"""Quadratic and bilinear forms, <psi|O|psi> and <phi|O|psi> sandwiches as
BP-able networks (port of `tnqs/forms.py`): per-vertex factors
``[ket[v], op[v], bra[v]]``, each edge carrying the tripled virtual space.
"""

from __future__ import annotations

from typing import Callable

import torch

from .core.index import Index
from .core.tensor import Tensor, delta, from_matrix, real_dtype_of
from .graphs import Edge, NamedGraph, is_tree
from .networks import TensorNetworkState
from .sitetypes import op_matrix


class AbstractForm:
    """The network-facing API that lets a form sit inside a BP cache."""

    @property
    def graph(self) -> NamedGraph:
        return self.ket.graph

    def vertices(self):
        return self.graph.vertices()

    def edges(self):
        return self.graph.edges()

    def neighbors(self, v):
        return self.graph.neighbors(v)

    def is_tree(self):
        return is_tree(self.graph)

    def dtype(self) -> torch.dtype:
        return torch.promote_types(self.ket.dtype(), self.operator.dtype())

    def real_dtype(self) -> torch.dtype:
        return real_dtype_of(self.dtype())

    @property
    def device(self) -> torch.device:
        return self.ket.device

    def _adapt_like(self, t: Tensor) -> Tensor:
        return t.astype(self.dtype()).to(self.device)

    def maxvirtualdim(self):
        return self.ket.maxvirtualdim()

    def virtualinds(self, e: Edge) -> list[Index]:
        return self.ket.virtualinds(e) + self.operator.virtualinds(e) + self.bra_virtualinds(e)

    def default_message(self, e: Edge) -> Tensor:
        return self._adapt_like(delta(self.virtualinds(e), dtype=self.real_dtype(), device=self.device))

    def bp_factors(self, v) -> list[Tensor]:
        return [self.ket[v], self.operator[v], self.bra_tensor(v)]


class QuadraticForm(AbstractForm):
    """<psi|O|psi>, the bra derived as dag(prime(ket))."""

    def __init__(self, ket: TensorNetworkState, f: Callable | None = None,
                 operator: TensorNetworkState | None = None):
        self.ket = ket
        if operator is not None:
            self.operator = operator
            return
        f = (lambda v: "I") if f is None else f
        op_tensors = {}
        for v in ket.vertices():
            t = None
            for s in ket.siteinds(v):
                o = ket._adapt_like(from_matrix(op_matrix(f(v), s.dim), [s.prime()], [s], device=ket.device))
                t = o if t is None else t * o
            op_tensors[v] = t
        self.operator = TensorNetworkState(op_tensors, ket.graph.copy(), {v: [] for v in ket.vertices()})

    def copy(self) -> "QuadraticForm":
        return QuadraticForm(self.ket.copy(), operator=self.operator.copy())

    def bra_tensor(self, v) -> Tensor:
        return self.ket[v].prime().dag()

    def bra_virtualinds(self, e: Edge):
        return [i.prime() for i in self.ket.virtualinds(e)]


def _remap_site_inds(tns, remap: dict):
    """Copy of `tns` with per-vertex site indices replaced (old, new), in
    the tensors and the `site_inds` registry."""
    out = tns.copy()
    for v, (old, new) in remap.items():
        if old == new:
            continue
        out.set_preserve(v, out[v].replaceinds(old, new))
        out.site_inds[v] = list(new)
    return out


class BilinearForm(AbstractForm):
    """<phi|O|psi> with an explicitly stored (primed, conjugated) bra; `ket`
    and `bra` share the graph, and the bra's site indices are mapped onto
    the ket's where they differ (same number and dimension per vertex)."""

    def __init__(self, ket: TensorNetworkState, bra: TensorNetworkState, _raw: bool = False):
        if _raw:
            self.ket, self.bra = ket, bra
            self.operator = None  # set by copy()
            return
        if ket.graph != bra.graph:
            raise ValueError("BilinearForm: states must share the same graph")
        if any(ket.siteinds(v) != bra.siteinds(v) for v in ket.vertices()):
            remap = {}
            for v in ket.vertices():
                ks, bs = ket.siteinds(v), bra.siteinds(v)
                if len(ks) != len(bs) or any(k.dim != b.dim for k, b in zip(ks, bs)):
                    raise ValueError(f"BilinearForm: site indices at {v} differ in number or dimension "
                                     f"({bs} vs {ks})")
                remap[v] = (list(bs), list(ks))
            bra = _remap_site_inds(bra, remap)
        self.ket = ket
        self.bra = bra.map_tensors(lambda t: t.prime().dag())
        op_tensors = {}
        for v in ket.vertices():
            t = None
            for s in ket.siteinds(v):
                o = ket._adapt_like(delta([s, s.prime()], dtype=ket.real_dtype(), device=ket.device))
                t = o if t is None else t * o
            op_tensors[v] = t
        self.operator = TensorNetworkState(op_tensors, ket.graph.copy(), {v: [] for v in ket.vertices()})

    def copy(self) -> "BilinearForm":
        out = BilinearForm.__new__(BilinearForm)
        out.ket = self.ket.copy()
        out.bra = self.bra.copy()
        out.operator = self.operator.copy()
        return out

    def bra_tensor(self, v) -> Tensor:
        return self.bra[v]

    def bra_virtualinds(self, e: Edge):
        return self.bra.virtualinds(e)
