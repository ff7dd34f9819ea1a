"""Belief propagation over tensor networks (port of `tnqs/bp.py`).

A cache wraps a network (TensorNetwork, TensorNetworkState or a form) and
its message tensors, keyed by directed edge; `update` sweeps a forest-cover
edge schedule until the mean message change drops below the tolerance.
The messages stay on the network's device.  A message is normalized by its
element sum on the device (no host read), and a sweep sums its per-edge
changes there in float64 in edge order, as the JAX package sums its Python
floats, and reads the sum once: one host read per iteration, and the same
iteration counts as the JAX package's.
"""

from __future__ import annotations

import warnings
from math import log
from typing import Sequence

import numpy as np
import torch

from .contraction import contract, contraction_sequence
from .core.tensor import Tensor, as_torch_dtype
from .graphs import Edge, boundary_edges, forest_cover_edge_sequence, is_tree, reverse_edge
from .networks import TensorNetwork, TensorNetworkState

_DEFAULT_BP_MAXITER = 25


def default_tolerance(dtype) -> float | None:
    """1e-5 for single precision, 1e-8 for double (torch or numpy dtype)."""
    dt = as_torch_dtype(dtype)
    if dt in (torch.float32, torch.complex64):
        return 1.0e-5
    if dt in (torch.float64, torch.complex128):
        return 1.0e-8
    return None


def default_bp_update_kwargs(network) -> dict:
    if network.is_tree():
        return dict(maxiter=1, tolerance=None, verbose=False)
    return dict(maxiter=_DEFAULT_BP_MAXITER, tolerance=default_tolerance(network.dtype()), verbose=False)


def _message_diff_t(a: Tensor, b: Tensor) -> torch.Tensor:
    """1 - fidelity of two messages as a 0-d float64 tensor on the device:
    the norms in the messages' precision, the ratio in double, as the JAX
    package takes them in Python floats."""
    na = a.norm_t().to(torch.float64)
    nb = b.norm_t().to(torch.float64)
    f = torch.abs(b.dot_t(a).to(torch.complex128) / (na * nb)) ** 2
    return torch.where((na == 0) | (nb == 0), torch.ones_like(f), 1.0 - f)


def message_diff(a: Tensor, b: Tensor) -> float:
    """1 - fidelity between two messages."""
    return float(_message_diff_t(a, b))


class AbstractBeliefPropagationCache:
    """Shared machinery of the BP and boundary-MPS caches."""

    network = None
    messages: dict
    seq_cache: dict

    @property
    def graph(self):
        return self.network.graph

    def vertices(self):
        return self.graph.vertices()

    def edges(self):
        return self.graph.edges()

    def is_tree(self):
        return is_tree(self.graph)

    def dtype(self):
        return self.network.dtype()

    def bp_factors(self, v):
        return self.network.bp_factors(v)

    def default_message(self, e: Edge) -> Tensor:
        return self.network.default_message(e)

    # -- message store ----------------------------------------------------
    def message(self, e: Edge):
        e = tuple(e)
        m = self.messages.get(e)
        if m is None:
            m = self.default_message(e)
            self.messages[e] = m
        return m

    def set_message(self, e: Edge, m) -> None:
        self.messages[tuple(e)] = m

    def delete_message(self, e: Edge) -> None:
        self.messages.pop(tuple(e), None)

    def delete_messages(self, edges=None) -> None:
        if edges is None:
            self.messages.clear()
        else:
            for e in edges:
                self.delete_message(e)

    def messages_for(self, edges: Sequence[Edge]) -> list[Tensor]:
        out: list[Tensor] = []
        for e in edges:
            m = self.message(e)
            if isinstance(m, list):
                out.extend(m)
            else:
                out.append(m)
        return out

    def incoming_messages(self, vertices, ignore_edges=()) -> list[Tensor]:
        # vertices may be tuples (lattice coordinates): only lists and sets
        # count as collections
        if not isinstance(vertices, (list, set)):
            vertices = [vertices]
        ignore = {tuple(e) for e in ignore_edges}
        b_edges = [e for e in boundary_edges(self.graph, list(vertices), dir="in") if tuple(e) not in ignore]
        return self.messages_for(b_edges)

    def invalidate_sequences(self) -> None:
        self.seq_cache.clear()

    def set_preserve(self, v, t: Tensor) -> None:
        self.network.set_preserve(v, t)

    # -- message update -----------------------------------------------------
    def updated_message(self, e: Edge, normalize: bool = True, seq_alg: str = "optimal") -> Tensor:
        v = e[0]
        contract_list = self.incoming_messages(v, ignore_edges=(reverse_edge(e),)) + self.bp_factors(v)
        key = (v, tuple(e), len(contract_list))
        seq = self.seq_cache.get(key)
        if seq is None:
            seq = contraction_sequence(contract_list, alg=seq_alg)
            self.seq_cache[key] = seq
        m = contract(contract_list, sequence=seq)
        if normalize:
            n = m.sum_t()
            m = Tensor(torch.where(n != 0, m.data / n, m.data), m.inds)
        return m

    def update_message(self, e: Edge, **kwargs) -> None:
        self.set_message(e, self.updated_message(e, **kwargs))

    # -- scalars ----------------------------------------------------------------
    def vertex_scalar(self, v) -> complex:
        contract_list = self.bp_factors(v) + self.incoming_messages(v)
        seq = contraction_sequence(contract_list, alg="optimal")
        return contract(contract_list, sequence=seq).item()

    def edge_scalar(self, e: Edge) -> complex:
        raise NotImplementedError

    def vertex_scalars(self, vertices=None) -> list:
        vertices = self.vertices() if vertices is None else vertices
        return [self.vertex_scalar(v) for v in vertices]

    def edge_scalars(self, edges=None) -> list:
        edges = self.edges() if edges is None else edges
        return [self.edge_scalar(e) for e in edges]

    def scalar_factors_quotient(self):
        return self.vertex_scalars(), self.edge_scalars()

    def freenergy(self):
        numer, denom = self.scalar_factors_quotient()
        if any(t == 0 for t in denom):
            return -np.inf

        def log_sum(terms):
            if any(isinstance(t, complex) and t.imag != 0 for t in terms) or any(np.real(t) < 0 for t in terms):
                return sum(np.log(complex(t)) for t in terms)
            return sum(log(np.real(t)) for t in terms)

        f = log_sum(numer) - log_sum(denom)
        if isinstance(f, complex) and f.imag == 0:
            f = f.real
        return f

    def partitionfunction(self):
        z = np.exp(self.freenergy())
        if isinstance(z, complex) and z.imag == 0:
            z = z.real
        return z

    def rescale_messages(self, edges=None) -> None:
        raise NotImplementedError

    def rescale_vertices(self, vertices=None) -> None:
        raise NotImplementedError

    def rescale_(self) -> None:
        self.rescale_messages()
        self.rescale_vertices()

    def rescale(self):
        out = self.copy()
        out.rescale_()
        return out

    # -- dtype / device -------------------------------------------------------
    def map_messages(self, f) -> None:
        for e in list(self.messages.keys()):
            m = self.messages[e]
            self.messages[e] = [f(x) for x in m] if isinstance(m, list) else f(m)

    def adapt(self, dtype=None, device=None):
        out = self.copy()
        out.network = out.network.adapt(dtype=dtype, device=device)

        def f(t: Tensor) -> Tensor:
            if dtype is not None:
                t = t.astype(dtype)
            return t.to(device) if device is not None else t

        out.map_messages(f)
        return out


class BeliefPropagationCache(AbstractBeliefPropagationCache):
    """Flat BP cache over the network's graph."""

    def __init__(self, network, messages: dict | None = None, edge_sequence: list | None = None):
        self.network = network
        self.messages = {} if messages is None else dict(messages)
        self.seq_cache: dict = {}
        self.edge_sequence = (forest_cover_edge_sequence(network.graph) if edge_sequence is None
                              else list(edge_sequence))

    def copy(self) -> "BeliefPropagationCache":
        out = BeliefPropagationCache(self.network.copy(), self.messages, self.edge_sequence)
        out.seq_cache = dict(self.seq_cache)
        return out

    def default_maxiter(self) -> int:
        return 1 if self.is_tree() else _DEFAULT_BP_MAXITER

    def update_iteration(self, edges: Sequence[Edge], compute_diff: bool = False) -> float:
        """One sweep over `edges`; with `compute_diff` the summed message
        changes, read to the host once."""
        total = None
        for e in edges:
            prev = self.message(e) if compute_diff else None
            self.update_message(e)
            if compute_diff:
                d = _message_diff_t(self.message(e), prev)
                total = d if total is None else total + d
        return 0.0 if total is None else float(total)

    def update(self, maxiter: int | None = None, tolerance: float | None = None,
               edge_sequence: Sequence[Edge] | None = None, verbose: bool = False) -> "BeliefPropagationCache":
        maxiter = self.default_maxiter() if maxiter is None else maxiter
        edge_sequence = self.edge_sequence if edge_sequence is None else list(edge_sequence)
        bpc = self.copy()
        bpc.invalidate_sequences()
        compute_error = tolerance is not None
        converged = False
        avg_diff = None
        niter = maxiter
        for it in range(maxiter):
            diff = bpc.update_iteration(edge_sequence, compute_diff=compute_error)
            if compute_error:
                avg_diff = diff / max(len(edge_sequence), 1)
                if avg_diff <= tolerance:
                    converged = True
                    niter = it + 1
                    break
        if compute_error:
            if converged:
                if verbose:
                    print(f"BP converged to desired precision after {niter} iterations.")
            else:
                msg = (f"BP did not converge to tolerance {tolerance} after {niter} iterations (final average "
                       f"message change: {avg_diff}).")
                if verbose:
                    print(msg)
                else:
                    warnings.warn(msg)
        bpc.invalidate_sequences()
        return bpc

    def edge_scalar(self, e: Edge) -> complex:
        return (self.message(e) * self.message(reverse_edge(e))).item()

    def rescale_messages(self, edges=None) -> None:
        edges = self.edges() if edges is None else edges
        for e in edges:
            me = self.message(e).normalize()
            mer = self.message(reverse_edge(e)).normalize()
            n = (me * mer).item()
            if isinstance(n, float) or (isinstance(n, complex) and n.imag == 0):
                n = np.real(n)
                s = np.sign(n) if n != 0 else 1.0
                me = me * s
                n = n * s
            self.set_message(e, me * (1.0 / np.sqrt(n)))
            self.set_message(reverse_edge(e), mer * (1.0 / np.sqrt(n)))

    def rescale_vertices(self, vertices=None) -> None:
        vertices = self.vertices() if vertices is None else vertices
        tn = self.network
        for v in vertices:
            vn = self.vertex_scalar(v)
            if isinstance(vn, complex) and vn.imag == 0:
                vn = vn.real
            s = (1.0 if vn >= 0 else -1.0) if not isinstance(vn, complex) else 1.0
            root = np.emath.sqrt(vn)  # complex for a negative real
            if isinstance(tn, TensorNetworkState):
                tn.set_preserve(v, tn[v] * (s / root))
            elif isinstance(tn, TensorNetwork):
                tn.set_preserve(v, tn[v] * (s / vn if vn != 0 else 0.0))
            else:
                raise TypeError("don't know how to rescale the vertices of this network type")

    # -- BP-quality diagnostics -----------------------------------------------
    def loop_correlation(self, loop: list[Edge], target_e: Edge) -> float:
        if self.is_tree():
            return 0.0
        es = list(loop) + [tuple(target_e)]
        incoming = [self.message(e) for e in _region_boundary_edges(self, es)]
        vs = []
        for e in es[:-1]:
            for v in e:
                if v not in vs:
                    vs.append(v)
        src_v = target_e[0]
        e_vinds = list(self.message(tuple(target_e)).inds)
        e_vinds_sim = [i.sim() for i in e_vinds]
        tensors = []
        for t in self.bp_factors(src_v):
            t_inds = [i for i in t.inds if i in e_vinds]
            if t_inds:
                t = t.replaceind(t_inds[0], e_vinds_sim[e_vinds.index(t_inds[0])])
            tensors.append(t)
        for v in vs:
            if v != src_v:
                tensors.extend(self.bp_factors(v))
        tensors.extend(incoming)
        t = contract(tensors, sequence=contraction_sequence(tensors, alg="greedy"))
        mat = t.matricize(e_vinds, e_vinds_sim).to(torch.complex128).cpu().numpy()
        lams = sorted(np.linalg.eigvals(mat), key=abs, reverse=True)
        return 1.0 - abs(lams[0]) / sum(abs(l) for l in lams)

    def loop_correlations(self, smallest_loop_size: int) -> list[float]:
        """One correlation per simple cycle of `unique_simple_cycles`, each
        cut at its last edge."""
        from .graphs import unique_simple_cycles

        return [self.loop_correlation(loop[:-1], reverse_edge(loop[-1]))
                for loop in unique_simple_cycles(self.graph, smallest_loop_size)]


def _region_boundary_edges(cache: AbstractBeliefPropagationCache, es: list[Edge]) -> list[Edge]:
    """Edges into the region covered by `es`, except `es` themselves."""
    vs = []
    for e in es:
        for v in e:
            if v not in vs:
                vs.append(v)
    es_set = {tuple(e) for e in es} | {reverse_edge(e) for e in es}
    out = []
    for v in vs:
        for e in boundary_edges(cache.graph, [v], dir="in"):
            if tuple(e) not in es_set:
                out.append(e)
    return out


def loop_correlations(network, smallest_loop_size: int, bp_update_kwargs: dict | None = None):
    """The loop-correlation BP-error diagnostic of a network."""
    kwargs = default_bp_update_kwargs(network) if bp_update_kwargs is None else bp_update_kwargs
    return BeliefPropagationCache(network).update(**kwargs).loop_correlations(smallest_loop_size)


def make_hermitian(a: Tensor) -> Tensor:
    """(A + A^dag) / 2 for a 2-index tensor."""
    if a.ndim != 2:
        raise ValueError("make_hermitian expects a 2-index tensor")
    i, j = a.inds
    return (a + a.dag().replaceinds([i, j], [j, i])) * 0.5
