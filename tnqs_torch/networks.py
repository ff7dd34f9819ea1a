"""Tensor networks and states (port of `tnqs/networks.py`).

A network is a graph plus a dict of named-index tensors, all on one device;
edges correspond to shared indices.  The constructors build on the CUDA
device unless `device` names another, and raise without a card; random
networks draw from the caller's numpy Generator in the JAX package's order
(`tnqs/networks.py:276-392`) and then copy to the device, so one seed gives
the same arrays in both packages.  `TensorNetworkState.from_arrays` /
`to_arrays` carry a state across as host arrays and index descriptors
``[id, dim, tag, plev]`` (the npz header's, `tnqs/checkpoint.py:50`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .core.index import Index
from .core.tensor import (
    Tensor,
    commoninds,
    delta,
    directsum,
    from_matrix,
    identity_tensor,
    onehot,
    random_tensor,
    real_dtype_of,
    resolve_device,
)
from .graphs import Edge, NamedGraph, is_tree
from .sitetypes import op_matrix, site_dimension, site_tag, state_vector


def siteinds(sitetype: str, g: NamedGraph, dim: int | None = None, inds_per_site: int = 1) -> dict:
    """Fresh physical indices for every vertex of `g`."""
    d = site_dimension(sitetype) if dim is None else int(dim)
    tag = site_tag(sitetype)
    return {v: [Index(d, tag) for _ in range(inds_per_site)] for v in g.vertices()}


def default_siteinds(g: NamedGraph) -> dict:
    return siteinds("S=1/2", g)


class IndexTable:
    """Index descriptors ``[id, dim, tag, plev]`` to `Index` objects: one
    saved id gives one base index, so shared bonds stay shared
    (`tnqs/checkpoint.py:54`)."""

    def __init__(self):
        self._by_id: dict = {}

    def resolve(self, desc) -> Index:
        iid, dim, tag, plev = desc
        base = self._by_id.get(iid)
        if base is None:
            base = Index(dim=int(dim), tag=str(tag))
            self._by_id[iid] = base
        return base.setprime(int(plev))


def index_desc(i: Index) -> list:
    return [i.id, i.dim, i.tag, i.plev]


class TensorNetwork:
    """A graph of tensors; edges are pairs of tensors sharing indices."""

    def __init__(self, tensors: dict, graph: NamedGraph | None = None):
        if graph is None:
            graph = _infer_graph(tensors)
        self.tensors: dict = dict(tensors)
        self.graph = graph

    def __getitem__(self, v) -> Tensor:
        return self.tensors[v]

    def set_preserve(self, v, t: Tensor) -> "TensorNetwork":
        """Replace the tensor at `v` without recomputing edges."""
        self.tensors[v] = t
        return self

    def __setitem__(self, v, t: Tensor):
        if not self.graph.has_vertex(v):
            raise KeyError(f"vertex {v!r} not in tensor network")
        self.add_tensor(t, v)

    def add_tensor(self, t: Tensor, v) -> "TensorNetwork":
        """Insert `t` at `v`, re-deriving the incident edges from shared
        indices."""
        g = self.graph
        if not g.has_vertex(v):
            g.add_vertex(v)
        else:
            for e in g.incident_edges(v):
                g.rem_edge(*e)
        self.tensors[v] = t
        for u in self.vertices():
            if u != v and commoninds(self.tensors[u], t):
                g.add_edge(v, u)
        return self

    def rem_vertex(self, v) -> "TensorNetwork":
        self.graph.rem_vertex(v)
        del self.tensors[v]
        return self

    def copy(self) -> "TensorNetwork":
        return TensorNetwork(dict(self.tensors), self.graph.copy())

    def vertices(self) -> list:
        return self.graph.vertices()

    def edges(self) -> list[Edge]:
        return self.graph.edges()

    def neighbors(self, v) -> list:
        return self.graph.neighbors(v)

    def is_tree(self) -> bool:
        return is_tree(self.graph)

    # -- index queries ------------------------------------------------------
    def virtualinds(self, e: Edge) -> list[Index]:
        return commoninds(self[e[0]], self[e[1]])

    def virtualind(self, e: Edge) -> Index:
        vi = self.virtualinds(e)
        if len(vi) != 1:
            raise ValueError(f"edge {e} has {len(vi)} virtual indices")
        return vi[0]

    def maxvirtualdim(self) -> int:
        dims = [i.dim for e in self.edges() for i in self.virtualinds(e)]
        return max(dims) if dims else 1

    def uniqueinds(self, v) -> list[Index]:
        mine = list(self[v].inds)
        for u in self.neighbors(v):
            other = set(self[u].inds)
            mine = [i for i in mine if i not in other]
        return mine

    def siteinds_dict(self) -> dict:
        return {v: self.uniqueinds(v) for v in self.vertices()}

    # -- BP interface ---------------------------------------------------------
    def bp_factors(self, v) -> list[Tensor]:
        return [self[v]]

    def default_message(self, e: Edge) -> Tensor:
        return self._adapt_like(delta(self.virtualinds(e), dtype=self.real_dtype(), device=self.device))

    # -- dtype / device -------------------------------------------------------
    def dtype(self) -> torch.dtype:
        dts = [t.dtype for t in self.tensors.values()]
        out = dts[0]
        for dt in dts[1:]:
            out = torch.promote_types(out, dt)
        return out

    def real_dtype(self) -> torch.dtype:
        return real_dtype_of(self.dtype())

    @property
    def device(self) -> torch.device:
        return next(iter(self.tensors.values())).device

    def _adapt_like(self, t: Tensor) -> Tensor:
        return t.astype(self.dtype()).to(self.device)

    def map_tensors(self, f: Callable[[Tensor], Tensor]) -> "TensorNetwork":
        out = self.copy()
        for v in out.vertices():
            out.set_preserve(v, f(out[v]))
        return out

    def map_virtualinds(self, f: Callable[[list], list]) -> "TensorNetwork":
        """Apply `f` to each edge's virtual-index list in both endpoint
        tensors (same-length, same-dimension replacements)."""
        out = self.copy()
        for e in out.edges():
            old = out.virtualinds(e)
            new = list(f(list(old)))
            if len(new) != len(old) or any(a.dim != b.dim for a, b in zip(old, new)):
                raise ValueError("map_virtualinds must return one same-dimension index per input index")
            out.set_preserve(e[0], out[e[0]].replaceinds(old, new))
            out.set_preserve(e[1], out[e[1]].replaceinds(old, new))
        return out

    def adapt(self, dtype=None, device=None) -> "TensorNetwork":
        """Convert / move all tensors (the JAX package's `adapt`, with a
        torch device in place of its backend)."""

        def f(t: Tensor) -> Tensor:
            if dtype is not None:
                t = t.astype(dtype)
            return t.to(device) if device is not None else t

        return self.map_tensors(f)

    # -- structural edits ---------------------------------------------------
    def insert_virtualinds(self, bond_dimension: int = 1) -> "TensorNetwork":
        """Give every index-free edge a trivial bond."""
        out = self.copy()
        for e in out.edges():
            if not out.virtualinds(e):
                p = out._adapt_like(onehot(Index(bond_dimension, "Link"), 0, device=out.device))
                out.set_preserve(e[0], out[e[0]] * p)
                out.set_preserve(e[1], out[e[1]] * p)
        return out

    def combine_virtualinds(self) -> "TensorNetwork":
        """Fuse parallel bonds on each edge into one index."""
        out = self.copy()
        for e in out.edges():
            vinds = out.virtualinds(e)
            if len(vinds) > 1:
                fused = Index(int(np.prod([i.dim for i in vinds])), "Link")
                C = out._adapt_like(identity_tensor([fused], vinds, device=out.device))
                out.set_preserve(e[0], out[e[0]] * C)
                out.set_preserve(e[1], out[e[1]] * C)
        return out

    def add(self, other: "TensorNetwork") -> "TensorNetwork":
        """Direct sum on every bond."""
        if self.graph != other.graph:
            raise ValueError("networks must share the same graph to be added")
        es = self.edges()
        new_inds = {frozenset(e): Index(self.virtualind(e).dim + other.virtualind(e).dim, "Link") for e in es}
        out = self.copy()
        for v in self.vertices():
            es_v = [e for e in es if v in e]
            out.set_preserve(v, directsum(self[v], [self.virtualind(e) for e in es_v], other[v],
                                          [other.virtualind(e) for e in es_v], [new_inds[frozenset(e)] for e in es_v]))
        return out

    def __add__(self, other):
        return self.add(other)

    def __repr__(self):
        return f"{type(self).__name__}({self.graph.nv()} vertices, {self.graph.ne()} edges)"


def _infer_graph(tensors: dict) -> NamedGraph:
    g = NamedGraph(tensors.keys())
    vs = list(tensors.keys())
    for i, v in enumerate(vs):
        for u in vs[i + 1:]:
            if commoninds(tensors[v], tensors[u]):
                g.add_edge(v, u)
    return g


def tensornetwork_from_list(tensors: Sequence[Tensor]) -> TensorNetwork:
    return TensorNetwork({i + 1: t for i, t in enumerate(tensors)})


def random_tensornetwork(g: NamedGraph, bond_dimension: int = 1, dtype=np.float64, rng=None,
                         device=None) -> TensorNetwork:
    """Random scalar network, drawn vertex by vertex from `rng`."""
    device = resolve_device(device)
    rng = np.random.default_rng() if rng is None else rng
    links = {frozenset(e): Index(bond_dimension, "Link") for e in g.edges()}
    tensors = {v: random_tensor([links[frozenset((v, u))] for u in g.neighbors(v)], dtype=dtype, rng=rng,
                                device=device) for v in g.vertices()}
    return TensorNetwork(tensors, g.copy())


class TensorNetworkState(TensorNetwork):
    """A wavefunction network: tensors carry physical (site) indices."""

    def __init__(self, tensors: dict, graph: NamedGraph | None = None, site_inds: dict | None = None):
        super().__init__(tensors, graph)
        if site_inds is None:
            site_inds = {v: self.uniqueinds(v) for v in self.vertices()}
        self.site_inds: dict = {v: list(inds) for v, inds in site_inds.items()}

    def siteinds(self, v=None):
        if v is None:
            return self.site_inds
        return self.site_inds[v]

    def copy(self) -> "TensorNetworkState":
        return TensorNetworkState(dict(self.tensors), self.graph.copy(),
                                  {v: list(i) for v, i in self.site_inds.items()})

    def __setitem__(self, v, t: Tensor):
        super().__setitem__(v, t)
        for u in self.neighbors(v) + [v]:
            self.site_inds[u] = self.uniqueinds(u)

    def map_tensors(self, f: Callable[[Tensor], Tensor]) -> "TensorNetworkState":
        out = self.copy()
        for v in out.vertices():
            out.set_preserve(v, f(out[v]))
        return out

    # -- host arrays in, host arrays out ------------------------------------
    @classmethod
    def from_arrays(cls, graph: NamedGraph, arrays: dict, site_inds: dict, device=None) -> "TensorNetworkState":
        """A state from ``{v: (ndarray, [index descriptor])}`` and
        ``{v: [index descriptor]}`` (descriptors ``[id, dim, tag, plev]``;
        equal ids become one shared `Index`), copied to `device` (the CUDA
        device when None)."""
        device = resolve_device(device)
        table = IndexTable()
        tensors = {v: Tensor(np.asarray(arrays[v][0]), [table.resolve(d) for d in arrays[v][1]], device=device)
                   for v in graph.vertices()}
        sinds = {v: [table.resolve(d) for d in site_inds[v]] for v in graph.vertices()}
        return cls(tensors, graph.copy(), sinds)

    def to_arrays(self) -> tuple[dict, dict]:
        """``({v: (ndarray, [descriptor])}, {v: [descriptor]})`` on the host."""
        arrays = {v: (self[v].to_numpy(), [index_desc(i) for i in self[v].inds]) for v in self.vertices()}
        return arrays, {v: [index_desc(i) for i in self.site_inds[v]] for v in self.vertices()}

    # -- BP interface (the doubled ket/bra layer) -----------------------------
    def norm_factors(self, verts: Sequence, op_strings: Callable | None = None) -> list[Tensor]:
        """Per-vertex factors of ``<psi|O|psi>``: `op_strings(v)` is "I"
        (ket and bra site contracted), "ρ" (the site left open) or an
        operator name."""
        if op_strings is None:
            op_strings = lambda v: "I"  # noqa: E731
        factors: list[Tensor] = []
        for v in verts:
            sinds = self.site_inds[v]
            tv = self[v]
            tv_dag = tv.prime().dag()
            o = op_strings(v)
            if o == "ρ" or not sinds:
                factors.extend([tv, tv_dag])
            elif o == "I":
                factors.extend([tv, tv_dag.replaceinds([i.prime() for i in sinds], sinds)])
            else:
                if len(sinds) != 1:
                    raise ValueError("operator insertion requires one site index per vertex")
                s = sinds[0]
                opt = self._adapt_like(from_matrix(op_matrix(o, s.dim), [s.prime()], [s], device=self.device))
                factors.extend([tv, tv_dag, opt])
        return factors

    def bp_factors(self, v) -> list[Tensor]:
        return self.norm_factors([v])

    def default_message(self, e: Edge) -> Tensor:
        linds = self.virtualinds(e)
        return self._adapt_like(delta(linds + [i.prime() for i in linds], dtype=self.real_dtype(),
                                      device=self.device))

    def gate_vertices(self, t: Tensor) -> list:
        """Vertices whose site indices appear on gate tensor `t`."""
        return [v for v in self.vertices() if any(t.hasind(s) for s in self.site_inds[v])]


def _site_inds_arg(g: NamedGraph, site_inds) -> dict:
    if site_inds is None:
        return default_siteinds(g)
    if isinstance(site_inds, str):
        return siteinds(site_inds, g)
    return site_inds


def random_tensornetworkstate(g: NamedGraph, site_inds: dict | str | None = None, bond_dimension: int = 1,
                              dtype=np.float64, rng=None, device=None) -> TensorNetworkState:
    device = resolve_device(device)
    rng = np.random.default_rng() if rng is None else rng
    site_inds = _site_inds_arg(g, site_inds)
    links = {frozenset(e): Index(bond_dimension, "Link") for e in g.edges()}
    tensors = {}
    for v in g.vertices():
        inds = list(site_inds[v]) + [links[frozenset((v, u))] for u in g.neighbors(v)]
        tensors[v] = random_tensor(inds, dtype=dtype, rng=rng, device=device)
    return TensorNetworkState(tensors, g.copy(), site_inds)


def tensornetworkstate(f: Callable, g: NamedGraph, site_inds: dict | str | None = None, dtype=np.float64,
                       device=None) -> TensorNetworkState:
    """Product state from per-vertex state labels or coefficient vectors."""
    device = resolve_device(device)
    site_inds = _site_inds_arg(g, site_inds)
    tensors = {}
    for v in g.vertices():
        local = f(v)
        s = site_inds[v]
        if len(s) != 1:
            raise ValueError("product-state constructor expects one site index per vertex")
        vec = state_vector(local, s[0].dim) if isinstance(local, str) else np.asarray(local)
        tensors[v] = Tensor(vec, s, device=device).astype(dtype)
    for e in g.edges():
        l = Index(1, "Link")
        for v in e:
            p = onehot(l, 0, dtype=real_dtype_of(tensors[v].dtype), device=device)
            tensors[v] = tensors[v] * p.astype(tensors[v].dtype)
    return TensorNetworkState(tensors, g.copy(), site_inds)


def zerostate(g: NamedGraph, site_inds: dict | None = None, dtype=np.float64, device=None) -> TensorNetworkState:
    """All-spins-up product state."""
    if site_inds is None:
        site_inds = siteinds("S=1/2", g)
    return tensornetworkstate(lambda v: "↑", g, site_inds, dtype=dtype, device=device)


def identity_tensornetworkstate(g: NamedGraph, site_inds: dict | None = None, dtype=np.float64,
                                device=None) -> TensorNetworkState:
    """Bond-dimension-1 operator state of the identity: each vertex holds an
    even number of site indices, the first half rows, the second columns."""
    device = resolve_device(device)
    if site_inds is None:
        site_inds = siteinds("S=1/2", g, inds_per_site=2)
    links = {frozenset(e): Index(1, f"e{e[0]}_{e[1]}") for e in g.edges()}
    tensors = {}
    for v in g.vertices():
        s = site_inds[v]
        if len(s) % 2 != 0:
            raise ValueError(f"Odd number of siteinds on vertex {v} - don't know how to partition into rows and "
                             "columns")
        t = delta([links[frozenset((v, u))] for u in g.neighbors(v)], dtype=dtype, device=device)
        n = len(s)
        if n > 0:
            t = t * identity_tensor(s[: n // 2], s[n // 2:], dtype=dtype, device=device)
        tensors[v] = t
    return TensorNetworkState(tensors, g.copy(), site_inds)


def toriccode_groundstate(n: int, site_inds: dict | None = None, device=None) -> TensorNetworkState:
    """Exact bond-dimension-2 toric-code ground state on an n x n torus."""
    from .graphs import named_grid

    device = resolve_device(device)
    g = named_grid((n, n), periodic=True)
    if site_inds is None:
        site_inds = siteinds("S=1/2", g)

    def mod1(x, m):
        return ((x - 1) % m) + 1

    e_inds = {frozenset(e): Index(2, "Link") for e in g.edges()}

    def lk(a, b) -> Index:
        return e_inds[frozenset((a, b))]

    def oh(ix, k):
        return onehot(ix, k, dtype=np.complex128, device=device)

    tensors = {}
    for v in g.vertices():
        sv = site_inds[v][0]
        north = lk((mod1(v[0] + 1, n), v[1]), v)
        east = lk((v[0], mod1(v[1] + 1, n)), v)
        south = lk(v, (mod1(v[0] - 1, n), v[1]))
        west = lk(v, (v[0], mod1(v[1] - 1, n)))
        inds = [north, east, south, west, sv]
        if len(set(inds[:-1])) != 4:
            raise ValueError("toric code requires n >= 3 (distinct wrap edges)")
        a, b = ((north, east), (south, west)) if (v[0] + v[1]) % 2 == 0 else ((north, west), (south, east))
        plus_a = oh(a[0], 0) * oh(a[1], 0) + oh(a[0], 1) * oh(a[1], 1)
        minus_a = oh(a[0], 0) * oh(a[1], 0) - oh(a[0], 1) * oh(a[1], 1)
        plus_b = oh(b[0], 0) * oh(b[1], 0) + oh(b[0], 1) * oh(b[1], 1)
        minus_b = oh(b[0], 0) * oh(b[1], 0) - oh(b[0], 1) * oh(b[1], 1)
        t = plus_a * plus_b * oh(sv, 0) + minus_a * minus_b * oh(sv, 1)
        tensors[v] = t.permute(inds)
    return TensorNetworkState(tensors, g.copy(), site_inds)


def ising_partitionfunction(g: NamedGraph, beta: float, Js: dict | None = None, device=None) -> TensorNetwork:
    """Bond-dimension-2 network contracting to the classical Ising Z(beta):
    the symmetric square root of each Boltzmann matrix on both ends."""
    device = resolve_device(device)
    Js = {frozenset(e): 1.0 for e in g.edges()} if Js is None else {frozenset(e): j for e, j in Js.items()}
    links = {frozenset(e): Index(2, "Link") for e in g.edges()}
    sqrt_Ws = {}
    for e in g.edges():
        key = frozenset(e)
        arg = beta * Js[key]
        arg = complex(arg) if np.real(arg) < 0 else arg
        lam1, lam2 = np.cosh(arg), np.sinh(arg)
        alpha = 0.5 * (np.sqrt(lam1) + np.sqrt(lam2))
        phi = 0.5 * (np.sqrt(lam1) - np.sqrt(lam2))
        sqrt_W = np.sqrt(2.0) * np.array([[alpha, phi], [phi, alpha]], dtype=np.complex128)
        W = np.array([[np.exp(arg), np.exp(-arg)], [np.exp(-arg), np.exp(arg)]], dtype=np.complex128)
        if not np.allclose(sqrt_W @ sqrt_W, W, atol=1e-10):
            raise AssertionError("sqrt Boltzmann factorization failed")
        sqrt_Ws[key] = sqrt_W
    tensors = {}
    for v in g.vertices():
        es = [frozenset((v, u)) for u in g.neighbors(v)]
        t = delta([links[k] for k in es], dtype=np.complex128, device=device)
        for k in es:
            l = links[k]
            t = (from_matrix(sqrt_Ws[k], [l.prime()], [l], device=device) * t).noprime()
        tensors[v] = t
    return TensorNetwork(tensors, g.copy())

