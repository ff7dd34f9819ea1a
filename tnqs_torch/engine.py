"""Batched simple-update evolution engine in PyTorch.

Port of `tnqs/engine.py::LatticeEngine` with the switches of the JAX
engine (`LatticeEngine` lists them).  The production configuration is
``factor_method="gram"`` with the Cholesky environment gauge, shifted
CholeskyQR2 on the tall sides, and ``trunc_method="svd"`` whose theta
truncations route to the Jacobi kernels through `pjsvd`
(`tnqs/engine.py:1231-1255`).  The direct path (`tnqs/engine.py:914-1007`),
the eigh gauge, the Q-free reduction, the Gram truncations and the library
SVD are the other values; complex128 runs every one of them except the
float32 kernels.  Every BP sweep, the step's refreshes and its final run
as well as `bp_update` and `normalize`, routes every degree >= 2 group
through the fused BP kernel (`ops.bp_sweep_group`) under
``bp_kernel="kernel"``.  The JAX step passes ``use_kernel=False``
(`tnqs/engine.py:1433`, `:1445`) because its TPU kernel needs pre-permuted
real/imaginary plane copies of every site tensor; the port's kernel reads
``T[k]`` in place, so that reason does not carry over.  The BP measurements
of `tnqs/engine.py:1566-1961` follow: `expect_1site`, `expect_2site`,
`freenergy`, `partitionfunction`, `rescale` and `bond_entropies`.

Layout as in the JAX engine: site tensors are stacked per vertex degree,
``T[k]`` of shape ``[n_k, d, chi, ..., chi]`` (k bond axes, zero-padded to
the bond cap), and BP messages are one tensor ``M[2E, chi, chi]`` keyed by
directed edge id.  The host plan (`LatticePlan`, `compile_circuit`,
`build_program`) is numpy and matches the JAX package table for table, so
the packed state carries over in both directions (`from_arrays`,
`to_arrays`).  PyTorch runs eagerly: a layer is a Python loop over the
program, and writes into the state are in place where the JAX code rebuilt
immutable arrays.
"""

from __future__ import annotations

import copy
import string
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .gates import gate_matrix
from .sitetypes import op_matrix
from .graphs import NamedGraph, center, leafless_edge_induced_subgraphs
from .ops.bp_sweep import absorb_message, bp_sweep_group, group_messages, supports_group
from .ops.factorizations import (
    apply_rinv,
    cholesky_nan,
    cholesky_qr,
    default_eigh,
    eps_of,
    gram_rfactor,
    library_eigh,
    library_svd,
    subspace_eigh,
    svd_from_eigh,
)
from .ops.osj import pjsvd, pjsvd_fits
from .utils.einsum_cache import ceinsum


# ----------------------------------------------------------------------
# static plan: everything derived from the graph alone
# (`tnqs/engine.py:55-210`)
# ----------------------------------------------------------------------

@dataclass
class LatticePlan:
    """Static structure of a graph for the engine."""

    graph: NamedGraph
    vertices: list
    degrees: dict  # vertex -> degree
    neighbor_order: dict  # vertex -> list of neighbors (bond axis order)
    buckets: dict  # degree k -> list of vertices
    bucket_pos: dict  # vertex -> (k, position in bucket)
    edge_ids: dict  # directed edge tuple -> int
    num_edges: int
    bp_groups: list  # [(stage, k, t, src_pos [B], out_eids [B], in_eids [B, k-1], in_slots [k-1])]
    bp_schedule: str = "wavefront"

    @staticmethod
    def build(graph: NamedGraph, bp_schedule: str = "wavefront") -> "LatticePlan":
        """`bp_schedule` stages the BP sweep (`tnqs/engine.py:71`):

        - "wavefront": directed edges staged by BFS depth from a central
          root — leaf-to-root, same-depth edges by bipartite color, then
          root-to-leaf; one sweep is exact on trees;
        - "color": two Gauss-Seidel stages by bipartite source color.
        """
        vertices = graph.vertices()
        neighbor_order = {v: graph.neighbors(v) for v in vertices}
        degrees = {v: len(neighbor_order[v]) for v in vertices}
        buckets: dict = {}
        for v in vertices:
            buckets.setdefault(degrees[v], []).append(v)
        edge_ids: dict = {}
        for v in vertices:
            for u in neighbor_order[v]:
                edge_ids[(v, u)] = len(edge_ids)
        # bipartite source color: a synchronous update ping-pongs on
        # bipartite graphs, two color stages restore sweep convergence
        color = {vertices[0]: 0}
        stack = [vertices[0]]
        bipartite = True
        while stack:
            u = stack.pop()
            for w in neighbor_order[u]:
                if w not in color:
                    color[w] = 1 - color[u]
                    stack.append(w)
                elif color[w] == color[u]:
                    bipartite = False
        for v in vertices:  # disconnected safety
            color.setdefault(v, 0)
        if not bipartite:
            color = {v: 0 for v in vertices}

        if bp_schedule == "wavefront":
            try:
                root = center(graph)[0]
            except ValueError:  # disconnected
                root = vertices[0]
            depth = {root: 0}
            frontier = [root]
            while frontier:
                nxt = []
                for u in frontier:
                    for w in neighbor_order[u]:
                        if w not in depth:
                            depth[w] = depth[u] + 1
                            nxt.append(w)
                frontier = nxt
            for v in vertices:
                depth.setdefault(v, 0)
            dmax = max(depth.values())

            def stage_of(u, v):
                du, dv = depth[u], depth[v]
                if du > dv:  # toward the root: deepest sources first
                    return dmax - du
                if du == dv:  # loop ties, between the two phases
                    return dmax + color[u]
                return dmax + 2 + du  # away from the root

            def bucket_key(v):
                return (depth[v], color[v])
        elif bp_schedule == "color":

            def stage_of(u, v):
                return color[u]

            def bucket_key(v):
                return (color[v],)
        else:
            raise ValueError(f"unknown bp_schedule {bp_schedule!r}")

        # every (stage, degree, slot) BP group reads a contiguous bucket
        # range and writes a contiguous message range
        buckets = {k: sorted(vs, key=bucket_key) for k, vs in buckets.items()}
        bucket_pos = {v: (k, i) for k, vs in buckets.items() for i, v in enumerate(vs)}

        stage = {e: stage_of(*e) for e in edge_ids}
        ordered_edges = sorted(
            edge_ids.keys(),
            key=lambda e: (
                stage[e],
                degrees[e[0]],
                neighbor_order[e[0]].index(e[1]),
                bucket_pos[e[0]][1],
            ),
        )
        edge_ids = {e: i for i, e in enumerate(ordered_edges)}

        groups: dict = {}
        for (u, v), eid in edge_ids.items():
            k = degrees[u]
            t = neighbor_order[u].index(v)
            groups.setdefault((stage[(u, v)], k, t), []).append((u, v, eid))
        bp_groups = []
        for (cu, k, t), items in sorted(groups.items()):
            src_pos = np.array([bucket_pos[u][1] for (u, v, eid) in items], dtype=np.int32)
            out_eids = np.array([eid for (u, v, eid) in items], dtype=np.int32)
            other_slots = [j for j in range(k) if j != t]
            in_eids = np.array(
                [[edge_ids[(neighbor_order[u][j], u)] for j in other_slots] for (u, v, eid) in items],
                dtype=np.int32,
            ).reshape(len(items), k - 1)
            bp_groups.append((cu, k, t, src_pos, out_eids, in_eids, other_slots))
        return LatticePlan(
            graph=graph,
            vertices=vertices,
            degrees=degrees,
            neighbor_order=neighbor_order,
            buckets=buckets,
            bucket_pos=bucket_pos,
            edge_ids=edge_ids,
            num_edges=len(edge_ids),
            bp_groups=bp_groups,
            bp_schedule=bp_schedule,
        )


# ----------------------------------------------------------------------
# compiled circuit representation (`tnqs/engine.py:217-376`)
# ----------------------------------------------------------------------

@dataclass
class OneSiteGroup:
    per_bucket: dict  # k -> (positions [B], gates [B, d, d], gate indices [B])


@dataclass
class TwoSiteGroup:
    classes: list  # of _TwoSiteClass, one per (ku, kv)


@dataclass
class _TwoSiteClass:
    ku: int
    kv: int
    u_pos: np.ndarray  # [B]
    v_pos: np.ndarray  # [B]
    slot_u: np.ndarray  # [B] bond axis of u facing v
    slot_v: np.ndarray  # [B]
    env_u_eids: np.ndarray  # [B, ku-1] incoming message ids at u (excl. v->u)
    env_v_eids: np.ndarray  # [B, kv-1]
    eid_uv: np.ndarray  # [B]
    eid_vu: np.ndarray  # [B]
    gates: np.ndarray  # [B, d, d, d, d] (out_u, out_v, in_u, in_v)
    gate_index: np.ndarray  # [B] position of each gate in the circuit


def compile_circuit(plan: LatticePlan, circuit: Sequence, d: int = 2) -> list:
    """Partition a circuit (list of ``(name, verts[, param])``) into batched
    one-site groups and vertex-disjoint two-site groups, as
    `tnqs.engine.compile_circuit` (`tnqs/engine.py:245`): consecutive
    one-site gates merge, consecutive two-site gates merge while they stay
    vertex-disjoint."""
    groups: list = []
    current = None  # ("one", list) or ("two", list, used vertex set)
    for gate_counter, gate in enumerate(circuit):
        name, verts = gate[0], list(gate[1])
        param = gate[2] if len(gate) > 2 else None
        mat = np.asarray(name) if isinstance(name, np.ndarray) else gate_matrix(name, param)
        if len(verts) == 1:
            if current is None or current[0] != "one":
                if current is not None:
                    groups.append(current)
                current = ("one", [])
            current[1].append((verts[0], mat, gate_counter))
        elif len(verts) == 2:
            if current is None or current[0] != "two" or verts[0] in current[2] or verts[1] in current[2]:
                if current is not None:
                    groups.append(current)
                current = ("two", [], set())
            current[1].append((verts[0], verts[1], mat, gate_counter))
            current[2].update(verts)
        else:
            raise ValueError("engine supports 1- and 2-site gates")
    if current is not None:
        groups.append(current)

    compiled = []
    for g in groups:
        if g[0] == "one":
            # compose successive gates on one vertex
            merged: dict = {}
            for (v, mat, gi) in g[1]:
                merged[v] = (mat @ merged[v][0], merged[v][1]) if v in merged else (mat, gi)
            per_bucket: dict = {}
            for v, (mat, gi) in merged.items():
                k, pos = plan.bucket_pos[v]
                per_bucket.setdefault(k, []).append((pos, mat, gi))
            compiled.append(
                OneSiteGroup(
                    {
                        k: (
                            np.array([p for p, _, _ in items], dtype=np.int32),
                            np.stack([m for _, m, _ in items]).astype(np.complex128),
                            np.array([gi for _, _, gi in items], dtype=np.int32),
                        )
                        for k, items in per_bucket.items()
                    }
                )
            )
            continue
        classes: dict = {}
        for (u, v, mat, gi) in g[1]:
            ku, up = plan.bucket_pos[u]
            kv, vp = plan.bucket_pos[v]
            su = plan.neighbor_order[u].index(v)
            sv = plan.neighbor_order[v].index(u)
            env_u = [plan.edge_ids[(plan.neighbor_order[u][j], u)] for j in range(ku) if j != su]
            env_v = [plan.edge_ids[(plan.neighbor_order[v][j], v)] for j in range(kv) if j != sv]
            classes.setdefault((ku, kv), []).append(
                (up, vp, su, sv, env_u, env_v, plan.edge_ids[(u, v)], plan.edge_ids[(v, u)], mat, gi)
            )
        cls_list = []
        for (ku, kv), items in sorted(classes.items()):
            col = lambda i: np.array([it[i] for it in items], dtype=np.int32)  # noqa: E731
            cls_list.append(
                _TwoSiteClass(
                    ku=ku,
                    kv=kv,
                    u_pos=col(0),
                    v_pos=col(1),
                    slot_u=col(2),
                    slot_v=col(3),
                    env_u_eids=col(4).reshape(len(items), ku - 1),
                    env_v_eids=col(5).reshape(len(items), kv - 1),
                    eid_uv=col(6),
                    eid_vu=col(7),
                    gates=np.stack([it[8].reshape(d, d, d, d) for it in items]).astype(np.complex128),
                    gate_index=col(9),
                )
            )
        compiled.append(TwoSiteGroup(cls_list))
    return compiled


def build_program(plan: LatticePlan, compiled: list) -> list:
    """Interleave compiled gate groups with BP refreshes: a refresh precedes
    a two-site group iff one of its vertices was touched since the last
    refresh (`tnqs/engine.py:349`)."""
    program: list = []
    affected: set = set()
    for gidx, g in enumerate(compiled):
        if isinstance(g, OneSiteGroup):
            program.append(("one", g, gidx))
            for k, (pos, _, _) in g.per_bucket.items():
                affected.update(plan.buckets[k][int(p)] for p in pos)
        else:
            verts = set()
            for cls in g.classes:
                for up, vp in zip(cls.u_pos, cls.v_pos):
                    verts.add(plan.buckets[cls.ku][int(up)])
                    verts.add(plan.buckets[cls.kv][int(vp)])
            if affected & verts:
                program.append(("bp",))
                affected = set()
            program.append(("two", g, gidx))
            affected |= verts
    return program


# ----------------------------------------------------------------------
# device helpers (`tnqs/engine.py:383-495`)
# ----------------------------------------------------------------------

def _truncate_mask(s: torch.Tensor, chi: int, cutoff: float, tail_extra: torch.Tensor | None = None):
    """Static-shape truncation of singular values s [B, K] (descending) with
    the relative-cutoff semantics of `tnqs/engine.py:415`.  `tail_extra` [B]
    is weight known to lie below the given values (the subspace
    eigensolver's unresolved tail): it joins the total and every cumulative
    tail.  Returns (s_padded [B, chi] masked, mask [B, chi], discarded
    weight [B])."""
    B, K = s.shape
    p = s * s
    total = torch.sum(p, dim=1, keepdim=True)
    tail = torch.flip(torch.cumsum(torch.flip(p, [1]), dim=1), [1])  # tail[k] = sum_{j>=k} p_j
    beyond = tail.new_zeros((B, 1))
    if tail_extra is not None:
        beyond = tail_extra.to(p.dtype)[:, None]
        total = total + beyond
        tail = tail + beyond
    total = torch.where(total > 0, total, 1.0)
    # keep the smallest count whose dropped tail is within cutoff * total
    nstar = (K - torch.sum(tail <= cutoff * total, dim=1)).clamp(1, chi)
    s_pad = s[:, :chi] if K >= chi else F.pad(s, (0, chi - K))
    mask = torch.arange(chi, device=s.device)[None, :] < nstar[:, None]
    tail_full = torch.cat([tail, beyond], dim=1)
    err = torch.gather(tail_full, 1, nstar[:, None])[:, 0] / total[:, 0]
    return s_pad * mask, mask, err


def _pseudo_sqrt_roots(E: torch.Tensor, cutoff: float, eigh_fn=None):
    """Batched pseudo sqrt and inverse sqrt (W, Winv) of the hermitized
    environments E [..., chi, chi], eigenvalues below `cutoff` in absolute
    value zeroed (`tnqs/engine.py:396`); `eigh_fn` defaults to the library's
    (`library_eigh`: NaN for a non-finite environment, as in JAX)."""
    H = 0.5 * (E + E.mH)
    w, U = (library_eigh if eigh_fn is None else eigh_fn)(H)
    w = w.real
    ok = torch.abs(w) >= cutoff
    sq = torch.where(ok, torch.sqrt(torch.clamp(w, min=0.0)), 0.0)
    isq = torch.where(ok & (sq > 0), 1.0 / torch.where(sq > 0, sq, 1.0), 0.0)
    W = (U * sq.to(U.dtype)[..., None, :]) @ U.mH
    Winv = (U * isq.to(U.dtype)[..., None, :]) @ U.mH
    return W, Winv


def _svd_fallback(mat: torch.Tensor):
    """The library's batched thin SVD (`library_svd`: gesvd on the card, NaN
    for a non-finite theta as in JAX), the direct path's, ``svd_impl="xla"``'s
    and every theta's that `pjsvd` cannot take (`tnqs/engine.py:498`).  Calls
    are counted by [B, m, n] in `_svd_fallback.calls_by_shape`."""
    shape = tuple(mat.shape)
    _svd_fallback.calls_by_shape[shape] = _svd_fallback.calls_by_shape.get(shape, 0) + 1
    return library_svd(mat)


_svd_fallback.calls_by_shape = {}  # (B, m, n) -> calls


def _cholesky_gauge_roots(E: torch.Tensor, eps: float):
    """Batched gauge roots (W, Winv) of environments E [N, chi, chi] from
    the Cholesky factor of the regularized hermitized environment
    (`tnqs/engine.py:455`).  W = L with L L^H = E + delta I; the un-gauge
    contracts conj(Winv), so Winv = conj(L^{-1})^T.

    Null directions (L[j,j]^2 ~ delta) are ZEROED in Winv.  Their rows
    would be ~1/sqrt(delta) ~ 1e4 in float32, which amplifies the truncated
    SVD's residual in the dead bond directions into garbage that reached NaN
    within 3 layers on the chi=64 Eagle run.  A failed Cholesky gives NaN
    (`cholesky_nan`), as in JAX, rather than raising."""
    H = 0.5 * (E + E.mH)
    chi = H.shape[-1]
    diag_scale = torch.diagonal(H, dim1=-2, dim2=-1).real.sum(-1) / chi
    delta = torch.clamp(torch.abs(diag_scale) * (32.0 * eps), min=1e-30)
    eye = torch.eye(chi, dtype=H.dtype, device=H.device)
    L = cholesky_nan(H + delta[..., None, None] * eye)
    Linv = torch.linalg.solve_triangular(L, eye.expand(H.shape), upper=False)
    diagL2 = torch.abs(torch.diagonal(L, dim1=-2, dim2=-1)) ** 2
    keep = (diagL2 > (64.0 * delta)[..., None]).to(Linv.dtype)
    Winv = (Linv * keep[..., :, None]).mH.resolve_conj()
    return L, Winv


def default_engine_tolerance(dtype: torch.dtype) -> float:
    """BP convergence tolerance by working precision (`tnqs/engine.py:1997`)."""
    return 1e-5 if eps_of(dtype) == eps_of(torch.float32) else 1e-8


def _unit_rows(A: torch.Tensor) -> torch.Tensor:
    """Each batch entry of A scaled to unit Frobenius norm (zero stays zero)."""
    n = torch.linalg.vector_norm(A.reshape(A.shape[0], -1), dim=1)
    return A / torch.where(n > 0, n, 1.0).reshape((-1,) + (1,) * (A.dim() - 1))


def _bp_diff(Ma: torch.Tensor, Mb: torch.Tensor) -> torch.Tensor:
    """Mean message infidelity 1 - |<Ma|Mb>|^2 / (|Ma| |Mb|)^2."""
    na = torch.linalg.vector_norm(Ma.reshape(Ma.shape[0], -1), dim=1)
    nb = torch.linalg.vector_norm(Mb.reshape(Mb.shape[0], -1), dim=1)
    dot = torch.sum(Ma.conj() * Mb, dim=(1, 2))
    denom = torch.where(na * nb > 0, na * nb, 1.0)
    return torch.mean(1.0 - torch.abs(dot / denom) ** 2)


def _index(a, device) -> torch.Tensor:
    """Host plan indices as an int64 device tensor."""
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


class _Rows:
    """Device index data for gathering or scattering one side of a
    two-site class: per bond-slot value j, the class rows with that slot
    (None for all rows) and their bucket positions."""

    def __init__(self, pos: np.ndarray, slot: np.ndarray, device):
        self.parts = []
        for j in np.unique(slot):
            rows = np.nonzero(slot == j)[0]
            self.parts.append(
                (
                    int(j),
                    None if len(rows) == len(slot) else _index(rows, device),
                    _index(pos[rows], device),
                )
            )


class _ClassData:
    """A two-site class's plan data and gates on the device."""

    def __init__(self, cls: _TwoSiteClass, dtype, device):
        self.cls = cls
        self.u = _Rows(cls.u_pos, cls.slot_u, device)
        self.v = _Rows(cls.v_pos, cls.slot_v, device)
        self.env_u = _index(cls.env_u_eids, device)
        self.env_v = _index(cls.env_v_eids, device)
        self.eid_uv = _index(cls.eid_uv, device)
        self.eid_vu = _index(cls.eid_vu, device)
        self.gate_index = _index(cls.gate_index, device)
        self.gates = torch.as_tensor(cls.gates, device=device).to(dtype)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

class LatticeEngine:
    """Batched simple-update evolution on a fixed graph at a fixed bond cap
    (`tnqs/engine.py:562`), starting from the product state "↑".

    The engine runs on the CUDA device unless `device` names another
    (``"cpu"`` for the tests); with no CUDA device the default raises.  On
    CUDA the BP schedule defaults to "color", which the production parity
    runs used; elsewhere to "wavefront", as in the JAX engine on the CPU.

    The switches are the JAX engine's options (`tnqs/engine.py:585-677`),
    taken as constructor arguments only: the port reads none of the JAX
    package's ``TNQS_TRUNC``, ``TNQS_REDUCE`` or ``TNQS_SVD_IMPL``
    environment overrides.  The defaults are the production values.

    - `dtype`: complex64 or complex128.  K1, K2 and K3 are float32 kernels,
      so a complex128 engine launches none of them.
    - `factor_method`: "gram" (per edge-color group, batched: the gauge
      roots of every environment at once, MXU-style reductions) or
      "direct" (per class, one after another: the eigh pseudo-sqrt gauge
      with the library eigh, `torch.linalg.qr` on tall sides and
      `torch.linalg.svd` of theta, as the JAX engine's CPU path).  The
      switches below act on the gram path only.
    - `env_gauge`: "cholesky" (the Cholesky root of each environment) or
      "eigh" (the pseudo-sqrt, its eigensolve through `default_eigh`).
    - `reduce_method`: "cholqr2" (shifted CholeskyQR2 of each tall side) or
      "gram_nofactor" (the Q-free R factor of every tall side's Gram, banked
      into one `gram_rfactor` chain, recombined as X R^{-1} R_new; the
      reference calls it float32-unstable and opt-in).
    - `trunc_method`: "svd" (the SVD of theta, by `svd_impl`), "full"
      (`default_eigh` of each theta's smaller-side Gram) or "subspace"
      (`subspace_eigh` of Grams wider than chi + 16, `default_eigh` below).
    - `svd_impl`, for ``trunc_method="svd"``: "pjsvd" (the Jacobi kernels,
      K2 then K1, for thetas whose smaller side is even and 64..128, the
      library elsewhere: below, and past the kernels' 128 from chi = 65 on),
      "xla" (`torch.linalg.svd` for every theta) or "auto" ("pjsvd" at
      complex64, "xla" at complex128).
    - `bp_kernel` picks the BP sweep of `bp_update`, `normalize` and the
      layer step (`tnqs/engine.py:597-601`): "kernel" routes every degree
      >= 2 group that `ops.supports_group` admits (all of them at chi = 64)
      through `ops.bp_sweep_group` (the CUDA kernel on the card, its plain
      version on the CPU, as JAX's "interpret"), "einsum" keeps the einsum
      chain, and "auto" means "kernel" for complex64 on a CUDA device and
      "einsum" otherwise.  Unlike the JAX engine, the step follows it too:
      the JAX kernel's plane copies, which kept its step on einsum, do not
      exist here.
    - `bp_precision` (`tnqs/engine.py:672-677`, an attribute there): None or
      "highest" (full float32 BP sweeps) or "high", under which every group
      the kernel route takes runs K3 in its "bf16_3x" mode (three bf16
      products a real product, float32 accumulation), in the step's
      refreshes and final run, `bp_update` and `normalize`.  The groups on
      the einsum route (the ones K3 does not take, every group under
      ``bp_kernel="einsum"`` and at complex128) stay full precision: the
      port has no per-op precision (ROADMAP Queue 3).

    Sites: `site_legs` legs of dimension `d0` fold into one site axis of
    d = d0 ** site_legs (`tnqs/engine.py:680-692`): ``site_legs=2`` is an
    operator state, (ket, bra) interleaved as the JAX engine folds them.
    The start is a product state at bond index 0 (`tnqs/engine.py:704`):
    `state` is None ("↑", the first basis vector, on every site), one
    vector of length d for every vertex, or {vertex: vector};
    `identity_operator_vector(d0)` is vec(I), the identity operator state's
    site."""

    def __init__(
        self,
        graph: NamedGraph,
        chi: int,
        dtype: torch.dtype = torch.complex64,
        device=None,
        bp_schedule: str = "auto",
        factor_method: str = "gram",
        env_gauge: str = "cholesky",
        reduce_method: str = "cholqr2",
        trunc_method: str = "svd",
        svd_impl: str = "auto",
        bp_kernel: str = "auto",
        bp_precision: str | None = None,
        site_legs: int = 1,
        d0: int = 2,
        state=None,
    ):
        if dtype not in (torch.complex64, torch.complex128):
            raise NotImplementedError(f"dtype={dtype!r} is not ported; complex64 or complex128")
        switches = {
            "factor_method": (factor_method, ("gram", "direct")),
            "env_gauge": (env_gauge, ("cholesky", "eigh")),
            "reduce_method": (reduce_method, ("cholqr2", "gram_nofactor")),
            "trunc_method": (trunc_method, ("svd", "full", "subspace")),
            "svd_impl": (svd_impl, ("auto", "pjsvd", "xla")),
        }
        for name, (value, known) in switches.items():
            if value not in known:
                raise ValueError(f"unknown {name} {value!r}; one of {known}")
        if bp_kernel == "pallas":
            raise NotImplementedError("bp_kernel='pallas' is the TPU kernel; the port's is 'kernel'")
        if bp_kernel not in ("auto", "kernel", "einsum"):
            raise ValueError(f"unknown bp_kernel {bp_kernel!r}")
        single = dtype == torch.complex64
        if svd_impl == "pjsvd" and not single:
            raise NotImplementedError("svd_impl='pjsvd' runs the float32 Jacobi kernels; complex128 takes 'xla'")
        if bp_kernel == "kernel" and not single:
            raise ValueError("bp_kernel='kernel' is the float32 BP kernel; complex128 takes 'einsum'")
        if bp_precision not in (None, "highest", "high"):
            raise ValueError(f"unknown bp_precision {bp_precision!r}; None, 'highest' or 'high'")
        if int(site_legs) < 1 or int(d0) < 2:
            raise ValueError(f"site_legs={site_legs}, d0={d0}: need site_legs >= 1 and d0 >= 2")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("LatticeEngine runs on the CUDA device and none is available; "
                                   "pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if bp_kernel == "auto":
            bp_kernel = "kernel" if self.device.type == "cuda" and single else "einsum"
        self.bp_kernel = bp_kernel
        self.bp_precision = bp_precision
        self.factor_method, self.env_gauge = factor_method, env_gauge
        self.reduce_method, self.trunc_method = reduce_method, trunc_method
        self.svd_impl = ("pjsvd" if single else "xla") if svd_impl == "auto" else svd_impl
        if bp_schedule == "auto":
            bp_schedule = "color" if self.device.type == "cuda" else "wavefront"
        self.plan = LatticePlan.build(graph, bp_schedule=bp_schedule)
        self.chi = int(chi)
        self.site_legs, self.d0 = int(site_legs), int(d0)
        self.d = self.d0**self.site_legs
        self.dtype = dtype
        self.real_dtype = dtype.to_real()
        self.sqrt_cutoff = 10 * eps_of(self.real_dtype)  # `tnqs/engine.py:701`
        self._bp_groups = []
        for (stage, k, t, src_pos, out_eids, in_eids, other_slots) in self.plan.bp_groups:
            lo, hi = int(src_pos[0]), int(src_pos[-1]) + 1
            src = slice(lo, hi) if hi - lo == len(src_pos) else _index(src_pos, self.device)
            elo, ehi = int(out_eids[0]), int(out_eids[-1]) + 1
            out = slice(elo, ehi) if ehi - elo == len(out_eids) else _index(out_eids, self.device)
            ins = [_index(in_eids[:, col], self.device) for col in range(len(other_slots))]
            rows = _index(src_pos, self.device)
            self._bp_groups.append((stage, k, t, src, out, ins, rows, _index(in_eids, self.device)))
        self.T = self._product_state(state)
        self.M = self._initial_messages()
        self.bp_iterations, self.bp_eps = 0, float("nan")
        self._edge_cls_cache = None
        self._loopcorr_cache: dict = {}

    # -- state ----------------------------------------------------------
    def _product_state(self, state=None) -> dict:
        """The product state `state` on bond index 0 of every bond (the
        packed bond-dimension-1 state of the JAX engine, `tnqs/engine.py:704`):
        None puts "↑" (the first basis vector) on every site, a vector of
        length d goes on every vertex, a dict maps vertex -> vector."""
        T = {}
        for k, verts in self.plan.buckets.items():
            arr = torch.zeros((len(verts), self.d) + (self.chi,) * k, dtype=self.dtype, device=self.device)
            if state is None:
                arr[(slice(None), 0) + (0,) * k] = 1.0
            else:
                vecs = np.stack([np.asarray(state[v] if isinstance(state, dict) else state) for v in verts])
                if vecs.shape != (len(verts), self.d):
                    raise ValueError(f"a site vector has shape {vecs.shape[1:]}, the sites have d = {self.d}")
                arr[(slice(None), slice(None)) + (0,) * k] = torch.as_tensor(vecs, device=self.device).to(self.dtype)
            T[k] = arr
        return T

    def _initial_messages(self) -> torch.Tensor:
        """Identity / chi on every directed edge (`tnqs/engine.py:725`)."""
        eye = torch.eye(self.chi, dtype=self.dtype, device=self.device) / self.chi
        return eye.expand(self.plan.num_edges, self.chi, self.chi).clone()

    @classmethod
    def from_arrays(
        cls, graph: NamedGraph, T: dict, M: np.ndarray, chi: int, dtype=torch.complex64, device=None, **options
    ) -> "LatticeEngine":
        """Engine carrying a packed state: `T` {degree: [n_k, d, chi^k]} and
        `M` [2E, chi, chi] as numpy arrays, laid out by the plan of `graph`
        under the same `bp_schedule` (e.g. a JAX engine's ``eng.T`` and
        ``eng.M``), on the CUDA device unless `device` names another.  The
        arrays are copied."""
        eng = cls(graph, chi, dtype=dtype, device=device, **options)
        new_T = {}
        for k, ref in eng.T.items():
            arr = np.asarray(T[k])
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"T[{k}] has shape {arr.shape}, the plan needs {tuple(ref.shape)}")
            new_T[k] = torch.tensor(arr, dtype=dtype, device=eng.device)
        M = np.asarray(M)
        if M.shape != tuple(eng.M.shape):
            raise ValueError(f"M has shape {M.shape}, the plan needs {tuple(eng.M.shape)}")
        eng.T = new_T
        eng.M = torch.tensor(M, dtype=dtype, device=eng.device)
        return eng

    def to_arrays(self) -> tuple[dict, np.ndarray]:
        """The packed state as host numpy arrays (T by degree, M)."""
        return {k: v.cpu().numpy() for k, v in self.T.items()}, self.M.cpu().numpy()

    # -- the flex tier's types (`tnqs/engine.py:572-763`) ------------------------
    @classmethod
    def from_state(cls, psi, chi: int, dtype=torch.complex64, device=None, **options) -> "LatticeEngine":
        """The counterpart of the JAX package's ``LatticeEngine(psi, chi,
        ...)``: an engine on `psi`'s graph carrying the flex state `psi`
        (bonds zero-padded to `chi`, its site indices kept for `to_state`),
        with the initial messages, on the CUDA device unless `device` names
        another.  A vertex's site legs (all of one dimension, the same
        count on every vertex) fold into its site axis in `siteinds` order."""
        sinds = psi.siteinds()
        dims = {s.dim for v in psi.vertices() for s in sinds[v]}
        if len(dims) != 1:
            raise ValueError("engine requires a uniform site dimension")
        counts = {len(sinds[v]) for v in psi.vertices()}
        if len(counts) != 1:
            raise ValueError("engine requires a uniform site-index count per vertex")
        eng = cls(psi.graph, chi, dtype=dtype, device=device, site_legs=counts.pop(), d0=dims.pop(), **options)
        eng._site_indices = {v: list(sinds[v]) for v in psi.vertices()}
        plan = eng.plan
        for k, verts in plan.buckets.items():
            arr = torch.zeros_like(eng.T[k])
            for p, v in enumerate(verts):
                order = list(sinds[v]) + [psi.virtualind((v, u)) for u in plan.neighbor_order[v]]
                data = psi[v].permute(order).data
                data = data.reshape((eng.d,) + tuple(data.shape[eng.site_legs:]))
                if any(n > eng.chi for n in data.shape[1:]):
                    raise ValueError(f"vertex {v} has a bond wider than chi = {eng.chi}")
                arr[(p, slice(0, eng.d)) + tuple(slice(0, n) for n in data.shape[1:])] = data.to(
                    device=eng.device, dtype=eng.dtype)
            eng.T[k] = arr
        return eng

    def site_indices(self) -> dict:
        """The flex site indices of each vertex: the state's for an engine
        from `from_state`, else fresh ones made at the first call."""
        if getattr(self, "_site_indices", None) is None:
            from .core.index import Index

            tag = {2: "S=1/2", 3: "S=1"}.get(self.d0, "Site")
            self._site_indices = {v: [Index(self.d0, tag) for _ in range(self.site_legs)] for v in self.plan.vertices}
        return self._site_indices

    def to_state(self):
        """The packed state as a flex `TensorNetworkState` on the engine's
        device (bonds stay chi-padded; the zero pads are inert), as
        `tnqs/engine.py:730`."""
        from .core.index import Index
        from .core.tensor import Tensor
        from .networks import TensorNetworkState

        plan = self.plan
        bond = {frozenset(e): Index(self.chi, "Link") for e in plan.graph.edges()}
        sinds = self.site_indices()
        tensors = {}
        for v in plan.vertices:
            k, pos = plan.bucket_pos[v]
            ss = sinds[v]
            data = self.T[k][pos]
            data = data.reshape(tuple(i.dim for i in ss) + tuple(data.shape[1:]))
            tensors[v] = Tensor(data.clone(), list(ss) + [bond[frozenset((v, u))] for u in plan.neighbor_order[v]])
        return TensorNetworkState(tensors, plan.graph.copy(), {v: list(sinds[v]) for v in plan.vertices})

    def to_bp_cache(self):
        """A flex `BeliefPropagationCache` on `to_state()` holding the
        engine's messages, ``M[(u, v)]`` on the bond pair ``(b, b')``
        (`tnqs/engine.py:753`)."""
        from .bp import BeliefPropagationCache
        from .core.tensor import Tensor

        psi = self.to_state()
        bpc = BeliefPropagationCache(psi)
        for (u, v), eid in self.plan.edge_ids.items():
            b = psi.virtualind((u, v))
            bpc.set_message((u, v), Tensor(self.M[eid].clone(), [b, b.prime()]))
        return bpc

    # -- BP sweep (`tnqs/engine.py:784-884`) -------------------------------
    def _bp_new_messages(self, T: dict, M: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
        """One BP iteration: batched within each (stage, degree, slot) group,
        Gauss-Seidel between stages (a stage reads the messages of the
        previous one).  With `use_kernel` and ``bp_kernel="kernel"``, every
        group the fused kernel takes (degree >= 2, `supports_group`) goes
        through `bp_sweep_group`, gathered source rows included; the rest
        stay on the einsum chain, as at `tnqs/engine.py:798-831`."""
        kernel = use_kernel and self.bp_kernel == "kernel"
        mode = "bf16_3x" if self.bp_precision == "high" else "highest"
        stage = None
        out = M
        for (g_stage, k, t, src, dst, ins, rows, in_all) in self._bp_groups:
            if g_stage != stage:
                M = out  # stage barrier
                out = M.clone()
                stage = g_stage
            if kernel and supports_group(k, self.chi, self.dtype):
                m_new = bp_sweep_group(T[k], M[in_all], rows, t, mode)
            else:
                m_new = group_messages(T[k][src], [M[eids] for eids in ins], t)
            # sum-normalize (`tnqs/engine.py:834-836`)
            norm = torch.sum(m_new, dim=(1, 2), keepdim=True)
            out[dst] = m_new / torch.where(torch.abs(norm) > 0, norm, 1.0)
        return out

    def _bp_fixed_point(
        self, T: dict, M: torch.Tensor, maxiter: int, tolerance: float
    ) -> torch.Tensor:
        """BP to `tolerance` or `maxiter` iterations, with the loop of
        `tnqs/engine.py:853-884`: the first update counts as iteration 1,
        then iterate while ``it < maxiter and eps > tolerance``.  The count
        and the last eps stay in `bp_iterations` and `bp_eps`."""
        if self.bp_kernel == "kernel":
            T = {k: v.contiguous() for k, v in T.items()}  # the kernel reads T in place
        M_cur = self._bp_new_messages(T, M)
        eps = _bp_diff(M, M_cur)
        it = 1
        while it < maxiter and float(eps) > tolerance:
            M_new = self._bp_new_messages(T, M_cur)
            eps = _bp_diff(M_cur, M_new)
            M_cur = M_new
            it += 1
        self.bp_iterations, self.bp_eps = it, float(eps)
        return M_cur

    def bp_update(self, maxiter: int = 30, tolerance: float | None = None) -> "LatticeEngine":
        """Run BP on the engine's state to `tolerance` (default by dtype) or
        `maxiter` iterations, through the fused kernel where `bp_kernel`
        says so (`tnqs/engine.py:845`)."""
        if tolerance is None:
            tolerance = default_engine_tolerance(self.dtype)
        self.M = self._bp_fixed_point(self.T, self.M, maxiter, tolerance)
        return self

    # -- gauge and layout (`tnqs/engine.py:887-973`) ---------------------
    def _gather_permuted(self, T: dict, k: int, rows: _Rows) -> torch.Tensor:
        """Bucket-k tensors of one class side with the gate bond moved last:
        [B, d, chi x (k-1), chi_active], one gather per slot value."""
        if len(rows.parts) == 1:
            j, _, pos = rows.parts[0]
            return T[k][pos].movedim(2 + j, -1)
        B = sum(len(pos) for _, _, pos in rows.parts)
        out = torch.empty((B, self.d) + (self.chi,) * k, dtype=self.dtype, device=self.device)
        for j, sel, pos in rows.parts:
            out[sel] = T[k][pos].movedim(2 + j, -1)
        return out

    def _scatter_permuted(self, T: dict, k: int, rows: _Rows, A_new: torch.Tensor) -> None:
        """Inverse of `_gather_permuted`: move the last axis back to its slot
        and write the rows into the bucket in place."""
        for j, sel, pos in rows.parts:
            src = A_new if sel is None else A_new[sel]
            T[k].index_copy_(0, pos, src.movedim(-1, 2 + j))

    def _gauged_matrix(self, A: torch.Tensor, W: torch.Tensor, k: int) -> torch.Tensor:
        """Absorb the environment gauge roots and matricize:
        [B, d, chi x (k-1), chi_active] -> [B, chi^(k-1), d*chi]."""
        B = A.shape[0]
        for j in range(k - 1):
            A = absorb_message(A, W[:, j], axis=2 + j)
        # [B, d, e1..e_{k-1}, a] -> [B, e..., d, a]
        A = A.permute((0,) + tuple(range(2, k + 1)) + (1, k + 1))
        return A.reshape(B, self.chi ** (k - 1), self.d * self.chi)

    def _restore(self, Aflat: torch.Tensor, Winv: torch.Tensor, k: int) -> torch.Tensor:
        """Un-gauge a recombined flat side [B, chi^(k-1), d*chi] and restore
        the [B, d, chi x (k-1), chi_active] layout."""
        B = Aflat.shape[0]
        A = Aflat.reshape((B,) + (self.chi,) * (k - 1) + (self.d, self.chi))
        A = A.permute((0, k) + tuple(range(1, k)) + (k + 1,))  # [B, d, e..., a]
        for j in range(k - 1):
            # contract the bra side with conj(Winv)
            A = torch.einsum("B...j,Bij->B...i", A.movedim(2 + j, -1), Winv[:, j].conj())
            A = A.movedim(-1, 2 + j)
        return A

    # -- gate groups (`tnqs/engine.py:975-1367`) ---------------------------
    def _apply_two_site_class(self, T, M, errors, cd: _ClassData, cutoff: float, normalize: bool) -> None:
        """The direct path's update of one class in place on (T, M, errors)
        (`tnqs/engine.py:975-1007`): per side the eigh pseudo-sqrt gauge of
        its environments (library eigh) and `torch.linalg.qr` when tall
        (wide sides skip it, R = X); theta by the reference's two einsums,
        so rounding follows it; the library SVD."""
        chi, d = self.chi, self.d
        cls = cd.cls
        Bn = len(cls.u_pos)
        sides = []
        for rows, k, env in ((cd.u, cls.ku, cd.env_u), (cd.v, cls.kv, cd.env_v)):
            A = self._gather_permuted(T, k, rows)
            E = M[env] if k > 1 else M.new_zeros((Bn, 0, chi, chi))
            W, Winv = _pseudo_sqrt_roots(E, self.sqrt_cutoff)
            X = self._gauged_matrix(A, W, k)
            if X.shape[1] <= d * chi:
                sides.append((X, None, Winv))
            else:
                Q, R = torch.linalg.qr(X)
                sides.append((R, lambda Rn, Q=Q: Q @ Rn, Winv))
        (Ru, *side_u), (Rv, *side_v) = sides
        ru, rv = Ru.shape[1], Rv.shape[1]
        theta = torch.einsum("Bxda,Byea->Bxdye", Ru.reshape(Bn, ru, d, chi), Rv.reshape(Bn, rv, d, chi))
        theta = torch.einsum("Bxdye,Bpqde->Bxpyq", theta, cd.gates).reshape(Bn, ru * d, rv * d)
        self._finish_two_site(T, M, errors, cd, *_svd_fallback(theta), (ru, *side_u), (rv, *side_v), cutoff,
                              normalize)

    def _apply_two_site_group(self, T, M, errors, classes: list, cutoff: float, normalize: bool) -> None:
        """Apply one edge-color gate group in place on (T, M, errors)
        (`tnqs/engine.py:1009-1308`): one batched gauge over every
        environment of the group (Cholesky roots, or the pseudo-sqrt through
        `default_eigh`), then per class the gauged sides (tall ones reduced
        by CholeskyQR2 or banked into one `gram_rfactor` chain; wide ones
        R = X), theta as one matmul, and one truncation solve per theta
        shape (SVD) or per Gram size (eigh).

        Gathering every class's environments from the pre-group M and
        writing T and M in place are safe: a group's gates are
        vertex-disjoint, so a class writes only its own gate bonds and its
        own rows of T, which no other class of the group reads, and every
        gather (a copy) happens before the first write."""
        chi, d = self.chi, self.d
        eps = eps_of(self.dtype)

        # phase 1: gather both sides, bank every environment
        env_bank, gathered = [], []
        pos = 0
        for cd in classes:
            cls = cd.cls
            Au = self._gather_permuted(T, cls.ku, cd.u)
            Av = self._gather_permuted(T, cls.kv, cd.v)
            sl = []
            for k, eids in ((cls.ku, cd.env_u), (cls.kv, cd.env_v)):
                if k > 1:
                    e = M[eids].reshape(-1, chi, chi)
                    env_bank.append(e)
                    sl.append((pos, e.shape[0]))
                    pos += e.shape[0]
                else:
                    sl.append(None)
            gathered.append((Au, Av, sl))
        if env_bank:
            if self.env_gauge == "cholesky":
                W_all, Winv_all = _cholesky_gauge_roots(torch.cat(env_bank), eps)
            else:
                W_all, Winv_all = _pseudo_sqrt_roots(torch.cat(env_bank), self.sqrt_cutoff, eigh_fn=default_eigh)

        # phase 2: gauge + matricize; a side is (R, recombination R_new ->
        # flat side or None for the identity, Winv).  Wide sides (chi^(k-1)
        # <= d*chi) need no reduction (R = X); tall ones take CholeskyQR2,
        # or bank their Gram for one Q-free `gram_rfactor` chain
        sides, banked = [], []
        for cd, (Au, Av, sl) in zip(classes, gathered):
            cls = cd.cls
            Bn = len(cls.u_pos)
            pair = []
            for A, slot, k in ((Au, sl[0], cls.ku), (Av, sl[1], cls.kv)):
                if slot is None:
                    W = Winv = A.new_zeros((Bn, 0, chi, chi))
                else:
                    start, count = slot
                    W = W_all[start : start + count].reshape(Bn, k - 1, chi, chi)
                    Winv = Winv_all[start : start + count].reshape(Bn, k - 1, chi, chi)
                X = self._gauged_matrix(A, W, k)
                if X.shape[1] <= d * chi:
                    pair.append([X, None, Winv])
                elif self.reduce_method == "gram_nofactor":
                    pair.append([None, X, Winv])  # R and the recombination come from the bank
                    banked.append((pair[-1], X.mH @ X))
                else:
                    Q, R = cholesky_qr(X)
                    pair.append([R, lambda Rn, Q=Q: Q @ Rn, Winv])
            sides.append(pair)
        if banked:
            R_all, L1_all, L2_all = gram_rfactor(torch.cat([G for _, G in banked]))
            ofs = 0
            for side, G in banked:
                b = slice(ofs, ofs + G.shape[0])
                X, L1, L2 = side[1], L1_all[b], L2_all[b]
                side[0], side[1] = R_all[b], lambda Rn, X=X, L1=L1, L2=L2: X @ apply_rinv(L1, L2, Rn)
                ofs += G.shape[0]

        # theta[(x p), (y q)] = gate[p,q,d,e] Ru[x,(d a)] Rv[y,(e a)]: fold
        # the gate into Rv, then one matmul contracting (d, a).  A side keeps
        # only R's row count past this point, so no R outlives its theta
        thetas = []
        for cd, pair in zip(classes, sides):
            (Ru, _, _), (Rv, _, _) = pair
            Bn, ru, rv = Ru.shape[0], Ru.shape[1], Rv.shape[1]
            Rv5 = torch.einsum("Bpqde,Byea->Bdapyq", cd.gates, Rv.reshape(Bn, rv, d, chi))
            theta = (Ru.reshape(Bn, ru, d * chi) @ Rv5.reshape(Bn, d * chi, d * rv * d)).reshape(
                Bn, ru * d, rv * d
            )
            thetas.append(theta)
            pair[0][0], pair[1][0] = ru, rv
        del Ru, Rv, Rv5

        if self.trunc_method == "svd":
            results = self._theta_svds(thetas)
        else:
            results = self._theta_gram_eighs(thetas)

        # phase 4: truncate, recombine, un-gauge, write back
        for cd, (side_u, side_v), res in zip(classes, sides, results):
            self._finish_two_site(T, M, errors, cd, *res[:3], side_u, side_v, cutoff, normalize, tail_extra=res[3])

    def _theta_svds(self, thetas: list) -> list:
        """(U, s, Vh, None) of every theta, one SVD per theta shape
        (`tnqs/engine.py:1195-1268`).  Under ``svd_impl="pjsvd"`` an even
        smaller dimension >= 64 takes `pjsvd` (wide thetas through the
        adjoint; rectangular ones polish 6 sweeps, square 4) where its
        kernels hold the shape (`pjsvd_fits`: even, at most 128); every
        other theta, and every theta under "xla", takes `_svd_fallback`.
        The JAX gate (`tnqs/engine.py:1231-1235`) has no upper limit, since
        its kernels take any even width; the port's K1 and K2 stop at 128,
        so from chi = 65 on (a saturated bond's theta is 2 chi wide at
        d = 2) the thetas take the library SVD instead.  The route depends
        on the shape alone, so it is the same on every device."""
        bank: dict = {}
        for ci, theta in enumerate(thetas):
            bank.setdefault(tuple(theta.shape[1:]), []).append(ci)
        results = [None] * len(thetas)
        for (m_, n_), cis in bank.items():
            Ts = torch.cat([thetas[ci] for ci in cis])
            if self.svd_impl == "pjsvd" and min(m_, n_) >= 64 and pjsvd_fits(max(m_, n_), min(m_, n_)):
                polish = 6 if m_ != n_ else 4
                if m_ >= n_:
                    U, s, Vh = pjsvd(Ts, polish_sweeps=polish)
                else:
                    Ut, s, Vht = pjsvd(Ts.mH, polish_sweeps=polish)
                    U, Vh = Vht.mH, Ut.mH
            else:
                U, s, Vh = _svd_fallback(Ts)
            ofs = 0
            for ci in cis:
                b = slice(ofs, ofs + thetas[ci].shape[0])
                results[ci] = (U[b], s[b], Vh[b], None)
                ofs += thetas[ci].shape[0]
        return results

    def _theta_gram_eighs(self, thetas: list) -> list:
        """(U, s, Vh, tail) of every theta from the eigh of its smaller-side
        Gram, one eigensolve per Gram size (`tnqs/engine.py:1155-1193`, the
        algebra `:1289-1303`): `subspace_eigh` to the top chi + 8 pairs for
        ``trunc_method="subspace"`` and Grams wider than chi + 16, where
        `tail` is the weight it left out; `default_eigh` otherwise."""
        bank: dict = {}
        for ci, theta in enumerate(thetas):
            m_, n_ = theta.shape[1:]
            G = theta @ theta.mH if m_ <= n_ else theta.mH @ theta
            bank.setdefault(min(m_, n_), []).append((ci, G))
        results = [None] * len(thetas)
        for n_small, items in bank.items():
            Gs = torch.cat([G for _, G in items])
            if self.trunc_method == "subspace" and n_small > self.chi + 16:
                w, V, tail = subspace_eigh(self.chi)(Gs)
            else:
                (w, V), tail = default_eigh(Gs), None
            ofs = 0
            for ci, G in items:
                b = slice(ofs, ofs + G.shape[0])
                results[ci] = (*svd_from_eigh(thetas[ci], w[b], V[b]), None if tail is None else tail[b])
                ofs += G.shape[0]
        return results

    def _finish_two_site(self, T, M, errors, cd, U, s, Vh, side_u, side_v, cutoff, normalize, tail_extra=None):
        """Truncation, recombination (each side's (rows of R, recombination
        R_new -> the flat side or None for the identity, Winv)), gauge
        removal, scatter and singular-value message writeback
        (`tnqs/engine.py:1310`), in place."""
        chi, d = self.chi, self.d
        cls = cd.cls
        Bn = len(cls.u_pos)
        (ru, recomb_u, Winv_u), (rv, recomb_v, Winv_v) = side_u, side_v
        s_m, _, err = _truncate_mask(s.to(self.real_dtype), chi, cutoff, tail_extra)
        K = s.shape[1]
        if K >= chi:
            U, Vh = U[:, :, :chi], Vh[:, :chi, :]
        else:
            U, Vh = F.pad(U, (0, chi - K)), F.pad(Vh, (0, 0, 0, chi - K))
        if normalize:
            s_norm = torch.linalg.vector_norm(s_m, dim=1, keepdim=True)
            s_m = s_m / torch.where(s_norm > 0, s_norm, 1.0)
        rs = torch.sqrt(s_m).to(self.dtype)
        Ru_new = (U * rs[:, None, :]).reshape(Bn, ru, d * chi)
        Rv_new = (rs[:, :, None] * Vh).mT.reshape(Bn, rv, d * chi)
        if recomb_u is not None:
            Ru_new = recomb_u(Ru_new)
        if recomb_v is not None:
            Rv_new = recomb_v(Rv_new)
        Au_new = self._restore(Ru_new, Winv_u, cls.ku)
        Av_new = self._restore(Rv_new, Winv_v, cls.kv)
        if normalize:
            Au_new, Av_new = _unit_rows(Au_new), _unit_rows(Av_new)
        self._scatter_permuted(T, cls.ku, cd.u, Au_new)
        self._scatter_permuted(T, cls.kv, cd.v, Av_new)
        m_diag = torch.diag_embed(s_m.to(self.dtype))
        M[cd.eid_uv] = m_diag
        M[cd.eid_vu] = m_diag
        errors[cd.gate_index] = err

    def _apply_one_site_group(self, T: dict, gates: dict) -> None:
        """Apply a one-site group; `gates` maps a degree to (positions
        [B] device tensor or None for a whole bucket in bucket order,
        gates [B, d, d])."""
        for k, (pos, G) in gates.items():
            if pos is None:  # e.g. a transverse-field kick on every qubit
                T[k] = torch.einsum("Bps,Bs...->Bp...", G, T[k])
            else:
                T[k].index_copy_(0, pos, torch.einsum("Bps,Bs...->Bp...", G, T[k][pos]))

    # -- layer step (`tnqs/engine.py:1370-1483`) ---------------------------
    def make_step(
        self,
        circuit: Sequence,
        cutoff: float = 0.0,
        normalize: bool = True,
        bp_maxiter: int = 30,
        bp_tolerance: float | None = None,
        bp_inner_maxiter: int = 2,
        layers_per_call: int = 1,
    ):
        """Build ``step(T, M) -> (T, M, errors)`` applying `layers_per_call`
        repetitions of the circuit layer; `errors` is [n_gates] for one
        layer and [layers_per_call, n_gates] otherwise.

        BP refreshes precede every two-site group whose vertices were
        touched since the last one (`build_program`), capped at
        `bp_inner_maxiter` iterations: they only feed the gauge, which
        cancels exactly, and the truncation weighting.  The layer ends with
        a BP run to `bp_tolerance` or `bp_maxiter`.  Both take the sweep
        `bp_kernel` picks: the JAX step's ``use_kernel=False``
        (`tnqs/engine.py:1433`, `:1445`) saved its TPU kernel's plane copies
        of every site tensor, and the port's kernel reads T in place.  The
        step writes into the T and M it is given, and keeps every T[k]
        contiguous, so the kernel takes it without a copy."""
        if bp_tolerance is None:
            bp_tolerance = default_engine_tolerance(self.dtype)
        compiled = compile_circuit(self.plan, circuit, d=self.d)
        program = build_program(self.plan, compiled)
        group_data = {}
        for gidx, grp in enumerate(compiled):
            if isinstance(grp, OneSiteGroup):
                data = {}
                for k, (pos, g, _) in grp.per_bucket.items():
                    G = torch.as_tensor(g, device=self.device).to(self.dtype)
                    if len(pos) == len(self.plan.buckets[k]):
                        perm = np.zeros(len(pos), dtype=np.int64)
                        perm[pos] = np.arange(len(pos))
                        data[k] = (None, G[_index(perm, self.device)])
                    else:
                        data[k] = (_index(pos, self.device), G)
                group_data[gidx] = data
            else:
                group_data[gidx] = [_ClassData(c, self.dtype, self.device) for c in grp.classes]
        n_gates = len(circuit)
        inner = min(bp_maxiter, bp_inner_maxiter)

        def layer(T, M):
            errors = torch.zeros((n_gates,), dtype=self.real_dtype, device=self.device)
            for entry in program:
                if entry[0] == "bp":
                    M = self._bp_fixed_point(T, M, inner, bp_tolerance)
                elif entry[0] == "one":
                    self._apply_one_site_group(T, group_data[entry[2]])
                elif self.factor_method == "gram":
                    self._apply_two_site_group(T, M, errors, group_data[entry[2]], cutoff, normalize)
                else:  # direct: class by class, each seeing the previous one's writes
                    for cd in group_data[entry[2]]:
                        self._apply_two_site_class(T, M, errors, cd, cutoff, normalize)
            M = self._bp_fixed_point(T, M, bp_maxiter, bp_tolerance)
            return T, M, errors

        L = int(layers_per_call)

        def step(T, M):
            T = dict(T)
            if L == 1:
                return layer(T, M)
            all_errors = []
            for _ in range(L):
                T, M, errors = layer(T, M)
                all_errors.append(errors)
            return T, M, torch.stack(all_errors)

        return step

    def evolve(self, circuit: Sequence, num_layers: int = 1, **kwargs) -> np.ndarray:
        """Apply `num_layers` repetitions of `circuit`; returns the per-layer
        truncation errors [num_layers, n_gates]."""
        step = self.make_step(circuit, **kwargs)
        all_errors = []
        for _ in range(num_layers):
            self.T, self.M, errors = step(self.T, self.M)
            all_errors.append(errors)
        return torch.stack(all_errors).cpu().numpy()

    # -- rank ladder (`tnqs/engine.py:1486-1566`) -------------------------
    def resize_chi(self, chi_new: int) -> "LatticeEngine":
        """A new engine at bond cap `chi_new` carrying this state: every bond
        axis of T and M zero-padded (grow, lossless) or sliced (shrink, safe
        while the bonds' rank stays below the new cap) on the device.  The
        plan and the options are shared; the caches kept per chi are not."""
        chi_new = int(chi_new)
        if chi_new == self.chi:
            return self
        eng = copy.copy(self)
        eng.chi = chi_new
        eng._edge_cls_cache = None
        eng._loopcorr_cache = {}
        delta = chi_new - self.chi

        def fix(arr, first, n):
            if delta > 0:
                return F.pad(arr, (0, delta) * n)  # the last n axes are the bonds
            return arr[(slice(None),) * first + (slice(0, chi_new),) * n].clone(memory_format=torch.contiguous_format)

        eng.T = {k: fix(arr, 2, k) for k, arr in self.T.items()}
        eng.M = fix(self.M, 1, 2)
        return eng

    def evolve_ladder(self, circuit: Sequence, num_layers: int, rungs: Sequence = (8, 16, 32, 64), observe=None,
                      **kwargs):
        """Rank-adaptive evolution (`tnqs/engine.py:1518`): from a product
        state a bond's rank after L layers is at most growth^L, growth = d to
        the most two-site gates on one edge of a layer, so each layer runs at
        the smallest rung at or above that bound (the rungs below this
        engine's chi, then chi).  Returns ``(engine at the last rung, errors
        [num_layers, n_gates])``; `self` is left as it was.  `observe`, if
        given, is called as ``observe(layer, engine)`` after each layer
        (layer from 1), on the rung's engine; the rest of `kwargs` go to
        `make_step`."""
        rung_list = sorted({int(r) for r in rungs if int(r) < self.chi} | {self.chi})
        per_edge: dict = {}
        for gate in circuit:
            verts = list(gate[1])
            if len(verts) == 2:
                key = frozenset(verts)
                per_edge[key] = per_edge.get(key, 0) + 1
        growth = self.d ** max(per_edge.values()) if per_edge else 1
        # the step writes into the state it is given: run on a copy of self's
        eng = copy.copy(self)
        eng.T, eng.M = {k: v.clone() for k, v in self.T.items()}, self.M.clone()
        eng._loopcorr_cache = {}
        rank, step, all_errors = 1, None, []
        for _ in range(num_layers):
            rank = min(rank * growth, self.chi)
            target = next(r for r in rung_list if r >= rank)
            if target != eng.chi:
                eng, step = eng.resize_chi(target), None
            if step is None:
                step = eng.make_step(circuit, **kwargs)
            eng.T, eng.M, errors = step(eng.T, eng.M)
            all_errors.append(errors)
            if observe is not None:
                observe(len(all_errors), eng)
        return eng, torch.stack(all_errors).cpu().numpy()

    # -- measurement (`tnqs/engine.py:1566-1961`) -------------------------
    def _closed(self, T: dict, M: torch.Tensor, k: int) -> torch.Tensor:
        """Bucket-k tensors with the incoming message of every bond absorbed."""
        plan = self.plan
        in_eids = np.array(
            [[plan.edge_ids[(u, v)] for u in plan.neighbor_order[v]] for v in plan.buckets[k]], dtype=np.int64
        ).reshape(-1, k)
        A = T[k]
        for j in range(k):
            A = absorb_message(A, M[_index(in_eids[:, j], self.device)], axis=2 + j)
        return A

    def _edge_index(self, edges) -> tuple[torch.Tensor, torch.Tensor]:
        """Message ids (u -> v, v -> u) of each undirected edge (u, v)."""
        ids = self.plan.edge_ids
        return _index([ids[(u, v)] for (u, v) in edges], self.device), _index([ids[(v, u)] for (u, v) in edges], self.device)

    def _op(self, opname: str) -> torch.Tensor:
        return torch.as_tensor(op_matrix(opname), device=self.device).to(self.dtype)

    def _expect_1site_all(self, T: dict, M: torch.Tensor, op: torch.Tensor) -> dict:
        """<op_v> for every vertex via BP, batched per degree bucket."""
        outs = {}
        for k in self.plan.buckets:
            A = self._closed(T, M, k)
            Tc = T[k].conj()
            axes = "".join(chr(ord("a") + j) for j in range(k))
            denom = torch.einsum(f"Bs{axes},Bs{axes}->B", A, Tc)
            numer = torch.einsum(f"Bs{axes},ps,Bp{axes}->B", A, op, Tc)
            outs[k] = numer / denom
        return outs

    def expect_1site(self, opname: str) -> dict:
        """BP expectation of a one-site operator on every vertex."""
        outs = self._expect_1site_all(self.T, self.M, self._op(opname))
        result = {}
        for k, verts in self.plan.buckets.items():
            vals = outs[k].cpu().numpy()
            for i, v in enumerate(verts):
                result[v] = complex(vals[i])
        return result

    def _edge_classes(self) -> list:
        """Undirected edges batched by (deg u, deg v), one entry per edge in
        its stored orientation (`tnqs/engine.py:1600`): (ku, kv, edges, u
        rows, v rows, u env message ids [B, ku-1], v env message ids), the
        rows and ids as device data."""
        if self._edge_cls_cache is not None:
            return self._edge_cls_cache
        plan = self.plan
        classes: dict = {}
        for (u, v) in plan.graph.edges():
            ku, up = plan.bucket_pos[u]
            kv, vp = plan.bucket_pos[v]
            su = plan.neighbor_order[u].index(v)
            sv = plan.neighbor_order[v].index(u)
            env_u = [plan.edge_ids[(plan.neighbor_order[u][j], u)] for j in range(ku) if j != su]
            env_v = [plan.edge_ids[(plan.neighbor_order[v][j], v)] for j in range(kv) if j != sv]
            classes.setdefault((ku, kv), []).append(((u, v), up, vp, su, sv, env_u, env_v))
        out = []
        for (ku, kv), items in sorted(classes.items()):
            col = lambda i: np.array([it[i] for it in items], dtype=np.int64)  # noqa: E731
            out.append(
                (
                    ku,
                    kv,
                    [it[0] for it in items],
                    _Rows(col(1), col(3), self.device),
                    _Rows(col(2), col(4), self.device),
                    _index(col(5).reshape(len(items), ku - 1), self.device),
                    _index(col(6).reshape(len(items), kv - 1), self.device),
                )
            )
        self._edge_cls_cache = out
        return out

    def _expect_2site_all(self, T: dict, M: torch.Tensor, op_u: torch.Tensor, op_v: torch.Tensor) -> list:
        """<op_u op_v> on every edge via the two-site BP region, batched per
        (deg u, deg v) class (`tnqs/engine.py:1634`)."""
        outs = []
        for (ku, kv, _, rows_u, rows_v, env_u, env_v) in self._edge_classes():
            Au0 = self._gather_permuted(T, ku, rows_u)  # [B, d, env..., bond]
            Av0 = self._gather_permuted(T, kv, rows_v)
            Au, Av = Au0, Av0
            for col in range(ku - 1):
                Au = absorb_message(Au, M[env_u[:, col]], axis=2 + col)
            for col in range(kv - 1):
                Av = absorb_message(Av, M[env_v[:, col]], axis=2 + col)
            eu = "".join(chr(ord("a") + j) for j in range(ku - 1))
            ev = "".join(chr(ord("f") + j) for j in range(kv - 1))
            # half transfer matrices on the shared bond: [B, d_out, d_in, x, y]
            hu = torch.einsum(f"Bs{eu}x,Bt{eu}y->Bstxy", Au, Au0.conj())
            hv = torch.einsum(f"Bs{ev}x,Bt{ev}y->Bstxy", Av, Av0.conj())
            denom = torch.einsum("Bssxy,Bppxy->B", hu, hv)
            # hu[s,t,..] pairs ket index s with bra index t: <O> inserts O[t,s]
            numer = torch.einsum("Bstxy,ts,Bpqxy,qp->B", hu, op_u, hv, op_v)
            outs.append(numer / denom)
        return outs

    def expect_2site(self, opname_u: str, opname_v: str) -> dict:
        """BP expectation of a two-site operator on every edge of the
        lattice: {edge: value}.  The region is the two site tensors plus
        their incoming messages."""
        outs = self._expect_2site_all(self.T, self.M, self._op(opname_u), self._op(opname_v))
        result = {}
        for (_, _, edges, *_), vals in zip(self._edge_classes(), outs):
            for e, x in zip(edges, vals.cpu().numpy()):
                result[e] = complex(x)
        return result

    def _bp_scalars(self, T: dict, M: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """(vertex scalars per bucket, edge scalars) of the BP fixed point
        (`tnqs/engine.py:1679`): a vertex closed with all its incoming
        messages; <m_e, m_e~> per undirected edge."""
        vs = {}
        for k in self.plan.buckets:
            axes = "".join(chr(ord("a") + j) for j in range(k))
            vs[k] = torch.einsum(f"Bs{axes},Bs{axes}->B", self._closed(T, M, k), T[k].conj())
        idx1, idx2 = self._edge_index(self.plan.graph.edges())
        return vs, torch.einsum("eij,eij->e", M[idx1], M[idx2])

    def freenergy(self):
        """BP free energy log Z = sum log(vertex scalars) - sum log(edge
        scalars) (`tnqs/engine.py:1703`), complex when a term is complex or
        negative, -inf when an edge scalar is zero.  For a state Z is the BP
        estimate of <psi|psi>."""
        vs, es = self._bp_scalars(self.T, self.M)
        numer = np.concatenate([v.cpu().numpy().ravel() for v in vs.values()])
        denom = es.cpu().numpy().ravel()
        if np.any(denom == 0):
            return -np.inf
        f = _log_sum(numer) - _log_sum(denom)
        if isinstance(f, complex) and f.imag == 0:
            f = f.real
        return f

    def partitionfunction(self):
        """exp(freenergy) (`tnqs/engine.py:1727`)."""
        return _z_from_freenergy(self.freenergy())

    # -- loop corrections (`tnqs/engine.py:1733-1862`) ----------------------
    def _doubled_vertex(self, v, open_slots: list, Ts: dict, Ms: torch.Tensor) -> torch.Tensor:
        """Ket and bra of vertex v contracted over the site axis, with the
        message into v absorbed on every bond but `open_slots`, which stay
        open as (ket, bra) axis pairs in the order given."""
        plan = self.plan
        k, pos = plan.bucket_pos[v]
        A = Ts[k][pos : pos + 1]
        X = A
        for j, u in enumerate(plan.neighbor_order[v]):
            if j not in open_slots:
                X = absorb_message(X, Ms[plan.edge_ids[(u, v)]][None], 2 + j)
        ket = "s" + "".join(chr(ord("a") + j) for j in range(k))
        bra = "s" + "".join(chr(ord("A") + j) if j in open_slots else chr(ord("a") + j) for j in range(k))
        out = "".join(chr(ord("a") + j) + chr(ord("A") + j) for j in open_slots)
        return torch.einsum(f"{ket},{bra}->{out}", X[0], A[0].conj())

    def _cycle_vertex_transfer(self, v, prev_v, next_v, Ts: dict, Ms: torch.Tensor) -> torch.Tensor:
        """Doubled transfer matrix [chi^2, chi^2] of a cycle vertex
        (`tnqs/engine.py:1734`): rows the (ket, bra) pair of the bond from
        prev_v, columns that of the bond to next_v, the messages into v
        absorbed on its off-cycle bonds."""
        order = self.plan.neighbor_order[v]
        D = self._doubled_vertex(v, [order.index(prev_v), order.index(next_v)], Ts, Ms)
        return D.reshape(self.chi * self.chi, self.chi * self.chi)

    def _cycle_weights(self, group: list, Ts: dict, Ms: torch.Tensor) -> torch.Tensor:
        """Sum of the weights of same-length simple cycles (vertex walks):
        trace of the ring product of T_i (1 - m_in m_out^T) per cycle, where
        m_in is the message into cycle vertex i from i+1 and m_out the one
        into i+1 (`_cycle_bond_op`, `tnqs/engine.py:1760`; the antiprojector
        is applied as its rank-one update rather than as a matrix), batched
        over the cycles as [G, chi^2, chi^2] products."""
        ids, chi = self.plan.edge_ids, self.chi
        L, W = len(group[0]), None
        for i in range(L):
            step = torch.empty((len(group), chi * chi, chi * chi), dtype=self.dtype, device=self.device)
            for c, cyc in enumerate(group):
                step[c] = self._cycle_vertex_transfer(cyc[i], cyc[i - 1], cyc[(i + 1) % L], Ts, Ms)
            m_in = Ms[_index([ids[(cyc[(i + 1) % L], cyc[i])] for cyc in group], self.device)].reshape(-1, chi * chi)
            m_out = Ms[_index([ids[(cyc[i], cyc[(i + 1) % L])] for cyc in group], self.device)].reshape(-1, chi * chi)
            step -= (step @ m_in[:, :, None]) @ m_out[:, None, :]
            W = step if W is None else W @ step
            del step
        return torch.diagonal(W, dim1=1, dim2=2).sum()

    def _configuration_weight(self, eg: list, Ts: dict, Ms: torch.Tensor) -> torch.Tensor:
        """Weight of any configuration (edge list) on the rescaled fixed
        point, with the flex tier's semantics (`tnqs/loopcorrections.py:
        32-95`): each of its vertices' doubled tensor with the message into
        it on every bond outside the configuration (chords included), and
        on each configuration edge (u, v) the antiprojector 1 - m_{v->u}
        m_{u->v}, each endpoint taking the message into it.  One contraction
        by `ceinsum`'s pairwise path; up to 13 edges (4 index letters each)."""
        plan = self.plan
        if len(eg) > 13:
            raise NotImplementedError(f"a non-cycle configuration of {len(eg)} edges (at most 13)")
        vs = list(dict.fromkeys(v for e in eg for v in e))
        in_config = {frozenset(e) for e in eg}
        letters = iter(string.ascii_letters)
        end = {}  # (v, u) -> (ket, bra) labels of bond (v, u) at v's end
        for (u, v) in eg:
            end[(u, v)] = next(letters) + next(letters)
            end[(v, u)] = next(letters) + next(letters)
        terms, ops = [], []
        for v in vs:
            order = plan.neighbor_order[v]
            cfg = [j for j, u in enumerate(order) if frozenset((v, u)) in in_config]
            ops.append(self._doubled_vertex(v, cfg, Ts, Ms))
            terms.append("".join(end[(v, order[j])] for j in cfg))
        chi = self.chi
        eye = torch.eye(chi, dtype=self.dtype, device=self.device)
        for (u, v) in eg:
            m_u, m_v = Ms[plan.edge_ids[(v, u)]], Ms[plan.edge_ids[(u, v)]]  # into u, into v
            ops.append(torch.einsum("ac,bd->abcd", eye, eye) - torch.einsum("ab,cd->abcd", m_u, m_v))
            terms.append(end[(u, v)] + end[(v, u)])
        return ceinsum(",".join(terms) + "->", *ops)

    def loopcorrected_partitionfunction(self, max_configuration_size: int):
        """Z_BP (1 + sum of the loop-series weights) over every leafless
        configuration of at most `max_configuration_size` edges
        (`tnqs/engine.py:1771`), on the rescaled fixed point (`_rescaled`;
        the engine's own state is not changed).  Simple cycles go through
        batched ring products of doubled transfer matrices (`_cycle_weights`),
        the rest through one contraction each (`_configuration_weight`, the
        flex weight, which the JAX engine takes from its flex tier).  The
        configurations are enumerated once per size and kept."""
        zbp = self.partitionfunction()
        size = int(max_configuration_size)
        if size not in self._loopcorr_cache:
            by_len, others = {}, []
            for eg in leafless_edge_induced_subgraphs(self.plan.graph, size):
                cyc = _cycle_order(eg)
                if cyc is None:
                    others.append(eg)
                else:
                    by_len.setdefault(len(cyc), []).append(cyc)
            self._loopcorr_cache[size] = (by_len, others)
        by_len, others = self._loopcorr_cache[size]
        if not by_len and not others:
            return zbp
        Ts, Ms = self._rescaled(self.T, self.M)
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for L in sorted(by_len):
            total = total + self._cycle_weights(by_len[L], Ts, Ms)
        for eg in others:
            total = total + self._configuration_weight(eg, Ts, Ms)
        return zbp * (1 + complex(total.item()))

    def _rescaled(self, T: dict, M: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """Every message pair to unit overlap, then every vertex tensor by
        1/sqrt(its vertex scalar): afterwards all local BP scalars, and so
        Z_BP, are 1 (`tnqs/engine.py:1861`).  A real dtype cannot take a
        complex root: there the pair overlap is sign-flipped onto +1 and a
        vertex keeps the sign of its scalar."""
        idx1, idx2 = self._edge_index(self.plan.graph.edges())
        m1, m2 = _unit_rows(M[idx1]), _unit_rows(M[idx2])
        n = torch.einsum("eij,eij->e", m1, m2)[:, None, None]
        if M.is_complex():
            root = torch.sqrt(torch.where(n.abs() > 0, n, 1.0))
            m1n, m2n = m1 / root, m2 / root
        else:
            sign = torch.where(n < 0, -1.0, 1.0).to(M.dtype)
            root = torch.sqrt(torch.where(n.abs() > 0, n.abs(), 1.0))
            m1n, m2n = m1 * sign / root, m2 / root
        Mn = M.clone()
        Mn[idx1] = m1n
        Mn[idx2] = m2n
        vs, _ = self._bp_scalars(T, Mn)
        Tn = {}
        for k, q in vs.items():
            r = torch.sqrt(torch.where(q.abs() > 0, q if q.is_complex() else q.abs(), 1.0))
            Tn[k] = T[k] / r.reshape((-1,) + (1,) * (T[k].dim() - 1))
        return Tn, Mn

    def rescale(self) -> "LatticeEngine":
        """In place: all local BP scalars to 1 (`tnqs/engine.py:1905`)."""
        self.T, self.M = self._rescaled(self.T, self.M)
        return self

    def normalize(self, bp_maxiter: int = 30) -> "LatticeEngine":
        """BP-normalize the state: converge the messages, then rescale so
        Z_BP = <psi|psi>_BP = 1 (`tnqs/engine.py:1910`)."""
        self.bp_update(maxiter=bp_maxiter)
        return self.rescale()

    def _bond_spectra(self, M: torch.Tensor, idx1: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
        """Eigenvalues of rho_e = sqrt(m_rev) m_fwd sqrt(m_rev) per bond,
        similar to m_fwd m_rev: the bond spectrum read off the BP fixed
        point (`tnqs/engine.py:1919`)."""
        m1 = M[idx1]
        m2 = M[idx2]
        m1 = 0.5 * (m1 + m1.mH)
        m2 = 0.5 * (m2 + m2.mH)
        w2, V2 = torch.linalg.eigh(m2)
        root = torch.sqrt(torch.clamp(w2, min=0.0))
        W2 = torch.einsum("eij,ej,ekj->eik", V2, root.to(V2.dtype), V2.conj())
        rho = torch.einsum("eij,ejk,ekl->eil", W2, m1, W2)
        rho = 0.5 * (rho + rho.mH)
        return torch.linalg.eigvalsh(rho)

    def bond_entropies(self, alpha: float = 1.0, edges=None) -> dict:
        """Renyi-alpha entanglement entropy of every bond (or of `edges`)
        from the converged messages (`tnqs/engine.py:1936`); alpha = 1 is
        von Neumann.  Returns {edge: entropy}."""
        if edges is None:
            edges = list(self.plan.graph.edges())
        lam = self._bond_spectra(self.M, *self._edge_index(edges)).cpu().numpy()
        out = {}
        for e, lams in zip(edges, lam):
            lams = lams / np.sum(lams)  # trace-normalize
            lams = lams[np.abs(lams) > 10 * np.finfo(lams.dtype).eps]
            if alpha == 1:
                out[tuple(e)] = float(-np.sum(lams * np.log(lams)))
            else:
                out[tuple(e)] = float(np.log(np.sum(lams**alpha)) / (1 - alpha))
        return out


def _cycle_order(eg) -> list | None:
    """The vertex walk of an edge set that is one simple cycle, or None
    (`tnqs/engine.py:1973`)."""
    adj: dict = {}
    for (u, v) in eg:
        adj.setdefault(u, []).append(v)
        adj.setdefault(v, []).append(u)
    if any(len(ns) != 2 for ns in adj.values()):
        return None
    start = next(iter(adj))
    cyc, prev, cur = [start], None, start
    while True:
        a, b = adj[cur]
        nxt = b if a == prev else a
        if nxt == start:
            break
        cyc.append(nxt)
        prev, cur = cur, nxt
        if len(cyc) > len(adj):
            return None
    return cyc if len(cyc) == len(adj) else None


def identity_operator_vector(d0: int = 2) -> np.ndarray:
    """vec(I) of an operator site, (ket, bra) interleaved as the engine
    folds them (`tnqs/engine.py:686-692`): the identity operator state's
    site vector for ``site_legs=2``."""
    return np.eye(d0).reshape(-1)


def _log_sum(terms: np.ndarray):
    """sum(log(terms)), complex when a term is complex or negative."""
    if np.any(np.iscomplex(terms)) or np.any(np.real(terms) < 0):
        return complex(np.sum(np.log(terms.astype(complex))))
    return float(np.sum(np.log(np.real(terms))))


def _z_from_freenergy(f):
    """exp(log Z), an exactly real complex value demoted to float
    (`tnqs/engine.py:1964`)."""
    z = np.exp(f)
    if isinstance(z, complex) and z.imag == 0:
        z = z.real
    return z
