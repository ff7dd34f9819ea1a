"""Boundary-MPS measurement of engine states: expectation values, RDMs,
overlaps and certified sampling.

Port of `tnqs/bmps_engine.py`: the expectation tier (`:58-1503`) and the
certified sampler `BMPSSampler` (`:1504-2174`, at the end of this module):

* a static :class:`ColumnPlan` derived once from the engine's lattice:
  columns (vertices grouped by a column key, ordered by a row key), the
  cross edges of every cut, and ring (periodic) detection;
* the boundary MPS at every cut, built by zip-up sweeps through each column
  (`BMPSEngine._zip_column`).  An emit vertex whose step matrix is small is
  truncated by an exact SVD; a larger one by a randomized range finder: a
  sketch, `power_iters` rounds of subspace iteration, exact whitening
  through the small [x, x] Gram eigh and an oversampled truncation, so
  every large operation is a matrix product;
* expectations by a per-column "ladder" between the left and right
  boundary MPSes with prefix/suffix environments, and overlaps by bilinear
  sweeps with the bra layer from a second state;
* samples drawn column by column from conditional RDM diagonals between
  the right boundary MPSes and a bit-projected left one, with their p/q
  certificates (`BMPSSampler`).

Scale factors are dropped throughout (every emission is norm-rescaled) and
cancel in the ratios; overlaps carry them in log space.

The JAX module compiles the sweeps into XLA programs; here they run
eagerly, every contraction as pairwise `torch.einsum` calls in the JAX
code's order (`utils.einsum_cache.ceinsum` where it searched one).  The
tier reaches no Pallas kernel in JAX and no hand-written kernel here.  The
small eighs and the exact-emit SVDs are the library's (`library_eigh`,
`library_svd`: gesvd on the card), counted in `_eigh.calls` and
`_svd.calls`: on the card each is a host synchronisation.

The sketches cannot be JAX's (`jax.random.fold_in`, `:713-720`).  The
default, `cpu_sketch`, draws from a `torch.Generator` seeded from (`seed`,
code) on the CPU and moves the draw to the engine's device, so one seed
gives one sketch on every device; `BMPSEngine(sketch=...)` takes any other
draw, e.g. JAX's own in the tests.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
from itertools import product

import numpy as np
import torch

from .engine import LatticeEngine
from .sitetypes import op_matrix
from .ops.factorizations import library_eigh, library_svd
from .utils.einsum_cache import ceinsum


# ----------------------------------------------------------------------
# static plan
# ----------------------------------------------------------------------


@dataclass
class ColumnPlan:
    """Static column decomposition of a lattice for boundary-MPS sweeps
    (`tnqs/bmps_engine.py:58`).

    `periodic` marks a ring column quotient (cylinder-class lattices:
    periodic across columns, each column an open path).  Ring plans carry
    nC cuts: `cross[nC-1]` is the wrap cut between the last and first
    columns."""

    columns: list  # list of ordered vertex lists
    cross: list  # cross[c] = ordered cross edges (u in col c, w in col c+1)
    col_of: dict
    order_in_col: dict  # vertex -> position in its column
    periodic: bool = False

    def side(self, v, u) -> str:
        """Which axis role neighbor `u` plays for vertex `v`: up/down along
        the column, left/right across cuts (wrap-aware on ring plans:
        column 0's neighbor in the last column sits to its left)."""
        cv, cu = self.col_of[v], self.col_of[u]
        if cv == cu:
            return "u" if self.order_in_col[u] < self.order_in_col[v] else "d"
        d = cu - cv
        if self.periodic and abs(d) == len(self.columns) - 1:
            d = -d
        return "l" if d < 0 else "r"

    @staticmethod
    def build(plan, column_of=None, row_of=None) -> "ColumnPlan":
        """Columns of `plan` (a `LatticePlan`) by `column_of(v)` (default
        v[0]), each ordered by `row_of(v)` (default v[1]).  Raises
        ValueError where a boundary MPS chain is ill-defined: a column that
        is not a path in row order, an edge across non-adjacent columns, wrap
        edges without a ring, crossing edges in a cut, or a vertex with two
        cross bonds on one side."""
        if column_of is None:
            column_of = lambda v: v[0]  # noqa: E731
        if row_of is None:
            row_of = lambda v: v[1]  # noqa: E731
        cols: dict = {}
        for v in plan.vertices:
            cols.setdefault(column_of(v), []).append(v)
        keys = sorted(cols)
        columns = [sorted(cols[k], key=row_of) for k in keys]
        col_index = {k: i for i, k in enumerate(keys)}
        col_of = {v: col_index[column_of(v)] for v in plan.vertices}
        order_in_col = {v: i for cl in columns for i, v in enumerate(cl)}

        nC = len(columns)
        cross: list = [[] for _ in range(nC - 1)]
        wrap: list = []
        for (u, w) in plan.graph.edges():
            cu, cw = col_of[u], col_of[w]
            if cu == cw:
                if abs(order_in_col[u] - order_in_col[w]) != 1:
                    raise ValueError(f"column is not a path in row order (non-adjacent intra-column edge {(u, w)})")
                continue
            if abs(cu - cw) == nC - 1 and nC > 2:
                # wrap edge (ring column quotient): oriented (last col, col 0)
                wrap.append((u, w) if cu > cw else (w, u))
                continue
            if abs(cu - cw) != 1:
                raise ValueError(f"edge {(u, w)} spans non-adjacent columns")
            a, b = (u, w) if cu < cw else (w, u)
            cross[min(cu, cw)].append((a, b))
        periodic = bool(wrap)
        if periodic:
            cross.append(wrap)  # cut nC-1: last column -> column 0
            # a ring quotient connects every consecutive column pair (mod
            # nC); one stray long-range edge must not enable the closure
            empty = [c for c, es in enumerate(cross) if not es]
            if empty:
                raise ValueError(
                    f"wrap edges {wrap} imply a ring column quotient, but cut(s) {empty} are empty — the "
                    "quotient is not a ring (stray long-range edge?); use the flex tier"
                )
        for c, es in enumerate(cross):
            by_src = sorted(es, key=lambda e: order_in_col[e[0]])
            by_dst = sorted(es, key=lambda e: order_in_col[e[1]])
            if by_src != by_dst:
                raise ValueError(f"cut {c} has crossing edges; boundary-MPS chain order is ill-defined "
                                 "(use the flex tier)")
            cross[c] = by_src
        for v in plan.vertices:
            n_l = sum(1 for es in cross for e in es if e[1] == v)
            n_r = sum(1 for es in cross for e in es if e[0] == v)
            if n_l > 1 or n_r > 1:
                raise ValueError(f"vertex {v} has multiple cross bonds on one side; unsupported (use the flex tier)")
        return ColumnPlan(columns=columns, cross=cross, col_of=col_of, order_in_col=order_in_col, periodic=periodic)


# ----------------------------------------------------------------------
# library calls and sketches
# ----------------------------------------------------------------------


def _eigh(H: torch.Tensor):
    """The library eigh of a small Gram (x <= rank + oversample), counted."""
    _eigh.calls += 1
    return library_eigh(H)


def _svd(A: torch.Tensor):
    """The library thin SVD of an exact emit or a rounding step, counted."""
    _svd.calls += 1
    return library_svd(A)


_eigh.calls = 0
_svd.calls = 0


def cpu_sketch(seed: int, code: int, shape: tuple) -> torch.Tensor:
    """The port's sketch draw for fold `code` of `seed`: float32 standard
    normals [2, *shape] from a CPU `torch.Generator` seeded from (seed,
    code), as real and imaginary parts.  The JAX tier draws
    ``jax.random.normal(fold_in(PRNGKey(seed), code), (2, *shape))`` on the
    device (`tnqs/bmps_engine.py:718-720`), which the port cannot
    reproduce."""
    # torch's CPU generator keeps 32 bits of its seed: mix (seed, code) into them
    gen = torch.Generator().manual_seed(int(np.random.SeedSequence([int(seed), int(code)]).generate_state(1)[0]))
    om = torch.randn((2,) + tuple(shape), generator=gen, dtype=torch.float32)
    return torch.complex(om[0], om[1])


# ----------------------------------------------------------------------
# matmul-only randomized truncation
# ----------------------------------------------------------------------


# Peak elements allowed in one x-coupled zip-sweep intermediate (2^26
# elements, 512 MB at complex64); sketch axes and free bonds are chunked to
# stay under it (`tnqs/bmps_engine.py:165-170`).
_EINSUM_BUDGET = 2**26

# Emit steps whose step matrix [q*r*R, P*A*B] has at most this many
# elements are truncated by an exact SVD instead of the randomized sketch:
# optimal (Eckart–Young), free of sketch noise and monotone in rank
# (`tnqs/bmps_engine.py:387-398`).
_EXACT_EMIT_LIMIT = 2**22


def _chunk_last(f, V: torch.Tensor, chunk: int) -> torch.Tensor:
    """`f` applied to slices of V's last axis, concatenated: bounds the peak
    size of sketch-coupled intermediates.  The JAX version maps over padded
    slices to keep its compiled program small; the values are the same."""
    x = V.shape[-1]
    if x <= chunk:
        return f(V)
    return torch.cat([f(V[..., i : i + chunk]) for i in range(0, x, chunk)], dim=-1)


def _orth(Y: torch.Tensor) -> torch.Tensor:
    """Exact column orthonormalization Q = Y G^{-1/2} through the small
    [x, x] Gram eigh; directions with vanishing Gram weight (rank-deficient
    or padded sketches) are zeroed, not inverted (`tnqs/bmps_engine.py:201`)."""
    G = Y.mH @ Y
    w, U = _eigh(G)
    wmax = torch.clamp(w[-1].real, min=1e-300)
    inv = torch.where(w.real > wmax * 1e-12, 1.0 / torch.sqrt(torch.clamp(w.real, min=1e-300)), 0.0)
    return Y @ (U * inv[None, :].to(U.dtype)) @ U.mH


def _rand_trunc_factored(apply_A, apply_Ah, omega: torch.Tensor, m_shape, keep: int | None = None,
                         power_iters: int = 1):
    """Randomized rank factorization A ~= Q C^T without materializing A
    (`tnqs/bmps_engine.py:216`).  `apply_A(V)` contracts A against V
    [..cols.., x] and `apply_Ah(W)` against W [..rows.., x].  `power_iters`
    rounds of subspace iteration with exact re-orthonormalization, then
    exact whitening; with `keep` < x the oversampled subspace is truncated
    to its best `keep` directions through the eigh of C^H C.

    Returns (Q, C / ||C||, log ||C||)."""
    Y = apply_A(omega)
    x = Y.shape[-1]
    for _ in range(max(power_iters, 0)):
        Q = _orth(Y.reshape(-1, x)).reshape(*m_shape, x)
        Y = apply_A(apply_Ah(Q))
    Q = _orth(Y.reshape(-1, x)).reshape(*m_shape, x)
    C = apply_Ah(Q).conj()  # (A^H Q)^* = (Q^H A)^T, cols-major [..cols.., x]
    if keep is not None and keep < x:
        cols_shape = C.shape[:-1]
        Cm = C.reshape(-1, x)
        _, U = _eigh(Cm.mH @ Cm)  # ascending eigenvalues
        Uk = U[:, -keep:].flip(1)  # top-`keep` right-singular directions
        Q = torch.einsum("...x,xk->...k", Q, Uk.conj())
        C = (Cm @ Uk).reshape(*cols_shape, keep)
    c_n = torch.sqrt(torch.sum(C.abs() ** 2)) + 1e-30
    return Q, C / c_n, torch.log(c_n)


def _ladder_transfer_two_cross(G, Ml, Mr, K, B, budget: int):
    """Blocked ladder step for vertices with both left and right cross
    bonds (square-grid column interiors), where every pairwise order of the
    5-tensor clique materializes a rank^2 chi^4 intermediate
    (`tnqs/bmps_engine.py:256`).  Chunks the output bonds A (ket down) and B
    (bra down) and the contracted bra up-bond b, and accumulates each (A, B)
    block over the b chunks through a fixed pairwise chain whose peak is
    ~rank^2 chi^2 chunk^2 elements."""
    p_dim, P_dim = G.shape[0], G.shape[1]
    s_dim, a_dim, A_dim, l_dim, r_dim = K.shape
    b_dim, B_dim = B.shape[1], B.shape[2]
    m_dim, q_dim = Ml.shape[2], Ml.shape[3]
    R_dim, Q_dim = Mr.shape[2], Mr.shape[3]
    per1 = p_dim * P_dim * s_dim * l_dim * r_dim
    per2 = P_dim * s_dim * r_dim * m_dim * q_dim
    per3 = P_dim * r_dim * q_dim * R_dim
    c = max(1, int(np.sqrt(budget / max(per1, per2, per3, 1))))
    cA, cB, cb = min(c, A_dim), min(c, B_dim), min(c, b_dim)
    # the blocks are concatenated, not written into a preallocated output:
    # the sampler maps this step over its lanes (`torch.func.vmap`), which
    # cannot write a lane-batched block into an unbatched tensor
    rows = []
    for iA in range(0, A_dim, cA):
        Kc = K[:, :, iA : iA + cA]
        blocks = []
        for iB in range(0, B_dim, cB):
            Bc = B[:, :, iB : iB + cB]
            acc = None
            for ib in range(0, b_dim, cb):
                T1 = torch.einsum("pPab,saAlr->pPbsAlr", G[..., ib : ib + cb], Kc)
                T2 = torch.einsum("pPbsAlr,plmq->PbsArmq", T1, Ml)
                T3 = torch.einsum("PbsArmq,sbBmR->PArqBR", T2, Bc[:, ib : ib + cb])
                part = torch.einsum("PArqBR,PrRQ->qQAB", T3, Mr)
                acc = part if acc is None else acc + part
            blocks.append(acc)
        rows.append(torch.cat(blocks, dim=3))
    return torch.cat(rows, dim=2)


def _pass_step_block(C, Min, K, B, *, budget: int):
    """Non-emit zip step C[q,p,a,b] Min[p,l,m,P] K[s,a,A,l] B[s,b,B,m] ->
    [q,P,A,B] (`tnqs/bmps_engine.py:360`).  The four tensors form a clique,
    so any pairwise order couples two chi^2 bond pairs; above `budget` the
    free output bond A is chunked through the chain C*K -> *Min -> *B."""
    q, p, a, b = C.shape
    s, _, A, l = K.shape
    m, P = Min.shape[2], Min.shape[3]
    per_A = max(q * p * b * s * l, q * b * s * m * P)
    if A * per_A <= budget:
        return ceinsum("qpab,plmP,saAl,sbBm->qPAB", C, Min, K, B)
    Ac = max(1, int(budget // max(per_A, 1)))
    outs = []
    for i in range(0, A, Ac):
        T1 = ceinsum("qpab,saAl->qpbsAl", C, K[:, :, i : i + Ac])
        T2 = ceinsum("qpbsAl,plmP->qbsAmP", T1, Min)
        outs.append(ceinsum("qbsAmP,sbBm->qPAB", T2, B))
    return torch.cat(outs, dim=2)


def _exact_trunc_svd(Am, m_shape, cols_shape, keep: int):
    """Exact truncated SVD of the materialized step matrix `Am` [M, N] in
    `_rand_trunc_factored`'s convention: (Q [..rows.., k], C/||C||
    [..cols.., k], log ||C||) with A ~= Q @ C^T (`tnqs/bmps_engine.py:401`)."""
    U, s, Vh = _svd(Am)
    Q = U[:, :keep].reshape(*m_shape, keep)
    C = (s[:keep].to(Am.dtype)[:, None] * Vh[:keep]).T.reshape(*cols_shape, keep)
    c_n = torch.sqrt(torch.sum(C.abs() ** 2)) + 1e-30
    return Q, C / c_n, torch.log(c_n)


def _round_chain(chain: list, keep: int) -> list:
    """Round an emitted boundary-MPS chain (walk order, tensors [q_in, bk,
    bb, q_out]) down to bond dimension `keep` by one right-to-left SVD
    truncation sweep (`tnqs/bmps_engine.py:413`).  The zip emits are
    left-canonical by construction, so one sweep is the (quasi-)optimal
    compression of the chain."""
    if len(chain) <= 1:
        return list(chain)
    out = list(chain)
    for i in range(len(out) - 1, 0, -1):
        A = out[i]
        q, bk, bb, r = A.shape
        U, s, Vh = _svd(A.reshape(q, bk * bb * r))
        x = min(keep, q, bk * bb * r)
        out[i] = Vh[:x].reshape(x, bk, bb, r)
        carry = U[:, :x] * s[:x].to(A.dtype)[None, :]
        out[i - 1] = torch.einsum("pkbq,qx->pkbx", out[i - 1], carry)
    return out


def _exact_emit_step_block(C, Min, K, B, *, keep: int):
    """Exact-SVD emit step (doubled layer): materialize C[q,p,a,b]
    Min[p,l,m,P] K[s,a,A,l,r] B[s,b,B,m,R] -> [(q,r,R), (P,A,B)] and truncate
    it optimally (`tnqs/bmps_engine.py:449`)."""
    A6 = ceinsum("qpab,plmP,saAlr,sbBmR->qrRPAB", C, Min, K, B)
    q, rk, rb, P, Ak, Bb = A6.shape
    return _exact_trunc_svd(A6.reshape(q * rk * rb, P * Ak * Bb), (q, rk, rb), (P, Ak, Bb), keep)


def _exact_emit1_step_block(C, Min, K, *, keep: int):
    """Exact-SVD emit step (single layer): C[q,p,a] Min[p,l,P] K[a,A,l,r] ->
    [(q,r), (P,A)] (`tnqs/bmps_engine.py:462`)."""
    A4 = ceinsum("qpa,plP,aAlr->qrPA", C, Min, K)
    q, r, P, Ak = A4.shape
    return _exact_trunc_svd(A4.reshape(q * r, P * Ak), (q, r), (P, Ak), keep)


def _emit_step_block(C, Min, K, B, omega, *, xc: int, keep: int, power_iters: int):
    """Emit-vertex zip step: the matrix-free randomized factorization of the
    step tensor C[q,p,a,b] Min[p,l,m,P] K[s,a,A,l,r] B[s,b,B,m,R] ->
    [(q,r,R), (P,A,B)], sketch columns chunked by `xc`
    (`tnqs/bmps_engine.py:472`)."""
    Cc, Minc, Kc, Bc = C.conj(), Min.conj(), K.conj(), B.conj()

    def apply_A(V):
        return _chunk_last(lambda Vc: ceinsum("qpab,plmP,saAlr,sbBmR,PABx->qrRx", C, Min, K, B, Vc), V, xc)

    def apply_Ah(W):
        return _chunk_last(lambda Wc: ceinsum("qpab,plmP,saAlr,sbBmR,qrRx->PABx", Cc, Minc, Kc, Bc, Wc), W, xc)

    q, rk, rb = C.shape[0], K.shape[4], B.shape[4]
    return _rand_trunc_factored(apply_A, apply_Ah, omega, (q, rk, rb), keep=keep, power_iters=power_iters)


def _pass1_step_block(C, Min, K, *, budget: int):
    """Single-layer non-emit zip step C[q,p,a] Min[p,l,P] K[a,A,l] ->
    [q,P,A] (`tnqs/bmps_engine.py:501`), the free down-bond A chunked above
    `budget`."""
    q, p, a = C.shape
    _, A, l = K.shape
    P = Min.shape[2]
    per_A = max(q * p * l, q * l * P)
    if A * per_A <= budget:
        return ceinsum("qpa,plP,aAl->qPA", C, Min, K)
    Ac = max(1, int(budget // max(per_A, 1)))
    outs = []
    for i in range(0, A, Ac):
        T1 = ceinsum("qpa,aAl->qpAl", C, K[:, i : i + Ac])
        outs.append(ceinsum("qpAl,plP->qPA", T1, Min))
    return torch.cat(outs, dim=2)


def _emit1_step_block(C, Min, K, omega, *, xc: int, keep: int, power_iters: int):
    """Single-layer emit-vertex step: randomized factorization of C[q,p,a]
    Min[p,l,P] K[a,A,l,r] -> [(q,r), (P,A)] (`tnqs/bmps_engine.py:522`)."""
    Cc, Minc, Kc = C.conj(), Min.conj(), K.conj()

    def apply_A(V):
        return _chunk_last(lambda Vc: ceinsum("qpa,plP,aAlr,PAx->qrx", C, Min, K, Vc), V, xc)

    def apply_Ah(W):
        return _chunk_last(lambda Wc: ceinsum("qpa,plP,aAlr,qrx->PAx", Cc, Minc, Kc, Wc), W, xc)

    q, r = C.shape[0], K.shape[3]
    return _rand_trunc_factored(apply_A, apply_Ah, omega, (q, r), keep=keep, power_iters=power_iters)


# ----------------------------------------------------------------------
# the sweeps
# ----------------------------------------------------------------------


class BMPSEngine:
    """Boundary-MPS measurement for a :class:`LatticeEngine` state
    (`tnqs/bmps_engine.py:548`).

    Builds left/right boundary MPSes at every column cut by zip-up sweeps,
    then returns BP-independent expectations.  `rank` is the MPS bond
    dimension (the accuracy knob); `oversample` widens each sketch, which is
    truncated back to `rank`; `power_iters` rounds of subspace iteration
    sharpen it; `ring_iters` relaxation passes run around a ring plan;
    `zip_factor` > 1 zips at rank * zip_factor and rounds each emitted chain
    back to `rank` (`_round_chain`).  `sketch(code, shape)` returns the
    complex sketch [*shape] of fold `code`; it defaults to `cpu_sketch` of
    `seed`.  Everything runs on the engine's device; a sketch drawn
    elsewhere is moved there, and its bytes counted in `sketch_bytes`."""

    def __init__(self, engine: LatticeEngine, rank: int, column_of=None, row_of=None, seed: int = 7,
                 oversample: int = 8, power_iters: int = 1, ring_iters: int = 3, zip_factor: int = 1,
                 sketch=None):
        self.engine = engine
        self.rank = int(rank)
        self.zip_factor = int(zip_factor)
        self.ring_iters = int(ring_iters)
        self.oversample = int(oversample)
        self.power_iters = int(power_iters)
        self.cplan = ColumnPlan.build(engine.plan, column_of, row_of)
        self._seed = int(seed)
        # sketches are seeded per (column, direction, vertex), so every
        # sweep sees the same draws whatever it measures
        self._sketch = partial(cpu_sketch, self._seed) if sketch is None else sketch
        self.sketch_bytes = 0
        self._sketch_cache = None

    def _draw(self, code: int, shape: tuple, dt) -> torch.Tensor:
        key = (code, tuple(shape), dt)
        if self._sketch_cache is not None and key in self._sketch_cache:
            return self._sketch_cache[key]
        omega = self._sketch(code, shape)
        if omega.device != self.engine.device:
            self.sketch_bytes += omega.numel() * omega.element_size()
        omega = omega.to(device=self.engine.device, dtype=dt)
        if self._sketch_cache is not None:
            self._sketch_cache[key] = omega
        return omega

    @contextmanager
    def sketches_cached(self):
        """Within the block every fold is drawn and copied to the device once
        and then reused: a sampler call zips the same folds for each group
        of lanes.  A draw depends only on (seed, code, shape), so the cache
        changes no value; it is freed when the block exits."""
        self._sketch_cache = {}
        try:
            yield
        finally:
            self._sketch_cache = None

    def _ones(self, shape, dt) -> torch.Tensor:
        return torch.ones(shape, dtype=dt, device=self.engine.device)

    def _eye4(self, p: int, dt) -> torch.Tensor:
        """The trivial boundary message [p, 1, 1, p] of a vertex without a
        cross bond on that side."""
        return torch.eye(p, dtype=dt, device=self.engine.device).reshape(p, 1, 1, p)

    def _op(self, opname: str) -> torch.Tensor:
        return torch.as_tensor(op_matrix(opname), device=self.engine.device).to(self.engine.dtype)

    # -- per-vertex access ------------------------------------------------
    def _vertex_tensor(self, T: dict, v, plan=None) -> torch.Tensor:
        """Engine row of v reshaped to the uniform [s, up, down, left, right]
        axis convention, missing bonds as dim-1 axes (`tnqs/bmps_engine.py:
        594`).  `plan` overrides the bucket lookup (the bilinear `inner`
        passes the bra engine's)."""
        cp = self.cplan
        plan = self.engine.plan if plan is None else plan
        k, pos = plan.bucket_pos[v]
        A = T[k][pos]  # [d, chi x k]
        roles = [cp.side(v, u) for u in plan.neighbor_order[v]]
        order = ["u", "d", "l", "r"]
        A = A.permute([0] + [1 + roles.index(r) for r in order if r in roles])
        shape = [A.shape[0]]
        ai = 1
        for r in order:
            if r in roles:
                shape.append(A.shape[ai])
                ai += 1
            else:
                shape.append(1)
        return A.reshape(shape)

    def _dtype(self, T: dict):
        return next(iter(T.values())).dtype

    # -- zip-up sweeps ----------------------------------------------------
    def _zip_column(self, T: dict, c: int, incoming: list, direction: int, rank: int | None = None, K_of=None,
                    budget: int | None = None, B_of=None):
        """Zip the incoming boundary MPS through column c
        (`tnqs/bmps_engine.py:617`).

        direction=+1: left to right (emit on 'r' bonds, consume on 'l');
        -1: mirrored.  Returns ``(emitted, logscale)``: the emitted MPS
        tensors [q_in, bond_ket, bond_bra, q_out] in cut order and the log
        of every norm factor dropped in the sweep.  `rank` overrides the
        engine's, `K_of(v)` the ket's vertex tensors, `B_of(v)` the bra
        layer (another state's, for `inner`), `budget` the intermediate-size
        budget."""
        rank = self.rank if rank is None else int(rank)
        target_rank = rank
        if self.zip_factor > 1:
            rank = rank * self.zip_factor  # rounded back before return
        if budget is None:
            budget = _EINSUM_BUDGET
        cp = self.cplan
        col = cp.columns[c]
        nC = len(cp.columns)
        # on ring plans every column has both cuts, indexed mod nC
        if direction > 0:
            consume_cut = cp.cross[(c - 1) % nC] if (c > 0 or cp.periodic) else []
            emit_cut = cp.cross[c] if (c < len(cp.cross)) else []
            consume_of = {e[1]: i for i, e in enumerate(consume_cut)}
            emit_of = {e[0]: i for i, e in enumerate(emit_cut)}
        else:
            consume_cut = cp.cross[c] if (c < len(cp.cross)) else []
            emit_cut = cp.cross[(c - 1) % nC] if (c > 0 or cp.periodic) else []
            consume_of = {e[0]: i for i, e in enumerate(consume_cut)}
            emit_of = {e[1]: i for i, e in enumerate(emit_cut)}

        dt = self._dtype(T)
        C = self._ones((1, 1, 1, 1), dt)  # [q, p, a, b]
        logscale = torch.zeros((), dtype=dt.to_real(), device=self.engine.device)
        emitted: list = [None] * len(emit_cut)
        last_emit = -1
        for v in col:
            K = self._vertex_tensor(T, v) if K_of is None else K_of(v)  # [s,u,d,l,r]
            B = K if B_of is None else B_of(v)
            if direction < 0:
                K = K.permute(0, 1, 2, 4, 3)  # swap l <-> r roles
                B = B.permute(0, 1, 2, 4, 3)
            B = B.conj()
            Min = incoming[consume_of[v]] if v in consume_of else self._eye4(C.shape[1], dt)  # [p, lk, lb, p2]
            # step tensor C[q,p,a,b] Min[p,l,m,P] K[s,a,A,l,r] B[s,b,B,m,R]
            # -> [q,P,r,R,A,B], never materialized on the sketch path
            q, P = C.shape[0], Min.shape[3]
            rk, Ak = K.shape[4], K.shape[2]
            rb, Bb = B.shape[4], B.shape[2]
            if v in emit_of:
                M_, N_ = q * rk * rb, P * Ak * Bb
                x = min(rank, M_, N_)
                if M_ * N_ <= min(_EXACT_EMIT_LIMIT, budget):
                    Q, Cnew, logn = _exact_emit_step_block(C, Min, K, B, keep=x)
                else:
                    # oversampled sketch, truncated back to x after whitening
                    xs = min(x + self.oversample, M_, N_)
                    code = c * 4096 + (0 if direction > 0 else 2048) + cp.order_in_col[v]
                    omega = self._draw(code, (P, Ak, Bb, xs), dt)
                    # worst x-coupled intermediate per sketch column is
                    # ~2 chi^3 max(q, P) elements: chunk the sketch axis
                    per_x = 2 * max(Ak, 1) * max(Bb, 1) * max(rk, rb, 1) * max(q, P, 1)
                    xc = max(1, int(budget // max(per_x, 1)))
                    Q, Cnew, logn = _emit_step_block(C, Min, K, B, omega, xc=xc, keep=x,
                                                     power_iters=self.power_iters)
                logscale = logscale + logn
                emitted[emit_of[v]] = Q
                C = Cnew.movedim(-1, 0)  # [x, P, A, B]
                last_emit = emit_of[v]
            else:
                # no emission: r = R = 1; land on [q, P, A, B] directly
                C = _pass_step_block(C, Min, K[..., 0], B[..., 0], budget=int(budget))
                nrm = torch.sqrt(torch.sum(C.abs() ** 2)) + 1e-30
                logscale = logscale + torch.log(nrm)
                C = C / nrm
        if last_emit >= 0:
            # fold the trailing scalar chain into the last emitted tensor
            tail = C.reshape(C.shape[0])  # [x]
            emitted[last_emit] = torch.einsum("qrRx,x->qrR", emitted[last_emit], tail)[..., None]
            if self.zip_factor > 1 and len(emit_cut) > 1:
                # chain bonds link consecutive emits in walk order: round in
                # that order, then scatter back to cut order
                walk = [emit_of[v] for v in col if v in emit_of]
                for i, t in zip(walk, _round_chain([emitted[i] for i in walk], target_rank)):
                    emitted[i] = t
        else:
            # fully scalar column: the carry is a pure scale
            logscale = logscale + torch.log(C.reshape(()).abs() + 1e-30)
        return emitted, logscale

    @staticmethod
    def _ladder_transfer(G, Ml, Mr, K, B, budget: int | None = None):
        """out[q,Q,A,B] = G[p,P,a,b] Ml[p,l,m,q] Mr[P,r,R,Q] K[s,a,A,l,r]
        B[s,b,B,m,R], the per-vertex ladder step, memory-aware
        (`tnqs/bmps_engine.py:318`, `:766`): vertices with two cross bonds
        take the blocked path past the budget; those with one take an
        explicit pairwise order chunked over the incoming chain bond, which
        peaks at rank^2 chi^3 where the generic order peaks at rank^2
        chi^4."""
        if budget is None:
            budget = _EINSUM_BUDGET
        l_dim, r_dim = K.shape[3], K.shape[4]
        a_dim, A_dim = K.shape[1], K.shape[2]
        p_dim = G.shape[0]
        one_cross = (l_dim > 1) != (r_dim > 1)
        if l_dim > 1 and r_dim > 1 and a_dim * A_dim > 1:
            est2 = p_dim * Ml.shape[3] * a_dim * A_dim * l_dim * r_dim * K.shape[0]
            if est2 > budget:
                return _ladder_transfer_two_cross(G, Ml, Mr, K, B, budget)
        est = p_dim * G.shape[1] * G.shape[3] * K.shape[0] * A_dim * max(l_dim, r_dim)
        if not (one_cross and a_dim * A_dim > 1) or est <= budget // 16:
            return ceinsum("pPab,plmq,PrRQ,saAlr,sbBmR->qQAB", G, Ml, Mr, K, B)
        pc = max(1, int(budget // max(est // p_dim, 1)))
        out = None
        for i in range(0, p_dim, pc):
            Gc, Mlc = G[i : i + pc], Ml[i : i + pc]
            if r_dim > 1:  # cross bond on the right; l = m = 1
                T1 = torch.einsum("pPab,saAr->pPbsAr", Gc, K[:, :, :, 0, :])
                T2 = torch.einsum("pPbsAr,PrRQ->pbsARQ", T1, Mr)
                T3 = torch.einsum("pbsARQ,sbBR->pAQB", T2, B[:, :, :, 0, :])
                part = torch.einsum("pAQB,pq->qQAB", T3, Mlc[:, 0, 0, :])
            else:  # cross bond on the left; r = R = 1
                T1 = torch.einsum("pPab,saAl->pPbsAl", Gc, K[..., 0])
                T2 = torch.einsum("pPbsAl,plmq->PbsAmq", T1, Mlc)
                T3 = torch.einsum("PbsAmq,sbBm->PAqB", T2, B[..., 0])
                part = torch.einsum("PAqB,PQ->qQAB", T3, Mr[:, 0, 0, :])
            out = part if out is None else out + part
        return out

    def _ladder_walks(self, T: dict, c: int, L: list, R: list, dt):
        """Shared machinery of the per-column ladder (`tnqs/bmps_engine.py:
        788`): (step_down, step_up, prefixes, suffixes, denom, col).  Steps
        take `op=None` or a [d, d] operator to insert at that vertex."""
        cp = self.cplan
        col = cp.columns[c]
        nC = len(cp.columns)
        lcut = cp.cross[(c - 1) % nC] if (c > 0 or cp.periodic) else []
        rcut = cp.cross[c] if c < len(cp.cross) else []
        l_of = {e[1]: i for i, e in enumerate(lcut)}
        r_of = {e[0]: i for i, e in enumerate(rcut)}

        def mins(v, C_pl, C_pr):
            Ml = L[l_of[v]] if v in l_of else self._eye4(C_pl, dt)
            Mr = R[r_of[v]] if v in r_of else self._eye4(C_pr, dt)
            return Ml, Mr

        def step_down(G, v, op=None):
            K = self._vertex_tensor(T, v)
            B = K.conj()
            if op is not None:
                K = torch.einsum("ts,saDlr->taDlr", op.to(dt), K)
            Ml, Mr = mins(v, G.shape[0], G.shape[1])
            return self._ladder_transfer(G, Ml, Mr, K, B)

        def step_up(G, v, op=None):
            # mirrored walk: G holds environments from below [q,Q,A,B]; the
            # up step is the down step under (p <-> q, P <-> Q, a <-> A,
            # b <-> B)
            K = self._vertex_tensor(T, v)
            B = K.conj()
            if op is not None:
                K = torch.einsum("ts,saAlr->taAlr", op.to(dt), K)
            Ml, Mr = mins(v, G.shape[0], G.shape[1])
            return self._ladder_transfer(G, Ml.permute(3, 1, 2, 0), Mr.permute(3, 1, 2, 0),
                                         K.permute(0, 2, 1, 3, 4), B.permute(0, 2, 1, 3, 4))

        one = self._ones((1, 1, 1, 1), dt)
        prefixes = [one]
        for v in col:
            prefixes.append(step_down(prefixes[-1], v))
        suffixes = [one] * (len(col) + 1)
        for i in range(len(col) - 1, -1, -1):
            suffixes[i] = step_up(suffixes[i + 1], col[i])
        denom = torch.einsum("pPab,pPab->", prefixes[-1], suffixes[len(col)])
        return step_down, step_up, prefixes, suffixes, denom, col

    def _ladder_expect(self, T: dict, c: int, L: list, R: list, op: torch.Tensor) -> dict:
        """<op_v> for every vertex of column c, as device scalars."""
        step_down, _, prefixes, suffixes, denom, col = self._ladder_walks(T, c, L, R, op.dtype)
        return {v: torch.einsum("qQAB,qQAB->", step_down(prefixes[i], v, op), suffixes[i + 1]) / denom
                for i, v in enumerate(col)}

    def _ladder_expect_pairs(self, T: dict, c: int, L: list, R: list, op1, op2, pairs: list) -> dict:
        """<op1_v1 op2_v2> for vertex pairs within column c, at any
        separation: one operator-inserted walk per pair between the shared
        prefix/suffix environments (`tnqs/bmps_engine.py:862`)."""
        cp = self.cplan
        step_down, _, prefixes, suffixes, denom, col = self._ladder_walks(T, c, L, R, op1.dtype)
        out = {}
        for (v1, v2) in pairs:
            i, j = cp.order_in_col[v1], cp.order_in_col[v2]
            if i > j:
                # walk top-down with the operators swapped: single-site
                # operators at distinct vertices commute
                (i, j), (o1, o2) = (j, i), (op2, op1)
            else:
                o1, o2 = op1, op2
            if i == j:
                # both on one vertex: the operator product (op acts as
                # <t|op|s> on the ket, so O = op1 @ op2)
                g = step_down(prefixes[i], col[i], op1 @ op2)
            else:
                g = step_down(prefixes[i], col[i], o1)
                for t in range(i + 1, j):
                    g = step_down(g, col[t])
                g = step_down(g, col[j], o2)
            out[(v1, v2)] = torch.einsum("qQAB,qQAB->", g, suffixes[j + 1]) / denom
        return out

    # -- boundary chains ---------------------------------------------------
    def _ring_init(self, cut, reverse: bool, M) -> list:
        """Product-MPS initialization of a ring cut from the BP fixed point:
        each bond message is that edge's chi x chi doubled-layer cut
        environment."""
        eids = self.engine.plan.edge_ids
        return [M[eids[(w, u)] if reverse else eids[(u, w)]][None, :, :, None] for (u, w) in cut]

    def _relax_ring(self, T: dict, lefts: dict, rights: dict, B_of=None):
        """`ring_iters` Gauss-Seidel passes around a ring plan in each
        direction from the given cut messages (`tnqs/bmps_engine.py:936-945`)."""
        nC = len(self.cplan.columns)
        for _ in range(max(self.ring_iters, 1)):
            for c in range(nC):
                lefts[(c + 1) % nC], _ = self._zip_column(T, c, lefts[c], +1, B_of=B_of)
        for _ in range(max(self.ring_iters, 1)):
            for c in range(nC - 1, -1, -1):
                rights[(c - 1) % nC], _ = self._zip_column(T, c, rights[c], -1, B_of=B_of)
        return [lefts[c] for c in range(nC)], [rights[c] for c in range(nC)]

    def _boundary_mpses(self, T: dict, M=None):
        """(lefts, rights): lefts[c] = boundary MPS entering column c from
        the left (on cut c-1), rights[c] from the right (cut c)
        (`tnqs/bmps_engine.py:895`).  Line plans: one zip chain each way.
        Ring plans: cut messages start from the BP messages `M` as product
        MPSes and relax by `ring_iters` passes around the ring each way;
        like BP on a loop, exact only as correlations decay around it."""
        cp, nC = self.cplan, len(self.cplan.columns)
        if not cp.periodic:
            lefts: list = [None] * nC
            cur: list = []
            for c in range(nC):
                lefts[c] = cur
                if c < nC - 1:
                    cur, _ = self._zip_column(T, c, cur, +1)
            rights: list = [None] * nC
            cur = []
            for c in range(nC - 1, -1, -1):
                rights[c] = cur
                if c > 0:
                    cur, _ = self._zip_column(T, c, cur, -1)
            return lefts, rights
        if M is None:
            raise ValueError("ring-quotient boundary MPS needs the BP messages M")
        lefts = {c: self._ring_init(cp.cross[(c - 1) % nC], False, M) for c in range(nC)}
        rights = {c: self._ring_init(cp.cross[c], True, M) for c in range(nC)}
        return self._relax_ring(T, lefts, rights)

    # -- public API -------------------------------------------------------
    def expect_1site(self, opname: str, vertices=None, split: bool = False) -> dict:
        """Boundary-MPS expectation of a one-site operator
        (`tnqs/bmps_engine.py:1065`): {vertex: complex}.

        `vertices` restricts the result (default every vertex).  The zip
        sweeps always cover the whole lattice; the ladder walks run only for
        columns holding a requested vertex.  `split` is accepted for the JAX
        signature: there it compiles per-column programs instead of one
        fused program, with the same blocks and sketches; an eager run has
        no compile unit to split, so both values run the same code."""
        eng, cp = self.engine, self.cplan
        del split
        if vertices is None:
            columns = range(len(cp.columns))
        else:
            columns = sorted({cp.col_of[v] for v in vertices})
        op = self._op(opname)
        lefts, rights = self._boundary_mpses(eng.T, eng.M if cp.periodic else None)
        vals = {}
        for c in columns:
            vals.update(self._ladder_expect(eng.T, c, lefts[c], rights[c], op))
        keys = sorted(vals)
        host = torch.stack([vals[v] for v in keys]).cpu().numpy()
        out = {v: complex(host[i]) for i, v in enumerate(keys)}
        if vertices is not None:
            out = {v: out[v] for v in vertices}
        return out

    def expect_2site(self, opname_u: str, opname_v: str, pairs=None) -> dict:
        """Boundary-MPS two-point function <op_u(v1) op_v(v2)> for vertex
        pairs within one column (`tnqs/bmps_engine.py:1109`); `pairs`
        defaults to every intra-column edge.  Returns {(v1, v2): complex},
        keyed by the caller's orientation."""
        eng, cp = self.engine, self.cplan
        if pairs is None:
            pairs = [(u, w) for (u, w) in eng.plan.graph.edges() if cp.col_of[u] == cp.col_of[w]]
        pairs = sorted({tuple(p) for p in pairs})
        by_col: dict = {}
        for (u, w) in pairs:
            if cp.col_of[u] != cp.col_of[w]:
                raise ValueError(f"pair {(u, w)} spans columns; expect_2site needs both vertices in one column "
                                 "(choose the other partitioning)")
            by_col.setdefault(cp.col_of[u], []).append((u, w))
        op1, op2 = self._op(opname_u), self._op(opname_v)
        lefts, rights = self._boundary_mpses(eng.T, eng.M if cp.periodic else None)
        vals = {}
        for c, col_pairs in sorted(by_col.items()):
            vals.update(self._ladder_expect_pairs(eng.T, c, lefts[c], rights[c], op1, op2, col_pairs))
        host = torch.stack([vals[k] for k in pairs]).cpu().numpy()
        return {k: complex(host[i]) for i, k in enumerate(pairs)}

    def rdm(self, vertices, normalize: bool = True) -> np.ndarray:
        """Reduced density matrix on `vertices`, all in one column
        (`tnqs/bmps_engine.py:1175`): a [d^k, d^k] ndarray, row = ket
        multi-index (first vertex slowest), trace-normalized unless
        `normalize=False`.  Each entry rho[s, t] is one matrix-unit-inserted
        ladder walk; the d^(2k) walks share the sweeps and environments."""
        eng, cp = self.engine, self.cplan
        verts = sorted(vertices, key=lambda v: cp.order_in_col[v])
        if len({cp.col_of[v] for v in verts}) != 1:
            raise ValueError(f"rdm vertices {verts} span columns; they must share one column "
                             "(choose the other partitioning)")
        d = eng.d
        k = len(verts)
        if d ** (2 * k) > 256:
            raise ValueError(f"rdm on {k} sites of dimension {d} needs {d ** (2 * k)} matrix-unit walks; "
                             "keep d^(2k) <= 256")
        c = cp.col_of[verts[0]]
        nC = len(cp.columns)
        T = eng.T
        if cp.periodic:
            lefts, rights = self._boundary_mpses(T, eng.M)
            L, R = lefts[c], rights[c]
        else:
            L = []
            for cc in range(c):
                L, _ = self._zip_column(T, cc, L, +1)
            R = []
            for cc in range(nC - 1, c, -1):
                R, _ = self._zip_column(T, cc, R, -1)
        dt = self._dtype(T)
        step_down, _, prefixes, suffixes, denom, col = self._ladder_walks(T, c, L, R, dt)
        orders = [cp.order_in_col[v] for v in verts]
        lo, hi = orders[0], orders[-1]
        op_at = {o: i for i, o in enumerate(orders)}
        assign = list(product(range(d), repeat=2 * k))  # (s1..sk, t1..tk)
        vals = []
        for a in assign:
            E = {}
            for i in range(k):
                # <E> with E[t, s] = 1 gives rho[s, t]
                E[i] = torch.zeros((d, d), dtype=dt, device=eng.device)
                E[i][a[k + i], a[i]] = 1.0
            g = prefixes[lo]
            for o in range(lo, hi + 1):
                g = step_down(g, col[o], E.get(op_at.get(o)))
            vals.append(torch.einsum("qQAB,qQAB->", g, suffixes[hi + 1]))
        vals = (torch.stack(vals) / denom).cpu().numpy()
        rho = np.zeros((d,) * (2 * k), dtype=vals.dtype)
        for a, x in zip(assign, vals):
            rho[a] = x
        rho = rho.reshape(d**k, d**k)
        if normalize:
            rho = rho / np.trace(rho)
        return rho

    # -- overlaps ------------------------------------------------------------
    def _column_scalar(self, T, c: int, L: list, R: list, dt, B_of):
        """Complex partition scalar of column c of the bilinear sandwich
        between boundary MPSes on both cuts: a pass-only ladder walk
        (`tnqs/bmps_engine.py:1265`).  Returns (log|z|, unit phase)."""
        cp = self.cplan
        col = cp.columns[c]
        nC = len(cp.columns)
        lcut = cp.cross[(c - 1) % nC] if (c > 0 or cp.periodic) else []
        rcut = cp.cross[c] if (c < len(cp.cross)) else []
        l_of = {e[1]: i for i, e in enumerate(lcut)}
        r_of = {e[0]: i for i, e in enumerate(rcut)}
        G = self._ones((1, 1, 1, 1), dt)
        log_abs = torch.zeros((), dtype=dt.to_real(), device=self.engine.device)
        for v in col:
            K = self._vertex_tensor(T, v)
            B = B_of(v).conj()
            Ml = L[l_of[v]] if v in l_of else self._eye4(G.shape[0], dt)
            Mr = R[r_of[v]] if v in r_of else self._eye4(G.shape[1], dt)
            G = self._ladder_transfer(G, Ml, Mr, K, B)
            n = torch.sqrt(torch.sum(G.abs() ** 2)) + 1e-30
            log_abs = log_abs + torch.log(n)
            G = G / n
        val = G.reshape(())
        mag = val.abs() + 1e-30
        return log_abs + torch.log(mag), val / mag

    def _cut_scalar(self, Lmsgs: list, Rmsgs: list, dt):
        """Complex cut scalar <m_e, m_e~>: the chain contraction of the two
        oppositely directed boundary MPSes on one cut
        (`tnqs/bmps_engine.py:1306`).  Returns (log|z|, unit phase)."""
        X = self._ones((1, 1), dt)
        log_abs = torch.zeros((), dtype=dt.to_real(), device=self.engine.device)
        for Li, Ri in zip(Lmsgs, Rmsgs):
            X = ceinsum("ab,akKc,bkKd->cd", X, Li, Ri)
            n = torch.sqrt(torch.sum(X.abs() ** 2)) + 1e-30
            log_abs = log_abs + torch.log(n)
            X = X / n
        val = X.reshape(())
        mag = val.abs() + 1e-30
        return log_abs + torch.log(mag), val / mag

    def _overlap(self, T: dict, Tb: dict, bra_plan):
        """(log|<bra|ket>|, unit phase) as device scalars
        (`tnqs/bmps_engine.py:1323`).  Line plans: left-to-right doubled
        zip sweeps with the bra layer from the second state, closed by a
        pass-only walk down the last column, which keeps the complex phase.
        Ring plans: Gauss-Seidel passes converge the bilinear cut messages
        from rectangular-identity product inits, then log <bra|ket> =
        sum_c log z_c - sum_cuts log z_cut (the quotient-BP partition
        function); like ring expectations, exact only as correlations decay
        around the ring."""
        cp = self.cplan
        nC = len(cp.columns)
        dt = self._dtype(T)

        def B_of(v):
            return self._vertex_tensor(Tb, v, plan=bra_plan)

        if cp.periodic:
            def init_cut(cut):
                return [torch.eye(self._vertex_tensor(T, u).shape[4], B_of(u).shape[4], dtype=dt,
                                  device=self.engine.device)[None, :, :, None] for (u, _) in cut]

            lefts = {c: init_cut(cp.cross[(c - 1) % nC]) for c in range(nC)}
            rights = {c: init_cut(cp.cross[c]) for c in range(nC)}
            lefts, rights = self._relax_ring(T, lefts, rights, B_of=B_of)
            log_abs = torch.zeros((), dtype=dt.to_real(), device=self.engine.device)
            phase = self._ones((), dt)
            for c in range(nC):
                lz, ph = self._column_scalar(T, c, lefts[c], rights[c], dt, B_of)
                le, pe = self._cut_scalar(lefts[(c + 1) % nC], rights[c], dt)
                log_abs = log_abs + lz - le
                phase = phase * ph / pe
            return log_abs, phase

        cur: list = []
        total = torch.zeros((), dtype=dt.to_real(), device=self.engine.device)
        for c in range(nC - 1):
            cur, ls = self._zip_column(T, c, cur, +1, B_of=B_of)
            total = total + ls
        # final column: consume-only walk, tracking the complex carry
        c = nC - 1
        l_of = {e[1]: i for i, e in enumerate(cp.cross[c - 1] if c > 0 else [])}
        C = self._ones((1, 1, 1, 1), dt)
        for v in cp.columns[c]:
            K = self._vertex_tensor(T, v)
            B = B_of(v).conj()
            Min = cur[l_of[v]] if v in l_of else self._eye4(C.shape[1], dt)
            C = _pass_step_block(C, Min, K[..., 0], B[..., 0], budget=_EINSUM_BUDGET)
            nrm = torch.sqrt(torch.sum(C.abs() ** 2)) + 1e-30
            total = total + torch.log(nrm)
            C = C / nrm
        val = C.reshape(())
        mag = val.abs() + 1e-30
        return total + torch.log(mag), val / mag

    def _log_inner(self, bra: LatticeEngine | None = None) -> tuple[float, complex]:
        """(log |<bra|ket>|, phase) with ket = this engine's state; `bra=None`
        means <ket|ket> (`tnqs/bmps_engine.py:1417`)."""
        ket = self.engine
        bra = ket if bra is None else bra
        if bra.plan.graph is not ket.plan.graph and set(bra.plan.graph.vertices()) != set(ket.plan.graph.vertices()):
            raise ValueError("inner needs both states on the same graph")
        log_abs, phase = self._overlap(ket.T, bra.T, bra.plan)
        return float(log_abs.cpu()), complex(phase.cpu())

    def lognorm(self) -> float:
        """log <psi|psi> by boundary-MPS sweeps, scale-safe at any lattice
        size (`tnqs/bmps_engine.py:1446`)."""
        log_abs, _ = self._log_inner(None)
        return log_abs

    def norm_sqr(self) -> float:
        """<psi|psi> by boundary-MPS sweeps; underflows float32 beyond ~100
        sites (the engine normalizes its tensors one by one), where
        :meth:`lognorm` holds."""
        return float(np.exp(self.lognorm()))

    def inner(self, bra: LatticeEngine) -> complex:
        """<bra|ket> by boundary-MPS sweeps, ket = this engine's state
        (`tnqs/bmps_engine.py:1459`; the reference's `inner(psi, phi)`
        treats psi as the ket).  Underflows float32 at 100+ sites, where
        :meth:`fidelity` holds."""
        log_abs, phase = self._log_inner(bra)
        return float(np.exp(log_abs)) * phase

    def fidelity(self, bra: LatticeEngine) -> float:
        """|<bra|ket>|^2 / (<bra|bra> <ket|ket>) in log space
        (`tnqs/bmps_engine.py:1472`).  <bra|bra> comes from a BMPSEngine on
        the bra with this one's rank, seed, oversample and power_iters and
        the other arguments at their defaults, as in JAX."""
        log_bk, _ = self._log_inner(bra)
        log_kk, _ = self._log_inner(None)
        log_bb, _ = BMPSEngine(bra, rank=self.rank, seed=self._seed, oversample=self.oversample,
                               power_iters=self.power_iters, sketch=self._sketch)._log_inner(None)
        return float(np.exp(2.0 * log_bk - log_kk - log_bb))


# ----------------------------------------------------------------------
# certified sampling
# ----------------------------------------------------------------------


def cpu_uniforms(seed: int, s: int, n: int) -> torch.Tensor:
    """The draw values of sample `s` of `seed`: `n` float32 uniforms in [0, 1),
    one per vertex in the sampler's `keys_order`, from a CPU
    `torch.Generator` seeded from (seed, s) as `cpu_sketch` seeds its folds.
    A sample's bits then depend on (seed, s) alone: not on the chunking,
    nor on the device.  JAX draws each bit with `jax.random.categorical`
    under `fold_in(split(PRNGKey(seed), nsamples)[s], vertex)`
    (`tnqs/bmps_engine.py:1782`, `:2145`), which the port cannot reproduce."""
    gen = torch.Generator().manual_seed(int(np.random.SeedSequence([int(seed), int(s)]).generate_state(1)[0]))
    return torch.rand(n, generator=gen, dtype=torch.float32)


def conditional_law(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, tr) of a conditional RDM diagonal [d] (`tnqs/bmps_engine.py:
    1756-1781`): the diagonal clipped at 0 with trace tr, normalized; the
    uniform law where tr <= 1e-25 (an under-ranked projected boundary can
    zero the whole diagonal, and a uniform draw keeps q a distribution);
    floored at 1e-12 and renormalized before the draw, so the bit and its
    weight come from one law.  No host branch: a lane's collapse is a
    `torch.where`."""
    diag = torch.clamp(diag, min=0.0)
    tr = torch.sum(diag)
    ok = tr > 1e-25
    d = diag.shape[0]
    q = torch.where(ok, diag / torch.where(ok, tr, 1.0), torch.full_like(diag, 1.0 / d))
    q = torch.clamp(q, min=1e-12)
    return q / torch.sum(q), tr


def inverse_cdf(q: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The bit of draw value u under the law q [d]: min(#{k : cumsum(q)[k]
    <= u}, d - 1), an int64 scalar on q's device.  u = 0 gives bit 0 and u
    = 1 bit d - 1 for every law (q holds the 1e-12 floor)."""
    return torch.clamp(torch.sum(torch.cumsum(q, 0) <= u), max=q.shape[0] - 1)


class _FactoredCut:
    """Lazy doubled view of a single-layer projected cut MPS
    (`tnqs/bmps_engine.py:1504`).

    Holds the single-layer tensors `l1[i]` [chain_in, bond, chain_out] and
    builds the doubled ket x bra message ``l (x) conj(l) -> [chain^2,
    bond_ket, bond_bra, chain^2]`` only where a vertex consumes it: one
    expanded message is live per ladder step instead of a whole cut's."""

    def __init__(self, l1: list):
        self.l1 = l1

    def __getitem__(self, i):
        l = self.l1[i]
        p, b, P = l.shape
        return torch.einsum("pbP,qcQ->pqbcPQ", l, l.conj()).reshape(p * p, b, b, P * P)


class BMPSSampler:
    """Boundary-MPS certified sampler for engine states
    (`tnqs/bmps_engine.py:1528`).

    The autoregressive column sweep: each vertex's bit is drawn from the
    diagonal of its conditional RDM, between the right (norm-network)
    boundary MPS of its column and the left boundary MPS projected on the
    bits drawn so far, scaled by 1/sqrt(q_v).  The right boundaries do not
    depend on the sample and are built once per call (`_norm`); the
    projected left boundary is zipped per sample.  The samples of a group
    of `chunk` lanes advance together: one lane's sweep is mapped over the
    group by `torch.func.vmap`, so every contraction is one batched call,
    and nothing in a group reads a device value on the host.  Groups run
    one after another against the shared boundaries, which bounds the live
    memory by one group's.

    Dropped norm factors are kept in log space, summed in float64 (a
    127-site p(x) is ~2^-127, a float32 zero; `_zero`), and the certificate
    ``poverq`` = p(x)/q(x) is normalized by the BP partition function Z_BP,
    so E_q[p/q] = <psi|psi>/Z_BP ~= 1.  There is no division by the rank-limited norm
    estimate, which is biased low; it is reported as ``norm_estimate``.
    Converge the engine's messages (`bp_update`, or `evolve`) first: Z_BP
    is read from them.

    `proj_rank` bounds the projected sweep (default 5 chi).  `q_mode`
    "factored" carries the projected boundary as a single-layer MPS of rank
    `proj_rank` and expands l (x) conj(l) only where a vertex consumes it
    (rank r carries a doubled rank r^2; not on ring plans).  A bit is the
    `inverse_cdf` of its vertex's law at its draw value, the values of
    sample s being ``uniforms(seed, s, nv)`` (default `cpu_uniforms`).  At
    d = 2 the values 0.0 and 1.0 take bits 0 and 1 whatever the law, which
    is how the tests replay JAX's bits.  The library calls and sketches are
    the `BMPSEngine`'s, each fold drawn once per call
    (`BMPSEngine.sketches_cached`)."""

    def __init__(self, bmps: BMPSEngine, proj_rank: int | None = None, q_mode: str = "doubled", uniforms=None):
        self.bmps = bmps
        self.proj_rank = int(proj_rank) if proj_rank is not None else 5 * bmps.engine.chi
        self.q_mode = str(q_mode)
        if self.q_mode not in ("doubled", "factored"):
            raise ValueError(f"unknown q_mode {q_mode!r}")
        cp = bmps.cplan
        if cp.periodic and self.q_mode == "factored":
            raise NotImplementedError(
                "factored-q sampling on ring column quotients is not supported (the wrap-cut norm message is a "
                "doubled-layer object with no exact single-layer factorization); use q_mode='doubled'")
        self.keys_order = [v for col in cp.columns for v in col]
        self._vidx = {v: i for i, v in enumerate(self.keys_order)}
        self.uniforms = cpu_uniforms if uniforms is None else uniforms

    # -- column helpers ----------------------------------------------------
    def _cut_maps(self, c: int):
        cp = self.bmps.cplan
        nC = len(cp.columns)
        # ring plans: column 0's left cut is the wrap cut (index nC-1)
        lcut = cp.cross[(c - 1) % nC] if (c > 0 or cp.periodic) else []
        rcut = cp.cross[c] if c < len(cp.cross) else []
        return {e[1]: i for i, e in enumerate(lcut)}, {e[0]: i for i, e in enumerate(rcut)}

    def _msgs(self, v, l_of, r_of, L, R, pl: int, pr: int, dt):
        Ml = L[l_of[v]] if v in l_of else self.bmps._eye4(pl, dt)
        Mr = R[r_of[v]] if v in r_of else self.bmps._eye4(pr, dt)
        return Ml, Mr

    @staticmethod
    def _step_up(D, Ml, Mr, K, B, budget: int = _EINSUM_BUDGET):
        # the down step under the chain/bond axis swap (see `_ladder_walks`)
        return BMPSEngine._ladder_transfer(D, Ml.permute(3, 1, 2, 0), Mr.permute(3, 1, 2, 0),
                                           K.permute(0, 2, 1, 3, 4), B.permute(0, 2, 1, 3, 4), budget=budget)

    @staticmethod
    def _renorm(X):
        """(X / n, log n) with n = ||X|| + 1e-30: every carry is renormalized
        per step, its scale kept in log space (float64, `_zero`)."""
        n = torch.sqrt(torch.sum(X.abs() ** 2)) + 1e-30
        return X / n, torch.log(n.to(torch.float64))

    def _zero(self):
        """A log-space accumulator.  JAX sums the sampler's logs in float32
        (`tnqs/bmps_engine.py:1641-1642`); at 127 sites they reach ~270,
        where a float32 ulp is 3e-5, so p/q = exp(sum) would carry a few
        times 3e-5 of rounding that depends on the device's reduction
        order.  The port sums them in float64."""
        return torch.zeros((), dtype=torch.float64, device=self.bmps.engine.device)

    def _log_z_bp(self, T, M):
        """log Z_BP = sum_v log|z_v| - sum_e log|z_e| on the device, each term
        log(|z| + 1e-30) (`tnqs/bmps_engine.py:1644`) of the engine's
        `_bp_scalars`, summed in float64 (`_zero`).  Not `freenergy`, which
        reads the scalars on the host."""
        vs, es = self.bmps.engine._bp_scalars(T, M)
        logz = self._zero()
        for z in vs.values():
            logz = logz + torch.sum(torch.log(z.abs().to(torch.float64) + 1e-30))
        return logz - torch.sum(torch.log(es.abs().to(torch.float64) + 1e-30))

    def _column_norm(self, T, c: int, R: list, dt):
        """Walk down column c closed against the cut-c MPS: the boundary-MPS
        estimate of log <psi|psi> (relative scale)."""
        be = self.bmps
        l_of, r_of = self._cut_maps(c)
        U = be._ones((1, 1, 1, 1), dt)
        ulog = self._zero()
        for v in be.cplan.columns[c]:
            K = be._vertex_tensor(T, v)
            Ml, Mr = self._msgs(v, l_of, r_of, [], R, U.shape[0], U.shape[1], dt)
            U, dl = self._renorm(BMPSEngine._ladder_transfer(U, Ml, Mr, K, K.conj()))
            ulog = ulog + dl
        return torch.log(U.reshape(()).abs() + 1e-30) + ulog

    def _sample_column(self, T, c: int, L, R: list, u_row, dt, budget: int):
        """Draw every bit of column c top to bottom (`tnqs/bmps_engine.py:
        1701`): (projected vertex tensors, bits, log q of the column, log of
        the unnormalized trace at the column's first vertex).  Each
        conditional diagonal is d site-projected down steps closed against
        the environment below."""
        be = self.bmps
        col = be.cplan.columns[c]
        l_of, r_of = self._cut_maps(c)
        n = len(col)
        D = [None] * (n + 1)
        dlog = [None] * (n + 1)
        D[n], dlog[n] = be._ones((1, 1, 1, 1), dt), self._zero()
        for i in range(n - 1, -1, -1):
            v = col[i]
            K = be._vertex_tensor(T, v)
            # identity messages carry the chain dims of the carry through
            # vertices without a cross bond
            Ml, Mr = self._msgs(v, l_of, r_of, L, R, D[i + 1].shape[0], D[i + 1].shape[1], dt)
            D[i], dl = self._renorm(self._step_up(D[i + 1], Ml, Mr, K, K.conj(), budget))
            dlog[i] = dlog[i + 1] + dl
        U = be._ones((1, 1, 1, 1), dt)
        ulog = self._zero()
        Kp, bits, log_tr_first = {}, {}, None
        logq = self._zero()
        for i, v in enumerate(col):
            K = be._vertex_tensor(T, v)
            d = K.shape[0]
            Ml, Mr = self._msgs(v, l_of, r_of, L, R, U.shape[0], U.shape[1], dt)
            diag = torch.stack([
                torch.sum(BMPSEngine._ladder_transfer(U, Ml, Mr, K[s : s + 1], K[s : s + 1].conj(), budget)
                          * D[i + 1]).real
                for s in range(d)])
            q, tr = conditional_law(diag)
            if i == 0:
                log_tr_first = torch.log(tr.to(torch.float64) + 1e-30) + ulog + dlog[i + 1]
            b = inverse_cdf(q, u_row[self._vidx[v]])
            oh = torch.arange(d, device=q.device) == b
            qv = torch.sum(torch.where(oh, q, 0.0)).to(torch.float32)
            Kpv = torch.einsum("s,sudlr->udlr", oh.to(dt), K)[None] * torch.rsqrt(qv).to(dt)
            Kp[v] = Kpv
            bits[v] = b
            logq = logq + torch.log(qv.to(torch.float64))
            U, du = self._renorm(BMPSEngine._ladder_transfer(U, Ml, Mr, Kpv, Kpv.conj(), budget))
            ulog = ulog + du
        return Kp, bits, logq, log_tr_first

    def _zip1_column(self, Kx_of, c: int, incoming: list, rank: int, budget: int, dt, tag: int = 0):
        """Single-layer zip of the bit-projected column c, left to right
        (`tnqs/bmps_engine.py:1801`): messages carry one bond leg [chain_in,
        bond, chain_out].  Returns (emitted MPS tensors, log of the dropped
        norm factors).  Sketch folds: tag 0 the independent certification
        sweep, tag 1 the factored draw boundaries, so the certificate shares
        no draw with the sample."""
        be = self.bmps
        cp = be.cplan
        col = cp.columns[c]
        consume_cut = cp.cross[c - 1] if c > 0 else []
        emit_cut = cp.cross[c] if c < len(cp.cross) else []
        consume_of = {e[1]: i for i, e in enumerate(consume_cut)}
        emit_of = {e[0]: i for i, e in enumerate(emit_cut)}
        C = be._ones((1, 1, 1), dt)  # [q, p, a]
        logscale = self._zero()
        emitted: list = [None] * len(emit_cut)
        last_emit = -1
        for v in col:
            Kx = Kx_of(v)  # [u(a), d(A), l, r]
            if v in consume_of:
                Min = incoming[consume_of[v]]  # [p, l, P]
            else:
                p = C.shape[1]
                Min = torch.eye(p, dtype=dt, device=be.engine.device).reshape(p, 1, p)
            q, P = C.shape[0], Min.shape[2]
            A, r = Kx.shape[1], Kx.shape[3]
            if v in emit_of:
                M_, N_ = q * r, P * A
                x = min(rank, M_, N_)
                # the per-lane budget gates the exact route, as in the doubled zip
                if M_ * N_ <= min(_EXACT_EMIT_LIMIT, budget):
                    Q, Cnew, logn = _exact_emit1_step_block(C, Min, Kx, keep=x)
                else:
                    xs = min(x + be.oversample, M_, N_)
                    code = c * 4096 + 1024 + 512 * tag + cp.order_in_col[v]
                    omega = be._draw(code, (P, A, xs), dt)
                    per_x = 2 * max(A, 1) * max(r, 1) * max(q, P, 1)
                    xc = max(1, int(budget // max(per_x, 1)))
                    Q, Cnew, logn = _emit1_step_block(C, Min, Kx, omega, xc=xc, keep=x, power_iters=be.power_iters)
                logscale = logscale + logn
                emitted[emit_of[v]] = Q  # [q, r, x]
                C = Cnew.movedim(-1, 0)  # [x, P, A]
                last_emit = emit_of[v]
            else:
                C = _pass1_step_block(C, Min, Kx[..., 0], budget=int(budget))
                nrm = torch.sqrt(torch.sum(C.abs() ** 2)) + 1e-30
                logscale = logscale + torch.log(nrm.to(torch.float64))
                C = C / nrm
        if last_emit >= 0:
            tail = C.reshape(C.shape[0])
            emitted[last_emit] = torch.einsum("qrx,x->qr", emitted[last_emit], tail)[..., None]
        else:
            logscale = logscale + torch.log(C.reshape(()).abs().to(torch.float64) + 1e-30)
        return emitted, logscale

    # -- the sample-independent half --------------------------------------
    def _norm(self):
        """The boundaries every group shares (`tnqs/bmps_engine.py:1972`):
        (right boundary MPS of each column, their dropped-norm logs, the
        certificate's log divisor, the log norm estimate in the same
        convention, the projected boundary's start).

        Line plans: the right boundaries zipped from the last column, the
        divisor log Z_BP, an empty start.  Ring plans: the Gauss-Seidel
        fixed point (`_boundary_mpses`), whose scale is arbitrary, so the
        divisor is the same pipeline run on the unprojected network (a
        "ghost" reference sharing the wrap-cut caps, whose unknown scales
        cancel), and the start is the wrap cut's left boundary."""
        be = self.bmps
        cp = be.cplan
        nC = len(cp.columns)
        T, M = be.engine.T, be.engine.M
        dt = be._dtype(T)
        log_zbp = self._log_z_bp(T, M)
        if cp.periodic:
            lefts, rights = be._boundary_mpses(T, M)

            def ket_of(v):
                return be._vertex_tensor(T, v)

            Lg = list(lefts[0])
            llog_ref = self._zero()
            for c in range(nC - 1):
                Lg, dl = be._zip_column(T, c, Lg, +1)
                llog_ref = llog_ref + dl
            log_col_ref, _ = be._column_scalar(T, nC - 1, Lg, rights[nC - 1], dt, ket_of)
            log_div = log_col_ref + llog_ref
            # the quotient partition formula (each message once in a column
            # scalar and once in a cut scalar), shifted into the Z_BP
            # convention: the caller reports exp(norm_log - log_div)
            norm_log = self._zero()
            for c in range(nC):
                lz, _ = be._column_scalar(T, c, lefts[c], rights[c], dt, ket_of)
                le, _ = be._cut_scalar(lefts[(c + 1) % nC], rights[c], dt)
                norm_log = norm_log + lz - le
            rlog = torch.zeros((nC,), dtype=torch.float64, device=be.engine.device)
            return rights, rlog, log_div, norm_log - log_zbp + log_div, list(lefts[0])
        rights: list = [None] * nC
        rlog: list = [None] * nC
        cur: list = []
        acc = self._zero()
        for c in range(nC - 1, -1, -1):
            rights[c] = cur
            rlog[c] = acc
            if c > 0:
                cur, ls = be._zip_column(T, c, cur, -1)
                acc = acc + ls
        norm_log = self._column_norm(T, 0, rights[0], dt) + rlog[0]
        return rights, torch.stack(rlog), log_zbp, norm_log, []

    # -- one lane, and a group of them ------------------------------------
    def _lane(self, rights, rlog, log_div, start, budget: int, u_row):
        """One sample's sweep (`tnqs/bmps_engine.py:2074`): (bits [nv] in
        `keys_order`, log q, p/q)."""
        be = self.bmps
        cp = be.cplan
        nC = len(cp.columns)
        T = be.engine.T
        dt = be._dtype(T)
        L = list(start) if self.q_mode == "doubled" else _FactoredCut([])
        llog = self._zero()
        logq = self._zero()
        bits_all = []
        log_tr_last = None
        for c in range(nC):
            Kp, bits, lq, log_tr = self._sample_column(T, c, L, rights[c], u_row, dt, budget)
            logq = logq + lq
            bits_all.extend(bits[v] for v in cp.columns[c])
            if c == nC - 1:
                log_tr_last = log_tr
            elif self.q_mode == "factored":
                l1, dlog1 = self._zip1_column(lambda v, Kp=Kp: Kp[v][0], c, L.l1, self.proj_rank, budget, dt, tag=1)
                L = _FactoredCut(l1)
                llog = llog + 2.0 * dlog1  # the doubled boundary is l (x) conj(l)
            else:
                L, dlog = be._zip_column(T, c, L, +1, rank=self.proj_rank, K_of=lambda v, Kp=Kp: Kp[v],
                                         budget=budget)
                llog = llog + dlog
        # the last column's conditionals are exact on the chain, so the
        # partial-bitstring ratio is the whole one (`tnqs/bmps_engine.py:2114`)
        poverq = log_tr_last + llog + rlog[nC - 1] - log_div
        return torch.stack(bits_all), logq, torch.exp(poverq)

    def _group(self, norm, u, budget: int):
        """The lanes of u [width, nv] in one batched sweep."""
        rights, rlog, log_div, _, start = norm
        # randomness="same": a fold drawn inside the map is one draw for
        # every lane (the sketches do not depend on the sample)
        return torch.func.vmap(partial(self._lane, rights, rlog, log_div, start, budget), randomness="same")(u)

    @staticmethod
    def _lane_budget(width: int) -> int:
        """Per-lane einsum budget: every intermediate of a group is `width`
        lanes wide (`tnqs/bmps_engine.py:2067`)."""
        return max(4096, _EINSUM_BUDGET // max(1, width))

    def _padded(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x with its last row repeated up to a multiple of `width` rows."""
        pad = (-x.shape[0]) % width
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x

    # -- public API -------------------------------------------------------
    def sample_directly_certified(self, nsamples: int, seed: int = 0, chunk: int | None = None):
        """Draw `nsamples` bitstrings with their p/q certificates
        (`tnqs/bmps_engine.py:2121`).

        `chunk` caps the lanes of a group (default: all at once); groups
        run one after another against the shared boundaries, the last one
        padded by repeating its last lane.  A sample's bits depend only on
        (seed, its index), so any chunking gives the same bitstrings.

        Returns a list of dicts with ``poverq``, ``logq``, ``norm_estimate``
        and ``bitstring`` (vertex -> 0..d-1)."""
        nv = len(self.keys_order)
        width = nsamples if chunk is None else max(1, min(int(chunk), nsamples))
        budget = self._lane_budget(width)
        dev = self.bmps.engine.device
        u = torch.stack([self.uniforms(seed, s, nv) for s in range(nsamples)]).to(dev)
        u = self._padded(u, width)
        with self.bmps.sketches_cached():
            norm = self._norm()
            parts = [self._group(norm, u[i : i + width], budget) for i in range(0, u.shape[0], width)]
        bits = torch.cat([p[0] for p in parts])[:nsamples].cpu().numpy()
        vals = torch.stack([torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts])])[:, :nsamples]
        logq, poverq = vals.cpu().numpy()
        n_hat = float(torch.exp(norm[3] - norm[2]).cpu())
        return [dict(poverq=float(poverq[s]), logq=float(logq[s]), norm_estimate=n_hat,
                     bitstring={v: int(bits[s, i]) for i, v in enumerate(self.keys_order)})
                for s in range(nsamples)]

    def _log_abs_amplitude(self, bits_row, cert_rank: int, budget: int):
        """log |<x|psi>| by single-layer zip sweeps over the bit-projected
        network (`tnqs/bmps_engine.py:1875`), x as bits in `keys_order`."""
        be = self.bmps
        T = be.engine.T
        dt = be._dtype(T)

        def Kx_of(v):
            K = be._vertex_tensor(T, v)  # [s, u, d, l, r]
            oh = (torch.arange(K.shape[0], device=K.device) == bits_row[self._vidx[v]]).to(dt)
            return torch.einsum("s,sudlr->udlr", oh, K)

        cur: list = []
        total = self._zero()
        for c in range(len(be.cplan.columns)):
            cur, ls = self._zip1_column(Kx_of, c, cur, cert_rank, budget, dt)
            total = total + ls
        return total

    def sample_certified(self, nsamples: int, seed: int = 0, cert_rank: int | None = None,
                         chunk: int | None = None):
        """Samples with independently certified p/q (`tnqs/bmps_engine.py:
        1913`): drawn by `sample_directly_certified`, then each certificate
        estimated again by a single-layer zip contraction of <x|psi> at bond
        dimension `cert_rank` (default `proj_rank`), which shares nothing
        with the draw beyond the state.

        Returns the draws' dicts with ``poverq`` the independent estimate and
        ``poverq_direct`` the draw-time one; E_q[poverq] ~= 1."""
        if self.bmps.cplan.periodic:
            raise NotImplementedError(
                "independent re-certification on ring column quotients is not supported (the single-layer "
                "<x|psi> sweep would need a boundary MPO carrying the open wrap chain); use "
                "sample_directly_certified")
        out = self.sample_directly_certified(nsamples, seed=seed, chunk=chunk)
        cert_rank = self.proj_rank if cert_rank is None else int(cert_rank)
        width = nsamples if chunk is None else max(1, min(int(chunk), nsamples))
        budget = self._lane_budget(width)
        eng = self.bmps.engine
        bits = torch.tensor([[o["bitstring"][v] for v in self.keys_order] for o in out], device=eng.device)
        logq = torch.tensor([o["logq"] for o in out], dtype=torch.float64, device=eng.device)
        bits, logq = self._padded(bits, width), self._padded(logq, width)

        def one(log_zbp, bits_row, lq):
            return torch.exp(2.0 * self._log_abs_amplitude(bits_row, cert_rank, budget) - log_zbp - lq)

        with self.bmps.sketches_cached():
            log_zbp = self._log_z_bp(eng.T, eng.M)
            cert = partial(one, log_zbp)
            parts = [torch.func.vmap(cert, randomness="same")(bits[i : i + width], logq[i : i + width])
                     for i in range(0, bits.shape[0], width)]
        poverq = torch.cat(parts)[:nsamples].cpu().numpy()
        for o, pq in zip(out, poverq):
            o["poverq_direct"] = o["poverq"]
            o["poverq"] = float(pq)
        return out
