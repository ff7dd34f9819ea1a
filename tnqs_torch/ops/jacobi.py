"""Batched Hermitian eigensolver by two-sided parallel Jacobi.

Port of `tnqs/ops/jacobi.py::jacobi_eigh` (`tnqs/ops/jacobi.py:208`).  The
rotation rounds run in the CUDA kernel `tnqs_torch/csrc/jacobi_eigh.cu` on a
CUDA tensor (up to n = 128 a cluster of three CTAs per matrix, H resident in
one CTA's shared memory and V in the other two's; past n = 128 H resident
in the shared memory of a cluster of 2, 4, 8 or 16 CTAs up to n = 598, each
CTA holding the columns of H at its pair positions, else in device memory
kept hot in L2, `eigh_log_plan`; V's columns in the same CTAs up to
n = 224, else V from the rounds' rotation log,
`rotation_log.apply_rotation_log`, `v_route_of`), and in
`_jacobi_eigh_plain`, the same schedule written in PyTorch, on a CPU
tensor.  The Newton–Schulz repair of V, the Rayleigh eigenvalues and the
ascending sort (`tnqs/ops/jacobi.py:300-318`) are PyTorch in both cases.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from . import rotation_log
from ._build import SMEM_LIMIT
from .rotation_log import apply_rotation_log

EPS32 = float(torch.finfo(torch.float32).eps)
RES_CLUSTERS = (16, 8, 4, 2)  # K2's resident cluster sizes, past n = 128
L2_CLUSTERS = (16, 8)  # cluster sizes of the L2 variants and of K1's resident one
L2_BUDGET = 40 * 2**20  # bytes of live iterates the L2 variants keep in the H100's 50 MB L2
LOG_BUDGET = 512 * 2**20  # bytes of rotation log one launch past the cluster kernels may write
# V's columns in the resident rings up to this width, where H and V fit clusters of 4 (the rings beat
# the log there on the H100, the log past it: `v_route_of`)
RING_N = 224


def _rot_params(a, b, gr, gi, eps: float, relative: bool):
    """Complex Jacobi rotation annihilating g in [[a, g], [conj(g), b]],
    identity when |g| <= eps (`tnqs/ops/jacobi.py:58`), or with `relative`
    when |g| <= eps sqrt(|a|) sqrt(|b|).  Inputs [B, m] float32; returns
    (c, s) with J = [[c, -conj(s)], [s, c]], and whether each rotation is
    taken."""
    absg = torch.sqrt(gr * gr + gi * gi)
    safe = absg > (eps * torch.sqrt(torch.abs(a)) * torch.sqrt(torch.abs(b)) if relative else eps)
    ga = torch.where(safe, absg, 1.0)
    phr = torch.where(safe, gr / ga, 1.0)
    phi = torch.where(safe, gi / ga, 0.0)
    tau = (b - a) / (2.0 * ga)
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)
    t = -sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    sm = t * c
    c = torch.where(safe, c, 1.0)
    s = torch.complex(torch.where(safe, sm * phr, 0.0), torch.where(safe, -sm * phi, 0.0))
    return c, s, safe


def round_robin(n: int, device) -> torch.Tensor:
    """Old position of each position's entry in the next round: the
    tournament of `pcol`/`prow` (`tnqs/ops/jacobi.py:98-106`) with position 0
    fixed, left' = [l0, r0, l1 .. l(m-2)], right' = [r1 .. r(m-1), l(m-1)]."""
    m = n // 2
    order = [0, m] + list(range(1, m - 1)) + list(range(m + 1, n)) + [m - 1]
    return torch.tensor(order, device=device)


def index_at(j: int, r: int, n: int) -> int:
    """Index that stands at position j after r rounds of `round_robin`, in
    closed form, as the CUDA kernels compute it (`index_at` in
    `tnqs_torch/csrc/jacobi_eigh.cu` and `osj_svd.cu`).  Position 0 stays;
    the other n-1 positions form one cycle, m -> 1 -> 2 -> ... -> m-1 -> n-1
    -> n-2 -> ... -> m+1 -> m, along which every entry moves one step a
    round, so after whole sweeps of n-1 rounds every index is home again."""
    m = n // 2
    if j == 0:
        return 0
    k = ((j if j < m else 0 if j == m else 3 * m - 1 - j) - r) % (n - 1)
    return m if k == 0 else k if k < m else 3 * m - 1 - k


def next_position(j: int, n: int) -> int:
    """The position the entry at position j takes in the next round, along
    the cycle of `index_at`: index_at(next_position(j), r + 1) ==
    index_at(j, r).  The L2 variant's CTAs (`next_position` in
    `tnqs_torch/csrc/jacobi_eigh.cu`) use it to hand each column's next
    entries to the CTA that owns the column next."""
    m = n // 2
    if j == 0:
        return 0
    if j == m:
        return 1
    if j < m - 1:
        return j + 1
    return n - 1 if j == m - 1 else j - 1


def _jacobi_eigh_plain(H: torch.Tensor, sweeps: int, relative: bool = True):
    """The kernel's rounds in PyTorch: pair i is (position i, position
    m+i) of the top and bottom halves, as in the JAX kernel body
    (`_make_kernel`, `tnqs/ops/jacobi.py:81`), and the data moves between
    rounds.  H [B, n, n] hermitian complex64.  Returns (w [B, n] unsorted,
    V [B, n, n]); the count of rotations taken (not skipped), a device
    scalar, stays in `_jacobi_eigh_plain.rotations`."""
    _jacobi_eigh_plain.calls += 1
    B, n, _ = H.shape
    m = n // 2
    perm = round_robin(n, H.device)
    W = torch.eye(n, dtype=H.dtype, device=H.device).expand(B, n, n)
    taken = torch.zeros((), dtype=torch.int64, device=H.device)
    for _ in range(sweeps * (n - 1)):
        d = H.diagonal(dim1=1, dim2=2).real
        g = H[:, :m, m:].diagonal(dim1=1, dim2=2)
        c, s, live = _rot_params(d[:, :m], d[:, m:], g.real, g.imag, EPS32, relative)
        taken += live.sum()
        if not live.any():  # the kernel's skipped round: the move alone
            H, W = H[:, :, perm][:, perm], W[:, :, perm]
            continue
        # rows: top' = c*top + conj(s)*bot ; bot' = -s*top + c*bot
        cc, sc = c[:, :, None], s[:, :, None]
        top, bot = H[:, :m], H[:, m:]
        H = torch.cat([cc * top + sc.conj() * bot, -sc * top + cc * bot], 1)
        # columns of H and V: left' = c*left + s*right ; right' = -conj(s)*left + c*right
        cr, sr = c[:, None, :], s[:, None, :]
        X = torch.cat([H, W], 1)
        lft, rgt = X[:, :, :m], X[:, :, m:]
        X = torch.cat([cr * lft + sr * rgt, -sr.conj() * lft + cr * rgt], 2)[:, :, perm]
        H, W = X[:, :n][:, perm], X[:, n:]
    _jacobi_eigh_plain.rotations = taken
    return H.diagonal(dim1=1, dim2=2).real, W


_jacobi_eigh_plain.calls = 0
_jacobi_eigh_plain.rotations = None


class L2Plan(NamedTuple):
    """An L2 variant's launch: `cluster` CTAs a matrix, `clusters` clusters
    (matrices) at once, the batch in `waves` of them, `scratch` bytes of
    device memory (the iterates and the exchange buffers) and `smem` shared
    bytes a CTA."""
    cluster: int
    clusters: int
    waves: int
    scratch: int
    smem: int


def l2_plan(B: int, live: int, exchange: int, smem: int, active) -> L2Plan:
    """The L2 variants' launch for B matrices whose iterates take `live`
    bytes each and whose clusters each take `exchange` bytes of exchange
    buffers: clusters of 16 where the card holds one (`active(C)`,
    `cudaOccupancyMaxActiveClusters`), else 8; as many matrices at once as
    keep their iterates within `L2_BUDGET` (at least one), at most B and at
    most what the card holds.  RuntimeError when it holds no cluster."""
    if smem > SMEM_LIMIT:
        raise ValueError(f"the L2 variants' {smem} shared bytes a CTA exceed {SMEM_LIMIT}")
    for C in L2_CLUSTERS:
        held = active(C)
        if held > 0:
            at_once = max(1, min(B, L2_BUDGET // live, held))
            return L2Plan(C, at_once, -(-B // at_once), B * live + at_once * exchange, smem)
    raise RuntimeError(f"no cluster of {L2_CLUSTERS} CTAs fits on the card")


class LogPlan(NamedTuple):
    """A launch past the cluster kernels, V from the rotation log: `layout`
    "resident" (the iterate in the cluster's shared memory) or "l2" (in
    device memory kept hot in L2); `cluster` CTAs a matrix, `clusters`
    clusters the card holds at once, the batch in `waves` of them; `group`
    matrices and `chunk` rounds a launch (`log_chunks`: `LOG_BUDGET` bounds
    the log); `scratch` bytes of device memory a launch (the log, and for
    "l2" the iterates and exchange buffers); `smem` shared bytes a CTA."""
    layout: str
    cluster: int
    clusters: int
    waves: int
    group: int
    chunk: int
    scratch: int
    smem: int


def log_group(B: int, n: int, rounds: int) -> int:
    """Matrices a launch whose logs (16 n/2 bytes a round) fit `LOG_BUDGET`,
    at least one."""
    return max(1, min(B, LOG_BUDGET // max(1, 8 * n * rounds)))


def log_chunks(B: int, n: int, rounds: int) -> tuple[int, int]:
    """(matrices, rounds) a launch whose log fits `LOG_BUDGET`: the whole
    schedule for as many matrices as fit (`log_group`); where not even one
    matrix's does, one matrix and the rounds that fit, V then taken from
    each launch's log in turn (the L2 variants only: their iterate stays in
    device memory between launches)."""
    group = log_group(B, n, rounds)
    return group, max(1, min(rounds, LOG_BUDGET // (8 * n * group)))


def resident_choice(B: int, sizes, active):
    """Of the resident cluster sizes `sizes`, the one whose clusters take B
    matrices in the fewest waves (`active(C)` clusters at once; the larger C
    on a tie, its rounds being shorter): (C, clusters at once, waves), or
    None when the card holds none of them."""
    best = None
    for C in sorted(sizes, reverse=True):
        held = active(C)
        if held > 0 and (best is None or -(-B // held) < best[2]):
            best = (C, held, -(-B // held))
    return best


def eigh_res_smem(n: int, C: int, v_ring: bool = False) -> int:
    """The resident variant's shared bytes a CTA (`res_smem_bytes` in
    `tnqs_torch/csrc/jacobi_eigh.cu`): two rounds' entries of every column,
    the m rotations, 2 pmax + 5 column slots of H (two rings of pmax + 2 and
    position 0) and, with `v_ring`, as many of V, two mbarriers, the index at
    each position and the CTA's pairs' slots."""
    pmax = -(-(n // 2) // C)
    return 40 * n + 8 * (2 if v_ring else 1) * (2 * pmax + 5) * n + 16 + 4 * n + 8 * pmax


def eigh_res_fits(n: int, C: int, v_ring: bool = False) -> bool:
    """Whether the resident variant holds H [n, n] (with `v_ring` also V,
    n <= `RING_N`) on C of `RES_CLUSTERS` CTAs: even n > 128, at least two
    pairs a CTA, within a CTA's shared memory (n = 256 on 4, 598 on 16)."""
    return (n % 2 == 0 and 128 < n <= (RING_N if v_ring else n) and C in RES_CLUSTERS and (n // 2) // C >= 2
            and eigh_res_smem(n, C, v_ring) <= SMEM_LIMIT)


def eigh_l2_smem(n: int) -> int:
    """The L2 variant's shared bytes a CTA (`l2_smem_bytes` in
    `tnqs_torch/csrc/jacobi_eigh.cu`): the m rotations and the index at each
    position."""
    return 16 * (n // 2) + 4 * n


def eigh_l2_plan(B: int, n: int, active) -> L2Plan:
    """The L2 variant's launch for B matrices [n, n] (n > 256): H
    column-major, 8 n^2 bytes a matrix, and each cluster's exchange buffer
    (a float4 a column, two rounds), `l2_plan`."""
    if n % 2 or n <= 256:
        raise ValueError(f"the L2 jacobi_eigh kernel takes even n > 256, got {n}")
    return l2_plan(B, 8 * n * n, 32 * n, eigh_l2_smem(n), active)


def eigh_log_plan(B: int, n: int, rounds: int, active) -> LogPlan:
    """K2's launch past n = 128 for B matrices [n, n] and `rounds` rounds:
    the resident variant where H fits a cluster the card holds
    (`eigh_res_fits`, `resident_choice`) and one matrix's log fits
    `LOG_BUDGET`, else (past n = 256) the L2 variant (`eigh_l2_plan`), in
    chunks of rounds where it must (`log_chunks`); `active(layout, C)` the
    clusters of C the card holds at once.  Up to n = 256 no L2 variant
    runs: a card that holds no resident cluster raises RuntimeError."""
    if n % 2 or n <= 128:
        raise ValueError(f"jacobi_eigh takes the variants past the cluster kernel at even n > 128, got {n}")
    group, chunk = log_chunks(B, n, rounds)
    log = group * 8 * n * chunk
    best = resident_choice(B, [C for C in RES_CLUSTERS if eigh_res_fits(n, C)],
                           lambda C: active("resident", C)) if chunk >= rounds else None
    if best is not None:
        C, held, waves = best
        return LogPlan("resident", C, held, waves, group, chunk, log, eigh_res_smem(n, C))
    if n <= 256:
        if chunk < rounds:
            raise ValueError(f"jacobi_eigh at n={n}: one matrix's log of {rounds} rounds exceeds LOG_BUDGET")
        raise RuntimeError(f"jacobi_eigh: no resident cluster for n={n} fits on the card")
    p = eigh_l2_plan(group, n, lambda C: active("l2", C))
    return LogPlan("l2", p.cluster, p.clusters, -(-B // p.clusters), group, chunk, log + p.scratch, p.smem)


@functools.cache
def l2_active_clusters(device: torch.device, n: int, C: int) -> int:
    """How many clusters of C CTAs of the L2 variant at size n the card holds
    at once (`cudaOccupancyMaxActiveClusters`)."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.kernels().tnqs_jacobi_eigh_l2_clusters(n, C, ctypes.byref(active)),
                     "tnqs_jacobi_eigh_l2_clusters")
    return active.value


@functools.cache
def res_active_clusters(device: torch.device, n: int, C: int, v_ring: bool = False) -> int:
    """How many clusters of C CTAs of the resident variant at size n (with
    `v_ring`, V in the rings) the card holds at once
    (`cudaOccupancyMaxActiveClusters`)."""
    active = ctypes.c_int(0)
    lib = _build.kernels()
    fn, name = ((lib.tnqs_jacobi_eigh_res_v_clusters, "tnqs_jacobi_eigh_res_v_clusters") if v_ring else
                (lib.tnqs_jacobi_eigh_res_clusters, "tnqs_jacobi_eigh_res_clusters"))
    with torch.cuda.device(device):
        _build.check(fn(n, C, ctypes.byref(active)), name)
    return active.value


def log_active_clusters(device: torch.device, n: int):
    """`eigh_log_plan`'s `active(layout, C)` on this device."""
    def active(layout, C):
        return (res_active_clusters if layout == "resident" else l2_active_clusters)(device, n, C)
    return active


def eigh_ring_plan(B: int, n: int, active):
    """The resident variant with V's columns in the rings (128 < n <= `RING_N`):
    (C, clusters at once, waves, shared bytes a CTA) by `resident_choice`
    over the sizes whose CTAs hold both; `active(C)` the clusters of C the
    card holds.  RuntimeError when it holds none."""
    best = resident_choice(B, [C for C in RES_CLUSTERS if eigh_res_fits(n, C, True)], active)
    if best is None:
        raise RuntimeError(f"jacobi_eigh: no resident cluster holding H and V for n={n} fits on the card")
    return best + (eigh_res_smem(n, best[0], True),)


def _jacobi_eigh_ring(H: torch.Tensor, sweeps: int, relative: bool, stream):
    """K2 for 128 < n <= `RING_N` with V in the rings
    (`tnqs_jacobi_eigh_res_v`, `eigh_ring_plan`), one launch.  Returns
    (w [B, n] unsorted, V [B, n, n])."""
    B, n, _ = H.shape
    C = eigh_ring_plan(B, n, lambda C: res_active_clusters(H.device, n, C, True))[0]
    vt = torch.empty_like(H)
    w = torch.empty((B, n), dtype=torch.float32, device=H.device)
    jacobi_eigh.rotations = torch.zeros((), dtype=torch.int64, device=H.device)
    err = _build.kernels().tnqs_jacobi_eigh_res_v(H.data_ptr(), vt.data_ptr(), w.data_ptr(),
                                                  jacobi_eigh.rotations.data_ptr(), B, n, sweeps * (n - 1), EPS32,
                                                  int(relative), C, stream)
    _build.check(err, "tnqs_jacobi_eigh_res_v")
    _count_launch(B, n, "ring")
    return w, vt.mT


def _jacobi_eigh_past_128(H: torch.Tensor, sweeps: int, relative: bool, stream):
    """K2 past `RING_N` with V from the log (`eigh_log_plan`): the rounds on
    H alone, resident (`tnqs_jacobi_eigh_res`) or in L2 (`tnqs_jacobi_eigh_l2`, in place on a column-major copy of H,
    `plan.chunk` rounds a launch), a group of matrices a launch, V from each
    launch's rotation log.  Returns (w [B, n] unsorted, V [B, n, n])."""
    B, n, _ = H.shape
    lib = _build.kernels()
    rounds = sweeps * (n - 1)
    plan = eigh_log_plan(B, n, rounds, log_active_clusters(H.device, n))
    w = torch.empty((B, n), dtype=torch.float32, device=H.device)
    V = torch.empty_like(H)
    logs = torch.empty(plan.group * plan.chunk * (n // 2) * 4, dtype=torch.float32, device=H.device)
    jacobi_eigh.rotations = torch.zeros((), dtype=torch.int64, device=H.device)
    taken = jacobi_eigh.rotations.data_ptr()
    for g0 in range(0, B, plan.group):
        b = min(plan.group, B - g0)
        log = logs[:b * plan.chunk * (n // 2) * 4].view(b, plan.chunk, n // 2, 4)
        if plan.layout == "resident":
            def launch(started=None, progress=None, stage=1):
                err = lib.tnqs_jacobi_eigh_res(H[g0].data_ptr(), log.data_ptr(), w[g0].data_ptr(), taken,
                                               None if started is None else started.data_ptr(),
                                               None if progress is None else progress.data_ptr(), stage, b, n,
                                               rounds, EPS32, int(relative), plan.cluster, stream)
                _build.check(err, "tnqs_jacobi_eigh_res")
            if rotation_log.follows(b, plan.cluster, plan.clusters, H.device):
                # V's kernel beside the rounds, on the SMs their one or last wave leaves
                with rotation_log.follow(log, None, V[g0:g0 + b], plan.cluster, plan.clusters) as flags:
                    launch(*flags)
            else:
                launch()
                apply_rotation_log(log, out=V[g0:g0 + b])
            _count_launch(B, n, plan.layout)
        else:
            hc = H[g0:g0 + b].mT.contiguous()  # hc[b][col][row] = H[row, col]
            xbuf = torch.empty((plan.clusters, 2, n, 4), dtype=torch.float32, device=H.device)
            for r0 in range(0, max(rounds, 1), plan.chunk):  # one launch at least: V = I at 0 rounds
                k = min(plan.chunk, rounds - r0)
                log = logs[:b * k * (n // 2) * 4].view(b, k, n // 2, 4)
                err = lib.tnqs_jacobi_eigh_l2(hc.data_ptr(), log.data_ptr(), xbuf.data_ptr(), taken, b, n, r0, k,
                                              EPS32, int(relative), plan.cluster, plan.clusters, stream)
                _build.check(err, "tnqs_jacobi_eigh_l2")
                _count_launch(B, n, plan.layout)
                apply_rotation_log(log, None if r0 == 0 else V[g0:g0 + b], out=V[g0:g0 + b], round0=r0)
            w[g0:g0 + b] = hc.diagonal(dim1=1, dim2=2).real
    return w, V


def v_route_of(n: int) -> str:
    """Where K2 past n = 128 makes V: "ring" (V's columns beside H's in the
    resident variant's rings) up to `RING_N`, where both fit clusters of 4,
    else "log" (the rotation log, `rotation_log.apply_rotation_log`).  On
    the H100 the rings were faster up to n = 224 ([26, 192, 192]: one wave
    of clusters of 4 either way, and V's columns take their rotations in the
    round that forms them), the log from n = 226 on (the rings need
    clusters of 8 there, two waves, where H alone takes one wave of 4 and
    V's kernel the SMs it leaves; PERF.md)."""
    return "ring" if 128 < n <= RING_N else "log"


def _count_launch(B: int, n: int, layout: str):
    jacobi_eigh.launches += 1
    jacobi_eigh.launches_by_shape[(B, n)] = jacobi_eigh.launches_by_shape.get((B, n), 0) + 1
    jacobi_eigh.launches_by_layout[layout] += 1


def _jacobi_eigh_cuda(H: torch.Tensor, sweeps: int, relative: bool = True):
    """Launch `tnqs_jacobi_eigh` (n <= 128, one cluster of three CTAs per
    matrix) or, past n = 128, the resident variant with V in the rings
    (`_jacobi_eigh_ring`, up to `RING_N`) or the resident or L2 variant and
    the rotation log (`_jacobi_eigh_past_128`), by `v_route_of(n)`, on H
    [B, n, n] hermitian complex64 (CUDA, contiguous).  Returns (w [B, n]
    unsorted, V [B, n, n])."""
    if H.dim() != 3 or H.shape[1] != H.shape[2] or H.shape[1] % 2 or H.shape[1] < 4:
        raise ValueError(f"jacobi_eigh kernel takes [B, n, n] with even n >= 4, got {tuple(H.shape)}")
    if not (H.is_cuda and H.dtype == torch.complex64 and H.is_contiguous()):
        raise ValueError("jacobi_eigh kernel takes a contiguous complex64 CUDA tensor [B, n, n]")
    B, n, _ = H.shape
    lib = _build.kernels()
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        if n > 128:
            if v_route_of(n) == "ring":
                return _jacobi_eigh_ring(H, sweeps, relative, stream)
            return _jacobi_eigh_past_128(H, sweeps, relative, stream)
        if active_clusters(H.device, n) == 0:
            raise RuntimeError(f"jacobi_eigh kernel: no cluster for n={n} fits on {H.device}")
        vt = torch.empty_like(H)
        w = torch.empty((B, n), dtype=torch.float32, device=H.device)
        err = lib.tnqs_jacobi_eigh(H.data_ptr(), vt.data_ptr(), w.data_ptr(), B, n, sweeps * (n - 1), EPS32,
                                   int(relative), stream)
    _build.check(err, "tnqs_jacobi_eigh")
    jacobi_eigh.launches += 1
    jacobi_eigh.launches_by_shape[(B, n)] = jacobi_eigh.launches_by_shape.get((B, n), 0) + 1
    return w, vt.mT


@functools.cache
def active_clusters(device: torch.device, n: int) -> int:
    """How many of the kernel's clusters of three CTAs for size n <= 128 the
    card holds at once (`cudaOccupancyMaxActiveClusters`;
    `log_active_clusters` past it)."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.kernels().tnqs_jacobi_eigh_clusters(n, ctypes.byref(active)), "tnqs_jacobi_eigh_clusters")
    return active.value


def jacobi_eigh(H: torch.Tensor, sweeps: int = 12, refine: bool = True, relative: bool = True):
    """Eigendecomposition of batched hermitian H [..., n, n] (n even,
    complex64).  Returns (w ascending [..., n] float32, V [..., n, n]) with
    H ~= V diag(w) V^H — the `torch.linalg.eigh` contract.

    The rotation rounds run in the CUDA kernel for a CUDA tensor and in the
    plain PyTorch version for a CPU tensor.  `refine` re-orthonormalizes the
    accumulated rotation product by two Newton–Schulz steps and recomputes
    the eigenvalues as Rayleigh quotients (`tnqs/ops/jacobi.py:300-312`:
    without it the ~4e-5 orthogonality drift of n=128 rotation products
    dominates the eigenpair residual).

    `relative` skips a pair when |g| <= eps sqrt(|a| |b|) (Demmel–Veselić)
    rather than the reference's |g| <= eps.  The absolute skip makes the
    accuracy depend on H's scale: the theta Grams of the chi=64 Eagle run
    shrink with depth, the absolute skip leaves their small eigenpairs
    unconverged, and the Gram truncation then breaks down at layer 7 (a
    non-positive-definite message).  With the relative skip the rounds are
    invariant under a power-of-two scaling of H, bit for bit.  `pjsvd`'s
    preconditioner, which only picks a starting basis for K1, keeps the
    absolute skip."""
    batch_shape = H.shape[:-2]
    n = H.shape[-1]
    if n % 2 != 0:
        raise ValueError("jacobi_eigh requires even n")
    if H.dtype != torch.complex64:
        raise TypeError(f"jacobi_eigh takes complex64, got {H.dtype}")
    B = math.prod(batch_shape)
    Hb = H.reshape(B, n, n)
    Hb = (0.5 * (Hb + Hb.mH)).contiguous()
    if B == 0:
        w, V = Hb.real.new_empty((0, n)), torch.empty_like(Hb)
    elif Hb.device.type == "cpu":
        w, V = _jacobi_eigh_plain(Hb, sweeps, relative)
    else:  # the kernel, which raises on a tensor off a CUDA device
        w, V = _jacobi_eigh_cuda(Hb, sweeps, relative)
    w, V = eigh_from_rounds(Hb, w, V, refine)
    return w.reshape(batch_shape + (n,)), V.reshape(batch_shape + (n, n))


jacobi_eigh.launches = 0
jacobi_eigh.launches_by_shape = {}  # (B, n) -> launches
jacobi_eigh.launches_by_layout = {"resident": 0, "ring": 0, "l2": 0}  # past n = 128
jacobi_eigh.rotations = None  # the last call past n = 128: rotations taken, a device scalar


def eigh_from_rounds(Hb: torch.Tensor, w: torch.Tensor, V: torch.Tensor, refine: bool = True):
    """Refine (optionally) and sort the rotation rounds' result for the
    hermitian Hb [B, n, n]: (w [B, n] ascending, V [B, n, n])."""
    B, n, _ = Hb.shape
    if refine:
        for _ in range(2):
            V = 0.5 * (3.0 * V - V @ (V.mH @ V))
        w = torch.sum(V.conj() * (Hb @ V), dim=1).real
    order = torch.argsort(w, dim=1, stable=True)
    return torch.gather(w, 1, order), torch.gather(V, 2, order[:, None, :].expand(B, n, n))
