"""Batched one-sided Jacobi SVD and the preconditioned `pjsvd`.

Port of `tnqs/ops/osj.py::osj_svd` (`:225`) and `pjsvd` (`:349`).  The
rotation rounds of `osj_svd` run in the CUDA kernel
`tnqs_torch/csrc/osj_svd.cu` on a CUDA tensor (one thread-block cluster per
matrix: up to n = 128 A and V resident in its CTAs' shared memory,
`osj_plan` its layout; past it, or past the rows a cluster holds, A alone
in the rounds, resident in a cluster of 2, 4, 8 or 16 where its chunks fit,
else in device memory kept hot in L2, `osj_log_plan`, and V from the
rounds' rotation log, `rotation_log.apply_rotation_log`), and in
`_osj_svd_plain`, the same schedule written in PyTorch, on a CPU tensor.
The Frobenius prescale, the column norms, the descending sort and U = A/s
(`tnqs/ops/osj.py:245-345`) are PyTorch in both cases.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, rotation_log
from .jacobi import (EPS32, L2_CLUSTERS, RES_CLUSTERS, SMEM_LIMIT, L2Plan, LogPlan, eigh_l2_smem, jacobi_eigh, l2_plan,
                     log_chunks, resident_choice, round_robin)
from .rotation_log import apply_rotation_log


def _rot_params_rel(a, b, gr, gi, eps: float):
    """Complex Jacobi rotation for the 2x2 Gram [[a, g], [conj(g), b]] with
    the relative Hestenes skip |g|^2 <= eps^2 a b (`tnqs/ops/osj.py:117`).
    Inputs [B, m] float32; returns (c, s) for J = [[c, -conj(s)], [s, c]],
    and whether each rotation is taken."""
    g2 = gr * gr + gi * gi
    safe = g2 > (eps * eps) * (a * b)
    absg = torch.sqrt(torch.where(safe, g2, 1.0))
    phr = torch.where(safe, gr / absg, 1.0)
    phi = torch.where(safe, gi / absg, 0.0)
    tau = (b - a) / (2.0 * torch.where(safe, absg, 1.0))
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)
    t = -sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    sm = t * c
    c = torch.where(safe, c, 1.0)
    s = torch.complex(torch.where(safe, sm * phr, 0.0), torch.where(safe, -sm * phi, 0.0))
    return c, s, safe


def _osj_svd_plain(A: torch.Tensor, V: torch.Tensor, sweeps: int):
    """The kernel's rounds in PyTorch: pair i is (column i, column m+i),
    as in the JAX kernel body (`_make_osj_kernel`, `tnqs/ops/osj.py:141`),
    and the columns move between rounds.  A [B, R, n], V [B, n, n]
    complex64.  Returns the rotated (A, V); the count of rotations taken
    (not skipped), a device scalar, stays in `_osj_svd_plain.rotations`."""
    _osj_svd_plain.calls += 1
    R, n = A.shape[-2], A.shape[-1]
    m = n // 2
    perm = round_robin(n, A.device)
    X = torch.cat([A, V], 1)  # columns of A and V rotate together
    taken = torch.zeros((), dtype=torch.int64, device=A.device)
    for _ in range(sweeps * (n - 1)):
        sq = torch.sum(A.real * A.real + A.imag * A.imag, dim=1)
        g = torch.sum(A[:, :, :m].conj() * A[:, :, m:], dim=1)
        c, s, live = _rot_params_rel(sq[:, :m], sq[:, m:], g.real, g.imag, EPS32)
        taken += live.sum()
        c, s = c[:, None, :], s[:, None, :]
        # [l', r'] = [l, r] @ [[c, -conj(s)], [s, c]]
        lft, rgt = X[:, :, :m], X[:, :, m:]
        X = torch.cat([c * lft + s * rgt, -s.conj() * lft + c * rgt], 2)[:, :, perm]
        A = X[:, :R]
    _osj_svd_plain.rotations = taken
    return A, X[:, R:]


_osj_svd_plain.calls = 0
_osj_svd_plain.rotations = None


CLUSTERS = (1, 2, 4, 8)  # cluster sizes the cluster kernel is launched with
CHUNK = 32  # rows of A or V a warp sums over: the unit the kernel splits rows by
NARROW_N = 128  # the widest A the cluster kernel holds beside V; past it A alone, V from the log


def osj_plan(R: int, n: int, C: int):
    """The kernel's layout for A [R, n] on a cluster of C CTAs: (chunks of 32
    rows of A per CTA, chunks of V's n rows per CTA, shared bytes per CTA).
    The sum is the one `smem_bytes` in `tnqs_torch/csrc/osj_svd.cu` takes:
    A and V column-major with an odd pitch, two rounds of every chunk's Gram
    partials (4 floats a pair for each 8-pair group), the m rotations, two
    rounds' index at each position, and two mbarriers."""
    nch, vch = -(-R // CHUNK), -(-n // CHUNK)
    cpc, vpc = -(-nch // C), -(-vch // C)
    groups = -(-(n // 2) // 8)
    smem = 8 * n * (cpc * CHUNK + 1 + vpc * CHUNK + 1) + 8 * nch * groups * 32 + 16 * (n // 2) + 8 * n + 16
    return cpc, vpc, smem


def _fitting_clusters(R: int, n: int) -> list[int]:
    """The cluster sizes the shared-memory layout (the cluster kernel, A
    and V) takes A [R, n] on: up to n = `NARROW_N`, the sizes whose CTAs
    each hold at least one chunk of A and fit their share in shared memory;
    empty past its shapes."""
    if n % 2 or not 4 <= n <= NARROW_N or R < n:
        return []
    nch = -(-R // CHUNK)
    return [C for C in CLUSTERS if (C - 1) * osj_plan(R, n, C)[0] < nch and osj_plan(R, n, C)[2] <= SMEM_LIMIT]


def osj_l2_smem(n: int) -> int:
    """The L2 variant's shared bytes a CTA (`l2_smem_bytes` in
    `tnqs_torch/csrc/osj_svd.cu`): the m rotations and two rounds' index at
    each position, whatever R."""
    return 16 * (n // 2) + 8 * n


def osj_l2(R: int, n: int) -> bool:
    """Whether the wrapper takes A [R, n] past the shared-memory layout (the
    resident or L2 variant, `osj_log_plan`): an even n >= 4, R >= n, that
    the layout does not hold (n > 128, or more rows than its clusters hold),
    up to the widths whose m rotations and index table fit a CTA of the L2
    variant (n = 14,528; V's kernel, `rotation_log.fits`, takes wider)."""
    return (n % 2 == 0 and 4 <= n <= R and not _fitting_clusters(R, n) and rotation_log.fits(n)
            and osj_l2_smem(n) <= SMEM_LIMIT
            and n * CHUNK * -(-R // CHUNK) < 2**31)  # the L2 variant's offsets are int


def pjsvd_fits(R: int, n: int) -> bool:
    """Whether `pjsvd` takes A [R, n] (R >= n) through its kernels: K2 on
    the Gram [n, n] and K1 on [R, n] (`osj_fits`), which together take every
    even n >= 4 with R >= n up to n = 14,528 (`osj_l2`).  Decided from the shape alone, before any launch, and
    never raises, so a caller routes every other shape elsewhere on every
    device."""
    return bool(_fitting_clusters(R, n)) or (osj_l2(R, n) and eigh_l2_smem(n) <= SMEM_LIMIT)


def osj_fits(R: int, n: int) -> list[int]:
    """The cluster sizes the kernel takes A [R, n] on: the shared-memory
    layout's (`_fitting_clusters`), else those of the L2 variant past it
    (`L2_CLUSTERS`, `osj_l2`; the resident variant's are `osj_res_sizes`),
    or ValueError for a shape none takes (odd n, n < 4, R < n, or n past
    14,528)."""
    fits = _fitting_clusters(R, n)
    if fits:
        return fits
    if osj_l2(R, n):
        return list(L2_CLUSTERS)
    raise ValueError(f"osj_svd kernel takes even n >= 4 and n <= R, with the L2 variant's rotations within "
                     f"{SMEM_LIMIT} shared bytes a CTA, got [{R}, {n}]")


def osj_l2_plan(B: int, R: int, n: int, active) -> tuple[L2Plan, int]:
    """The L2 variant's launch for B matrices [R, n] (`jacobi.l2_plan`, with
    `active(C)` the clusters of C the card holds), and the chunks of 32 rows
    of A (nch): A column-major, its rows padded to whole chunks, 8 n 32 nch
    bytes a matrix; each cluster's exchange buffer two rounds of a float4 a
    pair from each of its CTAs (16 n L2_CLUSTERS[0] bytes, sized for the
    larger cluster)."""
    nch = -(-R // CHUNK)
    return l2_plan(B, 8 * n * CHUNK * nch, 16 * n * L2_CLUSTERS[0], osj_l2_smem(n), active), nch


def osj_res_smem(n: int, cpc: int, C: int) -> int:
    """The resident variant's shared bytes a CTA (`res_smem_bytes` in
    `tnqs_torch/csrc/osj_svd.cu`): cpc chunks of A column-major with an odd
    pitch, two rounds of the owner's partials (C CTAs' float4 for each of
    its pmax pairs), two rounds of the m rotations, two rounds' index at
    each position, four mbarriers."""
    return 8 * n * (cpc * CHUNK + 1) + 32 * C * -(-(n // 2) // C) + 32 * (n // 2) + 8 * n + 32


def osj_res_sizes(R: int, n: int) -> dict[int, tuple[int, int]]:
    """The resident variant's cluster sizes for A [R, n]: C -> (chunks of
    A a CTA at most, shared bytes a CTA), those of `RES_CLUSTERS` within a
    CTA's shared memory ([384, 192] on 4 and up, [512, 256] on 8 and 16,
    [512, 512] and [640, 320] on 16; not [1024, 512])."""
    nch = -(-R // CHUNK)
    sizes = {}
    for C in RES_CLUSTERS:
        cpc = -(-nch // C)
        smem = osj_res_smem(n, cpc, C)
        if (n // 2) // C >= 1 and smem <= SMEM_LIMIT:
            sizes[C] = (cpc, smem)
    return sizes


def osj_log_plan(B: int, R: int, n: int, rounds: int, active) -> tuple[LogPlan, int, int]:
    """K1's launch past the shared-memory layout for B matrices [R, n] and
    `rounds` rounds: the resident variant where A's chunks fit a cluster the
    card holds (`osj_res_sizes`, `jacobi.resident_choice`), else the L2
    variant (`osj_l2_plan`); `active(layout, C, cpc)` the clusters of C the
    card holds at once; the resident variant only where one matrix's log
    fits `LOG_BUDGET`, the L2 variant in chunks of rounds where it must
    (`jacobi.log_chunks`).  Returns (plan, chunks of A, chunks of A a CTA at
    most)."""
    if not osj_l2(R, n):
        raise ValueError(f"osj_svd: [{R}, {n}] takes the shared-memory layout or no kernel")
    nch = -(-R // CHUNK)
    group, chunk = log_chunks(B, n, rounds)
    log = group * 8 * n * chunk
    sizes = osj_res_sizes(R, n) if chunk >= rounds else {}
    best = resident_choice(B, list(sizes), lambda C: active("resident", C, sizes[C][0]))
    if best is not None:
        C, held, waves = best
        return LogPlan("resident", C, held, waves, group, chunk, log, sizes[C][1]), nch, sizes[C][0]
    p, _ = osj_l2_plan(group, R, n, lambda C: active("l2", C, 0))
    return LogPlan("l2", p.cluster, p.clusters, -(-B // p.clusters), group, chunk, log + p.scratch, p.smem), nch, 0


@functools.cache
def l2_active_clusters(device: torch.device, n: int, C: int) -> int:
    """How many clusters of C CTAs of the L2 variant at width n the card
    holds at once (`cudaOccupancyMaxActiveClusters`)."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.kernels().tnqs_osj_svd_l2_clusters(n, C, ctypes.byref(active)),
                     "tnqs_osj_svd_l2_clusters")
    return active.value


@functools.cache
def res_active_clusters(device: torch.device, n: int, cpc: int, C: int) -> int:
    """How many clusters of C CTAs of the resident variant at width n, cpc
    chunks of A a CTA, the card holds at once (`cudaOccupancyMaxActiveClusters`)."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.kernels().tnqs_osj_svd_res_clusters(n, cpc, C, ctypes.byref(active)),
                     "tnqs_osj_svd_res_clusters")
    return active.value


def log_active_clusters(device: torch.device, n: int, cluster: int | None = None):
    """`osj_log_plan`'s `active(layout, C, cpc)` on this device (0 for every
    C but `cluster` when one is given)."""
    def active(layout, C, cpc):
        if cluster not in (None, C):
            return 0
        return res_active_clusters(device, n, cpc, C) if layout == "resident" else l2_active_clusters(device, n, C)
    return active


def osj_cluster(B: int, R: int, n: int, active) -> int:
    """The cluster size of the shared-memory layout for a batch of B
    matrices [R, n]: the largest that fits and of which the card holds B
    clusters at once (`active(C, smem)`, `cudaOccupancyMaxActiveClusters`),
    else the smallest that fits.  Raises ValueError past the kernel's shapes
    and RuntimeError when the card holds no cluster at all."""
    fits = _fitting_clusters(R, n)
    if not fits:
        osj_fits(R, n)  # ValueError past every shape the kernels take
        raise ValueError(f"osj_svd kernel: [{R}, {n}] takes the L2 variant (`osj_l2_plan`), not the shared-memory "
                         f"layout")
    for C in reversed(fits):
        if B <= active(C, osj_plan(R, n, C)[2]):
            return C
    C = fits[0]
    if active(C, osj_plan(R, n, C)[2]) == 0:
        raise RuntimeError(f"osj_svd kernel: no cluster of {C} CTAs for [{R}, {n}] fits on the card")
    return C


@functools.cache
def active_clusters(device: torch.device, C: int, smem: int) -> int:
    """How many clusters of C CTAs with `smem` shared bytes each the card
    holds at once (`cudaOccupancyMaxActiveClusters`)."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.kernels().tnqs_osj_svd_clusters(C, smem, ctypes.byref(active)),
                     "tnqs_osj_svd_clusters")
    return active.value


def _osj_svd_past_cluster(A: torch.Tensor, V: torch.Tensor, sweeps: int, cluster: int | None):
    """K1 past the shared-memory layout (`osj_log_plan`, or `cluster` CTAs):
    the rounds on A alone, resident (`tnqs_osj_svd_res`) or in L2
    (`tnqs_osj_svd_l2`, in place on a column-major copy of A, `plan.chunk`
    rounds a launch), a group of matrices a launch, V from V0 and each
    launch's rotation log.  Returns the rotated (A, V), row-major."""
    B, R, n = A.shape
    lib = _build.kernels()
    rounds = sweeps * (n - 1)
    plan, nch, cpc = osj_log_plan(B, R, n, rounds, log_active_clusters(A.device, n, cluster))
    A, V = A.contiguous(), V.contiguous()
    A_out, V_out = torch.empty_like(A), torch.empty_like(V)
    logs = torch.empty(plan.group * plan.chunk * (n // 2) * 4, dtype=torch.float32, device=A.device)
    osj_svd.rotations = torch.zeros((), dtype=torch.int64, device=A.device)
    taken = osj_svd.rotations.data_ptr()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        for g0 in range(0, B, plan.group):
            b = min(plan.group, B - g0)
            log = logs[:b * plan.chunk * (n // 2) * 4].view(b, plan.chunk, n // 2, 4)
            if plan.layout == "resident":
                def launch(started=None, progress=None, stage=1):
                    err = lib.tnqs_osj_svd_res(A[g0].data_ptr(), A_out[g0].data_ptr(), log.data_ptr(), taken,
                                               None if started is None else started.data_ptr(),
                                               None if progress is None else progress.data_ptr(), stage, b, R, n,
                                               nch, cpc, rounds, EPS32, plan.cluster, stream)
                    _build.check(err, "tnqs_osj_svd_res")
                if rotation_log.follows(b, plan.cluster, plan.clusters, A.device):
                    # V's kernel beside the rounds, on the SMs their one or last wave leaves
                    with rotation_log.follow(log, V[g0:g0 + b], V_out[g0:g0 + b], plan.cluster,
                                             plan.clusters) as flags:
                        launch(*flags)
                else:
                    launch()
                    apply_rotation_log(log, V[g0:g0 + b], out=V_out[g0:g0 + b])
                _count_launch(B, R, n, plan.layout)
            else:
                x = torch.zeros((b, n, CHUNK * nch), dtype=A.dtype, device=A.device)
                x[:, :, :R] = A[g0:g0 + b].mT
                part = torch.empty((plan.clusters, 2, plan.cluster, n // 2, 4), dtype=torch.float32, device=A.device)
                for r0 in range(0, max(rounds, 1), plan.chunk):  # one launch at least: V = V0 at 0 rounds
                    k = min(plan.chunk, rounds - r0)
                    log = logs[:b * k * (n // 2) * 4].view(b, k, n // 2, 4)
                    err = lib.tnqs_osj_svd_l2(x.data_ptr(), log.data_ptr(), part.data_ptr(), taken, b, n, nch, r0, k,
                                              EPS32, plan.cluster, plan.clusters, stream)
                    _build.check(err, "tnqs_osj_svd_l2")
                    _count_launch(B, R, n, plan.layout)
                    apply_rotation_log(log, V[g0:g0 + b] if r0 == 0 else V_out[g0:g0 + b], out=V_out[g0:g0 + b],
                                       round0=r0)
                A_out[g0:g0 + b] = x[:, :, :R].mT
    return A_out, V_out


def _count_launch(B: int, R: int, n: int, layout: str):
    osj_svd.launches += 1
    osj_svd.launches_by_shape[(B, R, n)] = osj_svd.launches_by_shape.get((B, R, n), 0) + 1
    osj_svd.launches_by_layout[layout] += 1


def _osj_svd_cuda(A: torch.Tensor, V: torch.Tensor, sweeps: int, cluster: int | None = None):
    """Launch `tnqs_osj_svd` on A [B, R, n] and V [B, n, n] complex64 CUDA
    tensors, one cluster per matrix (`cluster` CTAs, or as `osj_cluster`
    picks), which reads both row-major and writes the rotated (A, V) into
    new row-major tensors; or, where `osj_l2` holds, the resident or L2
    variant and the rotation log (`_osj_svd_past_cluster`)."""
    B, R, n = A.shape
    if V.shape != (B, n, n):
        raise ValueError(f"osj_svd kernel: bad shapes A {tuple(A.shape)}, V {tuple(V.shape)}")
    if cluster not in osj_fits(R, n) + [None] and cluster not in osj_res_sizes(R, n):
        raise ValueError(f"osj_svd kernel: a cluster of {cluster} does not fit [{R}, {n}]")
    if not (A.is_cuda and V.device == A.device and A.dtype == V.dtype == torch.complex64):
        raise ValueError("osj_svd kernel takes complex64 CUDA tensors on one device")
    if osj_l2(R, n):
        return _osj_svd_past_cluster(A, V, sweeps, cluster)
    lib = _build.kernels()
    if cluster is None:
        cluster = osj_cluster(B, R, n, lambda C, smem: active_clusters(A.device, C, smem))
    cpc, vpc, smem = osj_plan(R, n, cluster)
    A, V = A.contiguous(), V.contiguous()
    A_out, V_out = torch.empty_like(A), torch.empty_like(V)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tnqs_osj_svd(A.data_ptr(), V.data_ptr(), A_out.data_ptr(), V_out.data_ptr(), B, R, n,
                               sweeps * (n - 1), EPS32, cluster, cpc, vpc, smem, stream)
    _build.check(err, "tnqs_osj_svd")
    osj_svd.launches += 1
    osj_svd.launches_by_shape[(B, R, n)] = osj_svd.launches_by_shape.get((B, R, n), 0) + 1
    return A_out, V_out


def osj_svd(A: torch.Tensor, V0: torch.Tensor | None = None, sweeps: int = 10):
    """Thin SVD of batched A [..., R, n] (R >= n, n even, complex64) by
    one-sided Jacobi.  Returns (U [..., R, n], s [..., n] descending,
    Vh [..., n, n]) — the `torch.linalg.svd(full_matrices=False)` contract.

    `V0` warm-starts the rotation accumulator: pass an orthonormal
    approximate right-singular basis and A @ V0 as `A`, and the sweeps only
    polish (see `pjsvd`).  Null singular directions return zero U columns,
    which the engine's truncation multiplies by a masked sqrt(s) = 0."""
    batch_shape = A.shape[:-2]
    R, n = A.shape[-2], A.shape[-1]
    if R < n or n % 2 != 0:
        raise ValueError("osj_svd requires tall/square batched matrices with even column count")
    if A.dtype != torch.complex64:
        raise TypeError(f"osj_svd takes complex64, got {A.dtype}")
    B = math.prod(batch_shape)
    Ab, scale = prescale(A.reshape(B, R, n))
    if V0 is None:
        Vb = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)
    else:
        Vb = V0.reshape(B, n, n)
    if B == 0:
        Ur, Vr = Ab, Vb
    elif Ab.device.type == "cpu":
        Ur, Vr = _osj_svd_plain(Ab, Vb, sweeps)
    else:  # the kernel, which raises on a tensor off a CUDA device
        Ur, Vr = _osj_svd_cuda(Ab, Vb, sweeps)
    U, s, Vh = svd_from_rounds(Ur, Vr, scale)
    return (
        U.reshape(batch_shape + (R, n)),
        s.reshape(batch_shape + (n,)),
        Vh.reshape(batch_shape + (n, n)),
    )


osj_svd.launches = 0
osj_svd.launches_by_shape = {}  # (B, R, n) -> launches
osj_svd.launches_by_layout = {"resident": 0, "l2": 0}  # past the shared-memory layout
osj_svd.rotations = None  # the last call past the shared-memory layout: rotations taken, a device scalar


def prescale(Ab: torch.Tensor):
    """Ab [B, R, n] scaled to unit Frobenius norm per matrix, and the scale
    [B, 1, 1]: the rotation threshold and the norm extraction then work
    mid-range in float32."""
    scale = torch.sqrt(torch.sum(Ab.real * Ab.real + Ab.imag * Ab.imag, dim=(1, 2), keepdim=True))
    scale = torch.where(scale > 0, scale, 1.0)
    return Ab / scale, scale


def svd_from_rounds(Ur: torch.Tensor, Vr: torch.Tensor, scale: torch.Tensor):
    """(U, s descending, Vh) from the rotated iterate Ur [B, R, n] and
    accumulator Vr [B, n, n]: s = column norms (times the prescale), U =
    columns / s, with zero columns below 4 eps s_max."""
    B, R, n = Ur.shape
    s = torch.sqrt(torch.sum(Ur.real * Ur.real + Ur.imag * Ur.imag, dim=1))
    order = torch.argsort(-s, dim=1, stable=True)
    s = torch.gather(s, 1, order)
    Ur = torch.gather(Ur, 2, order[:, None, :].expand(B, R, n))
    Vr = torch.gather(Vr, 2, order[:, None, :].expand(B, n, n))
    inv = torch.where(s > (EPS32 * 4.0) * s[:, :1], 1.0 / torch.where(s > 0, s, 1.0), 0.0)
    return Ur * inv[:, None, :], s * scale.reshape(B, 1), Vr.mH.resolve_conj()


def pjsvd(A: torch.Tensor, precond_sweeps: int = 8, polish_sweeps: int = 4):
    """Preconditioned one-sided Jacobi SVD of batched A [..., R, n] (R >= n,
    n even, complex64), `tnqs/ops/osj.py:349`:

      1. G = A^H A;
      2. V0 = eigenbasis of G by `jacobi_eigh` (few sweeps, Newton–Schulz
         orthonormalized);
      3. B0 = A @ V0, from the original A;
      4. one-sided Jacobi polish of (B0, V0) by `osj_svd`.

    The Gram squaring only picks the preconditioner basis; every output is
    computed from unsquared columns of A @ (unitary), so errors stay graded
    like LAPACK's gesdd."""
    G = A.mH @ A
    _, V0 = jacobi_eigh(G, sweeps=precond_sweeps, relative=False)
    # literal NaNs from the preconditioner (two-sided Jacobi on rank-deficient
    # spectra) cannot be rotated away: those matrices restart cold
    finite = torch.isfinite(V0)
    ok = finite.all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    eye = torch.eye(A.shape[-1], dtype=V0.dtype, device=V0.device)
    V0 = torch.where(ok, V0.masked_fill(~finite, 0), eye)
    return osj_svd(A @ V0, V0, sweeps=polish_sweeps)
