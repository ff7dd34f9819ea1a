"""Batched Hermitian eigensolver by two-sided parallel Jacobi.

Port of `tnqs/ops/jacobi.py::jacobi_eigh` (`tnqs/ops/jacobi.py:208`).  The
rotation rounds run in the CUDA kernel `tnqs_torch/csrc/jacobi_eigh.cu` on a
CUDA tensor (up to n = 128 a cluster of three CTAs per matrix, H resident in
one CTA's shared memory and V in the other two's; for 128 < n <= 256 a
cluster of 4 or 8, each CTA holding the columns of H and V at its pair
positions, `eigh_wide_plan`), and in `_jacobi_eigh_plain`, the same schedule
written in PyTorch, on a CPU tensor.  The Newton–Schulz
repair of V, the Rayleigh eigenvalues and the ascending sort
(`tnqs/ops/jacobi.py:300-318`) are PyTorch in both cases.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

EPS32 = float(torch.finfo(torch.float32).eps)
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA of an H100 may use
WIDE_CLUSTERS = (4, 8)  # cluster sizes of the wide variant, 128 < n <= 256


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


def eigh_wide_plan(n: int):
    """The wide variant's layout for 128 < n <= 256: (cluster size C, pair
    positions of each CTA, shared bytes a CTA).  CTA k owns the positions
    [k m / C, (k+1) m / C) of the m = n/2 pairs; C is the smaller of
    `WIDE_CLUSTERS` whose CTAs each own at least 2 pairs and fit their
    columns.  The sum is `wide_smem_bytes` in `tnqs_torch/csrc/
    jacobi_eigh.cu`: the rotations of two rounds, four mbarriers, 2 pmax + 3
    column slots of H and of V (two rings of pmax + 1, and position 0), the
    row index at each position and the pairs' slots.  ValueError past the
    variant's shapes."""
    m = n // 2
    if n % 2 or not 128 < n <= 256:
        raise ValueError(f"the wide jacobi_eigh kernel takes even 128 < n <= 256, got {n}")
    for C in WIDE_CLUSTERS:
        pmax = -(-m // C)
        smem = 16 * n + 32 + 16 * (2 * pmax + 3) * n + 4 * n + 8 * pmax
        if m // C >= 2 and smem <= SMEM_LIMIT:
            return C, [(k + 1) * m // C - k * m // C for k in range(C)], smem
    raise ValueError(f"no cluster of {WIDE_CLUSTERS} holds n={n}")


def _jacobi_eigh_cuda(H: torch.Tensor, sweeps: int, relative: bool = True):
    """Launch `tnqs_jacobi_eigh` (n <= 128, one cluster of three CTAs per
    matrix) or `tnqs_jacobi_eigh_wide` (128 < n <= 256, `eigh_wide_plan`)
    on H [B, n, n] hermitian complex64 (CUDA, contiguous).  Returns
    (w [B, n] unsorted, V [B, n, n])."""
    if H.dim() != 3 or H.shape[1] != H.shape[2] or H.shape[1] % 2 or not 4 <= H.shape[1] <= 256:
        raise ValueError(f"jacobi_eigh kernel takes [B, n, n] with even 4 <= n <= 256, got {tuple(H.shape)}")
    if not (H.is_cuda and H.dtype == torch.complex64 and H.is_contiguous()):
        raise ValueError("jacobi_eigh kernel takes a contiguous complex64 CUDA tensor [B, n, n]")
    B, n, _ = H.shape
    lib = _build.kernels()
    if active_clusters(H.device, n) == 0:
        raise RuntimeError(f"jacobi_eigh kernel: no cluster for n={n} fits on {H.device}")
    vt = torch.empty_like(H)
    w = torch.empty((B, n), dtype=torch.float32, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        if n <= 128:
            err = lib.tnqs_jacobi_eigh(H.data_ptr(), vt.data_ptr(), w.data_ptr(), B, n, sweeps * (n - 1), EPS32,
                                       int(relative), stream)
        else:
            err = lib.tnqs_jacobi_eigh_wide(H.data_ptr(), vt.data_ptr(), w.data_ptr(), B, n, sweeps * (n - 1),
                                            EPS32, int(relative), eigh_wide_plan(n)[0], stream)
    _build.check(err, "tnqs_jacobi_eigh" if n <= 128 else "tnqs_jacobi_eigh_wide")
    jacobi_eigh.launches += 1
    jacobi_eigh.launches_by_shape[(B, n)] = jacobi_eigh.launches_by_shape.get((B, n), 0) + 1
    return w, vt.mT


@functools.cache
def active_clusters(device: torch.device, n: int) -> int:
    """How many of the kernel's clusters for size n (three CTAs up to
    n = 128, `eigh_wide_plan`'s past it) the card holds at once
    (`cudaOccupancyMaxActiveClusters`)."""
    active = ctypes.c_int(0)
    lib = _build.kernels()
    with torch.cuda.device(device):
        if n <= 128:
            _build.check(lib.tnqs_jacobi_eigh_clusters(n, ctypes.byref(active)), "tnqs_jacobi_eigh_clusters")
        else:
            _build.check(lib.tnqs_jacobi_eigh_wide_clusters(n, eigh_wide_plan(n)[0], ctypes.byref(active)),
                         "tnqs_jacobi_eigh_wide_clusters")
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
