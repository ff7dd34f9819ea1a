"""V from a log of Jacobi rotations.

Past the widths their clusters hold, K1 (`osj.osj_svd`) and K2
(`jacobi.jacobi_eigh`) keep V out of their rounds: each round appends its
m = n/2 rotations to a log, [B, rounds, m, 4] float32 (c, Re s, Im s, and a
meta word whose int32 bits are p << 16 | q << 1 | taken, p and q the pair's
column indices), and `apply_rotation_log` then rotates V0's columns by the
logged rounds in order: the CUDA kernel `tnqs_torch/csrc/rotation_log.cu`
on a CUDA tensor (one CTA per slab of rows, the log streamed in by bulk
copies), `_apply_rotation_log_plain` on a CPU tensor.  Where the iterate's
clusters leave SMs idle, `follow` runs the kernel beside the iterate on a
second stream as the log grows (`rotation_log.cu`).  V0 may be `out`: an
iterate run in chunks of rounds applies each chunk's log to V in place.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from . import _build
from ._build import SMEM_LIMIT

STAGE_BYTES = 16_384  # the log a stage of the kernel aims to hold
STAGES = 2  # stages of the log in flight
SLAB_ROWS = (16, 8, 4, 2, 1)  # rows of V a CTA, the first that fits


def smem_bytes(n: int, S: int, E: int) -> int:
    """The kernel's shared bytes a CTA (`smem_bytes` in
    `tnqs_torch/csrc/rotation_log.cu`): `STAGES` stages of E entries of the
    log, the slab of S rows of V, the stages' mbarriers."""
    return 16 * STAGES * E + 8 * S * n + 8 * STAGES


def plan(n: int) -> tuple[int, int, int]:
    """The kernel's layout for V [n, n]: (rows a CTA S, a half-warp each,
    log entries a stage E, shared bytes a CTA).  Whole rounds a stage where
    one round fits beside a row (about `STAGE_BYTES` of log, K rounds,
    E = K n/2, with the most rows that fit); past that (n > 9684) one row
    and the part of a round that fits.  ValueError where not even a row and
    16 entries fit (n > 28990)."""
    if n % 2 or n < 4 or n // 2 > 0x7FFF:
        raise ValueError(f"the rotation log takes even 4 <= n <= 65534, got {n}")
    m = n // 2
    for K in dict.fromkeys((max(1, STAGE_BYTES // (8 * n)), 1)):
        for S in SLAB_ROWS:
            if smem_bytes(n, S, K * m) <= SMEM_LIMIT:
                return S, K * m, smem_bytes(n, S, K * m)
    E = (SMEM_LIMIT - smem_bytes(n, 1, 0)) // (16 * STAGES)
    if E >= 16:
        return 1, E, smem_bytes(n, 1, E)
    raise ValueError(f"the rotation log kernel holds no row of V [{n}, {n}] in {SMEM_LIMIT} shared bytes")


def fits(n: int) -> bool:
    """Whether `plan` takes V [n, n]: even 4 <= n <= 28990."""
    try:
        plan(n)
    except ValueError:
        return False
    return True


def meta(p: torch.Tensor, q: torch.Tensor, taken: torch.Tensor) -> torch.Tensor:
    """The log's meta word of pairs (p, q), as float32 holding the int32
    bits p << 16 | q << 1 | taken, as the kernels write it."""
    return ((p.to(torch.int32) << 16) | (q.to(torch.int32) << 1) | taken.to(torch.int32)).view(torch.float32)


def unpack(log: torch.Tensor):
    """(p, q, taken) of every entry of a log [..., 4]."""
    bits = log[..., 3].contiguous().view(torch.int32)
    return bits >> 16, (bits >> 1) & 0x7FFF, (bits & 1).bool()


def _apply_rotation_log_plain(log: torch.Tensor, V0: torch.Tensor | None = None) -> torch.Tensor:
    """The logged rounds on V0 [B, rows, n] (the identity [B, n, n] when
    None; any rows of V, since column rotations never mix rows) in PyTorch,
    in the plain Jacobi versions' arithmetic: left' = c left + s right,
    right' = -conj(s) left + c right on the taken pairs' columns.  Returns V
    [B, rows, n]."""
    _apply_rotation_log_plain.calls += 1
    B, rounds, m, _ = log.shape
    n = 2 * m
    V = torch.eye(n, dtype=torch.complex64, device=log.device).expand(B, n, n) if V0 is None else V0
    V = V.clone()
    rows = V.shape[1]
    p, q, taken = unpack(log)
    for r in range(rounds):
        t = taken[:, r]
        if not t.any():
            continue
        c = log[:, r, None, :, 0]
        s = torch.complex(log[:, r, None, :, 1], log[:, r, None, :, 2])
        pi, qi = (x[:, r, None, :].long().expand(B, rows, m) for x in (p, q))
        lft, rgt = torch.gather(V, 2, pi), torch.gather(V, 2, qi)
        tt = t[:, None, :]
        new_l = torch.where(tt, c * lft + s * rgt, lft)
        new_r = torch.where(tt, -s.conj() * lft + c * rgt, rgt)
        V = V.scatter(2, pi, new_l).scatter(2, qi, new_r)
    return V


_apply_rotation_log_plain.calls = 0


def _apply_rotation_log_cuda(log: torch.Tensor, V0: torch.Tensor | None, out: torch.Tensor | None,
                             flags: tuple | None = None, mode: int = 0) -> torch.Tensor:
    """Launch `tnqs_rotation_log` (`plan`'s slabs and stages) into `out`, or
    a new V [B, n, n]; `flags` (started, progress, claim, cluster) and
    `mode` (1 follow, 2 rest) for a launch beside the iterate (`follow`)."""
    B, rounds, m, four = log.shape
    n = 2 * m
    if four != 4 or log.dtype != torch.float32 or not (log.is_cuda and log.is_contiguous()):
        raise ValueError(f"rotation log kernel takes a contiguous float32 CUDA log [B, rounds, m, 4], got "
                         f"{tuple(log.shape)} {log.dtype} on {log.device}")
    if V0 is not None:
        if V0.shape != (B, n, n) or V0.dtype != torch.complex64 or V0.device != log.device:
            raise ValueError(f"rotation log kernel: V0 {tuple(V0.shape)} {V0.dtype} does not match the log")
        V0 = V0.contiguous()
    if out is None:
        out = torch.empty((B, n, n), dtype=torch.complex64, device=log.device)
    elif out.shape != (B, n, n) or out.dtype != torch.complex64 or out.device != log.device or not out.is_contiguous():
        raise ValueError("rotation log kernel: out must be a contiguous complex64 [B, n, n] on the log's device")
    S, E, _ = plan(n)
    started, progress, claim, cluster = flags if flags is not None else (None, None, None, 0)
    ptr = [None if t is None else t.data_ptr() for t in (started, progress, claim)]
    with torch.cuda.device(log.device):
        err = _build.kernels().tnqs_rotation_log(None if V0 is None else V0.data_ptr(), log.data_ptr(),
                                                 out.data_ptr(), B, n, rounds, S, E, *ptr, cluster, mode,
                                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tnqs_rotation_log")
    apply_rotation_log.launches += 1
    return out


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def follows(B: int, cluster: int, waves: int, device: torch.device) -> bool:
    """Whether V's kernel runs beside an iterate launch of B clusters of
    `cluster` CTAs: all of them at once (one wave), SMs left idle."""
    return waves == 1 and B * cluster < torch.cuda.get_device_properties(device).multi_processor_count


@contextlib.contextmanager
def follow(log: torch.Tensor, V0: torch.Tensor | None, out: torch.Tensor, cluster: int):
    """V from the log of an iterate kernel launched inside the block (on the
    current stream, given `started` and `progress` and `stage` from the
    yielded (started, progress, stage); it publishes its progress every
    `stage` rounds, a stage of V's kernel): the V kernel follows the log on
    a second stream, then takes what it left on the current one, and the
    current stream waits for both."""
    B, rounds, m, _ = log.shape
    S, E, _ = plan(2 * m)
    slabs = -(-2 * m // S)
    flags = torch.zeros(B + B * cluster + B * slabs, dtype=torch.int32, device=log.device)
    started, progress, claim = flags[:B], flags[B:B + B * cluster], flags[B + B * cluster:]
    cur, side = torch.cuda.current_stream(log.device), _side_stream(log.device)
    side.wait_stream(cur)  # the log, flags, V0 and out are ready
    yield started, progress, max(1, E // m)
    with torch.cuda.stream(side):
        _apply_rotation_log_cuda(log, V0, out, (started, progress, claim, cluster), 1)
    _apply_rotation_log_cuda(log, V0, out, (started, progress, claim, cluster), 2)
    cur.wait_stream(side)
    for t in (log, out, flags) + (() if V0 is None else (V0,)):
        t.record_stream(side)


def apply_rotation_log(log: torch.Tensor, V0: torch.Tensor | None = None, out: torch.Tensor | None = None):
    """V0 [B, n, n] (the identity when None) with its columns rotated by
    the log [B, rounds, n/2, 4] of an iterate kernel, round by round.  The
    kernel for a CUDA log (into `out` when given), the plain version for a
    CPU one."""
    if log.device.type == "cpu":
        V = _apply_rotation_log_plain(log, V0)
        if out is not None:
            out.copy_(V)
            return out
        return V
    return _apply_rotation_log_cuda(log, V0, out)


apply_rotation_log.launches = 0
