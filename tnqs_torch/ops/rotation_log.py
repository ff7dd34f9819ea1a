"""V from a log of Jacobi rotations.

Past the widths their clusters hold, K1 (`osj.osj_svd`) and K2
(`jacobi.jacobi_eigh`) keep V out of their rounds: each round appends its
m = n/2 rotations to a log, [B, rounds, m, 4] float32 (c, Re s, Im s, and a
meta word whose int32 bits are p << 16 | q << 1 | taken, p and q the pair's
column indices), and `apply_rotation_log` then rotates V0's columns by the
logged rounds in order: the CUDA kernels of `tnqs_torch/csrc/rotation_log.cu`
on a CUDA tensor, `_apply_rotation_log_plain` on a CPU tensor.  Two layouts,
by width (`plan`): up to n = `REG_N` V's rows stay in registers, a warp's
lanes holding blocks of pair positions that move along the tournament's
cycle ("regs"); past it one CTA per slab of rows in shared memory ("slab").
Where the iterate's clusters leave SMs idle in their one or last wave,
`follow` runs the kernel beside the iterate on a second stream as the log
grows, in the slab layout where only its units all fit on those SMs
(`beside_plan`).  V0 may be `out`: an iterate run in chunks of rounds
applies each chunk's log to V in place, from the chunk's first round
`round0`.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from ._build import SMEM_LIMIT

STAGE_BYTES = 16_384  # the log a stage of the slab layout aims to hold
STAGES = 2  # the slab layout's stages of the log in flight
SLAB_ROWS = (16, 8, 4, 2, 1)  # rows of V a CTA in the slab layout, the first that fits
REG_N = 1024  # the widest V the register layout holds: P = n/64 <= 16 positions a lane
REG_STAGES = 4  # the register layout's stages of the log in flight
REG_STAGE_ROUNDS = 8  # the most rounds a stage of the register layout holds
REG_ROWS = (16, 12, 7)  # rows of V a CTA in the register layout (R a warp): up to P = 8, up to 12, past it
LAYOUTS = ("regs", "slab")


class VPlan(NamedTuple):
    """A launch of V's kernel for V [n, n]: the layout, the rows of V a CTA
    (its unit of work), the register layout's positions a lane P and rows a
    warp R (0 in the slab layout), the log's rounds a stage K and entries a
    stage E (K n/2, or part of a round in the slab layout past n = 9684),
    and the shared bytes a CTA."""
    layout: str
    rows: int
    P: int
    R: int
    K: int
    E: int
    smem: int


def smem_bytes(n: int, S: int, E: int) -> int:
    """The slab layout's shared bytes a CTA (`smem_bytes` in
    `tnqs_torch/csrc/rotation_log.cu`): `STAGES` stages of E entries of the
    log, the slab of S rows of V, the stages' mbarriers."""
    return 16 * STAGES * E + 8 * S * n + 8 * STAGES


def pieces(P: int) -> int:
    """The register layout's copies of a round into a stage, gcd(P, 8): the
    lanes' blocks of P entries in D runs, run g shifted by g entries, so
    that the 8 lanes of a quarter warp read 8 different bank groups."""
    return math.gcd(P, 8)


def round_units(P: int) -> int:
    """The 16-byte entries a round takes in a stage of the register layout:
    32 blocks of P entries and the runs' shifts."""
    return 32 * P + pieces(P)


def lane_block(lane: int, P: int) -> int:
    """The block of pair positions [b P, b P + P) that lane `lane` holds in
    the register layout (`lane_block` in `rotation_log.cu`): lane 8 q + l,
    l = g (8/D) + t, holds block g (32/D) + q (8/D) + t, D = `pieces(P)`:
    the lanes of a quarter warp span the D runs."""
    D = pieces(P)
    q, l = divmod(lane, 8)
    g, t = divmod(l, 8 // D)
    return g * (32 // D) + q * (8 // D) + t


def stage_unit(i: int, P: int) -> int:
    """Where entry i of a round stands in a stage of the register layout:
    its run's shift after it (`stage_unit` in `rotation_log.cu`)."""
    return i + (i // P) // (32 // pieces(P))


def reg_smem_bytes(P: int, K: int) -> int:
    """The register layout's shared bytes a CTA: `REG_STAGES` stages of K
    rounds, two mbarriers a stage."""
    return 16 * REG_STAGES * K * round_units(P) + 16 * REG_STAGES


def reg_rounds(P: int) -> int:
    """The register layout's rounds a stage (`stage_rounds` in
    `rotation_log.cu`): up to P = 8 the multiple of P up to
    `REG_STAGE_ROUNDS`, past it the largest divisor of P up to it whose
    stages fit, so that a stage starts and ends where the kernel's unrolled
    block of P rounds knows it at compile time."""
    if P <= 8:
        return P * (REG_STAGE_ROUNDS // P)
    return max(d for d in range(1, REG_STAGE_ROUNDS + 1) if P % d == 0 and reg_smem_bytes(P, d) <= SMEM_LIMIT)


def slab_plan(n: int) -> tuple[int, int, int]:
    """The slab layout for V [n, n]: (rows a CTA S, a half-warp each, log
    entries a stage E, shared bytes a CTA).  Whole rounds a stage where one
    round fits beside a row (about `STAGE_BYTES` of log, K rounds,
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


def plan(n: int) -> VPlan:
    """V's kernel for V [n, n], by width: the register layout up to
    n = `REG_N` (P = ceil(n/64) pair positions a lane, R = 2 rows a warp
    up to P = 4 and 1 past it, `REG_ROWS` rows a CTA and one warp that
    loads the log, stages of K = `reg_rounds(P)` whole rounds), the slab
    layout past it (`slab_plan`).  ValueError for odd n, n < 4 or
    n > 28990."""
    if n % 2 or n < 4:
        raise ValueError(f"the rotation log takes even 4 <= n <= 28990, got {n}")
    m = n // 2
    if n <= REG_N:
        P = -(-m // 32)
        K = reg_rounds(P)
        return VPlan("regs", REG_ROWS[(P > 8) + (P > 12)], P, 2 if P <= 4 else 1, K, K * m, reg_smem_bytes(P, K))
    return slab_vplan(n)


def slab_vplan(n: int) -> VPlan:
    S, E, smem = slab_plan(n)
    return VPlan("slab", S, 0, 0, max(1, E // (n // 2)), E, smem)


def beside_plan(n: int, B: int, idle: int, ctas_per_sm) -> VPlan:
    """V's kernel for B matrices [n, n] beside an iterate that leaves `idle`
    SMs: `plan(n)`, unless that is the register layout and its units (a
    CTA's rows) of the B matrices do not all fit on those SMs at once while
    the slab layout's do (`ctas_per_sm(layout)`: the CTAs an SM holds).
    There the slab layout follows the whole log beside the iterate, where
    the register layout, faster alone, would leave its last units to run
    after it (at 10e's [4, 512, 512]: 128 units, 68 SMs, one a SM)."""
    vp = plan(n)
    if vp.layout != "regs":
        return vp
    slab = slab_vplan(n)
    fits = {v.layout: B * -(-n // v.rows) <= idle * ctas_per_sm(v.layout) for v in (vp, slab)}
    return slab if fits["slab"] and not fits["regs"] else vp


def beside_vplan(n: int, B: int, cluster: int, clusters: int, device: torch.device) -> VPlan:
    """V's kernel beside an iterate launch of B clusters of `cluster` CTAs
    on [n, n], `clusters` of them held at once (`follow`): `beside_plan`
    on the SMs its one or last wave leaves idle."""
    idle = torch.cuda.get_device_properties(device).multi_processor_count - last_wave(B, clusters) * cluster
    return beside_plan(n, B, idle, lambda layout: _ctas_per_sm(device, n, layout))


@functools.cache
def _ctas_per_sm(device: torch.device, n: int, layout: str) -> int:
    """The CTAs of `plan`'s register layout or of the slab layout for
    V [n, n] one SM of `device` holds at once."""
    S, E, _ = slab_plan(n)
    with torch.cuda.device(device):
        ctas = _build.kernels().tnqs_rotation_log_ctas_per_sm(n, S, E, int(layout == "regs"))
    _build.check(min(ctas, 0), "tnqs_rotation_log_ctas_per_sm")
    return ctas


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
                             flags: tuple | None = None, mode: int = 0, round0: int = 0,
                             vp: VPlan | None = None) -> torch.Tensor:
    """Launch the layout of `vp` (by default `plan`'s: `tnqs_rotation_log_regs`
    from the log's first round `round0`, or `tnqs_rotation_log`) into
    `out`, or a new V [B, n, n]; `flags` (started, progress, claim, cluster)
    and `mode` (1 follow, 2 rest) for a launch beside the iterate
    (`follow`)."""
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
    vp = plan(n) if vp is None else vp
    started, progress, claim, cluster = flags if flags is not None else (None, None, None, 0)
    ptr = [None if t is None else t.data_ptr() for t in (started, progress, claim)]
    lib = _build.kernels()
    with torch.cuda.device(log.device):
        stream = torch.cuda.current_stream().cuda_stream
        v_in = None if V0 is None else V0.data_ptr()
        if vp.layout == "regs":
            err = lib.tnqs_rotation_log_regs(v_in, log.data_ptr(), out.data_ptr(), B, n, rounds, round0, vp.K, *ptr,
                                             cluster, mode, stream)
        else:
            err = lib.tnqs_rotation_log(v_in, log.data_ptr(), out.data_ptr(), B, n, rounds, vp.rows, vp.E, *ptr,
                                        cluster, mode, stream)
    _build.check(err, f"tnqs_rotation_log ({vp.layout})")
    apply_rotation_log.launches += 1
    apply_rotation_log.launches_by_layout[vp.layout] += 1
    apply_rotation_log.slab_beside += int(vp.layout == "slab" and n <= REG_N)
    return out


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def last_wave(B: int, clusters: int) -> int:
    """The clusters of the last wave of a launch of B clusters, `clusters`
    of them held at once."""
    return B - (-(-B // clusters) - 1) * clusters


def follows(B: int, cluster: int, clusters: int, device: torch.device) -> bool:
    """Whether V's kernel runs beside an iterate launch of B clusters of
    `cluster` CTAs, `clusters` of them held at once: where its one or last
    wave leaves SMs idle."""
    return last_wave(B, clusters) * cluster < torch.cuda.get_device_properties(device).multi_processor_count


@contextlib.contextmanager
def follow(log: torch.Tensor, V0: torch.Tensor | None, out: torch.Tensor, cluster: int, clusters: int):
    """V from the log of an iterate kernel launched inside the block (on the
    current stream, given `started` and `progress` and `stage` from the
    yielded (started, progress, stage); it publishes its progress every
    `stage` rounds; B clusters of `cluster` CTAs, `clusters` of them held
    at once): the V kernel (`beside_plan` on the SMs the iterate's one or
    last wave leaves idle) follows the log on a second stream, then takes
    what it left on the current one, and the current stream waits for
    both.  Past one wave a gate (`tnqs_rotation_log_gate`, one warp) holds
    the follow launch back on the second stream until every cluster of the
    iterate runs, so that its CTAs reach the SMs the last wave leaves idle,
    not the first wave's, where they would leave."""
    B, rounds, m, _ = log.shape
    n = 2 * m
    vp = beside_vplan(n, B, cluster, clusters, log.device)
    slabs = -(-n // vp.rows)
    flags = torch.zeros(B + B * cluster + B * slabs, dtype=torch.int32, device=log.device)
    started, progress, claim = flags[:B], flags[B:B + B * cluster], flags[B + B * cluster:]
    cur, side = torch.cuda.current_stream(log.device), _side_stream(log.device)
    side.wait_stream(cur)  # the log, flags, V0 and out are ready
    yield started, progress, max(1, STAGE_BYTES // (16 * m))
    with torch.cuda.stream(side):
        if B > clusters:
            _build.check(_build.kernels().tnqs_rotation_log_gate(started.data_ptr(), B, side.cuda_stream),
                         "tnqs_rotation_log_gate")
        _apply_rotation_log_cuda(log, V0, out, (started, progress, claim, cluster), 1, vp=vp)
    _apply_rotation_log_cuda(log, V0, out, (started, progress, claim, cluster), 2, vp=vp)
    cur.wait_stream(side)
    for t in (log, out, flags) + (() if V0 is None else (V0,)):
        t.record_stream(side)


def apply_rotation_log(log: torch.Tensor, V0: torch.Tensor | None = None, out: torch.Tensor | None = None,
                       round0: int = 0):
    """V0 [B, n, n] (the identity when None) with its columns rotated by
    the log [B, rounds, n/2, 4] of an iterate kernel, round by round, its
    first round being round `round0` of the iterate's schedule.  The kernel
    for a CUDA log (into `out` when given), the plain version for a CPU
    one."""
    if log.device.type == "cpu":
        V = _apply_rotation_log_plain(log, V0)
        if out is not None:
            out.copy_(V)
            return out
        return V
    return _apply_rotation_log_cuda(log, V0, out, round0=round0)


apply_rotation_log.launches = 0
apply_rotation_log.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
apply_rotation_log.slab_beside = 0  # the slab layout's launches at n <= REG_N: `beside_plan`'s
