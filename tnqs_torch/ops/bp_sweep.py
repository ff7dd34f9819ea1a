"""Fused BP message update of one (stage, degree, slot) group.

Port of `tnqs/ops/bp_sweep.py::bp_sweep_group` (`tnqs/ops/bp_sweep.py:230`).
On a CUDA tensor the update runs in the CUDA kernels of
`tnqs_torch/csrc/bp_sweep.cu`; on a CPU tensor `_bp_sweep_group_plain` runs
the same algebra in PyTorch.  Both split the absorbs between the ket and
the bra: one incoming message (slot u) goes to the bra, V = K x_u conj(M_u),
the others to the ket, W = K x_v M_v x ..., and the message is the sum of
W conj(V) over the site value and every slot but t.  `group_messages` is
the einsum chain the engine's einsum route runs (`tnqs/engine.py:816-831`).

The kernel reads the complex64 bucket ``T[k]`` in place, at the rows an
index tensor names; the TPU version's pre-permuted real/imaginary planes
(`plane_layouts`) and blocked-real embedding are Mosaic workarounds and are
not ported.  `bp_plan` makes the kernel's launch plan (slots, chunks,
scratch); the wrapper caches it per shape and device as the int64 array the
kernel reads and sets the kernels' attributes once per device, so a launch
is one ctypes call and makes no host sync.

Two arithmetic modes, as the TPU kernel has (`tnqs/ops/bp_sweep.py:129-166`):
"highest", every product in full float32, and "bf16_3x", every real
product hi.hi + hi.lo + lo.hi of its operands' bfloat16 split with float32
accumulation (the JAX engine's ``bp_precision="high"``).  In "bf16_3x" the
plain version splits at the kernel's points (each operand of each of the
three products, V and W rounded to float32 before their split) and takes
float32 products of the splits, which are exact, so it differs from the
kernel's tensor-core products only in the order of the sums.

bf16_3x takes one of two kernel designs by one rule, `tc_route`: degree 2
and 3 at chi <= 64 (every shape a path runs) go to the `wgmma` kernels fed
by TMA, which read T's split planes (`split_bucket`, made once per BP run
by the engine, or by the wrapper when it is given T alone); the other
admitted shapes (degree 4-6 at chi 8 and 16, degree 2 past chi = 64) keep
the `mma.sync` kernels, which split as they load.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence
from dataclasses import dataclass

import torch

from . import _build

# the kernels' shared tiles (`bp_sweep.cu`): 64 x 64 complex64 at a pitch of
# 66; pass 1 (`bp_mode_product`) and pass 2 (`bp_pass2`) hold three each
TILE = 64
PITCH = TILE + 2
SMEM_MODE = 3 * TILE * PITCH * 8
SMEM_PASS2 = 3 * TILE * PITCH * 8
# the bf16_3x kernels' split tiles: hi and lo planes of the real and
# imaginary parts, 64 rows of 72 bf16 each; pass 1 holds two, pass 2 three
PITCH_H = TILE + 8
SPLIT_BYTES = 4 * TILE * PITCH_H * 2
SMEM_MODE_3X = 2 * SPLIT_BYTES
SMEM_PASS2_3X = 3 * SPLIT_BYTES
# the tensor-core bf16_3x kernels (`bp_bra_tc`, `bp_pass2_tc`): a 64 x 64
# tile's four bf16 planes (32 KB); the CTA's message tile and a ring of two
# tiles, 1024 bytes of alignment slack and four mbarriers
TC_TILE_BYTES = 4 * TILE * TILE * 2
SMEM_TC = 1024 + 3 * TC_TILE_BYTES + 32
MODES = ("highest", "bf16_3x")
# cost of the reduce pass in pass-2 items, for choosing the chunks
_REDUCE_COST = 0.25


def supports_group(k: int, chi: int, dtype) -> bool:
    """Whether the CUDA kernel takes a degree-`k` group at bond cap `chi`:
    the TPU kernel's gate (`tnqs/ops/bp_sweep.py:81`): complex64, k >= 2
    (k = 1 has no absorb; the einsum is already minimal), chi % 8 == 0 and
    chi^k <= 2^18.  The kernel's limits are stated here and nowhere else."""
    return dtype == torch.complex64 and k >= 2 and chi % 8 == 0 and 0 < chi**k <= 1 << 18


def tc_route(k: int, chi: int) -> bool:
    """Whether an admitted bf16_3x group runs on the tensor-core kernels
    (`wgmma` from shared memory, TMA tile loads, T's split planes): degree 2
    or 3 at one 64-tile a bond.  The rest (degree >= 4, chi <= 16; degree 2
    past chi = 64) keeps the `mma.sync` kernels.  The one rule between the
    two designs."""
    return k <= 3 and chi <= TILE


def split_slots(k: int, t: int) -> tuple[int | None, int]:
    """(u, v) of a degree-`k` group through slot `t`: u the slot whose
    message goes to the bra side (None at k = 2, where the one message stays
    on the ket), v the ket slot absorbed last, inside the kernel's second
    pass.  v is the last slot unless t is, so one index of the tiles K[t, v]
    is contiguous; u is the first slot left."""
    v = k - 1 if t != k - 1 else k - 2
    if k == 2:
        return None, v
    return min(j for j in range(k) if j not in (t, v)), v


def _per_cta(items: int, ctas_per_chunk: int, slots: int, reduce_cost: float) -> int:
    """Items a CTA takes so that the grid's makespan, in items, is least:
    ceil(CTAs / slots) waves of `per` items each, plus `reduce_cost` when
    the chunks need summing; ties go to more items a CTA."""
    best = None
    for per in range(1, items + 1):
        chunks = -(-items // per)
        cost = -(-ctas_per_chunk * chunks // slots) * per + (reduce_cost if chunks > 1 else 0.0)
        if best is None or cost <= best[0]:
            best = (cost, per)
    return best[1]


@dataclass(frozen=True)
class BPPlan:
    """The kernel's launch plan for one group shape (`bp_sweep.cu`).

    Pass 1 (`bp_mode_product`, k >= 3) makes V = K x_u conj(M_u) and, at
    k >= 4, the ket absorbs of `pre` in turn, per (message, s) in
    `mode_blocks` blocks of 64 columns, `mode_per_cta` a CTA.  Pass 2
    (`bp_pass2`) has a CTA per (message, chunk, i-block, j-block); a chunk
    is `per_cta` of the message's `items` = d chi^(k-2) items (s, o), o the
    index of the slots other than t and v.  With more than one chunk the
    partials are summed in chunk order (`bp_reduce`)."""

    k: int
    chi: int
    batch: int
    d: int
    t: int
    u: int | None
    v: int
    pre: tuple[int, ...]
    nblk: int
    items: int
    per_cta: int
    chunks: int
    mode_blocks: int
    mode_per_cta: int

    @property
    def site(self) -> int:
        return self.chi**self.k

    @property
    def v_elems(self) -> int:
        """complex64 elements of V: the group's [B, d, chi^k], for k >= 3
        (on the tensor-core route: bf16 planes of the same bytes)."""
        return self.batch * self.d * self.site if self.k >= 3 else 0

    @property
    def w_elems(self) -> int:
        """The ket absorbs before pass 2 (k >= 4), in up to two alternating
        buffers of [B, d, chi^k]."""
        return self.batch * self.d * self.site * min(len(self.pre), 2)

    @property
    def part_elems(self) -> int:
        """The partials [B, chunks, chi, chi], when there is more than one."""
        return self.batch * self.chunks * self.chi**2 if self.chunks > 1 else 0

    @property
    def scratch_elems(self) -> int:
        return self.v_elems + self.w_elems + self.part_elems

    def pass2_items(self, chunk: int) -> list[tuple[int, int]]:
        """The (s, o) items of a message that pass-2 chunk `chunk` sums, in
        its order (the kernel's `it / O`, `it % O`)."""
        O = self.chi ** (self.k - 2)
        return [divmod(it, O) for it in range(chunk * self.per_cta, min(self.items, (chunk + 1) * self.per_cta))]


@functools.lru_cache(maxsize=None)
def bp_plan(k: int, chi: int, batch: int, t: int, d: int, mode_slots: int, pass2_slots: int,
            tc: bool = False) -> BPPlan:
    """The plan of a (k, chi, B, t) group for a card that holds `mode_slots`
    pass-1 and `pass2_slots` pass-2 CTAs at once.  With `tc` (the
    tensor-core route, `tc_route`) pass 1's unit is one value of the slot
    that is neither u nor the last (a 64-column block at chi = 64, fewer
    columns below)."""
    u, v = split_slots(k, t)
    pre = tuple(j for j in range(k) if j not in (t, u, v))
    nblk = -(-chi // TILE)
    items = d * chi ** (k - 2)
    per_cta = _per_cta(items, batch * nblk * nblk, pass2_slots, _REDUCE_COST)
    if k < 3:
        mode_blocks = 0
    else:
        mode_blocks = chi ** (k - 2) if tc else chi ** (k - 1) // TILE
    mode_per_cta = _per_cta(mode_blocks, batch * d, mode_slots, 0.0) if k >= 3 else 1
    return BPPlan(k, chi, batch, d, t, u, v, pre, nblk, items, per_cta, -(-items // per_cta), mode_blocks,
                  mode_per_cta)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor as float32 values: hi = bf16(x), lo =
    bf16(x - hi), both rounded to nearest even (x - hi is exact)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


@dataclass(frozen=True)
class SplitBucket:
    """The bf16 split planes of a bucket T[k], the operand the tensor-core
    bf16_3x kernels read in place of T: `planes` [4, n_k, d, chi x k] bf16,
    re hi, im hi, re lo, im lo (`_split` of the real and imaginary parts);
    None for a CPU tensor, whose plain version splits T itself.  It holds
    the tensor it was made from and that tensor's version counter at the
    time, and `bp_sweep_group` refuses it for any other tensor or after an
    in-place write to that one, so a split never outlives its T."""

    source: torch.Tensor
    version: int
    planes: torch.Tensor | None

    def of(self, Tk: torch.Tensor) -> bool:
        """Whether these planes are the split of `Tk` as it stands."""
        return self.source is Tk and self.version == Tk._version


def _split_planes_plain(Tk: torch.Tensor) -> torch.Tensor:
    """The split planes by `_split`, in PyTorch."""
    (rh, rl), (ih, il) = _split(Tk.real), _split(Tk.imag)
    return torch.stack([rh, ih, rl, il]).to(torch.bfloat16)


def split_bucket(Tk: torch.Tensor) -> SplitBucket:
    """T[k]'s split planes: on a CUDA tensor by the split pass of
    `bp_sweep.cu` (`tnqs_bp_split`, counted in `split_bucket.launches`).  On
    a CPU tensor only T and its version are kept: the plain version, which
    `bp_sweep_group` runs there, never reads the planes."""
    version = Tk._version
    if Tk.device.type == "cpu":
        return SplitBucket(Tk, version, None)
    if not (Tk.is_cuda and Tk.dtype == torch.complex64 and Tk.is_contiguous() and Tk.dim() >= 3):
        raise ValueError("split_bucket takes a contiguous complex64 CUDA bucket [n_k, d, chi x k]")
    rows = Tk.shape[0] * Tk.shape[1]
    per_row = Tk[0, 0].numel()
    planes = torch.empty((4,) + tuple(Tk.shape), dtype=torch.bfloat16, device=Tk.device)
    if rows and per_row:
        lib = _build.kernels()
        _build.check(lib.tnqs_bp_split(Tk.data_ptr(), planes.data_ptr(), rows, per_row, Tk.device.index,
                                       torch.cuda.current_stream(Tk.device).cuda_stream), "tnqs_bp_split")
        split_bucket.launches += 1
    return SplitBucket(Tk, version, planes)


split_bucket.launches = 0


def _einsum3(expr: str, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The complex64 einsum of two operands in bf16_3x: four real
    products, each hi.hi + hi.lo + lo.hi of the operands' splits."""
    (ar, ai), (br, bi) = ((_split(X.real), _split(X.imag)) for X in (A.resolve_conj(), B.resolve_conj()))

    def prod(x, y):
        return torch.einsum(expr, x[1], y[0]) + torch.einsum(expr, x[0], y[1]) + torch.einsum(expr, x[0], y[0])

    return torch.complex(prod(ar, br) - prod(ai, bi), prod(ar, bi) + prod(ai, br))


def _einsum(expr: str, A: torch.Tensor, B: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.einsum(expr, A, B) if mode == "highest" else _einsum3(expr, A, B)


def absorb_message(A: torch.Tensor, M: torch.Tensor, axis: int, mode: str = "highest") -> torch.Tensor:
    """Contract bond `axis` of the batched tensor A [B, ..., chi@axis, ...]
    with the batched message M [B, chi, chi] as (ket, out)."""
    A = _einsum("B...i,Bij->B...j", A.movedim(axis, -1), M, mode)
    return A.movedim(-1, axis)


def _bra_product(A: torch.Tensor, Bra: torch.Tensor, t: int, mode: str = "highest") -> torch.Tensor:
    """m[B, i, j] = sum over the site axis and every bond but slot t of
    A[.., i@t, ..] conj(Bra[.., j@t, ..])."""
    k = A.dim() - 2
    a_sub = ["B", "s"] + [chr(ord("a") + j) for j in range(k)]
    b_sub = list(a_sub)
    a_sub[2 + t], b_sub[2 + t] = "i", "j"
    return _einsum(f"{''.join(a_sub)},{''.join(b_sub)}->Bij", A, Bra.conj(), mode)


def group_messages(A: torch.Tensor, Ms: Sequence[torch.Tensor], t: int) -> torch.Tensor:
    """Un-normalized outgoing messages [B, chi, chi] of the site tensors A
    [B, d, chi x k] through slot `t` by the einsum chain: absorb Ms[col]
    [B, chi, chi] into the col-th other slot (ascending), then contract with
    conj(A) over the site axis and every bond but slot t."""
    k = A.dim() - 2
    Asrc = A
    for M, j in zip(Ms, (j for j in range(k) if j != t)):
        A = absorb_message(A, M, 2 + j)
    return _bra_product(A, Asrc, t)


def _check_group(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int,
                 mode: str = "highest") -> tuple[int, int, int]:
    if mode not in MODES:
        raise ValueError(f"bp_sweep_group: unknown mode {mode!r}; one of {MODES}")
    k = Tk.dim() - 2
    B = Min.shape[0]
    chi = Tk.shape[-1]
    if k < 2 or Tk.shape[2:] != (chi,) * k or Min.shape[1:] != (k - 1, chi, chi):
        raise ValueError(f"bp_sweep_group: bad shapes T {tuple(Tk.shape)}, messages {tuple(Min.shape)}")
    if rows.dtype != torch.int64 or rows.shape != (B,) or rows.device != Tk.device:
        raise ValueError(f"bp_sweep_group: rows must be int64 [{B}] on {Tk.device}")
    if not 0 <= t < k:
        raise ValueError(f"bp_sweep_group: slot {t} of a degree-{k} bucket")
    # on the card the kernel checks the rows itself (a host check would sync)
    if rows.device.type == "cpu" and B and not (0 <= int(rows.min()) and int(rows.max()) < Tk.shape[0]):
        raise ValueError(f"bp_sweep_group: rows outside T {tuple(Tk.shape)}")
    return k, B, chi


def _bp_sweep_group_plain(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int,
                          mode: str = "highest") -> torch.Tensor:
    """The kernel's messages by its formulation in PyTorch: the ket side W
    takes every message but slot u's, ascending, the bra side V = K x_u
    conj(M_u) (K itself at k = 2), then the sum of W conj(V) over s and
    every slot but t (`split_slots`), each product in `mode`."""
    _bp_sweep_group_plain.calls += 1
    k, _, _ = _check_group(Tk, Min, rows, t, mode)
    u, _ = split_slots(k, t)
    W = V = Tk[rows]
    for col, j in enumerate(j for j in range(k) if j != t):
        if j == u:  # V[.., x@u, ..] = sum_p conj(M_u[x, p]) K[.., p@u, ..]
            V = absorb_message(V, Min[:, col].mH, 2 + j, mode)
        else:
            W = absorb_message(W, Min[:, col], 2 + j, mode)
    return _bra_product(W, V, t, mode)


_bp_sweep_group_plain.calls = 0


def _query_slots(setup: str, smem: tuple[int, int], device_index: int) -> tuple[int, int, int]:
    """Set one mode's kernels' shared-memory limits on a device (`setup`,
    the C entry) and return how many pass-1, pass-2 and wide pass-2
    (chi > 64) CTAs the card holds at once."""
    vals = [ctypes.c_int() for _ in range(6)]
    with torch.cuda.device(device_index):
        _build.check(getattr(_build.kernels(), setup)(*(ctypes.byref(x) for x in vals)), setup)
    smem_mode, smem_pass2, *ctas, sms = (x.value for x in vals)
    if (smem_mode, smem_pass2) != smem:
        raise RuntimeError(f"bp_sweep.cu's shared memory {smem_mode}, {smem_pass2} B is not the plan's {smem} B")
    if min(ctas) < 1:
        raise RuntimeError(f"no BP kernel CTA of {setup} fits an SM {ctas}")
    return tuple(n * sms for n in ctas)


@functools.cache
def _slots(device_index: int) -> tuple[int, int, int]:
    """Once per device: the FP32 ("highest") kernels' CTA slots."""
    return _query_slots("tnqs_bp_sweep_setup", (SMEM_MODE, SMEM_PASS2), device_index)


@functools.cache
def _slots_3x(device_index: int) -> tuple[int, int, int]:
    """Once per device: the bf16_3x kernels' CTA slots."""
    return _query_slots("tnqs_bp_sweep_setup_3x", (SMEM_MODE_3X, SMEM_PASS2_3X), device_index)


@functools.cache
def _slots_tc(device_index: int) -> tuple[int, int]:
    """Once per device: set the tensor-core bf16_3x kernels' shared-memory
    limit and return how many pass-1 and pass-2 CTAs the card holds at
    once."""
    vals = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device_index):
        _build.check(_build.kernels().tnqs_bp_sweep_setup_tc(*(ctypes.byref(x) for x in vals)),
                     "tnqs_bp_sweep_setup_tc")
    smem, ctas_mode, ctas_pass2, sms = (x.value for x in vals)
    if smem != SMEM_TC:
        raise RuntimeError(f"bp_sweep.cu's tensor-core shared memory {smem} B is not the plan's {SMEM_TC} B")
    if min(ctas_mode, ctas_pass2) < 1:
        raise RuntimeError(f"no tensor-core BP kernel CTA fits an SM ({ctas_mode}, {ctas_pass2})")
    return ctas_mode * sms, ctas_pass2 * sms


@functools.lru_cache(maxsize=None)
def _launch_args_tc(k: int, chi: int, batch: int, t: int, d: int, device_index: int):
    """(scratch elements, the plan as the int64[12] `tnqs_bp_sweep_tc`
    reads) of a tensor-core bf16_3x group shape on a device, made once."""
    plan = bp_plan(k, chi, batch, t, d, *_slots_tc(device_index), tc=True)
    args = (ctypes.c_longlong * 12)(batch, k, chi, d, t, -1 if plan.u is None else plan.u, plan.v, plan.mode_per_cta,
                                    plan.per_cta, plan.chunks, 0, plan.v_elems)  # V, then the partials
    return plan.v_elems + plan.part_elems, args


@functools.lru_cache(maxsize=None)
def _launch_args(k: int, chi: int, batch: int, t: int, d: int, device_index: int, mode: str = "highest"):
    """(scratch elements, the plan as the int64[14] `tnqs_bp_sweep` reads)
    of a group shape on a device in `mode`, made once; the plan follows the
    occupancy of that mode's kernels."""
    mode_slots, pass2_slots, wide_slots = (_slots if mode == "highest" else _slots_3x)(device_index)
    plan = bp_plan(k, chi, batch, t, d, mode_slots, pass2_slots if chi <= TILE else wide_slots)
    buf = batch * d * plan.site
    offsets = (0, plan.v_elems, plan.v_elems + buf, plan.v_elems + plan.w_elems)  # V, W0, W1, partials
    args = (ctypes.c_longlong * 14)(batch, k, chi, d, t, -1 if plan.u is None else plan.u, plan.v, plan.mode_per_cta,
                                    plan.per_cta, plan.chunks, *offsets)
    return plan.scratch_elems, args


def _bp_sweep_group_cuda(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int,
                         mode: str = "highest", split: SplitBucket | None = None) -> torch.Tensor:
    """Launch `tnqs_bp_sweep` on contiguous complex64 CUDA tensors; in
    bf16_3x `tnqs_bp_sweep_tc` on T's split planes (`split`, else made
    here) where `tc_route` says so, else `tnqs_bp_sweep_3x`."""
    if not (Tk.is_cuda and Min.device == Tk.device and Tk.dtype == Min.dtype == torch.complex64):
        raise ValueError("bp_sweep_group kernel takes complex64 CUDA tensors on one device")
    if not (Tk.is_contiguous() and Min.is_contiguous() and rows.is_contiguous()):
        raise ValueError("bp_sweep_group kernel takes contiguous T, rows and messages")
    k, B, chi = _check_group(Tk, Min, rows, t, mode)
    if not supports_group(k, chi, Tk.dtype):
        raise ValueError(f"bp_sweep_group kernel does not take k={k}, chi={chi}")
    out = torch.empty((B, chi, chi), dtype=Tk.dtype, device=Tk.device)
    if B == 0:
        return out
    dev = Tk.device.index
    lib = _build.kernels()
    if mode == "bf16_3x" and tc_route(k, chi):
        route, src = "wgmma", (split if split is not None else split_bucket(Tk)).planes
        elems, args = _launch_args_tc(k, chi, B, t, Tk.shape[1], dev)
        launch = lib.tnqs_bp_sweep_tc
    else:
        route, src = ("fp32" if mode == "highest" else "mma.sync"), Tk
        elems, args = _launch_args(k, chi, B, t, Tk.shape[1], dev, mode)
        launch = lib.tnqs_bp_sweep if mode == "highest" else lib.tnqs_bp_sweep_3x
    # V, the ket absorbs before pass 2 and the partials, in one allocation
    scratch = torch.empty(elems, dtype=Tk.dtype, device=Tk.device) if elems else None
    err = launch(
        src.data_ptr(), rows.data_ptr(), Min.data_ptr(), out.data_ptr(), scratch.data_ptr() if elems else None,
        args, Tk.shape[0], dev, torch.cuda.current_stream(Tk.device).cuda_stream,
    )
    _build.check(err, launch.__name__)
    bp_sweep_group.launches += 1
    bp_sweep_group.launches_by_mode[mode] += 1
    bp_sweep_group.launches_by_route[route] += 1
    key = (mode, k, chi, B)
    bp_sweep_group.launches_by_shape[key] = bp_sweep_group.launches_by_shape.get(key, 0) + 1
    return out


def bp_sweep_group(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int,
                   mode: str = "highest", split: SplitBucket | None = None) -> torch.Tensor:
    """Un-normalized outgoing BP messages of one group, in the arithmetic of
    `mode` ("highest" or "bf16_3x", the TPU kernel's modes).

    `Tk` is the whole degree-k bucket [n_k, d, chi x k]; the bucket rows
    `rows` (int64 [B], on Tk's device) emit one message each through bond
    slot `t`.  `Min` [B, k-1, chi, chi] holds the incoming messages of the
    other slots in ascending slot order.  Returns m [B, chi, chi] (ket
    index, bra index); the caller sum-normalizes.  `split`, T's split
    planes (`split_bucket(Tk)`), saves the tensor-core bf16_3x route its own
    split of T a call; it must be the split of `Tk` as it stands.  A CPU
    tensor runs the plain version (which splits T itself: the same bits);
    any other device goes to the kernel launcher, which raises off a CUDA
    device."""
    if split is not None and not split.of(Tk):
        raise ValueError("bp_sweep_group: the split planes are not those of this T as it stands")
    if Tk.device.type != "cpu":
        return _bp_sweep_group_cuda(Tk, Min, rows, t, mode, split)
    _, B, chi = _check_group(Tk, Min, rows, t, mode)
    if B == 0:
        return Tk.new_empty((0, chi, chi))
    return _bp_sweep_group_plain(Tk, Min, rows, t, mode)


bp_sweep_group.launches = 0  # every launch, in either mode
bp_sweep_group.launches_by_mode = dict.fromkeys(MODES, 0)
bp_sweep_group.launches_by_shape = {}  # (mode, k, chi, B) -> launches
# by kernel design: "fp32" ("highest"), "wgmma" and "mma.sync" (bf16_3x, `tc_route`)
bp_sweep_group.launches_by_route = dict.fromkeys(("fp32", "wgmma", "mma.sync"), 0)
