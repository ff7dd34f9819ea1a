"""Fused BP message update of one (stage, degree, slot) group.

Port of `tnqs/ops/bp_sweep.py::bp_sweep_group` (`tnqs/ops/bp_sweep.py:230`).
On a CUDA tensor the whole chain — absorb the k-1 incoming messages into the
ket site tensor, contract with the conjugate bra over the site axis and the
other bonds, sum over the site value — runs in the CUDA kernel
`tnqs_torch/csrc/bp_sweep.cu`; on a CPU tensor `_bp_sweep_group_plain` runs
`group_messages`, the einsum chain the engine's einsum route uses too
(`tnqs/engine.py:816-831`).

The kernel reads the complex64 bucket ``T[k]`` in place, at the rows an
index tensor names; the TPU version's pre-permuted real/imaginary planes
(`plane_layouts`) and blocked-real embedding are Mosaic workarounds and are
not ported.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from . import _build


def supports_group(k: int, chi: int, dtype) -> bool:
    """Whether the CUDA kernel takes a degree-`k` group at bond cap `chi`:
    the TPU kernel's gate (`tnqs/ops/bp_sweep.py:81`): complex64, k >= 2
    (k = 1 has no absorb; the einsum is already minimal), chi % 8 == 0 and
    chi^k <= 2^18.  The kernel's limits are stated here and nowhere else."""
    return dtype == torch.complex64 and k >= 2 and chi % 8 == 0 and 0 < chi**k <= 1 << 18


def absorb_message(A: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract bond `axis` of the batched tensor A [B, ..., chi@axis, ...]
    with the batched message M [B, chi, chi] as (ket, out)."""
    A = torch.einsum("B...i,Bij->B...j", A.movedim(axis, -1), M)
    return A.movedim(-1, axis)


def group_messages(A: torch.Tensor, Ms: Sequence[torch.Tensor], t: int) -> torch.Tensor:
    """Un-normalized outgoing messages [B, chi, chi] of the site tensors A
    [B, d, chi x k] through slot `t` by the einsum chain: absorb Ms[col]
    [B, chi, chi] into the col-th other slot (ascending), then contract with
    conj(A) over the site axis and every bond but slot t."""
    k = A.dim() - 2
    Asrc = A
    for M, j in zip(Ms, (j for j in range(k) if j != t)):
        A = absorb_message(A, M, 2 + j)
    a_sub = ["B", "s"] + [chr(ord("a") + j) for j in range(k)]
    b_sub = list(a_sub)
    a_sub[2 + t], b_sub[2 + t] = "i", "j"
    return torch.einsum(f"{''.join(a_sub)},{''.join(b_sub)}->Bij", A, Asrc.conj())


def _check_group(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int) -> tuple[int, int, int]:
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


def _bp_sweep_group_plain(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int) -> torch.Tensor:
    """The kernel's messages by the einsum chain (`group_messages`)."""
    _bp_sweep_group_plain.calls += 1
    _check_group(Tk, Min, rows, t)
    return group_messages(Tk[rows], Min.unbind(1), t)


_bp_sweep_group_plain.calls = 0


def _bp_sweep_group_cuda(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int) -> torch.Tensor:
    """Launch `tnqs_bp_sweep` on contiguous complex64 CUDA tensors."""
    if not (Tk.is_cuda and Min.device == Tk.device and Tk.dtype == Min.dtype == torch.complex64):
        raise ValueError("bp_sweep_group kernel takes complex64 CUDA tensors on one device")
    if not (Tk.is_contiguous() and Min.is_contiguous() and rows.is_contiguous()):
        raise ValueError("bp_sweep_group kernel takes contiguous T, rows and messages")
    k, B, chi = _check_group(Tk, Min, rows, t)
    if not supports_group(k, chi, Tk.dtype):
        raise ValueError(f"bp_sweep_group kernel does not take k={k}, chi={chi}")
    lib = _build.kernels()
    elems = ctypes.c_longlong()
    _build.check(lib.tnqs_bp_sweep_scratch(B, k, chi, ctypes.byref(elems)), "tnqs_bp_sweep_scratch")
    # the absorb buffers of shapes too large for shared memory
    scratch = torch.empty(elems.value, dtype=Tk.dtype, device=Tk.device) if elems.value else None
    out = torch.empty((B, chi, chi), dtype=Tk.dtype, device=Tk.device)
    with torch.cuda.device(Tk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tnqs_bp_sweep(
            Tk.data_ptr(), rows.data_ptr(), Min.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), Tk.shape[0], B, k, chi, Tk.shape[1], t, stream,
        )
    _build.check(err, "tnqs_bp_sweep")
    bp_sweep_group.launches += 1
    return out


def bp_sweep_group(Tk: torch.Tensor, Min: torch.Tensor, rows: torch.Tensor, t: int) -> torch.Tensor:
    """Un-normalized outgoing BP messages of one group.

    `Tk` is the whole degree-k bucket [n_k, d, chi x k]; the bucket rows
    `rows` (int64 [B], on Tk's device) emit one message each through bond
    slot `t`.  `Min` [B, k-1, chi, chi] holds the incoming messages of the
    other slots in ascending slot order.  Returns m [B, chi, chi] (ket
    index, bra index); the caller sum-normalizes.  A CPU tensor runs the
    plain version; any other device goes to the kernel launcher, which
    raises off a CUDA device."""
    _, B, chi = _check_group(Tk, Min, rows, t)
    if B == 0:
        return Tk.new_empty((0, chi, chi))
    if Tk.device.type == "cpu":
        return _bp_sweep_group_plain(Tk, Min, rows, t)
    return _bp_sweep_group_cuda(Tk, Min, rows, t)


bp_sweep_group.launches = 0
