"""Index-aware factorizations on `torch.linalg` (port of
`tnqs/core/linalg.py`): truncated SVD, QR and the hermitian
eigendecomposition with its float64 promotion.

The truncation rule stays a host function on float64 numpy
(`truncation_rank`): a truncated factorization reads its singular values
to the host once, as the JAX package does (`tnqs/core/linalg.py:79`), and
`host_reads` counts those reads.  `pseudo_sqrt_inv_sqrt` cuts its
eigenvalues on the device and reads nothing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .index import Index
from .tensor import Tensor


class _Counter:
    """Host reads of singular values, one per truncated factorization."""

    def __init__(self):
        self.count = 0


host_reads = _Counter()


def truncation_rank(s: np.ndarray, maxdim=None, cutoff=None) -> tuple[int, float]:
    """Number of singular values to keep and the truncation error (the
    discarded fraction of sum(s^2)); `s` sorted descending."""
    s = np.asarray(s, dtype=np.float64)
    p = s * s
    total = float(p.sum())
    n = len(s)
    keep = n
    if total > 0.0 and cutoff is not None:
        tail = np.cumsum(p[::-1])[::-1]  # tail[k] = sum(p[k:])
        keep = n
        for k in range(n - 1, 0, -1):
            if tail[k] <= cutoff * total:
                keep = k
            else:
                break
    if maxdim is not None:
        keep = min(keep, int(maxdim))
    keep = max(keep, 1)
    err = 0.0 if total == 0.0 else float(p[keep:].sum() / total)
    return keep, err


def _host_s(s: torch.Tensor) -> np.ndarray:
    host_reads.count += 1
    return s.detach().cpu().numpy()


def _svd_split(t: Tensor, left_inds: Sequence[Index], maxdim, cutoff):
    left_inds = list(left_inds)
    right_inds = [i for i in t.inds if i not in left_inds]
    mat = t.matricize(left_inds, right_inds)
    U, s, Vh = torch.linalg.svd(mat, full_matrices=False)
    keep, err = truncation_rank(_host_s(s), maxdim=maxdim, cutoff=cutoff)
    return left_inds, right_inds, mat, U[:, :keep], s[:keep], Vh[:keep, :], keep, err


def svd(t: Tensor, left_inds: Sequence[Index], maxdim=None, cutoff=None, tag: str = "Link"):
    """Truncated SVD ``t = U S V``: ``(U, S, V, err)`` with a fresh bond
    pair, ``U`` carrying ``u``, ``V`` carrying ``v``, ``S`` on ``(u, v)``."""
    left_inds, right_inds, mat, U, s, Vh, keep, err = _svd_split(t, left_inds, maxdim, cutoff)
    u, v = Index(keep, tag), Index(keep, tag)
    U_t = Tensor(U.reshape([i.dim for i in left_inds] + [keep]), left_inds + [u])
    S_t = Tensor(torch.diag(s.to(mat.dtype)), [u, v])
    V_t = Tensor(Vh.reshape([keep] + [i.dim for i in right_inds]), [v] + right_inds)
    return U_t, S_t, V_t, err


def factorize_svd(t: Tensor, left_inds: Sequence[Index], maxdim=None, cutoff=None, ortho: str = "none",
                  tag: str = "Link"):
    """Two-factor truncated SVD split sharing one new bond index:
    ``ortho="none"`` gives ``U sqrt(S)``, ``sqrt(S) V`` (simple update),
    "left" ``U``, ``S V`` and "right" ``U S``, ``V``.  Returns
    ``(L, R, s_matrix, err)``, ``s_matrix`` the diagonal singular values on
    ``(b, b')``."""
    left_inds, right_inds, mat, U, s, Vh, keep, err = _svd_split(t, left_inds, maxdim, cutoff)
    dt = mat.dtype
    if ortho == "none":
        rs = torch.sqrt(s)
        L, R = U * rs[None, :].to(dt), rs[:, None].to(dt) * Vh
    elif ortho == "left":
        L, R = U, s[:, None].to(dt) * Vh
    elif ortho == "right":
        L, R = U * s[None, :].to(dt), Vh
    else:
        raise ValueError(f"unknown ortho {ortho!r}")
    b = Index(keep, tag)
    L_t = Tensor(L.reshape([i.dim for i in left_inds] + [keep]), left_inds + [b])
    R_t = Tensor(R.reshape([keep] + [i.dim for i in right_inds]), [b] + right_inds)
    S_t = Tensor(torch.diag(s.to(dt)), [b, b.prime()])
    return L_t, R_t, S_t, err


def qr(t: Tensor, left_inds: Sequence[Index], tag: str = "qr"):
    """Reduced QR of `t` with `left_inds` grouped on the Q side."""
    left_inds = list(left_inds)
    right_inds = [i for i in t.inds if i not in left_inds]
    mat = t.matricize(left_inds, right_inds)
    Q, R = torch.linalg.qr(mat, mode="reduced")
    k = Q.shape[1]
    b = Index(k, tag)
    Q_t = Tensor(Q.reshape([i.dim for i in left_inds] + [k]), left_inds + [b])
    R_t = Tensor(R.reshape([k] + [i.dim for i in right_inds]), [b] + right_inds)
    return Q_t, R_t


def factorize(t: Tensor, left_inds: Sequence[Index], ortho="left", maxdim=None, cutoff=None, tag="Link"):
    """General split ``t = L * R`` with `L` on `left_inds`: QR without
    truncation, the truncated SVD with `maxdim`/`cutoff`; ``ortho`` picks
    the orthonormal side."""
    left_inds = list(left_inds)
    if maxdim is None and cutoff in (None, 0, 0.0):
        if ortho == "left":
            return qr(t, left_inds, tag=tag)
        if ortho != "right":
            raise ValueError(f"unknown ortho {ortho!r}")
        right_inds = [i for i in t.inds if i not in left_inds]
        Q, R = qr(t, right_inds, tag=tag)
        return R, Q
    L, R, _, _ = factorize_svd(t, left_inds, maxdim=maxdim, cutoff=cutoff, ortho=ortho, tag=tag)
    return L, R


def eigh_matrix(mat: torch.Tensor, safe: bool = True):
    """Hermitian eig of a 2D tensor, 32-bit input promoted to 64-bit when
    `safe` (`safe_eigen`), on the tensor's device."""
    orig_dtype = mat.dtype
    work = mat
    if safe and orig_dtype in (torch.float32, torch.complex64):
        work = mat.to(torch.complex128 if orig_dtype == torch.complex64 else torch.float64)
    w, U = torch.linalg.eigh(work)
    return w, U, orig_dtype


def _eigh(t: Tensor, safe: bool = True):
    if t.ndim != 2:
        raise ValueError("eigh expects a 2-index tensor")
    l = next(i for i in t.inds if i.plev == min(j.plev for j in t.inds))
    lp = next(i for i in t.inds if i != l)
    w, U, orig_dtype = eigh_matrix(t.matricize([l], [lp]), safe=safe)
    e = Index(U.shape[1], "eig")
    return w, Tensor(U.to(orig_dtype), [l, e]), lp, e


def eigh(t: Tensor, safe: bool = True):
    """Hermitian eigendecomposition of ``m(l, l')``: ``(w, U, l', e)``, `w`
    host numpy, ``m = U diag(w) U^dag``."""
    w, U_t, lp, e = _eigh(t, safe=safe)
    return w.detach().cpu().numpy(), U_t, lp, e


def map_eigs(t: Tensor, f, safe: bool = True, hermitian_result: bool = True) -> Tensor:
    """Apply the host function `f` to each eigenvalue of hermitian ``m(l, l')``."""
    w, U, lp, e = eigh(t, safe=safe)
    fw = np.asarray([f(x) for x in w])
    dtype = t.data.dtype
    if np.iscomplexobj(fw) and not dtype.is_complex:
        dtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    mid = torch.as_tensor(fw, device=U.device).to(dtype)
    Ud = U.data.to(dtype)
    data = (Ud * mid[None, :]) @ Ud.conj().T
    return Tensor(data.to(dtype), [t.inds[t.axis(U.inds[0])], lp])


def pseudo_sqrt_inv_sqrt(m: Tensor, cutoff: float | None = None):
    """Pseudo square root and inverse square root of a hermitian 2-index
    tensor, eigenvalues below `cutoff` zeroed: ``(sqrt_m, inv_sqrt_m)``."""
    if cutoff is None:
        single = m.data.dtype in (torch.float32, torch.complex64)
        cutoff = 10 * float(np.finfo(np.float32 if single else np.float64).eps)
    w, U, lp, e = _eigh(m)
    w = w.real.to(torch.float64)
    ok = torch.abs(w) >= cutoff
    sq = torch.where(ok, torch.sqrt(torch.clamp(w, min=0.0)), torch.zeros_like(w))
    isq = torch.where(sq > 0, 1.0 / torch.clamp(sq, min=1e-300), torch.zeros_like(sq))
    dtype = m.data.dtype
    Ud = U.data
    Uh = Ud.conj().T
    sqrt_data = (Ud * sq[None, :].to(dtype)) @ Uh
    isq_data = (Ud * isq[None, :].to(dtype)) @ Uh
    l = U.inds[0]
    return Tensor(sqrt_data.to(dtype), [l, lp]), Tensor(isq_data.to(dtype), [l, lp])


def map_diag(t: Tensor, f) -> Tensor:
    """Apply the host function `f` to the diagonal of a 2-index tensor."""
    if t.ndim != 2:
        raise ValueError("map_diag expects a 2-index tensor")
    d = torch.diagonal(t.data)
    new_d = torch.as_tensor(np.asarray([f(x) for x in d.detach().cpu().numpy()]), device=t.device).to(t.dtype)
    return Tensor(t.data - torch.diag(d) + torch.diag(new_d), t.inds)
