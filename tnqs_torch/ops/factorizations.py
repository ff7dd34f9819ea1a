"""Shifted CholeskyQR2 for the engine's tall gauged sides.

Port of `tnqs/ops/factorizations.py::cholesky_qr` (`:38`).  The Gram-space
R factor (`gram_rfactor`, `apply_rinv`) serves the opt-in
``reduce_method="gram_nofactor"`` path and is not ported yet.
"""

from __future__ import annotations

import torch


def eps_of(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype.to_real() if dtype.is_complex else dtype).eps)


def cholesky_qr(A: torch.Tensor, rounds: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR of A [..., m, n] (m >= n) by shifted CholeskyQR^rounds.

    Returns (Q [..., m, n], R [..., n, n]) with A ~= Q @ R.  A small
    trace-relative shift keeps the Cholesky positive definite on the
    exactly-null columns the padded engine produces; Q then picks an
    arbitrary orthonormal completion there and R carries near-zero rows.
    The Cholesky is unchecked (`cholesky_ex`): a failure shows up as
    non-finite values downstream, as JAX's NaN does, instead of raising."""
    n = A.shape[-1]
    eps = eps_of(A.dtype)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    R_total = None
    Q = A
    for _ in range(rounds):
        G = Q.mH @ Q
        tr = torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1)[..., None, None]
        shift = (8.0 * eps) * tr + eps * eps
        L = torch.linalg.cholesky_ex(G + shift * eye).L  # G = L L^H
        Q = torch.linalg.solve_triangular(L.mH, Q, upper=True, left=False)  # Q L^{-H}
        Rk = L.mH
        R_total = Rk if R_total is None else Rk @ R_total
    return Q, R_total
