"""Batched factorizations of the engine's two-site update.

Port of `tnqs/ops/factorizations.py`:

* `cholesky_qr` (`:38`) — shifted CholeskyQR2 of the tall gauged sides;
* `gram_rfactor` / `apply_rinv` (`:70`, `:114`) — the Q-free R factor of a
  tall side from its Gram matrix alone, for ``reduce_method="gram_nofactor"``;
* `default_eigh` (`:121`) — the Hermitian eigensolver of the eigh gauge and
  the Gram truncations, routed to K2 (`jacobi.jacobi_eigh`) or the library;
* `library_eigh` / `library_svd` — the library's eigh and thin SVD with
  JAX's answer, NaN, for a batch member that holds a non-finite entry;
* `gram_svd` (`:132`) — the thin SVD from the smaller-side Gram's eigh;
* `subspace_eigh` (`:166`) — the top eigenpairs of a PSD Gram by randomized
  subspace iteration and a Rayleigh–Ritz solve.

Every Cholesky goes through `cholesky_nan`: a failed factorization turns
into NaN, as JAX returns it, instead of raising.
"""

from __future__ import annotations

import numpy as np
import torch

from .jacobi import jacobi_eigh


def eps_of(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype.to_real() if dtype.is_complex else dtype).eps)


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each hermitian matrix of A [..., n, n], NaN
    where its factorization fails, as `jnp.linalg.cholesky` returns it.  A
    bare `cholesky_ex` hands back LAPACK's partial factor there, finite and
    wrong, and the engine would go on with it.  In place on the factor, so
    the main path's peak memory holds no second copy."""
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill_((info != 0)[..., None, None], float("nan"))


def _shifted_chol(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of H + (8 eps tr(H) + eps^2) I: the small
    trace-relative shift keeps it positive definite on exactly-null
    directions while moving live eigenvalues by O(eps) ||H|| only."""
    eps = eps_of(H.dtype)
    tr = torch.diagonal(H, dim1=-2, dim2=-1).real.sum(-1)[..., None, None]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return cholesky_nan(H + ((8.0 * eps) * tr + eps * eps) * eye)


def cholesky_qr(A: torch.Tensor, rounds: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR of A [..., m, n] (m >= n) by shifted CholeskyQR^rounds.

    Returns (Q [..., m, n], R [..., n, n]) with A ~= Q @ R.  The shift of
    `_shifted_chol` keeps the Cholesky positive definite on the
    exactly-null columns the padded engine produces; Q then picks an
    arbitrary orthonormal completion there and R carries near-zero rows."""
    R_total = None
    Q = A
    for _ in range(rounds):
        L = _shifted_chol(Q.mH @ Q)  # G = L L^H
        Q = torch.linalg.solve_triangular(L.mH, Q, upper=True, left=False)  # Q L^{-H}
        Rk = L.mH
        R_total = Rk if R_total is None else Rk @ R_total
    return Q, R_total


def gram_rfactor(G: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """R factor of a tall X from its Gram matrix G = X^H X alone: shifted
    CholeskyQR2 in Gram space (`tnqs/ops/factorizations.py:70`).  Round 1
    factors G = L1 L1^H; round 2 factors the implicit Q1 = X L1^{-H}'s
    Gram G2 = L1^{-1} G L1^{-H}, so R = L2^H L1^H makes X R^{-1}
    orthonormal to CholeskyQR2 accuracy while every operation is [n, n].

    Returns (R upper [..., n, n], L1 lower, L2 lower).  Null columns of X
    get ~sqrt(shift) rows in R, which the truncation discards."""
    L1 = _shifted_chol(G)
    Y = torch.linalg.solve_triangular(L1, G, upper=False)  # L1^{-1} G
    G2 = torch.linalg.solve_triangular(L1, Y.mH, upper=False)  # L1^{-1} G L1^{-H}
    G2 = 0.5 * (G2 + G2.mH)
    L2 = _shifted_chol(G2)
    return L2.mH @ L1.mH, L1, L2


def apply_rinv(L1: torch.Tensor, L2: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """R^{-1} @ B for R = L2^H L1^H from `gram_rfactor`: two small
    triangular solves (L2^H y = B, then L1^H x = y)."""
    y = torch.linalg.solve_triangular(L2.mH, B, upper=True)
    return torch.linalg.solve_triangular(L1.mH, y, upper=True)


def default_eigh(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of hermitian H [..., n, n]: (w ascending, V), the
    `torch.linalg.eigh` contract.

    The route is keyed on the tensor, before any launch: complex64 with
    even 32 <= n <= 256, the JAX gate (`tnqs/ops/factorizations.py:125`),
    takes `jacobi_eigh` at its default 12 sweeps and scale-relative skip
    (K2 on a CUDA tensor, its resident variant past n = 128; its plain version
    on a CPU tensor); everything else takes `torch.linalg.eigh`.  The
    relative skip departs from the JAX kernel's absolute one, with which the
    Gram truncation broke down on the chi=64 Eagle run (`jacobi_eigh`).
    Complex128 departs from the JAX gate, which computes it in float32
    planes on the kernel: it goes to the library, which keeps it in double
    precision.  Library calls are counted in `default_eigh.library_calls`."""
    n = H.shape[-1]
    if H.dtype == torch.complex64 and n % 2 == 0 and 32 <= n <= 256:
        return jacobi_eigh(H)
    default_eigh.library_calls += 1
    return library_eigh(H)


default_eigh.library_calls = 0


def _finite_members(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A [..., m, n] with every batch member that holds a non-finite entry
    replaced by the identity, and the mask [...] of those members."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-2], A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(bad[..., None, None], eye, A), bad


def _nan_members(bad: torch.Tensor, *outs: torch.Tensor) -> tuple:
    """Each output with NaN written into the batch members `bad` marks."""
    return tuple(torch.where(bad.reshape(bad.shape + (1,) * (x.dim() - bad.dim())), float("nan"), x) for x in outs)


def library_eigh(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`torch.linalg.eigh(H)`, with NaN in both outputs of every batch member
    that holds a non-finite entry, as `jnp.linalg.eigh` returns them: the
    library raises on such input.  Those members are solved as the identity
    and then overwritten, so the other members' results are bit for bit the
    library's, and no value is read back to the host to decide."""
    Hs, bad = _finite_members(H)
    return _nan_members(bad, *torch.linalg.eigh(Hs))


def library_svd(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The library's batched thin SVD (U, s, Vh) of A [..., m, n], NaN for a
    non-finite batch member as in `library_eigh`: LAPACK's on the CPU, and on
    the card cuSOLVER's ``gesvd``, the QR-iteration method of LAPACK's
    accuracy class.  torch's default there, ``gesvdj``, stops its Jacobi
    sweeps at a tolerance that leaves float32 thetas measurably less
    accurate: the library route's Eagle chi=64 trajectory then leaves the
    main path's bound (`PERF.md`)."""
    As, bad = _finite_members(A)
    return _nan_members(bad, *torch.linalg.svd(As, full_matrices=False, driver="gesvd" if A.is_cuda else None))


def svd_from_eigh(A: torch.Tensor, w: torch.Tensor, V: torch.Tensor):
    """The SVD algebra of an eigendecomposition (w ascending, V) of A's
    smaller-side Gram (`tnqs/ops/factorizations.py:144-163`): s = sqrt(w)
    descending, and the other side's vectors as A's image over s, with
    s <= 8 eps smax cut to zero.  Returns (U, s, Vh)."""
    eps = eps_of(A.dtype)
    w, V = w.real.flip(-1), V.flip(-1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    inv = torch.where(s > (eps * 8.0) * s[..., :1], 1.0 / torch.where(s > 0, s, 1.0), 0.0).to(A.dtype)
    if A.shape[-2] <= A.shape[-1]:
        return V, s, inv[..., :, None] * (V.mH @ A)
    return (A @ V) * inv[..., None, :], s, V.mH


def gram_svd(A: torch.Tensor, eigh_fn=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD of A [..., m, n] by eigh of the smaller-side Gram matrix
    (`tnqs/ops/factorizations.py:132`).  Returns (U [..., m, k], s [..., k]
    descending, Vh [..., k, n]) with k = min(m, n); `eigh_fn` defaults to
    `default_eigh`.  Singular values below ~sqrt(eps) smax lose relative
    accuracy: the tail the engine truncates anyway."""
    if eigh_fn is None:
        eigh_fn = default_eigh
    G = A @ A.mH if A.shape[-2] <= A.shape[-1] else A.mH @ A
    return svd_from_eigh(A, *eigh_fn(G))


def subspace_eigh(k: int, oversample: int = 8, iters: int = 2, seed: int = 23):
    """Top-(k + oversample) eigenpairs of hermitian PSD batches by randomized
    subspace iteration and Rayleigh–Ritz (`tnqs/ops/factorizations.py:166`).

    Returns ``G [B, n, n] -> (w [B, m] ascending, V [B, n, m], tail [B])``
    with m = min(n, k + oversample) and `tail` the non-negative weight
    tr(G) - sum(w) the subspace missed, in float32 as JAX keeps it.  The
    probe omega is drawn as JAX draws it, numpy ``default_rng(seed)``,
    float32 real then imaginary ``standard_normal((n, m))``, so both
    packages take the same subspace.  The m-dim Rayleigh–Ritz solve goes
    through `default_eigh` at m >= 64 (K2 at m = 72 for chi = 64) and the
    library below, as in JAX."""

    def solve(G: torch.Tensor):
        B, n, _ = G.shape
        m = min(n, k + oversample)
        if m >= n:
            w, V = default_eigh(G)
            return w, V, torch.zeros((B,), dtype=torch.float32, device=G.device)
        rng = np.random.default_rng(seed)
        om_re = rng.standard_normal((n, m)).astype(np.float32)
        om_im = rng.standard_normal((n, m)).astype(np.float32)
        omega = torch.complex(torch.from_numpy(om_re), torch.from_numpy(om_im)).to(G.device, G.dtype)
        Y = G @ omega
        for _ in range(iters):
            Q, _ = cholesky_qr(Y)
            Y = G @ Q
        Q, _ = cholesky_qr(Y)
        H = Q.mH @ G @ Q
        H = 0.5 * (H + H.mH)
        w, S = default_eigh(H) if m >= 64 else torch.linalg.eigh(H)
        tr = torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1)
        tail = torch.clamp(tr - w.real.sum(1), min=0.0).to(torch.float32)
        return w, Q @ S, tail

    return solve
