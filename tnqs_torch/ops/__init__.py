"""Factorizations of the engine's two-site update; the Jacobi kernels live
in `jacobi` (K2) and `osj` (K1), built from `tnqs_torch/csrc` by `_build`."""

from .factorizations import cholesky_qr
from .jacobi import jacobi_eigh
from .osj import osj_svd, pjsvd

__all__ = ["cholesky_qr", "jacobi_eigh", "osj_svd", "pjsvd"]
