"""Factorizations of the engine's two-site update and its BP sweep; the
kernels live in `jacobi` (K2), `osj` (K1) and `bp_sweep` (K3), built from
`tnqs_torch/csrc` by `_build`."""

from .bp_sweep import bp_sweep_group
from .factorizations import cholesky_qr
from .jacobi import jacobi_eigh
from .osj import osj_svd, pjsvd

__all__ = ["bp_sweep_group", "cholesky_qr", "jacobi_eigh", "osj_svd", "pjsvd"]
