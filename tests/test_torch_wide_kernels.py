"""K1's and K2's plain versions past n = 128 against the JAX kernels.

On a CPU tensor the wrappers run the plain versions, which the CUDA kernels
are held to on the card (`chip_smoke.py`); here the plain versions meet the
JAX Pallas kernels run in interpret mode at the widths of the chi = 96 and
chi = 128 thetas, with the tolerances of the n <= 64 tests in
`tests/test_torch_ops.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnqs.ops.jacobi import jacobi_eigh as j_jacobi_eigh
from tnqs.ops.osj import osj_svd as j_osj_svd

from tnqs_torch.ops import jacobi, osj

import torch_wide_cases  # noqa: F401  (numpy's BLAS on one thread in the process)

torch.set_num_threads(1)


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [192, 256])
def test_jacobi_eigh_wide_plain_matches_jax_interpret(n):
    rng = np.random.default_rng(n)
    A = _rand_c(rng, (1, n, n))
    H = 0.5 * (A + np.swapaxes(A.conj(), -1, -2))
    calls = jacobi._jacobi_eigh_plain.calls
    w_j, _ = j_jacobi_eigh(jnp.asarray(H), sweeps=8, interpret=True)
    w, V = jacobi.jacobi_eigh(torch.as_tensor(H), sweeps=8, relative=False)
    assert jacobi._jacobi_eigh_plain.calls == calls + 1
    w, V = w.numpy(), V.numpy()
    scale = np.max(np.abs(np.linalg.eigvalsh(H)))
    # the same schedule and skip, float32 rounding in another order; the
    # refined eigenvalues agree to a few ulps of the spectral norm (before
    # convergence, at 2 sweeps, the two diverge by ~2e-2: the schedule
    # amplifies rounding until the rotations settle)
    assert np.max(np.abs(w - np.asarray(w_j))) < 1e-5 * scale
    assert np.all(np.diff(w, axis=1) >= 0)
    resid = np.einsum("bij,bjk->bik", H, V) - V * w[:, None, :]
    assert np.max(np.abs(resid)) < 1e-5 * scale


@pytest.mark.parametrize("R, n", [(384, 192), (512, 256)])
def test_osj_svd_wide_plain_matches_jax_interpret(R, n):
    """The polish as `pjsvd` runs it: both packages get the same warm start
    (B0 = A V0 from a float64 eigenbasis of the Gram), 2 sweeps."""
    rng = np.random.default_rng(R + n)
    A = _rand_c(rng, (1, R, n)) * np.geomspace(1.0, 1e-3, n).astype(np.float32)
    G = np.einsum("bki,bkj->bij", A.conj(), A).astype(np.complex128)
    V0 = np.linalg.eigh(G)[1][:, :, ::-1].astype(np.complex64)
    B0 = np.einsum("bij,bjk->bik", A, V0).astype(np.complex64)
    _, s_j, _ = j_osj_svd(jnp.asarray(B0), jnp.asarray(V0), sweeps=2, interpret=True)
    U, s, Vh = (x.numpy() for x in osj.osj_svd(torch.as_tensor(B0), torch.as_tensor(V0), sweeps=2))
    s_j = np.asarray(s_j)
    s0 = np.linalg.svd(A.astype(np.complex128), compute_uv=False)
    assert np.max(np.abs(s - s_j) / s_j[:, :1]) < 1e-5
    assert np.max(np.abs(s - s0) / s0[:, :1]) < 1e-5
    rec = np.einsum("bij,bj,bjk->bik", U, s, Vh)
    assert np.max(np.abs(rec - A)) < 3e-5 * s0[0, 0]
