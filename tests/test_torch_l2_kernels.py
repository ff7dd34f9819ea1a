"""K1's and K2's plain versions past n = 256 against the JAX kernels.

On a CPU tensor the wrappers run the plain versions, which the L2 variants
of the CUDA kernels are held to on the card (`chip_smoke.py`); here the
plain versions meet the JAX Pallas kernels run in interpret mode at the
widths of the chi = 160 thetas and the thermal path's (320 and 512), at
batch 1 and two sweeps, with the tolerances of
`tests/test_torch_wide_kernels.py`."""

import functools

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


@functools.cache
def _near_diagonal(n):
    """A Hermitian [1, n, n] that two sweeps converge: eigenvalues spread
    evenly over [1, 2] plus a perturbation of about 1e-2 of their gaps; and
    JAX's eigenvalues of it (the reference kernel has the absolute skip
    only)."""
    rng = np.random.default_rng(n)
    E = _rand_c(rng, (1, n, n))
    H = (np.diag(np.linspace(1.0, 2.0, n)) + 1e-2 / n * 0.5 * (E + np.swapaxes(E.conj(), -1, -2)))
    H = H.astype(np.complex64)
    w_j, _ = j_jacobi_eigh(jnp.asarray(H), sweeps=2, interpret=True)
    return H, np.asarray(w_j)


@pytest.mark.parametrize("n, relative", [(320, False), (320, True), (512, False)])
def test_jacobi_eigh_l2_plain_matches_jax_interpret(n, relative):
    """The absolute skip is JAX's own; the port's relative skip, on the same
    converging input, reaches the same eigenpairs."""
    H, w_j = _near_diagonal(n)
    calls = jacobi._jacobi_eigh_plain.calls
    w, V = jacobi.jacobi_eigh(torch.as_tensor(H), sweeps=2, relative=relative)
    assert jacobi._jacobi_eigh_plain.calls == calls + 1
    w, V = w.numpy(), V.numpy()
    scale = np.max(np.abs(np.linalg.eigvalsh(H)))
    assert np.max(np.abs(w - w_j)) < 1e-5 * scale
    assert np.all(np.diff(w, axis=1) >= 0)
    resid = np.einsum("bij,bjk->bik", H, V) - V * w[:, None, :]
    assert np.max(np.abs(resid)) < 1e-5 * scale


@pytest.mark.parametrize("R, n", [(640, 320), (512, 512)])
def test_osj_svd_l2_plain_matches_jax_interpret(R, n):
    """The polish as `pjsvd` runs it, on a warm start of its kind (B0 = A V0,
    V0 the Gram's eigenbasis, here a float64 one, so that both packages get
    the same), 2 sweeps, to 1e-5 of s_max."""
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
