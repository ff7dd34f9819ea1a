"""Shared by `tests/test_torch_wide_pjsvd.py` and
`tests/test_torch_wide_pjsvd_chi128.py`: `pjsvd` on one matrix of each
spectrum family of `test_pjsvd_graded_accuracy` (`tests/test_torch_ops.py`)
at a wide theta shape, held to LAPACK by the graded bounds of
`tests/test_ops.py:235-237`.  Importing it holds numpy's BLAS to one
thread in the process (`BLAS_LIMIT`)."""

import functools

import numpy as np
import torch
from threadpoolctl import threadpool_limits

from tnqs_torch.ops import jacobi, osj

torch.set_num_threads(1)
# numpy's BLAS on one thread in every process that imports this module, as
# every worker of the suite does when it collects the port's tests: under the
# suite's 6 workers OpenBLAS's idle threads spin on the shared cores and slow
# every test, the JAX package's too (torch's are held to one above).  A
# pytest run that collects no port test leaves OpenBLAS its own threads
# (ROADMAP.md, "Suite budget")
BLAS_LIMIT = threadpool_limits(limits=1, user_api="blas")

FAMILIES = ("gentle", "wide", "rank16", "rankcut", "clusters")


def _spectrum(family, n):
    h = n // 2
    return {
        "gentle": np.geomspace(1.0, 1e-2, n),
        "wide": np.geomspace(1.0, 1e-4, n),
        "rank16": np.geomspace(1.0, 1e-2, 16),
        "rankcut": np.concatenate([np.geomspace(1.0, 1e-6, h), np.zeros(h)]),
        "clusters": np.concatenate([np.ones(h), np.full(h, 1e-6)]),
    }[family]


@functools.cache
def _run(R, n, families):
    """One matrix of each of `families` in one `pjsvd` call, as the engine
    batches a class of thetas (6 polish sweeps: rectangular), and LAPACK's
    SVD."""
    rng = np.random.default_rng(R + n + FAMILIES.index(families[0]))
    A = []
    for family in families:
        s = np.zeros(n)
        spec = _spectrum(family, n)
        s[: len(spec)] = spec
        U, _ = np.linalg.qr(rng.normal(size=(R, n)) + 1j * rng.normal(size=(R, n)))
        V, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        A.append((U * s[None, :]) @ V.conj().T)
    A = np.stack(A).astype(np.complex64)
    calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls)
    out = tuple(x.numpy() for x in osj.pjsvd(torch.as_tensor(A), polish_sweeps=6))
    assert (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    return A, out, np.linalg.svd(A.astype(np.complex128), full_matrices=False)


def check_family(R, n, family, families=FAMILIES):
    """The graded bounds for `family`'s matrix of the batch of `families`."""
    b = families.index(family)
    assert osj.pjsvd_fits(R, n)  # the engine's route at this shape
    A, (U, s, Vh), (U0, s0, Vh0) = _run(R, n, families)
    U, s, Vh, U0, s0, Vh0 = (x[b] for x in (U, s, Vh, U0, s0, Vh0))
    assert np.isfinite(U).all() and np.isfinite(s).all() and np.isfinite(Vh).all()
    k = n // 2  # the bond, chi
    rec = (U[:, :k] * s[:k]) @ Vh[:k]
    best = (U0[:, :k] * s0[:k]) @ Vh0[:k]
    # the bounds of tests/test_ops.py:235-237: LAPACK-f32-class truncated factors
    recon = np.linalg.norm(rec - best) / s0[0]
    assert recon < 3e-5, f"truncated reconstruction {recon:.2e}"
    assert np.max(np.abs(s - s0) / s0[0]) < 1e-4
    assert np.all(np.diff(s) <= 1e-6)
