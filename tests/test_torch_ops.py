"""tnqs_torch factorizations against tnqs and LAPACK on the CPU.

On a CPU tensor each kernel wrapper runs the kernel's plain PyTorch
version (the same rotation schedule), so these tests hold that version
against the JAX Pallas kernels run in interpret mode, as `tests/test_ops.py`
runs them.  The CUDA kernels themselves are checked on the card by
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnqs.engine import _cholesky_gauge_roots as j_gauge_roots
from tnqs.ops.factorizations import cholesky_qr as j_cholesky_qr
from tnqs.ops.jacobi import jacobi_eigh as j_jacobi_eigh
from tnqs.ops.osj import osj_svd as j_osj_svd

from tnqs_torch.engine import _cholesky_gauge_roots
from tnqs_torch.ops import cholesky_qr, jacobi, osj

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("n, refine", [(32, True), (64, True), (32, False)])
def test_jacobi_eigh_plain_matches_jax_interpret(n, refine):
    rng = np.random.default_rng(n)
    A = _rand_c(rng, (2, n, n))
    H = 0.5 * (A + np.swapaxes(A.conj(), -1, -2))
    w_j, _ = j_jacobi_eigh(jnp.asarray(H), sweeps=8, interpret=True, refine=refine)
    w, V = jacobi.jacobi_eigh(torch.as_tensor(H), sweeps=8, refine=refine, relative=False)
    w, V = w.numpy(), V.numpy()
    scale = np.max(np.abs(np.linalg.eigvalsh(H)))
    # same schedule and skip, float32 rounding in another order: eigenvalues (Rayleigh
    # quotients, or the rotated diagonal without refinement) agree to a few
    # ulps of the spectral norm
    assert np.max(np.abs(w - np.asarray(w_j))) < 1e-5 * scale
    assert np.all(np.diff(w, axis=1) >= 0)
    if refine:
        # the refined eigenpairs are float32-accurate (LAPACK-f32 class ~1e-6)
        resid = np.einsum("bij,bjk->bik", H, V) - V * w[:, None, :]
        assert np.max(np.abs(resid)) < 1e-5 * scale


@pytest.mark.parametrize("n", [32, 64])
def test_jacobi_eigh_relative_skip_is_scale_free(n):
    """The relative skip takes the same rotations at any power-of-two scale
    of H, so the eigenpairs scale bit for bit, and a graded PSD Gram's small
    eigenvalues keep their relative accuracy; the reference's absolute skip
    leaves them unconverged once the Gram is small."""
    rng = np.random.default_rng(n + 3)
    A = torch.as_tensor(_rand_c(rng, (2, 3 * n // 2, n))) * torch.as_tensor(
        np.geomspace(1.0, 1e-3, n).astype(np.float32))
    G = A.mH @ A
    c = 2.0**-12
    w64 = torch.linalg.eigvalsh((G * c).to(torch.complex128))
    small = {}
    for relative in (True, False):
        w, V = jacobi.jacobi_eigh(G, relative=relative)
        ws, Vs = jacobi.jacobi_eigh(G * c, relative=relative)
        if relative:
            assert torch.equal(Vs, V) and torch.equal(ws, w * c)
        small[relative] = ((ws.double() - w64).abs() / w64.abs())[:, :8].max().item()
    assert small[True] < 1e-5 < 1e-2 < small[False]


def test_osj_svd_cold_plain_matches_jax_interpret():
    rng = np.random.default_rng(7)
    A = _rand_c(rng, (3, 32, 32))
    _, s_j, _ = j_osj_svd(jnp.asarray(A), sweeps=10, interpret=True)
    U, s, Vh = (x.numpy() for x in osj.osj_svd(torch.as_tensor(A), sweeps=10))
    s_j = np.asarray(s_j)
    # same schedule: singular values agree far inside the cold-start
    # rotation-cascade floor (~1.2e-5 of s_max at n=32, tests/test_ops.py:251)
    assert np.max(np.abs(s - s_j) / s_j[:, :1]) < 1e-5
    rec = np.einsum("bij,bj,bjk->bik", U, s, Vh)
    assert np.max(np.abs(rec - A)) < 3e-5


def _families(n):
    """The spectrum families of tests/test_ops.py:208-217, scaled to n
    singular values (the cut families cut at n/2)."""
    h = n // 2
    return {
        "gentle": np.geomspace(1.0, 1e-2, n),
        "wide": np.geomspace(1.0, 1e-4, n),
        "rank16": np.geomspace(1.0, 1e-2, 16),
        "rankcut": np.concatenate([np.geomspace(1.0, 1e-6, h), np.zeros(h)]),
        "clusters": np.concatenate([np.ones(h), np.full(h, 1e-6)]),
    }


@pytest.mark.parametrize("family", list(_families(64)))
@pytest.mark.parametrize("R", [128, 64], ids=["128x64", "64x64"])
def test_pjsvd_graded_accuracy(R, family):
    rng = np.random.default_rng(R)
    n, k = 64, 32
    spectrum = _families(n)[family]
    A = []
    for _ in range(2):
        s = np.zeros(n)
        s[: len(spectrum)] = spectrum
        U, _ = np.linalg.qr(rng.normal(size=(R, n)) + 1j * rng.normal(size=(R, n)))
        V, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        A.append((U * s[None, :]) @ V.conj().T)
    A = np.stack(A).astype(np.complex64)
    polish = 6 if R != n else 4  # the engine's routing, tnqs/engine.py:1246
    U, s, Vh = (x.numpy() for x in osj.pjsvd(torch.as_tensor(A), polish_sweeps=polish))
    assert np.isfinite(U).all() and np.isfinite(s).all() and np.isfinite(Vh).all()
    U0, s0, Vh0 = np.linalg.svd(A.astype(np.complex128), full_matrices=False)
    rec = np.einsum("bij,bj,bjk->bik", U[:, :, :k], s[:, :k], Vh[:, :k, :])
    best = np.einsum("bij,bj,bjk->bik", U0[:, :, :k], s0[:, :k], Vh0[:, :k, :])
    # the bounds of tests/test_ops.py:235-237: LAPACK-f32-class truncated factors
    recon = np.max(np.linalg.norm((rec - best).reshape(2, -1), axis=1) / s0[:, 0])
    assert recon < 3e-5, f"truncated reconstruction {recon:.2e}"
    assert np.max(np.abs(s - s0) / s0[:, :1]) < 1e-4
    assert np.all(np.diff(s, axis=1) <= 1e-6)


def test_cholesky_qr_matches_tnqs():
    rng = np.random.default_rng(3)
    A = _rand_c(rng, (3, 256, 32))
    A[:, :, 24:] = 0  # null columns, as padded bonds give
    Q, R = (x.numpy() for x in cholesky_qr(torch.as_tensor(A)))
    Q_j, R_j = (np.asarray(x) for x in j_cholesky_qr(jnp.asarray(A)))
    # the same shifted CholeskyQR2 arithmetic; float32 rounding only
    assert np.max(np.abs(Q - Q_j)) < 1e-5
    assert np.max(np.abs(R - R_j)) < 1e-5 * np.max(np.abs(R_j))
    assert np.max(np.abs(np.einsum("bmr,brn->bmn", Q, R) - A)) < 5e-5


def test_cholesky_gauge_roots_match_tnqs():
    rng = np.random.default_rng(5)
    chi, live = 16, 12
    X = _rand_c(rng, (4, live, live))
    E = np.zeros((4, chi, chi), np.complex64)
    # environments with exactly-null bond directions, as truncated bonds give
    E[:, :live, :live] = np.einsum("bij,bkj->bik", X, X.conj()) / live + 0.1 * np.eye(live)
    L, Winv = (x.numpy() for x in _cholesky_gauge_roots(torch.as_tensor(E), EPS32))
    L_j, Winv_j = (np.asarray(x) for x in j_gauge_roots(jnp.asarray(E), EPS32))
    assert np.max(np.abs(L - L_j)) < 1e-5 * np.max(np.abs(L_j))
    assert np.max(np.abs(Winv - Winv_j)) < 1e-5 * np.max(np.abs(Winv_j))
    assert np.all(Winv[:, :, live:] == 0)  # null directions zeroed


def test_cpu_tensor_takes_the_plain_path():
    rng = np.random.default_rng(9)
    A = torch.as_tensor(_rand_c(rng, (2, 16, 8)))
    launches = (jacobi.jacobi_eigh.launches, osj.osj_svd.launches)
    calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls)
    osj.pjsvd(A)
    assert (jacobi.jacobi_eigh.launches, osj.osj_svd.launches) == launches == (0, 0)
    assert (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    # the kernel launchers take CUDA tensors only; they never fall back
    with pytest.raises(ValueError):
        jacobi._jacobi_eigh_cuda(A.mH @ A, 8)
    with pytest.raises(ValueError):
        osj._osj_svd_cuda(A, torch.eye(8, dtype=A.dtype).expand(2, 8, 8), 4)
    # only a CPU tensor takes the plain version: any other device goes to
    # the kernel launcher, which refuses what is not on a CUDA device
    meta = torch.empty((2, 16, 8), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        jacobi.jacobi_eigh(meta.mH @ meta)
    with pytest.raises(ValueError):
        osj.osj_svd(meta)
    assert (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls) == (calls[0] + 1, calls[1] + 1)


@pytest.mark.parametrize(
    "shape, route",
    [((5, 256, 128), "pjsvd"), ((5, 128, 256), "pjsvd"), ((5, 128, 128), "pjsvd"), ((5, 384, 192), "pjsvd"),
     ((5, 192, 384), "pjsvd"), ((5, 512, 256), "pjsvd"), ((5, 256, 62), "library"), ((5, 516, 258), "pjsvd"),
     ((5, 258, 516), "pjsvd"), ((5, 1024, 256), "pjsvd")],
)
def test_theta_route_holds_the_kernels_shapes(monkeypatch, shape, route):
    """`_theta_svds` sends a theta to `pjsvd` by JAX's gate word for word
    (`tnqs/engine.py:1231-1235`: smaller side even and at least 64, no upper
    limit), decided from the shape before any launch, so meta tensors take
    the card's route; the saturated chi = 96 and chi = 128 thetas take the
    shared-memory kernels, the chi > 128 thetas (smaller side 2 chi) and
    thetas too tall for K1's clusters the L2 variants (`osj.pjsvd_fits`
    holds for all of them), an odd or narrower side the library SVD."""
    import tnqs_torch.engine as pe
    from tnqs_torch.graphs import NamedGraph

    calls = []

    def stub(name):
        def svd(A, **kwargs):
            calls.append((name, tuple(A.shape)))
            B, m, n = A.shape
            k = min(m, n)
            return A.new_empty((B, m, k)), A.real.new_empty((B, k)), A.new_empty((B, k, n))
        return svd

    monkeypatch.setattr(pe, "pjsvd", stub("pjsvd"))
    monkeypatch.setattr(pe, "library_svd", stub("library"))
    eng = pe.LatticeEngine(NamedGraph.from_edges([0, 1], [(0, 1)]), chi=2, device="cpu")
    before = dict(pe._svd_fallback.calls_by_shape)
    theta = torch.empty(shape, dtype=torch.complex64, device="meta")
    (U, s, Vh, _), = eng._theta_svds([theta])
    assert [c[0] for c in calls] == [route]
    assert U.shape == shape[:2] + (min(shape[1:]),) and Vh.shape == (shape[0], min(shape[1:]), shape[2])
    assert pe._svd_fallback.calls_by_shape.get(shape, 0) - before.get(shape, 0) == (route == "library")
    m, n = max(shape[1:]), min(shape[1:])
    assert osj.pjsvd_fits(m, n) == (route == "pjsvd" or n % 2 == 1 or n < 64)
