"""The engine's switches in tnqs_torch against tnqs on the CPU, from identical
inputs: the factorizations of `tnqs/ops/factorizations.py`, the helpers
of the eigh gauge and the Gram truncations, and 2-layer kicked-Ising runs
on heavy_hexagonal_lattice(2, 2) with every switch value the port took from
the JAX engine.

Inputs are made with numpy and carried into both packages as arrays.  On
the CPU the JAX engine's `default_eigh` is LAPACK's, and the port's sends
complex64 with even 32 <= n <= 256 to the plain version of its Jacobi
kernel, so the K2 route runs here as it runs on the card, in PyTorch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tnqs
import tnqs.models
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.engine import _pseudo_sqrt_roots as jax_pseudo_sqrt_roots
from tnqs.engine import _truncate_mask as jax_truncate_mask
from tnqs.engine import compile_circuit as jax_compile_circuit
from tnqs.ops import factorizations as jf

import tnqs_torch as tt
from tnqs_torch.engine import (
    LatticeEngine,
    _ClassData,
    _pseudo_sqrt_roots,
    _svd_fallback,
    _truncate_mask,
    compile_circuit,
)
from tnqs_torch.ops import factorizations as pf
from tnqs_torch.ops import jacobi, osj

torch.set_num_threads(1)

LAYER = dict(J=np.pi / 4, theta_h=0.4)
C64, C128 = (np.complex64, torch.complex64), (np.complex128, torch.complex128)


def _rand_c(rng, shape, dtype=np.complex64):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)


def _hh22():
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    return g, tt.NamedGraph.from_edges(g.vertices(), g.edges())


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b)))


# ----------------------------------------------------------------------
# factorizations (`tnqs/ops/factorizations.py`)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtypes, tol", [(C64, 1e-5), (C128, 1e-12)], ids=["complex64", "complex128"])
def test_gram_rfactor_and_apply_rinv_match_jax(dtypes, tol):
    np_dtype, _ = dtypes
    rng = np.random.default_rng(3)
    X = _rand_c(rng, (3, 512, 32), np_dtype)
    X[:, :, 24:] = 0  # null columns, as a padded bond gives them
    G = np.conj(np.swapaxes(X, 1, 2)) @ X
    B = _rand_c(rng, (3, 32, 32), np_dtype)
    R_j, L1_j, L2_j = jf.gram_rfactor(jnp.asarray(G))
    R_p, L1_p, L2_p = pf.gram_rfactor(torch.as_tensor(G))
    assert _rel(R_p.numpy(), R_j) < tol
    assert _rel(pf.apply_rinv(L1_p, L2_p, torch.as_tensor(B)).numpy(), jf.apply_rinv(L1_j, L2_j, jnp.asarray(B))) < tol
    # X R^{-1} is orthonormal on the live columns
    Q = X @ pf.apply_rinv(L1_p, L2_p, torch.eye(32, dtype=R_p.dtype).expand(3, 32, 32)).numpy()
    defect = np.conj(np.swapaxes(Q, 1, 2)) @ Q - np.eye(32)
    assert np.max(np.abs(defect[:, :24, :24])) < 1e3 * tol


def test_cholesky_nan_matches_jax():
    """A failed factorization is NaN, as `jnp.linalg.cholesky` returns it,
    where a bare `cholesky_ex` gives LAPACK's partial factor."""
    rng = np.random.default_rng(4)
    A = _rand_c(rng, (3, 8, 8))
    H = A @ np.conj(np.swapaxes(A, 1, 2)) + 0.1 * np.eye(8, dtype=np.complex64)
    H[1] -= 4.0 * np.eye(8, dtype=np.complex64) * np.abs(np.linalg.eigvalsh(H[1])).max()  # indefinite
    L_j = np.asarray(jnp.linalg.cholesky(jnp.asarray(H)))
    L_p = pf.cholesky_nan(torch.as_tensor(H)).numpy()
    lower = np.tril_indices(8)
    assert np.isnan(L_j[1][lower]).all() and np.isnan(L_p[1][lower]).all()
    assert np.isfinite(torch.linalg.cholesky_ex(torch.as_tensor(H)).L.numpy()[1]).all()
    for b in (0, 2):
        assert _rel(L_p[b], L_j[b]) < 1e-6


@pytest.mark.parametrize("mn", [(128, 256), (128, 128), (256, 128), (64, 64)])
def test_gram_svd_matches_lapack(mn):
    """The bars of `tests/test_ops.py:34`."""
    m, n = mn
    rng = np.random.default_rng(1234)
    A = _rand_c(rng, (3, m, n))
    A[:, :, -n // 4 :] = 0
    calls = jacobi._jacobi_eigh_plain.calls
    U, s, Vh = (x.resolve_conj().numpy() for x in pf.gram_svd(torch.as_tensor(A)))
    assert jacobi._jacobi_eigh_plain.calls == calls + 1  # the K2 route, min(m, n) in [32, 256]
    s2 = np.linalg.svd(A, compute_uv=False)
    smax = float(np.max(s2))
    assert np.all(np.diff(s, axis=1) <= 1e-4 * smax)
    assert np.max(np.abs(s - s2)) < 5e-3 * smax
    rec = np.einsum("bmk,bk,bkn->bmn", U, s.astype(U.dtype), Vh)
    assert np.max(np.abs(rec - A)) < 5e-4 * smax


@pytest.mark.parametrize("k", [32, 64])
def test_subspace_eigh_matches_jax(k):
    """The inputs and bars of `tests/test_ops.py:140-167`, port against JAX
    on the same G: the same probe, so the same subspace.  At k = 32 the
    40-dim Rayleigh-Ritz solve takes the library, at k = 64 the 72-dim one
    takes the K2 route."""
    rng = np.random.default_rng(0)
    B, n = 4, 96
    A = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    decay = (0.75 ** np.arange(n))[None, :, None]
    G = ((A * decay.swapaxes(1, 2)) @ (A * decay.swapaxes(1, 2)).conj().swapaxes(1, 2)).astype(np.complex64)
    w_j, _, tail_j = (np.asarray(x) for x in jf.subspace_eigh(k)(jnp.asarray(G)))
    calls = jacobi._jacobi_eigh_plain.calls
    w_p, V_p, tail_p = (x.numpy() for x in pf.subspace_eigh(k)(torch.as_tensor(G)))
    assert jacobi._jacobi_eigh_plain.calls == calls + (k + 8 >= 64)
    assert w_p.shape == w_j.shape == (B, k + 8) and V_p.shape == (B, n, k + 8)
    top_j, top_p = w_j.real[:, ::-1][:, :k], w_p.real[:, ::-1][:, :k]
    assert np.max(np.abs(top_p - top_j) / top_j[:, :1]) < 5e-5
    top_full = np.linalg.eigvalsh(G.astype(np.complex128))[:, ::-1][:, :k]
    assert np.max(np.abs(top_p - top_full) / top_full[:, :1]) < 5e-5
    GV = G @ V_p
    assert np.abs(GV - V_p * w_p.real[:, None, :]).max() / top_full.max() < 1e-4
    tr = np.einsum("bii->b", G).real
    np.testing.assert_allclose(tail_p + w_p.real.sum(1), tr, rtol=1e-4)
    np.testing.assert_allclose(tail_p + w_p.real.sum(1), tail_j + w_j.real.sum(1), rtol=1e-4)


@pytest.mark.parametrize(
    "n, dtypes, route",
    [(30, C64, "library"), (32, C64, "jacobi"), (72, C64, "jacobi"), (128, C64, "jacobi"), (130, C64, "jacobi"),
     (258, C64, "library"), (32, C128, "library")],
    ids=["30-complex64", "32-complex64", "72-complex64", "128-complex64", "130-complex64", "258-complex64",
         "32-complex128"],
)
def test_default_eigh_routes(n, dtypes, route):
    """K2's route for complex64 at even 32 <= n <= 256 (the JAX gate; its
    resident variant past 128), the library's for complex128, n < 32, odd n and
    n > 256; both keep the eigh contract."""
    np_dtype, _ = dtypes
    rng = np.random.default_rng(n)
    A = _rand_c(rng, (2, n, n), np_dtype)
    H = 0.5 * (A + np.conj(np.swapaxes(A, 1, 2)))
    calls, library = jacobi._jacobi_eigh_plain.calls, pf.default_eigh.library_calls
    w, V = (x.numpy() for x in pf.default_eigh(torch.as_tensor(H)))
    assert jacobi._jacobi_eigh_plain.calls - calls == (route == "jacobi")
    assert pf.default_eigh.library_calls - library == (route == "library")
    w_ref = np.linalg.eigvalsh(H.astype(np.complex128))
    scale = np.max(np.abs(w_ref))
    tol = 5e-5 if np_dtype == np.complex64 else 1e-12
    assert np.all(np.diff(w, axis=1) >= 0)
    assert np.max(np.abs(w - w_ref)) < tol * scale
    rec = np.einsum("bik,bk,bjk->bij", V, w.astype(V.dtype), V.conj())
    assert np.max(np.abs(rec - H)) < 10 * tol * scale


@pytest.mark.parametrize("dtypes, tol", [(C64, 1e-5), (C128, 1e-12)], ids=["complex64", "complex128"])
def test_pseudo_sqrt_roots_match_jax(dtypes, tol):
    """The eigh gauge's roots of rank-deficient PSD environments of unit
    trace, as BP keeps them, so the null eigenvalues' rounding stays below
    the cutoff of 10 eps of the real dtype (`tnqs/engine.py:701`)."""
    np_dtype, torch_dtype = dtypes
    rng = np.random.default_rng(6)
    A = _rand_c(rng, (5, 2, 16, 6), np_dtype)
    E = A @ np.conj(np.swapaxes(A, -1, -2))
    E /= np.trace(E, axis1=-2, axis2=-1)[..., None, None]
    cutoff = 10 * float(np.finfo(np.zeros((), np_dtype).real.dtype).eps)
    W_j, Winv_j = jax_pseudo_sqrt_roots(jnp.asarray(E), cutoff)
    W_p, Winv_p = _pseudo_sqrt_roots(torch.as_tensor(E), cutoff)
    assert _rel(W_p.numpy(), W_j) < tol
    assert _rel(Winv_p.numpy(), Winv_j) < 10 * tol
    # W Winv W = W: the pseudo-inverse of the root
    W = W_p.numpy()
    assert _rel(W @ Winv_p.numpy() @ W, W) < 10 * tol


@pytest.mark.parametrize("route", ["svd_fallback", "pseudo_sqrt", "default_eigh"])
def test_library_routes_give_nan_for_a_non_finite_member(route):
    """A batch member with a non-finite entry gives NaN from the library
    routes, as JAX does, where `torch.linalg` raises; every other member's
    result is bit for bit the library's on the finite batch."""
    rng = np.random.default_rng(12)
    if route == "svd_fallback":
        A = torch.as_tensor(_rand_c(rng, (4, 12, 6)))
        fn = _svd_fallback
        clean = torch.linalg.svd(A, full_matrices=False)
    else:
        X = _rand_c(rng, (4, 10, 30))
        A = torch.as_tensor(X @ np.conj(np.swapaxes(X, 1, 2)))  # n = 30: the library route
        if route == "pseudo_sqrt":
            def fn(H):
                return _pseudo_sqrt_roots(H, 1e-6)
        else:
            fn = pf.default_eigh
        clean = fn(A)
    bad = A.clone()
    bad[1, 2, 3] = float("nan")
    out = fn(bad)
    for ref, got in zip(clean, out):
        assert torch.isnan(got[1]).all()
        for i in (0, 2, 3):
            assert torch.equal(got[i], ref[i])


def test_truncate_mask_tail_extra_matches_jax():
    """Weight below the given values (the subspace solver's tail) joins the
    total and every cumulative tail."""
    rng = np.random.default_rng(8)
    s = np.sort(rng.exponential(size=(5, 12)), axis=1)[:, ::-1].astype(np.float32)
    s[2, 6:] = 0
    tail = (rng.exponential(size=5) * 1e-3).astype(np.float32)
    tail[1] = 0
    for chi, cutoff in ((8, 1e-3), (16, 1e-12)):
        out_p = _truncate_mask(torch.as_tensor(s.copy()), chi, cutoff, torch.as_tensor(tail))
        out_j = jax_truncate_mask(jnp.asarray(s), chi, cutoff, tail_extra=jnp.asarray(tail))
        np.testing.assert_array_equal(out_p[1].numpy(), np.asarray(out_j[1]))
        np.testing.assert_array_equal(out_p[0].numpy(), np.asarray(out_j[0]))
        np.testing.assert_allclose(out_p[2].numpy(), np.asarray(out_j[2]), rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def test_auto_switches_follow_the_dtype():
    _, p = _hh22()
    e64 = LatticeEngine(p, chi=4, device="cpu")
    e128 = LatticeEngine(p, chi=4, device="cpu", dtype=torch.complex128)
    assert (e64.svd_impl, e128.svd_impl) == ("pjsvd", "xla")
    assert e128.bp_kernel == "einsum" and e128.real_dtype == torch.float64
    assert e128.sqrt_cutoff == 10 * float(np.finfo(np.float64).eps)
    T, M = e128.to_arrays()
    assert M.dtype == np.complex128 and all(t.dtype == np.complex128 for t in T.values())


def _jax_engine(g, chi, np_dtype, switch):
    """The JAX engine with the port's attribute set: its constructor takes
    `factor_method`; the other switches are attributes (`tnqs/engine.py:
    609-672`), whose CPU defaults (trunc "full", svd "xla") are overridden
    to the port's defaults where the switch leaves them."""
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np_dtype)
    je = JaxEngine(psi, chi=chi, dtype=np_dtype, factor_method=switch.get("factor_method", "gram"),
                   bp_schedule="color")
    je.trunc_method = switch.get("trunc_method", "svd")
    je.env_gauge = switch.get("env_gauge", je.env_gauge)
    je.reduce_method = switch.get("reduce_method", "cholqr2")
    je.svd_impl = switch.get("svd_impl", "xla")
    return je


# (switch, dtypes, chi, which plain kernel runs: (K2, K1), per-gate error floor)
# The error floor is the scale below which a discarded weight is rounding
# noise: the 1e-12 cutoff for an SVD of theta (`tests/test_torch_engine.py`),
# float32 eps for the Gram eigenvalues of "full", and none for "subspace",
# whose tail tr(G) - sum(w) cancels in float32: an absolute 1e-5 there, the
# bar of `tests/test_ops.py:195`.
SWITCHES = [
    (dict(trunc_method="full"), C64, 32, (True, False), float(np.finfo(np.float32).eps)),
    (dict(trunc_method="subspace"), C64, 32, (False, False), None),
    (dict(env_gauge="eigh", svd_impl="xla"), C64, 32, (True, False), 1e-12),
    (dict(svd_impl="xla"), C64, 32, (False, False), 1e-12),
    (dict(factor_method="direct"), C64, 8, (False, False), 1e-12),
    (dict(factor_method="direct"), C128, 8, (False, False), 1e-12),
]


@pytest.mark.parametrize(
    "switch, dtypes, chi, plain, floor",
    SWITCHES,
    ids=["full", "subspace", "eigh-gauge", "svd-xla", "direct-complex64", "direct-complex128"],
)
def test_switch_matches_jax_engine(switch, dtypes, chi, plain, floor):
    """Two kicked-Ising layers from "↑" on hh(2, 2): <Z> within 1e-4 at
    complex64 (`tests/test_torch_engine.py`'s bar) and 1e-8 at complex128,
    per-gate discarded weights within 1e-4 relative above the floor."""
    np_dtype, torch_dtype = dtypes
    g, p = _hh22()
    je = _jax_engine(g, chi, np_dtype, switch)
    T0, M0 = {k: np.asarray(v) for k, v in je.T.items()}, np.asarray(je.M)
    step = je.make_step(tnqs.models.heavy_hex_kicked_ising_layer(g, **LAYER), cutoff=1e-12, bp_maxiter=25)
    e_jax = []
    for _ in range(2):
        je.T, je.M, e = step(je.T, je.M)
        e_jax.append(np.asarray(e))
    z_jax = je.expect_1site("Z")

    pe = LatticeEngine.from_arrays(p, T0, M0, chi=chi, dtype=torch_dtype, device="cpu", bp_schedule="color", **switch)
    calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls)
    e_port = pe.evolve(tt.heavy_hex_kicked_ising_layer(p, **LAYER), num_layers=2, cutoff=1e-12, bp_maxiter=25)
    z_port = pe.expect_1site("Z")
    assert (jacobi._jacobi_eigh_plain.calls > calls[0], osj._osj_svd_plain.calls > calls[1]) == plain
    tol = 1e-4 if torch_dtype == torch.complex64 else 1e-8
    assert max(abs(z_port[v] - z_jax[v]) for v in g.vertices()) < tol
    e_jax = np.stack(e_jax)
    if floor is None:
        assert np.all(np.abs(e_port - e_jax) <= 1e-4 * np.abs(e_jax) + 1e-5)
    else:
        assert np.all(np.abs(e_port - e_jax) <= 1e-4 * np.maximum(np.abs(e_jax), floor))


def test_gram_nofactor_group_matches_jax():
    """The Q-free reduction on one edge-color group at chi = 32 from a
    random full-rank state with BP-converged messages: T, M and the
    per-gate errors within 1e-4, the bar of `tests/test_torch_engine.py`'s
    group test.  Not from "↑": there every tall side's Gram has a live
    direction at its shift, and whether the Gram-space second Cholesky
    round fails (NaN in both packages) turns on the rounding of the
    Gram's products, which the BLAS and its thread count decide."""
    g, p = _hh22()
    chi = 32
    switch = dict(reduce_method="gram_nofactor", svd_impl="xla")
    je = _jax_engine(g, chi, np.complex64, switch)
    rng = np.random.default_rng(5)
    T = {k: _rand_c(rng, (len(vs), 2) + (chi,) * k) for k, vs in je.plan.buckets.items()}
    T_jax = {k: jnp.asarray(v) for k, v in T.items()}
    M = np.asarray(je._bp_fixed_point(T_jax, je.M, 30, 1e-5, False))
    circuit = tnqs.models.heavy_hex_kicked_ising_layer(g, **LAYER)
    group = next(c for c in jax_compile_circuit(je.plan, circuit) if hasattr(c, "classes"))
    gates = [jnp.asarray(c.gates.astype(np.complex64)) for c in group.classes]
    errors = jnp.zeros((len(circuit),), jnp.float32)
    apply = jax.jit(lambda T, M, e: je._apply_two_site_group(T, M, e, group.classes, gates, 1e-12, True))
    T_j, M_j, e_j = apply(T_jax, jnp.asarray(M), errors)

    pe = LatticeEngine.from_arrays(p, T, M, chi=chi, device="cpu", bp_schedule="color", **switch)
    pgroup = next(c for c in compile_circuit(pe.plan, tt.heavy_hex_kicked_ising_layer(p, **LAYER))
                  if hasattr(c, "classes"))
    e_p = torch.zeros((len(circuit),), dtype=torch.float32)
    pe._apply_two_site_group(pe.T, pe.M, e_p, [_ClassData(c, pe.dtype, pe.device) for c in pgroup.classes],
                             1e-12, True)
    for k in T:
        assert np.isfinite(np.asarray(T_j[k])).all()
        assert np.max(np.abs(pe.T[k].numpy() - np.asarray(T_j[k]))) < 1e-4, k
    assert np.max(np.abs(pe.M.numpy() - np.asarray(M_j))) < 1e-4
    e_j = np.asarray(e_j)
    assert np.max(np.abs(e_p.numpy() - e_j)) <= 1e-4 * np.max(e_j)
