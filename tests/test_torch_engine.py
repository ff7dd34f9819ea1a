"""tnqs_torch.engine against tnqs.engine on the CPU, from identical inputs.

Inputs are made with numpy and carried into both packages as packed arrays
(`LatticeEngine.from_arrays`).  Both engines run the production
configuration: factor_method="gram" (Cholesky gauge, CholeskyQR2),
trunc_method="svd" with the pjsvd route, and the BP schedule passed
explicitly.  The JAX engine's Pallas kernels run in interpret mode, as
`tests/test_ops.py:271-283` runs them; the port's kernel wrappers run their
plain PyTorch versions on CPU tensors."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tnqs
import tnqs.models
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.engine import compile_circuit as jax_compile_circuit
from tnqs.ops import osj as jax_osj

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine, _ClassData, compile_circuit
from tnqs_torch.ops import jacobi, osj

torch.set_num_threads(1)

LAYER = dict(J=np.pi / 4, theta_h=0.4)


def _hh22():
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    return g, tt.NamedGraph.from_edges(g.vertices(), g.edges())


def _jax_engine(g, chi, schedule):
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    eng = JaxEngine(psi, chi=chi, dtype=jnp.complex64, factor_method="gram", bp_schedule=schedule)
    eng.trunc_method = "svd"
    eng.svd_impl = "pjsvd"
    return eng


def _random_state(plan, chi, seed):
    rng = np.random.default_rng(seed)
    return {
        k: (rng.normal(size=(len(vs), 2) + (chi,) * k) + 1j * rng.normal(size=(len(vs), 2) + (chi,) * k))
        .astype(np.complex64)
        for k, vs in plan.buckets.items()
    }


def test_product_state_and_messages_match_tnqs():
    g, p = _hh22()
    je = _jax_engine(g, 4, "color")
    pe = LatticeEngine(p, chi=4, device="cpu", bp_schedule="color")
    T, M = pe.to_arrays()
    assert T.keys() == je.T.keys()
    for k in T:
        np.testing.assert_array_equal(T[k], np.asarray(je.T[k]))
    np.testing.assert_array_equal(M, np.asarray(je.M))


@pytest.mark.parametrize("schedule", ["wavefront", "color"])
def test_bp_fixed_point_matches_jax(schedule):
    g, p = _hh22()
    chi = 8
    je = _jax_engine(g, chi, schedule)
    T = _random_state(je.plan, chi, seed=11)
    M0 = np.asarray(je.M)
    M_jax = je._bp_fixed_point({k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(M0), 30, 1e-5, False)
    pe = LatticeEngine.from_arrays(p, T, M0, chi=chi, device="cpu", bp_schedule=schedule)
    M_port = pe._bp_fixed_point(pe.T, pe.M, 30, 1e-5)
    # same iteration count and update order; float32 rounding in another
    # order moves normalized messages by a few ulps per sweep
    assert np.max(np.abs(M_port.numpy() - np.asarray(M_jax))) < 1e-5


def test_two_site_group_matches_jax():
    g, p = _hh22()
    chi = 8
    je = _jax_engine(g, chi, "color")
    T = _random_state(je.plan, chi, seed=5)
    T_jax = {k: jnp.asarray(v) for k, v in T.items()}
    M = np.asarray(je._bp_fixed_point(T_jax, je.M, 30, 1e-5, False))  # PSD environments
    circuit = tnqs.models.heavy_hex_kicked_ising_layer(g, **LAYER)
    group = next(c for c in jax_compile_circuit(je.plan, circuit) if hasattr(c, "classes"))
    gates = [jnp.asarray(c.gates.astype(np.complex64)) for c in group.classes]
    errors = jnp.zeros((len(circuit),), jnp.float32)
    apply = jax.jit(lambda T, M, e: je._apply_two_site_group(T, M, e, group.classes, gates, 1e-12, True))
    T_j, M_j, e_j = apply(T_jax, jnp.asarray(M), errors)

    pe = LatticeEngine.from_arrays(p, T, M, chi=chi, device="cpu", bp_schedule="color")
    pgroup = next(c for c in compile_circuit(pe.plan, tt.heavy_hex_kicked_ising_layer(p, **LAYER))
                  if hasattr(c, "classes"))
    e_p = torch.zeros((len(circuit),), dtype=torch.float32)
    pe._apply_two_site_group(pe.T, pe.M, e_p, [_ClassData(c, pe.dtype, pe.device) for c in pgroup.classes],
                             1e-12, True)
    # unit-norm site tensors and normalized bond spectra after one gauge,
    # QR and SVD in float32: agreement to ~1e-6, bounded at 1e-4
    for k in T:
        assert np.max(np.abs(pe.T[k].numpy() - np.asarray(T_j[k]))) < 1e-4, k
    assert np.max(np.abs(pe.M.numpy() - np.asarray(M_j))) < 1e-4
    e_j = np.asarray(e_j)
    assert np.max(np.abs(e_p.numpy() - e_j)) <= 1e-4 * np.max(e_j)


def test_slice_matches_jax_production_engine():
    """Two kicked-Ising layers on heavy_hexagonal_lattice(2, 2) at chi=32
    from "↑": the smallest lattice and bond cap at which thetas reach the
    pjsvd route (min dimension 64)."""
    g, p = _hh22()
    chi = 32
    je = _jax_engine(g, chi, "color")
    T0, M0 = {k: np.asarray(v) for k, v in je.T.items()}, np.asarray(je.M)
    orig = jax_osj.pjsvd
    jax_osj.pjsvd = partial(orig, interpret=True)
    try:
        step = je.make_step(tnqs.models.heavy_hex_kicked_ising_layer(g, **LAYER), cutoff=1e-12, bp_maxiter=25)
        e_jax = []
        for _ in range(2):
            je.T, je.M, e = step(je.T, je.M)
            e_jax.append(np.asarray(e))
    finally:
        jax_osj.pjsvd = orig
    z_jax = je.expect_1site("Z")

    pe = LatticeEngine.from_arrays(p, T0, M0, chi=chi, device="cpu", bp_schedule="color")
    calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls)
    e_port = pe.evolve(tt.heavy_hex_kicked_ising_layer(p, **LAYER), num_layers=2, cutoff=1e-12, bp_maxiter=25)
    z_port = pe.expect_1site("Z")
    # the routed path ran: every pjsvd is one plain Jacobi eigh + one polish
    assert jacobi._jacobi_eigh_plain.calls > calls[0]
    assert osj._osj_svd_plain.calls > calls[1]
    # pre-saturation float32 evolution: both engines track each other to
    # ~1e-7 (and the flex-f64 golden to ~1e-6); 1e-4 is the gate of
    # tests/test_ops.py:290 halved
    assert max(abs(z_port[v] - z_jax[v]) for v in g.vertices()) < 1e-4
    # per-gate discarded weight, relative; below the 1e-12 cutoff it is the
    # rounding noise of exactly-null singular values, so the cutoff is the
    # floor of the relative scale
    e_jax = np.stack(e_jax)
    assert np.all(np.abs(e_port - e_jax) <= 1e-4 * np.maximum(np.abs(e_jax), 1e-12))


@pytest.mark.parametrize(
    "switch, error",
    [
        (dict(bp_kernel="pallas"), NotImplementedError),
        (dict(dtype=torch.complex128, svd_impl="pjsvd"), NotImplementedError),
        (dict(dtype=torch.complex128, bp_kernel="kernel"), ValueError),
        (dict(svd_impl="cusolver"), ValueError),
    ],
    ids=lambda x: "-".join(f"{k}={v}" for k, v in x.items()) if isinstance(x, dict) else x.__name__,
)
def test_unported_switches_raise(switch, error):
    """The TPU kernel's name, the float32 kernels asked for at complex128,
    and an unknown SVD route are refused."""
    _, p = _hh22()
    with pytest.raises(error):
        LatticeEngine(p, chi=4, device="cpu", **switch)


def test_from_arrays_checks_the_plan_shapes():
    _, p = _hh22()
    T, M = LatticeEngine(p, chi=4, device="cpu").to_arrays()
    k = max(T)
    with pytest.raises(ValueError):
        LatticeEngine.from_arrays(p, {**T, k: T[k][1:]}, M, chi=4, device="cpu")
    with pytest.raises(ValueError):
        LatticeEngine.from_arrays(p, T, M[:, :2], chi=4, device="cpu")
    # the arrays are copied: evolving the engine in place leaves them untouched
    T_before, M_before = {k: v.copy() for k, v in T.items()}, M.copy()
    eng = LatticeEngine.from_arrays(p, T, M, chi=4, device="cpu")
    eng.evolve(tt.heavy_hex_kicked_ising_layer(p, **LAYER), cutoff=1e-12, bp_maxiter=5)
    for k in T:
        np.testing.assert_array_equal(T[k], T_before[k])
    np.testing.assert_array_equal(M, M_before)


@pytest.mark.parametrize("chi, cutoff", [(4, 1e-2), (8, 1e-12), (12, 0.0)])
def test_truncate_mask_matches_jax(chi, cutoff):
    from tnqs.engine import _truncate_mask as jax_truncate_mask
    from tnqs_torch.engine import _truncate_mask

    rng = np.random.default_rng(chi)
    s = np.sort(rng.exponential(size=(5, 8)), axis=1)[:, ::-1].astype(np.float32)
    s[1, 4:] = 0  # exactly-null tail
    s_m, mask, err = (x.numpy() for x in _truncate_mask(torch.as_tensor(s.copy()), chi, cutoff))
    s_j, mask_j, err_j = (np.asarray(x) for x in jax_truncate_mask(jnp.asarray(s), chi, cutoff))
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_array_equal(s_m, s_j)
    # cumulative sums in another order: a few float32 ulps
    np.testing.assert_allclose(err, err_j, rtol=1e-5, atol=1e-7)


def test_layers_per_call_repeats_the_layer():
    _, p = _hh22()
    circuit = tt.heavy_hex_kicked_ising_layer(p, **LAYER)
    one, two = LatticeEngine(p, chi=4, device="cpu"), LatticeEngine(p, chi=4, device="cpu")
    e_one = one.evolve(circuit, num_layers=2, cutoff=1e-12, bp_maxiter=5)
    step = two.make_step(circuit, cutoff=1e-12, bp_maxiter=5, layers_per_call=2)
    two.T, two.M, e_two = step(two.T, two.M)
    assert e_two.shape == (2, len(circuit))
    np.testing.assert_array_equal(e_two.numpy(), e_one)
    for k in one.T:
        np.testing.assert_array_equal(two.T[k].numpy(), one.T[k].numpy())
    np.testing.assert_array_equal(two.M.numpy(), one.M.numpy())
