"""tnqs_torch.variational against tnqs.variational on the CPU: the BP energy
and its gradient (torch.autograd against jax.grad) on the same engine
state, the analytic product-state energy, inhomogeneous coefficients, the
Adam loop against optax's, the einsum route under the gradient, the
mesh argument's type, and the full-width energy's freedom from host reads."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tnqs
from tnqs.engine import LatticeEngine as JEngine
from tnqs import variational as jvar

import tnqs_torch as tt
from tnqs_torch import engine as pengine
from tnqs_torch import variational as pvar
from tnqs_torch.engine import LatticeEngine

from torch_flex_cases import CPU, graph

torch.set_num_threads(1)


def _engines(g, chi, seed, noise):
    """A JAX engine on `g` at complex64 whose site tensors carry seeded
    noise, and the port's engine on the same arrays (CPU)."""
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JEngine(psi, chi=chi, dtype=jnp.complex64)
    rng = np.random.default_rng(seed)
    je.T = {k: jnp.asarray(np.asarray(a) + noise * (rng.standard_normal(a.shape)
                                                    + 1j * rng.standard_normal(a.shape)).astype(np.complex64))
            for k, a in je.T.items()}
    pe = LatticeEngine.from_arrays(graph(g), {k: np.asarray(a) for k, a in je.T.items()}, np.asarray(je.M), chi,
                                   dtype=torch.complex64, device=CPU)
    return je, pe


def _port_value_and_grad(pe, ham, bp_iters):
    params = pvar._split(pe.T)
    for pair in params.values():
        for t in pair:
            t.requires_grad_(True)
    e = pvar.bp_energy_fn(pe, ham, bp_iters=bp_iters)(pvar._join(params, pe.dtype))
    e.backward()
    return float(e.detach()), {k: (re.grad.numpy(), im.grad.numpy()) for k, (re, im) in params.items()}


GRAPHS = {"line3": lambda: tnqs.named_grid((1, 3)), "grid3x3": lambda: tnqs.named_grid((3, 3))}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def energy_case(request):
    """JAX's value and gradient of the TFIM (J=1, h=0.7) BP energy, 10
    sweeps, chi=2, over the (real, imag) leaves, and the port's engine."""
    je, pe = _engines(GRAPHS[request.param](), 2, 1, 0.2)
    efn = jvar.bp_energy_fn(je, jvar.tfim_hamiltonian(J=1.0, h=0.7), bp_iters=10)

    def loss(params):
        return efn({k: jax.lax.complex(re, im).astype(jnp.complex64) for k, (re, im) in params.items()})

    ej, gj = jax.jit(jax.value_and_grad(loss))({k: (jnp.real(a), jnp.imag(a)) for k, a in je.T.items()})
    return pe, float(ej), {k: (np.asarray(re), np.asarray(im)) for k, (re, im) in gj.items()}


def test_energy_and_gradient_match_jax(energy_case):
    """The 3-site line (a tree) and the loopy 3x3 grid at chi=2, complex64:
    energy within 1e-5 relative, gradient within 1e-4 of its largest entry."""
    pe, ej, gj = energy_case
    ep, gp = _port_value_and_grad(pe, pvar.tfim_hamiltonian(J=1.0, h=0.7), 10)
    assert abs(ep - ej) <= 1e-5 * abs(ej)
    scale = max(np.abs(g).max() for pair in gj.values() for g in pair)
    assert scale > 0
    for k in gj:
        for part in (0, 1):
            assert gp[k][part].shape == gj[k][part].shape
            assert np.abs(gp[k][part] - gj[k][part]).max() <= 1e-4 * scale


def test_bp_energy_product_state_analytic():
    """|↑...↑> under TFIM: <ZZ> = 1 on each edge, <X> = 0, so E = -J n_edges
    (`tests/test_variational.py:58`)."""
    n, J, h = 6, 0.8, 0.37
    eng = LatticeEngine(graph(tnqs.named_grid((1, n))), 4, dtype=torch.complex64, device=CPU)
    e = pvar.bp_energy_fn(eng, pvar.tfim_hamiltonian(J=J, h=h), bp_iters=12)(eng.T)
    assert e.dtype == torch.float32 and e.shape == ()
    assert abs(float(e) - (-J * (n - 1))) < 1e-4


def test_inhomogeneous_coefficients():
    """Dict-valued coefficients select vertices and edges (in either
    orientation); missing keys are 0 (`tests/test_variational.py:142`)."""
    eng = LatticeEngine(graph(tnqs.named_grid((1, 4))), 2, dtype=torch.complex64, device=CPU)
    verts, edges = list(eng.plan.graph.vertices()), list(eng.plan.graph.edges())
    for e0 in (edges[0], edges[0][::-1]):
        ham = tt.Hamiltonian(fields=(("Z", {verts[0]: 2.0}),), bonds=(("Z", "Z", {e0: -3.0}),))
        assert abs(float(pvar.bp_energy_fn(eng, ham, bp_iters=8)(eng.T)) - (2.0 - 3.0)) < 1e-4
    ham = tt.heisenberg_hamiltonian(J=2.0)
    # the product state: <ZZ> = 1, <XX> = <YY> = 0 on each of 3 edges
    assert abs(float(pvar.bp_energy_fn(eng, ham, bp_iters=8)(eng.T)) - 3 * 2.0 / 4) < 1e-4


def test_minimize_energy_tracks_optax():
    """20 Adam steps (lr 0.05, 14 sweeps) of the 6-site TFIM chain (J=1,
    h=0.5) from the same noisy state: the port's history within 1e-4
    relative of optax's at every step; the best state is written back and
    BP run on it."""
    g = tnqs.named_grid((1, 6))
    je, pe = _engines(g, 4, 0, 0.05)
    rj = jvar.minimize_energy(je, jvar.tfim_hamiltonian(J=1.0, h=0.5), steps=20, learning_rate=0.05, bp_iters=14)
    seen = []
    rp = tt.minimize_energy(pe, tt.tfim_hamiltonian(J=1.0, h=0.5), steps=20, learning_rate=0.05, bp_iters=14,
                            callback=lambda i, e: seen.append((i, e)))
    assert rp["steps"] == 20 and rp["history"].dtype == np.float64
    assert np.all(np.abs(rp["history"] - rj["history"]) <= 1e-4 * np.abs(rj["history"]))
    assert rp["history"][-1] < rp["history"][0]
    assert seen == list(enumerate(rp["history"]))
    assert rp["energy"] == rp["history"].min()
    # the engine holds the best state, contiguous and detached, with its BP fixed point
    assert all(not a.requires_grad and a.is_contiguous() for a in pe.T.values())
    zz, xs = pe.expect_2site("Z", "Z"), pe.expect_1site("X")
    e_eng = -sum(np.real(v) for v in zz.values()) - 0.5 * sum(np.real(v) for v in xs.values())
    assert abs(e_eng - rp["energy"]) < 1e-3


def test_optimizer_factory_and_non_finite_energy():
    """`optimizer=` takes a factory of the leaves; a non-finite energy raises
    FloatingPointError at that step."""
    g = tnqs.named_grid((1, 4))
    _, pe = _engines(g, 2, 3, 0.1)
    made = []

    def sgd(params):
        made.append(len(params))
        return torch.optim.SGD(params, lr=1e-3)

    res = tt.minimize_energy(pe, tt.tfim_hamiltonian(), steps=3, bp_iters=6, optimizer=sgd)
    assert made == [2 * len(pe.T)] and np.all(np.isfinite(res["history"]))
    pe.T = {k: torch.full_like(a, float("nan")) for k, a in pe.T.items()}
    with pytest.raises(FloatingPointError, match="non-finite at step 0"):
        tt.minimize_energy(pe, tt.tfim_hamiltonian(), steps=2, bp_iters=6)


def test_gradient_takes_the_einsum_route(monkeypatch):
    """An engine on the kernel route (`bp_kernel="kernel"` at chi=8, where
    the fused kernel takes every degree >= 2 group) with its wrapper patched to
    raise: the BP energy still evaluates and differentiates, since every
    sweep under the gradient takes the einsum chain; the engine's own
    `bp_update` does reach the wrapper."""
    g = tnqs.named_grid((3, 3))
    psi = tt.tensornetworkstate(lambda v: "↑", graph(g), "S=1/2", dtype=np.complex64, device=CPU)
    eng = LatticeEngine.from_state(psi, 8, dtype=torch.complex64, device=CPU, bp_kernel="kernel")
    assert eng.bp_kernel == "kernel" and pengine.supports_group(2, eng.chi, eng.dtype)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused BP kernel's wrapper was called")

    monkeypatch.setattr(pengine, "bp_sweep_group", refuse)
    _, grads = _port_value_and_grad(eng, tt.tfim_hamiltonian(h=0.7), 4)
    assert all(np.all(np.isfinite(gr)) for pair in grads.values() for gr in pair)
    with pytest.raises(AssertionError, match="fused BP kernel"):
        eng.bp_update()


def test_mesh_must_be_a_port_mesh():
    """`minimize_energy(mesh=...)` takes a `tnqs_torch.parallel.Mesh` (the
    sharded run is `tests/test_torch_parallel.py::test_minimize_energy_on_mesh`);
    anything else raises before a step, and does not fall back to the
    unsharded path."""
    eng = LatticeEngine(graph(tnqs.named_grid((1, 3))), 2, dtype=torch.complex64, device=CPU)
    T0 = {k: a.clone() for k, a in eng.T.items()}
    with pytest.raises(TypeError, match="tnqs_torch.parallel.Mesh"):
        tt.minimize_energy(eng, tt.tfim_hamiltonian(), steps=2, mesh=object())
    assert all(torch.equal(T0[k], eng.T[k]) for k in T0)
    assert tt.sharded_bp_energy_fn is pvar.sharded_bp_energy_fn


def test_full_width_energy_reads_nothing_on_the_host():
    """The energy and its gradient at the main path's width (Eagle-127,
    chi=64, complex64) on meta tensors, which hold no values: nothing on
    the path reads a device value on the host."""
    eng = LatticeEngine(tt.eagle_lattice(), 64, dtype=torch.complex64, device="meta")
    params = pvar._split(eng.T)
    for pair in params.values():
        for t in pair:
            t.requires_grad_(True)
    e = pvar.bp_energy_fn(eng, tt.tfim_hamiltonian(J=1.0, h=3.0), bp_iters=2)(pvar._join(params, eng.dtype))
    assert e.device.type == "meta" and e.shape == ()
    e.backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for pair in params.values() for t in pair)
