"""Carrying flex states between the packages and between the tiers, on the
CPU: `TensorNetworkState.from_arrays` / `to_arrays` on index descriptors
taken from JAX objects, the state and BP-cache npz files written by one
package and read by the other (arrays bit for bit, shared indices shared),
and the engine's `from_state` / `to_state` / `to_bp_cache` against the JAX
engine's on the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnqs
from tnqs.engine import LatticeEngine as JaxEngine
import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from torch_flex_cases import CPU, GRAPHS, IndexMap, graph, layer, pair_states, state_descriptors

torch.set_num_threads(1)


def _same(nj, np_, exact=True):
    imap = IndexMap().learn_network(nj, np_)
    for v in nj.vertices():
        got, want = np_[v].to_numpy(), imap.array(nj[v], np_[v])
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-12)
    return imap


def _bonds_shared(psi):
    for u, v in psi.edges():
        assert len(psi.virtualinds((u, v))) == 1


@pytest.mark.parametrize("name", ["grid3x3", "hex2x2p"])
def test_from_arrays_and_back(name):
    psij, _, _ = pair_states(GRAPHS[name](), 3, np.complex64, 1)
    arrays, sinds = state_descriptors(psij)
    psip = tt.TensorNetworkState.from_arrays(graph(psij.graph), arrays, sinds, device=CPU)
    _same(psij, psip)
    _bonds_shared(psip)
    assert all(psip.siteinds(v) == psip.uniqueinds(v) for v in psip.vertices())
    back_arrays, back_sinds = psip.to_arrays()
    again = tt.TensorNetworkState.from_arrays(psip.graph, back_arrays, back_sinds, device=CPU)
    for v in psip.vertices():
        assert torch.equal(again[v].data, psip[v].data)
    assert abs(tt.norm_sqr(psip, alg="exact") - tnqs.norm_sqr(psij, alg="exact")) < 1e-5 * abs(
        tnqs.norm_sqr(psij, alg="exact"))


def test_state_files_both_ways(tmp_path):
    g = GRAPHS["grid3x3"]()
    psij, psip, _ = pair_states(g, 2, np.complex128, 2)
    tnqs.save_state(psij, tmp_path / "jax.npz")
    tt.save_state(psip, tmp_path / "port.npz")
    from_jax = tt.load_state(tmp_path / "jax.npz", device=CPU)
    from_port = tnqs.load_state(tmp_path / "port.npz")
    _same(psij, from_jax)
    _same(from_port, psip)
    _bonds_shared(from_jax)
    assert isinstance(from_jax, tt.TensorNetworkState)
    assert [len(from_jax.siteinds(v)) for v in g.vertices()] == [1] * g.nv()
    # a scalar network stays a scalar network
    zj = tnqs.ising_partitionfunction(g, 0.2)
    tnqs.save_state(zj, tmp_path / "z.npz")
    zp = tt.load_state(tmp_path / "z.npz", device=CPU)
    assert type(zp) is tt.TensorNetwork
    assert abs(tt.contract_network(zp) - tnqs.contract_network(zj)) < 1e-10 * abs(tnqs.contract_network(zj))


def test_bp_cache_files_both_ways(tmp_path):
    g = GRAPHS["hex2x2p"]()
    psij, psip, imap = pair_states(g, 2, np.complex128, 3)
    ak = dict(maxdim=3, cutoff=1e-12)
    bj, _ = tnqs.apply_gates(layer(g), tnqs.BeliefPropagationCache(psij), apply_kwargs=ak)
    bp, _ = tt.apply_gates(layer(g), tt.BeliefPropagationCache(psip), apply_kwargs=ak)
    tnqs.save_bp_cache(bj, tmp_path / "jax.npz")
    tt.save_bp_cache(bp, tmp_path / "port.npz")
    pj = tt.load_bp_cache(tmp_path / "jax.npz", device=CPU)
    jp = tnqs.load_bp_cache(tmp_path / "port.npz")
    for src, dst in ((bj, pj), (jp, bp)):
        imap = _same(src.network, dst.network)
        assert set(src.messages) == set(dst.messages)
        for e in src.messages:
            np.testing.assert_array_equal(imap.array(src.messages[e], dst.messages[e]), dst.messages[e].to_numpy())
    # the restored caches measure as the originals
    v = g.vertices()[0]
    assert tt.expect(pj, ("Z", [v])) == pytest.approx(tnqs.expect(bj, ("Z", [v])), abs=1e-12)
    assert tnqs.expect(jp, ("Z", [v])) == pytest.approx(tt.expect(bp, ("Z", [v])), abs=1e-12)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine on a random 3x3 state at bond dimension 2 and chi=4,
    its messages replaced by random positive ones, and the port engine on
    the same arrays and schedule."""
    g = GRAPHS["grid3x3"]()
    psij, psip, _ = pair_states(g, 2, np.complex128, 4)
    jeng = JaxEngine(psij, 4, dtype=jnp.complex128, factor_method="direct", bp_schedule="wavefront")
    rng = np.random.default_rng(6)
    a = rng.standard_normal((jeng.plan.num_edges, 4, 4)) + 1j * rng.standard_normal((jeng.plan.num_edges, 4, 4))
    M = a @ np.conj(np.swapaxes(a, 1, 2))
    jeng.M = jnp.asarray(M)
    T = {k: np.asarray(v) for k, v in jeng.T.items()}
    peng = LatticeEngine.from_arrays(graph(g), T, M, 4, dtype=torch.complex128, device=CPU,
                                     factor_method="direct", bp_schedule="wavefront")
    return g, psij, psip, jeng, peng


def test_engine_from_state_packs_as_jax(engines):
    g, psij, psip, jeng, peng = engines
    eng = LatticeEngine.from_state(psip, 4, dtype=torch.complex128, device=CPU, factor_method="direct",
                                   bp_schedule="wavefront")
    for k in jeng.T:
        np.testing.assert_array_equal(eng.T[k].numpy(), np.asarray(jeng.T[k]))
    np.testing.assert_array_equal(eng.M.numpy(), np.eye(4) / 4 * np.ones((jeng.plan.num_edges, 1, 1)))
    assert eng.site_indices() == {v: psip.siteinds(v) for v in g.vertices()}
    with pytest.raises(ValueError, match="wider than chi"):
        LatticeEngine.from_state(psip, 1, dtype=torch.complex128, device=CPU)


def test_to_state_and_to_bp_cache_as_jax(engines):
    g, psij, psip, jeng, peng = engines
    sj, sp = jeng.to_state(), peng.to_state()
    imap = _same(sj, sp)
    assert all(i.dim == 4 for e in sp.edges() for i in sp.virtualinds(e))
    cj, cp = jeng.to_bp_cache(), peng.to_bp_cache()
    assert set(cj.messages) == set(cp.messages)
    for e in cj.messages:
        np.testing.assert_array_equal(imap.learn(cj.messages[e], cp.messages[e]).array(cj.messages[e], cp.messages[e]),
                                      cp.messages[e].to_numpy())
    for v in g.vertices()[:3]:
        assert tt.expect(cp, ("Z", [v])) == pytest.approx(tnqs.expect(cj, ("Z", [v])), abs=1e-12)
    assert peng.to_state()[g.vertices()[0]].data.data_ptr() != peng.T[2].data_ptr()


def test_flex_bp_on_the_engine_state_equals_the_engine():
    """An evolved engine's converged messages carried into the flex tier:
    flex BP <Z> equals `expect_1site`, and a flex BP update from there
    stays at the fixed point."""
    g = tt.named_grid((3, 3))
    eng = LatticeEngine(g, 4, dtype=torch.complex128, device=CPU, factor_method="direct")
    eng.evolve(tt.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4), num_layers=2, cutoff=1e-12, bp_maxiter=30)
    eng.bp_update(maxiter=60, tolerance=1e-14)
    z = eng.expect_1site("Z")
    bpc = eng.to_bp_cache()
    for v in g.vertices():
        assert abs(tt.expect(bpc, ("Z", [v])) - z[v]) < 1e-10
    again = bpc.update(maxiter=5, tolerance=1e-12)
    for v in g.vertices()[:3]:
        assert abs(tt.expect(again, ("Z", [v])) - z[v]) < 1e-8
    fresh = LatticeEngine(g, 4, dtype=torch.complex128, device=CPU)
    assert list(fresh.to_state().siteinds().values())[0][0].tag == "S=1/2"
    assert fresh.site_indices() is fresh.site_indices()
