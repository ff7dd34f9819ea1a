"""tnqs_torch.parallel on gloo ranks on the CPU, against the JAX package's
unsharded engine and functions and the port's own unsharded runs, on the
same inputs (states from "↑" or from the port's unsharded evolution,
message noise and site-tensor noise from numpy seeds).  The ranks are two
`RankPool`s, one spawn each for the module (bodies in
`tests/torch_parallel_cases.py`): 8 processes for the cases on 8 bands
(Eagle-127's and HaloBP's) and 3 for the rest, the dry run included; a
case submits its ranks' work before it runs its JAX reference, so the two
overlap.  The JAX
mesh programs are not run here (`tests/test_parallel.py` holds them).  Every engine runs
the "color" BP schedule in both packages, and the JAX engines the port's
defaults (gram, svd, pjsvd)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tnqs
from tnqs import variational as jvar
from tnqs.engine import LatticeEngine as JEngine
from tnqs.engine import LatticePlan as JPlan
from tnqs.models import heavy_hex_kicked_ising_layer, tfim_layer
from tnqs.parallel import halo as jhalo
from tnqs.parallel import halo_step as jhalo_step
from tnqs.parallel.mesh import make_mesh as jmake_mesh

import tnqs_torch as tt
from tnqs_torch import variational as pvar
from tnqs_torch.engine import LatticeEngine, LatticePlan
from tnqs_torch.parallel import HaloBandPlan, RankPool, dryrun_multichip, make_mesh
from tnqs_torch.parallel import halo_step as phalo_step
from tnqs_torch.parallel.halo_step import cut_halves

import torch_parallel_cases as cases
from torch_flex_cases import CPU, graph

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool8():
    with RankPool(8) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool3():
    with RankPool(3) as pool:
        yield pool


def _ve(g):
    """A graph as the ranks take it: (vertices, edges)."""
    return list(g.vertices()), list(g.edges())


def _jengine(g, chi, dtype=jnp.complex64):
    """The JAX engine on `g` with the port's defaults (gram, svd, pjsvd) and
    the color schedule."""
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JEngine(psi, chi=chi, dtype=dtype, factor_method="gram", bp_schedule="color")
    je.trunc_method, je.svd_impl = "svd", "pjsvd"
    return je


def _pengine(g, chi, dtype=torch.complex64):
    return LatticeEngine(graph(g), chi, dtype=dtype, device=CPU, bp_schedule="color")


def _zj(je, g):
    z = je.expect_1site("Z")
    return np.array([complex(z[v]).real for v in g.vertices()])


def _zp(pe, g):
    z = pe.expect_1site("Z")
    return np.array([z[v].real for v in g.vertices()])


# -- the mesh ------------------------------------------------------------

def test_make_mesh_raises_without_a_card(monkeypatch):
    """No CUDA device and no ``device="cpu"``: no mesh (there is no CPU
    fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(8, device="cuda")


# -- the band plans, no ranks needed ---------------------------------------

PLAN_GRAPHS = {
    "grid8x3": (lambda: tnqs.named_grid((8, 3)), 8, None),
    "grid6x2": (lambda: tnqs.named_grid((6, 2)), 3, None),
    "heavyhex22": (lambda: tnqs.heavy_hexagonal_lattice(2, 2), 8, "sorted"),
    "eagle": (lambda: tnqs.eagle_lattice(), 8, "sorted"),
}


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for key in a:
            _assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(PLAN_GRAPHS))
def test_band_plan_matches_jax_field_for_field(name):
    """`HaloBandPlan.build` is the JAX package's, table for table."""
    make, nb, order = PLAN_GRAPHS[name]
    g = make()
    jp = jhalo.HaloBandPlan.build(JPlan.build(g, bp_schedule="color"), nb, order=order)
    pp = HaloBandPlan.build(LatticePlan.build(graph(g), bp_schedule="color"), nb, order=order)
    for f in ("n_bands", "band_of_vertex", "band_vert_pos", "n_loc", "eid_to_band_slot", "n_up", "n_dn", "send_up",
              "send_dn", "groups"):
        _assert_same(getattr(jp, f), getattr(pp, f), f)


@pytest.mark.parametrize("name,nb", [("heavyhex22", 8), ("eagle", 8), ("ring12", 4)])
def test_generator_order_raises_adjacent(name, nb):
    """Generator order interleaves heavy-hex columns, and a ring wraps: a
    cross-band edge then spans more than one band, in both packages."""
    g = tnqs.named_ring_graph(12) if name == "ring12" else PLAN_GRAPHS[name][0]()
    with pytest.raises(ValueError, match="adjacent"):
        jhalo.HaloBandPlan.build(JPlan.build(g), nb)
    with pytest.raises(ValueError, match="adjacent"):
        HaloBandPlan.build(LatticePlan.build(graph(g)), nb)


def _eagle_layer(g):
    return heavy_hex_kicked_ising_layer(g, float(np.pi / 4), 0.4)


def _grid_layer(g):
    return [("Rx", [v], 0.5) for v in g.vertices()] + [("Rzz", e, 0.6) for e in g.edges()]


@pytest.mark.parametrize("name", ["grid6x2", "eagle"])
def test_step_plan_matches_jax_field_for_field(name):
    """`_build_step_plan`'s tables (ghost rows, the width-2 message halo,
    the band-stacked program) are the JAX package's."""
    make, nb, order = PLAN_GRAPHS[name]
    g = make()
    layer = _eagle_layer(g) if name == "eagle" else _grid_layer(g)
    je = _jengine(g, 2)
    jsp = jhalo_step._build_step_plan(je, jhalo.HaloBandPlan.build(je.plan, nb, order=order), layer)
    pe = _pengine(g, 2)
    psp = phalo_step._build_step_plan(pe, HaloBandPlan.build(pe.plan, nb, order=order), layer)
    for f in ("n_bands", "n_gates", "own_n", "gfb_n", "gfa_n", "ext_n", "gsend_up", "gsend_dn", "n_msg_base",
              "msg_off", "msg_n", "msg_send", "zslot", "n_msg_ext"):
        _assert_same(getattr(jsp, f), getattr(psp, f), f)
    assert len(jsp.program) == len(psp.program)
    for i, (a, b) in enumerate(zip(jsp.program, psp.program)):
        assert a[0] == b[0]
        if a[0] == "one":
            _assert_same(a[1], b[1], f"program[{i}]")
        elif a[0] == "two":
            for j, (ca, cb) in enumerate(zip(a[1], b[1], strict=True)):
                _assert_same(vars(ca), vars(cb), f"program[{i}][{j}]")


# -- ShardedEngine -------------------------------------------------------------

def test_sharded_step_matches_unsharded(pool3):
    """3x3 grid, chi=4, complex64, two TFIM layers on 3 ranks (buckets of
    4, 4 and 1 sites: padding) against JAX's unsharded `evolve`: <Z> within
    1e-5, errors within rtol 1e-5 / atol 1e-6; against the port's unsharded
    step within 1e-6 (every rank runs the engine's own step)."""
    g = tnqs.named_grid((3, 3))
    layer = tfim_layer(g, J=0.5, hx=1.0, dt=0.25)
    kw = dict(cutoff=1e-10, bp_maxiter=10)
    pool3.submit(cases.sharded_steps, _ve(g), 4, layer, 2, kw)
    je = _jengine(g, 4)
    je.bp_update(maxiter=10)
    errs_j = je.evolve(layer, num_layers=2, **kw)
    pe = _pengine(g, 4)
    pe.bp_update(maxiter=10)
    errs_p = pe.evolve(layer, num_layers=2, **kw)
    out = pool3.collect()
    for errs, z in out:
        np.testing.assert_allclose(errs, np.asarray(errs_j), rtol=1e-5, atol=1e-6)
        assert np.abs(z - _zj(je, g)).max() < 1e-5
        assert np.abs(errs - errs_p).max() < 1e-6 and np.abs(z - _zp(pe, g)).max() < 1e-6


def test_sharded_heavyhex_padding(pool3):
    """Heavy-hex (2, 2) on 3 ranks: the degree-2 bucket's 29 sites take a
    padded row; one kicked-Ising layer is finite and is the port's
    unsharded step within 1e-6."""
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    layer = _eagle_layer(g)
    out = pool3.run(cases.sharded_steps, _ve(g), 4, layer, 1, dict(cutoff=1e-12, bp_maxiter=5))
    pe = _pengine(g, 4)
    pe.bp_update(maxiter=10)
    errs_p = pe.evolve(layer, num_layers=1, cutoff=1e-12, bp_maxiter=5)
    for errs, z in out:
        assert np.isfinite(errs).all() and np.isfinite(z).all()
        assert np.abs(errs - errs_p).max() < 1e-6 and np.abs(z - _zp(pe, g)).max() < 1e-6


def test_sharded_freenergy_matches_unsharded(pool3):
    """complex128: the free energy reduced over 3 ranks (two real sums and a
    minimum by `all_reduce`) against JAX's `freenergy` and the port's on the
    same state, within 1e-9 (relative past 1); the partition function within
    1e-9."""
    g = tnqs.named_grid((3, 3))
    pe = _pengine(g, 4, torch.complex128)
    pe.bp_update(maxiter=10)
    pe.evolve(tfim_layer(g, J=0.5, hx=1.0, dt=0.25), num_layers=2, cutoff=1e-10, bp_maxiter=10)
    T, M = pe.to_arrays()
    pool3.submit(cases.sharded_freenergy, _ve(g), 4, T, M)
    je = _jengine(g, 4, jnp.complex128)
    je.T, je.M = {k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(M)
    f_ref, z_ref = je.freenergy(), je.partitionfunction()
    for f, z in pool3.collect():
        assert abs(f - f_ref) < 1e-9 * max(1.0, abs(f_ref))
        assert abs(f - pe.freenergy()) < 1e-9 * max(1.0, abs(f_ref))
        assert abs(z - z_ref) < 1e-9


# -- HaloBP ----------------------------------------------------------------

def test_halo_bp_matches_unsharded(pool8):
    """8x3 grid in 8 bands, chi=4, complex64: from a two-layer TFIM state
    with seeded message noise, `HaloBP.fixed_point` (25 sweeps at most,
    tolerance 1e-7) against JAX's `_bp_fixed_point` and the port's within
    1e-5; every rank gathers the same messages."""
    g = tnqs.named_grid((8, 3))
    pe = _pengine(g, 4)
    pe.bp_update(maxiter=10)
    pe.evolve(tfim_layer(g, J=0.5, hx=1.0, dt=0.25), num_layers=2, cutoff=1e-10, bp_maxiter=10)
    T, M0 = pe.to_arrays()
    rng = np.random.default_rng(0)
    M0 = (M0 + 0.05 * (rng.normal(size=M0.shape) + 1j * rng.normal(size=M0.shape))).astype(M0.dtype)
    pool8.submit(cases.halo_fixed_point, _ve(g), 4, T, M0, 25, 1e-7)
    je = _jengine(g, 4)
    ref_j = np.asarray(je._bp_fixed_point({k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(M0), 25, 1e-7))
    ref_p = pe._bp_fixed_point(pe.T, torch.as_tensor(M0), 25, 1e-7).numpy()
    out = pool8.collect()
    assert all(np.array_equal(m, out[0]) for m in out)
    assert np.abs(out[0] - ref_j).max() < 1e-5
    assert np.abs(out[0] - ref_p).max() < 1e-5


# -- HaloStepEngine --------------------------------------------------------------

def test_halo_step_matches_unsharded_grid(pool3):
    """6x2 grid, chi=2, complex64, three bands: one layer (Rx 0.5 on every
    site, Rzz 0.6 on every edge) against JAX's and the port's unsharded step
    with the same fixed BP sweep counts (tolerance 0): <Z> within 1e-5,
    errors within 1e-6."""
    g = tnqs.named_grid((6, 2))
    layer = _grid_layer(g)
    pool3.submit(cases.halo_step, _ve(g), 2, layer, None, dict(cutoff=1e-12, bp_maxiter=6))
    _halo_step_against_unsharded(g, layer, 6, pool3.collect())


def test_halo_step_matches_unsharded_eagle(pool8):
    """Eagle-127 in 8 sorted bands, chi=2, complex64: one kicked-Ising layer
    against JAX's and the port's unsharded step (<Z> within 1e-5, errors
    within 1e-6), and `halo_bytes_per_layer` equal to JAX's, with 3 inner
    refreshes of 2 sweeps and the final 4."""
    g = tnqs.eagle_lattice()
    layer = _eagle_layer(g)
    pool8.submit(cases.halo_step, _ve(g), 2, layer, "sorted", dict(cutoff=1e-12, bp_maxiter=4))
    je = _jengine(g, 2)
    jhse = jhalo_step.HaloStepEngine(je, n_bands=8, mesh=jmake_mesh(8), order="sorted")
    traffic_j = jhse.halo_bytes_per_layer(layer, bp_maxiter=4)
    out = _halo_step_against_unsharded(g, layer, 4, pool8.collect(), je)
    for *_, traffic in out:
        assert traffic == traffic_j
        assert traffic["bp_sweeps"] == 3 * 2 + 4 and traffic["total_bytes"] > 0


def _halo_step_against_unsharded(g, layer, bp_maxiter, out, je=None):
    kw = dict(cutoff=1e-12, bp_maxiter=bp_maxiter, bp_tolerance=0.0)
    je = _jengine(g, 2) if je is None else je
    step = je.make_step(layer, **kw)
    je.T, je.M, ej = step(je.T, je.M)
    pe = _pengine(g, 2)
    pe.T, pe.M, ep = pe.make_step(layer, **kw)(pe.T, pe.M)
    zj, zp = _zj(je, g), _zp(pe, g)
    for errors, z, M, _ in out:
        assert np.abs(z - zj).max() < 1e-5 and np.abs(z - zp).max() < 1e-5
        assert np.abs(errors - np.asarray(ej)).max() < 1e-6 and np.abs(errors - ep.numpy()).max() < 1e-6
        assert np.array_equal(M, out[0][2])
    return out


@pytest.mark.parametrize("name,factor_method", [("grid6x2", "gram"), ("grid6x2", "direct"), ("eagle", "gram")])
def test_cut_crossing_halves_are_the_same_bits(name, factor_method):
    """Both bands of a cut run its cut-crossing gates as one sub-group of
    the same gates in the same order, so the two halves (both endpoints'
    new tensors and the bond's message) are the same bits: `cut_halves`
    runs every group's cut sub-groups on every pair of adjacent bands'
    tables, filled as the halo exchange fills them, from a state after one
    unsharded layer."""
    make, nb, order = PLAN_GRAPHS[name]
    g = make()
    layer = _eagle_layer(g) if name == "eagle" else _grid_layer(g)
    pe = LatticeEngine(graph(g), 2, device=CPU, bp_schedule="color", factor_method=factor_method)
    pe.evolve(layer, num_layers=1, cutoff=1e-12, bp_maxiter=4)
    got = cut_halves(pe, nb, layer, order=order, cutoff=1e-12)
    assert got["gates"] == sum(1 for gate in layer if len(gate[1]) == 2 and len({
        HaloBandPlan.build(pe.plan, nb, order=order).band_of_vertex[v] for v in gate[1]}) == 2)
    assert got["equal"] and got["max_abs_diff"] == 0.0


# -- the sharded energy -----------------------------------------------------------

def _noisy_state(g, seed=0):
    """The "↑" state of an 8x2 grid at chi=2 with seeded complex noise 0.1
    on every site tensor (`tests/test_variational.py:216`)."""
    T = {k: a.numpy() for k, a in _pengine(g, 2).T.items()}
    rng = np.random.default_rng(seed)
    return {k: a + (0.1 * (rng.standard_normal(a.shape) + 1j * rng.standard_normal(a.shape))).astype(a.dtype)
            for k, a in T.items()}


def test_sharded_energy_and_gradient_match_unsharded(pool3):
    """8x2 grid in 3 bands, chi=2, complex64, TFIM (J=1, h=1.3), 10
    sweeps: the sharded energy and its gradient over the (real, imag)
    leaves against JAX's `jax.value_and_grad(bp_energy_fn)` within the
    1e-4 relative bounds of `tests/test_variational.py:216-266`, and against
    the port's unsharded `bp_energy_fn` within 1e-5; the gradient is the
    same bits on every rank."""
    g = tnqs.named_grid((8, 2))
    T = _noisy_state(g)
    pool3.submit(cases.sharded_energy, _ve(g), 2, T, 1.3, 10)
    je = _jengine(g, 2)
    efn = jvar.bp_energy_fn(je, jvar.tfim_hamiltonian(J=1.0, h=1.3), bp_iters=10)

    def loss(p):
        return efn({k: jax.lax.complex(re, im).astype(jnp.complex64) for k, (re, im) in p.items()})

    vj, gj = jax.jit(jax.value_and_grad(loss))({k: (jnp.real(a), jnp.imag(a)) for k, a in T.items()})
    vj = float(vj)
    pe = LatticeEngine.from_arrays(graph(g), T, _pengine(g, 2).M.numpy(), 2, device=CPU, bp_schedule="color")
    params = pvar._split(pe.T)
    for pair in params.values():
        for t in pair:
            t.requires_grad_(True)
    ep = pvar.bp_energy_fn(pe, pvar.tfim_hamiltonian(J=1.0, h=1.3), bp_iters=10)(pvar._join(params, pe.dtype))
    ep.backward()
    out = pool3.collect()
    e0, g0 = out[0]
    for e, grads in out[1:]:
        assert e == e0
        assert all(np.array_equal(grads[k][i], g0[k][i]) for k in g0 for i in (0, 1))
    assert abs(e0 - vj) < 1e-4 * max(1.0, abs(vj))
    assert abs(e0 - float(ep.detach())) < 1e-5 * max(1.0, abs(vj))
    scale = max(float(jnp.max(jnp.abs(gj[k][i]))) for k in gj for i in (0, 1))
    assert scale > 0
    for k in gj:
        for i, grad in enumerate((params[k][0].grad.numpy(), params[k][1].grad.numpy())):
            assert np.abs(g0[k][i] - np.asarray(gj[k][i])).max() < 1e-4 * scale
            assert np.abs(g0[k][i] - grad).max() < 1e-5 * scale


def test_minimize_energy_on_mesh(pool3):
    """``minimize_energy(mesh=)``: 4 Adam steps (lr 0.05, 8 sweeps) of the
    8x2 TFIM (h=1.3) over 3 ranks track the port's unsharded history within
    1e-4 relative, lower the energy, and leave the same state on every
    rank."""
    g = tnqs.named_grid((8, 2))
    T = _noisy_state(g, seed=1)
    pool3.submit(cases.mesh_minimize, _ve(g), 2, T, 1.3, 4, 8)
    pe = LatticeEngine.from_arrays(graph(g), T, _pengine(g, 2).M.numpy(), 2, device=CPU, bp_schedule="color")
    ref = tt.minimize_energy(pe, tt.tfim_hamiltonian(J=1.0, h=1.3), steps=4, learning_rate=0.05, bp_iters=8)
    out = pool3.collect()
    for hist, energy, Tn in out:
        assert np.abs(hist - ref["history"]).max() < 1e-4 * np.abs(ref["history"]).max()
        assert hist[-1] < hist[0] and energy == hist.min()
        assert all(np.array_equal(Tn[k], out[0][2][k]) for k in Tn)


# -- the mesh's size (after the cases above, so the pools start while JAX compiles) ------

@pytest.mark.parametrize("world,asked", [(8, 8), (8, None), (3, 3)])
def test_make_mesh_size(world, asked, pool8, pool3):
    """One rank a device: the mesh is the whole world, each rank its own."""
    out = (pool8 if world == 8 else pool3).run(cases.mesh_of, asked)
    assert out == [(world, r, "cpu") for r in range(world)]


@pytest.mark.parametrize("world,asked", [(8, 4), (3, 8)])
def test_make_mesh_rejects_another_world_size(world, asked, pool8, pool3):
    """JAX's ``make_mesh(4)`` takes a subset of the devices; a rank is a
    device here, so asking for other than the world's size raises."""
    out = (pool8 if world == 8 else pool3).run(cases.mesh_of, asked)
    assert all(kind == "ValueError" and f"{asked} devices asked for" in msg for kind, msg in out)


def test_dryrun_multichip_runs(pool3):
    """`dryrun_multichip(3)` on the 3-rank pool, stages 1-6 to their end: the
    sharded heavy-hex step, halo BP and the halo full layer on Eagle-127 in
    3 sorted bands, the sharded certified sampler (6 samples) and the
    ring-pipelined BMPS column sweep (Eagle's 13 columns on 3 ranks, within
    2e-5 of the unsharded sweep) on stage 3's state, and the mesh
    variational step."""
    lines = dryrun_multichip(3, pool=pool3)
    assert len(lines) == 6
    assert "3 ranks" in lines[0] and "variational step OK" in lines[-1]
    assert "certified sampling on Eagle-127 OK (6 samples over 3 ranks" in lines[3]
    assert "ring-pipelined BMPS column sweep OK (127-site Eagle heavy-hex, 13 columns banded over 3 ranks" in lines[4]
