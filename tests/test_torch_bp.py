"""tnqs_torch BP convergence and BP measurement against tnqs on the CPU.

The fused BP kernel's plain PyTorch version (`_bp_sweep_group_plain`, what
the wrapper runs on a CPU tensor) is held against the JAX Pallas kernel in
interpret mode on the same numpy inputs; the engine's `bp_update`,
`freenergy`, `partitionfunction`, `rescale`, `normalize`, `expect_2site` and
`bond_entropies` against the JAX engine's, with the state carried over by
`from_arrays`.  The CUDA kernel itself is checked on the card by
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnqs
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.engine import LatticePlan as JaxPlan
from tnqs.ops import bp_sweep as jax_bp
from tnqs.sitetypes import _OPS_2
from tnqs.sitetypes import op_matrix as jax_op_matrix

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.ops import bp_sweep

torch.set_num_threads(1)


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _port(g):
    return tt.NamedGraph.from_edges(g.vertices(), g.edges())


# every (stage, k, t) group of heavy_hexagonal_lattice(2, 2) under "color"
# at chi=8, and the degree-4 groups of the 3x3 grid's center at chi=4
GROUPS = [("hh22", 8, i) for i in range(7)] + [("grid33", 4, i) for i in (2, 5)]


def _graph(name):
    return tnqs.heavy_hexagonal_lattice(2, 2) if name == "hh22" else tnqs.named_grid((3, 3))


def _rows(pos):
    return torch.as_tensor(np.asarray(pos, dtype=np.int64))


@pytest.mark.parametrize("name, chi, gi", GROUPS, ids=[f"{n}-chi{c}-group{i}" for n, c, i in GROUPS])
def test_bp_sweep_plain_matches_jax_interpret(name, chi, gi):
    plan = JaxPlan.build(_graph(name), bp_schedule="color")
    _, k, t, src_pos, _, in_eids, _ = [g for g in plan.bp_groups if g[1] >= 2][gi]
    rng = np.random.default_rng(100 + gi)
    n_k = len(plan.buckets[k])
    Tk = _rand_c(rng, (n_k, 2) + (chi,) * k)
    M = _rand_c(rng, (plan.num_edges, chi, chi))
    Min = M[in_eids]  # [B, k-1, chi, chi]
    lo = int(src_pos[0])
    planes = jax_bp.plane_layouts(jnp.asarray(Tk.real), jnp.asarray(Tk.imag), k, t)
    mr, mi = jax_bp.bp_sweep_group(*planes, jnp.asarray(Min.real), jnp.asarray(Min.imag), lo=lo, k=k, interpret=True)
    m_jax = np.asarray(mr) + 1j * np.asarray(mi)

    calls = bp_sweep._bp_sweep_group_plain.calls
    m = bp_sweep.bp_sweep_group(torch.as_tensor(Tk), torch.as_tensor(Min), _rows(src_pos), t).numpy()
    assert bp_sweep._bp_sweep_group_plain.calls == calls + 1
    assert m.shape == (len(src_pos), chi, chi)
    # float32 sums over d * chi^(k-1) <= 1024 products in another order:
    # ~sqrt(1024) ulps of the largest entry, bounded at 1e-5
    assert np.max(np.abs(m - m_jax)) < 1e-5 * np.max(np.abs(m_jax))


@pytest.mark.parametrize("k, t", [(2, 1), (3, 0), (3, 2)])
def test_bp_sweep_plain_takes_gathered_rows(k, t):
    """Rows out of order, as the wavefront schedule gathers them, against
    the JAX kernel on the same rows laid out contiguously."""
    rng = np.random.default_rng(7 + k + t)
    Tk = _rand_c(rng, (5, 2) + (8,) * k)
    Min = _rand_c(rng, (3, k - 1, 8, 8))
    pos = np.array([4, 0, 2])
    planes = jax_bp.plane_layouts(jnp.asarray(Tk[pos].real), jnp.asarray(Tk[pos].imag), k, t)
    mr, mi = jax_bp.bp_sweep_group(*planes, jnp.asarray(Min.real), jnp.asarray(Min.imag), lo=0, k=k, interpret=True)
    m_jax = np.asarray(mr) + 1j * np.asarray(mi)
    m = bp_sweep.bp_sweep_group(torch.as_tensor(Tk), torch.as_tensor(Min), _rows(pos), t).numpy()
    # float32 sums over <= 2 * 8^2 products in another order
    assert np.max(np.abs(m - m_jax)) < 1e-5 * np.max(np.abs(m_jax))


@pytest.fixture(scope="module")
def converged():
    """A random bond-3 state at chi=8 on heavy_hexagonal_lattice(2, 2)
    (`tests/test_ops.py:107`), its packed initial arrays, and JAX engines
    with the XLA and the interpret-mode kernel BP sweeps after
    bp_update(maxiter=10)."""
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    psi = tnqs.random_tensornetworkstate(
        g, "S=1/2", bond_dimension=3, dtype=np.complex64, rng=np.random.default_rng(11)
    )
    engines = {kern: JaxEngine(psi, chi=8, bp_kernel=kern) for kern in ("xla", "interpret")}
    init = ({k: np.asarray(v) for k, v in engines["xla"].T.items()}, np.asarray(engines["xla"].M))
    for eng in engines.values():
        eng.bp_update(maxiter=10)
    return g, init, engines


def _carry(g, eng, **options):
    return LatticeEngine.from_arrays(
        _port(g), {k: np.asarray(v) for k, v in eng.T.items()}, np.asarray(eng.M), chi=eng.chi,
        device="cpu", bp_schedule=eng.plan.bp_schedule, **options,
    )


@pytest.mark.parametrize("kern, jax_kern", [("kernel", "interpret"), ("einsum", "xla")])
def test_bp_update_matches_jax(converged, kern, jax_kern):
    g, (T0, M0), engines = converged
    je = engines[jax_kern]
    pe = LatticeEngine.from_arrays(_port(g), T0, M0, chi=8, device="cpu", bp_schedule=je.plan.bp_schedule,
                                   bp_kernel=kern)
    calls = bp_sweep._bp_sweep_group_plain.calls
    pe.bp_update(maxiter=10)
    # every degree >= 2 group takes the kernel route, the wavefront
    # schedule's gathered ones too (JAX keeps those on einsum)
    ran = bp_sweep._bp_sweep_group_plain.calls - calls
    per_sweep = sum(1 for g in pe.plan.bp_groups if g[1] >= 2)
    assert ran == (per_sweep * pe.bp_iterations if kern == "kernel" else 0)
    assert 1 <= pe.bp_iterations <= 10 and np.isfinite(pe.bp_eps)
    # the bound of tests/test_ops.py:123: same update order, float32 rounding
    assert np.max(np.abs(pe.M.numpy() - np.asarray(je.M))) < 5e-6


def test_freenergy_and_partitionfunction_match_jax(converged):
    g, _, engines = converged
    je = engines["xla"]
    pe = _carry(g, je)
    f_j, f_p = je.freenergy(), pe.freenergy()
    assert type(f_p) is type(f_j)
    # log Z sums ~100 float32 logs of vertex and edge scalars: ~1e-7 relative
    # each, bounded at 1e-5 of |log Z|
    assert abs(f_p - f_j) < 1e-5 * max(1.0, abs(f_j))
    z_j, z_p = je.partitionfunction(), pe.partitionfunction()
    assert abs(z_p - z_j) < 1e-5 * abs(z_j)


def test_freenergy_is_minus_inf_on_a_zero_edge_scalar(converged):
    g, _, engines = converged
    pe = _carry(g, engines["xla"])
    u, v = pe.plan.graph.edges()[0]
    pe.M[pe.plan.edge_ids[(u, v)]] = 0
    assert pe.freenergy() == -np.inf
    assert pe.partitionfunction() == 0.0


def test_rescale_and_normalize_match_jax(converged):
    g, _, engines = converged
    je = engines["xla"]
    pe = _carry(g, je)
    T_j, M_j = je._rescaled(je.T, je.M)
    pe.rescale()
    # unit-overlap messages and unit-scalar vertices, float32 rounding
    assert np.max(np.abs(pe.M.numpy() - np.asarray(M_j))) < 1e-5
    for k in pe.T:
        assert np.max(np.abs(pe.T[k].numpy() - np.asarray(T_j[k]))) < 1e-5 * np.max(np.abs(np.asarray(T_j[k])))
    # Z_BP = 1 after normalize: ~100 logs of 1 + O(1e-7) each
    pe = _carry(g, je, bp_kernel="kernel")
    pe.normalize(bp_maxiter=10)
    assert abs(pe.freenergy()) < 1e-5
    # the real branch: sign-flipped pair overlaps, magnitude-normalized vertices
    T_r = {k: np.real(np.asarray(v)).copy() for k, v in je.T.items()}
    M_r = np.real(np.asarray(je.M)).copy()
    T_rj, M_rj = je._rescaled({k: jnp.asarray(v) for k, v in T_r.items()}, jnp.asarray(M_r))
    T_rp, M_rp = pe._rescaled({k: torch.as_tensor(v) for k, v in T_r.items()}, torch.as_tensor(M_r))
    assert M_rp.dtype == torch.float32
    assert np.max(np.abs(M_rp.numpy() - np.asarray(M_rj))) < 1e-5
    for k in T_rp:
        assert np.max(np.abs(T_rp[k].numpy() - np.asarray(T_rj[k]))) < 1e-5 * np.max(np.abs(np.asarray(T_rj[k])))


@pytest.mark.parametrize("ops", [("Z", "Z"), ("X", "Y")])
def test_expect_2site_matches_jax(converged, ops):
    g, _, engines = converged
    je = engines["xla"]
    ref = je.expect_2site(*ops)
    got = _carry(g, je).expect_2site(*ops)
    assert list(got) == list(ref)
    # ratios of two float32 contractions of the two-site region
    assert max(abs(got[e] - ref[e]) for e in ref) < 1e-5


@pytest.mark.parametrize("alpha", [1, 2])
def test_bond_entropies_match_jax(converged, alpha):
    g, _, engines = converged
    je = engines["xla"]
    edges = g.edges()[:5]
    ref = je.bond_entropies(alpha)
    pe = _carry(g, je)
    got = pe.bond_entropies(alpha)
    assert list(got) == list(ref)
    # float32 eigenvalues of [8, 8] bond matrices, ~1e-7 each; an
    # eigenvalue at the 10-eps cut moves an entropy by ~1e-5 at most
    assert max(abs(got[e] - ref[e]) for e in ref) < 1e-4
    assert pe.bond_entropies(alpha, edges) == {e: got[e] for e in edges}


@pytest.mark.parametrize("name", sorted(_OPS_2))
def test_op_matrix_matches_tnqs(name):
    np.testing.assert_array_equal(tt.op_matrix(name), jax_op_matrix(name, 2))


def test_op_matrix_rejects_unknown_names():
    with pytest.raises(ValueError):
        tt.op_matrix("Rx")


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is taken, not refused")
    p = _port(tnqs.heavy_hexagonal_lattice(2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        LatticeEngine(p, chi=4)
    T, M = LatticeEngine(p, chi=4, device="cpu").to_arrays()
    with pytest.raises(RuntimeError, match="CUDA"):
        LatticeEngine.from_arrays(p, T, M, chi=4)


def test_bp_kernel_switch():
    p = _port(tnqs.heavy_hexagonal_lattice(2, 2))
    assert LatticeEngine(p, chi=4, device="cpu").bp_kernel == "einsum"  # "auto" off CUDA
    assert LatticeEngine(p, chi=4, device="cpu", bp_kernel="kernel").bp_kernel == "kernel"
    with pytest.raises(ValueError):
        LatticeEngine(p, chi=4, device="cpu", bp_kernel="xla")
    # the layer step's BP follows bp_kernel as bp_update does; chi=8 is the
    # smallest bond the kernel takes
    layer = tt.heavy_hex_kicked_ising_layer(p, np.pi / 4, 0.4)
    eng = LatticeEngine(p, chi=8, device="cpu", bp_kernel="einsum")
    calls = bp_sweep._bp_sweep_group_plain.calls
    eng.evolve(layer, cutoff=1e-12, bp_maxiter=5)
    eng.bp_update(maxiter=2)
    assert bp_sweep._bp_sweep_group_plain.calls == calls
    eng = LatticeEngine(p, chi=8, device="cpu", bp_kernel="kernel")
    eng.evolve(layer, cutoff=1e-12, bp_maxiter=5)
    assert bp_sweep._bp_sweep_group_plain.calls > calls


@pytest.mark.parametrize(
    "k, chi, admitted",
    [(2, 64, True), (3, 64, True), (4, 16, True), (6, 8, True), (2, 512, True), (2, 12, False),
     (1, 64, False), (4, 128, False), (2, 1024, False)],
)
def test_supports_group(k, chi, admitted):
    assert bp_sweep.supports_group(k, chi, torch.complex64) is admitted
    assert not bp_sweep.supports_group(k, chi, torch.complex128)


def test_supports_group_admits_every_tpu_group():
    # the kernel's gate is the TPU kernel's, no wider
    for k in range(1, 9):
        for chi in range(1, 520):
            assert bp_sweep.supports_group(k, chi, torch.complex64) == jax_bp.supports_group(
                k, chi, 2, np.complex64), (k, chi)


def test_bp_sweep_wrapper_routes_by_device():
    rng = np.random.default_rng(3)
    Tk = torch.as_tensor(_rand_c(rng, (4, 2, 8, 8, 8)))
    Min = torch.as_tensor(_rand_c(rng, (2, 2, 8, 8)))
    rows = _rows([1, 2])
    launches, calls = bp_sweep.bp_sweep_group.launches, bp_sweep._bp_sweep_group_plain.calls
    # an empty group launches nothing and runs nothing
    assert bp_sweep.bp_sweep_group(Tk, Min[:0], rows[:0], 0).shape == (0, 8, 8)
    bp_sweep.bp_sweep_group(Tk, Min, rows, 2)
    assert bp_sweep.bp_sweep_group.launches == launches == 0
    assert bp_sweep._bp_sweep_group_plain.calls == calls + 1
    for bad in (_rows([3, 4]), _rows([-1, 0]), rows.int(), rows[:1]):
        with pytest.raises(ValueError):  # past the bucket, negative, int32, too few
            bp_sweep.bp_sweep_group(Tk, Min, bad, 0)
    # the launcher takes CUDA tensors only and never falls back; any device
    # but the CPU goes to it
    with pytest.raises(ValueError):
        bp_sweep._bp_sweep_group_cuda(Tk, Min, rows, 0)
    meta_T = torch.empty(Tk.shape, dtype=Tk.dtype, device="meta")
    meta_M = torch.empty(Min.shape, dtype=Min.dtype, device="meta")
    with pytest.raises(ValueError):
        bp_sweep.bp_sweep_group(meta_T, meta_M, rows.to("meta"), 0)
    assert bp_sweep._bp_sweep_group_plain.calls == calls + 1
