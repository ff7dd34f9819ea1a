"""tnqs_torch.parallel.bmps_ring on gloo ranks on the CPU, against the JAX
package's `tnqs.parallel.bmps_ring` and the port's unsharded `BMPSEngine`
and `BMPSSampler`, on the same states (evolved by the port and carried
into a JAX engine of the same plan, as `torch_bmps_cases.cylinder`).  The
ranks are two `RankPool`s, one spawn each for the module (bodies in
`tests/torch_parallel_bmps_cases.py`): 4 processes and 3.  A case submits
its ranks' work before it runs its references, so the two overlap.

At these sizes (chi=2, rank 3-16) every emit is an exact SVD below
`_EXACT_EMIT_LIMIT`, so no sketch enters a comparison: each rank counts its
sketch draws and the tests require none.  The samplers' JAX bits reach the
ranks through `uniforms=` (`torch_parallel_bmps_cases.Replay`).

Tolerances: <Z> against the port's unsharded engine 1e-6 (the same zips in
the same order, bit for bit expected), against JAX `Z_TOL` (2e-5); the
ring relay within 2e-3 of the unsharded relaxation and 6e-3 of exact (the
bounds of `tests/test_ring_bmps.py:103-124`); samples as
`tests/test_torch_bmps_sample.py` (log q 1e-5, p/q and the norm estimate
1e-4 relative of JAX's) and p/q within 1e-5 relative of the port's
unsharded sampler, whose bits they share."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnqs
import tnqs.bmps_engine as JB
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.models import heavy_hex_kicked_ising_layer, tfim_layer
from tnqs.parallel import bmps_ring as jring
from tnqs.parallel.mesh import make_mesh as jmake_mesh

import tnqs_torch.bmps_engine as PB
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.parallel import RankPool, ShardedBMPS, ShardedSampler
from tnqs_torch.parallel.bmps_ring import _pack, _unpack, band_bounds, relay_templates

import torch_bmps_cases as bcases
import torch_parallel_bmps_cases as cases
from torch_bmps_cases import Z_TOL, port_graph

torch.set_num_threads(1)

LOGQ_TOL = 1e-5
PQ_TOL = 1e-4


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool3():
    with RankPool(3) as pool:
        yield pool


def _lattice(name):
    """(graph, circuit) of the line-plan cases (`tests/test_parallel.py:234-279`)."""
    if name == "grid8x3":
        g = tnqs.named_grid((8, 3))
        return g, tfim_layer(g, J=0.5, hx=1.0, dt=0.3)
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    return g, heavy_hex_kicked_ising_layer(g, 0.55, 0.4)


def _evolved(g, circuit, layers=2):
    """(port engine, JAX engine) on one state: `layers` layers from "↑" by
    the port, carried into a JAX engine of the same plan."""
    pe = LatticeEngine(port_graph(g), chi=2, device="cpu")
    pe.bp_update(maxiter=10)
    pe.evolve(circuit, num_layers=layers, cutoff=1e-10, bp_maxiter=10)
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JaxEngine(psi, chi=2, dtype=jnp.complex64)
    assert je.plan.bp_schedule == pe.plan.bp_schedule
    T, M = pe.to_arrays()
    je.T, je.M = {k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(M)
    return pe, je


def _ranks_args(pe):
    """A port engine's graph and state as the rank bodies take them."""
    g = pe.plan.graph
    T, M = pe.to_arrays()
    return (list(g.vertices()), list(g.edges())), T, M, pe.chi, pe.plan.bp_schedule


def _same_on_every_rank(out):
    assert all(o == out[0] for o in out[1:])
    return out[0]


def _gap(a, b):
    return max(abs(a[v] - b[v]) for v in b)


# -- the bands and the relay's shapes, no ranks needed ------------------------------------

@pytest.mark.parametrize("name", ["grid8x3", "eagle"])
def test_bands_match_jax(name):
    """`band_bounds` splits the columns as JAX's `ShardedBMPS` does, for every
    mesh size up to one column a rank."""
    g = tnqs.named_grid((8, 3)) if name == "grid8x3" else tnqs.eagle_lattice()
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    jb = JB.BMPSEngine(JaxEngine(psi, chi=2), rank=2)
    nC = len(jb.cplan.columns)
    for D in range(1, min(nC, 8) + 1):
        assert band_bounds(nC, D) == [tuple(int(x) for x in b) for b in jring.ShardedBMPS(jb, jmake_mesh(D)).bands]


def _line_cuts(be):
    """The true cut shapes of the unsharded chains: (left, right) by cut."""
    lefts, rights = be._boundary_mpses(be.engine.T)
    nC = len(be.cplan.columns)
    return ({c: [tuple(t.shape) for t in lefts[c + 1]] for c in range(nC - 1)},
            {c: [tuple(t.shape) for t in rights[c]] for c in range(nC - 1)})


@pytest.mark.parametrize("name", ["grid8x3", "heavyhex22", "eagle", "cylinder"])
def test_relay_templates_are_the_chains_shapes(name):
    """The meta pass's shapes are the real chains': on line plans every cut of
    both unsharded chains; on the ring the stable entry of each of 3 bands
    is what a real zip of the band before it gives from its own stable
    entry, seeded from the BP messages.  The template is every cut's
    elementwise largest shape, as many as the longest cut."""
    if name == "cylinder":
        _, pe, _ = bcases.cylinder()
        be = PB.BMPSEngine(pe, rank=16, ring_iters=4)
    else:
        g = tnqs.eagle_lattice() if name == "eagle" else _lattice(name)[0]
        pe = LatticeEngine(port_graph(g), chi=2, device="cpu")
        be = PB.BMPSEngine(pe, rank=3)
    D = 3
    tL, tR = relay_templates(be, D)
    if name == "cylinder":
        cp, nC = be.cplan, len(be.cplan.columns)
        bands = band_bounds(nC, D)
        for t, direction in ((tL, +1), (tR, -1)):
            for i, (s0, s1) in enumerate(bands):
                cut = cp.cross[(s0 - 1) % nC if direction > 0 else (s1 - 1) % nC]
                seed = _unpack(_pack(be._ring_init(cut, direction < 0, pe.M), t, pe.M), t, t.cuts[i])
                j = (i + direction) % D  # the band this one's exit feeds
                out = seed
                for c in (range(s0, s1) if direction > 0 else range(s1 - 1, s0 - 1, -1)):
                    out, _ = be._zip_column(pe.T, c, out, direction)
                assert [tuple(x.shape) for x in out] == t.cuts[j], (direction, i)
    else:
        want = _line_cuts(be)
        assert (tL.cuts, tR.cuts) == want
    for t in (tL, tR):
        shapes = [s for cut in t.cuts.values() for s in cut]
        assert t.n == max(len(cut) for cut in t.cuts.values())
        assert t.shape == tuple(max(s[i] for s in shapes) for i in range(4))


def test_wrong_device_and_too_few_columns_raise(pool4):
    """The 3x3 grid's 3 columns on 4 ranks: ValueError on every rank, as JAX
    (`tests/test_parallel.py:282-289`); an engine on another device than
    the mesh's rank: ValueError."""
    g = tnqs.named_grid((3, 3))
    pool4.submit(cases.too_few_columns, (list(g.vertices()), list(g.edges())), 2)
    be = PB.BMPSEngine(LatticeEngine(port_graph(g), chi=2, device="cpu"), rank=2)
    elsewhere = SimpleNamespace(size=1, rank=0, device=torch.device("meta"))
    with pytest.raises(ValueError, match="mesh's rank on meta"):
        ShardedBMPS(be, elsewhere)
    with pytest.raises(ValueError, match="mesh's rank on meta"):
        ShardedSampler(PB.BMPSSampler(be, proj_rank=2), elsewhere)
    assert pool4.collect() == ["need >= 1 column per device (3 columns, 4 devices)"] * 4


# -- ShardedBMPS -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grid8x3", "heavyhex22"])
def test_line_plan_matches_unsharded_and_jax(pool4, name):
    """Line plans on 4 ranks, rank 3: the (8, 3) grid (TFIM, 2 layers) and
    heavy-hex (2, 2) (kicked Ising, 2 layers), whose cuts differ in count
    and bond shapes (the padded relay).  <Z> on every vertex within 1e-6
    of the port's unsharded engine and within `Z_TOL` of JAX's
    `ShardedBMPS` on a mesh of 4; the same on every rank."""
    pe, je = _evolved(*_lattice(name))
    pool4.submit(cases.sharded_expect, *_ranks_args(pe), 3, 3)
    zj = jring.ShardedBMPS(JB.BMPSEngine(je, rank=3), jmake_mesh(4)).expect_1site("Z")
    zp = PB.BMPSEngine(pe, rank=3).expect_1site("Z")
    z, draws, relay = _same_on_every_rank(pool4.collect())
    assert draws == 0 and relay["steps"] == 3
    assert set(z) == set(zp) == set(zj)
    assert _gap(z, zp) < 1e-6
    assert _gap(z, {v: complex(x) for v, x in zj.items()}) < Z_TOL[np.complex64]


def test_ring_plan_matches_jax_sharded(pool3):
    """The 6x3 cylinder on 3 ranks (rank 16, `ring_iters=4`: 12 relay
    steps): within `Z_TOL` of JAX's `ShardedBMPS` on a mesh of 3 (the same
    banded relay), within 2e-3 of the port's unsharded relaxation and 6e-3
    of exact contraction at four vertices (`tests/test_ring_bmps.py:103`)."""
    g, pe, je = bcases.cylinder()
    pool3.submit(cases.sharded_expect, *_ranks_args(pe), 16, 4)
    zj = jring.ShardedBMPS(JB.BMPSEngine(je, rank=16, ring_iters=4), jmake_mesh(3)).expect_1site("Z")
    zp = PB.BMPSEngine(pe, rank=16, ring_iters=4).expect_1site("Z")
    st = je.to_state()
    exact = {v: complex(tnqs.expect(st, ("Z", v), alg="exact")).real for v in list(g.vertices())[:4]}
    z, draws, relay = _same_on_every_rank(pool3.collect())
    assert draws == 0 and relay["steps"] == 12
    assert set(z) == set(zp) == set(zj)
    assert _gap(z, {v: complex(x) for v, x in zj.items()}) < Z_TOL[np.complex64]
    assert max(abs(z[v].real - zp[v].real) for v in zp) < 2e-3
    assert max(abs(z[v].real - exact[v]) for v in exact) < 6e-3


# -- ShardedSampler ----------------------------------------------------------------

@pytest.fixture(scope="module")
def sampled():
    """The two sampler cases, each (port engine, JAX's unsharded samples and
    keys order, sampler options, nsamples, seed): the 3x3 grid of
    `tests/test_parallel.py:205` (8 samples, seed 4) and the cylinder of
    `tests/test_torch_bmps_sample.py`'s ring replay (5 samples, seed 11,
    `ring_iters=3`)."""
    st = bcases.flex_state(tnqs.named_grid((3, 3)), theta=0.7, layers=1, maxdim=2, hx=0.6)
    je = JaxEngine(st, chi=2)
    je.bp_update(maxiter=20)
    out = {"grid": (bcases.carry(je), je, dict(rank=8, proj_rank=8, ring_iters=3), 8, 4)}
    _, pe, jc = bcases.cylinder()
    out["cylinder"] = (pe, jc, dict(rank=8, proj_rank=8, ring_iters=3), 5, 11)
    return out


def _jax_samples(je, kw, n, seed):
    js = JB.BMPSSampler(JB.BMPSEngine(je, rank=kw["rank"], ring_iters=kw["ring_iters"]), proj_rank=kw["proj_rank"])
    return js.keys_order, js.sample_directly_certified(n, seed=seed)


@pytest.mark.parametrize("name,draws", [("grid", "port"), ("grid", "jax"), ("cylinder", "port"),
                                        ("cylinder", "jax")])
def test_sharded_sampler(pool4, pool3, sampled, name, draws):
    """`ShardedSampler` on 4 ranks (the grid) and 3 (the cylinder, a ring
    plan: 5 samples padded to 6).  On the port's draws: the unsharded
    sampler's bits, p/q within 1e-5 relative.  On JAX's bits, replayed: log
    q within 1e-5, p/q and the norm estimate within 1e-4 relative of JAX's.
    The same list on every rank."""
    pe, je, kw, n, seed = sampled[name]
    pool = pool4 if name == "grid" else pool3
    args = _ranks_args(pe) + (kw["rank"], kw["proj_rank"], kw["ring_iters"], n, seed)
    if draws == "jax":
        keys, want = _jax_samples(je, kw, n, seed)
        pool.submit(cases.sharded_samples, *args, np.array([[o["bitstring"][v] for v in keys] for o in want]))
    else:
        pool.submit(cases.sharded_samples, *args)
        sam = PB.BMPSSampler(PB.BMPSEngine(pe, rank=kw["rank"], ring_iters=kw["ring_iters"]), proj_rank=kw["proj_rank"])
        keys, want = sam.keys_order, sam.sample_directly_certified(n, seed=seed)
    got, n_draws = _same_on_every_rank(pool.collect())
    assert n_draws == 0 and len(got) == n
    for a, b in zip(got, want):
        assert list(a["bitstring"]) == keys and a["bitstring"] == b["bitstring"]
        if draws == "port":
            assert abs(a["poverq"] - b["poverq"]) <= 1e-5 * abs(b["poverq"])
        else:
            assert abs(a["logq"] - b["logq"]) <= LOGQ_TOL
            assert abs(a["poverq"] - b["poverq"]) <= PQ_TOL * abs(b["poverq"])
            assert abs(a["norm_estimate"] - b["norm_estimate"]) <= PQ_TOL * abs(b["norm_estimate"])
    if draws == "port":
        assert len({tuple(o["bitstring"].values()) for o in got}) > 1
