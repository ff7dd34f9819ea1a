"""tnqs_torch.bmps_engine.BMPSSampler against tnqs.bmps_engine.BMPSSampler
and exact amplitudes, on the CPU (`tests/test_bmps_engine.py:127-186`,
`:480-520`, `:600-625`; `tests/test_ring_bmps.py:204-211`).

The port cannot draw JAX's bits (`cpu_uniforms` against
`jax.random.categorical`), so the replay tests hand JAX's bits to the port
through `uniforms=` (`torch_bmps_cases.replay`): on the same bits both
packages must give the same log q and p/q.  The port's own draws
are held against exact amplitudes.  Each JAX sampler runs once per module,
in a fixture its tests share.

Tolerances: log q within 1e-5 absolute (a sum of ~10 float32 logs of
conditionals that the packages contract in other orders); p/q and the norm
estimate within 1e-4 relative (exp of a sum of float32 logs of ~10 norms,
each rounding differently, and the library SVDs of the exact emits); p/q
against exact amplitudes within 1e-3 and E_q[p/q] within 5e-2, the JAX
tests' bounds.
"""

import numpy as np
import pytest
import torch

import tnqs
import tnqs.bmps_engine as JB
from tnqs.engine import LatticeEngine as JaxEngine

import tnqs_torch as tt
import tnqs_torch.bmps_engine as PB
from tnqs_torch.engine import LatticeEngine
import torch_bmps_cases as cases

torch.set_num_threads(1)

LOGQ_TOL = 1e-5
PQ_TOL = 1e-4


@pytest.fixture(scope="module")
def grid():
    """The 3x3 state of `tests/test_bmps_engine.py:151-179` (Rzz 0.7, Rx 0.6,
    maxdim 2, `bp_update(30)`): (flex state, JAX engine, port engine)."""
    st = cases.flex_state(tnqs.named_grid((3, 3)), theta=0.7, layers=1, maxdim=2, hx=0.6)
    je = JaxEngine(st, chi=2)
    je.bp_update(maxiter=30)
    return st, je, cases.carry(je)


@pytest.fixture(scope="module")
def jax_runs(grid):
    """JAX's samples on the grid: doubled (its `sample_certified`, whose
    direct half is `sample_directly_certified(10, seed=5)`) and factored."""
    _, je, _ = grid
    doubled = JB.BMPSSampler(JB.BMPSEngine(je, rank=8), proj_rank=8)
    factored = JB.BMPSSampler(JB.BMPSEngine(je, rank=8), proj_rank=4, q_mode="factored")
    return {"doubled": (doubled.keys_order, doubled.sample_certified(10, seed=5, cert_rank=8)),
            "factored": (factored.keys_order, factored.sample_directly_certified(10, seed=5))}


@pytest.fixture(scope="module")
def cylinder():
    return cases.cylinder()


def _rel(a, b):
    return abs(a - b) / abs(b)


def _port(pe, out=None, keys=None, rank=8, **kw):
    """The port's sampler on `pe`, replaying the bits of JAX's `out`."""
    if out is not None:
        kw["uniforms"] = cases.replay(out, keys)
    return PB.BMPSSampler(PB.BMPSEngine(pe, rank=rank, ring_iters=3), **kw)


@pytest.mark.parametrize("q_mode, proj_rank", [("doubled", 8), ("factored", 4)])
def test_replay_matches_jax(grid, jax_runs, q_mode, proj_rank):
    """On JAX's bits: log q, the draw-time p/q and the norm estimate."""
    keys, want = jax_runs[q_mode]
    sam = _port(grid[2], want, keys, proj_rank=proj_rank, q_mode=q_mode)
    assert sam.keys_order == keys
    got = sam.sample_directly_certified(10, seed=5)
    for a, b in zip(got, want):
        assert a["bitstring"] == b["bitstring"]
        assert abs(a["logq"] - b["logq"]) <= LOGQ_TOL
        assert _rel(a["poverq"], b.get("poverq_direct", b["poverq"])) <= PQ_TOL
        assert _rel(a["norm_estimate"], b["norm_estimate"]) <= PQ_TOL


def test_replay_certified_matches_jax(grid, jax_runs):
    """`sample_certified` on JAX's bits: the independent single-layer
    certificate (cert_rank 8) and the draw-time one."""
    keys, want = jax_runs["doubled"]
    got = _port(grid[2], want, keys, proj_rank=8).sample_certified(10, seed=5, cert_rank=8)
    for a, b in zip(got, want):
        assert a["bitstring"] == b["bitstring"]
        assert _rel(a["poverq"], b["poverq"]) <= PQ_TOL
        assert _rel(a["poverq_direct"], b["poverq_direct"]) <= PQ_TOL


def test_replay_ring_matches_jax(cylinder):
    """The ring plan (6x3 cylinder, rank 8, three ring passes, doubled
    proj_rank 8): the ghost-reference divisor and the wrap-cut start."""
    _, pe, je = cylinder
    js = JB.BMPSSampler(JB.BMPSEngine(je, rank=8, ring_iters=3), proj_rank=8)
    want = js.sample_directly_certified(5, seed=11)
    got = _port(pe, want, js.keys_order, proj_rank=8).sample_directly_certified(5, seed=11)
    for a, b in zip(got, want):
        assert a["bitstring"] == b["bitstring"]
        assert abs(a["logq"] - b["logq"]) <= LOGQ_TOL
        assert _rel(a["poverq"], b["poverq"]) <= PQ_TOL
        assert _rel(a["norm_estimate"], b["norm_estimate"]) <= PQ_TOL


@pytest.mark.parametrize("q_mode, proj_rank", [("doubled", 8), ("factored", 4)])
def test_own_draws_match_exact_amplitudes(grid, q_mode, proj_rank):
    """The port's own draws (`cpu_uniforms`): p/q = |<x|psi>|^2 / (q(x) Z_BP)
    from exact contraction, and E_q[p/q] = <psi|psi> / Z_BP
    (`tests/test_bmps_engine.py:176-186`)."""
    st, _, pe = grid
    p_exact = cases.exact_probability(st)
    z_bp = abs(complex(tnqs.norm_sqr(st, alg="bp")))
    nrm = abs(complex(tnqs.norm_sqr(st, alg="exact")))
    out = _port(pe, proj_rank=proj_rank, q_mode=q_mode).sample_directly_certified(10, seed=5)
    assert len({tuple(o["bitstring"].values()) for o in out}) > 1
    for o in out:
        want = p_exact(o["bitstring"]) / np.exp(o["logq"]) / z_bp
        assert _rel(o["poverq"], want) < 1e-3
    pq = np.array([o["poverq"] for o in out])
    assert abs(pq.mean() - nrm / z_bp) / (nrm / z_bp) < 5e-2


@pytest.mark.parametrize("periodic", [False, True], ids=["line", "ring"])
def test_product_state_is_certain(periodic):
    """"↑" everywhere: every bit 0 with q = 1, and p/q = 1 within 1e-5
    (`tests/test_bmps_engine.py:127-140`)."""
    g = tnqs.named_grid((6, 3) if periodic else (3, 3), periodic=(periodic, False))
    pe = LatticeEngine(cases.port_graph(g), chi=2, device="cpu")
    pe.bp_update(maxiter=10)
    sam = PB.BMPSSampler(PB.BMPSEngine(pe, rank=4), proj_rank=4)
    assert sam.bmps.cplan.periodic == periodic
    for o in sam.sample_directly_certified(6, seed=3):
        assert abs(o["poverq"] - 1.0) < 1e-5
        assert abs(o["logq"]) < 1e-5
        assert all(b == 0 for b in o["bitstring"].values())


@pytest.mark.parametrize("certified", [False, True], ids=["direct", "certified"])
def test_chunking_is_invariant(grid, certified):
    """7 samples in groups of 3 (the last padded) and all at once: the same
    bits, p/q within 1e-6 (the lanes of a group are contracted together,
    so other group widths may round differently)."""
    sam = _port(grid[2], proj_rank=8)
    run = sam.sample_certified if certified else sam.sample_directly_certified
    full, chunked = run(7, seed=9), run(7, seed=9, chunk=3)
    for a, b in zip(full, chunked):
        assert a["bitstring"] == b["bitstring"]
        assert _rel(b["poverq"], a["poverq"]) <= 1e-6
        if certified:
            assert _rel(b["poverq_direct"], a["poverq_direct"]) <= 1e-6


def test_guards_raise(grid, cylinder):
    """Factored q and independent certificates on ring plans raise
    NotImplementedError, as JAX's (`tnqs/bmps_engine.py:1587`, `:1936`)."""
    ring = PB.BMPSEngine(cylinder[1], rank=4)
    with pytest.raises(NotImplementedError, match="factored"):
        PB.BMPSSampler(ring, proj_rank=4, q_mode="factored")
    with pytest.raises(NotImplementedError, match="re-certification"):
        PB.BMPSSampler(ring, proj_rank=4).sample_certified(2, seed=0)
    with pytest.raises(ValueError, match="q_mode"):
        PB.BMPSSampler(PB.BMPSEngine(grid[2], rank=4), q_mode="tripled")


def test_conditional_law_and_draw():
    """The law: a collapsed diagonal (trace <= 1e-25) gives the uniform law,
    negative entries clip to 0 and every entry holds the 1e-12 floor, the
    law sums to 1.  The draw: on a grid of 1000 uniforms the inverse CDF
    returns each bit at its share of the law, within a grid step."""
    q, tr = PB.conditional_law(torch.tensor([1e-27, -3e-27]))
    assert torch.equal(tr, torch.tensor(1e-27)) and torch.equal(q, torch.tensor([0.5, 0.5]))
    q, _ = PB.conditional_law(torch.tensor([0.25, -0.1, 0.0, 0.75]))
    assert float(q.sum()) == pytest.approx(1.0, abs=1e-7)
    assert float(q[1]) == pytest.approx(1e-12, rel=1e-6) and float(q[2]) == pytest.approx(1e-12, rel=1e-6)
    assert float(q[0]) == pytest.approx(0.25, rel=1e-6)
    law = torch.tensor([0.2, 0.5, 0.3])
    u = (torch.arange(1000, dtype=torch.float32) + 0.5) / 1000
    bits = torch.stack([PB.inverse_cdf(law, x) for x in u])
    assert bits.dtype == torch.int64
    share = torch.bincount(bits, minlength=3).float() / 1000
    assert torch.allclose(share, law, atol=1e-3)
    # the end values take the end bits under any floored law (how the tests
    # replay JAX's bits), and none is past the last bit
    for q in (law, PB.conditional_law(torch.tensor([1.0, 0.0, 0.0]))[0],
              PB.conditional_law(torch.tensor([0.0, 0.0, 1.0]))[0]):
        assert int(PB.inverse_cdf(q, torch.tensor(0.0))) == 0
        assert int(PB.inverse_cdf(q, torch.tensor(1.0))) == 2
    # the port's draw values: float32 in [0, 1), one per vertex, fixed by (seed, s)
    a = PB.cpu_uniforms(1, 4, 127)
    assert a.dtype == torch.float32 and a.shape == (127,) and 0 <= float(a.min()) and float(a.max()) < 1
    assert torch.equal(a, PB.cpu_uniforms(1, 4, 127)) and not torch.equal(a, PB.cpu_uniforms(1, 5, 127))


def test_eagle_chi64_group_on_meta(monkeypatch):
    """One two-lane group of bench's chi=64 stage (`BMPSEngine(rank=8)`,
    proj_rank 16) on meta tensors: it finishes, so nothing in a group reads
    a device value on the host; each fold is drawn once per call (a second
    group draws none); and every emit takes the exact SVD exactly where
    M N <= min(_EXACT_EMIT_LIMIT, budget), with the norm's budget 2^26 and
    the group's per-lane budget 2^25."""
    routes = []

    def record(route, fn):
        def wrapped(C, Min, K, *rest, **kw):
            if len(rest) and rest[0].dim() == 5:  # doubled: K, B [s, u, d, l, r]
                M_, N_ = C.shape[0] * K.shape[4] * rest[0].shape[4], Min.shape[3] * K.shape[2] * rest[0].shape[2]
            else:  # single layer: K [u, d, l, r]
                M_, N_ = C.shape[0] * K.shape[3], Min.shape[2] * K.shape[1]
            routes.append((route, M_ * N_, record.budget))
            return fn(C, Min, K, *rest, **kw)
        return wrapped

    for name, route in (("_exact_emit_step_block", "exact"), ("_emit_step_block", "sketch"),
                        ("_exact_emit1_step_block", "exact"), ("_emit1_step_block", "sketch")):
        monkeypatch.setattr(PB, name, record(route, getattr(PB, name)))
    drawn = []

    def sketch(code, shape):
        drawn.append((code, tuple(shape)))
        return torch.empty(shape, dtype=torch.complex64, device="meta")

    eng = LatticeEngine(tt.eagle_lattice(), chi=64, device="meta", bp_schedule="color")
    sam = PB.BMPSSampler(PB.BMPSEngine(eng, rank=8, sketch=sketch), proj_rank=16)
    u = torch.zeros((2, len(sam.keys_order)), device="meta")
    budget = sam._lane_budget(2)
    assert budget == 2**25
    with sam.bmps.sketches_cached():
        record.budget = PB._EINSUM_BUDGET
        norm = sam._norm()
        n_norm = len(drawn)
        record.budget = budget
        bits, logq, poverq = sam._group(norm, u, budget)
        n_group = len(drawn)
        sam._group(norm, u, budget)
    assert bits.shape == (2, 127) and bits.dtype == torch.int64 and logq.shape == poverq.shape == (2,)
    assert logq.dtype == poverq.dtype == torch.float64  # the log sums in float64 (`BMPSSampler._zero`)
    assert len(drawn) == n_group and len(set(drawn)) == len(drawn)  # each fold once, none again
    assert n_norm == 21 and n_group - n_norm == 21  # every emit past the exact limit, each way
    assert sam.bmps._sketch_cache is None  # freed with the call
    assert {r for r, _, _ in routes} == {"exact", "sketch"}
    for route, size, b in routes:
        assert (route == "exact") == (size <= min(PB._EXACT_EMIT_LIMIT, b)), (route, size, b)
