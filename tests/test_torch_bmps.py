"""tnqs_torch.bmps_engine against tnqs.bmps_engine on the CPU: the column
plans, the contraction paths, the truncation and step blocks, and the
public API on line plans with exact-SVD emits.

States are made with the JAX package (the flex tier's simple update on
small grids) and carried into the port as packed arrays
(`torch_bmps_cases.carry`), so both packages hold one state in one layout.

Tolerances: 2e-5 absolute on complex64 expectation values and 1e-10 on
complex128 ones (`torch_bmps_cases.Z_TOL`); the blocks are compared on
gauge-free products at float32 rounding relative to their scale.  The
sketch path is in `test_torch_bmps_sketch.py`, ring plans in
`test_torch_bmps_ring.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import opt_einsum

import tnqs
import tnqs.bmps_engine as JB
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.engine import LatticePlan as JaxPlan

import tnqs_torch.bmps_engine as PB
from tnqs_torch.engine import LatticePlan
from tnqs_torch.utils.einsum_cache import ceinsum, contract_path
from torch_bmps_cases import Z_TOL, carry, flex_state, port_graph, random_engines

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grid():
    """The entangled grid state of `tests/test_bmps_engine.py:18` on the 3x3
    grid (a middle column with cross bonds on both sides), in both
    packages."""
    g = tnqs.named_grid((3, 3))
    st = flex_state(g)
    je = JaxEngine(st, chi=4)
    return g, st, je, carry(je)


def _c(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


# ----------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "maker",
    [lambda: tnqs.named_grid((4, 4)), lambda: tnqs.heavy_hexagonal_lattice(2, 2), tnqs.eagle_lattice,
     lambda: tnqs.named_grid((5, 7))],
    ids=["grid4x4", "heavyhex2x2", "eagle", "grid5x7"],
)
def test_column_plan_matches_jax(maker):
    g = maker()
    jp = JB.ColumnPlan.build(JaxPlan.build(g))
    pp = PB.ColumnPlan.build(LatticePlan.build(port_graph(g)))
    assert pp.columns == jp.columns
    assert pp.cross == jp.cross
    assert pp.col_of == jp.col_of and pp.order_in_col == jp.order_in_col
    assert pp.periodic == jp.periodic is False
    for (u, w) in g.edges():
        assert pp.side(u, w) == jp.side(u, w) and pp.side(w, u) == jp.side(w, u)


def _guard_graphs():
    """Malformed lattices, each with the message both packages raise."""
    path = [(1, 1), (1, 2), (1, 3)]
    skip = [(path[0], path[1]), (path[1], path[2]), (path[0], path[2])]  # a column that is not a path
    far = [((c, 1), (c + 1, 1)) for c in range(1, 4)] + [((1, 1), (3, 1))]  # spans two columns
    crossing = [((1, 1), (1, 2)), ((2, 1), (2, 2)), ((1, 1), (2, 2)), ((1, 2), (2, 1))]
    double = [((1, 1), (1, 2)), ((2, 1), (2, 2)), ((1, 1), (2, 1)), ((1, 1), (2, 2))]
    return [(skip, "not a path"), (far, "non-adjacent columns"), (crossing, "crossing edges"),
            (double, "multiple cross bonds")]


@pytest.mark.parametrize("edges, match", _guard_graphs(), ids=["path", "span", "crossing", "double"])
def test_column_plan_guards_match_jax(edges, match):
    verts = sorted({v for e in edges for v in e})
    jg = tnqs.NamedGraph(verts)
    for u, w in edges:
        jg.add_edge(u, w)
    with pytest.raises(ValueError, match=match):
        JB.ColumnPlan.build(JaxPlan.build(jg))
    with pytest.raises(ValueError, match=match):
        PB.ColumnPlan.build(LatticePlan.build(port_graph(jg)))


# ----------------------------------------------------------------------
# contraction paths
# ----------------------------------------------------------------------

# the tier's multi-operand expressions at chi = 64, rank 16 (+8 oversampled)
BMPS_EXPRESSIONS = {
    "qpab,plmP,saAlr,sbBmR,PABx->qrRx": [(16, 16, 64, 64), (16, 64, 64, 16), (2, 64, 64, 64, 1), (2, 64, 64, 64, 1),
                                         (16, 64, 64, 24)],
    "qpab,plmP,saAlr,sbBmR,qrRx->PABx": [(16, 16, 64, 64), (16, 1, 1, 16), (2, 64, 64, 1, 64), (2, 64, 64, 1, 64),
                                         (16, 64, 64, 24)],
    "pPab,plmq,PrRQ,saAlr,sbBmR->qQAB": [(16, 16, 64, 64), (16, 64, 64, 16), (16, 1, 1, 16), (2, 64, 64, 64, 1),
                                         (2, 64, 64, 64, 1)],
    "qpab,plmP,saAl,sbBm->qPAB": [(16, 16, 64, 64), (16, 64, 64, 16), (2, 64, 64, 64), (2, 64, 64, 64)],
    "qpab,plmP,saAlr,sbBmR->qrRPAB": [(1, 1, 1, 1), (1, 1, 1, 1), (2, 1, 8, 1, 8), (2, 1, 8, 1, 8)],
    "qpa,plP,aAlr,PAx->qrx": [(16, 16, 64), (16, 64, 16), (64, 64, 64, 1), (16, 64, 24)],
    "qpa,plP,aAl->qPA": [(16, 16, 64), (16, 64, 16), (64, 64, 64)],
}


@pytest.mark.parametrize("expr", list(BMPS_EXPRESSIONS))
def test_ceinsum_path_cost_is_opt_einsums_optimum(expr):
    shapes = BMPS_EXPRESSIONS[expr]
    _, flops, peak = contract_path(expr, shapes)
    info = opt_einsum.contract_path(expr, *shapes, shapes=True, optimize="optimal")[1]
    assert flops == info.opt_cost
    assert peak <= info.largest_intermediate


@pytest.mark.parametrize("expr", list(BMPS_EXPRESSIONS))
def test_ceinsum_values(expr):
    rng = np.random.default_rng(len(expr))
    # the expression's index structure at small sizes (2..4 per index)
    inputs = expr.split("->")[0].split(",")
    sizes = {c: int(rng.integers(2, 5)) for c in set("".join(inputs))}
    ops = [_c(rng, tuple(sizes[c] for c in term)) for term in inputs]
    got = ceinsum(expr, *(torch.from_numpy(o) for o in ops)).numpy()
    want = np.einsum(expr, *(o.astype(np.complex128) for o in ops))
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


def test_ceinsum_rejects_mismatched_sizes():
    with pytest.raises(ValueError, match="index 'b'"):
        contract_path("ab,bc,cd->ad", [(2, 3), (4, 5), (5, 2)])


# ----------------------------------------------------------------------
# truncation and step blocks
# ----------------------------------------------------------------------


def test_orth_and_rand_trunc_match_jax():
    """`_orth` and `_rand_trunc_factored` on shared complex128 inputs (the
    Gram eigh squares the spectrum's range, which float32 would not
    resolve to a tight bound), with and without oversampling; the factors
    are compared through their product, free of the eigenvectors' gauge."""
    rng = np.random.default_rng(11)
    m, n, k = 60, 50, 6
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((U[:, :n] * 0.7 ** np.arange(n)) @ V.T).astype(np.complex128)
    Y = _c(rng, (m, 9), np.complex128)
    Qj = np.asarray(JB._orth(jnp.asarray(Y)))
    Qp = PB._orth(torch.from_numpy(Y)).numpy()
    assert np.max(np.abs(Qp - Qj)) < 1e-10
    assert np.max(np.abs(Qp.conj().T @ Qp - np.eye(9))) < 1e-10
    Aj, Ap = jnp.asarray(A), torch.from_numpy(A)
    for extra in (0, 10):
        om = _c(rng, (n, k + extra), np.complex128)
        Qj, Cj, lj = JB._rand_trunc_factored(lambda x: Aj @ x, lambda w: Aj.conj().T @ w, jnp.asarray(om), (m,),
                                             keep=k)
        Qp, Cp, lp = PB._rand_trunc_factored(lambda x: Ap @ x, lambda w: Ap.mH @ w, torch.from_numpy(om), (m,),
                                             keep=k)
        want = np.asarray(jnp.einsum("mx,nx->mn", Qj, Cj)) * np.exp(float(lj))
        got = torch.einsum("mx,nx->mn", Qp, Cp).numpy() * np.exp(float(lp))
        assert abs(float(lp) - float(lj)) < 1e-10
        assert np.max(np.abs(got - want)) < 1e-10


def test_round_chain_matches_jax():
    """A chain of emitted tensors rounded to rank 3: the same bond
    dimensions, and the same chain once contracted."""
    rng = np.random.default_rng(5)
    dims = [(1, 2, 2, 6), (6, 2, 2, 7), (7, 2, 2, 5), (5, 2, 2, 1)]
    chain = [_c(rng, d) for d in dims]
    rj = [np.asarray(t) for t in JB._round_chain([jnp.asarray(t) for t in chain], 3)]
    rp = [t.numpy() for t in PB._round_chain([torch.from_numpy(t) for t in chain], 3)]
    assert [t.shape for t in rp] == [t.shape for t in rj]

    def contract(ts):
        out = ts[0]
        for t in ts[1:]:
            out = np.tensordot(out, t, axes=(-1, 0))
        return out

    want = contract(rj)
    assert np.max(np.abs(contract(rp) - want)) < 1e-5 * np.max(np.abs(want))


def test_ladder_transfer_explicit_matches_generic():
    """The memory-aware ladder orders (one cross bond on either side, both
    cross bonds, and the up step's axis swap), forced by a budget of 1,
    against the one-shot contraction (`tests/test_bmps_engine.py:314`)."""
    rng = np.random.default_rng(0)

    def t(*sh):
        return torch.from_numpy(_c(rng, sh))

    p, P, q, Q, chi, s = 3, 4, 5, 6, 7, 2
    gen = "pPab,plmq,PrRQ,saAlr,sbBmR->qQAB"
    for l, r in ((1, 8), (8, 1), (8, 8)):
        G, Ml, Mr = t(p, P, chi, chi), t(p, l, l, q), t(P, r, r, Q)
        K, B = t(s, chi, chi, l, r), t(s, chi, chi, l, r)
        ref = torch.einsum(gen, G, Ml, Mr, K, B)
        out = PB.BMPSEngine._ladder_transfer(G, Ml, Mr, K, B, budget=1)
        assert (ref - out).abs().max() < 1e-5 * ref.abs().max()
        D = t(q, Q, chi, chi)
        ref_up = torch.einsum("qQAB,plmq,PrRQ,saAlr,sbBmR->pPab", D, Ml, Mr, K, B)
        out_up = PB.BMPSEngine._ladder_transfer(D, Ml.permute(3, 1, 2, 0), Mr.permute(3, 1, 2, 0),
                                                K.permute(0, 2, 1, 3, 4), B.permute(0, 2, 1, 3, 4), budget=1)
        assert (ref_up - out_up).abs().max() < 1e-5 * ref_up.abs().max()


def _gauge_free(Q, C, logn, m_axes):
    """The factorization's product Q C^T exp(logn) as one array."""
    Q, C = np.asarray(Q), np.asarray(C)
    x = Q.shape[-1]
    return (Q.reshape(-1, x) @ C.reshape(-1, x).T).reshape(Q.shape[:m_axes] + C.shape[:-1]) * np.exp(float(logn))


@pytest.mark.parametrize("budget", [2**26, 64], ids=["one-shot", "chunked"])
def test_step_blocks_match_jax(budget):
    """Every zip step block on shared inputs: the doubled and single-layer
    pass steps (chunked past a small budget), the exact-SVD emits, and the
    sketched emits with a shared sketch (chunked sketch axis)."""
    rng = np.random.default_rng(3)
    q, p, a, b, l, m, P, s, A, Bd, r, R = 3, 2, 3, 3, 2, 2, 4, 2, 3, 3, 2, 2
    C, Min = _c(rng, (q, p, a, b)), _c(rng, (p, l, m, P))
    K, Bt = _c(rng, (s, a, A, l, r)), _c(rng, (s, b, Bd, m, R))
    J, T = jnp.asarray, torch.from_numpy
    scale = lambda x: np.max(np.abs(x))  # noqa: E731

    want = np.asarray(JB._pass_step_block(J(C), J(Min), J(K[..., 0]), J(Bt[..., 0]), budget=budget))
    got = PB._pass_step_block(T(C), T(Min), T(K[..., 0]).contiguous(), T(Bt[..., 0]).contiguous(), budget=budget)
    assert np.max(np.abs(got.numpy() - want)) < 1e-5 * scale(want)

    want = _gauge_free(*JB._exact_emit_step_block(J(C), J(Min), J(K), J(Bt), keep=5), 3)
    got = _gauge_free(*PB._exact_emit_step_block(T(C), T(Min), T(K), T(Bt), keep=5), 3)
    assert np.max(np.abs(got - want)) < 1e-5 * scale(want)

    om = _c(rng, (P, A, Bd, 6))
    xc = 2 if budget == 64 else 6
    want = _gauge_free(*JB._emit_step_block(J(C), J(Min), J(K), J(Bt), J(om), xc=xc, keep=4, power_iters=1), 3)
    got = _gauge_free(*PB._emit_step_block(T(C), T(Min), T(K), T(Bt), T(om), xc=xc, keep=4, power_iters=1), 3)
    assert np.max(np.abs(got - want)) < 1e-4 * scale(want)

    C1, Min1, K1 = _c(rng, (q, p, a)), _c(rng, (p, l, P)), _c(rng, (a, A, l, r))
    want = np.asarray(JB._pass1_step_block(J(C1), J(Min1), J(K1[..., 0]), budget=budget))
    got = PB._pass1_step_block(T(C1), T(Min1), T(K1[..., 0]).contiguous(), budget=budget).numpy()
    assert np.max(np.abs(got - want)) < 1e-5 * scale(want)
    want = _gauge_free(*JB._exact_emit1_step_block(J(C1), J(Min1), J(K1), keep=4), 2)
    got = _gauge_free(*PB._exact_emit1_step_block(T(C1), T(Min1), T(K1), keep=4), 2)
    assert np.max(np.abs(got - want)) < 1e-5 * scale(want)
    om1 = _c(rng, (P, A, 5))
    want = _gauge_free(*JB._emit1_step_block(J(C1), J(Min1), J(K1), J(om1), xc=xc, keep=3, power_iters=1), 2)
    got = _gauge_free(*PB._emit1_step_block(T(C1), T(Min1), T(K1), T(om1), xc=xc, keep=3, power_iters=1), 2)
    assert np.max(np.abs(got - want)) < 1e-4 * scale(want)


# ----------------------------------------------------------------------
# the public API on line plans, exact emits
# ----------------------------------------------------------------------


def test_expect_1site_matches_jax(grid):
    """All vertices, a vertex subset and `split=True` against JAX's fused
    sweep; `split` runs the same code in the port, so it is bit for bit."""
    g, _, je, pe = grid
    zj = JB.BMPSEngine(je, rank=8).expect_1site("Z")
    be = PB.BMPSEngine(pe, rank=8)
    zp = be.expect_1site("Z")
    assert set(zp) == set(zj)
    assert max(abs(zp[v] - zj[v]) for v in zj) < Z_TOL[np.complex64]
    verts = [(1, 2), (3, 1), (2, 3)]
    sub = be.expect_1site("Z", vertices=verts)
    assert list(sub) == verts
    assert all(sub[v] == zp[v] for v in verts)
    assert be.expect_1site("Z", split=True) == zp
    assert be.expect_1site("Z", vertices=verts, split=True) == sub
    assert be.sketch_bytes == 0  # every emit here takes the exact SVD


def test_expect_2site_matches_jax(grid):
    """Adjacent and non-adjacent pairs, both orientations, a duplicate and a
    same-vertex pair (the operator product) in one call; and the guard."""
    _, _, je, pe = grid
    cp = PB.BMPSEngine(pe, rank=8).cplan
    col = cp.columns[1]
    u, w = col[0], col[-1]
    pairs = [(col[0], col[1]), (col[2], col[1]), (u, w), (w, u), (u, w), (u, u)]
    want = JB.BMPSEngine(je, rank=8).expect_2site("Z", "X", pairs=pairs)
    got = PB.BMPSEngine(pe, rank=8).expect_2site("Z", "X", pairs=pairs)
    assert list(got) == list(want)
    assert max(abs(got[k] - want[k]) for k in want) < Z_TOL[np.complex64]
    with pytest.raises(ValueError, match="spans columns"):
        PB.BMPSEngine(pe, rank=8).expect_2site("Z", "Z", pairs=[(cp.columns[0][0], cp.columns[1][0])])


def test_rdm_matches_jax(grid):
    _, _, je, pe = grid
    be = PB.BMPSEngine(pe, rank=8)
    col = be.cplan.columns[2]
    vs = [col[2], col[0]]
    want = np.asarray(JB.BMPSEngine(je, rank=8).rdm(vs))
    got = be.rdm(vs)
    assert got.shape == (4, 4) and got.dtype == np.complex64
    assert np.max(np.abs(got - want)) < Z_TOL[np.complex64]
    rho1 = be.rdm([col[1]])
    z = be.expect_1site("Z", vertices=[col[1]])[col[1]]
    assert abs(np.trace(rho1) - 1) < 1e-6
    assert abs(rho1[0, 0] - rho1[1, 1] - z) < 1e-5
    with pytest.raises(ValueError, match="span columns"):
        be.rdm([be.cplan.columns[0][0], be.cplan.columns[1][0]])


def test_inner_fidelity_lognorm_match_jax():
    """The bilinear sweeps on two 3x3 states (`tests/test_bmps_engine.py:526`)."""
    g = tnqs.named_grid((3, 3))
    ja, jb = JaxEngine(flex_state(g, 0.3), chi=4), JaxEngine(flex_state(g, 0.45), chi=4)
    pa, pb = carry(ja), carry(jb)
    bj, bp = JB.BMPSEngine(jb, rank=10), PB.BMPSEngine(pb, rank=10)
    want, got = complex(bj.inner(ja)), bp.inner(pa)
    assert abs(got - want) < 1e-5 * abs(want)
    assert abs(bp.fidelity(pa) - bj.fidelity(ja)) < 1e-5
    assert abs(bp.lognorm() - bj.lognorm()) < 1e-5
    assert abs(bp.fidelity(pb) - 1.0) < 1e-5
    assert abs(bp.norm_sqr() - np.exp(bp.lognorm())) < 1e-6 * bp.norm_sqr()


def test_complex128_expect_and_norm_match_jax():
    """<Z> and the norm on a complex128 3x3 random state
    (`tests/test_bmps_engine.py:563`), every emit an exact SVD."""
    dtype = np.complex128
    je, pe = random_engines(dtype)
    bj, bp = JB.BMPSEngine(je, rank=3), PB.BMPSEngine(pe, rank=3)
    zj, zp = bj.expect_1site("Z"), bp.expect_1site("Z")
    assert max(abs(zp[v] - zj[v]) for v in zj) < Z_TOL[dtype]
    assert abs(bp.lognorm() - bj.lognorm()) < Z_TOL[dtype]


def test_readout_cost_on_meta_tensors():
    """`tools.bmps_cost` counts a readout without a device: at the w2
    configuration (Eagle chi=8, rank 10) every emit is an exact SVD, so it
    draws no sketch, as phase 8a of `chip_smoke.py` requires on the card;
    at chi=32, rank 4 the larger emits are sketched, rank + oversample
    wide."""
    import tnqs_torch as tt
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.tools.bmps_cost import readout_cost

    g = tt.eagle_lattice()
    w2 = readout_cost(LatticeEngine(g, chi=8, device="meta", bp_schedule="color"), rank=10)
    assert w2["flops"] > 0 and w2["svd"] > 0 and w2["sketches"] == []
    cost = readout_cost(LatticeEngine(g, chi=32, device="meta", bp_schedule="color"), rank=4)
    assert cost["sketches"] and cost["eigh"] > 0
    assert all(shape[-1] <= 4 + 8 for shape in cost["sketches"])
