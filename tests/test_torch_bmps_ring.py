"""tnqs_torch.bmps_engine on ring (periodic) column quotients against
tnqs.bmps_engine and exact contraction, on the CPU
(`tests/test_ring_bmps.py`).

The 6x3 cylinder state is evolved by the port's engine and carried into a
JAX engine of the same plan, so both packages hold one state.  Parity
tolerances are `torch_bmps_cases.Z_TOL`; against exact contraction the
ring closure's own envelope (`tests/test_ring_bmps.py:64`, `:272`).
"""

import numpy as np
import pytest
import torch

import tnqs
import tnqs.bmps_engine as JB
from tnqs.engine import LatticePlan as JaxPlan

import tnqs_torch.bmps_engine as PB
from tnqs_torch.engine import LatticeEngine, LatticePlan
import torch_bmps_cases as cases
from torch_bmps_cases import Z_TOL, port_graph

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cylinder():
    return cases.cylinder()


def test_ring_plan_matches_jax():
    g = tnqs.named_grid((6, 3), periodic=(True, False))
    jp = JB.ColumnPlan.build(JaxPlan.build(g))
    pp = PB.ColumnPlan.build(LatticePlan.build(port_graph(g)))
    assert pp.periodic and jp.periodic
    assert len(pp.cross) == 6  # nC cuts, the wrap cut included
    assert all(u[0] == 6 and w[0] == 1 for (u, w) in pp.cross[-1])  # oriented (last column, column 0)
    assert (pp.columns, pp.cross, pp.col_of, pp.order_in_col) == (jp.columns, jp.cross, jp.col_of, jp.order_in_col)
    for (u, w) in g.edges():
        assert pp.side(u, w) == jp.side(u, w) and pp.side(w, u) == jp.side(w, u)


def test_malformed_ring_rejected():
    """A stray long-range edge must not enable the ring closure
    (`tests/test_ring_bmps.py:248`)."""
    g = tnqs.NamedGraph([(c, 1) for c in range(1, 5)])
    for u, w in (((1, 1), (2, 1)), ((3, 1), (4, 1)), ((4, 1), (1, 1))):
        g.add_edge(u, w)
    with pytest.raises(ValueError, match="not a ring"):
        JB.ColumnPlan.build(JaxPlan.build(g))
    with pytest.raises(ValueError, match="not a ring"):
        PB.BMPSEngine(LatticeEngine(port_graph(g), chi=2, device="cpu"), rank=2)


def test_ring_product_state_exact():
    _, pe, _ = cases.cylinder(layers=0)
    z = PB.BMPSEngine(pe, rank=4, ring_iters=2).expect_1site("Z")
    assert max(abs(z[v] - 1.0) for v in z) < 1e-5


def test_ring_expect_matches_jax_and_exact(cylinder):
    """<Z> on every vertex against JAX (and `split=True` bit for bit the
    same), and against exact contraction within the ring envelope."""
    g, pe, je = cylinder
    zj = JB.BMPSEngine(je, rank=8, ring_iters=3).expect_1site("Z")
    be = PB.BMPSEngine(pe, rank=8, ring_iters=3)
    zp = be.expect_1site("Z")
    assert max(abs(zp[v] - zj[v]) for v in zj) < Z_TOL[np.complex64]
    assert be.expect_1site("Z", split=True) == zp
    st = je.to_state()
    for v in list(g.vertices())[:6]:
        assert abs(zp[v].real - complex(tnqs.expect(st, ("Z", v), alg="exact")).real) < 6e-3


def test_ring_2site_matches_jax_and_rdm_exact(cylinder):
    _, pe, je = cylinder
    pairs = [((1, 1), (1, 2)), ((3, 3), (3, 1))]
    want = JB.BMPSEngine(je, rank=8, ring_iters=3).expect_2site("Z", "Z", pairs=pairs)
    got = PB.BMPSEngine(pe, rank=8, ring_iters=3).expect_2site("Z", "Z", pairs=pairs)
    assert list(got) == list(want)
    assert max(abs(got[k] - want[k]) for k in want) < Z_TOL[np.complex64]
    be = PB.BMPSEngine(pe, rank=8, ring_iters=3)
    rho = be.rdm([(1, 1)])
    z = be.expect_1site("Z", vertices=[(1, 1)])[(1, 1)]
    assert abs(np.trace(rho) - 1.0) < 1e-6
    assert abs(rho[0, 0] - rho[1, 1] - z) < 1e-5
    ze = complex(tnqs.expect(je.to_state(), ("Z", (1, 1)), alg="exact")).real
    assert abs(float(np.real(rho[0, 0] - rho[1, 1])) - ze) < 6e-3


def test_ring_inner_fidelity_lognorm(cylinder):
    """The quotient-BP overlap on ring plans against JAX and against exact
    contraction (`tests/test_ring_bmps.py:272`)."""
    g, ket, jket = cylinder
    _, bra, jbra = cases.cylinder(dt=0.28)
    bj, bp = JB.BMPSEngine(jket, rank=8), PB.BMPSEngine(ket, rank=8)
    got = bp.inner(bra)
    assert abs(got - complex(bj.inner(jbra))) < 1e-5 * abs(got)
    assert abs(bp.lognorm() - bj.lognorm()) < 1e-5
    ket_s, bra_s = jket.to_state(), jbra.to_state()
    ex = complex(tnqs.inner(ket_s, bra_s, alg="exact"))
    nk = complex(tnqs.norm_sqr(ket_s, alg="exact"))
    nb = complex(tnqs.norm_sqr(bra_s, alg="exact"))
    assert abs(got - ex) / abs(ex) < 1e-4
    assert abs(bp.fidelity(bra) - abs(ex) ** 2 / np.real(nk * nb)) < 1e-4
    assert abs(bp.lognorm() - float(np.log(np.real(nk)))) < 1e-4
