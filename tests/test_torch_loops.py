"""Loop-corrected partition functions of the port's engine against the JAX
engine on the CPU.

`LatticeEngine.loopcorrected_partitionfunction` sums the loop series on the
rescaled BP fixed point: simple cycles by batched ring products of doubled
transfer matrices, every other configuration by one contraction of its
vertices with messages on its boundary and antiprojectors on its edges
(the flex weight, which the JAX engine takes from its flex tier).  The 3x3
grid at size 4 has only plaquettes; at size 8 it has 6 non-cycle
configurations (two plaquettes sharing an edge or a vertex).  The 6-ring at
its full length is the analytic anchor: there the truncated series is
exact.  Tolerances: complex128 sums of a few hundred terms that both
packages evaluate in other orders, 1e-10 relative (the JAX test's own bar,
`tests/test_engine.py:363-381`); the ring anchor 1e-12 relative to the
exact contraction (`tests/test_engine.py:384-404`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnqs
from tnqs.engine import LatticeEngine as JaxEngine

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine, _cycle_order

torch.set_num_threads(1)


def _pair(g, seed, iters):
    """A random bond-dimension-3 complex128 state on `g` after BP in the JAX
    engine, the same arrays in a port engine, and the exact <psi|psi>."""
    rng = np.random.default_rng(seed)
    psi = tnqs.random_tensornetworkstate(g, "S=1/2", bond_dimension=3, dtype=np.complex128, rng=rng)
    je = JaxEngine(psi, chi=3, dtype=jnp.complex128)
    je.bp_update(maxiter=iters)
    pg = tt.NamedGraph.from_edges(g.vertices(), g.edges())
    pe = LatticeEngine.from_arrays(pg, {k: np.asarray(v) for k, v in je.T.items()}, np.asarray(je.M), 3,
                                   dtype=torch.complex128, device="cpu")
    return je, pe, psi


@pytest.fixture(scope="module")
def grid():
    return _pair(tnqs.named_grid((3, 3)), 7, 60)


@pytest.mark.parametrize("size", [4, 8])
def test_grid_matches_jax(grid, size):
    je, pe, psi = grid
    z_jax = je.loopcorrected_partitionfunction(size)
    T0 = {k: v.clone() for k, v in pe.T.items()}
    z = pe.loopcorrected_partitionfunction(size)
    assert abs(z - z_jax) < 1e-10 * abs(z_jax), (z, z_jax)
    by_len, others = pe._loopcorr_cache[size]
    assert sorted(by_len) == ([4] if size == 4 else [4, 6, 8]) and len(others) == (0 if size == 4 else 6)
    # a real correction (~5% of Z_BP on this state), closer to the exact Z than BP, and the state untouched
    z_bp = pe.partitionfunction()
    z_ex = complex(tnqs.norm_sqr(psi, alg="exact"))
    assert abs(z - z_bp) > 1e-3 * abs(z_bp) and abs(z - z_ex) < abs(z_bp - z_ex)
    assert all(torch.equal(T0[k], pe.T[k]) for k in T0)
    assert pe.loopcorrected_partitionfunction(size) == z  # the cached configurations give the same sum


def test_ring_anchor_is_exact():
    je, pe, psi = _pair(tnqs.named_ring_graph(6), 9, 80)
    z_ex = complex(tnqs.norm_sqr(psi, alg="exact"))
    z_bp = pe.partitionfunction()
    z = pe.loopcorrected_partitionfunction(6)
    assert abs(z_bp - z_ex) / abs(z_ex) > 1e-3  # BP alone is not exact
    assert abs(z - z_ex) / abs(z_ex) < 1e-12
    assert abs(z - je.loopcorrected_partitionfunction(6)) < 1e-12 * abs(z_ex)
    assert pe.loopcorrected_partitionfunction(5) == pe.partitionfunction()  # no configuration below the ring


def test_configuration_weight_equals_the_cycle_product(grid):
    """The general contraction agrees with the transfer-matrix ring product
    on every cycle of the grid, the two evaluations the engine mixes."""
    _, pe, _ = grid
    Ts, Ms = pe._rescaled(pe.T, pe.M)
    for eg in tt.leafless_edge_induced_subgraphs(pe.plan.graph, 8):
        cyc = _cycle_order(eg)
        if cyc is None:
            continue
        w_ring = complex(pe._cycle_weights([cyc], Ts, Ms))
        w_contr = complex(pe._configuration_weight(eg, Ts, Ms))
        assert abs(w_ring - w_contr) <= 1e-12 * max(1.0, abs(w_ring)), (eg, w_ring, w_contr)
