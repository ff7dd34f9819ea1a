"""The rank ladder (`resize_chi`, `evolve_ladder`) against the JAX engine
and against a direct run, on the CPU.

From "↑" the kicked-Ising layer on heavy-hex (2, 2) has one two-site gate
per edge, so a bond's rank is at most 2^L after L layers: rungs (2, 4)
under chi=8 run layers 1-3 at chi 2, 4 and 8, each exact while the rank
stays under the rung.  Tolerances: the JAX engine's own bar for the ladder
against the direct run, 5e-5 in <Z> (`tests/test_engine.py:193-216`); the
port's ladder against the JAX ladder on the same direct path at
complex64, 1e-5, and their truncation errors (the discarded weights, ~0
below a rung) within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnqs
import tnqs.models
from tnqs.engine import LatticeEngine as JaxEngine

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine

torch.set_num_threads(1)

J, THETA_H = float(np.pi / 5), 0.37


@pytest.fixture(scope="module")
def jax_ladder():
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JaxEngine(psi, chi=8, dtype=jnp.complex64)
    je.bp_update(maxiter=10)
    je, errs = je.evolve_ladder(tnqs.models.heavy_hex_kicked_ising_layer(g, J, THETA_H), num_layers=3, rungs=(2, 4),
                                cutoff=1e-12, bp_maxiter=10)
    return je.expect_1site("Z"), errs


def _engine():
    g = tt.heavy_hexagonal_lattice(2, 2)
    eng = LatticeEngine(g, 8, device="cpu", factor_method="direct")
    eng.bp_update(maxiter=10)
    return eng, tt.heavy_hex_kicked_ising_layer(g, J, THETA_H)


def test_ladder_matches_jax_and_the_direct_run(jax_ladder):
    z_jax, errs_jax = jax_ladder
    eng, layer = _engine()
    T0, M0 = {k: v.clone() for k, v in eng.T.items()}, eng.M.clone()
    out, errs = eng.evolve_ladder(layer, num_layers=3, rungs=(2, 4), cutoff=1e-12, bp_maxiter=10)
    assert out.chi == 8 and errs.shape == errs_jax.shape == (3, len(layer))
    assert all(torch.equal(T0[k], eng.T[k]) for k in T0) and torch.equal(M0, eng.M)  # self left as it was
    z = out.expect_1site("Z")
    assert max(abs(z[v] - z_jax[v]) for v in z_jax) < 1e-5
    assert np.max(np.abs(errs - errs_jax)) < 1e-6
    eng.evolve(layer, num_layers=3, cutoff=1e-12, bp_maxiter=10)
    z_direct = eng.expect_1site("Z")
    assert max(abs(z[v] - z_direct[v]) for v in z) < 5e-5


@pytest.mark.parametrize("chi_new", [2, 12])
def test_resize_chi_pads_and_slices(chi_new):
    eng, layer = _engine()
    eng.evolve(layer, num_layers=1, cutoff=1e-12, bp_maxiter=10)  # bond rank 2
    eng.expect_2site("Z", "Z")  # fills the per-chi edge cache
    new = eng.resize_chi(chi_new)
    assert new is not eng and new.plan is eng.plan and new.chi == chi_new and eng.chi == 8
    assert new._edge_cls_cache is None and new._loopcorr_cache == {}
    c = min(8, chi_new)
    for k, A in eng.T.items():
        assert new.T[k].shape == A.shape[:2] + (chi_new,) * k and new.T[k].is_contiguous()
        assert torch.equal(new.T[k][(slice(None),) * 2 + (slice(0, c),) * k], A[(slice(None),) * 2 + (slice(0, c),) * k])
    assert new.M.shape == (eng.M.shape[0], chi_new, chi_new)
    assert torch.equal(new.M[:, :c, :c], eng.M[:, :c, :c])
    if chi_new > 8:
        assert not new.M[:, 8:].any() and not new.M[:, :, 8:].any()
    z, z_new = eng.expect_1site("Z"), new.expect_1site("Z")  # rank 2 fits either cap: the same state
    assert max(abs(z[v] - z_new[v]) for v in z) < 1e-6
    assert eng.resize_chi(8) is eng
