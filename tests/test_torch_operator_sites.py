"""Operator sites (``site_legs=2``: two legs folded into one axis of d = 4)
and the thermal-state path against the JAX engine on the CPU.

The Heisenberg-picture layer of `tests/test_engine.py:139-190` on the 2x3
grid runs in both engines from the same packed start (the JAX engine's
arrays carried over by `from_arrays`), compared on quantities free of the
bond gauge: Z_BP and the bond entropies (complex64 on the direct path in
two packages: 1e-5 relative and 1e-4).  The thermal path
(`examples/hexagonal_heisenberg_thermalstate.py:52-80`) runs at chi=8 for 6
steps at complex128 from the port's own identity operator state: its
free-energy density must be the JAX engine's within 1e-10 (complex128 runs
that round in other orders; measured ~1e-14) and the 4th-order HTSE within
5e-4 (`tests/test_engine.py:355-357`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnqs
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.gates import op
from tnqs.models import operator_picture_layer

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine

from torch_thermal_reference import jax_thermal_free_energies

torch.set_num_threads(1)


def test_heisenberg_picture_layer_matches_jax():
    g = tnqs.named_grid((2, 3))
    s = tnqs.siteinds("S=1/2", g, inds_per_site=2)
    psi = tnqs.identity_tensornetworkstate(g, s, dtype=np.complex64)
    vz = tnqs.center(g)[0]
    psi.set_preserve(vz, (psi[vz] * psi._adapt_like(op("Z", s[vz][0]))).noprime())
    psi = tnqs.normalize(psi, alg="bp")
    h, J, dt = -0.9, -1.1, 0.07
    named = [("Rz", [v], 2 * h * dt) for v in g.vertices()]
    for group in tnqs.edge_color(g, 4):
        named += [("Rxx", [u, v], 2 * J * dt) for (u, v) in group]

    je = JaxEngine(psi, chi=8, dtype=jnp.complex64)
    pg = tt.NamedGraph.from_edges(g.vertices(), g.edges())
    pe = LatticeEngine.from_arrays(pg, {k: np.asarray(v) for k, v in je.T.items()}, np.asarray(je.M), 8,
                                   device="cpu", factor_method="direct", site_legs=2)
    assert (pe.d, pe.d0, pe.site_legs) == (4, 2, 2)
    je.bp_update(maxiter=20)
    je.evolve(operator_picture_layer(named, d0=2), num_layers=2, cutoff=1e-12, bp_maxiter=20)
    pe.bp_update(maxiter=20)
    pe.evolve(tt.operator_picture_layer(named, d0=2), num_layers=2, cutoff=1e-12, bp_maxiter=20)
    z_jax, z = je.partitionfunction(), pe.partitionfunction()
    assert abs(z - z_jax) < 1e-5 * abs(z_jax), (z, z_jax)
    s_jax, s_port = je.bond_entropies(), pe.bond_entropies()
    assert max(abs(s_port[e] - s_jax[e]) for e in s_jax) < 1e-4


def test_thermal_path_matches_jax_and_htse():
    J, dbeta, nsteps, chi = 1.0, 0.02, 6, 8
    g = tt.named_hexagonal_lattice_graph(2, 2, periodic=True)
    eng = LatticeEngine(g, chi, dtype=torch.complex128, device="cpu", site_legs=2, state=tt.identity_operator_vector())
    eng.bp_update(maxiter=30)
    step = eng.make_step(tt.heisenberg_thermal_layer(g, J, dbeta), cutoff=1e-14, normalize=False, bp_maxiter=30)
    logz = -eng.freenergy()
    eng.rescale()
    f = []
    for _ in range(nsteps):
        eng.T, eng.M, _ = step(eng.T, eng.M)
        logz -= eng.freenergy()
        eng.rescale()
        f.append(float(np.real(logz) / g.nv()))
    f_jax = jax_thermal_free_energies(chi, nsteps, dbeta, J)
    assert np.max(np.abs(np.array(f) - np.array(f_jax))) < 1e-10
    assert abs(f[-1] - tt.htse_free_energy_density_4th(J, 2 * nsteps * dbeta)) < 5e-4


def test_identity_state_and_site_checks():
    g = tt.named_grid((2, 2))
    eng = LatticeEngine(g, 3, device="cpu", site_legs=2, state=tt.identity_operator_vector(2))
    A = eng.T[2]
    assert A.shape == (4, 4, 3, 3)
    np.testing.assert_array_equal(A[:, :, 0, 0].numpy(), np.tile([1, 0, 0, 1], (4, 1)))  # vec(I), (ket, bra)
    assert not A[:, :, 1:].any() and not A[:, :, :, 1:].any()
    up = LatticeEngine(g, 3, device="cpu")
    assert up.d == 2 and up.T[2][:, 0, 0, 0].eq(1).all()  # "↑" stays the default
    per_vertex = LatticeEngine(g, 3, device="cpu", state={v: np.array([0.6, 0.8]) for v in g.vertices()})
    np.testing.assert_allclose(per_vertex.T[2][:, :, 0, 0].numpy(), np.tile([0.6, 0.8], (4, 1)), rtol=1e-7)
    with pytest.raises(ValueError):
        LatticeEngine(g, 3, device="cpu", site_legs=2, state=np.array([1.0, 0.0]))
    with pytest.raises(ValueError):
        LatticeEngine(g, 3, device="cpu", site_legs=0)
