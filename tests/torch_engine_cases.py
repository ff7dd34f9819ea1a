"""Shared by `tests/test_torch_wide_engine.py` (chi = 96) and
`tests/test_torch_l2_engine.py` (chi = 130): one two-site group in both
engines on the CPU, random bond-chi site tensors on a ring of four sites,
whose thetas are [2 chi, 2 chi], through `pjsvd` (the JAX Pallas kernels in
interpret mode, as `tests/test_ops.py:272-277` arranges; the port's plain
versions of K2 and K1), truncated back to chi.  Inputs are made with numpy
and carried into both packages as arrays, as `tests/test_torch_engine.py`
does."""

from functools import partial

import numpy as np
import torch

import jax
import jax.numpy as jnp

import tnqs
import tnqs.models
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.engine import compile_circuit as jax_compile_circuit
from tnqs.ops import osj as jax_osj

import tnqs_torch as tt
import tnqs_torch.engine as pe_mod
from tnqs_torch.engine import LatticeEngine, _ClassData, _svd_fallback, compile_circuit
from tnqs_torch.ops import jacobi, osj

import torch_wide_cases  # noqa: F401  (numpy's BLAS on one thread in the process)

torch.set_num_threads(1)

LAYER = dict(J=np.pi / 4, theta_h=0.4)


def two_site_group_against_jax(chi, monkeypatch):
    """The first two-site group of the kicked-Ising layer on a ring of four
    at bond `chi` (thetas [2 chi, 2 chi]) in the JAX engine and the port,
    from the same random site tensors and messages; the port's route must
    be one `pjsvd` of both thetas and no library SVD."""
    g = tnqs.named_grid((4,), periodic=True)
    p = tt.NamedGraph.from_edges(g.vertices(), g.edges())
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JaxEngine(psi, chi=chi, dtype=jnp.complex64, factor_method="gram", bp_schedule="color")
    je.trunc_method, je.svd_impl = "svd", "pjsvd"
    rng = np.random.default_rng(chi)
    T = {k: (rng.normal(size=(len(vs), 2) + (chi,) * k) + 1j * rng.normal(size=(len(vs), 2) + (chi,) * k))
         .astype(np.complex64) for k, vs in je.plan.buckets.items()}
    # positive-definite environments with a decaying spectrum, normalized
    X = rng.normal(size=(je.M.shape[0], chi, chi)) * np.geomspace(1.0, 1e-2, chi)
    M = np.einsum("eij,ekj->eik", X, X) + 1e-3 * np.eye(chi)
    M = (M / np.einsum("eii->e", M)[:, None, None]).astype(np.complex64)

    circuit = tnqs.models.heavy_hex_kicked_ising_layer(g, **LAYER)
    group = next(c for c in jax_compile_circuit(je.plan, circuit) if hasattr(c, "classes"))
    gates = [jnp.asarray(c.gates.astype(np.complex64)) for c in group.classes]
    errors = jnp.zeros((len(circuit),), jnp.float32)
    orig = jax_osj.pjsvd
    jax_osj.pjsvd = partial(orig, interpret=True)
    try:
        T_j, M_j, e_j = je._apply_two_site_group({k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(M), errors,
                                                 group.classes, gates, 1e-12, True)
        je.T, je.M = T_j, M_j
        z_j = je.expect_1site("Z")
    finally:
        jax_osj.pjsvd = orig

    pe = LatticeEngine.from_arrays(p, T, M, chi=chi, device="cpu", bp_schedule="color")
    pgroup = next(c for c in compile_circuit(pe.plan, tt.heavy_hex_kicked_ising_layer(p, **LAYER))
                  if hasattr(c, "classes"))
    e_p = torch.zeros((len(circuit),), dtype=torch.float32)
    calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls)
    fallback = dict(_svd_fallback.calls_by_shape)
    shapes = []
    monkeypatch.setattr(pe_mod, "pjsvd", lambda A, **kw: shapes.append(tuple(A.shape)) or osj.pjsvd(A, **kw))
    pe._apply_two_site_group(pe.T, pe.M, e_p, [_ClassData(c, pe.dtype, pe.device) for c in pgroup.classes],
                             1e-12, True)
    # every theta is [2 chi, 2 chi]: one pjsvd (K2 then K1), no library SVD
    assert (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert shapes == [(2, 2 * chi, 2 * chi)] and _svd_fallback.calls_by_shape == fallback
    z_p = pe.expect_1site("Z")
    # full-rank thetas cut from 2 chi to chi (at chi = 96 ~2e-5 of the
    # weight discarded): float32 Jacobi in both packages on the same
    # schedule; <Z> to 1e-4, the discarded weight to 1e-4 relative
    assert max(abs(z_p[v] - z_j[v]) for v in g.vertices()) < 1e-4
    e_j = np.asarray(e_j)
    assert np.count_nonzero(e_j > 1e-6) == 2  # both gates' truncations discard weight
    assert np.max(np.abs(e_p.numpy() - e_j)) <= 1e-4 * np.max(e_j)
