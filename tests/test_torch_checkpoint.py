"""Engine checkpoints across the two packages, on the CPU.

A JAX `save_engine` file loads in the port's `load_engine` with the same
plan (buckets, edge ids), the same arrays bit for bit and the options the
JAX engine resolved, and one more step agrees with the JAX engine's; a port
file loads in `tnqs.load_engine` with the same arrays (the JAX package
ignores the port's header keys).  Heavy-hex (2, 2) at chi=4 under both BP
schedules, since the schedule orders the buckets and messages
(`tests/test_checkpoint.py:95-118`).  The step's tolerance: the direct path
at complex64 in two packages that round in other orders, 1e-5 in <Z>
(`tests/test_torch_switches.py`'s direct-path bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnqs
import tnqs.models
from tnqs.engine import LatticeEngine as JaxEngine

import tnqs_torch as tt
from tnqs_torch import checkpoint
from tnqs_torch.engine import LatticeEngine

torch.set_num_threads(1)

J, THETA_H = float(np.pi / 4), 0.4


@pytest.fixture(scope="module", params=["wavefront", "color"])
def jax_run(request, tmp_path_factory):
    """A JAX engine after two layers (its file written), and its state after
    a third layer."""
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JaxEngine(psi, chi=4, dtype=jnp.complex64, bp_schedule=request.param)
    layer = tnqs.models.heavy_hex_kicked_ising_layer(g, J, THETA_H)
    je.evolve(layer, num_layers=2, cutoff=1e-12, bp_maxiter=10)
    path = tmp_path_factory.mktemp("ckpt") / "jax.npz"
    tnqs.save_engine(je, path)
    saved = ({k: np.asarray(v) for k, v in je.T.items()}, np.asarray(je.M))
    je.evolve(layer, num_layers=1, cutoff=1e-12, bp_maxiter=10)
    return request.param, je, path, saved


def test_jax_checkpoint_loads_in_the_port(jax_run):
    schedule, je, path, (T, M) = jax_run
    pe = checkpoint.load_engine(path, device="cpu")
    assert pe.plan.bp_schedule == schedule and pe.chi == 4 and pe.d == 2 and pe.dtype == torch.complex64
    # JAX resolved factor_method "direct" on the CPU, hence the eigh gauge (`tnqs/engine.py:609`)
    assert (pe.factor_method, pe.env_gauge, pe.site_legs, pe.bp_precision) == ("direct", "eigh", 1, None)
    assert pe.plan.edge_ids == je.plan.edge_ids and pe.plan.buckets == je.plan.buckets
    assert all(np.array_equal(pe.T[k].numpy(), T[k]) for k in T) and np.array_equal(pe.M.numpy(), M)
    pe.evolve(tt.heavy_hex_kicked_ising_layer(pe.plan.graph, J, THETA_H), num_layers=1, cutoff=1e-12, bp_maxiter=10)
    z_jax, z = je.expect_1site("Z"), pe.expect_1site("Z")
    assert max(abs(z[v] - z_jax[v]) for v in z_jax) < 1e-5


def test_port_checkpoint_loads_in_jax(jax_run, tmp_path):
    schedule, _, path, _ = jax_run
    pe = checkpoint.load_engine(path, device="cpu")
    pe.evolve(tt.heavy_hex_kicked_ising_layer(pe.plan.graph, J, THETA_H), num_layers=1, cutoff=1e-12, bp_maxiter=10)
    checkpoint.save_engine(pe, tmp_path / "port.npz")
    je = tnqs.load_engine(tmp_path / "port.npz")
    assert je.plan.bp_schedule == schedule and je.plan.edge_ids == pe.plan.edge_ids
    assert all(np.array_equal(np.asarray(je.T[k]), pe.T[k].numpy()) for k in pe.T)
    assert np.array_equal(np.asarray(je.M), pe.M.numpy())


def test_round_trip_keeps_the_switches_and_operator_sites(tmp_path):
    g = tt.named_hexagonal_lattice_graph(2, 2, periodic=True)
    eng = LatticeEngine(g, 4, dtype=torch.complex128, device="cpu", site_legs=2, state=tt.identity_operator_vector(),
                        env_gauge="eigh", trunc_method="full", bp_precision="high", bp_schedule="color")
    eng.evolve(tt.heisenberg_thermal_layer(g, 1.0, 0.05), num_layers=1, cutoff=1e-14, normalize=False)
    checkpoint.save_engine(eng, tmp_path / "op.npz")
    header, _ = checkpoint._read_npz(tmp_path / "op.npz")
    assert {"chi", "d", "dtype", "buckets", "bp_schedule", "factor_method", "env_gauge", "reduce_method",
            "trunc_method", "svd_impl", "bp_kernel", "bp_precision", "site_legs"} <= set(header)
    back = checkpoint.load_engine(tmp_path / "op.npz", device="cpu")
    for key in ("chi", "d", "d0", "site_legs", "dtype", "factor_method", "env_gauge", "reduce_method",
                "trunc_method", "svd_impl", "bp_kernel", "bp_precision"):
        assert getattr(back, key) == getattr(eng, key), key
    assert back.plan.edge_ids == eng.plan.edge_ids and back.plan.bp_schedule == "color"
    assert all(torch.equal(back.T[k], eng.T[k]) for k in eng.T) and torch.equal(back.M, eng.M)
    assert back.device == torch.device("cpu")
