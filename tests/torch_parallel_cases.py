"""Rank bodies of `tests/test_torch_parallel.py`: module-level functions that
a `tnqs_torch.parallel.RankPool` runs on every gloo rank (pickled by name,
so this module imports no jax and no `tnqs`).  Each takes plain data (a
graph as its vertex and edge lists, circuits as gate tuples, states as
numpy arrays) and returns numpy data."""

import numpy as np
import torch

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.parallel import HaloBandPlan, HaloBP, HaloStepEngine, ShardedEngine, make_mesh
from tnqs_torch import variational as pvar

CPU = "cpu"


def _graph(ve):
    return tt.NamedGraph.from_edges(*ve)


def _z(eng):
    z = eng.expect_1site("Z")
    return np.array([z[v].real for v in eng.plan.vertices])


def mesh_of(n_asked):
    """(size, rank, device) of ``make_mesh(n_asked, device="cpu")``, or the
    error's type and message."""
    try:
        mesh = make_mesh(n_asked, device=CPU)
    except (ValueError, RuntimeError) as err:
        return type(err).__name__, str(err)
    return mesh.size, mesh.rank, str(mesh.device)


def sharded_steps(ve, chi, circuit, layers, kwargs):
    """`ShardedEngine` from "↑" after ``bp_update(maxiter=10)``: `layers`
    steps; (errors [layers, n_gates], <Z> by vertex)."""
    eng = LatticeEngine(_graph(ve), chi, device=CPU, bp_schedule="color")
    eng.bp_update(maxiter=10)
    sharded = ShardedEngine(eng, make_mesh(device=CPU))
    step = sharded.make_step(circuit, **kwargs)
    errs = []
    for _ in range(layers):
        sharded.T, sharded.M, e = step(sharded.T, sharded.M)
        errs.append(e.numpy())
    return np.stack(errs), _z(sharded.unshard())


def sharded_freenergy(ve, chi, T, M):
    """`ShardedEngine.freenergy` and `partitionfunction` at complex128 on
    the state (T, M)."""
    eng = LatticeEngine.from_arrays(_graph(ve), T, M, chi, dtype=torch.complex128, device=CPU, bp_schedule="color")
    sharded = ShardedEngine(eng, make_mesh(device=CPU))
    return sharded.freenergy(), sharded.partitionfunction()


def halo_fixed_point(ve, chi, T, M, maxiter, tolerance):
    """`HaloBP.fixed_point` from the messages M; the gathered messages."""
    eng = LatticeEngine.from_arrays(_graph(ve), T, M, chi, device=CPU, bp_schedule="color")
    mesh = make_mesh(device=CPU)
    hbp = HaloBP(eng, HaloBandPlan.build(eng.plan, mesh.size), mesh)
    hbp.fixed_point(maxiter=maxiter, tolerance=tolerance)
    return hbp.gather_messages().numpy()


def halo_step(ve, chi, circuit, order, kwargs):
    """One `HaloStepEngine` layer from "↑": (errors, <Z>, the unsharded
    messages, `halo_bytes_per_layer`)."""
    eng = LatticeEngine(_graph(ve), chi, device=CPU, bp_schedule="color")
    mesh = make_mesh(device=CPU)
    hse = HaloStepEngine(eng, n_bands=mesh.size, mesh=mesh, order=order)
    step = hse.make_step(circuit, **kwargs)
    hse.Tb, hse.Mb, errors = step(hse.Tb, hse.Mb)
    eng = hse.unshard()
    traffic = hse.halo_bytes_per_layer(circuit, bp_maxiter=kwargs.get("bp_maxiter", 30))
    return errors.numpy(), _z(eng), eng.M.numpy(), traffic


def sharded_energy(ve, chi, T, h, bp_iters):
    """The sharded BP energy (TFIM, J = 1) and its gradient over the (real,
    imag) leaves."""
    eng = LatticeEngine.from_arrays(_graph(ve), T, _initial_m(ve, chi), chi, device=CPU, bp_schedule="color")
    efn = pvar.sharded_bp_energy_fn(eng, pvar.tfim_hamiltonian(J=1.0, h=h), mesh=make_mesh(device=CPU),
                                    bp_iters=bp_iters)
    params = pvar._split(eng.T)
    for pair in params.values():
        for t in pair:
            t.requires_grad_(True)
    e = efn(pvar._join(params, eng.dtype))
    e.backward()
    return float(e.detach()), {k: (re.grad.numpy(), im.grad.numpy()) for k, (re, im) in params.items()}


def mesh_minimize(ve, chi, T, h, steps, bp_iters):
    """``minimize_energy(mesh=)``: the history and the final state."""
    eng = LatticeEngine.from_arrays(_graph(ve), T, _initial_m(ve, chi), chi, device=CPU, bp_schedule="color")
    res = pvar.minimize_energy(eng, pvar.tfim_hamiltonian(J=1.0, h=h), steps=steps, learning_rate=0.05,
                               bp_iters=bp_iters, mesh=make_mesh(device=CPU))
    return res["history"], res["energy"], {k: v.numpy() for k, v in eng.T.items()}


def _initial_m(ve, chi):
    return LatticeEngine(_graph(ve), chi, device=CPU, bp_schedule="color").M.numpy()
