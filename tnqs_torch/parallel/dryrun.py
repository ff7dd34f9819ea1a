"""The multi-rank dry run on the CPU: `dryrun_multichip(n)` spawns n gloo
ranks (`RankPool`) and runs, on tiny shapes, the row-sharded heavy-hex
step, halo-exchange BP and the halo full layer on Eagle-127 in sorted
bands, and one mesh variational step (the JAX package's
`__graft_entry__.py` stages 1-3 and 6; its stages 4-5, the sharded
boundary-MPS sampler and column sweep, wait for `bmps_ring.py`).

Run it as ``python -m tnqs_torch.parallel.dryrun 8``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .pool import RankPool


def _stages(n: int) -> list:
    """The dry run's body on one rank; the report lines (rank 0's are
    printed)."""
    from .. import eagle_lattice, heavy_hexagonal_lattice, named_grid
    from ..engine import LatticeEngine
    from ..models import heavy_hex_kicked_ising_layer
    from ..variational import _join, _split, sharded_bp_energy_fn, tfim_hamiltonian
    from .halo import HaloBandPlan, HaloBP
    from .halo_step import HaloStepEngine
    from .mesh import ShardedEngine, make_mesh

    mesh = make_mesh(n, device="cpu")
    lines = []

    # 1: the row-sharded step on heavy-hex (2, 2), buckets not a multiple of n
    g = heavy_hexagonal_lattice(2, 2)
    eng = LatticeEngine(g, 4, device="cpu")
    eng.bp_update(maxiter=5)
    sharded = ShardedEngine(eng, mesh)
    errors = sharded.step_once(heavy_hex_kicked_ising_layer(g, float(np.pi / 4), 0.4), cutoff=1e-12, bp_maxiter=5)
    z = sharded.unshard().expect_1site("Z")
    assert torch.isfinite(errors).all() and np.isfinite(np.real(list(z.values()))).all()
    lines.append(f"dryrun_multichip: {n} ranks, heavy-hex {len(z)} sites, "
                 f"<Z> center = {np.real(z[(3, 3)]) if (3, 3) in z else 'n/a'}")

    # 2: halo-exchange BP on Eagle-127 in sorted bands
    g = eagle_lattice()
    heng = LatticeEngine(g, 4, device="cpu", bp_schedule="color")
    hbp = HaloBP(heng, HaloBandPlan.build(heng.plan, n, order="sorted"), mesh)
    hbp.fixed_point(maxiter=5, tolerance=1e-5)
    assert torch.isfinite(hbp.gather_messages()).all()
    lines.append(f"dryrun_multichip: halo-exchange BP fixed point on Eagle-127 ({n} sorted bands) OK")

    # 3: the halo full layer on Eagle-127
    layer = heavy_hex_kicked_ising_layer(g, float(np.pi / 4), 0.4)
    heng = LatticeEngine(g, 2, device="cpu", bp_schedule="color")
    hse = HaloStepEngine(heng, n_bands=n, mesh=mesh, order="sorted")
    hstep = hse.make_step(layer, cutoff=1e-12, bp_maxiter=4)
    hse.Tb, hse.Mb, _ = hstep(hse.Tb, hse.Mb)
    zvals = np.real(np.array(list(hse.unshard().expect_1site("Z").values())))
    assert np.isfinite(zvals).all()
    traffic = hse.halo_bytes_per_layer(layer, bp_maxiter=4)
    # the main path's width, counted on a meta engine (shapes only)
    wide = HaloStepEngine(LatticeEngine(g, 64, device="meta", bp_schedule="color"), n_bands=n, mesh=mesh,
                          order="sorted").halo_bytes_per_layer(layer, bp_maxiter=25)
    lines.append(f"dryrun_multichip: halo full-step on Eagle-127 ({n} sorted bands) OK (<Z> mean = "
                 f"{zvals.mean():.6f}; halo traffic {traffic['total_bytes'] / 1e6:.2f} MB/rank/layer at chi=2: "
                 f"bp {traffic['bp_bytes'] / 1e6:.2f} MB over {traffic['bp_sweeps']} sweeps x "
                 f"{traffic['n_stages']} stages, gates {traffic['gate_bytes'] / 1e6:.2f} MB; at chi=64 with 25 "
                 f"final sweeps {wide['total_bytes'] / 1e6:.2f} MB: bp {wide['bp_bytes'] / 1e6:.2f}, gates "
                 f"{wide['gate_bytes'] / 1e6:.2f})")

    # 6: one mesh variational step: the gradient through the halo program
    # and one Adam update
    g = named_grid((2 * n, 2))
    veng = LatticeEngine(g, 2, device="cpu")
    rng = np.random.default_rng(0)
    veng.T = {k: a + torch.as_tensor(0.1 * (rng.standard_normal(a.shape) + 1j * rng.standard_normal(a.shape)))
              .to(a.dtype) for k, a in veng.T.items()}
    efn = sharded_bp_energy_fn(veng, tfim_hamiltonian(J=1.0, h=1.3), mesh=mesh, bp_iters=8)
    params = _split(veng.T)
    leaves = [t.requires_grad_(True) for pair in params.values() for t in pair]
    opt = torch.optim.Adam(leaves, lr=0.05)
    e0 = efn(_join(params, veng.dtype))
    e0.backward()
    opt.step()
    with torch.no_grad():
        e1 = efn(_join(params, veng.dtype))
    e0, e1 = float(e0.detach()), float(e1)
    assert np.isfinite(e0) and np.isfinite(e1) and e1 < e0, (e0, e1)
    lines.append(f"dryrun_multichip: mesh-parallel variational step OK (grad through the halo BP over {n} ranks; "
                 f"E {e0:.4f} -> {e1:.4f})")
    return lines


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0, pool: RankPool | None = None) -> list:
    """Run the dry run on `n_devices` gloo ranks: those of `pool`, a
    `RankPool` of that size, or else a pool spawned for the run and closed
    after it.  Prints and returns rank 0's report lines; raises if a rank
    fails (every rank of the pool is then killed)."""
    if pool is None:
        with RankPool(n_devices, timeout_s=timeout_s) as own:
            return dryrun_multichip(n_devices, pool=own)
    if pool.n != int(n_devices):
        raise ValueError(f"dryrun_multichip: {n_devices} ranks asked for, the pool has {pool.n}")
    lines = pool.run(_stages, int(n_devices))[0]
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
