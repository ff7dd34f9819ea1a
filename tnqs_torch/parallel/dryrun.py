"""The multi-rank dry run on the CPU: `dryrun_multichip(n)` spawns n gloo
ranks (`RankPool`) and runs, on tiny shapes, the JAX package's
`__graft_entry__.py` stages: (1) the row-sharded heavy-hex step, (2)
halo-exchange BP and (3) the halo full layer on Eagle-127 in sorted bands,
(4) the sharded certified sampler and (5) the ring-pipelined boundary-MPS
column sweep on stage 3's state, and (6) one mesh variational step.
Stages 3 and 5 also count, on meta tensors, what the halo exchange and the
boundary relay would send at the main path's width (chi=64).

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
    from ..bmps_engine import BMPSEngine, BMPSSampler
    from ..engine import LatticeEngine
    from ..models import heavy_hex_kicked_ising_layer, tfim_layer
    from ..variational import _join, _split, sharded_bp_energy_fn, tfim_hamiltonian
    from .bmps_ring import ShardedBMPS, ShardedSampler, relay_templates
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

    # 4: the sharded certified sampler on stage 3's state, 2 samples a rank
    meng = hse.unshard()
    meng.bp_update(maxiter=10)
    sam = ShardedSampler(BMPSSampler(BMPSEngine(meng, rank=4), proj_rank=8), mesh)
    pq = np.array([c["poverq"] for c in sam.sample_directly_certified(2 * n, seed=0)])
    assert np.isfinite(pq).all()
    lines.append(f"dryrun_multichip: mesh-parallel certified sampling on Eagle-127 OK ({2 * n} samples over {n} "
                 f"ranks; p/q mean = {pq.mean():.4f})")

    # 5: the ring-pipelined column sweep on that state (Eagle's 13 columns),
    # or on a (2n, 3) grid past 13 ranks, against the unsharded sweep
    if n <= 13:
        ring_g, reng = g, meng
    else:
        ring_g = named_grid((2 * n, 3))
        reng = LatticeEngine(ring_g, 2, device="cpu")
        reng.bp_update(maxiter=5)
        reng.evolve(tfim_layer(ring_g, J=0.5, hx=1.0, dt=0.3), num_layers=1, cutoff=1e-10, bp_maxiter=5)
    ring = ShardedBMPS(BMPSEngine(reng, rank=3), mesh)
    zr = ring.expect_1site("Z")
    zs = BMPSEngine(reng, rank=3).expect_1site("Z")
    assert np.isfinite(np.array(list(zr.values()))).all() and zr.keys() == zs.keys()
    gap = max(abs(zr[v] - zs[v]) for v in zs)
    assert gap < 2e-5, f"ring-sharded BMPS deviates from unsharded by {gap}"
    relay = ring.relay_bytes()
    # the main path's readout width (chi=64, rank 16), counted on a meta engine
    wide = [t.numel * 8 for t in relay_templates(BMPSEngine(LatticeEngine(g, 64, device="meta"), rank=16), n)]
    lines.append(f"dryrun_multichip: ring-pipelined BMPS column sweep OK ({len(zs)}-site "
                 f"{'Eagle heavy-hex' if reng is meng else 'grid'}, {len(ring.bmps.cplan.columns)} columns banded "
                 f"over {n} ranks; max |sharded - unsharded| = {gap:.2e}; relay {relay['steps']} steps of "
                 f"{relay['left_bytes'] + relay['right_bytes']} bytes a rank at rank 3 and chi=2, at rank 16 and "
                 f"chi=64 {(wide[0] + wide[1]) / 1e6:.2f} MB a step: left {wide[0] / 1e6:.2f}, right "
                 f"{wide[1] / 1e6:.2f})")

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
