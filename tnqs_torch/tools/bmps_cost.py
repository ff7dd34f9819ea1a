"""The work of one boundary-MPS readout and of the certified sampler, counted
without a device.

    python3 -m tnqs_torch.tools.bmps_cost [--chi 64] [--ranks 16 24]

Builds an Eagle-127 engine of bond cap `chi` on the meta device (shapes, no
data) and runs `BMPSEngine(rank=r, power_iters=1)`'s zip sweeps and the
ladder walks of the columns of (7, 8) and (11, 5), as `expect_1site` does,
under `torch.utils.flop_counter.FlopCounterMode`.  That counts a complex
multiply-add as 2 FLOP, so the real float32 work is ~4x the count.  A
recording sketch notes each draw's shape; the tool then times the port's
own host draws (`cpu_sketch`) of those shapes on this machine's CPU.
Prints, per rank, the counted FLOPs, the library eighs and SVDs, and the
sketches' count, bytes and host draw time.

Then one `BMPSSampler` call, split into its shared norm boundaries and one
group of lanes, for the two sampler configurations of `bench.py`: the w2
workload (Eagle chi=8, `BMPSEngine(rank=10, oversample=8,
power_iters=3)`, `proj_rank=12`, factored q, 50 lanes in one group) and
the chi=64 stage (`rank=8`, `proj_rank=16`, doubled q, groups of 2 lanes).
The sketches are cached per call (`BMPSEngine.sketches_cached`), so the
norm and the first group draw every fold and later groups none.
"""

from __future__ import annotations

import argparse
import math
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

import tnqs_torch
from tnqs_torch import bmps_engine
from tnqs_torch.engine import LatticeEngine

PROBES = ((7, 8), (11, 5))


def readout_cost(eng: LatticeEngine, rank: int) -> dict:
    """Counted FLOPs, library calls and sketch shapes of one `expect_1site`
    at PROBES on `eng` (a meta-device engine)."""
    shapes = []

    def sketch(code, shape):
        shapes.append(tuple(shape))
        return torch.empty(shape, dtype=eng.dtype, device=eng.device)

    be = bmps_engine.BMPSEngine(eng, rank=rank, power_iters=1, sketch=sketch)
    cp = be.cplan
    calls0 = (bmps_engine._eigh.calls, bmps_engine._svd.calls)
    op = torch.empty((2, 2), dtype=eng.dtype, device=eng.device)
    with FlopCounterMode(display=False) as counter:
        lefts, rights = be._boundary_mpses(eng.T)
        for c in sorted({cp.col_of[v] for v in PROBES}):
            be._ladder_expect(eng.T, c, lefts[c], rights[c], op)
    return dict(flops=counter.get_total_flops(), eigh=bmps_engine._eigh.calls - calls0[0],
                svd=bmps_engine._svd.calls - calls0[1], sketches=shapes)


SAMPLERS = (
    ("w2", 8, dict(rank=10, oversample=8, power_iters=3), dict(proj_rank=12, q_mode="factored"), 50),
    ("chi64", 64, dict(rank=8), dict(proj_rank=16), 2),
)


def sampler_cost(eng: LatticeEngine, bmps_kw: dict, sampler_kw: dict, width: int) -> dict:
    """Counted FLOPs, library calls and sketch shapes of a `BMPSSampler`
    call's norm boundaries (`_norm`) and of one group of `width` lanes on
    `eng` (a meta-device engine); `draws` counts the folds a second group
    draws (0: every fold is cached)."""
    shapes = []

    def sketch(code, shape):
        shapes.append(tuple(shape))
        return torch.empty(shape, dtype=eng.dtype, device=eng.device)

    be = bmps_engine.BMPSEngine(eng, sketch=sketch, **bmps_kw)
    sam = bmps_engine.BMPSSampler(be, **sampler_kw)
    u = torch.zeros((width, len(sam.keys_order)), device=eng.device)
    out = {}
    with be.sketches_cached():
        for part in ("norm", "group"):
            calls0 = (bmps_engine._eigh.calls, bmps_engine._svd.calls)
            n0 = len(shapes)
            with FlopCounterMode(display=False) as counter:
                if part == "norm":
                    norm = sam._norm()
                else:
                    sam._group(norm, u, sam._lane_budget(width))
            out[part] = dict(flops=counter.get_total_flops(), eigh=bmps_engine._eigh.calls - calls0[0],
                             svd=bmps_engine._svd.calls - calls0[1], sketches=shapes[n0:])
        n0 = len(shapes)
        sam._group(norm, u, sam._lane_budget(width))
        out["draws"] = len(shapes) - n0
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chi", type=int, default=64)
    ap.add_argument("--ranks", type=int, nargs="+", default=[16, 24])
    args = ap.parse_args()
    eng = LatticeEngine(tnqs_torch.eagle_lattice(), chi=args.chi, device="meta", bp_schedule="color")
    for rank in args.ranks:
        cost = readout_cost(eng, rank)
        nbytes = sum(8 * math.prod(s) for s in cost["sketches"])
        t0 = time.perf_counter()
        for code, shape in enumerate(cost["sketches"]):
            bmps_engine.cpu_sketch(7, code, shape)
        draw_s = time.perf_counter() - t0
        print(f"chi={args.chi} rank {rank}: {cost['flops'] / 1e12:.3f} TFLOP counted (complex MAC = 2), "
              f"library eigh {cost['eigh']}, SVD {cost['svd']}, {len(cost['sketches'])} sketches of {nbytes} bytes, "
              f"drawn on this host in {draw_s:.3f} s")
    for label, chi, bmps_kw, sampler_kw, width in SAMPLERS:
        eng = LatticeEngine(tnqs_torch.eagle_lattice(), chi=chi, device="meta", bp_schedule="color")
        cost = sampler_cost(eng, bmps_kw, sampler_kw, width)
        for part in ("norm", "group"):
            c = cost[part]
            nbytes = sum(8 * math.prod(s) for s in c["sketches"])
            print(f"sampler {label} (chi={chi}, {bmps_kw}, {sampler_kw}) {part}"
                  f"{f' of {width} lanes' if part == 'group' else ''}: {c['flops'] / 1e12:.3f} TFLOP counted, "
                  f"library eigh {c['eigh']}, SVD {c['svd']}, {len(c['sketches'])} sketches of {nbytes} bytes")
        print(f"sampler {label}: a second group draws {cost['draws']} sketches")


if __name__ == "__main__":
    main()
