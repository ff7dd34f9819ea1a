"""The work of one boundary-MPS readout, counted without a device.

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


if __name__ == "__main__":
    main()
