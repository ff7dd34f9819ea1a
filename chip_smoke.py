#!/usr/bin/env python3
"""Smoke run of tnqs_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--layers N] [--bp-kernel-only | --switches-only | --measure-only | --flex-only |
                           --phase12-only | --parallel-only | --wide-only | --l2-only | --sanitize]

Run from the repository root.  Phases, each of which fails the run:

1. environment: Python, torch and CUDA versions, the card's name and power
   limit; exits nonzero when `torch.cuda.is_available()` is False;
2. build: nvcc compiles each `tnqs_torch/csrc/*.cu` for sm_90a into a
   library of its own in `build/tnqs_torch/` (one process per source, in
   parallel) and ptxas's register and spill lines are printed; g++ builds
   the host library of `tnqs_torch/csrc/host/` (the loop enumerator);
3. kernels: the cluster occupancy of each Jacobi kernel and the cluster
   size K1's wrapper picks for each batch; each Jacobi kernel against its
   plain PyTorch version on the same card inputs, at the engine's chi=64
   shapes (Gram [26, 128, 128] for `jacobi_eigh`; thetas [18, 128, 128] and
   [26, 256, 128] for `osj_svd` inside `pjsvd`) and at n = 4, 32, 64, over
   five singular-value families; K1 at every cluster size it can take on
   one input, which must agree bitwise; the library call of the same
   function (`torch.linalg.eigh`, `torch.linalg.svd`) timed beside them as a
   yardstick; both kernels timed alone at each of the main path's 8 shapes
   a layer; K2 also at the switches' shapes (phase 7), the eigh gauge's
   environment bank [144, 64, 64], the subspace solve [54, 72, 72] and full
   truncation's Grams [54, 128, 128], at `default_eigh`'s 12 sweeps and
   relative skip, each beside `torch.linalg.eigh` and its bound; then K1 and
   K2 past n = 128 (`wide_kernel_phase`): K2's resident variant on
   [26, n, n] Grams at n = 192 and 256 in both skips, by the V route each
   width takes (`jacobi.v_route_of`: V in the rings at 192, from the
   rotation log at 256; the plans printed: layout, cluster size, clusters
   at once, waves, shared bytes), checked at 12 sweeps, timed at pjsvd's 8
   sweeps with the absolute skip and `default_eigh`'s 12 with the relative
   one (and [54, 256, 256] there) in turn with `torch.linalg.eigh`; the
   bound from the rotations the kernel counted; at n = 130, 224 and 226
   (pair ranges split unevenly over the CTAs) checked at
   `L2_CHECK_SWEEPS` against the plain version on two members; K1 as
   pjsvd's polish at the chi = 96 and chi = 128
   thetas [26, 384, 192], [18, 192, 192], [26, 512, 256] and
   [18, 256, 256] on the resident variant (A alone in a cluster of 2-16
   CTAs, V from the rotation log; the plan printed: cluster size, chunks a
   CTA, clusters at once, waves, V's kernel beside or after the rounds),
   each against its plain version and LAPACK on the spectrum families
   scaled to n, five calls bitwise equal, timed as a whole call beside the
   library call and its bound (the log's bytes and the rotations the
   kernel counted); F2: pjsvd on the 128-value
   families padded with zeros at [26, 384, 192], recorded, and the worst
   member (`F2_MEMBER`) alone, its error after each polish sweep for K2 then
   K1 on the card, both plain, the plain K2 then the kernel K1, and the
   plain K2 on the Gram moved by rounding-sized noise; then the L2 variants
   past n = 256 (`l2_kernel_phase`): their plans, K2 on [26, 320, 320] and
   [4, 512, 512] Grams in both skips (against the plain version at batch 2
   at `L2_CHECK_SWEEPS`, timed at 8 absolute and 12 relative sweeps), K1 as
   pjsvd's polish at [4, 512, 512], [26, 640, 320] and [26, 1024, 512]
   (against the plain version and LAPACK's graded bounds at
   `L2_GRADED_SWEEPS`, the engine's sweeps recorded), five calls bitwise
   equal, beside the library call (K2 and `eigh` in turn, ten calls each,
   min / median / max) and the bound from the rotations the kernel counted;
   the L2 variants at `L2_BOUNDARY`, and there with their schedule split
   into launches of 1000 rounds (bitwise one launch); V's kernel alone at
   the paths' shapes (`ROTLOG_SHAPES`: the resident K2's and K1's logs on
   10e's, 8e's and 8d's matrices, in the register and the slab layout in
   turns, the path's own named) and past n = 1024 (a chunk of K2's L2
   schedule, the slab layout), each against its plain version and beside
   its bound, in stages of part of a round and in place (bitwise), its
   `kernels` row listing its launches by layout and path and its times by
   layout;
4. BP kernel: `bp_sweep_group` against its plain version on every degree
   >= 2 group of the Eagle chi=64 color plan, on random site tensors and
   positive messages, plus groups of gathered rows at degree 2-6 that
   reach its other tilings; two calls on each Eagle group must agree
   bitwise; each Eagle group timed on the kernel, on the einsum chain
   `group_messages` and as one multi-operand `torch.einsum` (the
   yardstick), beside its bound; the largest group's kernels' device time
   (torch.profiler); the host side of one launch; one BP sweep timed on the
   kernel and on the einsum route; then K3's bf16_3x mode: ptxas's
   registers and spills of its tensor-core kernels (none may spill), the
   split pass bit for bit against `_split` (ties, subnormals, signed zeros;
   the Eagle T[3]) and timed, the kernel against its own plain version
   (the same bf16 splits, float32 products) on the same groups and on the
   other shape classes (d = 4, depth padding, the thermal path's k = 3,
   chi=32 groups; both designs, `tc_route`), two calls bitwise equal and
   equal to a call given T alone, each Eagle group timed beside the FP32
   mode (every k >= 3 group must be faster), the largest in turns with the
   FP32 mode and the library einsum, beside its plain version, its bound at
   the dense bf16 rate and the design's byte floor, by kernel (profiler);
5. main path: `LatticeEngine.make_step` on the Eagle-127 kicked-Ising layer
   (J = pi/4, theta_h = 0.4) at chi=64, complex64, cutoff 1e-12,
   bp_maxiter=25, N layers (default 10) from "↑".  After each layer <Z> at
   (7,8) and (11,5) must lie within max(3 x the running multi-seed flex-f32
   floor, 2e-5) of the flex-f64 trajectory in
   `tests/golden/golden_f32_controls.json`, and all three kernels must
   have been launched by the step with no plain run (the Jacobi kernels'
   launches are printed by shape, K3's a layer); then a torch.profiler
   window over two more steady layers run on a copy of the layer-10 state:
   K1's, K2's, K3's and the top other kernels' device time and launches,
   and the device's idle share; then the step's BP routes in turns, 3
   layers each from the layer-10 state (kernel, einsum, kernel, einsum),
   layers/s and their <Z> agreement;
6. BP path, on the state the main path leaves: `normalize` (Z_BP -> 1, <Z>
   still within the last layer's bound), then a cold `bp_update` from the
   initial messages on the kernel route and on an einsum-route engine
   carried over by `from_arrays`; the two must agree on the messages, <Z>,
   <ZZ>, bond entropies and Z_BP, and the BP kernel must have been launched
   on this path with no plain run;
7. switches, each run from "↑" on Eagle-127 with the main path's layer and
   failing on non-finite values: (a) the golden gate of
   `tests/test_golden.py:158`, direct, complex128, chi=8, 20 layers, layer
   20 within 1e-5 of `golden_eagle127.json`; (b) direct, complex128,
   chi=64, the device's f64 oracle, every layer within the main path's
   bound and the CPU tests' complex128 bar of 1e-8, 10 layers or fewer (at
   least 4) if they pass `ORACLE_CAP_S`, then one layer's time in
   `torch.linalg.qr`/`svd`/`eigh`; (c-e) complex64, chi=64, N layers of
   `trunc_method="full"`, `"subspace"` and `env_gauge="eigh"`, with K2
   launched at n = 128, 72 and 64 and no plain run, every layer within the
   1e-2 envelope of `tests/test_f32_floor.py:119-129`; (f)
   `reduce_method="gram_nofactor"`, which breaks down as the reference
   does: its factorizations of the first group's real Grams from "↑"
   (complex64) and from (b)'s state (complex128), failures NaN and never a
   partial factor, X R^-1's orthonormality where they succeed, and one
   group on a random full-rank state with identity messages
   (well-conditioned sides) against cholqr2, the site tensors compared
   where the bond gauge drops out; (g) `svd_impl="xla"`, complex64, chi=64,
   N layers within the main bound with no K1/K2 launch, layers/s beside
   phase 5's, and F1's table: phase 5's and 7g's deviations from flex-f64
   by layer against the two clauses of the reference's `pjsvd_certified`
   (`certification_table`).  Complex128 runs launch no float32 kernel and
   run no plain version;
8. measurement, `BMPSEngine` on the card: (a) the w2 readout, Eagle-127 at
   chi=8, complex64, 20 kicked-Ising layers from "↑", BP <Z>(11,5) within
   5e-4 of flex-f64, then BMPS rank 10 <Z> at (7,8) and (11,5), every emit
   an exact SVD, gated as `tests/test_f32_floor.py:219-229` gates the
   committed readout (inside the CPU readout spread of
   `scripts/bisect_w2_gap_results.json` widened by its width, and within
   twice the width of the flex tier's 0.853), with `expect_2site` on one
   column pair, `rdm` (trace 1, Hermitian, its <Z> that of `expect_1site`
   within 1e-5), `fidelity(self)` within 1e-4 of 1 and `norm_sqr` against
   exp(`lognorm`), no kernel launched inside BMPS; (b) the same readout on
   a CPU engine carried over by `from_arrays`, within 1e-5 of the card's;
   (c) on the main path's state after phase 6's `bp_update`, rank 16 cold
   and warm and rank 24 with a power iteration and `split=True`
   (`bench.py:315-343`) beside BP: finite, |Im| <= 1e-3 |Re| (the sketched
   zip's truncation class), |z16 - z24| <= 1e-2; wall times, peak memory, library eigh/SVD calls, host-to-device
   sketch bytes and one torch.profiler window of a rank-16 call; (d)
   chi=96 from "↑", 8 layers or fewer past 60 s (CHI96_CAP_S): every
   theta the kernels hold (up to 256 wide) takes K2 and K1 and none the
   library SVD (`_svd_fallback`, counted by shape), K1 and K2 launched at
   n = 192, no plain run, every layer finite, and on the layers where the
   main path discarded nothing past the cutoff <Z> within the main path's
   bound of flex-f64; then the same layers on `svd_impl="xla"` (as many as
   fit WIDE_XLA_CAP_S, at least 2), each within the main bound of the kernels' run; ms a
   layer, peak memory, one more layer under torch.profiler; (e) the same
   at chi=128 (CHI128_CAP_S 90 s; K1 and K2 at n = 256), then two more
   layers under `trunc_method="full"` from its last state, K2 at n = 256
   on their Grams, within the 1e-2 envelope;
9. certified sampling, `BMPSSampler` on the card, on the states phases 5-6
   and 8a made (K1, K2 and K3 must have run in those evolutions, none inside
   the sampler): (a) bench's w2 sampler (`bench.py:446-452`: rank 10,
   power_iters 3, factored proj_rank 12) on 8a's state, 50 samples with
   seed 0 cold and seed 1 timed, each p/q finite and > 0, each bit 0 or 1,
   |pq_mean - 1| < 0.1 and pq_min > 0.5 (`tests/test_f32_floor.py:231-232`),
   pq_rel_std beside the flex-f64 floor, no sketch drawn; seed 1's first
   `W2_REPEAT` samples again in groups of 10: the same bits, p/q within
   1e-4; the time they spend in the library SVDs; (b) the first 10 of seed 1 on a CPU engine from
   `from_arrays`: the card's bits, p/q within 1e-4 of the card's group of
   10 (the same contraction order);
   (c) `sample_certified(8, seed=2, cert_rank=12)`: finite, positive, mean
   within 0.1 of 1; (d) bench's chi=64 sampler (`bench.py:365-368`: rank 8,
   proj_rank 16, groups of 2) on the main path's state after `bp_update`:
   one two-lane call cold, then as many samples (4 to 50) as fit
   SAMPLE_CAP_S at its rate, whose first two must be the cold call's;
   p/q and the norm estimate finite and > 0, log q <= 0; seconds a sample,
   peak memory, library calls, sketch bytes a call (each fold drawn once a
   call) and one torch.profiler window of a two-lane group;
10. the engine's remainder: (a) the main path's engine saved by
   `save_engine` after layer 5, restored by `load_engine` on the card and
   run to layer 10: T and M bit for bit phase 5's, and the file restored on
   the CPU gives the same arrays; (b) `evolve_ladder` from "↑" with rungs
   (8, 16, 32, 64), every layer within the main bound, K3 launched at every
   rung; (c) `bp_precision="high"` from "↑": every K3 launch bf16_3x on the
   tensor cores with T split once a BP run, every layer within the main
   bound and <Z>(7,8), <Z>(11,5) within 1e-5 of phase 5's, its peak
   memory, then one BP sweep on each route (K3 bf16_3x on T's split planes,
   K3 FP32, einsum) timed in turns, and the split's own time; (d) `loopcorrected_partitionfunction(12)` on the main
   path's state after phase 6's `bp_update` (18 plaquettes; finite, the
   shift against Z_BP, wall time, peak memory), on 8a's chi=8 state on the
   card and on a CPU engine (the loop factor Z / Z_BP within 1e-6), and a
   random 6-ring at chi=3, complex128, within 1e-12 of its exact
   contraction; (e) the thermal state of `golden_thermal.json` (chi=32,
   dbeta=0.01, 25 steps, operator sites) at complex128 on the card and,
   for the first `THERMAL_CPU_STEPS` steps, the CPU (1e-10 apart; within
   the JAX engine's own distance from the golden, plus that) and at complex64 in both BP precisions (K3 at d = 4, k = 3,
   chi=32; every [4, 512, 512] theta on the L2 variants of K2 then K1, none
   on the library SVD, each recorded step within 1e-5 of complex128), then
   complex64 on `svd_impl="xla"`, its seconds beside the kernels', every
   recorded step within 2e-3 of the 4th-order HTSE;
11. the flex tier on the card (`tnqs_torch.apply_gates`, `expect`,
   `sample_directly_certified`): (a) `golden_eagle127.json`'s
   configuration (Eagle-127, 20 kicked-Ising layers, J = pi/4, theta_h =
   0.4, maxdim 8, cutoff 1e-12, complex128) from "↑", every layer's
   fidelity and BP <Z>(7,8) within 1e-5 of the golden, ms and host syncs
   (`torch.cuda.set_sync_debug_mode`) a layer, then BMPS rank 10 <Z>(7,8)
   within 1e-5, its seconds and syncs; (b) `sample_directly_certified`
   with `default_rng(0)` at rank 10, 4 samples (2 if (a)'s evolution took
   over 60 s): each sample's bit at (7,8) and its count of ones those of
   `first4_samples`, p/q within FLEX_PQ_TOL of the golden's, seconds a
   sample; (c) 2 layers on the card and on the CPU port, truncation errors
   and BP <Z> on every vertex within 1e-10; (d) `golden_loopcorrections.json`
   (BP, loop-corrected and exact norms within 1e-5, the loop correction
   closer to exact); (e) the main path's chi=64 state after phase 6 as an
   engine (`from_arrays`), `to_bp_cache()`, flex BP <Z> at (7,8) and (11,5)
   within 1e-5 of `expect_1site`, its time and peak memory, and
   `to_state()` through `save_state` / `load_state` bit for bit.  No
   kernel launches and no plain run on the flex tier;
12. full update, truncation, the variational search and the profiling
   hooks: (a) the TFIM (J=1, h=3) BP energy, 16 sweeps, and its gradient
   by `torch.autograd` on a seeded chi=16 complex128 Eagle state, card
   against the CPU port (energy 1e-10 relative, gradient 1e-8 of its
   largest entry); on the main path's chi=64 state after phase 6, the
   gradient's derivative along a seeded direction weighted by the gradient
   against a central difference of the card's own energy (2e-2); one
   energy traced by `utils.profiling.trace` (a Chrome trace with device
   kernels); then `minimize_energy`, 10 Adam steps at lr `VAR_LR`, from
   that state: every energy finite, the best below step 0's, no K3 launch
   under the gradient and some in the final `bp_update`, no plain run;
   seconds a step and peak memory; (b) `truncate` of 11a's Eagle golden
   state to maxdim 4 by BP and by boundary MPS (rank 10): every bond at
   most 4, the BMPS result's overlap with the untruncated state (by BMPS
   rank 10) at least the BP result's less 1e-6; seconds, host reads and
   the full updates' solves by route; (c) card against the CPU port at
   complex128, each from the same arrays: `tests/test_truncate.py`'s 3x3
   state truncated to maxdim 2 by BP and by BMPS at rank 16 (exact there)
   without the symmetric gauge, exact fidelities within 1e-10, and with it
   within `TRUNC_GAUGE_TOL` (its result depends on the singular vectors'
   phases, which the SVD library picks); `tests/test_gauge_measure.py:79`'s
   full update within 1e-10 of simple update; `fidelity` of a truncating
   full update within 1e-12;
13. the mesh on the card (`tnqs_torch.parallel`): a one-rank NCCL world set
   up by the script (TCP on 127.0.0.1, a free port) and destroyed before it
   goes on, at the main path's width (Eagle-127, chi=64, complex64, sorted
   bands): (a) `HaloStepEngine` on one band, `PAR_LAYERS` kicked-Ising
   layers from "↑" with fixed BP sweep counts, against the unsharded
   engine's same layers (``bp_tolerance=0``): <Z> within 1e-5, errors
   within 1e-6, K1's and K2's launches > 0 and equal to the unsharded
   step's (K3's printed); then `cut_halves` on `PAR_CUT_BANDS` sorted bands
   from the state after those layers: every cut-crossing gate run as both
   bands of its cut run it (one process, no exchange), the two halves the
   same bits, on K1 and K2; (b) `HaloBP.fixed_point` on one band against
   `_bp_fixed_point` from the same seeded perturbed messages, within 1e-5;
   (c) `ShardedEngine`, one step and `freenergy` through NCCL's
   `all_reduce`, against the unsharded engine (<Z> within 1e-5, the free
   energy within 4 x (the unsharded float32 sum's spread, float32 against
   float64 over the same logs, + eps32 x the sum of |log|)); (d)
   `sharded_bp_energy_fn` against `bp_energy_fn` on (a)'s state (energy
   1e-6 relative, gradient 1e-5 of its largest entry, K3 launched 0 times
   under the gradient), then `PAR_ADAM_STEPS` Adam steps of
   `minimize_energy(mesh=)`, timed, with peak memory; on the main path's
   state after phase 6: (e) `ShardedBMPS` (rank 16, power_iters 1, bench's
   readout width) on one band, <Z> on every vertex, within 1e-6 of 8c's
   warm rank-16 values at the probe vertices (the same bits expected: one
   band relays nothing and runs the unsharded zips in their order), with
   wall time, peak memory, and no K1, K2 or K3 launch; (f) `ShardedSampler`
   (bench's chi=64 sampler, rank 8, proj_rank 16) on one band, 2 samples of
   seed 1, the bits of 9d's cold call and p/q within 1e-5 relative, seconds
   a sample.  The halo exchange and the boundary relay between ranks are
   not on the card (NCCL takes one rank a GPU); the gloo tests
   (`tests/test_torch_parallel.py`, `tests/test_torch_parallel_bmps.py`)
   show them.

The line before the last is {"kernels": [...]}: `launches` counts the
launches on each row's own path (phase 5 for K1-K3, 10c for K3's bf16_3x
mode), `launches_by_path` each run's of phases 5-10 and 12 ("6" the BP
path, "8a" the w2 evolution, "8a bmps" and "8c bmps" the BMPS calls, "9a",
"9c" and "9d" the sampler calls, "10e" and "10e high" the complex64 thermal
runs on the kernels, "12a steps" and "12a bp_update" `minimize_energy`'s
Adam steps and its final BP run, "13a" the one-band halo step, "13d grad"
the sharded energy's gradient, "13e bmps" and "13f sampler" the sharded
readout and samples; the L2 rows' `launches` are 10e's);
the last line is {"ok": true, "device": {...}}.
`--l2-only` runs phases 1, 2, the L2 variants' checks and 10e (no result
lines); `--sanitize` runs phases 1, 2 and then the cluster kernels at batch
1-2 under compute-sanitizer's racecheck and synccheck (no result lines).
`--flex-only` runs phases 1, 2, the main path's evolution and `bp_update`
and 11 (no result lines); `--phase12-only` phases 1, 2, the main path's
evolution and `bp_update`, 11a's golden evolution and 12 (no result
lines).
`--parallel-only` runs phases 1, 2 and 13, and profiles one more layer of
13a's two steps (`profile_13a`; no result lines); its 13e and 13f run on
13c's state against unsharded calls of their own.
`--bp-kernel-only` runs phases 1, 2 and 4 and prints K3's row alone (no
result lines), e.g. on an older tree; `--switches-only` runs phases 1, 2,
K2 at the switches' shapes and 7 (no result lines); `--measure-only` runs
phases 1, 2, the main path's evolution and `bp_update`, 8 and 9 (no result
lines).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# spectrum families of tests/test_ops.py:208-217 (n = 128 singular values)
FAMILIES = {
    "gentle": np.geomspace(1.0, 1e-2, 128),
    "wide": np.geomspace(1.0, 1e-4, 128),
    "rank16": np.geomspace(1.0, 1e-2, 16),
    "rankcut": np.concatenate([np.geomspace(1.0, 1e-6, 64), np.zeros(64)]),
    "clusters": np.concatenate([np.ones(64), np.full(64, 1e-6)]),
}


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def scaled_families(n):
    """The families with n singular values (the cut families cut at n/2), as
    `tests/test_torch_ops.py::_families` scales them."""
    h = n // 2
    return {"gentle": np.geomspace(1.0, 1e-2, n), "wide": np.geomspace(1.0, 1e-4, n),
            "rank16": np.geomspace(1.0, 1e-2, 16), "rankcut": np.concatenate([np.geomspace(1.0, 1e-6, h), np.zeros(h)]),
            "clusters": np.concatenate([np.ones(h), np.full(h, 1e-6)])}


def spectrum_batch(rng, B, R, n, families=FAMILIES):
    """B matrices [R, n] with the families' singular values, in turn (zero
    past a family's length)."""
    out = []
    families = list(families.values())
    for b in range(B):
        spec = families[b % len(families)]
        s = np.zeros(n)
        s[: min(len(spec), n)] = spec[:n]
        U, _ = np.linalg.qr(rng.normal(size=(R, n)) + 1j * rng.normal(size=(R, n)))
        V, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        out.append((U * s[None, :]) @ V.conj().T)
    return np.stack(out).astype(np.complex64)


# the card's ceilings for `bound_ms` (H100 SXM at 700 W, NVIDIA's data
# sheet): FP32 outside the tensor cores, since the precision pins rule out
# TF32, and HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(flops, nbytes):
    """(least milliseconds for `flops` FP32 operations and `nbytes` moved,
    which of the two sets it)."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def cuda_ms(fn, reps, warmup=True):
    """Mean milliseconds per call of `fn` on the current stream, after one
    call unless `warmup` is False (a plain version has nothing to warm)."""
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternating_ms(fns, calls):
    """Milliseconds of each call of each of `fns`, the functions called in
    turn (a b a b ...) `calls` times each after one warm-up call of each,
    every call timed alone by CUDA events.  Returns one list a function, in
    call order."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(calls):
        for fn, t in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end))
    return times


def median(t):
    return sorted(t)[len(t) // 2]


def spread(t):
    """min / median / max of times, for a printed line."""
    return f"{min(t):.3f} / {median(t):.3f} / {max(t):.3f}"


# The 8 `pjsvd` calls of one Eagle chi=64 layer (`compile_circuit` on
# `eagle_lattice()`, thetas routed as `tnqs_torch/engine.py:716-733` routes
# them): (batch, theta rows, polish sweeps), width 128.  K2 takes each one's
# Gram [B, 128, 128] at pjsvd's 8 sweeps.
REAL_PATH = ((18, 128, 4), (18, 128, 4), (26, 256, 6), (9, 256, 6), (16, 256, 6), (20, 256, 6), (11, 256, 6),
             (24, 256, 6))


def eigh_bound(B, n, taken, log=0):
    """K2's bound: a rotation taken updates 2n elements of H's upper half
    (rows, then columns; the lower half is their mirror) and 2n of V's
    columns (`jacobi_eigh.cu`; past n = 256 V's in `rotation_log.cu`), each
    c x + s y with real c: 4 FMAs and 2 multiplies, 6 issue slots of the FP32
    pipe (a slot is 2 FLOP at the peak rate).  A pair found converged skips
    its update, so the rotations count as this run's data takes them, as the
    plain version counts them.  `log`: the rotation log's bytes, written and
    read, where V is made from it."""
    return bound(taken * 4 * n * 6 * 2, B * n * n * 8 * 2 + B * n * 4 + log)


def osj_bound(B, R, n, sweeps, taken, log=0):
    """K1's bound: every pair of every round forms its 2x2 Gram, 4 x 2 FMAs a
    row (`osj_svd.cu`, step 1); a rotation taken updates R + n rows of the
    pair's two columns of A and V, 12 issue slots each (`colmix`: 4 FMAs and
    2 multiplies per output); the rotations as this run's data takes them.
    `log`: the rotation log's bytes, written and read, where V is made from
    it (`rotation_log.cu`)."""
    pairs = B * sweeps * (n - 1) * (n // 2)
    return bound((pairs * 8 * R + taken * 12 * (R + n)) * 2, B * (R * n + n * n) * 8 * 2 + log)


def check_eigh(name, Hb, w, V):
    """Residual and orthonormality of refined eigenpairs, both below 1e-4."""
    n = Hb.shape[-1]
    require(torch.isfinite(w).all() and torch.isfinite(V).all(), f"jacobi_eigh {name}: non-finite output")
    scale = Hb.abs().amax(dim=(1, 2))
    resid = ((Hb @ V - V * w[:, None, :]).abs().amax(dim=(1, 2)) / scale).max().item()
    orth = (V.mH @ V - torch.eye(n, device=V.device)).abs().max().item()
    print(f"jacobi_eigh {name}: residual {resid:.3e}, orthonormality {orth:.3e}")
    require(resid < 1e-4 and orth < 1e-4, f"jacobi_eigh {name}: residual/orthonormality above 1e-4")


def kernel_phase(dev):
    from tnqs_torch.ops import jacobi, osj

    rng = np.random.default_rng(0)
    results = []
    print("K2 clusters of 3 CTAs the card holds at once: "
          + ", ".join(f"n={n}: {jacobi.active_clusters(dev, n)}" for n in (4, 32, 64, 128)))
    for R in (128, 256):
        plans = [(C, *osj.osj_plan(R, 128, C)) for C in osj.osj_fits(R, 128)]
        print(f"K1 plans for [B,{R},128]: " + "; ".join(
            f"C={C}: {cpc}+{vpc} chunks of A+V a CTA, {smem} B, {osj.active_clusters(dev, C, smem)} clusters at once"
            for C, cpc, vpc, smem in plans))
        print("  the wrapper's choice by batch: " + ", ".join(
            f"B={B}: C={osj.osj_cluster(B, R, 128, lambda C, smem: osj.active_clusters(dev, C, smem))}"
            for B in sorted({b for b, r, _ in REAL_PATH if r == R})))

    # K2: jacobi_eigh on Grams of [26, 256, 128] thetas, then at n = 4, 32,
    # 64 on [5, 2n, n] thetas, with the absolute skip of pjsvd's
    # preconditioner (the main path's).  Checked at its default 12 sweeps:
    # pjsvd's 8 leave clustered spectra at ~1e-4 residual by design (the
    # polish repairs the basis); timed at pjsvd's 8
    errs = []
    for B, R, n in ((26, 256, 128), (5, 8, 4), (5, 64, 32), (5, 128, 64)):
        A = torch.as_tensor(spectrum_batch(rng, B, R, n), device=dev)
        G = A.mH @ A
        Hb = (0.5 * (G + G.mH)).contiguous()
        w_k, V_k = jacobi.jacobi_eigh(G, sweeps=12, relative=False)
        w_p, V_p = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 12, False))
        torch.cuda.synchronize()
        check_eigh(f"kernel [{B},{n},{n}]", Hb, w_k, V_k)
        check_eigh(f"plain [{B},{n},{n}]", Hb, w_p, V_p)
        err = (w_k - w_p).abs().max().item()
        rel = ((w_k - w_p).abs().amax(1) / w_p.abs().amax(1)).max().item()
        print(f"jacobi_eigh [{B},{n},{n}] kernel vs plain: max |dw| {err:.3e}, relative to largest {rel:.3e}")
        require(rel < 1e-4, f"jacobi_eigh [{B},{n},{n}]: kernel and plain eigenvalues differ by more than 1e-4")
        errs.append(err)
        if n == 128:
            G26, Hb26 = G, Hb
    ms = cuda_ms(lambda: jacobi.jacobi_eigh(G26, sweeps=8, relative=False), 10)
    plain_ms = cuda_ms(lambda: jacobi.eigh_from_rounds(Hb26, *jacobi._jacobi_eigh_plain(Hb26, 8, False)), 2)
    library_ms = cuda_ms(lambda: torch.linalg.eigh(Hb26), 10)
    B, n = Hb26.shape[:2]
    taken = jacobi._jacobi_eigh_plain.rotations.item()
    bound_ms, bound_by = eigh_bound(B, n, taken)
    print(f"jacobi_eigh [26,128,128] sweeps=8: kernel {ms:.3f} ms (wrapper, refinement included), plain "
          f"{plain_ms:.3f} ms, torch.linalg.eigh {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{taken} of {B * 8 * (n - 1) * (n // 2)} rotations taken)")
    results.append(dict(name="jacobi_eigh", route="cuda", source="tnqs_torch/csrc/jacobi_eigh.cu",
                        replaces="tnqs/ops/jacobi.py:279", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))

    # K1: osj_svd as pjsvd's polish on [18, 128, 128] (4 sweeps) and
    # [26, 256, 128] (6 sweeps), then at n = 4, 32, 64; the plain version
    # gets the same (B0, V0), and so does the kernel at every cluster size
    # it can take, which must agree bitwise (the Gram sums go in chunk order)
    errs, times = [], {}
    for B, R, n, polish in ((18, 128, 128, 4), (26, 256, 128, 6), (5, 8, 4, 6), (5, 64, 32, 6), (5, 128, 64, 6)):
        A = torch.as_tensor(spectrum_batch(rng, B, R, n), device=dev)
        _, V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8, relative=False)
        B0 = A @ V0
        U_k, s_k, Vh_k = osj.osj_svd(B0, V0, sweeps=polish)
        Ab, scale = osj.prescale(B0)
        U_p, s_p, Vh_p = osj.svd_from_rounds(*osj._osj_svd_plain(Ab, V0, polish), scale)
        U_j, s_j, Vh_j = osj.pjsvd(A, polish_sweeps=polish)
        U0, s0, Vh0 = torch.linalg.svd(A.to(torch.complex128), full_matrices=False)
        # chi=64 shapes: the rank-64 truncation against LAPACK's; the small
        # ones, whose families hold exactly equal values, the whole product
        k = 64 if n == 128 else n
        best = (U0[:, :, :k] * s0[:, None, :k]) @ Vh0[:, :k]
        for name, U, s, Vh in (("kernel", U_k, s_k, Vh_k), ("plain", U_p, s_p, Vh_p), ("pjsvd", U_j, s_j, Vh_j)):
            require(all(torch.isfinite(x).all() for x in (U, s, Vh)), f"osj_svd {name} [{B},{R},{n}]: non-finite")
            rec = ((U[:, :, :k] * s[:, None, :k]) @ Vh[:, :k]).to(torch.complex128)
            recon = (torch.linalg.vector_norm((rec - best).flatten(1), dim=1) / s0[:, 0]).max().item()
            s_err = ((s.double() - s0).abs().amax(1) / s0[:, 0]).max().item()
            print(f"osj_svd {name} [{B},{R},{n}]: rank-{k} reconstruction {recon:.3e}, s error {s_err:.3e}")
            require(recon < 3e-5, f"osj_svd {name} [{B},{R},{n}]: truncated reconstruction above 3e-5")
            require(s_err < 1e-4, f"osj_svd {name} [{B},{R},{n}]: singular values off by more than 1e-4")
        err = (s_k - s_p).abs().max().item()
        rel = ((s_k - s_p).abs().amax(1) / s_p[:, 0]).max().item()
        print(f"osj_svd [{B},{R},{n}] kernel vs plain: max |ds| {err:.3e}, relative to largest {rel:.3e}")
        require(rel < 1e-4, f"osj_svd [{B},{R},{n}]: kernel and plain singular values differ by more than 1e-4")
        errs.append(err)
        Ab = Ab.contiguous()
        outs = {C: osj._osj_svd_cuda(Ab, V0, polish, cluster=C) for C in osj.osj_fits(R, n)}
        first = next(iter(outs.values()))
        same = all(torch.equal(a, first[0]) and torch.equal(v, first[1]) for a, v in outs.values())
        print(f"osj_svd [{B},{R},{n}] at cluster sizes {list(outs)}: bitwise the same {same}")
        require(same, f"osj_svd [{B},{R},{n}]: the cluster sizes {list(outs)} disagree")
        if n != 128:
            continue
        k_ms = cuda_ms(lambda: osj.osj_svd(B0, V0, sweeps=polish), 10)
        p_ms = cuda_ms(lambda: osj.svd_from_rounds(*osj._osj_svd_plain(Ab, V0, polish), scale), 2)
        l_ms = cuda_ms(lambda: torch.linalg.svd(A, full_matrices=False), 10)
        pairs, taken = B * polish * (n - 1) * (n // 2), osj._osj_svd_plain.rotations.item()
        times[(B, R)] = (k_ms, p_ms, l_ms, *osj_bound(B, R, n, polish, taken))
        print(f"osj_svd [{B},{R},128] sweeps={polish}: kernel {k_ms:.3f} ms (wrapper, prescale and sort included), "
              f"plain {p_ms:.3f} ms, torch.linalg.svd {l_ms:.3f} ms, bound {times[(B, R)][3]:.3f} ms "
              f"({times[(B, R)][4]}; {taken} of {pairs} rotations taken)")
    ms, plain_ms, library_ms, bound_ms, bound_by = times[(26, 256)]
    results.append(dict(name="osj_svd", route="cuda", source="tnqs_torch/csrc/osj_svd.cu",
                        replaces="tnqs/ops/osj.py:306", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))

    # each kernel alone at the main path's shapes: K2 on the Gram of every
    # theta batch at 8 sweeps, K1 on every theta batch at its polish sweeps
    print("the main path's shapes, kernel alone (CUDA events, 10 calls), bound from the plain version's rotations:")
    for B, R, polish in sorted(set(REAL_PATH)):
        A = torch.as_tensor(spectrum_batch(rng, B, R, 128), device=dev)
        Hb = (A.mH @ A).contiguous()
        Hb = (0.5 * (Hb + Hb.mH)).contiguous()
        k2_ms = cuda_ms(lambda: jacobi._jacobi_eigh_cuda(Hb, 8, False), 10)
        w, V0 = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 8, False))
        k2_bound = eigh_bound(B, 128, jacobi._jacobi_eigh_plain.rotations.item())
        Ab, _ = osj.prescale(A @ V0)
        Ab = Ab.contiguous()
        k1_ms = cuda_ms(lambda: osj._osj_svd_cuda(Ab, V0, polish), 10)
        osj._osj_svd_plain(Ab, V0, polish)
        k1_bound = osj_bound(B, R, 128, polish, osj._osj_svd_plain.rotations.item())
        C = osj.osj_cluster(B, R, 128, lambda C, smem: osj.active_clusters(dev, C, smem))
        print(f"  K2 [{B},128,128] 8 sweeps: {k2_ms:.3f} ms, bound {k2_bound[0]:.3f} ms ({k2_bound[1]}); "
              f"K1 [{B},{R},128] {polish} sweeps, C={C}: {k1_ms:.3f} ms, bound {k1_bound[0]:.3f} ms ({k1_bound[1]})")
    return results


# K1 and K2 past n = 128: the saturated thetas of the chi = 96 (n = 192) and
# chi = 128 (n = 256) Eagle layers, at the largest batches of a layer's
# groups (`REAL_PATH`'s, whose classes are the same at every chi): (batch,
# theta rows, width, polish sweeps).  K2 takes the tall ones' Grams.
WIDE_N = (192, 256)
WIDE_PATH = ((26, 384, 192, 6), (18, 192, 192, 4), (26, 512, 256, 6), (18, 256, 256, 4))
F2_MEMBER = 21  # the zero-padded [26, 384, 192] batch's worst member under the kernel (`zero_padded_member`)


WIDE_TIMED_CALLS = 5  # calls of K2 and of `eigh` at n = 192/256, in turn
WIDE_FULL_B = 54  # [54, 256, 256]: 8e's full-truncation Grams (12 sweeps, the relative skip)
# the narrowest width past 128 and the two sides of `jacobi.RING_N`: pair ranges that do not split
# evenly over the CTAs (130 on 4: 16-17 pairs a CTA; 224 on 4: 28; 226 on 4: 28-29)
WIDE_EDGE_N = (130, 224, 226)


def k2_plan(dev, B, n):
    """The launch `jacobi._jacobi_eigh_cuda` takes for B matrices [n, n]
    past n = 128 at 8 sweeps: (layout and V's route, cluster size, clusters
    at once, waves, shared bytes a CTA, whether V's kernel follows the
    rounds on the SMs they leave)."""
    from tnqs_torch.ops import jacobi, rotation_log

    if jacobi.v_route_of(n) == "ring":
        C, held, waves, smem = jacobi.eigh_ring_plan(B, n, lambda C: jacobi.res_active_clusters(dev, n, C, True))
        return "resident, V in the rings", C, held, waves, smem, False
    plan = jacobi.eigh_log_plan(B, n, 8 * (n - 1), jacobi.log_active_clusters(dev, n))
    follows = plan.layout == "resident" and rotation_log.follows(plan.group, plan.cluster, plan.clusters, dev)
    return f"{plan.layout}, V from the log", plan.cluster, plan.clusters, plan.waves, plan.smem, follows


def k2_refined(Hb, sweeps, relative):
    """K2 on the Hermitian Hb [B, n, n] as `jacobi_eigh` runs it on the
    card: the kernel, then the refinement and sort."""
    from tnqs_torch.ops import jacobi

    return jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_cuda(Hb, sweeps, relative))


def wide_eigh_timed(Hb, sweeps, relative):
    """K2 and `torch.linalg.eigh` on Hb in turn, `WIDE_TIMED_CALLS` calls
    each timed alone (K2's refinement included): {name: times}, and the
    rotations K2 took."""
    from tnqs_torch.ops import jacobi

    fns = {"kernel": lambda: k2_refined(Hb, sweeps, relative), "eigh": lambda: torch.linalg.eigh(Hb)}
    times = dict(zip(fns, alternating_ms(list(fns.values()), WIDE_TIMED_CALLS)))
    k2_refined(Hb, sweeps, relative)
    return times, jacobi.jacobi_eigh.rotations.item()


def k1_plan(dev, B, R, n, polish):
    """The launch `osj._osj_svd_cuda` takes for B matrices [R, n] past
    n = 128 at `polish` sweeps: (plan, chunks of A a CTA at most, whether
    V's kernel follows the rounds on the SMs they leave)."""
    from tnqs_torch.ops import osj, rotation_log

    plan, _, cpc = osj.osj_log_plan(B, R, n, polish * (n - 1), osj.log_active_clusters(dev, n))
    follows = plan.layout == "resident" and rotation_log.follows(plan.group, plan.cluster, plan.clusters, dev)
    return plan, cpc, follows


def wide_kernel_phase(dev):
    """K1 and K2 past n = 128 against their plain versions on the card: K2's
    resident variant on [26, n, n] Grams at n = 192 and 256 in both skips
    by the route `jacobi.v_route_of` gives each width (checked at 12
    sweeps; timed at pjsvd's 8 sweeps with the absolute skip and at
    `default_eigh`'s 12 with the relative one, and at [54, 256, 256], 8e's
    full truncation, in turn with `torch.linalg.eigh`); at the widths whose
    pair ranges split unevenly (`WIDE_EDGE_N`) checked at `L2_CHECK_SWEEPS`;
    K1 as pjsvd's polish on every shape of `WIDE_PATH`, each beside the
    library call and its bound.  Returns the rows of the `kernels` line,
    one per kernel and width."""
    from tnqs_torch.ops import jacobi, osj

    rng = np.random.default_rng(10)
    more = np.random.default_rng(11)  # the shapes only timed, drawn apart so the checked inputs stay as they were
    for n in WIDE_N:
        for B in (26, WIDE_FULL_B) if n == 256 else (26,):
            layout, C, held, waves, smem, follows = k2_plan(dev, B, n)
            print(f"K2 [{B},{n},{n}]: {layout}, clusters of {C} CTAs, {held} at once, {waves} waves, {smem} B a CTA"
                  + (f", V's kernel beside the rounds: {follows}" if "log" in layout else ""))
    for B, R, n, polish in WIDE_PATH:
        plan, cpc, follows = k1_plan(dev, B, R, n, polish)
        print(f"K1 [{B},{R},{n}]: {plan.layout}, A alone, clusters of {plan.cluster} CTAs (of "
              f"{list(osj.osj_res_sizes(R, n))} that fit), {cpc} chunks of A a CTA at most, {plan.smem} B a CTA, "
              f"{plan.clusters} clusters at once, {plan.waves} waves; V from the log "
              f"{'beside' if follows else 'after'} the rounds")
    rows = {}
    for n in WIDE_N:
        B = 26
        A = torch.as_tensor(spectrum_batch(rng, B, 2 * n, n, scaled_families(n)), device=dev)
        G = A.mH @ A
        Hb = (0.5 * (G + G.mH)).contiguous()
        errs, timed = [], {}
        route = jacobi.v_route_of(n)
        for relative, sweeps in ((False, 8), (True, 12)):
            skip = "relative" if relative else "absolute"
            w_p, V_p = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 12, relative))
            check_eigh(f"plain [{B},{n},{n}] {skip}", Hb, w_p, V_p)
            w_k, V_k = jacobi.jacobi_eigh(G, sweeps=12, relative=relative)
            torch.cuda.synchronize()
            check_eigh(f"resident, V {route}, [{B},{n},{n}] {skip}", Hb, w_k, V_k)
            rel = ((w_k - w_p).abs().amax(1) / w_p.abs().amax(1)).max().item()
            errs.append((w_k - w_p).abs().max().item())
            print(f"jacobi_eigh resident, V {route}, [{B},{n},{n}] {skip} kernel vs plain: max |dw| {errs[-1]:.3e}, "
                  f"relative to largest {rel:.3e}")
            require(rel < 1e-4, f"jacobi_eigh [{B},{n},{n}] {skip}: kernel and plain differ by more than 1e-4")
            times, taken = wide_eigh_timed(Hb, sweeps, relative)
            ms, library_ms = median(times["kernel"]), median(times["eigh"])
            plain_ms = cuda_ms(lambda: jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, sweeps, relative)),
                               1, warmup=False)
            bound_ms, bound_by = eigh_bound(B, n, taken, log_bytes(B, n, sweeps * (n - 1)) if route == "log" else 0)
            timed[skip] = (ms, plain_ms, bound_ms, bound_by, library_ms)
            print(f"jacobi_eigh [{B},{n},{n}] sweeps={sweeps} {skip}, V {route}, {WIDE_TIMED_CALLS} calls each in "
                  f"turn, min / median / max ms: " + "; ".join(f"{k} {spread(t)}" for k, t in times.items())
                  + f"; plain {plain_ms:.3f}; bound {bound_ms:.3f} ({bound_by}; {taken} of "
                  f"{B * sweeps * (n - 1) * (n // 2)} rotations taken; kernel at {100 * bound_ms / ms:.1f}%)",
                  flush=True)
            if n == 256 and relative:
                Af = torch.as_tensor(spectrum_batch(more, WIDE_FULL_B, 2 * n, n, scaled_families(n)), device=dev)
                Gf = Af.mH @ Af
                Hf = (0.5 * (Gf + Gf.mH)).contiguous()
                times_f, taken_f = wide_eigh_timed(Hf, sweeps, relative)
                print(f"jacobi_eigh [{WIDE_FULL_B},{n},{n}] sweeps={sweeps} {skip} (8e's full truncation), min / "
                      f"median / max ms: " + "; ".join(f"{k} {spread(t)}" for k, t in times_f.items())
                      + f"; {taken_f} rotations taken", flush=True)
        ms, plain_ms, bound_ms, bound_by, library_ms = timed["absolute"]
        layout, C, held, _, _, _ = k2_plan(dev, B, n)
        rows[f"jacobi_eigh_res n={n}"] = dict(
            name=f"jacobi_eigh_res n={n}", route="cuda", source="tnqs_torch/csrc/jacobi_eigh.cu",
            replaces="tnqs/ops/jacobi.py:279", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, shape=[B, n, n], sweeps=8, layout=layout, cluster=C,
            clusters=held,
            relative_12=dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), timed["relative"])))

    for n in WIDE_EDGE_N:  # the route each width takes, against the plain version on two members
        A = torch.as_tensor(spectrum_batch(more, 26, 2 * n, n, scaled_families(n)), device=dev)
        G = A.mH @ A
        Hb = (0.5 * (G + G.mH)).contiguous()
        w_p, _ = jacobi.eigh_from_rounds(Hb[:2], *jacobi._jacobi_eigh_plain(Hb[:2], L2_CHECK_SWEEPS, False))
        w_k, V_k = k2_refined(Hb, L2_CHECK_SWEEPS, False)
        check_eigh(f"resident, V {jacobi.v_route_of(n)}, [26,{n},{n}] absolute", Hb, w_k, V_k)
        rel = ((w_k[:2] - w_p).abs().amax(1) / w_p.abs().amax(1)).max().item()
        print(f"jacobi_eigh resident, V {jacobi.v_route_of(n)}, [26,{n},{n}] absolute, {L2_CHECK_SWEEPS} sweeps: "
              f"kernel vs plain on 2 members, relative to largest {rel:.3e}", flush=True)
        require(rel < 1e-4, f"jacobi_eigh [26,{n},{n}]: kernel and plain differ by more than 1e-4")
    for B, R, n, polish in WIDE_PATH:
        A = torch.as_tensor(spectrum_batch(rng, B, R, n, scaled_families(n)), device=dev)
        _, V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8, relative=False)
        B0 = A @ V0
        U_k, s_k, Vh_k = osj.osj_svd(B0, V0, sweeps=polish)
        Ab, scale = osj.prescale(B0)
        Ab = Ab.contiguous()
        U_p, s_p, Vh_p = osj.svd_from_rounds(*osj._osj_svd_plain(Ab, V0, polish), scale)
        taken = osj._osj_svd_plain.rotations.item()
        U_j, s_j, Vh_j = osj.pjsvd(A, polish_sweeps=polish)
        U0, s0, Vh0 = torch.linalg.svd(A.to(torch.complex128), full_matrices=False)
        k = n // 2  # the bond: the rank-chi truncation against LAPACK's
        best = (U0[:, :, :k] * s0[:, None, :k]) @ Vh0[:, :k]
        for name, U, s, Vh in (("kernel", U_k, s_k, Vh_k), ("plain", U_p, s_p, Vh_p), ("pjsvd", U_j, s_j, Vh_j)):
            require(all(torch.isfinite(x).all() for x in (U, s, Vh)), f"osj_svd {name} [{B},{R},{n}]: non-finite")
            rec = ((U[:, :, :k] * s[:, None, :k]) @ Vh[:, :k]).to(torch.complex128)
            recon = (torch.linalg.vector_norm((rec - best).flatten(1), dim=1) / s0[:, 0]).max().item()
            s_err = ((s.double() - s0).abs().amax(1) / s0[:, 0]).max().item()
            print(f"osj_svd {name} [{B},{R},{n}]: rank-{k} reconstruction {recon:.3e}, s error {s_err:.3e}")
            require(recon < 3e-5, f"osj_svd {name} [{B},{R},{n}]: truncated reconstruction above 3e-5")
            require(s_err < 1e-4, f"osj_svd {name} [{B},{R},{n}]: singular values off by more than 1e-4")
        err = (s_k - s_p).abs().max().item()
        rel = ((s_k - s_p).abs().amax(1) / s_p[:, 0]).max().item()
        print(f"osj_svd [{B},{R},{n}] kernel vs plain: max |ds| {err:.3e}, relative to largest {rel:.3e}")
        require(rel < 1e-4, f"osj_svd [{B},{R},{n}]: kernel and plain singular values differ by more than 1e-4")
        if (R, n) == (384, 192):
            zero_padded_member(dev, B, R, n, polish)
        # the result depends on the cluster size (the owners sum the CTAs' partials in CTA order), not on the run
        same_calls(lambda: osj._osj_svd_cuda(Ab, V0, polish), f"osj_svd [{B},{R},{n}]")
        plan, _, follows = k1_plan(dev, B, R, n, polish)
        k_ms = cuda_ms(lambda: osj.osj_svd(B0, V0, sweeps=polish), 5)
        k_taken = osj.osj_svd.rotations.item()
        p_ms = cuda_ms(lambda: osj.svd_from_rounds(*osj._osj_svd_plain(Ab, V0, polish), scale), 1, warmup=False)
        l_ms = cuda_ms(lambda: torch.linalg.svd(A, full_matrices=False), 2)
        log = log_bytes(B, n, polish * (n - 1))
        bound_ms, bound_by = osj_bound(B, R, n, polish, k_taken, log)
        print(f"osj_svd [{B},{R},{n}] sweeps={polish}, {plan.layout} on C={plan.cluster}, {plan.waves} waves, V "
              f"{'beside' if follows else 'after'} the rounds: kernel {k_ms:.3f} ms (wrapper, V's kernel, prescale "
              f"and sort included; {L2_SAME_CALLS} calls bitwise equal), plain {p_ms:.3f} ms, torch.linalg.svd "
              f"{l_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; {k_taken} of {B * polish * (n - 1) * (n // 2)} "
              f"rotations taken, counted by the kernel ({taken} by the plain version); log {log} B; kernel at "
              f"{100 * bound_ms / k_ms:.1f}%)", flush=True)
        row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=l_ms, shape=[B, R, n],
                   sweeps=polish, max_abs_err=err, layout=plan.layout, cluster=plan.cluster, clusters=plan.clusters)
        if R > n:
            rows[f"osj_svd n={n}"] = dict(name=f"osj_svd n={n}", route="cuda", source="tnqs_torch/csrc/osj_svd.cu",
                                          replaces="tnqs/ops/osj.py:306", **row)
        else:
            rows[f"osj_svd n={n}"]["square"] = row
            rows[f"osj_svd n={n}"]["max_abs_err"] = max(err, rows[f"osj_svd n={n}"]["max_abs_err"])
    return list(rows.values())


# K1 and K2 past n = 256: K2 on [B, n, n] Grams at n = 320 (chi = 160) and
# 512 (the thermal path's thetas, chi = 256), H resident in a cluster of 8
# or 16; K1 as pjsvd's polish (batch, rows, width, polish sweeps) at the
# thermal path's saturated thetas ([4, 512, 512] a call, three calls a step in
# 10e) and the chi = 160 thetas (A resident in a cluster of 16) and the
# chi = 256 ones (A in L2); V from each call's rotation log.  Past the
# resident layouts, the L2 variants: K2 at the first width past it and K1 at
# the first height past it at n = 512 (`L2_BOUNDARY`).
L2_N = (320, 512)
L2_EIGH = ((26, 320), (4, 512))
L2_PATH = ((4, 512, 512, 4), (26, 640, 320, 6), (26, 1024, 512, 6))
L2_BOUNDARY = ((2, 600), (2, 544, 512, 6))  # K2 [B, n], K1 [B, R, n, polish]: the L2 variants
L2_PLAIN_BATCH = 2  # the plain comparison's batch; the kernels run and are timed at the full batch
L2_SAME_CALLS = 5  # calls of each kernel that must agree bit for bit
L2_TIMED_CALLS = 10  # calls of K2 past n = 256 and of `torch.linalg.eigh`, in turn, each timed alone
L2_CHUNK_ROUNDS = 1000  # rounds a launch when `l2_chunk_case` splits the L2 variants' schedule
# sweeps at which K2's variants past n = 256 are held to their plain version:
# both skips converge every family there (at 12 with the relative skip the
# plain version itself leaves 1.1e-05 of the spectral norm on the clusters
# family at n = 320)
L2_CHECK_SWEEPS = 16
# The earlier design's times (V in the rounds, the iterate in L2), recorded
# on an NVIDIA H100 80GB HBM3, 700 W (PERF.md §6), not measured by this
# script: printed on a labelled line of their own, never in the `kernels` line
EARLIER_MS = {"jacobi_eigh_l2 n=320": {"ms": 45.626, "relative_12": 76.461},
              "jacobi_eigh_l2 n=512": {"ms": 54.251, "relative_12": 83.130},
              "osj_svd_l2 n=512": {"ms": 30.688, "tall": 344.368}, "osj_svd_l2 n=320": {"ms": 114.166}}
EARLIER_THERMAL_S = 2.837  # 10e complex64 "highest" on the earlier design (recorded, PERF.md §6)


def l2_residual(Hb, w, V):
    """max |H V - V diag(w)| of each member over its spectral norm."""
    return (Hb @ V - V * w[:, None, :]).abs().amax(dim=(1, 2)) / w.abs().amax(1)


L2_LAPACK_BATCH = 5  # members held to LAPACK's SVD: one of each spectrum family
# polish sweeps at which pjsvd is held to LAPACK's graded bounds: the
# engine's square schedule (4, JAX's) leaves the dense families unconverged
# at n = 512 in the plain version as in the kernel (recorded beside it)
L2_GRADED_SWEEPS = 6


def log_bytes(B, n, rounds):
    """The rotation log a call writes and the V kernel reads: 16 n/2 bytes a
    round a matrix, twice."""
    return 2 * B * rounds * 8 * n


def same_calls(fn, label):
    """`L2_SAME_CALLS` calls of `fn`, every output bitwise the first's."""
    first = fn()
    for _ in range(L2_SAME_CALLS - 1):
        again = fn()
        require(all(torch.equal(a, b) for a, b in zip(first, again)), f"{label}: {L2_SAME_CALLS} calls differ")
    return first


def l2_eigh_case(dev, rng, B, n, skips, plain_timed):
    """K2 past n = 256 on the Grams [B, n, n] of the families scaled to n:
    per skip, checked at `L2_CHECK_SWEEPS` against its plain version on the
    first `L2_PLAIN_BATCH` members (eigenvalues within 1e-5 of the spectral
    norm) and on every member (eigen-residual at most 1e-5 of it),
    `L2_SAME_CALLS` calls bitwise equal; timed at pjsvd's 8 sweeps with the
    absolute skip and `default_eigh`'s 12 with the relative one, in turn
    with `torch.linalg.eigh` (`L2_TIMED_CALLS` calls each, the medians
    kept), beside the bound (and, with `plain_timed`, the plain version).  Returns {skip: (ms, plain_ms, bound_ms, bound_by, library_ms,
    taken)}, the largest |dw| and the plan."""
    from tnqs_torch.ops import jacobi

    pb = L2_PLAIN_BATCH
    plan = jacobi.eigh_log_plan(B, n, 8 * (n - 1), jacobi.log_active_clusters(dev, n))
    print(f"K2 past 256 [{B},{n},{n}]: {plan} (clusters the card holds: resident of 16 "
          f"{jacobi.res_active_clusters(dev, n, 16) if jacobi.eigh_res_fits(n, 16) else 0}, of 8 "
          f"{jacobi.res_active_clusters(dev, n, 8) if jacobi.eigh_res_fits(n, 8) else 0}; L2 of 16 "
          f"{jacobi.l2_active_clusters(dev, n, 16)}, of 8 {jacobi.l2_active_clusters(dev, n, 8)})")
    A = torch.as_tensor(spectrum_batch(rng, B, 2 * n, n, scaled_families(n)), device=dev)
    G = A.mH @ A
    Hb = (0.5 * (G + G.mH)).contiguous()
    errs, timed = [], {}
    for relative, sweeps in skips:
        skip = "relative" if relative else "absolute"
        layouts = dict(jacobi.jacobi_eigh.launches_by_layout)
        same_calls(lambda: jacobi._jacobi_eigh_cuda(Hb, L2_CHECK_SWEEPS, relative), f"jacobi_eigh [{B},{n},{n}] {skip}")
        used = {k: v - layouts[k] for k, v in jacobi.jacobi_eigh.launches_by_layout.items() if v > layouts[k]}
        require(list(used) == [plan.layout], f"jacobi_eigh [{B},{n},{n}]: launched {used}, planned {plan.layout}")
        w_k, V_k = jacobi.jacobi_eigh(G, sweeps=L2_CHECK_SWEEPS, relative=relative)
        w_p, V_p = jacobi.eigh_from_rounds(Hb[:pb], *jacobi._jacobi_eigh_plain(Hb[:pb], L2_CHECK_SWEEPS, relative))
        torch.cuda.synchronize()
        check_eigh(f"{plan.layout} kernel [{B},{n},{n}] {skip}", Hb, w_k, V_k)
        check_eigh(f"plain [{pb},{n},{n}] {skip}", Hb[:pb], w_p, V_p)
        dw = ((w_k[:pb] - w_p).abs().amax(1) / w_k[:pb].abs().amax(1)).max().item()
        resid = l2_residual(Hb, w_k, V_k).max().item()
        errs.append((w_k[:pb] - w_p).abs().max().item())
        print(f"jacobi_eigh {plan.layout} [{B},{n},{n}] {skip}, {L2_CHECK_SWEEPS} sweeps: kernel vs plain on {pb} "
              f"members max |dw| {dw:.3e} of the spectral norm (bound 1e-5), kernel eigen-residual {resid:.3e} of it "
              f"on all {B} (bound 1e-5); {L2_SAME_CALLS} calls bitwise equal")
        require(dw <= 1e-5 and resid <= 1e-5, f"jacobi_eigh [{B},{n},{n}] {skip}: off its plain version")
        torch.cuda.reset_peak_memory_stats()
        k_t, l_t = alternating_ms((lambda: jacobi.jacobi_eigh(G, sweeps=sweeps, relative=relative),
                                   lambda: torch.linalg.eigh(Hb)), L2_TIMED_CALLS)
        ms, library_ms = median(k_t), median(l_t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        taken = jacobi.jacobi_eigh.rotations.item()
        w_t, V_t = jacobi.jacobi_eigh(G, sweeps=sweeps, relative=relative)
        plain_ms = float("nan")
        if plain_timed:
            plain_ms = cuda_ms(lambda: jacobi.eigh_from_rounds(
                Hb[:pb], *jacobi._jacobi_eigh_plain(Hb[:pb], sweeps, relative)), 1, warmup=False)
            r_t = l2_residual(Hb, w_t, V_t)
            b = int(r_t.argmax())  # the kernel's worst member, through the plain version too
            w_q, V_q = jacobi.eigh_from_rounds(Hb[b:b + 1], *jacobi._jacobi_eigh_plain(Hb[b:b + 1], sweeps, relative))
            print(f"jacobi_eigh [{B},{n},{n}] {skip} at the timed {sweeps} sweeps (recorded): eigen-residual of the "
                  f"spectral norm, kernel {r_t.max().item():.3e} on all {B} (member {b}), plain "
                  f"{l2_residual(Hb[b:b + 1], w_q, V_q).item():.3e} on member {b}")
        bound_ms, bound_by = eigh_bound(B, n, taken, log_bytes(B, n, sweeps * (n - 1)))
        timed[skip] = (ms, plain_ms, bound_ms, bound_by, library_ms, taken)
        print(f"jacobi_eigh {plan.layout} [{B},{n},{n}] sweeps={sweeps} {skip}: kernel {ms:.3f} ms (wrapper, V's "
              f"kernel, copies and refinement included; peak {peak:.3f} GiB), plain {plain_ms:.3f} ms at batch {pb}, "
              f"torch.linalg.eigh {library_ms:.3f} ms ({'faster' if ms < library_ms else 'slower'}: "
              f"{library_ms / ms:.2f}x; medians of {L2_TIMED_CALLS} calls each in turn, min / median / max: kernel "
              f"{spread(k_t)}, eigh {spread(l_t)}; kernel faster in {sum(a < b for a, b in zip(k_t, l_t))} of the "
              f"{L2_TIMED_CALLS} pairs), bound {bound_ms:.3f} ms ({bound_by}; {taken} of "
              f"{B * sweeps * (n - 1) * (n // 2)} rotations taken, counted by the kernel; kernel at "
              f"{100 * bound_ms / ms:.1f}%)", flush=True)
    return timed, max(errs), plan


def l2_osj_case(dev, rng, B, R, n, polish, plain_timed):
    """K1 past the cluster kernel as pjsvd's polish on [B, R, n]: against
    its plain version (s within 1e-5 of s_max) and pjsvd against LAPACK by
    the graded bounds of `tests/test_torch_wide_pjsvd.py` on one member of
    each family, `L2_SAME_CALLS` calls bitwise equal, timed beside
    `torch.linalg.svd` and the bound (and, with `plain_timed`, the plain
    version).  Returns the row's numbers and the plan."""
    from tnqs_torch.ops import jacobi, osj

    pb = L2_PLAIN_BATCH
    plan, nch, cpc = osj.osj_log_plan(B, R, n, polish * (n - 1), osj.log_active_clusters(dev, n))
    print(f"K1 past the cluster kernel [{B},{R},{n}]: {plan}, {nch} chunks of A, {cpc} a CTA resident")
    A = torch.as_tensor(spectrum_batch(rng, B, R, n, scaled_families(n)), device=dev)
    _, V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8, relative=False)
    B0 = A @ V0
    Ab, scale = osj.prescale(B0)
    Ab, V0c = Ab.contiguous(), V0.contiguous()
    layouts = dict(osj.osj_svd.launches_by_layout)
    same_calls(lambda: osj._osj_svd_cuda(Ab, V0c, polish), f"osj_svd [{B},{R},{n}]")
    used = {k: v - layouts[k] for k, v in osj.osj_svd.launches_by_layout.items() if v > layouts[k]}
    require(list(used) == [plan.layout], f"osj_svd [{B},{R},{n}]: launched {used}, planned {plan.layout}")
    lb = min(L2_LAPACK_BATCH, B)
    U0, s0, Vh0 = torch.linalg.svd(A[:lb].to(torch.complex128), full_matrices=False)
    k = n // 2  # the bond: the rank-chi truncation against LAPACK's
    best = (U0[:, :, :k] * s0[:, None, :k]) @ Vh0[:, :k]
    fams = list(scaled_families(n))
    for sweeps in sorted({polish, max(polish, L2_GRADED_SWEEPS)}):
        # the engine's sweeps, recorded; the graded bounds where the schedule converges
        gated = sweeps >= L2_GRADED_SWEEPS
        U_k, s_k, Vh_k = osj.osj_svd(B0, V0, sweeps=sweeps)
        U_p, s_p, Vh_p = osj.svd_from_rounds(*osj._osj_svd_plain(Ab[:pb], V0c[:pb], sweeps), scale[:pb])
        U_j, s_j, Vh_j = osj.pjsvd(A, polish_sweeps=sweeps)
        off = []
        for name, U, s, Vh, b in (("kernel", U_k, s_k, Vh_k, lb), ("plain", U_p, s_p, Vh_p, pb),
                                  ("pjsvd", U_j, s_j, Vh_j, lb)):
            require(all(torch.isfinite(x).all() for x in (U, s, Vh)), f"osj_svd {name} [{B},{R},{n}]: non-finite")
            U, s, Vh = U[:b], s[:b], Vh[:b]
            rec = ((U[:, :, :k] * s[:, None, :k]) @ Vh[:, :k]).to(torch.complex128)
            recon = torch.linalg.vector_norm((rec - best[:b]).flatten(1), dim=1) / s0[:b, 0]
            s_err = (s.double() - s0[:b]).abs().amax(1) / s0[:b, 0]
            sorted_ok = bool((s[:, 1:] - s[:, :-1] <= 1e-6).all())
            print(f"osj_svd {plan.layout} {name} [{B},{R},{n}] {sweeps} sweeps ({'gated' if gated else 'recorded'}): "
                  f"rank-{k} reconstruction (bound 3e-5) and s error (bound 1e-4) of s_max by member: "
                  + ", ".join(f"{fams[i % 5]} {r.item():.3e} {e.item():.3e}"
                              for i, (r, e) in enumerate(zip(recon, s_err)))
                  + f"; descending {sorted_ok}")
            if not (recon.max().item() < 3e-5 and s_err.max().item() < 1e-4 and sorted_ok):
                off.append(name)
        require(not gated or not off, f"osj_svd [{B},{R},{n}]: {off} off LAPACK")
        # the kernel against its plain version: gated where the schedule
        # converges; before it the two part by float32 rounding (F2)
        err = (s_k[:pb] - s_p).abs().max().item()
        rel = ((s_k[:pb] - s_p).abs().amax(1) / s_p[:, 0]).max().item()
        print(f"osj_svd {plan.layout} [{B},{R},{n}] {sweeps} sweeps ({'gated' if gated else 'recorded'}) kernel vs "
              f"plain on {pb} members: max |ds| {err:.3e}, {rel:.3e} of s_max (bound 1e-5); {L2_SAME_CALLS} calls "
              f"bitwise equal")
    require(rel <= 1e-5, f"osj_svd [{B},{R},{n}]: kernel and plain singular values differ")
    torch.cuda.reset_peak_memory_stats()
    k_ms = cuda_ms(lambda: osj.osj_svd(B0, V0, sweeps=polish), 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    taken = osj.osj_svd.rotations.item()
    p_ms = float("nan")
    if plain_timed:
        p_ms = cuda_ms(lambda: osj.svd_from_rounds(*osj._osj_svd_plain(Ab[:pb], V0c[:pb], polish), scale[:pb]), 1,
                       warmup=False)
    l_ms = cuda_ms(lambda: torch.linalg.svd(A, full_matrices=False), 2)
    bound_ms, bound_by = osj_bound(B, R, n, polish, taken, log_bytes(B, n, polish * (n - 1)))
    print(f"osj_svd {plan.layout} [{B},{R},{n}] sweeps={polish}, C={plan.cluster}: kernel {k_ms:.3f} ms (wrapper, "
          f"V's kernel, copies, prescale and sort included; peak {peak:.3f} GiB), plain {p_ms:.3f} ms at batch {pb}, "
          f"torch.linalg.svd {l_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; {taken} of "
          f"{B * polish * (n - 1) * (n // 2)} rotations taken, counted by the kernel; kernel at "
          f"{100 * bound_ms / k_ms:.1f}%)", flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=l_ms, shape=[B, R, n],
                sweeps=polish, max_abs_err=err, plain_shape=[pb, R, n], cluster=plan.cluster, clusters=plan.clusters,
                layout=plan.layout), plan


# V's kernel alone at the paths' shapes (`rotation_log_case`): (path, B, R, n,
# sweeps, iterate whose log it takes), R = n for K2's Grams; [18, 512, 256]
# (8e) and [18, 192, 192] (8d) are where `beside_plan` gives the path's calls
# to the slab layout, as at 10e's [4, 512, 512]
ROTLOG_SHAPES = (("10e", 4, 512, 512, 8, "K2"), ("10e", 4, 512, 512, 4, "K1"), ("8e", 26, 512, 256, 6, "K1"),
                 ("8e", 18, 512, 256, 6, "K1"), ("8e", 26, 256, 256, 8, "K2"), ("8d", 26, 384, 192, 6, "K1"),
                 ("8d", 18, 192, 192, 4, "K1"))
ROTLOG_SLAB = (1, 1100, 500, 300)  # a chunk of K2's L2 schedule past n = 1024: [B, n], its first round, its rounds


def iterate_log(dev, rng, B, R, n, sweeps, iterate):
    """The log of the resident iterate on the families scaled to n: K2's on
    the Grams [B, n, n] (the absolute skip, V0 = I), K1's on the prescaled
    A V0 [B, R, n] with V0 from K2 as `pjsvd` hands it over.  Returns (log,
    V0 or None, the layout V's kernel takes beside or after this launch on
    the path: `rotation_log.beside_vplan` where it `follows`, else
    `rotation_log.plan`)."""
    from tnqs_torch.ops import _build, jacobi, osj, rotation_log

    rounds = sweeps * (n - 1)
    A = torch.as_tensor(spectrum_batch(rng, B, R if iterate == "K1" else 2 * n, n, scaled_families(n)), device=dev)
    log = torch.empty((B, rounds, n // 2, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if iterate == "K2":
        G = A.mH @ A
        Hb = (0.5 * (G + G.mH)).contiguous()
        plan = jacobi.eigh_log_plan(B, n, rounds, jacobi.log_active_clusters(dev, n))
        w = torch.empty((B, n), dtype=torch.float32, device=dev)
        _build.check(_build.kernels().tnqs_jacobi_eigh_res(Hb.data_ptr(), log.data_ptr(), w.data_ptr(), None, None,
                                                            None, 1, B, n, rounds, jacobi.EPS32, 0, plan.cluster,
                                                            stream), "tnqs_jacobi_eigh_res")
        V0 = None
    else:
        V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8, relative=False)[1].contiguous()
        Ab = osj.prescale(A @ V0)[0].contiguous()
        plan, nch, cpc = osj.osj_log_plan(B, R, n, rounds, osj.log_active_clusters(dev, n))
        A1 = torch.empty_like(Ab)
        _build.check(_build.kernels().tnqs_osj_svd_res(Ab.data_ptr(), A1.data_ptr(), log.data_ptr(), None, None,
                                                        None, 1, B, R, n, nch, cpc, rounds, jacobi.EPS32,
                                                        plan.cluster, stream), "tnqs_osj_svd_res")
    b = min(plan.group, B)  # the matrices of one launch
    beside = plan.layout == "resident" and rotation_log.follows(b, plan.cluster, plan.clusters, dev)
    vp = rotation_log.beside_vplan(n, b, plan.cluster, plan.clusters, dev) if beside else rotation_log.plan(n)
    return log, V0, vp.layout


def rotation_log_shape(label, log, V0, round0=0, path_layout=None):
    """V's kernel on one log in each layout that takes n (the register
    layout up to n = 1024, and the slab layout, PR 12's kernel, unchanged
    for a launch alone), each against the plain version on the card (the
    same operations in PyTorch's complex arithmetic: within 1e-5, FMA
    contraction apart), `L2_SAME_CALLS` calls bitwise equal, and timed in
    turns (regs, slab, slab, regs) beside the bound (24 FLOP a row of a
    taken pair; the log read, V0 read and V written once).  Returns the
    shape's numbers, by layout, and V."""
    from tnqs_torch.ops import rotation_log

    B, rounds, m, _ = log.shape
    n = 2 * m
    vps = {vp.layout: vp for vp in (rotation_log.plan(n), rotation_log.slab_vplan(n))}
    runs = {layout: (lambda vp=vp: rotation_log._apply_rotation_log_cuda(log, V0, None, round0=round0, vp=vp))
            for layout, vp in vps.items()}
    V_p = rotation_log._apply_rotation_log_plain(log, V0)
    Vs = {layout: same_calls(lambda run=run: (run(),), f"rotation_log {label} {layout}")[0]
          for layout, run in runs.items()}
    errs = {layout: (V - V_p).abs().max().item() for layout, V in Vs.items()}
    taken = int(rotation_log.unpack(log)[2].sum().item())
    turns = {layout: [] for layout in runs}
    for layout in list(runs) + list(runs)[::-1]:
        turns[layout].append(cuda_ms(runs[layout], 3))
    plain_ms = cuda_ms(lambda: rotation_log._apply_rotation_log_plain(log, V0), 1, warmup=False)
    bound_ms, bound_by = bound(taken * 2 * n * 6 * 2, log.numel() * 4 + B * n * n * 8 * (1 if V0 is None else 2))
    by_layout = {layout: dict(ms=sum(t) / len(t), turns=t, share=bound_ms * len(t) / sum(t), max_abs_err=errs[layout],
                              rows=vps[layout].rows, P=vps[layout].P, R=vps[layout].R, K=vps[layout].K,
                              smem=vps[layout].smem) for layout, t in turns.items()}
    path_layout = path_layout or rotation_log.plan(n).layout
    print(f"rotation_log {label} [{B},{n},{n}], {rounds} rounds from round {round0} ({taken} of {B * rounds * m} "
          f"rotations taken), the path's layout {path_layout}; bound {bound_ms:.3f} ms ({bound_by}), plain "
          f"{plain_ms:.3f} ms; " + "; ".join(
              f"{layout} (P={v['P']}, R={v['R']}, {v['rows']} rows a CTA, {v['K']} rounds a stage, {v['smem']} shared "
              f"bytes): vs plain max |dV| {v['max_abs_err']:.3e} (bound 1e-5), {L2_SAME_CALLS} calls bitwise equal, "
              f"ms in turns {', '.join(f'{t:.3f}' for t in v['turns'])} ({100 * v['share']:.1f}% of the bound)"
              for layout, v in by_layout.items()), flush=True)
    require(max(errs.values()) <= 1e-5, f"rotation_log {label}: kernel and plain differ: {errs}")
    main = by_layout[path_layout]
    return dict(shape=[B, n, n], label=label, rounds=rounds, round0=round0, taken=taken, layout=path_layout,
                max_abs_err=max(errs.values()), ms=main["ms"], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                by_layout=by_layout), Vs[path_layout]


def rotation_log_case(dev, rng):
    """V's kernel alone at the paths' shapes (`ROTLOG_SHAPES`: the logs of
    the resident K2 and K1 on 10e's, 8e's and 8d's matrices, in both
    layouts, each against its plain version, `rotation_log_shape`), then
    the slab layout past n = 1024 on a chunk of K2's L2 schedule
    (`ROTLOG_SLAB`, from a round that is not a sweep's first).  In place
    from two launches' logs (the L2 variants' schedule in chunks) on both
    layouts, and the slab layout's stages of part of a round (the layout
    past n = 9684, here at a stage of m/3 + 5 entries): each bit for bit
    one whole launch.  No single PyTorch call applies a sequence of
    rotations: library_ms is null.  Returns the row: its numbers those of
    the layout 10e launches at its [4, 512, 512] K2 log, both layouts' there
    under `by_layout`, every shape's under `shapes`."""
    from tnqs_torch.ops import _build, jacobi, rotation_log

    shapes, checks = [], {}
    for path, B, R, n, sweeps, iterate in ROTLOG_SHAPES:
        log, V0, path_layout = iterate_log(dev, rng, B, R, n, sweeps, iterate)
        row, V_k = rotation_log_shape(f"{path} {iterate} {sweeps} sweeps", log, V0, path_layout=path_layout)
        shapes.append(row)
        if len(shapes) == 1:  # the register layout in place from two launches, the second from round h
            V_r = rotation_log.apply_rotation_log(log)
            h = log.shape[1] // 2
            V_h = rotation_log.apply_rotation_log(log[:, :h].contiguous())
            rotation_log.apply_rotation_log(log[:, h:].contiguous(), V_h, out=V_h, round0=h)
            checks["regs in place"] = torch.equal(V_h, V_r)
        del log, V0, V_k
    B, n, r0, k = ROTLOG_SLAB
    plan = jacobi.eigh_log_plan(B, n, r0 + k, jacobi.log_active_clusters(dev, n))
    A = torch.as_tensor(spectrum_batch(rng, B, 2 * n, n, scaled_families(n)), device=dev)
    hc = (A.mH @ A).mT.contiguous()
    log = torch.empty((B, k, n // 2, 4), dtype=torch.float32, device=dev)
    xbuf = torch.empty((plan.clusters, 2, n, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.kernels().tnqs_jacobi_eigh_l2(hc.data_ptr(), log.data_ptr(), xbuf.data_ptr(), None, B, n,
                                                           r0, k, jacobi.EPS32, 0, plan.cluster, plan.clusters,
                                                           torch.cuda.current_stream().cuda_stream),
                     "tnqs_jacobi_eigh_l2")
    V0 = torch.linalg.qr(torch.as_tensor(rand_c(rng, (B, n, n)), device=dev))[0].contiguous()
    row, V_k = rotation_log_shape(f"K2 L2 chunk ({plan.layout})", log, V0, r0)
    require(plan.layout == "l2" and row["layout"] == "slab", f"rotation_log past 1024: {plan.layout}, {row['layout']}")
    shapes.append(row)
    h = k // 2
    V_h = rotation_log.apply_rotation_log(log[:, :h].contiguous(), V0, round0=r0)
    rotation_log.apply_rotation_log(log[:, h:].contiguous(), V_h, out=V_h, round0=r0 + h)
    checks["slab in place"] = torch.equal(V_h, V_k)
    S, E, _ = rotation_log.slab_plan(n)
    Ep = n // 2 // 3 + 5
    V_s = torch.empty_like(V_k)
    with torch.cuda.device(dev):
        _build.check(_build.kernels().tnqs_rotation_log(V0.data_ptr(), log.data_ptr(), V_s.data_ptr(), B, n, k, S, Ep,
                                                         None, None, None, 0, 0,
                                                         torch.cuda.current_stream().cuda_stream), "tnqs_rotation_log")
    checks["slab part-round stages"] = torch.equal(V_s, V_k)
    print(f"rotation_log: two launches in place and stages of {Ep} entries (part of a round) each bitwise one "
          f"launch: {checks}", flush=True)
    require(all(checks.values()), f"rotation_log: {checks}")
    main = shapes[0]
    return dict(name="rotation_log", route="cuda", source="tnqs_torch/csrc/rotation_log.cu",
                replaces="tnqs/ops/jacobi.py:279 and tnqs/ops/osj.py:306 (their V accumulation)",
                max_abs_err=max(r["max_abs_err"] for r in shapes), ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None, shape=main["shape"],
                sweeps=ROTLOG_SHAPES[0][4], layout=main["layout"],
                by_layout={k: dict(ms=v["ms"], bound_ms=main["bound_ms"], share=v["share"])
                           for k, v in main["by_layout"].items()}, shapes=shapes)


def l2_chunk_case(dev, rng):
    """The L2 variants with their schedule split into launches of
    `L2_CHUNK_ROUNDS` rounds, as `jacobi.LOG_BUDGET` splits a matrix whose
    log does not fit it (lowered here, so that the `L2_BOUNDARY` shapes
    split): each launch starts at its round of the schedule and V takes each
    launch's log in place.  Bit for bit one launch (K2's w and V, K1's A
    and V), with the launches counted."""
    from tnqs_torch.ops import jacobi, osj

    (B, n), (Bo, Ro, no, polish) = L2_BOUNDARY
    A = torch.as_tensor(spectrum_batch(rng, B, 2 * n, n, scaled_families(n)), device=dev)
    G = A.mH @ A
    Hb = (0.5 * (G + G.mH)).contiguous()
    Ao = torch.as_tensor(spectrum_batch(rng, Bo, Ro, no, scaled_families(no)), device=dev)
    V0 = jacobi.jacobi_eigh(Ao.mH @ Ao, sweeps=8, relative=False)[1].contiguous()
    Ab = osj.prescale(Ao @ V0)[0].contiguous()
    whole = jacobi._jacobi_eigh_cuda(Hb, 8, False) + osj._osj_svd_cuda(Ab, V0, polish)
    budget, before = jacobi.LOG_BUDGET, (jacobi.jacobi_eigh.launches, osj.osj_svd.launches)
    try:
        jacobi.LOG_BUDGET = 8 * n * L2_CHUNK_ROUNDS
        plan = jacobi.eigh_log_plan(B, n, 8 * (n - 1), jacobi.log_active_clusters(dev, n))
        split = jacobi._jacobi_eigh_cuda(Hb, 8, False)
        jacobi.LOG_BUDGET = 8 * no * L2_CHUNK_ROUNDS
        oplan = osj.osj_log_plan(Bo, Ro, no, polish * (no - 1), osj.log_active_clusters(dev, no))[0]
        split += osj._osj_svd_cuda(Ab, V0, polish)
    finally:
        jacobi.LOG_BUDGET = budget
    launches = (jacobi.jacobi_eigh.launches - before[0], osj.osj_svd.launches - before[1])
    want = (B * -(-8 * (n - 1) // L2_CHUNK_ROUNDS), Bo * -(-polish * (no - 1) // L2_CHUNK_ROUNDS))
    same = [torch.equal(a, b) for a, b in zip(whole, split)]
    print(f"L2 variants in launches of {L2_CHUNK_ROUNDS} rounds: K2 [{B},{n},{n}] ({plan.layout}, chunk {plan.chunk}) "
          f"and K1 [{Bo},{Ro},{no}] ({oplan.layout}, chunk {oplan.chunk}) in {launches} launches (planned {want}); "
          f"w, V, A, V bitwise one launch's: {same}", flush=True)
    require(plan.layout == oplan.layout == "l2" and plan.chunk == oplan.chunk == L2_CHUNK_ROUNDS,
            f"the split plans {plan}, {oplan}")
    require(launches == want and all(same), "the L2 variants in chunks of rounds differ from one launch")


def l2_kernel_phase(dev):
    """K1 and K2 past the cluster kernels (the resident and L2 variants, V
    from the rotation log) on the card: K2 at `L2_EIGH` (both skips) and
    K1 at `L2_PATH` (`l2_eigh_case`, `l2_osj_case`), each variant's plan,
    the layout it launched; the L2 variants at `L2_BOUNDARY`, whole and in
    chunks of rounds (`l2_chunk_case`); the V kernel alone
    (`rotation_log_case`).  Returns the rows of the `kernels` line,
    one per kernel and width."""
    rng = np.random.default_rng(12)
    rows = {}
    for B, n in L2_EIGH:
        timed, err, plan = l2_eigh_case(dev, rng, B, n, ((False, 8), (True, 12)), True)
        ms, plain_ms, bound_ms, bound_by, library_ms, _ = timed["absolute"]
        key = f"jacobi_eigh_l2 n={n}"
        rows[key] = dict(
            name=key, route="cuda", source="tnqs_torch/csrc/jacobi_eigh.cu", replaces="tnqs/ops/jacobi.py:279",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            shape=[B, n, n], sweeps=8, plain_shape=[L2_PLAIN_BATCH, n, n], cluster=plan.cluster,
            clusters=plan.clusters, layout=plan.layout,
            relative_12=dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), timed["relative"][:5])))
    (B, n), (Bo, Ro, no, polish) = L2_BOUNDARY
    timed, err, plan = l2_eigh_case(dev, rng, B, n, ((False, 8),), False)
    require(plan.layout == "l2", f"jacobi_eigh [{B},{n},{n}]: {plan.layout}, not past the resident layout")
    rows["jacobi_eigh_l2 n=512"]["past_resident"] = dict(
        zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"), timed["absolute"][:5]), shape=[B, n, n],
        layout=plan.layout, max_abs_err=err)
    for B, R, n, polish in L2_PATH:
        row, _ = l2_osj_case(dev, rng, B, R, n, polish, True)
        key = f"osj_svd_l2 n={n}"
        if key not in rows:
            rows[key] = dict(name=key, route="cuda", source="tnqs_torch/csrc/osj_svd.cu",
                             replaces="tnqs/ops/osj.py:306", **row)
        else:
            rows[key]["tall"] = row
            rows[key]["max_abs_err"] = max(row["max_abs_err"], rows[key]["max_abs_err"])
    row, plan = l2_osj_case(dev, rng, Bo, Ro, no, polish, False)
    require(plan.layout == "l2", f"osj_svd [{Bo},{Ro},{no}]: {plan.layout}, not past the resident layout")
    rows["osj_svd_l2 n=512"]["past_resident"] = row
    l2_chunk_case(dev, rng)
    rows["rotation_log"] = rotation_log_case(dev, rng)
    print(f"the earlier design's times, ms (V in the rounds; recorded in PERF.md, not measured in this run): "
          f"{EARLIER_MS}")
    return list(rows.values())


def zero_padded_member(dev, B, R, n, polish):
    """F2 (ROADMAP Queue 3), recorded, not gated: `pjsvd` on the 128-value
    families padded with zeros, on which the reference's schedule itself
    leaves up to ~1e-4 of s_max on a "wide" member.  The batch's worst
    member (`F2_MEMBER`, `tests/test_torch_svd_route.py` holds the plain version to
    JAX's interpret-mode `pjsvd` on it) is then run alone, kernel and plain,
    with its s error after the preconditioner (sweep 0) and after each polish
    sweep: K2 then K1 on the card, both plain, and K1 on the plain K2's
    basis, which parts K1 from K2."""
    from tnqs_torch.ops import jacobi, osj

    Ap = torch.as_tensor(spectrum_batch(np.random.default_rng(11), B, R, n), device=dev)
    sp0 = torch.linalg.svdvals(Ap.to(torch.complex128))
    Hp = Ap.mH @ Ap
    Hp = (0.5 * (Hp + Hp.mH)).contiguous()
    _, Vp = jacobi.eigh_from_rounds(Hp, *jacobi._jacobi_eigh_plain(Hp, 8, False))
    Ab_p, scale_p = osj.prescale(Ap @ Vp)
    plain_s = osj.svd_from_rounds(*osj._osj_svd_plain(Ab_p, Vp, polish), scale_p)[1]
    errs = {}
    for name, sp in (("kernel", osj.pjsvd(Ap, polish_sweeps=polish)[1]), ("plain", plain_s)):
        errs[name] = ((sp.double() - sp0).abs().amax(1) / sp0[:, 0]).cpu().numpy()
        print(f"pjsvd {name} [{B},{R},{n}] on the zero-padded 128-value families (recorded): s error "
              f"{errs[name].max():.3e} (member {int(errs[name].argmax())}), median {np.median(errs[name]):.3e}")
    b = F2_MEMBER
    print(f"F2: member {b} (the kernel's worst: member {int(errs['kernel'].argmax())}): kernel "
          f"{errs['kernel'][b]:.3e}, plain {errs['plain'][b]:.3e} of s_max in the batch of {B}")
    A1, s1 = Ap[b:b + 1].contiguous(), sp0[b:b + 1]
    H1 = Hp[b:b + 1].contiguous()
    V_k = jacobi.jacobi_eigh(A1.mH @ A1, sweeps=8, relative=False)[1]
    V_p = jacobi.eigh_from_rounds(H1, *jacobi._jacobi_eigh_plain(H1, 8, False))[1]

    def by_sweep(V0, rounds):
        X, scale = osj.prescale(A1 @ V0)
        X, V = X.contiguous(), V0.contiguous()
        out = []
        for sweep in range(polish + 1):
            if sweep:
                X, V = rounds(X, V, 1)
            s = osj.svd_from_rounds(X, V, scale)[1]
            out.append(((s.double() - s1).abs().amax(1) / s1[:, 0]).item())
        return out

    rows = {"K2+K1 kernel": by_sweep(V_k, osj._osj_svd_cuda), "K2+K1 plain": by_sweep(V_p, osj._osj_svd_plain),
            "plain K2, kernel K1": by_sweep(V_p, osj._osj_svd_cuda)}
    # the plain K2 on the Gram moved by a Hermitian perturbation of 1e-7 of
    # its largest entry (float32 rounding's size), then the kernel K1: how far
    # rounding alone moves the outcome of the same schedule
    for seed in (1, 2):
        E = torch.as_tensor(rand_c(np.random.default_rng(seed), (1, n, n)), device=dev)
        H_e = (H1 + 1e-7 * H1.abs().max() * 0.5 * (E + E.mH)).contiguous()
        V_e = jacobi.eigh_from_rounds(H_e, *jacobi._jacobi_eigh_plain(H_e, 8, False))[1]
        rows[f"plain K2 on the Gram + 1e-7 noise (seed {seed}), kernel K1"] = by_sweep(V_e, osj._osj_svd_cuda)
    for name, e in rows.items():
        print(f"F2 member {b} alone, s error / s_max after sweeps 0..{polish} ({name}): "
              + " ".join(f"{x:.3e}" for x in e))
    k, p = rows["K2+K1 kernel"][-1], rows["K2+K1 plain"][-1]
    print(f"F2: kernel {k:.3e} against plain {p:.3e} alone ({k / p:.2f}x; 2x is the line the ROADMAP draws)")
    return rows


def normalized(m):
    """Sum-normalized messages, as the engine stores them."""
    return m / m.sum(dim=(1, 2), keepdim=True)


def einsum_expr(k, t):
    """One torch.einsum of a group's gathered site tensors, its k-1 messages
    and the conjugate: "Bsibc,Bbp,Bcq,Bsjpq->Bij" at k=3, t=0."""
    ket = ["s"] + [chr(ord("a") + j) for j in range(k)]
    bra = list(ket)
    ket[1 + t], bra[1 + t] = "i", "j"
    msgs = []
    for col, j in enumerate(j for j in range(k) if j != t):
        bra[1 + j] = chr(ord("p") + col)
        msgs.append(f"B{ket[1 + j]}{bra[1 + j]}")
    return f"B{''.join(ket)},{','.join(msgs)},B{''.join(bra)}->Bij"


def bp_flops(B, k, chi):
    """A group's FP32 operations: per message and site value, k contractions
    of depth chi over chi^k entries (k-1 absorbs and the bra product), each
    a complex MAC of 4 FMAs (8 FLOP)."""
    return B * 2 * k * chi ** (k + 1) * 8


def bp_bytes(B, k, chi):
    """A group's bytes: each site tensor and message read once, each
    outgoing message written once."""
    return (B * 2 * chi**k + B * k * chi * chi) * 8


def bp_kernel_phase(dev, chi=64):
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import bp_sweep

    rng = np.random.default_rng(2)
    eng = LatticeEngine(tnqs_torch.eagle_lattice(), chi=chi, device=dev)  # color plan, kernel route
    T = {k: torch.as_tensor(rand_c(rng, tuple(v.shape)), device=dev) for k, v in eng.T.items()}
    # positive hermitian messages of unit trace, as BP keeps them
    G = torch.as_tensor(rand_c(rng, tuple(eng.M.shape)), device=dev)
    M = G @ G.mH
    M = M / torch.diagonal(M, dim1=1, dim2=2).sum(-1)[:, None, None]
    print(f"BP kernel inputs: T[3] {tuple(T[3].shape)}, T[2] {tuple(T[2].shape)}, M {tuple(M.shape)}")

    # Tolerance: the kernel and the einsum chain sum up to d * chi^(k-1) =
    # 8192 float32 products per entry (after two 64-term absorbs) in other
    # orders; rounding of ~sqrt(8192) ulps of the largest entry is ~1e-5, so
    # 1e-4 of the largest normalized entry leaves a factor 10
    tol = 1e-4
    # each group as the engine's sweep calls it (the messages gathered in
    # the timed call): the kernel against its plain version, twice bitwise,
    # then timed beside the einsum chain `group_messages` (the einsum route),
    # one multi-operand torch.einsum (the yardstick) and the bound
    print(f"BP groups of the Eagle chi={chi} color plan (CUDA events, 10 calls each; bound: FP32 operations at "
          f"{PEAK_FP32 / 1e12:.0f} TFLOP/s or bytes at {PEAK_BYTES / 1e12:.2f} TB/s):")
    errs, table = [], {}
    for (stage, k, t, src, _, ins, rows, in_all) in eng._bp_groups:
        if k < 2:
            continue
        B, Min = rows.shape[0], M[in_all]
        m1 = bp_sweep.bp_sweep_group(T[k], Min, rows, t)
        m2 = bp_sweep.bp_sweep_group(T[k], Min, rows, t)
        m_p = normalized(bp_sweep._bp_sweep_group_plain(T[k], Min, rows, t))
        require(torch.isfinite(m1).all(), f"bp_sweep_group k={k} t={t}: non-finite output")
        require(torch.equal(m1, m2), f"bp_sweep_group stage {stage} k={k} t={t}: two calls differ")
        err = (normalized(m1) - m_p).abs().max().item()
        rel = err / m_p.abs().max().item()
        errs.append(err)
        require(rel < tol, f"bp_sweep_group k={k} t={t}: kernel and plain differ by more than {tol}")
        k_ms = cuda_ms(lambda: bp_sweep.bp_sweep_group(T[k], M[in_all], rows, t), 10)
        g_ms = cuda_ms(lambda: bp_sweep.group_messages(T[k][src], [M[e] for e in ins], t), 10)
        A, expr = T[k][rows], einsum_expr(k, t)
        l_ms = cuda_ms(lambda: torch.einsum(expr, A, *Min.unbind(1), A.conj()), 10)
        b_ms, b_by = bound(bp_flops(B, k, chi), bp_bytes(B, k, chi))
        table[(stage, k, t)] = (B, k_ms, g_ms, l_ms, b_ms, b_by, rows, Min)
        print(f"  stage {stage} k={k} t={t} B={B}: vs plain max |dm| {err:.3e} ({rel:.3e} of the largest), two calls "
              f"bitwise equal; kernel {k_ms:.4f} ms, group_messages {g_ms:.4f} ms, torch.einsum {l_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; kernel at {100 * b_ms / k_ms:.1f}%)")
    print(f"  sum over the groups: kernel {sum(v[1] for v in table.values()):.4f} ms, group_messages "
          f"{sum(v[2] for v in table.values()):.4f} ms, torch.einsum {sum(v[3] for v in table.values()):.4f} ms, "
          f"bound {sum(v[4] for v in table.values()):.4f} ms")

    # the kernel's other shape classes, on rows gathered out of order (the
    # wavefront schedule's groups): degree 3 at chi=64, degree 4-6 at chi=8
    # (ket absorbs before pass 2), a 512-wide bond (pass 2 over 64-blocks);
    # and the empty group
    for kk, w, n_k, B in ((3, 64, 5, 3), (4, 8, 4, 3), (5, 8, 3, 2), (6, 8, 2, 2), (2, 512, 4, 3)):
        Tk = torch.as_tensor(rand_c(rng, (n_k, 2) + (w,) * kk), device=dev)
        Min = torch.as_tensor(rand_c(rng, (B, kk - 1, w, w)), device=dev)
        rows = torch.as_tensor(rng.permutation(n_k)[:B], device=dev)
        rel = 0.0
        for t in range(kk):
            m_k = bp_sweep.bp_sweep_group(Tk, Min, rows, t)
            m_p = bp_sweep._bp_sweep_group_plain(Tk, Min, rows, t)
            rel = max(rel, ((m_k - m_p).abs().max() / m_p.abs().max()).item())
        print(f"bp_sweep_group k={kk} chi={w} rows {rows.tolist()}, every slot: max relative difference {rel:.3e}")
        require(rel < tol, f"bp_sweep_group k={kk} chi={w}: kernel and plain differ by {rel:.3e}")
    no_rows = torch.zeros(0, dtype=torch.int64, device=dev)
    require(bp_sweep.bp_sweep_group(T[3], M[:0].reshape(0, 2, chi, chi), no_rows, 0).shape == (0, chi, chi),
            "bp_sweep_group: empty group")

    # the host side of one launch alone: a 1-message chi=8 group, whose
    # kernel is shorter than its launch, issued 200 times with no sync
    Tt = torch.as_tensor(rand_c(rng, (2, 2, 8, 8)), device=dev)
    Mt = torch.as_tensor(rand_c(rng, (1, 1, 8, 8)), device=dev)
    rt = torch.ones(1, dtype=torch.int64, device=dev)
    bp_sweep.bp_sweep_group(Tt, Mt, rt, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bp_sweep.bp_sweep_group(Tt, Mt, rt, 0)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    print(f"bp_sweep_group host path: {host_us:.2f} us a launch (wrapper and ctypes, 200 calls, no sync)")

    # the kernel table's row: the largest group
    stage, k, t = max(table, key=lambda key: table[key][0] * chi ** key[1])
    B, ms, _, library_ms, bound_ms, bound_by, rows, Min = table[(stage, k, t)]
    # where the largest group's time goes: each of its kernels' device time
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            bp_sweep.bp_sweep_group(T[k], Min, rows, t)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        if us > 0 and "bp_" in ev.key:
            print(f"  k={k} t={t} B={B}, {ev.key[:60]}: {us / 1e3 / 10:.4f} ms a call, {ev.count // 10} a call "
                  f"(torch.profiler, 10 calls)")
    plain_ms = cuda_ms(lambda: bp_sweep._bp_sweep_group_plain(T[k], Min, rows, t), 2)
    A, expr = T[k][rows], einsum_expr(k, t)
    m_lib = normalized(torch.einsum(expr, A, *Min.unbind(1), A.conj()))
    lib_rel = ((m_lib - normalized(bp_sweep._bp_sweep_group_plain(T[k], Min, rows, t))).abs().max()
               / m_lib.abs().max()).item()
    require(lib_rel < tol, f"the library einsum {expr} differs from the plain version by {lib_rel:.3e}")
    print(f"bp_sweep_group k={k} t={t} B={B}: kernel {ms:.4f} ms "
          f"({bp_flops(B, k, chi) / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms, torch.einsum {expr} "
          f"{library_ms:.4f} ms (vs plain {lib_rel:.1e}), bound {bound_ms:.4f} ms ({bound_by})")
    sweep = {}
    for use_kernel in (False, True, True, False):
        sweep.setdefault(use_kernel, []).append(cuda_ms(lambda: eng._bp_new_messages(T, M, use_kernel), 5))
    print(f"one BP sweep of the Eagle chi={chi} color plan: kernel route {sweep[True]} ms, "
          f"einsum route {sweep[False]} ms")
    return dict(name="bp_sweep_group", route="cuda", source="tnqs_torch/csrc/bp_sweep.cu",
                replaces="tnqs/ops/bp_sweep.py:282", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# the dense bf16 tensor-core peak (H100 SXM at 700 W, NVIDIA's data sheet)
PEAK_BF16 = 989e12


def bp_3x_flops(B, k, chi):
    """A group's bf16_3x operations: per complex MAC four real products of
    three bf16 passes each, 24 FLOP, three times the FP32 mode's 8."""
    return 3 * bp_flops(B, k, chi)


def tc_build_lines():
    """ptxas's lines (registers, spills, wgmma serialization) for the
    tensor-core bf16_3x kernels and the split pass, from the build log;
    whether any of them spills; and whether ptxas serialized a kernel's
    `wgmma` (C7512, a line that names its function before the function's
    own lines)."""
    from tnqs_torch.ops import _build

    names = ("bp_bra_tc", "bp_pass2_tc", "bp_split_planes")
    lines, keep, spills, serialized = [], False, False, False
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = any(name in line for name in names)
        if "C7512" in line and any(name in line for name in names):
            lines.append(line.strip())
            serialized = True
        elif keep and any(w in line for w in ("entry function", "registers", "spill", "wgmma")):
            lines.append(line.strip())
            if "spill" in line:
                spills |= any(f"{n} bytes spill" in line and n != "0" for n in line.replace(",", " ").split())
    return lines, spills, serialized


def split_check(dev, T3):
    """The split pass (`split_bucket` on the card, `bp_split_planes`) bit for
    bit against `_split_planes_plain` on values that round at a tie both ways,
    subnormals (bf16 keeps float32's exponent range), signed zeros and large
    values, and on the Eagle bucket T[3]; then timed on T[3] beside its
    plain version and its bound (bytes: 8 read and 8 written a value)."""
    from tnqs_torch.ops import bp_sweep

    rng = np.random.default_rng(5)
    special = np.array([1.0, 1 + 2.0**-8, 1 + 3 * 2.0**-9, -(1 + 2.0**-8), 1 + 2.0**-8 + 2.0**-20, 2.0**-126,
                        1.5 * 2.0**-130, 1e-40, -3e-41, 2.0**-149, 3 * 2.0**-149, 0.0, -0.0, 3.0e38, -1.7e38,
                        3.1415927, 1 + 2.0**-16 + 2.0**-24], dtype=np.float32)
    x = np.empty((3, 2, 8, 8), dtype=np.complex64)
    x.real = rng.choice(special, size=x.shape)
    x.imag = rng.choice(special, size=x.shape)
    # the special values against the CPU's plain split (whose float32
    # subtraction keeps subnormals, as the kernel's does), T[3] against the
    # card's
    err = 0.0
    for name, Tk, ref in (("special values", torch.as_tensor(x, device=dev), torch.as_tensor(x)),
                          ("Eagle T[3]", T3, T3)):
        planes = bp_sweep.split_bucket(Tk).planes.cpu()
        plain = bp_sweep._split_planes_plain(ref).cpu()
        err = max(err, (planes.double() - plain.double()).abs().max().item())
        require(torch.equal(planes.view(torch.int16), plain.view(torch.int16)),
                f"split pass on {name}: planes differ from _split's")
        print(f"split pass on {name} {tuple(Tk.shape)}: bit for bit _split's hi and lo planes")
    ms = cuda_ms(lambda: bp_sweep.split_bucket(T3), 10)
    plain_ms = cuda_ms(lambda: bp_sweep._split_planes_plain(T3), 3)
    bound_ms = 1e3 * 2 * T3.numel() * 8 / PEAK_BYTES
    print(f"split pass T[3] {tuple(T3.shape)}: {ms:.4f} ms (plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms "
          f"(bytes; {100 * bound_ms / ms:.1f}%)")
    return dict(name="bp_split_planes", route="cuda", source="tnqs_torch/csrc/bp_sweep.cu",
                replaces="tnqs/ops/bp_sweep.py:154-157 (dot2's bf16 split of each operand)", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def bp_kernel_3x_phase(dev, chi=64):
    """K3's bf16_3x mode: the split pass bit for bit; the kernel against its
    plain version (the same splits, float32 products of them) on every Eagle
    chi=64 group and on the other shape classes (gathered rows, degree 4-6,
    a 512-wide and a 72-wide bond, depth padding at chi=24, the thermal
    path's d = 4, k = 3, chi=32), both designs (`tc_route`), two calls
    bitwise equal and equal to a call given T alone; every Eagle group timed
    beside the FP32 mode, the largest in turns with the FP32 mode and the
    library einsum, by pass, beside its plain version, its bound at the
    bf16 rate and the design's byte floor."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import bp_sweep

    lines, spills, serialized = tc_build_lines()
    print("tensor-core bf16_3x kernels, ptxas:\n  " + "\n  ".join(lines))
    require(lines and not spills, "the tensor-core bf16_3x kernels spill registers (or the build log lacks them)")
    require(not serialized, "ptxas serialized the tensor-core bf16_3x kernels' wgmma (C7512)")
    rng = np.random.default_rng(2)  # the FP32 phase's inputs
    eng = LatticeEngine(tnqs_torch.eagle_lattice(), chi=chi, device=dev)
    T = {k: torch.as_tensor(rand_c(rng, tuple(v.shape)), device=dev) for k, v in eng.T.items()}
    G = torch.as_tensor(rand_c(rng, tuple(eng.M.shape)), device=dev)
    M = G @ G.mH
    M = M / torch.diagonal(M, dim1=1, dim2=2).sum(-1)[:, None, None]
    split_row = split_check(dev, T[3])
    splits = {k: bp_sweep.split_bucket(v) for k, v in T.items() if bp_sweep.tc_route(k, chi)}
    # Tolerance: the kernel and its plain version split at the same points
    # and multiply the same bf16 values exactly; they differ in the order of
    # the float32 sums (the FP32 mode's 1e-4 bar) and where a float32 V or
    # W rounds to another bf16 hi, whose lo then differs by one bf16 ulp of
    # hi (2^-16 relative): within 1e-4 of the largest entry
    tol = 1e-4
    print(f"K3 bf16_3x on the Eagle chi={chi} color plan (CUDA events, 10 calls each; bound: 24 FLOP a complex MAC "
          f"at {PEAK_BF16 / 1e12:.0f} TFLOP/s or bytes at {PEAK_BYTES / 1e12:.2f} TB/s):")
    errs, table = [], {}
    for (stage, k, t, src, _, ins, rows, in_all) in eng._bp_groups:
        if k < 2:
            continue
        B, Min, sp = rows.shape[0], M[in_all], splits.get(k)
        m1 = bp_sweep.bp_sweep_group(T[k], Min, rows, t, mode="bf16_3x", split=sp)
        m2 = bp_sweep.bp_sweep_group(T[k], Min, rows, t, mode="bf16_3x", split=sp)
        m0 = bp_sweep.bp_sweep_group(T[k], Min, rows, t, mode="bf16_3x")  # T alone: the wrapper splits it
        m_p = normalized(bp_sweep._bp_sweep_group_plain(T[k], Min, rows, t, mode="bf16_3x"))
        m_hi = normalized(bp_sweep.bp_sweep_group(T[k], Min, rows, t))
        require(torch.isfinite(m1).all(), f"bf16_3x k={k} t={t}: non-finite output")
        require(torch.equal(m1, m2) and torch.equal(m1, m0), f"bf16_3x stage {stage} k={k} t={t}: two calls differ")
        err = (normalized(m1) - m_p).abs().max().item()
        rel = err / m_p.abs().max().item()
        rel_hi = ((normalized(m1) - m_hi).abs().max() / m_hi.abs().max()).item()
        errs.append(err)
        require(rel < tol, f"bf16_3x k={k} t={t}: kernel and plain differ by {rel:.3e}")
        k_ms = cuda_ms(lambda: bp_sweep.bp_sweep_group(T[k], M[in_all], rows, t, mode="bf16_3x", split=sp), 10)
        f_ms = cuda_ms(lambda: bp_sweep.bp_sweep_group(T[k], M[in_all], rows, t), 10)
        b_ms, b_by = max((1e3 * bp_3x_flops(B, k, chi) / PEAK_BF16, "operations"),
                         (1e3 * bp_bytes(B, k, chi) / PEAK_BYTES, "bytes"))
        table[(stage, k, t)] = (B, k_ms, f_ms, b_ms, b_by, rows, Min)
        print(f"  stage {stage} k={k} t={t} B={B}: vs plain {err:.3e} ({rel:.3e} of the largest), vs the FP32 mode "
              f"{rel_hi:.3e}; two calls bitwise equal; bf16_3x {k_ms:.4f} ms, FP32 mode {f_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; kernel at {100 * b_ms / k_ms:.1f}%)")
    require(all(v[1] < v[2] for key, v in table.items() if key[1] >= 3),
            "bf16_3x is not faster than the FP32 mode at every k >= 3 group")
    before = dict(bp_sweep.bp_sweep_group.launches_by_route)
    for kk, w, n_k, B, d in ((3, 64, 5, 3, 2), (4, 8, 4, 3, 2), (5, 8, 3, 2, 2), (6, 8, 2, 2, 2), (2, 512, 4, 3, 2),
                             (2, 72, 4, 3, 2), (3, 24, 4, 3, 2), (3, 32, 5, 3, 4), (3, 32, 16, 7, 4), (2, 32, 6, 4, 4),
                             (2, 40, 4, 3, 2), (3, 8, 4, 3, 2)):
        Tk = torch.as_tensor(rand_c(rng, (n_k, d) + (w,) * kk), device=dev)
        Min = torch.as_tensor(rand_c(rng, (B, kk - 1, w, w)), device=dev)
        rows = torch.as_tensor(rng.permutation(n_k)[:B], device=dev)
        rel = 0.0
        for t in range(kk):
            m_k = bp_sweep.bp_sweep_group(Tk, Min, rows, t, mode="bf16_3x")
            m_p = bp_sweep._bp_sweep_group_plain(Tk, Min, rows, t, mode="bf16_3x")
            require(torch.equal(m_k, bp_sweep.bp_sweep_group(Tk, Min, rows, t, mode="bf16_3x")),
                    f"bf16_3x k={kk} chi={w} d={d} t={t}: two calls differ")
            rel = max(rel, ((m_k - m_p).abs().max() / m_p.abs().max()).item())
        route = "wgmma" if bp_sweep.tc_route(kk, w) else "mma.sync"
        print(f"bf16_3x k={kk} chi={w} d={d} rows {rows.tolist()} ({route}), every slot: max relative difference "
              f"{rel:.3e}, two calls bitwise equal")
        require(rel < tol, f"bf16_3x k={kk} chi={w} d={d}: kernel and plain differ by {rel:.3e}")
    after = bp_sweep.bp_sweep_group.launches_by_route
    require(after["wgmma"] > before["wgmma"] and after["mma.sync"] > before["mma.sync"],
            f"bf16_3x: both designs must run ({before} -> {after})")

    # the host side of one tensor-core launch alone (a 1-message chi=8
    # group on its split planes, 200 calls, no sync), as phase 4 reads the
    # FP32 mode's
    Tt = torch.as_tensor(rand_c(rng, (2, 2, 8, 8)), device=dev)
    Mt, rt = torch.as_tensor(rand_c(rng, (1, 1, 8, 8)), device=dev), torch.ones(1, dtype=torch.int64, device=dev)
    st_ = bp_sweep.split_bucket(Tt)
    bp_sweep.bp_sweep_group(Tt, Mt, rt, 0, mode="bf16_3x", split=st_)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bp_sweep.bp_sweep_group(Tt, Mt, rt, 0, mode="bf16_3x", split=st_)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    print(f"bf16_3x tensor-core host path: {host_us:.2f} us a launch (wrapper and ctypes, 200 calls, no sync)")

    stage, k, t = max(table, key=lambda key: table[key][0] * chi ** key[1])
    B, ms, fp32_ms, bound_ms, bound_by, rows, Min = table[(stage, k, t)]
    sp = splits[k]
    A, expr = T[k][rows], einsum_expr(k, t)
    fns = (lambda: bp_sweep.bp_sweep_group(T[k], Min, rows, t, mode="bf16_3x", split=sp),
           lambda: bp_sweep.bp_sweep_group(T[k], Min, rows, t),
           lambda: torch.einsum(expr, A, *Min.unbind(1), A.conj()))
    k_t, f_t, l_t = alternating_ms(fns, 10)
    library_ms = cuda_ms(fns[2], 10)  # as the kernel's `ms`: calls queued back to back
    plain_ms = cuda_ms(lambda: bp_sweep._bp_sweep_group_plain(T[k], Min, rows, t, mode="bf16_3x"), 2)
    # the design's byte floor: pass 1 reads K and writes V, pass 2 reads K
    # and V (each B d chi^k bf16 planes, 8 bytes a value), the partials out
    # and back; with V read back from L2, one trip of V less
    plan = bp_sweep.bp_plan(k, chi, B, t, 2, *bp_sweep._slots_tc(dev.index), tc=True)
    vk, part = B * 2 * chi**k * 8, 2 * 8 * plan.part_elems
    floor_ms, floor_l2_ms = 1e3 * (4 * vk + part) / PEAK_BYTES, 1e3 * (3 * vk + part) / PEAK_BYTES
    print(f"bf16_3x k={k} t={t} B={B}, in turns (10 calls each, each timed alone, host included; median): kernel "
          f"{median(k_t):.4f} ms, FP32 mode {median(f_t):.4f} ms, torch.einsum {median(l_t):.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; kernel at "
          f"{100 * bound_ms / median(k_t):.1f}%); the design's byte floor {floor_ms:.4f} ms ({floor_l2_ms:.4f} with V "
          f"read back from L2); {plan.chunks} chunks")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fns[0]()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        if us > 0 and "bp_" in ev.key:
            print(f"  bf16_3x k={k} t={t} B={B}, {ev.key[:60]}: {us / 1e3 / 10:.4f} ms a call, {ev.count // 10} a "
                  f"call (torch.profiler, 10 calls)")
    print(f"bf16_3x k={k} t={t} B={B}: kernel {ms:.4f} ms ({bp_3x_flops(B, k, chi) / ms / 1e9:.2f} TFLOP/s of bf16 "
          f"products), FP32 mode {fp32_ms:.4f} ms, plain {plain_ms:.3f} ms, torch.einsum {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    row = dict(name="bp_sweep_group_bf16_3x", route="cuda", source="tnqs_torch/csrc/bp_sweep.cu",
               replaces="tnqs/ops/bp_sweep.py:282 (mode bf16_3x, :154-166)", max_abs_err=max(errs), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, fp32_ms=fp32_ms)
    return [row, split_row]


def main_path(dev, layers, checkpoint=None):
    """Phase 5; with `checkpoint` = (path, layer) the engine is saved there
    after that layer (outside the timed steps) for 10a."""
    import tnqs_torch
    from tnqs_torch import checkpoint as ckpt
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import bp_sweep, jacobi, osj

    controls = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["chi64"]
    cfg = controls["config"]
    require(layers <= cfg["layers"], f"the golden trajectory has {cfg['layers']} layers")
    center, bench_v = tuple(cfg["center"]), tuple(cfg["bench_vertex"])
    # the floor recomputed from the seed data, not the committed scalar
    floors = np.max(
        [controls["f32_floor_per_layer"]]
        + [sd["dev_from_f64_per_layer"] for sd in controls["multiseed_controls"]["seeds"].values()],
        axis=0,
    )[:layers]
    bound = np.maximum(3.0 * np.maximum.accumulate(floors), 2e-5)

    g = tnqs_torch.eagle_lattice()
    circuit = tnqs_torch.heavy_hex_kicked_ising_layer(g, cfg["J"], cfg["theta_h"])
    eng = LatticeEngine(g, chi=int(cfg["maxdim"]), dtype=torch.complex64, device=dev)
    step = eng.make_step(circuit, cutoff=float(cfg["cutoff"]), bp_maxiter=25)
    plain_calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls, bp_sweep._bp_sweep_group_plain.calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    devs, times, discarded, zs = [], [], [], []
    for li in range(layers):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.T, eng.M, errors = step(eng.T, eng.M)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(torch.isfinite(errors).all(), f"layer {li + 1}: non-finite truncation errors")
        discarded.append(float(errors.max()))
        z = eng.expect_1site("Z")
        zc, zb = z[center].real, z[bench_v].real
        zs.append((zc, zb))
        if checkpoint is not None and li + 1 == checkpoint[1]:
            ckpt.save_engine(eng, checkpoint[0])
        dev_l = max(abs(zc - controls["z_center_f64"][li]), abs(zb - controls["z_bench_f64"][li]))
        devs.append(dev_l)
        print(f"layer {li + 1}: {times[-1]:.3f} s  Z{center}={zc:+.7f}  Z{bench_v}={zb:+.7f}  "
              f"|dev| {dev_l:.3e} (bound {bound[li]:.3e}, floor {floors[li]:.3e})", flush=True)
        require(np.isfinite(dev_l), f"layer {li + 1}: non-finite <Z>")
        require(dev_l <= bound[li], f"layer {li + 1}: deviation {dev_l:.3e} above bound {bound[li]:.3e}")
    launches = k3_launches()
    require(launches["bp_sweep_group_bf16_3x"] == 0 and launches["bp_split_planes"] == 0,
            "the main path launched K3's bf16_3x mode")
    by_shape = (dict(jacobi.jacobi_eigh.launches_by_shape), dict(osj.osj_svd.launches_by_shape))
    require(all(torch.isfinite(t).all() for t in eng.T.values()), "non-finite state")
    require(torch.isfinite(eng.M).all(), "non-finite messages")
    require(all(launches[k] > 0 for k in ("jacobi_eigh", "osj_svd", "bp_sweep_group")),
            f"a kernel was not launched by the main path: {launches}")
    require(plain_calls == (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls,
                            bp_sweep._bp_sweep_group_plain.calls), "the main path ran a plain version on the card")
    print(f"kernel launches in the main path: {launches}; K2 by [B, n]: {by_shape[0]}; K1 by [B, R, n]: {by_shape[1]}")
    print(f"K3 launches a layer (the step's BP refreshes and final BP run): "
          f"{launches['bp_sweep_group'] / layers:.1f}")
    print(f"certification clause max|dev| <= max(floor): {max(devs):.3e} <= {floors.max():.3e}: "
          f"{max(devs) <= floors.max()}")
    print(f"first layer {times[0]:.3f} s")
    rate = (layers - 1) / sum(times[1:]) if layers > 1 else float("nan")
    print(f"layers/s over layers 2-{layers}: {rate:.4f}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    final = ({k: v.cpu().numpy() for k, v in eng.T.items()}, eng.M.cpu().numpy())
    return launches, eng, step, (center, bench_v, controls, bound[-1], layers), rate, discarded, (np.array(zs), final,
                                                                                                 bound, devs)


def device_times(prof):
    """{kernel name: (device ms, launches)} of a torch.profiler window."""
    kernels = {}
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            kernels[ev.key] = (us / 1e3, ev.count)
    return kernels


def profile_window(eng, step, layers=2):
    """torch.profiler over `layers` steady layers from a copy of the evolved
    state (the BP path starts from the main path's last layer): device time
    and launches of K1, K2 and the other kernels, and the device's idle
    share of the window's wall time.  The profiler's own overhead is in that
    wall time, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    T, M = {k: v.clone() for k, v in eng.T.items()}, eng.M.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(layers):
            T, M, _ = step(T, M)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_times(prof)
    busy = sum(ms for ms, _ in kernels.values())
    if busy == 0:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        T, M = {k: v.clone() for k, v in eng.T.items()}, eng.M.clone()
        start.record()
        for _ in range(layers):
            T, M, _ = step(T, M)
        end.record()
        torch.cuda.synchronize()
        print(f"profile window: torch.profiler saw no device time; CUDA events over {layers} layers: "
              f"{start.elapsed_time(end):.3f} ms")
        return
    union = busy_ms(prof)  # V's kernel may run beside K2 on a second stream
    print(f"profile window, {layers} steady layers (torch.profiler): wall {wall_ms:.3f} ms, kernels {busy:.3f} ms "
          f"summed over streams, device busy {union:.3f} ms (their union), idle share {1 - union / wall_ms:.4f}")
    labels = (("K1 osj_svd", ("osj_svd_kernel",)), ("K1 resident (n > 128)", ("osj_svd_res_kernel",)),
              ("K2 jacobi_eigh", ("jacobi_eigh_kernel",)),
              ("K2 resident (n > 128)", ("jacobi_eigh_res_kernel",)),
              ("V from the log, registers", ("rotation_log_regs_kernel",)),
              ("V from the log, slabs", ("rotation_log_kernel",)),
              ("V's follow gate", ("rotation_log_gate_kernel",)),
              ("K3 bp_sweep_group", ("bp_mode_product", "bp_pass2", "bp_reduce")))
    for label, keys in labels:
        sel = [v for k, v in kernels.items() if any(key in k for key in keys)]
        ms, n = sum(v[0] for v in sel), sum(v[1] for v in sel)
        print(f"  {label}: {ms:.3f} ms in {n} launches ({100 * ms / busy:.1f}% of device time)")
    ours = [key for _, keys in labels for key in keys]
    others = sorted(((v, k) for k, v in kernels.items() if not any(key in k for key in ours)), reverse=True)
    for (ms, n), k in others[:8]:
        print(f"  {ms:9.3f} ms {n:5d}x ({100 * ms / busy:4.1f}%) {k[:110]}")


def step_ab(dev, eng, step, probe, layers=3):
    """The step's BP routes against each other in one call: `layers` steady
    layers from the layer-10 state with bp_kernel="kernel" (the main path's
    engine) and with "einsum" (an engine carried over by `from_arrays`), run
    kernel, einsum, kernel, einsum, each from its own copy of the state,
    after one untimed layer on each."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine

    cfg = probe[2]["config"]
    circuit = tnqs_torch.heavy_hex_kicked_ising_layer(eng.plan.graph, cfg["J"], cfg["theta_h"])
    T_host = {k: v.cpu().numpy() for k, v in eng.T.items()}
    e_ein = LatticeEngine.from_arrays(eng.plan.graph, T_host, eng.M.cpu().numpy(), chi=eng.chi, device=dev,
                                      bp_kernel="einsum")
    steps = {"kernel": (eng, step), "einsum": (e_ein, e_ein.make_step(circuit, cutoff=float(cfg["cutoff"]), bp_maxiter=25))}
    for e, st in steps.values():  # one untimed layer each: caches and the allocator warm
        st({k: v.clone() for k, v in eng.T.items()}, eng.M.clone())
    rates, z = {}, {}
    for route in ("kernel", "einsum", "kernel", "einsum"):
        e, st = steps[route]
        T, M = {k: v.clone() for k, v in eng.T.items()}, eng.M.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(layers):
            T, M, _ = st(T, M)
        torch.cuda.synchronize()
        rates.setdefault(route, []).append(layers / (time.perf_counter() - t0))
        zs = e._expect_1site_all(T, M, e._op("Z"))
        z[route] = torch.cat([zs[k] for k in sorted(zs)]).real
    # two float32 routes that round in other orders, three layers on: each
    # layer stays within ~2e-5 of flex-f64 (main path), so they agree to 1e-4
    dz = (z["kernel"] - z["einsum"]).abs().max().item()
    print(f"step A/B from the layer-10 state, {layers} layers a run (kernel, einsum, kernel, einsum): layers/s "
          f"kernel route {[round(r, 4) for r in rates['kernel']]}, einsum route "
          f"{[round(r, 4) for r in rates['einsum']]}; max |d<Z>| between the routes {dz:.3e}")
    require(np.isfinite(dz) and dz < 1e-4, f"the step's kernel and einsum routes differ by {dz:.3e} in <Z>")


def bp_path(dev, eng, probe):
    """normalize and cold BP convergence on the evolved state, on the kernel
    route, against a cold convergence on the einsum route."""
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import bp_sweep

    center, bench_v, controls, zbound, layers = probe
    require(eng.bp_kernel == "kernel", f"the engine's BP route is {eng.bp_kernel!r} on the card")
    plain_calls = bp_sweep._bp_sweep_group_plain.calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bp_sweep.bp_sweep_group.launches = 0

    for call in ("first call, with set-up", "again"):
        t0 = time.perf_counter()
        eng.normalize()
        torch.cuda.synchronize()
        print(f"normalize ({call}): {time.perf_counter() - t0:.3f} s, {eng.bp_iterations} BP iterations, "
              f"eps {eng.bp_eps:.3e}")
    f = eng.freenergy()
    # after the rescale every one of the 127 vertex and 144 edge scalars is 1
    # up to the float32 rounding of its contraction (~1e-6), so |log Z_BP|
    # <= 271 * 1e-6 < 1e-3
    print(f"freenergy after normalize: {f}")
    require(abs(f) < 1e-3, f"normalize left log Z_BP = {f}")
    z = eng.expect_1site("Z")
    for v, ref in ((center, controls["z_center_f64"][layers - 1]), (bench_v, controls["z_bench_f64"][layers - 1])):
        dev_v = abs(z[v].real - ref)
        print(f"<Z>{v} after normalize {z[v].real:+.7f}, |dev| {dev_v:.3e} (bound {zbound:.3e})")
        require(dev_v <= zbound, f"normalize moved <Z>{v} out of the layer-{layers} bound")

    T_host = {k: v.cpu().numpy() for k, v in eng.T.items()}
    M0 = eng._initial_messages()
    results = {}
    for route in ("kernel", "einsum"):
        if route == "kernel":
            e = eng
            e.M = M0.clone()
        else:
            e = LatticeEngine.from_arrays(eng.plan.graph, T_host, M0.cpu().numpy(), chi=eng.chi, device=dev,
                                          bp_kernel="einsum")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.bp_update(maxiter=30)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"cold bp_update on the {route} route: {e.bp_iterations} iterations, eps {e.bp_eps:.3e}, "
              f"{wall:.3f} s ({1e3 * wall / e.bp_iterations:.2f} ms an iteration)")
        z = e.expect_1site("Z")
        zz = e.expect_2site("Z", "Z")
        results[route] = dict(
            M=e.M, z={v: z[v] for v in (center, bench_v)},
            zz={edge: val for edge, val in zz.items() if center in edge or bench_v in edge},
            S=e.bond_entropies(1), Z=e.partitionfunction(),
        )
        r = results[route]
        require(torch.isfinite(r["M"]).all(), f"{route} route: non-finite messages")
        require(all(np.isfinite(x) for d in (r["z"], r["zz"], r["S"]) for x in d.values()) and np.isfinite(r["Z"]),
                f"{route} route: non-finite measurement")
    launches = bp_sweep.bp_sweep_group.launches
    require(launches > 0, "normalize and bp_update did not launch the BP kernel")
    require(bp_sweep._bp_sweep_group_plain.calls == plain_calls, "the BP path ran the plain BP version on the card")
    print(f"BP kernel launches on the BP path: {launches}")
    by_path = dict(dict.fromkeys(k3_launches(), 0), bp_sweep_group=launches)

    # Tolerances: the two routes round in other orders (~1e-6 relative per
    # sweep) and the BP map contracts those differences, so the fixed points
    # agree to ~1e-5 of the largest message entry when both run the same
    # iterations; one iteration more leaves a difference below the 1e-5
    # infidelity tolerance, ~3e-3 relative.  Local expectations are ratios
    # of contractions of those messages; an entropy sums 64 eigenvalues;
    # log Z_BP sums 271 logs.
    a, b = results["kernel"], results["einsum"]
    same = e.bp_iterations == eng.bp_iterations
    dm = ((a["M"] - b["M"]).abs().max() / b["M"].abs().max()).item()
    dz = max(abs(a["z"][v] - b["z"][v]) for v in a["z"])
    dzz = max(abs(a["zz"][edge] - b["zz"][edge]) for edge in a["zz"])
    ds = max(abs(a["S"][edge] - b["S"][edge]) for edge in a["S"])
    dZ = abs(a["Z"] - b["Z"]) / abs(b["Z"])
    print(f"kernel vs einsum route: messages {dm:.3e} (relative), <Z> {dz:.3e}, <ZZ> {dzz:.3e} on "
          f"{len(a['zz'])} edges, entropies {ds:.3e}, Z_BP {dZ:.3e} (relative; Z_BP {a['Z']})")
    require(dm < (1e-4 if same else 1e-2), f"kernel and einsum routes: messages differ by {dm:.3e}")
    require(dz < 1e-5 and dzz < 1e-5, f"kernel and einsum routes: <Z> {dz:.3e}, <ZZ> {dzz:.3e}")
    require(ds < 1e-4, f"kernel and einsum routes: bond entropies differ by {ds:.3e}")
    require(dZ < 1e-3, f"kernel and einsum routes: Z_BP differs by {dZ:.3e}")
    print(f"max_memory_allocated on the BP path {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return by_path


# ----------------------------------------------------------------------
# phase 7: the engine's other switches
# ----------------------------------------------------------------------

def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def rotation_log_layouts(by_path, paths):
    """V's kernel's launches by layout on every path that ran it, printed.
    On each of `paths` (8d, 8e, 10e: n <= 1024 only) V must have run, every
    launch in the register layout but where `rotation_log.beside_plan` gave
    it to the slab layout, whose units all fit on the SMs the iterate leaves
    idle (10e's [4, 512, 512], 8e's [16/18, 512, 256], 8d's [18, 192, 192]).
    Returns {path: {layout: launches}}."""
    layouts = {p: {layout: c[f"rotation_log {layout}"] for layout in ("regs", "slab", "slab beside")}
               for p, c in by_path.items() if c.get("rotation_log")}
    print(f"V's kernel by layout and path: {layouts}", flush=True)
    for p in paths:
        c = by_path[p]
        require(c["rotation_log"] and c["rotation_log regs"] + c["rotation_log slab beside"] == c["rotation_log"],
                f"V's kernel by layout on {p}: {layouts.get(p)}")
    return layouts


def reset_counts():
    """Zero every kernel's launch counts (the plain runs' counts stay, and are
    compared before and after)."""
    from tnqs_torch.ops import bp_sweep, jacobi, osj
    from tnqs_torch.ops.factorizations import default_eigh

    from tnqs_torch.ops.rotation_log import apply_rotation_log

    jacobi.jacobi_eigh.launches = osj.osj_svd.launches = bp_sweep.bp_sweep_group.launches = 0
    apply_rotation_log.launches = apply_rotation_log.slab_beside = 0
    apply_rotation_log.launches_by_layout.update(dict.fromkeys(apply_rotation_log.launches_by_layout, 0))
    jacobi.jacobi_eigh.launches_by_shape.clear()
    osj.osj_svd.launches_by_shape.clear()
    for by_layout in (jacobi.jacobi_eigh.launches_by_layout, osj.osj_svd.launches_by_layout):
        by_layout.update(dict.fromkeys(by_layout, 0))
    bp_sweep.bp_sweep_group.launches_by_mode.update(dict.fromkeys(bp_sweep.MODES, 0))
    by_route = bp_sweep.bp_sweep_group.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    bp_sweep.split_bucket.launches = 0
    bp_sweep.bp_sweep_group.launches_by_shape.clear()
    default_eigh.library_calls = 0
    return (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls, bp_sweep._bp_sweep_group_plain.calls)


def read_counts(plain_before):
    """(launches by kernel name, K2's launches by [B, n], library eigh calls,
    whether a plain version ran since `reset_counts`)."""
    from tnqs_torch.ops import bp_sweep, jacobi, osj
    from tnqs_torch.ops.factorizations import default_eigh

    plain = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls, bp_sweep._bp_sweep_group_plain.calls)
    return k3_launches(), dict(jacobi.jacobi_eigh.launches_by_shape), default_eigh.library_calls, plain != plain_before


def k3_launches():
    """Launches by kernel row of the `kernels` line, K3's by mode; past
    n = 256 also K1's and K2's by layout (resident, L2)."""
    from tnqs_torch.ops import bp_sweep, jacobi, osj
    from tnqs_torch.ops.rotation_log import apply_rotation_log

    by_mode = bp_sweep.bp_sweep_group.launches_by_mode
    counts = {"jacobi_eigh": jacobi.jacobi_eigh.launches, "osj_svd": osj.osj_svd.launches,
              "bp_sweep_group": by_mode["highest"], "bp_sweep_group_bf16_3x": by_mode["bf16_3x"],
              "bp_split_planes": bp_sweep.split_bucket.launches,
              "bf16_3x wgmma": bp_sweep.bp_sweep_group.launches_by_route["wgmma"],
              "rotation_log": apply_rotation_log.launches}
    for layout, count in apply_rotation_log.launches_by_layout.items():
        counts[f"rotation_log {layout}"] = count
    counts["rotation_log slab beside"] = apply_rotation_log.slab_beside
    for layout in ("resident", "l2"):
        counts[f"jacobi_eigh {layout}"] = jacobi.jacobi_eigh.launches_by_layout[layout]
        counts[f"osj_svd {layout}"] = osj.osj_svd.launches_by_layout[layout]
    counts["jacobi_eigh ring"] = jacobi.jacobi_eigh.launches_by_layout["ring"]
    for n, k2, k1 in [(n, "jacobi_eigh_res", "osj_svd") for n in WIDE_N] + [(n, "jacobi_eigh_l2", "osj_svd_l2")
                                                                          for n in L2_N]:
        # the rows past n = 128 (K2's resident variant, K1) and past n = 256 (the L2 variants), by width
        counts[f"{k2} n={n}"] = sum(c for (_, w), c in jacobi.jacobi_eigh.launches_by_shape.items() if w == n)
        counts[f"{k1} n={n}"] = sum(c for (_, _, w), c in osj.osj_svd.launches_by_shape.items() if w == n)
    return counts


def switch_shapes(eng, circuit):
    """K2's shapes on the switches' paths, per two-site group of the layer:
    the eigh gauge's environment bank [N, chi, chi] (every class side of
    degree k > 1 brings k-1 environments) and the count B of thetas whose
    smaller-side Gram is 2*chi wide (both ends of degree > 1): full
    truncation's [B, 2chi, 2chi], subspace's Rayleigh-Ritz [B, chi+8, chi+8]."""
    from tnqs_torch.engine import TwoSiteGroup, compile_circuit

    shapes = []
    for grp in compile_circuit(eng.plan, circuit):
        if isinstance(grp, TwoSiteGroup):
            N = sum(len(c.u_pos) * ((c.ku - 1) + (c.kv - 1)) for c in grp.classes)
            B = sum(len(c.u_pos) for c in grp.classes if min(c.ku, c.kv) > 1)
            shapes.append((N, B))
    return shapes


def k2_switch_shapes(dev):
    """K2 against its plain version at the switches' shapes, the largest of
    each on the Eagle chi=64 layer: the environment bank [N, 64, 64], the
    subspace solve [B, 72, 72] and full truncation's Grams [B, 128, 128], at
    `default_eigh`'s 12 sweeps and relative skip; each timed beside
    `torch.linalg.eigh` and its bound."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import jacobi

    g = tnqs_torch.eagle_lattice()
    eng = LatticeEngine(g, chi=64, device=dev)
    shapes = switch_shapes(eng, tnqs_torch.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4))
    rng = np.random.default_rng(7)
    rows, errs = [], []
    for B, n in ((max(N for N, _ in shapes), 64), (max(b for _, b in shapes), 72), (max(b for _, b in shapes), 128)):
        A = torch.as_tensor(spectrum_batch(rng, B, 2 * n, n), device=dev)
        G = A.mH @ A
        Hb = (0.5 * (G + G.mH)).contiguous()
        w_k, V_k = jacobi.jacobi_eigh(G)
        w_p, V_p = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 12))
        sync(dev)
        check_eigh(f"kernel [{B},{n},{n}]", Hb, w_k, V_k)
        check_eigh(f"plain [{B},{n},{n}]", Hb, w_p, V_p)
        rel = ((w_k - w_p).abs().amax(1) / w_p.abs().amax(1)).max().item()
        errs.append((w_k - w_p).abs().max().item())
        print(f"jacobi_eigh [{B},{n},{n}] kernel vs plain: max |dw| {errs[-1]:.3e}, relative to largest {rel:.3e}")
        require(rel < 1e-4, f"jacobi_eigh [{B},{n},{n}]: kernel and plain eigenvalues differ by more than 1e-4")
        taken = jacobi._jacobi_eigh_plain.rotations.item()
        ms = cuda_ms(lambda: jacobi.jacobi_eigh(G), 10)
        plain_ms = cuda_ms(lambda: jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 12)), 1)
        library_ms = cuda_ms(lambda: torch.linalg.eigh(Hb), 10)
        bound_ms, bound_by = eigh_bound(B, n, taken)
        rows.append((B, n, ms, plain_ms, library_ms, bound_ms, bound_by))
        print(f"jacobi_eigh [{B},{n},{n}] sweeps=12: kernel {ms:.3f} ms (wrapper, refinement included), plain "
              f"{plain_ms:.3f} ms, torch.linalg.eigh {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
              f"{taken} of {B * 12 * (n - 1) * (n // 2)} rotations taken; kernel at {100 * bound_ms / ms:.1f}%)")
    return max(errs)


def evolve_eagle(dev, label, chi, dtype, layers, refs, cutoff, gate=None, time_cap=None, min_layers=None,
                 state=None, **options):
    """`layers` kicked-Ising layers (J = pi/4, theta_h = 0.4) on Eagle-127 from
    "↑" (or from `state` = (T, M) host arrays) on an engine built with
    `options`.  After each layer <Z> is read at each vertex of `refs`
    {vertex: reference values a layer, or None} and held against its
    reference; every value must be finite, and the deviation within
    `gate[layer]` where `gate` is given.  With `time_cap`, the run stops
    after `min_layers` once the next layer would pass it.  Returns (engine,
    step, <Z> [layers, vertices], deviations, seconds a layer, counts)."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine

    g = tnqs_torch.eagle_lattice()
    circuit = tnqs_torch.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4)
    if state is None:
        eng = LatticeEngine(g, chi=chi, dtype=dtype, device=dev, **options)
    else:
        eng = LatticeEngine.from_arrays(g, *state, chi=chi, dtype=dtype, device=dev, **options)
    step = eng.make_step(circuit, cutoff=cutoff, bp_maxiter=25)
    plain_before = reset_counts()
    zs, devs, times = [], [], []
    for li in range(layers):
        sync(dev)
        t0 = time.perf_counter()
        eng.T, eng.M, errors = step(eng.T, eng.M)
        sync(dev)
        times.append(time.perf_counter() - t0)
        finite = (bool(torch.isfinite(errors).all()) and bool(torch.isfinite(eng.M).all())
                  and all(bool(torch.isfinite(t).all()) for t in eng.T.values()))
        require(finite, f"{label}, layer {li + 1}: non-finite state")
        z = eng.expect_1site("Z")
        zs.append([z[v].real for v in refs])
        require(np.isfinite(zs[-1]).all(), f"{label}, layer {li + 1}: non-finite <Z>")
        line = f"{label} layer {li + 1}: {times[-1]:.3f} s  " + "  ".join(f"Z{v}={z[v].real:+.9f}" for v in refs)
        if all(vals is not None for vals in refs.values()):
            devs.append(max(abs(z[v].real - vals[li]) for v, vals in refs.items()))
            line += f"  |dev| {devs[-1]:.3e}" + ("" if gate is None else f" (bound {gate[li]:.3e})")
            if gate is not None:
                require(devs[-1] <= gate[li], f"{label}, layer {li + 1}: deviation {devs[-1]:.3e} above {gate[li]:.3e}")
        print(line, flush=True)
        if time_cap is not None and li + 1 >= min_layers and sum(times) + times[-1] > time_cap:
            print(f"{label}: cut at {li + 1} of {layers} layers, the next would pass {time_cap:.0f} s")
            break
    counts = read_counts(plain_before)
    print(f"{label}: {1e3 * np.mean(times[1:] or times):.1f} ms a layer over layers 2-{len(times)}, launches "
          f"{counts[0]}, K2 by [B, n] {counts[1]}, library eigh calls {counts[2]}")
    return eng, step, np.array(zs), devs, times, counts


def linalg_split(dev, label, eng, step):
    """One more layer, on a copy of the state, with every `torch.linalg.qr`,
    `svd` and `eigh` call synchronised on both sides and timed on the host
    clock: the layer's time in each against the whole."""
    spent = {}
    real = {name: getattr(torch.linalg, name) for name in ("qr", "svd", "eigh")}

    def timed(name):
        def call(*args, **kwargs):
            sync(dev)
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            sync(dev)
            n, ms = spent.get(name, (0, 0.0))
            spent[name] = (n + 1, ms + 1e3 * (time.perf_counter() - t0))
            return out

        return call

    T, M = {k: v.clone() for k, v in eng.T.items()}, eng.M.clone()
    for name in real:
        setattr(torch.linalg, name, timed(name))
    try:
        sync(dev)
        t0 = time.perf_counter()
        step(T, M)
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for name, fn in real.items():
            setattr(torch.linalg, name, fn)
    print(f"{label}, one more layer with each library factorization synchronised: {wall_ms:.1f} ms; "
          + ", ".join(f"torch.linalg.{k} {n} calls {ms:.1f} ms ({100 * ms / wall_ms:.1f}%)"
                      for k, (n, ms) in sorted(spent.items()))
          + f"; the rest {wall_ms - sum(ms for _, ms in spent.values()):.1f} ms")
    return spent


# 7f's bars.  X R^{-1} built from the Gram alone is orthonormal to a small
# multiple of eps kappa^2 plus CholeskyQR2's own, shift-limited defect
# (kappa: the live columns' condition number; on the CPU the Eagle layer at
# chi=16 gives at most 0.25 eps kappa^2, well-conditioned random sides 1x
# CholeskyQR2's 3e-5); one
# group on well-conditioned sides through the Q-free reduction and through
# cholqr2 agrees to the bar of the CPU group tests
# (`tests/test_torch_switches.py`)
NOFACTOR_ORTH = 10.0
NOFACTOR_GROUP = 1e-4


def first_group_tall_sides(eng):
    """The real tall gauged sides X [B, chi^2, d*chi] of the first two-site
    group of one layer from `eng`'s state (the layer runs on a copy)."""
    import tnqs_torch

    captured, first = [], {"on": False}
    orig_gauged, orig_group = eng._gauged_matrix, eng._apply_two_site_group

    def gauged(A, W, k):
        X = orig_gauged(A, W, k)
        if first["on"] and X.shape[1] > eng.d * eng.chi:
            captured.append(X)
        return X

    def group(*args, **kwargs):
        first["on"] = not captured
        try:
            return orig_group(*args, **kwargs)
        finally:
            first["on"] = False

    eng._gauged_matrix, eng._apply_two_site_group = gauged, group
    try:
        step = eng.make_step(tnqs_torch.heavy_hex_kicked_ising_layer(eng.plan.graph, np.pi / 4, 0.4),
                             cutoff=1e-12, bp_maxiter=25)
        step({k: v.clone() for k, v in eng.T.items()}, eng.M.clone())
    finally:
        del eng._gauged_matrix, eng._apply_two_site_group
    return torch.cat(captured)


def nofactor_factorizations(X, label):
    """`gram_rfactor` on the Grams of real tall sides X.  Its Gram-space
    second Cholesky round fails wherever a live direction's eigenvalue lies
    at the shift (every product state; truncated bonds): the reference
    returns NaN for such a matrix, and so must the port, never a partial
    factor.  Returns which factorizations succeeded."""
    from tnqs_torch.ops.factorizations import gram_rfactor

    R, _, _ = gram_rfactor(X.mH @ X)
    finite, nan = torch.isfinite(R).all(dim=(1, 2)), torch.isnan(R).all(dim=(1, 2))
    print(f"7f: gram_rfactor on the first group's tall sides {label} {tuple(X.shape)}, {X.dtype}: "
          f"{int((~finite).sum())} of {len(finite)} factorizations failed (a failure is NaN, as the reference "
          f"returns it)")
    require(bool((finite | nan).all()), f"7f: gram_rfactor returned a partial factor {label}")
    return finite


def nofactor_orthonormality(X, ok):
    """X R^{-1} of `gram_rfactor` against `cholesky_qr`'s Q on the tall sides
    X whose factorization succeeded (`ok`), on their live columns
    (exactly-null bond columns are zero).  Per matrix: the largest
    |Q^H Q - I| of each, and eps kappa^2 for kappa the live columns'
    condition number: the Gram-space second round repairs Q1 = X L1^{-H}
    from G alone, so X R^{-1} is orthonormal to ~eps kappa^2 on top of the
    defect the shift leaves CholeskyQR2 on X itself."""
    from tnqs_torch.ops.factorizations import apply_rinv, cholesky_qr, eps_of, gram_rfactor

    X = X[ok]
    G = X.mH @ X
    _, L1, L2 = gram_rfactor(G)
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    Qn = X @ apply_rinv(L1, L2, eye.expand(G.shape))
    Qc, _ = cholesky_qr(X)
    live = torch.linalg.vector_norm(X, dim=1) > 0  # [B, n]
    mask = (live[:, :, None] & live[:, None, :]).to(X.real.dtype)
    dn, dc = (((Q.mH @ Q - eye).abs() * mask).amax(dim=(1, 2)) for Q in (Qn, Qc))
    s = torch.linalg.svdvals(X)
    kappa = s[:, 0] / s.gather(1, (live.sum(1, keepdim=True) - 1).clamp(min=0))[:, 0]
    scale = eps_of(X.dtype) * kappa**2 + dc
    print(f"7f: on {len(X)} tall sides ({int(live.sum())} live columns of {live.numel()}): max |Q^H Q - I| "
          f"X R^-1 {dn.max().item():.3e}, cholesky_qr {dc.max().item():.3e}; live kappa "
          f"{kappa.min().item():.3e}..{kappa.max().item():.3e}; largest X R^-1 defect / (eps kappa^2 + "
          f"cholesky_qr's) {(dn / scale).max().item():.3e} (bar {NOFACTOR_ORTH})")
    require(bool((dn <= NOFACTOR_ORTH * scale).all()), "7f: X R^-1 further from orthonormal than eps kappa^2")
    return max(dn.max().item(), dc.max().item())


def nofactor_group(dev, chi):
    """The engine's Q-free path where it is well posed: the first two-site
    group of the layer on a random full-rank complex64 state (numpy, seed 5)
    with the initial identity/chi messages, so the gauged tall sides are
    well conditioned.  Their factorizations must all succeed and X R^-1 be
    orthonormal to ~eps kappa^2; the group, once with
    ``reduce_method="gram_nofactor"`` and once with "cholqr2", must leave the
    state finite, and the messages and <Z> on every vertex within
    `NOFACTOR_GROUP` of each other.

    The site tensors themselves are compared where the bond gauge (the SVD's
    free phase of each singular pair) drops out.  The thetas (R factors
    unique up to rounding) must agree to `NOFACTOR_GROUP`; each gate's
    two-site tensor, the bond contraction of its new site tensors, must
    agree to within `NOFACTOR_ORTH` times the first-order bound of the
    rank-chi truncation, (d theta + d Q) (1 + 2 s_chi / (s_chi -
    s_chi+1)): d theta the gate's theta difference, d Q the larger
    orthonormality defect of the two reductions, and the gap that of
    cholqr2's theta at the cut."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine, TwoSiteGroup, _ClassData, compile_circuit

    g = tnqs_torch.eagle_lattice()
    circuit = tnqs_torch.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4)
    ref = LatticeEngine(g, chi=chi, device=dev)
    rng = np.random.default_rng(5)
    T0 = {k: rand_c(rng, tuple(v.shape)) for k, v in ref.T.items()}
    M0 = ref.M.cpu().numpy()
    out, cds, thetas, captured = {}, {}, {}, []
    for method in ("cholqr2", "gram_nofactor"):
        eng = LatticeEngine.from_arrays(g, T0, M0, chi=chi, device=dev, reduce_method=method)
        if method == "cholqr2":
            def gauged(A, W, k, eng=eng, orig=eng._gauged_matrix):
                X = orig(A, W, k)
                if X.shape[1] > eng.d * eng.chi:
                    captured.append(X)
                return X

            eng._gauged_matrix = gauged

        def svds(ths, method=method, orig=eng._theta_svds):
            thetas[method] = [t.clone() for t in ths]
            return orig(ths)

        eng._theta_svds = svds
        group = next(c for c in compile_circuit(eng.plan, circuit) if isinstance(c, TwoSiteGroup))
        cds[method] = [_ClassData(c, eng.dtype, eng.device) for c in group.classes]
        errors = torch.zeros(len(circuit), dtype=torch.float32, device=dev)
        eng._apply_two_site_group(eng.T, eng.M, errors, cds[method], 1e-12, True)
        sync(dev)
        require(all(bool(torch.isfinite(t).all()) for t in eng.T.values()) and bool(torch.isfinite(eng.M).all()),
                f"7f: {method} group on the random state: non-finite")
        out[method] = eng
    X = torch.cat(captured)
    ok = nofactor_factorizations(X, "of a random full-rank state")
    require(bool(ok.all()), "7f: a factorization of the random state's well-conditioned sides failed")
    dq = nofactor_orthonormality(X, ok)
    z = {m: torch.cat(list(e._expect_1site_all(e.T, e.M, e._op("Z")).values())).real for m, e in out.items()}
    dz = (z["gram_nofactor"] - z["cholqr2"]).abs().max().item()
    dM = (out["gram_nofactor"].M - out["cholqr2"].M).abs().max().item()
    dT = max((out["gram_nofactor"].T[k] - out["cholqr2"].T[k]).abs().max().item() for k in T0)

    def rel(a, b):
        return torch.linalg.vector_norm((a - b).flatten(1), dim=1) / torch.linalg.vector_norm(b.flatten(1), dim=1)

    def two_site(eng, cd):
        B, cls = len(cd.cls.u_pos), cd.cls
        Au = eng._gather_permuted(eng.T, cls.ku, cd.u).reshape(B, -1, chi)
        Av = eng._gather_permuted(eng.T, cls.kv, cd.v).reshape(B, -1, chi)
        return Au @ Av.mT

    d_theta, d_two, bound, gaps = [], [], [], []
    for ci in range(len(cds["cholqr2"])):
        th_c, th_n = thetas["cholqr2"][ci], thetas["gram_nofactor"][ci]
        dth = rel(th_n, th_c)
        s = torch.linalg.svdvals(th_c.to(torch.complex128))
        gap = ((s[:, chi - 1] - s[:, chi]) / s[:, chi - 1]) if s.shape[1] > chi else torch.full_like(s[:, 0], np.inf)
        d_theta.append(dth)
        gaps.append(gap)
        d_two.append(rel(two_site(out["gram_nofactor"], cds["gram_nofactor"][ci]),
                         two_site(out["cholqr2"], cds["cholqr2"][ci])))
        bound.append((dth + dq) * (1.0 + 2.0 / gap.float()))
    d_theta, d_two, bound, gaps = (torch.cat(x) for x in (d_theta, d_two, bound, gaps))
    worst = int(torch.argmax(d_two / bound))
    print(f"7f: the first group on the random state, gram_nofactor against cholqr2: max |dM| {dM:.3e}, max "
          f"|d<Z>| {dz:.3e} over every vertex, thetas {d_theta.max().item():.3e} relative (bar {NOFACTOR_GROUP}); "
          f"max |dT| {dT:.3e} entrywise; the gates' two-site tensors (free of the bond gauge) {d_two.max().item():.3e} "
          f"relative, at most {(d_two / bound).max().item():.3e} of the first-order truncation bound (bar "
          f"{NOFACTOR_ORTH}; there d theta {d_theta[worst].item():.3e}, d Q {dq:.3e}, relative gap at the cut "
          f"{gaps[worst].item():.3e}); smallest gap at the cut {gaps.min().item():.3e}")
    require(dM < NOFACTOR_GROUP and dz < NOFACTOR_GROUP and d_theta.max().item() < NOFACTOR_GROUP,
            "7f: gram_nofactor and cholqr2 groups differ")
    require(bool((d_two <= NOFACTOR_ORTH * bound).all()),
            "7f: a gate's two-site tensor differs beyond its truncation bound")


def certification_table(runs):
    """F1 (ROADMAP Queue 3): each run's per-layer deviation from flex-f64
    {label: deviations} against both clauses of the reference's
    `pjsvd_certified` (`tnqs/ops/osj.py:62-106`), on the floor of
    `tests/golden/tpu_parity_chi64.json`: (1) every layer within max(3 x
    the running floor, 2e-5); (2) the trajectory's maximum at most the
    floor's.  Returns {label: (clause 1, clause 2, max deviation)}."""
    floors = np.asarray(json.loads((ROOT / "tests" / "golden" / "tpu_parity_chi64.json").read_text())
                        ["f32_floor_per_layer"])
    gate = np.maximum(3.0 * np.maximum.accumulate(floors), 2e-5)
    out = {}
    for label, devs in runs.items():
        devs = np.asarray(devs)
        c1, c2 = bool((devs <= gate[:len(devs)]).all()), bool(devs.max() <= floors.max())
        print(f"F1 {label}: |dev| by layer " + " ".join(f"{d:.3e}" for d in devs)
              + f"; clause 1 (each layer within max(3 x running floor, 2e-5)) {c1}; clause 2 (max {devs.max():.3e} "
              f"<= floor max {floors.max():.3e}) {c2}")
        out[label] = (c1, c2, float(devs.max()))
    return out


def switches_phase(dev, layers, main_rate=float("nan"), chi=64, main_devs=None):
    """Phase 7: every switch of the engine on the card, from "↑" on Eagle-127
    with the main path's layer.  Returns each run's kernel launches by path
    ("7a" .. "7g"), each counted from 0 just before that run."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine

    gold = json.loads((ROOT / "tests" / "golden" / "golden_eagle127.json").read_text())
    controls = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["chi64"]
    cfg = controls["config"]
    center, bench_v = tuple(cfg["center"]), tuple(cfg["bench_vertex"])
    floors = np.max([controls["f32_floor_per_layer"]]
                    + [sd["dev_from_f64_per_layer"] for sd in controls["multiseed_controls"]["seeds"].values()], axis=0)
    main_bound = np.maximum(3.0 * np.maximum.accumulate(floors), 2e-5)
    refs64 = {center: controls["z_center_f64"], bench_v: controls["z_bench_f64"]}
    envelope = np.full(cfg["layers"], 1e-2)  # the non-production envelope, tests/test_f32_floor.py:119-129
    # complex128 against flex-f64: the main bound, and the CPU tests' 1e-8
    # complex128 bar (`tests/test_torch_switches.py`), the tighter of the two
    oracle_bound = np.minimum(main_bound, 1e-8)
    by_path = {}

    def none_launched(label, counts):
        require(not any(counts[0].values()) and not counts[3],
                f"{label}: a float32 kernel or its plain version ran: {counts[0]}")

    # a. the golden: direct, complex128, chi=8, 20 layers, the reference
    # test's BP schedule (the JAX engine's on the CPU)
    c = gold["config"]
    *_, devs, _, counts = evolve_eagle(dev, "7a golden direct c128 chi=8", c["maxdim"], torch.complex128, c["layers"],
                                       {tuple(c["central"]): gold["z_central"]}, c["cutoff"],
                                       factor_method="direct", bp_schedule="wavefront")
    print(f"7a: layer {c['layers']} |dev| {devs[-1]:.3e} from golden_eagle127.json (bound 1e-5)")
    require(devs[-1] < 1e-5, f"7a: layer {c['layers']} deviates {devs[-1]:.3e} from the golden")
    none_launched("7a", counts)
    by_path["7a"] = counts[0]

    # b. direct, complex128, chi=64: the device's f64 oracle
    eng, step, _, devs, times, counts = evolve_eagle(
        dev, f"7b direct c128 chi={chi}", chi, torch.complex128, cfg["layers"], refs64, cfg["cutoff"],
        gate=oracle_bound, time_cap=ORACLE_CAP_S, min_layers=4, factor_method="direct")
    none_launched("7b", counts)
    by_path["7b"] = counts[0]
    linalg_split(dev, f"7b direct c128 chi={chi}", eng, step)
    oracle = ({k: v.cpu().numpy() for k, v in eng.T.items()}, eng.M.cpu().numpy())
    del eng, step

    # c-e. K2 on the Gram truncations and the eigh gauge
    for label, options, n, k1 in (("7c trunc full", dict(trunc_method="full"), 2 * chi, False),
                                  ("7d trunc subspace", dict(trunc_method="subspace"), chi + 8, False),
                                  ("7e env_gauge eigh", dict(env_gauge="eigh"), chi, True)):
        *_, devs, _, counts = evolve_eagle(dev, f"{label} c64 chi={chi}", chi, torch.complex64, layers, refs64,
                                           cfg["cutoff"], gate=envelope, **options)
        by_n = sorted(shape for shape in counts[1] if shape[1] == n)
        print(f"{label}: K2 at n={n}: {by_n}; max |dev| {max(devs):.3e}; within the main path's bound at every "
              f"layer: {all(d <= b for d, b in zip(devs, main_bound))}")
        require(by_n, f"{label}: K2 not launched at n={n}")
        require(not counts[3], f"{label}: a plain version ran on the card")
        require(counts[0]["bp_sweep_group"] > 0 and (counts[0]["osj_svd"] > 0) == k1,
                f"{label}: launches {counts[0]}")
        by_path[label[:2]] = counts[0]

    # f. the Q-free reduction.  Its Gram-space second round breaks down, as
    # the reference's does, wherever a live direction sits at the shift
    # (kappa(X)^2 past 1/eps), so no trajectory from "↑" runs (ROADMAP Queue
    # 3): its factorizations on real tall sides from "↑" (complex64) and
    # from 7b's state (complex128), X R^-1 where they succeed, and the
    # engine's Q-free group path on well-conditioned sides
    g = tnqs_torch.eagle_lattice()
    nofactor_factorizations(first_group_tall_sides(LatticeEngine(g, chi=chi, device=dev)), "from the product state")
    X = first_group_tall_sides(LatticeEngine.from_arrays(g, *oracle, chi=chi, dtype=torch.complex128, device=dev))
    ok = nofactor_factorizations(X, "from 7b's state")
    if ok.any():
        nofactor_orthonormality(X, ok)
    del X
    nofactor_group(dev, chi)

    # g. the library SVD for every theta
    _, _, _, devs, times, counts = evolve_eagle(dev, f"7g svd_impl xla c64 chi={chi}", chi, torch.complex64, layers, refs64,
                                             cfg["cutoff"], gate=main_bound, svd_impl="xla")
    require(counts[0]["osj_svd"] == 0 and counts[0]["jacobi_eigh"] == 0 and counts[0]["bp_sweep_group"] > 0,
            f"7g: launches {counts[0]}")
    require(not counts[3], "7g: a plain version ran on the card")
    by_path["7g"] = counts[0]
    rate = (len(times) - 1) / sum(times[1:]) if len(times) > 1 else float("nan")
    print(f"7g: layers/s over layers 2-{len(times)} {rate:.4f} with torch.linalg.svd, against {main_rate:.4f} on "
          f"the pjsvd route (phase 5)")
    if main_devs is not None:
        certification_table({"5 (svd_impl='pjsvd', K2 then K1)": main_devs, "7g (svd_impl='xla', gesvd)": devs})
    return by_path

# ----------------------------------------------------------------------
# phase 8: the boundary-MPS measurement path
# ----------------------------------------------------------------------

ORACLE_CAP_S = 12.0  # 7b's complex128 oracle layers stop once the next would pass this (at least 4)
CHI96_CAP_S = 60.0  # 8d's layers stop once the next would pass this
CHI128_CAP_S = 90.0  # 8e's the same
WIDE_XLA_CAP_S = 8.0  # 8d's and 8e's library-SVD runs the same (at least 2 layers; ~2-3 s a layer there)


def bmps_library_calls():
    """(library eighs, library SVDs) the boundary-MPS tier has made."""
    from tnqs_torch import bmps_engine

    return bmps_engine._eigh.calls, bmps_engine._svd.calls


def checked_z(label, z, verts, im_rel=1e-4):
    """<Z> at `verts` as reals, each finite with |Im| <= im_rel |Re|."""
    for v in verts:
        require(np.isfinite(z[v]), f"{label}: non-finite <Z>{v}")
        require(abs(z[v].imag) <= im_rel * abs(z[v].real), f"{label}: <Z>{v} = {z[v]} is not real")
    return {v: z[v].real for v in verts}


def measure_w2(dev):
    """8a: the w2 readout, Eagle-127 at chi=8 after 20 kicked-Ising layers,
    BMPS rank 10, gated as `tests/test_f32_floor.py:219-229` gates the
    committed readout, with the 2-site, rdm, fidelity and norm entry points
    on the same state; 8b: the same readout on a CPU engine carried over by
    `from_arrays`.  Returns the launches of the evolution and of the BMPS
    calls."""
    from tnqs_torch.bmps_engine import BMPSEngine
    from tnqs_torch.engine import LatticeEngine

    w2 = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["w2"]
    rows = json.loads((ROOT / "scripts" / "bisect_w2_gap_results.json").read_text())["rows"]
    z_flex = json.loads((ROOT / "scripts" / "w2_onchip_results.json").read_text())["cross_tier_gap_closure"][
        "flex_z_bench"]
    cfg = w2["config"]
    center, bench_v = tuple(cfg["center"]), tuple(cfg["bench_vertex"])
    verts = [center, bench_v]
    eng, _, zs, devs, _, counts = evolve_eagle(
        dev, "8a w2 c64 chi=8", cfg["maxdim"], torch.complex64, cfg["layers"],
        {center: w2["z_center_f64"], bench_v: w2["z_bench_f64"]}, cfg["cutoff"])
    require(not counts[3], "8a: a plain kernel version ran on the card")
    by_path = {"8a": counts[0]}
    z_bp = eng.expect_1site("Z")[bench_v].real
    print(f"8a: BP <Z>{bench_v} {z_bp:+.7f}, |dev| {abs(z_bp - w2['z_bench_f64'][-1]):.3e} from flex-f64 (bound 5e-4)")
    require(abs(z_bp - w2["z_bench_f64"][-1]) <= 5e-4, "8a: the BP evolution left flex-f64 at the bench vertex")

    plain_before = reset_counts()
    calls0 = bmps_library_calls()
    be = BMPSEngine(eng, rank=cfg["mps_bond_dimension"])
    sync(dev)
    t0 = time.perf_counter()
    z = checked_z("8a", be.expect_1site("Z", vertices=verts), verts)
    sync(dev)
    wall = time.perf_counter() - t0
    lo, hi = min(r["z_bmps_bench"] for r in rows), max(r["z_bmps_bench"] for r in rows)
    width = hi - lo
    print(f"8a: BMPS rank {cfg['mps_bond_dimension']} <Z>{center} {z[center]:+.7f}, <Z>{bench_v} {z[bench_v]:+.7f} "
          f"({wall:.3f} s); envelope [{lo - width:.7f}, {hi + width:.7f}], |z - flex {z_flex}| "
          f"{abs(z[bench_v] - z_flex):.3e} (bound {2 * width:.3e})")
    require(lo - width <= z[bench_v] <= hi + width, f"8a: readout {z[bench_v]:.7f} outside the committed envelope")
    require(abs(z[bench_v] - z_flex) <= 2 * width, "8a: readout too far from the flex tier")
    require(be.sketch_bytes == 0, "8a: an emit drew a sketch at chi=8, rank 10")

    cp = be.cplan
    pair = next((u, w) for (u, w) in eng.plan.graph.edges() if center in (u, w) and cp.col_of[u] == cp.col_of[w])
    zz = be.expect_2site("Z", "Z", pairs=[pair])[pair]
    zz_bp = eng.expect_2site("Z", "Z")[pair]
    print(f"8a: <ZZ>{pair} BMPS {zz.real:+.7f}, BP {zz_bp.real:+.7f}")
    require(np.isfinite(zz) and abs(zz.imag) <= 1e-4 * abs(zz.real), f"8a: <ZZ>{pair} = {zz}")
    rho = be.rdm([center])
    z_rho = (rho[0, 0] - rho[1, 1]).real
    herm = np.abs(rho - rho.conj().T).max()
    print(f"8a: rdm{center} trace {np.trace(rho):.7f}, |rho - rho^H| {herm:.3e}, <Z> from it {z_rho:+.7f} "
          f"(expect_1site {z[center]:+.7f})")
    require(abs(np.trace(rho) - 1) <= 1e-6 and herm <= 1e-6, "8a: rdm not a unit-trace Hermitian matrix")
    require(abs(z_rho - z[center]) <= 1e-5, "8a: rdm's <Z> and expect_1site's differ")
    f = be.fidelity(eng)
    ln, ns = be.lognorm(), be.norm_sqr()
    print(f"8a: fidelity(self) {f:.9f}, lognorm {ln:.7f}, norm_sqr {ns:.7e}")
    require(abs(f - 1) <= 1e-4, f"8a: self-fidelity {f}")
    require(abs(ns - np.exp(ln)) <= 1e-6 * ns, "8a: norm_sqr and exp(lognorm) differ")
    counts = read_counts(plain_before)
    calls = np.subtract(bmps_library_calls(), calls0)
    print(f"8a: BMPS calls launched {counts[0]}, library eigh {calls[0]}, SVD {calls[1]}")
    require(not any(counts[0].values()) and not counts[3], "8a: a kernel or its plain version ran inside BMPS")
    by_path["8a bmps"] = counts[0]

    # 8b: the same readout on the CPU
    cpu = LatticeEngine.from_arrays(eng.plan.graph, *eng.to_arrays(), chi=eng.chi, device="cpu",
                                    bp_schedule=eng.plan.bp_schedule)
    t0 = time.perf_counter()
    zc = checked_z("8b", BMPSEngine(cpu, rank=cfg["mps_bond_dimension"]).expect_1site("Z", vertices=verts), verts)
    d = max(abs(zc[v] - z[v]) for v in verts)
    print(f"8b: CPU readout {zc[center]:+.7f}, {zc[bench_v]:+.7f} ({time.perf_counter() - t0:.3f} s), card - CPU "
          f"{d:.3e} (bound 1e-5)")
    require(d <= 1e-5, "8b: the card's and the CPU's readouts differ")
    return by_path, eng


def measure_chi64(dev, eng, probe):
    """8c: BMPS <Z> on the main path's final state after `bp_update`, at
    rank 16 cold and warm and at rank 24 with a power iteration and
    `split=True` (`bench.py:315-343`), beside BP's; wall times, peak memory,
    library calls, host-to-device sketch bytes and one torch.profiler
    window of the rank-16 call.  Returns ({"8c bmps": launches}, the warm
    rank-16 call's {vertex: <Z>} at the probe vertices, for 13e)."""
    from torch.profiler import ProfilerActivity, profile

    from tnqs_torch.bmps_engine import BMPSEngine, cpu_sketch

    center, bench_v = probe[0], probe[1]
    verts = [center, bench_v]
    z_bp = checked_z("8c BP", eng.expect_1site("Z"), verts)
    plain_before = reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs, raw = {}, {}
    for label, rank, kw in (("rank 16 cold", 16, {}), ("rank 16 warm", 16, {}),
                            ("rank 24 power_iters=1 split", 24, dict(split=True))):
        be = BMPSEngine(eng, rank=rank, power_iters=1)
        calls0 = bmps_library_calls()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zc = be.expect_1site("Z", vertices=verts, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = np.subtract(bmps_library_calls(), calls0)
        print(f"8c {label}: <Z>{center} {zc[center]:+.7f}, <Z>{bench_v} {zc[bench_v]:+.7f}, {wall:.3f} s, library "
              f"eigh {calls[0]} SVD {calls[1]}, sketches {be.sketch_bytes} bytes host to device", flush=True)
        # the sketched zip truncates the doubled (ket x bra) layer without
        # keeping its ket <-> bra symmetry, so <Z> carries an imaginary part
        # of the truncation's size (1.04e-4 at rank 16 on the normalized
        # state, where rank 16 and 24 differ by ~3e-4): 1e-3 |Re| holds that
        # class and still catches a conjugation fault
        runs[label] = z = checked_z(f"8c {label}", zc, verts, im_rel=1e-3)
        raw[label] = zc
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    z16, z24 = runs["rank 16 warm"], runs["rank 24 power_iters=1 split"]
    d = max(abs(z16[v] - z24[v]) for v in verts)
    print(f"8c: BP <Z> {z_bp[center]:+.7f}, {z_bp[bench_v]:+.7f}; |z16 - z24| {d:.3e} (bound 1e-2); |z16 - BP| "
          f"{max(abs(z16[v] - z_bp[v]) for v in verts):.3e}; cold - warm "
          f"{max(abs(runs['rank 16 cold'][v] - z16[v]) for v in verts):.3e}; peak memory above the state "
          f"{peak:.3f} GiB")
    require(d <= 1e-2, f"8c: rank 16 and rank 24 differ by {d:.3e}")
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], f"8c: a kernel ran inside BMPS: {counts[0]}")

    def timed_sketch(code, shape):  # the default draw, its host time summed
        t = time.perf_counter()
        omega = cpu_sketch(7, code, shape)
        timed_sketch.seconds += time.perf_counter() - t
        return omega

    timed_sketch.seconds = 0.0
    be = BMPSEngine(eng, rank=16, power_iters=1, sketch=timed_sketch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.expect_1site("Z", vertices=verts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_times(prof)
    busy = sum(ms for ms, _ in kernels.values())
    print(f"8c profile window, one rank-16 call (torch.profiler): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall_ms:.4f}, {sum(n for _, n in kernels.values())} kernel launches; the host "
          f"drew the sketches in {1e3 * timed_sketch.seconds:.3f} ms")
    for (ms, n), k in sorted(((v, k) for k, v in kernels.items()), reverse=True)[:8]:
        print(f"  {ms:9.3f} ms {n:5d}x ({100 * ms / max(busy, 1e-9):4.1f}%) {k[:110]}")
    return {"8c bmps": counts[0]}, raw["rank 16 warm"]


def measure_wide(dev, label, chi, discarded, cap_s, xla_cap_s, full_layers=0):
    """8d (chi=96) and 8e (chi=128): Eagle-127 from "↑" at `chi`, complex64,
    default switches, up to 8 layers within `cap_s`.  Every theta the
    kernels hold (smaller side even, 64..256) takes K2 then K1, none the
    library SVD (`_svd_fallback`, counted by shape), and K1 and K2 launch at
    n = 2 chi; no plain version runs; every layer is finite.  On the layers
    where the chi=64 main path discarded no more than the cutoff
    (`discarded`, its largest per layer) both runs are the same physics:
    there <Z> must lie within the main path's bound of flex-f64.  Then the
    same layers on the library route (`svd_impl="xla"`, as many as fit
    `xla_cap_s`, at least 2), each within the main bound of this run.  With
    `full_layers`, that many more layers under `trunc_method="full"` from
    this run's last state, K2 at n = 2 chi on their Grams, within the 1e-2
    envelope of flex-f64 (`tests/test_f32_floor.py:119-129`).  Between the
    two, a torch.profiler window over one more layer from a copy of the
    kernels' run's last state."""
    from tnqs_torch.engine import _svd_fallback
    from tnqs_torch.ops.osj import pjsvd_fits

    controls = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["chi64"]
    cfg = controls["config"]
    center, bench_v = tuple(cfg["center"]), tuple(cfg["bench_vertex"])
    floors = np.max([controls["f32_floor_per_layer"]]
                    + [sd["dev_from_f64_per_layer"] for sd in controls["multiseed_controls"]["seeds"].values()], axis=0)
    bound = np.maximum(3.0 * np.maximum.accumulate(floors), 2e-5)
    refs = {center: controls["z_center_f64"], bench_v: controls["z_bench_f64"]}
    n = 2 * chi
    _svd_fallback.calls_by_shape.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, step, zs, devs, times, counts = evolve_eagle(dev, f"{label} c64 chi={chi}", chi, torch.complex64, 8, refs,
                                                      cfg["cutoff"], time_cap=cap_s, min_layers=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    routed = dict(sorted(_svd_fallback.calls_by_shape.items()))
    held = {shape: c for shape, c in routed.items() if min(shape[1:]) >= 64 and pjsvd_fits(max(shape[1:]),
                                                                                            min(shape[1:]))}
    by_path = {label: counts[0]}
    ms = 1e3 * np.mean(times[1:] or times)
    print(f"{label}: {ms:.1f} ms a layer over layers 2-{len(times)}, peak {peak:.3f} GiB; K2 by [B, n] {counts[1]}; "
          f"K1 launches {counts[0]['osj_svd']}, at n={n}: {counts[0][f'osj_svd n={n}']}; thetas to the library SVD "
          f"by [B, m, n]: {routed}")
    require(not held, f"{label}: thetas the kernels hold took the library SVD: {held}")
    require(counts[0][f"jacobi_eigh_res n={n}"] > 0 and counts[0][f"osj_svd n={n}"] > 0,
            f"{label}: K1 or K2 not launched at n = {n}: {counts[0]}")
    require(not counts[3], f"{label}: a plain kernel version ran on the card")
    same = [li for li in range(len(devs)) if li < len(discarded) and discarded[li] <= cfg["cutoff"]]
    for li in same:
        print(f"{label} layer {li + 1}: |dev| {devs[li]:.3e}, bound {bound[li]:.3e} (chi=64 discarded "
              f"{discarded[li]:.3e})")
        require(devs[li] <= bound[li], f"{label}: layer {li + 1} deviates {devs[li]:.3e} from flex-f64")
    print(f"{label}: {len(times)} layers, all finite; {len(same)} of them gated against flex-f64")
    state = ({k: v.cpu().numpy() for k, v in eng.T.items()}, eng.M.cpu().numpy())
    print(f"{label}: one more layer at chi={chi} under the profiler:")
    profile_window(eng, step, layers=1)
    del eng, step

    # the library route on the same layers
    _, _, zs_x, _, times_x, counts_x = evolve_eagle(dev, f"{label} svd_impl=xla chi={chi}", chi, torch.complex64,
                                                    len(times), refs, cfg["cutoff"], time_cap=xla_cap_s,
                                                    min_layers=2, svd_impl="xla")
    require(counts_x[0]["osj_svd"] == 0 and counts_x[0]["jacobi_eigh"] == 0,
            f"{label} xla: launches {counts_x[0]}")
    for li in range(len(zs_x)):
        d = float(np.max(np.abs(zs[li] - zs_x[li])))
        print(f"{label} layer {li + 1}: kernels - library SVD {d:.3e} (bound {bound[li]:.3e})")
        require(d <= bound[li], f"{label}: layer {li + 1}: the kernels' and the library's <Z> differ by {d:.3e}")
    print(f"{label}: {ms:.1f} ms a layer on K1/K2 against {1e3 * np.mean(times_x[1:] or times_x):.1f} on the "
          f"library SVD (layers 2-{len(times_x)})", flush=True)
    by_path[f"{label} xla"] = counts_x[0]

    if full_layers:
        first = len(times)
        envelope = np.full(cfg["layers"], 1e-2)
        fr = {v: vals[first:] for v, vals in refs.items()}
        *_, fdevs, ftimes, fcounts = evolve_eagle(dev, f"{label} trunc full chi={chi} (layers {first + 1}-"
                                                  f"{first + full_layers})", chi, torch.complex64, full_layers, fr,
                                                  cfg["cutoff"], gate=envelope[first:], state=state,
                                                  trunc_method="full")
        wide = sorted(shape for shape in fcounts[1] if shape[1] == n)
        print(f"{label} trunc full: K2 at n={n}: {wide}, library eigh calls {fcounts[2]}, "
              f"{1e3 * np.mean(ftimes):.1f} ms a layer, max |dev| {max(fdevs):.3e}")
        require(wide, f"{label} trunc full: K2 not launched at n = {n}")
        require(not fcounts[3], f"{label} trunc full: a plain version ran on the card")
        by_path[f"{label} full"] = fcounts[0]
    return by_path


# ----------------------------------------------------------------------
# phase 9: certified sampling
# ----------------------------------------------------------------------

SAMPLE_CAP_S = 15.0  # 9d draws the most samples, up to 50, whose groups fit this


def sample_stats(label, out):
    """(p/q array, mean, relative std) of a sampler call's dicts, each p/q
    finite and > 0 and each bit 0 or 1, log q <= 0 and the norm estimate
    finite and > 0."""
    pq = np.array([o["poverq"] for o in out])
    require(np.all(np.isfinite(pq)) and np.all(pq > 0), f"{label}: p/q not finite and positive: {pq}")
    require(all(b in (0, 1) for o in out for b in o["bitstring"].values()), f"{label}: a bit outside {{0, 1}}")
    require(all(o["logq"] <= 0 for o in out), f"{label}: log q > 0")
    n_hat = out[0]["norm_estimate"]
    require(np.isfinite(n_hat) and n_hat > 0, f"{label}: norm estimate {n_hat}")
    return pq, float(pq.mean()), float(pq.std() / pq.mean())


def same_draws(label, a, b, rel=1e-4):
    """The same bitstrings, and p/q within `rel` (another group width may
    round differently in cuBLAS); returns the largest relative difference."""
    require(all(x["bitstring"] == y["bitstring"] for x, y in zip(a, b)), f"{label}: the bitstrings differ")
    d = max(abs(x["poverq"] - y["poverq"]) / abs(y["poverq"]) for x, y in zip(a, b))
    require(d <= rel, f"{label}: p/q differs by {d:.3e} relative (bound {rel:.0e})")
    return d


W2_REPEAT = 20  # 9a's samples of seed 1 drawn again in groups of 10, and with the library SVDs timed


def sample_w2(dev, eng):
    """9a: bench's w2 sampler (`bench.py:446-452`) on 8a's Eagle chi=8 state:
    50 factored samples with seed 0 cold, 50 with seed 1 timed, gated as
    `tests/test_f32_floor.py:231-232` gates the committed run, the first
    `W2_REPEAT` of seed 1 again in groups of 10; 9b: the first 10 of seed 1 on a CPU engine carried over
    by `from_arrays`; 9c: 8 independently certified samples.  Returns the
    launches of 9a and 9c."""
    from tnqs_torch.bmps_engine import BMPSEngine, BMPSSampler
    from tnqs_torch.engine import LatticeEngine

    floor = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["w2"]["pq_rel_std_f64"]
    kw = dict(rank=10, oversample=8, power_iters=3)
    plain_before = reset_counts()
    calls0 = bmps_library_calls()
    sam = BMPSSampler(BMPSEngine(eng, **kw), proj_rank=12, q_mode="factored")
    times = {}
    for seed in (0, 1):
        sync(dev)
        t0 = time.perf_counter()
        out = sam.sample_directly_certified(50, seed=seed)
        times[seed] = time.perf_counter() - t0
        pq, mean, rel_std = sample_stats(f"9a seed {seed}", out)
        print(f"9a w2 seed {seed} ({'cold' if seed == 0 else 'warm'}): 50 factored samples in {times[seed]:.3f} s, "
              f"pq_mean {mean:.7f}, pq_rel_std {rel_std:.4e} (flex-f64 floor {floor:.2e}), pq_min {pq.min():.7f}, "
              f"pq_max {pq.max():.7f}", flush=True)
        require(abs(mean - 1) < 0.1 and pq.min() > 0.5, f"9a: pq_mean {mean}, pq_min {pq.min()}")
    calls = np.subtract(bmps_library_calls(), calls0)
    require(sam.bmps.sketch_bytes == 0, "9a: an emit drew a sketch at chi=8")
    sync(dev)
    t0 = time.perf_counter()
    chunked = sam.sample_directly_certified(W2_REPEAT, seed=1, chunk=10)
    t_chunk = time.perf_counter() - t0
    d = same_draws("9a chunk=10", chunked, out[:W2_REPEAT])
    print(f"9a: every emit an exact SVD (no sketch), library eigh {calls[0]} SVD {calls[1]} in the two calls; "
          f"the first {W2_REPEAT} in groups of 10: {t_chunk:.3f} s, the same bits, p/q within {d:.3e}")
    svd_s, wall = timed_library_svd(lambda: sam.sample_directly_certified(W2_REPEAT, seed=1))
    print(f"9a: one {W2_REPEAT}-sample call with each library SVD synchronised and timed: {wall:.3f} s, {svd_s:.3f} s "
          f"of it in the SVDs (cuSOLVER's gesvd takes a batch one matrix at a time)")
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], f"9a: a kernel or its plain version ran: {counts[0]}")
    by_path = {"9a": counts[0]}

    cpu = LatticeEngine.from_arrays(eng.plan.graph, *eng.to_arrays(), chi=eng.chi, device="cpu",
                                    bp_schedule=eng.plan.bp_schedule)
    t0 = time.perf_counter()
    on_cpu = BMPSSampler(BMPSEngine(cpu, **kw), proj_rank=12, q_mode="factored").sample_directly_certified(10, seed=1)
    t_cpu = time.perf_counter() - t0
    # held against the card's first group of 10, which contracts in the
    # same order (the group width sets the per-lane budget, and so the
    # chunking); beside it the difference from the 50-lane call
    d = same_draws("9b card vs CPU", on_cpu, chunked[:10])
    d50 = max(abs(x["poverq"] - y["poverq"]) / abs(y["poverq"]) for x, y in zip(on_cpu, out[:10]))
    print(f"9b: 10 samples on the CPU in {t_cpu:.3f} s: the card's bits, p/q within {d:.3e} of the card's group of "
          f"10 ({d50:.3e} of its 50-lane call)")

    plain_before = reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    cert = sam.sample_certified(8, seed=2, cert_rank=12)
    t_cert = time.perf_counter() - t0
    pq = np.array([o["poverq"] for o in cert])
    ratio = pq / np.array([o["poverq_direct"] for o in cert])
    print(f"9c: 8 independently certified samples (cert_rank 12) in {t_cert:.3f} s, mean p/q {pq.mean():.7f}; "
          f"p/q over the draw's: {' '.join(f'{r:.6f}' for r in ratio)}")
    require(np.all(np.isfinite(pq)) and np.all(pq > 0), f"9c: certificates {pq}")
    require(abs(pq.mean() - 1) < 0.1, f"9c: mean certificate {pq.mean()}")
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], f"9c: a kernel or its plain version ran: {counts[0]}")
    by_path["9c"] = counts[0]
    return by_path


def sample_chi64(dev, eng):
    """9d: bench's chi=64 sampler (`bench.py:365-368`, `BMPSEngine(rank=8)`,
    proj_rank 16, groups of 2) on the main path's state after
    `bp_update`: one two-lane call cold, then as many samples as
    SAMPLE_CAP_S allows at that rate (4 to 50) with seed 1, whose first two
    must be the cold call's; p/q, seconds a sample, peak memory, library
    calls, sketch bytes a call, and one torch.profiler window of a group.
    Returns ({"9d": launches}, the cold call's two samples, for 13f)."""
    from tnqs_torch.bmps_engine import BMPSEngine, BMPSSampler, cpu_uniforms

    plain_before = reset_counts()
    sam = BMPSSampler(BMPSEngine(eng, rank=8), proj_rank=16)
    be = sam.bmps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    calls0, bytes0 = bmps_library_calls(), be.sketch_bytes
    t0 = time.perf_counter()
    first = sam.sample_directly_certified(2, seed=1, chunk=2)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    calls = np.subtract(bmps_library_calls(), calls0)
    bytes_cold = be.sketch_bytes - bytes0
    sample_stats("9d cold", first)
    n = int(min(50, max(4, 2 * int(SAMPLE_CAP_S // t_cold))))
    print(f"9d chi=64: one two-lane call cold (norm boundaries + one group) {t_cold:.3f} s, peak memory above the "
          f"state {peak:.3f} GiB, library eigh {calls[0]} SVD {calls[1]}, sketches {bytes_cold} bytes host to device; "
          f"{n} samples fit {SAMPLE_CAP_S:.0f} s", flush=True)
    calls0, bytes0 = bmps_library_calls(), be.sketch_bytes
    t0 = time.perf_counter()
    out = sam.sample_directly_certified(n, seed=1, chunk=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = np.subtract(bmps_library_calls(), calls0)
    pq, mean, rel_std = sample_stats("9d", out)
    d = same_draws("9d first two lanes", out[:2], first)
    print(f"9d: {n} samples in {wall:.3f} s ({wall / n:.3f} s a sample), pq_mean {mean:.7f}, pq_rel_std "
          f"{rel_std:.4e}, pq_min {pq.min():.7f}, pq_max {pq.max():.7f}, norm_estimate {out[0]['norm_estimate']:.7e}; "
          f"library eigh {calls[0]} SVD {calls[1]}, sketches {be.sketch_bytes - bytes0} bytes host to device "
          f"(the cold 2-sample call {bytes_cold}); first two as the cold call's, p/q within {d:.3e}", flush=True)
    require(be.sketch_bytes - bytes0 == bytes_cold, "9d: the sketches were not drawn once per call")
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], f"9d: a kernel or its plain version ran: {counts[0]}")

    u = torch.stack([cpu_uniforms(3, s, len(sam.keys_order)) for s in range(2)]).to(dev)
    with be.sketches_cached():
        norm = sam._norm()
        sam._group(norm, u, sam._lane_budget(2))  # draws the folds outside the window
        profiled("9d profile window, one two-lane group", lambda: sam._group(norm, u, sam._lane_budget(2)))
    return {"9d": counts[0]}, first


def timed_library_svd(fn):
    """(seconds inside the BMPS tier's library SVDs, wall seconds) of fn(),
    each SVD synchronised before and after."""
    from tnqs_torch import bmps_engine

    orig = bmps_engine.library_svd

    def timed(A):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(A)
        torch.cuda.synchronize()
        timed.seconds += time.perf_counter() - t
        return out

    timed.seconds = 0.0
    bmps_engine.library_svd = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return timed.seconds, time.perf_counter() - t0
    finally:
        bmps_engine.library_svd = orig


def profiled(label, fn):
    """One torch.profiler window over fn(): wall time, device busy time,
    idle share and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_times(prof)
    busy = sum(ms for ms, _ in kernels.values())
    print(f"{label} (torch.profiler): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.4f}, {sum(c for _, c in kernels.values())} kernel launches")
    for (ms, c), k in sorted(((v, k) for k, v in kernels.items()), reverse=True)[:8]:
        print(f"  {ms:9.3f} ms {c:5d}x ({100 * ms / max(busy, 1e-9):4.1f}%) {k[:110]}")


def evolutions_launched(by_path):
    """K1, K2 and K3 ran in the chi=64 evolution (phase 5) and K3 in the w2
    one (8a), whose states phase 9 samples; K1 and K2 take no chi=8 theta
    (16 wide, below `pjsvd_fits`)."""
    require(all(by_path["5"][k] for k in ("jacobi_eigh", "osj_svd", "bp_sweep_group")),
            f"phase 5 launched {by_path['5']}")
    require(by_path["8a"]["bp_sweep_group"] > 0, f"8a launched {by_path['8a']}")


# ----------------------------------------------------------------------
# phase 10: the engine's remainder
# ----------------------------------------------------------------------

CKPT_LAYER = 5  # 10a saves the main path at this layer and resumes from it


def eagle_circuit(g):
    import tnqs_torch

    return tnqs_torch.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4)


def resume_checkpoint(dev, path, trajectory, layers):
    """10a: the main path's engine saved after layer CKPT_LAYER, loaded into
    a fresh engine on the card, run to the last layer: T and M bit for bit
    the uninterrupted run's; the file loaded on the CPU: the same arrays."""
    from tnqs_torch import checkpoint

    zs, (T_end, M_end), *_ = trajectory
    plain_before = reset_counts()
    t0 = time.perf_counter()
    eng = checkpoint.load_engine(path, device=dev)
    load_s = time.perf_counter() - t0
    require(eng.device.type == "cuda" and eng.bp_kernel == "kernel" and eng.plan.bp_schedule == "color",
            f"10a: restored on {eng.device}, {eng.bp_kernel}, {eng.plan.bp_schedule}")
    cpu = checkpoint.load_engine(path, device="cpu")
    same_cpu = all(torch.equal(cpu.T[k], eng.T[k].cpu()) for k in eng.T) and torch.equal(cpu.M, eng.M.cpu())
    require(same_cpu, "10a: the CPU round trip changed the arrays")
    step = eng.make_step(eagle_circuit(eng.plan.graph), cutoff=1e-12, bp_maxiter=25)
    dz = []
    for li in range(CKPT_LAYER, layers):
        eng.T, eng.M, _ = step(eng.T, eng.M)
        z = eng.expect_1site("Z")
        dz.append(max(abs(z[v].real - ref) for v, ref in zip(((7, 8), (11, 5)), zs[li])))
    print(f"10a: resumed <Z> - the main path's, layers {CKPT_LAYER + 1}-{layers}: {dz}")
    same = all(np.array_equal(eng.T[k].cpu().numpy(), T_end[k]) for k in T_end) and np.array_equal(
        eng.M.cpu().numpy(), M_end)
    counts = read_counts(plain_before)
    print(f"10a: checkpoint at layer {CKPT_LAYER} ({pathlib.Path(path).stat().st_size / 2**20:.1f} MiB npz), "
          f"load_engine {load_s:.3f} s; layers {CKPT_LAYER + 1}-{layers} resumed: T and M bit for bit the main "
          f"path's: {same}; load_engine(device='cpu') the same arrays: {same_cpu}; launches {counts[0]}")
    require(same, "10a: the resumed run is not bit for bit the uninterrupted one")
    require(not counts[3], "10a: a plain kernel version ran on the card")
    return {"10a": counts[0]}


def ladder_run(dev, bound_main, layers, chi=64, rungs=(8, 16, 32, 64)):
    """10b: `evolve_ladder` from "↑", rungs (8, 16, 32, 64), every layer
    within the main path's bound of flex-f64, K3 launches by chi."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import bp_sweep

    controls = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["chi64"]
    eng = LatticeEngine(tnqs_torch.eagle_lattice(), chi=chi, device=dev)
    seen = []

    def observe(layer, e):
        z = e.expect_1site("Z")
        dev_l = max(abs(z[(7, 8)].real - controls["z_center_f64"][layer - 1]),
                    abs(z[(11, 5)].real - controls["z_bench_f64"][layer - 1]))
        seen.append((layer, e.chi, dev_l))
        print(f"10b ladder layer {layer}: chi={e.chi}  Z(7, 8)={z[(7, 8)].real:+.7f}  Z(11, 5)={z[(11, 5)].real:+.7f}  "
              f"|dev| {dev_l:.3e} (bound {bound_main[layer - 1]:.3e})", flush=True)
        require(np.isfinite(dev_l) and dev_l <= bound_main[layer - 1], f"10b: layer {layer} deviation {dev_l:.3e}")

    plain_before = reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    out, errors = eng.evolve_ladder(eagle_circuit(eng.plan.graph), layers, rungs=rungs, observe=observe,
                                    cutoff=1e-12, bp_maxiter=25)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts(plain_before)
    by_chi = {}
    for (mode, k, chi, B), n in bp_sweep.bp_sweep_group.launches_by_shape.items():
        by_chi[chi] = by_chi.get(chi, 0) + n
    print(f"10b: {layers} layers in {wall:.3f} s on rungs {[c for _, c, _ in seen]}; K3 launches by chi {by_chi}; "
          f"launches {counts[0]}; max discarded weight {errors.max():.3e}")
    require(out.chi == chi and np.isfinite(errors).all(), f"10b: the ladder did not end at chi={chi} finite")
    require(all(by_chi.get(c, 0) > 0 for c in rungs), f"10b: K3 not launched at every rung: {by_chi}")
    require(not counts[3], "10b: a plain kernel version ran on the card")
    return {"10b": counts[0]}


def precision_high_run(dev, trajectory, bound_main, layers, chi=64):
    """10c: `bp_precision="high"` from "↑": every K3 launch bf16_3x, every
    layer within the main bound and <Z>(7,8), <Z>(11,5) within 1e-5 of the
    "highest" trajectory (phase 5), the JAX contract (`tnqs/engine.py:672`);
    then one BP sweep on each route, timed."""
    zs_main = trajectory[0]
    controls = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["chi64"]
    refs = {(7, 8): controls["z_center_f64"], (11, 5): controls["z_bench_f64"]}
    torch.cuda.reset_peak_memory_stats()
    eng, step, zs, devs, times, counts = evolve_eagle(dev, f"10c bp_precision=high c64 chi={chi}", chi,
                                                      torch.complex64, layers, refs, 1e-12, gate=bound_main,
                                                      bp_precision="high")
    print(f"10c: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (phase 5's, \"highest\", "
          f"is printed there)")
    d_main = np.abs(zs - zs_main[:len(zs)]).max(axis=1)
    print(f"10c: |<Z> - the highest trajectory| by layer {[f'{x:.2e}' for x in d_main]} (bound 1e-5); "
          f"{1e3 * np.mean(times[1:]):.1f} ms a layer (phase 5's rate is host-bound; no claim)")
    require(d_main.max() <= 1e-5, f"10c: bp_precision='high' left the highest trajectory by {d_main.max():.3e}")
    c = counts[0]
    require(c["bp_sweep_group_bf16_3x"] > 0 and c["bp_sweep_group"] == 0 and not counts[3]
            and c["bf16_3x wgmma"] == c["bp_sweep_group_bf16_3x"] and c["bp_split_planes"] > 0,
            f"10c: K3 launches {c} (every one must be bf16_3x on the tensor cores, the split made, no plain run)")
    # one sweep as the engine pays for it: on 10c's traffic a BP run is
    # about one sweep (80 splits for 287 K3 launches, ~7 groups a sweep),
    # so each turn makes T's split (`_bp_splits`, {} off "high") as
    # `_bp_fixed_point` does once a run
    T = {k: v.contiguous() for k, v in eng.T.items()}
    sweep = {}
    for route in ("bf16_3x", "highest", "einsum", "einsum", "highest", "bf16_3x") * 2:
        eng.bp_precision = "high" if route == "bf16_3x" else None
        sweep.setdefault(route, []).append(
            round(cuda_ms(lambda: eng._bp_new_messages(T, eng.M, route != "einsum", eng._bp_splits(T)), 5), 4))
    eng.bp_precision = "high"
    splits = eng._bp_splits(T)
    split_ms = cuda_ms(lambda: eng._bp_splits(T), 5)
    print(f"10c: one BP run of one sweep of the Eagle chi=64 color plan, T's split included, ms (in turns): K3 "
          f"bf16_3x {sweep['bf16_3x']}, K3 FP32 {sweep['highest']}, einsum route {sweep['einsum']}; bf16_3x / FP32 "
          f"{sum(sweep['bf16_3x']) / sum(sweep['highest']):.3f} (of the medians "
          f"{median(sweep['bf16_3x']) / median(sweep['highest']):.3f}); of it the split of T {split_ms:.4f} ms "
          f"({sum(v.planes.numel() * 2 for v in splits.values()) / 2**30:.3f} GiB)")
    return {"10c": counts[0]}


def z_bp_and_loops(eng, size):
    sync(eng.device)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    z = eng.loopcorrected_partitionfunction(size)
    sync(eng.device)
    wall = time.perf_counter() - t0
    return z, eng.partitionfunction(), wall, (torch.cuda.max_memory_allocated() - base) / 2**30


def loop_corrections(dev, state_main, state_w2):
    """10d: `loopcorrected_partitionfunction(12)` on the main path's state
    after `bp_update` (the 18 heavy-hex plaquettes, 4096 x 4096 doubled
    transfer matrices), on 8a's chi=8 state on the card and on the CPU, and
    the analytic anchor: a random 6-ring at chi=3, complex128, where the
    series truncated at the ring is exact."""
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine

    g = tnqs_torch.eagle_lattice()
    plain_before = reset_counts()
    eng = LatticeEngine.from_arrays(g, *state_main, chi=state_main[1].shape[-1], device=dev)
    z, z_bp, wall, peak = z_bp_and_loops(eng, 12)
    by_len, others = eng._loopcorr_cache[12]
    n_cfg = sum(len(v) for v in by_len.values()) + len(others)
    shift = abs(z - z_bp) / abs(z_bp)
    print(f"10d chi={eng.chi}: {n_cfg} configurations (cycles by length {({L: len(c) for L, c in by_len.items()})}, "
          f"{len(others)} others), Z_BP {z_bp}, loop-corrected {z}, relative shift {shift:.3e}; {wall:.3f} s, peak "
          f"{peak:.3f} GiB above the state")
    require(n_cfg == 18 == g.ne() - g.nv() + 1 and not others, f"10d: {n_cfg} configurations at size 12")
    require(np.isfinite(z) and np.isfinite(z_bp), "10d: non-finite loop-corrected Z")
    del eng

    e8 = LatticeEngine.from_arrays(g, *state_w2, chi=state_w2[1].shape[-1], device=dev)
    z8, z8_bp, wall8, _ = z_bp_and_loops(e8, 12)
    cpu = LatticeEngine.from_arrays(g, *state_w2, chi=e8.chi, device="cpu", bp_schedule=e8.plan.bp_schedule)
    t0 = time.perf_counter()
    z8_cpu = cpu.loopcorrected_partitionfunction(12)
    cpu_s = time.perf_counter() - t0
    z8_cpu_bp = cpu.partitionfunction()
    # Z = Z_BP (1 + sum w).  Z_BP of this unnormalized state is exp of 271
    # logs near -270, each vertex and edge scalar a complex64 contraction:
    # card and CPU differ there by the float32 class of phase 9b (~1e-4);
    # the loop series' own factor 1 + sum w is held to 1e-6
    rel8 = abs(z8 / z8_bp - z8_cpu / z8_cpu_bp) / abs(z8_cpu / z8_cpu_bp)
    print(f"10d chi=8 (8a's state): card {z8} ({wall8:.3f} s), CPU {z8_cpu} ({cpu_s:.3f} s); Z / Z_BP card "
          f"{z8 / z8_bp:.9f}, CPU {z8_cpu / z8_cpu_bp:.9f}, relative difference {rel8:.3e} (bound 1e-6); Z card - CPU "
          f"{abs(z8 - z8_cpu) / abs(z8_cpu):.3e} relative, Z_BP card - CPU {abs(z8_bp - z8_cpu_bp) / abs(z8_cpu_bp):.3e}")
    require(rel8 <= 1e-6, f"10d: chi=8 card and CPU loop factors differ by {rel8:.3e}")

    # the ring anchor: exact <psi|psi> is the trace of the ring of doubled
    # site tensors, contracted here in numpy from the plan's axis order
    ring = tnqs_torch.named_ring_graph(6)
    rng = np.random.default_rng(9)
    proto = LatticeEngine(ring, 3, dtype=torch.complex128, device="cpu", bp_schedule="wavefront")
    T = {k: rng.normal(size=v.shape) + 1j * rng.normal(size=v.shape) for k, v in proto.T.items()}
    # the wavefront schedule of the JAX anchor (`tests/test_engine.py:384`, on
    # the CPU), converged until eps stops falling: the series is exact only
    # at the fixed point, and the color schedule stops ~2e-10 short of it at
    # the default complex128 tolerance (in the JAX engine as well)
    e6 = LatticeEngine.from_arrays(ring, T, proto.M.numpy(), chi=3, dtype=torch.complex128, device=dev,
                                   bp_schedule="wavefront")
    e6.bp_update(maxiter=80, tolerance=0.0)
    plan = e6.plan
    walk = list(range(1, 7))
    W = np.eye(9, dtype=complex)
    for i, v in enumerate(walk):
        k, pos = plan.bucket_pos[v]
        A = T[k][pos]
        a, b = plan.neighbor_order[v].index(walk[i - 1]), plan.neighbor_order[v].index(walk[(i + 1) % 6])
        A = np.moveaxis(A, (1 + a, 1 + b), (1, 2))
        W = W @ np.einsum("sab,sAB->aAbB", A, A.conj()).reshape(9, 9)
    z_ex = np.trace(W)
    z6, z6_bp, _, _ = z_bp_and_loops(e6, 6)
    rel6 = abs(z6 - z_ex) / abs(z_ex)
    print(f"10d ring anchor (6-ring, chi=3, complex128, {e6.bp_iterations} BP iterations): exact {z_ex}, Z_BP {z6_bp} "
          f"({abs(z6_bp - z_ex) / abs(z_ex):.3e} off), loop-corrected {z6}, relative {rel6:.3e} (bound 1e-12)")
    require(abs(z6_bp - z_ex) / abs(z_ex) > 1e-3 and rel6 <= 1e-12, f"10d: ring anchor {rel6:.3e}")
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], f"10d: a kernel ran in the loop corrections {counts[0]}")
    return {"10d": counts[0]}


# the JAX engine's largest CPU distance from golden_thermal.json's
# free_energy_density at chi=32, 25 steps, complex128 (printed by
# `python tests/torch_thermal_reference.py`)
JAX_THERMAL_DIST = 1.049161e-13


def busy_ms(prof):
    """Milliseconds in which at least one kernel ran in a torch.profiler
    window: the union of the kernels' spans, which V's kernel beside the
    iterate (a second stream) would otherwise count twice."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "CUDA" in str(e.device_type) and e.time_range.end > e.time_range.start)
    total, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return (total + (0.0 if end is None else end - start)) / 1e3


def thermal_breakdown(label, prof, wall_ms):
    """Device time by kernel of a torch.profiler window over thermal steps:
    K1's and K2's variants past n = 256, V's kernel, K3 and the top others,
    and the idle share of the window's wall time (the profiler's overhead
    included, so an upper bound)."""
    kernels = device_times(prof)
    busy = sum(ms for ms, _ in kernels.values())
    if busy == 0:
        print(f"10e {label}: torch.profiler saw no device time (wall {wall_ms:.3f} ms)")
        return
    union = busy_ms(prof)
    print(f"10e {label} (torch.profiler): wall {wall_ms:.3f} ms, kernels {busy:.3f} ms summed over both streams, "
          f"device busy {union:.3f} ms (their union), idle share {1 - union / wall_ms:.4f}")
    labels = (("K2 resident", ("jacobi_eigh_res_kernel",)), ("K2 L2", ("jacobi_eigh_l2_kernel",)),
              ("K1 resident", ("osj_svd_res_kernel",)), ("K1 L2", ("osj_svd_l2_kernel",)),
              ("V from the log, registers", ("rotation_log_regs_kernel",)),
              ("V from the log, slabs", ("rotation_log_kernel",)),
              ("V's follow gate", ("rotation_log_gate_kernel",)), ("K1 clusters", ("osj_svd_kernel",)),
              ("K2 n <= 128", ("jacobi_eigh_kernel",)),
              ("K3 bp_sweep_group", ("bp_mode_product", "bp_pass2", "bp_reduce")))
    for name, keys in labels:
        sel = [v for k, v in kernels.items() if any(key in k for key in keys)]
        ms, n = sum(v[0] for v in sel), sum(v[1] for v in sel)
        print(f"  {name}: {ms:.3f} ms in {n} launches ({100 * ms / busy:.1f}% of device time, "
              f"{100 * ms / wall_ms:.1f}% of the wall)")
    ours = [key for _, keys in labels for key in keys]
    others = sorted(((v, k) for k, v in kernels.items() if not any(key in k for key in ours)), reverse=True)
    for (ms, n), k in others[:6]:
        print(f"  {ms:9.3f} ms {n:5d}x ({100 * ms / busy:4.1f}%) {k[:110]}")


THERMAL_CPU_STEPS = 5  # 10e's complex128 steps on the CPU port, held to the card's (the card runs all 25; f is recorded every 5)


def thermal_run(label, chi, dtype, device, bp_precision=None, svd_impl="auto", profile_last=0, steps=None):
    """The thermal state of golden_thermal.json at bond `chi`, its `steps`
    steps (all of them by default); the last `profile_last` steps under
    torch.profiler (`thermal_breakdown`)."""
    import tnqs_torch
    from torch.profiler import ProfilerActivity, profile
    from tnqs_torch.engine import LatticeEngine

    gold = json.loads((ROOT / "tests" / "golden" / "golden_thermal.json").read_text())
    c = gold["config"]
    g = tnqs_torch.named_hexagonal_lattice_graph(2, 2, periodic=True)
    t0 = time.perf_counter()
    eng = LatticeEngine(g, chi, dtype=dtype, device=device, site_legs=2, state=tnqs_torch.identity_operator_vector(),
                        bp_precision=bp_precision, svd_impl=svd_impl)
    eng.bp_update(maxiter=30)
    step = eng.make_step(tnqs_torch.heisenberg_thermal_layer(g, c["J"], c["dbeta"]), cutoff=c["cutoff"],
                         normalize=False, bp_maxiter=30)
    logz = -eng.freenergy()
    eng.rescale()
    f = []
    prof = None
    steps = steps or c["steps"]
    for k in range(steps):
        if profile_last and k == steps - profile_last:
            sync(eng.device)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        eng.T, eng.M, _ = step(eng.T, eng.M)
        logz -= eng.freenergy()
        eng.rescale()
        f.append(float(np.real(logz) / g.nv()))
    sync(eng.device)
    if prof is not None:
        wall_ms = 1e3 * (time.perf_counter() - t_prof)
        prof.__exit__(None, None, None)
        thermal_breakdown(f"{label}, the last {profile_last} steps", prof, wall_ms)
    rec = np.array(f[c["record_every"] - 1:: c["record_every"]])
    htse = np.abs(rec - np.array(gold["htse_4th"][:len(rec)]))
    flex = np.abs(rec - np.array(gold["free_energy_density"][:len(rec)]))
    seconds = time.perf_counter() - t0
    print(f"10e {label}: {seconds:.3f} s, f at steps {c['record_every']}..{steps} {[f'{x:.10f}' for x in rec]}; "
          f"|f - HTSE 4th| max "
          f"{htse.max():.3e} (bound 2e-3); |f - golden free_energy_density| max {flex.max():.3e}", flush=True)
    require(np.isfinite(rec).all() and htse.max() < 2e-3, f"10e {label}: off the HTSE anchor")
    return rec, flex if chi == c["maxdim"] else None, seconds


def thermal_phase(dev, chi=32):
    """10e: the thermal state (`examples/hexagonal_heisenberg_thermalstate.py`,
    golden_thermal.json's configuration: chi=32, dbeta=0.01, 25 steps) at
    complex128 on the card (no float32 kernel) and on the CPU, and at
    complex64 on the card (K3 at d = 4, k = 3, chi=32) in both BP
    precisions, every saturated theta [4, 512, 512] through K2 then K1 (the
    L2 variants) and none through the library SVD, each recorded step within
    1e-5 of complex128; then complex64 on ``svd_impl="xla"`` (gesvd), its
    seconds and distance from complex128 beside the kernels'."""
    from tnqs_torch.engine import _svd_fallback
    from tnqs_torch.ops import bp_sweep, osj

    by_path = {}
    plain_before = reset_counts()
    f128, dist, _ = thermal_run("complex128, card", chi, torch.complex128, dev)
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], f"10e: complex128 launched {counts[0]}")
    f_cpu, _, _ = thermal_run("complex128, CPU port", chi, torch.complex128, "cpu", steps=THERMAL_CPU_STEPS)
    d_cpu = np.abs(f128[:len(f_cpu)] - f_cpu).max()
    print(f"10e: complex128 card - CPU over the first {THERMAL_CPU_STEPS} steps {d_cpu:.3e} (bound 1e-10)")
    require(d_cpu <= 1e-10, "10e: complex128 card and CPU differ")
    if dist is not None:  # golden_thermal.json's chi
        print(f"10e: complex128 card from the golden {dist.max():.3e}, the JAX engine's own CPU distance "
              f"{JAX_THERMAL_DIST:.3e} (bound that + the card-CPU bound 1e-10)")
        require(dist.max() <= JAX_THERMAL_DIST + 1e-10, "10e: complex128 off the golden")
    wide = 16 * chi  # the saturated thetas' side: (d chi) x d = 512 at d = 4, [4, 512, 512] a call
    seconds = {}
    for prec, svd_impl in ((None, "auto"), ("high", "auto"), (None, "xla")):
        label = f"complex64, card, bp_precision={prec}, svd_impl={svd_impl}"
        plain_before = reset_counts()
        fallback = dict(_svd_fallback.calls_by_shape)
        torch.cuda.reset_peak_memory_stats()
        f64, _, seconds[label] = thermal_run(label, chi, torch.complex64, dev, prec, svd_impl)
        print(f"10e {label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        counts = read_counts(plain_before)
        library = {k: v - fallback.get(k, 0) for k, v in _svd_fallback.calls_by_shape.items() if v > fallback.get(k, 0)}
        shapes = {key[:3] for key in bp_sweep.bp_sweep_group.launches_by_shape}
        d128 = np.abs(f64 - f128)
        print(f"10e {label}: - complex128 by recorded step {[f'{x:.3e}' for x in d128]}; K3 launches {counts[0]} at "
              f"(mode, k, chi) {sorted(shapes)}; K2 by [B, n] {counts[1]}; K1 by [B, R, n] "
              f"{dict(osj.osj_svd.launches_by_shape)}; library SVDs by shape {library}")
        mode = "bp_sweep_group_bf16_3x" if prec == "high" else "bp_sweep_group"
        require(counts[0][mode] > 0 and not counts[3] and all(key[1:] == (3, chi) for key in shapes),
                f"10e: complex64 launches {counts[0]}")
        if svd_impl == "xla":
            require(counts[0]["jacobi_eigh"] == 0 and counts[0]["osj_svd"] == 0, f"10e {label}: launched K1/K2")
            continue
        require(any(n == wide for _, n in counts[1]) and any(shape[1:] == (wide, wide)
                                                              for shape in osj.osj_svd.launches_by_shape)
                and not any(shape[1:] == (wide, wide) for shape in library),
                f"10e {label}: the [*, {wide}, {wide}] thetas did not all take K2 then K1")
        # the thetas' K2 and K1 on the resident variants, V from their logs
        require(counts[0]["jacobi_eigh resident"] > 0 and counts[0]["osj_svd resident"] > 0
                and counts[0]["rotation_log"] >= counts[0]["jacobi_eigh"] + counts[0]["osj_svd"],
                f"10e {label}: K1/K2 by layout and V's kernel {counts[0]}")
        require(d128.max() <= 1e-5, f"10e {label}: {d128.max():.3e} from complex128 (bound 1e-5)")
        by_path["10e" if prec is None else "10e high"] = counts[0]
    # where the steps' time goes once the thetas are saturated: two steps
    # under torch.profiler, on the kernels
    thermal_run("complex64, card, profiled", chi, torch.complex64, dev, profile_last=2)
    print("10e complex64 seconds (25 steps, BP included): "
          + "; ".join(f"{label.split('card, ')[1]}: {t:.3f} s" for label, t in seconds.items())
          + f" (the earlier design, V in the rounds, recorded in PERF.md, not measured in this run: "
            f"{EARLIER_THERMAL_S:.3f} s for bp_precision=None, auto)")
    return by_path


# ----------------------------------------------------------------------
# phase 11: the flex tier
# ----------------------------------------------------------------------

# The flex BMPS sampler's p/q at a truncating rank depends on the basis the
# fitting's QR gives the null space of its rank-deficient start (JAX's
# own p/q moves by up to 4.5e-5 when 1e-15 relative noise enters its QR
# inputs: `python tests/torch_flex_noise_reference.py`), so the golden's
# p/q is reproducible to 1e-5 only by bit-identical arithmetic; held here
# to 1e-4, about twice that spread.  Bits and counts are held exactly.
FLEX_PQ_TOL = 1e-4


class SyncCounter:
    """Counts the host synchronizations of the CUDA work inside it
    (`torch.cuda.set_sync_debug_mode("warn")`, one warning each)."""

    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings(record=True)
        self._log = self._ctx.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)
        self.count = sum("synchroniz" in str(w.message) for w in self._log)
        return False


def flex_evolve(dev, g, layer, c, layers, gold=None):
    """`layers` kicked-Ising layers of the golden configuration by
    `apply_gates` on the flex tier from "↑" on `dev`: the cache, each
    layer's truncation errors and <Z> on every vertex (BP), ms and host
    syncs a layer."""
    import tnqs_torch as tt

    from tnqs_torch.core import linalg

    psi = tt.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex128, device=dev)
    bpc = tt.BeliefPropagationCache(psi)
    ak = dict(maxdim=c["maxdim"], cutoff=c["cutoff"], normalize_tensors=True)
    central = tuple(c["central"])
    errs, zs, ms, syncs = [], [], [], []
    for i in range(layers):
        t0 = time.perf_counter()
        if torch.device(dev).type == "cuda":
            reads = linalg.host_reads.count
            with SyncCounter() as sc:
                bpc, e = tt.apply_gates(layer, bpc, apply_kwargs=ak)
                sync(dev)
            syncs.append((sc.count, linalg.host_reads.count - reads))
        else:
            bpc, e = tt.apply_gates(layer, bpc, apply_kwargs=ak)
        ms.append(1e3 * (time.perf_counter() - t0))
        z = {v: tt.expect(bpc, ("Z", [v])) for v in ([central] if gold is not None else g.vertices())}
        errs.append(e)
        zs.append(z)
        if gold is not None:
            dfid = abs(float(np.prod(1.0 - e)) - gold["layer_fidelity"][i])
            dz = abs(float(np.real(z[central])) - gold["z_central"][i])
            require(dfid < 1e-5 and dz < 1e-5, f"11a: layer {i + 1} off the golden (fidelity {dfid:.3e}, <Z> "
                                               f"{dz:.3e})")
    return bpc, errs, zs, ms, syncs


def flex_phase(dev, state_main):
    """Phase 11: the flex tier on the card.  (a) the Eagle golden, 20 layers,
    then BMPS rank 10; (b) certified samples; (c) 2 layers card vs CPU at
    complex128; (d) golden_loopcorrections.json; (e) `to_state` /
    `to_bp_cache` of the main path's chi=64 engine and the state
    checkpoints.  Returns (a)'s evolved state, for 12b."""
    import tnqs_torch as tt
    from tnqs_torch.engine import LatticeEngine

    plain_before = reset_counts()
    gold = json.loads((ROOT / "tests" / "golden" / "golden_eagle127.json").read_text())
    c = gold["config"]
    g = tt.eagle_lattice()
    layer = tt.heavy_hex_kicked_ising_layer(g, c["J"], c["theta_h"])
    central = tuple(c["central"])

    # 11a: the golden, every layer within 1e-5, then BMPS rank 10
    t0 = time.perf_counter()
    bpc, _, _, ms, syncs = flex_evolve(dev, g, layer, c, c["layers"], gold)
    evolve_s = time.perf_counter() - t0
    print(f"11a: Eagle golden on the flex tier, {c['layers']} layers at chi={c['maxdim']}, complex128: every "
          f"layer_fidelity and z_central within 1e-5; {evolve_s:.3f} s with the per-layer <Z>; ms a layer "
          f"{[round(x, 1) for x in ms]} (mean {np.mean(ms[1:]):.1f} after the first); host syncs a layer, of "
          f"them singular-value reads of the truncation rule, {syncs} (mean {np.mean([x[0] for x in syncs]):.1f})",
          flush=True)
    psi_t = bpc.network
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with SyncCounter() as sc:
        zb = tt.expect(psi_t, [("Z", [central])], alg="boundarymps", mps_bond_dimension=c["mps_bond_dimension"])[0]
    bmps_s = time.perf_counter() - t0
    dzb = abs(float(np.real(zb)) - gold["z_bmps_central"])
    print(f"11a: BMPS rank {c['mps_bond_dimension']} <Z>{central} = {zb:.12f}, |dz| from the golden {dzb:.3e} "
          f"(bound 1e-5); {bmps_s:.3f} s, {sc.count} host syncs, peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB", flush=True)
    require(dzb < 1e-5, "11a: BMPS <Z> off the golden")

    # 11b: certified samples, the golden's seed and rank
    n = 4 if evolve_s <= 60 else 2
    t0 = time.perf_counter()
    cert = tt.sample_directly_certified(psi_t, n, alg="boundarymps", norm_mps_bond_dimension=c["mps_bond_dimension"],
                                        rng=np.random.default_rng(c["sample_seed"]))
    sample_s = time.perf_counter() - t0
    rows = []
    for got, want in zip(cert, gold["first4_samples"]):
        pq = float(np.real(got["poverq"]))
        rows.append((int(got["bitstring"][central]), int(sum(got["bitstring"].values())), pq, pq - want["poverq"]))
        require(rows[-1][0] == want["bits_central"] and rows[-1][1] == want["n_ones"],
                f"11b: sample {len(rows)} bits {rows[-1][:2]}, the golden's {want['bits_central'], want['n_ones']}")
        require(abs(rows[-1][3]) < FLEX_PQ_TOL, f"11b: sample {len(rows)} p/q off the golden by {rows[-1][3]:.3e}")
    print(f"11b: {n} samples ({'4' if n == 4 else '2: the evolution took over 60 s'}), (bit at {central}, ones, "
          f"p/q, p/q - golden) {rows} (bits exact, p/q bound {FLEX_PQ_TOL}); {sample_s:.3f} s, "
          f"{sample_s / n:.3f} s a sample", flush=True)
    del bpc, cert

    # 11c: 2 layers on the card and on the CPU port, complex128
    layers = 2
    _, e_card, z_card, _, _ = flex_evolve(dev, g, layer, c, layers)
    t0 = time.perf_counter()
    _, e_cpu, z_cpu, _, _ = flex_evolve("cpu", g, layer, c, layers)
    cpu_s = time.perf_counter() - t0
    de = max(float(np.abs(a - b).max()) for a, b in zip(e_card, e_cpu))
    dz = max(abs(a[v] - b[v]) for a, b in zip(z_card, z_cpu) for v in a)
    print(f"11c: {layers} layers, card vs CPU port (complex128): truncation errors {de:.3e}, BP <Z> on all 127 "
          f"vertices {dz:.3e} (bound 1e-10); CPU {cpu_s:.3f} s", flush=True)
    require(de < 1e-10 and dz < 1e-10, "11c: card and CPU port differ")

    # 11d: golden_loopcorrections.json on the card
    lgold = json.loads((ROOT / "tests" / "golden" / "golden_loopcorrections.json").read_text())
    rng = np.random.default_rng(lgold["config"]["seed"])
    for lg, name in [(tt.named_hexagonal_lattice_graph(2, 2), "hexagonal"), (tt.named_grid((4, 4)), "square")]:
        entry = lgold["lattices"][name]
        psi = tt.random_tensornetworkstate(lg, bond_dimension=lgold["config"]["chi"], rng=rng, dtype=np.float64,
                                           device=dev)
        psi = tt.normalize(psi, alg="bp")
        bp = complex(tt.norm_sqr(psi, alg="bp"))
        loop = complex(tt.norm_sqr(psi, alg="loopcorrections",
                                   max_configuration_size=entry["max_configuration_size"]))
        exact = complex(tt.norm_sqr(psi, alg="exact"))
        d = [abs(bp - complex(*entry["norm_bp"])), abs(loop - complex(*entry["norm_loop_corrected"])),
             abs(exact - complex(*entry["norm_exact"]))]
        print(f"11d: {name}: |bp|, |loop-corrected|, |exact| - golden {[f'{x:.3e}' for x in d]} (bound 1e-5); "
              f"|loop - exact| {abs(loop - exact):.3e} < |bp - exact| {abs(bp - exact):.3e}", flush=True)
        require(max(d) < 1e-5 and abs(loop - exact) < abs(bp - exact), f"11d: {name} off the golden")

    # 11e: the main path's chi=64 engine into the flex tier
    T, M = state_main
    eng = LatticeEngine.from_arrays(tt.eagle_lattice(), T, M, 64, device=dev)
    z_eng = eng.expect_1site("Z")
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fbpc = eng.to_bp_cache()
    z_flex = {v: tt.expect(fbpc, ("Z", [v])) for v in [(7, 8), (11, 5)]}
    flex_s = time.perf_counter() - t0
    dz = max(abs(z_flex[v] - z_eng[v]) for v in z_flex)
    print(f"11e: to_bp_cache of the chi=64 engine and flex BP <Z> at (7,8), (11,5) {[f'{z_flex[v].real:.8f}' for v in z_flex]}"
          f", engine {[f'{z_eng[v].real:.8f}' for v in z_flex]}, |dz| {dz:.3e} (bound 1e-5); {flex_s:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    require(dz < 1e-5, "11e: flex BP <Z> off the engine's")
    path = ROOT / "build" / "chip_smoke" / "flex_state.npz"
    psi = eng.to_state()
    tt.save_state(psi, path)
    back = tt.load_state(path, device=dev)
    same = all(torch.equal(psi[v].data, back[v].data) and [i.dim for i in psi[v].inds] == [i.dim for i in back[v].inds]
               for v in psi.vertices())
    path.unlink()
    print(f"11e: save_state / load_state of the chi=64 state bit for bit: {same}", flush=True)
    require(same, "11e: the state checkpoint changed the state")
    counts = read_counts(plain_before)
    print(f"11: kernel launches {counts[0]}, plain runs {counts[3]} (the flex tier reaches no kernel)", flush=True)
    require(not any(counts[0].values()) and not counts[3], "11: a kernel ran on the flex tier")
    return psi_t


# Phase 12: the variational BP-energy search, truncation and the full update
VAR_HAM = dict(J=1.0, h=3.0)  # TFIM, the example of docs/variational.md
VAR_BP_ITERS = 16
VAR_STEPS = 10
VAR_LR = 1e-5  # Adam moves every entry by ~lr a step, a small move beside the chi=64 state's entries
VAR_FD_STEP = 1e-2  # the central difference's step along a unit direction
TRUNC_MAXDIM = 4
TRUNC_MPS_RANK = 10
TRUNC_EXACT_RANK = 16  # 12c's 3x3 boundary MPS is exact at this rank (see tests/test_torch_truncate.py)
# With the symmetric gauge (`gauge_state=True`) the BMPS truncation depends on
# the phases the SVD library gives the gauge's singular vectors: up to 7.7e-11
# on the CPU under other phases (`python tests/torch_truncate_noise_reference.py`),
# and cuSOLVER's differ from LAPACK's; held to this, the rest to 1e-10
TRUNC_GAUGE_TOL = 2e-9


def energy_and_grad(eng, ham, bp_iters):
    """The BP energy of the engine's state and its gradient over the (real,
    imag) leaves, by `torch.autograd`."""
    from tnqs_torch import variational as var

    params = var._split(eng.T)
    for pair in params.values():
        for t in pair:
            t.requires_grad_(True)
    e = var.bp_energy_fn(eng, ham, bp_iters=bp_iters)(var._join(params, eng.dtype))
    e.backward()
    return e.detach(), params, {k: (re.grad, im.grad) for k, (re, im) in params.items()}


def variational_phase(dev, state_main):
    """12a: `minimize_energy` on a copy of the main path's chi=64 engine, with
    its checks (chi=16 complex128 card vs CPU; the chi=64 gradient against a
    central difference of the card's energy) and the profiling hooks."""
    import shutil

    import tnqs_torch as tt
    from tnqs_torch import variational as var
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.utils import profiling

    g = tt.eagle_lattice()
    ham = tt.tfim_hamiltonian(**VAR_HAM)

    # card against the CPU port at chi=16, complex128, the same arrays and BP schedule
    rng = np.random.default_rng(12)
    base = LatticeEngine(g, 16, dtype=torch.complex128, device="cpu", bp_schedule="color")
    T16 = {k: a.numpy() + 0.1 * (rng.standard_normal(a.shape) + 1j * rng.standard_normal(a.shape))
           for k, a in base.T.items()}
    got = {}
    for d in (dev, "cpu"):
        eng = LatticeEngine.from_arrays(g, T16, base.M.numpy(), 16, dtype=torch.complex128, device=d,
                                        bp_schedule="color")
        t0 = time.perf_counter()
        e, _, grads = energy_and_grad(eng, ham, VAR_BP_ITERS)
        sync(torch.device(d))
        got[str(d)] = (float(e), {k: (re.cpu(), im.cpu()) for k, (re, im) in grads.items()}, time.perf_counter() - t0)
    (e_card, g_card, s_card), (e_cpu, g_cpu, s_cpu) = got[str(dev)], got["cpu"]
    scale = max(float(x.abs().max()) for pair in g_cpu.values() for x in pair)
    dg = max(float((a - b).abs().max()) for k in g_cpu for a, b in zip(g_card[k], g_cpu[k]))
    de = abs(e_card - e_cpu) / abs(e_cpu)
    print(f"12a: chi=16 complex128 BP energy ({VAR_BP_ITERS} sweeps), card {e_card:.12f}, CPU port {e_cpu:.12f}: "
          f"relative {de:.3e} (bound 1e-10); gradient {dg:.3e} of its largest entry {scale:.3e} "
          f"({dg / scale:.3e}, bound 1e-8); energy and gradient {s_card:.3f} s on the card, {s_cpu:.3f} s on the CPU",
          flush=True)
    require(de < 1e-10 and dg <= 1e-8 * scale, "12a: the card's energy or gradient is off the CPU port's")

    # the chi=64 step-0 gradient against a central difference of the card's energy
    T, M = state_main
    chi = M.shape[-1]
    eng = LatticeEngine.from_arrays(g, T, M, chi, device=dev)
    e0, params, grads = energy_and_grad(eng, ham, VAR_BP_ITERS)
    rng = np.random.default_rng(1207)
    # a seeded direction weighted by the gradient (a random one over ~1e8
    # leaves is nearly orthogonal to it, below float32's resolution of E)
    direction = {k: tuple(gr * torch.as_tensor(1.0 + rng.standard_normal(tuple(gr.shape)).astype(np.float32),
                                               device=dev) for gr in pair) for k, pair in grads.items()}
    norm = float(torch.sqrt(sum((x.double() ** 2).sum() for pair in direction.values() for x in pair)))
    direction = {k: tuple(x / norm for x in pair) for k, pair in direction.items()}
    dd = float(sum((a.double() * b.double()).sum() for k in grads for a, b in zip(grads[k], direction[k])))
    efn = var.bp_energy_fn(eng, ham, bp_iters=VAR_BP_ITERS)
    with torch.no_grad():
        shifted = [float(efn(var._join({k: tuple(p + sgn * VAR_FD_STEP * d for p, d in zip(params[k], direction[k]))
                                        for k in params}, eng.dtype))) for sgn in (1, -1)]
    fd = (shifted[0] - shifted[1]) / (2 * VAR_FD_STEP)
    rel = abs(fd - dd) / abs(fd)
    print(f"12a: chi={chi} complex64 step-0 energy {float(e0):.6f}; directional derivative along a seeded direction: "
          f"autograd {dd:.6f}, central difference (step {VAR_FD_STEP}) {fd:.6f}, relative {rel:.3e} (bound 2e-2)",
          flush=True)
    require(np.isfinite(fd) and rel <= 2e-2, "12a: the gradient disagrees with the central difference")
    del eng, params, grads, direction, efn

    # the profiling hooks on the card: one energy evaluation traced
    log_dir = ROOT / "build" / "chip_smoke" / "trace12"
    shutil.rmtree(log_dir, ignore_errors=True)
    eng = LatticeEngine.from_arrays(g, T, M, chi, device=dev)
    with profiling.trace(str(log_dir)):
        with profiling.annotate("bp_energy"):
            with torch.no_grad():
                var.bp_energy_fn(eng, ham, bp_iters=2)(eng.T)
            sync(dev)
    files = sorted(log_dir.glob("*.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"12a: profiling.trace of one 2-sweep energy on the card: {len(files)} trace file, "
          f"{sum(e.get('name') == 'bp_energy' for e in events)} 'bp_energy' region, {kernels} device kernel events",
          flush=True)
    require(len(files) == 1 and kernels > 0, "12a: the trace holds no device activity")
    for f in files:
        f.unlink()
    log_dir.rmdir()

    # the run: Adam from the main path's state, the best kept, then bp_update on K3
    plain_before = reset_counts()
    marks = []

    def mark(i, e):
        sync(dev)
        marks.append((time.perf_counter(), k3_launches()))

    sync(dev)
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = tt.minimize_energy(eng, ham, steps=VAR_STEPS, learning_rate=VAR_LR, bp_iters=VAR_BP_ITERS, callback=mark)
    sync(dev)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps_k3, all_k3 = marks[-1][1], k3_launches()
    in_bp = {k: all_k3[k] - steps_k3[k] for k in all_k3}
    counts = read_counts(plain_before)
    hist = res["history"]
    per_step = np.diff([t0] + [m[0] for m in marks])
    print(f"12a: minimize_energy, Eagle-127 chi={chi} complex64 from the main path's state, TFIM J={VAR_HAM['J']}, "
          f"h={VAR_HAM['h']}, {VAR_STEPS} Adam steps (lr {VAR_LR}), {VAR_BP_ITERS} sweeps: energies "
          f"{[round(float(x), 6) for x in hist]}, best {res['energy']:.6f} (step 0 {hist[0]:.6f}); seconds a step "
          f"{[round(float(x), 3) for x in per_step]} (mean {per_step[1:].mean():.3f} after the first), "
          f"{total:.3f} s with the final bp_update ({total - (marks[-1][0] - t0):.3f} s, {eng.bp_iterations} "
          f"iterations); peak memory {peak / 2**30:.3f} GiB ({(peak - base_mem) / 2**30:.3f} above the state "
          f"allocated before)", flush=True)
    print(f"12a: K3 launches during the steps {steps_k3['bp_sweep_group']}, in the final bp_update "
          f"{in_bp['bp_sweep_group']}; plain runs {counts[3]}", flush=True)
    require(np.all(np.isfinite(hist)), "12a: a non-finite energy")
    require(res["energy"] < hist[0], "12a: no step went below step 0's energy")
    require(not any(steps_k3.values()), f"12a: a kernel ran under the gradient: {steps_k3}")
    require(in_bp["bp_sweep_group"] > 0, "12a: the final bp_update did not run K3")
    require(not counts[3], "12a: a plain version ran on the card")
    require(all(torch.isfinite(a).all() for a in eng.T.values()) and torch.isfinite(eng.M).all(),
            "12a: non-finite state after minimize_energy")
    return {"12a steps": steps_k3, "12a bp_update": in_bp}


def truncation_phase(dev, psi_gold):
    """12b: `truncate` by BP and by boundary MPS of phase 11a's Eagle golden
    state, their overlaps with it by boundary MPS."""
    from collections import Counter

    import tnqs_torch as tt
    from tnqs_torch import fullupdate
    from tnqs_torch.core import linalg

    plain_before = reset_counts()
    rows, outs = {}, {}
    for alg, kw in (("bp", {}), ("boundarymps", dict(mps_bond_dimension=TRUNC_MPS_RANK))):
        reads, solves = linalg.host_reads.count, Counter(fullupdate.solves)
        sync(dev)
        t0 = time.perf_counter()
        out = tt.truncate(psi_gold, alg=alg, maxdim=TRUNC_MAXDIM, **kw)
        sync(dev)
        rows[alg] = (time.perf_counter() - t0, linalg.host_reads.count - reads,
                     dict(Counter(fullupdate.solves) - solves))
        outs[alg] = out
        require(out.maxvirtualdim() <= TRUNC_MAXDIM, f"12b: {alg} left a bond above {TRUNC_MAXDIM}")
    # |<out|gold>|^2 / (<out|out> <gold|gold>), each by boundary MPS
    t0 = time.perf_counter()
    kw = dict(alg="boundarymps", mps_bond_dimension=TRUNC_MPS_RANK)
    n_gold = tt.norm_sqr(psi_gold, **kw)
    fid = {alg: abs(tt.inner(out, psi_gold, **kw)) ** 2 / abs(tt.norm_sqr(out, **kw) * n_gold)
           for alg, out in outs.items()}
    overlap_s = time.perf_counter() - t0
    for alg, (secs, reads, solves) in rows.items():
        print(f"12b: truncate(alg={alg!r}, maxdim={TRUNC_MAXDIM}"
              + (f", mps_bond_dimension={TRUNC_MPS_RANK}" if alg == "boundarymps" else "")
              + f") of the Eagle golden state (maxdim 8, complex128): {secs:.3f} s, {reads} host reads, full updates' "
              f"solves by route {solves}, maxvirtualdim {outs[alg].maxvirtualdim()}, normalized overlap with the "
              f"untruncated state (BMPS rank {TRUNC_MPS_RANK}) {fid[alg]:.10f}", flush=True)
    print(f"12b: overlaps {overlap_s:.3f} s; BMPS - BP {fid['boundarymps'] - fid['bp']:.3e} (bound >= -1e-6)",
          flush=True)
    require(all(np.isfinite(f) and f > 0 for f in fid.values()), "12b: a non-finite overlap")
    require(fid["boundarymps"] >= fid["bp"] - 1e-6, "12b: the BMPS truncation is worse than the BP one")
    counts = read_counts(plain_before)
    require(not any(counts[0].values()) and not counts[3], "12b: a kernel ran on the flex tier")


def entangled_3x3(tt):
    """`tests/test_truncate.py`'s entangled 3x3 state, built on the CPU."""
    g = tt.named_grid((3, 3))
    psi = tt.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex128, device="cpu")
    layer = [("Rx", [v], 0.4) for v in g.vertices()]
    for ce in tt.edge_color(g, 4):
        layer += [("Rzz", p, 0.7) for p in ce]
    return tt.apply_gates(layer * 3, psi, apply_kwargs=dict(maxdim=4, cutoff=1e-14))[0]


def exact_fidelity(tt, a, b):
    ip = tt.inner(a, b, alg="exact")
    return abs(ip) ** 2 / (abs(tt.norm_sqr(a, alg="exact")) * abs(tt.norm_sqr(b, alg="exact")))


def full_update_checks(dev):
    """12c: card against the CPU port at complex128 on the test sizes, each
    from the same arrays."""
    import tnqs_torch as tt
    from tnqs_torch import fullupdate

    t0 = time.perf_counter()
    psi_cpu = entangled_3x3(tt)
    cases = {"bp": dict(alg="bp"), "bmps": dict(alg="boundarymps", mps_bond_dimension=TRUNC_EXACT_RANK,
                                                gauge_state=False),
             "bmps gauged": dict(alg="boundarymps", mps_bond_dimension=TRUNC_EXACT_RANK)}
    fids, fu_ov, fid_fu = {}, {}, {}
    for d in (dev, "cpu"):
        psi = psi_cpu.adapt(device=d)
        fids[str(d)] = {name: exact_fidelity(tt, tt.truncate(psi, maxdim=2, **kw), psi) for name, kw in cases.items()}
        # `tests/test_gauge_measure.py:79`: full update against simple update, no truncation
        g = tt.named_path_graph(2)
        p2 = tt.random_tensornetworkstate(g, bond_dimension=2, dtype=np.complex128, rng=np.random.default_rng(0),
                                          device=d)
        gate, _ = tt.to_tensor(("Rzz", [1, 2], 0.37), g, p2.siteinds(), device=d)
        envs = tt.BeliefPropagationCache(p2).update().incoming_messages([1, 2])
        (s1, s2), _, _ = tt.simple_update(gate, [p2[1], p2[2]], envs=envs, maxdim=8)
        f1, f2 = tt.full_update(gate, p2, [1, 2], envs=envs, maxdim=8, nfullupdatesweeps=20)
        su, fu = p2.copy(), p2.copy()
        su[1], su[2], fu[1], fu[2] = s1, s2, f1, f2
        fu_ov[str(d)] = abs(tt.inner(su, fu, alg="exact")) / np.sqrt(
            abs(tt.norm_sqr(su, alg="exact")) * abs(tt.norm_sqr(fu, alg="exact")))
        # `fidelity` of a truncating full update on the middle bond of a 4-site path
        g4 = tt.named_path_graph(4)
        p4 = tt.random_tensornetworkstate(g4, bond_dimension=2, dtype=np.complex128, rng=np.random.default_rng(5),
                                          device=d)
        gate4, _ = tt.to_tensor(("Rxx", [2, 3], 0.61), g4, p4.siteinds(), device=d)
        envs4 = tt.BeliefPropagationCache(p4).update().incoming_messages([2, 3])
        t1, t2 = tt.full_update(gate4, p4, [2, 3], envs=envs4, maxdim=2)
        fid_fu[str(d)] = fullupdate.fidelity(envs4, t1, t2, p4[2], p4[3], gate4)
    card, cpu = str(dev), "cpu"
    diff = {name: abs(fids[card][name] - fids[cpu][name]) for name in cases}
    print(f"12c: 3x3 state (test_truncate.py), exact fidelities after truncate maxdim 2 by BP, by BMPS rank "
          f"{TRUNC_EXACT_RANK} without and with the symmetric gauge: card "
          f"{[f'{x:.12f}' for x in fids[card].values()]}, CPU {[f'{x:.12f}' for x in fids[cpu].values()]}, "
          f"|card - CPU| {[f'{x:.3e}' for x in diff.values()]} (bounds 1e-10, 1e-10, {TRUNC_GAUGE_TOL:.0e})",
          flush=True)
    print(f"12c: full update against simple update (test_gauge_measure.py:79), normalized overlap - 1: card "
          f"{fu_ov[card] - 1:.3e}, CPU {fu_ov[cpu] - 1:.3e} (bound 1e-10); fidelity() of a truncating full update "
          f"card {fid_fu[card]:.15f}, CPU {fid_fu[cpu]:.15f}, |card - CPU| {abs(fid_fu[card] - fid_fu[cpu]):.3e} "
          f"(bound 1e-12); {time.perf_counter() - t0:.3f} s", flush=True)
    require(diff["bp"] < 1e-10 and diff["bmps"] < 1e-10, "12c: the 3x3 truncation fidelities differ between the card "
                                                          "and the CPU")
    require(diff["bmps gauged"] < TRUNC_GAUGE_TOL, "12c: the gauged BMPS truncation differs between the card and "
                                                   "the CPU beyond its gauge's phases")
    require(abs(fu_ov[card] - 1) < 1e-10, "12c: the card's full update is off its simple update")
    require(abs(fid_fu[card] - fid_fu[cpu]) < 1e-12, "12c: fidelity() differs between the card and the CPU")


def phase12(dev, state_main, psi_gold):
    """Phase 12: 12a, 12b, 12c; K3's launches of 12a by part."""
    t0 = time.perf_counter()
    by_path = variational_phase(dev, state_main)
    t1 = time.perf_counter()
    truncation_phase(dev, psi_gold)
    t2 = time.perf_counter()
    full_update_checks(dev)
    print(f"12: {time.perf_counter() - t0:.3f} s (12a {t1 - t0:.3f}, 12b {t2 - t1:.3f}, 12c "
          f"{time.perf_counter() - t2:.3f})", flush=True)
    return by_path


PAR_LAYERS = 2  # 13a's kicked-Ising layers from "↑", on one band and unsharded
PAR_BP_MAXITER = 25  # the final BP run's sweeps (the main path's cap), fixed: bp_tolerance=0 unsharded
PAR_ADAM_STEPS = 2  # 13d's minimize_energy(mesh=) steps
PAR_CUT_BANDS = 8  # 13a's cut_halves: the bands of the (one-process) check of the cut-crossing gates


def profile_13a(steps, dev):
    """One more layer of each of 13a's steps (``{name: () -> None}``) under
    `torch.profiler`: per step the wall time, the device's busy time (the
    sum of the kernels' own times), the kernel launches, and the operators
    with the most host time and the kernels with the most device time; the
    whole tables go to ``chiprun_out/profile_13a.txt``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tables = []
    for name, fn in steps.items():
        sync(dev)
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            fn()
            sync(dev)
            wall = time.perf_counter() - t
        ka = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

        kernels = [e for e in ka if dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kernels) / 1e3
        launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                                         "cuLaunchKernelEx"))
        top_host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:6]
        top_dev = sorted(kernels, key=lambda e: -dev_us(e))[:4]
        print(f"13a profile, {name}, one layer: {wall * 1e3:.1f} ms wall, device busy {busy:.1f} ms, "
              f"{launches} kernel launches; host (self ms, calls): "
              + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.1f} x{e.count}" for e in top_host)
              + "; device (self ms, calls): "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.1f} x{e.count}" for e in top_dev), flush=True)
        tables.append(f"== {name}: {wall * 1e3:.1f} ms wall, device busy {busy:.1f} ms\n"
                      + ka.table(sort_by="self_cpu_time_total", row_limit=40))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_13a.txt").write_text("\n\n".join(tables))


def mesh_phase(dev, main=None, profile=False):
    """Phase 13: the parallel modules on a one-rank NCCL mesh (see the module
    docstring); K1, K2 and K3's launches of 13a's halo step, 13d's gradient
    and the sharded readout and sampler of 13e and 13f.  `main`: (the main
    path's state after phase 6, 8c's warm rank-16 <Z> at the probe
    vertices, 9d's cold two samples), against which 13e and 13f run; without
    it they run on 13c's state against unsharded calls of their own.
    `profile`: `profile_13a` after 13a's comparisons."""
    import torch.distributed as dist

    import tnqs_torch as tt
    from tnqs_torch import variational as var
    from tnqs_torch.bmps_engine import BMPSEngine, BMPSSampler
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.parallel import (HaloBandPlan, HaloBP, HaloStepEngine, ShardedBMPS, ShardedEngine, ShardedSampler,
                                     make_mesh)
    from tnqs_torch.parallel.halo_step import cut_halves
    from tnqs_torch.parallel.mesh import init_ranks, psum
    from tnqs_torch.parallel.pool import free_port

    t_phase = time.perf_counter()
    cfg = json.loads((ROOT / "tests" / "golden" / "golden_f32_controls.json").read_text())["chi64"]["config"]
    chi = int(cfg["maxdim"])
    g = tt.eagle_lattice()
    circuit = tt.heavy_hex_kicked_ising_layer(g, cfg["J"], cfg["theta_h"])
    kw = dict(cutoff=float(cfg["cutoff"]), bp_maxiter=PAR_BP_MAXITER)
    verts = list(g.vertices())
    t0 = time.perf_counter()
    init_ranks(0, 1, free_port(), device="cuda")
    try:
        mesh = make_mesh(1)
        setup = time.perf_counter() - t0
        # NCCL makes its communicator at the group's first collective: timed
        # here, so that 13a's halo step (whose errors are an all_reduce)
        # does not carry it
        t = time.perf_counter()
        psum(torch.zeros(1, device=dev), mesh)
        sync(dev)
        print(f"13: {mesh} (process group set up in {setup:.3f} s, its first collective "
              f"{time.perf_counter() - t:.3f} s)", flush=True)
        require(mesh.backend == "nccl" and mesh.device.type == "cuda", "13: the mesh is not NCCL on the card")

        def zs(eng):
            z = eng.expect_1site("Z")
            return np.array([z[v].real for v in verts])

        def layers(step, T, M):
            plain = reset_counts()
            sync(dev)
            t = time.perf_counter()
            errs = []
            for _ in range(PAR_LAYERS):
                T, M, e = step(T, M)
                errs.append(e)
            sync(dev)
            dt = time.perf_counter() - t
            counts = read_counts(plain)
            require(not counts[3], "13: a plain version ran on the card")
            return T, M, torch.stack(errs).cpu().numpy(), counts[0], dt

        # 13a: the halo step on one band against the unsharded step
        eng0 = LatticeEngine(g, chi, device=dev)
        eng0.T, eng0.M, e0, c0, s0 = layers(eng0.make_step(circuit, bp_tolerance=0.0, **kw), eng0.T, eng0.M)
        eng1 = LatticeEngine(g, chi, device=dev)
        hse = HaloStepEngine(eng1, n_bands=1, mesh=mesh, order="sorted")
        t = time.perf_counter()
        hstep = hse.make_step(circuit, **kw)
        plan_s = time.perf_counter() - t
        hse.Tb, hse.Mb, e1, c1, s1 = layers(hstep, hse.Tb, hse.Mb)
        z0, z1 = zs(eng0), zs(hse.unshard())
        dz, de = float(np.abs(z0 - z1).max()), float(np.abs(e0 - e1).max())
        print(f"13a: HaloStepEngine, one band, {PAR_LAYERS} layers: {s1:.3f} s (unsharded {s0:.3f} s; the step's "
              f"plan {plan_s:.3f} s on the host); max |<Z> - unsharded| {dz:.3e} (bound 1e-5), max |errors - "
              f"unsharded| {de:.3e} (bound 1e-6); K1 {c1['osj_svd']} (unsharded {c0['osj_svd']}), K2 "
              f"{c1['jacobi_eigh']} ({c0['jacobi_eigh']}), K3 {c1['bp_sweep_group']} ({c0['bp_sweep_group']})",
              flush=True)
        require(np.isfinite(z1).all() and dz < 1e-5 and de < 1e-6, "13a: the halo step is off the unsharded step")
        require(c1["osj_svd"] > 0 and c1["jacobi_eigh"] > 0, "13a: the halo step launched no K1 or K2")
        require((c1["osj_svd"], c1["jacobi_eigh"]) == (c0["osj_svd"], c0["jacobi_eigh"]),
                "13a: the halo step launched K1 or K2 another number of times than the unsharded step")

        # 13a: a cut-crossing gate runs on both bands of its cut, as one
        # sub-group of the same gates in the same order on both; the two
        # halves (both endpoints' new tensors and the bond's message) must
        # be the same bits.  Every two-site group and cut of 8 sorted bands,
        # each band's tables filled from the state after the layers
        plain = reset_counts()
        sync(dev)
        t = time.perf_counter()
        halves = cut_halves(eng0, PAR_CUT_BANDS, circuit, order="sorted", cutoff=kw["cutoff"])
        sync(dev)
        s_cut = time.perf_counter() - t
        c_cut = read_counts(plain)
        print(f"13a: cut_halves, {PAR_CUT_BANDS} sorted bands: {halves['gates']} cut-crossing gates run on both of "
              f"their bands, the halves the same bits: {halves['equal']} (max |difference| "
              f"{halves['max_abs_diff']:.3e}); K1 {c_cut[0]['osj_svd']}, K2 {c_cut[0]['jacobi_eigh']} launches; "
              f"{s_cut:.3f} s", flush=True)
        require(halves["equal"] and halves["gates"] > 0, "13a: the two halves of a cut-crossing gate differ")
        require(c_cut[0]["osj_svd"] > 0 and c_cut[0]["jacobi_eigh"] > 0 and not c_cut[3],
                "13a: the cut-crossing gates did not take the kernels")
        if profile:
            # a negative tolerance keeps every sweep: at 0 the unsharded BP
            # stops where two sweeps agree bit for bit, the halo step never
            step_fixed = eng0.make_step(circuit, bp_tolerance=-1.0, **kw)

            def unsharded():
                eng0.T, eng0.M, _ = step_fixed(eng0.T, eng0.M)

            def halo():
                hse.Tb, hse.Mb, _ = hstep(hse.Tb, hse.Mb)

            profile_13a({"unsharded": unsharded, "one-band halo step": halo}, dev)

        # 13b: HaloBP.fixed_point on one band against _bp_fixed_point
        rng = np.random.default_rng(13)
        noise = rng.standard_normal(tuple(eng0.M.shape)) + 1j * rng.standard_normal(tuple(eng0.M.shape))
        M0 = eng0.M + 0.05 * torch.as_tensor(noise, device=dev).to(eng0.M.dtype)
        plain = reset_counts()
        t = time.perf_counter()
        ref = eng0._bp_fixed_point(eng0.T, M0, 25, 1e-7)
        sync(dev)
        s_ref, it_ref = time.perf_counter() - t, eng0.bp_iterations
        eng2 = LatticeEngine.from_arrays(g, {k: v.cpu().numpy() for k, v in eng0.T.items()}, M0.cpu().numpy(), chi,
                                         device=dev)
        hbp = HaloBP(eng2, HaloBandPlan.build(eng2.plan, 1, order="sorted"), mesh)
        t = time.perf_counter()
        hbp.fixed_point(maxiter=25, tolerance=1e-7)
        got = hbp.gather_messages()
        sync(dev)
        s_halo = time.perf_counter() - t
        counts = read_counts(plain)
        dm = float((got - ref).abs().max())
        print(f"13b: HaloBP.fixed_point, one band, from seeded perturbed messages: {s_halo:.3f} s (unsharded "
              f"{s_ref:.3f} s, {it_ref} iterations); max |M - unsharded| {dm:.3e} (bound 1e-5); K3 "
              f"{counts[0]['bp_sweep_group']} launches in both", flush=True)
        require(dm < 1e-5 and not counts[3], "13b: halo BP is off the unsharded fixed point")

        # 13c: ShardedEngine, one step and freenergy through NCCL
        state = ({k: v.cpu().numpy() for k, v in eng0.T.items()}, eng0.M.cpu().numpy())
        eng3 = LatticeEngine.from_arrays(g, *state, chi, device=dev)
        eng4 = LatticeEngine.from_arrays(g, *state, chi, device=dev)
        sharded = ShardedEngine(eng3, mesh)
        t = time.perf_counter()
        sharded.step_once(circuit, **kw)
        f_mesh = sharded.freenergy()
        sync(dev)
        s_mesh = time.perf_counter() - t
        eng4.T, eng4.M, _ = eng4.make_step(circuit, **kw)(eng4.T, eng4.M)
        f_ref = eng4.freenergy()
        vs, es = eng4._bp_scalars(eng4.T, eng4.M)
        logs32 = np.concatenate([np.log(np.abs(v.cpu().numpy())) for v in vs.values()] +
                                [-np.log(np.abs(es.cpu().numpy()))])
        # the float32 rounding the unsharded sum carries: its summation's
        # spread (float32 against float64 over the same float32 logs) and
        # each log's own rounding
        spread = abs(float(np.sum(logs32, dtype=np.float32)) - float(np.sum(logs32.astype(np.float64))))
        tol_f = 4 * (spread + float(np.finfo(np.float32).eps) * float(np.abs(logs32).sum()))
        dzc = float(np.abs(zs(sharded.unshard()) - zs(eng4)).max())
        dfree = abs(f_mesh - f_ref)
        print(f"13c: ShardedEngine, one step and freenergy: {s_mesh:.3f} s; max |<Z> - unsharded| {dzc:.3e} (bound "
              f"1e-5); freenergy {f_mesh} against {f_ref}: {dfree:.3e} (bound {tol_f:.3e}: 4 x (the unsharded "
              f"float32 sum's spread {spread:.3e} + eps32 sum|log|))", flush=True)
        require(dzc < 1e-5 and dfree <= tol_f, "13c: the sharded engine is off the unsharded one")
        del eng2, eng3, eng4, hbp, sharded

        # 13d: the sharded energy and its gradient, then minimize_energy(mesh=)
        ham = tt.tfim_hamiltonian(**VAR_HAM)
        e_u, _, g_u = energy_and_grad(eng0, ham, VAR_BP_ITERS)
        params = var._split(eng0.T)
        for pair in params.values():
            for x in pair:
                x.requires_grad_(True)
        plain = reset_counts()
        sync(dev)
        t = time.perf_counter()
        e_s = var.sharded_bp_energy_fn(eng0, ham, mesh=mesh, bp_iters=VAR_BP_ITERS, order="sorted")(
            var._join(params, eng0.dtype))
        e_s.backward()
        sync(dev)
        s_grad = time.perf_counter() - t
        c_grad = read_counts(plain)
        scale = max(float(x.abs().max()) for pair in g_u.values() for x in pair)
        dg = max(float((a - b.grad).abs().max()) for k in g_u for a, b in zip(g_u[k], params[k]))
        e_s = e_s.detach()
        de = abs(float(e_s) - float(e_u)) / abs(float(e_u))
        print(f"13d: sharded BP energy, chi={chi}, {VAR_BP_ITERS} sweeps: {float(e_s):.6f} against {float(e_u):.6f} "
              f"(relative {de:.3e}, bound 1e-6); gradient {dg:.3e} of its largest entry {scale:.3e} ({dg / scale:.3e}, "
              f"bound 1e-5); energy and gradient {s_grad:.3f} s; K3 launches under the gradient "
              f"{c_grad[0]['bp_sweep_group']}", flush=True)
        require(de < 1e-6 and dg <= 1e-5 * scale, "13d: the sharded energy or gradient is off the unsharded one")
        require(not any(c_grad[0].values()) and not c_grad[3], f"13d: a kernel ran under the gradient: {c_grad[0]}")
        del params, g_u
        marks = []
        sync(dev)
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = tt.minimize_energy(eng0, ham, steps=PAR_ADAM_STEPS, learning_rate=VAR_LR, bp_iters=VAR_BP_ITERS,
                                 mesh=mesh, callback=lambda i, e: (sync(dev), marks.append(time.perf_counter())))
        sync(dev)
        total = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        per_step = np.diff([t] + marks)
        print(f"13d: minimize_energy(mesh=), {PAR_ADAM_STEPS} Adam steps (lr {VAR_LR}): energies "
              f"{[round(float(x), 6) for x in res['history']]}; seconds a step {[round(float(x), 3) for x in per_step]}, "
              f"{total:.3f} s with the final bp_update; peak memory {peak / 2**30:.3f} GiB "
              f"({(peak - base_mem) / 2**30:.3f} above the state allocated before)", flush=True)
        require(np.all(np.isfinite(res["history"])), "13d: a non-finite energy")
        del res

        # 13e: ShardedBMPS on one band, every vertex, at bench's readout
        # width (`bench.py:315-343`), against the unsharded engine at the
        # probe vertices: on one band the relay has no step and the band
        # runs the unsharded zips in their order, so the same bits
        probe = [tuple(cfg["center"]), tuple(cfg["bench_vertex"])]
        state5, z16, samples_9d = main if main is not None else (state, None, None)
        eng5 = LatticeEngine.from_arrays(g, *state5, chi, device=dev)
        sharded = ShardedBMPS(BMPSEngine(eng5, rank=16, power_iters=1), mesh)
        plain = reset_counts()
        calls0 = bmps_library_calls()
        sync(dev)
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ze = sharded.expect_1site("Z")
        sync(dev)
        s_e = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base_mem
        calls = np.subtract(bmps_library_calls(), calls0)
        c_e = read_counts(plain)
        if z16 is None:
            t = time.perf_counter()
            z16 = BMPSEngine(eng5, rank=16, power_iters=1).expect_1site("Z", vertices=probe)
            ref_from = f"an unsharded call at the probe vertices, {time.perf_counter() - t:.3f} s"
        else:
            ref_from = "8c's warm rank-16 call"
        de = max(abs(ze[v] - z16[v]) for v in probe)
        print(f"13e: ShardedBMPS, one band, rank 16, power_iters 1, <Z> on {len(ze)} vertices: {s_e:.3f} s, peak "
              f"memory {peak / 2**30:.3f} GiB above the state, library eigh {calls[0]} SVD {calls[1]}; "
              + ", ".join(f"<Z>{v} {ze[v].real:+.7f}" for v in probe)
              + f"; max |sharded - unsharded| {de:.3e} (bound 1e-6; the same bits: "
              f"{all(ze[v] == z16[v] for v in probe)}; against {ref_from}); K1 {c_e[0]['osj_svd']}, K2 "
              f"{c_e[0]['jacobi_eigh']}, K3 {c_e[0]['bp_sweep_group']}", flush=True)
        require(len(ze) == len(verts) and np.isfinite(np.array(list(ze.values()))).all(),
                "13e: the sharded readout is not finite on every vertex")
        require(de <= 1e-6, f"13e: the sharded readout is {de:.3e} off the unsharded one")
        require(not any(c_e[0].values()) and not c_e[3], f"13e: a kernel or its plain version ran: {c_e[0]}")
        del sharded

        # 13f: ShardedSampler on one band, bench's chi=64 sampler (9d's),
        # 2 samples of seed 1, against the unsharded sampler's
        sam = ShardedSampler(BMPSSampler(BMPSEngine(eng5, rank=8), proj_rank=16), mesh)
        plain = reset_counts()
        sync(dev)
        t = time.perf_counter()
        got = sam.sample_directly_certified(2, seed=1)
        sync(dev)
        s_f = time.perf_counter() - t
        c_f = read_counts(plain)
        if samples_9d is None:
            t = time.perf_counter()
            samples_9d = BMPSSampler(BMPSEngine(eng5, rank=8), proj_rank=16).sample_directly_certified(2, seed=1)
            ref_from = f"an unsharded call, {time.perf_counter() - t:.3f} s"
        else:
            ref_from = "9d's cold call"
        same = all(a["bitstring"] == b["bitstring"] for a, b in zip(got, samples_9d))
        dpq = max(abs(a["poverq"] - b["poverq"]) / abs(b["poverq"]) for a, b in zip(got, samples_9d))
        print(f"13f: ShardedSampler, one band, rank 8, proj_rank 16, 2 samples of seed 1: {s_f:.3f} s "
              f"({s_f / 2:.3f} s a sample, the norm boundaries included); p/q {[round(o['poverq'], 7) for o in got]}; "
              f"the unsharded bits: {same}, max relative |p/q - unsharded| {dpq:.3e} (bound 1e-5; against "
              f"{ref_from}); K1 {c_f[0]['osj_svd']}, K2 {c_f[0]['jacobi_eigh']}, K3 {c_f[0]['bp_sweep_group']}",
              flush=True)
        require(same and dpq <= 1e-5 and np.isfinite([o["poverq"] for o in got]).all(),
                "13f: the sharded samples are not the unsharded ones")
        require(not any(c_f[0].values()) and not c_f[3], f"13f: a kernel or its plain version ran: {c_f[0]}")
    finally:
        dist.destroy_process_group()
    print(f"13: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return {"13a": c1, "13d grad": c_grad[0], "13e bmps": c_e[0], "13f sampler": c_f[0]}


def sanitize_target(dev):
    """The cluster kernels at batch 1-2 and one sweep, for compute-sanitizer
    (`--sanitize`): K2's resident variant at n = 192 (V in the rings), 256
    and 320, K1's resident variant at [512, 256] (8 CTAs) and
    [640, 320] (16), the L2 variants past them (n = 600; [544, 512]), each with
    V's kernel."""
    from tnqs_torch.ops import jacobi, osj

    rng = np.random.default_rng(13)
    for B, n in ((2, 192), (2, 256), (1, 320), (1, 600)):
        X = torch.as_tensor(rand_c(rng, (B, n, n)), device=dev)
        jacobi._jacobi_eigh_cuda((0.5 * (X + X.mH)).contiguous(), 1, False)
        torch.cuda.synchronize()
        print(f"sanitize target: jacobi_eigh [{B},{n},{n}] V {jacobi.v_route_of(n)}, one sweep done", flush=True)
    for B, R, n in ((2, 512, 256), (1, 640, 320), (1, 544, 512)):
        A = torch.as_tensor(rand_c(rng, (B, R, n)), device=dev)
        osj._osj_svd_cuda(A, torch.eye(n, dtype=A.dtype, device=dev).expand(B, n, n).contiguous(), 1)
        torch.cuda.synchronize()
        print(f"sanitize target: osj_svd [{B},{R},{n}] one sweep done ({'past the cluster kernel' if osj.osj_l2(R, n) else 'clusters of '
              + str(osj.osj_fits(R, n)[-1])})", flush=True)


def sanitize():
    """`--sanitize`: `sanitize_target` under compute-sanitizer's racecheck and
    synccheck, where the toolkit ships it.  Returns 0 when both report no
    hazard and the target ran to its end."""
    import shutil

    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not pathlib.Path(tool).exists():
        print("sanitize: the CUDA toolkit here ships no compute-sanitizer")
        return 1
    rc = 0
    for check in ("racecheck", "synccheck"):
        t0 = time.perf_counter()
        proc = subprocess.run([tool, "--tool", check, sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--sanitize-target"], capture_output=True, text=True, timeout=900)
        out = (proc.stdout + proc.stderr).strip().splitlines()
        print(f"sanitize {check}: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s; the sanitizer's "
              f"lines and the target's last:")
        for line in [line for line in out if line.startswith("=========")][:12] + out[-4:]:
            print(f"  {line}")
        clean = proc.returncode == 0 and any("0 errors" in line or "0 hazards" in line for line in out)
        if any("not supported" in line.lower() for line in out):
            print(f"sanitize {check}: compute-sanitizer refuses this card (\"Device not supported\"): no {check} ran")
        rc |= not clean
    return rc


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=10, help="main-path layers (default 10)")
    ap.add_argument("--bp-kernel-only", action="store_true",
                    help="only the environment, the build and the BP kernel phase (no result lines)")
    ap.add_argument("--switches-only", action="store_true",
                    help="only the environment, the build and the switches phase (no result lines)")
    ap.add_argument("--flex-only", action="store_true",
                    help="only the environment, the build, the main path's evolution and `bp_update` and the flex "
                         "tier's phase 11 (no result lines)")
    ap.add_argument("--phase12-only", action="store_true",
                    help="only the environment, the build, the main path's evolution and `bp_update`, phase 11a's "
                         "golden evolution and phase 12 (no result lines)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="only the environment, the build and the mesh phase 13 (no result lines)")
    ap.add_argument("--measure-only", action="store_true",
                    help="only the environment, the build, the main path's evolution and the measurement phase "
                         "(no result lines)")
    ap.add_argument("--wide-only", action="store_true",
                    help="only the environment, the build, K1 and K2 past n = 128 against their plain versions, the "
                         "main path's evolution and the chi=96 and chi=128 runs 8d and 8e (no result lines)")
    ap.add_argument("--l2-only", action="store_true",
                    help="only the environment, the build, K1 and K2 past n = 256 against their plain versions and "
                         "the thermal phase 10e (no result lines)")
    ap.add_argument("--sanitize", action="store_true",
                    help="only the build, then the cluster kernels at batch 1-2 under compute-sanitizer's racecheck "
                         "and synccheck (no result lines)")
    ap.add_argument("--sanitize-target", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    sys.path.insert(0, str(ROOT))
    import tnqs_torch  # noqa: F401  (pins full-float32 matmuls)
    from tnqs_torch.ops import _build

    dev = torch.device("cuda", 0)
    try:
        t0 = time.perf_counter()
        _build.kernels()
        libs = ", ".join(str(p.relative_to(ROOT)) for p in _build.library_paths().values())
        print(f"kernel build {time.perf_counter() - t0:.2f} s -> {libs}", flush=True)
        for line in _build.build_log().splitlines():
            if line.startswith("==") or any(w in line for w in ("Function properties", "registers", "spill")):
                print(f"  {line.strip()}")
        t0 = time.perf_counter()
        _build.host_library()
        print(f"host library build (g++, the loop enumerator) {time.perf_counter() - t0:.2f} s -> "
              f"{_build.host_library_path().relative_to(ROOT)}", flush=True)
        if args.sanitize_target:
            sanitize_target(dev)
            return 0
        if args.sanitize:
            return sanitize()
        if args.bp_kernel_only:
            print(json.dumps(bp_kernel_phase(dev)))
            for row in bp_kernel_3x_phase(dev):
                print(json.dumps(row))
            return 0
        if args.switches_only:
            k2_switch_shapes(dev)
            switches_phase(dev, args.layers)
            return 0
        if args.flex_only:
            _, eng, _, _, _, _, _ = main_path(dev, args.layers)
            eng.bp_update(maxiter=30)
            state_main = eng.to_arrays()
            del eng
            flex_phase(dev, state_main)
            return 0
        if args.phase12_only:
            _, eng, _, _, _, _, _ = main_path(dev, args.layers)
            eng.bp_update(maxiter=30)
            state_main = eng.to_arrays()
            del eng
            import tnqs_torch as tt

            gold = json.loads((ROOT / "tests" / "golden" / "golden_eagle127.json").read_text())
            c = gold["config"]
            g = tt.eagle_lattice()
            bpc = flex_evolve(dev, g, tt.heavy_hex_kicked_ising_layer(g, c["J"], c["theta_h"]), c, c["layers"],
                              gold)[0]
            print(f"kernel launches by path (12a): {phase12(dev, state_main, bpc.network)}")
            return 0
        if args.parallel_only:
            print(f"kernel launches by path (13): {mesh_phase(dev, profile=True)}")
            return 0
        if args.measure_only:
            launches, eng, _, probe, _, discarded, _ = main_path(dev, args.layers)
            eng.bp_update(maxiter=30)
            measure_chi64(dev, eng, probe)
            sample_chi64(dev, eng)
            del eng
            by_w2, eng = measure_w2(dev)
            evolutions_launched({"5": launches, **by_w2})
            sample_w2(dev, eng)
            del eng
            measure_wide(dev, "8d", 96, discarded, CHI96_CAP_S, WIDE_XLA_CAP_S)
            measure_wide(dev, "8e", 128, discarded, CHI128_CAP_S, WIDE_XLA_CAP_S, full_layers=2)
            return 0
        if args.l2_only:
            l2_kernel_phase(dev)
            by_path = thermal_phase(dev)
            print(f"kernel launches by path (10e): {by_path}")
            rotation_log_layouts(by_path, ("10e",))
            return 0
        if args.wide_only:
            wide_kernel_phase(dev)
            _, eng, _, _, _, discarded, _ = main_path(dev, args.layers)
            del eng
            by_path = measure_wide(dev, "8d", 96, discarded, CHI96_CAP_S, WIDE_XLA_CAP_S)
            by_path.update(measure_wide(dev, "8e", 128, discarded, CHI128_CAP_S, WIDE_XLA_CAP_S, full_layers=2))
            print(f"kernel launches by path (8d, 8e): {by_path}")
            rotation_log_layouts(by_path, ("8d", "8e"))
            return 0
        kernels = kernel_phase(dev)
        k2_err = k2_switch_shapes(dev)
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], k2_err)
        kernels += wide_kernel_phase(dev)
        kernels += l2_kernel_phase(dev)
        kernels.append(bp_kernel_phase(dev))
        kernels += bp_kernel_3x_phase(dev)
        ckpt_path = ROOT / "build" / "chip_smoke" / f"main_layer{CKPT_LAYER}.npz"
        launches, eng, step, probe, main_rate, discarded, trajectory = main_path(
            dev, args.layers, (ckpt_path, CKPT_LAYER) if args.layers > CKPT_LAYER else None)
        profile_window(eng, step)
        step_ab(dev, eng, step, probe)
        by_path = {"5": launches, "6": bp_path(dev, eng, probe)}
        state_main = eng.to_arrays()  # after phase 6's bp_update, for 10d
        by_8c, z16 = measure_chi64(dev, eng, probe)
        by_9d, samples_9d = sample_chi64(dev, eng)
        by_path.update({**by_8c, **by_9d})
        del eng, step
        by_path.update(switches_phase(dev, args.layers, main_rate, main_devs=trajectory[3]))
        by_w2, eng = measure_w2(dev)
        by_path.update(by_w2)
        evolutions_launched(by_path)
        by_path.update(sample_w2(dev, eng))
        state_w2 = eng.to_arrays()
        del eng
        by_path.update(measure_wide(dev, "8d", 96, discarded, CHI96_CAP_S, WIDE_XLA_CAP_S))
        by_path.update(measure_wide(dev, "8e", 128, discarded, CHI128_CAP_S, WIDE_XLA_CAP_S, full_layers=2))
        if args.layers > CKPT_LAYER:
            by_path.update(resume_checkpoint(dev, ckpt_path, trajectory, args.layers))
            ckpt_path.unlink()
        by_path.update(ladder_run(dev, trajectory[2], args.layers))
        by_path.update(precision_high_run(dev, trajectory, trajectory[2], args.layers))
        by_path.update(loop_corrections(dev, state_main, state_w2))
        by_path.update(thermal_phase(dev))
        print(f"kernel launches by path (phases 5-10): {by_path}")
        psi_gold = flex_phase(dev, state_main)
        by_path.update(phase12(dev, state_main, psi_gold))
        by_path.update(mesh_phase(dev, main=(state_main, z16, samples_9d)))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "launches_by_path", "launches_by_layout", "fp32_ms", "shape", "sweeps",
            "relative_12", "square", "tall", "plain_shape", "cluster", "clusters", "layout", "by_layout",
            "past_resident", "shapes")
    # `launches`: each row's own path, phase 5 for K1-K3, 10c for K3's bf16_3x
    # mode, 8d for K1 and K2 at n = 192 and 8e at n = 256
    own = {name: by_path["10c"][name] for name in ("bp_sweep_group_bf16_3x", "bp_split_planes")}
    for name, path in (("192", "8d"), ("256", "8e")):
        for k in ("jacobi_eigh_res", "osj_svd"):
            own[f"{k} n={name}"] = by_path[path][f"{k} n={name}"]
    for n in L2_N:  # the rows past n = 256: the thermal path's (n = 512; n = 320 is on no path of the smoke)
        for k in ("jacobi_eigh_l2", "osj_svd_l2"):
            own[f"{k} n={n}"] = by_path["10e"][f"{k} n={n}"]
    own["rotation_log"] = by_path["10e"]["rotation_log"]
    try:
        rotlog_layouts = rotation_log_layouts(by_path, ("8d", "8e", "10e"))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{key: v for key, v in dict(k, launches=own.get(k["name"], launches[k["name"]]),
                                          launches_by_path={p: c[k["name"]] for p, c in by_path.items()},
                                          **({"launches_by_layout": rotlog_layouts} if k["name"] == "rotation_log"
                                             else {})).items()
                if key in keys} for k in kernels]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
