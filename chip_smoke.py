#!/usr/bin/env python3
"""Smoke run of tnqs_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--layers N] [--bp-kernel-only]

Run from the repository root.  Phases, each of which fails the run:

1. environment: Python, torch and CUDA versions, the card's name and power
   limit; exits nonzero when `torch.cuda.is_available()` is False;
2. build: nvcc compiles each `tnqs_torch/csrc/*.cu` for sm_90a into a
   library of its own in `build/tnqs_torch/` (one process per source, in
   parallel) and ptxas's register and spill lines are printed;
3. kernels: the cluster occupancy of each Jacobi kernel and the cluster
   size K1's wrapper picks for each batch; each Jacobi kernel against its
   plain PyTorch version on the same card inputs, at the engine's chi=64
   shapes (Gram [26, 128, 128] for `jacobi_eigh`; thetas [18, 128, 128] and
   [26, 256, 128] for `osj_svd` inside `pjsvd`) and at n = 4, 32, 64, over
   five singular-value families; K1 at every cluster size it can take on
   one input, which must agree bitwise; the library call of the same
   function (`torch.linalg.eigh`, `torch.linalg.svd`) timed beside them as a
   yardstick the port never calls; both kernels timed alone at each of the
   main path's 8 shapes a layer;
4. BP kernel: `bp_sweep_group` against its plain version on every degree
   >= 2 group of the Eagle chi=64 color plan, on random site tensors and
   positive messages, plus groups of gathered rows at degree 2-6 that
   reach its other tilings; two calls on each Eagle group must agree
   bitwise; each Eagle group timed on the kernel, on the einsum chain
   `group_messages` and as one multi-operand `torch.einsum` (the
   yardstick), beside its bound; the largest group's kernels' device time
   (torch.profiler); the host side of one launch; one BP sweep timed on the
   kernel and on the einsum route;
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
   on this path with no plain run.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.  `--bp-kernel-only` runs phases 1, 2 and 4
and prints K3's row alone (no result lines), e.g. on an older tree.
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


def spectrum_batch(rng, B, R, n):
    """B matrices [R, n] with the families' singular values, in turn."""
    out = []
    families = list(FAMILIES.values())
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


def cuda_ms(fn, reps):
    """Mean milliseconds per call of `fn` on the current stream."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The 8 `pjsvd` calls of one Eagle chi=64 layer (`compile_circuit` on
# `eagle_lattice()`, thetas routed as `tnqs_torch/engine.py:716-733` routes
# them): (batch, theta rows, polish sweeps), width 128.  K2 takes each one's
# Gram [B, 128, 128] at pjsvd's 8 sweeps.
REAL_PATH = ((18, 128, 4), (18, 128, 4), (26, 256, 6), (9, 256, 6), (16, 256, 6), (20, 256, 6), (11, 256, 6),
             (24, 256, 6))


def eigh_bound(B, n, taken):
    """K2's bound: a rotation taken updates 2n elements of H's upper half
    (rows, then columns; the lower half is their mirror) and 2n of V's
    columns (`jacobi_eigh.cu`), each c x + s y with real c: 4 FMAs and 2
    multiplies, 6 issue slots of the FP32 pipe (a slot is 2 FLOP at the peak
    rate).  A pair found converged skips its update, so the rotations count
    as this run's data takes them, as the plain version counts them."""
    return bound(taken * 4 * n * 6 * 2, B * n * n * 8 * 2 + B * n * 4)


def osj_bound(B, R, n, sweeps, taken):
    """K1's bound: every pair of every round forms its 2x2 Gram, 4 x 2 FMAs a
    row (`osj_svd.cu`, step 1); a rotation taken updates R + n rows of the
    pair's two columns of A and V, 12 issue slots each (`colmix`: 4 FMAs and
    2 multiplies per output); the rotations as this run's data takes them."""
    pairs = B * sweeps * (n - 1) * (n // 2)
    return bound((pairs * 8 * R + taken * 12 * (R + n)) * 2, B * (R * n + n * n) * 8 * 2)


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
    # 64 on [5, 2n, n] thetas.  Checked at its default 12 sweeps: pjsvd's 8
    # leave clustered spectra at ~1e-4 residual by design (the polish repairs
    # the basis); timed at pjsvd's 8
    errs = []
    for B, R, n in ((26, 256, 128), (5, 8, 4), (5, 64, 32), (5, 128, 64)):
        A = torch.as_tensor(spectrum_batch(rng, B, R, n), device=dev)
        G = A.mH @ A
        Hb = (0.5 * (G + G.mH)).contiguous()
        w_k, V_k = jacobi.jacobi_eigh(G, sweeps=12)
        w_p, V_p = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 12))
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
    ms = cuda_ms(lambda: jacobi.jacobi_eigh(G26, sweeps=8), 10)
    plain_ms = cuda_ms(lambda: jacobi.eigh_from_rounds(Hb26, *jacobi._jacobi_eigh_plain(Hb26, 8)), 2)
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
        _, V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8)
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
        k2_ms = cuda_ms(lambda: jacobi._jacobi_eigh_cuda(Hb, 8), 10)
        w, V0 = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 8))
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


def main_path(dev, layers):
    import tnqs_torch
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
    jacobi.jacobi_eigh.launches = 0
    osj.osj_svd.launches = 0
    bp_sweep.bp_sweep_group.launches = 0
    jacobi.jacobi_eigh.launches_by_shape.clear()
    osj.osj_svd.launches_by_shape.clear()
    devs, times = [], []
    for li in range(layers):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.T, eng.M, errors = step(eng.T, eng.M)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(torch.isfinite(errors).all(), f"layer {li + 1}: non-finite truncation errors")
        z = eng.expect_1site("Z")
        zc, zb = z[center].real, z[bench_v].real
        dev_l = max(abs(zc - controls["z_center_f64"][li]), abs(zb - controls["z_bench_f64"][li]))
        devs.append(dev_l)
        print(f"layer {li + 1}: {times[-1]:.3f} s  Z{center}={zc:+.7f}  Z{bench_v}={zb:+.7f}  "
              f"|dev| {dev_l:.3e} (bound {bound[li]:.3e}, floor {floors[li]:.3e})", flush=True)
        require(np.isfinite(dev_l), f"layer {li + 1}: non-finite <Z>")
        require(dev_l <= bound[li], f"layer {li + 1}: deviation {dev_l:.3e} above bound {bound[li]:.3e}")
    launches = {"jacobi_eigh": jacobi.jacobi_eigh.launches, "osj_svd": osj.osj_svd.launches,
                "bp_sweep_group": bp_sweep.bp_sweep_group.launches}
    by_shape = (dict(jacobi.jacobi_eigh.launches_by_shape), dict(osj.osj_svd.launches_by_shape))
    require(all(torch.isfinite(t).all() for t in eng.T.values()), "non-finite state")
    require(torch.isfinite(eng.M).all(), "non-finite messages")
    require(all(n > 0 for n in launches.values()), f"a kernel was not launched by the main path: {launches}")
    require(plain_calls == (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls,
                            bp_sweep._bp_sweep_group_plain.calls), "the main path ran a plain version on the card")
    print(f"kernel launches in the main path: {launches}; K2 by [B, n]: {by_shape[0]}; K1 by [B, R, n]: {by_shape[1]}")
    print(f"K3 launches a layer (the step's BP refreshes and final BP run): "
          f"{launches['bp_sweep_group'] / layers:.1f}")
    print(f"certification clause max|dev| <= max(floor): {max(devs):.3e} <= {floors.max():.3e}: "
          f"{max(devs) <= floors.max()}")
    print(f"first layer {times[0]:.3f} s")
    if layers > 1:
        print(f"layers/s over layers 2-{layers}: {(layers - 1) / sum(times[1:]):.4f}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, eng, step, (center, bench_v, controls, bound[-1], layers)


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
    kernels = {}
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            kernels[ev.key] = (us / 1e3, ev.count)
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
    print(f"profile window, {layers} steady layers (torch.profiler): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}")
    labels = (("K1 osj_svd", ("osj_svd_kernel",)), ("K2 jacobi_eigh", ("jacobi_eigh_kernel",)),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=10, help="main-path layers (default 10)")
    ap.add_argument("--bp-kernel-only", action="store_true",
                    help="only the environment, the build and the BP kernel phase (no result lines)")
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
        if args.bp_kernel_only:
            print(json.dumps(bp_kernel_phase(dev)))
            return 0
        kernels = kernel_phase(dev)
        kernels.append(bp_kernel_phase(dev))
        launches, eng, step, probe = main_path(dev, args.layers)
        profile_window(eng, step)
        step_ab(dev, eng, step, probe)
        bp_path(dev, eng, probe)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [{key: dict(k, launches=launches[k["name"]])[key] for key in keys} for k in kernels]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
