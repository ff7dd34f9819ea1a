"""Where a round of the Jacobi kernels K1 (`osj_svd.cu`) and K2
(`jacobi_eigh.cu`) spends its time, on the card.

    python3 -m tnqs_torch.tools.phase_costs

Run from the repository root on a machine with the GPU.  It compiles
variants of the two sources with one phase removed (their results are
wrong; only their time is read), each into its own library under
`build/tnqs_torch/phases/`, and times every variant with CUDA events at the
main path's shapes: K1 at [18, 128, 128] (4 sweeps) and [26, 256, 128] (6
sweeps) at every cluster size it can take, K1's resident variant
(`osj_svd_res_kernel`, A alone, its rotation log written, V not applied)
at the chi = 128 and chi = 96 thetas [26, 512, 256] and [26, 384, 192] (6
sweeps) on the cluster size the wrapper takes, K2 at [26, 128, 128] (8 sweeps,
the absolute skip of `pjsvd`'s preconditioner); and K2's resident variant
past n = 128 (`jacobi_eigh_res_kernel`) at [26, 192, 192] by both V routes
(V in the rings, the route n = 192 takes, and H alone, whose log is
written but not applied), [26, 256, 256] and [4, 512, 512] (H alone, the
routes they take), 8 sweeps with the absolute skip, on the cluster size
the wrapper takes.  The resident variants cut the round's H (and V)
update, its hand-over (the sends, and the wait for what arrives), or both.
A phase's cost is the base time less the variant's.  Each variant names
the text it removes, and the tool stops if a source no longer holds it.
K1's resident variant cuts the round's Gram (its partials sent as zeros),
its update, or both.  First, V's register layout (`rotation_log.cu`) on the
logs `chip_smoke.iterate_log` makes (so the tool imports `chip_smoke.py`
from the working directory) at [4, 512, 512], [26, 256, 256] and
[26, 192, 192]: its round without the colmixes, the movement or the log's
reads, and whole with the other loader (`cp.async.bulk`); with `--regs`
only that.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from tnqs_torch.ops import _build, jacobi, osj, rotation_log

# the Gram variant still sends its (zero) partials: the rounds wait for them
K1_GRAM = [("        if (i < m) {\n          x = As", "        if (false) {\n          x = As"),
           ("      fold<16>(v, lane);\n      fold<8>(v, lane);\n      fold<4>(v, lane);\n"
            "      fold<2>(v, lane);\n      fold<1>(v, lane);\n", "")]
K1_UPDATE = [("task < (ach + vch) * groups;", "task < 0;")]
K1 = {
    "base": [],
    "no Gram loads, products or folds": K1_GRAM,
    "no update": K1_UPDATE,
    "exchange and rotations only": K1_GRAM + K1_UPDATE,
}
# K1's resident variant: the Gram (its partials, zero, still go to the owners) and the update
K1_RES_GRAM = [("const float acc = group_partial(As, lda, 0, ach, pos, gp, m, lane);", "const float acc = 0.0f;")]
K1_RES_UPDATE = [("rotate_group(As, lda, ch * kChunk + lane, rot + par * m, pos, gp, m);", "")]
K1_RES = {
    "base": [],
    "no Gram loads, products or folds": K1_RES_GRAM,
    "no update": K1_RES_UPDATE,
    "hand-overs and rotations only": K1_RES_GRAM + K1_RES_UPDATE,
}
K2_H = ("for (int e = tid; e < tri; e += workers)", "for (int e = tid; e < 0; e += workers)")
K2_V = ("for (int e0 = tid; e0 < m * hv; e0 += 4 * blockDim.x)", "for (int e0 = tid; e0 < 0; e0 += 4 * blockDim.x)")
K2_MIRROR = ("if (i != j) H[cl[bb] * ld + rw[a]] = make_float2(x.x, -x.y);", "")
K2 = {
    "base": [],
    "no H update": [K2_H],
    "no V update": [K2_V],
    "no mirror stores": [K2_MIRROR],
    "no H or V update": [K2_H, K2_V],
}

# the resident variant (both instances, V in the rings and H alone): the round's update (C), and its
# hand-over (D's sends of the leaving columns and the next entries, round 0's entries, A's wait)
K2_RES_UPDATE = [("    if (any) {\n      const int step = blockDim.x / m, i = tid % m;",
                  "    if (false) {\n      const int step = blockDim.x / m, i = tid % m;")]
K2_RES_HANDOVER = [("    if (tid == 0) expect_bytes(bar, r > 0 ? (kV ? 48u : 32u) * n : 16u * n);\n", ""),
                   ("    wait_phase(bar, (r >> 1) & 1);\n", ""),
                   ("rounds > 0 && e < 2 * P * C;", "rounds < 0 && e < 2 * P * C;"),
                   ("e < (kV ? 2 : 1) * n; e += blockDim.x", "e < 0; e += blockDim.x"),
                   ("    for (int e = tid; e < 2 * P * C; e += blockDim.x) {", "    for (int e = tid; e < 0; e += blockDim.x) {")]
K2_RES = {
    "base": [],
    "no update": K2_RES_UPDATE,
    "no hand-over": K2_RES_HANDOVER,
    "neither": K2_RES_UPDATE + K2_RES_HANDOVER,
}


# V's register layout: the colmixes, the movement along the cycle, the log's
# reads from the stage (the entries taken from V's registers instead, all
# taken); the pairing check's trap cut from these three.  And the other
# loader, whole: the loading warp's lane 0 issuing a stage's runs by
# `cp.async.bulk` against the full mbarrier's transaction count (the slab
# layout's copy) instead of 32 lanes' 16-byte `cp.async`
REGS_TRAP = [("  if (blk < W && (bad & ~1u)) __trap();", "")]
REGS_BULK = [
    ('      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;" ::"r"(smem_addr(bars + s)));',
     '      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + s)));'),
    ("  for (int t = tid; t < kRegStages * K * RS; t += blockDim.x) stage[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n",
     "  for (int t = tid; t < kRegStages * K * RS; t += blockDim.x) stage[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
     '  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");\n'),
    ("""    for (int r = 0; r < kr; ++r) {
      const float4* src = lg + (size_t)(r0 + r) * m;
      for (int i = lane; i < m; i += 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + r * RS + i + i / P / per_run)),
                     "l"(src + i) : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bars + buf)) : "memory");
""", """    if (lane == 0) {
      const unsigned bar = smem_addr(bars + buf);
      if (follow) asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(16u * kr * m) : "memory");
      for (int r = 0; r < kr; ++r)
        for (int g = 0; g < D; ++g) {
          const int e0 = g * P * per_run, e1 = min(m, e0 + P * per_run);
          if (e1 > e0)
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                         ::"r"(smem_addr(dst + r * RS + e0 + g)), "l"(lg + (size_t)(r0 + r) * m + e0),
                         "r"(16u * (e1 - e0)), "r"(bar) : "memory");
        }
    }
""")]
REGS = {
    "base": [],
    "no colmix": REGS_TRAP + [("        if (__any_sync(0xffffffffu, G::kBits ? any : any & 1)) {",
                               "        if (false) {")],
    "no movement": REGS_TRAP + [("        move_round<P, R>(top, bot, key, k, src_up, src_dn, first, last, exact, sm);",
                                 "")],
    "no log reads": REGS_TRAP + [
        ("          const int meta = G::kSplit ? __float_as_int(e[s].w) : __float_as_int((q[s] = e[s]).w);",
         "          const int meta = __float_as_int((q[s] = make_float4(top[0][s].x, top[0][s].y, bot[0][s].x, "
         "__int_as_float(1))).w);"),
        ("            const float4 qs = G::kSplit ? lds_in_order(e + s) : q[s];", "            const float4 qs = q[s];")],
    "bulk loader": REGS_BULK,
}


def build(stem: str, variants: dict, tag: str = "") -> dict:
    """One library per variant of `csrc/<stem>.cu`, compiled in parallel."""
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{stem}.cu").read_text()
    procs = {}
    for i, (name, cuts) in enumerate(variants.items()):
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                sys.exit(f"{stem}.cu no longer holds {old!r}: update the variant {name!r}")
            text = text.replace(old, new)
        cu = out / f"{stem}{tag}_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on the variant {name!r} of {stem}.cu:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def cuda_ms(fn, reps=10):
    if fn() != 0:
        sys.exit("a variant's launch failed")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def resident_k2(libs, rand_c, stream):
    """The resident K2's variants at its three widths, in turn: ms and µs a
    round, and each phase's share of the base round."""
    dev = torch.device("cuda", 0)
    for B, n, ring in ((26, 192, True), (26, 192, False), (26, 256, False), (4, 512, False)):
        X = rand_c((B, 2 * n, n))
        G = X.mH @ X
        H = (0.5 * (G + G.mH)).contiguous()
        rounds = 8 * (n - 1)
        w = torch.empty((B, n), device=dev)
        taken = torch.zeros((), dtype=torch.int64, device=dev)
        if ring:
            C = jacobi.eigh_ring_plan(B, n, lambda C: jacobi.res_active_clusters(dev, n, C, True))[0]
            vt = torch.empty_like(H)

            def launch(lib):
                return lib.tnqs_jacobi_eigh_res_v(H.data_ptr(), vt.data_ptr(), w.data_ptr(), taken.data_ptr(), B, n,
                                                  rounds, jacobi.EPS32, 0, C, stream)
        else:
            plan = jacobi.eigh_log_plan(B, n, rounds, jacobi.log_active_clusters(dev, n))
            if plan.layout != "resident" or plan.group < B:
                sys.exit(f"phase_costs: [{B},{n},{n}] takes {plan}, not one resident launch")
            C = plan.cluster
            log = torch.empty((B, rounds, n // 2, 4), device=dev)

            def launch(lib):
                return lib.tnqs_jacobi_eigh_res(H.data_ptr(), log.data_ptr(), w.data_ptr(), taken.data_ptr(), None,
                                                None, 1, B, n, rounds, jacobi.EPS32, 0, C, stream)
        ms = {name: [] for name in libs}
        for _ in range(3):  # the variants in turn, three times
            for name, lib in libs.items():
                ms[name].append(cuda_ms(lambda: launch(lib), 5))
        best = {name: min(t) for name, t in ms.items()}
        row = "; ".join(f"{name} {t:.3f} ms ({1e3 * t / rounds:.3f} us a round)" for name, t in best.items())
        base = best["base"]
        split = (f"update {1e3 * (base - best['no update']) / rounds:.3f} us, hand-over "
                 f"{1e3 * (best['no update'] - best['neither']) / rounds:.3f} us, the rest (rotations, vote, "
                 f"tables, log) {1e3 * best['neither'] / rounds:.3f} us a round")
        print(f"K2 resident [{B},{n},{n}] 8 sweeps, V {'in the rings' if ring else 'left to the log'}, C={C} "
              f"(fastest of 3 turns of 5 calls): {row}; {split}", flush=True)


def resident_k1(libs, rand_c, stream):
    """The resident K1's variants at the chi = 128 and chi = 96 thetas, 6
    sweeps, on the cluster size the wrapper takes: ms and us a round of a
    wave, and each phase's cost."""
    dev = torch.device("cuda", 0)
    for B, R, n in ((26, 512, 256), (26, 384, 192)):
        A0 = osj.prescale(rand_c((B, R, n)))[0].contiguous()
        A1 = torch.empty_like(A0)
        rounds = 6 * (n - 1)
        plan, nch, cpc = osj.osj_log_plan(B, R, n, rounds, osj.log_active_clusters(dev, n))
        if plan.layout != "resident" or plan.group < B:
            sys.exit(f"phase_costs: [{B},{R},{n}] takes {plan}, not one resident launch")
        log = torch.empty((B, rounds, n // 2, 4), device=dev)
        taken = torch.zeros((), dtype=torch.int64, device=dev)
        ms = {name: cuda_ms(lambda: lib.tnqs_osj_svd_res(A0.data_ptr(), A1.data_ptr(), log.data_ptr(),
                                                         taken.data_ptr(), None, None, 1, B, R, n, nch, cpc, rounds,
                                                         jacobi.EPS32, plan.cluster, stream), 5)
              for name, lib in libs.items()}
        per = {name: 1e3 * t / (rounds * plan.waves) for name, t in ms.items()}
        row = "; ".join(f"{name} {t:.3f} ms ({per[name]:.2f} us a round of a wave)" for name, t in ms.items())
        print(f"K1 resident [{B},{R},{n}] 6 sweeps, C={plan.cluster}, {cpc} chunks a CTA, {plan.clusters} clusters "
              f"at once, {plan.waves} waves: {row}; Gram {per['base'] - per['no Gram loads, products or folds']:.2f} "
              f"us, update {per['base'] - per['no update']:.2f} us, the rest (hand-overs, sums, rotations, log) "
              f"{per['hand-overs and rotations only']:.2f} us a round", flush=True)


def regs_rounds(libs, stream):
    """V's register layout (`rotation_log_regs_kernel`) on the smoke's logs
    (`chip_smoke.iterate_log`: K2's 8-sweep log at [4, 512, 512] and
    [26, 256, 256], K1's 6-sweep log at [26, 384, 192], V [26, 192, 192]),
    the variants in turn three times: ms and us a round, the colmixes', the
    movement's and the log reads' shares of the base round, and the bulk
    loader's time against the base's (its V bit for bit the base's)."""
    import chip_smoke

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(19)
    for B, R, n, sweeps, iterate in ((4, 512, 512, 8, "K2"), (26, 256, 256, 8, "K2"), (26, 384, 192, 6, "K1")):
        log, V0, _ = chip_smoke.iterate_log(dev, rng, B, R, n, sweeps, iterate)
        rounds = log.shape[1]
        taken = int(rotation_log.unpack(log)[2].sum().item())
        vp = rotation_log.plan(n)
        v_in = None if V0 is None else V0.data_ptr()
        outs = {name: torch.empty((B, n, n), dtype=torch.complex64, device=dev) for name in libs}
        ms = {name: [] for name in libs}
        for _ in range(3):
            for name, lib in libs.items():
                ms[name].append(cuda_ms(lambda: lib.tnqs_rotation_log_regs(
                    v_in, log.data_ptr(), outs[name].data_ptr(), B, n, rounds, 0, vp.K, None, None, None, 0, 0,
                    stream), 5))
        best = {name: min(t) for name, t in ms.items()}
        row = "; ".join(f"{name} {t:.3f} ms ({1e3 * t / rounds:.3f} us a round)" for name, t in best.items())
        base = best["base"]
        print(f"V regs [{B},{n},{n}] {iterate} {sweeps} sweeps ({taken} taken), P={vp.P}, R={vp.R}, K={vp.K} "
              f"(fastest of 3 turns of 5 calls): {row}; colmix {1e3 * (base - best['no colmix']) / rounds:.3f} us, "
              f"movement {1e3 * (base - best['no movement']) / rounds:.3f} us, log reads "
              f"{1e3 * (base - best['no log reads']) / rounds:.3f} us a round; the bulk loader's turns "
              f"{', '.join(f'{t:.3f}' for t in ms['bulk loader'])} ms against the base's "
              f"{', '.join(f'{t:.3f}' for t in ms['base'])}, V bit for bit the base's: "
              f"{torch.equal(outs['base'], outs['bulk loader'])}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("phase_costs: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def rand_c(shape):
        return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64),
                               device=dev)

    stream = torch.cuda.current_stream().cuda_stream
    regs_rounds(build("rotation_log", REGS, "_regs"), stream)
    if "--regs" in sys.argv[1:]:
        return
    libs = build("osj_svd", K1)
    n = 128
    for B, R, sweeps in ((18, 128, 4), (26, 256, 6)):
        A = rand_c((B, R, n))
        _, V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8, relative=False)
        A0 = osj.prescale(A @ V0)[0].contiguous()
        V0 = V0.contiguous()
        A1, V1 = torch.empty_like(A0), torch.empty_like(V0)
        rounds = sweeps * (n - 1)
        for C in osj.osj_fits(R, n):
            cpc, vpc, smem = osj.osj_plan(R, n, C)
            row = []
            for name, lib in libs.items():
                ms = cuda_ms(lambda: lib.tnqs_osj_svd(A0.data_ptr(), V0.data_ptr(), A1.data_ptr(), V1.data_ptr(),
                                                      B, R, n, rounds, jacobi.EPS32, C, cpc, vpc, smem, stream))
                row.append(f"{name} {ms:.3f} ms ({1e3 * ms / rounds:.2f} us a round)")
            print(f"K1 [{B},{R},{n}] {sweeps} sweeps, C={C}: " + "; ".join(row), flush=True)

    resident_k1(build("osj_svd", K1_RES, "_res"), rand_c, stream)

    libs = build("jacobi_eigh", K2)
    A = rand_c((26, 256, n))
    G = A.mH @ A
    H = (0.5 * (G + G.mH)).contiguous()
    vt, w = torch.empty_like(H), torch.empty((26, n), device=dev)
    rounds = 8 * (n - 1)
    row = []
    for name, lib in libs.items():
        ms = cuda_ms(lambda: lib.tnqs_jacobi_eigh(H.data_ptr(), vt.data_ptr(), w.data_ptr(), 26, n, rounds,
                                                  jacobi.EPS32, 0, stream))
        row.append(f"{name} {ms:.3f} ms ({1e3 * ms / rounds:.2f} us a round)")
    print(f"K2 [26,{n},{n}] 8 sweeps: " + "; ".join(row))

    resident_k2(build("jacobi_eigh", K2_RES, "_res"), rand_c, stream)


if __name__ == "__main__":
    main()
