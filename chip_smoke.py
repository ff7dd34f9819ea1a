#!/usr/bin/env python3
"""Smoke run of tnqs_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--layers N]

Run from the repository root.  Phases, each of which fails the run:

1. environment: Python, torch and CUDA versions, the card's name and power
   limit; exits nonzero when `torch.cuda.is_available()` is False;
2. build: nvcc compiles `tnqs_torch/csrc/*.cu` for sm_90a into
   `build/tnqs_torch/`;
3. kernels: each Jacobi kernel against its plain PyTorch version on the same
   card inputs, at the engine's chi=64 shapes (Gram [26, 128, 128] for
   `jacobi_eigh`; thetas [18, 128, 128] and [26, 256, 128] for `osj_svd`
   inside `pjsvd`), over five singular-value families;
4. main path: `LatticeEngine.make_step` on the Eagle-127 kicked-Ising layer
   (J = pi/4, theta_h = 0.4) at chi=64, complex64, cutoff 1e-12,
   bp_maxiter=25, N layers (default 10) from "↑".  After each layer <Z> at
   (7,8) and (11,5) must lie within max(3 x the running multi-seed flex-f32
   floor, 2e-5) of the flex-f64 trajectory in
   `tests/golden/golden_f32_controls.json`, and both kernels must have been
   launched by the step.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
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


def kernel_phase(dev):
    from tnqs_torch.ops import jacobi, osj

    rng = np.random.default_rng(0)
    results = []

    # K2: jacobi_eigh on Grams of [26, 256, 128] thetas.  Checked at its
    # default 12 sweeps: pjsvd's 8 leave clustered spectra at ~1e-4 residual
    # by design (the polish repairs the basis); timed at pjsvd's 8
    A = torch.as_tensor(spectrum_batch(rng, 26, 256, 128), device=dev)
    G = A.mH @ A
    Hb = (0.5 * (G + G.mH)).contiguous()
    w_k, V_k = jacobi.jacobi_eigh(G, sweeps=12)
    w_p, V_p = jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 12))
    torch.cuda.synchronize()
    for name, w, V in (("kernel", w_k, V_k), ("plain", w_p, V_p)):
        require(torch.isfinite(w).all() and torch.isfinite(V).all(), f"jacobi_eigh {name}: non-finite output")
        scale = Hb.abs().amax(dim=(1, 2))
        resid = ((Hb @ V - V * w[:, None, :]).abs().amax(dim=(1, 2)) / scale).max().item()
        orth = (V.mH @ V - torch.eye(128, device=dev)).abs().max().item()
        print(f"jacobi_eigh {name}: residual {resid:.3e}, orthonormality {orth:.3e}")
        require(resid < 1e-4 and orth < 1e-4, f"jacobi_eigh {name}: residual/orthonormality above 1e-4")
    err = (w_k - w_p).abs().max().item()
    rel = ((w_k - w_p).abs().amax(1) / w_p.abs().amax(1)).max().item()
    print(f"jacobi_eigh kernel vs plain: max |dw| {err:.3e}, relative to largest {rel:.3e}")
    require(rel < 1e-4, "jacobi_eigh: kernel and plain eigenvalues differ by more than 1e-4")
    ms = cuda_ms(lambda: jacobi.jacobi_eigh(G, sweeps=8), 10)
    plain_ms = cuda_ms(lambda: jacobi.eigh_from_rounds(Hb, *jacobi._jacobi_eigh_plain(Hb, 8)), 2)
    print(f"jacobi_eigh [26,128,128] sweeps=8: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    results.append(dict(name="jacobi_eigh", route="cuda", source="tnqs_torch/csrc/jacobi_eigh.cu",
                        replaces="tnqs/ops/jacobi.py:279", max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K1: osj_svd as pjsvd's polish on [18, 128, 128] (4 sweeps) and
    # [26, 256, 128] (6 sweeps); the plain version gets the same (B0, V0)
    errs, times = [], {}
    for B, R, polish in ((18, 128, 4), (26, 256, 6)):
        A = torch.as_tensor(spectrum_batch(rng, B, R, 128), device=dev)
        _, V0 = jacobi.jacobi_eigh(A.mH @ A, sweeps=8)
        B0 = A @ V0
        U_k, s_k, Vh_k = osj.osj_svd(B0, V0, sweeps=polish)
        Ab, scale = osj.prescale(B0)
        U_p, s_p, Vh_p = osj.svd_from_rounds(*osj._osj_svd_plain(Ab, V0, polish), scale)
        U_j, s_j, Vh_j = osj.pjsvd(A, polish_sweeps=polish)
        U0, s0, Vh0 = torch.linalg.svd(A.to(torch.complex128), full_matrices=False)
        best = (U0[:, :, :64] * s0[:, None, :64]) @ Vh0[:, :64]
        for name, U, s, Vh in (("kernel", U_k, s_k, Vh_k), ("plain", U_p, s_p, Vh_p), ("pjsvd", U_j, s_j, Vh_j)):
            require(all(torch.isfinite(x).all() for x in (U, s, Vh)), f"osj_svd {name} [{B},{R},128]: non-finite")
            rec = ((U[:, :, :64] * s[:, None, :64]) @ Vh[:, :64]).to(torch.complex128)
            recon = (torch.linalg.vector_norm((rec - best).flatten(1), dim=1) / s0[:, 0]).max().item()
            s_err = ((s.double() - s0).abs().amax(1) / s0[:, 0]).max().item()
            print(f"osj_svd {name} [{B},{R},128]: rank-64 reconstruction {recon:.3e}, s error {s_err:.3e}")
            require(recon < 3e-5, f"osj_svd {name} [{B},{R},128]: truncated reconstruction above 3e-5")
            require(s_err < 1e-4, f"osj_svd {name} [{B},{R},128]: singular values off by more than 1e-4")
        err = (s_k - s_p).abs().max().item()
        rel = ((s_k - s_p).abs().amax(1) / s_p[:, 0]).max().item()
        print(f"osj_svd [{B},{R},128] kernel vs plain: max |ds| {err:.3e}, relative to largest {rel:.3e}")
        require(rel < 1e-4, "osj_svd: kernel and plain singular values differ by more than 1e-4")
        errs.append(err)
        times[(B, R)] = (
            cuda_ms(lambda: osj.osj_svd(B0, V0, sweeps=polish), 10),
            cuda_ms(lambda: osj.svd_from_rounds(*osj._osj_svd_plain(Ab, V0, polish), scale), 2),
        )
        print(f"osj_svd [{B},{R},128] sweeps={polish}: kernel {times[(B, R)][0]:.3f} ms, "
              f"plain {times[(B, R)][1]:.3f} ms")
    ms, plain_ms = times[(26, 256)]
    results.append(dict(name="osj_svd", route="cuda", source="tnqs_torch/csrc/osj_svd.cu",
                        replaces="tnqs/ops/osj.py:306", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))
    return results


def main_path(dev, layers):
    import tnqs_torch
    from tnqs_torch.engine import LatticeEngine
    from tnqs_torch.ops import jacobi, osj

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
    plain_calls = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    jacobi.jacobi_eigh.launches = 0
    osj.osj_svd.launches = 0
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
    launches = {"jacobi_eigh": jacobi.jacobi_eigh.launches, "osj_svd": osj.osj_svd.launches}
    require(all(torch.isfinite(t).all() for t in eng.T.values()), "non-finite state")
    require(torch.isfinite(eng.M).all(), "non-finite messages")
    require(all(n > 0 for n in launches.values()), f"a kernel was not launched by the main path: {launches}")
    require(plain_calls == (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls),
            "the main path ran a plain version on the card")
    print(f"kernel launches in the main path: {launches}")
    print(f"certification clause max|dev| <= max(floor): {max(devs):.3e} <= {floors.max():.3e}: "
          f"{max(devs) <= floors.max()}")
    print(f"first layer {times[0]:.3f} s")
    if layers > 1:
        print(f"layers/s over layers 2-{layers}: {(layers - 1) / sum(times[1:]):.4f}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=10, help="main-path layers (default 10)")
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
        print(f"kernel build {time.perf_counter() - t0:.2f} s -> {_build.library_path().relative_to(ROOT)}",
              flush=True)
        kernels = kernel_phase(dev)
        launches = main_path(dev, args.layers)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    kernels = [{key: dict(k, launches=launches[k["name"]])[key] for key in keys} for k in kernels]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
