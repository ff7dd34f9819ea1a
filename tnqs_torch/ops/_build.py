"""Build the CUDA kernels of `tnqs_torch/csrc` with nvcc, and the host
library of `tnqs_torch/csrc/host` with g++, and load them.

The sources have a plain C interface, so nvcc compiles each in seconds into
a shared library of its own that `ctypes` loads; nothing includes PyTorch's
headers.  The sources compile in parallel, one nvcc process each.  The
libraries go to ``build/tnqs_torch/`` at the repository root, named by a
hash of the source and the flags, and are built at first use; ptxas's
register and spill report is kept beside each (`build_log`).  No
``--use_fast_math``: the Jacobi rotation formulas need IEEE division and
square roots.  The host library (`host_library`: the loop-series
enumerator and the flex tier's contraction-order planner) is plain C++ and builds the same way with g++ on any machine.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import types

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
HOST_SOURCES = (CSRC / "host" / "loop_enum.cpp", CSRC / "host" / "contract_opt.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tnqs_torch"
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA of an H100 may use (every kernel's plan checks it)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns the launch's cudaError_t as int
_SIGNATURES = {
    # (h_in, vt_out, w_out, batch, n, rounds, eps, relative, stream)
    "tnqs_jacobi_eigh": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
    # (n, active_out)
    "tnqs_jacobi_eigh_clusters": [_I, ctypes.POINTER(_I)],
    # the resident variant, n > 128: (h_in, log, w_out, taken, started, progress, stage, batch, n, rounds, eps,
    # relative, cluster, stream)
    "tnqs_jacobi_eigh_res": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    # (n, cluster, active_out)
    "tnqs_jacobi_eigh_res_clusters": [_I, _I, ctypes.POINTER(_I)],
    # the resident variant with V in the rings, 128 < n <= 256: (h_in, vt_out, w_out, taken, batch, n, rounds, eps,
    # relative, cluster, stream)
    "tnqs_jacobi_eigh_res_v": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    # (n, cluster, active_out)
    "tnqs_jacobi_eigh_res_v_clusters": [_I, _I, ctypes.POINTER(_I)],
    # the L2 variant, past it: (hc, log, xbuf, taken, batch, n, round0, rounds, eps, relative, cluster, clusters,
    # stream)
    "tnqs_jacobi_eigh_l2": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P],
    # (n, cluster, active_out)
    "tnqs_jacobi_eigh_l2_clusters": [_I, _I, ctypes.POINTER(_I)],
    # (a_in, v_in, a_out, v_out, batch, rows, n, rounds, eps, cluster, cpc, vpc, smem, stream)
    "tnqs_osj_svd": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P],
    # (cluster, smem, active_out)
    "tnqs_osj_svd_clusters": [_I, _I, ctypes.POINTER(_I)],
    # the resident variant: (a_in, a_out, log, taken, started, progress, stage, batch, rows, n, nch, cpc, rounds, eps,
    # cluster, stream)
    "tnqs_osj_svd_res": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    # (n, cpc, cluster, active_out)
    "tnqs_osj_svd_res_clusters": [_I, _I, _I, ctypes.POINTER(_I)],
    # the L2 variant: (x, log, part, taken, batch, n, nch, round0, rounds, eps, cluster, clusters, stream)
    "tnqs_osj_svd_l2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    # (n, cluster, active_out)
    "tnqs_osj_svd_l2_clusters": [_I, _I, ctypes.POINTER(_I)],
    # V from a rotation log: (v_in or null, log, v_out, batch, n, rounds, rows a CTA, entries a stage, started,
    # progress, claim, cluster, mode, stream)
    "tnqs_rotation_log": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P],
    # its register layout, n <= 1024: (v_in or null, log, v_out, batch, n, rounds, round0, rounds a stage, started,
    # progress, claim, cluster, mode, stream)
    "tnqs_rotation_log_regs": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P],
    # the follow launch's gate past one wave: (started, batch, stream)
    "tnqs_rotation_log_gate": [_P, _I, _P],
    # CTAs an SM holds: (n, rows a CTA, entries a stage, the register layout or the slab's)
    "tnqs_rotation_log_ctas_per_sm": [_I, _I, _I, _I],
    # (t, rows, min, out, scratch, plan int64[14], n_k, device, stream)
    "tnqs_bp_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # (smem_mode, smem_pass2, ctas_mode, ctas_pass2, ctas_wide, sms), all out
    "tnqs_bp_sweep_setup": [ctypes.POINTER(_I)] * 6,
    # the bf16_3x mode's, with the same arguments
    "tnqs_bp_sweep_3x": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "tnqs_bp_sweep_setup_3x": [ctypes.POINTER(_I)] * 6,
    # bf16_3x on the tensor cores: (planes, rows, min, out, scratch, plan int64[12], n_k, device, stream)
    "tnqs_bp_sweep_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # (smem, ctas_mode, ctas_pass2, sms), all out
    "tnqs_bp_sweep_setup_tc": [ctypes.POINTER(_I)] * 4,
    # T's split planes: (x, planes, rows, per_row, device, stream)
    "tnqs_bp_split": [_P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the tnqs_torch CUDA kernels need the CUDA toolkit")
    return nvcc


def library_paths() -> dict[pathlib.Path, pathlib.Path]:
    """Each source and where the library built from it lives."""
    paths = {}
    for src in sorted(CSRC.glob("*.cu")):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        h.update(src.read_bytes())
        paths[src] = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    return paths


@functools.cache
def kernels() -> types.SimpleNamespace:
    """The kernels' C entry points by name, each library compiled on first
    call in this process unless it is already in the build directory."""
    paths = library_paths()
    todo = {src: path for src, path in paths.items() if not path.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            procs[src] = (tmp, subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, (tmp, proc) in procs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
            todo[src].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[src])
    libs = [ctypes.CDLL(str(path)) for path in paths.values()]
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(next(lib for lib in libs if hasattr(lib, name)), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(**fns)


def host_library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in HOST_SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtnqs_host_{h.hexdigest()[:16]}.so"


@functools.cache
def host_library() -> ctypes.CDLL:
    """The host library, compiled by g++ on first call in this process
    unless it is already in the build directory; a failed build raises."""
    path = host_library_path()
    if not path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: tnqs_torch's host library needs a C++ compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), *map(str, HOST_SOURCES)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {[s.name for s in HOST_SOURCES]} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    # (nv, ne, edges int32[2 ne], max_edges, out int32[cap], cap, written int64 out) -> count, -1 bad input,
    # -2 out too small
    lib.tnqs_leafless_subgraphs.argtypes = [ctypes.c_int32, ctypes.c_int32, _P, ctypes.c_int32, _P,
                                            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.tnqs_leafless_subgraphs.restype = ctypes.c_int64
    # (n, w, masks uint64[n w], logdims double[64 w], m, out int32) -> 0 ok, -1 bad input
    plan = [_I, _I, _P, _P, _I, _P]
    for name in ("tnqs_optimal_order", "tnqs_greedy_order"):
        getattr(lib, name).argtypes = plan
        getattr(lib, name).restype = _I
    # the same, then (n_restarts, temperature, seed)
    lib.tnqs_sa_order.argtypes = plan + [ctypes.c_int32, ctypes.c_double, ctypes.c_uint64]
    lib.tnqs_sa_order.restype = _I
    return lib


def build_log() -> str:
    """nvcc's output (ptxas registers, shared memory and spills) for the
    libraries of the current sources that are built."""
    logs = [(src, path.with_suffix(".log")) for src, path in library_paths().items()]
    return "".join(f"== {src.name}\n{log.read_text()}" for src, log in logs if log.exists())


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
