"""Build the CUDA kernels of `tnqs_torch/csrc` with nvcc and load them.

The sources have a plain C interface, so nvcc compiles them in seconds into
one shared library that `ctypes` loads; nothing includes PyTorch's headers.
The library goes to ``build/tnqs_torch/`` at the repository root, named by a
hash of the sources and flags, and is built at first use.  No
``--use_fast_math``: the Jacobi rotation formulas need IEEE division and
square roots.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tnqs_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns the launch's cudaError_t as int
_SIGNATURES = {
    # (h_in, vt_out, w_out, batch, n, rounds, eps, stream)
    "tnqs_jacobi_eigh": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
    # (at_inout, vt_inout, batch, rows, n, rounds, eps, stream)
    "tnqs_osj_svd": [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the tnqs_torch CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path() -> pathlib.Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtnqs_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def kernels() -> ctypes.CDLL:
    """The kernel library, compiled on first call in this process unless a
    library of the same sources is already in the build directory."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
