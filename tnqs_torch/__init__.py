"""tnqs_torch — the tensor-network quantum simulator in PyTorch for NVIDIA Hopper.

The PyTorch port of `tnqs` (the JAX package beside it, which stays the
reference).  It runs the compiled engine: `LatticeEngine.make_step` ->
`evolve` -> `expect_1site` and the BP tail on the heavy-hex kicked-Ising
layer, with the JAX engine's factor, gauge, reduction, truncation and SVD
switches at complex64 and complex128; the boundary-MPS measurement of its
states (`BMPSEngine`: expectation values, RDMs, overlaps) and its certified
sampling (`BMPSSampler`); and the
package's three TPU kernels
(the two Jacobi kernels of the truncated SVD and the fused BP sweep)
written in CUDA C++ for sm_90a (`tnqs_torch/csrc`).  On a CPU tensor each
kernel wrapper runs the kernel's plain PyTorch version instead.

The package imports torch, numpy and the standard library only: no jax, no
networkx, no `tnqs`.
"""

import torch

# Matmuls must stay full float32 (`tnqs/__init__.py:34-43`): TF32, the H100's
# reduced-precision matmul pass, breaks the Cholesky gauge and the physics
# parity the way single-pass bf16 does on a TPU.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .bmps_engine import BMPSEngine, BMPSSampler, ColumnPlan  # noqa: E402
from .engine import LatticeEngine, LatticePlan, build_program, compile_circuit  # noqa: E402
from .gates import gate_matrix, op_matrix  # noqa: E402
from .graphs import NamedGraph, center, eagle_lattice, edge_color  # noqa: E402
from .models import heavy_hex_kicked_ising_layer, tfim_layer  # noqa: E402

__all__ = [
    "BMPSEngine",
    "BMPSSampler",
    "ColumnPlan",
    "LatticeEngine",
    "LatticePlan",
    "NamedGraph",
    "build_program",
    "center",
    "compile_circuit",
    "eagle_lattice",
    "edge_color",
    "gate_matrix",
    "heavy_hex_kicked_ising_layer",
    "op_matrix",
    "tfim_layer",
]
