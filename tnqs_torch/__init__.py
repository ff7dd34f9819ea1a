"""tnqs_torch — the tensor-network quantum simulator in PyTorch for NVIDIA Hopper.

The PyTorch port of `tnqs` (the JAX package beside it, which stays the
reference).  It runs the compiled engine: `LatticeEngine.make_step` ->
`evolve` -> `expect_1site` and the BP tail, with the JAX engine's factor,
gauge, reduction, truncation and SVD switches at complex64 and complex128
and its BP precision (``bp_precision="high"``); operator sites
(``site_legs=2``, the thermal-state and Heisenberg-picture layers); the
rank ladder (`resize_chi`, `evolve_ladder`); loop-corrected partition
functions (`loopcorrected_partitionfunction`, with the port's g++ build of
the loop enumerator); engine checkpoints in the JAX package's npz layout
(`save_engine`, `load_engine`); the lattices and gate registry these need;
the boundary-MPS measurement of its states (`BMPSEngine`: expectation
values, RDMs, overlaps) and its certified sampling (`BMPSSampler`); and the
package's three TPU kernels (the two Jacobi kernels of the truncated SVD
and the fused BP sweep, in both of its arithmetic modes) written in CUDA
C++ for sm_90a (`tnqs_torch/csrc`).  On a CPU tensor each kernel wrapper
runs the kernel's plain PyTorch version instead.  Not yet ported: the flex
tier and its types (`to_state`, `to_bp_cache`, `save_state`), `variational`,
`parallel` and the profiling utilities.

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
from .checkpoint import load_engine, save_engine  # noqa: E402
from .engine import LatticeEngine, LatticePlan, build_program, compile_circuit, identity_operator_vector  # noqa: E402
from .gates import gate_matrix, op_matrix, register_alias, register_gate, unregister_gate  # noqa: E402
from .graphs import (  # noqa: E402
    NamedGraph,
    center,
    eagle_lattice,
    edge_color,
    heavy_hexagonal_lattice,
    is_ring_graph,
    leafless_edge_induced_subgraphs,
    named_comb_tree,
    named_grid,
    named_hexagonal_lattice_graph,
    named_path_graph,
    named_ring_graph,
)
from .models import (  # noqa: E402
    heavy_hex_kicked_ising_layer,
    heisenberg_thermal_layer,
    htse_free_energy_density_4th,
    operator_picture_layer,
    tfim_layer,
)

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
    "heavy_hexagonal_lattice",
    "heisenberg_thermal_layer",
    "htse_free_energy_density_4th",
    "identity_operator_vector",
    "is_ring_graph",
    "leafless_edge_induced_subgraphs",
    "load_engine",
    "named_comb_tree",
    "named_grid",
    "named_hexagonal_lattice_graph",
    "named_path_graph",
    "named_ring_graph",
    "op_matrix",
    "operator_picture_layer",
    "register_alias",
    "register_gate",
    "save_engine",
    "tfim_layer",
    "unregister_gate",
]
