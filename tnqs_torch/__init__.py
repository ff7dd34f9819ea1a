"""tnqs_torch — the tensor-network quantum simulator in PyTorch for NVIDIA Hopper.

The PyTorch port of `tnqs` (the JAX package beside it, which stays the
reference), in its two tiers.

The flex tier (`core`, `networks`, `forms`, `bp`, `apply`, `measure`,
`boundarymps`, `sampling`, `gauging`, `loopcorrections`, `contraction`):
named-index tensors over `torch.Tensor` on one device, dynamically shaped,
for arbitrary graphs: product and random states, BP caches, simple-update
evolution (`apply_gates`), expectation values, norms, overlaps, RDMs and
entropies by BP, boundary MPS, loop corrections or exact contraction,
gauging, certified sampling and state checkpoints (`save_state`,
`save_bp_cache`).  Its constructors build on the CUDA device unless the
caller names another (``device="cpu"``) and raise without a card; its
random draws and samples take the caller's numpy Generator.

The compiled tier: `LatticeEngine.make_step` -> `evolve` -> `expect_1site`
and the BP tail, with the JAX engine's factor, gauge, reduction,
truncation and SVD switches at complex64 and complex128 and its BP
precision (``bp_precision="high"``); operator sites (``site_legs=2``, the
thermal-state and Heisenberg-picture layers); the rank ladder
(`resize_chi`, `evolve_ladder`); loop-corrected partition functions; engine
checkpoints in the JAX package's npz layout (`save_engine`,
`load_engine`); the flex types in and out (`LatticeEngine.from_state`,
`to_state`, `to_bp_cache`); the boundary-MPS measurement of its states
(`BMPSEngine`) and its certified sampling (`BMPSSampler`); and the
package's three TPU kernels (the two Jacobi kernels of the truncated SVD
and the fused BP sweep, in both of its arithmetic modes) written in CUDA
C++ for sm_90a (`tnqs_torch/csrc`).  On a CPU tensor each kernel wrapper
runs the kernel's plain PyTorch version instead.  The flex tier launches
none of the kernels.  Full update (`full_update`), truncation by BP or
boundary MPS (`truncate`), the variational BP-energy search through
`torch.autograd` (`Hamiltonian`, `bp_energy_fn`, `minimize_energy`), the
profiling hooks (`utils.profiling`), the FLOP accounting (`utils.flops`)
and, over a `torch.distributed` mesh (`parallel`: `make_mesh`,
`ShardedEngine`, `HaloBP`, `HaloStepEngine`, `ShardedBMPS`,
`ShardedSampler`), the band-sharded layer step, halo-exchange BP, the
sharded BP energy (`sharded_bp_energy_fn`, ``minimize_energy(mesh=...)``)
and the ring-pipelined boundary-MPS sweep and sharded certified sampler
are ported: every module of the JAX package but its TPU-only transfer
workaround (`utils/transfer.py`).

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

from .apply import apply_circuit, apply_gates, apply_op, simple_update  # noqa: E402
from .fullupdate import full_update  # noqa: E402
from .bmps_engine import BMPSEngine, BMPSSampler, ColumnPlan  # noqa: E402
from .boundarymps import BoundaryMPSCache, default_bmps_update_kwargs, generic_apply  # noqa: E402
from .bp import (  # noqa: E402
    BeliefPropagationCache,
    default_bp_update_kwargs,
    default_tolerance,
    loop_correlations,
    make_hermitian,
    message_diff,
)
from .checkpoint import load_bp_cache, load_engine, load_state, save_bp_cache, save_engine, save_state  # noqa: E402
from .contraction import contraction_sequence  # noqa: E402
from .core.index import Index, noprime, prime, sim  # noqa: E402
from .core.linalg import (  # noqa: E402
    eigh,
    factorize,
    factorize_svd,
    map_diag,
    map_eigs,
    pseudo_sqrt_inv_sqrt,
    qr,
    svd,
    truncation_rank,
)
from .core.tensor import (  # noqa: E402
    Tensor,
    commoninds,
    delta,
    directsum,
    from_matrix,
    identity_tensor,
    onehot,
    random_tensor,
    uniqueinds,
)
from .engine import LatticeEngine, LatticePlan, build_program, compile_circuit, identity_operator_vector  # noqa: E402
from .forms import AbstractForm, BilinearForm, QuadraticForm  # noqa: E402
from .gates import gate_matrix, register_alias, register_gate, to_tensor, unregister_gate  # noqa: E402
from .gauging import gauge_and_scale, symmetric_gauge, symmetric_gauge_, symmetrize_and_normalize  # noqa: E402
from .graphs import (  # noqa: E402
    NamedGraph,
    PartitionedGraph,
    a_star,
    boundary_edges,
    build_graph_from_circuit,
    build_graph_from_gates,
    center,
    eagle_lattice,
    edge_color,
    forest_cover,
    forest_cover_edge_sequence,
    heavy_hexagonal_lattice,
    is_connected,
    is_line_graph,
    is_ring_graph,
    is_tree,
    leaf_vertices,
    leafless_edge_induced_subgraphs,
    lieb_lattice,
    named_comb_tree,
    named_grid,
    named_hexagonal_lattice_graph,
    named_path_graph,
    named_ring_graph,
    post_order_dfs_edges,
    reverse_edge,
    steiner_tree,
    topology_to_graph,
    unique_simple_cycles,
)
from .loopcorrections import loopcorrected_partitionfunction  # noqa: E402
from .measure import (  # noqa: E402
    contract_network,
    expect,
    inner,
    norm,
    norm_sqr,
    normalize,
    rdm,
    rdm_matrix,
    reduced_density_matrix,
    renyi_entropy,
    second_renyi_entanglement_entropy,
    von_neumann_entanglement_entropy,
)
from .models import (  # noqa: E402
    heavy_hex_kicked_ising_layer,
    heisenberg_thermal_layer,
    htse_free_energy_density_4th,
    operator_picture_layer,
    tfim_layer,
)
from .networks import (  # noqa: E402
    TensorNetwork,
    TensorNetworkState,
    default_siteinds,
    identity_tensornetworkstate,
    ising_partitionfunction,
    random_tensornetwork,
    random_tensornetworkstate,
    siteinds,
    tensornetwork_from_list,
    tensornetworkstate,
    toriccode_groundstate,
    zerostate,
)
from .sampling import certify_sample, certify_samples, sample, sample_certified, sample_directly_certified  # noqa: E402
from .sitetypes import op_matrix, site_dimension, site_tag, state_vector  # noqa: E402
from .truncate import truncate  # noqa: E402
from .variational import (  # noqa: E402
    Hamiltonian,
    bp_energy_fn,
    heisenberg_hamiltonian,
    minimize_energy,
    sharded_bp_energy_fn,
    tfim_hamiltonian,
)

# the Julia-style aliases of the JAX package
register_gate_bang = register_gate
contract = contract_network
