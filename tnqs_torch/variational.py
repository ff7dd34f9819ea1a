"""Differentiable variational energy minimization on the compiled engine
(port of `tnqs/variational.py`).

The BP energy

    E(T) = sum_v h_v <op_v>_BP + sum_e J_e <op_u op_v>_BP

is a function of the engine's packed site tensors through a fixed number of
BP sweeps from the initial messages and the per-region normalized
expectation contractions, so `torch.autograd` differentiates it end to end.
Minimizing it over the site tensors is variational ground-state search in
the BP (simple-update) environment approximation: exact on trees, the
standard BP variational energy on loopy graphs.

Under the gradient every BP group runs on the einsum chain
(``_bp_new_messages(..., use_kernel=False)``), as the JAX package
differentiates its einsum route: the fused BP kernel (K3) has no backward
in either package.  Each sweep runs under `torch.utils.checkpoint`, so the
backward pass keeps one sweep's intermediates at a time.  The final
`bp_update` of `minimize_energy` takes the engine's own route, K3 on the
card.

`sharded_bp_energy_fn` (and ``minimize_energy(mesh=...)``) runs the BP
sweeps as the halo-exchange program of `tnqs_torch.parallel.halo` over a
`torch.distributed` mesh, one band a rank, differentiated through the
collectives (`parallel.mesh`: `to_bands`, `ppermute`, `gather_bands`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .parallel.halo import HaloBandPlan, _BandSweep, _global_layout
from .parallel.mesh import Mesh, gather_bands, make_mesh, to_bands
from .sitetypes import op_matrix


@dataclass(frozen=True)
class Hamiltonian:
    """Sum of one-site fields and two-site (edge) bonds.

    ``fields``: a sequence of ``(opname, coeff)``; ``bonds``: a sequence of
    ``(opname_u, opname_v, coeff)``.  Each ``coeff`` is a float applied
    uniformly, or a dict keyed by vertex (fields) or by edge in either
    orientation (bonds) for inhomogeneous couplings; missing keys mean 0.
    Operator names resolve through `tnqs_torch.sitetypes.op_matrix` at the
    engine's site dimension ("X", "Z", "S+", ...).
    """

    fields: Sequence[tuple] = field(default_factory=tuple)
    bonds: Sequence[tuple] = field(default_factory=tuple)


def tfim_hamiltonian(J: float = 1.0, h: float = 1.0) -> Hamiltonian:
    """Transverse-field Ising: H = -J sum_e Z_u Z_v - h sum_v X_v."""
    return Hamiltonian(fields=(("X", -h),), bonds=(("Z", "Z", -J),))


def heisenberg_hamiltonian(J: float = 1.0) -> Hamiltonian:
    """Spin-1/2 Heisenberg: H = J sum_e S_u . S_v (S = sigma/2)."""
    c = J / 4.0
    return Hamiltonian(bonds=(("X", "X", c), ("Y", "Y", c), ("Z", "Z", c)))


def _vertex_coeff(coeff, v) -> float:
    if isinstance(coeff, Mapping):
        return float(coeff.get(v, 0.0))
    return float(coeff)


def _edge_coeff(coeff, e) -> float:
    if isinstance(coeff, Mapping):
        u, v = e
        if e in coeff:
            return float(coeff[e])
        return float(coeff.get((v, u), 0.0))
    return float(coeff)


def _precompute_terms(engine, ham: Hamiltonian):
    """The operator matrices and the coefficient vectors, per bucket (fields)
    and per edge class (bonds), on the engine's device, once per
    (engine, ham)."""
    dev, rdtype = engine.device, engine.real_dtype

    def mat(name):
        return torch.as_tensor(np.asarray(op_matrix(name, engine.d)), device=dev).to(engine.dtype)

    field_terms = []
    for (opname, coeff) in ham.fields:
        cvecs = {k: torch.tensor([_vertex_coeff(coeff, v) for v in verts], dtype=rdtype, device=dev)
                 for k, verts in engine.plan.buckets.items()}
        field_terms.append((mat(opname), cvecs))

    bond_terms = []
    ecls = engine._edge_classes()
    for (opu, opv, coeff) in ham.bonds:
        cvecs = [torch.tensor([_edge_coeff(coeff, e) for e in edges], dtype=rdtype, device=dev)
                 for (_ku, _kv, edges, *_rest) in ecls]
        bond_terms.append(((mat(opu), mat(opv)), cvecs))
    return field_terms, bond_terms


def _expectation_energy(engine, field_terms, bond_terms, T, M, rdtype):
    e = torch.zeros((), dtype=rdtype, device=engine.device)
    for op, cvecs in field_terms:
        outs = engine._expect_1site_all(T, M, op)
        for k, vals in outs.items():
            e = e + torch.sum(cvecs[k] * vals.real.to(rdtype))
    for (mu, mv), cvecs in bond_terms:
        outs = engine._expect_2site_all(T, M, mu, mv)
        for cv, vals in zip(cvecs, outs):
            e = e + torch.sum(cv * vals.real.to(rdtype))
    return e


def bp_energy_fn(engine, ham: Hamiltonian, bp_iters: int = 16) -> Callable:
    """``energy(T) -> real 0-d tensor`` on the engine's packed site tensors
    {degree: [n_k, d, chi x k]}, differentiable by `torch.autograd`.

    BP runs `bp_iters` synchronous sweeps from the initial messages, each
    under `torch.utils.checkpoint` (the JAX package's rematerialized
    `lax.scan`), fixed iterations rather than the engine's fixed point.
    Choose `bp_iters` >= the graph diameter so messages equilibrate.  Every
    group takes the einsum chain, whatever `bp_kernel` says: the fused
    kernel has no backward.  The function reads nothing to the host."""
    rdtype = engine.real_dtype
    field_terms, bond_terms = _precompute_terms(engine, ham)
    M0 = engine._initial_messages()

    def sweep(T, M):
        return engine._bp_new_messages(T, M, use_kernel=False)

    def energy(T):
        M = M0
        for _ in range(bp_iters):
            M = checkpoint(sweep, T, M, use_reentrant=False)
        return _expectation_energy(engine, field_terms, bond_terms, T, M, rdtype)

    return energy


def sharded_bp_energy_fn(engine, ham: Hamiltonian, mesh=None, n_bands: int | None = None, bp_iters: int = 16,
                         order=None) -> Callable:
    """`bp_energy_fn` with the BP sweeps run as the halo-exchange program
    over a 1-D mesh (`tnqs/variational.py:157`), differentiable by
    `torch.autograd`.  A collective: every rank of the mesh calls the energy
    with the same (replicated) T and gets the same energy.

    The steps are JAX's: T is taken into this rank's band rows
    (`parallel.to_bands`, whose backward sums every band's part of dE/dT
    over the ranks), `bp_iters` halo sweeps run on the band, each under
    `torch.utils.checkpoint` (its recomputation repeats the sweep's halo
    exchange on every rank, in the same order), the messages are gathered
    back to the global [2E, chi, chi] layout (`parallel.gather_bands`, whose
    backward keeps the local band's slice), and the expectation sums run on
    the full state, replicated.  The gradient is that of the unsharded
    energy, the same bits on every rank.  Every group takes the einsum
    chain: the fused BP kernel has no backward.  `mesh` defaults to
    `make_mesh(n_bands)` on the engine's device type."""
    if mesh is None:
        mesh = make_mesh(n_bands, device="cpu" if engine.device.type == "cpu" else None)
    hplan = HaloBandPlan.build(engine.plan, mesh.size, order=order)
    band_sweep = _BandSweep(engine, hplan, mesh)
    rdtype = engine.real_dtype
    field_terms, bond_terms = _precompute_terms(engine, ham)
    dev, chi = engine.device, engine.chi
    pos = {k: hplan.band_vert_pos[k][mesh.rank] for k in engine.T}
    rows = {k: torch.as_tensor(np.maximum(p, 0).astype(np.int64), device=dev) for k, p in pos.items()}
    masks = {k: torch.as_tensor((p >= 0).astype(np.float32), device=dev) for k, p in pos.items()}
    band, slot = _global_layout(engine, hplan)
    n_slots = hplan.n_loc + 1 + hplan.n_up + hplan.n_dn
    Mb0 = (torch.eye(chi, dtype=engine.dtype, device=dev) / chi).expand(n_slots, chi, chi)

    def sweep(Tb, Mb):
        return band_sweep(Tb, Mb, use_kernel=False)

    def energy(T):
        Tb = {}
        for k, arr in T.items():
            mine = to_bands(arr, mesh)[rows[k]]
            Tb[k] = mine * masks[k].to(arr.dtype).reshape((-1,) + (1,) * (arr.dim() - 1))
        Mb = Mb0
        for _ in range(bp_iters):
            Mb = checkpoint(sweep, Tb, Mb, use_reentrant=False)
        M = gather_bands(Mb, mesh)[band, slot]
        return _expectation_energy(engine, field_terms, bond_terms, T, M, rdtype)

    return energy


def _split(T):
    """(real, imag) leaf pairs of the complex site tensors, detached copies."""
    return {k: (a.detach().real.clone(), a.detach().imag.clone()) for k, a in T.items()}


def _join(params, dtype):
    return {k: torch.complex(re, im).to(dtype) for k, (re, im) in params.items()}


def minimize_energy(
    engine,
    ham: Hamiltonian,
    steps: int = 200,
    learning_rate: float = 0.05,
    bp_iters: int = 16,
    optimizer: Callable | None = None,
    callback: Callable | None = None,
    mesh=None,
) -> dict:
    """Variational ground-state search: gradient descent of the BP energy
    over the engine's site tensors (Adam by default).

    The complex tensors are optimized as (real, imag) float leaf pairs (the
    BP energy is real but not holomorphic).  The default optimizer is
    ``torch.optim.Adam(params, lr=learning_rate)``, whose update (eps added
    outside the square root of the bias-corrected second moment) is optax's
    ``adam``; `optimizer` takes a factory from the list of leaves to a
    `torch.optim.Optimizer` (the JAX package takes an optax transform).
    The engine's current state is the initial guess.  The best state seen
    is written back (``engine.T``) and BP is run on it (`bp_update`, the
    engine's own BP route).  Returns ``{"energy": float, "history":
    float64 array, "steps": int}``; one host read a step (the energy).
    ``mesh=`` (a `tnqs_torch.parallel.Mesh`) takes the energy and its
    gradient from `sharded_bp_energy_fn` over the mesh: a collective, every
    rank calling it with the same engine; the steps, the written-back state
    and the final `bp_update` are replicated."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"minimize_energy: mesh must be a tnqs_torch.parallel.Mesh (make_mesh), not "
                            f"{type(mesh).__name__}")
        efn = sharded_bp_energy_fn(engine, ham, mesh=mesh, bp_iters=bp_iters)
    else:
        efn = bp_energy_fn(engine, ham, bp_iters=bp_iters)
    dtype = engine.dtype
    params = _split(engine.T)
    leaves = [t.requires_grad_(True) for pair in params.values() for t in pair]
    opt = torch.optim.Adam(leaves, lr=learning_rate) if optimizer is None else optimizer(leaves)

    history = np.zeros(steps, dtype=np.float64)
    best_e, best_params = np.inf, params
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = efn(_join(params, dtype))
        loss.backward()
        e = float(loss.detach())
        history[i] = e
        if not np.isfinite(e):
            raise FloatingPointError(
                f"variational energy became non-finite at step {i}; reduce the learning rate or bp_iters")
        if e < best_e:
            best_e = e
            best_params = {k: (re.detach().clone(), im.detach().clone()) for k, (re, im) in params.items()}
        opt.step()
        if callback is not None:
            callback(i, e)
    with torch.no_grad():
        engine.T = {k: a.contiguous() for k, a in _join(best_params, dtype).items()}
    engine.bp_update()
    return {"energy": best_e, "history": history, "steps": steps}
