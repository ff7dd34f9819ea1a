"""Differentiable variational energy minimization on the compiled engine
(port of the unsharded part of `tnqs/variational.py`).

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
card.  The sharded energy (`sharded_bp_energy_fn`, ``minimize_energy(
mesh=...)``) waits for the port of `tnqs/parallel/`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
    ``mesh=`` (the sharded BP energy) is not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "minimize_energy(mesh=...) runs the sharded BP energy (sharded_bp_energy_fn), which waits for the "
            "port of tnqs/parallel/ (ROADMAP Queue 1 item 14)")
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
