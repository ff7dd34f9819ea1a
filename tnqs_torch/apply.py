"""Gate application by simple update against BP bond environments (port of
`tnqs/apply.py`): gauge each site tensor by the pseudo square roots of its
environments, QR both down, contract with the gate, split back with a
truncated SVD and un-gauge.  A two-site gate reads its singular values to
the host once (the truncation rule); the rest stays on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .bp import BeliefPropagationCache, default_bp_update_kwargs
from .core.linalg import factorize_svd, pseudo_sqrt_inv_sqrt, qr
from .core.tensor import Tensor, commoninds, contract, hascommoninds, uniqueinds
from .gates import circuit_to_tensors
from .graphs import reverse_edge
from .networks import TensorNetworkState


def apply_op(o: Tensor, t: Tensor) -> Tensor:
    """Apply an operator tensor (primed out, unprimed in) to `t`."""
    return (o * t).noprime()


def simple_update(o: Tensor, psis: Sequence[Tensor], envs: Sequence[Tensor] | None = None,
                  normalize_tensors: bool = True, sqrt_cutoff: float | None = None, maxdim: int | None = None,
                  cutoff: float | None = None):
    """Simple update of one or two site tensors under a gate: returns
    ``(updated_tensors, s_matrix_or_None, truncation_error)``, ``s_matrix``
    the diagonal singular values on the new bond pair ``(b, b')``."""
    psis = list(psis)
    if len(psis) == 1:
        out = apply_op(o, psis[0])
        if normalize_tensors:
            out = out.normalize()
        return [out], None, 0.0
    envs = list(envs) if envs is not None else []
    if sqrt_cutoff is None:
        ref = envs[0] if envs else psis[0]
        real = ref.dtype.to_real() if ref.dtype.is_complex else ref.dtype
        sqrt_cutoff = 10 * torch.finfo(real).eps
    envs_v1 = [e for e in envs if hascommoninds(e, psis[0])]
    envs_v2 = [e for e in envs if hascommoninds(e, psis[1])]
    for e in envs_v1 + envs_v2:
        if e.ndim != 2:
            raise ValueError("simple update environments must be rank-2")
    roots_v1 = [pseudo_sqrt_inv_sqrt(e, cutoff=sqrt_cutoff) for e in envs_v1]
    roots_v2 = [pseudo_sqrt_inv_sqrt(e, cutoff=sqrt_cutoff) for e in envs_v2]
    psi1 = contract([psis[0]] + [r[0] for r in roots_v1])
    psi2 = contract([psis[1]] + [r[0] for r in roots_v2])
    s1 = commoninds(psis[0], o)
    s2 = commoninds(psis[1], o)
    Q1, R1 = qr(psi1, [i for i in uniqueinds(psi1, psi2) if i not in s1])
    Q2, R2 = qr(psi2, [i for i in uniqueinds(psi2, psi1) if i not in s2])
    r1 = commoninds(Q1, R1)
    oR = apply_op(o, R1 * R2)
    R1n, R2n, s_matrix, err = factorize_svd(oR, r1 + s1, maxdim=maxdim, cutoff=cutoff, ortho="none")
    Q1 = contract([Q1] + [r[1].dag() for r in roots_v1])
    Q2 = contract([Q2] + [r[1].dag() for r in roots_v2])
    updated = [Q1 * R1n, Q2 * R2n]
    if normalize_tensors:
        s_matrix = s_matrix.normalize()
        updated = [t.normalize() for t in updated]
    return [t.noprime() for t in updated], s_matrix, err


def apply_gate_(gate: Tensor, bpc: BeliefPropagationCache, vv: Sequence | None = None, maxdim: int | None = None,
                cutoff: float | None = None, normalize_tensors: bool = True, **su_kwargs):
    """Apply one gate in place to a BP cache; a two-site gate writes its
    singular values (made positive) back as both bond messages."""
    tn: TensorNetworkState = bpc.network
    vv = list(tn.gate_vertices(gate) if vv is None else vv)
    nv = len(vv)
    if not 1 <= nv <= 2:
        raise ValueError(f"apply_gate_: only one- and two-site gates are supported; received a gate acting on "
                         f"{nv} vertices: {vv}.")
    if nv == 2 and not bpc.graph.has_edge(vv[0], vv[1]):
        raise ValueError(f"apply_gate_: cannot apply a two-site gate on the non-adjacent vertices {vv[0]} and "
                         f"{vv[1]}. Simple update requires the two sites to share an edge of the tensor-network "
                         "graph.")
    envs = None if nv == 1 else bpc.incoming_messages(vv)
    updated, s_matrix, err = simple_update(gate, [tn[v] for v in vv], envs=envs, maxdim=maxdim, cutoff=cutoff,
                                           normalize_tensors=normalize_tensors, **su_kwargs)
    if nv == 2:
        e = (vv[0], vv[1])
        fixed = tn._adapt_like(Tensor(torch.abs(s_matrix.data), s_matrix.inds))
        bpc.set_message(e, fixed)
        bpc.set_message(reverse_edge(e), fixed)
    for v, t in zip(vv, updated):
        bpc.set_preserve(v, t)
    return bpc, err


def adapt_gate(gate: Tensor, network) -> Tensor:
    """The gate in the network's dtype (complex kept) on its device."""
    return network._adapt_like(gate)


def apply_gates(circuit: Sequence, psi, apply_kwargs: dict | None = None, bp_update_kwargs: dict | None = None,
                update_cache: bool = True, verbose: bool = False, gate_vertices: Sequence | None = None):
    """Apply a circuit by simple update with BP environments.

    `psi` is a `TensorNetworkState` (a BP cache is built and updated first;
    the updated state comes back) or a `BeliefPropagationCache` (reused and
    returned).  Returns ``(state_or_cache, truncation_errors)``, the errors
    a host numpy array.  BP reruns only when a two-site gate touches a
    vertex changed since the last refresh."""
    apply_kwargs = {} if apply_kwargs is None else dict(apply_kwargs)
    if isinstance(psi, TensorNetworkState):
        if bp_update_kwargs is None:
            bp_update_kwargs = default_bp_update_kwargs(psi)
        bpc = BeliefPropagationCache(psi).update(**bp_update_kwargs)
        bpc, errors = apply_gates(circuit, bpc, apply_kwargs=apply_kwargs, bp_update_kwargs=bp_update_kwargs,
                                  update_cache=update_cache, verbose=verbose)
        return bpc.network, errors
    bpc: BeliefPropagationCache = psi
    if bp_update_kwargs is None:
        bp_update_kwargs = default_bp_update_kwargs(bpc.network)
    tn = bpc.network
    if gate_vertices is None:
        converted = circuit_to_tensors(circuit, bpc.graph, tn.siteinds(), device=tn.device)
        tensors = [c[0] for c in converted]
        gate_vertices = [c[1] for c in converted]
    else:
        tensors = list(circuit)
        gate_vertices = list(gate_vertices)
    bpc = bpc.copy()
    affected: set = set()
    errors = np.zeros(len(tensors))
    for ii, gate in enumerate(tensors):
        vs = gate_vertices[ii]
        if update_cache and len(vs) >= 2 and any(v in affected for v in vs):
            if verbose:
                print("Updating BP cache")
            bpc = bpc.update(**bp_update_kwargs)
            affected.clear()
        bpc, errors[ii] = apply_gate_(adapt_gate(gate, bpc.network), bpc, vv=vs, **apply_kwargs)
        affected.update(vs)
    if update_cache:
        bpc = bpc.update(**bp_update_kwargs)
    return bpc, errors


apply_circuit = apply_gates
