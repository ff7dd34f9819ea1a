"""Bond truncation by applying identity gates (port of `tnqs/truncate.py`).

``alg="bp"`` sweeps edge-color groups applying identity two-site gates by
simple update (cheap); ``alg="boundarymps"`` sweeps partitions applying
them by full update against boundary-MPS environments (more accurate), row
by row then column by column.  Everything stays on the state's device.
"""

from __future__ import annotations

import numpy as np

from .apply import apply_gate_
from .boundarymps import BoundaryMPSCache
from .bp import BeliefPropagationCache, default_bp_update_kwargs
from .core.tensor import Tensor, from_matrix
from .fullupdate import full_update
from .graphs import a_star, edge_color, leaf_vertices, reverse_edge
from .networks import TensorNetworkState


def _truncatable_edge(cache, e) -> bool:
    vinds = cache.network.virtualinds(e)
    if not vinds:
        return False
    return any(i.dim > 1 for i in vinds)


def _identity_gate(net: TensorNetworkState, v1, v2) -> Tensor:
    gate = None
    for v in (v1, v2):
        for s in net.siteinds(v):
            t = net._adapt_like(from_matrix(np.eye(s.dim), [s.prime()], [s], device=net.device))
            gate = t if gate is None else gate * t
    return gate


def truncate_bp_cache(bpc: BeliefPropagationCache, maxdim: int, cutoff: float | None = None,
                      bp_update_kwargs: dict | None = None, use_edge_color: bool = True,
                      normalize_tensors: bool = True) -> BeliefPropagationCache:
    """Truncate every bond of a BP cache by simple update of identity gates,
    one edge-color group at a time with a BP update after each
    (`tnqs/truncate.py:38`)."""
    bpc = bpc.copy()
    if bp_update_kwargs is None:
        bp_update_kwargs = default_bp_update_kwargs(bpc.network)
    net = bpc.network
    apply_kwargs = dict(maxdim=maxdim, cutoff=cutoff, normalize_tensors=normalize_tensors)
    if use_edge_color:
        for group in edge_color(net.graph):
            for e in group:
                if _truncatable_edge(bpc, e):
                    apply_gate_(_identity_gate(net, *e), bpc, vv=list(e), **apply_kwargs)
            bpc = bpc.update(**bp_update_kwargs)
    else:
        for e in net.graph.edges():
            apply_gate_(_identity_gate(net, *e), bpc, vv=list(e), **apply_kwargs)
            bpc = bpc.update(**bp_update_kwargs)
    return bpc


def truncate_bmps_cache(cache: BoundaryMPSCache, maxdim: int, cutoff: float | None = None,
                        normalize_tensors: bool = True) -> BoundaryMPSCache:
    """Sweep each partition with full update against boundary-MPS
    environments (`tnqs/truncate.py:65`)."""
    cache = cache.copy()
    ps = sorted(cache.quotient_vertices())
    for i, p in enumerate(ps):
        g_p = cache.partition_graph(p)
        leaves = leaf_vertices(g_p)
        seq = a_star(g_p, leaves[-1], leaves[0]) if len(leaves) >= 2 else []
        if seq:
            cache.update_partition_(seq)
        forward = [reverse_edge(e) for e in reversed(seq)]
        for e in forward:
            if _truncatable_edge(cache, e):
                net = cache.network  # re-fetch: cache.update() returns copies
                envs = cache.incoming_messages([e[0], e[1]])
                t1, t2 = full_update(_identity_gate(net, *e), net, list(e), envs, maxdim=maxdim, cutoff=cutoff)
                if normalize_tensors:
                    t1, t2 = t1.normalize(), t2.normalize()
                cache.set_preserve(e[0], t1)
                cache.set_preserve(e[1], t2)
            cache.update_partition_([e])
        if i != len(ps) - 1:
            cache = cache.update(edge_sequence=[(ps[i], ps[i + 1])], maxiter=1)
    return cache


def truncate(psi, alg: str | None = None, maxdim: int | None = None, **kwargs):
    """Truncate the virtual bonds of a state, a BP cache or a BMPS cache
    (`tnqs/truncate.py:102`).  A cache is truncated by its own method
    whatever `alg` says; a state by ``alg="bp"`` or ``"boundarymps"`` (which
    takes `mps_bond_dimension`, and `gauge_state`, default True)."""
    from .measure import algorithm_check

    if isinstance(psi, BeliefPropagationCache) and not isinstance(psi, BoundaryMPSCache):
        return truncate_bp_cache(psi, maxdim=maxdim, **kwargs)
    if isinstance(psi, BoundaryMPSCache):
        return truncate_bmps_cache(psi, maxdim=maxdim, **kwargs)
    if not isinstance(psi, TensorNetworkState):
        raise TypeError(f"cannot truncate {type(psi).__name__}")
    algorithm_check(psi, "truncate", alg)
    if alg == "bp":
        bpc = BeliefPropagationCache(psi).update(**default_bp_update_kwargs(psi))
        return truncate_bp_cache(bpc, maxdim=maxdim, **kwargs).network
    if alg == "boundarymps":
        mps_bond_dimension = kwargs.pop("mps_bond_dimension")
        gauge_state = kwargs.pop("gauge_state", True)
        psi_c = psi.copy()
        for partition_by in ("row", "col"):
            cache = BoundaryMPSCache(psi_c, mps_bond_dimension, partition_by=partition_by, gauge_state=gauge_state)
            q = cache.quotient_graph()
            leaves = leaf_vertices(q)
            seq = a_star(q, leaves[-1], leaves[0]) if len(leaves) >= 2 else []
            cache = cache.update(edge_sequence=seq, maxiter=1)
            cache = truncate_bmps_cache(cache, maxdim=maxdim, **kwargs)
            psi_c = cache.network
        return psi_c
    raise ValueError(f"unsupported truncate alg {alg!r}")
