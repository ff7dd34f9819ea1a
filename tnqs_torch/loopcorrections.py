"""Loop-series corrections to the BP partition function (port of
`tnqs/loopcorrections.py`): rescale the cache so BP gives Z = 1 locally,
enumerate leafless edge-induced subgraphs up to a size (the port's
`graphs.leafless_edge_induced_subgraphs`, its g++ enumerator), insert
antiprojectors ``1 - m_e m_rev`` on their edges and sum the weights.
"""

from __future__ import annotations

from typing import Sequence

from .bp import BeliefPropagationCache, _region_boundary_edges
from .contraction import contract, contraction_sequence
from .core.tensor import Tensor, identity_tensor
from .graphs import Edge, leafless_edge_induced_subgraphs, reverse_edge
from .networks import TensorNetworkState


def loopcorrected_partitionfunction(bpc: BeliefPropagationCache, max_configuration_size: int):
    """The BP partition function with loop corrections up to configurations
    of `max_configuration_size` edges."""
    zbp = bpc.partitionfunction()
    bpc = bpc.rescale()
    egs = leafless_edge_induced_subgraphs(bpc.graph, max_configuration_size)
    if not egs:
        return zbp
    return zbp * (1 + sum(weight(bpc, eg) for eg in egs))


def _sim_edge_induced_subgraph(bpc: BeliefPropagationCache, eg: Sequence[Edge]):
    """Relabel the region's bond indices so that antiprojectors can go in
    without index collisions."""
    bpc = bpc.copy()
    net = bpc.network
    is_state = isinstance(net, TensorNetworkState)
    vs: list = []
    for e in eg:
        for v in e:
            if v not in vs:
                vs.append(v)
    eg_set = {frozenset(e) for e in eg}
    processed: set = set()
    antiprojectors: list[Tensor] = []
    for v in vs:
        for e in bpc.graph.incident_edges(v, dir="out"):
            key = frozenset(e)
            if key in processed:
                continue
            processed.add(key)
            rev = reverse_edge(e)
            mer = bpc.message(rev)
            linds = [i for i in mer.inds if i.plev == 0]
            linds_sim = [i.sim() for i in linds]
            mer = mer.replaceinds(linds, linds_sim)
            if is_state:
                mer = mer.replaceinds([i.prime() for i in linds], [i.prime() for i in linds_sim])
            bpc.set_message(rev, mer)
            t = net[e[0]]
            t_inds = [i for i in t.inds if i in linds]
            if t_inds:
                net.set_preserve(e[0], t.replaceind(t_inds[0], linds_sim[linds.index(t_inds[0])]))
            if key in eg_set:
                row, col = list(linds), list(linds_sim)
                if is_state:
                    row = row + [i.prime() for i in linds]
                    col = col + [i.prime() for i in linds_sim]
                ident = net._adapt_like(identity_tensor(row, col, dtype=net.real_dtype(), device=net.device))
                antiprojectors.append(ident - bpc.message(e) * mer)
    return bpc, antiprojectors


def weight(bpc: BeliefPropagationCache, eg: Sequence[Edge]):
    """Weight of one loop configuration."""
    vs: list = []
    for e in eg:
        for v in e:
            if v not in vs:
                vs.append(v)
    bpc, antiprojectors = _sim_edge_induced_subgraph(bpc, eg)
    incoming = [bpc.message(e) for e in _region_boundary_edges(bpc, list(eg))]
    local_tensors = []
    for v in vs:
        local_tensors.extend(bpc.bp_factors(v))
    ts = incoming + local_tensors + antiprojectors
    return contract(ts, sequence=contraction_sequence(ts, alg="greedy")).item()
