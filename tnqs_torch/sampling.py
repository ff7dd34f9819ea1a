"""Born-rule bitstring sampling with optional certification (port of
`tnqs/sampling.py`).

* ``alg="bp"``: project each vertex in turn from its one-site conditional
  RDM, rerunning BP between projections;
* ``alg="boundarymps"``: an autoregressive sweep over partitions, each row
  sampled site by site from conditional RDMs, the projected ket row then
  zipped onto a running boundary MPS for the next row, with an on-the-fly
  p(x)/q(x) (`sample_directly_certified`) or an independent contraction
  (`sample_certified`).

Each bit is drawn as the JAX package draws it, ``rng.choice(len(probs),
p=probs)`` with the caller's numpy Generator on float64 host
probabilities, in the same order, so one seed gives the same bits in both
packages.
"""

from __future__ import annotations

from math import log, sqrt

import numpy as np
import torch

from .bp import BeliefPropagationCache
from .boundarymps import BoundaryMPSCache, generic_apply
from .contraction import contract, contraction_sequence
from .core.tensor import Tensor, onehot
from .gauging import gauge_and_scale, symmetrize_and_normalize
from .graphs import a_star, leaf_vertices, reverse_edge
from .networks import TensorNetworkState
from .measure import algorithm_check


def _sample_site_rho(cache, v, rng):
    """Contract the 1-site conditional RDM at `v` and draw a configuration.

    Returns ``(config, q, site_index)`` with `q` the probability drawn."""
    net = cache.network
    tv = net[v]
    tensors = cache.incoming_messages(v) + [tv, tv.prime().dag()]
    seq = contraction_sequence(tensors, alg="optimal")
    rho = contract(tensors, sequence=seq)
    tr = rho.trace_pairs().item()
    rho = rho * (1.0 / tr)
    s_ind = next(i for i in rho.inds if i.plev == 0)
    mat = rho.matricize([s_ind], [s_ind.prime()])
    diag = np.real(torch.diagonal(mat).detach().resolve_conj().cpu().numpy())
    diag = np.clip(diag, 0.0, None)
    probs = diag / diag.sum()
    config = int(rng.choice(len(probs), p=probs))
    return config, float(probs[config]), s_ind, tr


def sample_bp(
    psi: TensorNetworkState,
    nsamples: int,
    bp_update_kwargs: dict | None = None,
    gauge_state: bool = True,
    rng=None,
    **kwargs,
):
    """BP sampling."""
    rng = np.random.default_rng() if rng is None else rng
    bp_update_kwargs = {} if bp_update_kwargs is None else bp_update_kwargs
    cache = BeliefPropagationCache(psi).update(**bp_update_kwargs)
    if gauge_state:
        cache = symmetrize_and_normalize(cache)
    results = []
    vs = psi.vertices()
    for _ in range(nsamples):
        proj = cache.copy()
        bits: dict = {}
        for k, v in enumerate(vs):
            config, q, s_ind, _ = _sample_site_rho(proj, v, rng)
            bits[v] = config
            P = proj.network._adapt_like(onehot(s_ind, config, device=proj.network.device))
            proj.set_preserve(v, proj.network[v] * P)
            if k != len(vs) - 1:
                proj = proj.update(**bp_update_kwargs)
        results.append(dict(bitstring=bits))
    return results, psi


def sample_boundarymps(
    psi: TensorNetworkState,
    nsamples: int,
    projected_mps_bond_dimension: int,
    norm_mps_bond_dimension: int,
    norm_cache_message_update_kwargs: dict | None = None,
    partition_by: str = "row",
    gauge_state: bool = True,
    rng=None,
    **kwargs,
):
    """Boundary-MPS sampling."""
    rng = np.random.default_rng() if rng is None else rng
    norm_cache = BoundaryMPSCache(
        psi, norm_mps_bond_dimension, partition_by=partition_by, gauge_state=gauge_state
    )
    q = norm_cache.quotient_graph()
    leaves = leaf_vertices(q)
    seq = a_star(q, leaves[-1], leaves[0])
    mu_kwargs = dict(norm_cache_message_update_kwargs or {})
    mu_kwargs["normalize"] = False
    norm_cache = norm_cache.update(
        edge_sequence=seq, maxiter=1, message_update_alg="fitting", **mu_kwargs
    )
    results = []
    for _ in range(nsamples):
        p_over_q, logq, bits = _get_one_sample(
            norm_cache, seq, projected_mps_bond_dimension, rng
        )
        results.append(dict(poverq=p_over_q, logq=logq, bitstring=bits))
    return results, psi


def _get_one_sample(norm_cache: BoundaryMPSCache, seq, projected_mps_bond_dimension: int, rng):
    """One autoregressive sweep."""
    cache = norm_cache.copy()
    cutoff, maxdim = 1.0e-10, projected_mps_bond_dimension
    bits: dict = {}
    p_over_q = None
    logq = 0.0
    # partitions left-to-right: flip the right-to-left quotient sequence
    partitions = [reverse_edge(e)[0] for e in reversed(seq)] + [seq[0][0]]
    incoming_mps = None
    for i, partition in enumerate(partitions):
        p_over_q, _logq, bits = _sample_partition(cache, partition, bits, rng)
        logq += _logq
        if i < len(partitions) - 1:
            next_partition = partitions[i + 1]
            qe = (partition, next_partition)
            mpo, mps, right_inds = cache._bmps_apply_inputs(qe, incoming_mps=incoming_mps)
            outgoing = generic_apply(mpo, mps, right_inds, cutoff=cutoff, maxdim=maxdim, normalize=False)
            es = cache.sorted_edges(qe)
            for k, e in enumerate(es):
                cache.set_message(e, [outgoing[k], outgoing[k].prime().dag()])
            incoming_mps = outgoing
        if i > 1:
            cache.delete_interpartition_messages_((partitions[i - 2], partitions[i - 1]))
    return p_over_q, logq, bits


def _sample_partition(cache: BoundaryMPSCache, partition, bits: dict, rng):
    """Sample all sites along one partition line (reference
    `sample_partition!`, `sampling.jl:216-256`)."""
    g_p = cache.partition_graph(partition)
    leaves = leaf_vertices(g_p)
    if len(leaves) >= 2:
        seq = a_star(g_p, leaves[-1], leaves[0])
    else:
        seq = []
    if seq:
        cache.update_partition_(seq)
    vs = [reverse_edge(e)[0] for e in reversed(seq)] + [leaves[-1] if seq else leaves[0]]
    prev_v = None
    traces = []
    logq = 0.0
    for v in vs:
        if prev_v is not None:
            cache.update_partition_([(prev_v, v)])
        config, qv, s_ind, tr = _sample_site_rho(cache, v, rng)
        traces.append(tr)
        bits[v] = config
        logq += log(qv)
        P = cache.network._adapt_like(onehot(s_ind, config, device=cache.network.device))
        proj = cache.network[v] * P * (1.0 / sqrt(qv))
        cache.set_preserve(v, proj)
        prev_v = v
    cache.delete_partition_messages_(partition)
    return traces[0], logq, bits


def certify_sample(
    psi: TensorNetworkState,
    bitstring: dict,
    logq: float,
    certification_mps_bond_dimension: int,
    certification_cache_message_update_kwargs: dict | None = None,
    gauge_state: bool = True,
):
    """Independent p/q estimate: project the full state by the bitstring and
    contract <x|psi> with a zip-up boundary MPS."""
    from .networks import TensorNetwork

    if gauge_state:
        psi = gauge_and_scale(psi)
    s = psi.siteinds()
    qv = sqrt(np.exp(logq / len(psi.vertices())))
    proj_tensors = {}
    for v in psi.vertices():
        P = psi._adapt_like(onehot(s[v][0], bitstring[v], device=psi.device))
        proj_tensors[v] = psi[v] * P * (1.0 / qv)
    proj = TensorNetwork(proj_tensors, psi.graph.copy())
    cache = BoundaryMPSCache(proj, certification_mps_bond_dimension)
    mu = dict(certification_cache_message_update_kwargs or {})
    mu.setdefault("normalize", False)
    cache = cache.update(message_update_alg="zipup", **mu)
    p_over_q = cache.partitionfunction()
    p_over_q = p_over_q * np.conj(p_over_q)
    return dict(poverq=np.real(p_over_q), bitstring=bitstring)


def certify_samples(psi, probs_and_bitstrings, alg: str = "boundarymps", **kwargs):
    algorithm_check(psi, "sample", alg)
    return [
        certify_sample(psi, r["bitstring"], r["logq"], **kwargs) for r in probs_and_bitstrings
    ]


# ----------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------

def sample(psi: TensorNetworkState, nsamples: int, alg: str | None = None, **kwargs):
    """Draw bitstrings (each a dict vertex -> 0..d-1)."""
    algorithm_check(psi, "sample", alg)
    if alg == "bp":
        results, _ = sample_bp(psi, nsamples, **kwargs)
    elif alg == "boundarymps":
        results, _ = sample_boundarymps(psi, nsamples, **kwargs)
    else:
        raise ValueError("sample supports alg='bp' or alg='boundarymps'")
    return [r["bitstring"] for r in results]


def sample_directly_certified(
    psi: TensorNetworkState,
    nsamples: int,
    alg: str = "boundarymps",
    projected_mps_bond_dimension: int | None = None,
    **kwargs,
):
    """Samples plus on-the-fly p(x)/q(x) estimates."""
    algorithm_check(psi, "sample", alg)
    if alg != "boundarymps":
        raise ValueError("sample_directly_certified requires alg='boundarymps'")
    if projected_mps_bond_dimension is None:
        projected_mps_bond_dimension = 5 * psi.maxvirtualdim()
    results, _ = sample_boundarymps(
        psi, nsamples, projected_mps_bond_dimension=projected_mps_bond_dimension, **kwargs
    )
    return results


def sample_certified(
    psi: TensorNetworkState,
    nsamples: int,
    alg: str = "boundarymps",
    certification_mps_bond_dimension: int | None = None,
    certification_cache_message_update_kwargs: dict | None = None,
    projected_mps_bond_dimension: int | None = None,
    **kwargs,
):
    """Samples with independently-certified p(x)/q(x)."""
    algorithm_check(psi, "sample", alg)
    if certification_mps_bond_dimension is None:
        certification_mps_bond_dimension = 5 * psi.maxvirtualdim()
    if projected_mps_bond_dimension is None:
        projected_mps_bond_dimension = 5 * psi.maxvirtualdim()
    results, psi_out = sample_boundarymps(
        psi, nsamples, projected_mps_bond_dimension=projected_mps_bond_dimension, **kwargs
    )
    return certify_samples(
        psi_out,
        results,
        alg=alg,
        certification_mps_bond_dimension=certification_mps_bond_dimension,
        certification_cache_message_update_kwargs=certification_cache_message_update_kwargs,
        gauge_state=False,
    )
