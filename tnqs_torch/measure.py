"""Measurement API: expect, norm_sqr, inner, normalize, reduced density
matrices and entanglement entropies (port of `tnqs/measure.py`).

Every entry point dispatches on ``alg`` in {"exact", "bp", "boundarymps",
"loopcorrections"} under the JAX package's capability matrix.  The values
come back on the host as the JAX package returns them: Python or numpy
scalars, numpy matrices, and `Tensor` RDMs on the state's device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .bp import BeliefPropagationCache, default_bp_update_kwargs
from .contraction import contract, contraction_sequence
from .core.linalg import pseudo_sqrt_inv_sqrt
from .core.tensor import Tensor, delta
from .forms import BilinearForm, QuadraticForm
from .graphs import NamedGraph, reverse_edge, steiner_tree
from .networks import TensorNetwork, TensorNetworkState

_ALGS = ("exact", "bp", "boundarymps", "loopcorrections")


def _bmps():
    from . import boundarymps

    return boundarymps


def algorithm_check(psi, f: str, alg) -> None:
    """The capability matrix of the algorithms."""
    from .boundarymps import BoundaryMPSCache

    if alg == "bp":
        if not isinstance(psi, (BeliefPropagationCache, TensorNetworkState)):
            raise TypeError(
                f"Expected BeliefPropagationCache or TensorNetworkState for 'bp' algorithm, got {type(psi).__name__}"
            )
    elif alg == "loopcorrections":
        if not isinstance(psi, (BeliefPropagationCache, TensorNetworkState)):
            raise TypeError(
                f"Expected BeliefPropagationCache or TensorNetworkState for 'loop correction' algorithm, got {type(psi).__name__}"
            )
        if f in ("normalize", "expect", "sample", "truncate", "rdm"):
            raise ValueError("Loop correction-based contraction not supported for this functionality yet")
    elif alg == "boundarymps":
        if not isinstance(psi, (BoundaryMPSCache, TensorNetworkState)):
            raise TypeError(
                f"Expected BoundaryMPSCache or TensorNetworkState for 'boundarymps' algorithm, got {type(psi).__name__}"
            )
        if f in ("normalize",):
            raise ValueError("boundarymps contraction not supported for this functionality yet")
    elif alg == "exact":
        if f in ("normalize", "sample", "truncate"):
            raise ValueError("exact contraction not supported for this functionality yet")
    elif alg not in _ALGS:
        raise ValueError(
            "Unrecognized algorithm specified. Must be one of 'exact', 'bp', 'loopcorrections', or 'boundarymps'"
        )


def default_alg(psi) -> str:
    from .boundarymps import BoundaryMPSCache

    if isinstance(psi, BoundaryMPSCache):
        return "boundarymps"
    if isinstance(psi, BeliefPropagationCache):
        return "bp"
    raise ValueError(
        "You must specify a contraction algorithm. Currently supported: exact, bp and boundarymps."
    )


# ----------------------------------------------------------------------
# observables plumbing
# ----------------------------------------------------------------------

def collect_vertices(verts, g: NamedGraph) -> list:
    if g.has_vertex(verts):
        return [verts]
    if isinstance(verts, (list, tuple)):
        out = list(verts)
        for v in out:
            if not g.has_vertex(v):
                raise ValueError(f"vertex {v!r} not in graph")
        if len(set(out)) != len(out):
            raise ValueError("Repeated vertex in collection")
        return out
    raise ValueError(f"cannot interpret vertices {verts!r}")


def collectobservable(obs: tuple, g: NamedGraph):
    coeff = 1 if len(obs) == 2 else obs[-1]
    verts = collect_vertices(obs[1], g)
    op = obs[0]
    if isinstance(op, str):
        op_strings = [str(c) for c in op]
    elif isinstance(op, (list, tuple)) and all(isinstance(o, str) for o in op):
        op_strings = list(op)
    else:
        raise ValueError(
            "Invalid observable: expected a single string (one pauli character "
            "per vertex) or a vector of strings (one per vertex)."
        )
    if len(op_strings) != len(verts):
        raise ValueError("Invalid observable: need as many operators as vertices passed.")
    return op_strings, verts, coeff


def op_string_function(op_strings: Sequence[str], vs: Sequence) -> Callable:
    table = dict(zip(vs, op_strings))
    return lambda v: table.get(v, "I")


def observables_vertices(observable, g: NamedGraph) -> list:
    if isinstance(observable, tuple):
        return collect_vertices(observable[1], g)
    out = []
    for obs in observable:
        for v in collect_vertices(obs[1], g):
            if v not in out:
                out.append(v)
    return out


def boundarymps_partitioning(observable, g: NamedGraph) -> str:
    """Row or column partitioning from the observables' alignment."""
    observables = [observable] if isinstance(observable, tuple) else list(observable)
    partitioning = None
    for o in observables:
        vs = observables_vertices(o, g)
        if all(v[0] == vs[0][0] for v in vs) and partitioning in ("row", None):
            partitioning = "row"
        elif all(v[-1] == vs[0][-1] for v in vs) and partitioning in ("col", None):
            partitioning = "col"
        else:
            raise ValueError(
                "Observables must all be aligned in either the same column or "
                "the same row to do BoundaryMPS measurements."
            )
    return partitioning


# ----------------------------------------------------------------------
# expect
# ----------------------------------------------------------------------

def expect(psi, observable, alg: str | None = None, **kwargs):
    """Expectation value(s) of one or more observables ``(ops, vertices[,
    coeff])`` on a state or cache."""
    alg = default_alg(psi) if alg is None else alg
    algorithm_check(psi, "expect", alg)
    single = isinstance(observable, tuple)
    observables = [observable] if single else list(observable)
    if alg == "exact":
        out = _expect_exact(psi, observables, **kwargs)
    elif alg == "bp":
        out = _expect_bp(psi, observables, **kwargs)
    elif alg == "boundarymps":
        out = _bmps().expect_boundarymps(psi, observables, **kwargs)
    else:
        raise ValueError(f"unsupported alg {alg!r} for expect")
    return out[0] if single else out


def _expect_exact(psi: TensorNetworkState, observables, **kwargs):
    denom = norm_sqr(psi, alg="exact")
    out = []
    for obs in observables:
        op_strings, vs, coeff = collectobservable(obs, psi.graph)
        if coeff == 0:
            out.append(0 * coeff)
            continue
        f = op_string_function(op_strings, vs)
        tensors = psi.norm_factors(psi.vertices(), op_strings=f)
        seq = contraction_sequence(tensors, alg="greedy")
        numer = contract(tensors, sequence=seq).item()
        out.append(coeff * numer / denom)
    return out


def _expect_bp(psi, observables, cache_update_kwargs: dict | None = None, **kwargs):
    if isinstance(psi, TensorNetworkState):
        cache_update_kwargs = (
            default_bp_update_kwargs(psi) if cache_update_kwargs is None else cache_update_kwargs
        )
        cache = BeliefPropagationCache(psi).update(**cache_update_kwargs)
    else:
        cache = psi
    out = []
    for obs in observables:
        op_strings, vs, coeff = collectobservable(obs, cache.graph)
        if coeff == 0:
            out.append(0 * coeff)
            continue
        steiner_vs = vs if len(vs) == 1 else steiner_tree(cache.graph, vs).vertices()
        incoming = cache.incoming_messages(list(steiner_vs))

        def contract_region(op_f):
            tensors = cache.network.norm_factors(steiner_vs, op_strings=op_f) + incoming
            seq = contraction_sequence(tensors, alg="optimal")
            return contract(tensors, sequence=seq).item()

        denom = contract_region(lambda v: "I")
        numer = contract_region(op_string_function(op_strings, vs))
        out.append(coeff * numer / denom)
    return out


# ----------------------------------------------------------------------
# norm_sqr / norm
# ----------------------------------------------------------------------

def norm_sqr(psi, alg: str | None = None, **kwargs):
    alg = default_alg(psi) if alg is None and not isinstance(psi, TensorNetworkState) else alg
    algorithm_check(psi, "norm_sqr", alg)
    if alg == "exact":
        tensors = psi.norm_factors(psi.vertices())
        seq = contraction_sequence(tensors, alg="greedy")
        return contract(tensors, sequence=seq).item()
    if alg in ("bp", "loopcorrections"):
        if isinstance(psi, TensorNetworkState):
            cache_update_kwargs = kwargs.pop("cache_update_kwargs", None) or default_bp_update_kwargs(psi)
            cache = BeliefPropagationCache(psi).update(**cache_update_kwargs)
        else:
            cache = psi
        return _cache_norm_sqr(cache, alg, **kwargs)
    if alg == "boundarymps":
        return _bmps().norm_sqr_boundarymps(psi, **kwargs)
    raise ValueError(f"unsupported alg {alg!r} for norm_sqr")


def _cache_norm_sqr(cache, alg, max_configuration_size: int | None = None):
    tn = cache.network
    if alg == "loopcorrections":
        from .loopcorrections import loopcorrected_partitionfunction

        z = loopcorrected_partitionfunction(cache, max_configuration_size)
    else:
        z = cache.partitionfunction()
    if isinstance(tn, TensorNetworkState):
        return z
    if isinstance(tn, TensorNetwork):
        return z * z
    raise TypeError("Network type inside the cache is not a TensorNetworkState.")


def norm(psi, alg: str | None = None, **kwargs):
    return np.sqrt(norm_sqr(psi, alg=alg, **kwargs))


# ----------------------------------------------------------------------
# inner products
# ----------------------------------------------------------------------

def inner(psi: TensorNetworkState, phi: TensorNetworkState, alg: str, **kwargs):
    """<psi|phi> via a BilinearForm contracted with the chosen algorithm."""
    algorithm_check(psi, "inner", alg)
    algorithm_check(phi, "inner", alg)
    if alg == "exact":
        form = BilinearForm(psi, phi)
        tensors = []
        for v in form.vertices():
            tensors.extend(form.bp_factors(v))
        seq = contraction_sequence(tensors, alg="greedy")
        return contract(tensors, sequence=seq).item()
    if alg in ("bp", "loopcorrections"):
        cache_update_kwargs = kwargs.pop("cache_update_kwargs", {})
        cache = BeliefPropagationCache(BilinearForm(psi, phi)).update(**cache_update_kwargs)
        if alg == "loopcorrections":
            from .loopcorrections import loopcorrected_partitionfunction

            return loopcorrected_partitionfunction(cache, kwargs.pop("max_configuration_size"))
        return cache.partitionfunction()
    if alg == "boundarymps":
        return _bmps().inner_boundarymps(psi, phi, **kwargs)
    raise ValueError(f"unsupported alg {alg!r} for inner")


# ----------------------------------------------------------------------
# normalize
# ----------------------------------------------------------------------

def normalize(psi: TensorNetworkState, alg: str = "bp", cache_update_kwargs: dict | None = None) -> TensorNetworkState:
    """BP-normalize: after this, `norm_sqr(psi, alg="bp") ~ 1` and all local
    BP scalars are 1."""
    algorithm_check(psi, "normalize", alg)
    if alg != "bp":
        raise ValueError("normalize currently supports only alg='bp'")
    cache_update_kwargs = default_bp_update_kwargs(psi) if cache_update_kwargs is None else cache_update_kwargs
    bpc = BeliefPropagationCache(psi).update(**cache_update_kwargs)
    bpc.rescale_()
    return bpc.network


# ----------------------------------------------------------------------
# reduced density matrices
# ----------------------------------------------------------------------

def normalize_rdm(rho: Tensor) -> Tensor:
    tr = rho.trace_pairs().item()
    return rho * (1.0 / tr)


def rdm_matrix(rho: Tensor) -> np.ndarray:
    """Canonical dense matrix of an RDM tensor on the host: rows are the
    unprimed site indices (sorted by identity), columns their primes in the
    same order."""
    row = sorted([i for i in rho.inds if i.plev == 0], key=lambda i: i.id)
    col = [i.prime() for i in row]
    return rho.matricize(row, col).detach().resolve_conj().cpu().numpy()


def reduced_density_matrix(psi, verts, alg: str | None = None, normalize: bool = True, **kwargs) -> Tensor:
    alg = default_alg(psi) if alg is None else alg
    algorithm_check(psi, "rdm", alg)
    g = psi.graph
    verts = collect_vertices(verts, g)
    if alg == "exact":
        op_f = lambda v: "ρ" if v in verts else "I"
        tensors = psi.norm_factors(psi.vertices(), op_strings=op_f)
        seq = contraction_sequence(tensors, alg="greedy")
        rho = contract(tensors, sequence=seq)
    elif alg == "bp":
        if isinstance(psi, TensorNetworkState):
            cache_update_kwargs = kwargs.pop("cache_update_kwargs", None) or default_bp_update_kwargs(psi)
            cache = BeliefPropagationCache(psi).update(**cache_update_kwargs)
        else:
            cache = psi
        steiner_vs = verts if len(verts) == 1 else steiner_tree(cache.graph, verts).vertices()
        op_f = lambda v: "ρ" if v in verts else "I"
        tensors = cache.network.norm_factors(steiner_vs, op_strings=op_f)
        tensors += cache.incoming_messages(list(steiner_vs))
        seq = contraction_sequence(tensors, alg="optimal")
        rho = contract(tensors, sequence=seq)
    elif alg == "boundarymps":
        rho = _bmps().rdm_boundarymps(psi, verts, **kwargs)
    else:
        raise ValueError(f"unsupported alg {alg!r} for rdm")
    if normalize:
        rho = normalize_rdm(rho)
    return rho


rdm = reduced_density_matrix


# ----------------------------------------------------------------------
# entanglement entropies
# ----------------------------------------------------------------------

def renyi_entropy_matrix(rho: np.ndarray, alpha: float, normalize: bool = True) -> float:
    """Renyi entropy of a density matrix; alpha=1 is the von Neumann limit."""
    rho = np.asarray(rho)
    if normalize:
        rho = rho / np.trace(rho)
    lams = np.linalg.eigvalsh((rho + rho.conj().T) / 2)
    lams = lams[np.abs(lams) > 10 * np.finfo(lams.dtype).eps]
    if alpha == 1:
        return float(-np.sum(lams * np.log(lams)))
    return float(np.log(np.sum(lams**alpha)) / (1 - alpha))


def renyi_entropy(arg, *args, alpha: float = 1, **kwargs) -> float:
    """Renyi entropy of a density matrix (array or Tensor), of a bond of a
    BP cache (`renyi_entropy(bpc, edge)`), or of a vertex subsystem
    (`renyi_entropy(psi, verts, alg=...)`)."""
    if isinstance(arg, torch.Tensor):
        arg = arg.detach().resolve_conj().cpu().numpy()
    if isinstance(arg, np.ndarray):
        return renyi_entropy_matrix(arg, alpha, **kwargs)
    if isinstance(arg, Tensor) and not args:
        return renyi_entropy_matrix(rdm_matrix(arg), alpha, **kwargs)
    if isinstance(arg, BeliefPropagationCache) and args and _is_edge(args[0], arg.graph):
        return _bond_renyi_entropy(arg, args[0], alpha)
    if isinstance(arg, TensorNetworkState) and args and _is_edge(args[0], arg.graph):
        alg = kwargs.pop("alg", "bp")
        algorithm_check(arg, "rdm", alg)
        bpc = BeliefPropagationCache(arg).update(**default_bp_update_kwargs(arg))
        return _bond_renyi_entropy(bpc, args[0], alpha)
    # subsystem entropy via RDM
    verts = args[0]
    alg = kwargs.pop("alg", None)
    rho = reduced_density_matrix(arg, verts, alg=alg, normalize=False, **kwargs)
    return renyi_entropy_matrix(rdm_matrix(rho), alpha, normalize=True)


def _is_edge(x, g: NamedGraph) -> bool:
    return (
        isinstance(x, tuple)
        and len(x) == 2
        and g.has_vertex(x[0])
        and g.has_vertex(x[1])
        and g.has_edge(*x)
    )


def _bond_renyi_entropy(bpc: BeliefPropagationCache, e, alpha: float) -> float:
    """Bond entanglement directly from the two BP messages, no RDM."""
    m1 = bpc.message(tuple(e))
    m2 = bpc.message(reverse_edge(e))
    vinds = bpc.network.virtualinds(e)
    if len(vinds) != 1:
        raise ValueError("bond entropy requires a single bond index")
    l = vinds[0]
    root_m2, _ = pseudo_sqrt_inv_sqrt(m2)
    rho = (m1 * root_m2.replaceind(l.prime(), l.prime(2))) * root_m2
    rho = rho.replaceind(l.prime(2), l.prime())
    return renyi_entropy(rho, alpha=alpha)


def von_neumann_entanglement_entropy(*args, **kwargs) -> float:
    return renyi_entropy(*args, alpha=1, **kwargs)


def second_renyi_entanglement_entropy(*args, **kwargs) -> float:
    return renyi_entropy(*args, alpha=2, **kwargs)


# ----------------------------------------------------------------------
# whole-network contraction dispatch
# ----------------------------------------------------------------------

def contract_network(tn, alg: str = "exact", **kwargs):
    """Contract a scalar network to a number with the chosen algorithm;
    `alg="exact"` takes `sequence_alg`, a planner name or a callable (the
    protocol of `contraction_sequence`)."""
    if alg == "exact":
        tensors = [tn[v] for v in tn.vertices()]
        seq = contraction_sequence(
            tensors, alg=kwargs.pop("sequence_alg", "greedy")
        )
        return contract(tensors, sequence=seq).item()
    if alg == "bp":
        bp_update_kwargs = kwargs.pop("bp_update_kwargs", None) or default_bp_update_kwargs(tn)
        return BeliefPropagationCache(tn).update(**bp_update_kwargs).partitionfunction()
    if alg == "boundarymps":
        return _bmps().contract_boundarymps(tn, **kwargs)
    raise ValueError(f"unknown contraction alg {alg!r}")
