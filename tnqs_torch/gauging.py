"""Symmetric (Vidal) gauge from the BP fixed point (port of
`tnqs/gauging.py`): per edge the two messages' inverse roots go into the
site tensors, the central matrix ``sqrt(X) sqrt(Y)`` is SVD'd, its singular
values become the bond messages and ``sqrt(S)`` goes to both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from .bp import BeliefPropagationCache
from .core.index import Index
from .core.linalg import map_diag, map_eigs, svd
from .graphs import reverse_edge
from .networks import TensorNetworkState


def symmetric_gauge_(bpc: BeliefPropagationCache, regularization: float | None = None) -> BeliefPropagationCache:
    """In-place symmetric gauge transform of the cache's state and messages."""
    tn = bpc.network
    if not isinstance(tn, TensorNetworkState):
        raise TypeError("Can only transform TensorNetworkStates to the symmetric gauge")
    if regularization is None:
        regularization = 10 * torch.finfo(tn.real_dtype()).eps
    for e in bpc.edges():
        vsrc, vdst = e
        psi_src, psi_dst = tn[vsrc], tn[vdst]
        edge_inds = tn.virtualinds(e)
        if len(edge_inds) != 1:
            raise ValueError("symmetric gauge requires a single bond index per edge")
        l = edge_inds[0]
        l_sim = l.sim()
        X = bpc.message(e)
        Y = bpc.message(reverse_edge(e))
        root_x = map_eigs(X, lambda w: np.sqrt(np.real(w) + regularization))
        inv_root_x = map_eigs(X, lambda w: 1.0 / np.sqrt(np.real(w) + regularization))
        root_y = map_eigs(Y, lambda w: np.sqrt(np.real(w) + regularization))
        inv_root_y = map_eigs(Y, lambda w: 1.0 / np.sqrt(np.real(w) + regularization))
        psi_src = (psi_src * inv_root_x).noprime()
        psi_dst = (psi_dst * inv_root_y).noprime()
        Ce = root_x * root_y.replaceind(l, l_sim)  # (l, l_sim)
        U, S, V, _ = svd(Ce, [l])
        u = next(i for i in S.inds if U.hasind(i))
        v = next(i for i in S.inds if V.hasind(i))
        new_l = Index(u.dim, l.tag)
        psi_src = (psi_src * U).replaceind(u, new_l)
        psi_dst = psi_dst.replaceind(l, l_sim)
        psi_dst = (psi_dst * V).replaceind(v, new_l)
        S = S.replaceinds([u, v], [new_l, new_l.prime()])
        sqrt_S = map_diag(S, np.sqrt)
        bpc.set_preserve(vsrc, (psi_src * sqrt_S).noprime())
        bpc.set_preserve(vdst, (psi_dst * sqrt_S).noprime())
        bpc.set_message(e, S)
        bpc.set_message(reverse_edge(e), S.dag())
    return bpc


def symmetric_gauge(psi, regularization: float | None = None, cache_update_kwargs: dict | None = None):
    """Symmetric gauge of a cache (a new cache) or a state (a new state,
    BP run first)."""
    if isinstance(psi, BeliefPropagationCache):
        return symmetric_gauge_(psi.copy(), regularization=regularization)
    cache_update_kwargs = {"maxiter": 40} if cache_update_kwargs is None else cache_update_kwargs
    bpc = BeliefPropagationCache(psi).update(**cache_update_kwargs)
    return symmetric_gauge_(bpc, regularization=regularization).network


def symmetrize_and_normalize(bpc: BeliefPropagationCache, **kwargs) -> BeliefPropagationCache:
    """Rescale to unit local scalars, then symmetric-gauge."""
    return symmetric_gauge_(bpc.rescale(), **kwargs)


def gauge_and_scale(psi: TensorNetworkState, cache_update_kwargs: dict | None = None, **kwargs) -> TensorNetworkState:
    """BP update, rescale and symmetric gauge, returning the state."""
    cache_update_kwargs = {"maxiter": 40} if cache_update_kwargs is None else cache_update_kwargs
    bpc = BeliefPropagationCache(psi).update(**cache_update_kwargs)
    return symmetrize_and_normalize(bpc, **kwargs).network
