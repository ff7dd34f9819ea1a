"""Boundary-MPS cache of the flex tier (port of `tnqs/boundarymps.py`):
controllably accurate contraction of planar networks, separate from the
compiled tier's `bmps_engine` as in the JAX package.

The graph is partitioned into rows (or columns); the interpartition
messages on the sorted parallel edges are chained with extra virtual
indices into an implicit MPS of bond dimension `mps_bond_dimension`.  Two
message-update algorithms: ``"fitting"`` (one-site variational sweeps with
QR gauge moves, the default for states and forms) and ``"zipup"``
(positional MPO x MPS zip-up and a right-to-left SVD recompression, the
default for scalar networks and the engine of projected sampling).  The
outer `update` runs the BP loop over the quotient edges.  A fitting sweep
sums its messages' norms on the device and reads the sum once per
iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from .bp import AbstractBeliefPropagationCache, BeliefPropagationCache, default_tolerance
from .contraction import contract, contraction_sequence
from .core.index import Index
from .core.linalg import factorize
from .core.tensor import Tensor, commoninds, uniqueinds
from .forms import BilinearForm, QuadraticForm
from .graphs import (
    NamedGraph,
    PartitionedGraph,
    a_star,
    center,
    forest_cover_edge_sequence,
    is_line_graph,
    is_ring_graph,
    is_tree,
    leaf_vertices,
    post_order_dfs_edges,
    reverse_edge,
)
from .networks import TensorNetwork, TensorNetworkState

_DEFAULT_FITTING_NITERS = 50


def default_bmps_message_update_alg(network) -> str:
    if isinstance(network, (TensorNetworkState, BilinearForm, QuadraticForm)):
        return "fitting"
    if isinstance(network, TensorNetwork):
        return "zipup"
    raise TypeError(
        f"no default boundary-MPS message-update algorithm for {type(network).__name__}; "
        "expected a TensorNetworkState, TensorNetwork, or form"
    )


def default_bmps_update_kwargs(network) -> dict:
    return dict(tolerance=None, verbose=False)


class BoundaryMPSCache(AbstractBeliefPropagationCache):
    """Boundary-MPS message cache."""

    def __init__(
        self,
        network,
        mps_bond_dimension: int,
        partition_by: str = "row",
        gauge_state: bool = False,
        set_messages: bool = True,
        _internal: tuple | None = None,
    ):
        if _internal is not None:
            self.network = network
            self.mps_bond_dimension = mps_bond_dimension
            (self.supergraph, self.sorted_edges_map, self.messages, self.seq_cache) = _internal
            return
        if gauge_state and isinstance(network, TensorNetworkState):
            from .gauging import gauge_and_scale

            network = gauge_and_scale(network)
        self.network = network
        self.mps_bond_dimension = int(mps_bond_dimension)
        group_fn = (lambda v: v[0]) if partition_by == "row" else (lambda v: v[-1])

        # pseudo planar edges make each partition a connected line
        #
        planar = network.graph.copy()
        all_vs = planar.vertices()
        group_keys = []
        groups: dict = {}
        for v in sorted(all_vs):
            k = group_fn(v)
            if k not in groups:
                groups[k] = []
                group_keys.append(k)
            groups[k].append(v)
        for k in group_keys:
            vs = groups[k]
            for i in range(len(vs) - 1):
                if not planar.has_edge(vs[i], vs[i + 1]):
                    planar.add_edge(vs[i], vs[i + 1])
        self.supergraph = PartitionedGraph(planar, {k: groups[k] for k in sorted(group_keys)})

        # sorted parallel edges per quotient edge
        self.sorted_edges_map: dict = {}
        for qe in self.quotient_edges():
            self.sorted_edges_map[qe] = self._compute_sorted_edges(qe)

        self.messages: dict = {}
        self.seq_cache: dict = {}
        self._check_format()
        if set_messages:
            self.set_interpartition_messages()

    # ------------------------------------------------------------------
    # structure queries
    # ------------------------------------------------------------------
    @property
    def graph(self) -> NamedGraph:
        # the planar graph (with pseudo edges); intra-partition messages and
        # incoming-message gathering run on this graph
        return self.supergraph.graph

    def quotient_graph(self) -> NamedGraph:
        return self.supergraph.quotient

    def quotient_vertices(self) -> list:
        return self.supergraph.quotient.vertices()

    def quotient_edges(self) -> list:
        es = self.supergraph.quotient.edges()
        return es + [reverse_edge(e) for e in es]

    def quotient_of(self, v):
        return self.supergraph.group_of[v]

    def partition_vertices(self, qv) -> list:
        return self.supergraph.vertices_of(qv)

    def sorted_edges(self, qe) -> list:
        return self.sorted_edges_map[qe]

    def _compute_sorted_edges(self, qe) -> list:
        """Bottom-to-top parallel edges between two partitions."""
        src_vs = self.partition_vertices(qe[0])
        dst_vs = set(self.partition_vertices(qe[1]))
        out = []
        for sv in src_vs:
            for u in self.graph.neighbors(sv):
                if u in dst_vs:
                    out.append((sv, u))
        return out

    def partition_graph(self, qv) -> NamedGraph:
        vs = self.partition_vertices(qv)
        return self.graph.subgraph(vs)

    def _check_format(self) -> None:
        q = self.quotient_graph()
        if not is_ring_graph(q) and not is_line_graph(q):
            raise ValueError(
                "boundary MPS needs the partition quotient graph to be a path or "
                "a cycle; this partitioning produces neither"
            )
        for qv in self.quotient_vertices():
            if not is_line_graph(self.partition_graph(qv)):
                raise ValueError(
                    f"boundary MPS needs every partition to be a path; partition "
                    f"{qv!r} is not"
                )

    def copy(self) -> "BoundaryMPSCache":
        return BoundaryMPSCache(
            self.network.copy(),
            self.mps_bond_dimension,
            _internal=(
                self.supergraph,
                self.sorted_edges_map,
                dict(self.messages),
                dict(self.seq_cache),
            ),
        )

    def default_maxiter(self) -> int:
        return 1 if is_tree(self.quotient_graph()) else 5

    # ------------------------------------------------------------------
    # interpartition message initialization
    #
    # ------------------------------------------------------------------
    def virtual_index_dimension(self, e1, e2) -> int:
        qe = (self.quotient_of(e1[0]), self.quotient_of(e1[1]))
        es = self.sorted_edges(qe)
        i1, i2 = es.index(tuple(e1)), es.index(tuple(e2))
        lower, upper = (e2, e1) if i1 > i2 else (e1, e2)
        li, ui = min(i1, i2), max(i1, i2)
        net = self.network
        dims_above = [i.dim for e in es[li + 1:] for i in net.virtualinds(e)]
        dims_below = [i.dim for e in es[:ui] for i in net.virtualinds(e)]
        x1 = float(np.prod(dims_above)) if dims_above else 1.0
        x2 = float(np.prod(dims_below)) if dims_below else 1.0
        if isinstance(net, TensorNetwork) and not isinstance(net, TensorNetworkState):
            return int(min(x1, x2, float(self.mps_bond_dimension)))
        return int(min(x1 * x1, x2 * x2, float(self.mps_bond_dimension)))

    def set_interpartition_messages(self, quotient_edges=None) -> None:
        qes = self.quotient_edges() if quotient_edges is None else quotient_edges
        for qe in qes:
            es = self.sorted_edges(qe)
            for e in es:
                if tuple(e) not in self.messages:
                    self.set_message(e, self.default_message(e))
            for i in range(len(es) - 1):
                virt = self.virtual_index_dimension(es[i], es[i + 1])
                ind = Index(virt, f"m{i}{i + 1}")
                ones = self.network._adapt_like(
                    Tensor(torch.ones(virt, dtype=self.network.real_dtype(), device=self.network.device), [ind])
                )
                self.set_message(es[i], self.message(es[i]) * ones)
                self.set_message(es[i + 1], self.message(es[i + 1]) * ones)

    # ------------------------------------------------------------------
    # intra-partition updates (reference `update_partition!`,
    # `boundarympscache.jl:228-249`)
    # ------------------------------------------------------------------
    def update_partition_(self, seq_or_qv) -> None:
        if isinstance(seq_or_qv, list):
            seq = seq_or_qv
        else:
            seq = forest_cover_edge_sequence(self.partition_graph(seq_or_qv))
        for e in seq:
            self.update_message(e, normalize=False)

    def update_partition(self, seq_or_qv) -> "BoundaryMPSCache":
        out = self.copy()
        out.update_partition_(seq_or_qv)
        return out

    def update_partitions_(self, vertices_or_qvs: list) -> None:
        qvs = []
        for x in vertices_or_qvs:
            qv = self.quotient_of(x) if x in self.supergraph.group_of else x
            if qv not in qvs:
                qvs.append(qv)
        for qv in qvs:
            self.update_partition_(qv)

    def update_partitions(self, vertices_or_qvs: list) -> "BoundaryMPSCache":
        out = self.copy()
        out.update_partitions_(vertices_or_qvs)
        return out

    def delete_partition_messages_(self, qv) -> None:
        g = self.partition_graph(qv)
        es = g.edges()
        self.delete_messages([e for e in es + [reverse_edge(x) for x in es]])

    def delete_interpartition_messages_(self, qe) -> None:
        self.delete_messages(self.sorted_edges(qe))

    # ------------------------------------------------------------------
    # gauge moves on the workspace MPS (reference `gauge_step!`,
    # `boundarympscache.jl:270-298`)
    # ------------------------------------------------------------------
    def gauge_step_(self, e1, e2) -> None:
        m1, m2 = self.message(e1), self.message(e2)
        shared = commoninds(m1, m2)
        if not shared:
            raise ValueError("gauge step requires adjacent messages sharing an index")
        left_inds = uniqueinds(m1, m2)
        m1_new, Y = factorize(m1, left_inds, ortho="left")
        self.set_message(e1, m1_new)
        self.set_message(e2, m2 * Y)

    def gauge_walk_(self, seq) -> None:
        for e1, e2 in seq:
            self.gauge_step_(e1, e2)

    def switch_messages_(self, qe) -> None:
        """Swap (and conjugate) forward/backward messages on an
        interpartition."""
        for e in self.sorted_edges(qe):
            me, mer = self.message(e), self.message(reverse_edge(e))
            self.set_message(e, mer.dag() if isinstance(mer, Tensor) else [t.dag() for t in mer])
            self.set_message(reverse_edge(e), me.dag() if isinstance(me, Tensor) else [t.dag() for t in me])

    def prev_quotient_edge(self, qe):
        """The quotient edge feeding into src(qe) from the other side."""
        q = self.quotient_graph()
        vns = q.neighbors(qe[0])
        if len(vns) == 1:
            return None
        if len(vns) != 2:
            raise ValueError("quotient graph must be a line or ring")
        v1, v2 = vns
        if qe[1] == v1:
            return (v2, qe[0])
        if qe[1] == v2:
            return (v1, qe[0])
        raise ValueError(f"{qe} is not a quotient edge")

    # ------------------------------------------------------------------
    # fitting update (reference `update_message!(::Algorithm"fitting")`,
    # `boundarympscache.jl:330-369`)
    # ------------------------------------------------------------------
    def _update_message_fitting(
        self, qe, niters: int | None = None, tolerance: float | None = "auto", normalize: bool = True
    ) -> None:
        if niters is None:
            niters = _DEFAULT_FITTING_NITERS
        if tolerance == "auto":
            tolerance = default_tolerance(self.dtype())
        self.delete_partition_messages_(qe[0])
        self.switch_messages_(qe)
        es = self.sorted_edges(qe)
        g_p = self.partition_graph(qe[0])
        update_seq = list(es) + [es[i] for i in range(len(es) - 2, 0, -1)]

        init_gauge_seq = [
            (reverse_edge(es[i]), reverse_edge(es[i - 1])) for i in range(len(es) - 1, 0, -1)
        ]
        init_update_seq = post_order_dfs_edges(g_p, update_seq[0][0])
        if init_gauge_seq:
            self.gauge_walk_(init_gauge_seq)
        if init_update_seq:
            self.update_partition_(init_update_seq)

        prev_cf, prev_e = 0.0, None
        for it in range(niters):
            cf = None
            if it == niters - 1:
                update_seq = update_seq + [es[0]]
            for update_e in update_seq:
                if prev_e is not None:
                    self.gauge_step_(reverse_edge(prev_e), reverse_edge(update_e))
                    path = a_star(g_p, prev_e[0], update_e[0])
                    self.update_partition_(path)
                m = self.updated_message(update_e, normalize=False)
                n = m.norm_t()
                nd = n.to(torch.float64)
                cf = nd if cf is None else cf + nd
                if normalize:
                    m = Tensor(torch.where(n != 0, m.data / n, m.data), m.inds)
                self.set_message(reverse_edge(update_e), m.dag())
                prev_e = update_e
            cf = float(cf) / len(update_seq)
            eps = abs(cf - prev_cf)
            if tolerance is not None and eps < tolerance:
                break
            prev_cf = cf
        self.delete_partition_messages_(qe[0])
        self.switch_messages_(qe)

    # ------------------------------------------------------------------
    # zip-up update (reference `generic_apply` + `update_message!(zipup)`,
    # `boundarympscache.jl:389-502`)
    # ------------------------------------------------------------------
    def _bmps_apply_inputs(self, qe, incoming_mps=None):
        net = self.network
        sorted_vs = sorted(self.partition_vertices(qe[0]))
        pos = {v: i for i, v in enumerate(sorted_vs)}
        b = len(sorted_vs)
        mpo = [net[v] for v in sorted_vs]
        mps: dict[int, Tensor] = {}
        prev_qe = self.prev_quotient_edge(qe)
        if prev_qe is not None:
            for k, e in enumerate(self.sorted_edges(prev_qe)):
                t = self.message(e) if incoming_mps is None else incoming_mps[k]
                mps[pos[e[1]]] = t
        right_inds = [[] for _ in range(b)]
        for e in self.sorted_edges(qe):
            right_inds[pos[e[0]]] = list(net.virtualinds(e))
        return mpo, mps, right_inds

    def _update_message_zipup(self, qe, cutoff: float = 1.0e-12, normalize: bool = True, maxdim: int | None = None) -> None:
        maxdim = self.mps_bond_dimension if maxdim is None else maxdim
        mpo, mps, right_inds = self._bmps_apply_inputs(qe)
        out = generic_apply(mpo, mps, right_inds, cutoff=cutoff, maxdim=maxdim, normalize=normalize)
        es = self.sorted_edges(qe)
        for i, t in enumerate(out):
            self.set_message(es[i], t)

    # ------------------------------------------------------------------
    # outer BP loop over quotient edges (reference `set_default_kwargs` +
    # abstract update, `boundarympscache.jl:17-30`)
    # ------------------------------------------------------------------
    def bp_edge_sequence(self) -> list:
        return forest_cover_edge_sequence(self.quotient_graph())

    def update(
        self,
        maxiter: int | None = None,
        edge_sequence: list | None = None,
        message_update_alg: str | None = None,
        tolerance=None,
        verbose: bool = False,
        **alg_kwargs,
    ) -> "BoundaryMPSCache":
        """Update all interpartition MPS messages.

        `edge_sequence` is a list of quotient edges (pairs of partition
        keys).  `message_update_alg` is "fitting" or "zipup".
        """
        del tolerance, verbose  # outer quotient loop runs fixed iterations
        maxiter = self.default_maxiter() if maxiter is None else maxiter
        edge_sequence = self.bp_edge_sequence() if edge_sequence is None else list(edge_sequence)
        alg = (
            default_bmps_message_update_alg(self.network)
            if message_update_alg is None
            else message_update_alg
        )
        out = self.copy()
        out.invalidate_sequences()
        for _ in range(maxiter):
            for qe in edge_sequence:
                if alg == "fitting":
                    out._update_message_fitting(tuple(qe), **alg_kwargs)
                elif alg == "zipup":
                    out._update_message_zipup(tuple(qe), **alg_kwargs)
                else:
                    raise ValueError(f"unknown BMPS message update alg {alg!r}")
        out.invalidate_sequences()
        return out

    # ------------------------------------------------------------------
    # scalars over the quotient structure (reference
    # `boundarympscache.jl:504-556`)
    # ------------------------------------------------------------------
    def vertex_scalar(self, v):
        if v in self.supergraph.groups:  # a quotient vertex
            g_p = self.partition_graph(v)
            c = center(g_p)[0]
            work = self.update_partition(post_order_dfs_edges(g_p, c))
            return AbstractBeliefPropagationCache.vertex_scalar(work, c)
        return AbstractBeliefPropagationCache.vertex_scalar(self, v)

    def edge_scalar(self, qe):
        es = self.sorted_edges(tuple(qe))
        out = None
        for e in es:
            term = self.message(e) * self.message(reverse_edge(e))
            out = term if out is None else out * term
        return out.item()

    def vertex_scalars(self, vertices=None) -> list:
        vertices = self.quotient_vertices() if vertices is None else vertices
        return [self.vertex_scalar(v) for v in vertices]

    def edge_scalars(self, edges=None) -> list:
        edges = self.quotient_graph().edges() if edges is None else edges
        return [self.edge_scalar(e) for e in edges]

    # ------------------------------------------------------------------
    # observable contraction along a partition path (reference
    # `path_contract`, `boundarympscache.jl:616-667`)
    # ------------------------------------------------------------------
    def path_contract(self, vs: list, op_string_f, bmps_messages_up_to_date: bool = False, calculate_denom: bool = True):
        qvs = []
        for v in vs:
            q = self.quotient_of(v)
            if q not in qvs:
                qvs.append(q)
        if len(qvs) > 1:
            raise ValueError(
                "Observable support must be within a single partition (row/"
                "column) of the graph for now."
            )
        qv = qvs[0]
        g_p = self.partition_graph(qv)
        cache = self if bmps_messages_up_to_date else self.update_partition(qv)
        denom = cache.vertex_scalar(vs[0]) if calculate_denom else 0

        net = cache.network
        if len(vs) > 1:
            lvs = leaf_vertices(g_p)
            if len(lvs) != 2:
                raise ValueError("partition must be an open line")
            lv1, lv2 = lvs
            path = a_star(g_p, lv1, lv2)
            lv1_vns = g_p.neighbors(lv1)
            if len(lv1_vns) == 1:
                prev_edge, m = None, None
            else:
                others = [u for u in lv1_vns if u != lv2]
                prev_edge = (others[0], lv1)
                m = cache.message(prev_edge)
            for e in path:
                ignore = [reverse_edge(e)] if prev_edge is None else [reverse_edge(e), prev_edge]
                incoming = cache.incoming_messages(e[0], ignore_edges=ignore)
                contract_list = net.norm_factors([e[0]], op_strings=op_string_f) + incoming
                if m is not None:
                    contract_list.append(m)
                seq = contraction_sequence(contract_list, alg="optimal")
                m = contract(contract_list, sequence=seq)
                prev_edge = e
            contract_list = net.norm_factors([lv2], op_strings=op_string_f)
            contract_list += cache.incoming_messages(lv2, ignore_edges=[path[-1]])
            contract_list.append(m)
            seq = contraction_sequence(contract_list, alg="optimal")
            numer = contract(contract_list, sequence=seq)
        else:
            contract_list = net.norm_factors(vs, op_strings=op_string_f)
            contract_list += cache.incoming_messages(vs[0])
            seq = contraction_sequence(contract_list, alg="optimal")
            numer = contract(contract_list, sequence=seq)
        return numer, denom


# ----------------------------------------------------------------------
# position-indexed MPOxMPS zip-up apply (reference `generic_apply`,
# `boundarympscache.jl:401-450`)
# ----------------------------------------------------------------------

def generic_apply(mpo, mps: dict, right_inds, cutoff: float = 0.0, maxdim=None, normalize: bool = True):
    """Apply an incoming MPS through an MPO chain, emitting a truncated MPS.

    ``mpo[i]`` are the chain tensors at positions 0..b-1; ``mps`` maps a
    position to the incoming MPS tensor attached there; ``right_inds[i]`` are
    the outgoing site legs (may be empty — such positions just thread their
    bonds).  Forward zip-up sweep with left-orthogonal truncation, then a
    right-to-left SVD recompression.
    """
    b = len(mpo)
    if len(right_inds) != b:
        raise ValueError("right_inds must have one entry per MPO position")
    out: list[Tensor] = []
    carry = None
    left_link = None
    for i in range(b):
        T = mpo[i]
        if i in mps:
            T = T * mps[i]
        if carry is not None:
            T = carry * T
        site = list(right_inds[i])
        if not site:
            carry = T
            continue
        keep = site if left_link is None else site + [left_link]
        L, R = factorize(T, keep, ortho="left", cutoff=cutoff if cutoff else 1e-300, maxdim=maxdim)
        out.append(L)
        carry = R
        shared = commoninds(L, R)
        left_link = shared[0]
    if not out:
        raise ValueError("generic_apply: no outgoing site indices, nothing to build an MPS from")
    if carry is not None:
        out[-1] = out[-1] * carry
    # back sweep: right-to-left recompression
    for i in range(len(out) - 1, 0, -1):
        bond = commoninds(out[i - 1], out[i])
        L, R = factorize(out[i], bond, ortho="right", cutoff=cutoff if cutoff else 1e-300, maxdim=maxdim)
        out[i] = R
        out[i - 1] = out[i - 1] * L
    if normalize:
        out[0] = out[0].normalize()
    return out


# ----------------------------------------------------------------------
# measurement entry points used by `tnqs.measure`
# (reference `expect.jl:84-156`, `norm_sqr.jl:80-88`, `inner.jl:71-76`,
# `rdm.jl:77-124`, `contract.jl:11-13`)
# ----------------------------------------------------------------------

def with_default_maxiter(kwargs: dict, cache: BoundaryMPSCache) -> dict:
    out = dict(kwargs)
    out.setdefault("maxiter", cache.default_maxiter())
    return out


def expect_boundarymps(
    psi,
    observables: list,
    mps_bond_dimension: int | None = None,
    partition_by: str | None = None,
    cache_update_kwargs: dict | None = None,
    gauge_state: bool = True,
    bmps_messages_up_to_date: bool = False,
    **kwargs,
):
    from .measure import (
        boundarymps_partitioning,
        collectobservable,
        observables_vertices,
        op_string_function,
    )

    if isinstance(psi, BoundaryMPSCache):
        cache = psi
    else:
        if mps_bond_dimension is None:
            raise ValueError("expect with alg='boundarymps' requires mps_bond_dimension")
        if partition_by is None:
            partition_by = boundarymps_partitioning(observables, psi.graph)
        cache = BoundaryMPSCache(psi, mps_bond_dimension, partition_by=partition_by, gauge_state=gauge_state)
        cu = with_default_maxiter(cache_update_kwargs or {}, cache)
        cache = cache.update(**cu)
        bmps_messages_up_to_date = False
    obs_vs = observables_vertices(observables, cache.network.graph)
    if not bmps_messages_up_to_date:
        cache = cache.update_partitions(obs_vs)
    out = []
    for obs in observables:
        op_strings, vs, coeff = collectobservable(obs, cache.network.graph)
        if coeff == 0:
            out.append(0 * coeff)
            continue
        f = op_string_function(op_strings, vs)
        numer, denom = cache.path_contract(vs, f, bmps_messages_up_to_date=True)
        out.append(coeff * numer.item() / denom)
    return out


def norm_sqr_boundarymps(
    psi,
    mps_bond_dimension: int | None = None,
    partition_by: str = "row",
    cache_update_kwargs: dict | None = None,
    **kwargs,
):
    if isinstance(psi, BoundaryMPSCache):
        cache = psi
    else:
        cache = BoundaryMPSCache(psi, mps_bond_dimension, partition_by=partition_by)
        cu = with_default_maxiter(cache_update_kwargs or {}, cache)
        cache = cache.update(**cu)
    z = cache.partitionfunction()
    tn = cache.network
    if isinstance(tn, TensorNetworkState):
        return z
    if isinstance(tn, TensorNetwork):
        return z * z
    raise TypeError("Network type inside the cache is not a TensorNetworkState.")


def inner_boundarymps(
    psi, phi, mps_bond_dimension: int, partition_by: str = "row", cache_update_kwargs: dict | None = None, **kwargs
):
    form = BilinearForm(psi, phi)
    cache = BoundaryMPSCache(form, mps_bond_dimension, partition_by=partition_by)
    cu = with_default_maxiter(cache_update_kwargs or {}, cache)
    cache = cache.update(**cu)
    return cache.partitionfunction()


def rdm_boundarymps(
    psi,
    verts: list,
    mps_bond_dimension: int | None = None,
    partition_by: str | None = None,
    cache_update_kwargs: dict | None = None,
    bmps_messages_up_to_date: bool = False,
    **kwargs,
):
    if isinstance(psi, BoundaryMPSCache):
        cache = psi
    else:
        if partition_by is None:
            partition_by = _rdm_partitioning(verts)
        cache = BoundaryMPSCache(psi, mps_bond_dimension, partition_by=partition_by)
        cu = with_default_maxiter(cache_update_kwargs or {}, cache)
        cache = cache.update(**cu)
        bmps_messages_up_to_date = False
    op_f = lambda v: "ρ" if v in verts else "I"
    rho, _ = cache.path_contract(verts, op_f, bmps_messages_up_to_date=bmps_messages_up_to_date)
    return rho


def _rdm_partitioning(vs: list) -> str:
    if all(v[0] == vs[0][0] for v in vs):
        return "row"
    if all(v[-1] == vs[0][-1] for v in vs):
        return "col"
    raise ValueError(
        "Vertices must be aligned in either the same column or the same row to do BoundaryMPS."
    )


def contract_boundarymps(tn, mps_bond_dimension: int, bmps_update_kwargs: dict | None = None, **kwargs):
    cache = BoundaryMPSCache(tn, mps_bond_dimension)
    cu = with_default_maxiter(bmps_update_kwargs or {}, cache)
    cache = cache.update(**cu)
    return cache.partitionfunction()
