"""Contraction-sequence optimization (port of `tnqs/contraction.py`).

Algorithms, as the JAX package's:

* ``alg="optimal"``: exact dynamic programming over subsets, for the small
  local factor lists of BP message updates and regional contractions: the
  native planner up to `_OPTIMAL_MAX_NATIVE` tensors, the Python one up to
  `_OPTIMAL_MAX`, greedy beyond;
* ``alg="greedy"`` (alias ``"omeinsum"``): pairwise greedy minimizing the
  intermediate size, the native planner joining from `_GREEDY_NATIVE_MIN`
  tensors on, the candidate with the smaller largest intermediate kept;
* ``alg="sa"``/``"treesa"``: stochastic greedy with restarts (native);
* ``alg="treewidth"``/``"exacttreewidth"``: elimination orderings of the
  index graph (min-fill, or exact DP up to `_EXACT_TW_MAX` indices);
* ``alg="sabipartite"``/``"hypernd"``: recursive balanced bipartitions;
* a callable ``alg(index_sets, dims, **kwargs)``.

The native planner is the port's g++ build of
`tnqs_torch/csrc/host/contract_opt.cpp` (`ops/_build.host_library`, built
at first use; a failed build raises), the JAX package's search, so with
``native=True`` (the default) the port picks the same sequences as the JAX
package; ``native=False`` runs the pure-Python planners, the plain versions
the tests hold the native one against.  Sequences are nested lists of
1-based leaf positions, e.g. ``[[1, 3], 2]``.
"""

from __future__ import annotations

from math import prod
from typing import Sequence

import numpy as np

from .core.index import Index
from .core.tensor import Tensor, contract as _contract

_OPTIMAL_MAX = 10
# the native DP prunes in C++; exhaustive search stays tractable further out
_OPTIMAL_MAX_NATIVE = 16
# hand whole-network greedy planning to C++ above this size
_GREEDY_NATIVE_MIN = 24


# ---------------------------------------------------------------------------
# the native planner (`tnqs/native/__init__.py:144-276`)
# ---------------------------------------------------------------------------

def _pack(index_sets, dims):
    """Bitmask-encoded index sets over the index universe in `dims` order,
    and the log dimensions."""
    from math import log

    order = list(dims.keys())
    m = len(order)
    w = max(1, (m + 63) // 64)
    pos = {i: p for p, i in enumerate(order)}
    masks = np.zeros((len(index_sets), w), dtype=np.uint64)
    for k, s in enumerate(index_sets):
        for i in s:
            p = pos[i]
            masks[k, p // 64] |= np.uint64(1) << np.uint64(p % 64)
    logdims = np.zeros(w * 64, dtype=np.float64)
    for p, i in enumerate(order):
        logdims[p] = log(float(dims[i]))
    return masks, logdims, w, m


def _lib():
    from .ops import _build

    return _build.host_library()


def _native_optimal(index_sets, dims):
    n = len(index_sets)
    if n < 2 or n > 20:
        return None
    masks, logdims, w, m = _pack(index_sets, dims)
    out = np.zeros(1 << n, dtype=np.int32)
    if _lib().tnqs_optimal_order(n, w, masks.ctypes.data, logdims.ctypes.data, m, out.ctypes.data) != 0:
        return None

    def tree(mask: int):
        if mask & (mask - 1) == 0:
            return mask.bit_length()
        sub = int(out[mask])
        return [tree(sub), tree(mask ^ sub)]

    return tree((1 << n) - 1)


def _pairs_to_tree(out: np.ndarray, n: int):
    nodes: dict[int, object] = {k: k + 1 for k in range(n)}
    nid = n
    for s in range(n - 1):
        a, b = int(out[2 * s]), int(out[2 * s + 1])
        nodes[nid] = [nodes.pop(a), nodes.pop(b)]
        nid += 1
    return nodes[nid - 1]


def _native_greedy(index_sets, dims):
    n = len(index_sets)
    if n < 2:
        return None
    masks, logdims, w, m = _pack(index_sets, dims)
    out = np.zeros(2 * (n - 1), dtype=np.int32)
    if _lib().tnqs_greedy_order(n, w, masks.ctypes.data, logdims.ctypes.data, m, out.ctypes.data) != 0:
        return None
    return _pairs_to_tree(out, n)


def _native_sa(index_sets, dims, n_restarts: int = 32, temperature: float = 1.0, seed: int = 0):
    n = len(index_sets)
    if n < 2:
        return None
    masks, logdims, w, m = _pack(index_sets, dims)
    out = np.zeros(2 * (n - 1), dtype=np.int32)
    if _lib().tnqs_sa_order(n, w, masks.ctypes.data, logdims.ctypes.data, m, out.ctypes.data, int(n_restarts),
                            float(temperature), int(seed)) != 0:
        return None
    return _pairs_to_tree(out, n)


def _index_sets(tensors: Sequence[Tensor]) -> list[frozenset]:
    return [frozenset(t.inds) for t in tensors]


def _dims(tensors: Sequence[Tensor]) -> dict[Index, int]:
    out: dict[Index, int] = {}
    for t in tensors:
        for i in t.inds:
            out[i] = i.dim
    return out


def _validate_sequence(seq, n: int) -> None:
    """Check a nested leaf-position tree covers 1..n exactly once."""
    leaves: list[int] = []

    def walk(node):
        if isinstance(node, (int, np.integer)):
            leaves.append(int(node))
        elif isinstance(node, (list, tuple)):
            for sub in node:
                walk(sub)
        else:
            raise TypeError(f"bad sequence node {node!r}")

    walk(seq)
    if sorted(leaves) != list(range(1, n + 1)):
        raise ValueError(
            f"custom optimizer returned an invalid tree over {n} tensors: "
            f"leaves {sorted(leaves)}"
        )


def contraction_sequence(tensors: Sequence[Tensor], alg: str = "optimal", native: bool = True, **kwargs):
    """Find a pairwise contraction tree for `tensors`.

    `alg` is either one of the built-in optimizer names (module docstring)
    or a callable, the pluggable-optimizer protocol: it is invoked
    as ``alg(index_sets, dims, **kwargs)`` with `index_sets` a list of
    per-tensor frozensets of :class:`Index` objects and
    `dims` a dict Index -> dimension, and must return a nested 1-based
    leaf-position sequence (e.g. ``[[1, 3], 2]``).  The returned tree is
    validated before use.  ``native=False`` plans with the Python planners
    only (the JAX package's ``TNQS_NO_NATIVE``)."""
    n = len(tensors)
    if n == 0:
        raise ValueError("empty tensor list")
    if n == 1:
        return [1]
    if n == 2:
        return [1, 2]
    if callable(alg):
        seq = alg(_index_sets(tensors), _dims(tensors), **kwargs)
        _validate_sequence(seq, n)
        return seq
    if alg == "optimal":
        if native and n <= _OPTIMAL_MAX_NATIVE:
            seq = _native_optimal(_index_sets(tensors), _dims(tensors))
            if seq is not None:
                return seq
        if n <= _OPTIMAL_MAX:
            return _optimal_sequence(tensors)
    if alg in ("sa", "treesa") and native:
        # stochastic greedy with restarts (TreeSA-class annealing search)
        seq = _native_sa(
            _index_sets(tensors),
            _dims(tensors),
            n_restarts=int(kwargs.get("n_restarts", 32)),
            temperature=float(kwargs.get("temperature", 1.0)),
            seed=int(kwargs.get("seed", 0)),
        )
        if seq is not None:
            return seq
    if alg in ("treewidth", "exacttreewidth"):
        return _treewidth_sequence(tensors, exact=alg == "exacttreewidth", **kwargs)
    if alg == "sabipartite":
        return _bipartite_sequence(tensors, refine="sa", native=native, **kwargs)
    if alg == "hypernd":
        return _bipartite_sequence(tensors, refine="fm", native=native, **kwargs)
    cands = []
    if native and n >= _GREEDY_NATIVE_MIN:
        seq = _native_greedy(_index_sets(tensors), _dims(tensors))
        if seq is not None:
            cands.append(seq)
    # Guard against catastrophic greedy trees: on cyclic (e.g. ring-quotient)
    # networks a near-tie in the greedy score can commit to a tree whose
    # largest intermediate carries O(boundary-of-the-whole-ring) open
    # indices (observed: a 2^36-element intermediate on a 6x3 cylinder
    # bilinear sandwich — a 512 GiB einsum).  Simulating a candidate's max
    # intermediate size is O(n); pick the best candidate and escalate to
    # the annealed search if everything greedy still blows past the cap.
    cands.append(_greedy_sequence(tensors))
    pick = min(cands, key=lambda s: _seq_max_intermediate(tensors, s))
    if (
        _seq_max_intermediate(tensors, pick) > _SEQ_INTERMEDIATE_CAP
        and native
    ):
        seq = _native_sa(
            _index_sets(tensors), _dims(tensors),
            n_restarts=32, temperature=1.0, seed=0,
        )
        if seq is not None and _seq_max_intermediate(
            tensors, seq
        ) < _seq_max_intermediate(tensors, pick):
            pick = seq
    return pick


def _result_inds(s1: frozenset, s2: frozenset) -> frozenset:
    # every index appears on at most two tensors in our networks, so the
    # result of a pairwise contraction keeps the symmetric difference
    return s1 ^ s2


# a planned sequence whose largest intermediate exceeds this many elements
# triggers escalation to the annealed search (2^27 elements = 1 GiB c64)
_SEQ_INTERMEDIATE_CAP = 2**27


def _seq_max_intermediate(tensors: Sequence[Tensor], seq) -> int:
    """Largest intermediate (in elements) a contraction tree materializes."""
    sets = _index_sets(tensors)
    dimsz = _dims(tensors)

    def size(s: frozenset) -> int:
        return prod(dimsz[i] for i in s) if s else 1

    worst = 0

    def walk(s):
        nonlocal worst
        if isinstance(s, int):
            return sets[s - 1]
        out = None
        for part in s:
            p = walk(part)
            out = p if out is None else _result_inds(out, p)
        worst = max(worst, size(out))
        return out

    walk(seq)
    return worst


def _optimal_sequence(tensors: Sequence[Tensor]):
    """Exact DP over subsets minimizing total multiply count."""
    n = len(tensors)
    sets = _index_sets(tensors)
    dimsz = _dims(tensors)

    def size(s: frozenset) -> int:
        return prod(dimsz[i] for i in s) if s else 1

    # best[mask] = (cost, inds, tree)
    best: dict[int, tuple[int, frozenset, object]] = {}
    for k in range(n):
        best[1 << k] = (0, sets[k], k + 1)

    full = (1 << n) - 1
    for mask in range(1, full + 1):
        if mask in best or mask & (mask - 1) == 0:
            continue
        entry = None
        sub = (mask - 1) & mask
        while sub > 0:
            other = mask ^ sub
            if sub < other:  # enumerate unordered pairs once
                if sub in best and other in best:
                    c1, s1, t1 = best[sub]
                    c2, s2, t2 = best[other]
                    union = s1 | s2
                    step = prod(dimsz[i] for i in union) if union else 1
                    cost = c1 + c2 + step
                    if entry is None or cost < entry[0]:
                        entry = (cost, _result_inds(s1, s2), [t1, t2])
            sub = (sub - 1) & mask
        if entry is not None:
            best[mask] = entry
    return best[full][2]


def _greedy_sequence(tensors: Sequence[Tensor]):
    """Greedy pairwise contraction minimizing (result size, step cost)."""
    n = len(tensors)
    sets = _index_sets(tensors)
    dimsz = _dims(tensors)

    def size(s: frozenset) -> int:
        return prod(dimsz[i] for i in s) if s else 1

    live = {k: (sets[k], k + 1) for k in range(n)}
    next_id = n
    while len(live) > 1:
        keys = list(live.keys())
        bestpair = None
        bestscore = None
        # prefer pairs that actually share indices
        for a_i in range(len(keys)):
            for b_i in range(a_i + 1, len(keys)):
                a, b = keys[a_i], keys[b_i]
                sa, _ = live[a]
                sb, _ = live[b]
                if not (sa & sb):
                    continue
                res = _result_inds(sa, sb)
                score = (size(res), size(sa | sb))
                if bestscore is None or score < bestscore:
                    bestscore = score
                    bestpair = (a, b)
        if bestpair is None:  # disconnected: contract the two smallest
            keys.sort(key=lambda k: size(live[k][0]))
            bestpair = (keys[0], keys[1])
        a, b = bestpair
        sa, ta = live.pop(a)
        sb, tb = live.pop(b)
        live[next_id] = (_result_inds(sa, sb), [ta, tb])
        next_id += 1
    return next(iter(live.values()))[1]


# ---------------------------------------------------------------------------
# treewidth-based orderings (OMEinsum's Treewidth /
# ExactTreewidth optimizers)
# ---------------------------------------------------------------------------


def _index_adjacency(tensors: Sequence[Tensor]):
    """Index-interaction graph: indices adjacent iff they share a tensor."""
    sets = _index_sets(tensors)
    # sort by the index's own (counter id, prime level) — stable across
    # processes, unlike builtin id() memory addresses, so treewidth plans
    # are reproducible run to run
    verts: list = sorted({i for s in sets for i in s}, key=lambda i: (i.id, i.plev))
    pos = {v: p for p, v in enumerate(verts)}
    adj = [set() for _ in verts]
    for s in sets:
        ids = [pos[i] for i in s]
        for a_i in range(len(ids)):
            for b_i in range(a_i + 1, len(ids)):
                adj[ids[a_i]].add(ids[b_i])
                adj[ids[b_i]].add(ids[a_i])
    return verts, adj


def _minfill_order(adj) -> list:
    """Min-fill elimination ordering (standard treewidth heuristic)."""
    n = len(adj)
    adj = [set(a) for a in adj]
    alive = set(range(n))
    order = []
    while alive:
        best_v, best_key = None, None
        for v in alive:
            nb = adj[v] & alive
            fill = 0
            nbl = list(nb)
            for a_i in range(len(nbl)):
                for b_i in range(a_i + 1, len(nbl)):
                    if nbl[b_i] not in adj[nbl[a_i]]:
                        fill += 1
            key = (fill, len(nb))
            if best_key is None or key < best_key:
                best_key, best_v = key, v
        nb = list(adj[best_v] & alive)
        for a_i in range(len(nb)):
            for b_i in range(a_i + 1, len(nb)):
                adj[nb[a_i]].add(nb[b_i])
                adj[nb[b_i]].add(nb[a_i])
        alive.discard(best_v)
        order.append(best_v)
    return order


_EXACT_TW_MAX = 18


def _exact_tw_order(adj) -> list:
    """Exact minimum-width elimination ordering by DP over vertex subsets
    (Bodlaender–Fomin–Koster style: f(S) = min_v max(|N(v) \\ S|, f(S+v)))."""
    n = len(adj)
    full = (1 << n) - 1
    masks = [0] * n
    for v, nb in enumerate(adj):
        for u in nb:
            masks[v] |= 1 << u
    from functools import lru_cache

    @lru_cache(maxsize=None)
    def f(S: int) -> tuple:
        if S == full:
            return (0, -1)
        best = None
        rest = full & ~S
        v = 0
        while rest:
            if rest & 1:
                # degree of v in the graph where S is eliminated: neighbors
                # outside S, plus clique fill tracked implicitly by the DP
                # recurrence on the *elimination* graph: width contribution
                # is |reachable(v, S) \ S| where reachability runs through S
                reach = _reach(v, S, masks)
                w = bin(reach).count("1")
                sub = f(S | (1 << v))[0]
                cand = max(w, sub)
                if best is None or cand < best[0]:
                    best = (cand, v)
            rest >>= 1
            v += 1
        return best

    def _reach(v: int, S: int, masks) -> int:
        # neighbors of v in the elimination graph of S: vertices outside S
        # reachable from v via paths through S
        seen = 1 << v
        frontier = masks[v]
        out = 0
        while frontier:
            u = (frontier & -frontier).bit_length() - 1
            bit = 1 << u
            frontier &= ~bit
            if seen & bit:
                continue
            seen |= bit
            if S & bit:
                frontier |= masks[u] & ~seen
            else:
                out |= bit
        return out

    order = []
    S = 0
    while S != full:
        _, v = f(S)
        order.append(v)
        S |= 1 << v
    return order


def _elim_to_tree(tensors: Sequence[Tensor], verts, order):
    """Contraction tree from an index elimination order: eliminating an index
    contracts every live tensor that carries it."""
    live = {k: (set(tensors[k].inds), k + 1) for k in range(len(tensors))}
    next_id = len(tensors)

    def merge(keys):
        nonlocal next_id
        keys = list(keys)
        acc_s, acc_t = live.pop(keys[0])
        union = set(acc_s)
        for k2 in keys[1:]:
            s2, t2 = live.pop(k2)
            union |= s2
            acc_t = [acc_t, t2]
        # surviving indices: the union minus those no longer held by any
        # other live tensor (symmetric difference is wrong for indices
        # shared by 3+ tensors or shared with a tensor outside the merge)
        outside = set()
        for s, _ in live.values():
            outside |= s & union
        acc_s = outside
        live[next_id] = (acc_s, acc_t)
        next_id += 1

    for vi in order:
        ind = verts[vi]
        holders = [k for k, (s, _) in live.items() if ind in s]
        if len(holders) >= 2:
            merge(holders)
    while len(live) > 1:
        merge(list(live.keys())[:2])
    return next(iter(live.values()))[1]


def _treewidth_sequence(tensors: Sequence[Tensor], exact: bool = False, **kwargs):
    verts, adj = _index_adjacency(tensors)
    if not verts:  # all-scalar network
        return _greedy_sequence(tensors)
    if exact and len(verts) <= _EXACT_TW_MAX:
        order = _exact_tw_order(adj)
    else:
        order = _minfill_order(adj)
    return _elim_to_tree(tensors, verts, order)


# ---------------------------------------------------------------------------
# recursive-bipartition orderings (OMEinsum's
# SABipartite and HyperND optimizers)
# ---------------------------------------------------------------------------


def _cut_weight(groupA, groupB, sets, dimsz) -> float:
    from math import log

    w = 0.0
    indsA = set().union(*(sets[k] for k in groupA)) if groupA else set()
    indsB = set().union(*(sets[k] for k in groupB)) if groupB else set()
    for i in indsA & indsB:
        w += log(dimsz[i])
    return w


def _bipartition_sa(keys, sets, dimsz, rng, sweeps: int = 60):
    """Balanced bipartition minimizing log cut weight, simulated annealing."""
    keys = list(keys)
    n = len(keys)
    half = n // 2
    perm = list(rng.permutation(n))
    A = set(keys[p] for p in perm[:half])
    B = set(keys[p] for p in perm[half:])
    cost = _cut_weight(A, B, sets, dimsz)
    for sweep in range(sweeps):
        temp = max(1e-3, 1.0 - sweep / sweeps)
        a = keys[int(rng.integers(n))]
        b = keys[int(rng.integers(n))]
        if (a in A) == (b in A):
            continue
        if a in B:
            a, b = b, a
        A2 = (A - {a}) | {b}
        B2 = (B - {b}) | {a}
        c2 = _cut_weight(A2, B2, sets, dimsz)
        if c2 <= cost or rng.random() < float(np.exp((cost - c2) / temp) if (cost - c2) / temp > -50 else 0.0):
            A, B, cost = A2, B2, c2
    return A, B


def _bipartition_fm(keys, sets, dimsz, imbalance: float = 0.34):
    """Deterministic bisection with single-move Fiduccia–Mattheyses-style
    refinement (the nested-dissection splitter)."""
    keys = list(keys)
    n = len(keys)
    half = n // 2
    A = set(keys[:half])
    B = set(keys[half:])
    lo = max(1, int(n * (0.5 - imbalance)))
    hi = n - lo
    improved = True
    cost = _cut_weight(A, B, sets, dimsz)
    while improved:
        improved = False
        for k in keys:
            src, dst = (A, B) if k in A else (B, A)
            if len(src) - 1 < lo or len(dst) + 1 > hi:
                continue
            src2 = src - {k}
            dst2 = dst | {k}
            c2 = (
                _cut_weight(src2, dst2, sets, dimsz)
                if src is A
                else _cut_weight(dst2, src2, sets, dimsz)
            )
            if c2 < cost - 1e-12:
                src.discard(k)
                dst.add(k)
                cost = c2
                improved = True
    return A, B


def _bipartite_sequence(tensors: Sequence[Tensor], refine: str = "sa", seed: int = 0, native: bool = True,
                        **kwargs):
    sets = {k: frozenset(tensors[k].inds) for k in range(len(tensors))}
    dimsz = _dims(tensors)
    rng = np.random.default_rng(seed)

    def rec(keys):
        keys = list(keys)
        if len(keys) == 1:
            return keys[0] + 1
        if len(keys) == 2:
            return [keys[0] + 1, keys[1] + 1]
        if len(keys) <= 6:
            # small leaves: hand off to the exact/greedy base optimizer
            sub = [tensors[k] for k in keys]
            tree = contraction_sequence(sub, alg="optimal", native=native)

            def relabel(t):
                if isinstance(t, int):
                    return keys[t - 1] + 1
                return [relabel(x) for x in t]

            return relabel(tree)
        if refine == "sa":
            A, B = _bipartition_sa(keys, sets, dimsz, rng)
        else:
            A, B = _bipartition_fm(keys, sets, dimsz)
        if not A or not B:  # degenerate split: fall back
            A, B = set(keys[: len(keys) // 2]), set(keys[len(keys) // 2 :])
        return [rec(sorted(A)), rec(sorted(B))]

    return rec(range(len(tensors)))


def contract(tensors: Sequence[Tensor], sequence=None, alg: str = "optimal") -> Tensor:
    """Contract tensors, planning a sequence if not provided."""
    tensors = list(tensors)
    if sequence is None and len(tensors) > 2:
        sequence = contraction_sequence(tensors, alg=alg)
    return _contract(tensors, sequence)
