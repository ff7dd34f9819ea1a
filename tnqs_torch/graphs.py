"""Named graphs, lattices, edge coloring and loop configurations, without
networkx.

Port of the parts of `tnqs/graphs.py` the compiled engine needs:
`NamedGraph` (`tnqs/graphs.py:39-177`), the ring and line queries
(`:184-234`), `center` (`:298`), `edge_color` with its helpers
(`:412-628`), the lattice generators (`named_grid`, the path, ring and comb
graphs, `named_hexagonal_lattice_graph`, `heavy_hexagonal_lattice`,
`:795-888`), `eagle_lattice` (`:890`) and the loop-series configurations
(`leafless_edge_induced_subgraphs`, `:677-793`), enumerated by the port's
build of `tnqs_torch/csrc/host/loop_enum.cpp` with the Python enumerator as
its plain version.  The hexagonal lattice reproduces
`networkx.hexagonal_lattice_graph`'s vertex names and edge order without
networkx: the engine's plan, edge ids and checkpoints follow that order.
Everything here is host-side plan data; no tensor touches a device.
"""

from __future__ import annotations

import ctypes
import itertools
from collections import OrderedDict, deque
from typing import Hashable, Iterable, Sequence

Vertex = Hashable
Edge = tuple  # directed edge (src, dst)


class NamedGraph:
    """A simple undirected graph with named (hashable) vertices.

    Insertion order of vertices and edges is preserved, as in
    `tnqs.graphs.NamedGraph`: the engine's plan tables depend on it.
    """

    def __init__(self, vertices: Iterable[Vertex] = ()):
        self._adj: "OrderedDict[Vertex, OrderedDict[Vertex, None]]" = OrderedDict()
        self._edges: "OrderedDict[tuple, None]" = OrderedDict()
        for v in vertices:
            self.add_vertex(v)

    @staticmethod
    def from_edges(vertices: Iterable[Vertex], edges: Iterable[Edge]) -> "NamedGraph":
        """Graph from vertex and edge lists, in their order (carries any
        `tnqs` graph over: ``from_edges(g.vertices(), g.edges())``)."""
        return NamedGraph(vertices).add_edges(edges)

    # -- construction --------------------------------------------------
    def add_vertex(self, v: Vertex) -> "NamedGraph":
        if v not in self._adj:
            self._adj[v] = OrderedDict()
        return self

    def add_edge(self, u: Vertex, v: Vertex) -> "NamedGraph":
        if u == v:
            raise ValueError("self-loops not supported")
        self.add_vertex(u)
        self.add_vertex(v)
        if not self.has_edge(u, v):
            self._adj[u][v] = None
            self._adj[v][u] = None
            self._edges[(u, v)] = None
        return self

    def add_edges(self, edges: Iterable[Edge]) -> "NamedGraph":
        for u, v in edges:
            self.add_edge(u, v)
        return self

    # -- queries -------------------------------------------------------
    def vertices(self) -> list:
        return list(self._adj.keys())

    def edges(self) -> list[Edge]:
        return list(self._edges.keys())

    def has_edge(self, u, v) -> bool:
        return v in self._adj.get(u, ())

    def neighbors(self, v) -> list:
        return list(self._adj[v].keys())

    def degree(self, v) -> int:
        return len(self._adj[v])

    def nv(self) -> int:
        return len(self._adj)

    def ne(self) -> int:
        return len(self._edges)

    def rem_edge(self, u: Vertex, v: Vertex) -> "NamedGraph":
        if self.has_edge(u, v):
            del self._adj[u][v]
            del self._adj[v][u]
            self._edges.pop((u, v), None)
            self._edges.pop((v, u), None)
        return self

    def copy(self) -> "NamedGraph":
        g = NamedGraph()
        g._adj = OrderedDict((v, OrderedDict(nbrs)) for v, nbrs in self._adj.items())
        g._edges = OrderedDict(self._edges)
        return g

    def rename_vertices(self, f) -> "NamedGraph":
        return NamedGraph.from_edges((f(v) for v in self.vertices()), ((f(u), f(v)) for u, v in self.edges()))

    def __repr__(self):
        return f"NamedGraph({self.nv()} vertices, {self.ne()} edges)"


def is_connected(g: NamedGraph) -> bool:
    if g.nv() == 0:
        return True
    start = g.vertices()[0]
    seen, stack = {start}, [start]
    while stack:
        for u in g.neighbors(stack.pop()):
            if u not in seen:
                seen.add(u)
                stack.append(u)
    return len(seen) == g.nv()


def is_tree(g: NamedGraph) -> bool:
    return g.nv() >= 1 and g.ne() == g.nv() - 1 and is_connected(g)


def is_line_graph(g: NamedGraph) -> bool:
    """True if `g` is a path (`tnqs/graphs.py:215`)."""
    n = g.nv()
    if n == 1:
        return True
    if not is_tree(g):
        return False
    return sorted(g.degree(v) for v in g.vertices()) == [1, 1] + [2] * (n - 2)


def is_ring_graph(g: NamedGraph) -> bool:
    """True if `g` is a single cycle (`tnqs/graphs.py:226`)."""
    if g.ne() == 0:
        return False
    h = g.copy()
    h.rem_edge(*h.edges()[0])
    return is_line_graph(h)


def center(g: NamedGraph) -> list:
    """Vertices of minimum eccentricity, in `vertices()` order (what
    `networkx.center` returns for `tnqs.graphs.center`, `tnqs/graphs.py:298`).
    Raises ValueError on a disconnected graph, whose eccentricities are
    infinite."""
    ecc = {}
    for s in g.vertices():
        dist = {s: 0}
        q = deque([s])
        while q:
            v = q.popleft()
            for u in g.neighbors(v):
                if u not in dist:
                    dist[u] = dist[v] + 1
                    q.append(u)
        if len(dist) != g.nv():
            raise ValueError("center of a disconnected graph")
        ecc[s] = max(dist.values())
    radius = min(ecc.values())
    return [v for v in g.vertices() if ecc[v] == radius]


# ----------------------------------------------------------------------
# edge coloring (gate batching), `tnqs/graphs.py:412-622`
# ----------------------------------------------------------------------

def _axis_parity_edge_color(g: NamedGraph) -> list[list[Edge]] | None:
    """Structured coloring for integer-coordinate lattices: color by
    (axis, parity of the lower coordinate).  None if the graph is not of
    that form or the coloring is improper."""
    groups: dict[tuple, list[Edge]] = {}
    for (u, v) in g.edges():
        if not (isinstance(u, tuple) and isinstance(v, tuple) and len(u) == len(v)):
            return None
        diffs = [k for k in range(len(u)) if u[k] != v[k]]
        if len(diffs) != 1:
            return None
        k = diffs[0]
        a, b = u[k], v[k]
        if not (isinstance(a, int) and isinstance(b, int)):
            return None
        key = (k, min(a, b) % 2) if abs(a - b) == 1 else (k, 2)  # (k, 2): wrap edge
        groups.setdefault(key, []).append((u, v))
    for gr in groups.values():
        touched = [v for e in gr for v in e]
        if len(touched) != len(set(touched)):
            return None
    return [groups[k] for k in sorted(groups.keys())]


def _bipartition(g: NamedGraph) -> dict | None:
    """2-color the vertices, or None if the graph has an odd cycle."""
    side: dict = {}
    for s in g.vertices():
        if s in side:
            continue
        side[s] = 0
        queue = [s]
        while queue:
            v = queue.pop()
            for u in g.neighbors(v):
                if u not in side:
                    side[u] = 1 - side[v]
                    queue.append(u)
                elif side[u] == side[v]:
                    return None
    return side


def _koenig_edge_color(g: NamedGraph) -> dict | None:
    """Δ-edge-coloring of a bipartite graph by Kőnig's alternating paths.
    Returns {frozenset(edge): color}, or None if the graph is not
    bipartite."""
    if _bipartition(g) is None:
        return None
    delta = max((len(g.neighbors(v)) for v in g.vertices()), default=0)
    at: dict = {v: {} for v in g.vertices()}  # at[v][c] = neighbor on the c edge

    def free(v) -> int:
        for c in range(delta):
            if c not in at[v]:
                return c
        raise AssertionError("no free color at vertex")  # pragma: no cover

    color: dict = {}
    for (u, v) in g.edges():
        cu, cv = free(u), free(v)
        if cu != cv:
            # flip the maximal cu/cv alternating path from v; in a bipartite
            # graph it cannot reach u, so cu becomes free at both ends
            path = []
            at_v, want = v, cu
            while want in at[at_v]:
                nxt = at[at_v][want]
                path.append((at_v, nxt, want))
                at_v, want = nxt, (cv if want == cu else cu)
            for a, b, c in path:
                del at[a][c]
                del at[b][c]
            for a, b, c in path:
                newc = cv if c == cu else cu
                color[frozenset((a, b))] = newc
                at[a][newc] = b
                at[b][newc] = a
        color[frozenset((u, v))] = cu
        at[u][cu] = v
        at[v][cu] = u
    return color


def _misra_gries_edge_color(g: NamedGraph) -> dict:
    """≤ Δ+1 edge coloring of any simple graph (Misra–Gries)."""
    color: dict[frozenset, int] = {}

    def colors_at(v) -> set:
        return {
            color[frozenset((v, u))] for u in g.neighbors(v) if frozenset((v, u)) in color
        }

    def free_color(v) -> int:
        used = colors_at(v)
        c = 0
        while c in used:
            c += 1
        return c

    def edge_with_color(v, c, exclude=None):
        for u in g.neighbors(v):
            if u != exclude and color.get(frozenset((v, u))) == c:
                return u
        return None

    for (u0, v0) in g.edges():
        # maximal fan of u0 from v0: each next fan edge's color is free at
        # the previous fan vertex
        fan = [v0]
        while True:
            free_at_last = colors_at(fan[-1])
            nxt = next(
                (
                    w
                    for w in g.neighbors(u0)
                    if w not in fan
                    and frozenset((u0, w)) in color
                    and color[frozenset((u0, w))] not in free_at_last
                ),
                None,
            )
            if nxt is None:
                break
            fan.append(nxt)
        c = free_color(u0)
        d = free_color(fan[-1])
        if c != d:
            # invert the maximal d/c alternating path from u0
            path_edges = []
            at, want, prev = u0, d, None
            while True:
                nxt = edge_with_color(at, want, exclude=prev)
                if nxt is None:
                    break
                path_edges.append(frozenset((at, nxt)))
                prev, at = at, nxt
                want = c if want == d else d
            for fs in path_edges:
                color[fs] = c if color[fs] == d else d
        w_idx = next((i for i, w in enumerate(fan) if d not in colors_at(w)), len(fan) - 1)
        # rotate the fan prefix and color (u0, fan[w_idx]) with d
        for i in range(w_idx):
            color[frozenset((u0, fan[i]))] = color[frozenset((u0, fan[i + 1]))]
        color[frozenset((u0, fan[w_idx]))] = d
    return color


def edge_color(g: NamedGraph, num_colors: int | None = None) -> list[list[Edge]]:
    """Proper edge coloring: partition edges into matchings, with the rules
    of `tnqs.graphs.edge_color` (`tnqs/graphs.py:504`): Kőnig's exact
    Δ-coloring on bipartite graphs, Misra–Gries otherwise, and the
    axis/parity coloring of integer lattices whenever it needs no more
    colors.  Raises ValueError if more than `num_colors` are needed."""
    structured = _axis_parity_edge_color(g)
    color = _koenig_edge_color(g)
    if color is None:
        color = _misra_gries_edge_color(g)
    ncol = 1 + max(color.values(), default=-1)
    groups: list[list[Edge]] = [[] for _ in range(ncol)]
    for e in g.edges():
        groups[color[frozenset(e)]].append(e)
    groups = [gr for gr in groups if gr]
    for gr in groups:
        touched = [v for e in gr for v in e]
        if len(touched) != len(set(touched)):  # pragma: no cover
            raise AssertionError("edge_color produced an improper coloring")
    if structured is not None and len(structured) <= len(groups):
        groups = structured
    if num_colors is not None and len(groups) > num_colors:
        raise ValueError(f"graph is not {num_colors}-edge-colorable (needs {len(groups)})")
    return groups


def eagle_lattice() -> NamedGraph:
    """IBM Eagle 127-qubit heavy-hex coupling graph, vertex for vertex and
    edge for edge as `tnqs.graphs.eagle_lattice` (`tnqs/graphs.py:890`):
    chain rows 1 and 13 have 14 sites, rows 3..11 have 15, and the six
    connector rows have 4 sites each, alternately below columns {1,5,9,13}
    and {3,7,11,15}.  Vertices are 1-based ``(row, col)`` tuples."""
    g = NamedGraph()
    row_cols = {0: range(0, 14), 12: range(1, 15)}
    for r in (2, 4, 6, 8, 10):
        row_cols[r] = range(0, 15)
    for r, cols in row_cols.items():
        cols = list(cols)
        for c in cols:
            g.add_vertex((r + 1, c + 1))
        for c in cols[:-1]:
            g.add_edge((r + 1, c + 1), (r + 1, c + 2))
    for r in (1, 3, 5, 7, 9, 11):
        attach = (0, 4, 8, 12) if r % 4 == 1 else (2, 6, 10, 14)
        for c in attach:
            g.add_vertex((r + 1, c + 1))
            g.add_edge((r, c + 1), (r + 1, c + 1))
            g.add_edge((r + 1, c + 1), (r + 2, c + 1))
    if g.nv() != 127 or g.ne() != 144:  # pragma: no cover
        raise AssertionError("eagle_lattice: expected 127 vertices and 144 edges")
    return g


# ----------------------------------------------------------------------
# lattice generators (`tnqs/graphs.py:795-888`)
# ----------------------------------------------------------------------

def named_grid(dims: Sequence[int], periodic=False) -> NamedGraph:
    """Hypercubic lattice with 1-based tuple vertex names (1-based integers
    in one dimension), `tnqs.graphs.named_grid` vertex for vertex and edge
    for edge; `periodic` is a bool or one per axis (an axis wraps when it
    has more than 2 sites)."""
    dims = tuple(int(d) for d in dims)
    if isinstance(periodic, str):
        raise TypeError(f"periodic must be a bool or sequence of bools, got {periodic!r}")
    try:
        per = tuple(bool(p) for p in periodic)
    except TypeError:
        per = (bool(periodic),) * len(dims)
    if len(per) != len(dims):
        raise ValueError(f"periodic {periodic} does not match dims {dims}")
    if len(dims) == 1:
        g = NamedGraph(range(1, dims[0] + 1))
        for i in range(1, dims[0]):
            g.add_edge(i, i + 1)
        if per[0] and dims[0] > 2:
            g.add_edge(dims[0], 1)
        return g
    vs = list(itertools.product(*[range(1, d + 1) for d in dims]))
    g = NamedGraph(vs)
    for v in vs:
        for k, d in enumerate(dims):
            if v[k] < d:
                g.add_edge(v, v[:k] + (v[k] + 1,) + v[k + 1:])
            elif per[k] and d > 2:
                g.add_edge(v, v[:k] + (1,) + v[k + 1:])
    return g


def named_path_graph(n: int) -> NamedGraph:
    return named_grid((n,))


def named_ring_graph(n: int) -> NamedGraph:
    return named_grid((n,), periodic=True)


def named_comb_tree(dims: Sequence[int]) -> NamedGraph:
    """A backbone path along (i, 1) with teeth along j (`tnqs/graphs.py:835`)."""
    nx_, ny_ = dims
    g = NamedGraph(itertools.product(range(1, nx_ + 1), range(1, ny_ + 1)))
    for i in range(1, nx_):
        g.add_edge((i, 1), (i + 1, 1))
    for i in range(1, nx_ + 1):
        for j in range(1, ny_):
            g.add_edge((i, j), (i, j + 1))
    return g


class _NxGraph:
    """The dict-of-dicts bookkeeping of a `networkx.Graph`, for the
    operations `networkx.hexagonal_lattice_graph` performs (`add_edge`,
    `remove_node`, `copy`, `contracted_nodes`), so that its vertex and edge
    order come out as networkx's: a node's neighbors in insertion order, the
    edges in node order, each reported from the first endpoint reached."""

    def __init__(self):
        self.adj: dict = {}

    def add_edge(self, u, v) -> None:
        self.adj.setdefault(u, {})
        self.adj.setdefault(v, {})
        self.adj[u][v] = None
        self.adj[v][u] = None

    def remove_node(self, n) -> None:
        for u in self.adj[n]:
            del self.adj[u][n]
        del self.adj[n]

    def copy(self) -> "_NxGraph":
        # `Graph.copy`: the nodes in order, then every adjacency entry in
        # node order through `add_edges_from`, which reorders neighbors
        out = _NxGraph()
        out.adj = {n: {} for n in self.adj}
        for u, nbrs in self.adj.items():
            for v in nbrs:
                out.adj[u][v] = None
                out.adj[v][u] = None
        return out

    def contracted_nodes(self, u, v) -> "_NxGraph":
        """`networkx.contracted_nodes(G, u, v)` (copy=True, self_loops=True):
        v's edges, in v's neighbor order, re-attached to u."""
        h = self.copy()
        remap = list(self.adj[v])
        h.remove_node(v)
        for x in remap:
            x = u if x == v else x
            if x not in h.adj.get(u, {}):
                h.add_edge(u, x)
        return h

    def edges(self) -> list:
        seen, out = set(), []
        for n, nbrs in self.adj.items():
            out.extend((n, nbr) for nbr in nbrs if nbr not in seen)
            seen.add(n)
        return out


def named_hexagonal_lattice_graph(m: int, n: int, periodic: bool = False) -> NamedGraph:
    """Hexagonal (honeycomb) lattice of m x n hexagons with 1-based
    ``(row, col)`` names: `tnqs.graphs.named_hexagonal_lattice_graph`, whose
    vertices are `networkx.hexagonal_lattice_graph`'s (col, row) nodes
    renamed and sorted, and whose edges come in networkx's order.  The
    construction is networkx's, step for step, on `_NxGraph`."""
    if m == 0 or n == 0:
        return NamedGraph()
    if periodic and (n % 2 == 1 or m < 2 or n < 2):
        raise ValueError("periodic hexagonal lattice needs m > 1, n > 1 and even n")
    M = 2 * m
    rows, cols = range(M + 2), range(n + 1)
    G = _NxGraph()
    for i in cols:
        for j in rows[: M + 1]:
            G.add_edge((i, j), (i, j + 1))
    for i in cols[:n]:
        for j in rows:
            if i % 2 == j % 2:
                G.add_edge((i, j), (i + 1, j))
    G.remove_node((0, M + 1))
    G.remove_node((n, (M + 1) * (n % 2)))
    if periodic:
        for i in cols[:n]:
            G = G.contracted_nodes((i, 0), (i, M))
        for i in cols[1:]:
            G = G.contracted_nodes((i, 1), (i, M + 1))
        for j in rows[1:M]:
            G = G.contracted_nodes((0, j), (n, j))
        G.remove_node((n, M))
    name = {v: (v[1] + 1, v[0] + 1) for v in G.adj}
    return NamedGraph.from_edges(sorted(name.values()), ((name[u], name[v]) for u, v in G.edges()))


def heavy_hexagonal_lattice(nx_: int, ny_: int) -> NamedGraph:
    """The hexagonal lattice with a vertex on every edge (IBM's heavy-hex
    topology), `tnqs.graphs.heavy_hexagonal_lattice` (`tnqs/graphs.py:875`)."""
    g = named_hexagonal_lattice_graph(nx_, ny_).rename_vertices(lambda v: (2 * v[0] - 1, 2 * v[1] - 1))
    out = NamedGraph(g.vertices())
    for u, v in g.edges():
        mid = ((u[0] + v[0]) / 2, (u[1] + v[1]) / 2)
        mid = tuple(int(x) if float(x).is_integer() else x for x in mid)
        out.add_vertex(mid)
        out.add_edge(u, mid)
        out.add_edge(mid, v)
    return out


# ----------------------------------------------------------------------
# loop-series configurations (`tnqs/graphs.py:677-793`)
# ----------------------------------------------------------------------

def _connected_leafless_subgraphs(g: NamedGraph, max_edges: int) -> list[frozenset]:
    """Every connected edge-induced subgraph of `g` with 3 to `max_edges`
    edges and no vertex of degree 1, grown from each seed edge with edges of
    higher index only and pruned when its leaves cannot all be repaired
    within the budget (`tnqs/graphs.py:690`)."""
    edge_list = [frozenset(e) for e in g.edges()]
    edge_index = {e: i for i, e in enumerate(edge_list)}
    incident: dict = {}
    for e in edge_list:
        for v in e:
            incident.setdefault(v, []).append(e)
    results: set = set()
    seen_states: set = set()

    def degrees(es) -> dict:
        deg: dict = {}
        for e in es:
            for v in e:
                deg[v] = deg.get(v, 0) + 1
        return deg

    def grow(current: set, frontier: set):
        key = frozenset(current)
        if key in seen_states:
            return
        seen_states.add(key)
        deg = degrees(current)
        leaves = sum(1 for d in deg.values() if d == 1)
        if len(current) >= 3 and leaves == 0:
            results.add(key)
        if len(current) >= max_edges or len(current) + (leaves + 1) // 2 > max_edges:
            return
        min_idx = min(edge_index[e] for e in current)
        for e in list(frontier):
            if e in current or edge_index[e] < min_idx:
                continue
            new_frontier = set(frontier)
            for v in e:
                new_frontier.update(incident[v])
            grow(current | {e}, new_frontier)

    for seed in edge_list:
        frontier: set = set()
        for v in seed:
            frontier.update(incident[v])
        grow({seed}, frontier)
    return sorted(results, key=lambda s: (len(s), sorted(map(sorted, map(list, s)))))


def _leafless_subgraphs_plain(g: NamedGraph, max_edges: int) -> list[frozenset]:
    """The configurations as sets of undirected edges, by Python: the
    connected ones, then every vertex-disjoint union of them within the
    budget (`tnqs/graphs.py:755-789`)."""
    connected = _connected_leafless_subgraphs(g, max_edges)
    results = set(connected)

    def verts(es) -> frozenset:
        return frozenset(v for e in es for v in e)

    level = [(c, verts(c)) for c in connected]
    while level:
        nxt = []
        for es, vs in level:
            for c in connected:
                cvs = verts(c)
                if len(es) + len(c) > max_edges or vs & cvs:
                    continue
                u = es | c
                if u not in results:
                    results.add(u)
                    nxt.append((u, vs | cvs))
        level = nxt
    return sorted(results, key=len)


def _leafless_subgraphs_native(g: NamedGraph, max_edges: int) -> list[list[int]] | None:
    """The configurations as lists of edge indices into `g.edges()`, by the
    port's build of `csrc/host/loop_enum.cpp`; None past its 1024 edges."""
    from .ops import _build

    edge_list = g.edges()
    ne = len(edge_list)
    if ne == 0 or ne > 1024:
        return None
    import numpy as np

    vidx = {v: i for i, v in enumerate(g.vertices())}
    edges = np.array([(vidx[u], vidx[v]) for u, v in edge_list], dtype=np.int32)
    lib = _build.host_library()
    cap = 1 << 20
    while True:
        out = np.zeros(cap, dtype=np.int32)
        written = ctypes.c_int64(0)
        count = lib.tnqs_leafless_subgraphs(g.nv(), ne, edges.ctypes.data, int(max_edges), out.ctypes.data, cap,
                                            ctypes.byref(written))
        if count == -2 and cap < 1 << 28:
            cap *= 8
            continue
        if count < 0:
            raise RuntimeError(f"tnqs_leafless_subgraphs failed ({count}) on {g}, max_edges={max_edges}")
        break
    result, pos = [], 0
    for _ in range(count):
        n = int(out[pos])
        result.append([int(x) for x in out[pos + 1 : pos + 1 + n]])
        pos += 1 + n
    return result


def leafless_edge_induced_subgraphs(g: NamedGraph, max_edges: int, native: bool = True) -> list[list[Edge]]:
    """Every leafless edge-induced subgraph of `g` with at most `max_edges`
    edges (the BP loop series' configurations, `tnqs/graphs.py:743`), as
    lists of edges of `g`.  `native` enumerates with the port's build of
    `loop_enum.cpp` (compiled by g++ at first use; a failed build raises),
    else in Python, which is the plain version the tests hold it against;
    a graph of more than 1024 edges takes Python either way."""
    subs = _leafless_subgraphs_native(g, max_edges) if native else None
    edge_list = g.edges()
    if subs is not None:
        return [[edge_list[i] for i in es] for es in subs]
    index = {frozenset(e): e for e in edge_list}
    return [[index[e] for e in es] for es in _leafless_subgraphs_plain(g, max_edges)]
