"""Named graphs, the Eagle lattice and edge coloring, without networkx.

Port of the parts of `tnqs/graphs.py` the compiled engine's host plan needs:
`NamedGraph` (`tnqs/graphs.py:39-177`), `center` (`:298`), `edge_color` with
its helpers (`:412-628`) and `eagle_lattice` (`:890`).  Everything here is
host-side plan data; no tensor touches a device.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Hashable, Iterable

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

    def nv(self) -> int:
        return len(self._adj)

    def ne(self) -> int:
        return len(self._edges)

    def __repr__(self):
        return f"NamedGraph({self.nv()} vertices, {self.ne()} edges)"


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
