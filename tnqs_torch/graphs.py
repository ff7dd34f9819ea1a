"""Named graphs, lattices, graph algorithms, edge coloring and loop
configurations, without networkx.

Port of `tnqs/graphs.py`: `NamedGraph` (`tnqs/graphs.py:39-177`), the
connectivity, ring and line queries, traversals, paths, `center`, the
Steiner tree and the forest covers that order BP sweeps (`:184-410`),
`edge_color` with its helpers (`:412-628`), `PartitionedGraph` (`:629`),
`unique_simple_cycles` (`:666`), the lattice generators (`named_grid`, the
path, ring and comb graphs, `named_hexagonal_lattice_graph`,
`heavy_hexagonal_lattice`, `:795-888`), `eagle_lattice` (`:890`),
`lieb_lattice`, `topology_to_graph` and `build_graph_from_gates`
(`:928-977`) and the loop-series configurations
(`leafless_edge_induced_subgraphs`, `:677-793`), enumerated by the port's
build of `tnqs_torch/csrc/host/loop_enum.cpp` with the Python enumerator as
its plain version.  Where the JAX package calls networkx (`center`, the
eccentricities, the Steiner tree), the port reproduces networkx's result
and order.  The hexagonal lattice reproduces
`networkx.hexagonal_lattice_graph`'s vertex names and edge order without
networkx: the engine's plan, edge ids and checkpoints follow that order.
Everything here is host-side plan data; no tensor touches a device.
"""

from __future__ import annotations

import ctypes
import heapq
import itertools
from collections import OrderedDict, deque
from typing import Hashable, Iterable, Sequence

Vertex = Hashable
Edge = tuple  # directed edge (src, dst)


def reverse_edge(e: Edge) -> Edge:
    return (e[1], e[0])


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

    def all_edges(self) -> list[Edge]:
        """Both orientations of every edge."""
        es = self.edges()
        return es + [reverse_edge(e) for e in es]

    def has_vertex(self, v) -> bool:
        try:
            return v in self._adj
        except TypeError:  # unhashable candidate (e.g. a list of vertices)
            return False

    def has_edge(self, u, v) -> bool:
        return v in self._adj.get(u, ())

    def incident_edges(self, v, dir: str = "out") -> list[Edge]:
        """Edges touching `v`, oriented out of (`dir="out"`) or into `v`."""
        if dir == "out":
            return [(v, u) for u in self.neighbors(v)]
        return [(u, v) for u in self.neighbors(v)]

    def __contains__(self, v):
        return self.has_vertex(v)

    def __eq__(self, other):
        if not isinstance(other, NamedGraph):
            return NotImplemented
        if set(self._adj) != set(other._adj):
            return False
        return {frozenset(e) for e in self._edges} == {frozenset(e) for e in other._edges}

    def __hash__(self):
        return hash((frozenset(self._adj), frozenset(frozenset(e) for e in self._edges)))

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

    def rem_vertex(self, v: Vertex) -> "NamedGraph":
        for u in list(self._adj.get(v, ())):
            self.rem_edge(u, v)
        self._adj.pop(v, None)
        return self

    def subgraph(self, vertices: Iterable[Vertex]) -> "NamedGraph":
        vs = set(vertices)
        out = NamedGraph([v for v in self.vertices() if v in vs])
        for u, v in self.edges():
            if u in vs and v in vs:
                out.add_edge(u, v)
        return out

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


def _eccentricities(g: NamedGraph) -> dict:
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
            raise ValueError("eccentricity of a disconnected graph")
        ecc[s] = max(dist.values())
    return ecc


def center(g: NamedGraph) -> list:
    """Vertices of minimum eccentricity, in `vertices()` order (what
    `networkx.center` returns for `tnqs.graphs.center`, `tnqs/graphs.py:298`).
    Raises ValueError on a disconnected graph, whose eccentricities are
    infinite."""
    ecc = _eccentricities(g)
    radius = min(ecc.values())
    return [v for v in g.vertices() if ecc[v] == radius]


# ----------------------------------------------------------------------
# traversals, paths and forest covers (`tnqs/graphs.py:190-410`)
# ----------------------------------------------------------------------

def connected_components(g: NamedGraph) -> list[list]:
    """Components by depth-first search, each in discovery order, largest
    first (a stable sort)."""
    seen: set = set()
    comps = []
    for s in g.vertices():
        if s in seen:
            continue
        comp = []
        stack = [s]
        seen.add(s)
        while stack:
            v = stack.pop()
            comp.append(v)
            for u in g.neighbors(v):
                if u not in seen:
                    seen.add(u)
                    stack.append(u)
        comps.append(comp)
    comps.sort(key=len, reverse=True)
    return comps


def bfs_parents(g: NamedGraph, root) -> dict:
    parents = {root: None}
    q = deque([root])
    while q:
        v = q.popleft()
        for u in g.neighbors(v):
            if u not in parents:
                parents[u] = v
                q.append(u)
    return parents


def post_order_dfs_edges(g: NamedGraph, root) -> list[Edge]:
    """Edges of the tree containing `root`, child -> parent in post-order
    (the exact BP schedule toward `root` on a tree)."""
    edges = []
    visited = {root}

    def visit(v, parent):
        for u in g.neighbors(v):
            if u not in visited:
                visited.add(u)
                visit(u, v)
        if parent is not None:
            edges.append((v, parent))

    visit(root, None)
    return edges


def a_star(g: NamedGraph, start, goal) -> list[Edge]:
    """A shortest path from start to goal as directed edges (breadth-first,
    neighbors in insertion order)."""
    if start == goal:
        return []
    parents = {start: None}
    q = deque([start])
    while q:
        v = q.popleft()
        if v == goal:
            break
        for u in g.neighbors(v):
            if u not in parents:
                parents[u] = v
                q.append(u)
    if goal not in parents:
        raise ValueError("no path between vertices")
    path = []
    v = goal
    while parents[v] is not None:
        path.append((parents[v], v))
        v = parents[v]
    return list(reversed(path))


def leaf_vertices(g: NamedGraph) -> list:
    return [v for v in g.vertices() if g.degree(v) == 1]


def eccentricity_ordered_vertices(g: NamedGraph) -> list:
    """Vertices by eccentricity, ties in `vertices()` order."""
    ecc = _eccentricities(g)
    return sorted(g.vertices(), key=lambda v: ecc[v])


def boundary_edges(g: NamedGraph, vertices: Sequence, dir: str = "in") -> list[Edge]:
    """Edges crossing the boundary of `vertices`: (outside -> inside) for
    ``dir="in"``, (inside -> outside) for "out"."""
    inside = set(vertices)
    out = []
    for v in g.vertices():
        if v not in inside:
            continue
        for u in g.neighbors(v):
            if u not in inside:
                out.append((u, v) if dir == "in" else (v, u))
    return out


def _nx_edges(adj: dict) -> list:
    """A dict-of-dicts graph's edges in networkx's order: nodes in order,
    each edge reported from the first endpoint reached (self-loops once)."""
    seen, out = set(), []
    for n, nbrs in adj.items():
        out.extend((n, nbr) for nbr in nbrs if nbr not in seen)
        seen.add(n)
    return out


def _kruskal(adj: dict) -> list:
    """`networkx.minimum_spanning_edges` (Kruskal) on a weighted
    dict-of-dicts graph: edges in networkx order, stably sorted by weight,
    kept when they join two trees."""
    parent: dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for u, v in sorted(_nx_edges(adj), key=lambda e: adj[e[0]][e[1]]):
        ru, rv = find(u), find(v)
        if ru != rv:
            out.append((u, v))
            parent[rv] = ru
    return out


def _add_weighted(adj: dict, u, v, w) -> None:
    adj.setdefault(u, {})
    adj.setdefault(v, {})
    adj[u][v] = w
    adj[v][u] = w


def _multisource_paths(g: NamedGraph, sources: list) -> dict:
    """Shortest paths from the nearest source to every vertex, as
    `networkx.multi_source_dijkstra` breaks ties (unit weights)."""
    dist, seen, pred, fringe = {}, {}, {}, []
    c = itertools.count()
    for s in sources:
        seen[s] = 0
        heapq.heappush(fringe, (0, next(c), s))
    nsources = len(seen)
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        for u in g.neighbors(v):
            if u not in dist and (u not in seen or d + 1 < seen[u]):
                seen[u] = d + 1
                heapq.heappush(fringe, (d + 1, next(c), u))
                pred[u] = v
    paths = {s: [s] for s in sources}
    for v in itertools.islice(dist, nsources, None):
        paths[v] = paths[pred[v]] + [v]
    return paths


def _bidirectional_path(g: NamedGraph, source, target) -> list:
    """`networkx.bidirectional_dijkstra`'s path at unit weights."""
    if source == target:
        return [source]
    dists = [{}, {}]
    preds = [{source: None}, {target: None}]
    fringe = [[], []]
    seen = [{source: 0}, {target: 0}]
    c = itertools.count()
    heapq.heappush(fringe[0], (0, next(c), source))
    heapq.heappush(fringe[1], (0, next(c), target))
    finaldist, meetnode, direction = None, None, 1

    def path(curr, d):
        ret = []
        while curr is not None:
            ret.append(curr)
            curr = preds[d][curr]
        return list(reversed(ret)) if d == 0 else ret

    while fringe[0] and fringe[1]:
        direction = 1 - direction
        dist, _, v = heapq.heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = dist
        if v in dists[1 - direction]:
            return path(meetnode, 0) + path(preds[1][meetnode], 1)
        for w in g.neighbors(v):
            length = dist + 1
            if w in dists[direction]:
                continue
            if w not in seen[direction] or length < seen[direction][w]:
                seen[direction][w] = length
                heapq.heappush(fringe[direction], (length, next(c), w))
                preds[direction][w] = v
                if w in seen[1 - direction]:
                    total = length + seen[1 - direction][w]
                    if finaldist is None or finaldist > total:
                        finaldist, meetnode = total, w
    raise ValueError(f"no path between {source} and {target}")


def steiner_tree(g: NamedGraph, terminals: Sequence) -> NamedGraph:
    """Approximate Steiner tree spanning `terminals` (exact on trees): the
    tree `networkx.algorithms.approximation.steiner_tree` returns for
    `tnqs.graphs.steiner_tree` (Mehlhorn's method at unit weights, its
    tie-breaking step for step), vertices in `g`'s order."""
    terminals = list(terminals)
    paths = _multisource_paths(g, terminals)
    dist = {v: len(p) - 1 for v, p in paths.items()}
    nearest = {v: paths[v][0] for v in g.vertices()}
    g1: dict = {}
    for u, v in _nx_edges(g._adj):
        su, sv = nearest[u], nearest[v]
        w = dist[u] + 1 + dist[v]
        _add_weighted(g1, su, sv, min(w, g1[su][sv]) if su in g1 and sv in g1[su] else w)
    g3: dict = {}
    for u, v in _kruskal(g1):
        p = _bidirectional_path(g, u, v)
        for n1, n2 in zip(p, p[1:]):
            _add_weighted(g3, n1, n2, 1)
    # G.edge_subgraph(mst).copy(), its non-terminal leaves stripped
    adj = _edge_subgraph_copy(g, _kruskal(g3))
    keep = set(terminals)
    leaves = {v for v in adj if len(set(adj[v]) - {v}) == 1} - keep
    while leaves:
        for v in leaves:
            for u in list(adj[v]):
                del adj[u][v]
            del adj[v]
        leaves = {v for v in adj if len(set(adj[v]) - {v}) == 1} - keep
    tree = _nx_edges(adj)
    out = NamedGraph(_edge_subgraph_nodes(g, tree)[0])
    out.add_edges(tree)
    for v in terminals:
        out.add_vertex(v)
    return out


def _edge_subgraph_nodes(g: NamedGraph, edges) -> tuple[list, set]:
    """The node order of `networkx.Graph.edge_subgraph(edges)` on `g`'s
    networkx twin: the set of the edges' nodes, in that set's iteration
    order when it is under half the graph, else in `g`'s order; and the
    view's edge set."""
    edges = set(edges)
    nodes = set()
    for e in edges:
        nodes.update(e[:2])
    nodes = set(nodes)
    if 2 * len(nodes) < g.nv():
        return [n for n in nodes if n in g._adj], edges
    return [n for n in g.vertices() if n in nodes], edges


def _edge_subgraph_copy(g: NamedGraph, edges) -> dict:
    """`networkx.Graph.edge_subgraph(edges).copy()` as a dict-of-dicts."""
    order, edge_set = _edge_subgraph_nodes(g, edges)
    inside = set(order)
    adj: dict = {n: {} for n in order}
    for u in order:
        for v in g.neighbors(u):
            if v in inside and ((u, v) in edge_set or (v, u) in edge_set):
                _add_weighted(adj, u, v, 1)
    return adj


def spanning_forest(g: NamedGraph) -> NamedGraph:
    """A spanning forest (a BFS tree per connected component)."""
    f = NamedGraph(g.vertices())
    for comp in connected_components(g):
        for v, p in bfs_parents(g, comp[0]).items():
            if p is not None:
                f.add_edge(p, v)
    return f


def forest_cover(g: NamedGraph) -> list[NamedGraph]:
    """Spanning forests that together cover every edge of `g`: uncovered
    edges first, then covered ones to span as much as possible."""
    remaining = set(map(frozenset, g.edges()))
    forests = []
    while remaining:
        f = NamedGraph(g.vertices())
        parent = {v: v for v in g.vertices()}

        def find(v):
            while parent[v] != v:
                parent[v] = parent[parent[v]]
                v = parent[v]
            return v

        def union(u, v):
            ru, rv = find(u), find(v)
            if ru == rv:
                return False
            parent[rv] = ru
            return True

        for e in g.edges():
            if frozenset(e) in remaining and union(*e):
                f.add_edge(*e)
                remaining.discard(frozenset(e))
        for e in g.edges():
            if union(*e):
                f.add_edge(*e)
        forests.append(f)
    if not forests:
        forests.append(NamedGraph(g.vertices()))
    return forests


def forest_cover_edge_sequence(g: NamedGraph) -> list[Edge]:
    """The BP sweep schedule: for each forest of `forest_cover` and each of
    its trees, the leaf-to-root post-order pass toward the middle vertex of
    the component, then the reversed root-to-leaf pass."""
    seq: list[Edge] = []
    for forest in forest_cover(g):
        for comp in connected_components(forest):
            if len(comp) == 1:
                continue
            tree = forest.subgraph(comp)
            up = post_order_dfs_edges(tree, comp[len(comp) // 2])
            seq.extend(up)
            seq.extend(reverse_edge(e) for e in reversed(up))
    return seq


class PartitionedGraph:
    """A graph plus a partition of its vertices into named groups; the
    quotient has one vertex per group and an edge wherever a member edge
    crosses two groups (`tnqs/graphs.py:629`)."""

    def __init__(self, graph: NamedGraph, groups: dict):
        self.graph = graph
        self.groups = {k: list(vs) for k, vs in groups.items()}
        self.group_of = {v: k for k, vs in self.groups.items() for v in vs}
        q = NamedGraph(self.groups.keys())
        for u, v in graph.edges():
            gu, gv = self.group_of[u], self.group_of[v]
            if gu != gv:
                q.add_edge(gu, gv)
        self.quotient = q

    def copy(self) -> "PartitionedGraph":
        return PartitionedGraph(self.graph.copy(), {k: list(v) for k, v in self.groups.items()})

    def vertices_of(self, group_key) -> list:
        return list(self.groups[group_key])

    def quotient_edge_of(self, e: Edge) -> Edge:
        return (self.group_of[e[0]], self.group_of[e[1]])


class _NxView:
    """A networkx graph or its node-induced subgraph view, for the walks of
    `unique_simple_cycles`: `adj` the underlying dict-of-dicts (edges are
    removed from it in place), `nodes` the view's node set or None.  Nodes
    iterate as networkx's filtered views iterate them: the node set itself
    when it holds under half the graph's nodes, else the graph's order."""

    def __init__(self, adj: dict, nodes: set | None = None):
        self.adj, self.nodes = adj, nodes

    def __iter__(self):
        if self.nodes is None:
            return iter(list(self.adj))
        if 2 * len(self.nodes) < len(self.adj):
            return iter([n for n in self.nodes if n in self.adj])
        return iter([n for n in self.adj if n in self.nodes])

    def nbrs(self, v) -> list:
        return list(self.adj[v]) if self.nodes is None else [u for u in self.adj[v] if u in self.nodes]

    def first_edge(self):
        seen = set()
        for n in self:
            for nbr in self.nbrs(n):
                if nbr not in seen:
                    return [n, nbr]
            seen.add(n)
        raise StopIteration

    def subgraph(self, nodes) -> "_NxView":
        ok = set()
        for n in nodes:
            if n in self.adj:
                ok.add(n)
        return _NxView(self.adj, ok)


def _biconnected_components(g: _NxView) -> list[set]:
    """`networkx.biconnected_components`: Hopcroft-Tarjan by an explicit
    depth-first stack, each component the set of its edges' endpoints."""
    out = []
    visited: set = set()
    for start in g:
        if start in visited:
            continue
        discovery, low = {start: 0}, {start: 0}
        visited.add(start)
        edge_stack: list = []
        edge_index: dict = {}
        stack = [(start, start, iter(g.nbrs(start)))]
        while stack:
            grandparent, parent, children = stack[-1]
            child = next(children, _NxView)
            if child is not _NxView:
                if grandparent == child:
                    continue
                if child in visited:
                    if discovery[child] <= discovery[parent]:  # back edge
                        low[parent] = min(low[parent], discovery[child])
                        edge_index[parent, child] = len(edge_stack)
                        edge_stack.append((parent, child))
                else:
                    low[child] = discovery[child] = len(discovery)
                    visited.add(child)
                    stack.append((parent, child, iter(g.nbrs(child))))
                    edge_index[parent, child] = len(edge_stack)
                    edge_stack.append((parent, child))
                continue
            stack.pop()
            if len(stack) > 1:
                if low[parent] >= discovery[grandparent]:
                    ind = edge_index[grandparent, parent]
                    out.append(set(itertools.chain.from_iterable(edge_stack[ind:])))
                    del edge_stack[ind:]
                low[grandparent] = min(low[parent], low[grandparent])
            elif stack:  # the root's child
                ind = edge_index[grandparent, parent]
                out.append(set(itertools.chain.from_iterable(edge_stack[ind:])))
                del edge_stack[ind:]
    return out


def _bounded_cycle_search(g: _NxView, path: list, length_bound: int):
    """Gupta and Suzumura's bounded-length cycle search from the prefix
    `path`, as networkx's `_bounded_cycle_search`."""
    nbrs: dict = {}

    def of(v):
        if v not in nbrs:
            nbrs[v] = g.nbrs(v)
        return nbrs[v]

    lock = {v: 0 for v in path}
    B: dict = {}
    start = path[0]
    stack = [iter(of(path[-1]))]
    blen = [length_bound]
    while stack:
        for w in stack[-1]:
            if w == start:
                yield path[:]
                blen[-1] = 1
            elif len(path) < lock.get(w, length_bound):
                path.append(w)
                blen.append(length_bound)
                lock[w] = len(path)
                stack.append(iter(of(w)))
                break
        else:
            stack.pop()
            v = path.pop()
            bl = blen.pop()
            if blen:
                blen[-1] = min(blen[-1], bl)
            if bl < length_bound:
                relax_stack = [(bl, v)]
                while relax_stack:
                    bl, u = relax_stack.pop()
                    if lock.get(u, length_bound) < length_bound - bl + 1:
                        lock[u] = length_bound - bl + 1
                        relax_stack.extend((bl + 1, w) for w in B.get(u, set()).difference(path))
            else:
                for w in of(v):
                    B.setdefault(w, set()).add(v)


def unique_simple_cycles(g: NamedGraph, max_length: int) -> list[list[Edge]]:
    """Every simple cycle of 3 to `max_length` edges, as edge lists
    ``[(c0, c1), ..., (ck, c0)]``: the cycles, starts, orientations and
    order of `networkx.simple_cycles(g, length_bound=max_length)`, which
    `tnqs.graphs.unique_simple_cycles` takes (binary partition over
    biconnected components, then the bounded search), step for step."""
    if max_length < 3:
        return []
    adj: dict = {}
    for u in g.vertices():
        for v in g.neighbors(u):
            if v != u:
                adj.setdefault(u, {})
                adj.setdefault(v, {})
                adj[u][v] = adj[v][u] = None
    full = _NxView(adj)
    out = []
    components = [c for c in _biconnected_components(full) if len(c) >= 3]
    while components:
        gc = full.subgraph(components.pop())
        uv = gc.first_edge()
        del adj[uv[0]][uv[1]], adj[uv[1]][uv[0]]
        for cyc in _bounded_cycle_search(gc, uv, max_length):
            if len(cyc) >= 3:
                out.append([(cyc[i], cyc[(i + 1) % len(cyc)]) for i in range(len(cyc))])
        components.extend(c for c in _biconnected_components(gc) if len(c) >= 3)
    return out


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


# ----------------------------------------------------------------------
# graphs from lattices and circuits (`tnqs/graphs.py:928-977`)
# ----------------------------------------------------------------------

def lieb_lattice(nx_: int, ny_: int, periodic: bool = False) -> NamedGraph:
    """Lieb lattice: a square lattice with decorated edges (odd dims open,
    even dims periodic)."""
    ok = (not periodic and nx_ % 2 == 1 and ny_ % 2 == 1) or (periodic and nx_ % 2 == 0 and ny_ % 2 == 0)
    if not ok:
        raise ValueError("lieb_lattice: need odd dims (open) or even dims (periodic)")
    g = named_grid((nx_, ny_), periodic=periodic)
    for v in list(g.vertices()):
        if v[0] % 2 == 0 and v[1] % 2 == 0:
            g.rem_vertex(v)
    return g


def topology_to_graph(topology: Sequence[Sequence[int]]) -> NamedGraph:
    """Graph on 1..n from a list of integer edge pairs."""
    nq = max(max(pair) for pair in topology)
    g = NamedGraph(range(1, nq + 1))
    for i, j in topology:
        g.add_edge(i, j)
    return g


def build_graph_from_gates(circuit: Sequence) -> NamedGraph:
    """Graph induced by the 2-site gates of a circuit; a disconnected one
    raises."""
    vs, seen = [], set()
    for gate in circuit:
        for v in gate[1]:
            if v not in seen:
                seen.add(v)
                vs.append(v)
    g = NamedGraph(vs)
    for gate in circuit:
        qubits = list(gate[1])
        if len(qubits) == 2:
            g.add_edge(qubits[0], qubits[1])
    if not is_connected(g):
        raise ValueError("The circuit graph is not connected; the resulting tensor network would be disconnected, "
                         "which is not supported. Simulate the connected components separately.")
    return g


build_graph_from_circuit = build_graph_from_gates
