"""The flex tier's named-index layer, graphs, gates and contraction planner
in tnqs_torch against the JAX package's, on the CPU: the same numpy inputs
from a seed through both.  Constructors and contractions must give equal
arrays (1e-12 at complex128, 1e-6 at complex64), `contraction_sequence`
the same sequences (optimal, greedy, sa with a seed; the port's native
planner also held against its Python planners), factorizations the same
gauge-invariant products, and the graph algorithms the same orders."""

import numpy as np
import pytest
import torch

import tnqs
import tnqs.contraction as JC
import tnqs_torch as tt
import tnqs_torch.contraction as PC
from tnqs_torch.core import linalg as PL
from torch_flex_cases import CPU, GRAPHS, IndexMap, graph, pair_states

torch.set_num_threads(1)


def test_index_semantics():
    i = tt.Index(3, "Site")
    assert i.prime() != i and i.prime().noprime() == i and i.prime(2) == tt.prime(i, 2)
    assert i.sim() != i and (i.sim().dim, i.sim().tag, i.sim().plev) == (3, "Site", 0)
    assert tt.noprime(i.prime(3)) == i and tt.sim(i).id != i.id
    assert len({i, i.prime(), i.setprime(0)}) == 2


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.complex64])
def test_random_tensor_draws_the_same_arrays(dtype):
    dims = (2, 3, 4)
    a = tnqs.random_tensor([tnqs.Index(d) for d in dims], dtype=dtype, rng=np.random.default_rng(5))
    b = tt.random_tensor([tt.Index(d) for d in dims], dtype=dtype, rng=np.random.default_rng(5), device=CPU)
    assert b.dtype == tt.core.tensor.as_torch_dtype(dtype)
    np.testing.assert_array_equal(np.asarray(a.data), b.to_numpy())


def test_constructors_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    g = tt.named_grid((2, 2))
    for make in (lambda: tt.tensornetworkstate(lambda v: "↑", g), lambda: tt.random_tensornetworkstate(g),
                 lambda: tt.delta([tt.Index(2)]), lambda: tt.Tensor(np.ones(2), [tt.Index(2)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("name", ["grid3x3", "hex2x2p", "comb3x3"])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64, np.float64])
def test_random_states_equal(name, dtype):
    psij, psip, imap = pair_states(GRAPHS[name](), 2, dtype, 11)
    assert psip.graph.vertices() == psij.graph.vertices() and psip.graph.edges() == psij.graph.edges()
    for v in psij.vertices():
        np.testing.assert_array_equal(imap.array(psij[v], psip[v]), psip[v].to_numpy())
        assert [i.tag for i in psij.siteinds(v)] == [i.tag for i in psip.siteinds(v)]
    assert psip.maxvirtualdim() == psij.maxvirtualdim()


def _same_network(nj, np_, atol):
    imap = IndexMap().learn_network(nj, np_)
    for v in nj.vertices():
        assert imap.diff(nj[v], np_[v]) <= atol


@pytest.mark.parametrize("case", ["product", "zerostate", "identity", "toric", "ising", "random_tn"])
def test_state_constructors_equal(case):
    g = tnqs.named_grid((3, 3))
    gp = graph(g)
    if case == "product":
        f = lambda v: "+" if (v[0] + v[1]) % 2 else [0.6, 0.8j]  # noqa: E731
        nj, np_ = (tnqs.tensornetworkstate(f, g, dtype=np.complex128),
                   tt.tensornetworkstate(f, gp, dtype=np.complex128, device=CPU))
    elif case == "zerostate":
        nj, np_ = tnqs.zerostate(g, dtype=np.complex64), tt.zerostate(gp, dtype=np.complex64, device=CPU)
    elif case == "identity":
        nj, np_ = tnqs.identity_tensornetworkstate(g), tt.identity_tensornetworkstate(gp, device=CPU)
    elif case == "toric":
        nj, np_ = tnqs.toriccode_groundstate(3), tt.toriccode_groundstate(3, device=CPU)
    elif case == "ising":
        nj, np_ = tnqs.ising_partitionfunction(g, 0.4), tt.ising_partitionfunction(gp, 0.4, device=CPU)
    else:
        nj = tnqs.random_tensornetwork(g, bond_dimension=3, dtype=np.complex64, rng=np.random.default_rng(2))
        np_ = tt.random_tensornetwork(gp, bond_dimension=3, dtype=np.complex64, rng=np.random.default_rng(2),
                                      device=CPU)
    _same_network(nj, np_, 0.0 if case != "ising" else 1e-12)
    assert np_.graph == graph(nj.graph)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_contractions_equal(dtype):
    psij, psip, imap = pair_states(tnqs.named_grid((2, 3)), 3, dtype, 4)
    vs = psij.vertices()
    atol = 1e-12 if dtype == np.complex128 else 1e-6
    for seq in (None, [[1, 2], [[3, 4], [5, 6]]]):
        a = tnqs.core.tensor.contract([psij[v] for v in vs], sequence=seq)
        b = tt.core.tensor.contract([psip[v] for v in vs], sequence=seq)
        imap.learn(a, b)
        assert imap.diff(a, b) <= atol * max(1.0, float(np.abs(b.to_numpy()).max()))
    # the doubled network, exact contraction, traces and dots
    tj = tnqs.contraction.contract(psij.norm_factors(vs))
    tp = tt.contraction.contract(psip.norm_factors(vs))
    assert abs(tj.item() - tp.item()) <= atol * abs(tj.item())
    v = vs[0]
    assert abs(psij[v].dot(psij[v]) - psip[v].dot(psip[v])) <= atol * abs(psij[v].dot(psij[v]))
    rj = (psij[v] * psij[v].prime().dag()).trace_pairs()
    rp = (psip[v] * psip[v].prime().dag()).trace_pairs()
    assert imap.learn(rj, rp).diff(rj, rp) <= atol * 10


def test_directsum_and_add_equal():
    g = tnqs.named_grid((2, 2))
    aj, ap, imap = pair_states(g, 2, np.complex128, 1)
    bj = tnqs.random_tensornetworkstate(g, aj.siteinds(), bond_dimension=3, dtype=np.complex128,
                                        rng=np.random.default_rng(2))
    bp = tt.random_tensornetworkstate(graph(g), ap.siteinds(), bond_dimension=3, dtype=np.complex128,
                                      rng=np.random.default_rng(2), device=CPU)
    imap.learn_network(bj, bp)
    sj, sp = aj + bj, ap + bp
    for v in g.vertices():
        imap.learn(sj[v], sp[v])
        np.testing.assert_array_equal(imap.array(sj[v], sp[v]), sp[v].to_numpy())
    assert abs(tnqs.norm_sqr(sj, alg="exact") - tt.norm_sqr(sp, alg="exact")) < 1e-10 * abs(
        tnqs.norm_sqr(sj, alg="exact"))


def _random_lists(rng, n_tensors, n_inds, maxdim=4):
    """Random networks of index sets (each index on two tensors)."""
    out = []
    for _ in range(4):
        dims = rng.integers(2, maxdim + 1, n_inds)
        pairs = [rng.choice(n_tensors, 2, replace=False) for _ in range(n_inds)]
        ij = [tnqs.Index(int(d)) for d in dims]
        ip = [tt.Index(int(d)) for d in dims]
        lj = [[ij[k] for k, p in enumerate(pairs) if t in p] for t in range(n_tensors)]
        lp = [[ip[k] for k, p in enumerate(pairs) if t in p] for t in range(n_tensors)]
        if all(lj):
            out.append(([tnqs.Tensor(np.zeros([i.dim for i in s]), s) for s in lj],
                        [tt.Tensor(np.zeros([i.dim for i in s]), s, device=CPU) for s in lp]))
    return out


def _cost(tensors, seq):
    """Multiply count of a sequence (the optimal planner's objective)."""
    sets = [frozenset(t.inds) for t in tensors]
    total = 0

    def walk(s):
        nonlocal total
        if isinstance(s, int):
            return sets[s - 1]
        out = None
        for part in s:
            p = walk(part)
            if out is not None:
                total += int(np.prod([i.dim for i in out | p]))
                out = out ^ p
            else:
                out = p
        return out

    walk(seq)
    return total


@pytest.mark.parametrize("n", [5, 9, 13, 26])
def test_contraction_sequences_equal(n):
    rng = np.random.default_rng(n)
    for lj, lp in _random_lists(rng, n, int(1.6 * n)):
        for alg, kw in [("optimal", {}), ("greedy", {}), ("sa", {"seed": 3})]:
            assert tt.contraction_sequence(lp, alg=alg, **kw) == tnqs.contraction_sequence(lj, alg=alg, **kw)
        # the native planner against the Python ones
        if n <= PC._OPTIMAL_MAX:
            assert _cost(lp, tt.contraction_sequence(lp, alg="optimal")) == _cost(
                lp, tt.contraction_sequence(lp, alg="optimal", native=False))
            assert tt.contraction_sequence(lp, alg="optimal", native=False) == JC._optimal_sequence(lj)
        assert tt.contraction_sequence(lp, alg="greedy", native=False) == JC._greedy_sequence(lj)
        for alg in ("treewidth", "exacttreewidth", "sabipartite", "hypernd"):
            assert PC._validate_sequence(tt.contraction_sequence(lp, alg=alg), n) is None


def test_contraction_sequence_callable_protocol():
    _, lp = _random_lists(np.random.default_rng(0), 5, 8)[0]
    assert tt.contraction_sequence(lp, alg=lambda sets, dims: [[1, 2], [3, [4, 5]]]) == [[1, 2], [3, [4, 5]]]
    with pytest.raises(ValueError):
        tt.contraction_sequence(lp, alg=lambda sets, dims: [1, 2])


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_factorizations_equal_as_products(dtype):
    rng = np.random.default_rng(3)
    dims = (3, 4, 5)
    ij, ip = [tnqs.Index(d) for d in dims], [tt.Index(d) for d in dims]
    tj = tnqs.random_tensor(ij, dtype=dtype, rng=np.random.default_rng(9))
    tp = tt.random_tensor(ip, dtype=dtype, rng=np.random.default_rng(9), device=CPU)
    atol = 1e-12 if dtype == np.complex128 else 1e-5
    imap = IndexMap().learn(tj, tp)
    for maxdim, cutoff in [(None, None), (6, None), (None, 1e-2), (4, 1e-3)]:
        Uj, Sj, Vj, ej = tnqs.svd(tj, ij[:1] + ij[2:], maxdim=maxdim, cutoff=cutoff)
        Up, Sp, Vp, ep = tt.svd(tp, ip[:1] + ip[2:], maxdim=maxdim, cutoff=cutoff)
        np.testing.assert_allclose(np.diag(Sp.to_numpy()), np.diag(np.asarray(Sj.data)), atol=atol)
        assert abs(ej - ep) <= atol and Sp.inds[0].dim == Sj.inds[0].dim
        rj, rp = Uj * Sj * Vj, Up * Sp * Vp
        assert imap.diff(rj, rp) <= atol * 10
        for ortho in ("none", "left", "right"):
            Lj, Rj, _, _ = tnqs.factorize_svd(tj, ij[:2], maxdim=maxdim, cutoff=cutoff, ortho=ortho)
            Lp, Rp, _, _ = tt.factorize_svd(tp, ip[:2], maxdim=maxdim, cutoff=cutoff, ortho=ortho)
            assert imap.diff(Lj * Rj, Lp * Rp) <= atol * 10
    Qj, Rj = tnqs.qr(tj, ij[1:])
    Qp, Rp = tt.qr(tp, ip[1:])
    assert imap.diff(Qj * Rj, Qp * Rp) <= atol * 10
    # Q orthonormal
    q = Qp.matricize(ip[1:])
    np.testing.assert_allclose((q.conj().T @ q).numpy(), np.eye(q.shape[1]), atol=atol)
    for ortho in ("left", "right"):
        Lp, Rp = tt.factorize(tp, ip[:1], ortho=ortho)
        assert imap.diff(tj, Lp * Rp) <= atol * 10


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_hermitian_functions_equal(dtype):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 5)) + 1j * rng.standard_normal((5, 5))
    w = np.array([2.0, 1.0, 0.5, 0.1, 1e-20])  # the last below the pseudo-root's cut
    q, _ = np.linalg.qr(a)
    m = (q * w) @ q.conj().T
    m = ((m + m.conj().T) / 2).astype(dtype)
    ij, ip = tnqs.Index(5), tt.Index(5)
    mj = tnqs.from_matrix(m, [ij], [ij.prime()])
    mp = tt.from_matrix(m, [ip], [ip.prime()], device=CPU)
    imap = IndexMap().learn(mj, mp)
    atol = 1e-12 if dtype == np.complex128 else 1e-5
    for a_, b_ in zip(tnqs.pseudo_sqrt_inv_sqrt(mj), tt.pseudo_sqrt_inv_sqrt(mp)):
        assert imap.diff(a_, b_) <= atol * 10
    wj = tnqs.eigh(mj)[0]
    np.testing.assert_allclose(tt.eigh(mp)[0], wj, atol=atol)
    f = lambda x: x * x + 0.5  # noqa: E731
    assert imap.diff(tnqs.map_eigs(mj, f), tt.map_eigs(mp, f)) <= atol * 10
    assert imap.diff(tnqs.map_diag(mj, np.exp), tt.map_diag(mp, np.exp)) <= atol * 10
    assert tt.truncation_rank(np.array([1.0, 0.1, 1e-4]), cutoff=1e-6) == tnqs.truncation_rank(
        np.array([1.0, 0.1, 1e-4]), cutoff=1e-6)
    reads = PL.host_reads.count
    tt.svd(mp, [ip], maxdim=2)
    assert PL.host_reads.count == reads + 1


def test_op_matrix_one_table():
    from tnqs.sitetypes import _OPS_2, _OPS_3

    for dim, table in ((2, _OPS_2), (3, _OPS_3)):
        for name in table:
            np.testing.assert_array_equal(tt.op_matrix(name, dim), tnqs.op_matrix(name, dim))
    assert tt.op_matrix("Z") is tt.gates.op_matrix("Z") and tt.sitetypes.OPERATORS is tt.sitetypes._OPS_2
    for name in ("↑", "+", "i", "Z-"):
        np.testing.assert_array_equal(tt.state_vector(name, 2), tnqs.state_vector(name, 2))
    assert (tt.site_dimension("S=1"), tt.site_tag("qubit")) == (3, "S=1/2")


def test_gate_tensors_equal():
    g = tnqs.named_grid((2, 2))
    psij, psip, imap = pair_states(g, 1, np.complex128, 0)
    circuit = [("Rx", [(1, 1)], 0.3), ("CNOT", [(1, 1), (1, 2)]), ("Rzz", [(2, 1), (2, 2)], 0.5),
               ("XY", [(1, 2), (2, 2)])]
    for (tj, vj), (tp, vp) in zip(tnqs.gates.circuit_to_tensors(circuit, g, psij.siteinds()),
                                  tt.gates.circuit_to_tensors(circuit, graph(g), psip.siteinds(), device=CPU)):
        assert vj == vp
        np.testing.assert_array_equal(imap.array(tj, tp), tp.to_numpy())
        assert tt.to_tensor(tp, graph(g), psip.siteinds())[1] == vp
    s = psip.siteinds((1, 1))[0]
    sj = psij.siteinds((1, 1))[0]
    for name, param in (("Rz", 0.2), ("I", None), ("X", None)):
        np.testing.assert_array_equal(imap.array(tnqs.gates.op(name, sj, param), tt.gates.op(name, s, param,
                                                                                               device=CPU)),
                                      tt.gates.op(name, s, param, device=CPU).to_numpy())


@pytest.mark.parametrize("name", list(GRAPHS) + ["eagle", "lieb", "hex3x3"])
def test_graph_algorithms_equal(name):
    g = {"eagle": tnqs.eagle_lattice, "lieb": lambda: tnqs.lieb_lattice(5, 5),
         "hex3x3": lambda: tnqs.named_hexagonal_lattice_graph(3, 3)}.get(name, GRAPHS.get(name))()
    gp = graph(g)
    vs = g.vertices()
    assert tt.graphs.connected_components(gp) == tnqs.graphs.connected_components(g)
    assert tt.graphs.bfs_parents(gp, vs[1]) == tnqs.graphs.bfs_parents(g, vs[1])
    assert tt.post_order_dfs_edges(gp, vs[-1]) == tnqs.post_order_dfs_edges(g, vs[-1])
    assert tt.a_star(gp, vs[0], vs[-1]) == tnqs.a_star(g, vs[0], vs[-1])
    assert tt.leaf_vertices(gp) == tnqs.leaf_vertices(g)
    assert tt.graphs.eccentricity_ordered_vertices(gp) == tnqs.graphs.eccentricity_ordered_vertices(g)
    assert tt.center(gp) == tnqs.center(g)
    half = vs[: len(vs) // 2]
    for d in ("in", "out"):
        assert tt.boundary_edges(gp, half, dir=d) == tnqs.boundary_edges(g, half, dir=d)
    assert tt.graphs.spanning_forest(gp).edges() == tnqs.graphs.spanning_forest(g).edges()
    assert [f.edges() for f in tt.forest_cover(gp)] == [f.edges() for f in tnqs.forest_cover(g)]
    assert tt.forest_cover_edge_sequence(gp) == tnqs.forest_cover_edge_sequence(g)
    rng = np.random.default_rng(len(vs))
    for _ in range(30):
        ts = [vs[i] for i in rng.choice(len(vs), int(rng.integers(2, 5)), replace=False)]
        assert tt.steiner_tree(gp, ts).vertices() == tnqs.steiner_tree(g, ts).vertices()
    for length in (4, 6, 8):
        assert tt.unique_simple_cycles(gp, length) == tnqs.unique_simple_cycles(g, length)
    if all(isinstance(v, tuple) for v in vs):
        groups = {}
        for v in vs:
            groups.setdefault(v[0], []).append(v)
        pj, pp = tnqs.PartitionedGraph(g, groups), tt.PartitionedGraph(gp, groups)
        assert pp.quotient.edges() == pj.quotient.edges() and pp.group_of == pj.group_of


def test_graph_builders_equal():
    for periodic, dims in ((False, (5, 3)), (True, (4, 4))):
        assert graph(tnqs.lieb_lattice(*dims, periodic=periodic)).edges() == tt.lieb_lattice(
            *dims, periodic=periodic).edges()
    topo = [(1, 2), (2, 3), (3, 4), (4, 1), (2, 5)]
    assert tt.topology_to_graph(topo).edges() == tnqs.topology_to_graph(topo).edges()
    circ = [("H", [3]), ("CNOT", [3, 1]), ("CZ", [1, 2])]
    pg, jg = tt.build_graph_from_gates(circ), tnqs.build_graph_from_gates(circ)
    assert (pg.vertices(), pg.edges()) == (jg.vertices(), jg.edges())
    with pytest.raises(ValueError):
        tt.build_graph_from_gates([("CNOT", [1, 2]), ("CNOT", [3, 4])])
