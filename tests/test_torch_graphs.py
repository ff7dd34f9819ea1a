"""The port's lattices, loop configurations, gate registry and models
against the JAX package.

`tnqs_torch.graphs` builds every lattice without networkx; its vertex and
edge lists (and so each vertex's neighbor order, which sets the engine's
bond axes) must be `tnqs.graphs`' exactly, the hexagonal lattice's edge
order included, which networkx's `contracted_nodes` sets in the periodic
case.  The loop-series enumerator is the port's g++ build of
`loop_enum.cpp`, held against its Python plain version and the JAX
package's.  The gate tables must be bit-identical."""

import numpy as np
import pytest

import tnqs
import tnqs.gates as jgates
import tnqs.models as jmodels

import tnqs_torch as tt
from tnqs_torch import gates as pgates
from tnqs_torch import graphs as pgraphs
from tnqs_torch import models as pmodels


def _same(a, b):
    assert a.vertices() == b.vertices()
    assert a.edges() == b.edges()
    assert all(a.neighbors(v) == b.neighbors(v) for v in a.vertices())


HEX = [(1, 1, False), (2, 2, False), (2, 3, False), (5, 5, False), (2, 2, True), (3, 2, True), (3, 4, True),
       (4, 4, True), (2, 6, True)]


@pytest.mark.parametrize("m, n, periodic", HEX, ids=[f"{m}x{n}{'-periodic' if p else ''}" for m, n, p in HEX])
def test_hexagonal_lattice_matches(m, n, periodic):
    _same(tt.named_hexagonal_lattice_graph(m, n, periodic), tnqs.named_hexagonal_lattice_graph(m, n, periodic))


@pytest.mark.parametrize("m, n", [(2, 2), (3, 4), (5, 5)])
def test_heavy_hexagonal_lattice_matches(m, n):
    _same(tt.heavy_hexagonal_lattice(m, n), tnqs.heavy_hexagonal_lattice(m, n))


GRIDS = [((3, 3), False), ((2, 3), False), ((4, 4), True), ((6, 4), (True, False)), ((3, 3, 3), False),
         ((5,), False), ((6,), True), ((2,), True)]


@pytest.mark.parametrize("dims, periodic", GRIDS, ids=[f"{d}-{p}" for d, p in GRIDS])
def test_grid_matches(dims, periodic):
    _same(tt.named_grid(dims, periodic), tnqs.named_grid(dims, periodic))


def test_path_ring_comb_and_queries_match():
    _same(tt.named_path_graph(5), tnqs.named_path_graph(5))
    _same(tt.named_ring_graph(6), tnqs.named_ring_graph(6))
    _same(tt.named_comb_tree((3, 4)), tnqs.named_comb_tree((3, 4)))
    for gp, gj in ((tt.named_ring_graph(6), tnqs.named_ring_graph(6)), (tt.named_path_graph(4), tnqs.named_path_graph(4)),
                   (tt.named_grid((3, 3)), tnqs.named_grid((3, 3))), (tt.named_ring_graph(3), tnqs.named_ring_graph(3))):
        assert pgraphs.is_ring_graph(gp) == tnqs.graphs.is_ring_graph(gj)
    assert pgraphs.is_ring_graph(tt.named_ring_graph(6)) and not pgraphs.is_ring_graph(tt.named_grid((3, 3)))
    with pytest.raises(ValueError):
        tt.named_hexagonal_lattice_graph(2, 3, periodic=True)


def _as_sets(subs):
    return {frozenset(frozenset(e) for e in es) for es in subs}


CONFIGS = [("grid3x3", (3, 3), 4), ("grid3x3", (3, 3), 8), ("heavyhex", (2, 2), 12), ("eagle", None, 12)]


@pytest.mark.parametrize("name, dims, size", CONFIGS, ids=[f"{n}-{s}" for n, _, s in CONFIGS])
def test_leafless_enumerators_agree(name, dims, size):
    if name == "grid3x3":
        gp, gj = tt.named_grid(dims), tnqs.named_grid(dims)
    elif name == "heavyhex":
        gp, gj = tt.heavy_hexagonal_lattice(*dims), tnqs.heavy_hexagonal_lattice(*dims)
    else:
        gp, gj = tt.eagle_lattice(), tnqs.eagle_lattice()
    native = pgraphs.leafless_edge_induced_subgraphs(gp, size)
    edges = set(gp.edges())
    assert all(e in edges for es in native for e in es)  # edges of the graph, in its orientation
    assert _as_sets(native) == _as_sets(tnqs.graphs.leafless_edge_induced_subgraphs(gj, size))
    if name != "eagle":  # the Python enumerator takes ~1.4 s on Eagle at 12; the counts below pin it there
        assert _as_sets(native) == _as_sets(pgraphs.leafless_edge_induced_subgraphs(gp, size, native=False))
    if name == "eagle":
        # the 18 heavy-hex plaquettes, E - V + 1 = 144 - 127 + 1, each a 12-cycle
        assert len(native) == 18 == gp.ne() - gp.nv() + 1 and all(len(es) == 12 for es in native)


def test_gate_registry_is_bit_identical():
    # the built-in gates and their aliases (other tests may register gates in either registry)
    assert pgates.BUILTIN_GATES == jgates.BUILTIN_GATES
    for name in jgates.BUILTIN_GATES:
        spec = jgates.GATES[name]
        params = None if spec.num_params == 0 else (0.3, 0.7) if spec.num_params == 2 else 0.37
        assert np.array_equal(pgates.gate_matrix(name, params), jgates.gate_matrix(name, params)), name
    builtin = lambda aliases: {a: c for a, c in aliases.items() if c in jgates.BUILTIN_GATES}  # noqa: E731
    assert builtin(pgates.ALIASES) == builtin(jgates.ALIASES)
    # complex angles (imaginary time), aliases and Pauli strings
    for name, p in (("Rxxyyzz", -0.005j), ("Rxx", 0.2 - 0.1j), ("rzz", 0.4), ("cp", 0.3)):
        assert np.array_equal(pgates.gate_matrix(name, p), jgates.gate_matrix(name, p))
    assert np.array_equal(pgates.gate_matrix("XYZ"), jgates.gate_matrix("XYZ"))
    with pytest.raises(ValueError):
        pgates.gate_matrix("Rqq", 0.1)


def test_register_alias_and_unregister():
    mat = np.diag([1.0, 1j])
    name = pgates.register_gate("MyS", mat)
    try:
        assert pgates.register_alias("mys_alias", name) == "mys_alias"
        assert np.array_equal(pgates.gate_matrix("mys_alias"), mat)
        with pytest.raises(ValueError):
            pgates.register_gate("Rx", mat)
        with pytest.raises(ValueError):
            pgates.register_gate("MyRot", lambda t: mat)  # a callable needs num_qubits
    finally:
        pgates.unregister_gate(name)
    assert "MyS" not in pgates.GATES and "mys_alias" not in pgates.ALIASES


def test_models_match():
    gj = tnqs.named_hexagonal_lattice_graph(2, 2, periodic=True)
    gp = tt.named_hexagonal_lattice_graph(2, 2, periodic=True)
    for (a, va), (b, vb) in zip(jmodels.heisenberg_thermal_layer(gj, 1.0, 0.01), pmodels.heisenberg_thermal_layer(gp, 1.0, 0.01)):
        assert np.array_equal(a, b) and va == vb
    named = [("Rz", [(1, 1)], 0.3), ("Rxx", [(1, 1), (1, 2)], 0.2), ("Ry", [(1, 2)], -0.1), ("H", [(1, 1)])]
    for (a, va), (b, vb) in zip(jmodels.operator_picture_layer(named), pmodels.operator_picture_layer(named)):
        assert np.array_equal(a, b) and va == vb
    for beta in (0.1, 0.5):
        assert pmodels.htse_free_energy_density_4th(1.0, beta) == jmodels.htse_free_energy_density_4th(1.0, beta)
