"""Shared pieces of the flex-tier tests (`tests/test_torch_flex_*.py`):
graphs carried from the JAX package to the port, and the correspondence of
indices between a JAX network and the port's network built the same way
(the two packages number their indices with counters of their own, so a
tensor's k-th index in one is its k-th index in the other)."""

import numpy as np
import torch

import tnqs
import tnqs_torch as tt

CPU = "cpu"


def graph(g):
    """The port's copy of a `tnqs` graph, vertex and edge order kept."""
    return tt.NamedGraph.from_edges(g.vertices(), g.edges())


GRAPHS = {
    "grid3x3": lambda: tnqs.named_grid((3, 3)),
    "grid4x4": lambda: tnqs.named_grid((4, 4)),
    "ring6": lambda: tnqs.named_ring_graph(6),
    "comb3x3": lambda: tnqs.named_comb_tree((3, 3)),
    "hex2x2p": lambda: tnqs.named_hexagonal_lattice_graph(2, 2, periodic=True),
}


class IndexMap:
    """JAX index id -> port index id, learned position by position from
    pairs of tensors with the same index layout."""

    def __init__(self):
        self.ids = {}

    def learn(self, tj, tp):
        assert len(tj.inds) == len(tp.inds)
        for a, b in zip(tj.inds, tp.inds):
            assert (a.dim, a.plev) == (b.dim, b.plev)
            self.ids.setdefault(a.id, b.id)
        return self

    def learn_network(self, nj, np_):
        for v in nj.vertices():
            self.learn(nj[v], np_[v])
        return self

    def array(self, tj, tp):
        """The JAX tensor's array in the port tensor's index order."""
        key = {(self.ids[i.id], i.plev): k for k, i in enumerate(tj.inds)}
        return np.transpose(np.asarray(tj.data), [key[(i.id, i.plev)] for i in tp.inds])

    def diff(self, tj, tp) -> float:
        return float(np.abs(self.array(tj, tp) - tp.to_numpy()).max())


def pair_states(g, bond_dimension, dtype, seed):
    """The same random state in both packages (one seed), and their map."""
    psij = tnqs.random_tensornetworkstate(g, bond_dimension=bond_dimension, dtype=dtype,
                                          rng=np.random.default_rng(seed))
    psip = tt.random_tensornetworkstate(graph(g), bond_dimension=bond_dimension, dtype=dtype,
                                        rng=np.random.default_rng(seed), device=CPU)
    return psij, psip, IndexMap().learn_network(psij, psip)


def state_descriptors(psij):
    """A JAX state as `TensorNetworkState.from_arrays` takes it."""
    enc = lambda inds: [[i.id, i.dim, i.tag, i.plev] for i in inds]  # noqa: E731
    arrays = {v: (np.asarray(psij[v].data), enc(psij[v].inds)) for v in psij.vertices()}
    return arrays, {v: enc(psij.siteinds(v)) for v in psij.vertices()}


def tol(dtype) -> float:
    return 1e-10 if np.dtype(dtype) in (np.complex128, np.float64) else 1e-5


def layer(g, theta=0.3, phi=0.7):
    """One kicked-Ising layer on a `tnqs` graph (gate tuples serve both)."""
    return [("Rx", [v], theta) for v in g.vertices()] + [
        ("Rzz", list(e), phi) for group in tnqs.edge_color(g) for e in group]


def torch_threads():
    torch.set_num_threads(1)
