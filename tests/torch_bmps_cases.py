"""States and sketches shared by the boundary-MPS port tests
(`test_torch_bmps*.py`): small lattices made with the JAX package and
carried into the port as packed arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tnqs
from tnqs.engine import LatticeEngine as JaxEngine

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine

# <Z> parity between the packages: 2e-5 absolute at complex64, 1e-10 at
# complex128 (they contract in other orders and their library eighs and
# SVDs round differently)
Z_TOL = {np.complex64: 2e-5, np.complex128: 1e-10}


def port_graph(g):
    return tt.NamedGraph.from_edges(g.vertices(), g.edges())


def carry(je):
    """The port's engine on the JAX engine's state (CPU, same layout)."""
    T = {k: np.asarray(v) for k, v in je.T.items()}
    dtype = torch.complex128 if np.asarray(je.M).dtype == np.complex128 else torch.complex64
    return LatticeEngine.from_arrays(port_graph(je.plan.graph), T, np.asarray(je.M), chi=je.chi, dtype=dtype,
                                     device="cpu", bp_schedule=je.plan.bp_schedule)


def flex_state(g, theta=0.3, layers=2, maxdim=4, hx=0.5):
    """Rzz(theta) on every edge and Rx(hx) on every vertex, `layers` times
    from "↑", by the flex tier's simple update (`tests/test_bmps_engine.py:18`)."""
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    bpc = tnqs.BeliefPropagationCache(psi)
    layer = [("Rzz", e, theta) for e in g.edges()] + [("Rx", [v], hx) for v in g.vertices()]
    for _ in range(layers):
        bpc, _ = tnqs.apply_gates(layer, bpc, apply_kwargs=dict(cutoff=1e-12, maxdim=maxdim, normalize_tensors=True))
    return bpc.network


def random_engines(dtype):
    """A random bond-2 state on the 3x3 grid (`tests/test_bmps_engine.py:563`)
    in both packages."""
    from tnqs.networks import random_tensornetworkstate

    g = tnqs.named_grid((3, 3))
    psi = random_tensornetworkstate(g, "S=1/2", bond_dimension=2, dtype=dtype, rng=np.random.default_rng(1))
    je = JaxEngine(psi, chi=2, dtype=dtype)
    return je, carry(je)


def jax_sketch(seed):
    """JAX's sketch draws (`tnqs/bmps_engine.py:718-720`) as the port's
    `sketch(code, shape)`."""
    key = jax.random.PRNGKey(seed)

    def draw(code, shape):
        om = np.array(jax.random.normal(jax.random.fold_in(key, code), (2,) + tuple(shape), dtype=jnp.float32))
        return torch.complex(torch.from_numpy(om[0]), torch.from_numpy(om[1]))

    return draw


def counting(sketch):
    """`sketch` with a count of its draws in `.draws`."""

    def draw(code, shape):
        draw.draws += 1
        return sketch(code, shape)

    draw.draws = 0
    return draw


def cylinder(dt=0.3, layers=2):
    """(graph, port engine, JAX engine) of `tests/test_ring_bmps.py:30`'s
    TFIM state on the 6x3 cylinder, evolved by the port and carried into a
    JAX engine of the same plan."""
    g = tnqs.named_grid((6, 3), periodic=(True, False))
    pe = LatticeEngine(port_graph(g), chi=2, device="cpu")
    pe.bp_update(maxiter=10)
    if layers:
        pe.evolve(tt.tfim_layer(pe.plan.graph, J=0.5, hx=1.0, dt=dt), num_layers=layers, cutoff=1e-10, bp_maxiter=10)
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JaxEngine(psi, chi=2, dtype=jnp.complex64)
    assert je.plan.bp_schedule == pe.plan.bp_schedule
    T, M = pe.to_arrays()
    je.T, je.M = {k: jnp.asarray(v) for k, v in T.items()}, jnp.asarray(M)
    return g, pe, je


def replay(out, keys_order):
    """The port's `BMPSSampler(uniforms=...)` that takes the bits of JAX's
    samples `out`: at d = 2 the draw values 0.0 and 1.0 give bits 0 and 1
    whatever the law (`inverse_cdf`)."""
    bits = torch.tensor([[o["bitstring"][v] for v in keys_order] for o in out], dtype=torch.float32)
    return lambda seed, s, nv: bits[s]


def exact_probability(st):
    """|<x|psi>|^2 of the flex state `st` by exact contraction
    (`tests/test_bmps_engine.py:167-173`), memoized by bitstring."""
    from tnqs.core.tensor import onehot
    from tnqs.networks import TensorNetwork

    s = st.siteinds()
    memo = {}

    def p(bitstring):
        key = tuple(sorted(bitstring.items()))
        if key not in memo:
            proj = {v: st[v] * st._adapt_like(onehot(s[v][0], bitstring[v])) for v in st.vertices()}
            amp = tnqs.contract_network(TensorNetwork(proj, st.graph.copy()), alg="exact")
            memo[key] = abs(complex(amp)) ** 2
        return memo[key]

    return p
