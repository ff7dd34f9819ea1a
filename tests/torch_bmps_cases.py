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


def flex_state(g, theta=0.3, layers=2, maxdim=4):
    """Rzz(theta) on every edge and Rx(0.5) on every vertex, `layers` times
    from "↑", by the flex tier's simple update (`tests/test_bmps_engine.py:18`)."""
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    bpc = tnqs.BeliefPropagationCache(psi)
    layer = [("Rzz", e, theta) for e in g.edges()] + [("Rx", [v], 0.5) for v in g.vertices()]
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
