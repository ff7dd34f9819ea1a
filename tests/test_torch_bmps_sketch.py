"""tnqs_torch.bmps_engine's sketch path against tnqs.bmps_engine and against
exact contraction, on the CPU.

The exact-emit limit is lowered to 0 (monkeypatched, as
`tests/test_bmps_engine.py:237` does), so every emit at these small sizes
runs the randomized range finder.  Against JAX the port takes JAX's own
draws (`jax.random.fold_in`) through `sketch=`; the port's own generator
(`cpu_sketch`) is held against exact contraction within the JAX tests'
bounds instead.  Parity tolerances are `torch_bmps_cases.Z_TOL`.
"""

from functools import partial

import numpy as np
import pytest
import torch

import tnqs
import tnqs.bmps_engine as JB
from tnqs.engine import LatticeEngine as JaxEngine

import tnqs_torch.bmps_engine as PB
from torch_bmps_cases import Z_TOL, carry, counting, flex_state, jax_sketch

torch.set_num_threads(1)


@pytest.fixture
def sketch_all(monkeypatch):
    monkeypatch.setattr(JB, "_EXACT_EMIT_LIMIT", 0)
    monkeypatch.setattr(PB, "_EXACT_EMIT_LIMIT", 0)


def _engines(dtype):
    """States on the 3x2 grid: complex64, the entangled flex state (a random
    state is too ill-conditioned for float32: the Gram eigh of `_orth`
    squares its spectrum, and a power iteration squares it again, so its
    sketched <Z> moves by more than the parity bound under rounding-sized
    perturbations of the state); complex128, a random state."""
    g = tnqs.named_grid((3, 2))
    if dtype == np.complex128:
        from tnqs.networks import random_tensornetworkstate

        psi = random_tensornetworkstate(g, "S=1/2", bond_dimension=2, dtype=dtype, rng=np.random.default_rng(1))
        je = JaxEngine(psi, chi=2, dtype=dtype)
    else:
        je = JaxEngine(flex_state(g), chi=4)
    return je, carry(je)


@pytest.mark.parametrize(
    "dtype, args",
    [(np.complex64, dict(rank=3, oversample=2, power_iters=1)),
     (np.complex128, dict(rank=2, oversample=2, power_iters=1, zip_factor=2))],
    ids=["complex64", "complex128-zip2"],
)
def test_sketch_path_matches_jax(sketch_all, dtype, args):
    """<Z> with every emit sketched, on JAX's draws, with a power
    iteration; at complex128 zipped at twice the rank, then rounded
    (`_round_chain`), and the norm.  Each sketched emit depends on the
    gauge of the chain it consumes, which each package's eigensolver fixes
    by its own eigenvector phases; where the phases differ the packages
    part by the sketch noise, far above the parity bound, each within the
    bounds of `test_port_sketch_matches_exact`.  These states and settings
    keep the phases, so the parity bound holds."""
    je, pe = _engines(dtype)
    sketch = counting(jax_sketch(7))
    bj, bp = JB.BMPSEngine(je, **args), PB.BMPSEngine(pe, sketch=sketch, **args)
    zj, zp = bj.expect_1site("Z"), bp.expect_1site("Z")
    assert max(abs(zp[v] - zj[v]) for v in zj) < Z_TOL[dtype]
    if dtype == np.complex128:  # the bilinear sweep once, on the zip2 case
        assert abs(bp.lognorm() - bj.lognorm()) < Z_TOL[dtype]
    assert sketch.draws > 0


def test_cpu_sketch_is_seeded_per_fold():
    a, b = PB.cpu_sketch(7, 4096, (2, 3)), PB.cpu_sketch(7, 4096, (2, 3))
    assert a.dtype == torch.complex64 and a.shape == (2, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, PB.cpu_sketch(7, 4097, (2, 3)))
    assert not torch.equal(a, PB.cpu_sketch(8, 4096, (2, 3)))


def test_port_sketch_matches_exact(sketch_all):
    """The port's own generator on the 4x4 entangled grid state, every emit
    sketched, against exact contraction within the bounds of
    `tests/test_bmps_engine.py:31`, `:406` and `:442`."""
    from tnqs.measure import rdm_matrix, reduced_density_matrix

    g = tnqs.named_grid((4, 4))
    st = flex_state(g)
    pe = carry(JaxEngine(st, chi=4))
    sketch = counting(partial(PB.cpu_sketch, 7))
    be = PB.BMPSEngine(pe, rank=8, sketch=sketch)
    z = be.expect_1site("Z")
    errs = [abs(z[v].real - complex(tnqs.expect(st, ("Z", v), alg="exact")).real) for v in g.vertices()]
    assert max(errs) < 2e-3 and float(np.mean(errs)) < 2e-4
    assert sketch.draws > 0 and be.sketch_bytes == 0  # drawn on the engine's device
    col = be.cplan.columns[1]
    pairs = [(col[0], col[1]), (col[0], col[-1])]
    for (v1, v2), val in be.expect_2site("Z", "Z", pairs=pairs).items():
        assert abs(val.real - complex(tnqs.expect(st, ("ZZ", [v1, v2]), alg="exact")).real) < 3e-3
    vs = [col[0], col[2]]
    want = rdm_matrix(reduced_density_matrix(st, vs, alg="exact"))
    assert np.abs(be.rdm(vs) - want / np.trace(want)).max() < 3e-3


def test_port_sketch_overlaps_match_exact(sketch_all):
    """The port's own generator on the bilinear sweeps of two 3x3 states,
    every emit sketched, against exact contraction within the bounds of
    `tests/test_bmps_engine.py:526`."""
    g = tnqs.named_grid((3, 3))
    a, b = flex_state(g, 0.3), flex_state(g, 0.45)
    want = complex(tnqs.inner(b, a, alg="exact"))
    na = abs(complex(tnqs.norm_sqr(a, alg="exact")))
    nb = abs(complex(tnqs.norm_sqr(b, alg="exact")))
    pa, pb = carry(JaxEngine(a, chi=4)), carry(JaxEngine(b, chi=4))
    sketch = counting(partial(PB.cpu_sketch, 7))
    be = PB.BMPSEngine(pb, rank=10, sketch=sketch)
    assert abs(be.inner(pa) - want) / abs(want) < 2e-3
    f_want = abs(want) ** 2 / (na * nb)
    assert abs(be.fidelity(pa) - f_want) / f_want < 3e-3
    assert abs(be.fidelity(pb) - 1.0) < 1e-4
    assert abs(np.exp(be.lognorm()) - nb) / nb < 2e-3
    assert sketch.draws > 0
