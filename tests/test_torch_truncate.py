"""tnqs_torch.truncate against tnqs.truncate on the CPU, on the entangled
3x3 state of `tests/test_truncate.py` built in both packages: the BP and
boundary-MPS truncations' exact fidelities, the ordering property, the
dispatch on a state, a BP cache and a BMPS cache, and the errors."""

import numpy as np
import pytest
import torch

import tnqs

import tnqs_torch as tt
from tnqs_torch import fullupdate as pfu

from torch_flex_cases import CPU, graph

torch.set_num_threads(1)

# The boundary MPS of the 3x3 state at maxdim 4 is exact at rank 16, where
# the packages agree to ~2e-15.  At the reference test's rank 12 the port
# reads 1.2e-8 from JAX although 1e-15 noise on the state moves it by ~1e-14
# (`python tests/torch_truncate_noise_reference.py`): a truncating fit from
# the flex BMPS's rank-deficient start, whose null-space basis each library's
# QR sets (ROADMAP Queue 3).  So the packages are compared at rank 16.
EXACT_RANK = 16


def _entangled_state(pkg, g, **device):
    psi = pkg.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex128, **device)
    layer = [("Rx", [v], 0.4) for v in g.vertices()]
    for ce in pkg.edge_color(g, 4):
        layer += [("Rzz", p, 0.7) for p in ce]
    psi, _ = pkg.apply_gates(layer * 3, psi, apply_kwargs=dict(maxdim=4, cutoff=1e-14))
    return psi


def _fidelity(pkg, a, b):
    ip = pkg.inner(a, b, alg="exact")
    return abs(ip) ** 2 / (abs(pkg.norm_sqr(a, alg="exact")) * abs(pkg.norm_sqr(b, alg="exact")))


@pytest.fixture(scope="module")
def states():
    gj = tnqs.named_grid((3, 3))
    psij = _entangled_state(tnqs, gj)
    psip = _entangled_state(tt, graph(gj), device=CPU)
    fj = {
        "bp": _fidelity(tnqs, tnqs.truncate(psij, alg="bp", maxdim=2), psij),
        "boundarymps": _fidelity(
            tnqs, tnqs.truncate(psij, alg="boundarymps", maxdim=2, mps_bond_dimension=EXACT_RANK), psij),
    }
    return psij, psip, fj


@pytest.mark.parametrize("alg", ["bp", "boundarymps"])
def test_truncation_fidelity_matches_jax(states, alg):
    """Both algorithms at maxdim 2: the port's exact fidelity with the
    untruncated state against JAX's within 1e-8."""
    psij, psip, fj = states
    assert psip.maxvirtualdim() == psij.maxvirtualdim() == 4
    kw = dict(mps_bond_dimension=EXACT_RANK) if alg == "boundarymps" else {}
    before = pfu.solves["dense"]
    out = tt.truncate(psip, alg=alg, maxdim=2, **kw)
    assert isinstance(out, tt.TensorNetworkState)
    assert out.maxvirtualdim() <= 2
    assert out[(1, 1)].device == torch.device(CPU)
    # the boundary-MPS route runs full updates (all dense at these sizes)
    assert (pfu.solves["dense"] > before) == (alg == "boundarymps")
    assert abs(_fidelity(tt, out, psip) - fj[alg]) < 1e-8


def test_truncate_orderings(states):
    """`tests/test_truncate.py:28` on the port: fidelity(BMPS at rank 12) >=
    fidelity(BP) - 1e-6, both in [0, 1]."""
    _, psip, _ = states
    t_bp = tt.truncate(psip, alg="bp", maxdim=2)
    t_bm = tt.truncate(psip, alg="boundarymps", maxdim=2, mps_bond_dimension=12)
    assert t_bp.maxvirtualdim() <= 2 and t_bm.maxvirtualdim() <= 2
    f_bp, f_bm = _fidelity(tt, t_bp, psip), _fidelity(tt, t_bm, psip)
    assert 0.0 <= f_bp <= 1.0 + 1e-8
    assert 0.0 <= f_bm <= 1.0 + 1e-8
    assert f_bm >= f_bp - 1e-6


def test_dispatch_on_caches(states):
    """A BP cache is truncated by `truncate_bp_cache` and a BMPS cache by
    `truncate_bmps_cache`, whatever `alg` says; each returns its own type
    with every bond at most maxdim, the BP cache's network the state's
    `alg="bp"` truncation."""
    _, psip, _ = states
    bpc = tt.BeliefPropagationCache(psip).update(**tt.default_bp_update_kwargs(psip))
    out = tt.truncate(bpc, maxdim=2)
    assert isinstance(out, tt.BeliefPropagationCache)
    assert out.network.maxvirtualdim() <= 2
    ref = tt.truncate(psip, alg="bp", maxdim=2)
    assert abs(_fidelity(tt, out.network, ref) - 1.0) < 1e-12
    assert bpc.network.maxvirtualdim() == 4  # the input cache is left as it was

    cache = tt.BoundaryMPSCache(psip, EXACT_RANK, partition_by="row", gauge_state=True)
    cache = cache.update(maxiter=1)
    out = tt.truncate(cache, alg="bp", maxdim=2)
    assert isinstance(out, tt.BoundaryMPSCache)
    # one sweep of the row partitions truncates the in-row bonds
    g = psip.graph
    rows = [e for e in g.edges() if e[0][0] == e[1][0]]
    assert all(out.network.virtualind(e).dim <= 2 for e in rows)
    assert max(out.network.virtualind(e).dim for e in g.edges()) == 4


def test_errors_match_jax(states):
    """A network that is not a state raises TypeError; an algorithm that
    cannot truncate, or an unknown one, ValueError, as in JAX."""
    psij, psip, _ = states
    for pkg, psi in ((tnqs, psij), (tt, psip)):
        net = pkg.TensorNetwork({v: psi[v] for v in psi.vertices()}, psi.graph)
        with pytest.raises(TypeError, match="cannot truncate TensorNetwork"):
            pkg.truncate(net, alg="bp", maxdim=2)
        for alg in ("exact", "loopcorrections", "nonsense", None):
            with pytest.raises(ValueError):
                pkg.truncate(psi, alg=alg, maxdim=2)
