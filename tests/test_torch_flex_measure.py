"""The flex tier's measurement, boundary-MPS, loop-correction and sampling
API in tnqs_torch against the JAX package's, on the CPU, at complex128:
states from one seed on small lattices, evolved by `apply_gates` at
maxdim 2.  `expect`, norms, overlaps, RDMs and entropies by BP and exact
contraction agree to 1e-10; so do the BMPS results and the samplers' p/q
and log q (with the same bits for the same `default_rng` seed) at a rank
that holds every boundary exactly.  Below that rank the fitting's result
depends on the basis its QR gives the null space of its rank-deficient
start, which the packages' LAPACKs pick differently (the JAX package's own
p/q moves by ~5e-5 under 1e-15 noise on its QR inputs,
`tests/torch_flex_noise_reference.py`).  The loop-corrected norms are held
to `golden_loopcorrections.json` at its 1e-5."""

import json
import pathlib

import numpy as np
import pytest
import torch

import tnqs
import tnqs_torch as tt
from torch_flex_cases import CPU, GRAPHS, graph, layer, pair_states

torch.set_num_threads(1)

TOL = 1e-10
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "golden_loopcorrections.json"


@pytest.fixture(scope="module")
def evolved():
    """A 3x3-grid state after one kicked-Ising layer at maxdim 2, in both
    packages (the JAX cache, the port cache)."""
    g = GRAPHS["grid3x3"]()
    psij, psip, _ = pair_states(g, 2, np.complex128, 21)
    ak = dict(maxdim=2, cutoff=1e-12)
    bj, _ = tnqs.apply_gates(layer(g), tnqs.BeliefPropagationCache(psij), apply_kwargs=ak)
    bp, _ = tt.apply_gates(layer(g), tt.BeliefPropagationCache(psip), apply_kwargs=ak)
    return g, bj, bp


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max())), (a, b)


OBSERVABLES = [("Z", [(2, 2)]), ("XX", [(1, 1), (1, 2)]), ("ZZ", [(1, 1), (3, 3)], 0.5), ("X", [(1, 3)], 0),
               (["Z", "Y", "X"], [(1, 1), (2, 1), (3, 1)])]


def test_expect_bp_and_exact_equal(evolved):
    g, bj, bp = evolved
    close(tt.expect(bp, OBSERVABLES), tnqs.expect(bj, OBSERVABLES))
    close(tt.expect(bp.network, OBSERVABLES[:3], alg="exact"), tnqs.expect(bj.network, OBSERVABLES[:3], alg="exact"))
    z = tt.expect(bp, ("Z", [(2, 2)]))
    assert isinstance(z, complex) and z == tt.expect(bp, [("Z", [(2, 2)])])[0]
    close(tt.expect(bp.network, OBSERVABLES[:2], alg="bp"), tnqs.expect(bj.network, OBSERVABLES[:2], alg="bp"))
    with pytest.raises(ValueError):
        tt.expect(bp, ("ZZ", [(1, 1)]))


def test_norms_and_inner_equal(evolved):
    g, bj, bp = evolved
    psij, psip = bj.network, bp.network
    for alg in ("bp", "exact"):
        close(tt.norm_sqr(psip, alg=alg), tnqs.norm_sqr(psij, alg=alg))
        close(tt.norm(psip, alg=alg), tnqs.norm(psij, alg=alg))
    close(tt.norm_sqr(bp), tnqs.norm_sqr(bj))
    close(tt.norm_sqr(bp, alg="loopcorrections", max_configuration_size=6),
          tnqs.norm_sqr(bj, alg="loopcorrections", max_configuration_size=6))
    phij = tnqs.random_tensornetworkstate(bj.graph, psij.siteinds(), bond_dimension=2, dtype=np.complex128,
                                          rng=np.random.default_rng(4))
    phip = tt.random_tensornetworkstate(bp.graph, psip.siteinds(), bond_dimension=2, dtype=np.complex128,
                                        rng=np.random.default_rng(4), device=CPU)
    for alg in ("exact", "bp"):
        close(tt.inner(psip, phip, alg=alg), tnqs.inner(psij, phij, alg=alg))
    # the loop series rescales vertices, which a form's cache cannot do, in both packages
    for pkg, a, b in ((tnqs, psij, phij), (tt, psip, phip)):
        with pytest.raises(TypeError):
            pkg.inner(a, b, alg="loopcorrections", max_configuration_size=4)
    nj, np_ = tnqs.normalize(psij), tt.normalize(psip)
    assert abs(tt.norm_sqr(np_, alg="bp") - 1) < 1e-10
    close(tt.norm_sqr(np_, alg="exact"), tnqs.norm_sqr(nj, alg="exact"))
    with pytest.raises(ValueError):
        tt.normalize(psip, alg="exact")


def test_rdms_and_entropies_equal(evolved):
    g, bj, bp = evolved
    for verts in ([(2, 2)], [(1, 1), (1, 2)], [(1, 1), (2, 2)]):
        for alg in ("bp", "exact"):
            rj = tnqs.rdm(bj if alg == "bp" else bj.network, verts, alg=alg)
            rp = tt.rdm(bp if alg == "bp" else bp.network, verts, alg=alg)
            mp = tt.rdm_matrix(rp)
            assert isinstance(mp, np.ndarray)
            close(mp, tnqs.rdm_matrix(rj))
            close(tt.renyi_entropy(rp, alpha=2), tnqs.renyi_entropy(rj, alpha=2))
        close(tt.von_neumann_entanglement_entropy(bp.network, verts, alg="exact"),
              tnqs.von_neumann_entanglement_entropy(bj.network, verts, alg="exact"))
    for e in g.edges()[:4]:
        close(tt.von_neumann_entanglement_entropy(bp, e), tnqs.von_neumann_entanglement_entropy(bj, e))
        close(tt.second_renyi_entanglement_entropy(bp, e), tnqs.second_renyi_entanglement_entropy(bj, e))
    close(tt.renyi_entropy(bp.network, g.edges()[0], alpha=3), tnqs.renyi_entropy(bj.network, g.edges()[0], alpha=3))
    rho = np.diag([0.5, 0.3, 0.2])
    assert tt.renyi_entropy(torch.tensor(rho), alpha=1) == tnqs.renyi_entropy(rho, alpha=1)


def test_contract_network_equal():
    g = tnqs.named_grid((3, 3))
    zj = tnqs.ising_partitionfunction(g, 0.3)
    zp = tt.ising_partitionfunction(graph(g), 0.3, device=CPU)
    for alg, kw in (("exact", {}), ("exact", {"sequence_alg": "treewidth"}), ("bp", {}),
                    ("boundarymps", {"mps_bond_dimension": 8})):
        close(tt.contract_network(zp, alg=alg, **kw), tnqs.contract_network(zj, alg=alg, **kw))
    assert tt.contract is tt.contract_network


@pytest.fixture(scope="module")
def bmps_states():
    """A 3x3 state at bond dimension 2 after a layer at maxdim 2 (every
    boundary exact at rank 16), in both packages."""
    g = GRAPHS["grid3x3"]()
    psij, psip, _ = pair_states(g, 2, np.complex128, 23)
    ak = dict(maxdim=2, cutoff=1e-12)
    sj, _ = tnqs.apply_gates(layer(g, 0.5, 0.9), psij, apply_kwargs=ak)
    sp, _ = tt.apply_gates(layer(g, 0.5, 0.9), psip, apply_kwargs=ak)
    return g, sj, sp


def test_bmps_equal_at_an_exact_rank(bmps_states):
    g, sj, sp = bmps_states
    r = 16
    for obs in ([("Z", [(2, 2)]), ("XX", [(2, 1), (2, 2)]), ("Z", [(2, 3)])],
                [("ZZ", [(1, 2), (2, 2)]), ("X", [(3, 2)])]):
        zj = tnqs.expect(sj, obs, alg="boundarymps", mps_bond_dimension=r)
        zp = tt.expect(sp, obs, alg="boundarymps", mps_bond_dimension=r)
        close(zp, zj)
        close(zp, tt.expect(sp, obs, alg="exact"), 1e-8)
    close(tt.norm_sqr(sp, alg="boundarymps", mps_bond_dimension=r),
          tnqs.norm_sqr(sj, alg="boundarymps", mps_bond_dimension=r))
    close(tt.inner(sp, sp, alg="boundarymps", mps_bond_dimension=r),
          tnqs.inner(sj, sj, alg="boundarymps", mps_bond_dimension=r))
    for verts in ([(2, 1), (2, 2)], [(1, 3), (2, 3)]):
        rj = tnqs.rdm(sj, verts, alg="boundarymps", mps_bond_dimension=r)
        rp = tt.rdm(sp, verts, alg="boundarymps", mps_bond_dimension=r)
        close(tt.rdm_matrix(rp), tnqs.rdm_matrix(rj))
    # a cache reused: messages up to date after one update, zip-up on a scalar network
    cp = tt.BoundaryMPSCache(sp, r).update()
    cj = tnqs.BoundaryMPSCache(sj, r).update()
    close(cp.partitionfunction(), cj.partitionfunction())
    close(tt.expect(cp, [("Z", [(1, 1)])]), tnqs.expect(cj, [("Z", [(1, 1)])]))
    assert cp.quotient_vertices() == cj.quotient_vertices() and cp.sorted_edges_map == cj.sorted_edges_map
    with pytest.raises(ValueError):
        tt.BoundaryMPSCache(tt.random_tensornetworkstate(tt.named_grid((2, 2, 2)), device=CPU), 4)


def test_generic_apply_equal():
    rng = np.random.default_rng(2)
    n, d, chi = 4, 2, 3
    links_j = [tnqs.Index(chi) for _ in range(n - 1)]
    links_p = [tt.Index(chi) for _ in range(n - 1)]
    out_j, out_p = [tnqs.Index(d) for _ in range(n)], [tt.Index(d) for _ in range(n)]
    mpo_j, mpo_p = [], []
    for k in range(n):
        ij = ([links_j[k - 1]] if k else []) + [out_j[k]] + ([links_j[k]] if k < n - 1 else [])
        ip = ([links_p[k - 1]] if k else []) + [out_p[k]] + ([links_p[k]] if k < n - 1 else [])
        data = rng.standard_normal([i.dim for i in ij]) + 1j * rng.standard_normal([i.dim for i in ij])
        mpo_j.append(tnqs.Tensor(data, ij))
        mpo_p.append(tt.Tensor(data, ip, device=CPU))
    for maxdim, cutoff in ((None, 0.0), (2, 1e-12)):
        oj = tnqs.generic_apply(mpo_j, {}, [[o] for o in out_j], cutoff=cutoff, maxdim=maxdim)
        op_ = tt.generic_apply(mpo_p, {}, [[o] for o in out_p], cutoff=cutoff, maxdim=maxdim)
        assert [t.inds[0].dim if t.ndim else 0 for t in op_] == [t.inds[0].dim if t.ndim else 0 for t in oj]
        close(tt.core.tensor.contract(op_).to_numpy(), np.asarray(tnqs.core.tensor.contract(oj).data))


def test_loop_corrections_match_golden():
    """`tests/test_golden.py`'s loop-correction gate on the port."""
    gold = json.loads(GOLDEN.read_text())
    rng = np.random.default_rng(gold["config"]["seed"])
    for g, name in [(tt.named_hexagonal_lattice_graph(2, 2), "hexagonal"), (tt.named_grid((4, 4)), "square")]:
        entry = gold["lattices"][name]
        psi = tt.random_tensornetworkstate(g, bond_dimension=gold["config"]["chi"], rng=rng, dtype=np.float64,
                                           device=CPU)
        psi = tt.normalize(psi, alg="bp")
        bp = complex(tt.norm_sqr(psi, alg="bp"))
        loop = complex(tt.norm_sqr(psi, alg="loopcorrections", max_configuration_size=entry["max_configuration_size"]))
        exact = complex(tt.norm_sqr(psi, alg="exact"))
        assert abs(bp - complex(*entry["norm_bp"])) < 1e-5
        assert abs(loop - complex(*entry["norm_loop_corrected"])) < 1e-5
        assert abs(exact - complex(*entry["norm_exact"])) < 1e-5
        assert abs(loop - exact) < abs(bp - exact)


def _same_samples(rj, rp, keys=("poverq", "logq")):
    assert len(rj) == len(rp)
    for a, b in zip(rj, rp):
        assert a["bitstring"] == b["bitstring"]
        for k in keys:
            if k in a:
                assert abs(a[k] - b[k]) <= TOL * max(1.0, abs(a[k])), (k, a[k], b[k])


def test_samplers_give_the_same_bits(bmps_states):
    g, sj, sp = bmps_states
    rank = dict(norm_mps_bond_dimension=16, projected_mps_bond_dimension=16)
    for seed in (0, 1):
        rj = tnqs.sample_directly_certified(sj, 3, rng=np.random.default_rng(seed), **rank)
        rp = tt.sample_directly_certified(sp, 3, rng=np.random.default_rng(seed), **rank)
        _same_samples(rj, rp)
    cert = tt.certify_samples(sp, rp, certification_mps_bond_dimension=16)
    close([c["poverq"] for c in cert], [c["poverq"] for c in tnqs.certify_samples(
        sj, rj, certification_mps_bond_dimension=16)])
    rj = tnqs.sample_certified(sj, 2, certification_mps_bond_dimension=16, rng=np.random.default_rng(5), **rank)
    rp = tt.sample_certified(sp, 2, certification_mps_bond_dimension=16, rng=np.random.default_rng(5), **rank)
    _same_samples(rj, rp, keys=("poverq",))
    bj = tnqs.sample(sj, 3, alg="boundarymps", rng=np.random.default_rng(7), **rank)
    assert tt.sample(sp, 3, alg="boundarymps", rng=np.random.default_rng(7), **rank) == bj
    small = GRAPHS["ring6"]()
    qj, qp, _ = pair_states(small, 2, np.complex128, 3)
    assert tt.sample(qp, 2, alg="bp", rng=np.random.default_rng(9)) == tnqs.sample(qj, 2, alg="bp",
                                                                                  rng=np.random.default_rng(9))
    with pytest.raises(ValueError):
        tt.sample_directly_certified(sp, 1, alg="bp")
