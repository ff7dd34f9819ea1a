"""The flex tier's BP caches, forms, gauging and simple update in tnqs_torch
against the JAX package's, on the CPU: random states from one seed on 3x3
and 4x4 grids, a ring, a comb and a periodic 2x2 hexagonal lattice at
bond dimension <= 4.  BP messages, iteration counts, `apply_gates`'s
truncation errors, messages and expectation values agree to 1e-10 at
complex128 and 1e-5 at complex64; the Eagle golden's first 3 layers run on
the port alone (no JAX) within 1e-5 of `golden_eagle127.json`."""

import json
import pathlib

import numpy as np
import pytest
import torch

import tnqs
import tnqs_torch as tt
from torch_flex_cases import CPU, GRAPHS, IndexMap, graph, layer, pair_states, tol

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "golden_eagle127.json"


def _spectra_close(bj, bp, atol):
    """Messages after factorizations, compared through their spectra over
    their traces: the two packages' SVDs may fix a bond's basis with other
    phases, which turns a message by a unitary and, through the sum of its
    elements that normalizes it, rescales it."""
    worst = 0.0
    for e in bj.graph.edges():
        for d in (e, (e[1], e[0])):
            mj, mp = bj.message(d), bp.message(d)
            wj = np.linalg.eigvalsh(np.asarray(mj.data).reshape(mj.inds[0].dim, -1))
            wp = np.linalg.eigvalsh(mp.to_numpy().reshape(mp.inds[0].dim, -1))
            worst = max(worst, float(np.abs(wj / wj.sum() - wp / wp.sum()).max()))
    assert worst <= atol, worst


def _messages_close(bj, bp, imap, atol):
    worst = 0.0
    for e in bj.graph.edges():
        for d in (e, (e[1], e[0])):
            mj, mp = bj.message(d), bp.message(d)
            imap.learn(mj, mp)
            worst = max(worst, imap.diff(mj, mp) / max(1.0, float(np.abs(mp.to_numpy()).max())))
    assert worst <= atol, worst


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_bp_messages_and_iterations_equal(name, dtype, capsys):
    psij, psip, imap = pair_states(GRAPHS[name](), 2 if name != "ring6" else 4, dtype, 3)
    kw = dict(maxiter=25, tolerance=tnqs.default_tolerance(dtype), verbose=True)
    bj = tnqs.BeliefPropagationCache(psij).update(**kw)
    said_j = capsys.readouterr().out
    bp = tt.BeliefPropagationCache(psip).update(**dict(kw, tolerance=tt.default_tolerance(dtype)))
    said_p = capsys.readouterr().out
    assert said_p == said_j and "converged" in said_p
    assert bp.edge_sequence == bj.edge_sequence
    _messages_close(bj, bp, imap, tol(dtype))
    assert abs(bp.freenergy() - bj.freenergy()) <= tol(dtype) * max(1.0, abs(bj.freenergy()))
    np.testing.assert_allclose(bp.vertex_scalars(), bj.vertex_scalars(), rtol=tol(dtype))
    np.testing.assert_allclose(bp.edge_scalars(), bj.edge_scalars(), rtol=tol(dtype))


def test_tree_bp_is_one_sweep():
    psij, psip, imap = pair_states(GRAPHS["comb3x3"](), 3, np.complex128, 8)
    assert tt.default_bp_update_kwargs(psip) == tnqs.default_bp_update_kwargs(psij) == dict(
        maxiter=1, tolerance=None, verbose=False)
    bj = tnqs.BeliefPropagationCache(psij).update(**tnqs.default_bp_update_kwargs(psij))
    bp = tt.BeliefPropagationCache(psip).update(**tt.default_bp_update_kwargs(psip))
    _messages_close(bj, bp, imap, 1e-10)
    z_bp = tt.norm_sqr(bp)
    assert abs(z_bp - tt.norm_sqr(psip, alg="exact")) <= 1e-10 * abs(z_bp)


def test_bp_helpers():
    for dt in (np.complex64, np.float32, torch.complex64, torch.float32):
        assert tt.default_tolerance(dt) == 1e-5
    for dt in (np.complex128, np.float64, torch.complex128, torch.float64):
        assert tt.default_tolerance(dt) == 1e-8
    assert tt.default_tolerance(torch.int32) is None
    psij, psip, imap = pair_states(tnqs.named_grid((2, 2)), 2, np.complex128, 1)
    e = psij.graph.edges()[0]
    mj = [tnqs.BeliefPropagationCache(psij).updated_message(d) for d in (e, (e[1], e[0]))]
    mp = [tt.BeliefPropagationCache(psip).updated_message(d) for d in (e, (e[1], e[0]))]
    assert abs(tt.message_diff(*mp) - tnqs.message_diff(*mj)) < 1e-12
    assert tt.message_diff(mp[0], mp[0]) < 1e-12
    hj, hp = tnqs.make_hermitian(mj[0]), tt.make_hermitian(mp[0])
    imap.learn(mj[0], mp[0])
    assert imap.diff(hj, hp) < 1e-14


@pytest.mark.parametrize("name", ["grid3x3", "hex2x2p", "ring6"])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_apply_gates_equal(name, dtype):
    g = GRAPHS[name]()
    psij, psip, imap = pair_states(g, 2, dtype, 5)
    ak = dict(maxdim=3, cutoff=1e-12)
    bj, ej = tnqs.apply_gates(layer(g), tnqs.BeliefPropagationCache(psij), apply_kwargs=ak)
    bp, ep = tt.apply_gates(layer(g), tt.BeliefPropagationCache(psip), apply_kwargs=ak)
    assert isinstance(ep, np.ndarray) and ep.shape == ej.shape
    np.testing.assert_allclose(ep, ej, atol=tol(dtype))
    _spectra_close(bj, bp, tol(dtype))
    for v in g.vertices()[:4]:
        assert abs(tt.expect(bp, ("Z", [v])) - tnqs.expect(bj, ("Z", [v]))) <= tol(dtype)
    # a state in, a state out (the cache built and updated inside)
    sj, ej2 = tnqs.apply_gates(layer(g)[: g.nv() + 2], psij, apply_kwargs=ak)
    sp, ep2 = tt.apply_gates(layer(g)[: g.nv() + 2], psip, apply_kwargs=ak)
    assert isinstance(sp, tt.TensorNetworkState)
    np.testing.assert_allclose(ep2, ej2, atol=tol(dtype))
    v = g.vertices()[0]
    assert abs(tt.expect(sp, ("X", [v]), alg="bp") - tnqs.expect(sj, ("X", [v]), alg="bp")) <= tol(dtype)


def test_apply_gate_rejects_bad_supports():
    g = tt.named_grid((3, 3))
    bpc = tt.BeliefPropagationCache(tt.zerostate(g, device=CPU))
    gate = tt.gates.op("CNOT", [bpc.network.siteinds((1, 1))[0], bpc.network.siteinds((3, 3))[0]], device=CPU)
    with pytest.raises(ValueError, match="non-adjacent"):
        tt.apply.apply_gate_(gate, bpc)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_gauging_equal(dtype):
    g = tnqs.named_grid((3, 3))
    psij, psip, imap = pair_states(g, 3, dtype, 6)
    bj0 = tnqs.BeliefPropagationCache(psij).update(maxiter=40)
    bp0 = tt.BeliefPropagationCache(psip).update(maxiter=40)
    # the bond messages after the gauge are the singular values (gauge invariant)
    cj, cp = tnqs.symmetric_gauge(bj0), tt.symmetric_gauge(bp0)
    for e in g.edges():
        np.testing.assert_allclose(np.diag(cp.message(e).to_numpy()), np.diag(np.asarray(cj.message(e).data)),
                                   atol=1e-10)
    sj, sp = tnqs.symmetrize_and_normalize(bj0), tt.symmetrize_and_normalize(bp0)
    assert abs(sp.partitionfunction() - sj.partitionfunction()) < 1e-10 * abs(sj.partitionfunction())
    for v in g.vertices()[:3]:
        assert abs(sp.vertex_scalar(v) - sj.vertex_scalar(v)) < 1e-10
        for o in ("Z", "X"):
            assert abs(tt.expect(sp, (o, [v])) - tnqs.expect(sj, (o, [v]))) <= 1e-10
    assert isinstance(tt.gauge_and_scale(psip, cache_update_kwargs={"maxiter": 5}), tt.TensorNetworkState)


@pytest.mark.parametrize("name", ["grid3x3", "hex2x2p"])
def test_rescale_and_partition_function_equal(name):
    psij, psip, imap = pair_states(GRAPHS[name](), 2, np.complex128, 2)
    bj = tnqs.BeliefPropagationCache(psij).update(maxiter=30, tolerance=1e-12)
    bp = tt.BeliefPropagationCache(psip).update(maxiter=30, tolerance=1e-12)
    assert abs(bp.partitionfunction() - bj.partitionfunction()) <= 1e-10 * abs(bj.partitionfunction())
    rj, rp = bj.rescale(), bp.rescale()
    np.testing.assert_allclose(rp.vertex_scalars(), 1.0, atol=1e-10)
    np.testing.assert_allclose(rp.vertex_scalars(), rj.vertex_scalars(), atol=1e-10)
    np.testing.assert_allclose(rp.edge_scalars(), rj.edge_scalars(), atol=1e-10)
    imap.learn_network(rj.network, rp.network)
    for v in psij.vertices():
        assert imap.diff(rj.network[v], rp.network[v]) <= 1e-10


@pytest.mark.parametrize("name", ["grid4x4", "hex2x2p"])
def test_loop_correlations_equal(name):
    psij, psip, _ = pair_states(GRAPHS[name](), 2, np.complex128, 7)
    lj = tnqs.loop_correlations(psij, 6)
    lp = tt.loop_correlations(psip, 6)
    assert len(lp) == len(lj) > 0
    np.testing.assert_allclose(lp, lj, atol=1e-10)


def test_forms_equal():
    g = tnqs.named_grid((3, 3))
    psij, psip, imap = pair_states(g, 2, np.complex128, 12)
    phij = tnqs.random_tensornetworkstate(g, bond_dimension=2, dtype=np.complex128, rng=np.random.default_rng(13))
    phip = tt.random_tensornetworkstate(graph(g), bond_dimension=2, dtype=np.complex128,
                                        rng=np.random.default_rng(13), device=CPU)
    kw = dict(maxiter=30, tolerance=1e-12)
    qj = tnqs.BeliefPropagationCache(tnqs.QuadraticForm(psij, lambda v: "Z" if v == (2, 2) else "I")).update(**kw)
    qp = tt.BeliefPropagationCache(tt.QuadraticForm(psip, lambda v: "Z" if v == (2, 2) else "I")).update(**kw)
    assert abs(qp.partitionfunction() - qj.partitionfunction()) <= 1e-10 * abs(qj.partitionfunction())
    # the bilinear form's BP does not settle on this pair: both run 30 sweeps
    bj = tnqs.BeliefPropagationCache(tnqs.BilinearForm(psij, phij)).update(maxiter=30)
    bp = tt.BeliefPropagationCache(tt.BilinearForm(psip, phip)).update(maxiter=30)
    assert abs(bp.partitionfunction() - bj.partitionfunction()) <= 1e-10 * abs(bj.partitionfunction())
    assert isinstance(bp.network.copy(), tt.BilinearForm) and bp.network.dtype() == torch.complex128


def test_eagle_golden_first_layers():
    """Three layers of `golden_eagle127.json`'s configuration on the port
    alone: each layer's fidelity and BP <Z>(7,8) within 1e-5."""
    gold = json.loads(GOLDEN.read_text())
    c = gold["config"]
    g = tt.eagle_lattice()
    psi = tt.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex128, device=CPU)
    bpc = tt.BeliefPropagationCache(psi)
    ak = dict(maxdim=c["maxdim"], cutoff=c["cutoff"], normalize_tensors=True)
    circuit = tt.heavy_hex_kicked_ising_layer(g, c["J"], c["theta_h"])
    for i in range(3):
        bpc, e = tt.apply_gates(circuit, bpc, apply_kwargs=ak)
        assert abs(float(np.prod(1.0 - e)) - gold["layer_fidelity"][i]) < 1e-5
        z = float(np.real(tt.expect(bpc, [("Z", [tuple(c["central"])])])[0]))
        assert abs(z - gold["z_central"][i]) < 1e-5
