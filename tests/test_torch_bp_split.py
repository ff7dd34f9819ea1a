"""The BP kernel's split formulation and launch plan, and the layer step's
BP routing, on the CPU.

`_bp_sweep_group_plain` (what the wrapper runs on a CPU tensor) computes the
kernel's algebra: the bra side V = K x_u conj(M_u), the ket side W = K with
every other message absorbed, the message sum W conj(V).  It is held
against the JAX Pallas kernel in interpret mode and against the einsum
chain `group_messages` at every degree 2-6 and every slot, on contiguous
and on gathered rows.  `bp_plan` is the CUDA kernel's launch plan: its
coverage of the (message, s, o) tiles, its chunk order, its scratch and its
shared memory are checked for every shape `supports_group` admits.  The
CUDA kernel itself is checked on the card by `chip_smoke.py`."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnqs
import tnqs.models
from tnqs.engine import LatticeEngine as JaxEngine
from tnqs.ops import bp_sweep as jax_bp

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.ops import bp_sweep

torch.set_num_threads(1)

CHI = 8
CASES = [(k, t, gathered) for k in range(2, 7) for t in range(k) for gathered in (False, True)]


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _tol(k, chi, d=2):
    """float32 sums of d chi^(k-1) products per entry in another order:
    ~sqrt(n) ulps of the largest entry, 1e-5 of it up to n = 1024 products
    (`tests/test_torch_bp.py:70-72`) and growing as sqrt(n) beyond."""
    return 1e-5 * max(1.0, math.sqrt(d * chi ** (k - 1) / 1024))


@pytest.mark.parametrize("k, t, gathered", CASES, ids=[f"k{k}-t{t}-{'gathered' if g else 'contiguous'}"
                                                       for k, t, g in CASES])
def test_split_formulation_matches_jax_and_einsum(k, t, gathered):
    rng = np.random.default_rng(10 * k + t)
    Tk = _rand_c(rng, (4, 2) + (CHI,) * k)
    Min = _rand_c(rng, (3, k - 1, CHI, CHI))
    pos = np.array([3, 0, 2]) if gathered else np.array([1, 2, 3])
    planes = jax_bp.plane_layouts(jnp.asarray(Tk[pos].real), jnp.asarray(Tk[pos].imag), k, t)
    mr, mi = jax_bp.bp_sweep_group(*planes, jnp.asarray(Min.real), jnp.asarray(Min.imag), lo=0, k=k, interpret=True)
    m_jax = np.asarray(mr) + 1j * np.asarray(mi)

    rows = torch.as_tensor(pos)
    calls = bp_sweep._bp_sweep_group_plain.calls
    m = bp_sweep.bp_sweep_group(torch.as_tensor(Tk), torch.as_tensor(Min), rows, t)
    assert bp_sweep._bp_sweep_group_plain.calls == calls + 1
    m_chain = bp_sweep.group_messages(torch.as_tensor(Tk)[rows], list(torch.as_tensor(Min).unbind(1)), t)
    scale = np.max(np.abs(m_jax))
    assert np.max(np.abs(m.numpy() - m_jax)) < _tol(k, CHI) * scale
    assert np.max(np.abs(m.numpy() - m_chain.numpy())) < _tol(k, CHI) * scale


@pytest.mark.parametrize("k", range(2, 7))
def test_split_slots(k):
    for t in range(k):
        u, v = bp_sweep.split_slots(k, t)
        assert v != t and k - 1 in (t, v)  # one index of the pass-2 tile is contiguous
        if k == 2:
            assert u is None
        else:
            assert u not in (t, v) and 0 <= u < k


def _admitted():
    return [(k, chi) for k in range(2, 9) for chi in range(8, 520, 8)
            if bp_sweep.supports_group(k, chi, torch.complex64)]


# the Eagle chi=64 color plan's groups, then every admitted shape at a few
# batch sizes; an H100 holds 2 x 132 CTAs of either pass
EAGLE = [(3, 64, 36, t) for t in range(3)] + [(2, 64, 18, t) for t in range(2)] + [(2, 64, 71, t) for t in range(2)]
SHAPES = EAGLE + [(k, chi, B, k - 1) for k, chi in _admitted() for B in (1, 5)]


@pytest.mark.parametrize("k, chi, B, t", SHAPES, ids=[f"k{k}-chi{chi}-B{B}-t{t}" for k, chi, B, t in SHAPES])
def test_launch_plan(k, chi, B, t):
    plan = bp_sweep.bp_plan(k, chi, B, t, 2, 264, 264)
    O = chi ** (k - 2)
    assert plan.items == 2 * O and plan.nblk == -(-chi // 64)
    # every (message, s, o) tile of every output block in exactly one chunk,
    # each chunk's items in order, the chunks summed in chunk order 0, 1, ...
    seen = [item for c in range(plan.chunks) for item in plan.pass2_items(c)]
    assert seen == [(s, o) for s in range(2) for o in range(O)]
    assert all(plan.pass2_items(c) for c in range(plan.chunks))
    assert plan.chunks == -(-plan.items // plan.per_cta)
    # pass 1 writes whole 64-column blocks
    if k >= 3:
        assert chi <= 64 and chi ** (k - 1) % 64 == 0 and plan.mode_blocks == chi ** (k - 1) // 64
        assert 1 <= plan.mode_per_cta <= plan.mode_blocks
    # scratch: V is the group's [B, d, chi^k] at k >= 3 and nothing at k = 2
    assert plan.v_elems == (B * 2 * chi**k if k >= 3 else 0)
    assert plan.pre == tuple(j for j in range(k) if j not in (t, plan.u, plan.v))
    assert plan.w_elems == B * 2 * chi**k * min(max(k - 3, 0), 2)
    assert plan.part_elems == (B * plan.chunks * chi * chi if plan.chunks > 1 else 0)
    # the shared memory a CTA of either pass asks for fits the H100's 227 KB
    assert bp_sweep.SMEM_MODE <= 232448 and bp_sweep.SMEM_PASS2 <= 232448
    assert 2 * (bp_sweep.SMEM_PASS2 + 1024) <= 233472  # two pass-2 CTAs share an SM


def test_launch_plan_fills_whole_waves():
    # the largest Eagle group: 36 messages x 22 chunks = 792 CTAs, 3 waves of
    # 264 with none idle; one item a CTA would take 17.5 waves
    plan = bp_sweep.bp_plan(3, 64, 36, 0, 2, 264, 264)
    assert (plan.per_cta, plan.chunks) == (6, 22) and 36 * plan.chunks == 3 * 264
    assert (plan.u, plan.v, plan.pre) == (1, 2, ())
    assert plan.v_elems * 8 == 36 * 2 * 64**3 * 8  # 151 MB


@pytest.fixture(scope="module")
def jax_layers():
    """Two production kicked-Ising layers of the JAX engine on
    heavy_hexagonal_lattice(2, 2) at chi=8 from "↑", the smallest bond the
    kernel takes, and the initial packed state."""
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    je = JaxEngine(psi, chi=CHI, dtype=jnp.complex64, factor_method="gram", bp_schedule="color")
    je.trunc_method = "svd"
    je.svd_impl = "pjsvd"
    T0, M0 = {k: np.asarray(v) for k, v in je.T.items()}, np.asarray(je.M)
    step = je.make_step(tnqs.models.heavy_hex_kicked_ising_layer(g, J=np.pi / 4, theta_h=0.4), cutoff=1e-12,
                        bp_maxiter=25)
    errors = []
    for _ in range(2):
        je.T, je.M, e = step(je.T, je.M)
        errors.append(np.asarray(e))
    return g, T0, M0, je.expect_1site("Z"), np.stack(errors)


@pytest.mark.parametrize("route", ["kernel", "einsum"])
def test_step_refreshes_follow_bp_kernel(jax_layers, route):
    g, T0, M0, z_jax, e_jax = jax_layers
    p = tt.NamedGraph.from_edges(g.vertices(), g.edges())
    pe = LatticeEngine.from_arrays(p, T0, M0, chi=CHI, device="cpu", bp_schedule="color", bp_kernel=route)
    layer = tt.heavy_hex_kicked_ising_layer(p, np.pi / 4, 0.4)
    step = pe.make_step(layer, cutoff=1e-12, bp_maxiter=25)
    calls = bp_sweep._bp_sweep_group_plain.calls
    errors = []
    for _ in range(2):
        pe.T, pe.M, e = step(pe.T, pe.M)
        errors.append(e.numpy())
        # the write-backs keep every bucket contiguous: the kernel reads it
        # in place, with no copy
        assert all(v.is_contiguous() for v in pe.T.values())
    ran = bp_sweep._bp_sweep_group_plain.calls - calls
    # "kernel": every refresh and the final run take the kernel's route (its
    # plain version on CPU tensors); "einsum": none do
    assert ran > 0 if route == "kernel" else ran == 0
    z_port = pe.expect_1site("Z")
    # the gate of tests/test_torch_engine.py::test_slice_matches_jax_production_engine
    assert max(abs(z_port[v] - z_jax[v]) for v in g.vertices()) < 1e-4
    errors = np.stack(errors)
    assert np.all(np.abs(errors - e_jax) <= 1e-4 * np.maximum(np.abs(e_jax), 1e-12))


@pytest.mark.parametrize("k, chi, t", [(2, 64, 0), (2, 512, 1), (3, 64, 2), (4, 16, 0), (5, 8, 2), (6, 8, 3)])
def test_launch_args_lay_out_the_scratch(monkeypatch, k, chi, t):
    # the card's CTA slots (pass 1, pass 2, wide pass 2) as an H100 gives them
    monkeypatch.setattr(bp_sweep, "_slots", lambda device_index: (264, 264, 132))
    elems, args = bp_sweep._launch_args.__wrapped__(k, chi, 5, t, 2, 0)
    plan = bp_sweep.bp_plan(k, chi, 5, t, 2, 264, 264 if chi <= 64 else 132)
    a = list(args)
    assert a[:10] == [5, k, chi, 2, t, -1 if plan.u is None else plan.u, plan.v, plan.mode_per_cta, plan.per_cta,
                      plan.chunks]
    # V, the two ket-absorb buffers and the partials, one after another
    buf = 5 * 2 * chi**k
    used = [(a[10], plan.v_elems), (a[11], buf if plan.pre else 0), (a[12], buf if len(plan.pre) > 1 else 0),
            (a[13], plan.part_elems)]
    assert a[10] == 0 and a[11] == plan.v_elems and a[12] == plan.v_elems + buf
    assert a[13] == plan.v_elems + plan.w_elems and elems == plan.scratch_elems == a[13] + plan.part_elems
    spans = sorted((start, start + size) for start, size in used if size)
    assert all(s1 <= s2 for (_, s1), (s2, _) in zip(spans, spans[1:])) and all(e <= elems for _, e in spans)
