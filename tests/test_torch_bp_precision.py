"""K3's second arithmetic mode, "bf16_3x", and the engine's `bp_precision`,
on the CPU.

In "bf16_3x" every real product is hi.hi + hi.lo + lo.hi of its operands'
bfloat16 split with float32 accumulation (`tnqs/ops/bp_sweep.py:154-166`).
The port's plain version splits at its kernel's points (the split-absorb
design: V = K x_u conj(M_u), W = K M_v ..., then W V^H), the JAX kernel at
its own (every absorb on the ket side, in the blocked-real embedding), so
the two are two bf16_3x evaluations that round at different places: each
lies within ~1.5e-5 of the largest entry of the full-precision message
(about 2^-16 of a product dropped a term, summed over d chi^(k-1) terms),
and they agree within 2.5e-5 of it (measured at most 1.38e-5 over degrees
2-6 and every slot at chi=8).  The CUDA kernel is held to this plain version
on the card (`chip_smoke.py`, phase 4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnqs
import tnqs.models
from tnqs.ops import bp_sweep as jax_bp

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.ops import bp_sweep

torch.set_num_threads(1)

CHI = 8
CASES = [(k, t) for k in range(2, 7) for t in range(k)]


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("k, t", CASES, ids=[f"k{k}-t{t}" for k, t in CASES])
def test_bf16_3x_plain_matches_jax_interpret(k, t):
    rng = np.random.default_rng(10 * k + t)
    Tk = _rand_c(rng, (4, 2) + (CHI,) * k)
    Min = _rand_c(rng, (3, k - 1, CHI, CHI))
    pos = np.array([1, 2, 3])
    planes = jax_bp.plane_layouts(jnp.asarray(Tk[pos].real), jnp.asarray(Tk[pos].imag), k, t)
    mr, mi = jax_bp.bp_sweep_group(*planes, jnp.asarray(Min.real), jnp.asarray(Min.imag), lo=0, k=k, interpret=True,
                                   mode="bf16_3x")
    m_jax = np.asarray(mr) + 1j * np.asarray(mi)
    args = (torch.as_tensor(Tk), torch.as_tensor(Min), torch.as_tensor(pos), t)
    calls = bp_sweep._bp_sweep_group_plain.calls
    m3 = bp_sweep.bp_sweep_group(*args, mode="bf16_3x").numpy()
    assert bp_sweep._bp_sweep_group_plain.calls == calls + 1
    m_full = bp_sweep.bp_sweep_group(*args).numpy()
    scale = np.max(np.abs(m_full))
    assert np.max(np.abs(m3 - m_jax)) < 2.5e-5 * scale
    assert np.max(np.abs(m3 - m_full)) < 1.5e-5 * scale
    assert np.max(np.abs(m3 - m_full)) > 1e-8 * scale  # the mode is in force


def test_split_is_exact_and_rounds_to_nearest_even():
    x = torch.tensor([1.0, 1 + 2.0**-8, 1 + 3 * 2.0**-9, -3.1415927, 1e-30, 0.0], dtype=torch.float32)
    hi, lo = bp_sweep._split(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float()) and torch.equal(lo, (x - hi).to(torch.bfloat16).float())
    assert hi[1] == 1.0 and hi[2] == 1 + 2.0**-7  # ties to even, both ways
    assert torch.all((x - hi - lo).abs() <= 2.0**-16 * x.abs())


def test_mode_is_checked_and_counted():
    rng = np.random.default_rng(0)
    Tk, Min = torch.as_tensor(_rand_c(rng, (2, 2, 8, 8))), torch.as_tensor(_rand_c(rng, (1, 1, 8, 8)))
    rows = torch.ones(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        bp_sweep.bp_sweep_group(Tk, Min, rows, 0, mode="high")
    before = dict(bp_sweep.bp_sweep_group.launches_by_mode)
    bp_sweep.bp_sweep_group(Tk, Min, rows, 0, mode="bf16_3x")  # the plain version: no launch
    assert bp_sweep.bp_sweep_group.launches_by_mode == before
    assert set(before) == {"highest", "bf16_3x"}


@pytest.mark.parametrize("k, chi, t", [(2, 64, 0), (2, 512, 1), (3, 64, 2), (3, 32, 0), (5, 8, 2)])
def test_launch_args_follow_the_mode_occupancy(monkeypatch, k, chi, t):
    # an H100 holds 2 CTAs of each FP32 pass an SM, the bf16_3x passes 3 and 1 here (made-up counts)
    monkeypatch.setattr(bp_sweep, "_slots", lambda device_index: (264, 264, 132))
    monkeypatch.setattr(bp_sweep, "_slots_3x", lambda device_index: (396, 132, 132))
    for mode, slots in (("highest", (264, 264 if chi <= 64 else 132)), ("bf16_3x", (396, 132))):
        elems, args = bp_sweep._launch_args.__wrapped__(k, chi, 5, t, 2, 0, mode)
        plan = bp_sweep.bp_plan(k, chi, 5, t, 2, *slots)
        assert list(args)[7:10] == [plan.mode_per_cta, plan.per_cta, plan.chunks] and elems == plan.scratch_elems
    # the bf16_3x tiles: hi and lo planes of 64 rows of 72 bf16; two CTAs of pass 2 fit an SM
    assert bp_sweep.SMEM_MODE_3X == 2 * 4 * 64 * 72 * 2 and bp_sweep.SMEM_PASS2_3X == 3 * 4 * 64 * 72 * 2
    assert 2 * (bp_sweep.SMEM_PASS2_3X + 1024) <= 233472


@pytest.mark.parametrize("precision", [None, "high"])
def test_engine_routes_bp_precision(monkeypatch, precision):
    """Under "high" every group the kernel route takes runs bf16_3x (here its
    plain version); the trajectory stays within the JAX contract of 1e-5 in
    <Z> of the full-precision one (`tnqs/engine.py:672-677`)."""
    g = tt.heavy_hexagonal_lattice(2, 2)
    layer = tt.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4)
    orig, modes, z = bp_sweep._bp_sweep_group_plain, [], {}

    def spy(Tk, Min, rows, t, mode="highest"):
        modes.append(mode)
        return orig(Tk, Min, rows, t, mode)

    spy.calls = 0  # the plain version counts its runs on the module's name
    monkeypatch.setattr(bp_sweep, "_bp_sweep_group_plain", spy)
    for prec in (None, precision):
        modes.clear()
        eng = LatticeEngine(g, 8, device="cpu", bp_kernel="kernel", bp_schedule="color", bp_precision=prec)
        eng.evolve(layer, num_layers=2, cutoff=1e-12, bp_maxiter=25)
        assert modes and set(modes) == {"bf16_3x" if prec == "high" else "highest"}
        zz = eng.expect_1site("Z")
        z[prec] = np.array([zz[v].real for v in g.vertices()])
    assert np.max(np.abs(z[precision] - z[None])) < 1e-5
    with pytest.raises(ValueError):
        LatticeEngine(g, 8, device="cpu", bp_precision="bf16")
