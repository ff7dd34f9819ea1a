"""K3's bf16_3x mode on the tensor cores (`bp_bra_tc`, `bp_pass2_tc` and the
split pass `bp_split_planes` of `tnqs_torch/csrc/bp_sweep.cu`), on the CPU.

The kernels build and run only on the card (`chip_smoke.py` holds them to
the plain version there).  Here: the split planes bit for bit against a
rounding written on the float32 bits, ties and subnormals included, and
against JAX's split; the launch plan of every shape `tc_route` admits; a
model of the kernels' TMA boxes and tiles (the 5-dimensional maps, their
coordinates, zero fill past chi, the MN-major tiles when t is the last
slot) against `_bp_sweep_group_plain`; and the engine's split planes, made
once a BP run and refused once T has changed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.ops import bp_sweep

torch.set_num_threads(1)

SPECIAL = np.array([1.0, 1 + 2.0**-8, 1 + 3 * 2.0**-9, -(1 + 2.0**-8), 1 + 2.0**-8 + 2.0**-20, 2.0**-126,
                    1.5 * 2.0**-130, 1e-40, -3e-41, 2.0**-149, 3 * 2.0**-149, 0.0, -0.0, 3.0e38, -1.7e38,
                    3.1415927, 1 + 2.0**-16 + 2.0**-24, -2.5e-39], dtype=np.float32)


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """bf16 bits of finite float32 `x`, rounded to nearest even on the bits."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _bits_split(x: np.ndarray):
    hi = _rne_bf16(x)
    hi_f = (hi.astype(np.uint32) << 16).view(np.float32)
    return hi, _rne_bf16(x - hi_f)  # x - hi is exact in float32 (numpy keeps subnormals)


def _special_bucket():
    rng = np.random.default_rng(7)
    x = np.empty((3, 2, 8, 8), dtype=np.complex64)
    x.real = rng.choice(SPECIAL, size=x.shape)
    x.imag = rng.choice(SPECIAL, size=x.shape)
    return x


def test_split_planes_are_the_split_bit_for_bit():
    x = _special_bucket()
    planes = bp_sweep._split_planes_plain(torch.as_tensor(x))
    assert planes.dtype == torch.bfloat16 and planes.shape == (4,) + x.shape
    bits = planes.view(torch.int16).numpy().view(np.uint16)
    (rh, rl), (ih, il) = _bits_split(x.real), _bits_split(x.imag)
    for got, want in zip(bits, (rh, ih, rl, il)):
        np.testing.assert_array_equal(got, want)
    # `_split`'s hi and lo, the plain version's operands, are these planes
    (hr, lr), (hi_, li) = bp_sweep._split(torch.as_tensor(x.real)), bp_sweep._split(torch.as_tensor(x.imag))
    assert all(torch.equal(p.float(), q) for p, q in zip(planes, (hr, hi_, lr, li)))
    # JAX's split (`tnqs/ops/bp_sweep.py:154-157`) gives the same values; its
    # CPU subtraction flushes subnormal inputs, so a lo of -3e-41 is +0 there
    # and -0 here: equal as values
    for part, (h, lo) in ((x.real, (hr, lr)), (x.imag, (hi_, li))):
        a = jnp.asarray(part)
        ah = a.astype(jnp.bfloat16)
        al = (a - ah.astype(jnp.float32)).astype(jnp.bfloat16)
        assert np.array_equal(np.asarray(ah, dtype=np.float32), h.numpy())
        assert np.array_equal(np.asarray(al, dtype=np.float32), lo.numpy())


def test_split_is_refused_once_t_changes():
    rng = np.random.default_rng(1)
    Tk = torch.as_tensor(_rand_c(rng, (4, 2, 8, 8, 8)))
    Min = torch.as_tensor(_rand_c(rng, (3, 2, 8, 8)))
    rows = torch.as_tensor([2, 0, 3])
    sp = bp_sweep.split_bucket(Tk)
    assert sp.of(Tk) and sp.planes is None  # on the CPU the plain version splits T itself
    m = bp_sweep.bp_sweep_group(Tk, Min, rows, 1, "bf16_3x", split=sp)
    assert torch.equal(m, bp_sweep.bp_sweep_group(Tk, Min, rows, 1, "bf16_3x"))
    with pytest.raises(ValueError):  # another tensor, equal values
        bp_sweep.bp_sweep_group(Tk.clone(), Min, rows, 1, "bf16_3x", split=sp)
    Tk[0, 0, 0, 0, 0] += 1.0  # an in-place write
    assert not sp.of(Tk)
    with pytest.raises(ValueError):
        bp_sweep.bp_sweep_group(Tk, Min, rows, 1, "bf16_3x", split=sp)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _tc_shapes():
    return [(k, chi) for k in (2, 3) for chi in range(8, 72, 8)
            if bp_sweep.supports_group(k, chi, torch.complex64) and bp_sweep.tc_route(k, chi)]


def test_tc_route_is_one_rule():
    admitted = [(k, chi) for k in range(2, 9) for chi in range(8, 520, 8)
                if bp_sweep.supports_group(k, chi, torch.complex64)]
    tc = {(k, chi) for k, chi in admitted if bp_sweep.tc_route(k, chi)}
    assert tc == {(k, chi) for k, chi in admitted if k <= 3 and chi <= 64}
    # the paths' shapes: the Eagle chi=64 groups and the thermal path's k = 3, chi = 32
    assert {(2, 64), (3, 64), (3, 32)} <= tc
    # the rest keeps the mma.sync kernels: degree 4-6 at chi 8 and 16, degree 2 past 64
    assert {(k, chi) for k, chi in admitted if (k, chi) not in tc} == (
        {(4, 8), (5, 8), (6, 8), (4, 16)} | {(2, chi) for chi in range(72, 520, 8)})


SHAPES = [(k, chi, B, t, d) for k, chi in _tc_shapes() for B in (1, 7, 36) for t in range(k) for d in (2, 4)]


@pytest.mark.parametrize("k, chi, B, t, d", SHAPES, ids=[f"k{k}-chi{c}-B{B}-t{t}-d{d}" for k, c, B, t, d in SHAPES])
def test_tc_launch_plan(k, chi, B, t, d):
    plan = bp_sweep.bp_plan(k, chi, B, t, d, 264, 264, tc=True)
    # pass 1 (k = 3): one unit a value of the slot that is neither u nor the
    # last, every unit of every (message, s) in exactly one CTA
    if k == 3:
        assert plan.mode_blocks == chi and 1 <= plan.mode_per_cta <= chi
        ctas = -(-chi // plan.mode_per_cta)
        units = [i for c in range(ctas) for i in range(c * plan.mode_per_cta, min(chi, (c + 1) * plan.mode_per_cta))]
        assert units == list(range(chi))
    # pass 2: every item (s, o) of a message in exactly one chunk, in order
    O = chi ** (k - 2)
    assert plan.items == d * O
    assert [it for c in range(plan.chunks) for it in plan.pass2_items(c)] == [(s, o) for s in range(d)
                                                                             for o in range(O)]
    # scratch: V's bf16 planes (8 bytes a value, the size of complex64),
    # then the partials
    assert plan.v_elems == (B * d * chi**k if k == 3 else 0)
    assert plan.part_elems == (B * plan.chunks * chi * chi if plan.chunks > 1 else 0)
    # one of t and v is the last slot: one 64-wide index of each tile is contiguous
    assert k - 1 in (t, plan.v) and (plan.u is None) == (k == 2)


def test_tc_plan_of_the_largest_eagle_group():
    plan = bp_sweep.bp_plan(3, 64, 36, 0, 2, 264, 264, tc=True)
    # V of all 36 messages (151 MB) written by one pass-1 launch; 36 x 22
    # chunks = 792 pass-2 CTAs, 3 waves of 264
    assert (plan.per_cta, plan.chunks) == (6, 22) and plan.v_elems * 8 == 36 * 2 * 64**3 * 8
    assert (plan.u, plan.v, plan.mode_blocks) == (1, 2, 64) and 36 * 2 * -(-64 // plan.mode_per_cta) >= 264


def test_tc_shared_memory_and_launch_args(monkeypatch):
    # a message tile and two ring tiles of 32 KB, aligned to 1024, and four
    # mbarriers: two CTAs share an SM (232,448 bytes a CTA at most, 1 KB
    # reserved each)
    assert bp_sweep.SMEM_TC == 1024 + 3 * 32768 + 32 and 2 * (bp_sweep.SMEM_TC + 1024) <= 233472
    monkeypatch.setattr(bp_sweep, "_slots_tc", lambda device_index: (264, 264))
    for k, chi, t in ((2, 64, 0), (2, 64, 1), (3, 64, 0), (3, 32, 2), (3, 24, 1)):
        elems, args = bp_sweep._launch_args_tc.__wrapped__(k, chi, 36, t, 2, 0)
        plan = bp_sweep.bp_plan(k, chi, 36, t, 2, 264, 264, tc=True)
        assert list(args) == [36, k, chi, 2, t, -1 if plan.u is None else plan.u, plan.v, plan.mode_per_cta,
                              plan.per_cta, plan.chunks, 0, plan.v_elems]
        assert elems == plan.v_elems + plan.part_elems


# ---------------------------------------------------------------------------
# a model of the kernels' tiles
# ---------------------------------------------------------------------------

def _box(planes5, box, c):
    """TMA's tile load: the box `box` (innermost first) of the 5-dimensional
    map at coordinates `c`, zero past the tensor's edge, as [4][64][64]
    (the two 64-wide dimensions, the outer first)."""
    out = np.zeros(tuple(reversed(box)))
    src = planes5
    sl_src, sl_dst = [], []
    for dim in reversed(range(5)):
        n = src.shape[4 - dim]
        lo, hi = c[dim], min(c[dim] + box[dim], n)
        sl_src.append(slice(lo, hi))
        sl_dst.append(slice(0, max(hi - lo, 0)))
    out[tuple(sl_dst)] = src[tuple(sl_src)]
    return out.reshape(4, 64, 64)


def _map5(planes, k, chi, rows_d):
    """The kernels' map of planes [4][rows_d][chi^k]: numpy axes (plane, row,
    dim 2, dim 1, dim 0), slot j at dimension k - 1 - j (k = 2: a unit
    dimension 2)."""
    return planes.reshape((4, rows_d) + ((chi,) * 3 if k == 3 else (1, chi, chi)))


def _box_dims(da, db):
    box = [1, 1, 1, 1, 4]
    box[da] = box[db] = 64
    return box


def _split64(x):
    """(hi, lo) of float64 values rounded to float32, as float64."""
    hi, lo = bp_sweep._split(torch.as_tensor(x, dtype=torch.float32))
    return hi.double().numpy(), lo.double().numpy()


def _mm3(x, y):
    """x @ y by the three products of split operands (x, y: (hi, lo))."""
    return x[1] @ y[0] + x[0] @ y[1] + x[0] @ y[0]


def _msg_tile(M, chi):
    """put_message: M's split planes, row r column c = M[r, c], zero past chi."""
    tile = np.zeros((4, 64, 64))
    (rh, rl), (ih, il) = _split64(M.real), _split64(M.imag)
    for p, x in enumerate((rh, ih, rl, il)):
        tile[p, :chi, :chi] = x
    return tile


def _tc_model(Tk, Min, rows, t):
    """The tensor-core kernels' messages, tile by tile (float64 sums of
    exact split products, float32 where the kernels round: V and W before
    their split)."""
    n_k, d, chi, k = Tk.shape[0], Tk.shape[1], Tk.shape[-1], Tk.dim() - 2
    B = len(rows)
    u, v = bp_sweep.split_slots(k, t)
    planes = bp_sweep._split_planes_plain(Tk).float().double().numpy().reshape(4, n_k * d, -1)
    K5 = _map5(planes, k, chi, n_k * d)
    Mn = Min.numpy().astype(np.complex128)
    if k == 3:  # pass 1: V's planes [4][B d][chi^3]
        V = np.zeros((4, B * d, chi**3))
        V5 = _map5(V, k, chi, B * d)  # a view: the stores land in V
        for b in range(B):
            A = _msg_tile(Mn[b, u if u < t else u - 1], chi)
            ar, ai = (A[0], A[2]), (A[1], A[3])
            for s in range(d):
                for i in range(chi):
                    c = [0, 0, 0, int(rows[b]) * d + s, 0]
                    c[1 + u] = i
                    tile = _box(K5, _box_dims(2 - u, 0), c)  # [p][n]: B MN-major
                    kr, ki = (tile[0], tile[2]), (tile[1], tile[3])
                    cr = (_mm3(ar, kr) + _mm3(ai, ki)).astype(np.float32)
                    ci = (_mm3(ar, ki) - _mm3(ai, kr)).astype(np.float32)
                    (crh, crl), (cih, cil) = _split64(cr), _split64(ci)
                    c[3] = b * d + s
                    # the store: the part of the box inside V ([x][n] at slot u and the last)
                    idx = [slice(None)] * 5
                    idx[4 - (2 - u)], idx[4 - 0] = slice(0, chi), slice(0, chi)
                    idx[4 - (1 + u)], idx[4 - 3] = i, c[3]
                    for p, x in enumerate((crh, cih, crl, cil)):
                        V5[(p,) + tuple(idx[1:])] = x[:chi, :chi]
        Vmap = _map5(V, k, chi, B * d)
    P = np.zeros((B, chi, chi), dtype=np.complex128)
    t_inner = t == k - 1
    dother = t + v - 1 if k == 3 else 2
    box = _box_dims(k - 1 - t, k - 1 - v)
    for b in range(B):
        Mt = _msg_tile(Mn[b, v if v < t else v - 1], chi)  # [y][q]: B MN-major
        mr, mi = (Mt[0], Mt[2]), (Mt[1], Mt[3])
        for s in range(d):
            for o in range(chi if k == 3 else 1):
                c = [0, 0, 0, int(rows[b]) * d + s, 0]
                c[dother] = o
                Kt = _box(K5, box, c)
                if t_inner:  # [y][i]: A MN-major
                    Kt = Kt.transpose(0, 2, 1)
                kr, ki = (Kt[0], Kt[2]), (Kt[1], Kt[3])
                wr = (_mm3(kr, mr) - _mm3(ki, mi)).astype(np.float32)
                wi = (_mm3(kr, mi) + _mm3(ki, mr)).astype(np.float32)
                wr, wi = _split64(wr), _split64(wi)
                if k == 3:
                    c[3] = b * d + s
                    Vt = _box(Vmap, box, c)
                else:
                    Vt = _box(K5, box, c)
                if not t_inner:  # [j][q]: B K-major, B[q][j] = V[j][q]
                    Vt = Vt.transpose(0, 2, 1)
                vr, vi = (Vt[0], Vt[2]), (Vt[1], Vt[3])
                pr = _mm3(wr, vr) + _mm3(wi, vi)
                pi = _mm3(wi, vr) - _mm3(wr, vi)
                P[b] += (pr + 1j * pi)[:chi, :chi]
    return P


MODEL = [(k, chi, t) for k, chi in ((2, 8), (2, 24), (3, 8), (3, 24)) for t in range(k)]


@pytest.mark.parametrize("k, chi, t", MODEL, ids=[f"k{k}-chi{chi}-t{t}" for k, chi, t in MODEL])
def test_tile_model_matches_the_plain_version(k, chi, t):
    rng = np.random.default_rng(100 * k + chi + t)
    Tk = torch.as_tensor(_rand_c(rng, (4, 2) + (chi,) * k))
    Min = torch.as_tensor(_rand_c(rng, (3, k - 1, chi, chi)))
    rows = torch.as_tensor([3, 0, 2])  # gathered, out of order
    m_model = _tc_model(Tk, Min, rows, t)
    m_plain = bp_sweep._bp_sweep_group_plain(Tk, Min, rows, t, "bf16_3x").numpy()
    # the same split points and exact split products: the sums' order and
    # float32 against float64 accumulation only (a V or W entry that rounds
    # to another bf16 hi moves its lo by one bf16 ulp of hi)
    assert np.max(np.abs(m_model - m_plain)) < 1e-5 * np.max(np.abs(m_plain))


# ---------------------------------------------------------------------------
# the engine's split planes
# ---------------------------------------------------------------------------

def test_engine_splits_once_a_run_and_remakes_them_after_a_gate(monkeypatch):
    import tnqs_torch.engine as engine_mod

    made = []

    def spy(Tk):
        sp = bp_sweep.split_bucket(Tk)
        made.append(sp)
        return sp

    monkeypatch.setattr(engine_mod, "split_bucket", spy)
    g = tt.heavy_hexagonal_lattice(2, 2)
    eng = LatticeEngine(g, 8, device="cpu", bp_kernel="kernel", bp_schedule="color", bp_precision="high")
    eng.evolve(tt.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4), cutoff=1e-12, bp_maxiter=2)  # entangled
    made.clear()
    eng.bp_update(maxiter=3, tolerance=0.0)
    first = list(made)
    # one split a bucket the tensor-core route takes, for the whole run of 3 iterations
    assert eng.bp_iterations == 3
    assert sorted(sp.source.dim() - 2 for sp in first) == sorted(
        k for k in eng.T if bp_sweep.supports_group(k, 8, torch.complex64))
    assert all(sp.of(eng.T[sp.source.dim() - 2]) for sp in first)
    eng.evolve([("Rx", [v], 0.7) for v in g.vertices()], cutoff=1e-12, bp_maxiter=2)  # a gate on every site
    stale = [sp for sp in first if not sp.of(eng.T[sp.source.dim() - 2])]
    assert stale == first  # T changed: every earlier split is stale
    made.clear()
    eng.bp_update(maxiter=3)
    assert made and all(sp.of(eng.T[sp.source.dim() - 2]) for sp in made)  # remade from the T of this run
    k = first[0].source.dim() - 2
    group = next(gr for gr in eng._bp_groups if gr[1] == k)
    with pytest.raises(ValueError):
        bp_sweep.bp_sweep_group(eng.T[k], eng.M[group[7]], group[6], group[2], "bf16_3x", split=first[0])
    # no split under "highest"
    made.clear()
    eng.bp_precision = None
    eng.bp_update(maxiter=2)
    assert not made
