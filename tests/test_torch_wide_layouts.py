"""The layouts of the Jacobi kernels past n = 128, modelled on the CPU.

K2 past n = 128 runs the resident variant (`jacobi_eigh_res_kernel` in
`tnqs_torch/csrc/jacobi_eigh.cu`): CTA k of a cluster of 2, 4, 8 or 16 owns
a range of pair positions and holds the columns of H at them in two rings
of slots, every CTA forms every rotation from the entries the columns'
holders send it, and the columns that leave a CTA's positions move into a
spare slot of their next holder.  `test_torch_l2_resident._jacobi_res_model`
replays that over C virtual CTAs in a shuffled order; here it is held
against the plain version (which `tests/test_torch_ops.py` and
`tests/test_torch_wide_kernels.py` hold against the JAX kernel) at small n
on clusters of 2, 4 and 8, its ring slots are checked round by round, and
its plan is checked for every width of (128, 256].  K1 past n = 128 takes
its resident variant, A alone on a cluster of 2, 4, 8 or 16 CTAs and V from
the rotation log (`osj.osj_log_plan`; the round is modelled in
`tests/test_torch_wide_osj.py`); its plan is checked for every width of the
range.  The kernels themselves run on the card in
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tnqs_torch.ops import jacobi, osj

from test_torch_l2_resident import _jacobi_res_model, _res_lanes

torch.set_num_threads(1)


def _rand_c(rng, shape):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))


@pytest.mark.parametrize("n, C, sweeps, relative", [(12, 2, 3, True), (20, 4, 2, True), (20, 4, 2, False),
                                                    (40, 8, 1, True)])
def test_jacobi_res_model_at_small_widths(n, C, sweeps, relative):
    """The resident layout at small n in a shuffled CTA order: the same
    rotations on the same columns as the plain version, which it matches
    to rounding here (PyTorch's CPU kernels round the model's smaller
    products by another path).  Uneven pair ranges (n = 20: 2, 3, 2, 3
    pairs; n = 40 on 8 CTAs, 2 or 3) and both skips are covered."""
    rng = np.random.default_rng(n + C)
    X = _rand_c(rng, (2, n, n))
    H = (0.5 * (X + X.mH)).contiguous()
    w_k, V_k, _ = _jacobi_res_model(H, sweeps, C, relative, rng, slab=4)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, sweeps, relative)
    assert torch.allclose(w_k, w_p, atol=2e-5 * w_p.abs().max().item())
    assert torch.allclose(V_k, V_p, atol=1e-4)


def test_jacobi_res_model_every_slot_holds_one_column():
    """Over two sweeps at n = 20 on 4 CTAs, every position's column is in
    exactly one slot of its owner, no two columns share a slot, and the two
    columns that arrive for the next round land in slots no column of this
    round or the one before holds (the rings' two spare slots)."""
    n, C = 20, 4
    lanes = [_res_lanes(n // 2, C, k) for k in range(C)]
    for r in range(2 * (n - 1) + 1):
        for k in range(C):
            nslots, P, _, slot, _ = lanes[k]
            used = [slot(t, r) for t in range(2 * P)]
            assert len(set(used)) == 2 * P and max(used) < nslots
            arrivals = [dst for c in range(C) for _, (to, dst) in lanes[c][4](r) if to == k]
            assert len(arrivals) == 2 and not set(arrivals) & set(used)
            assert r == 0 or not set(arrivals) & {slot(t, r - 1) for t in range(2 * P)}


# clusters of each size an H100 holds at once for the resident variant at
# n = 192 and 256 (`jacobi.res_active_clusters`, one CTA an SM; `chip_smoke.py`)
H100_HELD = {16: 7, 8: 15, 4: 30, 2: 66}


@pytest.mark.parametrize("n", list(range(130, 257, 2)))
def test_eigh_res_plan_fits(n):
    """Every even width of (128, 256] takes the resident variant: a cluster
    size whose CTAs own at least two pairs each and fit their slots, the
    batch of 26 Grams on 4 CTAs in one wave as the H100 holds them; V's
    columns in the rings, up to n = 224, on 4 CTAs in one wave too, and
    past it V from the log."""
    plan = jacobi.eigh_log_plan(26, n, 8 * (n - 1), lambda layout, C: H100_HELD[C])
    pairs = [(k + 1) * (n // 2) // plan.cluster - k * (n // 2) // plan.cluster for k in range(plan.cluster)]
    assert plan.layout == "resident" and min(pairs) >= 2 and max(pairs) - min(pairs) <= 1
    assert (plan.cluster, plan.waves, plan.group, plan.chunk) == (4, 1, 26, 8 * (n - 1))
    assert plan.smem == jacobi.eigh_res_smem(n, 4) <= jacobi.SMEM_LIMIT
    if jacobi.v_route_of(n) == "ring":
        assert n <= 224 and jacobi.eigh_ring_plan(26, n, lambda C: H100_HELD[C]) == (
            4, 30, 1, jacobi.eigh_res_smem(n, 4, True))
    else:
        assert n > 224 and not any(jacobi.eigh_res_fits(n, C, True) for C in jacobi.RES_CLUSTERS)


@pytest.mark.parametrize("n", [128, 131, 257, 64])
def test_eigh_log_plan_refuses_other_widths(n):
    with pytest.raises(ValueError, match="even n > 128"):
        jacobi.eigh_log_plan(26, n, 8 * (n - 1), lambda layout, C: 7)


# the saturated chi = 96 and chi = 128 thetas [R, n], and the tallest R some widths take: the resident
# variant's cluster sizes that hold them
WIDE_THETAS = [(384, 192, [16, 8, 4]), (192, 192, [16, 8, 4, 2]), (512, 256, [16, 8]), (256, 256, [16, 8, 4]),
               (768, 192, [16, 8]), (260, 130, [16, 8, 4, 2]), (400, 200, [16, 8, 4]), (200, 200, [16, 8, 4, 2])]


def _res_chunks(R, n, C):
    """The chunks of A each CTA of K1's resident variant holds, [k nch / C,
    (k+1) nch / C), and its pairs, [k m / C, (k+1) m / C): every chunk and
    pair once, every CTA a pair at least, no CTA more chunks than
    `osj_res_sizes` gives it room for, within a CTA's shared memory."""
    nch, m = -(-R // osj.CHUNK), n // 2
    cpc, smem = osj.osj_res_sizes(R, n)[C]
    held = [range(k * nch // C, (k + 1) * nch // C) for k in range(C)]
    pairs = [range(k * m // C, (k + 1) * m // C) for k in range(C)]
    assert [ch for r in held for ch in r] == list(range(nch)) and max(map(len, held)) <= cpc == -(-nch // C)
    assert [i for r in pairs for i in r] == list(range(m)) and min(map(len, pairs)) >= 1
    assert smem == osj.osj_res_smem(n, cpc, C) <= osj.SMEM_LIMIT


def _k1_plan(B, R, n, held=H100_HELD):
    """K1's launch past n = 128 at 6 sweeps on a card holding `held`."""
    return osj.osj_log_plan(B, R, n, 6 * (n - 1), lambda layout, C, cpc: held[C] if layout == "resident" else 7)[0]


def _fewest_waves(B, sizes, held=H100_HELD):
    """The cluster `jacobi.resident_choice` takes: the fewest waves, the
    larger on a tie."""
    waves = {C: -(-B // held[C]) for C in sizes}
    return max(C for C in sizes if waves[C] == min(waves.values()))


@pytest.mark.parametrize("R, n, sizes", WIDE_THETAS)
def test_osj_plan_past_128_fits_and_covers(R, n, sizes):
    """Past n = 128 K1 takes its resident variant, A alone (V from the
    rotation log), on the cluster sizes of `jacobi.RES_CLUSTERS` whose CTAs
    hold their chunks of A; the sizes left out do not fit; the plan takes
    the size whose clusters take the batch in the fewest waves, the larger
    on a tie, and the L2 variant when the card holds none of them."""
    assert not osj._fitting_clusters(R, n) and osj.osj_l2(R, n) and osj.pjsvd_fits(R, n)
    assert list(osj.osj_res_sizes(R, n)) == sizes
    for C in sizes:
        _res_chunks(R, n, C)
    nch = -(-R // osj.CHUNK)
    assert all(osj.osj_res_smem(n, -(-nch // C), C) > osj.SMEM_LIMIT for C in jacobi.RES_CLUSTERS if C not in sizes)
    for B in (1, 26, 500):
        plan = _k1_plan(B, R, n)
        assert (plan.layout, plan.cluster) == ("resident", _fewest_waves(B, sizes))
        assert plan.waves == -(-B // H100_HELD[plan.cluster]) and plan.clusters == H100_HELD[plan.cluster]
    assert _k1_plan(26, R, n, dict.fromkeys(H100_HELD, 0)).layout == "l2"


@pytest.mark.parametrize("n", list(range(130, 257, 14)) + [256])
def test_osj_plan_past_128_square_and_twice_tall(n):
    """Every width of the range takes every theta from square to 2n rows,
    the tallest at d = 2 (a degree-3 site: 2 chi x d rows on a 2 chi-wide
    bond), on the resident variant with A alone, a batch of 26 on 8 CTAs
    at most; every even width from 64 to 128 on the cluster kernel, A and
    V."""
    for w in (n, n - 66):
        for R in range(w, 2 * w + 1):
            assert osj.pjsvd_fits(R, w)
            if w > osj.NARROW_N:
                plan = _k1_plan(26, R, w)
                assert plan.layout == "resident" and plan.cluster <= 8
                _res_chunks(R, w, plan.cluster)
            else:
                C = osj.osj_fits(R, w)[-1]
                assert osj.osj_plan(R, w, C)[2] <= osj.SMEM_LIMIT and not osj.osj_l2(R, w)


@pytest.mark.parametrize("n", list(range(130, 257, 2)))
def test_osj_res_plan_every_width(n):
    """Every even width of (128, 256], square and twice as tall: the
    resident variant's plan for a batch of 26 fits a CTA, covers every
    chunk of A and every pair, takes the cluster of fewest waves (one wave
    on 4 CTAs up to [432, 216], two on 8 past it) and logs the whole
    schedule of 6 sweeps in one launch."""
    for R in (n, 2 * n):
        plan = _k1_plan(26, R, n)
        sizes = list(osj.osj_res_sizes(R, n))
        _res_chunks(R, n, plan.cluster)
        assert plan.layout == "resident" and plan.cluster == _fewest_waves(26, sizes)
        assert (plan.cluster, plan.waves) == ((4, 1) if R <= 432 else (8, 2))
        assert (plan.group, plan.chunk, plan.scratch) == (26, 6 * (n - 1), 26 * 8 * n * 6 * (n - 1))
        assert plan.smem == osj.osj_res_sizes(R, n)[plan.cluster][1]


@pytest.mark.parametrize("B, R, n, want", [(26, 384, 192, (4, 1)), (18, 192, 192, (4, 1)), (26, 512, 256, (8, 2)),
                                           (18, 256, 256, (4, 1)), (26, 640, 320, (16, 4)), (4, 512, 512, (16, 1))])
def test_osj_res_plan_at_the_paths_shapes(B, R, n, want):
    """The chi = 96 and chi = 128 thetas, and past n = 256 the chi = 160
    and the thermal path's, on the H100's clusters: (cluster, waves), V
    beside the rounds on the SMs one wave leaves idle."""
    plan = _k1_plan(B, R, n)
    assert (plan.layout, plan.cluster, plan.waves) == ("resident", *want)
    assert (plan.waves == 1 and B * plan.cluster < 132) == (want[1] == 1)


def _osj_cluster_model(A, V, sweeps, C):
    """K1 over C virtual CTAs with `osj_plan`'s split at the CHUNK-row unit:
    each CTA forms the Gram partials of its own chunks of A and sends them
    to every CTA, every CTA sums all chunks in chunk order (so all take the
    same rotations), then rotates its own chunks of A and V.  CTAs past the
    last chunk hold nothing and only receive, as on [384, 192] with 8."""
    B, R, n = A.shape
    m = n // 2
    cpc, vpc, _ = osj.osj_plan(R, n, C)
    nch = -(-R // osj.CHUNK)
    rows_a = [range(c * cpc * osj.CHUNK, min(R, (c + 1) * cpc * osj.CHUNK)) for c in range(C)]
    rows_v = [range(c * vpc * osj.CHUNK, min(n, (c + 1) * vpc * osj.CHUNK)) for c in range(C)]
    assert sorted(r for rs in rows_a for r in rs) == list(range(R))  # every row once
    assert sorted(r for rs in rows_v for r in rs) == list(range(n))
    A, V = A.clone(), V.clone()
    for r in range(sweeps * (n - 1)):
        lft = [jacobi.index_at(i, r % (n - 1), n) for i in range(m)]
        rgt = [jacobi.index_at(m + i, r % (n - 1), n) for i in range(m)]
        part = [None] * nch  # [chunk] -> [B, m, 4], sent by the chunk's owner
        for c in range(C):
            for ch in range(c * cpc, min(nch, (c + 1) * cpc)):
                x = A[:, ch * osj.CHUNK:(ch + 1) * osj.CHUNK][:, :, lft]
                y = A[:, ch * osj.CHUNK:(ch + 1) * osj.CHUNK][:, :, rgt]
                part[ch] = torch.stack([(x.conj() * x).real.sum(1), (y.conj() * y).real.sum(1),
                                        (x.conj() * y).real.sum(1), (x.conj() * y).imag.sum(1)], -1)
        rots = []
        for c in range(C):  # every CTA sums every chunk in chunk order
            tot = part[0]
            for ch in range(1, nch):
                tot = tot + part[ch]
            rots.append(osj._rot_params_rel(tot[..., 0], tot[..., 1], tot[..., 2], tot[..., 3], jacobi.EPS32))
        assert all(torch.equal(rc[0], rots[0][0]) and torch.equal(rc[1], rots[0][1]) for rc in rots)
        for c in range(C):
            cc, s = rots[c][0][:, None, :], rots[c][1][:, None, :]
            for X, rows in ((A, rows_a[c]), (V, rows_v[c])):
                if len(rows):
                    rs = slice(rows.start, rows.stop)
                    x, y = X[:, rs][:, :, lft], X[:, rs][:, :, rgt]
                    X[:, rs, lft], X[:, rs, rgt] = cc * x + s * y, -s.conj() * x + cc * y
    return A, V


@pytest.mark.parametrize("R, n", [(160, 8), (96, 12)])
def test_osj_cluster_model_is_the_same_for_every_cluster(R, n):
    """Every cluster size, those that leave CTAs without a chunk of A
    included (160 rows: 5 chunks on 4 CTAs hold 2, 2, 1, 0; on 8 most hold
    none), gives bitwise the same result, and that result is the plain
    version's up to the order of the Gram sums."""
    rng = np.random.default_rng(R + n)
    A = _rand_c(rng, (2, R, n))
    A = A / torch.linalg.vector_norm(A, dim=(1, 2), keepdim=True)
    V = torch.eye(n, dtype=A.dtype).expand(2, n, n).contiguous()
    outs = {C: _osj_cluster_model(A, V, 2, C) for C in osj.CLUSTERS}
    for C in osj.CLUSTERS:
        assert torch.equal(outs[C][0], outs[1][0]) and torch.equal(outs[C][1], outs[1][1]), C
    A_p, V_p = osj._osj_svd_plain(A, V, 2)
    assert torch.allclose(outs[8][0], A_p, atol=2e-6) and torch.allclose(outs[8][1], V_p, atol=2e-5)
