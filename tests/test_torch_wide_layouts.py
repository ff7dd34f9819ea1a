"""The layouts of the Jacobi kernels past n = 128, modelled on the CPU.

K2's wide variant (`jacobi_eigh_wide_kernel` in
`tnqs_torch/csrc/jacobi_eigh.cu`, 128 < n <= 256) spreads H and V over a
cluster: CTA k owns a range of pair positions and holds the whole columns
at them, the rotations are broadcast to every CTA, and the columns that
leave a CTA's positions move into the neighbour's spare slot of a ring.
`_jacobi_wide_model` replays that over C virtual CTAs, slot for slot, and
is held against the plain version (which `tests/test_torch_ops.py` and
`tests/test_torch_wide_kernels.py` hold against the JAX kernel) at small n,
where the same closed forms apply.  K1 past n = 128 keeps its layout on a
cluster of up to 16 (`osj.osj_plan`); its plan is checked for every width
of the new range.  The kernels themselves run on the card in
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tnqs_torch.ops import jacobi, osj

torch.set_num_threads(1)


def _rand_c(rng, shape):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))


class _Lanes:
    """The kernel's `Lanes`: pair positions by CTA and the two rings of
    column slots of each CTA (left lane moving up, right lane moving down,
    CTA 0's position 0 fixed)."""

    def __init__(self, m, C):
        self.m, self.C, self.pmax = m, C, -(-m // C)

    def first(self, k):
        return k * self.m // self.C

    def pairs(self, k):
        return (k + 1) * self.m // self.C - k * self.m // self.C

    def left(self, k, t, r):
        return (t - r) % (self.pairs(k) - (k == 0) + 1)

    def right(self, k, t, r):
        return self.pmax + 1 + (t - r) % (self.pairs(k) + 1)

    def fixed(self):
        return 2 * self.pmax + 2

    def pair_left(self, k, j, r):
        return self.fixed() if k == 0 and j == 0 else self.left(k, j - (k == 0), r)

    def pair_right(self, k, j, r):
        return self.right(k, self.pairs(k) - 1 - j, r)


def _jacobi_wide_model(H, sweeps, C, relative=True):
    """K2's wide variant over C virtual CTAs.  H [B, n, n]; returns (w [B, n]
    unsorted, V [B, n, n]) as the kernel writes them, by index."""
    B, n, _ = H.shape
    m = n // 2
    lanes = _Lanes(m, C)
    nslots = 2 * lanes.pmax + 3
    # per CTA: column slots of H and of V, [B, nslots, n] (slot, row)
    Hs = [torch.zeros((B, nslots, n), dtype=H.dtype) for _ in range(C)]
    Vs = [torch.zeros((B, nslots, n), dtype=H.dtype) for _ in range(C)]
    eye = torch.eye(n, dtype=H.dtype)
    for k in range(C):
        for j in range(lanes.pairs(k)):
            for slot, col in ((lanes.pair_left(k, j, 0), lanes.first(k) + j),
                              (lanes.pair_right(k, j, 0), m + lanes.first(k) + j)):
                Hs[k][:, slot] = H[:, :, col]
                Vs[k][:, slot] = eye[:, col]
    rounds = sweeps * (n - 1)
    for r in range(rounds):
        rr = r % (n - 1)
        pos = [jacobi.index_at(j, rr, n) for j in range(n)]
        # A: each CTA's pairs' rotations from its own columns, into every CTA
        rot = [None] * m
        slots = {}
        for k in range(C):
            for j in range(lanes.pairs(k)):
                i = lanes.first(k) + j
                sl, sr = lanes.pair_left(k, j, r), lanes.pair_right(k, j, r)
                slots[k, j] = (sl, sr)
                p, q = pos[i], pos[m + i]
                g = Hs[k][:, sr, p]
                rot[i] = jacobi._rot_params(Hs[k][:, sl, p].real[:, None], Hs[k][:, sr, q].real[:, None],
                                            g.real[:, None], g.imag[:, None], jacobi.EPS32, relative)
        c = torch.cat([x[0] for x in rot], 1)  # [B, m]
        s = torch.cat([x[1] for x in rot], 1)
        live = torch.cat([x[2] for x in rot], 1)
        # B, C: the vote, then each CTA's blocks (all row pairs x its column
        # pairs), rows first, then columns, and its V columns
        if live.any():
            P_, Q_ = pos[:m], pos[m:]
            ci, si = c[:, :, None], s[:, :, None]
            for k in range(C):
                for j in range(lanes.pairs(k)):
                    sl, sr = slots[k, j]
                    i = lanes.first(k) + j
                    cj, sj = c[:, i, None], s[:, i, None]
                    L, R = Hs[k][:, sl].clone(), Hs[k][:, sr].clone()
                    h0, h1, h2, h3 = L[:, P_], R[:, P_], L[:, Q_], R[:, Q_]
                    h0, h2 = ci[..., 0] * h0 + si[..., 0].conj() * h2, -si[..., 0] * h0 + ci[..., 0] * h2
                    h1, h3 = ci[..., 0] * h1 + si[..., 0].conj() * h3, -si[..., 0] * h1 + ci[..., 0] * h3
                    h0, h1 = cj * h0 + sj * h1, -sj.conj() * h0 + cj * h1
                    h2, h3 = cj * h2 + sj * h3, -sj.conj() * h2 + cj * h3
                    L[:, P_], R[:, P_], L[:, Q_], R[:, Q_] = h0, h1, h2, h3
                    Hs[k][:, sl], Hs[k][:, sr] = L, R
                    x, y = Vs[k][:, sl].clone(), Vs[k][:, sr].clone()
                    Vs[k][:, sl], Vs[k][:, sr] = cj * x + sj * y, -sj.conj() * x + cj * y
        # D: every CTA's two leaving columns into their receivers' spare slots
        moves = []
        for k in range(C):
            P = lanes.pairs(k)
            src_l, src_r = lanes.left(k, P - (k == 0) - 1, r), lanes.right(k, P - 1, r)
            to_l, dst_l = (k + 1, lanes.left(k + 1, 0, r + 1)) if k < C - 1 else (k, lanes.right(k, 0, r + 1))
            to_r, dst_r = (k - 1, lanes.right(k - 1, 0, r + 1)) if k > 0 else (0, lanes.left(0, 0, r + 1))
            moves += [(k, src_l, to_l, dst_l), (k, src_r, to_r, dst_r)]
        sent = [(Hs[k][:, src].clone(), Vs[k][:, src].clone(), to, dst) for k, src, to, dst in moves]
        for h, v, to, dst in sent:
            Hs[to][:, dst], Vs[to][:, dst] = h, v
    w = torch.zeros((B, n), dtype=torch.float32)
    V = torch.zeros((B, n, n), dtype=H.dtype)
    rf = rounds % (n - 1)
    for k in range(C):
        for j in range(lanes.pairs(k)):
            for slot, x in ((lanes.pair_left(k, j, rounds), lanes.first(k) + j),
                            (lanes.pair_right(k, j, rounds), m + lanes.first(k) + j)):
                idx = jacobi.index_at(x, rf, n)
                V[:, :, idx] = Vs[k][:, slot]
                w[:, idx] = Hs[k][:, slot, idx].real
    return w, V


@pytest.mark.parametrize("n, C, sweeps, relative", [(12, 2, 3, True), (20, 4, 2, True), (20, 4, 2, False),
                                                    (40, 8, 1, True)])
def test_jacobi_wide_model_matches_plain(n, C, sweeps, relative):
    """The same rotations on the same columns: the model's H is not mirrored
    (as the kernel's is not), so it differs from the plain version's by
    rounding only.  Uneven pair ranges (n = 20: 2, 3, 2, 3 pairs; n = 40 on
    8 CTAs) and both skips are covered."""
    rng = np.random.default_rng(n + C)
    X = _rand_c(rng, (2, n, n))
    H = (0.5 * (X + X.mH)).contiguous()
    w_k, V_k = _jacobi_wide_model(H, sweeps, C, relative)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, sweeps, relative)
    assert torch.allclose(w_k, w_p, atol=2e-5 * w_p.abs().max().item())
    assert torch.allclose(V_k, V_p, atol=1e-4)


def test_jacobi_wide_model_every_slot_holds_one_column():
    """Over two sweeps at n = 20 on 4 CTAs, every position's column is in
    exactly one slot of its owner, and no two columns share a slot."""
    n, C = 20, 4
    m = n // 2
    lanes = _Lanes(m, C)
    for r in range(2 * (n - 1) + 1):
        for k in range(C):
            P = lanes.pairs(k)
            used = [lanes.pair_left(k, j, r) for j in range(P)] + [lanes.pair_right(k, j, r) for j in range(P)]
            assert len(set(used)) == 2 * P
            spare_l, spare_r = lanes.left(k, 0, r + 1), lanes.right(k, 0, r + 1)
            assert spare_l not in used and spare_r not in used  # the arrivals' slots are free
            assert max(used + [spare_l, spare_r]) < 2 * lanes.pmax + 3


@pytest.mark.parametrize("n", list(range(130, 257, 2)))
def test_eigh_wide_plan_fits(n):
    C, pairs, smem = jacobi.eigh_wide_plan(n)
    assert C in jacobi.WIDE_CLUSTERS and sum(pairs) == n // 2 and min(pairs) >= 2
    assert max(pairs) - min(pairs) <= 1 and smem <= jacobi.SMEM_LIMIT
    assert C == 4 if n <= 232 else C == 8  # the smaller cluster wherever its CTAs fit


@pytest.mark.parametrize("n", [128, 258, 131, 512])
def test_eigh_wide_plan_refuses_other_widths(n):
    with pytest.raises(ValueError, match="even 128 < n <= 256"):
        jacobi.eigh_wide_plan(n)


# the saturated chi = 96 and chi = 128 thetas [R, n], and the widest R each width takes
WIDE_THETAS = [(384, 192, 8), (192, 192, 4), (512, 256, 16), (256, 256, 8), (800, 192, 16), (260, 130, 4),
               (400, 200, 8), (200, 200, 8)]


@pytest.mark.parametrize("R, n, C", WIDE_THETAS)
def test_osj_plan_past_128_fits_and_covers(R, n, C):
    """Past n = 128 K1 takes the one smallest cluster whose CTAs fit (16 is
    non-portable); every row of A and V has a CTA, the Gram partials of every
    chunk have room, and the wrapper's choice is that cluster whatever the
    batch, unless the card holds none of it."""
    assert osj.osj_fits(R, n) == [C]
    cpc, vpc, smem = osj.osj_plan(R, n, C)
    assert smem <= osj.SMEM_LIMIT and C * cpc * osj.CHUNK >= R and C * vpc * osj.CHUNK >= n
    smaller = [C2 for C2 in osj.CLUSTERS if C2 < C]
    assert all(osj.osj_plan(R, n, C2)[2] > osj.SMEM_LIMIT for C2 in smaller)
    for B in (1, 26, 500):
        assert osj.osj_cluster(B, R, n, lambda C2, smem: 7) == C
    with pytest.raises(RuntimeError, match="no cluster"):
        osj.osj_cluster(1, R, n, lambda C2, smem: 0)


@pytest.mark.parametrize("n", list(range(130, 257, 14)) + [256])
def test_osj_plan_past_128_square_and_twice_tall(n):
    """Every width of the range takes every theta from square to 2n rows,
    the tallest at d = 2 (a degree-3 site: 2 chi x d rows on a 2 chi-wide
    bond), as does every even width from 64 to 128."""
    for w in (n, n - 66):
        for R in range(w, 2 * w + 1):
            C = osj.osj_fits(R, w)[-1]
            assert osj.osj_plan(R, w, C)[2] <= osj.SMEM_LIMIT and osj.pjsvd_fits(R, w)


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
    """Every cluster size, 16 and those that leave CTAs without a chunk of A
    (160 rows: 5 chunks on 4 CTAs hold 2, 2, 1, 0; on 8 and 16 most hold
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
    assert torch.allclose(outs[16][0], A_p, atol=2e-6) and torch.allclose(outs[16][1], V_p, atol=2e-5)
