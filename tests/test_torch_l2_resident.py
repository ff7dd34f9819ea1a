"""The resident variants of K1 and K2 past the cluster kernels, and the
rotation log that moves V out of their rounds, modelled on the CPU.

`_jacobi_res_model` replays the data flow of `jacobi_eigh_res_kernel`
(`tnqs_torch/csrc/jacobi_eigh.cu`): CTA k holds the columns of H at its
pair positions in two rings of slots with two spare slots each, every CTA
forms every rotation from the entries (H[x][x], coupling) that each column's
holder sends it, and the two columns that leave a CTA's positions go into a
spare slot of their next holder.  `_osj_res_model` replays
`osj_svd_res_kernel` (`tnqs_torch/csrc/osj_svd.cu`): CTA k holds its 32-row
chunks of A, sends its partial of every pair to the pair's owner, and the
owner sums the C partials in CTA order and sends the rotation to every CTA.
Each CTA is a generator that yields where the kernel waits or may be
overtaken, and the CTAs run in an order a seeded generator shuffles; every
hand-over asserts that it writes no buffer or slot still to be read.  Both
log their rotations, and V is the log applied by slabs of rows, in shuffled
order (`rotation_log._apply_rotation_log_plain`, the plain version of
`tnqs_torch/csrc/rotation_log.cu`).  K2's model is held to
`_jacobi_eigh_plain` bit for bit; K1's to the L2 variant's model
(`test_torch_l2_layouts._osj_l2_model`, the same partial sums in the same
order) bit for bit and, through it, to `_osj_svd_plain` within rounding.
Bit for bit holds at widths where the model's tensors and the plain
version's take the same path through PyTorch's CPU kernels, which round a
complex product by a vector or a scalar path depending on the shapes (at
n = 72 the two part by one rounding).  V's kernel is modelled too: its walk
of the log in stages of whole rounds or parts of one (`_v_by_stages`), and
its run beside the iterate, follow and rest CTAs against the iterate's
`started` and `progress` flags over a few SMs in shuffled orders
(`_follow_model`).  The plans are checked at the paths' shapes and past
`LOG_BUDGET`.  The kernels run on the card in `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tnqs_torch.ops import jacobi, osj, rotation_log

from test_torch_l2_layouts import _osj_l2_model, _rand_c
import torch_wide_cases  # noqa: F401  (numpy's BLAS on one thread in the process)

torch.set_num_threads(1)


def _run(ctas, ready, rng):
    """Step the CTA generators in a shuffled order: each yields the
    condition it waits on, and a CTA runs on once `ready(cond)` holds."""
    waiting = {k: next(g) for k, g in ctas.items()}
    while waiting:
        runnable = [k for k, cond in waiting.items() if ready(cond)]
        assert runnable, f"every CTA waits: {waiting}"
        k = runnable[rng.integers(len(runnable))]
        try:
            waiting[k] = next(ctas[k])
        except StopIteration:
            del waiting[k]


def _v_by_slabs(log, V0, n, slab, rng):
    """The log applied to V0 (the identity when None) slab by slab of rows,
    the slabs in shuffled order, as the V kernel's CTAs take them."""
    B = log.shape[0]
    V = torch.eye(n, dtype=torch.complex64).expand(B, n, n) if V0 is None else V0
    out = torch.empty((B, n, n), dtype=torch.complex64)
    for r0 in rng.permutation(range(0, n, slab)):
        out[:, r0:r0 + slab] = rotation_log._apply_rotation_log_plain(log, V[:, r0:r0 + slab])
    return out


def _res_lanes(m, C, k):
    """CTA k's slots in the resident K2 (`Ring` in jacobi_eigh.cu): the slot
    of its t-th column at round r (t < P: the left column of pair t, else the
    right one of pair t - P), the leaving columns' slots and their
    destinations (CTA, slot)."""
    pmax = -(-m // C)
    pairs = [(c + 1) * m // C - c * m // C for c in range(C)]
    P = pairs[k]
    left, right = P - (k == 0) + 2, P + 2
    up = pairs[k + 1] + 2 if k < C - 1 else right
    down = pairs[k - 1] + 2 if k > 0 else left
    fixed = 2 * pmax + 4

    def at(t, r, size):
        return (t - r % size) % size

    def slot(t, r):
        if t < P:
            return fixed if k == 0 and t == 0 else at(t - (k == 0), r, left)
        return pmax + 2 + at(2 * P - 1 - t, r, right)

    def leaving(r):
        src_l, src_r = at(P - (k == 0) - 1, r, left), pmax + 2 + at(P - 1, r, right)
        dst_l = (k + 1, at(0, r + 1, up)) if k < C - 1 else (k, pmax + 2 + at(0, r + 1, up))
        dst_r = (k - 1, pmax + 2 + at(0, r + 1, down)) if k > 0 else (0, at(0, r + 1, down))
        return (src_l, dst_l), (src_r, dst_r)

    return 2 * pmax + 5, P, k * m // C, slot, leaving


def _jacobi_res_model(H, sweeps, C, relative, rng, slab=16, v_ring=False):
    """K2's resident variant over C virtual CTAs in a shuffled order, in the
    plain version's arithmetic.  H [B, n, n]; returns (w [B, n] by index,
    V [B, n, n] from the log by slabs, the log).  With `v_ring` a slot holds
    V's column below H's (rows n..2n-1), which the column rotations and the
    hand-overs move with it, and V is read from the slots instead."""
    B, n, _ = H.shape
    m, rounds = n // 2, sweeps * (n - 1)
    Hc = H.mT.contiguous()  # Hc[b, x] = column x of H
    if v_ring:
        Hc = torch.cat([Hc, torch.eye(n, dtype=H.dtype).expand(B, n, n)], 2)  # column x of V = I below
    log = torch.zeros((B, rounds, m, 4))
    w = torch.full((B, n), float("nan"))
    V = torch.full((B, n, n), float("nan"), dtype=H.dtype)  # with v_ring, from the slots
    lanes = [_res_lanes(m, C, k) for k in range(C)]
    slots = [[None] * lanes[k][0] for k in range(C)]  # the column data, kept after it leaves
    holds = [[None] * lanes[k][0] for k in range(C)]  # the index a slot holds, None when free
    ent = torch.zeros((C, 2, B, n, 3))  # every CTA's entries by round parity
    got = np.zeros((C, 2, n), dtype=bool)  # entries sent, not yet read
    arrived = [dict() for _ in range(C)]  # round -> columns arrived for it
    synced, rotations = set(), {}
    at = {rr: np.array([jacobi.index_at(j, rr, n) for j in range(n)]) for rr in range(n - 1)}  # index at position
    at_t = {rr: (torch.as_tensor(a[:m]), torch.as_tensor(a[m:])) for rr, a in at.items()}
    nxt = np.array([jacobi.next_position(j, n) for j in range(n)])

    def positions(k):
        P, s0 = lanes[k][1], lanes[k][2]
        return np.concatenate([np.arange(s0, s0 + P), np.arange(m + s0, m + s0 + P)])

    def send_entries(k, X, xs, js, rr, par):
        """The entries of the CTA's columns X [B, 2P, n] (indices xs, at
        positions js in the round of step rr) into every CTA."""
        t = np.arange(len(xs))
        e = torch.zeros((B, len(xs), 3))
        e[:, :, 0] = X[:, t, xs].real
        right = js >= m
        g = X[:, t[right], at[rr][js[right] - m]]
        e[:, right, 1], e[:, right, 2] = g.real, g.imag
        assert not got[:, par, xs].any(), "an entry overwritten before it was read"
        ent[:, par, :, xs] = e
        got[:, par, xs] = True

    def cta(k):
        nslots, P, s0, slot, leaving = lanes[k]
        js = positions(k)
        for t, j in enumerate(js):  # round 0: position = index
            slots[k][slot(t, 0)], holds[k][slot(t, 0)] = Hc[:, j].clone(), int(j)
        synced.add(k)
        yield ("sync",)
        send_entries(k, torch.stack([slots[k][slot(t, 0)] for t in range(2 * P)], 1), js, js, 0, 0)
        rr = 0
        for r in range(rounds):
            par = r & 1
            yield ("round", k, r)
            assert got[k, par].all() and arrived[k].get(r, 0) == (2 if r else 0)
            e = ent[k, par].clone()
            got[k, par] = False  # read: free for round r+2
            P_, Q_ = at_t[rr]
            if r in rotations:  # every CTA reads the same entries, so forms the same rotations
                assert torch.equal(e, rotations[r][0])
            else:
                c, s, live = jacobi._rot_params(e[:, P_, 0], e[:, Q_, 0], e[:, Q_, 1], e[:, Q_, 2], jacobi.EPS32,
                                                relative)
                q = torch.stack([c, s.real, s.imag, rotation_log.meta(P_, Q_, live)], -1)
                rotations[r] = (e, c, s, live, q)
            _, c, s, live, q = rotations[r]
            own = slice(s0, s0 + P)
            log[:, r, own] = q[:, own]
            sl = [slot(t, r) for t in range(2 * P)]
            assert [holds[k][x] for x in sl] == at[rr][js].tolist()  # the closed-form slots hold these columns
            X = torch.stack([slots[k][x] for x in sl], 1)  # [B, 2P, n]: the CTA's columns
            if live.any():
                cc, sc = c[:, None, :], s[:, None, :]
                top, bot = X[:, :, P_], X[:, :, Q_]  # rows first (H's: P_, Q_ < n)
                X[:, :, P_], X[:, :, Q_] = cc * top + sc.conj() * bot, -sc * top + cc * bot
                cr, sr = c[:, own, None], s[:, own, None]  # then the CTA's column pairs
                lft, rgt = X[:, :P], X[:, P:]
                X = torch.cat([cr * lft + sr * rgt, -sr.conj() * lft + cr * rgt], 1)
                for t, x in enumerate(sl):
                    slots[k][x] = X[:, t]
            yield ("any",)
            if r + 1 == rounds:
                break
            for src, (to, dst) in leaving(r):  # D: the leaving columns into a spare slot
                x = holds[k][src]
                assert x is not None and holds[to][dst] is None, "a column sent into a slot still held"
                holds[k][src] = None  # its data stays until a later arrival overwrites it
                slots[to][dst], holds[to][dst] = slots[k][src], x
                arrived[to][r + 1] = arrived[to].get(r + 1, 0) + 1
            yield ("any",)  # another CTA may run between the columns and the entries
            # the entries for round r + 1, from the columns as they stand in
            # their slots now (a leaving one's slot is not written again yet)
            X = torch.stack([slots[k][x] for x in sl], 1)
            send_entries(k, X, at[rr][js], nxt[js], (rr + 1) % (n - 1), par ^ 1)
            rr = (rr + 1) % (n - 1)
        last = max(rounds - 1, 0)
        for t, j in enumerate(js):
            x = int(at[rr][j])
            w[:, x] = slots[k][slot(t, last)][:, x].real
            if v_ring:
                V[:, :, x] = slots[k][slot(t, last)][:, n:]

    def ready(cond):
        if cond[0] == "sync":
            return len(synced) == C
        if cond[0] == "round":
            k, r = cond[1], cond[2]
            return got[k, r & 1].all() and arrived[k].get(r, 0) == (2 if r else 0)
        return True

    _run({k: cta(k) for k in range(C)}, ready, rng)
    return w, V if v_ring else _v_by_slabs(log, None, n, slab, rng), log


def _osj_res_model(A, V0, sweeps, C, rng, slab=16):
    """K1's resident variant over C virtual CTAs in a shuffled order: CTA k's
    chunks of A, its partial of every pair (chunks in order) to the pair's
    owner, the owner's sum over the CTAs in order and its rotation to every
    CTA.  Returns (A, V from the log by slabs, the log)."""
    B, R, n = A.shape
    m, ck, rounds = n // 2, osj.CHUNK, sweeps * (n - 1)
    nch = -(-R // ck)
    X = torch.zeros((B, n, ck * nch), dtype=A.dtype)
    X[:, :, :R] = A.mT
    pmax = -(-m // C)
    first = [k * m // C for k in range(C + 1)]
    chunks = [range(k * nch // C, (k + 1) * nch // C) for k in range(C)]
    rows = [X[:, :, ck * ch.start:ck * ch.stop].clone() for ch in chunks]  # each CTA's chunks
    log = torch.zeros((B, rounds, m, 4))
    part = torch.zeros((C, 2, C, pmax, B, 4))  # the owner's buffers: [owner, parity, sender, its pair]
    part_got = np.zeros((C, 2, C, pmax), dtype=bool)
    rot = torch.zeros((C, 2, m, B, 3))
    rot_got = np.zeros((C, 2, m), dtype=bool)
    own_o = np.array([((i + 1) * C + m - 1) // m - 1 for i in range(m)])  # the owner, the kernel's closed form
    own_l = np.arange(m) - np.array(first)[own_o]
    assert (own_l >= 0).all() and (np.arange(m) < np.array(first)[own_o + 1]).all()
    live_of = {}

    def cta(k):
        s0, P = first[k], first[k + 1] - first[k]
        perm = jacobi.round_robin(n, "cpu").numpy()
        pos = np.arange(n)
        yield ("sync",)
        for r in range(rounds):
            par = r & 1
            P_, Q_ = pos[:m], pos[m:]
            # 1. the CTA's partial of every pair over its chunks in order, to the owners
            acc = torch.zeros((B, m, 4))
            if len(chunks[k]):
                xa = rows[k].reshape(B, n, len(chunks[k]), ck)
                x, y = xa[:, P_], xa[:, Q_]
                chunk = torch.stack([(x.real * x.real + x.imag * x.imag).sum(-1),
                                     (y.real * y.real + y.imag * y.imag).sum(-1),
                                     (x.real * y.real + x.imag * y.imag).sum(-1),
                                     (x.real * y.imag - x.imag * y.real).sum(-1)], -1)  # [B, m, chunks, 4]
                for ch in range(chunk.shape[2]):
                    acc = acc + chunk[:, :, ch]
            assert not part_got[own_o, par, k, own_l].any(), "a partial overwritten before it was read"
            part[own_o, par, k, own_l] = acc.transpose(0, 1)
            part_got[own_o, par, k, own_l] = True
            yield ("part", k, par)
            # 2. the owner: its pairs' sums over the CTAs in order, the rotations to every CTA
            total = torch.zeros((P, B, 4))
            for c in range(C):
                total = total + part[k, par, c, :P]
            total = total.transpose(0, 1)
            part_got[k, par] = False
            c_, s_, live = osj._rot_params_rel(total[..., 0], total[..., 1], total[..., 2], total[..., 3],
                                               jacobi.EPS32)
            q = torch.stack([c_, s_.real, s_.imag], -1)
            assert not rot_got[:, par, s0:s0 + P].any(), "a rotation overwritten before it was read"
            rot[:, par, s0:s0 + P] = q.transpose(0, 1)
            rot_got[:, par, s0:s0 + P] = True
            own = slice(s0, s0 + P)
            live_of[(r, k)] = live
            log[:, r, own] = torch.stack([c_, s_.real, s_.imag, rotation_log.meta(torch.as_tensor(P_[own]),
                                                                                  torch.as_tensor(Q_[own]), live)], -1)
            yield ("rot", k, par)
            # 3. every rotation; the CTA's chunks rotated
            qr = rot[k, par].transpose(0, 1).clone()
            rot_got[k, par] = False
            cc, sc = qr[:, None, :, 0], torch.complex(qr[:, None, :, 1], qr[:, None, :, 2])
            Xk = rows[k]
            lft, rgt = Xk[:, P_], Xk[:, Q_]
            Xk[:, P_], Xk[:, Q_] = cc[:, 0, :, None] * lft + sc[:, 0, :, None] * rgt, \
                -sc[:, 0, :, None].conj() * lft + cc[:, 0, :, None] * rgt
            pos = pos[perm]
            yield ("any",)

    def ready(cond):
        if cond[0] == "part":
            k = cond[1]
            return part_got[k, cond[2], :, :first[k + 1] - first[k]].all()
        if cond[0] == "rot":
            return rot_got[cond[1], cond[2]].all()
        return True

    _run({k: cta(k) for k in range(C)}, ready, rng)
    A_out = torch.cat(rows, 2)[:, :, :R].mT
    return A_out, _v_by_slabs(log, V0, n, slab, rng), log


def _hermitian(n, seed):
    X = _rand_c(np.random.default_rng(seed), (1, n, n))
    return (0.5 * (X + X.mH)).contiguous()


@pytest.mark.parametrize("n, C, relative, slab", [(258, 16, False, 43), (320, 8, True, 80), (130, 8, True, 13),
                                                 (192, 2, False, 48), (256, 4, True, 64)])
def test_jacobi_res_model_is_the_plain_version(n, C, relative, slab):
    """One sweep in a shuffled CTA order: the same rotations in every CTA,
    no slot or entry overwritten before it is read, and the same bits as the
    plain version, w from the held columns and V from the log by slabs
    (n = 258: 129 pairs, 8 or 9 a CTA, the absolute skip; 320 on 8 CTAs: 20
    a CTA, the relative one; past n = 128: 130 on 8 CTAs, 8 or 9 pairs a
    CTA, 192 on 2, 48 a CTA, and 256 on 4, the chi = 128 Grams' layout)."""
    H = _hermitian(n, n + C)
    w_k, V_k, _ = _jacobi_res_model(H, 1, C, relative, np.random.default_rng(C + slab))
    w_p, V_p = jacobi._jacobi_eigh_plain(H, 1, relative)
    assert torch.equal(w_k, w_p) and torch.equal(V_k, V_p)


@pytest.mark.parametrize("seed", [1, 2])
def test_jacobi_res_model_in_any_order(seed):
    """Two CTA orders, two sweeps (every index home again after each) at
    n = 80 on 16 CTAs (two or three pairs a CTA: the kernel takes n > 256,
    its data flow is the same): the same bits as the plain version."""
    H = _hermitian(80, seed)
    w_k, V_k, _ = _jacobi_res_model(H, 2, 16, seed != 2, np.random.default_rng(seed), slab=8)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, 2, seed != 2)
    assert torch.equal(w_k, w_p) and torch.equal(V_k, V_p)


@pytest.mark.parametrize("seed, n, C", [(3, 80, 2), (4, 80, 4), (5, 64, 8)])
def test_jacobi_res_model_small_clusters_in_any_order(seed, n, C):
    """The clusters of 2, 4 and 8 that K2 takes for 128 < n <= 256, at
    small n (20, 10 and 4 pairs a CTA), two sweeps in a shuffled CTA order
    with either skip: the same bits as the plain version."""
    H = _hermitian(n, seed)
    w_k, V_k, _ = _jacobi_res_model(H, 2, C, seed % 2 == 1, np.random.default_rng(seed), slab=8)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, 2, seed % 2 == 1)
    assert torch.equal(w_k, w_p) and torch.equal(V_k, V_p)


@pytest.mark.parametrize("n, C, sweeps, relative", [(192, 4, 1, False), (224, 4, 1, True), (130, 2, 1, True),
                                                    (64, 8, 2, False)])
def test_jacobi_res_model_v_ring_is_the_plain_version(n, C, sweeps, relative):
    """V's columns in the rings beside H's (the route K2 takes up to
    n = 224: `jacobi.v_route_of`), moved by the same hand-overs in a
    shuffled CTA order: the same bits as the plain version, w and V."""
    H = _hermitian(n, n + C)
    w_k, V_k, _ = _jacobi_res_model(H, sweeps, C, relative, np.random.default_rng(n), v_ring=True)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, sweeps, relative)
    assert torch.equal(w_k, w_p) and torch.equal(V_k, V_p)


def _warm_start(R, n, seed):
    """A of graded columns and its warm start as `pjsvd` hands it to K1:
    (A V0 prescaled, V0 a float64 eigenbasis of the Gram, the scale)."""
    rng = np.random.default_rng(seed)
    A = _rand_c(rng, (1, R, n)) * torch.as_tensor(np.geomspace(1.0, 1e-3, n).astype(np.float32))
    V0 = torch.linalg.eigh((A.mH @ A).to(torch.complex128))[1].flip(-1).to(torch.complex64)
    Ab, scale = osj.prescale(A @ V0)
    return Ab, V0, scale


@pytest.mark.parametrize("R, n, C, slab", [(320, 320, 16, 64), (512, 258, 8, 43)])
def test_osj_res_model_is_the_l2_model(R, n, C, slab):
    """One sweep in a shuffled CTA order: the owners' sums over the CTAs in
    order give the L2 variant's rotations bit for bit, so A, the log and V
    (from V0 by slabs) are the L2 model's; and, through it, the plain
    version's within rounding ([320, 320]: 10 chunks on 16 CTAs, six
    holding none; [512, 258] on 8 CTAs: two a CTA, 16 or 17 pairs)."""
    Ab, V0, scale = _warm_start(R, n, R + n + C)
    A_k, V_k, _ = _osj_res_model(Ab, V0, 1, C, np.random.default_rng(R + slab), slab)
    A_l, V_l = _osj_l2_model(Ab, V0, 1, C)
    assert torch.equal(A_k, A_l) and torch.equal(V_k, V_l)
    A_p, V_p = osj._osj_svd_plain(Ab, V0, 1)
    s_k = osj.svd_from_rounds(A_k, V_k, scale)[1]
    s_p = osj.svd_from_rounds(A_p, V_p, scale)[1]
    assert torch.allclose(s_k, s_p, rtol=0, atol=1e-6 * s_p[0, 0].item())


@pytest.mark.parametrize("n, rounds, slab", [(4, 3, 1), (40, 39, 16), (258, 20, 8)])
def test_rotation_log_by_slabs_is_the_plain_v(n, rounds, slab):
    """A log of random rotations (about half taken): V applied by slabs in
    shuffled order is the log applied to the whole V, bit for bit, and the
    plain Jacobi arithmetic on V's columns (every pair of a round at once,
    the identity where not taken) gives the same values."""
    rng = np.random.default_rng(n)
    m, B = n // 2, 2
    log = torch.zeros((B, rounds, m, 4))
    V0 = _rand_c(rng, (B, n, n))
    W = V0.clone()
    for r in range(rounds):
        pos = torch.as_tensor([jacobi.index_at(j, r % (n - 1), n) for j in range(n)])
        c = torch.as_tensor(rng.uniform(0.5, 1.0, (B, m)).astype(np.float32))
        s = torch.as_tensor(rng.normal(size=(B, m)).astype(np.float32)) * (1 - c * c).sqrt() * (1 + 0j)
        s = s.to(torch.complex64) * torch.as_tensor(np.exp(1j * rng.uniform(0, 6.3, (B, m))).astype(np.complex64))
        taken = torch.as_tensor(rng.random((B, m)) < 0.5)
        c, s = torch.where(taken, c, 1.0), torch.where(taken, s, 0)
        log[:, r] = torch.stack([c, s.real, s.imag, rotation_log.meta(pos[:m], pos[m:], taken)], -1)
        if taken.any():
            cr, sr = c[:, None, :], s[:, None, :]
            lft, rgt = W[:, :, pos[:m]], W[:, :, pos[m:]]
            W[:, :, pos[:m]], W[:, :, pos[m:]] = cr * lft + sr * rgt, -sr.conj() * lft + cr * rgt
    V = rotation_log._apply_rotation_log_plain(log, V0)
    assert torch.equal(_v_by_slabs(log, V0, n, slab, rng), V)
    assert torch.equal(V, W)
    assert rotation_log.apply_rotation_log(log, V0).equal(V)  # the wrapper on a CPU log: the plain version


def test_rotation_log_meta_round_trips():
    """The meta word holds p, q and taken in an int32's bits, as the kernels
    write it (p << 16 | q << 1 | taken), up to n = 65534."""
    p = torch.tensor([0, 1, 32766, 5])
    q = torch.tensor([32767, 2, 0, 7])
    t = torch.tensor([True, False, True, False])
    log = torch.zeros((4, 4))
    log[:, 3] = rotation_log.meta(p, q, t)
    p2, q2, t2 = rotation_log.unpack(log)
    assert p2.tolist() == p.tolist() and q2.tolist() == q.tolist() and t2.tolist() == t.tolist()


@pytest.mark.parametrize("n, want", [(4, (16, 512)), (512, (16, 4)), (320, (16, 6)), (2048, (8, 1)), (9684, (1, 1)),
                                     (9686, (1, 4842 / 4843)), (14528, (1, 3631 / 7264)), (28990, (1, 16 / 14495)),
                                     (192, ("regs", 3, 2)), (256, ("regs", 4, 2)), (512, ("regs", 8, 1)),
                                     (598, ("regs", 10, 1)), (1024, ("regs", 16, 1)), (1026, (16, 1))])
def test_rotation_log_plan(n, want):
    """V's kernel by width: the register layout up to n = 1024 (the paths'
    192, 256, 512 and K2's resident widths to 598: P = ceil(n/64) positions
    a lane, two rows a warp up to P = 4, one past it, 16 rows a CTA up to
    P = 8, 12 up to P = 12 and 7 past it, stages
    of whole rounds), the slab layout past it.  The slab layout's slab and
    stage (`slab_plan`, at any width): 16 rows a CTA where they fit, stages
    of about 16 KiB of log (K whole rounds, E = K n/2 entries); one row and
    one round at n = 9684; past it one row and the part of a round that
    fits, down to 16 entries at the widest, n = 28990."""
    vp = rotation_log.plan(n)
    assert vp.layout == ("regs" if n <= rotation_log.REG_N else "slab")
    if want[0] == "regs":
        assert (vp.layout, vp.P, vp.R) == want and vp.rows == (16 if vp.P <= 8 else 12 if vp.P <= 12 else 7) and vp.E == vp.K * (n // 2)
        assert vp.smem == rotation_log.reg_smem_bytes(vp.P, vp.K) <= jacobi.SMEM_LIMIT
        assert vp.K % vp.P == 0 or vp.P % vp.K == 0  # a stage's rounds known to the unrolled loop
        assert vp.K == {3: 6, 4: 8, 8: 8, 10: 5, 16: 4}[vp.P]
        return
    S, E, smem = rotation_log.slab_plan(n)
    assert (S, E / (n // 2)) == want and smem == 16 * 2 * E + 8 * S * n + 16 <= jacobi.SMEM_LIMIT
    assert smem == rotation_log.smem_bytes(n, S, E) and (E >= n // 2 or smem + 32 > jacobi.SMEM_LIMIT)
    if vp.layout == "slab":
        assert (vp.rows, vp.E, vp.smem) == (S, E, smem)
    with pytest.raises(ValueError):
        rotation_log.plan(28992)
    assert rotation_log.fits(28990) and not rotation_log.fits(28992)


def _v_by_stages(log, V0, E):
    """The kernel's walk of the log (`rotation_log_kernel`): stages of E
    entries of [rounds * m], each stage round by round, the part of a round
    it holds at a time.  Each part is applied as the plain version applies a
    round whose other entries are not taken, so a round split over stages
    is applied as one only if the parts cover it once, in order."""
    B, rounds, m, _ = log.shape
    flat = log.reshape(B, rounds * m, 4)
    V, seen, off = V0, [], 0  # off: the stage's first entry's place in its round, as the kernel keeps it
    for e0 in range(0, rounds * m, E):
        length, a, at = min(E, rounds * m - e0), 0, off
        while a < length:
            b = min(length, a + m - at)
            r, i = divmod(e0 + a, m)
            assert i == at  # the kernel's running place is the entry's
            part = log[:, r].clone()
            keep = torch.zeros(m, dtype=torch.bool)
            keep[i:i + b - a] = True
            p, q, taken = rotation_log.unpack(part)
            part[..., 3] = rotation_log.meta(p, q, taken & keep)
            assert torch.equal(flat[:, e0 + a:e0 + b], log[:, r, i:i + b - a])
            V = rotation_log._apply_rotation_log_plain(part[:, None], V)
            seen.extend(range(e0 + a, e0 + b))
            a, at = b, 0
        off = (off + length) % m
    assert seen == list(range(rounds * m))  # every entry once, in order
    return V


@pytest.mark.parametrize("E", [20, 60, 7 * 20 + 3, 16])
def test_rotation_log_stages_walk_the_log(E):
    """Stages of whole rounds (E = 20, 3 rounds of m = 20) and of parts of
    rounds (a part of one round, a stage across a round's end, 16 entries):
    the kernel's walk gives the plain V bit for bit."""
    rng = np.random.default_rng(E)
    n, rounds, B = 40, 9, 2
    m = n // 2
    log = torch.zeros((B, rounds, m, 4))
    for r in range(rounds):
        pos = torch.as_tensor([jacobi.index_at(j, r % (n - 1), n) for j in range(n)])
        th = torch.as_tensor(rng.uniform(0, 1.5, (B, m)).astype(np.float32))
        ph = torch.as_tensor(rng.uniform(0, 6.3, (B, m)).astype(np.float32))
        taken = torch.as_tensor(rng.random((B, m)) < 0.7)
        c, s = torch.where(taken, th.cos(), 1.0), torch.where(taken, th.sin(), 0.0)
        log[:, r] = torch.stack([c, s * ph.cos(), s * ph.sin(), rotation_log.meta(pos[:m], pos[m:], taken)], -1)
    V0 = _rand_c(rng, (B, n, n))
    assert torch.equal(_v_by_stages(log, V0, E), rotation_log._apply_rotation_log_plain(log, V0))


def test_resident_limits():
    """The resident K2 takes 128 < n <= 598 on 16 CTAs, <= 436 on 8, <= 320
    on 4 and <= 228 on 2 (V in the rings: up to `jacobi.RING_N` = 224 on 8
    and 4, <= 160 on 2); the resident K1 takes [512, 512] and [640, 320] on 16, not
    [1024, 512] or [544, 512] (two chunks of 512 columns a CTA)."""
    assert [n for n in range(130, 700, 2) if jacobi.eigh_res_fits(n, 16)][-1] == 598
    assert [n for n in range(130, 700, 2) if jacobi.eigh_res_fits(n, 8)][-1] == 436
    assert [n for n in range(130, 700, 2) if jacobi.eigh_res_fits(n, 4)][-1] == 320
    assert [n for n in range(130, 700, 2) if jacobi.eigh_res_fits(n, 2)][-1] == 228
    assert [[n for n in range(130, 700, 2) if jacobi.eigh_res_fits(n, C, True)][-1]
            for C in (8, 4, 2)] == [224, 224, 160]
    assert not jacobi.eigh_res_fits(128, 16) and not jacobi.eigh_res_fits(600, 16)
    assert not jacobi.eigh_res_fits(226, 8, True) and not jacobi.eigh_res_fits(258, 16, True)
    assert osj.osj_res_sizes(512, 512) == {16: (1, osj.osj_res_smem(512, 1, 16))}
    assert list(osj.osj_res_sizes(640, 320)) == [16] and osj.osj_res_sizes(640, 320)[16][0] == 2
    assert osj.osj_res_sizes(1024, 512) == {} and osj.osj_res_sizes(544, 512) == {}
    assert osj.osj_res_smem(512, 1, 16) <= osj.SMEM_LIMIT < osj.osj_res_smem(512, 2, 16)


@pytest.mark.parametrize("B, n, sweeps, held, want", [
    (4, 512, 8, {16: 7, 8: 14}, ("resident", 16, 1, 4)),      # the thermal path's Grams: H on 16 CTAs
    (26, 320, 12, {16: 8, 8: 16, 4: 0}, ("resident", 8, 2, 26)),    # fewer waves on 8 than on 16 (4)
    (26, 320, 12, {16: 13, 8: 13, 4: 0}, ("resident", 16, 2, 26)),  # a tie: the larger cluster
    (4, 512, 8, {16: 0, 8: 14}, ("l2", 8, 1, 4)),             # no cluster of 16, and H does not fit 8
    (2, 610, 8, {16: 7, 8: 14}, ("l2", 16, 1, 2)),            # past the resident width
    (26, 512, 8, {16: 7, 8: 14}, ("resident", 16, 4, 26)),    # [26, 1024, 512]'s Grams: the log fits
    (26, 1024, 12, {16: 7, 8: 14}, ("l2", 16, 6, 5)),         # its log past LOG_BUDGET: groups of 5
    (4, 512, 300, {16: 7, 8: 14}, ("l2", 16, 4, 1)),          # one matrix's log past it: L2, in chunks of rounds
    (1, 4096, 12, {16: 7, 8: 14}, ("l2", 16, 1, 1)),          # 1.5 GiB of log a matrix: chunks of 16384 rounds
    (26, 320, 12, {16: 7, 8: 15, 4: 30}, ("resident", 4, 1, 26)),   # one wave on 4, as the H100 holds them
    (26, 256, 8, {16: 7, 8: 15, 4: 30}, ("resident", 4, 1, 26)),    # the chi = 128 Grams: H on 4 CTAs, one wave
    (54, 256, 12, {16: 7, 8: 15, 4: 30}, ("resident", 4, 2, 54)),   # 8e's full truncation: two waves on 4
    (26, 192, 8, {16: 7, 8: 15, 4: 30, 2: 66}, ("resident", 4, 1, 26)),  # a tie of 4 and 2: the larger
])
def test_eigh_log_plan(B, n, sweeps, held, want):
    rounds = sweeps * (n - 1)
    plan = jacobi.eigh_log_plan(B, n, rounds, lambda layout, C: held[C])
    assert (plan.layout, plan.cluster, plan.waves, plan.group) == want
    log = plan.group * 8 * n * plan.chunk
    assert log <= jacobi.LOG_BUDGET  # every launch's log within the budget
    assert plan.group == B or (plan.group + 1) * 8 * n * rounds > jacobi.LOG_BUDGET
    assert plan.chunk == rounds or (plan.group == 1 and (plan.chunk + 1) * 8 * n > jacobi.LOG_BUDGET)
    if plan.layout == "resident":
        assert plan.scratch == log and plan.smem == jacobi.eigh_res_smem(n, plan.cluster) <= jacobi.SMEM_LIMIT
    else:
        assert plan.scratch > log and plan.smem == jacobi.eigh_l2_smem(n)
    with pytest.raises(ValueError):
        jacobi.eigh_log_plan(B, 128, rounds, lambda layout, C: 7)


@pytest.mark.parametrize("B, R, n, want", [
    (4, 512, 512, ("resident", 16, 1)),     # the thermal path's thetas
    (26, 640, 320, ("resident", 16, 4)),    # chi = 160
    (26, 1024, 512, ("l2", 16, 4)),         # chi = 256: two chunks of 512 columns a CTA do not fit
    (2, 544, 512, ("l2", 16, 1)),           # the first R past the resident layout at n = 512
    (2, 2048, 128, ("resident", 16, 1)),    # rows past the cluster kernel at n = 128
])
def test_osj_log_plan(B, R, n, want):
    """K1's launch past the cluster kernel on a card holding 7 clusters of 16
    and 14 of 8, and every shape's log within the budget."""
    plan, nch, cpc = osj.osj_log_plan(B, R, n, 6 * (n - 1), lambda layout, C, cpc: {16: 7, 8: 14}[C])
    assert (plan.layout, plan.cluster, plan.waves) == want and nch == -(-R // 32)
    assert plan.group == B
    if plan.layout == "resident":
        assert cpc == -(-nch // plan.cluster) and plan.smem == osj.osj_res_smem(n, cpc, plan.cluster)
    else:
        assert cpc == 0 and plan.smem == osj.osj_l2_smem(n)
    with pytest.raises(ValueError):
        osj.osj_log_plan(B, 256, 128, 6 * 127, lambda layout, C, cpc: 7)  # the cluster kernel's shape


@pytest.mark.parametrize("R, n, sweeps, want", [
    (512, 512, 6, ("resident", 3, 3066)),       # the thermal path's theta, whole
    (512, 512, 200, ("resident", 1, 102200)),   # one matrix's log (419 MB) within the budget: resident, one a launch
    (512, 512, 300, ("l2", 1, 131072)),         # past it: the L2 variant in chunks (the resident one cannot pause)
    (8192, 4096, 6, ("l2", 1, 16384)),          # 4096 wide: 0.8 GB of log a matrix, chunks of 16384 rounds
    (14528, 14528, 2, ("l2", 1, 4619)),         # the widest theta the kernels take
])
def test_osj_log_plan_bounds_every_launch(R, n, sweeps, want):
    """K1's log a launch stays within `LOG_BUDGET` at any width and sweeps:
    the L2 variant runs its rounds in chunks where one matrix's log does not
    fit, and the resident variant takes only logs that fit whole."""
    rounds = sweeps * (n - 1)
    plan, _, _ = osj.osj_log_plan(3, R, n, rounds, lambda layout, C, cpc: {16: 7, 8: 14}[C])
    assert (plan.layout, plan.group, plan.chunk) == want
    assert plan.group * 8 * n * plan.chunk <= jacobi.LOG_BUDGET
    assert plan.chunk == rounds or (plan.chunk + 1) * 8 * n > jacobi.LOG_BUDGET


def test_pjsvd_takes_up_to_14528():
    """`pjsvd_fits` takes every even side up to n = 14,528 (the L2
    variants' rotations within a CTA), V's kernel taking stages of part of a
    round past n = 9684."""
    for n in (9684, 9686, 12000, 14528):
        assert osj.pjsvd_fits(n, n) and osj.pjsvd_fits(2 * n, n) and rotation_log.fits(n)
    assert not osj.pjsvd_fits(14530, 14530) and not osj.pjsvd_fits(14531, 14531)
    with pytest.raises(ValueError, match="14530"):
        osj.osj_fits(14530, 14530)


@pytest.mark.parametrize("n, B, idle, ctas, want", [
    (512, 4, 68, {"regs": 1, "slab": 2}, "slab"),   # 10e: 128 units, 68 SMs beside one wave
    (192, 18, 60, {"regs": 2, "slab": 4}, "slab"),  # 8d's [18,192,192]: 216 units
    (256, 18, 60, {"regs": 2, "slab": 3}, "regs"),  # 8e's [18,256,256]: 288 units fit neither
    (256, 26, 44, {"regs": 2, "slab": 3}, "regs"),  # 8e's [26,512,256] beside its second wave
    (512, 2, 100, {"regs": 1, "slab": 2}, "regs"),  # the register layout fits
    (1100, 1, 132, {"regs": 0, "slab": 1}, "slab"),  # past REG_N: the slab layout
])
def test_rotation_log_beside_plan(n, B, idle, ctas, want):
    """V's layout beside an iterate, given the CTAs an SM holds: the
    register layout unless its units of the B matrices do not all fit on
    the idle SMs while the slab layout's do; the slab layout's plan is
    `slab_plan`'s."""
    vp = rotation_log.beside_plan(n, B, idle, ctas.get)
    assert vp.layout == want
    if want == "slab":
        S, E, smem = rotation_log.slab_plan(n)
        assert (vp.rows, vp.E, vp.smem) == (S, E, smem)
    else:
        assert vp == rotation_log.plan(n)


def _follow_model(B, C, rounds, m, E, stage, slabs, sms, spins, rng, gate_spins=0):
    """V's kernel beside the iterate (`rotation_log.follow`, the kernels'
    modes follow and rest), over `sms` SMs in a shuffled order: the
    iterate's clusters of C CTAs are placed only where C SMs are free, in
    as many waves as that takes; each CTA logs a round a step and publishes
    the rounds logged every `stage` rounds and at its end (`progress`);
    CTA 0 sets `started`.  With `gate_spins` the follow launch waits on its
    stream behind the gate, which holds an SM and polls `started` of every
    matrix at most that many times.  A follow CTA takes an SM, polls
    `started` `spins` times, and only then claims its unit and reads each
    stage once its cluster's CTAs published its rounds; it stays only once
    no cluster waits to be placed; a rest CTA runs after the iterate and
    takes every unit left.  Returns (stage lists by unit, units taken by
    follow CTAs, of which while a cluster of the launch still ran)."""
    started = np.zeros(B, dtype=bool)
    logged = np.zeros((B, C), dtype=int)  # rounds each iterate CTA has written to the log
    progress = np.zeros((B, C), dtype=int)  # what it published
    claim = np.zeros((B, slabs), dtype=bool)
    free, left, unplaced = [sms], [B * C], [B]
    done, by_follow, beside = {}, [0], [0]
    gate = [gate_spins == 0]  # the follow launch may start
    total = rounds * m
    chunks = -(-total // E)

    def need(c):  # the rounds stage c reaches into
        return -(-min(total, (c + 1) * E) // m)

    def placer():
        for b in rng.permutation(B):
            yield ("sms", C)
            free[0] -= C
            unplaced[0] -= 1
            started[b] = True  # the cluster runs: all its CTAs at once
            for k in range(C):
                ctas[("i", b, k)] = iterate(b, k)
                waiting[("i", b, k)] = next(ctas[("i", b, k)])

    def iterate(b, k):
        for r in range(rounds):
            if r > 0 and r % stage == 0:
                progress[b, k] = r  # after the fence: rounds [0, r) are in the log
            yield ("any",)
            logged[b, k] = r + 1
        progress[b, k] = rounds
        free[0] += 1
        left[0] -= 1

    def gate_cta():
        yield ("sms", 1)
        free[0] -= 1
        for _ in range(gate_spins):
            if started.all():
                break
            yield ("any",)
        free[0] += 1
        gate[0] = True

    def follow(b, s):
        yield ("gate",)
        yield ("sms", 1)
        free[0] -= 1
        for _ in range(spins):
            if started.all():
                break
            yield ("any",)
        if started.all() and not claim[b, s]:
            assert unplaced[0] == 0  # it stays: no cluster waits for an SM
            claim[b, s] = True
            by_follow[0] += 1
            beside[0] += left[0] > 0
            for c in range(chunks):
                yield ("progress", b, need(c))
                assert (logged[b] >= need(c)).all(), "a stage read before its rounds were logged"
                done.setdefault((b, s), []).append(c)
        free[0] += 1

    def rest(b, s):
        yield ("iterate_done",)
        if not claim[b, s]:
            claim[b, s] = True
            assert (logged[b] == rounds).all()
            done[(b, s)] = list(range(chunks))

    def ready(cond):
        if cond[0] == "sms":
            return free[0] >= cond[1]
        if cond[0] == "progress":
            return (progress[cond[1]] >= cond[2]).all()
        if cond[0] == "iterate_done":
            return left[0] == 0
        if cond[0] == "gate":
            return gate[0]
        return True

    ctas = {("p",): placer()}
    if gate_spins:
        ctas[("g",)] = gate_cta()
    ctas.update({("f", b, s): follow(b, s) for b in range(B) for s in range(slabs)})
    ctas.update({("r", b, s): rest(b, s) for b in range(B) for s in range(slabs)})
    waiting = {k: next(g) for k, g in ctas.items()}
    while waiting:
        runnable = [k for k, cond in waiting.items() if ready(cond)]
        assert runnable, f"every CTA waits: {waiting}"
        k = runnable[rng.integers(len(runnable))]
        try:
            waiting[k] = next(ctas[k])
        except StopIteration:
            del waiting[k]
    return done, by_follow[0], beside[0]


@pytest.mark.parametrize("E, stage", [(16, 2), (40, 5), (7, 1)])
def test_v_beside_the_iterate_never_hangs(E, stage):
    """Over shuffled orders, with as few SMs as hold the clusters and one
    more (one wave), and with SMs for two clusters and one to three more
    (two waves of clusters, the follow launch behind the gate): every unit
    is taken once, by a follow or a rest CTA, each stage read in order after
    its rounds were logged, no follow CTA stays while a cluster waits to be
    placed, and nothing waits forever; the follow CTAs take units in some
    orders (past one wave, beside the last wave) and leave them in others."""
    B, C, rounds, m, slabs = 3, 4, 12, 8, 4
    chunks = -(-rounds * m // E)
    for two_waves in (False, True):
        by_follow = beside = 0
        for seed in range(40):
            rng = np.random.default_rng(seed)
            sms = (2 if two_waves else B) * C + 1 + seed % 3
            done, taken, near = _follow_model(B, C, rounds, m, E, stage, slabs, sms, 1 + seed % 4, rng,
                                              gate_spins=40 if two_waves else 0)
            assert sorted(done) == [(b, s) for b in range(B) for s in range(slabs)]
            assert all(cs == list(range(chunks)) for cs in done.values())
            by_follow += taken
            beside += near
        assert 0 < by_follow < 40 * B * slabs
        assert beside > 0


@pytest.mark.parametrize("m, C", [(129, 16), (160, 16), (256, 16), (160, 8), (218, 8), (64, 16)])
def test_osj_owner_closed_form(m, C):
    """The owner of pair i in the resident K1, ((i+1) C + m - 1) / m - 1, is
    the CTA whose pairs [o m / C, (o+1) m / C) hold i."""
    for i in range(m):
        o = ((i + 1) * C + m - 1) // m - 1
        assert o * m // C <= i < (o + 1) * m // C
