"""The L2 variants of K1 and K2 (past n = 256), modelled on the CPU.

Past n = 256 the Jacobi kernels keep the iterate in device memory,
column-major by index, one cluster of C CTAs a matrix, and as many matrices
at once as keep their iterates in L2 (`jacobi_eigh_l2_kernel` in
`tnqs_torch/csrc/jacobi_eigh.cu`, `osj_svd_l2_kernel` in
`tnqs_torch/csrc/osj_svd.cu`).  `_jacobi_l2_model` replays K2's data flow:
CTA k owns a range of pair positions and the columns standing at them, every
CTA forms every rotation from an exchange buffer that each owner fills with
its columns' next entries (`jacobi.next_position`), and no column moves.
`_osj_l2_model` replays K1's: CTA k owns a range of 32-row chunks, sums its
chunks' Gram partials in order, and the C partials are summed in CTA order.
Neither rotates V in its rounds: each logs its rotations, and V is the log
applied afterwards (`rotation_log._apply_rotation_log_plain`); where a log
would pass its budget the wrapper runs the rounds in chunks, one launch
each, and applies each chunk's log to V in turn (`chunk=`).
Both are held against the plain versions (which `tests/test_torch_l2_kernels.py`
holds against the JAX kernels) at n = 258, 320 and 512; the launch plan and
the route are checked on shapes alone.  The kernels run on the card in
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tnqs_torch.ops import jacobi, osj, rotation_log

torch.set_num_threads(1)


def _rand_c(rng, shape):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))


def _positions(m, C):
    """Each CTA's pair positions, [k m / C, (k+1) m / C), and their right
    partners m + i: together every position once."""
    owned = [list(range(k * m // C, (k + 1) * m // C)) for k in range(C)]
    owned = [js + [m + j for j in js] for js in owned]
    assert sorted(j for js in owned for j in js) == list(range(2 * m))
    return np.concatenate(owned)


def _jacobi_l2_model(H, sweeps, C, relative, chunk=None, logs=None):
    """K2's L2 variant over C virtual CTAs, in the plain version's arithmetic.
    H [B, n, n]; returns (w [B, n], V [B, n, n]) as the wrapper reads them,
    by index, V from the rounds' rotation log: with `chunk`, each launch of
    `chunk` rounds starts from the entries of H as it stands and V takes
    each launch's log in turn.  `logs` collects (round0, log) a launch."""
    B, n, _ = H.shape
    m, rounds = n // 2, sweeps * (n - 1)
    Hc = H.mT.contiguous()  # Hc[b, col, row] = H[b, row, col]; columns never move
    owned = _positions(m, C)
    perm = jacobi.round_robin(n, "cpu").numpy()
    nxt = np.array([jacobi.next_position(j, n) for j in range(n)])
    xb = torch.zeros((2, B, n, 3), dtype=torch.float32)  # (H[x][x], Re H[p][x], Im H[p][x]) by round parity

    def export(par, pos_now, pos_next, positions_next):
        # every owner writes its columns' entries for the round ahead
        x = pos_now[owned]
        assert np.array_equal(np.bincount(x, minlength=n), np.ones(n, dtype=np.int64))  # each column once
        jn = positions_next[owned]
        assert np.array_equal(pos_next[jn], x)  # the column stands at jn in that round
        xb[par, :, x, 0] = Hc[:, x, x].real
        right = jn >= m
        g = Hc[:, x[right], pos_next[jn[right] - m]]
        xb[par, :, x[right], 1], xb[par, :, x[right], 2] = g.real, g.imag

    pos, V = np.arange(n), None
    chunk = chunk or max(rounds, 1)
    for r0 in range(0, max(rounds, 1), chunk):
        r1 = min(rounds, r0 + chunk)
        log = torch.zeros((B, r1 - r0, m, 4))
        export(0, pos, pos, np.arange(n))  # the launch's first round's entries, from H as it stands
        for r in range(r0, r1):
            P_, Q_ = pos[:m], pos[m:]
            e = xb[(r - r0) & 1]
            c, s, live = jacobi._rot_params(e[:, P_, 0], e[:, Q_, 0], e[:, Q_, 1], e[:, Q_, 2], jacobi.EPS32, relative)
            log[:, r - r0] = torch.stack([c, s.real, s.imag, rotation_log.meta(torch.as_tensor(P_), torch.as_tensor(Q_),
                                                                                 live)], -1)
            if live.any():
                # every CTA's blocks: rows first (in every column), then its columns
                cc, sc = c[:, None, :], s[:, None, :]
                top, bot = Hc[:, :, P_], Hc[:, :, Q_]
                Hc[:, :, P_], Hc[:, :, Q_] = cc * top + sc.conj() * bot, -sc * top + cc * bot
                cr, sr = c[:, :, None], s[:, :, None]
                lft, rgt = Hc[:, P_], Hc[:, Q_]
                Hc[:, P_], Hc[:, Q_] = cr * lft + sr * rgt, -sr.conj() * lft + cr * rgt
            pos_next = pos[perm]
            export((r - r0 + 1) & 1, pos, pos_next, nxt)
            pos = pos_next
        if logs is not None:
            logs.append((r0, log))
        V = rotation_log._apply_rotation_log_plain(log, V)
    return Hc.diagonal(dim1=1, dim2=2).real, V


def _osj_l2_model(A, V, sweeps, C, chunk=None, logs=None):
    """K1's L2 variant over C virtual CTAs: the iterate x[col][row] (rows of
    A padded to 32-row chunks), CTA k's chunks summed in order into its
    partial of every pair, the C partials summed in CTA order, every row
    rotated by its owner, each round's rotations logged.  Returns the
    rotated A and V, V0 with the log applied (with `chunk`, each launch's
    log of `chunk` rounds in turn; `logs` collects (round0, log) a
    launch)."""
    B, R, n = A.shape
    m, ck, rounds = n // 2, osj.CHUNK, sweeps * (n - 1)
    nch = -(-R // ck)
    rp = ck * nch
    X = torch.zeros((B, n, rp), dtype=A.dtype)
    X[:, :, :R] = A.mT
    per_launch = chunk or max(rounds, 1)
    log = torch.zeros((B, rounds, m, 4))
    a_own = [range(k * nch // C, (k + 1) * nch // C) for k in range(C)]
    assert sorted(ch for own in a_own for ch in own) == list(range(nch))  # every chunk once
    perm = jacobi.round_robin(n, "cpu").numpy()
    pos = np.arange(n)
    for r in range(sweeps * (n - 1)):
        P_, Q_ = pos[:m], pos[m:]
        xa = X[:, :, :rp].reshape(B, n, nch, ck)
        x, y = xa[:, P_], xa[:, Q_]
        chunk = torch.stack([(x.real * x.real + x.imag * x.imag).sum(-1), (y.real * y.real + y.imag * y.imag).sum(-1),
                             (x.real * y.real + x.imag * y.imag).sum(-1), (x.real * y.imag - x.imag * y.real).sum(-1)],
                            -1)  # [B, m, nch, 4]
        total = torch.zeros((B, m, 4))
        for own in a_own:
            part = torch.zeros((B, m, 4))
            for ch in own:
                part = part + chunk[:, :, ch]
            total = total + part
        c, s, live = osj._rot_params_rel(total[..., 0], total[..., 1], total[..., 2], total[..., 3], jacobi.EPS32)
        log[:, r] = torch.stack([c, s.real, s.imag, rotation_log.meta(torch.as_tensor(P_), torch.as_tensor(Q_), live)], -1)
        cc, sc = c[:, :, None], s[:, :, None]
        lft, rgt = X[:, P_], X[:, Q_]
        X[:, P_], X[:, Q_] = cc * lft + sc * rgt, -sc.conj() * lft + cc * rgt
        pos = pos[perm]
    for r0 in range(0, max(rounds, 1), per_launch):  # each launch's log, in turn
        if logs is not None:
            logs.append((r0, log[:, r0:r0 + per_launch]))
        V = rotation_log._apply_rotation_log_plain(log[:, r0:r0 + per_launch], V)
    return X[:, :, :R].mT, V


@pytest.mark.parametrize("n, C, relative", [(258, 16, True), (320, 16, False)])
def test_jacobi_l2_model_is_the_plain_version(n, C, relative):
    """One sweep: the same rotations from the exchange buffer, the same
    updates on columns kept by index, so the same bits as the plain version,
    which moves its data between rounds (n = 258: 129 pairs, 8 or 9 a CTA)."""
    rng = np.random.default_rng(n + C)
    X = _rand_c(rng, (1, n, n))
    H = (0.5 * (X + X.mH)).contiguous()
    w_k, V_k = _jacobi_l2_model(H, 1, C, relative)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, 1, relative)
    assert torch.equal(w_k, w_p) and torch.equal(V_k, V_p)


@pytest.mark.parametrize("n, chunk", [(258, 100), (258, 257), (258, 1)])
def test_l2_models_in_round_chunks(n, chunk):
    """The L2 variants run in launches of `chunk` rounds (the wrapper's
    `LogPlan.chunk`, past `LOG_BUDGET`), each starting from the iterate as
    the last left it (K2's exchange entries read anew from H, K1's index
    table from the round), V taking each launch's log in turn: the same bits
    as one launch, and for K2 as the plain version (chunks from one round to
    a sweep, across the sweep's end)."""
    rng = np.random.default_rng(n + chunk)
    X = _rand_c(rng, (1, n, n))
    H = (0.5 * (X + X.mH)).contiguous()
    w_k, V_k = _jacobi_l2_model(H, 2 if chunk > 1 else 1, 16, chunk % 2 == 0, chunk)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, 2 if chunk > 1 else 1, chunk % 2 == 0)
    assert torch.equal(w_k, w_p) and torch.equal(V_k, V_p)
    A = _rand_c(rng, (1, n + 64, n))
    V0 = _rand_c(rng, (1, n, n))
    A_k, V_k = _osj_l2_model(A, V0, 1, 16, chunk)
    A_1, V_1 = _osj_l2_model(A, V0, 1, 16)
    assert torch.equal(A_k, A_1) and torch.equal(V_k, V_1)


@pytest.mark.parametrize("n, C", [(258, 16), (320, 8), (512, 16)])
def test_jacobi_l2_exchange_covers_every_pair(n, C):
    """Over a sweep: every column's entries are exported once a round, by
    the CTA that owns it, and next round each pair (p, q) finds H[p][p] and
    H[q][q] at p and q and its coupling H[p][q] at q, exported by q's owner
    from q's column (n = 512: the thermal path's width on 16 CTAs)."""
    m = n // 2
    owned = _positions(m, C)
    perm = jacobi.round_robin(n, "cpu").numpy()
    nxt = np.array([jacobi.next_position(j, n) for j in range(n)])
    pos = np.arange(n)
    for _ in range(n - 1):
        pos_next = pos[perm]
        x, jn = pos[owned], nxt[owned]
        assert np.array_equal(np.sort(x), np.arange(n)) and np.array_equal(pos_next[jn], x)
        coupling = {int(c): int(pos_next[j - m]) for c, j in zip(x, jn) if j >= m}  # column -> its row exported
        assert coupling == {int(pos_next[m + i]): int(pos_next[i]) for i in range(m)}
        pos = pos_next
    assert np.array_equal(pos, np.arange(n))  # home after a sweep


@pytest.mark.parametrize("R, n, C", [(258, 258, 16), (640, 320, 8)])
def test_osj_l2_model_matches_the_plain_version(R, n, C):
    """One sweep of the polish on a warm start (A V0, V0 a float64 eigenbasis
    of the Gram, as `pjsvd` hands K1 a Jacobi one): the partials summed per
    CTA and then in CTA order differ from the plain version's row sums by
    rounding only."""
    rng = np.random.default_rng(R + n + C)
    A = _rand_c(rng, (1, R, n)) * torch.as_tensor(np.geomspace(1.0, 1e-3, n).astype(np.float32))
    G = (A.mH @ A).to(torch.complex128)
    V0 = torch.linalg.eigh(G)[1].flip(-1).to(torch.complex64)
    Ab, scale = osj.prescale(A @ V0)
    A_k, V_k = _osj_l2_model(Ab, V0, 1, C)
    A_p, V_p = osj._osj_svd_plain(Ab, V0, 1)
    s_k = osj.svd_from_rounds(A_k, V_k, scale)[1]
    s_p = osj.svd_from_rounds(A_p, V_p, scale)[1]
    assert torch.allclose(s_k, s_p, rtol=0, atol=1e-6 * s_p[0, 0].item())
    assert torch.allclose(A_k, A_p, atol=2e-6) and torch.allclose(V_k, V_p, atol=2e-5)


@pytest.mark.parametrize("n", [4, 6, 258, 320, 512])
def test_next_position_follows_the_tournament(n):
    """The entry at position j in round r stands at `next_position(j)` in
    round r + 1 (the closed form the L2 K2's owners use to export)."""
    for r in range(0, n - 1, max(1, (n - 1) // 9)):
        for j in range(n):
            assert jacobi.index_at(jacobi.next_position(j, n), (r + 1) % (n - 1), n) == jacobi.index_at(j, r, n)


@pytest.mark.parametrize("B, live, held, want", [
    (26, 6 * 2**20, {16: 7, 8: 14}, (16, 6, 5)),   # [1024, 512]: 6 MiB a matrix, 6 at once in 40 MiB
    (4, 4 * 2**20, {16: 7, 8: 14}, (16, 4, 1)),    # the thermal path's [4, 512, 512] Grams: the whole batch
    (26, 2**20, {16: 7, 8: 14}, (16, 7, 4)),       # small iterates: as many as the card holds
    (26, 2**20, {16: 0, 8: 14}, (8, 14, 2)),       # no cluster of 16: clusters of 8
    (3, 64 * 2**20, {16: 7, 8: 14}, (16, 1, 3)),   # an iterate past L2: one at a time
])
def test_l2_plan(B, live, held, want):
    plan = jacobi.l2_plan(B, live, 1024, 4096, lambda C: held[C])
    assert (plan.cluster, plan.clusters, plan.waves) == want
    assert plan.clusters * plan.waves >= B > plan.clusters * (plan.waves - 1)
    assert plan.clusters * live <= max(jacobi.L2_BUDGET, live)  # the live iterates fit the L2 budget
    assert plan.scratch == B * live + plan.clusters * 1024 and plan.smem == 4096
    with pytest.raises(RuntimeError, match="no cluster"):
        jacobi.l2_plan(B, live, 1024, 4096, lambda C: 0)


@pytest.mark.parametrize("B, R, n", [(4, 512, 512), (26, 640, 320), (26, 1024, 512), (26, 320, 320), (2, 2048, 128)])
def test_l2_plans_at_the_paths_shapes(B, R, n):
    """The L2 plans at the thermal path's and the chi = 160 and 256 shapes
    (and a theta too tall for K1's shared-memory layout), on a card that
    holds 7 clusters of 16: K1's iterate is A alone, 8 n 32 nch bytes, K2's
    H alone, 8 n^2 (V is out of the rounds), and each stays within the
    shared memory of a CTA."""
    assert osj.osj_l2(R, n) and osj.osj_fits(R, n) == list(jacobi.L2_CLUSTERS)
    plan, nch = osj.osj_l2_plan(B, R, n, lambda C: 7)
    live = 8 * n * osj.CHUNK * nch
    assert nch == -(-R // 32) and plan.smem == osj.osj_l2_smem(n) <= osj.SMEM_LIMIT
    assert plan.clusters == min(B, jacobi.L2_BUDGET // live, 7) and plan.cluster == 16
    if n > 256:
        eplan = jacobi.eigh_l2_plan(B, n, lambda C: 7)
        assert eplan.clusters == min(B, jacobi.L2_BUDGET // (8 * n * n), 7)
        assert eplan.scratch == B * 8 * n * n + eplan.clusters * 32 * n and eplan.smem <= jacobi.SMEM_LIMIT


def _jax_gate(R, n):
    """The JAX engine's route to `pjsvd` (`tnqs/engine.py:1231-1235`): an
    even smaller side of at least 64, with no upper limit."""
    return min(R, n) % 2 == 0 and min(R, n) >= 64


@pytest.mark.parametrize("n0", range(64, 1025, 64))
def test_pjsvd_fits_is_the_jax_gate(n0):
    """Every smaller side from 64 to 1024, even and odd, square to four
    times as tall: `pjsvd_fits` holds exactly where JAX's gate sends the
    theta to `pjsvd`, and K2 and K1 then take its shape."""
    for n in range(n0, n0 + 64 if n0 < 1024 else 1025):
        for R in (n, n + 1, 2 * n, 4 * n + 3):
            assert osj.pjsvd_fits(R, n) == _jax_gate(R, n), (R, n)
            if _jax_gate(R, n):
                assert osj.osj_fits(R, n) and (n <= 256 or jacobi.eigh_l2_smem(n) <= jacobi.SMEM_LIMIT)
