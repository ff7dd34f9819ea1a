"""The register layout of V's kernel (`rotation_log_regs_kernel` in
`tnqs_torch/csrc/rotation_log.cu`), replayed on the CPU.

A warp holds whole rows of V; lane L holds the pair positions of block
b = `rotation_log.lane_block(L, P)`, top [b P, b P + P) and bottom m + the
same, P = ceil(m/32).  Each round a lane applies its P entries of the log to
its P pairs, then the entries move one step along the tournament's cycle
(`jacobi.index_at`, `jacobi.next_position`): inside a lane by renaming (top
logical slot s in register (s - k) mod P, bottom in (s + k) mod P, k the
round mod P), across lanes by one shuffle up the top chain and one down the
bottom chain, and by selects at the turn-arounds (position m to 1 in block
0, m - 1 to n - 1 in the last block, at a slot `sm` of its own where P does
not divide m) and at the fixed position 0.  The model moves the values as
the kernel's registers do, reads the log through a stage's layout
(`rotation_log.stage_unit`, zeros where no entry stands), checks every
entry's p and q against the columns at its positions (the kernel traps), and
applies each pair with the plain version's own arithmetic, so it must equal
`rotation_log._apply_rotation_log_plain` bit for bit: only the movement is
under test.  The logs are the ones the iterate models of
`test_torch_l2_resident.py` and `test_torch_l2_layouts.py` write, whose V
those files hold to the plain versions and so to the JAX package's.
"""

import numpy as np
import pytest
import torch
from test_torch_l2_layouts import _jacobi_l2_model, _osj_l2_model
from test_torch_l2_resident import _hermitian, _jacobi_res_model, _osj_res_model, _rand_c, _warm_start

from tnqs_torch.ops import jacobi, rotation_log

torch.set_num_threads(1)


class PairingError(AssertionError):
    """A log entry's p and q are not the columns standing at its pair's
    positions in that round: the kernel traps."""


def _regs_model(log, V0=None, round0=0):
    """V0 [B, n, n] (the identity when None) rotated by the log [B, rounds,
    m, 4] whose first round is `round0`, moved as the register layout's
    lanes move it.  Returns V [B, n, n]."""
    B, rounds, m, _ = log.shape
    n = 2 * m
    vp = rotation_log.plan(n)
    P = vp.P
    assert vp.layout == "regs"
    W = -(-m // P)  # the blocks that hold positions
    sm = m - 1 - (W - 1) * P  # the last block's last position's slot
    exact = sm == P - 1
    blk = torch.tensor([rotation_log.lane_block(L, P) for L in range(32)])
    lane_of = torch.empty(32, dtype=torch.long)
    lane_of[blk] = torch.arange(32)
    src_up = torch.where(blk == 0, torch.arange(32), lane_of[(blk - 1).clamp(min=0)])
    src_dn = torch.where(blk == 31, torch.arange(32), lane_of[(blk + 1).clamp(max=31)])
    first, last = (blk == 0)[:, None, None], (blk == W - 1)[:, None, None]
    V = torch.eye(n, dtype=torch.complex64).expand(B, n, n) if V0 is None else V0
    rows = V.shape[1]
    i = blk[:, None] * P + torch.arange(P)  # [lane, slot] the pair at logical slot s, k = 0
    valid = i < m
    rr0 = round0 % (n - 1)
    ct = torch.tensor([[jacobi.index_at(x, rr0, n) if x < m else 0 for x in row] for row in i.tolist()])
    cb = torch.tensor([[jacobi.index_at(m + x, rr0, n) if x < m else 0 for x in row] for row in i.tolist()])
    # registers: top[lane, phys], bot[lane, phys] hold [B, rows]; keys col << 16 (top) and col << 1 (bottom)
    top = torch.where(valid[..., None, None], V[:, :, ct].permute(2, 3, 0, 1), 0)
    bot = torch.where(valid[..., None, None], V[:, :, cb].permute(2, 3, 0, 1), 0)
    kt = torch.where(valid, ct << 16, 0)
    kb = torch.where(valid, cb << 1, 0)
    pair_lane, pair_slot = lane_of[torch.arange(m) // P], torch.arange(m) % P  # where pair i stands
    units = torch.tensor([[rotation_log.stage_unit(x, P) for x in row] for row in i.tolist()])
    bad = torch.zeros(32, dtype=torch.bool)
    slot = torch.arange(P)
    for t in range(rounds):
        k = t % P
        ts, bs = (slot - k) % P, (slot + k) % P  # the registers of logical slot s
        stage = torch.zeros((B, rotation_log.round_units(P), 4))
        stage[:, [rotation_log.stage_unit(x, P) for x in range(m)]] = log[:, t]
        e = stage[:, units]  # [B, lane, slot, 4]: zeros where no entry stands
        meta = e[..., 3].contiguous().view(torch.int32).long()
        bad |= (((meta ^ (kt[:, ts] | kb[:, bs])) & ~1) != 0).any(0).any(-1)
        if (meta & 1).any():  # else the round's colmixes are skipped, only the movement runs
            # each pair's entry and registers in pair order, in the plain version's shapes and arithmetic
            q = e[:, pair_lane, pair_slot][:, None]  # [B, 1, m, 4] as the lanes read it
            tt = (q[..., 3].contiguous().view(torch.int32) & 1).bool()
            c, s = q[:, 0, None, :, 0], torch.complex(q[:, 0, None, :, 1], q[:, 0, None, :, 2])
            lft = top[pair_lane, ts[pair_slot]].permute(1, 2, 0).contiguous()
            rgt = bot[pair_lane, bs[pair_slot]].permute(1, 2, 0).contiguous()
            new_l = torch.where(tt, c * lft + s * rgt, lft)
            new_r = torch.where(tt, -s.conj() * lft + c * rgt, rgt)
            top[pair_lane, ts[pair_slot]] = new_l.permute(2, 0, 1)
            bot[pair_lane, bs[pair_slot]] = new_r.permute(2, 0, 1)
        a, b_, c_ = (P - 1 - k) % P, (P - k) % P, k % P
        ta, tb, bc = top[:, a].clone(), top[:, b_].clone(), bot[:, c_].clone()
        kta, ktb, kbc = kt[:, a].clone(), kt[:, b_].clone(), kb[:, c_].clone()
        up = torch.where(first, bc, ta) if P == 1 else ta  # block 0 sends position m up where P = 1
        kup = torch.where(first[:, 0, 0], kbc << 15, kta) if P == 1 else kta
        in_up, in_dn, kin_up, kin_dn = up[src_up], bc[src_dn], kup[src_up], kbc[src_dn]
        if P == 1:
            top[:, a] = torch.where(first, ta, in_up)  # position 0 stays
            kt[:, a] = torch.where(first[:, 0, 0], kta, kin_up)
        else:
            top[:, a], top[:, b_] = torch.where(first, tb, in_up), torch.where(first, bc, tb)
            kt[:, a], kt[:, b_] = torch.where(first[:, 0, 0], ktb, kin_up), torch.where(first[:, 0, 0], kbc << 15, ktb)
        turn = last & exact
        bot[:, c_] = torch.where(turn, ta, in_dn)
        kb[:, c_] = torch.where(turn[:, 0, 0], kta >> 15, kin_dn)
        if not exact:  # the last block's turn-around at slot sm; the top's stale copy keys as empty
            src, dst = (sm - k) % P, (sm + k + 1) % P
            bot[:, dst] = torch.where(last, top[:, src], bot[:, dst])
            kb[:, dst] = torch.where(last[:, 0, 0], kt[:, src] >> 15, kb[:, dst])
            kt[:, src] = torch.where(last[:, 0, 0], 0, kt[:, src])
    # the columns standing at the positions after the last round
    k = rounds % P
    rr = (round0 + rounds) % (n - 1)
    out = torch.empty((B, rows, n), dtype=torch.complex64)
    for L in range(32):
        for ph in range(P):
            for chain, regs, keys, shift, at in ((0, top, kt, 16, (ph + k) % P), (1, bot, kb, 1, (ph - k) % P)):
                x = int(blk[L]) * P + at
                if x >= m:
                    continue
                col = jacobi.index_at(chain * m + x, rr, n)
                bad[L] |= (int(keys[L, ph]) >> shift) != col
                out[:, :, col] = regs[L, ph]
    if bad[blk < W].any():
        raise PairingError(f"a log entry's p, q is not the pair at its positions (lanes {bad.nonzero().tolist()})")
    return out


def _some_rounds_idle(log, every=3):
    """The log with every `every`-th round untaken (its meta's taken bit
    cleared): whole rounds the kernel skips after one vote."""
    log = log.clone()
    p, q, taken = rotation_log.unpack(log)
    taken[:, ::every] = False
    log[..., 3] = rotation_log.meta(p, q, taken)
    return log


def test_blocks_and_stage_read_without_bank_conflicts():
    """Every P up to 16: the lanes hold the 32 blocks once, a round's
    entries fit its units in the stage, and for each slot the 8 lanes of a
    quarter warp read 16-byte words in 8 different bank groups."""
    for P in range(1, 17):
        blk = [rotation_log.lane_block(L, P) for L in range(32)]
        assert sorted(blk) == list(range(32))
        assert max(rotation_log.stage_unit(x, P) for x in range(32 * P)) < rotation_log.round_units(P)
        for s in range(P):
            for q in range(4):
                assert len({rotation_log.stage_unit(blk[L] * P + s, P) % 8 for L in range(8 * q, 8 * q + 8)}) == 8


@pytest.mark.parametrize("n, C, sweeps, relative, V0", [
    (64, 8, 1, False, False),   # m = 32: one position a lane, every lane
    (192, 4, 1, True, True),    # m = 96, P = 3: the chi = 96 widths, 32 lanes of 3
])
def test_regs_model_on_k2_resident_logs(n, C, sweeps, relative, V0):
    """K2's resident model's log (whole, round0 = 0), applied to the
    identity or to a given V0, and with every third round idle: the
    register layout gives the plain version's V bit for bit."""
    rng = np.random.default_rng(n)
    _, _, log = _jacobi_res_model(_hermitian(n, n + C), sweeps, C, relative, rng)
    V = _rand_c(rng, (1, n, n)) if V0 else None
    for lg in (log, _some_rounds_idle(log)):
        assert torch.equal(_regs_model(lg, V), rotation_log._apply_rotation_log_plain(lg, V))


@pytest.mark.parametrize("R, n, C", [(66, 66, 4), (130, 130, 8)])
def test_regs_model_on_k1_resident_logs(R, n, C):
    """K1's resident model's log on its warm start's V0, at m = 33 (P = 2,
    17 blocks, the last holding one position) and m = 65 (P = 3, 22 blocks,
    the last holding two): P does not divide m, the last block turns at a
    slot of its own."""
    Ab, V0, _ = _warm_start(R, n, R + n)
    _, _, log = _osj_res_model(Ab, V0, 1, C, np.random.default_rng(n))
    assert torch.equal(_regs_model(log, V0), rotation_log._apply_rotation_log_plain(log, V0))


@pytest.mark.parametrize("n, chunk, k2", [(8, 5, True), (12, 7, False), (66, 23, True)])
def test_regs_model_on_l2_chunks(n, chunk, k2):
    """The L2 models' logs in launches of `chunk` rounds, each applied in
    place from its first round (round0 mod n-1 not 0 from the second on),
    and again with every other round idle: the register layout equals the
    plain version at every launch, and the chain of launches is the
    model's V."""
    logs = []
    if k2:
        V_model, V = _jacobi_l2_model(_hermitian(n, n), 2, 2, True, chunk, logs)[1], None
    else:
        Ab, V, _ = _warm_start(2 * n, n, n)
        V_model = _osj_l2_model(Ab, V, 2, 2, chunk, logs)[1]
    assert len(logs) > 2 and any(r0 % (n - 1) for r0, _ in logs)
    for r0, log in logs:
        idle = _some_rounds_idle(log, 2)
        assert torch.equal(_regs_model(idle, V, r0), rotation_log._apply_rotation_log_plain(idle, V))
        V_p = rotation_log._apply_rotation_log_plain(log, V)
        assert torch.equal(_regs_model(log, V, r0), V_p)
        V = V_p
    assert torch.equal(V, V_model)


@pytest.mark.parametrize("n, at", [(12, (3, 2)), (66, (4, 32)), (192, (0, 0))])
def test_regs_model_refuses_a_swapped_pair(n, at):
    """A log whose p and q are swapped at one entry (or, at n = 192, a log
    read from the wrong first round) is refused, as the kernel traps rather
    than give a wrong V."""
    rng = np.random.default_rng(n)
    m, rounds = n // 2, 6
    log = torch.zeros((1, rounds, m, 4))
    for r in range(rounds):
        pos = torch.as_tensor([jacobi.index_at(j, r, n) for j in range(n)])
        th = torch.as_tensor(rng.uniform(0, 1.5, (1, m)).astype(np.float32))
        log[:, r] = torch.stack([th.cos(), th.sin(), 0 * th, rotation_log.meta(pos[:m], pos[m:], th > 0.5)], -1)
    assert torch.equal(_regs_model(log), rotation_log._apply_rotation_log_plain(log))
    if n == 192:
        with pytest.raises(PairingError):
            _regs_model(log, round0=1)
        return
    r, i = at
    p, q, taken = rotation_log.unpack(log)
    p[0, r, i], q[0, r, i] = q[0, r, i].clone(), p[0, r, i].clone()
    log[..., 3] = rotation_log.meta(p, q, taken)
    with pytest.raises(PairingError):
        _regs_model(log)
