"""The cluster kernels' bookkeeping on the CPU.

The CUDA kernels of `tnqs_torch/csrc/osj_svd.cu` (K1) and `jacobi_eigh.cu`
(K2) keep every column in place and find the pair of each position by a
closed form (`index_at`), sum K1's Gram entries per 32-row chunk in chunk
order, and update only K2's upper 2x2 blocks, mirroring them.  These tests
hold that formulation, written in PyTorch, against the plain versions that
move their columns (which `tests/test_torch_ops.py` holds against the JAX
kernels), and check the K1 launch plan and the wrappers' limits.  The
kernels themselves run on the card in `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tnqs_torch.ops import jacobi, osj

torch.set_num_threads(1)

# the 8 `pjsvd` calls of one Eagle chi=64 layer: (B, R) thetas of width 128
REAL_PATH = [(18, 128), (18, 128), (26, 256), (9, 256), (16, 256), (20, 256), (11, 256), (24, 256)]


def _rand_c(rng, shape):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))


@pytest.mark.parametrize("n", [4, 8, 64, 128])
def test_index_at_matches_round_robin(n):
    perm = jacobi.round_robin(n, "cpu")
    idx = torch.arange(n)  # index at each position, moved as the plain versions move it
    for r in range(3 * (n - 1) + 1):
        assert [jacobi.index_at(j, r, n) for j in range(n)] == idx.tolist(), f"round {r}"
        idx = idx[perm]
    # whole sweeps bring every index home
    assert [jacobi.index_at(j, 3 * (n - 1), n) for j in range(n)] == list(range(n))


def _fake_active(C, smem):
    """Clusters an H100 would hold at once, one CTA on an SM."""
    return 132 // C if smem <= osj.SMEM_LIMIT else 0


@pytest.mark.parametrize(
    "B, R, n",
    sorted(set((B, R, 128) for B, R in REAL_PATH)) + [(1, 4, 4), (3, 6, 4), (2, 33, 32), (2, 130, 128),
                                                       (1, 992, 128), (2, 2048, 64), (5, 64, 64)],
)
def test_osj_plan_fits_and_covers(B, R, n):
    fits = osj.osj_fits(R, n)
    assert fits, f"[{R}, {n}] must fit some cluster"
    for C in fits:
        cpc, vpc, smem = osj.osj_plan(R, n, C)
        assert smem <= osj.SMEM_LIMIT == 232_448
        assert C * cpc * osj.CHUNK >= R and C * vpc * osj.CHUNK >= n  # every row has a CTA
        assert (C - 1) * cpc * osj.CHUNK < R  # and the last CTA holds rows of A
    C = osj.osj_cluster(B, R, n, _fake_active)
    assert C in fits
    room = [C2 for C2 in fits if B <= _fake_active(C2, osj.osj_plan(R, n, C2)[2])]
    assert C == (max(room) if room else min(fits))


def test_osj_plan_real_path_is_one_wave():
    for B, R in REAL_PATH:
        C = osj.osj_cluster(B, R, 128, _fake_active)
        assert B * C <= 132 and osj.osj_plan(R, 128, C)[2] <= osj.SMEM_LIMIT


@pytest.mark.parametrize("R, n", [(993, 128), (2000, 128), (2050, 64), (258, 258), (513, 256), (64, 63), (3, 4),
                                  (2, 2)])
def test_wrappers_raise_past_the_limit(R, n):
    """Past the shared-memory layout (more rows than its clusters hold, or
    n > 256) K1 takes the L2 variant, whose clusters `osj_fits` then lists;
    only an odd n, n < 4 or R < n has no kernel, and every wrapper raises on
    it.  The wrappers raise on a CPU tensor in either case."""
    A = torch.zeros((1, R, n), dtype=torch.complex64)
    V = torch.zeros((1, n, n), dtype=torch.complex64)
    if n % 2 == 0 and 4 <= n <= R:
        assert osj.osj_l2(R, n) and osj.osj_fits(R, n) == list(jacobi.L2_CLUSTERS) and osj.pjsvd_fits(R, n)
        with pytest.raises(ValueError, match="takes the L2 variant"):
            osj.osj_cluster(1, R, n, _fake_active)
        with pytest.raises(ValueError, match="complex64 CUDA tensors"):
            osj._osj_svd_cuda(A, V, 4)
        with pytest.raises(ValueError, match="contiguous complex64 CUDA tensor"):
            jacobi._jacobi_eigh_cuda(torch.zeros((1, n, n), dtype=torch.complex64), 8)
        return
    assert not osj.osj_l2(R, n) and not osj.pjsvd_fits(R, n)
    with pytest.raises(ValueError, match="osj_svd kernel takes even n >= 4 and n <= R"):
        osj.osj_fits(R, n)
    with pytest.raises(ValueError, match="osj_svd kernel takes even n >= 4 and n <= R"):
        osj.osj_cluster(1, R, n, _fake_active)
    with pytest.raises(ValueError, match="osj_svd kernel takes even n >= 4 and n <= R"):
        osj._osj_svd_cuda(A, V, 4)
    if n % 2 or n < 4:
        with pytest.raises(ValueError, match="even n >= 4"):
            jacobi._jacobi_eigh_cuda(torch.zeros((1, n, n), dtype=torch.complex64), 8)


def test_osj_wrapper_refuses_a_cluster_that_does_not_fit():
    A = torch.zeros((2, 256, 128), dtype=torch.complex64)
    with pytest.raises(ValueError, match="a cluster of 1 does not fit"):
        osj._osj_svd_cuda(A, torch.zeros((2, 128, 128), dtype=torch.complex64), 4, cluster=1)


def _osj_fixed_columns(A, V, sweeps, chunk=32):
    """K1's formulation: columns stay, position i pairs index_at(i) with
    index_at(m+i), and each Gram entry is summed per 32-row chunk, the
    chunks added in order."""
    B, R, n = A.shape
    m = n // 2
    X = torch.cat([A, V], 1)
    nch = -(-R // chunk)
    for r in range(sweeps * (n - 1)):
        lft = [jacobi.index_at(i, r % (n - 1), n) for i in range(m)]
        rgt = [jacobi.index_at(m + i, r % (n - 1), n) for i in range(m)]
        x, y = X[:, :R, lft], X[:, :R, rgt]
        vals = torch.stack([(x.conj() * x).real, (y.conj() * y).real, (x.conj() * y).real, (x.conj() * y).imag], -1)
        vals = torch.cat([vals, vals.new_zeros((B, nch * chunk - R, m, 4))], 1).reshape(B, nch, chunk, m, 4).sum(2)
        tot = vals[:, 0]
        for k in range(1, nch):
            tot = tot + vals[:, k]
        c, s, _ = osj._rot_params_rel(tot[..., 0], tot[..., 1], tot[..., 2], tot[..., 3], jacobi.EPS32)
        c, s = c[:, None, :], s[:, None, :]
        x, y = X[:, :, lft], X[:, :, rgt]
        X[:, :, lft], X[:, :, rgt] = c * x + s * y, -s.conj() * x + c * y
    return X[:, :R], X[:, R:]


@pytest.mark.parametrize("R, n, sweeps", [(40, 8, 3), (64, 16, 2)])
def test_osj_fixed_columns_matches_plain(R, n, sweeps):
    rng = np.random.default_rng(R + n)
    A = _rand_c(rng, (2, R, n))
    A = A / torch.linalg.vector_norm(A, dim=(1, 2), keepdim=True)
    V = torch.eye(n, dtype=A.dtype).expand(2, n, n).contiguous()
    A_k, V_k = _osj_fixed_columns(A, V, sweeps)
    A_p, V_p = osj._osj_svd_plain(A, V, sweeps)
    # the same rotations on the same columns; only the order of the Gram sums differs
    assert torch.allclose(A_k, A_p, atol=2e-6) and torch.allclose(V_k, V_p, atol=2e-5)


def _jacobi_fixed_indices(H, sweeps):
    """K2's formulation: indices stay, position i pairs index_at(i) with
    index_at(m+i); rows then columns of each upper 2x2 block (pair i's rows,
    pair j's columns, i <= j) are rotated and the block below the diagonal
    gets their conjugate; V's columns take the same rotations."""
    B, n, _ = H.shape
    m = n // 2
    H = H.clone()
    V = torch.eye(n, dtype=H.dtype).expand(B, n, n).clone()
    upper = torch.triu(torch.ones(m, m, dtype=torch.bool))
    for r in range(sweeps * (n - 1)):
        P = [jacobi.index_at(i, r % (n - 1), n) for i in range(m)]
        Q = [jacobi.index_at(m + i, r % (n - 1), n) for i in range(m)]
        g = H[:, P, Q]
        c, s, _ = jacobi._rot_params(H[:, P, P].real, H[:, Q, Q].real, g.real, g.imag, jacobi.EPS32, True)
        ci, si = c[:, :, None], s[:, :, None]  # pair i's rows
        cj, sj = c[:, None, :], s[:, None, :]  # pair j's columns
        b = [[H[:, P][:, :, P], H[:, P][:, :, Q]], [H[:, Q][:, :, P], H[:, Q][:, :, Q]]]
        for col in range(2):  # rows: top' = c top + conj(s) bot, bot' = -s top + c bot
            top, bot = b[0][col], b[1][col]
            b[0][col], b[1][col] = ci * top + si.conj() * bot, -si * top + ci * bot
        for row in range(2):  # columns: left' = c left + s right, right' = -conj(s) left + c right
            lft, rgt = b[row][0], b[row][1]
            b[row][0], b[row][1] = cj * lft + sj * rgt, -sj.conj() * lft + cj * rgt
        for a, ra in enumerate((P, Q)):
            for bb, cb in enumerate((P, Q)):
                blk = b[a][bb]
                cur = H[:, ra][:, :, cb]
                H[:, torch.tensor(ra)[:, None], torch.tensor(cb)[None, :]] = torch.where(upper, blk, cur)
                low = H[:, cb][:, :, ra]
                H[:, torch.tensor(cb)[:, None], torch.tensor(ra)[None, :]] = torch.where(
                    upper.T & ~torch.eye(m, dtype=torch.bool), blk.conj().mT, low)
        lft, rgt = V[:, :, P], V[:, :, Q]
        V[:, :, P], V[:, :, Q] = cj * lft + sj * rgt, -sj.conj() * lft + cj * rgt
    return H.diagonal(dim1=1, dim2=2).real, V


@pytest.mark.parametrize("n", [4, 8, 16])
def test_jacobi_fixed_indices_matches_plain(n):
    rng = np.random.default_rng(n)
    X = _rand_c(rng, (2, n, n))
    H = (0.5 * (X + X.mH)).contiguous()
    w_k, V_k = _jacobi_fixed_indices(H, 6)
    w_p, V_p = jacobi._jacobi_eigh_plain(H, 6)
    # the same rotations; the mirrored blocks differ from the plain version's
    # by rounding only
    assert torch.allclose(w_k, w_p, atol=2e-5 * w_p.abs().max().item())
    assert torch.allclose(V_k, V_p, atol=1e-4)
