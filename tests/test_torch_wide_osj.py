"""K1's round for 128 < n <= 256, modelled on the CPU.

Past n = 128 K1 runs `osj_svd_res_kernel` (`tnqs_torch/csrc/osj_svd.cu`)
on a cluster of 2, 4 or 8 CTAs (16 past n = 256): CTA k holds A's 32-row
chunks [k nch / C, (k+1) nch / C) alone, sends its partial of every pair to
the pair's owner, the owner sums the C partials in CTA order and sends the
rotation to every CTA and to the rotation log, and V is the log applied
afterwards (`rotation_log.cu`, whose plain version is
`rotation_log._apply_rotation_log_plain`).  `test_torch_l2_resident.
_osj_res_model` replays that round with each CTA a generator, the CTAs in
an order a seeded generator shuffles, every hand-over asserting that it
writes no buffer still to be read.  Here it runs at the wide range's
cluster sizes and widths: against `_osj_svd_plain` (which
`tests/test_torch_wide_kernels.py` holds against the JAX kernel) at small
n on clusters of 2, 4 and 8, bit for bit the L2 variant's model at the same
C (the same partial sums in the same order), in several orders, and past
n = 128 V from its log against the plain version's V.  The result depends
on C (the order of the owner's sums), so no test holds two cluster sizes
to the same bits.  The plan is checked in `tests/test_torch_wide_layouts.py`;
the kernel runs on the card in `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tnqs_torch.ops import osj, rotation_log

from test_torch_l2_layouts import _osj_l2_model, _rand_c
from test_torch_l2_resident import _osj_res_model, _warm_start

torch.set_num_threads(1)


@pytest.mark.parametrize("R, n, C", [(96, 12, 2), (160, 16, 4), (256, 20, 8), (100, 20, 2), (64, 16, 8)])
def test_wide_round_is_the_plain_version(R, n, C):
    """Two sweeps at small widths on clusters of 2, 4 and 8 in a shuffled
    order (160 rows: 5 chunks on 4 CTAs, one or two each; 100 rows: a ragged
    last chunk; 64 rows on 8 CTAs: six hold no chunk and only own pairs):
    A and V from the log are the plain version's within rounding."""
    rng = np.random.default_rng(R + n + C)
    A = _rand_c(rng, (2, R, n))
    A = A / torch.linalg.vector_norm(A, dim=(1, 2), keepdim=True)
    V = torch.eye(n, dtype=A.dtype).expand(2, n, n).contiguous()
    A_k, V_k, _ = _osj_res_model(A, V, 2, C, rng, slab=4)
    A_p, V_p = osj._osj_svd_plain(A, V, 2)
    assert torch.allclose(A_k, A_p, atol=2e-6) and torch.allclose(V_k, V_p, atol=2e-5)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wide_round_in_any_order_is_the_l2_model(seed):
    """The CTAs of a cluster of 4 in three shuffled orders: A, V and the
    log are the same bits in every order, and those of the L2 variant's
    model on 4 CTAs (its partials also summed over each CTA's chunks in
    order, then over the CTAs in order)."""
    Ab, V0, _ = _warm_start(136, 24, 7)
    A_k, V_k, log = _osj_res_model(Ab, V0, 1, 4, np.random.default_rng(seed), slab=5)
    A_l, V_l = _osj_l2_model(Ab, V0, 1, 4)
    assert torch.equal(A_k, A_l) and torch.equal(V_k, V_l)
    A_0, V_0, log_0 = _osj_res_model(Ab, V0, 1, 4, np.random.default_rng(0), slab=24)
    assert torch.equal(A_k, A_0) and torch.equal(V_k, V_0) and torch.equal(log, log_0)


@pytest.mark.parametrize("R, n, C", [(272, 130, 4), (260, 130, 8), (192, 192, 2)])
def test_wide_round_v_from_the_log_past_128(R, n, C):
    """Past n = 128, one sweep (272 rows: 9 chunks on 4 CTAs, two or three
    each; 260 on 8; [192, 192] on 2, three chunks a CTA): V0 with the
    model's log applied whole by `rotation_log._apply_rotation_log_plain`
    is the model's V by slabs and the plain version's V within rounding,
    and the singular values are the plain version's."""
    Ab, V0, scale = _warm_start(R, n, R + C)
    A_k, V_k, log = _osj_res_model(Ab, V0, 1, C, np.random.default_rng(C), slab=n // 2 + 1)
    A_p, V_p = osj._osj_svd_plain(Ab, V0, 1)
    V_l = rotation_log._apply_rotation_log_plain(log, V0)
    assert torch.equal(V_l, V_k)  # by slabs or whole, the same operations
    assert torch.allclose(V_l, V_p, atol=2e-5) and torch.allclose(A_k, A_p, atol=2e-6)
    s_k = osj.svd_from_rounds(A_k, V_k, scale)[1]
    s_p = osj.svd_from_rounds(A_p, V_p, scale)[1]
    assert torch.allclose(s_k, s_p, rtol=0, atol=1e-6 * s_p[0, 0].item())
