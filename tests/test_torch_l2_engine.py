"""One two-site group past n = 256 in both engines on the CPU: random
bond-130 site tensors on a ring of four sites, whose thetas are [260, 260],
through `pjsvd` (the JAX Pallas kernels in interpret mode; the port's plain
versions of K2 and K1, which the L2 variants run on the card; until them
these thetas took the library SVD), truncated back to chi = 130
(`tests/torch_engine_cases.py`)."""

from torch_engine_cases import two_site_group_against_jax


def test_l2_two_site_group_matches_jax(monkeypatch):
    two_site_group_against_jax(130, monkeypatch)
