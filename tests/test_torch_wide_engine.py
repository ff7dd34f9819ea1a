"""One two-site group past chi = 64 in both engines on the CPU: random
bond-96 site tensors on a ring of four sites, whose thetas are [192, 192],
through `pjsvd` (the JAX Pallas kernels in interpret mode; the port's plain
versions of K2 and K1), truncated back to chi = 96
(`tests/torch_engine_cases.py`)."""

from torch_engine_cases import two_site_group_against_jax


def test_wide_two_site_group_matches_jax(monkeypatch):
    two_site_group_against_jax(96, monkeypatch)
