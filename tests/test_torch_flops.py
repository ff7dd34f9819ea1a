"""tnqs_torch.utils.flops against tnqs.utils.flops (`tests/test_flops.py`'s
four tests on the port, and the breakdown of both packages on the same
layers).  Host-side plan arithmetic only: the port's engines are built on
meta tensors, and no device work runs."""

import numpy as np
import pytest

import tnqs
from tnqs.engine import LatticeEngine as JEngine
from tnqs.utils import flops as jflops

from tnqs_torch.engine import LatticeEngine
from tnqs_torch.models import heavy_hex_kicked_ising_layer
from tnqs_torch.utils.flops import H100_FP32_PEAK, layer_flops, mfu, peak_flops
from torch_flex_cases import graph


def _engine(g, chi):
    return LatticeEngine(graph(g), chi, device="meta")


@pytest.fixture(scope="module")
def small_engine():
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    return _engine(g, 8), heavy_hex_kicked_ising_layer(graph(g), float(np.pi / 4), 0.4)


def test_breakdown_sums_and_positivity(small_engine):
    eng, layer = small_engine
    fl = layer_flops(eng, layer)
    parts = fl["two_site_dense"] + fl["svd"] + fl["bp"] + fl["one_site"]
    assert fl["total"] == pytest.approx(parts)
    for key in ("two_site_dense", "svd", "bp", "one_site"):
        assert fl[key] > 0


def test_bp_lower_bound_monotone(small_engine):
    eng, layer = small_engine
    lo = layer_flops(eng, layer, bp_exec_iters=1)
    hi = layer_flops(eng, layer, bp_exec_iters=5)
    assert hi["bp"] == pytest.approx(5 * lo["bp"])
    assert hi["total"] > lo["total"]
    # the non-BP terms do not depend on the iterations
    assert hi["two_site_dense"] == pytest.approx(lo["two_site_dense"])


def test_chi_scaling(small_engine):
    """Dense two-site work grows faster than chi^2 (chi^3-class gauge and
    theta matmuls dominate)."""
    _, layer = small_engine
    g = tnqs.heavy_hexagonal_lattice(2, 2)
    f8 = layer_flops(_engine(g, 8), layer)
    f16 = layer_flops(_engine(g, 16), layer)
    assert f16["two_site_dense"] > 4 * f8["two_site_dense"]


def test_mfu_math(monkeypatch):
    """The override, the arithmetic, and the default: the H100's float32 rate
    off the tensor cores (132 SMs x 128 lanes x 2 FLOP x 1.98 GHz)."""
    monkeypatch.setenv("TNQS_PEAK_FLOPS", "1e12")
    assert peak_flops() == 1e12
    r = mfu(5e11, 2.0)
    assert r["achieved_flops"] == pytest.approx(1e12)
    assert r["mfu"] == pytest.approx(1.0)
    monkeypatch.delenv("TNQS_PEAK_FLOPS")
    assert peak_flops() == H100_FP32_PEAK == pytest.approx(66.9e12, rel=1e-3)


@pytest.mark.parametrize("bp_exec_iters", [1, 5])
@pytest.mark.parametrize("lattice,chi", [("heavyhex22", 8), ("heavyhex22", 16), ("eagle", 64)])
def test_layer_flops_match_jax(lattice, chi, bp_exec_iters):
    """The port's breakdown is JAX's, key for key (relative 1e-12), on the
    kicked-Ising layer of heavy-hex (2, 2) and of Eagle-127 (the main
    path's chi=64)."""
    g = tnqs.heavy_hexagonal_lattice(2, 2) if lattice == "heavyhex22" else tnqs.eagle_lattice()
    layer = heavy_hex_kicked_ising_layer(graph(g), float(np.pi / 4), 0.4)
    psi = tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex64)
    want = jflops.layer_flops(JEngine(psi, chi=chi), layer, bp_exec_iters=bp_exec_iters)
    got = layer_flops(_engine(g, chi), layer, bp_exec_iters=bp_exec_iters)
    assert got.keys() == want.keys()
    assert got["model"] == want["model"] and got["bp_iters"] == want["bp_iters"]
    for key in ("total", "two_site_dense", "svd", "bp", "one_site"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key
