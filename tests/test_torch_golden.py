"""The port of `tests/test_golden.py:158`, the engine's cross-tier parity
gate, on tnqs_torch: 20 kicked-Ising layers on the 127-qubit Eagle lattice
at chi=8, complex128, ``factor_method="direct"``, must land within 1e-5 of
the flex-tier golden trajectory `tests/golden/golden_eagle127.json`.  It
reads the committed golden and runs no JAX."""

import json
import pathlib

import torch

import tnqs_torch as tt
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.ops import bp_sweep, jacobi, osj

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "golden_eagle127.json"


def test_eagle127_direct_complex128_matches_golden():
    gold = json.loads(GOLDEN.read_text())
    c = gold["config"]
    g = tt.eagle_lattice()
    eng = LatticeEngine(g, chi=c["maxdim"], dtype=torch.complex128, device="cpu", factor_method="direct")
    plain = (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls, bp_sweep._bp_sweep_group_plain.calls)
    eng.evolve(tt.heavy_hex_kicked_ising_layer(g, c["J"], c["theta_h"]), num_layers=c["layers"],
               cutoff=c["cutoff"], bp_maxiter=25)
    z = eng.expect_1site("Z")[tuple(c["central"])]
    assert abs(z.real - gold["z_central"][-1]) < 1e-5
    # complex128 takes none of the float32 kernels, not even as plain versions
    assert plain == (jacobi._jacobi_eigh_plain.calls, osj._osj_svd_plain.calls, bp_sweep._bp_sweep_group_plain.calls)
