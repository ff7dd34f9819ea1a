"""Analytic FLOP accounting of the engine's Trotter layer (port of
`tnqs/utils/flops.py`).

`layer_flops` prices one layer in real float32 FLOPs from the engine's own
static plan, the `compile_circuit` + `build_program` structures that
`LatticeEngine.make_step` runs, so a benchmark can report the FLOP/s it
reaches and `mfu` its share of the card's peak.

Conventions:

- complex64 arithmetic: one complex multiply-add = 4 real multiply-adds =
  **8 real FLOPs**.
- Dense factorizations are priced with explicit model constants (on each
  term below), in the LAPACK flop-count tradition, not measured.  The
  dominant terms (the gauge, Gram and recombination matmuls, theta's
  build) are exact.
- The ceiling (`peak_flops`) is the card's float32 rate off the tensor
  cores: `tnqs_torch` turns TF32 off and pins float32 matmuls to
  "highest", so a complex64 matmul runs on the CUDA cores' FFMA.  Override
  it with ``TNQS_PEAK_FLOPS`` (real FLOP/s).
"""

from __future__ import annotations

import os

# NVIDIA H100 80GB HBM3 (SXM), 700.00 W: 132 SMs x 128 FP32 lanes x 2 FLOP
# (an FFMA) x 1.98 GHz boost clock.  A card held below 700 W clocks lower
# under load and reaches less.
H100_FP32_PEAK = 132 * 128 * 2 * 1.98e9

# model constants (real-flop multipliers on n^3-class factorizations)
C_HERM_EIG = 9.0  # hermitian eigendecomposition of an n x n block
C_CHOL = 1.0 / 3.0  # Cholesky of an n x n block
C_SVD = 20.0  # direct SVD (one-sided Jacobi or the library's, to convergence)

_CPX = 8.0  # real FLOPs per complex multiply-add


def peak_flops() -> float:
    """The FLOP/s `mfu` divides by: ``TNQS_PEAK_FLOPS`` if set, else
    `H100_FP32_PEAK`."""
    env = os.environ.get("TNQS_PEAK_FLOPS")
    if env:
        return float(env)
    return H100_FP32_PEAK


def _side_flops(Bn: int, k: int, chi: int, d: int) -> tuple[float, int]:
    """Real FLOPs for one side (a vertex of degree ``k``) of a two-site
    class of ``Bn`` edges, through gauge -> reduction -> recombination ->
    un-gauge; returns (flops, r) with ``r`` the reduced row count of the R
    factor feeding theta (wide sides take R = X, tall sides the Gram
    reduction)."""
    n = d * chi
    r_env = chi ** (k - 1)
    fl = 0.0
    # bond-environment gauge roots: (k-1) hermitian chi x chi solves
    fl += (k - 1) * Bn * C_HERM_EIG * _CPX * chi**3
    # gauge in + un-gauge out: (k-1) message matmuls on each pass
    fl += 2 * Bn * (k - 1) * _CPX * r_env * d * chi**2
    if r_env > n:  # tall side: Gram reduction + recombination
        fl += Bn * _CPX * r_env * n**2  # X^H X
        fl += Bn * (C_CHOL * 2 + 1) * _CPX * n**3  # rfactor chain + R^-1 solves
        fl += Bn * _CPX * r_env * n**2  # X @ (R^-1 R_new)
        r = n
    else:
        r = r_env
    return fl, r


def layer_flops(eng, circuit, bp_exec_iters: int = 1) -> dict:
    """Price one Trotter layer of ``circuit`` on ``eng`` in real FLOPs
    (`tnqs/utils/flops.py:76`).

    Walks the program `LatticeEngine.make_step` builds (the same
    `compile_circuit` + `build_program`), so the BP refreshes counted are
    the ones the step runs.  A BP fixed point stops on convergence, an
    iteration count the plan cannot know; ``bp_exec_iters`` prices each
    one at that many iterations.  The default 1 is the least a run
    executes, which makes the total (and an MFU from it) a lower bound.
    Returns the breakdown; ``total`` is the headline number."""
    from ..engine import build_program, compile_circuit

    chi, d = eng.chi, eng.d
    program = build_program(eng.plan, compile_circuit(eng.plan, circuit, d=d))

    two = one = svd = 0.0
    n_bp_iters = bp_exec_iters  # the final refresh
    for entry in program:
        if entry[0] == "bp":
            n_bp_iters += bp_exec_iters
        elif entry[0] == "one":
            for k, (pos, _, _) in entry[1].per_bucket.items():
                one += len(pos) * _CPX * d**2 * chi ** (k - 1) * d
        else:
            for cls in entry[1].classes:
                Bn = len(cls.u_pos)
                fu, ru = _side_flops(Bn, cls.ku, chi, d)
                fv, rv = _side_flops(Bn, cls.kv, chi, d)
                two += fu + fv
                n = d * chi
                # theta: the gate fold (tiny) and one matmul [ru, n] x [n, d rv d]
                two += Bn * _CPX * d**4 * rv * chi
                two += Bn * _CPX * ru * n * (d * rv * d)
                m_, n_ = ru * d, rv * d
                svd += Bn * C_SVD * _CPX * m_ * n_ * min(m_, n_)
                # truncation algebra: s-scaled R factors (tiny) and the writeback
                two += Bn * _CPX * (m_ + n_) * chi

    # BP message updates: per directed edge out of a degree-k vertex, (k-1)
    # environment absorptions and the closing contraction, each an
    # r_env d x chi matmul against a chi x chi message
    bp_per_iter = 0.0
    for k, bucket in eng.plan.buckets.items():
        bp_per_iter += len(bucket) * k * k * _CPX * chi ** (k - 1) * d * chi**2
    bp = n_bp_iters * bp_per_iter

    return {
        "total": two + svd + one + bp,
        "two_site_dense": two,
        "svd": svd,
        "bp": bp,
        "one_site": one,
        "bp_iters": n_bp_iters,
        "model": (
            "complex madd = 8 flops; C_eig=9, C_svd=20, C_chol=1/3; "
            "BP priced at the guaranteed-executed minimum (lower bound)"
        ),
    }


def mfu(flops_per_layer: float, layers_per_sec: float) -> dict:
    """The FLOP/s reached at `layers_per_sec` and its share of `peak_flops`."""
    peak = peak_flops()
    achieved = flops_per_layer * layers_per_sec
    return {
        "flops_per_layer": flops_per_layer,
        "achieved_flops": achieved,
        "peak_flops": peak,
        "mfu": achieved / peak,
    }
