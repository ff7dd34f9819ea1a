"""How far the JAX flex tier's own certified samples move when rounding
noise enters its QR factorizations, the yardstick of the port's flex
sampler on `golden_eagle127.json`.

The boundary-MPS fitting starts from rank-deficient messages (a delta on
each bond times a vector of ones on the MPS's virtual index); their QR's
trailing columns, the basis of a null space, are fixed by rounding, and the
fitting at a truncating rank converges to a point that depends on them.  So
the sampler's p/q is reproducible only by bit-identical arithmetic.  Run as
a script,

    python tests/torch_flex_noise_reference.py [--seeds 3]

it evolves the golden's configuration on the JAX flex tier on the CPU
(Eagle-127, 20 kicked-Ising layers, maxdim 8, complex128), draws the first
`sample_directly_certified` sample at rank 10 with `default_rng(0)` once
as is and once for each noise seed with relative noise of 1e-15 added to
every QR input, and prints each p/q's distance from the golden's first
sample (bits and count of ones beside it).  `chip_smoke.py` phase 11b
quotes the largest distance for its p/q bound.  Takes ~4 min on 8 cores.
"""

import argparse
import json
import pathlib
import sys

import numpy as np

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "golden_eagle127.json"


def evolved_state():
    import tnqs
    from tnqs.models import heavy_hex_kicked_ising_layer

    c = json.loads(GOLDEN.read_text())["config"]
    g = tnqs.eagle_lattice()
    bpc = tnqs.BeliefPropagationCache(tnqs.tensornetworkstate(lambda v: "↑", g, "S=1/2", dtype=np.complex128))
    ak = dict(maxdim=c["maxdim"], cutoff=c["cutoff"], normalize_tensors=True)
    for _ in range(c["layers"]):
        bpc, _ = tnqs.apply_gates(heavy_hex_kicked_ising_layer(g, c["J"], c["theta_h"]), bpc, apply_kwargs=ak)
    return bpc.network


def first_sample(psi, noise_seed=None):
    """The first certified sample, with 1e-15 relative noise on every QR
    input when `noise_seed` is given."""
    import tnqs
    import tnqs.core.linalg as JL

    gold = json.loads(GOLDEN.read_text())
    c = gold["config"]
    qr = np.linalg.qr
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)

        def noisy_qr(a, mode="reduced"):
            a = np.asarray(a)
            scale = 1e-15 * (np.abs(a).max() if a.size else 1.0)
            n = rng.standard_normal(a.shape) * scale
            if np.iscomplexobj(a):
                n = n + 1j * rng.standard_normal(a.shape) * scale
            return qr(a + n, mode=mode)

        JL.np.linalg.qr = noisy_qr
    try:
        r = tnqs.sample_directly_certified(psi, 1, alg="boundarymps", norm_mps_bond_dimension=c["mps_bond_dimension"],
                                           rng=np.random.default_rng(c["sample_seed"]))[0]
    finally:
        JL.np.linalg.qr = qr
    want = gold["first4_samples"][0]
    return float(np.real(r["poverq"])) - want["poverq"], int(r["bitstring"][tuple(c["central"])]), int(
        sum(r["bitstring"].values()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(GOLDEN.parents[2]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    psi = evolved_state()
    print(f"no noise: p/q - golden {first_sample(psi)[0]:.3e}")
    worst = 0.0
    for seed in range(1, args.seeds + 1):
        d, bit, ones = first_sample(psi, seed)
        worst = max(worst, abs(d))
        print(f"QR noise seed {seed}: p/q - golden {d:.3e} (bit at the centre {bit}, ones {ones})", flush=True)
    print(f"largest |p/q - golden| under 1e-15 QR noise: {worst:.3e}")


if __name__ == "__main__":
    main()
