"""The JAX engine's thermal-state run (`examples/hexagonal_heisenberg_thermalstate.py:52-80`),
the reference of the port's operator-site path.

`jax_thermal_free_energies` runs the JAX `LatticeEngine` on the CPU at
complex128: the identity operator state on `named_hexagonal_lattice_graph(2, 2,
periodic=True)`, `heisenberg_thermal_layer` steps with ``cutoff=1e-14`` and
``normalize=False``, and the free-energy density after each step from the
per-step `freenergy` / `rescale` bookkeeping.  `tests/test_torch_operator_sites.py`
holds the port to it at a small size.  Run as a script,

    python tests/torch_thermal_reference.py

it runs `golden_thermal.json`'s configuration (chi=32, dbeta=0.01, 25 steps) and
prints the JAX engine's largest distance from the golden's
`free_energy_density` (the flex tier's) at its recorded steps, the bound
`chip_smoke.py` phase 10e quotes for the card's complex128 run.
"""

import json
import pathlib

import numpy as np

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "golden_thermal.json"


def jax_thermal_free_energies(chi: int, nsteps: int, dbeta: float, J: float = 1.0) -> list:
    import jax.numpy as jnp

    import tnqs
    from tnqs.engine import LatticeEngine
    from tnqs.models import heisenberg_thermal_layer

    g = tnqs.named_hexagonal_lattice_graph(2, 2, periodic=True)
    s = tnqs.siteinds("S=1/2", g, inds_per_site=2)
    eng = LatticeEngine(tnqs.identity_tensornetworkstate(g, s, dtype=np.float64), chi=chi, dtype=jnp.complex128)
    eng.bp_update(maxiter=30)
    step = eng.make_step(heisenberg_thermal_layer(g, J, dbeta), cutoff=1e-14, normalize=False, bp_maxiter=30)
    logz = -eng.freenergy()
    eng.rescale()
    out = []
    for _ in range(nsteps):
        eng.T, eng.M, _ = step(eng.T, eng.M)
        logz -= eng.freenergy()
        eng.rescale()
        out.append(float(np.real(logz) / g.nv()))
    return out


if __name__ == "__main__":
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    gold = json.loads(GOLDEN.read_text())
    c = gold["config"]
    f = jax_thermal_free_energies(c["maxdim"], c["steps"], c["dbeta"], c["J"])
    rec = f[c["record_every"] - 1 :: c["record_every"]]
    dist = [abs(a - b) for a, b in zip(rec, gold["free_energy_density"])]
    print(f"JAX engine, chi={c['maxdim']}, {c['steps']} steps, complex128 on the CPU: free-energy density at steps "
          f"{list(range(c['record_every'], c['steps'] + 1, c['record_every']))}: {rec}")
    print(f"distance from golden_thermal.json's free_energy_density: {dist}; largest {max(dist):.6e}")
