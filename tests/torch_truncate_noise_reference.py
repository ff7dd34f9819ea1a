"""What sets the boundary-MPS truncation's fidelity beyond rounding.

    python tests/torch_truncate_noise_reference.py

On `tests/test_truncate.py`'s entangled 3x3 state (maxdim 4, complex128),
truncated to maxdim 2 by boundary MPS at BMPS rank 12 (truncating) and 16
(exact), the exact fidelity with the untruncated state: JAX's; the port's
distance from it; the port's move under a relative 1e-15 perturbation of
the state's arrays; and the port's move when the symmetric gauge
(`gauge_state=True`, the default) takes other phases for its singular
vectors, as another SVD implementation may (~60 s on one core).
`tests/test_torch_truncate.py` compares the packages at rank 16 for what
this prints, and `chip_smoke.py` 12c compares the card with the CPU with
and without the gauge.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import tnqs  # noqa: E402
import tnqs_torch as tt  # noqa: E402
from tnqs_torch import gauging  # noqa: E402

from test_torch_truncate import _entangled_state, _fidelity  # noqa: E402
from torch_flex_cases import CPU, graph  # noqa: E402


def _noisy(psi, rng):
    """`psi` with each array scaled by 1 + 1e-15 N(0, 1) elementwise, the
    graph (and so the order of every sweep) kept."""
    out = psi.copy()
    for v in out.vertices():
        d = out[v].data
        out.set_preserve(v, tt.Tensor(d * (1 + 1e-15 * torch.as_tensor(rng.standard_normal(tuple(d.shape)))),
                                      out[v].inds))
    return out


def _phased_svd(rng):
    """`gauging.svd` with each singular pair's phase turned by a random
    angle (U e^{i a}, e^{-i a} V): the same factorization."""
    svd = gauging.svd

    def phased(t, left, **kw):
        U, S, V, err = svd(t, left, **kw)
        ph = torch.as_tensor(np.exp(1j * rng.uniform(0, 2 * np.pi, S.data.shape[0])), dtype=U.data.dtype)
        V_ph = ph.conj().reshape((-1,) + (1,) * (V.data.dim() - 1)) * V.data
        return tt.Tensor(U.data * ph, U.inds), S, tt.Tensor(V_ph, V.inds), err

    return svd, phased


def main():
    torch.set_num_threads(1)
    gj = tnqs.named_grid((3, 3))
    psij = _entangled_state(tnqs, gj)
    psip = _entangled_state(tt, graph(gj), device=CPU)
    for rank in (12, 16):
        kw = dict(alg="boundarymps", maxdim=2, mps_bond_dimension=rank)
        ref = _fidelity(tnqs, tnqs.truncate(psij, **kw), psij)
        port = _fidelity(tt, tt.truncate(psip, **kw), psip)
        noise = [_fidelity(tt, tt.truncate(_noisy(psip, np.random.default_rng(s)), **kw), psip) - port
                 for s in range(3)]
        phases = []
        for s in range(3):
            svd, gauging.svd = _phased_svd(np.random.default_rng(s))
            try:
                phases.append(_fidelity(tt, tt.truncate(psip, **kw), psip) - port)
            finally:
                gauging.svd = svd
        print(f"BMPS rank {rank}: JAX's fidelity {ref:.15f}; the port {port - ref:+.3e} from it; the port under "
              f"1e-15 noise {max(noise, key=abs):+.3e} (largest of 3 draws); under other singular-vector phases in "
              f"the symmetric gauge {[f'{x:+.3e}' for x in phases]}")


if __name__ == "__main__":
    main()
