"""Heisenberg imaginary-time evolution of a purified thermal state
(`tnqs/models/heisenberg.py:17-64`): the folded Trotter layer for the
engine's operator sites and the high-temperature series anchor."""

from __future__ import annotations

from math import log

import numpy as np

from ..gates import gate_matrix
from ..graphs import NamedGraph, edge_color


def heisenberg_thermal_layer(g: NamedGraph, J: float, dbeta: float, d0: int = 2) -> list:
    """One imaginary-time Trotter layer folded for operator sites (two legs
    of dimension d0 in one axis, ket and bra interleaved per vertex):
    ``Rxxyyzz(-i J dbeta / 2)`` on the ket legs of every edge, identity on
    the bra legs, edge-colored (`tnqs/models/heisenberg.py:29`).  Raw-matrix
    gates for `LatticeEngine` with ``site_legs=2`` from the identity
    operator state."""
    U = gate_matrix("Rxxyyzz", -0.5j * J * dbeta)
    A4 = U.reshape(d0, d0, d0, d0)  # [out_u, out_v, in_u, in_v] (ket legs)
    I2 = np.eye(d0)
    G = np.einsum("PpSs,QT,qt->PQpqSTst", A4, I2, I2).reshape((d0 * d0) ** 2, (d0 * d0) ** 2)
    return [(G, list(e)) for group in edge_color(g) for e in group]


def htse_free_energy_density_4th(J: float, beta: float) -> float:
    """4th-order high-temperature series of the hexagonal-lattice Heisenberg
    free-energy density (`tnqs/models/heisenberg.py:56`)."""
    return -log(2) - (9 / 64) * J * J * beta * beta - (3 / 128) * J**3 * beta**3 + (27 / 2048) * J**4 * beta**4
