"""Transverse-field and kicked Ising circuit layers and the operator-picture
fold (`tnqs/models/ising.py:16-80`)."""

from __future__ import annotations

import numpy as np

from ..gates import gate_matrix
from ..graphs import NamedGraph, edge_color


def tfim_layer(g: NamedGraph, J: float, hx: float, dt: float, hz: float = 0.0) -> list:
    """One first-order Trotter layer of the transverse-field Ising model:
    single-site Rx (and optionally Rz) rotations followed by edge-colored
    Rzz groups."""
    layer = [("Rx", [v], 2 * hx * dt) for v in g.vertices()]
    if hz != 0.0:
        layer += [("Rz", [v], 2 * hz * dt) for v in g.vertices()]
    for group in edge_color(g):
        layer += [("Rzz", list(pair), 2 * J * dt) for pair in group]
    return layer


def heavy_hex_kicked_ising_layer(g: NamedGraph, J: float, theta_h: float) -> list:
    """One layer of the kicked-Ising dynamics on the heavy-hex lattice
    (Tindall et al., PRX Quantum 5, 010308 (2024))."""
    layer = [("Rx", [v], theta_h) for v in g.vertices()]
    for group in edge_color(g):
        layer += [("Rzz", list(pair), 2 * J) for pair in group]
    return layer


def operator_picture_layer(layer: list, d0: int = 2) -> list:
    """A state-evolution layer folded into a Heisenberg-picture layer on
    operator sites (two legs folded into one axis of dimension d0^2, ket and
    bra interleaved per vertex), as `tnqs.models.operator_picture_layer`
    (`tnqs/models/ising.py:38`): each gate U(theta) becomes A = U(-theta) on
    the ket legs and conj(A) on the bra legs (a parameterless gate: A =
    U^dagger).  Returns raw-matrix gates for `LatticeEngine` with
    ``site_legs=2``."""
    out = []
    for gate in layer:
        name, verts = gate[0], list(gate[1])
        theta = gate[2] if len(gate) > 2 else None
        A = gate_matrix(name, -theta) if theta is not None else np.conj(gate_matrix(name, None)).T
        B = np.conj(A)
        if len(verts) == 1:
            G = np.kron(A, B)  # G[(p q), (s t)] = A[p, s] B[q, t]
        elif len(verts) == 2:
            A4 = A.reshape(d0, d0, d0, d0)  # [pu, pv, su, sv]
            B4 = B.reshape(d0, d0, d0, d0)  # [qu, qv, tu, tv]
            G = np.einsum("PpSs,QqTt->PQpqSTst", A4, B4).reshape(d0**4, d0**4)
        else:
            raise ValueError("operator_picture_layer supports 1/2-site gates")
        out.append((G, verts))
    return out
