"""Transverse-field and kicked Ising circuit layers (`tnqs/models/ising.py:16-35`)."""

from __future__ import annotations

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
