"""Site types, local operator matrices and local state vectors (port of
`tnqs/sitetypes.py`).

The one table of operator matrices in the port: the gate registry, the
engine and the flex tier all read `op_matrix` here.  "X"/"Y"/"Z" are the
Pauli matrices, "H" the Hadamard, spin operators "Sx" = X/2 etc.; host
numpy, built by the same arithmetic as the JAX package.
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------
# site types
# ----------------------------------------------------------------------

_SITE_ALIASES_2 = {"s=1/2", "qubit", "spin1/2", "spinhalf"}
_SITE_ALIASES_3 = {"qutrit", "s=1", "spin1"}


def _norm_sitetype(sitetype: str) -> str:
    return sitetype.replace(" ", "").lower()


def site_dimension(sitetype: str) -> int:
    """Physical dimension of a site type (reference `src/siteinds.jl:12-17`)."""
    s = _norm_sitetype(sitetype)
    if s in _SITE_ALIASES_2:
        return 2
    if s in _SITE_ALIASES_3:
        return 3
    raise ValueError(f"unknown site type {sitetype!r}; supported: S=1/2, S=1")


def site_tag(sitetype: str) -> str:
    s = _norm_sitetype(sitetype)
    if s in _SITE_ALIASES_2:
        return "S=1/2"
    if s in _SITE_ALIASES_3:
        return "S=1"
    raise ValueError(f"unknown site type {sitetype!r}; supported: S=1/2, S=1")


# ----------------------------------------------------------------------
# operator matrices
# ----------------------------------------------------------------------

_SQ2 = 1.0 / np.sqrt(2.0)

_OPS_2: dict[str, np.ndarray] = {
    "I": np.eye(2),
    "X": np.array([[0.0, 1.0], [1.0, 0.0]]),
    "Y": np.array([[0.0, -1j], [1j, 0.0]]),
    "Z": np.array([[1.0, 0.0], [0.0, -1.0]]),
    "H": np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]]),
    "S": np.array([[1.0, 0.0], [0.0, 1j]]),
    "T": np.array([[1.0, 0.0], [0.0, np.exp(1j * np.pi / 4)]]),
    "Sx": 0.5 * np.array([[0.0, 1.0], [1.0, 0.0]]),
    "Sy": 0.5 * np.array([[0.0, -1j], [1j, 0.0]]),
    "Sz": 0.5 * np.array([[1.0, 0.0], [0.0, -1.0]]),
    "S+": np.array([[0.0, 1.0], [0.0, 0.0]]),
    "S-": np.array([[0.0, 0.0], [1.0, 0.0]]),
    "ProjUp": np.array([[1.0, 0.0], [0.0, 0.0]]),
    "ProjDn": np.array([[0.0, 0.0], [0.0, 1.0]]),
}
OPERATORS = _OPS_2  # the qubit table the engine and the gate registry read

_S1X = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]]) / np.sqrt(2.0)
_S1Y = np.array([[0, -1j, 0], [1j, 0, -1j], [0, 1j, 0]]) / np.sqrt(2.0)
_S1Z = np.diag([1.0, 0.0, -1.0])

_OPS_3: dict[str, np.ndarray] = {
    "I": np.eye(3),
    "Sx": _S1X,
    "Sy": _S1Y,
    "Sz": _S1Z,
    "X": _S1X,
    "Y": _S1Y,
    "Z": _S1Z,
    "S+": np.sqrt(2.0) * np.array([[0, 1, 0], [0, 0, 1], [0, 0, 0]], dtype=float),
    "S-": np.sqrt(2.0) * np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=float),
}


def op_matrix(name: str, dim: int = 2) -> np.ndarray:
    """Local operator matrix `name` acting on a `dim`-dimensional site (a
    qubit by default)."""
    table = _OPS_2 if dim == 2 else _OPS_3 if dim == 3 else None
    if name == "I":
        return np.eye(dim)
    if table is None or name not in table:
        raise ValueError(f"unknown operator {name!r} for site dimension {dim}")
    return table[name]


# ----------------------------------------------------------------------
# state vectors
# ----------------------------------------------------------------------

_STATES_2: dict[str, np.ndarray] = {
    "↑": np.array([1.0, 0.0]),
    "Up": np.array([1.0, 0.0]),
    "Z+": np.array([1.0, 0.0]),
    "0": np.array([1.0, 0.0]),
    "↓": np.array([0.0, 1.0]),
    "Dn": np.array([0.0, 1.0]),
    "Z-": np.array([0.0, 1.0]),
    "1": np.array([0.0, 1.0]),
    "+": np.array([_SQ2, _SQ2]),
    "X+": np.array([_SQ2, _SQ2]),
    "-": np.array([_SQ2, -_SQ2]),
    "X-": np.array([_SQ2, -_SQ2]),
    "i": np.array([_SQ2, 1j * _SQ2]),
    "Y+": np.array([_SQ2, 1j * _SQ2]),
    "-i": np.array([_SQ2, -1j * _SQ2]),
    "Y-": np.array([_SQ2, -1j * _SQ2]),
}

_STATES_3: dict[str, np.ndarray] = {
    "↑": np.array([1.0, 0.0, 0.0]),
    "Up": np.array([1.0, 0.0, 0.0]),
    "Z+": np.array([1.0, 0.0, 0.0]),
    "0": np.array([0.0, 1.0, 0.0]),
    "Z0": np.array([0.0, 1.0, 0.0]),
    "↓": np.array([0.0, 0.0, 1.0]),
    "Dn": np.array([0.0, 0.0, 1.0]),
    "Z-": np.array([0.0, 0.0, 1.0]),
}


def state_vector(name: str, dim: int) -> np.ndarray:
    table = _STATES_2 if dim == 2 else _STATES_3 if dim == 3 else None
    if table is None or name not in table:
        raise ValueError(f"unknown state {name!r} for site dimension {dim}")
    return table[name]
