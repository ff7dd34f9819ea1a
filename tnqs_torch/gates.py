"""Gate and operator matrices for the kicked-Ising and TFIM layers.

Port of the entries of `tnqs/gates.py` that the Ising layers use: ``Rx``,
``Rz`` and ``Rzz`` (`tnqs/gates.py:99`, `:101`, `:137`), resolved by
`gate_matrix` (`:276`), plus the qubit operator table of
`tnqs/sitetypes.py:51-66`.
Parameter conventions are qiskit's, ``Rzz(θ) = exp(-i θ ZZ / 2)``.  The
matrices are host numpy in complex128, built by the same arithmetic as the
JAX package so both compile bit-identical gate tables.
"""

from __future__ import annotations

import numpy as np

_SQ2 = 1.0 / np.sqrt(2.0)
_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])

OPERATORS = {
    "I": np.eye(2),
    "X": _X,
    "Y": np.array([[0.0, -1j], [1j, 0.0]]),
    "Z": _Z,
    "H": np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]]),
    "S": np.array([[1.0, 0.0], [0.0, 1j]]),
    "T": np.array([[1.0, 0.0], [0.0, np.exp(1j * np.pi / 4)]]),
    "Sx": 0.5 * _X,
    "Sy": 0.5 * np.array([[0.0, -1j], [1j, 0.0]]),
    "Sz": 0.5 * _Z,
    "S+": np.array([[0.0, 1.0], [0.0, 0.0]]),
    "S-": np.array([[0.0, 0.0], [1.0, 0.0]]),
    "ProjUp": np.array([[1.0, 0.0], [0.0, 0.0]]),
    "ProjDn": np.array([[0.0, 0.0], [0.0, 1.0]]),
}


def _expm_gen(h: np.ndarray, scale) -> np.ndarray:
    """exp(-i * scale * h) for a hermitian generator h (`tnqs/gates.py:41`)."""
    w, u = np.linalg.eigh(h)
    return (u * np.exp(-1j * scale * w)[None, :]) @ u.conj().T


_GENERATORS = {"Rx": _X, "Rz": _Z, "Rzz": np.kron(_Z, _Z)}


def gate_matrix(name: str, param) -> np.ndarray:
    """Unitary of the rotation gate `name` at angle `param`."""
    if name not in _GENERATORS:
        raise ValueError(f"unknown gate {name!r}; supported: {sorted(_GENERATORS)}")
    return _expm_gen(_GENERATORS[name], 0.5 * param)


def op_matrix(name: str) -> np.ndarray:
    """Single-site operator matrix on a qubit."""
    if name not in OPERATORS:
        raise ValueError(f"unknown operator {name!r}; supported: {sorted(OPERATORS)}")
    return OPERATORS[name]
