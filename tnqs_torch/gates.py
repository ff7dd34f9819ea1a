"""Gate registry, gate matrices and gate tensors.

Port of `tnqs/gates.py`: `GateSpec`, the built-in gates, `register_gate` /
`register_alias` / `unregister_gate`, lower-case aliases, Pauli strings and
`gate_matrix`, and the flex tier's `to_tensor` / `circuit_to_tensors` /
`op`, which lift a matrix onto site indices as ``(s1', s2', s1, s2)``
tensors on a device.  Parameter conventions are qiskit's, ``Rzz(θ) =
exp(-i θ ZZ / 2)``; a parameter may be complex (imaginary-time gates, e.g.
``Rxxyyzz`` at ``-0.5j J dbeta``).  The matrices are host numpy in
complex128, built by the same arithmetic as the JAX package, so both
compile bit-identical gate tables; the engine takes names or raw matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .core.index import Index
from .core.tensor import Tensor, from_matrix
from .graphs import NamedGraph
from .sitetypes import op_matrix

_I2 = np.eye(2)
_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_Y = np.array([[0.0, -1j], [1j, 0.0]])
_Z = np.array([[1.0, 0.0], [0.0, -1.0]])
_H = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
_P0 = np.array([[1.0, 0.0], [0.0, 0.0]])
_P1 = np.array([[0.0, 0.0], [0.0, 1.0]])


def _expm_gen(h: np.ndarray, scale) -> np.ndarray:
    """exp(-i * scale * h) for a hermitian generator h, `scale` possibly
    complex (`tnqs/gates.py:41`)."""
    w, u = np.linalg.eigh(h)
    return (u * np.exp(-1j * scale * w)[None, :]) @ u.conj().T


def _controlled(u: np.ndarray) -> np.ndarray:
    """Control on the first qubit."""
    return np.kron(_P0, _I2) + np.kron(_P1, u)


def _rot(axis: np.ndarray):
    def f(theta):
        return _expm_gen(axis, 0.5 * theta)

    return f


@dataclass
class GateSpec:
    """A registered gate: `matrix(*params)` returns the unitary in the
    computational basis (|q1 q2>, first qubit most significant)."""

    matrix: Callable[..., np.ndarray]
    num_qubits: int
    num_params: int = 0
    rescale: Callable = None  # applied to user params before `matrix`


def _fixed(mat: np.ndarray, nq: int) -> GateSpec:
    m = np.asarray(mat)
    return GateSpec(lambda: m, nq, 0)


GATES: dict[str, GateSpec] = {
    "X": _fixed(_X, 1),
    "Y": _fixed(_Y, 1),
    "Z": _fixed(_Z, 1),
    "H": _fixed(_H, 1),
    "Rx": GateSpec(_rot(_X), 1, 1),
    "Ry": GateSpec(_rot(_Y), 1, 1),
    "Rz": GateSpec(_rot(_Z), 1, 1),
    "P": GateSpec(lambda phi: np.diag([1.0, np.exp(1j * phi)]), 1, 1),
    "Rz+": GateSpec(lambda theta: np.diag([np.exp(-1j * theta), 1.0]), 1, 1),
    "CNOT": _fixed(_controlled(_X), 2),
    "CX": _fixed(_controlled(_X), 2),
    "CY": _fixed(_controlled(_Y), 2),
    "CZ": _fixed(_controlled(_Z), 2),
    "SWAP": _fixed(np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=float), 2),
    "iSWAP": _fixed(np.array([[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]]), 2),
    "√SWAP": _fixed(
        np.array([[1, 0, 0, 0], [0, 0.5 + 0.5j, 0.5 - 0.5j, 0], [0, 0.5 - 0.5j, 0.5 + 0.5j, 0], [0, 0, 0, 1]]), 2
    ),
    "√iSWAP": _fixed(
        np.array(
            [
                [1, 0, 0, 0],
                [0, 1 / np.sqrt(2), 1j / np.sqrt(2), 0],
                [0, 1j / np.sqrt(2), 1 / np.sqrt(2), 0],
                [0, 0, 0, 1],
            ]
        ),
        2,
    ),
    "Rxx": GateSpec(_rot(np.kron(_X, _X)), 2, 1),
    "Ryy": GateSpec(_rot(np.kron(_Y, _Y)), 2, 1),
    "Rzz": GateSpec(_rot(np.kron(_Z, _Z)), 2, 1),
    "CRx": GateSpec(lambda t: _controlled(_rot(_X)(t)), 2, 1),
    "CRy": GateSpec(lambda t: _controlled(_rot(_Y)(t)), 2, 1),
    "CRz": GateSpec(lambda t: _controlled(_rot(_Z)(t)), 2, 1),
    "CPHASE": GateSpec(lambda phi: np.diag([1.0, 1.0, 1.0, np.exp(1j * phi)]), 2, 1),
    "Rz+z+": GateSpec(lambda t: np.diag([np.exp(-1j * t), 1.0, 1.0, 1.0]), 2, 1),
    "Rxxyy": GateSpec(lambda t: _expm_gen(0.5 * (np.kron(_X, _X) + np.kron(_Y, _Y)), t), 2, 1),
    "Rxxyyzz": GateSpec(lambda t: _expm_gen(0.5 * (np.kron(_X, _X) + np.kron(_Y, _Y) + np.kron(_Z, _Z)), t), 2, 1),
    "xx_plus_yy": GateSpec(
        lambda theta, beta: np.array(
            [
                [1, 0, 0, 0],
                [0, np.cos(theta / 2), -1j * np.sin(theta / 2) * np.exp(-1j * beta), 0],
                [0, -1j * np.sin(theta / 2) * np.exp(1j * beta), np.cos(theta / 2), 0],
                [0, 0, 0, 1],
            ]
        ),
        2,
        2,
    ),
}

BUILTIN_GATES = frozenset(GATES)

ALIASES: dict[str, str] = {name.lower(): name for name in GATES if name.lower() != name}
ALIASES["cp"] = "CPHASE"


def register_gate(name: str, matrix, num_qubits: int | None = None, num_params: int = 0,
                  rescale: Callable = None) -> str:
    """Register a custom gate: a fixed unitary or a callable `params ->
    unitary` (`tnqs/gates.py:179`); built-in gates cannot be replaced."""
    if name in BUILTIN_GATES:
        raise ValueError(f"{name!r} is a built-in gate and cannot be overwritten. "
                         "Choose a different name for your custom gate.")
    if not callable(matrix):
        mat = np.asarray(matrix)
        if num_qubits is None:
            num_qubits = int(round(np.log2(mat.shape[0])))
        spec = GateSpec((lambda m: (lambda: m))(mat), num_qubits, 0, rescale)
    else:
        if num_qubits is None:
            raise ValueError("num_qubits required when registering a callable matrix")
        spec = GateSpec(matrix, num_qubits, num_params, rescale)
    GATES[name] = spec
    return name


def register_alias(alias: str, canonical: str) -> str:
    if canonical not in GATES:
        raise ValueError(f"Cannot register alias {alias!r} -> {canonical!r}: canonical gate is not registered. "
                         f"Call register_gate({canonical!r}, ...) first.")
    ALIASES[alias] = canonical
    return alias


def unregister_gate(name: str) -> str:
    if name in BUILTIN_GATES:
        raise ValueError(f"{name!r} is a built-in gate and cannot be unregistered.")
    GATES.pop(name, None)
    for alias, canon in list(ALIASES.items()):
        if canon == name:
            del ALIASES[alias]
    return name


def _is_pauli_string(s: str) -> bool:
    return len(s) > 0 and all(c in "XYZxyz" for c in s)


def gate_matrix(name: str, params=None) -> np.ndarray:
    """The unitary of gate `name` at `params` (`tnqs/gates.py:276`): a Pauli
    string of two or more letters is their Kronecker product; otherwise the
    registry, then its aliases."""
    if _is_pauli_string(name) and len(name) > 1:
        mat = op_matrix(name[0].upper())
        for c in name[1:]:
            mat = np.kron(mat, op_matrix(c.upper()))
        return mat
    spec = GATES.get(name) or GATES.get(ALIASES.get(name, ""))
    if spec is None:
        raise ValueError(f"Unknown gate {name!r}. Registered gates: {sorted(GATES)}.")
    if spec.num_params == 0 and params is None:
        return spec.matrix()
    if params is None:
        raise ValueError(f"gate {name!r} expects {spec.num_params} parameter(s)")
    if spec.rescale is not None:
        params = spec.rescale(params)
    pvals = tuple(params) if isinstance(params, (tuple, list)) else (params,)
    if spec.num_params and len(pvals) != spec.num_params:
        raise ValueError(f"Gate {name!r} expects {spec.num_params} parameter(s), got {len(pvals)}.")
    return spec.matrix(*pvals)


def _collect_vertices(verts, g: NamedGraph) -> list:
    """A gate's vertex spec as a list of graph vertices."""
    if g.has_vertex(verts):
        return [verts]
    if isinstance(verts, (list, tuple)):
        out = list(verts)
        for v in out:
            if not g.has_vertex(v):
                raise ValueError(f"vertex {v!r} not in the tensor-network graph")
        if len(set(map(repr, out))) != len(out):
            raise ValueError("repeated vertex in gate support")
        return out
    raise ValueError(f"cannot interpret gate vertices {verts!r}")


def to_tensor(gate, g: NamedGraph, site_inds: dict, device=None):
    """A circuit entry as ``(Tensor, vertices)`` (`tnqs/gates.py:306`):
    ``(name, vertices[, param])`` tuples become tensors on `device` (the
    CUDA device when None); a ``(Tensor, vertices)`` pair passes through;
    a bare gate Tensor's support is the vertices whose site indices it
    carries."""
    if isinstance(gate, Tensor):
        verts = [v for v, sinds in site_inds.items() if any(gate.hasind(s) for s in sinds)]
        if not verts:
            raise ValueError("gate tensor touches no site index of the network")
        return gate, verts
    if isinstance(gate, tuple) and len(gate) >= 2 and isinstance(gate[0], Tensor):
        return gate[0], list(gate[1])
    name = gate[0]
    verts = _collect_vertices(gate[1], g)
    mat = gate_matrix(name, gate[2] if len(gate) > 2 else None)
    sinds = []
    for v in verts:
        s = site_inds[v]
        if len(s) != 1:
            raise ValueError("circuit gates require exactly one site index per vertex")
        sinds.append(s[0])
    expected = int(np.prod([s.dim for s in sinds]))
    if mat.shape != (expected, expected):
        raise ValueError(f"gate {name!r} has dimension {mat.shape} but acts on sites of total dimension {expected}")
    return from_matrix(mat, [s.prime() for s in sinds], sinds, device=device), verts


def circuit_to_tensors(circuit: Sequence, g: NamedGraph, site_inds: dict, device=None) -> list:
    return [to_tensor(gate, g, site_inds, device=device) for gate in circuit]


def op(name: str, inds, param=None, device=None) -> Tensor:
    """A gate/operator tensor on given site indices (`tnqs/gates.py:353`):
    rows ``[i' for i in inds]``, columns `inds`, on `device` (the CUDA
    device when None)."""
    if isinstance(inds, Index):
        inds = [inds]
    inds = list(inds)
    if name == "I" or (len(name) == len(inds) and _is_pauli_string(name) and len(name) > 1):
        mat = gate_matrix(name) if name != "I" else np.eye(int(np.prod([i.dim for i in inds])))
    else:
        mat = gate_matrix(name, param)
    return from_matrix(mat, [i.prime() for i in inds], inds, device=device)
