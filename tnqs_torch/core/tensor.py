"""Named-index dense tensors over `torch.Tensor` (port of
`tnqs/core/tensor.py`).

A :class:`Tensor` is a pair ``(data, inds)``: ``data`` a `torch.Tensor` on
one device, ``inds`` a tuple of :class:`Index`.  Two tensors contract over
every index they share, by `torch.einsum` with the JAX package's letter
assignment (at most 52 distinct indices in one pairwise contraction).
Host input (numpy arrays, Python numbers) is copied to the device the
caller names, and with none named to the CUDA device, which raises where
there is no card.  Queries that return a Python number (`item`, `norm`,
`sum_elements`, `dot`) read the device; the rest stays on it.
"""

from __future__ import annotations

import string
from typing import Iterable, Sequence

import numpy as np
import torch

from .index import Index

_LETTERS = string.ascii_letters


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when None (raising without a card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the flex tier runs on the CUDA device and none is available; "
                               "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or a numpy scalar type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def real_dtype_of(dtype) -> torch.dtype:
    dt = as_torch_dtype(dtype)
    return dt.to_real() if dt.is_complex else dt


def _host_scalar(x):
    return x.item() if isinstance(x, np.generic) else x


class Tensor:
    """A dense tensor with named indices; ``data.shape[k] == inds[k].dim``."""

    __slots__ = ("data", "inds")
    # numpy scalars on the left defer to our __rmul__
    __array_priority__ = 1000
    __array_ufunc__ = None

    def __init__(self, data, inds: Sequence[Index], device=None):
        inds = tuple(inds)
        if not isinstance(data, torch.Tensor):
            data = torch.tensor(np.asarray(data), device=resolve_device(device))
        elif device is not None:
            data = data.to(device)
        if tuple(data.shape) != tuple(i.dim for i in inds):
            raise ValueError(f"shape mismatch: data {tuple(data.shape)} vs inds {tuple(i.dim for i in inds)}")
        if len(set(inds)) != len(inds):
            raise ValueError(f"duplicate indices in tensor: {inds}")
        self.data = data
        self.inds = inds

    # -- basic queries ------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.inds)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self):
        return f"Tensor{list(self.inds)}<{self.data.dtype}>"

    def copy(self) -> "Tensor":
        return Tensor(self.data, self.inds)

    def axis(self, ind: Index) -> int:
        for k, i in enumerate(self.inds):
            if i == ind:
                return k
        raise KeyError(f"index {ind} not in tensor {self.inds}")

    def hasind(self, ind: Index) -> bool:
        return any(i == ind for i in self.inds)

    def scalar(self) -> torch.Tensor:
        if self.ndim != 0:
            raise ValueError(f"tensor is not a scalar: {self.inds}")
        return self.data.reshape(())

    def item(self):
        s = self.scalar().item()
        return complex(s) if self.data.is_complex() else float(s)

    # -- index manipulation (new Tensors; data shared) -----------------------
    def replaceinds(self, old: Sequence[Index], new: Sequence[Index]) -> "Tensor":
        old, new = list(old), list(new)
        if len(old) != len(new):
            raise ValueError("replaceinds: length mismatch")
        mapping = {o: n for o, n in zip(old, new)}
        out = []
        for i in self.inds:
            j = mapping.get(i, i)
            if j is not i and j.dim != i.dim:
                raise ValueError(f"replaceinds: dim mismatch {i} -> {j}")
            out.append(j)
        return Tensor(self.data, out)

    def replaceind(self, old: Index, new: Index) -> "Tensor":
        return self.replaceinds([old], [new])

    def prime(self, n: int = 1, only: Iterable[Index] | None = None) -> "Tensor":
        if only is None:
            return Tensor(self.data, [i.prime(n) for i in self.inds])
        only = set(only)
        return Tensor(self.data, [i.prime(n) if i in only else i for i in self.inds])

    def noprime(self) -> "Tensor":
        new = [i.noprime() for i in self.inds]
        if len(set(new)) != len(new):
            raise ValueError("noprime would create duplicate indices")
        return Tensor(self.data, new)

    def dag(self) -> "Tensor":
        d = self.data
        return Tensor(torch.conj_physical(d) if d.is_complex() else d, self.inds)

    def permute(self, inds: Sequence[Index]) -> "Tensor":
        inds = list(inds)
        if len(inds) != self.ndim:
            raise ValueError("permute: wrong number of indices")
        return Tensor(self.data.permute([self.axis(i) for i in inds]), inds)

    # -- arithmetic ---------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Tensor):
            return contract_pair(self, other)
        return Tensor(self.data * _host_scalar(other), self.inds)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Tensor):
            raise TypeError("use contraction for tensors")
        return Tensor(self.data / _host_scalar(other), self.inds)

    def __neg__(self):
        return Tensor(-self.data, self.inds)

    def __add__(self, other: "Tensor"):
        other = other.permute(self.inds) if other.inds != self.inds else other
        if set(other.inds) != set(self.inds):
            raise ValueError("tensor addition requires identical index sets")
        return Tensor(self.data + other.data, self.inds)

    def __sub__(self, other: "Tensor"):
        return self + (-other)

    # -- norms etc. -----------------------------------------------------------
    def norm_t(self) -> torch.Tensor:
        """The Frobenius norm as a 0-d real tensor on the device."""
        return torch.linalg.vector_norm(self.data.reshape(-1))

    def norm(self) -> float:
        return float(self.norm_t())

    def normalize(self) -> "Tensor":
        """`self / norm`, or `self` where the norm is 0, without a host read."""
        n = self.norm_t()
        return Tensor(torch.where(n == 0, self.data, self.data / n), self.inds)

    def sum_t(self) -> torch.Tensor:
        return self.data.sum()

    def sum_elements(self):
        s = self.sum_t().item()
        return complex(s) if self.data.is_complex() else float(s)

    def dot_t(self, other: "Tensor") -> torch.Tensor:
        """Frobenius inner product sum conj(self) * other, on the device."""
        o = other.permute(self.inds)
        a = self.data
        return (torch.conj_physical(a) if a.is_complex() else a).mul(o.data).sum()

    def dot(self, other: "Tensor"):
        return complex(self.dot_t(other).item())

    def trace_pairs(self) -> "Tensor":
        """Contract every (i, i') pair of unprimed/primed indices."""
        t = self
        while True:
            pair = next((i for i in t.inds if i.plev == 0 and t.hasind(i.prime())), None)
            if pair is None:
                return t
            a1, a2 = t.axis(pair), t.axis(pair.prime())
            data = torch.diagonal(t.data, dim1=a1, dim2=a2).sum(-1)
            t = Tensor(data, [j for j in t.inds if j != pair and j != pair.prime()])

    def matricize(self, row_inds: Sequence[Index], col_inds: Sequence[Index] | None = None) -> torch.Tensor:
        """A 2D tensor grouping `row_inds` / `col_inds`."""
        row_inds = list(row_inds)
        if col_inds is None:
            col_inds = [i for i in self.inds if i not in row_inds]
        col_inds = list(col_inds)
        t = self.permute(row_inds + col_inds)
        r = int(np.prod([i.dim for i in row_inds], dtype=np.int64)) if row_inds else 1
        c = int(np.prod([i.dim for i in col_inds], dtype=np.int64)) if col_inds else 1
        return t.data.reshape(r, c)

    def array(self) -> torch.Tensor:
        return self.data

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().resolve_conj().cpu().numpy()

    # -- dtype / device -------------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        """Cast to `dtype`; complex data stays complex (of `dtype`'s
        precision), as the JAX package's `astype`."""
        dtype = as_torch_dtype(dtype)
        if self.data.is_complex() and not dtype.is_complex:
            dtype = torch.complex64 if dtype.itemsize <= 4 else torch.complex128
        return Tensor(self.data.to(dtype), self.inds)

    def to(self, device) -> "Tensor":
        return Tensor(self.data.to(device), self.inds)


# ----------------------------------------------------------------------
# constructors (host-built, then copied to `device`)
# ----------------------------------------------------------------------

def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.zeros(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def from_matrix(mat, row_inds: Sequence[Index], col_inds: Sequence[Index], device=None) -> Tensor:
    row_inds, col_inds = list(row_inds), list(col_inds)
    dims = [i.dim for i in row_inds] + [i.dim for i in col_inds]
    if not isinstance(mat, torch.Tensor):
        mat = torch.tensor(np.asarray(mat), device=resolve_device(device))
    elif device is not None:
        mat = mat.to(device)
    return Tensor(mat.reshape(dims), row_inds + col_inds)


def delta(inds: Sequence[Index], dtype=np.float64, device=None) -> Tensor:
    """Generalized Kronecker delta: 1 where all positions are equal."""
    inds = list(inds)
    dt = _np_dtype(dtype)
    if not inds:
        return Tensor(np.asarray(1.0, dtype=dt), [], device=device)
    dims = [i.dim for i in inds]
    data = np.zeros(dims, dtype=dt)
    for k in range(min(dims)):
        data[(k,) * len(dims)] = 1.0
    return Tensor(data, inds, device=device)


def identity_tensor(row_inds: Sequence[Index], col_inds: Sequence[Index], dtype=np.float64, device=None) -> Tensor:
    """Identity between the combined row space and combined column space."""
    r = int(np.prod([i.dim for i in row_inds], dtype=np.int64))
    c = int(np.prod([i.dim for i in col_inds], dtype=np.int64))
    return from_matrix(np.eye(r, c, dtype=_np_dtype(dtype)), row_inds, col_inds, device=device)


def onehot(ind: Index, k: int, dtype=np.float64, device=None) -> Tensor:
    data = np.zeros(ind.dim, dtype=_np_dtype(dtype))
    data[k] = 1.0
    return Tensor(data, [ind], device=device)


def random_tensor(inds: Sequence[Index], dtype=np.float64, rng=None, device=None) -> Tensor:
    """Gaussian entries drawn from the numpy Generator `rng` in the JAX
    package's order (real part, then imaginary part), then copied over."""
    rng = np.random.default_rng() if rng is None else rng
    inds = list(inds)
    dims = [i.dim for i in inds]
    dt = _np_dtype(dtype)
    if np.issubdtype(dt, np.complexfloating):
        data = rng.standard_normal(dims) + 1j * rng.standard_normal(dims)
    else:
        data = rng.standard_normal(dims)
    return Tensor(data.astype(dt), inds, device=device)


# ----------------------------------------------------------------------
# contraction
# ----------------------------------------------------------------------

def contract_pair(a: Tensor, b: Tensor) -> Tensor:
    """Contract two tensors over all shared indices (einsum by identity)."""
    a_only = [i for i in a.inds if not b.hasind(i)]
    b_only = [i for i in b.inds if not a.hasind(i)]
    labels: dict[Index, str] = {}

    def lab(i: Index) -> str:
        if i not in labels:
            if len(labels) == len(_LETTERS):
                raise ValueError(f"contract_pair: more than {len(_LETTERS)} distinct indices")
            labels[i] = _LETTERS[len(labels)]
        return labels[i]

    sub_a = "".join(lab(i) for i in a.inds)
    sub_b = "".join(lab(i) for i in b.inds)
    out_inds = a_only + b_only
    sub_o = "".join(labels[i] for i in out_inds)
    dt = torch.promote_types(a.data.dtype, b.data.dtype)
    data = torch.einsum(f"{sub_a},{sub_b}->{sub_o}", a.data.to(dt), b.data.to(dt))
    return Tensor(data, out_inds)


def contract(tensors: Sequence[Tensor], sequence=None) -> Tensor:
    """Contract a list of tensors, optionally along a nested sequence of
    1-based leaf positions (e.g. ``[[1, 3], 2]``); else left to right."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("cannot contract empty tensor list")
    if sequence is None:
        out = tensors[0]
        for t in tensors[1:]:
            out = contract_pair(out, t)
        return out

    def run(node):
        if isinstance(node, (int, np.integer)):
            return tensors[int(node) - 1]
        parts = [run(child) for child in node]
        out = parts[0]
        for p in parts[1:]:
            out = contract_pair(out, p)
        return out

    return run(sequence)


# ----------------------------------------------------------------------
# index-set algebra
# ----------------------------------------------------------------------

def commoninds(a: Tensor, b: Tensor) -> list[Index]:
    return [i for i in a.inds if b.hasind(i)]


def uniqueinds(a: Tensor, *others: Tensor) -> list[Index]:
    out = list(a.inds)
    for b in others:
        out = [i for i in out if not b.hasind(i)]
    return out


def hascommoninds(a: Tensor, b: Tensor) -> bool:
    return len(commoninds(a, b)) > 0


def directsum(a: Tensor, a_inds: Sequence[Index], b: Tensor, b_inds: Sequence[Index],
              new_inds: Sequence[Index]) -> Tensor:
    """Direct sum of `a` and `b` along the paired indices; the other indices
    must match."""
    a_inds, b_inds, new_inds = list(a_inds), list(b_inds), list(new_inds)
    shared = [i for i in a.inds if i not in a_inds]
    if set(shared) != set(i for i in b.inds if i not in b_inds):
        raise ValueError("directsum: non-summed indices must match")
    a_p = a.permute(a_inds + shared)
    b_p = b.permute(b_inds + shared)
    dt = torch.promote_types(a.dtype, b.dtype)
    data = torch.zeros([ni.dim for ni in new_inds] + [i.dim for i in shared], dtype=dt, device=a.device)
    sl_a = tuple(slice(0, i.dim) for i in a_inds)
    sl_b = tuple(slice(i.dim, i.dim + j.dim) for i, j in zip(a_inds, b_inds))
    data[sl_a] += a_p.data.to(dt)
    data[sl_b] += b_p.data.to(dt)
    return Tensor(data, new_inds + shared)
