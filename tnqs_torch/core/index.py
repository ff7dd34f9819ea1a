"""Named tensor indices (port of `tnqs/core/index.py`).

An :class:`Index` labels one tensor axis: a unique ``id`` (from the port's
own counter), a dimension, a tag and a prime level.  Two indices contract
with each other iff they compare equal (same ``id`` and prime level).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

_ID_COUNTER = itertools.count(1)


def _next_id() -> int:
    return next(_ID_COUNTER)


@dataclass(frozen=True)
class Index:
    """An immutable named tensor index; identity is ``(id, plev)``."""

    dim: int
    tag: str = ""
    plev: int = 0
    id: int = field(default_factory=_next_id)

    def __eq__(self, other):
        if not isinstance(other, Index):
            return NotImplemented
        return self.id == other.id and self.plev == other.plev

    def __hash__(self):
        return hash((self.id, self.plev))

    def prime(self, n: int = 1) -> "Index":
        return replace(self, plev=self.plev + n)

    def noprime(self) -> "Index":
        return replace(self, plev=0)

    def setprime(self, n: int) -> "Index":
        return replace(self, plev=n)

    def sim(self) -> "Index":
        """A fresh index with the same dim/tag/plev but a new identity."""
        return Index(dim=self.dim, tag=self.tag, plev=self.plev)

    def with_tag(self, tag: str) -> "Index":
        return replace(self, tag=tag)

    def __repr__(self):
        p = "'" * self.plev if self.plev <= 3 else f"'^{self.plev}"
        t = f"|{self.tag}" if self.tag else ""
        return f"(dim={self.dim}{t}|id={self.id % 100000}){p}"


def prime(i: Index, n: int = 1) -> Index:
    return i.prime(n)


def noprime(i: Index) -> Index:
    return i.noprime()


def sim(i: Index) -> Index:
    return i.sim()
