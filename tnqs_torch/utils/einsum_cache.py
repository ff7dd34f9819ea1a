"""Contraction paths for multi-operand einsums, searched once and memoized.

Port of `tnqs/utils/einsum_cache.py` (`ceinsum`, `:31`).  The JAX module asks
opt_einsum for the optimal pairwise order once per (expression, shapes) and
hands it to `jnp.einsum`.  The port cannot count on opt_einsum, and without
it `torch.einsum` contracts a multi-operand expression left to right, which
at chi = 64 builds the rank^2 chi^4 intermediates the boundary-MPS code is
written to avoid (`tnqs/bmps_engine.py:766-787`).  So `contract_path`
searches every pairwise order itself: the boundary-MPS expressions have at
most five operands, 180 orders.  It minimizes opt_einsum's FLOP count (the
product of the sizes of every index a pairwise step touches, doubled when
the step sums an index away) and breaks ties by the largest intermediate.
Past `EXHAUSTIVE_MAX` operands (the loop-series weights of non-cycle
configurations, one operand per vertex and per edge) it builds the path
greedily instead: each step contracts the pair whose product is smallest,
then the cheapest.  `ceinsum` runs the memoized path as pairwise
`torch.einsum` calls.
"""

from __future__ import annotations

import math

import torch

_PATH_CACHE: dict = {}
EXHAUSTIVE_MAX = 6  # operands; 2700 pairwise orders at 6


def _parse(expr: str) -> tuple[list[str], str]:
    inputs, output = expr.replace(" ", "").split("->")
    return inputs.split(","), output


def contract_path(expr: str, shapes) -> tuple[list, int, int]:
    """The cheapest pairwise order for `expr` on operands of `shapes`:
    (path, FLOPs, largest intermediate in elements).  `path` follows
    opt_einsum's convention: each step names two positions in the current
    operand list, which leave it, and their product joins its end."""
    inputs, output = _parse(expr)
    sizes = {}
    for term, shape in zip(inputs, shapes):
        if len(term) != len(shape):
            raise ValueError(f"{expr}: operand {term!r} has shape {tuple(shape)}")
        for c, x in zip(term, shape):
            if sizes.setdefault(c, int(x)) != int(x):
                raise ValueError(f"{expr}: index {c!r} has sizes {sizes[c]} and {int(x)}")
    best = [None]  # (flops, peak, path)

    def step_cost(terms, i, j):
        rest = [t for k, t in enumerate(terms) if k not in (i, j)]
        keep = set(output).union(*rest)
        union = "".join(dict.fromkeys(terms[i] + terms[j]))
        new = "".join(c for c in union if c in keep)
        cost = math.prod(sizes[c] for c in union) * (2 if len(new) < len(union) else 1)
        return rest, new, cost

    if len(inputs) > EXHAUSTIVE_MAX:
        terms, flops, peak, path = list(inputs), 0, 0, []
        while len(terms) > 1:
            pairs = [(i, j) for i in range(len(terms)) for j in range(i + 1, len(terms))]
            shared = [(i, j) for i, j in pairs if set(terms[i]) & set(terms[j])] or pairs
            scored = []
            for i, j in shared:
                rest, new, cost = step_cost(terms, i, j)
                scored.append((math.prod(sizes[c] for c in new), cost, (i, j), rest, new))
            size, cost, ij, rest, new = min(scored, key=lambda x: x[:3])
            terms, flops, peak, path = rest + [new], flops + cost, max(peak, size), path + [ij]
        return path, flops, peak

    def search(terms, flops, peak, path):
        if best[0] is not None and flops > best[0][0]:
            return
        if len(terms) == 1:
            if best[0] is None or (flops, peak) < best[0][:2]:
                best[0] = (flops, peak, path)
            return
        for i in range(len(terms)):
            for j in range(i + 1, len(terms)):
                rest, new, cost = step_cost(terms, i, j)
                search(rest + [new], flops + cost, max(peak, math.prod(sizes[c] for c in new)), path + [(i, j)])

    search(list(inputs), 0, 0, [])
    return best[0][2], best[0][0], best[0][1]


def _steps(expr: str, shapes) -> list:
    """The memoized path of `expr` at `shapes` as pairwise einsum steps
    (i, j, "ab,bc->ac"); the last step writes the output's index order."""
    key = (expr, shapes)
    steps = _PATH_CACHE.get(key)
    if steps is None:
        inputs, output = _parse(expr)
        path, _, _ = contract_path(expr, shapes)
        terms, steps = list(inputs), []
        for n, (i, j) in enumerate(path):
            a, b = terms[i], terms[j]
            rest = [t for k, t in enumerate(terms) if k not in (i, j)]
            if n == len(path) - 1:
                new = output
            else:
                keep = set(output).union(*rest)
                new = "".join(c for c in dict.fromkeys(a + b) if c in keep)
            steps.append((i, j, f"{a},{b}->{new}"))
            terms = rest + [new]
        _PATH_CACHE[key] = steps
    return steps


def ceinsum(expr: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(expr, *ops)` contracted pairwise along the memoized
    cheapest path (`contract_path`)."""
    if len(ops) <= 2:
        return torch.einsum(expr, *ops)
    ops = list(ops)
    for i, j, sub in _steps(expr, tuple(tuple(o.shape) for o in ops)):
        a, b = ops[i], ops[j]
        ops = [o for k, o in enumerate(ops) if k not in (i, j)] + [torch.einsum(sub, a, b)]
    return ops[0]
