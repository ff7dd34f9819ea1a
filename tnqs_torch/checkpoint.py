"""Checkpoints of states, BP caches and engines in the JAX package's npz
layout (port of `tnqs/checkpoint.py`), read and written both ways.

`save_state` / `load_state` and `save_bp_cache` / `load_bp_cache`
(`tnqs/checkpoint.py:110-207`): the JSON header holds the graph, each
tensor's index descriptors ``[id, dim, tag, plev]`` (and the site indices,
and the message edges and their indices), the arrays ``t{n}`` (vertex
order) and ``m{n}``; indices with one saved id come back as one `Index`,
so a restored cache contracts like the original.  The engine's
(`:210-266`, `save_engine`, `load_engine`):  A checkpoint is one ``.npz``: a JSON header in the uint8
array ``__meta__`` (version, the graph's vertices and edges in insertion
order, chi, d, dtype, the degree buckets, the BP schedule and the factor
method), the packed buckets ``b{k}`` [n_k, d, chi^k] and the messages ``M``
[2E, chi, chi].  The port adds its switches to the header (`env_gauge`,
`reduce_method`, `trunc_method`, `svd_impl`, `bp_kernel`, `bp_precision`,
`site_legs`); the JAX package ignores keys it does not know, so a port
checkpoint at d = 2 loads in `tnqs.load_engine`, and a JAX checkpoint loads
here with the options the JAX engine resolves (``env_gauge="eigh"`` on the
direct path, `tnqs/engine.py:609`; the port's defaults otherwise).  The
plan is rebuilt from the saved graph under the saved schedule, since
another schedule orders the buckets and edge ids otherwise (the shapes
would still match), and the arrays are loaded verbatim.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from .graphs import NamedGraph
from .networks import IndexTable, index_desc

_VERSION = 1
_DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}
# the port's switches and site legs, saved beside the JAX package's keys
_PORT_KEYS = ("env_gauge", "reduce_method", "trunc_method", "svd_impl", "bp_kernel", "bp_precision", "site_legs")


def _enc_vertex(v):
    if isinstance(v, tuple):
        return {"__t__": [_enc_vertex(x) for x in v]}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"cannot serialize vertex of type {type(v)!r}")


def _dec_vertex(o):
    if isinstance(o, dict) and "__t__" in o:
        return tuple(_dec_vertex(x) for x in o["__t__"])
    return o


def _enc_graph(g: NamedGraph) -> dict:
    return {
        "vertices": [_enc_vertex(v) for v in g.vertices()],
        "edges": [[_enc_vertex(u), _enc_vertex(v)] for (u, v) in g.edges()],
    }


def _dec_graph(d) -> NamedGraph:
    g = NamedGraph(_dec_vertex(v) for v in d["vertices"])
    for u, v in d["edges"]:
        g.add_edge(_dec_vertex(u), _dec_vertex(v))
    return g


def _write_npz(path, header: dict, arrays: dict) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, __meta__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8), **arrays)


def _read_npz(path):
    data = np.load(path, allow_pickle=False)
    header = json.loads(bytes(data["__meta__"].tobytes()).decode())
    if header.get("version", 0) > _VERSION:
        raise ValueError(f"checkpoint version {header['version']} is newer than supported {_VERSION}")
    return header, data


def save_state(psi, path) -> None:
    """Save a TensorNetwork / TensorNetworkState (arrays copied to the host)."""
    verts = psi.vertices()
    header = {
        "version": _VERSION,
        "kind": type(psi).__name__,
        "graph": _enc_graph(psi.graph),
        "tensor_inds": [[index_desc(i) for i in psi[v].inds] for v in verts],
    }
    site_inds = getattr(psi, "site_inds", None)
    if site_inds is not None:
        header["site_inds"] = [[index_desc(i) for i in site_inds[v]] for v in verts]
    _write_npz(path, header, {f"t{n}": psi[v].to_numpy() for n, v in enumerate(verts)})


def _load_network(header, data, table, device):
    from .core.tensor import Tensor, resolve_device
    from .networks import TensorNetwork, TensorNetworkState

    device = resolve_device(device)
    g = _dec_graph(header["graph"])
    verts = g.vertices()
    tensors = {v: Tensor(data[f"t{n}"], [table.resolve(d) for d in header["tensor_inds"][n]], device=device)
               for n, v in enumerate(verts)}
    if header.get("network_kind", header["kind"]) == "TensorNetwork":
        return TensorNetwork(tensors, g)
    site_inds = None
    if "site_inds" in header:
        site_inds = {v: [table.resolve(d) for d in header["site_inds"][n]] for n, v in enumerate(verts)}
    return TensorNetworkState(tensors, g, site_inds)


def load_state(path, device=None):
    """A state saved by `save_state` here or in the JAX package, on the
    CUDA device unless `device` names another."""
    header, data = _read_npz(path)
    return _load_network(header, data, IndexTable(), device)


def save_bp_cache(bpc, path) -> None:
    """Save a BeliefPropagationCache: its network and every stored message,
    bond identity shared between the two."""
    psi = bpc.network
    verts = psi.vertices()
    msg_edges = list(bpc.messages.keys())
    header = {
        "version": _VERSION,
        "kind": "BeliefPropagationCache",
        "network_kind": type(psi).__name__,
        "graph": _enc_graph(psi.graph),
        "tensor_inds": [[index_desc(i) for i in psi[v].inds] for v in verts],
        "message_edges": [[_enc_vertex(u), _enc_vertex(v)] for (u, v) in msg_edges],
        "message_inds": [[index_desc(i) for i in bpc.messages[e].inds] for e in msg_edges],
    }
    site_inds = getattr(psi, "site_inds", None)
    if site_inds is not None:
        header["site_inds"] = [[index_desc(i) for i in site_inds[v]] for v in verts]
    arrays = {f"t{n}": psi[v].to_numpy() for n, v in enumerate(verts)}
    for n, e in enumerate(msg_edges):
        arrays[f"m{n}"] = bpc.messages[e].to_numpy()
    _write_npz(path, header, arrays)


def load_bp_cache(path, device=None):
    """A cache saved by `save_bp_cache` here or in the JAX package, on the
    CUDA device unless `device` names another."""
    from .bp import BeliefPropagationCache
    from .core.tensor import Tensor

    header, data = _read_npz(path)
    table = IndexTable()
    psi = _load_network(header, data, table, device)
    messages = {}
    for n, (eu, ev) in enumerate(header["message_edges"]):
        inds = [table.resolve(d) for d in header["message_inds"][n]]
        messages[(_dec_vertex(eu), _dec_vertex(ev))] = Tensor(data[f"m{n}"], inds, device=psi.device)
    return BeliefPropagationCache(psi, messages)


def save_engine(eng, path) -> None:
    """Save a `LatticeEngine` mid-evolution: its graph, packing layout,
    options, packed buckets and messages (copied to the host)."""
    header = {
        "version": _VERSION,
        "kind": "LatticeEngine",
        "graph": _enc_graph(eng.plan.graph),
        "chi": eng.chi,
        "d": eng.d,
        "dtype": str(eng.dtype).removeprefix("torch."),
        "buckets": sorted(int(k) for k in eng.T),
        "bp_schedule": eng.plan.bp_schedule,
        "factor_method": eng.factor_method,
        **{key: getattr(eng, key) for key in _PORT_KEYS},
    }
    arrays = {f"b{k}": arr.cpu().numpy() for k, arr in eng.T.items()}
    arrays["M"] = eng.M.cpu().numpy()
    _write_npz(path, header, arrays)


def load_engine(path, device=None):
    """Restore a `LatticeEngine` saved by `save_engine` here or in the JAX
    package, on the CUDA device unless `device` names another, with the
    saved options (``bp_kernel="kernel"`` restored on the CPU runs the
    kernel's plain version, as such an engine does there)."""
    from .engine import LatticeEngine

    header, data = _read_npz(path)
    if header.get("kind", "LatticeEngine") != "LatticeEngine":
        raise ValueError(f"{path} holds a {header['kind']}, not a LatticeEngine")
    if header["dtype"] not in _DTYPES:
        raise ValueError(f"unsupported dtype {header['dtype']!r}")
    factor_method = header.get("factor_method", "direct")
    site_legs = int(header.get("site_legs", 1))
    d = int(header["d"])
    d0 = round(d ** (1.0 / site_legs))
    if d0**site_legs != d:
        raise ValueError(f"d = {d} is not a power of {site_legs} legs")
    options = {
        "env_gauge": "eigh" if factor_method == "direct" else "cholesky",
        **{key: header[key] for key in _PORT_KEYS if key in header},
        "site_legs": site_legs,
        "d0": d0,
    }
    eng = LatticeEngine(
        _dec_graph(header["graph"]),
        chi=int(header["chi"]),
        dtype=_DTYPES[header["dtype"]],
        device=device,
        bp_schedule=header.get("bp_schedule", "wavefront"),
        factor_method=factor_method,
        **options,
    )
    for k in header["buckets"]:
        saved = data[f"b{k}"]
        if tuple(eng.T[k].shape) != saved.shape:
            raise ValueError(f"bucket {k} shape mismatch: saved {saved.shape}, rebuilt {tuple(eng.T[k].shape)}")
        eng.T[k] = torch.as_tensor(saved, device=eng.device)
    if tuple(eng.M.shape) != data["M"].shape:
        raise ValueError(f"messages shape mismatch: saved {data['M'].shape}, rebuilt {tuple(eng.M.shape)}")
    eng.M = torch.as_tensor(data["M"], device=eng.device)
    return eng
