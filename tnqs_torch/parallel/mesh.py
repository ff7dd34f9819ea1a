"""The 1-D device mesh on `torch.distributed`, its collectives, and the
row-sharded engine (port of `tnqs/parallel/mesh.py`).

The JAX package builds one program over a `jax.sharding.Mesh` and lets
`shard_map` and XLA place the collectives.  Here every rank is a Python
process of its own, holding one device (``cuda:<local rank>`` over NCCL, or
the CPU over gloo for the tests), and the collectives the JAX code gets from
XLA are written once in this module:

- `ppermute`: each rank sends its buffer along a permutation of the ranks
  (`dist.batch_isend_irecv` pairs); a rank no pair sends to receives zeros,
  as `jax.lax.ppermute`.  Its backward sends the gradient along the inverse
  permutation.
- `psum` / `pmin`: `all_reduce`, replicated results.
- `to_bands`: replicated -> band.  The identity forward; its backward
  `all_reduce`s the gradient, so each band's part of a gradient reaches
  every rank.
- `gather_bands`: band -> replicated, every rank's tensor stacked
  ([D, ...], `all_gather`).  Its backward keeps the local band's slice and
  sums nothing: every rank computes the identical replicated function of
  the gathered value, so a sum would count that function D times.

Complex tensors travel as their real views (NCCL has no complex type).

`ShardedEngine` is the data-parallel layout of the JAX module: each rank
keeps its rows of the padded ``T[k]`` and ``M`` (`_pad_rows`, rows
``[r n/D, (r+1) n/D)``) between steps.  What a step exchanges: one
`all_gather` of every ``T[k]`` and of ``M`` (the shards to the replicated
state), after which every rank runs the engine's own layer step on the
whole state, with the same kernels on the same values, so every rank holds
the same new state and keeps its rows of it; the truncation errors are
replicated.  So the step's work is replicated, not divided: the class
shards the state it keeps between steps, and a step costs every rank the
unsharded step plus the gather.  A departure by design from the JAX class,
whose step XLA partitions (the batched factorizations included); the
port's program that divides a layer's work over the ranks is
`HaloStepEngine`.  `freenergy` gathers ``M`` (a vertex reads the messages into it
from other ranks' rows), sums the logs of its own rows' vertex scalars and
of the edge scalars whose forward message it holds, and reduces the two
real sums and the smallest edge scalar with `all_reduce`.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..ops.bp_sweep import absorb_message


class Mesh:
    """The 1-D mesh of the whole `torch.distributed` world: `size` ranks,
    this process being `rank`, each on `device`, under `backend` ("nccl" or
    "gloo").  ``axis_names`` as a JAX mesh's."""

    def __init__(self, axis: str, device: torch.device, backend: str):
        self.axis_names = (axis,)
        self.device = device
        self.backend = backend
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()

    def __repr__(self):
        return f"Mesh(size={self.size}, rank={self.rank}, device={self.device}, backend={self.backend!r})"


def make_mesh(n_devices: int | None = None, axis: str = "d", device=None) -> Mesh:
    """The mesh of the `torch.distributed` world, one rank a device.

    By default NCCL on ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank
    modulo the visible cards); ``device="cpu"`` takes gloo.  Raises when no
    card is there and the caller did not ask for the CPU (there is no CPU
    fallback), and when the world has not `n_devices` ranks.  A process
    group already set up (`init_process_group`, as a launcher or a test pool
    does) must be of the matching backend; without one, it is set up from
    torchrun's environment (``env://``)."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: the mesh runs on CUDA devices and none is available; "
                           "pass device='cpu' for a gloo mesh on the CPU")
    backend = "gloo" if cpu else "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    if dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group runs {dist.get_backend()!r}, a "
                           f"{'CPU' if cpu else 'CUDA'} mesh needs {backend!r}")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the world has {world} ranks "
                         "(one rank a device)")
    if cpu:
        return Mesh(axis, torch.device("cpu"), backend)
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    torch.cuda.set_device(dev)
    return Mesh(axis, dev, backend)


def init_ranks(rank: int, world_size: int, port: int, device: str = "cpu", timeout_s: float = 120.0) -> None:
    """Set up this process's `torch.distributed` group over TCP on the
    local host: gloo for ``device="cpu"``, NCCL otherwise.  Collectives
    that wait longer than `timeout_s` raise instead of hanging."""
    dist.init_process_group("gloo" if device == "cpu" else "nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world_size, timeout=timedelta(seconds=timeout_s))


# ----------------------------------------------------------------------
# collectives (the JAX code's `shard_map` / XLA ones)
# ----------------------------------------------------------------------

def _wire(x: torch.Tensor) -> torch.Tensor:
    """The tensor as the collectives carry it: contiguous, complex as real."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _ppermute(x: torch.Tensor, perm, mesh: Mesh) -> torch.Tensor:
    out = x.new_zeros(x.shape)  # contiguous, so its real view is the buffer itself
    ops = []
    for src, dst in perm:
        if src == mesh.rank:
            ops.append(dist.P2POp(dist.isend, _wire(x), dst))
        if dst == mesh.rank:
            ops.append(dist.P2POp(dist.irecv, _wire(out), src))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, mesh):
        ctx.perm, ctx.mesh = perm, mesh
        return _ppermute(x, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, [(dst, src) for src, dst in ctx.perm], ctx.mesh), None, None


def ppermute(x: torch.Tensor, mesh: Mesh, perm) -> torch.Tensor:
    """`jax.lax.ppermute`: rank src's `x` lands on rank dst for each (src,
    dst) of `perm`; zeros where no pair lands.  Every rank passes a tensor
    of the same shape and the same `perm`.  Differentiable."""
    perm = [(int(s), int(d)) for s, d in perm]
    return _PPermute.apply(x, perm, mesh)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks, on every rank (not differentiable)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_wire(out), op=dist.ReduceOp.SUM)
    return out


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise minimum of a real `x` over the ranks, on every rank."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MIN)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[D, ...]: every rank's `x` (same shape on every rank), stacked in rank
    order, on every rank (not differentiable; see `gather_bands`)."""
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w)
    out = torch.stack(parts)
    return torch.view_as_complex(out) if x.is_complex() else out


class _ToBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh), None


def to_bands(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Replicated -> band: `x` itself, through which each rank takes its band
    (an indexing after this call).  The backward sums the bands' gradients
    over the ranks (`all_reduce`), so every rank holds all of it."""
    return _ToBands.apply(x, mesh)


class _GatherBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.rank].contiguous(), None


def gather_bands(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Band -> replicated: [D, ...], every rank's `x` in rank order.  The
    backward keeps this rank's slice of the gradient, unsummed: every rank
    computes the same replicated function of the result."""
    return _GatherBands.apply(x, mesh)


# ----------------------------------------------------------------------
# the row-sharded engine
# ----------------------------------------------------------------------

def _pad_rows(arr: torch.Tensor, multiple: int) -> torch.Tensor:
    """`arr` zero-padded along its leading axis to a multiple of `multiple`."""
    pad = (-arr.shape[0]) % multiple
    if pad == 0:
        return arr
    return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])


class ShardedEngine:
    """A `LatticeEngine`'s state sharded by rows over a mesh: rank r holds
    rows ``[r n/D, (r+1) n/D)`` of every padded ``T[k]`` and of the padded
    messages (`T`, `M`: per band).  Every rank passes the same engine (the
    same graph, options and state); `errors`, `freenergy` and
    `partitionfunction` are replicated.  A step runs the whole unsharded
    step on every rank (no scale-out of the work; `HaloStepEngine` divides
    it); the module docstring says what it exchanges."""

    def __init__(self, engine, mesh: Mesh):
        self.engine = engine
        self.mesh = mesh
        self._n = mesh.size
        self._m_rows = engine.M.shape[0]
        self._t_rows = {k: arr.shape[0] for k, arr in engine.T.items()}
        self.M = self._own(_pad_rows(engine.M, self._n))
        self.T = {k: self._own(_pad_rows(arr, self._n)) for k, arr in engine.T.items()}

    def _own(self, padded: torch.Tensor) -> torch.Tensor:
        per = padded.shape[0] // self._n
        return padded[self.mesh.rank * per:(self.mesh.rank + 1) * per].clone()

    def _whole(self, shard: torch.Tensor, rows: int) -> torch.Tensor:
        g = all_gather(shard, self.mesh)
        return g.reshape((-1,) + tuple(shard.shape[1:]))[:rows]

    def make_step(self, circuit, **kwargs):
        """``step(T, M) -> (T, M, errors)`` on the shards: gather them, run
        the engine's layer step (`LatticeEngine.make_step` with `kwargs`) on
        the whole state, keep this rank's rows."""
        inner = self.engine.make_step(circuit, **kwargs)

        def step(T, M):
            Tn, Mn, errors = inner({k: self._whole(v, self._t_rows[k]) for k, v in T.items()},
                                   self._whole(M, self._m_rows))
            Tn = {k: self._own(_pad_rows(v.contiguous(), self._n)) for k, v in Tn.items()}
            return Tn, self._own(_pad_rows(Mn, self._n)), errors

        return step

    def step_once(self, circuit, **kwargs):
        step = self.make_step(circuit, **kwargs)
        self.T, self.M, errors = step(self.T, self.M)
        return errors

    def freenergy(self):
        """BP free energy, its log sums reduced over the mesh: the same
        semantics as `LatticeEngine.freenergy` (a real log Z when every
        scalar is real positive, else the summed phases; -inf for a zero
        edge scalar); two real sums and one minimum cross the ranks."""
        eng, plan = self.engine, self.engine.plan
        M = self._whole(self.M, self._m_rows)
        per_m = self.M.shape[0]
        lo_m = self.mesh.rank * per_m
        re = torch.zeros((), dtype=eng.real_dtype, device=M.device)
        im = torch.zeros_like(re)
        for k, verts in plan.buckets.items():
            per = self.T[k].shape[0]
            lo = self.mesh.rank * per
            n = max(0, min(per, len(verts) - lo))
            if n == 0:
                continue
            A = Tk = self.T[k][:n]
            for j in range(k):
                eids = [plan.edge_ids[(plan.neighbor_order[v][j], v)] for v in verts[lo:lo + n]]
                A = absorb_message(A, M[torch.as_tensor(eids, device=M.device)], 2 + j)
            axes = "".join(chr(ord("a") + j) for j in range(k))
            vs = torch.einsum(f"Bs{axes},Bs{axes}->B", A, Tk.conj())
            re = re + torch.sum(torch.log(torch.abs(vs)))
            im = im + torch.sum(torch.angle(vs))
        ids = plan.edge_ids
        mine = [(ids[(u, v)], ids[(v, u)]) for (u, v) in plan.graph.edges() if lo_m <= ids[(u, v)] < lo_m + per_m]
        if mine:
            i1, i2 = (torch.as_tensor(c, device=M.device) for c in zip(*mine))
            es = torch.einsum("eij,eij->e", M[i1], M[i2])
            re = re - torch.sum(torch.log(torch.abs(es)))
            im = im - torch.sum(torch.angle(es))
            min_es = torch.min(torch.abs(es))
        else:
            min_es = torch.full((), float("inf"), dtype=eng.real_dtype, device=M.device)
        sums = psum(torch.stack([re, im]), self.mesh)
        if float(pmin(min_es, self.mesh)) == 0.0:
            # a zero edge scalar means Z_BP = 0, not +inf from -log|0|
            return -np.inf
        re, im = float(sums[0]), float(sums[1])
        return re if im == 0.0 else complex(re, im)

    def partitionfunction(self):
        from ..engine import _z_from_freenergy

        return _z_from_freenergy(self.freenergy())

    def unshard(self):
        """The engine with the gathered state (on every rank)."""
        eng = self.engine
        eng.T = {k: self._whole(v, self._t_rows[k]).contiguous() for k, v in self.T.items()}
        eng.M = self._whole(self.M, self._m_rows).contiguous()
        return eng
