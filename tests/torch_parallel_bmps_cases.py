"""Rank bodies of `tests/test_torch_parallel_bmps.py`: module-level functions
that a `tnqs_torch.parallel.RankPool` runs on every gloo rank (pickled by
name, so this module imports no jax and no `tnqs`).  Each takes plain data
(a graph as its vertex and edge lists, a state as numpy arrays) and returns
plain data."""

import numpy as np
import torch

import tnqs_torch as tt
from tnqs_torch.bmps_engine import BMPSEngine, BMPSSampler, cpu_sketch
from tnqs_torch.engine import LatticeEngine
from tnqs_torch.parallel import ShardedBMPS, ShardedSampler, make_mesh

CPU = "cpu"


class CountingSketch:
    """The default draw (`cpu_sketch` of `seed`), counting its draws in
    `draws`: a test that needs no sketch in its comparison asserts none."""

    def __init__(self, seed: int = 7):
        self.seed, self.draws = seed, 0

    def __call__(self, code, shape):
        self.draws += 1
        return cpu_sketch(self.seed, code, shape)


class Replay:
    """`BMPSSampler(uniforms=...)` that replays given bits: sample s takes
    row s of `bits` (0.0/1.0 at d = 2 give bits 0 and 1 whatever the law,
    `inverse_cdf`); samples past the table (a mesh's padding) take zeros."""

    def __init__(self, bits: np.ndarray):
        self.bits = torch.as_tensor(np.asarray(bits), dtype=torch.float32)

    def __call__(self, seed, s, nv):
        return self.bits[s] if s < self.bits.shape[0] else torch.zeros(nv)


def engine(ve, T, M, chi, bp_schedule):
    """The port's CPU engine on the state (T, M) of the graph `ve`."""
    return LatticeEngine.from_arrays(tt.NamedGraph.from_edges(*ve), T, M, chi, device=CPU, bp_schedule=bp_schedule)


def sharded_expect(ve, T, M, chi, bp_schedule, rank, ring_iters):
    """`ShardedBMPS(...).expect_1site("Z")` over the world: ({vertex: <Z>},
    the sketch draws, the relay's bytes)."""
    sketch = CountingSketch()
    be = BMPSEngine(engine(ve, T, M, chi, bp_schedule), rank=rank, ring_iters=ring_iters, sketch=sketch)
    sharded = ShardedBMPS(be, make_mesh(device=CPU))
    return sharded.expect_1site("Z"), sketch.draws, sharded.relay_bytes()


def sharded_samples(ve, T, M, chi, bp_schedule, rank, proj_rank, ring_iters, nsamples, seed, bits=None):
    """`ShardedSampler(...).sample_directly_certified(nsamples, seed)` over
    the world, on the port's draws or replaying `bits`: (samples, the
    sketch draws)."""
    sketch = CountingSketch()
    be = BMPSEngine(engine(ve, T, M, chi, bp_schedule), rank=rank, ring_iters=ring_iters, sketch=sketch)
    sam = BMPSSampler(be, proj_rank=proj_rank, uniforms=None if bits is None else Replay(bits))
    return ShardedSampler(sam, make_mesh(device=CPU)).sample_directly_certified(nsamples, seed=seed), sketch.draws


def too_few_columns(ve, chi):
    """The error of `ShardedBMPS` on a lattice of fewer columns than ranks."""
    eng = LatticeEngine(tt.NamedGraph.from_edges(*ve), chi, device=CPU)
    try:
        ShardedBMPS(BMPSEngine(eng, rank=2), make_mesh(device=CPU))
    except ValueError as err:
        return str(err)
    return None
