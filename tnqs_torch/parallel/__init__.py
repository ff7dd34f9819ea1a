"""Multi-device execution over `torch.distributed` (port of `tnqs/parallel/`
but `bmps_ring.py`): the 1-D mesh and its collectives (`mesh`), the
row-sharded engine (`ShardedEngine`), band-decomposed BP with a halo
exchange (`halo`) and the whole layer step on bands (`halo_step`), the rank
pool that spawns a local world (`pool`) and the CPU dry run
(`dryrun_multichip`, ``python -m tnqs_torch.parallel.dryrun N``)."""

from .halo import HaloBandPlan, HaloBP
from .halo_step import HaloStepEngine, HaloStepPlan
from .mesh import Mesh, ShardedEngine, all_gather, gather_bands, make_mesh, pmin, ppermute, psum, to_bands
from .pool import RankPool

__all__ = ["HaloBP", "HaloBandPlan", "HaloStepEngine", "HaloStepPlan", "Mesh", "RankPool", "ShardedEngine",
           "all_gather", "dryrun_multichip", "gather_bands", "make_mesh", "pmin", "ppermute", "psum", "to_bands"]


def __getattr__(name):
    # `dryrun` stays unimported until asked for, so that running it with
    # ``python -m`` does not find it imported already
    if name == "dryrun_multichip":
        from .dryrun import dryrun_multichip

        return dryrun_multichip
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
