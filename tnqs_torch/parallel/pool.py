"""A pool of spawned ranks on the local host, each in the `torch.distributed`
world of the pool, that run functions as one collective program.

`RankPool(n)` spawns n processes; each sets up its process group over TCP
on 127.0.0.1 (gloo on the CPU, `init_ranks`) with one torch thread, then
runs what `run` sends it: ``fn(*args)`` on every rank at once, `fn` a
module-level function (it is pickled by name) and `args` picklable.
`run` returns the ranks' results in rank order.  Every rank of a call must
reach the same collectives; a rank that raises poisons the call, and the
pool then kills every rank and raises, so no rank outlives a failure.  A
collective that waits longer than the group's timeout raises in its rank.
`close` (or leaving a ``with`` block) tells every rank to leave its group
(`destroy_process_group`) and joins each with a time limit, killing any
that does not end.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, timeout_s: float, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_ranks

    torch.set_num_threads(1)
    try:
        init_ranks(rank, n, port, "cpu", timeout_s)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                break
    finally:
        dist.destroy_process_group()


class RankPool:
    """`n` spawned gloo ranks of one `torch.distributed` world on the CPU
    (see the module docstring).  `timeout_s` bounds a collective's wait
    inside a rank and a `run` call's wait for every rank's result."""

    def __init__(self, n: int, timeout_s: float = 120.0):
        self.n, self.timeout_s = int(n), float(timeout_s)
        self._procs, self._pending = [], None
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        port = free_port()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, self.n, port, self.timeout_s, self._tasks[r], self._results))
                       for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order.  Raises
        (after killing the pool) if a rank raised, died or did not answer
        within the time limit; the next call starts a new pool."""
        self.submit(fn, *args)
        return self.collect()

    def submit(self, fn, *args) -> None:
        """Start ``fn(*args)`` on every rank and return at once; `collect`
        waits for the results (one call at a time)."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args))
        self._pending = fn.__name__

    def collect(self) -> list:
        """The results of the submitted call, in rank order (see `run`)."""
        name = self._pending
        out: dict = {}
        deadline = time.monotonic() + self.timeout_s
        while len(out) < self.n:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive() and r not in out]
                if dead or time.monotonic() > deadline:
                    self.kill()
                    raise RuntimeError(f"RankPool: ranks {dead or 'all'} gave no result for {name}"
                                       + ("" if dead else f" within {self.timeout_s:.0f} s"))
                continue
            if not ok:
                self.kill()
                raise RuntimeError(f"RankPool: rank {rank} failed in {name}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.n)]

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []
        # nothing left in a queue may hold this process at its exit
        for q in self._tasks + [self._results]:
            q.cancel_join_thread()
            q.close()

    def close(self) -> None:
        """Every rank leaves its group and ends; any that has not ended
        after the time limit is killed."""
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + 30.0
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        self.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
