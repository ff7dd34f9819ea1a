"""Profiling hooks: `torch.profiler` traces around hot regions (port of
`tnqs/utils/profiling.py`).

Wrap a region in :func:`trace` (or set ``TNQS_PROFILE=<dir>`` to arm
:func:`trace_from_env`) to write a Chrome trace of it, host and CUDA
activity, into the directory; open it in Perfetto or `chrome://tracing`.
:func:`annotate` names a sub-region inside an active trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Context manager: a `torch.profiler` trace of the region, written as
    ``trace_<pid>_<ns>.json`` (Chrome trace format) into `log_dir`; a no-op
    if `log_dir` is falsy."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    # Only the profiler's entry and exit are guarded: an exception raised by
    # the caller's code inside the region must propagate unchanged (a
    # blanket try around the yield would make this generator yield twice and
    # contextlib would replace the real exception).
    prof = torch.profiler.profile(activities=_activities())
    try:
        prof.__enter__()
        armed = True
    except Exception:
        # profiling must never take down the run: fall through untraced
        armed = False
    try:
        yield
    finally:
        if armed:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
            except Exception:
                pass


def trace_from_env(var: str = "TNQS_PROFILE"):
    """`trace()` armed by an environment variable holding the log dir."""
    return trace(os.environ.get(var))


@contextlib.contextmanager
def annotate(name: str):
    """A named sub-region inside an active trace (`record_function`)."""
    with torch.profiler.record_function(name):
        yield
