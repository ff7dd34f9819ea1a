"""tnqs_torch.utils.profiling on the CPU: `trace` is a no-op without a
directory and writes a Chrome trace with one, `annotate` names nested
regions inside it, `trace_from_env` arms from the environment, and an
exception raised inside a region propagates unchanged."""

import json

import pytest
import torch

from tnqs_torch.utils import profiling

torch.set_num_threads(1)


def _work():
    a = torch.ones(64, 64)
    return (a @ a).sum()


def _events(log_dir):
    files = sorted(log_dir.glob("*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(log_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(log_dir):
        with profiling.annotate("outside a trace"):
            assert float(_work()) == 64.0**3
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace_with_nested_annotations(tmp_path):
    log_dir = tmp_path / "prof" / "run"
    with profiling.trace(str(log_dir)):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                _work()
    events = {e["name"]: e for e in _events(log_dir) if e.get("ph") == "X"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TNQS_PROFILE", str(tmp_path / "env"))
    with profiling.trace_from_env():
        with profiling.annotate("armed"):
            _work()
    assert any(e["name"] == "armed" for e in _events(tmp_path / "env"))
    monkeypatch.delenv("TNQS_PROFILE")
    with profiling.trace_from_env():
        _work()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["env"]


class _Marker(Exception):
    pass


@pytest.mark.parametrize("armed", [False, True])
def test_exception_propagates_unchanged(armed, tmp_path):
    err = _Marker("from the region")
    with pytest.raises(_Marker) as caught:
        with profiling.trace(str(tmp_path / "t") if armed else None):
            with profiling.annotate("failing"):
                raise err
    assert caught.value is err
    if armed:
        # the trace of the region is still written
        assert any(e["name"] == "failing" for e in _events(tmp_path / "t"))
