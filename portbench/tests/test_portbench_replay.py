"""The replay-share reader (``cascade_graph_replay_pct``) on synthetic spans:
every level replayed, none, a mix, the host-ops window left out, and nothing
to read without spans or without the program's graph module."""

import builtins

import pytest

from portbench import harness, trace
from superresolution_for_pdes_tpu_torch.utils import profiling
from superresolution_for_pdes_tpu_torch.utils.profiling import SpanRecord


def _reader():
    return harness.load_module(harness.HERE / "metrics" / "cascade_graph_replay_pct.py")


def _reading(unit="scene"):
    cell = harness.load_cell("champion_serve_scene" if unit == "scene" else "champion_train_b32")
    t = trace.Trace(window_s=1e-3, activities=[trace.Activity("k", 0.0, 500.0, True, ())])
    return harness.Reading(t, 1, t, 1, unit, cell.config, cell.traffic, cell.family)


def _span(name, start_us, index, parent):
    return SpanRecord(name, int(start_us * 1000), int((start_us + 10) * 1000), index, parent,
                      0, 1, 1)


def _scene(replayed, start_us=0.0, first=1):
    """A ``cascade`` root and four levels; the levels in ``replayed`` (by
    position) each enclose a ``cascade.replay`` span."""
    spans = [_span("cascade", start_us, first - 1, None)]
    for level in range(4):
        index = first + 2 * level
        spans.append(_span("cascade.level", start_us + 10 * level, index, first - 1))
        if level in replayed:
            spans.append(_span("cascade.replay", start_us + 10 * level + 1, index + 1, index))
    return spans


@pytest.fixture
def spans(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(held))
    return held


@pytest.mark.parametrize("replayed,share", [((0, 1, 2, 3), 100.0), ((), 0.0), ((2, 3), 50.0)],
                         ids=["all", "none", "mix"])
def test_share_of_levels_replayed(replayed, share, spans):
    spans += _scene(replayed)
    # a scene of the host-ops window, after the device-only window's last activity
    spans += _scene((), start_us=600.0, first=20)
    assert _reader().read(_reading()) == pytest.approx(share)
    assert _reader().read(_reading("step")) is None


def test_nothing_to_read_without_spans(spans, monkeypatch):
    assert _reader().read(_reading()) is None
    spans += _scene((0, 1))
    real_import = builtins.__import__

    def no_graphs(name, globals=None, locals=None, fromlist=(), level=0):
        if name.endswith("cascade") and "graphs" in (fromlist or ()):
            raise ImportError("a program without cascade/graphs.py")
        return real_import(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_graphs)
    assert _reader().read(_reading()) is None
