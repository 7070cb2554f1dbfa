"""The five span readers on a synthetic device trace and synthetic span lists:
the split between the two traced windows, host time per unit, the device's
idle time inside spans, and nothing read where the program recorded no span
(as at a commit without spans)."""

import pytest

from portbench import harness, trace
from superresolution_for_pdes_tpu_torch.utils import profiling
from superresolution_for_pdes_tpu_torch.utils.profiling import SpanRecord

A = trace.Activity
SERVE = ("cascade_host_ms_per_scene", "cascade_idle_ms_per_scene")
TRAIN = ("train_host_ms_per_step", "train_idle_ms_per_step", "optimizer_host_ms_per_step")


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _trace():
    """Busy 0-100, 150-200, 400-500 us: idle gaps 100-150 and 200-400."""
    return trace.Trace(window_s=1e-3, activities=[A("k", 0.0, 100.0, True, ()),
                                                  A("k", 150.0, 200.0, True, ()),
                                                  A("k", 400.0, 500.0, True, ())])


def _span(name, start_us, end_us, index=0, parent=None, root=None):
    """A span on thread 1; ``root`` defaults to the parent (or the span itself)."""
    root = root if root is not None else (index if parent is None else parent)
    return SpanRecord(name, int(start_us * 1000), int(end_us * 1000), index, parent, root, 1,
                      None)


def _reading(unit, units=2):
    cell = harness.load_cell("champion_serve_refine2" if unit == "scene" else "champion_train_b32")
    t = _trace()
    return harness.Reading(t, units, t, units, unit, cell.config, cell.traffic, cell.family)


@pytest.fixture
def spans(monkeypatch):
    """The program's span buffer, replaced by the list a test fills."""
    held = []
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(held))
    return held


def test_serve_readers_split_the_windows_and_intersect_the_gaps(spans):
    spans += [_span("cascade", 50, 300, 0), _span("cascade", 320, 450, 1),
              _span("cascade.refine", 120, 180, 2, parent=0),
              # the host-ops window, after the device-only window's last activity
              _span("cascade", 600, 900, 3), _span("cascade.refine", 610, 890, 4, parent=3)]
    r = _reading("scene", units=2)
    assert _reader("cascade_host_ms_per_scene").read(r) == pytest.approx((250 + 130) / 2 / 1e3)
    # gaps 100-150 and 200-400 inside 50-300 and 320-450: 50 + 100 + 80 us
    assert _reader("cascade_idle_ms_per_scene").read(r) == pytest.approx(230 / 2 / 1e3)
    assert all(_reader(name).read(r) is None for name in TRAIN)


def test_train_readers(spans):
    spans += [_span("train.optimizer", 160, 210, 1, parent=0), _span("train.step", 90, 420, 0),
              _span("train.optimizer", 700, 800, 3, parent=2), _span("train.step", 600, 900, 2)]
    r = _reading("step", units=1)
    assert _reader("train_host_ms_per_step").read(r) == pytest.approx(0.330)
    assert _reader("train_idle_ms_per_step").read(r) == pytest.approx(0.250)
    assert _reader("optimizer_host_ms_per_step").read(r) == pytest.approx(0.050)
    assert all(_reader(name).read(r) is None for name in SERVE)


def test_overlapping_spans_count_the_idle_once(spans):
    spans += [_span("train.step", 100, 300, 0), _span("train.step", 120, 260, 1)]
    assert _reader("train_idle_ms_per_step").read(_reading("step", 1)) == pytest.approx(0.150)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_to_read_without_spans(name, spans, monkeypatch):
    unit = "scene" if name in SERVE else "step"
    assert _reader(name).read(_reading(unit)) is None
    monkeypatch.delattr(profiling, "recorded_spans")  # a program without spans
    assert _reader(name).read(_reading(unit)) is None


def test_phase_table_puts_each_launch_down_to_the_innermost_open_span():
    """``phases.table``: device time by the span open at the launch (a launch
    from a thread without spans, as autograd's, by the spans of the thread
    that has them), idle time inside each span, and launches outside every
    span apart."""
    from portbench import phases

    L = phases.Launched
    spans = [_span("cascade", 0, 1000, 0), _span("cascade.level", 10, 500, 1, parent=0),
             _span("cascade.model", 20, 400, 2, parent=1, root=0),
             _span("cascade.level", 510, 990, 3, parent=0),
             _span("cascade.model", 520, 980, 4, parent=3, root=0)]
    spans = [s._replace(n=n) for s, n in zip(spans, (1, 80, 4, 160, 16))]
    acts = [L(100.0, 200.0, 30_000, 1), L(600.0, 650.0, 515_000, 1),
            L(700.0, 900.0, 600_000, 2), L(1500.0, 1510.0, 1_200_000, 1)]
    rows, outside = phases.table(acts, spans, units=1)
    got = {(r.name, r.level): (r.calls, r.device_ms, r.idle_ms) for r in rows}
    assert [(r.name, r.level) for r in rows] == [
        ("cascade", None), ("cascade.level", 80), ("cascade.model", 80),
        ("cascade.level", 160), ("cascade.model", 160)]
    assert got[("cascade", None)] == pytest.approx((1, 0.350, 0.550))
    assert got[("cascade.level", 80)] == pytest.approx((1, 0.100, 0.300))
    assert got[("cascade.model", 80)] == pytest.approx((1, 0.100, 0.200))
    assert got[("cascade.level", 160)] == pytest.approx((1, 0.250, 0.230))
    assert got[("cascade.model", 160)] == pytest.approx((1, 0.200, 0.210))
    assert rows[0].host_ms == pytest.approx(1.0)
    assert outside == pytest.approx(0.010)
