"""``attention_kernel_pct`` on synthetic span lists: every attention call on
the kernel path (100), none (0), no attention span (nothing to read), and
kernel spans that no attention span in the window encloses (not counted)."""

import pytest

from portbench import harness, trace
from superresolution_for_pdes_tpu_torch.utils import profiling
from superresolution_for_pdes_tpu_torch.utils.profiling import SpanRecord


def _reader():
    return harness.load_module(harness.HERE / "metrics" / "attention_kernel_pct.py")


def _reading():
    cell = harness.load_cell("swinir_train_b32")
    t = trace.Trace(window_s=1e-3, activities=[trace.Activity("k", 0.0, 500.0, True, ())])
    return harness.Reading(t, 1, t, 1, "step", cell.config, cell.traffic, cell.family)


def _span(name, start_us, end_us, index, parent=None):
    return SpanRecord(name, int(start_us * 1000), int(end_us * 1000), index, parent,
                      index if parent is None else parent, 1, 6 * 25 * 32)


@pytest.fixture
def spans(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(held))
    return held


def _attention(spans, kernels):
    """Two attention calls in the device-only window, the first ``kernels`` of
    them enclosing a kernel span; and one after the window (not read)."""
    for i in range(2):
        spans.append(_span("swinir.attention", 10 + 100 * i, 90 + 100 * i, 2 * i))
        if i < kernels:
            spans.append(_span("swinir.attention.kernel", 20 + 100 * i, 80 + 100 * i, 2 * i + 1,
                               parent=2 * i))
    spans.append(_span("swinir.attention", 900, 950, 10))


@pytest.mark.parametrize("kernels,want", [(2, 100.0), (1, 50.0), (0, 0.0)])
def test_share_of_attention_calls_on_the_kernels(spans, kernels, want):
    _attention(spans, kernels)
    assert _reader().read(_reading()) == pytest.approx(want)


def test_nothing_to_read_without_attention_spans(spans, monkeypatch):
    assert _reader().read(_reading()) is None
    monkeypatch.delattr(profiling, "recorded_spans")  # a program without spans
    assert _reader().read(_reading()) is None


def test_only_kernel_spans_inside_a_windowed_attention_call_count(spans):
    """A kernel span counts for the attention span that is its parent: one
    under a span of another name, or under an attention call after the
    window, leaves the window's calls at 0."""
    spans.append(_span("swinir.attention", 10, 90, 0))
    spans.append(_span("swinir.stage", 100, 190, 1))
    spans.append(_span("swinir.attention.kernel", 110, 180, 2, parent=1))
    spans.append(_span("swinir.attention", 900, 950, 3))
    spans.append(_span("swinir.attention.kernel", 910, 940, 4, parent=3))
    assert _reader().read(_reading()) == pytest.approx(0.0)
