"""The reduction of a trace to the per-layer metrics, on synthetic device
activities (the card's own traces are read only on the card)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, trace
from portbench.metrics._kernels import is_convolution

A = trace.Activity


def _trace():
    acts = [A("conv_fprop", 0.0, 400.0, True, ("aten::cudnn_convolution", "aten::conv2d")),
            A("gemm", 300.0, 500.0, True, ("aten::mm", "aten::matmul")),  # overlaps the first
            A("Memcpy HtoD (Pinned -> Device)", 700.0, 750.0, False, ("aten::copy_",)),
            A("jacobi_kernel<2>", 1000.0, 1010.0, True, ()),
            A("smooth_residual_kernel<2>", 1010.0, 1030.0, True, ())]
    return trace.Trace(window_s=2e-3, activities=acts)


def test_busy_time_is_the_union_of_device_intervals():
    t = _trace()
    assert t.busy_intervals() == [(0.0, 500.0), (700.0, 750.0), (1000.0, 1030.0)]
    assert t.busy_s == pytest.approx(580e-6)
    assert len(t.kernels) == 4  # a copy is not a launch


def test_idle_gaps_are_named_by_the_launch_that_ends_them():
    gaps = dict(map(tuple, _trace().idle_gaps()))
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps["(unlinked) jacobi_kernel<2>"] == pytest.approx(250e-6)


def test_convolutions_by_their_launching_operation_or_their_name():
    t = _trace()
    assert t.device_seconds(is_convolution) == pytest.approx(400e-6)
    assert is_convolution(A("sm80_xmma_fprop_implicit_gemm_cudnn", 0, 1, True, ()))
    assert not is_convolution(A("sm80_xmma_gemm", 0, 1, True, ("aten::mm", "aten::matmul")))


def test_readers_of_the_stencil_roofline_and_idle_share():
    reader = harness.load_module(harness.HERE / "metrics" / "stencil_roofline_pct.refine.py")
    idle = harness.load_module(harness.HERE / "metrics" / "device_idle_pct.serve.py")
    cell = harness.load_cell("champion_serve_refine2")
    t = _trace()
    r = harness.Reading(t, 1, t, 1, "scene", cell.config, cell.traffic)
    nbytes, ops = reader.scene_work(cell.config["serve"]["refine"], 2, 40, 640)
    assert reader.read(r) == pytest.approx(100 * nbytes / 3.35e12 / 30e-6)
    assert idle.read(r) == pytest.approx(100 * (1 - 580e-6 / 2e-3))
    plain = harness.Reading(t, 1, t, 1, "scene", cell.config, {**cell.traffic, "refine_cycles": 0})
    assert reader.read(plain) is None


def test_host_operations_nest_by_interval():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.randn(2, 3, 16, 16)
        w = torch.randn(4, 3, 3, 3, requires_grad=True)
        torch.nn.functional.conv2d(x, w).sum().backward()
    chains = trace._host_chains(prof.profiler.kineto_results.events()).values()
    assert any(c[-1] == "aten::conv2d" and len(c) > 2 for c in chains)
    assert any("aten::convolution_backward" in c for c in chains)
