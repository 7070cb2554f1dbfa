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


# kernels of a served scene as a replayed CUDA graph launches them: no ATen
# operation, only the program's spans, in the chain (names as the card's
# profiler gives them)
REPLAYED = [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize128x128x8_stage3_"
     "warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn", 20.0, True),
    ("void DSE::regular_fft_pad<0, 1, 128, 16, 32, 1, float, float, float2>(float2*, float*, "
     "int, int3, float*, int, float*, float*, int, int, int, int, int, bool)", 7.0, True),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int, int, "
     "int, int, int, float2)", 5.0, True),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>("
     "int, int, int, float const*, int, float*, float const*, kernel_conv_params, unsigned long "
     "long, int, float, float, int, float const*, float const*, bool, int, int)", 0.5, True),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float, float, "
     "cudnnTensorStruct, float const*, cudnnTensorStruct, float*, float const*)", 3.0, False),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_stage3_warpsize4x1x1_ffma_aligna4_"
     "alignc4_execute_kernel__5x_cublas", 2.0, False),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>(cutlass_80_simt_sgemm_"
     "64x64_8x5_nn_align1::Params)", 1.0, False),
]


# a replay's span as the profiler can nest it: inside its own flush events and
# the copy of the inputs before it
MISNESTED = ("cascade.replay", "cascade.level", "Buffer Flush", "aten::copy_", "aten::clone",
             "Buffer Flush")


@pytest.mark.parametrize("chain", [("cascade.replay", "cascade"), MISNESTED,
                                   ("Buffer Flush", "aten::clone", "cascade.replay")],
                         ids=["replay", "misnested", "flush"])
@pytest.mark.parametrize("name, _, conv", REPLAYED,
                         ids=[n.split("<")[0][:32] for n, *_ in REPLAYED])
def test_a_replayed_kernel_is_a_convolution_by_its_name(name, _, conv, chain):
    assert is_convolution(A(name, 0.0, 1.0, True, chain)) is conv


def test_convolutions_per_scene_under_replay_and_linked_as_before():
    """The replayed cuDNN convolution kernels count; BatchNorm's and the
    matmuls' do not; ATen-linked kernels count by their operations as before
    (a layout transform a convolution launched does, BatchNorm under a
    convolution's name does not)."""
    acts, at = [], 0.0
    for name, us, _ in REPLAYED:
        acts.append(A(name, at, at + us, True, ("cascade.replay", "cascade")))
        at += us
    linked = [A("void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true>", 100.0,
                104.0, True, ("aten::cudnn_convolution", "aten::_convolution", "aten::conv2d",
                              "cascade.model", "cascade")),
              A("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>", 104.0, 110.0,
                True, ("aten::cudnn_batch_norm", "aten::batch_norm", "cascade.model")),
              A("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3", 110.0, 118.0,
                True, ("aten::convolution_backward",
                       "autograd::engine::evaluate_function: ConvolutionBackward0"))]
    t = trace.Trace(window_s=1e-3, activities=acts + linked)
    cell = harness.load_cell("champion_serve_scene")
    reader = harness.load_module(harness.HERE / "metrics" / "conv_ms_per_scene.py")
    r = harness.Reading(t, 2, t, 2, "scene", cell.config, cell.traffic, cell.family)
    assert reader.read(r) == pytest.approx((20.0 + 7.0 + 5.0 + 0.5 + 4.0 + 8.0) * 1e-3 / 2)
    assert [is_convolution(a) for a in linked] == [True, False, True]


def test_readers_of_the_stencil_roofline_and_idle_share():
    reader = harness.load_module(harness.HERE / "metrics" / "stencil_roofline_pct.refine.py")
    idle = harness.load_module(harness.HERE / "metrics" / "device_idle_pct.serve.py")
    cell = harness.load_cell("champion_serve_refine2")
    t = _trace()
    r = harness.Reading(t, 1, t, 1, "scene", cell.config, cell.traffic, cell.family)
    nbytes, ops = reader.scene_work(cell.config["serve"]["refine"], 2, 40, 640)
    assert reader.read(r) == pytest.approx(100 * nbytes / 3.35e12 / 30e-6)
    assert idle.read(r) == pytest.approx(100 * (1 - 580e-6 / 2e-3))
    plain = harness.Reading(t, 1, t, 1, "scene", cell.config, {**cell.traffic, "refine_cycles": 0},
                            cell.family)
    assert reader.read(plain) is None


def test_host_operations_nest_by_interval():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.randn(2, 3, 16, 16)
        w = torch.randn(4, 3, 3, 3, requires_grad=True)
        torch.nn.functional.conv2d(x, w).sum().backward()
    chains = trace._host_chains(prof.profiler.kineto_results.events()).values()
    assert any(c[-1] == "aten::conv2d" and len(c) > 2 for c in chains)
    assert any("aten::convolution_backward" in c for c in chains)
