"""The token-reduction readers, ``token_reduce_ms_per_step`` and
``token_reduce_kernel_pct``, on synthetic traces of two train steps: ATen's
chains (LayerNorm's backward with its ``GammaBeta`` kernel, a linear's bias
sum under ``AddmmBackward0``), the program's own reductions (``swinir::token_``
operations), a trace with neither (nothing to read), and the kernels neither
reader counts (the GEMMs, a convolution's bias sum, the window attention)."""

import pytest

from portbench import harness, trace

CELL = harness.load_cell("swinir_train_b32")
A = trace.Activity
LINEAR = "autograd::engine::evaluate_function: AddmmBackward0"
NORM = "autograd::engine::evaluate_function: NativeLayerNormBackward0"
OUR_LINEAR = "autograd::engine::evaluate_function: _LinearBackward"
OUR_NORM = "autograd::engine::evaluate_function: _LayerNormBackward"


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _reading(activities, steps=2):
    t = trace.Trace(1e-3, activities)
    return harness.Reading(t, steps, t, steps, "step", CELL.config, CELL.traffic, CELL.family)


def _others(t0):
    """Kernels that neither reader counts: the linear's GEMMs, a
    convolution's bias sum and weight gradient, the window attention's
    backward, and a memset."""
    return [
        A("sm80_xmma_gemm_f32f32", t0, t0 + 100, True, ("aten::mm", LINEAR)),
        A("reduce_kernel<512, 1>", t0 + 100, t0 + 110, True,
          ("aten::sum", "aten::convolution_backward", "ConvolutionBackward0")),
        A("sm80_xmma_wgrad", t0 + 110, t0 + 150, True, ("aten::convolution_backward",)),
        A("window_attention_backward_kernel", t0 + 150, t0 + 200, True,
          ("swinir::window_scaled_dot_product_attention_backward",)),
        A("Memset (Device)", t0 + 200, t0 + 210, False, ("aten::zero_",)),
    ]


def _parent():
    """ATen's chains: per step a LayerNorm backward (input gradient 30 us,
    weight and bias 40 us) and a linear's bias sum (50 us; its memset is no
    launch)."""
    acts = []
    for t0 in (0.0, 1000.0):
        acts += [
            A("layer_norm_grad_input_kernel", t0, t0 + 30, True,
              ("aten::native_layer_norm_backward", NORM)),
            A("GammaBetaBackwardCUDAKernel", t0 + 30, t0 + 70, True,
              ("aten::native_layer_norm_backward", NORM)),
            A("reduce_kernel<128, 4>", t0 + 70, t0 + 120, True, ("aten::sum", LINEAR)),
            A("Memset (Device)", t0 + 120, t0 + 125, False, ("aten::sum", LINEAR)),
        ] + _others(t0 + 200)
    return acts


def _change():
    """The program's: per step the same input gradient (30 us), a LayerNorm's
    reduction (8 us and its 2 us finish) and a bias sum (9 + 1 us)."""
    acts = []
    for t0 in (0.0, 1000.0):
        acts += [
            A("layer_norm_grad_input_kernel", t0, t0 + 30, True,
              ("aten::native_layer_norm_backward", OUR_NORM)),
            A("token_reduce_kernel<float, true>", t0 + 30, t0 + 38, True,
              ("swinir::token_layer_norm_affine_grad", OUR_NORM)),
            A("token_reduce_finish_kernel", t0 + 38, t0 + 40, True,
              ("swinir::token_layer_norm_affine_grad", OUR_NORM)),
            A("token_reduce_kernel<float, false>", t0 + 40, t0 + 49, True,
              ("swinir::token_bias_grad", OUR_LINEAR)),
            A("token_reduce_finish_kernel", t0 + 49, t0 + 50, True,
              ("swinir::token_bias_grad", OUR_LINEAR)),
            A("sm80_xmma_gemm_f32f32", t0 + 50, t0 + 150, True, ("aten::mm", OUR_LINEAR)),
        ] + _others(t0 + 200)
    return acts


@pytest.mark.parametrize("activities,ms,pct", [(_parent(), 0.12, 0.0), (_change(), 0.05, 100.0),
                                                (_parent()[:4] + _change()[:5], 0.085, 50.0)],
                         ids=["aten", "kernel", "half"])
def test_readers_on_synthetic_traces(activities, ms, pct):
    r = _reading(activities)
    assert _reader("token_reduce_ms_per_step").read(r) == pytest.approx(ms)
    assert _reader("token_reduce_kernel_pct").read(r) == pytest.approx(pct)


def test_nothing_to_read_without_token_reductions():
    """GEMMs, a convolution's bias sum and the attention alone: neither
    reader counts them, so both give nothing."""
    r = _reading(_others(0.0) + _others(1000.0))
    assert _reader("token_reduce_ms_per_step").read(r) is None
    assert _reader("token_reduce_kernel_pct").read(r) is None


def test_a_serve_window_gives_nothing():
    r = _reading(_parent())
    r.unit = "scene"
    assert _reader("token_reduce_ms_per_step").read(r) is None
    assert _reader("token_reduce_kernel_pct").read(r) is None
