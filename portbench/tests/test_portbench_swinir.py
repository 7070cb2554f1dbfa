"""The SwinIR family and its cell: the FLOP counts against
``torch.utils.flop_counter`` on the plain reference, the weights drawn from
a seed, the window attention's work against the program's spans, the two
window-attention readers on synthetic traces, and the cell run through the
harness on the CPU at TINY widths.

The FLOPs are counted on the reference and not on the program: the program
pads the heads to a multiple of 8 for SDPA's fused kernels, so the counter
would count its products on the padded heads. Counting rules (as
``families/swin_ir.py`` writes them): linear layers and convolutions at
``2 in out`` a point, the attention's two products at ``4 N d`` a query and
head, a backward at twice its forward less the first layer's input gradient;
softmax, LayerNorm, GELU, the bias gather and adds uncounted (the counter
counts none of them)."""

import copy
import hashlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, trace, weights
from portbench.drivers.train_steps import build_model

CELL = harness.load_cell("swinir_train_b32")
FAMILY = CELL.family
PUBLISHED = CELL.config["architecture"]
CPU = torch.device("cpu")
# recorded from families/swin_ir.py's draws (seed 11, the CPU, TINY widths)
DIGESTS = {0: "4f42aff30086c5653585d70e980b444dc4691ab710b76d104d8637bda928569b",
           3: "06a36f126f60e845392b8306940bd5915a76d9172b6e51d052b23ced5f53e990"}


def _tiny():
    arch = copy.deepcopy(PUBLISHED)
    arch.update(FAMILY.TINY)
    return arch


def _counted(arch, size, backward, device="cpu", batch=2):
    with torch.device(device):
        state = {k: torch.randn(s) * 0.1 for k, s, _ in FAMILY.layout(arch)}
        x = torch.randn(batch, arch["in_channels"], size, size)
    with FlopCounterMode(display=False) as counter:
        if backward:
            leaves = {k: v.requires_grad_(True) for k, v in state.items()}
            out = FAMILY.forward(arch, leaves, x, train=True)
            torch.autograd.grad(out.sum(), list(leaves.values()))
        else:
            with torch.no_grad():
                FAMILY.forward(arch, state, x)
    return counter.get_total_flops() // batch


@pytest.mark.parametrize("size", [16, 18])
def test_flop_counts_match_the_flop_counter(size):
    """TINY widths, on a multiple of the window and on a padded size."""
    arch = _tiny()
    assert _counted(arch, size, backward=False) == FAMILY.flops_forward(arch, size)
    assert _counted(arch, size, backward=True) == FAMILY.flops_train_step(arch, size)


def test_published_widths_count_24_4_mflop_a_pixel():
    """24,423,120 FLOPs a pixel forward (83% in the Swin blocks), 3.75 TFLOP
    a train step of 32 at 40^2; the counter agrees on the meta device."""
    assert FAMILY.flops_forward(PUBLISHED, 40) == 24_423_120 * 40 * 40
    assert _counted(PUBLISHED, 40, backward=True, device="meta", batch=1) == \
        FAMILY.flops_train_step(PUBLISHED, 40)
    assert 32 * FAMILY.flops_train_step(PUBLISHED, 40) == pytest.approx(3.7506e12, rel=1e-4)


def test_attention_work_at_the_cell():
    """172,800 window-heads a step of 32 at 40^2: 254.8 GFLOP and 16.1 GB
    (q, k, v, output and log-sum-exp forward; 16.01 GB of them, the rest the
    bias and mask and their gradient), bound by memory at 4.81 ms."""
    assert FAMILY.attention_window_heads(PUBLISHED, 32, 40) == 172_800
    nbytes, ops = FAMILY.attention_work(PUBLISHED, 32, 40)
    assert ops == 172_800 * 3 * 4 * 64 * 64 * 30
    assert nbytes == pytest.approx(16.106e9, rel=1e-4)
    assert nbytes / 3.35e12 > ops / 67e12


@pytest.mark.parametrize("tag", sorted(DIGESTS))
def test_weights_are_the_same_bits(tag):
    state = weights.make_state_dict(FAMILY, _tiny(), 11, CPU, tag=tag)
    h = hashlib.sha256()
    for key, v in state.items():
        v = v.detach().contiguous()
        h.update(f"{key}|{v.dtype}|{tuple(v.shape)}|".encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == DIGESTS[tag]


@pytest.mark.parametrize("size", [16, 18])
def test_window_heads_are_what_the_program_attends(size):
    """The sum of ``n`` over the program's ``swinir.attention`` spans in a
    forward is ``batch (size / ws)^2 heads sum(depths)``, padded sizes too."""
    from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

    arch = _tiny()
    model = build_model(FAMILY, arch)
    x = torch.randn(3, arch["in_channels"], size, size)
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(x)
    attended = sum(s.n for s in recorded_spans() if s.name == "swinir.attention")
    assert attended == FAMILY.attention_window_heads(arch, 3, size)
    assert attended == 3 * (-(-size // 4)) ** 2 * 2 * 4


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _reading():
    """Two steps: SDPA forward and backward kernels, a linear layer's GEMM
    and a convolution, each tied to its launching operations."""
    A = trace.Activity
    ops = trace.Trace(1e-3, [
        A("fmha_cutlassF", 0.0, 300.0, True,
          ("aten::_efficient_attention_forward", "aten::_scaled_dot_product_efficient_attention",
           "aten::scaled_dot_product_attention")),
        A("fmha_cutlassB", 300.0, 800.0, True,
          ("aten::_efficient_attention_backward",
           "aten::_scaled_dot_product_efficient_attention_backward",
           "ScaledDotProductEfficientAttentionBackward0")),
        A("Memset (Device)", 800.0, 810.0, False,
          ("aten::zero_", "aten::_scaled_dot_product_efficient_attention_backward")),
        A("gemm", 810.0, 1000.0, True, ("aten::addmm", "aten::linear")),
        A("implicit_convolve", 1000.0, 1100.0, True, ("aten::cudnn_convolution",)),
    ])
    return harness.Reading(ops, 2, ops, 2, "step", CELL.config, CELL.traffic, FAMILY)


def test_attention_readers_on_a_synthetic_trace(monkeypatch):
    """800 us of SDPA kernels (the memset is no launch) over 2 steps: 0.4 ms
    a step; the roofline from the spans' count."""
    from superresolution_for_pdes_tpu_torch.utils import profiling
    from superresolution_for_pdes_tpu_torch.utils.profiling import SpanRecord

    r = _reading()
    assert _reader("attention_ms_per_step").read(r) == pytest.approx(0.4)
    roofline = _reader("attention_roofline_pct.train")
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [])
    assert roofline.read(r) is None  # a program without the span
    per_step = FAMILY.attention_window_heads(PUBLISHED, 32, 40)
    spans = [SpanRecord("swinir.attention", 0, 1000, i, None, i, 1, per_step // 36)
             for i in range(72)]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: spans)
    bound = max(x / p for x, p in zip(FAMILY.attention_work(PUBLISHED, 32, 40),
                                      (3.35e12, 67e12)))
    assert roofline.read(r) == pytest.approx(100 * bound / 0.4e-3)


def test_the_cell_runs_correct_on_the_cpu(tiny):
    result = harness.run(tiny("swinir_train_b32"), 2 ** 40 + 3, 0.5, False, 0.0, CPU,
                         benchmark=json.loads((harness.ROOT / "BENCHMARK.json").read_text()))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
