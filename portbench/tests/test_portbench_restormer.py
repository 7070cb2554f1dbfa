"""The Restormer family and its cells: the FLOP counts against
``torch.utils.flop_counter`` on the plain reference (the train step with the
counter's convolution backward made group-aware) and against hand counts,
the transposed attention's heads against the program's spans and its work
over a served scene, the two readers on synthetic traces (and on a trace of
a program without the kernels), both new cells resolving, and
``restormer_serve_scene`` run through the harness on the CPU at TINY sizes.

Counting rules (as ``families/restormer.py`` writes them): convolutions at
``2 (c_in / groups) c_out k^2`` a point, the attention's two products at
``2 d^2`` a token and head each, a backward at twice its forward less the
first layer's input gradient."""

import copy
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from portbench import flops, harness, trace
from portbench.drivers.train_steps import build_model

CELL = harness.load_cell("restormer_serve_scene")
FAMILY = CELL.family
PUBLISHED = CELL.config["architecture"]
CPU = torch.device("cpu")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _tiny():
    arch = copy.deepcopy(PUBLISHED)
    arch.update(FAMILY.TINY)
    return arch


def _grouped_conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                           _dilation, _transposed, _output_padding, _groups, output_mask,
                           out_shape=None, **kwargs):
    """A convolution's input and weight gradients at the forward's count
    each. The counter's own formula counts a grouped convolution's weight
    gradient as a dense one (the batch taken for input channels): for a
    depthwise 3x3 of C channels that is C times too many."""
    return conv_flop_count(x_shape, w_shape, grad_out_shape) * (bool(output_mask[0])
                                                                + bool(output_mask[1]))


def _counted(arch, size, backward, device="cpu", batch=2):
    with torch.device(device):
        state = {k: torch.randn(s) * 0.1 for k, s, _ in FAMILY.layout(arch)}
        x = torch.randn(batch, arch["in_channels"], size, size)
    mapping = {torch.ops.aten.convolution_backward: _grouped_conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        if backward:
            leaves = {k: v.requires_grad_(True) for k, v in state.items()}
            out = FAMILY.forward(arch, leaves, x, train=True)
            torch.autograd.grad(out.sum(), list(leaves.values()))
        else:
            with torch.no_grad():
                FAMILY.forward(arch, state, x)
    return counter.get_total_flops() // batch


@pytest.mark.parametrize("size", [16, 20])
def test_flop_counts_match_the_flop_counter(size):
    """TINY widths, on a multiple of 8 and on a padded size."""
    arch = _tiny()
    assert _counted(arch, size, backward=False) == FAMILY.flops_forward(arch, size)
    assert _counted(arch, size, backward=True) == FAMILY.flops_train_step(arch, size)


def test_published_widths_count_2_57_tflop_a_scene():
    """By hand at 160^2: a block of C channels in heads of d over N tokens is
    (6 C^2 + 54 C + 4 C d + 2 C^2) N for MDTA and (4 C h + 36 h + 2 h C) N
    for GDFN with h = int(2.66 C); 121.0 GFLOP a 160^2 tile, 30.2 an 80^2
    one, 2.57 TFLOP a served scene; the counter agrees on the meta device."""
    def block(c, d):
        h = int(c * 2.66)
        return 8 * c * c + 54 * c + 4 * c * d + 6 * c * h + 36 * h

    n = 160 * 160
    blocks = (4 * block(48, 48) * n + 12 * block(96, 48) * n // 4
              + 12 * block(192, 48) * n // 16 + 8 * block(384, 48) * n // 64
              + 8 * block(96, 96) * n)
    convs = 2 * 9 * n * (5 * 48 + 48 * 24 + 96 * 48 / 4 + 192 * 96 / 16 + 384 * 768 / 64
                         + 192 * 384 / 16 + 96 * 192 / 4 + 96) \
        + 2 * (384 * 192 * n / 16 + 192 * 96 * n / 4)
    assert FAMILY.flops_forward(PUBLISHED, 160) == blocks + convs
    assert _counted(PUBLISHED, 160, backward=False, device="meta", batch=1) == \
        FAMILY.flops_forward(PUBLISHED, 160)
    scene = flops.served_scene(FAMILY, PUBLISHED, 40, 640, [40, 80, 80])
    assert scene == FAMILY.flops_forward(PUBLISHED, 80) + 21 * FAMILY.flops_forward(PUBLISHED, 160)
    assert scene == pytest.approx(2.5703e12, rel=1e-4)


def test_transposed_attention_work_of_a_served_scene():
    """A 160^2 tile: 16 C N bytes and 4 C d N operations a block, 589.8 MB
    and 10.85 GFLOP; a scene (1 tile of 80^2, 21 of 160^2) 12.53 GB and
    230.7 GFLOP, bound near 3.8 ms on an H100, level by level."""
    nbytes, ops = FAMILY.transposed_attention_work(PUBLISHED, 1, 160)
    n = 160 * 160
    stages = [(4, 48, 48, n), (12, 96, 48, n // 4), (12, 192, 48, n // 16), (8, 384, 48, n // 64),
              (8, 96, 96, n)]
    assert nbytes == sum(16 * k * c * t for k, c, _, t in stages)
    assert ops == sum(4 * k * c * d * t for k, c, d, t in stages)
    levels = flops.cascade_tiles(40, 640, [40, 80, 80])
    assert levels == [(1, 80), (1, 160), (4, 160), (16, 160)]
    work = [FAMILY.transposed_attention_work(PUBLISHED, k, s) for k, s in levels]
    assert sum(w[0] for w in work) == pytest.approx(12.534e9, rel=1e-3)
    assert sum(w[1] for w in work) == pytest.approx(230.62e9, rel=1e-3)
    least = sum(max(b / 3.35e12, o / 67e12) for b, o in work)
    assert least == pytest.approx(3.742e-3, rel=1e-3)


@pytest.mark.parametrize("size", [16, 20])
def test_attention_heads_are_what_the_program_attends(size):
    """The sum of ``n`` over the program's ``restormer.attention`` spans in a
    forward is the family's samples times heads; ``restormer.ffn`` counts
    each block's tokens at its scale."""
    from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

    arch = _tiny()
    model = build_model(FAMILY, arch)
    x = torch.randn(3, arch["in_channels"], size, size)
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(x)
    spans = recorded_spans()
    assert sum(s.n for s in spans if s.name == "restormer.attention") == \
        FAMILY.attention_heads(arch, 3) == 3 * (2 + 2 + 4 + 2 * 4 + 4 + 2 + 2 + 2)
    side = -(-size // 8) * 8
    assert sum(s.n for s in spans if s.name == "restormer.ffn") == \
        3 * side * side * (1 + 1 / 4 + 1 / 16 + 2 / 64 + 1 / 16 + 1 / 4 + 1 + 1)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _reading(with_kernels=True):
    """Two scenes: the three kernels (600 us), a convolution and a GEMM."""
    A = trace.Activity
    acts = [A("implicit_convolve_sgemm", 0.0, 100.0, True, ("cascade.replay",)),
            A("gemm", 100.0, 150.0, True, ())]
    if with_kernels:
        acts += [A("void transposed_attention_gram_kernel<48>", 150.0, 450.0, True, ()),
                 A("void transposed_attention_softmax_kernel<48>", 450.0, 500.0, True, ()),
                 A("void transposed_attention_apply_kernel<48>", 500.0, 750.0, True, ()),
                 A("Memset (Device)", 750.0, 760.0, False, ())]
    t = trace.Trace(1e-3, acts)
    return harness.Reading(t, 2, t, 2, "scene", CELL.config, CELL.traffic, FAMILY)


def test_readers_on_a_synthetic_trace():
    """300 us of kernels a scene; the roofline share is the scene's least
    time over it; a program without the kernels (the parent) and a train
    unit give nothing to read."""
    ms = _reader("transposed_attention_ms_per_scene")
    roofline = _reader("transposed_attention_roofline_pct.serve")
    r = _reading()
    assert ms.read(r) == pytest.approx(0.3)
    work = [FAMILY.transposed_attention_work(PUBLISHED, k, s)
            for k, s in flops.cascade_tiles(40, 640, [40, 80, 80])]
    least = sum(max(b / 3.35e12, o / 67e12) for b, o in work)
    assert roofline.read(r) == pytest.approx(100 * least / 0.3e-3)
    assert ms.read(_reading(False)) is None and roofline.read(_reading(False)) is None
    r.unit = "step"
    assert ms.read(r) is None and roofline.read(r) is None


def test_the_new_cells_resolve_and_report_their_metrics():
    """Both cells on one chip; the serve cell reports p50, scenes/s and
    set-up end to end and the span, replay and attention metrics traced; the
    batch cell its scenes/s and the device's."""
    specs = {w["name"]: w for w in BENCH["workloads"]}
    for name, config, traffic in (("restormer_serve_scene", "restormer_dim48", "serve_scene"),
                                  ("champion_serve_batch16", "champion_unet",
                                   "serve_scene_batch16")):
        cell = harness.load_cell(name)
        assert (cell.spec["config"], cell.spec["traffic"], cell.spec["chips"]) == \
            (config, traffic, 1) == (specs[name]["config"], specs[name]["traffic"],
                                     specs[name]["chips"])
    e2e = {m["name"] for m in harness.reported(BENCH, "restormer_serve_scene", False)}
    assert e2e == {"scene_p50_ms", "scenes_per_s", "setup_s"}
    layers = {m["name"] for m in harness.reported(BENCH, "restormer_serve_scene", True)}
    assert layers == {"device_idle_pct.serve", "mfu.serve", "conv_ms_per_scene",
                      "launches_per_scene", "cascade_host_ms_per_scene",
                      "cascade_idle_ms_per_scene", "cascade_graph_replay_pct",
                      "transposed_attention_ms_per_scene",
                      "transposed_attention_roofline_pct.serve"}
    assert {m["name"] for m in harness.reported(BENCH, "champion_serve_batch16", False)} == \
        {"scenes_per_s", "setup_s"}
    assert {m["name"] for m in harness.reported(BENCH, "champion_serve_batch16", True)} == \
        {"device_idle_pct.serve", "mfu.serve", "conv_ms_per_scene", "launches_per_scene"}
    assert CELL.config["serve"] == harness.load_cell("hat_train_b32").config["serve"]
    assert CELL.config["reduced"] == [] and PUBLISHED["parameters"] == 26_125_780


def test_the_serve_cell_runs_correct_on_the_cpu(tiny):
    result = harness.run(tiny("restormer_serve_scene"), 2 ** 40 + 3, 0.5, False, 0.0, CPU,
                         benchmark=BENCH)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"scene_p50_ms", "scenes_per_s", "setup_s"}
