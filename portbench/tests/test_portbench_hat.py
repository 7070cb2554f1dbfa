"""The HAT family and its cells: the FLOP counts against
``torch.utils.flop_counter`` on the plain reference and against hand counts,
the attentions' window-heads against the program's spans, their work counts,
the OCAB and CAB readers on synthetic traces (the window attention's reader
and OCAB's each count their own kernels only), and the cell ``hat_train_b32``
and the batch-serving cell's files (``champion_serve_batch16``, not yet in
``BENCHMARK.json``) run through the harness on the CPU at TINY sizes.

Counting rules (as ``families/hat.py`` writes them): linear layers and
convolutions at ``2 in out`` a point (the CAB's squeeze convolutions at one
point a sample), the attentions' two products at ``4 N d`` a query and head
(``N`` = 256 keys in a HAB, 576 in an OCAB at the published widths), a
backward at twice its forward less the first layer's input gradient."""

import copy
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, trace
from portbench.drivers.train_steps import build_model

CELL = harness.load_cell("hat_train_b32")
FAMILY = CELL.family
PUBLISHED = CELL.config["architecture"]
CPU = torch.device("cpu")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


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


def test_published_widths_count_49_mflop_a_token():
    """By hand: a HAB 1,091,520 FLOPs a token (linears 518,400, attention
    4 x 256 x 180, CAB 2 x 9 x 2 x 180 x 60), an OCAB 933,120 (attention 4 x
    576 x 180), a 3x3 180 -> 180 convolution 583,200; 36 HABs, 6 OCABs, 7
    such convolutions, conv_first and conv_last, and the squeezes' 2 x 2 x
    180 x 6 a HAB and sample. At 40^2 (48^2 padded) 10.84 TFLOP a train step
    of 32; the counter agrees on the meta device."""
    tokens = 48 * 48
    per_token = 36 * 1_091_520 + 6 * 933_120 + 7 * 583_200 + 2 * 9 * 5 * 180 + 2 * 9 * 180
    assert FAMILY.flops_forward(PUBLISHED, 40) == per_token * tokens + 36 * 2 * 2 * 180 * 6
    assert _counted(PUBLISHED, 40, backward=True, device="meta", batch=1) == \
        FAMILY.flops_train_step(PUBLISHED, 40)
    assert 32 * FAMILY.flops_train_step(PUBLISHED, 40) == pytest.approx(10.836e12, rel=1e-4)


def test_attention_work_at_the_cell():
    """A step of 32 at 40^2: 62,208 HAB window-heads (32 x 9 windows x 36
    blocks x 6 heads) and 10,368 OCAB window-heads; HAB 1.468 TFLOP and 23.1
    GB (the hand count of families/hat.py::_work: what the attention reads
    and writes, no kernel's scratch), OCAB 0.550 TFLOP and 3.84 GB; both
    bound by the float32 rate."""
    assert FAMILY.attention_window_heads(PUBLISHED, 32, 40) == 62_208
    assert FAMILY.ocab_window_heads(PUBLISHED, 32, 40) == 10_368
    d, nq = 30, 256
    per = (4 * nq * d + nq) + (5 * nq * d + nq) + 3 * nq * d
    nbytes, ops = FAMILY.attention_work(PUBLISHED, 32, 40)
    assert ops == 62_208 * 3 * 4 * nq * nq * d
    assert nbytes == 4 * (62_208 * per + 36 * 3 * 961 * 6)
    nbytes_o, ops_o = FAMILY.ocab_work(PUBLISHED, 32, 40)
    assert ops_o == 10_368 * 3 * 4 * nq * 576 * d
    assert nbytes_o == 4 * (10_368 * per + 6 * 3 * 1521 * 6)
    assert ops / 67e12 > nbytes / 3.35e12 and ops_o / 67e12 > nbytes_o / 3.35e12
    assert ops == pytest.approx(1.4677e12, rel=1e-4) and ops_o == pytest.approx(0.55038e12,
                                                                                rel=1e-4)


@pytest.mark.parametrize("size", [16, 18])
def test_window_heads_are_what_the_program_attends(size):
    """The sums of ``n`` over the program's ``swinir.attention`` and
    ``hat.ocab`` spans in a forward are the family's window-heads, padded
    sizes too."""
    from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

    arch = _tiny()
    model = build_model(FAMILY, arch)
    x = torch.randn(3, arch["in_channels"], size, size)
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(x)
    spans = recorded_spans()
    assert sum(s.n for s in spans if s.name == "swinir.attention") == \
        FAMILY.attention_window_heads(arch, 3, size) == 3 * (-(-size // 4)) ** 2 * 2 * 4
    assert sum(s.n for s in spans if s.name == "hat.ocab") == \
        FAMILY.ocab_window_heads(arch, 3, size) == 3 * (-(-size // 4)) ** 2 * 4


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _reading():
    """Two steps: the window attention's and OCAB's kernels, a CAB's
    convolution and sigmoid inside its span, another convolution, a GEMM."""
    A = trace.Activity
    window_op = "swinir::window_scaled_dot_product_attention"
    ocab_op = "hat::overlapping_window_attention"
    ops = trace.Trace(1e-3, [
        A("tiled_attention_forward_kernel", 0.0, 100.0, True, (window_op, "swinir.attention")),
        A("tiled_attention_dq_kernel", 100.0, 300.0, True,
          (window_op + "_backward", "autograd::engine::evaluate_function: WindowBackward")),
        A("tiled_attention_forward_kernel", 300.0, 500.0, True, (ocab_op, "hat.ocab")),
        A("kv_fold_kernel", 500.0, 900.0, True, (ocab_op + "_backward", "hat.ocab")),
        A("Memset (Device)", 900.0, 910.0, False, (ocab_op + "_backward",)),
        A("implicit_convolve_sgemm", 910.0, 1010.0, True,
          ("aten::cudnn_convolution", "aten::convolution", "hat.cab", "train.forward")),
        A("sigmoid_kernel", 1010.0, 1030.0, True, ("aten::sigmoid", "hat.cab")),
        A("implicit_convolve_sgemm", 1030.0, 1130.0, True, ("aten::cudnn_convolution",)),
        A("gemm", 1130.0, 1200.0, True, ("aten::addmm", "aten::linear", "hat.ocab")),
    ])
    return harness.Reading(ops, 2, ops, 2, "step", CELL.config, CELL.traffic, FAMILY)


def test_each_attention_reader_counts_its_own_kernels(monkeypatch):
    """The window attention's 300 us and OCAB's 600 us of kernels (the
    memset is no launch, the OCAB's qkv GEMM is not its kernel) over 2
    steps; OCAB's roofline from its spans' count."""
    from superresolution_for_pdes_tpu_torch.utils import profiling
    from superresolution_for_pdes_tpu_torch.utils.profiling import SpanRecord

    r = _reading()
    assert _reader("attention_ms_per_step").read(r) == pytest.approx(0.15)
    assert _reader("ocab_ms_per_step").read(r) == pytest.approx(0.3)
    roofline = _reader("ocab_roofline_pct.train")
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [])
    assert roofline.read(r) is None  # a program without the span
    per_step = FAMILY.ocab_window_heads(PUBLISHED, 32, 40)
    spans = [SpanRecord("hat.ocab", 0, 1000, i, None, i, 1, per_step // 6) for i in range(12)]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: spans)
    bound = max(x / p for x, p in zip(FAMILY.ocab_work(PUBLISHED, 32, 40), (3.35e12, 67e12)))
    assert roofline.read(r) == pytest.approx(100 * bound / 0.3e-3)


def test_cab_reader_on_a_synthetic_trace():
    """The kernels launched inside ``hat.cab`` spans (its convolution and its
    sigmoid: 120 us) over 2 steps; the other convolution is not counted."""
    assert _reader("cab_forward_ms_per_step").read(_reading()) == pytest.approx(0.06)
    r = _reading()
    r.unit = "scene"
    assert _reader("cab_forward_ms_per_step").read(r) is None


def test_the_train_cell_runs_correct_on_the_cpu(tiny):
    result = harness.run(tiny("hat_train_b32"), 2 ** 40 + 3, 0.5, False, 0.0, CPU,
                         benchmark=BENCH)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_the_float32_controls_read_on_the_cpu(tiny):
    """``control_float32.py``'s readings at TINY on the CPU: a second float32
    reference reads 0, the half batch fails the cell's limits, the program's
    first steps pass them (TF32 means nothing on the CPU: no reading of it is
    held here; the card's are in PERF.md)."""
    from portbench import control_float32

    cell = tiny("hat_train_b32")
    out = control_float32.train_readings(cell, 2 ** 40 + 3, CPU, program=True)
    readings = out["readings"]
    assert out["reference_peak_bytes"] is None
    assert set(readings) == {"tf32", "half_batch", "reference_again", "program"}
    assert all(readings["reference_again"][k] == 0 for k in cell.limits)
    assert any(readings["half_batch"][k] > cell.limits[k] for k in cell.limits)
    assert all(readings["program"][k] <= cell.limits[k] for k in cell.limits)


def test_the_batch_serve_cell_runs_correct_on_the_cpu():
    """``champion_serve_batch16`` at TINY widths, 4 scenes a request to 160^2
    (the conftest's ``tiny_cell`` sizes the single-scene driver only), under
    a benchmark that lists it for ``scenes_per_s`` (its files are ready; the
    entry waits, PERF.md section 7)."""
    cell = harness.load_cell("champion_serve_batch16")
    config = copy.deepcopy(cell.config)
    config["architecture"].update(cell.family.TINY)
    traffic = dict(cell.traffic, target=160, pool_scenes=6, scenes_per_request=4,
                   check_requests=5, warmup_requests=1)
    cell = harness.Cell(cell.name, config, traffic, cell.spec, cell.driver, cell.family)
    bench = copy.deepcopy(BENCH)
    next(m for m in bench["end_to_end"] if m["name"] == "scenes_per_s")["workloads"].append(
        cell.name)
    result = harness.run(cell, 2 ** 39 + 7, 0.5, False, 0.0, CPU, benchmark=bench)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"scenes_per_s", "setup_s"}
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 4
