"""PyTorch port, the program's spans (``utils/profiling.py::span``): nothing
recorded without a profiler, the cascade's and the train step's span trees
under one, the spans as ``record_function`` events on the profiler's clock,
and (on a card) a kernel launched inside a span running within it on the
same clock. The card's test runs with
``python -m pytest --noconftest -q tests/test_torch_tracing.py``."""

import re
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.resnet import PDEResNet
from superresolution_for_pdes_tpu_torch.models.restormer import Restormer
from superresolution_for_pdes_tpu_torch.models.hat import HAT
from superresolution_for_pdes_tpu_torch.models.swinir import SwinIR
from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop
from superresolution_for_pdes_tpu_torch.utils import profiling
from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans, span

from torch_port_helpers import TINY

PACKAGE = Path(profiling.__file__).resolve().parents[1]
# every span the program opens, and what reads it (PERF.md section 3)
SPAN_NAMES = ("cascade", "cascade.level", "cascade.inputs", "cascade.model", "cascade.stitch",
              "cascade.refine", "cascade.modal", "cascade.replay", "multigrid.vcycle",
              "train.step", "train.forward", "physics.loss", "train.backward", "train.clip",
              "train.optimizer", "swinir.stage", "swinir.attention", "swinir.attention.kernel",
              "hat.cab", "hat.ocab", "hat.ocab.kernel", "restormer.attention", "restormer.ffn",
              "restormer.attention.kernel")


def _opened_in_source():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names.update(re.findall(r'\bspan\("([^"]+)"', path.read_text()))
    return names


def _cascade_run(refine_cycles=1):
    """A two-level cascade (40 -> 80 -> 160) of a TINY random U-Net on two
    scenes, with scalar gains."""
    gen = torch.Generator().manual_seed(0)
    model = AttentionUNet(in_channels=5, generator=gen, **TINY)
    data = {"u": {40: torch.randn(2, 40, 40, generator=gen)},
            "f": {r: torch.randn(2, r, r, generator=gen) for r in (80, 160)},
            "theta": {r: torch.rand(2, r, r, generator=gen) + 0.5 for r in (80, 160)}}
    return lambda: ml_cascade(model, None, data, 160, refine_cycles=refine_cycles,
                              amp_levels=[torch.tensor(1.1), torch.tensor(0.9)])


def _train_run(steps=2):
    """``train_epoch`` over ``steps`` rows of 4 on a TINY ResNet with the
    physics loss."""
    gen = torch.Generator().manual_seed(1)
    model = PDEResNet(in_channels=3, features=8, num_blocks=2, generator=gen)
    n = 4 * steps
    raw = {"u_coarse": torch.randn(n, 20, 20, generator=gen),
           "u_fine": torch.randn(n, 40, 40, generator=gen),
           "f_fine": torch.randn(n, 40, 40, generator=gen),
           "theta_fine": torch.rand(n, 40, 40, generator=gen) + 0.5}
    stats = NormStats.from_dataset(raw)
    arrays = loop.prepare_arrays(raw, stats)
    opt = loop.make_optimizer(model, TrainConfig())
    train_epoch, _ = loop.make_train_fns(model, opt, stats, physics_weight=0.1)
    return lambda: train_epoch(arrays, torch.arange(n).reshape(steps, 4))


def _profiled(run, activities=(ProfilerActivity.CPU,)):
    clear_spans()
    with profile(activities=list(activities)) as prof:
        run()
    return recorded_spans(), prof.profiler.kineto_results.events()


def _children(records, parent):
    return [r for r in records if r.parent == parent.index]


def test_no_profiler_no_spans():
    clear_spans()
    _cascade_run()()
    _train_run()()
    assert recorded_spans() == []
    assert span("cascade") is span("train.step", 4)


def test_the_program_opens_the_documented_spans():
    assert _opened_in_source() == set(SPAN_NAMES)


@pytest.mark.parametrize("name", SPAN_NAMES)
def test_no_span_name_names_a_convolution(name):
    """A reader counts a kernel as a convolution's when a launching operation's
    name contains "conv"."""
    assert "conv" not in name.lower()


def test_swinir_records_a_span_per_group_and_window_attention():
    """Under a profiler, a TINY SwinIR forward opens ``swinir.stage`` per
    residual group (``n``: tokens) and inside it ``swinir.attention`` per
    block (``n``: windows times heads), on the map padded to the window."""
    model = SwinIR(in_channels=5, embed_dim=12, depths=(2, 3), num_heads=(2, 3),
                   window_size=4, generator=torch.Generator().manual_seed(2))
    x = torch.randn(3, 5, 14, 16, generator=torch.Generator().manual_seed(3))
    records, _ = _profiled(lambda: model(x))
    stages = [r for r in records if r.name == "swinir.stage"]
    assert [r.n for r in stages] == [3 * 16 * 16] * 2 and all(r.parent is None for r in stages)
    attention = {s.index: [r.n for r in records if r.name == "swinir.attention"
                           and r.parent == s.index] for s in stages}
    assert list(attention.values()) == [[3 * 16 * 2] * 2, [3 * 16 * 3] * 3]
    assert len(records) == 2 + 5


def test_swinir_kernel_span_never_opens_on_the_twin():
    """``swinir.attention.kernel`` marks the CUDA kernels' path only: a TINY
    SwinIR forward and backward on the CPU (the plain twin) under a profiler
    opens ``swinir.attention`` per block and no kernel span."""
    model = SwinIR(in_channels=5, embed_dim=12, depths=(2,), num_heads=(2,), window_size=4,
                   generator=torch.Generator().manual_seed(4))
    x = torch.randn(2, 5, 8, 12, generator=torch.Generator().manual_seed(5))
    records, _ = _profiled(lambda: model(x).sum().backward())
    names = [r.name for r in records]
    assert names.count("swinir.attention") == 2 and "swinir.attention.kernel" not in names


def test_hat_records_its_blocks_spans():
    """Under a profiler, a TINY HAT forward and backward on the CPU opens per
    group ``swinir.stage`` (``n``: tokens), inside it per HAB
    ``swinir.attention`` (windows times heads) and ``hat.cab`` (tokens), and
    per OCAB ``hat.ocab`` (windows times heads); the twins open no kernel
    span."""
    model = HAT(in_channels=5, embed_dim=12, depths=(2, 3), num_heads=(2, 2), window_size=4,
                squeeze_factor=3, generator=torch.Generator().manual_seed(6))
    x = torch.randn(3, 5, 14, 16, generator=torch.Generator().manual_seed(7))
    records, _ = _profiled(lambda: model(x).sum().backward())
    stages = [r for r in records if r.name == "swinir.stage"]
    assert [r.n for r in stages] == [3 * 16 * 16] * 2 and all(r.parent is None for r in stages)

    def inside(stage, name):
        return [r.n for r in records if r.name == name and r.parent == stage.index]

    assert [inside(s, "swinir.attention") for s in stages] == [[3 * 16 * 2] * 2, [3 * 16 * 2] * 3]
    assert [inside(s, "hat.cab") for s in stages] == [[3 * 16 * 16] * 2, [3 * 16 * 16] * 3]
    assert [inside(s, "hat.ocab") for s in stages] == [[3 * 16 * 2]] * 2
    names = {r.name for r in records}
    assert not names & {"swinir.attention.kernel", "hat.ocab.kernel"}


def test_restormer_records_its_blocks_spans():
    """Under a profiler, a TINY Restormer forward and backward on the CPU
    opens per block ``restormer.attention`` (``n``: samples times heads) and
    ``restormer.ffn`` (``n``: tokens at the block's scale), on the map padded
    to a multiple of 8; the twin opens no kernel span."""
    model = Restormer(in_channels=5, dim=8, num_blocks=(1, 1, 1, 2), num_refinement_blocks=1,
                      heads=(2, 2, 4, 4), generator=torch.Generator().manual_seed(8))
    x = torch.randn(3, 5, 14, 16, generator=torch.Generator().manual_seed(9))
    records, _ = _profiled(lambda: model(x).sum().backward())
    # blocks in forward order: encoders 1-3, latent (2), decoders 3-1, refinement
    heads = [2, 2, 4, 4, 4, 4, 2, 2, 2]
    sides = [16, 8, 4, 2, 2, 4, 8, 16, 16]
    assert [r.n for r in records if r.name == "restormer.attention"] == [3 * h for h in heads]
    assert [r.n for r in records if r.name == "restormer.ffn"] == [3 * s * s for s in sides]
    assert "restormer.attention.kernel" not in {r.name for r in records}


def test_cascade_records_its_span_tree():
    records, _ = _profiled(_cascade_run())
    by_index = {r.index: r for r in records}
    (root,) = [r for r in records if r.parent is None]
    assert (root.name, root.n) == ("cascade", 2)
    assert {r.root for r in records} == {root.index}
    levels = _children(records, root)
    assert [(r.name, r.n) for r in sorted(levels, key=lambda r: r.start_ns)] == \
        [("cascade.level", 80), ("cascade.level", 160)]
    for level, tiles in zip(sorted(levels, key=lambda r: r.start_ns), (2 * 4, 2 * 16)):
        kids = sorted(_children(records, level), key=lambda r: r.start_ns)
        assert [(r.name, r.n) for r in kids] == [
            ("cascade.inputs", tiles), ("cascade.model", tiles), ("cascade.stitch", tiles),
            ("cascade.refine", 1), ("cascade.modal", None)]
        (vcycle,) = _children(records, kids[3])
        assert (vcycle.name, vcycle.n) == ("multigrid.vcycle", None)
    assert len(records) == 1 + 2 * 7
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_index[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert len({r.thread for r in records}) == 1


def test_each_cascade_call_is_its_own_root():
    run = _cascade_run(refine_cycles=0)
    records, _ = _profiled(lambda: (run(), run()))
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["cascade", "cascade"]
    for root in roots:
        assert sum(r.root == root.index for r in records) == 1 + 2 * 5


def test_spans_are_record_function_events_on_the_same_clock():
    records, events = _profiled(_cascade_run())
    marks = sorted((e.name(), e.start_ns()) for e in events
                   if e.name() in SPAN_NAMES and e.device_type() == torch.autograd.DeviceType.CPU)
    ours = sorted((r.name, r.start_ns) for r in records)
    assert [n for n, _ in marks] == [n for n, _ in ours]
    for (_, theirs), (_, start) in zip(marks, ours):
        assert abs(theirs - start) <= 50_000


def test_train_epoch_records_a_root_per_step():
    records, _ = _profiled(_train_run(steps=2))
    roots = sorted((r for r in records if r.parent is None), key=lambda r: r.start_ns)
    assert [(r.name, r.n) for r in roots] == [("train.step", 4), ("train.step", 4)]
    for root in roots:
        step = [r for r in records if r.root == root.index and r is not root]
        assert sorted(r.name for r in step) == sorted(
            ("train.forward", "physics.loss", "train.backward", "train.clip", "train.optimizer"))
        forward = next(r for r in step if r.name == "train.forward")
        assert next(r for r in step if r.name == "physics.loss").parent == forward.index
        assert all(root.start_ns <= r.start_ns and r.end_ns <= root.end_ns for r in step)


def _one_step_span():
    with span("train.step", 1):
        pass


def test_a_thread_keeps_its_own_stack():
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("cascade", 1):
            worker = threading.Thread(target=_one_step_span)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    records = recorded_spans()
    assert sorted((r.name, r.parent) for r in records) == [("cascade", None),
                                                            ("train.step", None)]
    assert len({r.thread for r in records}) == 2


@pytest.mark.cuda
def test_a_kernel_launched_in_a_span_runs_inside_it_on_the_same_clock():
    """``torch.cuda._sleep`` (the profile's only device activity) launched
    inside a span, after a synchronise, under a CUDA-only profiler, starts on
    the device at or after the span's start and no later than 50 us after its
    end: the device's timestamps and the spans' ``time.time_ns()`` share one
    clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()
            with span("cascade.model", 1):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            time.sleep(0.002)
    records = sorted(recorded_spans(), key=lambda r: r.start_ns)
    kernels = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation()), key=lambda e: e.start_ns())
    assert len(records) == len(kernels) == 5
    for r, k in zip(records, kernels):
        assert r.start_ns <= k.start_ns() <= r.end_ns + 50_000, (r, k.start_ns())
