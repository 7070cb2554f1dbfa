"""A run with its timed path broken underneath comes out not ``correct``.

Each test drives the harness as ``run.py`` does, past its look for a card,
on the CPU at TINY sizes, with one fault planted in the program for the
whole run: an answer altered where it is produced (serving), a step that
returns its state unchanged, and half of every batch left out with the mean
taken over the rest (training). One chip: no exchange between chips to
leave out.
"""

import json

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _run(cell):
    return harness.run(cell, 2 ** 35 + 17, 0.3, False, 0.0, CPU, benchmark=BENCH)


@pytest.mark.parametrize("cell", ["champion_serve_scene", "champion_serve_refine2"])
def test_an_altered_answer_is_caught(cell, tiny, monkeypatch):
    from superresolution_for_pdes_tpu_torch.cascade import upscale

    real = upscale.ml_cascade

    def altered(*args, **kwargs):
        fields = real(*args, **kwargs)
        last = max(fields)
        fields[last] = fields[last].clone()
        fields[last][0, 0] += 1e-3 * float(fields[last].abs().max())
        return fields

    monkeypatch.setattr(upscale, "ml_cascade", altered)
    result = _run(tiny(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["champion_train_b32", "resnet_train_b32"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, tiny, monkeypatch):
    from superresolution_for_pdes_tpu_torch.train import loop

    def unchanged(model, optimizer, batch, stats, physics_weight=0.0, grad_clip=1.0, dp=None):
        model.train()
        return loop.batch_loss(model, batch, stats, physics_weight).detach()

    monkeypatch.setattr(loop, "train_step", unchanged)
    result = _run(tiny(cell))
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("cell", ["champion_train_b32", "resnet_train_b32"])
def test_half_the_batch_left_out_is_caught(cell, tiny, monkeypatch):
    from superresolution_for_pdes_tpu_torch.train import loop

    real = loop.batch_loss

    def half(model, batch, stats, physics_weight=0.0, use_kernel=None):
        n = batch["x"].shape[0] // 2
        return real(model, {k: v[:n] if v.ndim else v for k, v in batch.items()}, stats,
                    physics_weight, use_kernel)

    monkeypatch.setattr(loop, "batch_loss", half)
    result = _run(tiny(cell))
    assert not result["correct"], result["checks"]


def test_tf32_switched_on_by_the_program_does_not_reach_the_reference(tiny, monkeypatch):
    """A program that turns TF32 on for its own run leaves the reference in
    float32: the harness turns it off again before the check."""
    cell = tiny("champion_serve_scene")
    seen = []
    real = cell.driver.reference_fields

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    monkeypatch.setattr(cell.driver, "reference_fields", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _run(cell)
    assert seen and all(flags == (False, False) for flags in seen)
