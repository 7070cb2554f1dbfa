"""PyTorch port, the train options of the last slice: fused streaming epochs
(``fused_epochs > 1``) against the standard streamed loop and against the JAX
package's rules for a chunk, and TensorBoard mirroring."""

import sys

import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu_torch.data.generate import generate_standard_dataset
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop, train_model
from superresolution_for_pdes_tpu_torch.train.checkpoint import restore_checkpoint
from superresolution_for_pdes_tpu_torch.train.metrics import read_metrics

from torch_port_helpers import TINY


def _tiny_model():
    return AttentionUNet(**TINY, generator=torch.Generator().manual_seed(0))


def _stream(gen):
    return generate_standard_dataset(gen, 24)


def _config(**kw):
    base = dict(batch_size=8, num_epochs=5, stratify_by_subdomain=False, physics_weight=0.3,
                checkpoint_interval=1, plateau_patience=50)
    return TrainConfig(**{**base, **kw})


def test_fused_epochs_equal_the_streamed_loop_bit_for_bit(tmp_path):
    """K = 2 over 5 epochs (chunks 2, 2, 1) against the standard streamed loop,
    with no LR change: the same regenerations and shuffles, so the same
    history, bit for bit; regeneration is not timed apart inside a chunk."""
    dataset = generate_standard_dataset(0, 24, device="cpu")
    runs = {}
    for fused in (0, 2):
        runs[fused] = train_model(dataset, _config(fused_epochs=fused), tmp_path / f"f{fused}",
                                  model=_tiny_model(), verbose=False, dataset_generator=_stream,
                                  device="cpu")
    plain, fused = runs[0], runs[2]
    assert fused["num_epochs"] == 5 and len(set(fused["lr"])) == 1
    for key in ("train_loss", "val_loss", "lr", "train_steps", "eval_chunks"):
        assert fused[key] == plain[key], key
    assert np.isnan(fused["regen_seconds"]).all() and fused["epoch_seconds"][0] > 0
    assert [r["val_loss"] for r in read_metrics(tmp_path / "f2")] == plain["val_loss"]
    for name in ("best_model", "final_model"):
        assert (tmp_path / "f2" / name).exists()
    final = {k: v for k, v in fused["model"].state_dict().items()}
    for name, value in plain["model"].state_dict().items():
        assert torch.equal(final[name], value), name


def test_fused_chunks_follow_the_jax_rules(tmp_path, monkeypatch):
    """A scripted validation sequence through K = 3 chunks, with plateau
    patience 0 and early-stopping patience 3 (JAX ``train/loop.py:423-504``):

    * ``history["lr"]`` records ``plateau.step`` after every epoch;
    * the optimizer's LR changes only at a chunk's end;
    * the best snapshot is the state at the end of the chunk that holds the
      best epoch, with ``early.best_epoch``;
    * an early stop inside a chunk logs the epochs up to the stop and keeps
      the chunk's end state."""
    script = [1.0, 1.2, 0.4, 0.3, 0.35, 0.5, 0.6, 0.9, 0.9]
    seen = {"val": [], "lr": [], "states": []}
    make_train_fns = loop.make_train_fns

    def scripted(model, optimizer, *args, **kwargs):
        train_epoch, _ = make_train_fns(model, optimizer, *args, **kwargs)

        def epoch(arrays, idx, noise=None):
            seen["lr"].append(loop.get_learning_rate(optimizer))
            out = train_epoch(arrays, idx, noise)
            seen["states"].append({k: v.clone() for k, v in model.state_dict().items()})
            return out

        def eval_loss(arrays, read=True):
            value = script[len(seen["val"])]
            seen["val"].append(value)
            return value if read else torch.tensor(value, dtype=torch.float64)

        return epoch, eval_loss

    monkeypatch.setattr(loop, "make_train_fns", scripted)
    dataset = generate_standard_dataset(1, 24, device="cpu")
    config = _config(num_epochs=12, fused_epochs=3, plateau_patience=0,
                     early_stopping_patience=3, learning_rate=1e-3)
    history = train_model(dataset, config, tmp_path, model=_tiny_model(), verbose=False,
                          dataset_generator=_stream, device="cpu")
    # the stop at epoch 6 (three stale epochs after the best, epoch 3) ends chunk 3
    assert history["val_loss"] == script[:7] and history["num_epochs"] == 7
    assert len(seen["states"]) == 9  # the chunk ran to its end
    assert history["lr"] == [1e-3, 5e-4, 5e-4, 5e-4, 2.5e-4, 1.25e-4, 6.25e-5]
    assert seen["lr"] == [1e-3] * 3 + [5e-4] * 3 + [1.25e-4] * 3
    assert loop.get_learning_rate(history["optimizer"]) == 6.25e-5
    assert history["best_epoch"] == 3 and history["best_val_loss"] == 0.3
    chunk_end = seen["states"][5]  # the end of the chunk holding epoch 3
    for name, value in history["best_state"].items():
        assert torch.equal(value, chunk_end[name]), name
    best = restore_checkpoint(tmp_path / "best_model")
    assert best["epoch"] == 3 and best["val_loss"] == 0.3
    assert all(torch.equal(best["model"][k], chunk_end[k]) for k in chunk_end)
    final = restore_checkpoint(tmp_path / "final_model")
    assert final["epoch"] == 6
    assert all(torch.equal(final["model"][k], seen["states"][8][k]) for k in chunk_end)
    assert [r["step"] for r in read_metrics(tmp_path)] == list(range(7))


class _FakeMesh:
    """A 1-D mesh of two ranks, enough for the checks that come before any
    collective."""

    ndim = 1

    def get_group(self):
        return None

    def get_local_rank(self):
        return 0

    def size(self):
        return 2


@pytest.mark.parametrize("kw", [dict(coarse_noise_std=0.1), dict(mesh=_FakeMesh())])
def test_fused_epochs_refuse_noise_and_data_parallelism(tmp_path, kw):
    dataset = generate_standard_dataset(0, 24, device="cpu")
    mesh = kw.pop("mesh", None)
    with pytest.raises(ValueError, match="fused_epochs does not compose"):
        train_model(dataset, _config(fused_epochs=2, **kw), tmp_path, model=_tiny_model(),
                    dataset_generator=_stream, device="cpu", mesh=mesh)


def test_tensorboard_mirrors_the_three_scalars(tmp_path, monkeypatch, capsys):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    dataset = generate_standard_dataset(0, 24, device="cpu")
    config = _config(num_epochs=2, log_tensorboard=True)
    history = train_model(dataset, config, tmp_path / "tb", model=_tiny_model(),
                          verbose=False, device="cpu")
    events = EventAccumulator(str(tmp_path / "tb" / "tensorboard"))
    events.Reload()
    assert set(events.Tags()["scalars"]) == {"train_loss", "val_loss", "learning_rate"}
    assert [e.value for e in events.Scalars("val_loss")] == pytest.approx(history["val_loss"])

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import fails
    history = train_model(dataset, config, tmp_path / "none", model=_tiny_model(),
                          verbose=False, device="cpu")
    assert history["num_epochs"] == 2
    assert "TensorBoard is not written" in capsys.readouterr().out
    assert not (tmp_path / "none" / "tensorboard").exists()
    assert len(read_metrics(tmp_path / "none")) == 2
