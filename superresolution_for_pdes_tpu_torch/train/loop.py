"""Training loop for the attention U-Net (port of ``train/loop.py``).

MSE on normalized targets plus, with ``physics_weight > 0``, the PDE-residual
term (its stencil is the hand-written kernel K1, forward and backward);
AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay on every parameter,
BatchNorm included); global-norm gradient clipping with optax's formula
(scale by ``max_norm / norm`` once ``norm >= max_norm``); plateau LR halving;
best-val checkpoints; early stopping; full resume.

The whole dataset lives on the device. An epoch is a Python loop of steps
over a shuffled ``(steps, batch)`` index matrix (the JAX package scans it in
one jitted program); losses stay on the device until the epoch's end. With a
``dataset_generator`` the training split is regenerated every ``gen_every``
epochs from a generator seeded by a pure function of the epoch index, so a
resumed run regenerates the sets it would have seen; validation stays on the
fixed split.

Not ported yet (they raise): ``fused_epochs > 1`` with a generator,
TensorBoard, and dtypes other than float32; there is no device mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from superresolution_for_pdes_tpu_torch.data.normalization import (
    NormStats,
    make_model_inputs,
    make_targets,
    per_sample_stats,
)
from superresolution_for_pdes_tpu_torch.data.pipeline import epoch_batch_indices, stratified_split
from superresolution_for_pdes_tpu_torch.device import resolve_device
from superresolution_for_pdes_tpu_torch.physics.loss import pde_residual_loss
from superresolution_for_pdes_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from superresolution_for_pdes_tpu_torch.train.config import TrainConfig
from superresolution_for_pdes_tpu_torch.train.metrics import MetricsLogger, plot_history
from superresolution_for_pdes_tpu_torch.train.schedule import EarlyStopping, ReduceLROnPlateau

Arrays = Dict[str, torch.Tensor]


def make_optimizer(model: nn.Module, config: TrainConfig) -> torch.optim.AdamW:
    """AdamW on every parameter (clipping is :func:`clip_by_global_norm_`)."""
    return torch.optim.AdamW(model.parameters(), lr=config.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=config.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def clip_by_global_norm_(parameters, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``max_norm / norm`` when the global norm is at
    least ``max_norm`` (``optax.clip_by_global_norm``; PyTorch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6``). Returns the norm; no
    host synchronization."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by a pure function of ``(seed, epoch)``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _physics_stats(batch: Arrays, stats: NormStats) -> NormStats:
    """Per-sample stats travel in the batch (theta mean 0, std 1); dataset
    normalization uses the fixed split stats."""
    if "u_std" not in batch:
        return stats
    return NormStats(
        u_mean=batch["u_mean"], u_std=batch["u_std"],
        f_mean=batch["f_mean"], f_std=batch["f_std"],
        theta_mean=torch.zeros_like(batch["u_mean"]),
        theta_std=torch.ones_like(batch["u_std"]),
        theta_is_constant=torch.ones((), dtype=torch.bool, device=batch["u_std"].device),
    )


def batch_loss(model: nn.Module, batch: Arrays, stats: NormStats, physics_weight: float = 0.0,
               use_kernel: bool | None = None) -> torch.Tensor:
    """MSE of the normalized prediction, plus ``physics_weight`` times the
    PDE residual (K1 unless ``use_kernel`` is False)."""
    pred = model(batch["x"])
    loss = torch.mean((pred - batch["y"]) ** 2)
    if physics_weight > 0.0:
        loss = loss + physics_weight * pde_residual_loss(
            pred, batch["theta"], batch["f"], _physics_stats(batch, stats), use_kernel)
    return loss


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: Arrays,
               stats: NormStats, physics_weight: float = 0.0,
               grad_clip: float = 1.0) -> torch.Tensor:
    """One step: forward in training mode, backward, clip, AdamW. Returns the
    loss as a 0-d device tensor."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = batch_loss(model, batch, stats, physics_weight)
    loss.backward()
    clip_by_global_norm_(model.parameters(), grad_clip)
    optimizer.step()
    return loss.detach()


def eval_chunk_size(n: int, height: int, width: int, eval_chunk: int = 1024) -> int:
    """Samples per validation chunk: ``eval_chunk`` is a budget in 40x40
    samples, scaled down by the input area."""
    return min(max(1, (eval_chunk * 40 * 40) // (height * width)), n)


def make_train_fns(model: nn.Module, optimizer: torch.optim.Optimizer, stats: NormStats,
                   physics_weight: float = 0.0, coarse_noise_std: float = 0.0,
                   eval_chunk: int = 1024,
                   grad_clip: float = 1.0) -> Tuple[Callable, Callable]:
    """``(train_epoch, eval_loss)``.

    ``train_epoch(arrays, idx_matrix, noise_generator=None)`` runs one step
    per row of ``idx_matrix`` and returns the mean loss (0-d device tensor).
    With ``coarse_noise_std > 0`` and a generator, Gaussian noise of that std
    is added to the upsampled-coarse input channel of every batch.
    ``eval_loss(arrays)`` is the sample-weighted mean loss over chunks of
    :func:`eval_chunk_size` samples, in evaluation mode, as a float.
    """

    def train_epoch(arrays: Arrays, idx_matrix: torch.Tensor,
                    noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        total = torch.zeros((), device=idx_matrix.device)
        for idx in idx_matrix:
            batch = {k: v[idx] for k, v in arrays.items()}
            if coarse_noise_std > 0.0 and noise_generator is not None:
                x = batch["x"]
                x[:, 0] += coarse_noise_std * torch.randn(
                    x[:, 0].shape, generator=noise_generator, dtype=x.dtype, device=x.device)
            total += train_step(model, optimizer, batch, stats, physics_weight, grad_clip)
        return total / idx_matrix.shape[0]

    def eval_loss(arrays: Arrays) -> float:
        x = arrays["x"]
        n = x.shape[0]
        chunk = eval_chunk_size(n, x.shape[-2], x.shape[-1], eval_chunk)
        model.eval()
        total = torch.zeros((), device=x.device)
        with torch.no_grad():
            for start in range(0, n, chunk):
                batch = {k: v[start:start + chunk] for k, v in arrays.items()}
                total += batch_loss(model, batch, stats, physics_weight) * batch["x"].shape[0]
        return float(total / n)

    return train_epoch, eval_loss


def prepare_arrays(dataset: Arrays, stats: NormStats, per_sample: bool = False,
                   scale_channels: bool = False) -> Arrays:
    """Normalized NCHW inputs ``x`` and targets ``y`` plus the physical
    ``theta`` and ``f``; with ``per_sample`` every sample is normalized with
    its own stats, which the arrays carry for the physics term."""
    if per_sample:
        stats = per_sample_stats(dataset["u_coarse"], dataset["f_fine"], dataset["theta_fine"])
    arrays = {
        "x": make_model_inputs(dataset["u_coarse"], dataset["f_fine"], dataset["theta_fine"],
                               stats, scale_channels=scale_channels).contiguous(),
        "y": make_targets(dataset["u_fine"], stats).contiguous(),
        "theta": dataset["theta_fine"].contiguous(),
        "f": dataset["f_fine"].contiguous(),
    }
    if per_sample:
        arrays.update(u_mean=stats.u_mean, u_std=stats.u_std,
                      f_mean=stats.f_mean, f_std=stats.f_std)
    return arrays


def _split(dataset: Arrays, config: TrainConfig) -> Tuple[np.ndarray, np.ndarray]:
    n = int(dataset["u_fine"].shape[0])
    flags = dataset.get("is_subdomain")
    flags = np.zeros(n, bool) if flags is None else flags.cpu().numpy().astype(bool)
    if config.stratify_by_subdomain and flags.any():
        train_idx, val_idx = stratified_split(config.seed, flags, config.val_split)
    else:
        perm = np.random.default_rng(config.seed).permutation(n)
        n_val = int(n * config.val_split)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
    if len(val_idx) == 0:
        raise ValueError(
            f"the validation split of {n} samples at val_split={config.val_split} is empty; "
            "grow the dataset or raise val_split")
    return train_idx, val_idx


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_snapshot(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    return {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "optimizer": copy.deepcopy(optimizer.state_dict())}


def _stats_dict(stats: NormStats) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in dataclasses.asdict(stats).items()}


def _save_best(run_dir: Path, snapshot: Dict[str, Any], stats: NormStats) -> None:
    save_checkpoint(run_dir / "best_model", {
        "model": snapshot["state"]["model"],
        "optimizer": snapshot["state"]["optimizer"],
        "epoch": snapshot["epoch"],
        "train_loss": snapshot["train_loss"],
        "val_loss": snapshot["val_loss"],
        "plateau": snapshot["plateau"],
        "early": snapshot["early"],
        "norm_stats": _stats_dict(stats),
    })


def _check_supported(config: TrainConfig, streaming: bool) -> None:
    not_ported = []
    if config.dtype != "float32":
        not_ported.append(f"dtype {config.dtype!r}")
    if config.log_tensorboard:
        not_ported.append("TensorBoard logging")
    if streaming and int(config.fused_epochs or 0) > 1:
        not_ported.append("fused_epochs > 1")
    if not_ported:
        raise NotImplementedError(
            f"{', '.join(not_ported)}: not yet ported to PyTorch (see ROADMAP.md)")


def train_model(dataset: Arrays, config: TrainConfig, run_dir, model: Optional[nn.Module] = None,
                verbose: bool = True, resume_from: Optional[str] = None,
                dataset_generator: Optional[Callable[[torch.Generator], Arrays]] = None,
                device=None) -> Dict[str, Any]:
    """Full training job: split -> normalize -> epochs -> checkpoints.

    Stratified 80/20 split (the non-stratified split raises when it leaves no
    validation sample), normalization stats from the training split, per-epoch
    train/val losses, plateau LR, early stopping, ``best_model/`` and
    ``final_model/`` checkpoints, ``config.json`` and ``metrics.jsonl`` in
    ``run_dir``.

    ``model`` gives the architecture and its initial weights; by default the
    registry's ``config.model`` is built with weights drawn from
    ``config.seed``. ``resume_from`` restores model, optimizer, plateau and
    early-stopping state and the epoch from a checkpoint directory; the
    schedules' hyperparameters come from ``config``. ``dataset_generator(gen)``
    returns a fresh training set of fixed size from a ``torch.Generator``.
    Everything runs on ``device`` (default ``cuda``; raises without a card).

    The returned history holds per-epoch ``train_loss``, ``val_loss``, ``lr``,
    ``train_steps``, ``eval_chunks``, ``regen_seconds`` (0 where nothing was
    regenerated) and ``epoch_seconds``, plus the best epoch, the model, the
    best state and the stats.
    """
    device = resolve_device(device)
    _check_supported(config, dataset_generator is not None)
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    config.to_json(run_dir / "config.json")
    logger = MetricsLogger(run_dir)

    dataset = {k: v.to(device) for k, v in dataset.items()}
    train_idx, val_idx = _split(dataset, config)
    train_ds = {k: v[torch.as_tensor(train_idx, device=device)] for k, v in dataset.items()}
    val_ds = {k: v[torch.as_tensor(val_idx, device=device)] for k, v in dataset.items()}
    stats = NormStats.from_dataset(train_ds)
    per_sample = config.normalization == "per_sample"

    if model is None:
        from superresolution_for_pdes_tpu_torch.models.registry import build_model

        overrides = {"in_channels": 5} if config.scale_channels else {}
        if config.model_norm != "batch":
            overrides["norm"] = config.model_norm
        model = build_model(config.model, generator=torch.Generator().manual_seed(config.seed),
                            **overrides)
    model = model.to(device)
    scale_channels = model.in_channels > 3
    train_arrays = prepare_arrays(train_ds, stats, per_sample, scale_channels)
    val_arrays = prepare_arrays(val_ds, stats, per_sample, scale_channels)
    optimizer = make_optimizer(model, config)
    train_epoch, eval_loss = make_train_fns(
        model, optimizer, stats, config.physics_weight,
        coarse_noise_std=config.coarse_noise_std, grad_clip=config.grad_clip)

    plateau = ReduceLROnPlateau(lr=config.learning_rate, factor=config.plateau_factor,
                                patience=config.plateau_patience, min_lr=config.min_lr)
    early = EarlyStopping(patience=config.early_stopping_patience)
    start_epoch = 0
    if resume_from is not None:
        restored = restore_checkpoint(resume_from, map_location=device)
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        plateau = ReduceLROnPlateau.from_state_dict(restored["plateau"])
        plateau.factor = config.plateau_factor
        plateau.patience = config.plateau_patience
        plateau.min_lr = config.min_lr
        early = EarlyStopping.from_state_dict(restored["early"])
        early.patience = config.early_stopping_patience
        start_epoch = int(restored["epoch"]) + 1
        if verbose:
            print(f"resumed from {resume_from} at epoch {start_epoch + 1}")

    history = {k: [] for k in ("train_loss", "val_loss", "lr", "train_steps", "eval_chunks",
                               "regen_seconds", "epoch_seconds")}
    n_train = len(train_idx)
    n_val = len(val_idx)
    val_chunk = eval_chunk_size(n_val, *val_arrays["x"].shape[-2:])
    best_snapshot = None
    last_ckpt_epoch = -(10**9)
    gen_every = max(1, int(config.gen_every or 1))
    last_gen_epoch = None
    for epoch in range(start_epoch, config.num_epochs):
        t_epoch = time.perf_counter()
        regen_s = 0.0
        if dataset_generator is not None and (
                last_gen_epoch is None or epoch - last_gen_epoch >= gen_every):
            t0 = time.perf_counter()
            fresh = dataset_generator(epoch_generator(config.seed + 2, epoch, device))
            train_arrays = prepare_arrays(fresh, stats, per_sample, scale_channels)
            n_train = int(fresh["u_fine"].shape[0])
            del fresh
            _synchronize(device)
            regen_s = time.perf_counter() - t0
            last_gen_epoch = epoch
        idx_matrix = epoch_batch_indices(epoch_generator(config.seed + 1, epoch, device),
                                         n_train, config.batch_size)
        noise_gen = (epoch_generator(config.seed + 3, epoch, device)
                     if config.coarse_noise_std > 0.0 else None)
        train_loss = float(train_epoch(train_arrays, idx_matrix, noise_gen))
        val_loss = eval_loss(val_arrays)

        new_lr = plateau.step(val_loss)
        if new_lr != get_learning_rate(optimizer):
            set_learning_rate(optimizer, new_lr)
        epoch_s = time.perf_counter() - t_epoch
        for key, value in (("train_loss", train_loss), ("val_loss", val_loss), ("lr", new_lr),
                           ("train_steps", int(idx_matrix.shape[0])),
                           ("eval_chunks", math.ceil(n_val / val_chunk)),
                           ("regen_seconds", regen_s), ("epoch_seconds", epoch_s)):
            history[key].append(value)
        logger.log(epoch, {"train_loss": train_loss, "val_loss": val_loss,
                           "learning_rate": new_lr})
        if verbose:
            print(f"epoch {epoch + 1}/{config.num_epochs}: train {train_loss:.6f} "
                  f"val {val_loss:.6f} lr {new_lr:.2e} ({epoch_s:.1f} s, regen {regen_s:.1f} s)")

        stop = early.step(val_loss, epoch)
        if early.improved:
            best_snapshot = {
                "state": _state_snapshot(model, optimizer),
                "epoch": epoch,
                "train_loss": train_loss,
                "val_loss": val_loss,
                "plateau": plateau.state_dict(),
                "early": early.state_dict(),
            }
            due = epoch - last_ckpt_epoch >= config.checkpoint_interval
            if config.checkpoint_every_best and due:
                _save_best(run_dir, best_snapshot, stats)
                last_ckpt_epoch = epoch
        if stop:
            if verbose:
                print(f"early stopping after {epoch + 1} epochs")
            break

    return _finalize(run_dir, config, model, optimizer, stats, history, early, plateau,
                     best_snapshot, start_epoch)


def _finalize(run_dir, config, model, optimizer, stats, history, early, plateau,
              best_snapshot, start_epoch) -> Dict[str, Any]:
    """Final and best checkpoints, the history plot, and the history dict."""
    if best_snapshot is not None and config.checkpoint_every_best:
        _save_best(run_dir, best_snapshot, stats)
    save_checkpoint(run_dir / "final_model", {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": len(history["train_loss"]) + start_epoch - 1,
        "train_loss": history["train_loss"][-1],
        "val_loss": history["val_loss"][-1],
        "best_val_loss": early.best,
        "best_epoch": early.best_epoch,
        "plateau": plateau.state_dict(),
        "early": early.state_dict(),
        "norm_stats": _stats_dict(stats),
    })
    plot_history(run_dir)
    history["best_val_loss"] = early.best
    history["best_epoch"] = early.best_epoch
    history["num_epochs"] = len(history["train_loss"])
    history["model"] = model
    history["optimizer"] = optimizer
    history["best_state"] = (best_snapshot["state"]["model"] if best_snapshot is not None
                             else model.state_dict())
    history["stats"] = stats
    history["run_dir"] = run_dir
    return history
