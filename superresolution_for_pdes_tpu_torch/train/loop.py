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
fixed split. With ``fused_epochs = K > 1`` and a generator, epochs run in
chunks of K with no host read inside a chunk (:func:`_train_fused`).

``config.dtype`` is ``float32`` or ``bfloat16``. In bfloat16 the arrays are
stored in bf16 (:func:`prepare_arrays`) and the forward and the loss run
under ``torch.autocast`` (:func:`batch_loss`): convolutions, resizes and
activations compute in bf16, BatchNorm takes its statistics in float32, the
physics loss runs K1's bf16 instantiation, and parameters, gradients and the
optimizer state stay float32, as with Flax's ``dtype=bfloat16``.

With a ``mesh`` (a 1-D ``DeviceMesh`` of ``parallel.data_mesh``) the run is
data-parallel over its process group (:mod:`~superresolution_for_pdes_tpu_torch.parallel.data`):
each rank steps on its part of every global batch with global BatchNorm
statistics and the group-mean gradient, validation is split over the ranks
and summed, and only rank 0 writes the run's files.
"""

from __future__ import annotations

import contextlib
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
from superresolution_for_pdes_tpu_torch.device import resolve_device, synchronize
from superresolution_for_pdes_tpu_torch.parallel import data as dpar
from superresolution_for_pdes_tpu_torch.physics.loss import pde_residual_loss
from superresolution_for_pdes_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from superresolution_for_pdes_tpu_torch.train.config import TrainConfig
from superresolution_for_pdes_tpu_torch.train.metrics import MetricsLogger, plot_history
from superresolution_for_pdes_tpu_torch.train.schedule import EarlyStopping, ReduceLROnPlateau
from superresolution_for_pdes_tpu_torch.utils.profiling import span

Arrays = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def train_dtype(name: str) -> torch.dtype:
    """The storage and compute dtype of ``config.dtype``."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r}: training runs in float32 or bfloat16") from None


def _autocast(x: torch.Tensor):
    """bfloat16 autocast on ``x``'s device for bf16 arrays; nothing otherwise."""
    if x.dtype != torch.bfloat16:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=torch.bfloat16)


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
    PDE residual (K1 unless ``use_kernel`` is False). Arrays in bfloat16 run
    the forward and the loss under bf16 autocast."""
    with _autocast(batch["x"]):
        pred = model(batch["x"])
        loss = torch.mean((pred - batch["y"]) ** 2)
        if physics_weight > 0.0:
            loss = loss + physics_weight * pde_residual_loss(
                pred, batch["theta"], batch["f"], _physics_stats(batch, stats), use_kernel)
    return loss


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: Arrays,
               stats: NormStats, physics_weight: float = 0.0,
               grad_clip: float = 1.0, dp: dpar.DataGroup | None = None) -> torch.Tensor:
    """One step: forward in training mode, backward, clip, AdamW. Returns the
    loss (of this rank's part of the batch, under ``dp``) as a 0-d device
    tensor. Under ``dp`` the gradients are the group's mean before the clip."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with span("train.forward"):
        loss = batch_loss(model, batch, stats, physics_weight)
    with span("train.backward"):
        loss.backward()
    with span("train.clip"):
        dpar.all_reduce_gradients(model.parameters(), dp)
        clip_by_global_norm_(model.parameters(), grad_clip)
    with span("train.optimizer"):
        optimizer.step()
    return loss.detach()


def eval_chunk_size(n: int, height: int, width: int, eval_chunk: int = 1024) -> int:
    """Samples per validation chunk: ``eval_chunk`` is a budget in 40x40
    samples, scaled down by the input area."""
    return min(max(1, (eval_chunk * 40 * 40) // (height * width)), n)


def make_train_fns(model: nn.Module, optimizer: torch.optim.Optimizer, stats: NormStats,
                   physics_weight: float = 0.0, coarse_noise_std: float = 0.0,
                   eval_chunk: int = 1024, grad_clip: float = 1.0,
                   dp: dpar.DataGroup | None = None) -> Tuple[Callable, Callable]:
    """``(train_epoch, eval_loss)``.

    ``train_epoch(arrays, idx_matrix, noise_generator=None)`` runs one step
    per row of ``idx_matrix`` and returns the mean loss (0-d device tensor).
    With ``coarse_noise_std > 0`` and a generator, Gaussian noise of that std
    is added to the upsampled-coarse input channel of every batch.
    ``eval_loss(arrays, read=True)`` is the sample-weighted mean loss over
    chunks of :func:`eval_chunk_size` samples, in evaluation mode, as a float
    or (``read=False``) a 0-d device tensor, with no host read.

    Under ``dp`` each step trains on this rank's rows of the batch (the batch
    size must divide by the world size) and returns the group's mean loss
    at the epoch's end; ``eval_loss`` evaluates this rank's contiguous part of
    the arrays and sums the parts over the group.
    """

    def train_epoch(arrays: Arrays, idx_matrix: torch.Tensor,
                    noise_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        total = torch.zeros((), device=idx_matrix.device)
        for idx in idx_matrix:
            with span("train.step", idx.shape[0]):
                batch = {k: v[dpar.shard_rows(idx, dp)] for k, v in arrays.items()}
                if coarse_noise_std > 0.0 and noise_generator is not None:
                    x = batch["x"]
                    x[:, 0] += coarse_noise_std * torch.randn(
                        x[:, 0].shape, generator=noise_generator, dtype=x.dtype, device=x.device)
                total += train_step(model, optimizer, batch, stats, physics_weight, grad_clip, dp)
        if dp is not None:
            total = dpar.all_reduce_sum(total, dp) / dp.world
        return total / idx_matrix.shape[0]

    def eval_loss(arrays: Arrays, read: bool = True):
        x = arrays["x"]
        n = x.shape[0]
        lo, hi = (0, n) if dp is None else (dp.rank * n // dp.world,
                                            (dp.rank + 1) * n // dp.world)
        chunk = eval_chunk_size(max(hi - lo, 1), x.shape[-2], x.shape[-1], eval_chunk)
        model.eval()
        total = torch.zeros((), device=x.device)
        with torch.no_grad():
            for start in range(lo, hi, chunk):
                batch = {k: v[start:min(start + chunk, hi)] for k, v in arrays.items()}
                total += batch_loss(model, batch, stats, physics_weight) * batch["x"].shape[0]
        loss = dpar.all_reduce_sum(total, dp) / n
        return float(loss) if read else loss

    return train_epoch, eval_loss


def prepare_arrays(dataset: Arrays, stats: NormStats, per_sample: bool = False,
                   scale_channels: bool = False, dtype: torch.dtype = torch.float32) -> Arrays:
    """Normalized NCHW inputs ``x`` and targets ``y`` plus the physical
    ``theta`` and ``f``; with ``per_sample`` every sample is normalized with
    its own stats, which the arrays carry for the physics term. Everything is
    computed in float32 and stored in ``dtype`` (the JAX package's casts)."""
    if per_sample:
        stats = per_sample_stats(dataset["u_coarse"], dataset["f_fine"], dataset["theta_fine"])
    arrays = {
        "x": make_model_inputs(dataset["u_coarse"], dataset["f_fine"], dataset["theta_fine"],
                               stats, scale_channels=scale_channels),
        "y": make_targets(dataset["u_fine"], stats),
        "theta": dataset["theta_fine"],
        "f": dataset["f_fine"],
    }
    if per_sample:
        arrays.update(u_mean=stats.u_mean, u_std=stats.u_std,
                      f_mean=stats.f_mean, f_std=stats.f_std)
    return {k: v.to(dtype).contiguous() for k, v in arrays.items()}


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


def train_model(dataset: Arrays, config: TrainConfig, run_dir, model: Optional[nn.Module] = None,
                verbose: bool = True, resume_from: Optional[str] = None,
                dataset_generator: Optional[Callable[[torch.Generator], Arrays]] = None,
                device=None, mesh=None) -> Dict[str, Any]:
    """Full training job: split -> normalize -> epochs -> checkpoints.

    Stratified 80/20 split (the non-stratified split raises when it leaves no
    validation sample), normalization stats from the training split, per-epoch
    train/val losses, plateau LR, early stopping, ``best_model/`` and
    ``final_model/`` checkpoints, ``config.json`` and ``metrics.jsonl`` (and,
    with ``config.log_tensorboard``, TensorBoard events) in ``run_dir``.

    ``model`` gives the architecture and its initial weights; by default the
    registry's ``config.model`` is built with weights drawn from
    ``config.seed``. ``resume_from`` restores model, optimizer, plateau and
    early-stopping state and the epoch from a checkpoint directory; the
    schedules' hyperparameters come from ``config``. ``dataset_generator(gen)``
    returns a fresh training set of fixed size from a ``torch.Generator``;
    with ``config.fused_epochs > 1`` it runs the fused loop
    (:func:`_train_fused`). Everything runs on ``device`` (default ``cuda``;
    raises without a card). ``mesh`` (a 1-D ``DeviceMesh``) makes the run
    data-parallel over its group (module docstring).

    The returned history holds per-epoch ``train_loss``, ``val_loss``, ``lr``,
    ``train_steps``, ``eval_chunks``, ``regen_seconds`` (0 where nothing was
    regenerated; NaN inside a fused chunk, where it is not timed apart) and
    ``epoch_seconds``, plus the best epoch, the model, the best state and the
    stats.
    """
    device = resolve_device(device)
    dtype = train_dtype(config.dtype)
    dp = dpar.data_group(mesh)
    fused = int(config.fused_epochs or 0) > 1 and dataset_generator is not None
    if fused and (dp is not None or config.coarse_noise_std > 0.0):
        raise ValueError("fused_epochs does not compose with data parallelism or "
                         "coarse_noise_std")
    if dp is not None and config.batch_size % dp.world:
        raise ValueError(f"batch_size {config.batch_size} does not divide over the "
                         f"{dp.world} ranks of the data-parallel group")
    writer = dpar.is_writer(dp)
    run_dir = Path(run_dir)
    if writer:
        run_dir.mkdir(parents=True, exist_ok=True)
        config.to_json(run_dir / "config.json")
    logger = MetricsLogger(run_dir, tensorboard=config.log_tensorboard) if writer else None

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
    dpar.broadcast_module(model, dp)
    dpar.sync_batch_norm(model, dp)
    scale_channels = model.in_channels > 3

    def prepare(ds: Arrays) -> Arrays:
        return prepare_arrays(ds, stats, per_sample, scale_channels, dtype)

    train_arrays = prepare(train_ds)
    val_arrays = prepare(val_ds)
    optimizer = make_optimizer(model, config)
    train_epoch, eval_loss = make_train_fns(
        model, optimizer, stats, config.physics_weight,
        coarse_noise_std=config.coarse_noise_std, grad_clip=config.grad_clip, dp=dp)

    plateau = ReduceLROnPlateau(lr=config.learning_rate, factor=config.plateau_factor,
                                patience=config.plateau_patience, min_lr=config.min_lr)
    early = EarlyStopping(patience=config.early_stopping_patience)
    start_epoch = 0
    if resume_from is not None:
        dpar.barrier(dp)
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
        if verbose and writer:
            print(f"resumed from {resume_from} at epoch {start_epoch + 1}")

    n_val = len(val_idx) if dp is None else max(len(val_idx) // dp.world, 1)  # per rank
    eval_chunks = math.ceil(n_val / eval_chunk_size(n_val, *val_arrays["x"].shape[-2:]))
    run = _Run(config, device, run_dir, model, optimizer, stats, plateau, early, logger,
               verbose and writer, writer, eval_chunks)
    if fused:
        _train_fused(run, start_epoch, dataset_generator, prepare, train_epoch, eval_loss,
                     val_arrays)
    else:
        _train_epochs(run, start_epoch, dataset_generator, prepare, train_epoch, eval_loss,
                      train_arrays, val_arrays, len(train_idx))
    history = _finalize(run_dir, config, model, optimizer, stats, run.history, early, plateau,
                        run.best_snapshot, start_epoch, writer)
    if logger is not None:
        logger.close()
    dpar.sync_batch_norm(model, None)
    return history


@dataclasses.dataclass
class _Run:
    """What the epoch loops share: the job, its schedules and its records."""

    config: TrainConfig
    device: torch.device
    run_dir: Path
    model: nn.Module
    optimizer: torch.optim.Optimizer
    stats: NormStats
    plateau: ReduceLROnPlateau
    early: EarlyStopping
    logger: Optional[MetricsLogger]
    verbose: bool
    writer: bool
    eval_chunks: int
    history: Dict[str, list] = dataclasses.field(default_factory=lambda: {
        k: [] for k in ("train_loss", "val_loss", "lr", "train_steps", "eval_chunks",
                        "regen_seconds", "epoch_seconds")})
    best_snapshot: Optional[Dict[str, Any]] = None
    last_ckpt_epoch: int = -(10**9)

    def record(self, epoch: int, train_loss: float, val_loss: float, lr: float, steps: int,
               regen_s: float, epoch_s: float) -> None:
        for key, value in (("train_loss", train_loss), ("val_loss", val_loss), ("lr", lr),
                           ("train_steps", steps), ("eval_chunks", self.eval_chunks),
                           ("regen_seconds", regen_s), ("epoch_seconds", epoch_s)):
            self.history[key].append(value)
        if self.logger is not None:
            self.logger.log(epoch, {"train_loss": train_loss, "val_loss": val_loss,
                                    "learning_rate": lr})
        if self.verbose:
            print(f"epoch {epoch + 1}/{self.config.num_epochs}: train {train_loss:.6f} "
                  f"val {val_loss:.6f} lr {lr:.2e} ({epoch_s:.1f} s, regen {regen_s:.1f} s)")

    def keep_best(self, epoch: int, last_epoch: int, train_loss: float) -> None:
        """Snapshot the current state as the best (of ``epoch``); write it when
        ``checkpoint_interval`` epochs have passed since the last write at
        ``last_epoch``."""
        self.best_snapshot = {
            "state": _state_snapshot(self.model, self.optimizer),
            "epoch": epoch,
            "train_loss": train_loss,
            "val_loss": self.early.best,
            "plateau": self.plateau.state_dict(),
            "early": self.early.state_dict(),
        }
        due = last_epoch - self.last_ckpt_epoch >= self.config.checkpoint_interval
        if self.config.checkpoint_every_best and due:
            if self.writer:
                _save_best(self.run_dir, self.best_snapshot, self.stats)
            self.last_ckpt_epoch = last_epoch


def _train_epochs(run: _Run, start_epoch: int, dataset_generator, prepare, train_epoch,
                  eval_loss, train_arrays: Arrays, val_arrays: Arrays, n_train: int) -> None:
    """The standard loop: one epoch at a time, the LR changed after each."""
    config, device = run.config, run.device
    gen_every = max(1, int(config.gen_every or 1))
    last_gen_epoch = None
    for epoch in range(start_epoch, config.num_epochs):
        t_epoch = time.perf_counter()
        regen_s = 0.0
        if dataset_generator is not None and (
                last_gen_epoch is None or epoch - last_gen_epoch >= gen_every):
            t0 = time.perf_counter()
            fresh = dataset_generator(epoch_generator(config.seed + 2, epoch, device))
            train_arrays = prepare(fresh)
            n_train = int(fresh["u_fine"].shape[0])
            del fresh
            synchronize(device)
            regen_s = time.perf_counter() - t0
            last_gen_epoch = epoch
        idx_matrix = epoch_batch_indices(epoch_generator(config.seed + 1, epoch, device),
                                         n_train, config.batch_size)
        noise_gen = (epoch_generator(config.seed + 3, epoch, device)
                     if config.coarse_noise_std > 0.0 else None)
        train_loss = float(train_epoch(train_arrays, idx_matrix, noise_gen))
        val_loss = eval_loss(val_arrays)

        new_lr = run.plateau.step(val_loss)
        if new_lr != get_learning_rate(run.optimizer):
            set_learning_rate(run.optimizer, new_lr)
        run.record(epoch, train_loss, val_loss, new_lr, int(idx_matrix.shape[0]), regen_s,
                   time.perf_counter() - t_epoch)
        stop = run.early.step(val_loss, epoch)
        if run.early.improved:
            run.keep_best(epoch, epoch, train_loss)
        if stop:
            if run.verbose:
                print(f"early stopping after {epoch + 1} epochs")
            break


def _train_fused(run: _Run, start_epoch: int, dataset_generator, prepare, train_epoch,
                 eval_loss, val_arrays: Arrays) -> None:
    """Streamed epochs in chunks of ``config.fused_epochs`` (the JAX
    package's one-program chunk): regenerate -> prepare -> train epoch ->
    validate, K times back to back with the losses kept on the device, then
    one host read of the chunk's 2K losses. Every epoch regenerates from the
    standard loop's draws (``gen_every`` is not read), so without an LR
    change inside a chunk the history equals the standard loop's. As in JAX:
    the plateau's LR changes take effect at the chunk's end (``history["lr"]``
    still records its value after every epoch), the best snapshot is the
    state at the end of the chunk that holds the best epoch, and an early
    stop inside a chunk ends the run with that chunk's state, the history
    cut at the stop."""
    config, device = run.config, run.device
    epoch, stopped = start_epoch, False
    while epoch < config.num_epochs and not stopped:
        k = min(int(config.fused_epochs), config.num_epochs - epoch)
        t0 = time.perf_counter()
        losses, steps = [], []
        for e in range(epoch, epoch + k):
            fresh = dataset_generator(epoch_generator(config.seed + 2, e, device))
            arrays = prepare(fresh)
            n_train = int(fresh["u_fine"].shape[0])
            del fresh
            idx_matrix = epoch_batch_indices(epoch_generator(config.seed + 1, e, device),
                                             n_train, config.batch_size)
            losses += [train_epoch(arrays, idx_matrix), eval_loss(val_arrays, read=False)]
            steps.append(int(idx_matrix.shape[0]))
        values = torch.stack(losses).tolist()  # the chunk's one host read
        epoch_s = (time.perf_counter() - t0) / k
        chunk_improved = False
        for j in range(k):
            train_loss, val_loss = values[2 * j], values[2 * j + 1]
            new_lr = run.plateau.step(val_loss)
            run.record(epoch + j, train_loss, val_loss, new_lr, steps[j], math.nan, epoch_s)
            stopped = run.early.step(val_loss, epoch + j)
            chunk_improved |= run.early.improved
            if stopped:
                break
        if run.plateau.lr != get_learning_rate(run.optimizer):
            set_learning_rate(run.optimizer, run.plateau.lr)
        if chunk_improved:
            run.keep_best(run.early.best_epoch, epoch + k - 1, values[2 * (k - 1)])
        epoch += k
        if stopped and run.verbose:
            print(f"early stopping after {len(run.history['val_loss']) + start_epoch} epochs")


def _finalize(run_dir, config, model, optimizer, stats, history, early, plateau,
              best_snapshot, start_epoch, writer: bool = True) -> Dict[str, Any]:
    """Final and best checkpoints and the history plot (by the writing
    process), and the history dict."""
    if writer:
        _write_final(run_dir, config, model, optimizer, stats, history, early, plateau,
                     best_snapshot, start_epoch)
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


def _write_final(run_dir, config, model, optimizer, stats, history, early, plateau,
                 best_snapshot, start_epoch) -> None:
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
