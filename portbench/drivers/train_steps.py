"""Back-to-back train steps through the program's training loop.

Set-up: the configuration's model is built with the program's
``models.build_model`` from the model family's registry entry
(``program_config``), as ``deploy.load_bundle`` builds it, and given weights
drawn on the card from the seed; the recipe's raw training set is made on
the card (``portbench.inputs``); the program normalises it
(``train.loop.prepare_arrays``), builds AdamW and ``make_train_fns``'
``train_epoch``; the first ``checked_steps`` steps run through that same
``train_epoch``, one row of a seeded shuffle each, and what the check needs
is read from them: each step's loss, the first gradient as AdamW holds it
after one step, and each parameter's change after the last of them.

The window hands ``train_epoch`` the following rows of the shuffle in calls
of ``rows_per_call`` rows (a new shuffle when one runs out) until the time is
up, then synchronises. Regeneration, validation and checkpoints are left out.

The check: the plain reference follows the same steps from the same weights
and rows, after the program's state is freed.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from portbench import inputs, weights
from portbench.harness import Phases
from portbench.reference import train as ref_train

UNIT = "step"


def build_model(family, arch: Dict):
    """The program's model of ``arch``, of the model family ``family``."""
    from superresolution_for_pdes_tpu_torch import models

    return models.build_model(**family.program_config(arch))


def _rows(gen: torch.Generator, n: int, batch: int) -> torch.Tensor:
    perm = torch.randperm(n, generator=gen, device=gen.device)
    return perm[: (n // batch) * batch].reshape(-1, batch)


def setup(cell, seed: int, device) -> Dict:
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

    arch, train = cell.config["architecture"], cell.config["train"]
    clock = Phases()
    model = build_model(cell.family, arch).to(device)
    model.load_state_dict(weights.make_state_dict(cell.family, arch, seed, device))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    clock.lap("model")
    raw = inputs.training_set(weights.generator(seed, device, 6), train["data"])
    clock.lap("training set")
    stats = NormStats.from_dataset(raw)
    arrays = loop.prepare_arrays(raw, stats, train["normalization"] == "per_sample",
                                 train["scale_channels"])
    opt = loop.make_optimizer(model, TrainConfig(learning_rate=train["learning_rate"],
                                                 weight_decay=train["weight_decay"]))
    train_epoch, _ = loop.make_train_fns(model, opt, stats, train["physics_weight"],
                                         grad_clip=train["grad_clip"])
    gen = weights.generator(seed, device, 7)
    rows = _rows(gen, raw["u_fine"].shape[0], train["batch_size"])
    clock.lap("arrays and optimizer")
    checked = cell.traffic["checked_steps"]
    beta1 = opt.param_groups[0]["betas"][0]
    losses, first_grad = [], {}
    for s in range(checked):
        losses.append(float(train_epoch(arrays, rows[s:s + 1])))
        if s == 0:
            first_grad = {n: _held_gradient(opt, p, beta1) for n, p in model.named_parameters()}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    del start
    clock.lap("checked steps")
    return {"cell": cell, "seed": seed, "device": device, "model": model, "opt": opt,
            "arrays": arrays, "train_epoch": train_epoch, "raw": raw, "gen": gen,
            "rows": rows, "cursor": checked, "checked_rows": rows[:checked].clone(),
            "program": {"loss": losses, "grad": first_grad, "change": change},
            "phases": clock.seconds}


def _held_gradient(opt, p, beta1: float) -> float:
    """The norm of the gradient AdamW took at its first step, from its first
    moment ``(1 - beta1) g`` (0 where it holds no state: no step was taken)."""
    held = opt.state[p].get("exp_avg")
    return 0.0 if held is None else float(held.norm()) / (1 - beta1)


def _call(state: Dict, n_rows: int) -> int:
    """One ``train_epoch`` call on the next ``n_rows`` rows (fewer where the
    shuffle ends); returns the steps it ran."""
    rows, at = state["rows"], state["cursor"]
    if at >= rows.shape[0]:
        rows = _rows(state["gen"], state["raw"]["u_fine"].shape[0], rows.shape[1])
        state["rows"] = rows
        at = 0
    chunk = rows[at:at + n_rows]
    state["train_epoch"](state["arrays"], chunk)
    state["cursor"] = at + chunk.shape[0]
    return chunk.shape[0]


def window(state: Dict, seconds: float) -> Dict:
    per_call = state["cell"].traffic["rows_per_call"]
    batch = state["rows"].shape[1]
    steps = 0
    sync = state["device"].type == "cuda"
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        steps += _call(state, per_call)
    if sync:
        torch.cuda.synchronize(state["device"])
    elapsed = time.perf_counter() - t0
    return {"attempted": steps, "train_samples_per_s": steps * batch / elapsed}


def traced(state: Dict) -> int:
    n, per_call = state["cell"].traffic["trace_steps"], state["cell"].traffic["rows_per_call"]
    done = 0
    while done < n:
        done += _call(state, min(per_call, n - done))
    return done


def check(state: Dict) -> Dict[str, float]:
    """Gaps of the program's first steps from the reference's (``gaps``),
    read once the program's state is freed."""
    cell, seed, dev = state["cell"], state["seed"], state["device"]
    program, raw, rows = state["program"], state["raw"], state["checked_rows"]
    for key in ("model", "opt", "arrays", "train_epoch", "rows", "gen"):
        state.pop(key)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cell, seed, dev, raw, rows)
    return gaps(program, ref)


def reference_steps(cell, seed: int, device, raw: Dict, rows: torch.Tensor,
                    drop_half: bool = False, dtype: torch.dtype = torch.float32) -> Dict:
    """The reference's loss per step, first-gradient norms and change norms
    over ``rows`` (one step per row), in ``dtype`` at the precision the
    backends are set to; ``drop_half`` leaves out the second half of every
    batch."""
    family, arch, train = cell.family, cell.config["architecture"], cell.config["train"]
    state = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in weights.make_state_dict(family, arch, seed, device).items()}
    raw = {k: v.to(dtype) for k, v in raw.items()}
    kinds = {k: kind for k, _, kind in family.layout(arch)}
    params = {k: v.clone() for k, v in state.items() if kinds[k] in family.TRAINABLE}
    buffers = {k: v for k, v in state.items() if kinds[k] not in family.TRAINABLE}
    start = {k: v.clone() for k, v in params.items()}
    set_stats = ref_train.dataset_stats(raw) if train["normalization"] == "dataset" else None
    opt = ref_train.AdamW(params, train["learning_rate"], train["weight_decay"])
    out = {"loss": [], "grad": {}}
    for s, row in enumerate(rows):
        row = row[: row.shape[0] // 2] if drop_half else row
        batch = ref_train.batch_arrays(raw, row, train, set_stats)
        loss, grads = ref_train.step(lambda p, x: family.forward(arch, p, x, train=True),
                                     params, buffers, opt, batch, train["physics_weight"],
                                     train["grad_clip"])
        out["loss"].append(loss)
        if s == 0:
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
    out["change"] = {k: float((params[k] - start[k]).norm()) for k in params}
    return out


def gaps(program: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared. ``loss_gap``: the first step's loss, relative.
    ``grad_gap``: the widest gap of a leaf's first-gradient norm. ``change_gap``:
    the median, over the leaves, of the gap of a leaf's change norm after the
    checked steps, counting the leaves whose reference gradient is at least a
    thousandth of the median leaf's. A leaf's gap is measured against the
    larger of its reference norm and the median leaf's. (The later steps'
    losses and the widest leaf's change carry the noise of the reference's
    own nondeterministic kernels, which AdamW's first steps amplify:
    ``control.py`` reads them beside these.)"""
    loss = abs(program["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    g_med = statistics.median(ref["grad"].values())
    grad = max(abs(program["grad"][k] - g) / max(g, g_med) for k, g in ref["grad"].items())
    moving = [k for k, g in ref["grad"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in moving)
    change = statistics.median(abs(program["change"][k] - ref["change"][k])
                               / max(ref["change"][k], c_med) for k in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
