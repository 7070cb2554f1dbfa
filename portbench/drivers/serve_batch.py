"""Serving batches of scenes through the program's cascade, closed loop: the
regime of ``statistical`` evaluation and of ``calibrate_modal`` over many
scenes.

Set-up is ``serve_cascade.py``'s (the bundle saved and loaded with the
program's ``deploy``, the scene pool in pinned host memory), then a few
batch requests warm every shape the window runs.

A request hands ``scenes_per_request`` scenes of the pool (consecutive in a
seeded order, cycling) to the card, runs ``cascade.upscale.ml_cascade`` on
all of them in one call (its default scene chunks), and copies every level's
fields back to the host. One client sends its next request when the last
has returned. The unit is the scene: ``scenes_per_s`` counts the scenes
completed in the window. (A batch runs its levels eagerly: the program
replays a level as a CUDA graph only for one scene.)

The check: ``check_requests`` scenes sampled from the window's requests,
each level's field against the plain reference's cascade of that scene
(``serve_cascade.reference_fields``), after the program's state is freed:
``field_err``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from portbench import weights
from portbench.drivers import serve_cascade

UNIT = "scene"


def setup(cell, seed: int, device) -> Dict:
    single = dataclasses.replace(cell, traffic={**cell.traffic, "warmup_requests": 0})
    state = serve_cascade.setup(single, seed, device)
    state["cell"] = cell
    t0 = time.perf_counter()
    for _ in range(cell.traffic["warmup_requests"]):
        _request(state, record=False)
    state["next"] = 0
    state["phases"]["warm-up requests"] = time.perf_counter() - t0
    return state


def _request(state: Dict, record: bool = True) -> int:
    """One request of a batch of scenes, end to end; returns its scenes."""
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade

    pool, dev, order = state["pool"], state["device"], state["order"]
    traffic = state["cell"].traffic
    n = traffic["scenes_per_request"]
    picks = [int(order[(state["next"] + j) % len(order)]) for j in range(n)]
    state["next"] += n
    idx = torch.tensor(picks)
    scene = {"u": {traffic["start"]: pool["u0"][idx].to(dev, non_blocking=True)},
             "f": {r: v[idx].to(dev, non_blocking=True) for r, v in pool["f"].items()},
             "theta": {r: v[idx].to(dev, non_blocking=True) for r, v in pool["theta"].items()}}
    fields = ml_cascade(state["model"], state["variables"], scene, traffic["target"],
                        **state["kwargs"])
    out = {r: v.cpu() for r, v in fields.items()}
    if record:
        state["served"].extend((i, {r: v[j] for r, v in out.items()})
                               for j, i in enumerate(picks))
    return n


def window(state: Dict, seconds: float) -> Dict:
    scenes = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        scenes += _request(state)
    return {"attempted": scenes, "scenes_per_s": scenes / (time.perf_counter() - t0)}


def traced(state: Dict) -> int:
    return sum(_request(state) for _ in range(state["cell"].traffic["trace_requests"]))


def check(state: Dict) -> Dict[str, float]:
    """The widest gap of a served scene's level field from the reference's,
    as a share of the reference field's largest magnitude, over the sampled
    scenes: ``field_err``."""
    cell, seed, dev = state["cell"], state["seed"], state["device"]
    served, pool = state.pop("served"), state["pool"]
    for key in ("model", "variables", "amp", "manifest", "kwargs"):
        state.pop(key)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(weights.derived_seed(seed, 5))
    picks = rng.choice(len(served), size=min(cell.traffic["check_requests"], len(served)),
                       replace=False)
    experts, gains = serve_cascade._experts(cell, seed, dev)
    worst = 0.0
    for k in picks:
        i, fields = served[int(k)]
        ref = serve_cascade.reference_fields(cell, experts, gains, pool, i, dev)
        worst = max([worst] + [float((fields[r] - ref[r].cpu()).abs().max()
                                     / ref[r].abs().max()) for r in ref])
    return {"field_err": worst}
