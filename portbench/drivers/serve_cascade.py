"""Serving scenes through the program's cascade, closed loop.

Set-up: the configuration's per-level experts and modal gains are drawn on
the card from the seed, saved as a bundle of the model family's registry
entry (``program_config``) with the program's ``deploy.save_bundle`` under
``TMPDIR`` and loaded back with ``deploy.load_bundle``, which builds the
model with ``models.build_model`` (as ``upscale --bundle`` does); a pool of
scenes is made on the card (``portbench.inputs``) and kept in pinned host
memory; a few requests warm every shape the window runs.

A request hands one scene from the pool (in a seeded order) to the card,
runs ``cascade.upscale.ml_cascade`` with the loaded manifest's arguments
(``deploy.run_bundle``'s call), and copies every level's field back to the
host. One client sends its next request when the last has returned. Its
latency is host time from the hand-over to the last field on the host.

The check: a sample of the window's requests, drawn from the seed, each
level's field against the plain reference's cascade on the same scene, with
the same weights and gains made again from the seed, after the program's
state is freed.
"""

from __future__ import annotations

import shutil
import statistics
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from portbench import inputs, weights
from portbench.harness import Phases
from portbench.reference import cascade as ref_cascade

UNIT = "scene"


def _experts(cell, seed: int, device):
    serve = cell.config["serve"]
    experts = [weights.make_state_dict(cell.family, cell.config["architecture"], seed, device,
                                       tag=level)
               for level in range(serve["experts"])]
    g = serve["gains"]
    gains = weights.make_gains(seed, serve["experts"], g["shape"], g["low"], g["high"], device)
    return experts, gains


def setup(cell, seed: int, device) -> Dict:
    from superresolution_for_pdes_tpu_torch.deploy import load_bundle, save_bundle

    config, traffic = cell.config, cell.traffic
    serve, arch = config["serve"], config["architecture"]
    clock = Phases()
    experts, gains = _experts(cell, seed, device)
    bundle = tempfile.mkdtemp(prefix="portbench_bundle_")
    try:
        save_bundle(bundle, cell.family.program_config(arch), experts, amp_levels=gains,
                    overlap=serve["overlap"], stats_mode=serve["stats_mode"],
                    coarse_tile=serve["coarse_tile"])
        model, variables, amp, manifest = load_bundle(bundle, device=device)
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    del experts, gains
    clock.lap("bundle saved and loaded")
    pool = inputs.scene_pool(weights.generator(seed, device, 3), traffic["pool_scenes"],
                             traffic["start"], traffic["target"], traffic["k_range"])
    pin = device.type == "cuda"
    host = {"u0": pool["u0"].cpu(),
            "f": {r: v.cpu() for r, v in pool["f"].items()},
            "theta": {r: v.cpu() for r, v in pool["theta"].items()}}
    if pin:
        host = {"u0": host["u0"].pin_memory(),
                "f": {r: v.pin_memory() for r, v in host["f"].items()},
                "theta": {r: v.pin_memory() for r, v in host["theta"].items()}}
    del pool
    clock.lap("scene pool")
    rng = np.random.default_rng(weights.derived_seed(seed, 4))
    state = {"cell": cell, "seed": seed, "device": device, "model": model,
             "variables": variables, "amp": amp, "manifest": manifest, "pool": host,
             "order": rng.permutation(traffic["pool_scenes"]), "served": [], "next": 0,
             "kwargs": dict(stats_mode=manifest["stats_mode"], overlap=manifest["overlap"],
                            coarse_tile=manifest["coarse_tile"], amp_levels=amp,
                            start_resolution=traffic["start"],
                            refine_cycles=traffic["refine_cycles"]),
             "phases": clock.seconds}
    for _ in range(traffic["warmup_requests"]):
        _request(state, record=False)
    state["next"] = 0
    clock.lap("warm-up requests")
    return state


def _request(state: Dict, record: bool = True) -> float:
    """One request, end to end; returns its latency in seconds."""
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade

    pool, dev = state["pool"], state["device"]
    order = state["order"]
    i = int(order[state["next"] % len(order)])
    state["next"] += 1
    t0 = time.perf_counter()
    scene = {"u": {state["cell"].traffic["start"]: pool["u0"][i].to(dev, non_blocking=True)},
             "f": {r: v[i].to(dev, non_blocking=True) for r, v in pool["f"].items()},
             "theta": {r: v[i].to(dev, non_blocking=True) for r, v in pool["theta"].items()}}
    fields = ml_cascade(state["model"], state["variables"], scene,
                        state["cell"].traffic["target"], **state["kwargs"])
    out = {r: v.cpu() for r, v in fields.items()}
    latency = time.perf_counter() - t0
    if record:
        state["served"].append((i, out))
    return latency


def window(state: Dict, seconds: float) -> Dict:
    latencies = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        latencies.append(_request(state))
    elapsed = time.perf_counter() - t0
    p95 = (statistics.quantiles(latencies, n=100, method="inclusive")[94]
           if len(latencies) > 1 else latencies[0])
    return {"attempted": len(latencies), "scene_p50_ms": statistics.median(latencies) * 1e3,
            "scene_p95_ms": p95 * 1e3, "scenes_per_s": len(latencies) / elapsed}


def traced(state: Dict) -> int:
    n = state["cell"].traffic["trace_requests"]
    for _ in range(n):
        _request(state)
    return n


def check(state: Dict) -> Dict[str, float]:
    """The widest gap of a served level's field from the reference's, as a
    share of the reference field's largest magnitude, over the sampled
    requests: ``field_err``."""
    cell, seed, dev = state["cell"], state["seed"], state["device"]
    served, pool = state.pop("served"), state["pool"]
    for key in ("model", "variables", "amp", "manifest", "kwargs"):
        state.pop(key)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(weights.derived_seed(seed, 5))
    picks = rng.choice(len(served), size=min(cell.traffic["check_requests"], len(served)),
                       replace=False)
    experts, gains = _experts(cell, seed, dev)
    worst = 0.0
    for k in picks:
        i, fields = served[int(k)]
        ref = reference_fields(cell, experts, gains, pool, i, dev)
        worst = max([worst] + [float((fields[r] - ref[r].cpu()).abs().max()
                                     / ref[r].abs().max()) for r in ref])
    return {"field_err": worst}


def reference_fields(cell, experts, gains, pool: Dict, i: int, device) -> Dict[int, torch.Tensor]:
    """The plain reference's cascade of pool scene ``i`` with the given
    experts and gains, at the precision the backends are set to."""
    arch, serve, traffic = cell.config["architecture"], cell.config["serve"], cell.traffic
    runs = [lambda x, p=p: cell.family.forward(arch, p, x) for p in experts]
    f = {r: v[i].to(device) for r, v in pool["f"].items()}
    theta = {r: v[i].to(device) for r, v in pool["theta"].items()}
    with torch.no_grad():
        return ref_cascade.cascade(runs[0], pool["u0"][i].to(device), f, theta, traffic["target"],
                                   serve["coarse_tile"], gains, traffic["refine_cycles"],
                                   scale_channels=arch["in_channels"] > 3, level_models=runs,
                                   refine=serve["refine"])
