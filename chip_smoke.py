#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. device -- the card's name and power limit; TF32 off for matmuls and cuDNN
   (as ``resolve_device`` sets it for every command);
2. build  -- ``nvcc`` builds every ``csrc/*.cu`` of the port (sm_90a);
3. kernels -- K2 (``kernel_residual``, theta scalar and field), K3
   (``kernel_jacobi_smooth``, 1 to 6 sweeps) and the fused pre-smooth and
   residual (``kernel_smooth_residual``, 0 to 5 sweeps) against their plain
   PyTorch twins at the refine path's shapes plus ragged ones; the device
   time per launch (profiler), time per call (CUDA events), twin and bound of
   K3 (2 sweeps), K2 (scalar theta) and the fused kernel (2 sweeps), beside
   the pair it replaces (K3 then K2, two calls), at (1, 160^2), (1, 320^2),
   (1, 640^2) and (4, 640^2), with a ``F.conv2d`` 5-point yardstick's device
   time and time per call; K3 at 2, 4 and 6 sweeps per call;
4. serve  -- four full-width 5-channel BatchNorm experts from seeded
   generators, frozen into a bundle with the champion manifest (tile stats,
   tiles 40/80/80, grid gains) and served by ``deploy.run_bundle`` on one
   scene to 640^2;
5. refine -- the same bundle through ``ml_cascade(..., refine_cycles=2)``
   with the stencil kernels (launch counts reset just before and read just
   after: 6 fused pre-smooth and residual, 6 K3 post-smooths, 0 K2) and with
   ``use_kernels=False``; the fields must agree and refinement must lower the
   error against the exact solve at 160, 320 and 640;
6. multigrid -- ``solve_poisson_mg`` at 640^2, batch 4, 12 cycles, kernels on,
   against the DST solve (12 fused launches and 12 K3);
7. profile -- ``torch.profiler`` device time of the served and the refined
   cascade to 640^2, and the device busy share;
8. K1 -- ``kernel_apply_operator`` against its twin at the training path's
   shapes plus 640^2 and a ragged one, theta scalar and field, and its
   adjoint ``L(theta g)`` against autograd of the twin; the fused
   physics-loss kernels (``kernel_pde_loss_forward``/``_backward``) against
   their twins at the training shapes with 0-d and per-sample stats, and
   bit for bit over two calls; device time, time per call, twin and bound of
   the operator and of the loss per train step at (32, 40, 40) and
   (32, 160, 160), beside the same loss composed without the fusion (the
   operator kernel between elementwise launches, forward and backward);
9. generate -- the ``generate_data`` CLI at the published counts (1000
   standard + 1000 subdomain, theta mixed, 64 cascade scenes; the sample
   figure at its default of 20, skipped without matplotlib): the ``.npz``
   keys, shapes and finiteness, and standard samples against a float64 DST
   solve of their own f and theta;
10. train -- the ``train`` CLI with the champion's first-stage recipe
   (``scripts/rebuild_champion.sh:87-90``; full-width 5-channel BatchNorm
   U-Net, batch 32, streamed regeneration, physics weight 0.3), cut to 2
   epochs, with the launch counts reset just before and read just after (the
   fused loss forward once per train step and per validation chunk, its
   backward once per train step, the operator kernel never); the checkpoints
   load into a U-Net; one step's loss and gradients with the kernels and
   with the twins agree; a warm step's time, its device launches (at most
   445; 455 before the loss was fused), a profiler split by kernel class and
   the device busy share;
11. solvers -- ``solve_poisson`` on 4 seeded problems: dst, mg (12 cycles)
   and mgcg (tol 1e-6, at most 60 iterations) at 640^2, cg (tol 1e-6) at
   160^2, each against a float64 DST solve (``SOLVER_LIMITS``), with
   iterations, wall and device busy share; CG's launch identities (K1 = 1 +
   the loop's iterations; for mgcg the fused pre-smooth and residual and K3
   too); the shipped convergence-test cadence against the other one, bit
   for bit, with both walls (and cg at 640^2 for 200 iterations); K1 with
   theta = -1 timed at CG's shape;
12. freeze -- four full-width experts written as run dirs and frozen by
   ``python -m superresolution_for_pdes_tpu_torch upscale`` (the dispatcher,
   in this process) with the flags of ``scripts/rebuild_champion.sh:133-140``
   (32 calibration scenes, grid gains, tiles 40/80/80): the gains finite, a
   second calibration bit-identical, ``run_bundle`` on the saved bundle
   against the fields the command wrote, the peak device memory; the
   calibration's wall and peak with the default scene chunk and with one
   chunk of all 32 scenes, whose gains and cascade fields agree;
13. evaluate -- protocols 1 and 5 of ``scripts/eval_champion_bundle.sh`` on
   that bundle (``statistical --n_examples 20 --seed 3``;
   ``resolution_comparison --k 10 11 --seed 0`` with ``--refine_cycles 2``):
   per-level ML time per scene, direct-solve time, rel-L2 (random weights:
   no statement of model quality), the artifacts, and the refined sweep's
   launches (6 fused, 6 K3, 0 K2); the statistical harness's ML time per
   scene and peak with the default scene chunk and with one chunk of 20;
14. rebuild -- the ``train`` command with the flags of the champion's
   self-fed stages (``scripts/rebuild_champion.sh:101-109`` SFL2F, then
   ``:118-129`` SFL34G with that SFL2F run as its level-2 teacher), cut to 2
   epochs, on phase 12's R7 and SFL1E run dirs: 768 and 2,048 harvested
   80 -> 160 tiles per regeneration, finite; the teacher calibration,
   regeneration, epoch and warm step walls at (32, 160^2), peak memory, and
   the launches (the fused loss forward once per train step and validation
   chunk, its backward once per step, no other kernel); then both checkpoints
   serve levels 2 and 3-4 of one cascade to 640^2;
15. single-level and diagnose -- ``compare_methods`` on phase 12's R7 run dir
   with 1000 fresh samples, and ``diagnose`` on phase 13's
   ``statistical_results.json``: walls and artifacts;
16. resnet -- ``train --model resnet`` with the round-1 ResNet recipe
   (``reports/ROUND1.md:14-18``: 4,000 mixed-theta samples, physics weight
   0.1; the flags are read off the report's table) cut to 2 epochs: the
   launch identities (the fused loss forward per step and validation chunk,
   its backward per step, no other kernel), both checkpoints load through
   ``resolve_model`` as a 594,753-parameter ``PDEResNet``, one step with the
   kernels against the twins, a warm step (batch 32 at 40^2) with its
   profile, the peak memory, and one scene served to 640^2;
17. router harnesses -- four full-width U-Net experts (one per sample with 5
   channels) and a reference ``.pth``: ``compare_test_cases`` with the flags of
   ``reports/RECIPES.md:100-104`` and ``out_of_sample`` at its defaults with
   the router, with phase 16's ResNet and with the ``.pth``: artifacts,
   figures written or named as skipped, the wavenumbers on the card against
   float64 on the CPU, equal masks, every arm used, routed predictions
   against each expert's own; ``run_single_example`` on phase 12's R7 run
   to 640^2; walls;
18. r7bf16 -- ``train`` with R7's flags and ``--dtype bfloat16 --batch_size
   256 --lr 6e-4`` (``reports/RECIPES.md:26``), cut to 2 epochs: K1's bf16
   loss kernels launched once per step and validation chunk (forward) and
   once per step (backward), no float32 K1 launch; the bf16 kernels against
   their twins at (256, 40^2) and timed there with their bounds (bf16
   bytes); one bf16 step with the kernels against the twins (loss 1e-6,
   gradients one bf16 step); the warm step at (256, 40^2) in bf16 and in
   float32; peak memory and epoch walls;
19. fused -- the consthi2 recipe (``reports/RECIPES.md:27``) cut to 4
   epochs with and without ``--fused_epochs 2`` (cuDNN deterministic): the
   per-epoch losses side by side, epoch walls and host syncs;
20. data parallel -- ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m superresolution_for_pdes_tpu_torch train
   --data_parallel --multihost`` with R7's flags cut to 1 epoch (NCCL): the
   topology line and epoch 1 beside phase 10's; then one data-parallel step
   in a one-rank NCCL group of this process against the plain step (loss
   1e-6, gradients 1e-5 of max);
21. online -- ``make_online_train_step``, three steps at batch 32, full width;
22. shard -- ``resolution_comparison --shard_tiles`` on phase 12's bundle
   against the unsplit sweep, bit for bit;
23. trace -- ``device_trace`` around one served cascade to 640^2: the trace
   names the convolution kernels;
24. native -- the float64 C++ oracle built with g++, its CG at 160^2 against
   a float64 DST solve on the card (1e-8);
25. window attention -- SwinIR's kernel pair (``csrc/window_attention.cu``)
   against its plain twin (output, qkv and bias-table gradients, plain and
   shifted) at the training shape (32 maps of 40^2) and a served 160^2
   level, its gradients bit for bit over two runs, and, shifted, its device
   time, time per call, the twin's, its bound and SDPA on heads padded to 32
   as the yardstick; then the pair's launches on its main path: a
   published-width SwinIR's train step at (32, 40^2), in float32 and in
   bfloat16 (autocast), with the counts set to 0 just before each; in the
   same steps one token reduction (``csrc/token_reduce.cu``) a linear's bias
   gradient (144) and one a LayerNorm's weight and bias (74), and their
   device time a step beside the bytes they read; alone at the training
   shape, the reductions against a float64 sum, with device time, time per
   call, twin, bound and ATen's column sums as the yardstick.

Prints each phase's seconds, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line and, last, ``{"ok": true, "device":
{...}}``. Without a CUDA device it exits with an error before printing any
result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 100) -> float:
    """Time per call of ``fn`` by CUDA events around ``reps`` back-to-back
    calls, after a warm-up. Where the host enqueues slower than the card runs,
    this is the host's time per call; ``profile`` gives the device time."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(fn, reps: int = 1):
    """``fn`` under ``torch.profiler`` after a warm call: (wall ms per rep under
    the profiler, device kernel ms per rep, [(kernel, ms per rep, launches per
    rep)] by device time). Ranges annotated on the device (the optimizer's
    step) are left out: their kernels are counted on their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows


K1_NAME = "pde_operator_kernel"
# K3, and K2 with the fused pre-smooth and residual: two entry points of one template
K3_NAME, K2_NAME = "jacobi_kernel", "smooth_residual_kernel"
# the loss forward is two kernels: pde_loss_forward_kernel and its one-block sum
K1_FWD_NAME, K1_BWD_NAME = "pde_loss_forward", "pde_loss_backward_kernel"
UNFUSED_LAUNCHES_PER_STEP = 455  # a train step with the loss unfused (PERF.md): ~18 of them


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its name."""
    low = name.lower()
    if any(k in low for k in (K1_NAME, K1_FWD_NAME, K1_BWD_NAME)):
        return "stencil K1"
    if K2_NAME in low or K3_NAME in low:
        return "stencil (K2/K3)"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv", "fft", "winograd",
                              "mult_and_sum", "cudnn", "cf32")):  # cf32: FFT convolution's
        return "convolution (cuDNN)"                               # complex products
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS: resize, solver)"
    if any(k in low for k in ("adam", "foreach", "multi_tensor")):
        return "optimizer"
    return "other (elementwise, norm, copy)"


def device_ms_per_call(fn, kernel: str | None = None, reps: int = 50) -> float:
    """Device ms per call of ``fn`` (profiler): of the kernels whose names hold
    ``kernel``, or of every kernel ``fn`` launches."""
    _, busy, rows = profile(fn, reps=reps)
    return busy if kernel is None else sum(r[1] for r in rows if kernel in r[0])


def laplacian_weights(n: int, dev: torch.device) -> torch.Tensor:
    """The 5-point ``L`` as a 3x3 ``F.conv2d`` filter (a library yardstick)."""
    w = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], device=dev)
    return w.div((1.0 / (n - 1)) ** 2).reshape(1, 1, 3, 3)


def by_class(rows) -> dict:
    classes = {}
    for name, ms, _ in rows:
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + ms
    return dict(sorted(classes.items(), key=lambda kv: -kv[1]))


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12     # outside the tensor cores


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_generate(dev: torch.device, smi: str, n_each: int = 1000, n_scenes: int = 64) -> dict:
    """Phase 9: the generate_data CLI at the published counts (``n_each``
    standard and subdomain samples per theta stratum, ``n_scenes`` cascade
    scenes), its file checked, standard samples held against a float64 DST
    solve."""
    import numpy as np

    from superresolution_for_pdes_tpu_torch.cli import generate_data
    from superresolution_for_pdes_tpu_torch.data.generate import generate_mixed_dataset
    from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = generate_data.main(["--n_standard", str(n_each), "--n_subdomain", str(n_each),
                                   "--theta", "mixed", "--n_cascade_scenes", str(n_scenes),
                                   "--out", tmp,
                                   "--device", dev.type])
        cli_s = time.perf_counter() - t0
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
    n_tiles = n_scenes * 8 * 4  # scenes x tiles per level x level pairs 40 -> 640
    n = 4 * n_each + n_tiles
    shapes = {"u_fine": (n, 40, 40), "f_fine": (n, 40, 40), "theta_fine": (n, 40, 40),
              "u_coarse": (n, 20, 20), "f_coarse": (n, 20, 20), "theta_coarse": (n, 20, 20),
              "k1": (n,), "k2": (n,), "is_subdomain": (n,)}
    check(set(data) == set(shapes), f"npz keys {sorted(data)}")
    for key, shape in shapes.items():
        check(data[key].shape == shape, f"{key}: shape {data[key].shape} != {shape}")
        if key != "is_subdomain":
            check(bool(np.isfinite(data[key]).all()), f"{key}: non-finite values")
    check(data["is_subdomain"].dtype == bool
          and int(data["is_subdomain"].sum()) == 2 * n_each + n_tiles, "is_subdomain flags")
    # standard samples: theta == 1 first, then subdomain, then theta ~ U(0.5, 2)
    idx = [0, 1, n_each - 1, 2 * n_each, 2 * n_each + 1, 3 * n_each - 1]
    worst = 0.0
    for grid in ("fine", "coarse"):
        f, th, u = (torch.from_numpy(data[f"{name}_{grid}"][idx]).to(dev, torch.float64)
                    for name in ("f", "theta", "u"))
        ref = solve_poisson_dst(f, th, refine_iters=1)
        for i in range(len(idx)):
            rel = float((u[i] - ref[i]).abs().max() / ref[i].abs().max())
            worst = max(worst, rel)
            check(rel <= 1e-5, f"sample {idx[i]} u_{grid}: {rel:.2e} from the float64 solve")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_mixed_dataset(42, n_each, n_each, theta="mixed", n_cascade_scenes=n_scenes,
                           device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[generate] {n} samples ({n_tiles} cascade tiles): keys, shapes and finiteness ok; "
        f"{len(idx)} standard samples within {worst:.2e} of a float64 DST solve (tol 1e-5); "
        f"CLI wall {cli_s:.2f} s (first call, .npz write included), generation alone "
        f"{warm_s:.3f} s warm, on {smi}")
    return {"samples": n, "cli_s": cli_s, "generation_warm_s": warm_s,
            "max_rel_err_vs_f64": worst}


def phase_train(dev: torch.device, card: str, smi: str) -> dict:
    """Phase 10: the train CLI with the champion's first-stage recipe, cut to
    2 epochs; K1's launches counted over the run; checkpoints reloaded; one
    step with K1 against one with its twin; step time and profile."""
    from superresolution_for_pdes_tpu_torch.cli import train as train_cli
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet, count_parameters
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.train.checkpoint import load_model_state

    # scripts/rebuild_champion.sh:87-90, stage flagship_r7; the one cut: 2 epochs, not 1000
    recipe = ["--generate", "--gen_stream", "--gen_theta", "mixed", "--gen_cascade_scenes", "384",
              "--gen_tiles_per_level", "12", "--gen_cascade_k", "6", "12",
              "--normalization", "per_sample", "--scale_channels", "--physics_weight", "0.3",
              "--early_stopping_patience", "50", "--plateau_patience", "25", "--epochs", "2"]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(4, 5, 40, 40, device=dev, generator=gen)
    with tempfile.TemporaryDirectory() as tmp:
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        hist = train_cli.main([*recipe, "--results", tmp, "--device", dev.type])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = sk.launch_counts()
        for which in ("best_model", "final_model"):
            restored = AttentionUNet(in_channels=5).to(dev)
            restored.load_state_dict(load_model_state(hist["run_dir"], which))
            with torch.no_grad():
                y = restored.eval()(x)
            check(y.shape == (4, 1, 40, 40) and bool(torch.isfinite(y).all()),
                  f"{which}: forward of the reloaded U-Net")
    steps, chunks = sum(hist["train_steps"]), sum(hist["eval_chunks"])
    expected = {"kernel_apply_operator": 0, "kernel_pde_loss_forward": steps + chunks,
                "kernel_pde_loss_backward": steps, "kernel_residual": 0,
                "kernel_jacobi_smooth": 0, "kernel_smooth_residual": 0}
    log(f"[train] 2 epochs: {steps} train steps {hist['train_steps']}, {chunks} validation "
        f"chunks {hist['eval_chunks']}; launches {counts}; expected loss forward {steps} + "
        f"{chunks}, backward {steps}, operator 0")
    check(counts == expected, f"launches {counts} != {expected}")
    losses = hist["train_loss"] + hist["val_loss"]
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    model, stats = hist["model"], hist["stats"]
    n_params = count_parameters(model)
    check(n_params == 7_835_740, f"{n_params} parameters")
    log(f"[train] losses train {hist['train_loss']} val {hist['val_loss']}; "
        f"{n_params} parameters; best_model and final_model reload and run")

    batch = step_batch(dev, stats, per_sample=True, scale_channels=True)
    kernel_vs_twin_step(model, batch, stats, 0.3, "train")
    warm = warm_step(model, batch, stats, 0.3, "train", smi)
    log(f"[train] (before the loss was fused: {UNFUSED_LAUNCHES_PER_STEP} device launches "
        f"per step)")
    check(warm["launches_per_step"] <= 445, f"{warm['launches_per_step']} device launches per step")
    log(f"[train] epochs: regeneration {hist['regen_seconds']} s, epoch wall "
        f"{hist['epoch_seconds']} s; CLI run {run_s:.1f} s, on {smi}")
    return {"launches": counts,
            "history": {k: hist[k] for k in ("train_loss", "val_loss")},
            "summary": {"steps": steps, "eval_chunks": chunks, **warm,
                        "regen_s": hist["regen_seconds"], "epoch_s": hist["epoch_seconds"],
                        "run_s": run_s}}


def step_batch(dev: torch.device, stats, per_sample: bool, scale_channels: bool,
               n: int = 32, dtype: torch.dtype = torch.float32) -> dict:
    """``n`` training samples of all four strata (theta constant and varying,
    standard and subdomain), normalized as the run normalizes them and stored
    in ``dtype``."""
    from superresolution_for_pdes_tpu_torch.data.generate import generate_mixed_dataset
    from superresolution_for_pdes_tpu_torch.train import loop

    ds = generate_mixed_dataset(7, n // 2, n // 2, theta="mixed", device=dev)
    arrays = loop.prepare_arrays(ds, stats, per_sample=per_sample, scale_channels=scale_channels,
                                 dtype=dtype)
    idx = torch.arange(0, 2 * n, 2, device=dev)
    return {k: v[idx] for k, v in arrays.items()}


def kernel_vs_twin_step(model, batch: dict, stats, physics_weight: float, tag: str,
                        grad_tol: float = 1e-5) -> dict:
    """One step's loss and gradients with the fused K1 loss and with its
    twins, from the same weights (restored after): loss within 1e-6
    relative, every gradient within ``grad_tol`` of its max (1e-5; for a bf16
    batch one bf16 step, 2^-8)."""
    from superresolution_for_pdes_tpu_torch.train import loop

    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    step = {}
    for use_kernel in (True, False):
        model.load_state_dict(state0)
        model.train().zero_grad(set_to_none=True)
        loss = loop.batch_loss(model, batch, stats, physics_weight, use_kernel)
        loss.backward()
        step[use_kernel] = (float(loss.detach()),
                            {n: p.grad.clone() for n, p in model.named_parameters()})
    torch.backends.cudnn.deterministic = False
    model.load_state_dict(state0)
    (loss_k, grads_k), (loss_p, grads_p) = step[True], step[False]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_rel <= 1e-6, f"{tag}: loss with the kernels {loss_k} vs twins {loss_p}")
    top = max(float(g.abs().max()) for g in grads_p.values())
    grad_rel = 0.0
    for name, ref in grads_p.items():
        scale = float(ref.abs().max())
        if scale < 1e-6 * top:  # a conv bias feeding BatchNorm: rounding noise only
            continue
        rel = float((grads_k[name] - ref).abs().max()) / scale
        grad_rel = max(grad_rel, rel)
        check(rel <= grad_tol, f"{tag}: gradient {name}: kernel path vs twin path {rel:.2e}")
    log(f"[{tag}] one step, fused K1 loss vs twins: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
        f"{loss_rel:.2e}), worst gradient tensor {grad_rel:.2e} of its max (tol 1e-6 / "
        f"{grad_tol:.2e})")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel}


def warm_step(model, batch: dict, stats, physics_weight: float, tag: str, smi: str) -> dict:
    """A warm train step at the batch's shape: ms (CUDA events over 50
    steps), samples/s, one fused loss forward and backward per step, and a
    profile: device busy, kernel classes, device launches per step."""
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

    opt = loop.make_optimizer(model, TrainConfig())
    n, size, dtype = batch["x"].shape[0], batch["x"].shape[-1], batch["x"].dtype

    def train_step():
        return loop.train_step(model, opt, batch, stats, physics_weight, 1.0)

    sk.reset_launch_counts()
    step_ms = time_ms(train_step, reps=50)
    step_counts = sk.launch_counts(dtype)
    check(step_counts["kernel_pde_loss_forward"] == 55 and step_counts["kernel_pde_loss_backward"]
          == 55 and step_counts["kernel_apply_operator"] == 0,
          f"{tag}: one fused loss forward and backward per step: {step_counts} over 55 steps")
    wall, busy, rows = profile(train_step, reps=10)
    classes = by_class(rows)
    launches = sum(r[2] for r in rows)
    log(f"[{tag}] warm step, batch {n} at {size}^2 in {str(dtype)[6:]}: {step_ms:.3f} ms "
        f"(CUDA events), "
        f"{n * 1e3 / step_ms:.0f} samples/s; device busy {busy:.3f} ms per step = "
        f"{100 * busy / step_ms:.0f}% of the step ({100 * busy / wall:.0f}% of the "
        f"{wall:.3f} ms per step under the profiler); {launches:.0f} device kernel launches "
        f"per step; on {smi}")
    for cls, ms in classes.items():
        log(f"[{tag}]   {ms:8.4f} ms per step  {cls}")
    for name, ms, calls in rows[:8]:
        log(f"[{tag}]   {ms:8.4f} ms  {calls:5.0f} launches per step  {name[:80]}")
    return {"step_ms": step_ms, "samples_per_s": n * 1e3 / step_ms, "device_busy_ms": busy,
            "busy_share": busy / step_ms, "launches_per_step": launches, "classes_ms": classes}


def run_command(argv: list):
    """``python -m superresolution_for_pdes_tpu_torch <argv>`` in this process
    (the same dispatcher), so that its launches and peak memory can be read
    and it runs with this process's TF32 settings; returns the command's
    result."""
    from superresolution_for_pdes_tpu_torch.__main__ import main as dispatch

    saved = sys.argv
    sys.argv = ["python -m superresolution_for_pdes_tpu_torch", *argv]
    try:
        return dispatch()
    finally:
        sys.argv = saved


def random_expert(seed: int, in_channels: int = 5) -> dict:
    """A full-width BatchNorm AttentionUNet's state_dict from a seed, with
    non-trivial running statistics."""
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet

    g = torch.Generator().manual_seed(seed)
    model = AttentionUNet(in_channels=in_channels, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.state_dict()


# limits of the solvers against a float64 DST solve, max|u - u64| / max|u64|
# (about 3x what the first run on an H100 measured: 3.0e-6, 6.9e-6, 5.5e-6, 3.3e-6)
SOLVER_LIMITS = {"dst": 1e-5, "mg": 2e-5, "mgcg": 2e-5, "cg": 1e-5}


def phase_solvers(dev: torch.device, card: str, smi: str) -> dict:
    """Phase 11: ``solve_poisson`` with each method on 4 seeded problems (f
    from k ~ U(6, 12), theta ~ U(0.5, 2)) -- dst, mg (12 cycles) and mgcg (tol
    1e-6, at most 60 iterations) at 640^2, cg (tol 1e-6) at 160^2 -- against a
    float64 DST solve; CG's launch identities (K1 = 1 + the loop's
    iterations, and for mgcg the fused pre-smooth and residual and K3 too);
    the convergence test every CONVERGENCE_CHUNK iterations against one every
    iteration, bit for bit, with both walls; K1 timed at CG's shape."""
    import torch.nn.functional as F

    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
    from superresolution_for_pdes_tpu_torch.solver import cg as cg_mod
    from superresolution_for_pdes_tpu_torch.solver import solve_poisson
    from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst
    from superresolution_for_pdes_tpu_torch.solver.multigrid import mg_preconditioner

    gen = torch.Generator(device=dev).manual_seed(11)

    def problem(n):
        k = torch.rand(4, 2, device=dev, generator=gen) * 6.0 + 6.0
        return (forcing_term(k[:, 0], k[:, 1], n, device=dev),
                torch.rand(4, n, n, device=dev, generator=gen) * 1.5 + 0.5)

    p640, p160 = problem(640), problem(160)
    cases = {"dst 640": (p640, "dst", {}), "mg 640": (p640, "mg", {"n_cycles": 12}),
             "mgcg 640": (p640, "mgcg", {"tol": 1e-6, "max_iters": 60}),
             "cg 160": (p160, "cg", {"tol": 1e-6, "max_iters": 2000}),
             # no convergence: 200 iterations, the chunk's effect per iteration
             "cg 640 x200": (p640, "cg", {"tol": 1e-12, "max_iters": 200})}
    total = {fn.__name__: 0 for fn in sk.KERNELS}
    results = {}
    for name, ((f, theta), method, kw) in cases.items():
        def solve(f=f, theta=theta, method=method, kw=kw):
            return solve_poisson(f, theta, method, **kw)

        solve()
        sk.reset_launch_counts()
        u = solve()
        torch.cuda.synchronize()
        counts = sk.launch_counts()
        for key, c in counts.items():
            total[key] += c
        wall = wall_ms(solve)
        pwall, busy, _ = profile(solve)
        rec = dict(method=method, wall_ms=wall, device_ms=busy, busy_share=busy / pwall,
                   launches=counts)
        if not name.endswith("x200"):
            ref = solve_poisson_dst(f.double(), theta.double(), refine_iters=1)
            rec["rel_err"] = float((u.double() - ref).abs().max() / ref.abs().max())
            rec["limit"] = SOLVER_LIMITS[method]
            check(rec["rel_err"] <= rec["limit"],
                  f"{name}: {rec['rel_err']:.3e} from the float64 solve > {rec['limit']}")
        if method in ("cg", "mgcg"):
            precond = mg_preconditioner if method == "mgcg" else None
            u2, iters = cg_mod.cg_solve(lambda p: sk.kernel_apply_operator(-1.0, p),
                                        -(f / theta), tol=kw["tol"], max_iters=kw["max_iters"],
                                        precond=precond)
            iters = int(iters)
            chunk = cg_mod.convergence_chunk(precond)
            ran = cg_mod.iterations_run(iters, kw["max_iters"], chunk)
            check(torch.equal(u2, u), f"{name}: cg_solve and solve_poisson differ")
            cycles = 1 + ran if method == "mgcg" else 0
            expected = {"kernel_apply_operator": 1 + ran, "kernel_pde_loss_forward": 0,
                        "kernel_pde_loss_backward": 0, "kernel_residual": 0,
                        "kernel_jacobi_smooth": cycles, "kernel_smooth_residual": cycles}
            check(counts == expected, f"{name}: launches {counts} != {expected}")
            if not name.endswith("x200"):
                check(iters < kw["max_iters"], f"{name}: not converged in {iters} iterations")
            # the other cadence, for the record: a test every iteration for
            # plain CG, every CONVERGENCE_CHUNK iterations for mgcg
            other = 1 if chunk > 1 else cg_mod.CONVERGENCE_CHUNK
            saved = cg_mod.convergence_chunk
            cg_mod.convergence_chunk = lambda precond: other
            try:
                u_other = solve()
                wall_other = wall_ms(solve)
            finally:
                cg_mod.convergence_chunk = saved
            check(torch.equal(u_other, u), f"{name}: chunks {chunk} and {other} differ")
            rec.update(iters=iters, loop_iterations=ran, chunk=chunk, other_chunk=other,
                       wall_ms_other_chunk=wall_other)
        results[name] = rec
        log(f"[solvers] {name}: {rec.get('iters', '-')} iterations "
            f"(loop ran {rec.get('loop_iterations', '-')}), wall {wall:.2f} ms"
            + (f" testing every {rec['chunk']} (every {rec['other_chunk']}: "
               f"{rec['wall_ms_other_chunk']:.2f} ms, same u bit for bit)"
               if "chunk" in rec else "")
            + f", device busy {busy:.2f} ms = {100 * rec['busy_share']:.0f}% of the profiled "
            f"wall" + (f", max|u - u64|/max|u64| {rec['rel_err']:.3e} (limit {rec['limit']})"
                       if "rel_err" in rec else "")
            + f"; launches {counts}; on {smi}")
    # K1 at CG's shape: theta = -1 on (4, 640, 640)
    u = torch.randn(4, 640, 640, device=dev, generator=gen)
    w5 = -laplacian_weights(640, dev)
    points = u.numel()

    def k1(u=u):
        return sk.kernel_apply_operator(-1.0, u)

    timing = dict(ms=time_ms(k1), plain_ms=time_ms(lambda: sk.plain_apply_operator(-1.0, u)),
                  library_ms=time_ms(lambda: F.conv2d(u[:, None], w5, padding=1)),
                  bound=bound(2 * 4 * points, 7 * points),
                  device_ms=device_ms_per_call(k1, K1_NAME), shape=list(u.shape))
    diff = float((k1() - sk.plain_apply_operator(-1.0, u)).abs().max())
    check(diff == 0.0, f"K1 theta -1 differs from its twin by {diff}")
    log(f"[solvers] K1 theta -1 at (4, 640, 640): device {timing['device_ms'] * 1e3:.3f} us per "
        f"launch, {timing['ms']:.4f} ms per call, twin {timing['plain_ms']:.4f} ms, -F.conv2d "
        f"{timing['library_ms']:.4f} ms, bound {timing['bound'][0] * 1e3:.3f} us; bit-identical "
        f"to its twin; on {smi}")
    return {"launches": total, "cases": results, "k1_timing": timing}


def phase_freeze(dev: torch.device, smi: str, root) -> dict:
    """Phase 12: four full-width experts (standing for R7, SFL1E, SFL2F and
    SFL34G) written as run dirs, frozen by the ``upscale`` command with the
    flags of ``scripts/rebuild_champion.sh:133-140``; the gains finite, a second
    calibration bit-identical, ``run_bundle`` on the saved bundle against the
    fields the command wrote; peak device memory."""
    import numpy as np

    from superresolution_for_pdes_tpu_torch.cascade.modal import calibrate_modal
    from superresolution_for_pdes_tpu_torch.cascade.multires import (
        solve_multi_resolution,
        solve_multi_resolution_batch,
    )
    from superresolution_for_pdes_tpu_torch.cascade.upscale import (
        default_scene_chunk,
        ml_cascade,
        plan_cascade,
    )
    from superresolution_for_pdes_tpu_torch.deploy import load_bundle, run_bundle
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

    runs = {}
    for i, name in enumerate(("r7", "sfl1e", "sfl2f", "sfl34g")):
        run = root / f"{name}_run_0"
        save_checkpoint(run / "best_model", {"model": random_expert(200 + i)})
        (run / "config.json").write_text(json.dumps(
            {"model": "attention_unet", "scale_channels": True, "model_norm": "batch"}))
        runs[name] = str(run)
    bundle, out = root / "champion_bundle", root / "upscaled_champion"
    argv = ["upscale", "--model_path", runs["r7"], "--model_path_level1", runs["sfl1e"],
            "--model_path_level", "2", runs["sfl2f"], "--model_path_level", "3", runs["sfl34g"],
            "--model_path_level", "4", runs["sfl34g"], "--stats_mode", "tile",
            "--tile_levels", "40", "80", "80", "--amp_calibrate", "32", "--amp_k", "8", "12",
            "--amp_bpo", "4", "--save_bundle", str(bundle), "--target", "640",
            "--out", str(out)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    run_command(argv)
    torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t0
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(sum(counts.values()) == 0, f"the freeze launched stencil kernels: {counts}")
    with np.load(bundle / "amp.npz") as z:
        gains = [z[f"level{i}"] for i in range(len(z.files))]
    check(len(gains) == 4 and all(g.shape == (48, 48) and np.isfinite(g).all() for g in gains),
          "bundle gains: 4 finite 48x48 grids")
    model, variables, _, manifest = load_bundle(bundle, dev)
    check(manifest["stats_mode"] == "tile" and manifest["coarse_tile"] == (40, 80, 80)
          and manifest["overlap"] is False and len(variables) == 5,
          f"manifest {manifest}")
    calib = dict(target_resolution=640, k_range=(8.0, 12.0), stats_mode="tile",
                 coarse_tile=manifest["coarse_tile"], bands_per_octave=4, kind="grid",
                 device=dev)
    # the default scene chunk, then one chunk of all 32 scenes (the layout before
    # the cascade chunked scenes), each with its own peak
    walls, peaks, fits = {}, {}, {}
    for label, chunk in (("default", None), ("one chunk", 32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fits[label] = calibrate_modal(model, variables, 100, n_scenes=32, scene_chunk=chunk,
                                      **calib)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        peaks[label] = torch.cuda.max_memory_allocated()
    again = fits["default"]
    calib_s, calib_peak = walls["default"], peaks["default"]
    identical = all(np.array_equal(a.cpu().numpy(), g) for a, g in zip(again, gains))
    check(identical, "a second calibration gave other gains")
    gain_diff = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(again, fits["one chunk"]))
    # gains divide two band sums, a low-energy band two small ones (PERF.md section 2)
    check(gain_diff <= 2e-4, f"chunked gains {gain_diff:.3e} of max|gain| from one chunk")
    scenes = solve_multi_resolution_batch(100, 32, resolutions=(80, 160, 320, 640),
                                          k_range=(8.0, 12.0), device=dev)
    kw = dict(stats_mode="tile", coarse_tile=manifest["coarse_tile"], amp_levels=again)
    by_chunk = {chunk: ml_cascade(model, variables, scenes, 640, scene_chunk=chunk, **kw)
                for chunk in (None, 32)}
    field_diff = max(float((by_chunk[None][r] - by_chunk[32][r]).abs().max()
                           / by_chunk[32][r].abs().max()) for r in (80, 160, 320, 640))
    check(field_diff <= 1e-5, f"chunked fields {field_diff:.3e} of max|field| from one chunk")
    plan = plan_cascade(model, variables, 40, 640, stats_mode="tile",
                        coarse_tile=manifest["coarse_tile"])
    chunks = {lv.res: default_scene_chunk(32, lv.res // 2, lv.coarse_tile, lv.overlap)
              for lv in plan.levels}
    log(f"[freeze] calibration of 32 scenes, default scene chunk (scenes per model call by "
        f"level {chunks}): {walls['default']:.2f} s, peak {peaks['default'] / 2**30:.2f} GiB; "
        f"one chunk of 32: {walls['one chunk']:.2f} s, peak {peaks['one chunk'] / 2**30:.2f} "
        f"GiB; gains within {gain_diff:.2e} of max|gain| (limit 2e-4), the cascade's fields "
        f"within {field_diff:.2e} of max|field| (limit 1e-5); on {smi}")
    del by_chunk, scenes
    full = solve_multi_resolution(0, resolutions=(80, 160, 320, 640), k_range=(10.0, 11.0),
                                  device=dev)
    scene = {"u": {40: full["u"][40]}, "f": full["f"], "theta": full["theta"]}
    served = run_bundle(bundle, scene, 640, device=dev)
    worst = 0.0
    for r in (80, 160, 320, 640):
        ref = torch.from_numpy(np.load(out / f"ml_{r}x{r}.npy")).to(dev)
        rel = float((served[r] - ref).abs().max() / ref.abs().max())
        worst = max(worst, rel)
        check(rel <= 1e-6, f"run_bundle at {r}: {rel:.3e} of max|field| from the command's")
    log(f"[freeze] upscale --save_bundle (32 calibration scenes to 640^2): {freeze_s:.2f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB; gains finite; a second calibration "
        f"{calib_s:.2f} s, peak {calib_peak / 2**30:.2f} GiB, bit-identical {identical}; "
        f"run_bundle on the saved bundle within {worst:.2e} of max|field| of the assembled "
        f"cascade (limit 1e-6); launches {counts}; on {smi}")
    return {"launches": counts, "bundle": bundle, "runs": runs,
            "summary": {"freeze_s": freeze_s, "peak_gib": peak / 2**30, "calibrate_s": calib_s,
                        "calibrate_peak_gib": calib_peak / 2**30,
                        "calibrate_one_chunk_s": walls["one chunk"],
                        "calibrate_one_chunk_peak_gib": peaks["one chunk"] / 2**30,
                        "scene_chunks": chunks, "chunk_gain_rel_diff": gain_diff,
                        "chunk_field_rel_diff": field_diff, "run_bundle_rel_diff": worst}}


def phase_evaluate(dev: torch.device, smi: str, root, bundle) -> dict:
    """Phase 13: protocols 1 and 5 of ``scripts/eval_champion_bundle.sh`` on
    the frozen bundle (``statistical --n_examples 20 --seed 3``;
    ``resolution_comparison --k 10 11 --seed 0`` with ``--refine_cycles 2``
    added), their artifacts, and the refined sweep's launches; the statistical
    harness's ML time per scene and peak with the default scene chunk and with
    one chunk of all 20 scenes."""
    from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution_batch
    from superresolution_for_pdes_tpu_torch.cascade.upscale import level_resolutions
    from superresolution_for_pdes_tpu_torch.deploy import load_bundle
    from superresolution_for_pdes_tpu_torch.eval.statistical import (
        solve_times,
        statistics_on_scenes,
    )
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk

    stat_dir, sweep_dir = root / "statistical_bundle_n20_seed3", root / "resolution_bundle"
    sk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stat = run_command(["statistical", "--bundle", str(bundle), "--n_examples", "20",
                        "--seed", "3", "--out", str(stat_dir)])
    torch.cuda.synchronize()
    stat_s = time.perf_counter() - t0
    stat_peak = torch.cuda.max_memory_allocated()
    stat_counts = sk.launch_counts()
    check(sum(stat_counts.values()) == 0, f"statistical launched stencil kernels: {stat_counts}")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = run_command(["resolution_comparison", "--bundle", str(bundle), "--k", "10", "11",
                         "--seed", "0", "--refine_cycles", "2", "--out", str(sweep_dir)])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = sk.launch_counts()
    expected = {"kernel_apply_operator": 0, "kernel_pde_loss_forward": 0,
                "kernel_pde_loss_backward": 0, "kernel_residual": 0,
                "kernel_jacobi_smooth": 6, "kernel_smooth_residual": 6}
    check(sweep_counts == expected, f"refined sweep launches {sweep_counts} != {expected}")
    for path in (stat_dir / "summary.txt", stat_dir / "statistical_results.json",
                 stat_dir / "statistical_results.csv", sweep_dir / "resolution_metrics.json"):
        check(path.is_file(), f"{path.name} was not written")
    prev = 0.0
    for res, a in stat["aggregate"].items():
        check(all(math.isfinite(v) for v in a.values()), f"statistical {res}: {a}")
        log(f"[evaluate] statistical {res}x{res}: ML {1e3 * (a['ml_time_mean'] - prev):.3f} ms "
            f"per scene for this level ({1e3 * a['ml_time_mean']:.3f} ms to reach it), direct "
            f"solve {1e3 * a['solve_time_mean']:.4f} ms per scene, rel-L2 ML "
            f"{a['ml_rel_l2_mean']:.4f} bilinear {a['bilinear_rel_l2_mean']:.4f} (random "
            f"weights: says nothing of model quality)")
        prev = a["ml_time_mean"]
    m = sweep["metrics"]
    for res in (80, 160, 320, 640):
        ml, phys = m["ml_multi_level"][res]["relative_l2"], m["ml_physics"][res]["relative_l2"]
        check(math.isfinite(ml) and math.isfinite(phys), f"sweep {res}: non-finite rel-L2")
        log(f"[evaluate] resolution sweep {res}x{res}: rel-L2 ML {ml:.4f}, ML + 2 V-cycles "
            f"{phys:.4f}, bilinear {m['bilinear_direct'][res]['relative_l2']:.4f}")
    log(f"[evaluate] statistical (20 scenes) {stat_s:.2f} s, peak device memory "
        f"{stat_peak / 2**30:.2f} GiB; resolution_comparison {sweep_s:.2f} s, launches "
        f"{sweep_counts}; artifacts written; on {smi}")

    # the statistical command's scenes through its harness with the default
    # scene chunk and with one chunk of all 20, in turns
    model, variables, amp, manifest = load_bundle(bundle, dev)
    scenes = solve_multi_resolution_batch(3, 20, resolutions=level_resolutions(40, 640),
                                          k_range=(8.0, 12.0), device=dev)
    solve_s = solve_times(scenes)
    per_scene = {"default": [], "one chunk": []}
    chunk_peaks = {}
    for label in ("default", "one chunk", "one chunk", "default"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, agg = statistics_on_scenes(
            model, variables, scenes, (80, 160, 320, 640), solve_s,
            stats_mode=manifest["stats_mode"], overlap=manifest["overlap"],
            coarse_tile=manifest["coarse_tile"], amp_levels=amp,
            scene_chunk=20 if label == "one chunk" else None)
        chunk_peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        per_scene[label].append(1e3 * agg[640]["ml_time_mean"])
    log(f"[evaluate] statistical's harness on its 20 scenes, ML ms per scene to reach 640^2: "
        f"default chunk {per_scene['default']} (peak {chunk_peaks['default']:.2f} GiB), one "
        f"chunk of 20 {per_scene['one chunk']} (peak {chunk_peaks['one chunk']:.2f} GiB); on "
        f"{smi}")
    del scenes
    return {"statistical_launches": stat_counts, "sweep_launches": sweep_counts,
            "statistical_dir": stat_dir,
            "summary": {"statistical_s": stat_s, "statistical_peak_gib": stat_peak / 2**30,
                        "sweep_s": sweep_s, "ml_ms_per_scene_640_by_chunk": per_scene,
                        "peak_gib_by_chunk": chunk_peaks,
                        "ml_ms_to_reach": {r: 1e3 * a["ml_time_mean"]
                                           for r, a in stat["aggregate"].items()},
                        "solve_ms": {r: 1e3 * a["solve_time_mean"]
                                     for r, a in stat["aggregate"].items()}}}


# scripts/rebuild_champion.sh:101-109 and :118-129, stages sfl2f and sfl34g; the
# one cut: 2 epochs, not 1200. The teacher run dirs are filled in.
SFL2F = ["--generate", "--gen_stream", "--gen_theta", "mixed", "--gen_standard", "0",
         "--gen_subdomain", "0", "--gen_cascade_scenes", "0", "--gen_selffeed_scenes", "768",
         "--gen_selffeed_model", "{R7}", "--gen_selffeed_model_level1", "{SFL1E}",
         "--gen_selffeed_finest", "160", "--gen_selffeed_harvest_from", "80",
         "--gen_selffeed_amp", "32", "--gen_selffeed_k", "6", "12",
         "--gen_selffeed_teacher_tile", "40", "--gen_tile_size", "80",
         "--gen_tiles_per_level", "1", "--gen_every", "2", "--normalization", "per_sample",
         "--scale_channels", "--physics_weight", "0.3", "--epochs", "2",
         "--early_stopping_patience", "60", "--plateau_patience", "30"]
SFL34G = ["--generate", "--gen_stream", "--gen_theta", "mixed", "--gen_standard", "0",
          "--gen_subdomain", "0", "--gen_cascade_scenes", "0", "--gen_selffeed_scenes", "128",
          "--gen_selffeed_chunk", "32", "--gen_selffeed_model", "{R7}",
          "--gen_selffeed_model_level1", "{SFL1E}", "--gen_selffeed_model_level", "2", "{SFL2F}",
          "--gen_selffeed_finest", "640", "--gen_selffeed_harvest_from", "160",
          "--gen_selffeed_amp", "32", "--gen_selffeed_k", "6", "12",
          "--gen_selffeed_teacher_tile", "40", "80", "20", "--gen_tile_size", "80",
          "--gen_tiles_per_level", "8", "--gen_every", "2", "--normalization", "per_sample",
          "--scale_channels", "--physics_weight", "0.3", "--epochs", "2",
          "--early_stopping_patience", "60", "--plateau_patience", "30"]


def phase_rebuild(dev: torch.device, smi: str, root, runs: dict) -> dict:
    """Phase 14: the champion's self-fed stages through the train command in
    this process, SFL2F on phase 12's R7 and SFL1E run dirs, then SFL34G with
    that SFL2F run as its level-2 teacher: harvested tiles per regeneration,
    their finiteness, the teacher calibration, regeneration, epoch and warm
    step walls at (32, 160^2), peak memory and launches; then both
    checkpoints serve levels 2 and 3-4 of one cascade to 640^2."""
    import types

    from superresolution_for_pdes_tpu_torch.cascade import modal
    from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
    from superresolution_for_pdes_tpu_torch.cli import resolve_level_experts
    from superresolution_for_pdes_tpu_torch.data import generate
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

    def timed(fn, record):
        """``fn`` with the wall of each top-level call recorded (SFL34G's
        scene chunks call the generator again from inside)."""
        depth = [0]

        def wrapper(*args, **kwargs):
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                torch.cuda.synchronize()
                record.append((time.perf_counter() - t0, out))
            return out

        return wrapper

    teachers = {"R7": runs["r7"], "SFL1E": runs["sfl1e"]}
    stages = {}
    for name, recipe, tiles_expected in (("SFL2F", SFL2F, 768), ("SFL34G", SFL34G, 128 * 8 * 2)):
        argv = [a.format(**teachers) for a in recipe]
        calibrations, regenerations = [], []
        saved = modal.calibrate_modal, generate.selffeed_cascade_dataset
        modal.calibrate_modal = timed(saved[0], calibrations)
        generate.selffeed_cascade_dataset = timed(saved[1], regenerations)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            hist = run_command(["train", *argv, "--results", str(root / name.lower()),
                                "--prefix", f"{name.lower()}_"])
            torch.cuda.synchronize()
        finally:
            modal.calibrate_modal, generate.selffeed_cascade_dataset = saved
        run_s = time.perf_counter() - t0
        counts = sk.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, chunks = sum(hist["train_steps"]), sum(hist["eval_chunks"])
        expected = {"kernel_apply_operator": 0, "kernel_pde_loss_forward": steps + chunks,
                    "kernel_pde_loss_backward": steps, "kernel_residual": 0,
                    "kernel_jacobi_smooth": 0, "kernel_smooth_residual": 0}
        check(counts == expected, f"{name}: launches {counts} != {expected}")
        check(len(calibrations) == 1, f"{name}: {len(calibrations)} teacher calibrations")
        tiles = [int(out["u_fine"].shape[0]) for _, out in regenerations]
        check(tiles == [tiles_expected] * len(tiles) and len(tiles) == 2,
              f"{name}: harvested tiles per regeneration {tiles}, expected {tiles_expected}")
        for _, out in regenerations:
            check(out["u_fine"].shape[-1] == 160 and out["u_coarse"].shape[-1] == 80,
                  f"{name}: tiles {tuple(out['u_coarse'].shape)} -> {tuple(out['u_fine'].shape)}")
            check(all(bool(torch.isfinite(v).all()) for k, v in out.items()
                      if v.is_floating_point()), f"{name}: non-finite tiles")
        losses = hist["train_loss"] + hist["val_loss"]
        check(all(math.isfinite(v) for v in losses), f"{name}: non-finite losses {losses}")

        # a warm train step at (32, 160^2) on the stage's own last tiles
        model, stats = hist["model"], hist["stats"]
        arrays = loop.prepare_arrays(regenerations[-1][1], stats, per_sample=True,
                                     scale_channels=True)
        batch = {k: v[:32] for k, v in arrays.items()}
        opt = loop.make_optimizer(model, TrainConfig())
        step_ms = time_ms(lambda: loop.train_step(model, opt, batch, stats, 0.3, 1.0), reps=10)
        stages[name] = {
            "run_dir": str(hist["run_dir"]), "tiles_per_regeneration": tiles,
            "teacher_calibration_s": calibrations[0][0],
            "regeneration_s": [s for s, _ in regenerations],
            "epoch_s": hist["epoch_seconds"], "epoch_regen_s": hist["regen_seconds"],
            "train_steps": hist["train_steps"], "eval_chunks": hist["eval_chunks"],
            "step_ms": step_ms, "samples_per_s": 32e3 / step_ms, "peak_gib": peak,
            "run_s": run_s, "launches": counts, "losses": losses}
        log(f"[rebuild] {name} (train, {' '.join(recipe)}): {tiles} harvested tiles of 80 -> "
            f"160 per regeneration, finite; teacher calibration {calibrations[0][0]:.2f} s, "
            f"regenerations {[round(s, 3) for s, _ in regenerations]} s, epochs "
            f"{[round(s, 2) for s in hist['epoch_seconds']]} s (regeneration inside "
            f"{[round(s, 2) for s in hist['regen_seconds']]}); warm step at (32, 160^2) "
            f"{step_ms:.2f} ms = {32e3 / step_ms:.0f} samples/s; {steps} steps + {chunks} "
            f"validation chunks, launches {counts}; peak device memory {peak:.2f} GiB; "
            f"command {run_s:.1f} s; on {smi}")
        teachers[name] = stages[name]["run_dir"]
        del hist, model, arrays, batch, opt, regenerations

    # both stages serve their levels of one cascade to 640^2
    ns = types.SimpleNamespace(model_path_level1=runs["sfl1e"],
                               model_path_level=[("2", teachers["SFL2F"]),
                                                 ("3", teachers["SFL34G"]),
                                                 ("4", teachers["SFL34G"])])
    model, variables, _ = resolve_level_experts(runs["r7"], ns, device=dev)
    full = solve_multi_resolution(5, resolutions=(80, 160, 320, 640), k_range=(10.0, 11.0),
                                  device=dev)
    scene = {"u": {40: full["u"][40]}, "f": full["f"], "theta": full["theta"]}
    fields = ml_cascade(model, variables, scene, 640, stats_mode="tile", coarse_tile=(40, 80, 80))
    for r in (80, 160, 320, 640):
        check(fields[r].shape == (r, r) and bool(torch.isfinite(fields[r]).all()),
              f"served {r}: {tuple(fields[r].shape)}, finite {bool(torch.isfinite(fields[r]).all())}")
    log(f"[rebuild] R7 + SFL1E + the rebuilt SFL2F (level 2) and SFL34G (levels 3-4) serve one "
        f"cascade to 640^2 ({len(variables)} expert slots): finite fields at 80-640")
    return {"stages": stages, "launches": {name: s["launches"] for name, s in stages.items()}}


def phase_single_level(smi: str, root, r7_run: str, stat_dir) -> dict:
    """Phase 15: ``compare_methods`` on phase 12's R7 run dir with 1000 fresh
    samples, and ``diagnose`` on phase 13's ``statistical_results.json``."""
    t0 = time.perf_counter()
    result = run_command(["compare_methods", "--model_path", r7_run, "--n_samples", "1000",
                          "--out", str(root / "compare_methods")])
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    check(result["n_samples"] == 1000 and all(
        math.isfinite(v) for ms in result["summary"].values() for v in ms.values()),
        f"compare_methods summary {result['summary']}")
    check((root / "compare_methods" / "compare_metrics.json").is_file(),
          "compare_metrics.json was not written")
    t0 = time.perf_counter()
    diag = run_command(["diagnose", "--results", str(stat_dir / "statistical_results.json"),
                        "--focus", "640", "--out", str(root / "diagnosis.json")])
    diagnose_s = time.perf_counter() - t0
    check(diag["resolutions"] == [80, 160, 320, 640] and len(diag["table"]) == 20,
          f"diagnose: resolutions {diag['resolutions']}, {len(diag['table'])} scenes")
    check((root / "diagnosis.json").is_file(), "diagnosis.json was not written")
    s = result["summary"]
    log(f"[single-level] compare_methods, 1000 samples at 40^2 in one model batch: "
        f"{compare_s:.2f} s (model load, solves, metrics and JSON included), MAE ML "
        f"{s['ml']['mae']:.3e} bilinear {s['bilinear']['mae']:.3e} bicubic "
        f"{s['bicubic']['mae']:.3e} (random weights); diagnose over 20 scenes {diagnose_s:.3f} s "
        f"({len(diag['features'])} features); compare_metrics.json and diagnosis.json written; "
        f"on {smi}")
    return {"compare_s": compare_s, "diagnose_s": diagnose_s, "summary": s}


# The round-1 ResNet run of reports/ROUND1.md:14-18 (enhanced_run_resnet: 4,000
# mixed-theta samples, physics weight 0.1, the 0.6M-parameter ResNet). The report
# records no flags: these are read off its table (1,000 standard + 1,000 subdomain
# samples per theta stratum, which --gen_theta mixed doubles to 4,000; batch 32 and
# the rest at train's defaults). The one cut: 2 epochs.
RESNET = ["--model", "resnet", "--generate", "--gen_standard", "1000", "--gen_subdomain",
          "1000", "--gen_theta", "mixed", "--physics_weight", "0.1", "--batch_size", "32",
          "--epochs", "2"]


def phase_resnet(dev: torch.device, smi: str, root) -> dict:
    """Phase 16: ``train --model resnet`` in this process with the round-1
    ResNet recipe cut to 2 epochs: launches (the fused loss forward per step
    and validation chunk, its backward per step, no other kernel), finite
    losses, both checkpoints load through ``resolve_model`` as a 594,753
    parameter ``PDEResNet``; one step with the kernels against the twins; a
    warm step's time and profile; peak memory; the checkpoint serves one
    scene to 640^2 through ``ml_cascade``."""
    from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
    from superresolution_for_pdes_tpu_torch.cli import resolve_model
    from superresolution_for_pdes_tpu_torch.models import PDEResNet, count_parameters
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_command(["train", *RESNET, "--results", str(root / "resnet"),
                        "--prefix", "resnet_"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps, chunks = sum(hist["train_steps"]), sum(hist["eval_chunks"])
    expected = {"kernel_apply_operator": 0, "kernel_pde_loss_forward": steps + chunks,
                "kernel_pde_loss_backward": steps, "kernel_residual": 0,
                "kernel_jacobi_smooth": 0, "kernel_smooth_residual": 0}
    log(f"[resnet] train {' '.join(RESNET)}: {steps} train steps {hist['train_steps']}, "
        f"{chunks} validation chunks; launches {counts}")
    check(counts == expected, f"resnet launches {counts} != {expected}")
    losses = hist["train_loss"] + hist["val_loss"]
    check(all(math.isfinite(v) for v in losses), f"resnet: non-finite losses {losses}")
    x = torch.randn(4, 3, 40, 40, device=dev, generator=torch.Generator(dev).manual_seed(2))
    for which in ("best_model", "final_model"):
        model, weights, _ = resolve_model(str(hist["run_dir"] / which), device=dev)
        n_params = count_parameters(model)
        check(isinstance(model, PDEResNet) and n_params == 594_753,
              f"{which}: {type(model).__name__} of {n_params} parameters")
        model.load_state_dict(weights)
        with torch.no_grad():
            y = model(x)
        check(y.shape == (4, 1, 40, 40) and bool(torch.isfinite(y).all()),
              f"{which}: forward of the reloaded ResNet")
    log(f"[resnet] losses train {hist['train_loss']} val {hist['val_loss']}; best_model and "
        f"final_model load through resolve_model as a PDEResNet of {n_params} parameters; "
        f"peak device memory {peak:.2f} GiB; epochs {hist['epoch_seconds']} s; command "
        f"{run_s:.1f} s; on {smi}")

    model, stats = hist["model"], hist["stats"]
    batch = step_batch(dev, stats, per_sample=False, scale_channels=False)
    parity = kernel_vs_twin_step(model, batch, stats, 0.1, "resnet")
    warm = warm_step(model, batch, stats, 0.1, "resnet", smi)

    served, weights, _ = resolve_model(str(hist["run_dir"]), device=dev)
    full = solve_multi_resolution(9, resolutions=(80, 160, 320, 640), k_range=(10.0, 11.0),
                                  device=dev)
    scene = {"u": {40: full["u"][40]}, "f": full["f"], "theta": full["theta"]}
    serve_ms = wall_ms(lambda: ml_cascade(served, weights, scene, 640, stats_mode="tile"))
    fields = ml_cascade(served, weights, scene, 640, stats_mode="tile")
    for r in (80, 160, 320, 640):
        check(fields[r].shape == (r, r) and bool(torch.isfinite(fields[r]).all()),
              f"resnet served {r}: {tuple(fields[r].shape)}")
    log(f"[resnet] the checkpoint serves one scene to 640^2 through ml_cascade (tile stats): "
        f"finite at 80-640, {serve_ms:.1f} ms warm; on {smi}")
    return {"launches": counts, "run_dir": str(hist["run_dir"]),
            "summary": {"steps": steps, "eval_chunks": chunks, "run_s": run_s,
                        "epoch_s": hist["epoch_seconds"], "peak_gib": peak, "losses": losses,
                        "serve_ms": serve_ms, **parity, **warm}}


def phase_router(dev: torch.device, smi: str, root, r7_run: str, resnet_run: str) -> dict:
    """Phase 17: the regime router's harnesses. Four full-width BatchNorm
    U-Net experts as run dirs (the varying one per sample with 5 channels)
    and a reference ``.pth``; ``compare_test_cases`` with the flags of
    ``reports/RECIPES.md:100-104`` (4 arms, thresholds 6.0 and 6.5, 10
    samples per set); ``out_of_sample`` at its defaults with the router, with
    phase 16's ResNet run and with the ``.pth``: artifacts, figures written
    or named as skipped; the wavenumbers on the card against float64 on the
    CPU, the masks, every arm used, routed predictions against each
    expert's own; ``run_single_example`` on phase 12's R7 run to 640^2."""
    import contextlib
    import io

    from superresolution_for_pdes_tpu_torch.cli import resolve_expert, resolve_model
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.eval.single_level import predict_dataset
    from superresolution_for_pdes_tpu_torch.eval.statistical import run_single_example
    from superresolution_for_pdes_tpu_torch.eval.test_cases import GRID, grid_datasets
    from superresolution_for_pdes_tpu_torch.models.router import RegimeRouter, estimate_wavenumbers
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

    runs = {}
    for i, name in enumerate(("const", "varying", "consthi", "varyinghi")):
        cfg = {"model": "attention_unet"}
        if name == "varying":
            cfg.update(normalization="per_sample", scale_channels=True)
        run = root / f"{name}_run_0"
        save_checkpoint(run / "best_model",
                        {"model": random_expert(300 + i, 5 if name == "varying" else 3)})
        (run / "config.json").write_text(json.dumps(cfg))
        runs[name] = str(run)
    pth = root / "reference" / "reference_unet.pth"
    pth.parent.mkdir()
    torch.save({"model_state_dict": random_expert(310, 3)}, pth)
    router_flags = ["--expert_const", runs["const"], "--expert_const_highk", runs["consthi"],
                    "--k_threshold", "6.0", "--expert_varying", runs["varying"],
                    "--expert_varying_highk", runs["varyinghi"], "--k_threshold_varying", "6.5"]

    def command(argv, out, json_names, figures):
        """The command with its launches, wall and printed lines; each JSON
        artifact written, each figure written or named as skipped."""
        buf = io.StringIO()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = run_command([*argv, "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = sk.launch_counts()
        text = buf.getvalue()
        log(text.rstrip())
        check(sum(counts.values()) == 0, f"{argv[0]} launched stencil kernels: {counts}")
        for name in json_names:
            check((out / name).is_file(), f"{argv[0]}: {name} was not written")
        skipped = [line for line in text.splitlines() if "figures skipped" in line]
        for name in figures:
            check((out / name).is_file() or any(name in line for line in skipped),
                  f"{argv[0]}: figure {name} neither written nor named as skipped")
        return result, wall, counts

    labels = [label for label, _, _ in GRID]
    grid, grid_s, grid_counts = command(
        ["compare_test_cases", *router_flags, "--n_samples", "10"], root / "test_cases",
        ["comprehensive_test_results.json"] + [f"{label}_metrics.json" for label in labels],
        [f"comparison_{m}{s}.png" for m in ("mae", "rmse") for s in ("", "_log")]
        + [f"{label}_sample_{i}.png" for label in labels for i in (1, 2)])
    check(list(grid) == labels, f"compare_test_cases sets {list(grid)}")
    oos = {}
    for label, argv in (("router", router_flags), ("resnet", ["--model_path", resnet_run]),
                        (".pth", ["--model_path", str(pth)])):
        result, wall, counts = command(
            ["out_of_sample", *argv], root / f"out_of_sample_{label.strip('.')}",
            ["average_metrics.json", "out_of_sample_metrics.json"],
            [f"{kind}_{i}.png" for kind in ("error_distribution", "cross_section",
                                            "out_of_sample_sample") for i in (1, 2, 3)])
        s = result["summary"]
        check(result["n_samples"] == 5 and all(math.isfinite(v) for ms in s.values()
                                                for v in ms.values()),
              f"out_of_sample {label}: {s}")
        oos[label] = {"wall_s": wall, "ml_mae": s["ml"]["mae"], "bilinear_mae": s["bilinear"]["mae"],
                      "launches": counts}
    for label, r in grid.items():
        s = r["summary"]
        check(all(math.isfinite(v) for ms in s.values() for v in ms.values()),
              f"compare_test_cases {label}: {s}")

    # the grid's sets again (compare_test_cases draws them from --seed 0): the
    # estimator on the card against float64 on the CPU, the masks, the arms,
    # and each routed sample against its expert's own prediction
    sets = grid_datasets(0, 10, device=dev)
    router = RegimeRouter(*(resolve_expert(runs[n], device=dev) for n in ("const", "varying")),
                          const_high=resolve_expert(runs["consthi"], device=dev),
                          varying_high=resolve_expert(runs["varyinghi"], device=dev),
                          k_threshold=6.0, k_threshold_varying=6.5)
    experts = (router.const, router.varying, router.const_high, router.varying_high)
    k_err, routed_err, per_arm = 0.0, 0.0, [0, 0, 0, 0]
    for label, data in sets.items():
        check(data["k1"].tolist() == grid[label]["k1"], f"{label}: another draw than the command's")
        f, theta = data["f_fine"], data["theta_fine"]
        for card_k, cpu_k in zip(estimate_wavenumbers(f), estimate_wavenumbers(f.cpu().double())):
            k_err = max(k_err, float((card_k.cpu() - cpu_k).abs().max()))
        masks = {where: (router.regime_mask(th), router.highk_mask(ff), router.highk_mask(ff, 6.5))
                 for where, th, ff in (("card", theta, f),
                                       ("cpu", theta.cpu().double(), f.cpu().double()))}
        for a, b in zip(masks["card"], masks["cpu"]):
            check(a.cpu().tolist() == b.tolist(), f"{label}: masks on the card and the CPU differ")
        const, hi, hi_v = masks["card"]
        arm = torch.where(const, torch.where(hi, 2, 0), torch.where(hi_v, 3, 1))
        stats = NormStats.from_dataset(data)
        routed = router.predict(data, stats)
        for a, (model, weights, normalization) in enumerate(experts):
            sel = arm == a
            per_arm[a] += int(sel.sum())
            if sel.any():
                own = predict_dataset(model, weights, data, stats, normalization=normalization)
                err = float((routed[sel] - own[sel]).abs().max() / own[sel].abs().max())
                routed_err = max(routed_err, err)
    check(k_err <= 1e-4, f"wavenumbers on the card vs float64 on the CPU: {k_err:.2e}")
    check(all(n >= 1 for n in per_arm), f"samples per arm {per_arm}")
    check(routed_err <= 1e-6, f"routed vs each expert's own prediction: {routed_err:.2e}")

    model, weights, _ = resolve_model(r7_run, device=dev)
    t0 = time.perf_counter()
    single = run_single_example(model, weights, 0, (80, 160, 320, 640), (10.0, 11.0), "tile",
                                device=dev)
    single_s = time.perf_counter() - t0
    for r in (80, 160, 320, 640):
        check(all(math.isfinite(v) for m in ("ml", "bilinear") for v in single[r][m].values()),
              f"run_single_example {r}: {single[r]}")
    log(f"[router] compare_test_cases (4 arms, thresholds 6.0 / 6.5, 5 sets of 10) "
        f"{grid_s:.2f} s; out_of_sample (5 samples) router {oos['router']['wall_s']:.2f} s, "
        f"resnet {oos['resnet']['wall_s']:.2f} s, .pth {oos['.pth']['wall_s']:.2f} s; samples "
        f"per arm (const, varying, const high-k, varying high-k) {per_arm}; wavenumbers on the "
        f"card within {k_err:.2e} of float64 on the CPU (limit 1e-4), masks equal; routed "
        f"predictions within {routed_err:.2e} of each expert's own (limit 1e-6); "
        f"run_single_example on R7 to 640^2 {single_s:.2f} s (ML ms by resolution "
        f"{ {r: round(1e3 * single[r]['ml_time'], 3) for r in (80, 160, 320, 640)} }); "
        f"on {smi}")
    return {"launches": {"compare_test_cases": grid_counts,
                         **{f"out_of_sample {k}": v["launches"] for k, v in oos.items()}},
            "summary": {"compare_test_cases_s": grid_s, "out_of_sample": oos,
                        "per_arm": per_arm, "k_err": k_err, "routed_err": routed_err,
                        "single_example_s": single_s,
                        "single_example_ml_ms": {r: 1e3 * single[r]["ml_time"]
                                                 for r in (80, 160, 320, 640)}}}


# scripts/rebuild_champion.sh:87-90 (R7) with reports/RECIPES.md:26's r7bf16 flags; the
# one cut: 2 epochs, not 1000
R7BF16 = ["--generate", "--gen_stream", "--gen_theta", "mixed", "--gen_cascade_scenes", "384",
          "--gen_tiles_per_level", "12", "--gen_cascade_k", "6", "12",
          "--normalization", "per_sample", "--scale_channels", "--physics_weight", "0.3",
          "--early_stopping_patience", "50", "--plateau_patience", "25",
          "--dtype", "bfloat16", "--batch_size", "256", "--lr", "6e-4", "--epochs", "2"]
# reports/RECIPES.md:27, consthi2; the cut: 4 epochs, not 1000
CONSTHI2 = ["--generate", "--gen_stream", "--gen_theta", "constant", "--gen_standard", "2000",
            "--gen_standard_k", "4.5", "9", "--gen_subdomain", "1000", "--gen_subdomain_k",
            "4.5", "12", "--dtype", "bfloat16", "--batch_size", "256", "--lr", "6e-4",
            "--epochs", "4", "--early_stopping_patience", "50", "--plateau_patience", "25"]
BF16_STEP = 2.0 ** -8  # one bf16 step, relative to max|x|
BF16_BYTES = 2


def phase_bf16(dev: torch.device, smi: str, root) -> dict:
    """Phase 18 (a): the r7bf16 recipe through the train command; K1's bf16
    loss kernels: their launches on the run (one forward per step and per
    validation chunk, one backward per step, no float32 K1 launch), against
    their twins at (256, 40^2) and timed there, one bf16 step with the
    kernels against the twins, and the warm step in bf16 and in float32."""
    from superresolution_for_pdes_tpu_torch.cli import train as train_cli
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk

    sk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train_cli.main([*R7BF16, "--results", str(root / "r7bf16"), "--device", dev.type])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts16, counts32 = sk.launch_counts(torch.bfloat16), sk.launch_counts()
    steps, chunks = sum(hist["train_steps"]), sum(hist["eval_chunks"])
    log(f"[r7bf16] 2 epochs: {steps} steps {hist['train_steps']}, {chunks} validation chunks; "
        f"bf16 launches {counts16}, float32 launches {counts32}; losses train "
        f"{hist['train_loss']} val {hist['val_loss']}")
    check(counts16["kernel_pde_loss_forward"] == steps + chunks
          and counts16["kernel_pde_loss_backward"] == steps
          and sum(counts16.values()) == steps + chunks + steps,
          f"bf16 loss launches {counts16}: expected {steps} + {chunks} forward, {steps} backward")
    check(sum(counts32.values()) == 0, f"float32 K1 launches on the bf16 path: {counts32}")
    check(all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]), "losses")
    state = hist["model"].state_dict()
    check(all(v.dtype == torch.float32 for v in state.values() if v.is_floating_point()),
          "the bf16 run's parameters are float32")
    log(f"[r7bf16] regeneration {hist['regen_seconds']} s, epoch walls {hist['epoch_seconds']} "
        f"s, CLI run {run_s:.1f} s, peak device memory {peak:.2f} GiB, on {smi}")

    # the bf16 kernels alone at the recipe's shape, against their twins
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (256, 40, 40)
    points = math.prod(shape)
    pred = torch.randn(256, 1, 40, 40, device=dev, generator=gen).bfloat16()
    theta = (torch.rand(shape, device=dev, generator=gen) * 1.5 + 0.5).bfloat16()
    f = torch.randn(shape, device=dev, generator=gen).bfloat16()
    st = tuple(t.bfloat16() for t in (torch.randn(256, 1, 1, device=dev, generator=gen),
                                      torch.rand(256, 1, 1, device=dev, generator=gen) + 0.5,
                                      torch.rand(256, 1, 1, device=dev, generator=gen) + 0.5))
    g = torch.tensor(0.7, device=dev)
    ref_loss, ref_seed = sk.plain_pde_residual_loss(pred, theta, f, *st)
    ref_grad = sk.plain_pde_residual_loss_backward(ref_seed, st[1], g, dtype=torch.bfloat16)
    loss, seed = sk.kernel_pde_loss_forward(pred, theta, f, *st)
    grad = sk.kernel_pde_loss_backward(seed, st[1], g, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    seed_err = float((seed - ref_seed).abs().max())
    grad_err = float((grad.float() - ref_grad.float()).abs().max())
    check(loss.dtype == torch.float32 and grad.dtype == torch.bfloat16, "bf16 kernel dtypes")
    check(loss_rel <= 1e-6, f"bf16 loss {float(loss)} vs twin {float(ref_loss)}")
    check(seed_err <= 4e-6 * float(ref_seed.abs().max()), f"bf16 seed {seed_err:.3e}")
    check(grad_err <= BF16_STEP * float(ref_grad.float().abs().max()), f"bf16 grad {grad_err:.3e}")

    def fwd():
        return sk.kernel_pde_loss_forward(pred, theta, f, *st)

    def bwd():
        return sk.kernel_pde_loss_backward(seed, st[1], g, dtype=torch.bfloat16)

    timing = {
        "forward": dict(ms=time_ms(fwd), device_ms=device_ms_per_call(fwd, K1_FWD_NAME),
                        plain_ms=time_ms(lambda: sk.plain_pde_residual_loss(pred, theta, f, *st)),
                        # pred, theta and f read in bf16, the float32 seed written
                        bound=bound((3 * BF16_BYTES + 4) * points, 16 * points),
                        library_ms=None, max_abs_err=seed_err, loss_rel=loss_rel,
                        shape=list(shape)),
        "backward": dict(ms=time_ms(bwd), device_ms=device_ms_per_call(bwd, K1_BWD_NAME),
                         plain_ms=time_ms(lambda: sk.plain_pde_residual_loss_backward(
                             seed, st[1], g, dtype=torch.bfloat16)),
                         # the float32 seed read, the bf16 gradient written
                         bound=bound((4 + BF16_BYTES) * points, 9 * points),
                         library_ms=None, max_abs_err=grad_err, shape=list(shape)),
    }
    for label, t in timing.items():
        log(f"[r7bf16] bf16 loss {label} {shape}: device {t['device_ms'] * 1e3:.3f} us per "
            f"launch (profiler), {t['ms']:.4f} ms per call (CUDA events), twin "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0] * 1e3:.3f} us ({t['bound'][1]}) = "
            f"{100 * t['bound'][0] / max(t['device_ms'], 1e-9):.0f}% of the device time; on "
            f"{smi}")
    log(f"[r7bf16] bf16 kernels vs twins at {shape}: loss {loss_rel:.2e} relative, seed "
        f"{seed_err:.2e}, gradient {grad_err:.2e} (one bf16 step: "
        f"{BF16_STEP * float(ref_grad.float().abs().max()):.2e})")

    model, stats = hist["model"], hist["stats"]
    batch16 = step_batch(dev, stats, True, True, n=256, dtype=torch.bfloat16)
    kernel_vs_twin_step(model, batch16, stats, 0.3, "r7bf16", grad_tol=BF16_STEP)
    warm = {"bfloat16": warm_step(model, batch16, stats, 0.3, "r7bf16", smi)}
    batch32 = step_batch(dev, stats, True, True, n=256)
    warm["float32"] = warm_step(model, batch32, stats, 0.3, "r7bf16", smi)
    log(f"[r7bf16] warm step at (256, 40^2): bf16 {warm['bfloat16']['step_ms']:.3f} ms, float32 "
        f"{warm['float32']['step_ms']:.3f} ms; device busy bf16 "
        f"{warm['bfloat16']['device_busy_ms']:.3f} ms, float32 "
        f"{warm['float32']['device_busy_ms']:.3f} ms; on {smi}")
    return {"launches": counts16, "launches_float32": counts32, "timing": timing,
            "summary": {"steps": steps, "eval_chunks": chunks, "run_s": run_s,
                        "peak_gib": peak, "regen_s": hist["regen_seconds"],
                        "epoch_s": hist["epoch_seconds"], "warm": warm}}


def count_syncs(fn):
    """``fn()``'s result and the number of synchronizing CUDA calls it made
    (host reads), counted by ``torch.cuda.set_sync_debug_mode``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def phase_fused(dev: torch.device, smi: str, root) -> dict:
    """Phase 19 (b): the consthi2 recipe cut to 4 epochs, streamed, with and
    without ``--fused_epochs 2`` (cuDNN deterministic for both): the per-epoch
    losses, the epoch walls and the host reads (synchronizing calls) of each
    run."""
    from superresolution_for_pdes_tpu_torch.cli import train as train_cli

    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, extra in (("unfused", []), ("fused", ["--fused_epochs", "2"])):
            t0 = time.perf_counter()
            hist, syncs = count_syncs(lambda extra=extra, label=label: train_cli.main(
                [*CONSTHI2, *extra, "--results", str(root / f"consthi2_{label}"),
                 "--device", dev.type]))
            torch.cuda.synchronize()
            runs[label] = dict(train=hist["train_loss"], val=hist["val_loss"], lr=hist["lr"],
                               epoch_s=hist["epoch_seconds"], regen_s=hist["regen_seconds"],
                               run_s=time.perf_counter() - t0, host_syncs=syncs)
    finally:
        torch.backends.cudnn.deterministic = False
    # where the host syncs are: one regeneration of the recipe's set, one train step
    from superresolution_for_pdes_tpu_torch.data.generate import generate_mixed_dataset
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

    _, regen_syncs = count_syncs(lambda: generate_mixed_dataset(
        42, 2000, 1000, theta="constant", standard_k_range=(4.5, 9.0),
        subdomain_k_range=(4.5, 12.0), device=dev))
    model, stats = hist["model"], hist["stats"]
    batch = step_batch(dev, stats, False, False, n=256, dtype=torch.bfloat16)
    opt = loop.make_optimizer(model, TrainConfig())
    loop.train_step(model, opt, batch, stats)
    _, step_syncs = count_syncs(lambda: loop.train_step(model, opt, batch, stats))
    a, b = runs["unfused"], runs["fused"]
    for run in (a, b):
        check(len(run["train"]) == 4 and all(math.isfinite(v) for v in run["train"] + run["val"]),
              f"consthi2 losses {run}")
    lr_inside = [e for e in range(4) if e % 2 == 0 and a["lr"][e] != a["lr"][0]]
    equal = a["train"] == b["train"] and a["val"] == b["val"]
    parts = [e for e in range(4) if (a["train"][e], a["val"][e]) != (b["train"][e], b["val"][e])]
    worst = max(max(abs(x - y) / abs(y) for x, y in zip(b[k], a[k])) for k in ("train", "val"))
    log(f"[fused] consthi2, 4 epochs: unfused train {a['train']} val {a['val']}; fused K=2 "
        f"train {b['train']} val {b['val']}; equal bit for bit: {equal} (epochs that differ: "
        f"{parts}, worst relative difference {worst:.2e}; LR changes inside a chunk: "
        f"{lr_inside})")
    log(f"[fused] epoch walls unfused {a['epoch_s']} s (regeneration {a['regen_s']} s), fused "
        f"{b['epoch_s']} s (per epoch of a chunk); runs {a['run_s']:.1f} s and {b['run_s']:.1f} "
        f"s; host syncs over the run: unfused {a['host_syncs']}, fused {b['host_syncs']} (2 "
        f"chunks); one regeneration {regen_syncs}, one warm train step {step_syncs}; on {smi}")
    check(worst <= 1e-2, f"fused and unfused consthi2 part by {worst:.2e}")
    return {"runs": runs, "equal": equal, "differ_at": parts, "worst_rel": worst,
            "regen_syncs": regen_syncs, "step_syncs": step_syncs}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_dp(dev: torch.device, smi: str, root, r7_history: dict) -> dict:
    """Phase 20 (c): ``train --data_parallel --multihost`` under ``torchrun``
    (one process, NCCL) with R7's flags cut to 1 epoch, side by side with
    phase 10's first epoch; and, in a one-rank NCCL group of this process,
    one data-parallel step against the plain step on the same batch and
    weights (loss 1e-6 relative, gradients 1e-5 of max)."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from superresolution_for_pdes_tpu_torch.data.generate import generate_mixed_dataset
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet
    from superresolution_for_pdes_tpu_torch.parallel import data as dpar
    from superresolution_for_pdes_tpu_torch.parallel import data_mesh, initialize_multihost
    from superresolution_for_pdes_tpu_torch.train import loop
    from superresolution_for_pdes_tpu_torch.train.metrics import read_metrics

    recipe = [*R7BF16[:R7BF16.index("--dtype")], "--epochs", "1"]  # R7's own flags
    out_dir = root / "r7_dp"
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "superresolution_for_pdes_tpu_torch", "train", "--data_parallel", "--multihost",
         *recipe, "--results", str(out_dir), "--device", dev.type],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])})
    run_s = time.perf_counter() - t0
    tail = (done.stdout + done.stderr)[-3000:]
    check(done.returncode == 0, f"torchrun train exited {done.returncode}:\n{tail}")
    topo = [line for line in done.stdout.splitlines() if line.startswith("multihost:")]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(topo == [f"multihost: process 0/1, 1 global devices, backend {backend}"],
          f"topology line {topo}")
    (run_dir,) = [d for d in out_dir.iterdir() if d.is_dir()]
    dp = read_metrics(run_dir)[0]
    side = {"dp": (dp["train_loss"], dp["val_loss"]),
            "plain": (r7_history["train_loss"][0], r7_history["val_loss"][0])}
    rel = [abs(x - y) / abs(y) for x, y in zip(side["dp"], side["plain"])]
    log(f"[dp] torchrun, 1 process: {topo[0]}; epoch 1 train/val DP {side['dp']} vs phase 10 "
        f"{side['plain']} ({rel[0]:.2e} and {rel[1]:.2e} apart: cuDNN's nondeterministic "
        f"kernels make two runs of phase 10 differ too, and the global BatchNorm rounds "
        f"otherwise; the mean train loss of 701 steps is the steadier); {run_s:.1f} s with "
        f"the launch, on {smi}")
    check(all(math.isfinite(v) for v in side["dp"]) and rel[0] <= 5e-2,
          f"DP epoch 1 train loss is {rel[0]:.2e} from the plain run's")

    # one DP step against the plain step in a one-rank group of this process
    topo_here = initialize_multihost(f"localhost:{_free_port()}", 1, 0, device=dev)
    try:
        mesh = data_mesh()
        model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(3)).to(dev)
        stats = NormStats.from_dataset(generate_mixed_dataset(5, 16, 16, theta="mixed",
                                                              device=dev))
        batch = step_batch(dev, stats, True, True)
        state0 = {k: v.clone() for k, v in model.state_dict().items()}
        torch.backends.cudnn.deterministic = True
        result = {}
        for label, group in (("plain", None), ("dp", dpar.data_group(mesh))):
            model.load_state_dict(state0)
            dpar.sync_batch_norm(model, group)
            model.train().zero_grad(set_to_none=True)
            loss = loop.batch_loss(model, {k: dpar.shard_rows(v, group) for k, v in batch.items()},
                                   stats, 0.3)
            loss.backward()
            dpar.all_reduce_gradients(model.parameters(), group)
            result[label] = (float(loss.detach()),
                             {n: p.grad.clone() for n, p in model.named_parameters()})
        dpar.sync_batch_norm(model, None)
        torch.backends.cudnn.deterministic = False
    finally:
        dist.destroy_process_group()
    # the same step in float64 (the twins' loss): the referee of both float32 steps
    model64 = copy.deepcopy(model).double()
    model64.load_state_dict({k: v.double() if v.is_floating_point() else v
                             for k, v in state0.items()})
    stats64 = NormStats(**{k: v.double() if v.is_floating_point() else v
                           for k, v in dataclasses.asdict(stats).items()})
    model64.train().zero_grad(set_to_none=True)
    loss64 = loop.batch_loss(model64, {k: v.double() for k, v in batch.items()}, stats64, 0.3,
                             use_kernel=False)
    loss64.backward()
    g64 = {n: p.grad for n, p in model64.named_parameters()}
    (lp, gp), (ld, gd) = result["plain"], result["dp"]
    loss_rel = abs(ld - lp) / abs(lp)
    top = max(float(g.abs().max()) for g in g64.values())

    def dist(grads, ref):
        return max(float((grads[n].double() - r.double()).abs().max())
                   for n, r in ref.items()) / top

    grad_rel, plain_err, dp_err = dist(gd, gp), dist(gp, g64), dist(gd, g64)
    log(f"[dp] one-rank group {topo_here}: one DP step vs the plain step, loss {ld:.7f} vs "
        f"{lp:.7f} ({loss_rel:.2e} relative; tol 1e-6), gradients {grad_rel:.2e} of max apart "
        f"(1e-5 asked: {grad_rel <= 1e-5}); the float64 step is {plain_err:.2e} of max from the "
        f"plain float32 step and {dp_err:.2e} from the DP one (held to twice the plain one's "
        f"plus 1e-5). The two float32 steps round at other places: the DP BatchNorm takes "
        f"E[x^2] - E[x]^2 from float64 sums and a centered backward, the plain one is cuDNN's")
    check(loss_rel <= 1e-6 and dp_err <= 2 * plain_err + 1e-5,
          f"DP step: loss {loss_rel:.2e} from the plain step's, gradients {dp_err:.2e} from "
          f"float64 (plain {plain_err:.2e})")
    return {"topology": topo[0], "epoch1": side, "epoch1_rel": rel, "run_s": run_s,
            "step_loss_rel": loss_rel, "step_grad_rel": grad_rel, "plain_f64_err": plain_err,
            "dp_f64_err": dp_err}


def phase_online(dev: torch.device, smi: str) -> dict:
    """Phase 21 (d): ``make_online_train_step`` at batch 32 with the
    full-width U-Net, three steps on freshly generated data."""
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet
    from superresolution_for_pdes_tpu_torch.parallel import (
        calibration_stats,
        make_online_train_step,
    )
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

    stats = calibration_stats(0, n_samples=512, device=dev)
    model = AttentionUNet(generator=torch.Generator().manual_seed(4))
    step = make_online_train_step(model, loop.make_optimizer(model, TrainConfig()), stats, 32,
                                  device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    walls, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(gen)))
        walls.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(v) for v in losses) and step.steps == 3,
          f"online steps {losses}, count {step.steps}")
    log(f"[online] 3 steps at batch 32 (16 standard + 16 subdomain solved per step): losses "
        f"{losses}, ms per step {walls} (the first one cold), on {smi}")
    return {"losses": losses, "ms_per_step": walls}


def phase_shard(smi: str, root, bundle) -> dict:
    """Phase 22 (e): ``resolution_comparison --shard_tiles`` on phase 12's
    bundle against the unsplit sweep (phase 13's flags): metrics and fields
    bit for bit."""
    argv = ["resolution_comparison", "--bundle", str(bundle), "--k", "10", "11", "--seed", "0",
            "--refine_cycles", "2"]
    runs = {}
    for label, extra in (("split", ["--shard_tiles"]), ("plain", [])):
        t0 = time.perf_counter()
        runs[label] = run_command([*argv, *extra, "--out", str(root / f"sweep_{label}")])
        torch.cuda.synchronize()
        runs[label]["wall_s"] = time.perf_counter() - t0
    a, b = runs["split"], runs["plain"]
    check(a["metrics"] == b["metrics"], "split sweep metrics differ")
    for name, by_res in b["solutions"].items():
        for res, field in by_res.items():
            check(torch.equal(a["solutions"][name][res], field), f"split {name} {res} differs")
    log(f"[shard] resolution_comparison --shard_tiles over {torch.cuda.device_count()} card(s): "
        f"metrics and fields equal the unsplit run's bit for bit; walls {a['wall_s']:.2f} s and "
        f"{b['wall_s']:.2f} s, on {smi}")
    return {"wall_s": {k: v["wall_s"] for k, v in runs.items()}}


def phase_trace(dev: torch.device, smi: str, root, bundle) -> dict:
    """Phase 23 (f): one served cascade to 640^2 inside ``device_trace``: the
    Chrome trace is written and names the convolution kernels."""
    from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution
    from superresolution_for_pdes_tpu_torch.deploy import run_bundle
    from superresolution_for_pdes_tpu_torch.utils.profiling import device_trace

    scene = solve_multi_resolution(5, resolutions=(80, 160, 320, 640), k_range=(10.0, 11.0),
                                   device=dev)
    scene = {"u": {40: scene["u"][40]}, "f": scene["f"], "theta": scene["theta"]}
    run_bundle(bundle, scene, 640, device=dev)  # warm
    with device_trace(root / "trace", device=dev) as path:
        run_bundle(bundle, scene, 640, device=dev)
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    convs = sorted(k for k in kernels if kernel_class(k) == "convolution (cuDNN)")
    check(path.is_file() and convs, f"trace {path}: {len(kernels)} kernels, no convolution")
    log(f"[trace] device_trace of one served cascade to 640^2: {path.name}, "
        f"{path.stat().st_size / 2**20:.1f} MiB, {len(kernels)} kernel names, "
        f"{len(convs)} convolution kernels (e.g. {convs[:1]}), on {smi}")
    return {"kernels": len(kernels), "convolution_kernels": len(convs)}


def phase_native(dev: torch.device, smi: str) -> dict:
    """Phase 24 (g): the native float64 C++ oracle built with g++ on the host,
    its CG solve at 160^2 against a float64 DST solve on the card (1e-8 of
    max|u|)."""
    import numpy as np

    from superresolution_for_pdes_tpu_torch import native
    from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
    from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst

    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    n = 160
    f = forcing_term(torch.tensor(3.3), torch.tensor(7.1), n, dtype=torch.float64,
                     device="cpu").numpy()
    theta = np.random.default_rng(8).uniform(0.5, 2.0, (n, n))
    t0 = time.perf_counter()
    u = native.solve_cg(f, theta)
    cg_s = time.perf_counter() - t0
    ref = solve_poisson_dst(torch.from_numpy(f).to(dev), torch.from_numpy(theta).to(dev),
                            refine_iters=1).cpu().numpy()
    err = float(np.max(np.abs(u - ref)) / np.max(np.abs(ref)))
    log(f"[native] g++ build {build_s:.2f} s; CG at 160^2 in float64 on the host {cg_s:.3f} s, "
        f"{err:.2e} of max|u| from the card's float64 DST solve (tol 1e-8)")
    check(err <= 1e-8, f"native CG {err:.2e} from DST")
    return {"build_s": build_s, "cg_s": cg_s, "rel_err": err}


def phase_window_attention(dev: torch.device, smi: str) -> dict:
    """Phase 25: SwinIR's window attention kernel pair (``csrc/window_attention.cu``)
    against its plain twin, forward and backward, plain and shifted, at the
    training shape (32 maps of 40^2) and at a served 160^2 level (one map),
    published widths (window 8, 6 heads of 30); then, shifted, the device time
    of the forward launch and of the backward call (the kernel and its bias
    sum), ms per forward and backward by CUDA events, the twin's, the bound,
    and as the ``library_ms`` yardstick only, the composition's SDPA on heads
    padded to 32 with its additive mask. The bound's bytes are those the pair
    must move for a window and head of ``n`` tokens of size ``d``: q, k, v
    read by each kernel, the output written, its gradient read, the
    gradients of q, k and v written (``11 n d``; the backward takes
    rowsum(P dP) and reads no output), the log-sum-exp written and read, and
    the bias table read twice; its operations, ``12 n^2 d``, those of
    ``portbench/families/swin_ir.py``'s ``attention_work``. Last, one train
    step of a published-width SwinIR at (32, 40^2) through ``train_step``, in
    float32 and in bfloat16, each with the counts set to 0 just before it:
    one forward and one backward call a block, 36 each, and the pair's device
    time a block inside that step (profiler); in the same steps one token
    reduction a linear (144) and a LayerNorm (74), and their device time a
    step beside the bytes they must read (``token_reduce_timing`` times them
    alone)."""
    import torch.nn.functional as F

    from superresolution_for_pdes_tpu_torch.data.generate import generate_mixed_dataset
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.models import SwinIR
    from superresolution_for_pdes_tpu_torch.ops import token_reduce as tr
    from superresolution_for_pdes_tpu_torch.ops import window_attention as wa
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

    window, heads, d, n = 8, 6, 30, 64
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"max_rel_err": 0.0}
    wa.reset_launch_counts()
    for b, hp in ((32, 40), (1, 160)):
        qkv = torch.randn(b, hp, hp, 3 * heads * d, device=dev, generator=gen)
        table = 0.5 * torch.randn((2 * window - 1) ** 2, heads, device=dev, generator=gen)
        g = torch.randn(b, hp, hp, heads * d, device=dev, generator=gen)
        leaves = [t.clone().requires_grad_(True) for t in (qkv, table)]

        def step(fn, shift=window // 2):
            for t in leaves:
                t.grad = None
            o = fn(leaves[0], leaves[1], heads, window, shift, d ** -0.5)
            o.backward(g)
            return o

        for shift in (0, window // 2):
            got = [step(wa.window_attention, shift).detach()] + [t.grad for t in leaves]
            want = [step(wa.plain_window_attention, shift).detach()] + [t.grad for t in leaves]
            for what, x, y in zip(("out", "dqkv", "dtable"), got, want):
                err = float((x - y).abs().max() / y.abs().max())
                out["max_rel_err"] = max(out["max_rel_err"], err)
                log(f"[window attention] ({b}, {hp}^2) shift {shift} {what}: kernels vs twin "
                    f"{err:.3e} of max")
                check(err <= 1e-4, f"window attention {what} at ({b}, {hp}^2): {err:.3e}")
        wh = b * (hp // window) ** 2 * heads
        nbytes = 4 * wh * (11 * n * d + 2 * n) + 4 * 2 * table.numel()
        flops = 3 * wh * 4 * n * n * d
        nw = (hp // window) ** 2
        pad = torch.zeros(b * nw, heads, n, 2, device=dev)
        q, k, v = (torch.cat([torch.randn(b * nw, heads, n, d, device=dev, generator=gen), pad],
                             -1).requires_grad_(True) for _ in range(3))
        mask = torch.randn(1, nw * heads, n, n, device=dev, generator=gen).requires_grad_(True)
        go = torch.randn(b, nw * heads, n, d + 2, device=dev, generator=gen)

        def sdpa():
            o = F.scaled_dot_product_attention(q.view(b, nw * heads, n, d + 2),
                                               k.view(b, nw * heads, n, d + 2),
                                               v.view(b, nw * heads, n, d + 2), attn_mask=mask,
                                               scale=d ** -0.5)
            o.backward(go)

        _, _, rows = profile(lambda: step(wa.window_attention), reps=20)
        fwd = sum(r[1] for r in rows if "window_attention_forward" in r[0])
        bwd = sum(r[1] for r in rows
                  if "window_attention_backward" in r[0] or "bias_grad_sum" in r[0])
        t = dict(shape=[b, hp, hp], device_ms=fwd + bwd, forward_device_ms=fwd,
                 backward_device_ms=bwd, ms=time_ms(lambda: step(wa.window_attention), 20),
                 plain_ms=time_ms(lambda: step(wa.plain_window_attention), 20),
                 bound=bound(nbytes, flops), library_ms=time_ms(sdpa, 20),
                 library_device_ms=device_ms_per_call(sdpa, reps=20))
        t["roofline_pct"] = 100.0 * t["bound"][0] / t["device_ms"]
        out[f"({b}, {hp}^2)"] = t
        log(f"[window attention] ({b}, {hp}^2) shifted, forward + backward: device "
            f"{t['device_ms']:.4f} ms (forward {fwd:.4f}, backward and bias sum {bwd:.4f}), "
            f"{t['ms']:.4f} ms per call, twin {t['plain_ms']:.4f} ms, bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), {t['roofline_pct']:.1f}% of it; SDPA on heads padded "
            f"to 32 (yardstick) {t['library_ms']:.4f} ms per call, {t['library_device_ms']:.4f} "
            f"ms on the device; on {smi}")
        runs = []
        for _ in range(2):
            step(wa.window_attention)
            runs.append([t.grad.clone() for t in leaves])
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"window attention gradients at ({b}, {hp}^2) differ between two runs")

    model = SwinIR(in_channels=5, generator=torch.Generator().manual_seed(17)).to(dev)
    blocks = sum(len(layer.residual_group.blocks) for layer in model.layers)
    opt = loop.make_optimizer(model, TrainConfig())
    stats = NormStats.from_dataset(generate_mixed_dataset(5, 16, 16, theta="mixed", device=dev))
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    out["launches_by_path"], out["token_reduce"] = {}, token_reduce_timing(dev, smi)
    out["token_reduce"]["launches_by_path"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        batch = step_batch(dev, stats, True, True, dtype=dtype)
        check(tuple(batch["x"].shape) == (32, 5, 40, 40), f"SwinIR batch {batch['x'].shape}")
        wa.reset_launch_counts()
        tr.reset_launch_counts()
        loss = float(loop.train_step(model, opt, batch, stats, 0.0, 1.0))
        torch.cuda.synchronize()
        counts = wa.launch_counts()
        path = f"SwinIR train step at (32, 40^2), published widths, {str(dtype)[6:]} (phase 25)"
        out["launches_by_path"][path] = counts
        log(f"[window attention] {path}: loss {loss:.6f}, launches {counts}")
        check(math.isfinite(loss), f"{path}: loss {loss}")
        check(counts == {"kernel_forward": blocks, "kernel_backward": blocks},
              f"{path}: one forward and one backward call a block ({blocks}), got {counts}")
        # the linears' bias sums take the linears' dtype (bf16 under autocast),
        # the LayerNorms' float32 (autocast runs LayerNorm in float32)
        reductions = {k: tr.launch_counts(torch.float32)[k] + tr.launch_counts(torch.bfloat16)[k]
                      for k in tr.launch_counts()}
        out["token_reduce"]["launches_by_path"][path] = reductions
        log(f"[token reductions] {path}: calls {reductions} ({len(linears)} linears, "
            f"{len(norms)} LayerNorms)")
        check(reductions == {"kernel_bias_grad": len(linears),
                             "kernel_layer_norm_affine_grad": len(norms)},
              f"{path}: one bias sum a linear ({len(linears)}) and one reduction a LayerNorm "
              f"({len(norms)}), got {reductions}")
        _, busy, rows = profile(lambda: loop.train_step(model, opt, batch, stats, 0.0, 1.0),
                                reps=5)
        pair = sum(r[1] for r in rows if "window_attention" in r[0] or "bias_grad_sum" in r[0])
        out[f"in_step_device_ms_per_block {str(dtype)[6:]}"] = pair / blocks
        log(f"[window attention] {path}: the pair's device time {pair:.3f} ms a step, "
            f"{pair / blocks:.4f} ms a block, of {busy:.3f} ms busy; on {smi}")
        tokens = 32 * 40 * 40
        nbytes = sum(tokens * m.out_features * dtype.itemsize for m in linears) + sum(
            tokens * (2 * m.weight.numel() * 4 + 8) for m in norms)
        reduced = sum(r[1] for r in rows if "token_reduce" in r[0])
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out["token_reduce"][f"in_step {str(dtype)[6:]}"] = dict(
            device_ms=reduced, bound_ms=bound_ms, bytes=nbytes,
            roofline_pct=100.0 * bound_ms / reduced)
        log(f"[token reductions] {path}: device time {reduced:.3f} ms a step against a bound of "
            f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB read), {100 * bound_ms / reduced:.1f}% "
            f"of it; on {smi}")
    out["launches"] = out["launches_by_path"][next(iter(out["launches_by_path"]))]
    out["token_reduce"]["launches"] = out["token_reduce"]["launches_by_path"][
        next(iter(out["token_reduce"]["launches_by_path"]))]
    return out


def token_reduce_timing(dev: torch.device, smi: str) -> dict:
    """SwinIR's token reductions (``csrc/token_reduce.cu``) alone at the
    training shape (32 maps of 40^2 = 51,200 tokens): the bias sum at the
    linears' widths (180, 360, 540) and a LayerNorm's weight and bias
    gradients at 180, float32: the kernel against the float64 sum, its device
    time (both launches), time per call, the plain twin's (for the bias sum
    this is ``torch.sum`` itself), its bound (bytes read at 3.35 TB/s), and
    as the ``library_ms`` yardstick ATen's own column sums (``g.sum(0)``;
    ``native_layer_norm_backward`` asked for the weight and bias alone, its
    GammaBeta kernel). Each timed call reads the next of a ring of inputs
    larger than twice the 50 MB L2, so every call reads from HBM, as in a
    train step."""
    from superresolution_for_pdes_tpu_torch.ops import token_reduce as tr

    tokens = 32 * 40 * 40
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"max_rel_err": 0.0}
    for what, c in (("bias", 180), ("bias", 360), ("bias", 540), ("layer_norm", 180)):
        nbytes = 4 * tokens * c if what == "bias" else 8 * tokens * c + 8 * tokens
        ring = []
        for _ in range(-(-100_000_000 // nbytes) + 1):
            g = torch.randn(tokens, c, device=dev, generator=gen)
            x = torch.randn(tokens, c, device=dev, generator=gen) + 0.5
            _, mean, rstd = torch.native_layer_norm(x, (c,), None, None, 1e-5)
            ring.append((g, x, mean.view(-1), rstd.view(-1)))
        w = torch.ones(c, device=dev)
        turn = [0]

        def args():
            turn[0] += 1
            return ring[turn[0] % len(ring)]

        if what == "bias":
            def kernel():
                return (tr.kernel_bias_grad(args()[0]),)

            def plain():
                return (tr.plain_bias_grad(args()[0]),)

            def aten():
                return (args()[0].sum(0),)
        else:
            def kernel():
                return tr.kernel_layer_norm_affine_grad(*args())

            def plain():
                return tr.plain_layer_norm_affine_grad(*args())

            def aten():
                g, x, mean, rstd = args()
                return torch.ops.aten.native_layer_norm_backward(
                    g, x, (c,), mean.view(-1, 1), rstd.view(-1, 1), w, torch.zeros_like(w),
                    [False, True, True])[1:]

        g, x, mean, rstd = ring[(turn[0] + 1) % len(ring)]
        g64 = g.double()
        xhat = (x.double() - mean.double()[:, None]) * rstd.double()[:, None]
        exact = (g64.sum(0),) if what == "bias" else ((g64 * xhat).sum(0), g64.sum(0))
        for got, want in zip(kernel(), exact):
            err = float((got.double() - want).abs().max() / want.abs().max())
            out["max_rel_err"] = max(out["max_rel_err"], err)
            check(err <= 1e-4, f"token reduction {what} at C = {c}: {err:.3e} of max")
        t = dict(shape=[tokens, c], device_ms=device_ms_per_call(kernel, "token_reduce"),
                 ms=time_ms(kernel), plain_ms=time_ms(plain), bound=bound(nbytes, 0.0),
                 library_ms=time_ms(aten), library_device_ms=device_ms_per_call(aten))
        t["roofline_pct"] = 100.0 * t["bound"][0] / t["device_ms"]
        out[f"{what} {c}"] = t
        log(f"[token reductions] {what} ({tokens}, {c}), {len(ring)} inputs in turn: device "
            f"{t['device_ms']:.4f} ms, {t['ms']:.4f} ms per call, twin {t['plain_ms']:.4f} ms, "
            f"bound {t['bound'][0]:.4f} ms ({nbytes / 1e6:.1f} MB), {t['roofline_pct']:.1f}% "
            f"of it; ATen {t['library_ms']:.4f} ms per call, {t['library_device_ms']:.4f} ms on "
            f"the device; on {smi}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    import numpy as np
    import torch.nn.functional as F

    from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution
    from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.deploy import load_bundle, run_bundle, save_bundle
    from superresolution_for_pdes_tpu_torch.eval.metrics import relative_l2
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet
    from superresolution_for_pdes_tpu_torch.ops import _build
    from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
    from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
    from superresolution_for_pdes_tpu_torch.physics.loss import pde_residual_loss
    from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst
    from superresolution_for_pdes_tpu_torch.solver.multigrid import solve_poisson_mg

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    t_phase = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        log(f"[seconds] {phase}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # ------------------------------------------------------------ 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {card} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ------------------------------------------------------------- 2. build
    build = _build.build_all()
    log(f"[build] {build.seconds:.2f} s")
    for stem, out in build.log.items():
        log(f"[build] nvcc {stem}.cu:\n{out.strip()}")
    lap("1-2 device and build")

    # ----------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = 4e-6
    keys = ("K1", "K1 loss forward", "K1 loss backward", "K2", "K3", "K3+K2")
    worst = {key: [0.0, 0.0] for key in keys}  # [max_abs_err, max_rel_err]

    def compare(key, what, out, ref):
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        worst[key][0] = max(worst[key][0], err)
        worst[key][1] = max(worst[key][1], err / scale)
        check(err <= tol * scale,
              f"{key} {what}: max|kernel - twin| {err:.3e} > {tol} * {scale:.3e}")

    sk.reset_launch_counts()
    for shape in [(1, 160, 160), (1, 320, 320), (1, 640, 640), (4, 640, 640), (8, 161, 161),
                  (3, 41, 41), (1, 1023, 1023)]:
        u = torch.randn(shape, device=dev, generator=gen)
        f = torch.randn(shape, device=dev, generator=gen)
        theta = torch.rand(shape, device=dev, generator=gen) * 1.5 + 0.5
        for th, label in ((-1.0, "scalar"), (theta, "field")):
            compare("K2", f"{shape} theta {label}", sk.kernel_residual(th, u, f),
                    sk.plain_residual(th, u, f))
        for iters in (1, 2, 3, 4, 6):
            compare("K3", f"{shape} iters {iters}", sk.kernel_jacobi_smooth(u, f, iters=iters),
                    sk.plain_jacobi_smooth(u, f, iters=iters))
        for iters in (0, 1, 2, 3, 5):
            got, ref = (fn(u, f, iters=iters)
                        for fn in (sk.kernel_smooth_residual, sk.plain_smooth_residual))
            for part, out, ref_part in zip(("u", "r"), got, ref):
                compare("K3+K2", f"{shape} iters {iters} {part}", out, ref_part)
    torch.cuda.synchronize()
    k2_check_launches = sk.launch_counts()["kernel_residual"]
    log(f"[kernels] K2/K3 and the fused pre-smooth and residual match their twins at every "
        f"shape, K3 at 1-6 sweeps, the fused kernel at 0-5 (max rel err K2 "
        f"{worst['K2'][1]:.2e}, K3 {worst['K3'][1]:.2e}, fused {worst['K3+K2'][1]:.2e}; "
        f"bit-identical: K2 {worst['K2'][0] == 0}, K3 {worst['K3'][0] == 0}, fused "
        f"{worst['K3+K2'][0] == 0}; tol {tol}); {k2_check_launches} K2 launches")

    # K3, K2 and the fused kernel back to back on inputs that fit in the 50 MB
    # L2; the bounds count each HBM byte once
    k3_timing, k2_timing, fused_timing = {}, {}, {}
    for shape in [(1, 160, 160), (1, 320, 320), (1, 640, 640), (4, 640, 640)]:
        n = shape[-1]
        u = torch.randn(shape, device=dev, generator=gen)
        b = torch.randn(shape, device=dev, generator=gen)
        w5 = laplacian_weights(n, dev)
        points = math.prod(shape)

        def k3(u=u, b=b):
            return sk.kernel_jacobi_smooth(u, b, iters=2)

        def k2(u=u, b=b):
            return sk.kernel_residual(-1.0, u, b)

        def fused(u=u, b=b):
            return sk.kernel_smooth_residual(u, b, iters=2)

        def pair(u=u, b=b):
            return sk.kernel_residual(-1.0, sk.kernel_jacobi_smooth(u, b, iters=2), b)

        def conv(u=u, w5=w5):
            return F.conv2d(u[:, None], w5, padding=1)

        yardstick = dict(library_ms=time_ms(conv), library_device_ms=device_ms_per_call(conv),
                         shape=list(shape))
        k3_timing[shape] = dict(
            ms=time_ms(k3), plain_ms=time_ms(lambda: sk.plain_jacobi_smooth(u, b, iters=2)),
            device_ms=device_ms_per_call(k3, K3_NAME),
            bound=bound(3 * 4 * points, 2 * 10 * points), **yardstick)
        k2_timing[shape] = dict(
            ms=time_ms(k2), plain_ms=time_ms(lambda: sk.plain_residual(-1.0, u, b)),
            device_ms=device_ms_per_call(k2, K2_NAME),
            bound=bound(3 * 4 * points, 8 * points), **yardstick)
        fused_timing[shape] = dict(
            ms=time_ms(fused), plain_ms=time_ms(lambda: sk.plain_smooth_residual(u, b, iters=2)),
            device_ms=device_ms_per_call(fused, K2_NAME),
            pair_ms=time_ms(pair), pair_device_ms=device_ms_per_call(pair),
            bound=bound(4 * 4 * points, (2 * 10 + 8) * points), **yardstick)
        for label, t in (("K3 2 sweeps", k3_timing[shape]), ("K2 theta -1", k2_timing[shape]),
                         ("fused 2 sweeps + residual", fused_timing[shape])):
            log(f"[kernels] {label} at {shape}: device {t['device_ms'] * 1e3:.3f} us per launch "
                f"(profiler), {t['ms']:.4f} ms per call (CUDA events), twin "
                f"{t['plain_ms']:.4f} ms, bound {t['bound'][0] * 1e3:.3f} us ({t['bound'][1]}) "
                f"= {100 * t['bound'][0] / max(t['device_ms'], 1e-9):.0f}% of the device time; "
                f"on {smi}")
        t = fused_timing[shape]
        log(f"[kernels] the pair the fused kernel replaces (K3 2 sweeps, then K2) at {shape}: "
            f"device {t['pair_device_ms'] * 1e3:.3f} us per pair, {t['pair_ms']:.4f} ms per "
            f"pair; F.conv2d L.u device {t['library_device_ms'] * 1e3:.3f} us, "
            f"{t['library_ms']:.4f} ms per call; on {smi}")
    n = 640
    u, b = (torch.randn(1, n, n, device=dev, generator=gen) for _ in range(2))
    sweeps = {}
    for iters in (2, 4, 6):
        def k3(iters=iters):
            return sk.kernel_jacobi_smooth(u, b, iters=iters)

        sk.reset_launch_counts()
        k3()
        per_call = sk.launch_counts()["kernel_jacobi_smooth"]
        sweeps[iters] = dict(device_ms=device_ms_per_call(k3, K3_NAME), ms=time_ms(k3),
                             launches=per_call)
        log(f"[kernels] K3 {iters} sweeps at (1, 640, 640): {per_call} launch(es), device "
            f"{sweeps[iters]['device_ms'] * 1e3:.3f} us per call, "
            f"{sweeps[iters]['ms']:.4f} ms per call, on {smi}")
    lap("3 kernels")

    # ------------------------------------------------------------- 4. serve
    levels, tiles = (80, 160, 320, 640), [40, 80, 80]
    experts = []
    for level in range(4):
        g = torch.Generator().manual_seed(100 + level)
        model = AttentionUNet(in_channels=5, generator=g)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
        experts.append(model.state_dict())
    gains = [np.random.default_rng(7 + i).uniform(0.8, 1.2, (48, 48)).astype(np.float32)
             for i in range(4)]
    scene_full = solve_multi_resolution(3, resolutions=levels, k_range=(10.0, 11.0), device=dev)
    scene = {"u": {40: scene_full["u"][40]}, "f": scene_full["f"], "theta": scene_full["theta"]}
    truth = scene_full["u"]

    with tempfile.TemporaryDirectory() as tmp:
        save_bundle(tmp, {"name": "attention_unet", "in_channels": 5}, experts,
                    amp_levels=gains, overlap=False, stats_mode="tile", coarse_tile=tiles)
        run_bundle(tmp, scene, 640, device=dev)  # warm-up (cuDNN plans, caches)
        sk.reset_launch_counts()
        served = run_bundle(tmp, scene, 640, device=dev)
        torch.cuda.synchronize()
        serve_counts = sk.launch_counts()
        reach_ms = {r: wall_ms(lambda r=r: run_bundle(tmp, scene, r, device=dev)) for r in levels}
        err_served = {}
        for r in levels:
            field = served[r]
            check(field.shape == (r, r), f"served {r}: shape {tuple(field.shape)}")
            finite = bool(torch.isfinite(field).all())
            check(finite, f"served {r}: non-finite values")
            err_served[r] = float(relative_l2(field, truth[r]))
            log(f"[serve] {r}x{r}: shape {tuple(field.shape)} finite {finite} rel-L2 "
                f"{err_served[r]:.4f} wall {reach_ms[r]:.1f} ms to reach it (run_bundle, "
                f"weights load included) on {smi}")
        log(f"[serve] kernel launches on the bundle path: {serve_counts} (it runs no stencil)")

        # --------------------------------------------------------- 5. refine
        model, variables, amp, manifest = load_bundle(tmp, device=dev)
        kw = dict(stats_mode=manifest["stats_mode"], overlap=manifest["overlap"],
                  coarse_tile=manifest["coarse_tile"], amp_levels=amp, refine_cycles=2)
        ml_cascade(model, variables, scene, 640, **kw)  # warm-up
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        refined = ml_cascade(model, variables, scene, 640, **kw)
        torch.cuda.synchronize()
        refine_ms = (time.perf_counter() - t0) * 1e3
        counts = sk.launch_counts()
        plain = ml_cascade(model, variables, scene, 640, use_kernels=False, **kw)
        torch.cuda.synchronize()
    check(sk.launch_counts() == counts, "use_kernels=False launched a kernel")
    kernel_levels = [r for r in levels if r >= 160]
    # per level and refine cycle: one fused pre-smooth and residual, one K3 post-smooth
    expected = {"kernel_apply_operator": 0, "kernel_pde_loss_forward": 0,
                "kernel_pde_loss_backward": 0, "kernel_residual": 0,
                "kernel_jacobi_smooth": 2 * len(kernel_levels),
                "kernel_smooth_residual": 2 * len(kernel_levels)}
    log(f"[refine] launches {counts}, expected {expected}; wall {refine_ms:.1f} ms on {smi}")
    check(counts == expected, f"launch counts {counts} != {expected}")
    for r in levels:
        diff = float((refined[r] - plain[r]).abs().max())
        scale = float(plain[r].abs().max())
        err = float(relative_l2(refined[r], truth[r]))
        log(f"[refine] {r}x{r}: max|kernels - twin path| {diff:.3e} (max|field| {scale:.3e}), "
            f"rel-L2 {err:.4f} vs served {err_served[r]:.4f}")
        check(bool(torch.isfinite(refined[r]).all()), f"refined {r}: non-finite")
        check(diff <= 1e-5 * scale, f"refined {r}: kernel path differs by {diff:.3e}")
        if r in kernel_levels:
            check(err < err_served[r], f"refine did not lower rel-L2 at {r}")
    lap("4-5 serve and refine")

    # ------------------------------------------------------ 6. multigrid
    k = torch.tensor([[3.3, 7.1], [10.5, 10.2], [6.0, 1.5], [11.9, 8.4]], device=dev)
    f4 = forcing_term(k[:, 0], k[:, 1], n, device=dev)
    th4 = torch.rand(4, n, n, device=dev, generator=gen) * 1.5 + 0.5
    mg_ms = wall_ms(lambda: solve_poisson_mg(f4, th4, n_cycles=12, use_kernels=True))
    sk.reset_launch_counts()
    u_mg = solve_poisson_mg(f4, th4, n_cycles=12, use_kernels=True)
    torch.cuda.synchronize()
    mg_counts = sk.launch_counts()
    u_dst = solve_poisson_dst(f4, th4, refine_iters=1)
    mg_err = float((u_mg - u_dst).abs().max())
    mg_scale = float(u_dst.abs().max())
    log(f"[multigrid] 640^2 batch 4, 12 cycles: max|mg - dst| {mg_err:.3e} "
        f"(max|u| {mg_scale:.3e}); wall {mg_ms:.1f} ms on {smi}; launches {mg_counts}")
    check(mg_err <= 1e-4 * mg_scale, "multigrid does not reach the DST solution")
    check(mg_counts["kernel_smooth_residual"] == 12 and mg_counts["kernel_jacobi_smooth"] == 12
          and mg_counts["kernel_residual"] == 0, f"multigrid launches {mg_counts}")
    lap("6 multigrid")

    # ------------------------------------------------------- 7. profile
    for label, extra in (("serve", {"refine_cycles": 0}), ("refine", {})):
        def cascade():
            return ml_cascade(model, variables, scene, 640, **{**kw, **extra})

        plain_wall = wall_ms(cascade)
        wall, busy, rows = profile(cascade)
        log(f"[profile] {label} cascade to 640: wall {plain_wall:.1f} ms ({wall:.1f} ms under "
            f"the profiler), device busy {busy:.1f} ms = {100 * busy / wall:.0f}% of the "
            f"profiled wall, on {smi}")
        for cls, ms in by_class(rows).items():
            log(f"[profile]   {ms:8.3f} ms  {cls}")
        for name, ms, calls in rows[:6]:
            log(f"[profile]   {ms:8.3f} ms  {calls:6.0f} launches  {name[:80]}")
    lap("7 profile")

    # ---------------------------------------------------------------- 8. K1
    for shape in [(32, 40, 40), (1024, 40, 40), (32, 80, 80), (1, 640, 640), (3, 41, 41)]:
        u = torch.randn(shape, device=dev, generator=gen)
        theta = torch.rand(shape, device=dev, generator=gen) * 1.5 + 0.5
        for th, label in ((1.0, "scalar"), (theta, "field")):
            compare("K1", f"{shape} theta {label}", sk.kernel_apply_operator(th, u),
                    sk.plain_apply_operator(th, u))
    for shape in [(32, 40, 40), (3, 41, 41)]:
        u, g = (torch.randn(shape, device=dev, generator=gen) for _ in range(2))
        theta = torch.rand(shape, device=dev, generator=gen) * 1.5 + 0.5
        x = u.clone().requires_grad_(True)
        sk.plain_apply_operator(theta, x).backward(g)
        # the gradient of theta * L u is L(theta * g): the truncated L is symmetric
        compare("K1", f"{shape} adjoint", sk.kernel_apply_operator(1.0, theta * g), x.grad)
    log(f"[K1] matches its twin forward (theta scalar and field) and as its adjoint at every "
        f"shape (max rel err {worst['K1'][1]:.2e}, max abs err {worst['K1'][0]:.2e}; tol {tol})")
    # the operator and its adjoint, driven once outside the comparisons (no
    # main path of this slice runs the operator: its row's launches are phase 10's)
    u = torch.randn(32, 40, 40, device=dev, generator=gen)
    theta = torch.rand(32, 40, 40, device=dev, generator=gen) * 1.5 + 0.5
    sk.reset_launch_counts()
    sk.kernel_apply_operator(1.0, theta * sk.kernel_apply_operator(theta, u))
    torch.cuda.synchronize()
    k1_op_launches = sk.launch_counts()["kernel_apply_operator"]
    check(k1_op_launches == 2, f"operator and adjoint: {k1_op_launches} launches")
    k1_timing = {}
    for shape in [(32, 40, 40), (1, 640, 640)]:
        u = torch.randn(shape, device=dev, generator=gen)
        theta = torch.rand(shape, device=dev, generator=gen) * 1.5 + 0.5
        w5 = laplacian_weights(shape[-1], dev)
        points = math.prod(shape)

        def k1(theta=theta, u=u):
            return sk.kernel_apply_operator(theta, u)

        t = dict(ms=time_ms(k1), plain_ms=time_ms(lambda: sk.plain_apply_operator(theta, u)),
                 library_ms=time_ms(lambda: theta * F.conv2d(u[:, None], w5, padding=1)[:, 0]),
                 bound=bound(3 * 4 * points, 7 * points), device_ms=device_ms_per_call(k1, K1_NAME),
                 shape=list(shape))
        k1_timing[shape] = t
        log(f"[K1] operator {shape} theta field: device {t['device_ms'] * 1e3:.3f} us per launch "
            f"(profiler); {t['ms']:.4f} ms per call, twin {t['plain_ms']:.4f} ms, theta * "
            f"F.conv2d (two calls) {t['library_ms']:.4f} ms, bound {t['bound'][0] * 1e3:.3f} us "
            f"({t['bound'][1]}) on {smi}")

    # the fused physics loss: forward (loss + seed) and backward against their twins
    def loss_data(shape, per_sample):
        pred = torch.randn(shape[0], 1, *shape[1:], device=dev, generator=gen)
        theta = torch.rand(shape, device=dev, generator=gen) * 1.5 + 0.5
        f = torch.randn(shape, device=dev, generator=gen)
        size = (shape[0], 1, 1) if per_sample else ()
        u_mean = torch.randn(size, device=dev, generator=gen)
        u_std, f_std = (torch.rand(size, device=dev, generator=gen) + 0.5 for _ in range(2))
        return pred, theta, f, (u_mean, u_std, f_std)

    loss_rel = 0.0
    for shape in [(32, 40, 40), (1024, 40, 40), (32, 80, 80), (32, 160, 160), (3, 41, 41)]:
        for per_sample in (False, True):
            pred, theta, f, stats = loss_data(shape, per_sample)
            g = torch.tensor(0.7, device=dev)
            ref_loss, ref_seed = sk.plain_pde_residual_loss(pred, theta, f, *stats)
            ref_grad = sk.plain_pde_residual_loss_backward(ref_seed, stats[1], g)
            loss, seed = sk.kernel_pde_loss_forward(pred, theta, f, *stats)
            grad = sk.kernel_pde_loss_backward(seed, stats[1], g)
            what = f"{shape} {'per-sample' if per_sample else '0-d'} stats"
            rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
            loss_rel = max(loss_rel, rel)
            check(rel <= 1e-6, f"K1 loss {what}: {float(loss)} vs twin {float(ref_loss)}")
            compare("K1 loss forward", f"{what} seed", seed, ref_seed)
            compare("K1 loss backward", what, grad, ref_grad)
    for shape in [(1024, 40, 40), (32, 160, 160)]:
        pred, theta, f, stats = loss_data(shape, True)
        g = torch.tensor(1.0, device=dev)
        runs = []
        for _ in range(2):
            loss, seed = sk.kernel_pde_loss_forward(pred, theta, f, *stats)
            runs.append((loss.clone(), seed, sk.kernel_pde_loss_backward(seed, stats[1], g)))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"fused loss at {shape}: two calls differ")
    log(f"[K1] fused loss matches its twins at every shape, 0-d and per-sample stats: loss "
        f"within {loss_rel:.2e} relative (tol 1e-6), seed {worst['K1 loss forward'][1]:.2e} and "
        f"gradient {worst['K1 loss backward'][1]:.2e} of their max (tol {tol}); loss, seed and "
        f"gradient bit-identical over two calls")

    loss_timing = {}
    for shape in [(32, 40, 40), (32, 160, 160)]:
        pred, theta, f, (u_mean, u_std, f_std) = loss_data(shape, True)
        stats = NormStats(u_mean=u_mean, u_std=u_std, f_mean=u_mean, f_std=f_std,
                          theta_mean=torch.zeros_like(u_mean), theta_std=torch.ones_like(u_std),
                          theta_is_constant=torch.ones_like(u_std, dtype=torch.bool))
        g = torch.tensor(1.0, device=dev)
        _, seed = sk.kernel_pde_loss_forward(pred, theta, f, u_mean, u_std, f_std)
        points = math.prod(shape)
        w5 = laplacian_weights(shape[-1], dev)

        def fwd(pred=pred, theta=theta, f=f, st=(u_mean, u_std, f_std)):
            return sk.kernel_pde_loss_forward(pred, theta, f, *st)

        def bwd(seed=seed, u_std=u_std, g=g):
            return sk.kernel_pde_loss_backward(seed, u_std, g)

        def fused_step(pred=pred, theta=theta, f=f, stats=stats):
            pde_residual_loss(pred.detach().requires_grad_(True), theta, f, stats).backward()

        def unfused_step(pred=pred, theta=theta, f=f, st=(u_mean, u_std, f_std)):
            # the loss and its gradient unfused: elementwise launches around
            # the operator kernel, the gradient by the operator's adjoint
            r = (sk.kernel_apply_operator(theta, pred[:, 0] * st[1] + st[0]) - f) / st[2]
            loss = torch.mean(r ** 2)
            seed = (2.0 / r.numel()) * (r / st[2])
            return loss, st[1] * sk.kernel_apply_operator(1.0, theta * seed)

        t = {"shape": list(shape)}
        for label, fn in (("fused_step", fused_step), ("unfused_step", unfused_step)):
            _, busy, rows = profile(fn, reps=50)
            t[label] = dict(device_ms=busy, launches=sum(r[2] for r in rows), ms=time_ms(fn))
        t["forward"] = dict(
            ms=time_ms(fwd), device_ms=device_ms_per_call(fwd, K1_FWD_NAME),
            plain_ms=time_ms(lambda: sk.plain_pde_residual_loss(pred, theta, f, u_mean, u_std,
                                                                f_std)),
            bound=bound(4 * 4 * points, 16 * points), library_ms=None,
            yardstick_ms=time_ms(lambda: F.conv2d(pred, w5, padding=1)))
        t["backward"] = dict(
            ms=time_ms(bwd), device_ms=device_ms_per_call(bwd, K1_BWD_NAME),
            plain_ms=time_ms(lambda: sk.plain_pde_residual_loss_backward(seed, u_std, g)),
            bound=bound(2 * 4 * points, 9 * points), library_ms=None,
            yardstick_ms=t["forward"]["yardstick_ms"])
        step_bound = t["forward"]["bound"][0] + t["backward"]["bound"][0]
        loss_timing[shape] = t
        fw, bw, fs_, p2 = t["forward"], t["backward"], t["fused_step"], t["unfused_step"]
        log(f"[K1] loss {shape}: forward device {fw['device_ms'] * 1e3:.3f} us per launch, "
            f"{fw['ms']:.4f} ms per call, twin {fw['plain_ms']:.4f} ms, bound "
            f"{fw['bound'][0] * 1e3:.3f} us; backward device {bw['device_ms'] * 1e3:.3f} us, "
            f"{bw['ms']:.4f} ms per call, twin {bw['plain_ms']:.4f} ms, bound "
            f"{bw['bound'][0] * 1e3:.3f} us; F.conv2d L.pred yardstick {fw['yardstick_ms']:.4f} "
            f"ms; on {smi}")
        log(f"[K1] loss {shape} per train step (forward + backward through pde_residual_loss): "
            f"device {fs_['device_ms'] * 1e3:.3f} us in {fs_['launches']:.0f} launches, "
            f"{fs_['ms']:.4f} ms per step; bound {step_bound * 1e3:.3f} us; unfused: "
            f"device {p2['device_ms'] * 1e3:.3f} us in {p2['launches']:.0f} launches, "
            f"{p2['ms']:.4f} ms per step; on {smi}")
    lap("8 K1")

    # ---------------------------------------------------------- 9. generate
    generated = phase_generate(dev, smi)
    lap("9 generate")

    # ------------------------------------------------------------- 10. train
    trained = phase_train(dev, card, smi)
    lap("10 train")

    # ----------------------------------------------------------- 11. solvers
    solved = phase_solvers(dev, card, smi)
    lap("11 solvers")

    # ------------------- 12-15. freeze, evaluate, rebuild, single-level and diagnose
    with tempfile.TemporaryDirectory() as tmp:
        frozen = phase_freeze(dev, smi, Path(tmp))
        lap("12 freeze")
        evaluated = phase_evaluate(dev, smi, Path(tmp), frozen["bundle"])
        lap("13 evaluate")
        rebuilt = phase_rebuild(dev, smi, Path(tmp), frozen["runs"])
        lap("14 rebuild")
        single = phase_single_level(smi, Path(tmp), frozen["runs"]["r7"],
                                    evaluated["statistical_dir"])
        lap("15 single-level and diagnose")
        resnet = phase_resnet(dev, smi, Path(tmp))
        lap("16 resnet")
        routed = phase_router(dev, smi, Path(tmp), frozen["runs"]["r7"], resnet["run_dir"])
        lap("17 router harnesses")
        bf16 = phase_bf16(dev, smi, Path(tmp))
        lap("18 r7bf16")
        fused_run = phase_fused(dev, smi, Path(tmp))
        lap("19 fused epochs")
        dp_run = phase_dp(dev, smi, Path(tmp), trained["history"])
        lap("20 data parallel")
        online_run = phase_online(dev, smi)
        lap("21 online step")
        shard_run = phase_shard(smi, Path(tmp), frozen["bundle"])
        lap("22 shard tiles")
        trace_run = phase_trace(dev, smi, Path(tmp), frozen["bundle"])
        lap("23 device trace")
    native_run = phase_native(dev, smi)
    lap("24 native oracle")
    attention = phase_window_attention(dev, smi)
    lap("25 window attention")

    t40 = loss_timing[(32, 40, 40)]
    timing = {"K1": dict(solved["k1_timing"],
                         launches=solved["launches"]["kernel_apply_operator"],
                         check_launches=k1_op_launches,
                         path="solve_poisson cg and mgcg (phase 11): the matvec -L p with "
                              "theta = -1; check_launches: operator and adjoint (phase 8)"),
              "K1 loss forward": dict(t40["forward"], shape=t40["shape"],
                                      launches=trained["launches"]["kernel_pde_loss_forward"],
                                      path="train CLI, 2 epochs (phase 10)"),
              "K1 loss backward": dict(t40["backward"], shape=t40["shape"],
                                       launches=trained["launches"]["kernel_pde_loss_backward"],
                                       path="train CLI, 2 epochs (phase 10)"),
              "K2": dict(k2_timing[(1, 640, 640)], launches=counts["kernel_residual"],
                         check_launches=k2_check_launches,
                         path="refined scene to 640^2 (phase 5), whose V-cycle runs the fused "
                              "kernel in its place; check_launches: phase 3's comparisons"),
              "K3": dict(k3_timing[(1, 640, 640)], launches=counts["kernel_jacobi_smooth"],
                         path="refined scene to 640^2 (phase 5): the post-smooths"),
              "K3+K2": dict(fused_timing[(1, 640, 640)], launches=counts["kernel_smooth_residual"],
                            path="refined scene to 640^2 (phase 5): the pre-smooths and "
                                 "residuals; pair_*: K3 then K2 as two calls")}
    names = {"K1": "kernel_apply_operator", "K1 loss forward": "kernel_pde_loss_forward",
             "K1 loss backward": "kernel_pde_loss_backward", "K2": "kernel_residual",
             "K3": "kernel_jacobi_smooth", "K3+K2": "kernel_smooth_residual"}
    lines = {"K1": "100", "K1 loss forward": "100", "K1 loss backward": "100", "K2": "115",
             "K3": "131", "K3+K2": "131 and :115"}
    by_path = {  # each path driven with the counts set to 0 just before and read just after
        "refined scene to 640^2 (phase 5)": counts,
        "multigrid solve, 640^2 (phase 6)": mg_counts,
        "train CLI, 2 epochs (phase 10)": trained["launches"],
        "solve_poisson, 4 methods (phase 11)": solved["launches"],
        "upscale --save_bundle (phase 12)": frozen["launches"],
        "statistical --bundle (phase 13)": evaluated["statistical_launches"],
        "resolution_comparison --refine_cycles 2 (phase 13)": evaluated["sweep_launches"],
        "train SFL2F, 2 epochs at (32, 160^2) (phase 14)": rebuilt["launches"]["SFL2F"],
        "train SFL34G, 2 epochs at (32, 160^2) (phase 14)": rebuilt["launches"]["SFL34G"],
        "train --model resnet, 2 epochs (phase 16)": resnet["launches"],
        **{f"{cmd} (phase 17)": c for cmd, c in routed["launches"].items()},
    }
    rows = []
    for key in keys:
        t = timing[key]
        rows.append({
            "name": f"{key} {names[key]}", "route": "cuda",
            "source": "superresolution_for_pdes_tpu_torch/csrc/stencil.cu",
            "replaces": f"superresolution_for_pdes_tpu/ops/pallas_stencil.py:{lines[key]}",
            "launches": t["launches"], "path": t["path"],
            "max_abs_err": worst[key][0], "max_rel_err": worst[key][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "shape": t["shape"],
        })
        for extra in ("check_launches", "pair_ms", "pair_device_ms"):
            if extra in t:
                rows[-1][extra] = t[extra]
        rows[-1]["launches_by_path"] = {path: c[names[key]] for path, c in by_path.items()}
    rows[1]["loss_max_rel_err"] = loss_rel
    for key, fn in (("forward", "kernel_pde_loss_forward"),
                    ("backward", "kernel_pde_loss_backward")):
        t = bf16["timing"][key]
        rows.append({
            "name": f"K1 loss {key} bf16 {fn}", "route": "cuda",
            "source": "superresolution_for_pdes_tpu_torch/csrc/stencil.cu",
            "replaces": "superresolution_for_pdes_tpu/ops/pallas_stencil.py:100",
            "launches": bf16["launches"][fn],
            "path": "train r7bf16, 2 epochs at (256, 40^2) (phase 18)",
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "shape": t["shape"],
            "launches_by_path": {"train r7bf16 (phase 18)": bf16["launches"][fn]}})
    rows[-2]["loss_max_rel_err"] = bf16["timing"]["forward"]["loss_rel"]
    t = attention["(32, 40^2)"]
    rows.append({
        "name": "window attention kernel_forward + kernel_backward", "route": "cuda",
        "source": "superresolution_for_pdes_tpu_torch/csrc/window_attention.cu",
        "replaces": "no TPU kernel (no JAX SwinIR): the port's roll, partition, padded-head SDPA",
        "launches": attention["launches"],
        "path": "a published-width SwinIR's train step at (32, 40^2) (phase 25): one forward "
                "and one backward call a block; bfloat16 is widened to the same kernels",
        "launches_by_path": attention["launches_by_path"],
        "in_step_device_ms_per_block": attention["in_step_device_ms_per_block float32"],
        "max_rel_err": attention["max_rel_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"], "shape": t["shape"],
        "served_160": attention["(1, 160^2)"]})
    t = attention["token_reduce"]["bias 540"]
    rows.append({
        "name": "token reductions kernel_bias_grad + kernel_layer_norm_affine_grad",
        "route": "cuda", "source": "superresolution_for_pdes_tpu_torch/csrc/token_reduce.cu",
        "replaces": "no TPU kernel (no JAX SwinIR): ATen's sum of a linear's output gradient "
                    "and LayerNorm's GammaBetaBackward",
        "launches": attention["token_reduce"]["launches"],
        "path": "a published-width SwinIR's train step at (32, 40^2) (phase 25): one bias sum "
                "a linear and one reduction a LayerNorm",
        "launches_by_path": attention["token_reduce"]["launches_by_path"],
        "in_step": attention["token_reduce"]["in_step float32"],
        "max_rel_err": attention["token_reduce"]["max_rel_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": t["library_ms"], "device_ms": t["device_ms"], "shape": t["shape"],
        "by_shape": {k: v for k, v in attention["token_reduce"].items()
                     if k.startswith(("bias", "layer_norm"))}})
    log(f"[summary] K3 timing {k3_timing}; K2 timing {k2_timing}; fused timing "
        f"{fused_timing}; K3 sweeps {sweeps}; loss timing {loss_timing}")
    log(f"[summary] generate {generated}; train {trained['summary']}")
    log(f"[summary] solvers {solved['cases']}; freeze {frozen['summary']}; evaluate "
        f"{evaluated['summary']}")
    log(f"[summary] rebuild {rebuilt['stages']}; single-level {single}")
    log(f"[summary] resnet {resnet['summary']}; router harnesses {routed['summary']}")
    log(f"[summary] r7bf16 {bf16['summary']}; fused {fused_run}; dp {dp_run}")
    log(f"[summary] online {online_run}; shard {shard_run}; trace {trace_run}; native "
        f"{native_run}; window attention {attention}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
