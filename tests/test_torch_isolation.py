"""PyTorch port: imports no JAX and nothing of the JAX package, and its entry
points never fall back to the CPU on their own."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import superresolution_for_pdes_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "superresolution_for_pdes_tpu"))
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    count, bad = int(out[0]), out[1] if len(out) > 1 else ""
    assert count >= 49, count  # every module of the port was imported
    assert bad == "", f"the port pulled in {bad}"


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from superresolution_for_pdes_tpu_torch import resolve_device
    from superresolution_for_pdes_tpu_torch.cascade.multires import (
        solve_multi_resolution,
        solve_multi_resolution_batch,
    )
    from superresolution_for_pdes_tpu_torch.cascade.modal import calibrate_modal
    from superresolution_for_pdes_tpu_torch.cascade.upscale import calibrate_amplitude
    from superresolution_for_pdes_tpu_torch.cli import (
        compare_methods,
        compare_test_cases,
        generate_data,
        out_of_sample,
        resolution_comparison,
        resolve_expert,
        resolve_model,
        statistical,
        train,
    )
    from superresolution_for_pdes_tpu_torch.cli.upscale import main
    from superresolution_for_pdes_tpu_torch.eval.out_of_sample import evaluate_out_of_sample
    from superresolution_for_pdes_tpu_torch.eval.resolution import run_resolution_sweep
    from superresolution_for_pdes_tpu_torch.eval.statistical import (
        run_single_example,
        run_statistical_benchmark,
    )
    from superresolution_for_pdes_tpu_torch.eval.test_cases import run_generalization_grid
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet
    from superresolution_for_pdes_tpu_torch.data.generate import (
        generate_mixed_dataset,
        selffeed_cascade_dataset,
    )
    from superresolution_for_pdes_tpu_torch.data.io import load_dataset
    from superresolution_for_pdes_tpu_torch.deploy import load_bundle, run_bundle
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, train_model

    model = AttentionUNet(in_channels=5)
    calls = (
        resolve_device,
        lambda: solve_multi_resolution(0, resolutions=(80,)),
        lambda: solve_multi_resolution_batch(0, 2, resolutions=(80,)),
        lambda: load_bundle(tmp_path),
        lambda: run_bundle(tmp_path, {}, 80),
        lambda: main(["--bundle", str(tmp_path), "--target", "80", "--out", str(tmp_path)]),
        lambda: generate_mixed_dataset(0, 2, 2),
        lambda: load_dataset(tmp_path),
        lambda: train_model({}, TrainConfig(), tmp_path),
        lambda: generate_data.main(["--n_standard", "2", "--out", str(tmp_path)]),
        lambda: train.main(["--generate", "--epochs", "1", "--results", str(tmp_path)]),
        lambda: calibrate_modal(model, None, 0, n_scenes=2, target_resolution=80),
        lambda: calibrate_amplitude(model, None, 0, n_scenes=2, target_resolution=80),
        lambda: run_resolution_sweep(model, None, 0, resolutions=(80,)),
        lambda: run_statistical_benchmark(model, None, 0, n_examples=2, resolutions=(80,)),
        lambda: resolve_model(str(tmp_path)),
        lambda: main(["--model_path", str(tmp_path), "--target", "80", "--out", str(tmp_path)]),
        lambda: statistical.main(["--bundle", str(tmp_path), "--out", str(tmp_path)]),
        lambda: resolution_comparison.main(["--bundle", str(tmp_path), "--out", str(tmp_path)]),
        lambda: compare_methods.main(["--model_path", str(tmp_path), "--out", str(tmp_path)]),
        lambda: selffeed_cascade_dataset(model, None, 0, 2, finest=80),
        lambda: resolve_expert(str(tmp_path)),
        lambda: out_of_sample.main(["--model_path", str(tmp_path), "--out", str(tmp_path)]),
        lambda: compare_test_cases.main(["--model_path", str(tmp_path), "--out", str(tmp_path)]),
        lambda: evaluate_out_of_sample(model, None, 0, n_samples=2),
        lambda: run_generalization_grid(model, None, 0, n_samples=2),
        lambda: run_single_example(model, None, 0, (80,), (8.0, 12.0), "tile"),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_turns_tf32_off_for_a_card(monkeypatch):
    """Every entry point resolves its device here: for a card, matmuls and
    cuDNN's convolutions run in full float32 (TF32 off), whatever the process
    had set."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from superresolution_for_pdes_tpu_torch.device import resolve_device

    assert resolve_device("cuda") == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    torch.backends.cudnn.allow_tf32 = True
    resolve_device("cpu")  # the CPU leaves the card's settings alone
    assert torch.backends.cudnn.allow_tf32 is True
