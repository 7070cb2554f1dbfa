"""PyTorch port, ``deploy.py`` and the ``upscale`` CLI: a JAX bundle converted
by ``scripts/jax_bundle_to_torch.py`` serves the same fields as the JAX
package's ``run_bundle``."""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.cascade.multires import solve_multi_resolution
from superresolution_for_pdes_tpu.deploy import run_bundle as jax_run_bundle
from superresolution_for_pdes_tpu.deploy import save_bundle as jax_save_bundle
from superresolution_for_pdes_tpu.models.torch_import import torch_state_dict_to_variables
from superresolution_for_pdes_tpu_torch.cli.upscale import main as upscale_main
from superresolution_for_pdes_tpu_torch.deploy import load_bundle, run_bundle, save_bundle
from superresolution_for_pdes_tpu_torch.models import AttentionUNet

from torch_port_helpers import TINY, assert_rel_close, np_

REL = 1e-4  # as the cascade parity tests
CONFIG = dict(name="attention_unet", in_channels=5, **TINY)


def _converter():
    path = Path(__file__).resolve().parents[1] / "scripts" / "jax_bundle_to_torch.py"
    spec = importlib.util.spec_from_file_location("jax_bundle_to_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _variables(seed):
    """Seeded TINY 5-channel Flax variables with non-trivial BatchNorm, drawn
    in numpy (layout read off the importer)."""
    rng = np.random.default_rng(seed)
    layout = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in AttentionUNet(in_channels=5, **TINY).state_dict().items()})

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:3])), shape)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.25, shape)
        return rng.normal(0.0, 0.02, shape)

    return jax.tree_util.tree_map_with_path(lambda p, x: draw(p, x).astype(np.float32), layout)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A JAX bundle (two experts, the second shared by two levels, grid gains,
    mixed overlap, per-level tiles) and its converted port bundle."""
    root = tmp_path_factory.mktemp("bundles")
    v0, v1 = _variables(0), _variables(1)
    gains = tuple(np.random.default_rng(2).uniform(0.8, 1.2, (3, 48, 48)).astype(np.float32))
    jax_save_bundle(root / "jax", CONFIG, (v0, v1, v1), amp_levels=gains,
                    overlap=(True, False), stats_mode="tile", coarse_tile=(20, 40),
                    extra={"note": "test"})
    _converter().main([str(root / "jax"), str(root / "torch")])
    return root / "jax", root / "torch"


@pytest.fixture(scope="module")
def scene():
    full = solve_multi_resolution(jax.random.key(4), resolutions=(80, 160), k_range=(3.0, 4.0))
    return {"u": {40: full["u"][40]}, "f": full["f"], "theta": full["theta"]}


def test_converted_bundle_layout(bundles):
    jax_dir, torch_dir = bundles
    manifest = json.loads((torch_dir / "manifest.json").read_text())
    source = json.loads((jax_dir / "manifest.json").read_text())
    assert manifest == source
    assert manifest["variables_files"] == ["level0", "level1", "level1"]
    assert (torch_dir / "level1" / "state_dict.pt").is_file()
    model, variables, amp, loaded = load_bundle(torch_dir, device="cpu")
    assert loaded["overlap"] == (True, False) and loaded["coarse_tile"] == (20, 40)
    assert variables[1] is variables[2] and len(amp) == 3 and amp[0].shape == (48, 48)
    assert model.in_channels == 5 and not model.training


def test_run_bundle_matches_jax(bundles, scene):
    jax_dir, torch_dir = bundles
    ref = jax_run_bundle(jax_dir, scene, 160)
    ours = run_bundle(torch_dir, {k: {r: np_(v) for r, v in f.items()} for k, f in scene.items()},
                      160, device="cpu")
    for res in (80, 160):
        assert_rel_close(ours[res], ref[res], REL, f"level {res}")


def test_save_load_roundtrip(tmp_path, bundles):
    _, torch_dir = bundles
    model, variables, amp, manifest = load_bundle(torch_dir, device="cpu")
    save_bundle(tmp_path / "again", manifest["model_config"], variables, amp_levels=amp,
                overlap=manifest["overlap"], stats_mode=manifest["stats_mode"],
                coarse_tile=manifest["coarse_tile"])
    _, again, amp2, manifest2 = load_bundle(tmp_path / "again", device="cpu")
    assert manifest2["variables_files"] == ["level0", "level1", "level1"]
    for key, value in variables[0].items():
        assert torch.equal(again[0][key], value)
    assert torch.equal(amp2[2], amp[2])
    save_bundle(tmp_path / "single", CONFIG, model, stats_mode="scene")
    _, single, amp3, m3 = load_bundle(tmp_path / "single", device="cpu")
    assert m3["per_level"] is False and amp3 is None and isinstance(single, dict)


def test_cli_serves_bundle(tmp_path, bundles, scene):
    jax_dir, torch_dir = bundles
    # self-generated scene: fields per level plus metrics against the exact solve
    upscale_main(["--bundle", str(torch_dir), "--target", "160", "--k", "3", "4",
                  "--out", str(tmp_path / "gen"), "--device", "cpu"])
    out = np.load(tmp_path / "gen" / "ml_160x160.npy")
    assert out.shape == (160, 160) and np.isfinite(out).all()
    metrics = json.loads((tmp_path / "gen" / "metrics.json").read_text())
    assert set(metrics) == {"80", "160"} and metrics["160"]["relative_l2"] > 0
    # a given scene (npz): same field as the JAX package's run_bundle
    np.savez(tmp_path / "scene.npz", u40=np_(scene["u"][40]),
             **{f"{k}{r}": np_(scene[k][r]) for k in ("f", "theta") for r in (80, 160)})
    upscale_main(["--bundle", str(torch_dir), "--scene", str(tmp_path / "scene.npz"),
                  "--target", "160", "--out", str(tmp_path / "given"), "--device", "cpu"])
    ref = jax_run_bundle(jax_dir, scene, 160)
    assert_rel_close(np.load(tmp_path / "given" / "ml_160x160.npy"), ref[160], REL, "cli 160")
    assert json.loads((tmp_path / "given" / "metrics.json").read_text()) == {}


def test_cli_rejects_unported_routes(tmp_path):
    """The model-assembly route runs a reference ``.pth`` checkpoint too; a
    model path that does not exist is an error."""
    torch.save({"model_state_dict": AttentionUNet().state_dict()}, tmp_path / "reference.pth")
    common = ["--target", "80", "--device", "cpu", "--out", str(tmp_path / "out")]
    upscale_main(["--model_path", str(tmp_path / "reference.pth"), *common])
    assert np.isfinite(np.load(tmp_path / "out" / "ml_80x80.npy")).all()
    with pytest.raises(FileNotFoundError):
        upscale_main(["--model_path", str(tmp_path / "missing"), *common])
