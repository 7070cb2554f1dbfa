"""PyTorch port, the single-level evaluation and the diagnosis:
``evaluate_dataset`` against the JAX package's on the same test set and TINY
weights (dataset and per-sample normalization, the dihedral ensemble, the
normalized metric space); ``diagnose`` on a ``statistical_results.json`` the
port's harness wrote, against the JAX package's; and CPU runs of the
``compare_methods`` and ``diagnose`` commands."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.eval import diagnose as jdiag
from superresolution_for_pdes_tpu.eval.single_level import evaluate_dataset as jax_evaluate
from superresolution_for_pdes_tpu_torch.__main__ import COMMANDS
from superresolution_for_pdes_tpu_torch.cli import compare_methods
from superresolution_for_pdes_tpu_torch.cli import diagnose as diagnose_cli
from superresolution_for_pdes_tpu_torch.data import io
from superresolution_for_pdes_tpu_torch.data.generate import combine_datasets, generate_test_dataset
from superresolution_for_pdes_tpu_torch.eval import diagnose
from superresolution_for_pdes_tpu_torch.eval.single_level import evaluate_dataset
from superresolution_for_pdes_tpu_torch.eval.statistical import run_statistical_benchmark
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

from torch_port_helpers import T, TINY, tiny_experts

METRIC_REL = 1e-3  # metrics of fields that agree to 1e-4 (PERF.md section 2)


@pytest.fixture(scope="module")
def expert():
    fmodel, jvars, tmodel, sds = tiny_experts(13, n_levels=1)
    return fmodel, jvars[0], tmodel, sds[0]


@pytest.mark.parametrize("normalization,symmetrize,space", [
    ("dataset", False, "physical"),
    ("per_sample", False, "physical"),
    ("dataset", True, "physical"),
    ("per_sample", True, "normalized"),
])
def test_evaluate_dataset_matches_jax(normalization, symmetrize, space, expert, tmp_path):
    fmodel, jvars, tmodel, sd = expert
    ref_data = jgen.generate_test_dataset(jax.random.key(51), 6, (0.5, 5.0), constant_theta=False,
                                          dtype=jnp.float32)
    data = {k: T(v) for k, v in ref_data.items()}
    kw = dict(normalization=normalization, symmetrize=symmetrize, space=space)
    ref = jax_evaluate(fmodel, jvars, ref_data, **kw)
    ours = evaluate_dataset(tmodel, sd, data, save_dir=tmp_path, n_plot=1, **kw)
    assert ours["n_samples"] == ref["n_samples"] == 6
    assert ours["k1"] == pytest.approx(ref["k1"], rel=1e-7)
    for method, metrics in ref["per_sample"].items():
        for name, values in metrics.items():
            np.testing.assert_allclose(ours["per_sample"][method][name], values,
                                       rtol=METRIC_REL, err_msg=f"{method} {name}")
            assert ours["summary"][method][name] == pytest.approx(
                ref["summary"][method][name], rel=METRIC_REL)
    written = json.loads((tmp_path / "test_metrics.json").read_text())
    assert written["summary"] == ours["summary"] and len(written["per_sample"]["ml"]["mae"]) == 6
    assert (tmp_path / "test_sample_1.png").is_file()
    with pytest.raises(ValueError, match="metric space"):
        evaluate_dataset(tmodel, sd, data, space="other")


def _assert_same_tree(ours, ref, path=""):
    """Equal structure; floats within 1e-12 relative (NaN where NaN)."""
    if isinstance(ref, dict):
        assert set(map(str, ours)) == set(map(str, ref)), path
        for key in ref:
            _assert_same_tree(ours[key], ref[key], f"{path}/{key}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(ours), path
    else:
        assert ours == pytest.approx(ref, rel=1e-12, abs=0.0), path


def test_diagnose_matches_jax_on_a_statistical_run(tmp_path, capsys):
    model = AttentionUNet(in_channels=5, **TINY, generator=torch.Generator().manual_seed(4))
    run_statistical_benchmark(model, None, 2, n_examples=5, resolutions=(80, 160),
                              stats_mode="tile", save_dir=tmp_path, device="cpu")
    path = tmp_path / "statistical_results.json"
    for focus in (None, 160):
        ours = diagnose.diagnose_file(path, focus=focus)
        ref = jdiag.diagnose_file(path, focus=focus)
        _assert_same_tree(ours, ref)
        assert diagnose.format_report(ours, focus=focus) == jdiag.format_report(ref, focus=focus)
    assert ours["resolutions"] == [80, 160] and len(ours["table"]) == 5
    assert set(ours["features"]) >= {"k_sum", "tile_misalign_L1", "amp_ratio",
                                     "bilinear_rel_l2"}
    out = tmp_path / "diag" / "diagnosis.json"
    diag = diagnose_cli.main(["--results", str(path), "--focus", "160", "--out", str(out)])
    assert "worst scenes @ 160^2" in capsys.readouterr().out
    _assert_same_tree(json.loads(out.read_text())["features"],
                      {k: {str(r): v for r, v in d.items()} for k, d in diag["features"].items()})
    with pytest.raises(ValueError, match="not a resolution"):
        diagnose.format_report(ours, focus=640)


def test_compare_methods_cli(tmp_path, capsys):
    run = tmp_path / "run"
    model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(6))
    save_checkpoint(run / "best_model", {"model": model.state_dict()})
    (run / "config.json").write_text(json.dumps({"scale_channels": True}))
    fresh = compare_methods.main(["--model_path", str(run), "--n_samples", "3", "--seed", "1",
                                  "--out", str(tmp_path / "fresh"), "--device", "cpu"])
    assert fresh["n_samples"] == 3 and set(fresh["summary"]) == {"ml", "bilinear", "bicubic"}
    assert all(math.isfinite(v) for ms in fresh["summary"].values() for v in ms.values())
    data = combine_datasets(generate_test_dataset(1, 3, (0.5, 5.0), device="cpu"),
                            generate_test_dataset(2, 2, (0.5, 5.0), device="cpu"))
    path = io.save_dataset(data, tmp_path / "data")
    loaded = compare_methods.main(["--model_path", str(run), "--data", str(path),
                                   "--n_samples", "3", "--out", str(tmp_path / "loaded"),
                                   "--device", "cpu"])
    # the same seed draws the same test set, and --data keeps its first samples
    assert loaded["summary"] == fresh["summary"]
    assert (tmp_path / "loaded" / "compare_metrics.json").is_file()
    assert "bicubic: MAE" in capsys.readouterr().out
    assert {"compare_methods", "diagnose"} <= set(COMMANDS) and len(COMMANDS) == 9
