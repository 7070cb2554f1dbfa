"""PyTorch port, ``eval/`` and the freeze-and-evaluate commands: the
resolution sweep on a given scene (every method, ``ml_physics`` included)
and the statistical aggregates on the JAX package's own scenes, each against
the JAX package with the same per-level TINY weights; the model resolution
of ``cli/``; and the CLI round trip ``train`` -> ``upscale --model_path ...
--amp_calibrate --save_bundle`` -> ``upscale``/``statistical``/
``resolution_comparison --bundle`` on the CPU."""

import csv
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.cascade.multires import (
    solve_multi_resolution,
    solve_multi_resolution_batch,
)
from superresolution_for_pdes_tpu.eval.resolution import run_resolution_sweep as jax_sweep
from superresolution_for_pdes_tpu.eval.statistical import run_statistical_benchmark as jax_stats
from superresolution_for_pdes_tpu_torch.cli import resolve_level_experts, resolve_model
from superresolution_for_pdes_tpu_torch.cli import resolution_comparison, statistical
from superresolution_for_pdes_tpu_torch.cli import train as train_cli
from superresolution_for_pdes_tpu_torch.cli import upscale
from superresolution_for_pdes_tpu_torch.deploy import load_bundle
from superresolution_for_pdes_tpu_torch.eval import resolution, statistical as port_stats
from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

from torch_port_helpers import T, assert_rel_close, tiny_experts

CASCADE_REL = 1e-4  # max|diff| <= 1e-4 * max|JAX field| (PERF.md section 2)
METRIC_REL = 1e-3   # metrics of fields that agree to CASCADE_REL
SCHEDULE = dict(stats_mode="tile", coarse_tile=(20, 40))


@pytest.fixture(scope="module")
def experts():
    fmodel, jvars, tmodel, sds = tiny_experts(9, n_levels=2)
    g = np.random.default_rng(10).uniform(0.8, 1.2, (2, 48, 48)).astype(np.float32)
    return fmodel, jvars, tmodel, sds, [jnp.asarray(x) for x in g], [T(x) for x in g]


def test_resolution_sweep_matches_jax_on_a_given_scene(experts, tmp_path):
    fmodel, jvars, tmodel, sds, jg, tg = experts
    jscene = solve_multi_resolution(jax.random.key(31), resolutions=(80, 160),
                                    k_range=(10.0, 11.0))
    tscene = {k: {r: T(a) for r, a in jscene[k].items()} for k in ("u", "f", "theta")}
    tscene.update(k1=jscene["k1"], k2=jscene["k2"])
    kw = dict(resolutions=(80, 160), refine_cycles=2, **SCHEDULE)
    ref = jax_sweep(fmodel, jvars, jax.random.key(0), scene=jscene, amp_levels=jg, **kw)
    ours = resolution.run_resolution_sweep(tmodel, sds, scene=tscene, amp_levels=tg,
                                           save_dir=tmp_path, **kw)
    assert set(ours["solutions"]) == set(ref["solutions"]) == {
        "ml_multi_level", "ml_physics", "bilinear_direct", "bicubic_direct",
        "bilinear_multi_level", "bicubic_multi_level"}
    for name, by_res in ref["solutions"].items():
        for res in (80, 160):
            assert_rel_close(ours["solutions"][name][res], by_res[res], CASCADE_REL,
                             f"{name} {res}")
            for metric, value in ref["metrics"][name][res].items():
                assert ours["metrics"][name][res][metric] == pytest.approx(value, rel=METRIC_REL)
    assert ours["amp_levels"] == ref["amp_levels"]
    written = json.loads((tmp_path / "resolution_metrics.json").read_text())
    assert written["metrics"]["ml_physics"]["160"]["mae"] == ours["metrics"]["ml_physics"][160]["mae"]
    assert (tmp_path / "comparison_enhanced_160x160.png").is_file()
    # calibrated on its own self-generated scenes: one grid of gains per level
    calibrated = resolution.run_resolution_sweep(
        tmodel, sds, scene=tscene, resolutions=(80, 160), amp_calibrate=2, amp_mode="modal",
        amp_kind="grid", **SCHEDULE)
    assert [np.shape(g) for g in calibrated["amp_levels"]] == [(48, 48), (48, 48)]


def test_statistics_match_jax_on_its_scenes(experts, tmp_path):
    fmodel, jvars, tmodel, sds, jg, tg = experts
    key = jax.random.key(32)
    ref = jax_stats(fmodel, jvars, key, n_examples=2, resolutions=(80, 160), amp_levels=jg,
                    **SCHEDULE)
    jsc = solve_multi_resolution_batch(key, 2, resolutions=(80, 160), k_range=(8.0, 12.0))
    tsc = {k: {r: T(a) for r, a in jsc[k].items()} for k in ("u", "f", "theta")}
    tsc.update(k1=T(jsc["k1"]), k2=T(jsc["k2"]))
    solve_s = port_stats.solve_times(tsc)
    records, aggregate = port_stats.statistics_on_scenes(tmodel, sds, tsc, (80, 160), solve_s,
                                                         amp_levels=tg, **SCHEDULE)
    for res in (80, 160):
        for key_, value in ref["aggregate"][res].items():
            if not key_.endswith("time_mean"):
                assert aggregate[res][key_] == pytest.approx(value, rel=METRIC_REL), key_
        assert aggregate[res]["solve_time_mean"] == solve_s[res] > 0
        assert aggregate[res]["ml_time_mean"] > 0
    for ours, theirs in zip(records, ref["records"]):
        assert ours["k1"] == pytest.approx(theirs["k1"], rel=1e-6)
        assert ours["rms40"] == pytest.approx(theirs["rms40"], rel=1e-5)
        assert ours[160]["truth_rms"] == pytest.approx(theirs[160]["truth_rms"], rel=1e-5)
    port_stats.write_csv_summary_and_plots(records, aggregate, (80, 160), tmp_path)
    with open(tmp_path / "statistical_results.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    assert tuple(rows[0]) == port_stats.CSV_COLUMNS and len(rows) == 1 + 2 * 2
    assert "160x160: ML MAE" in (tmp_path / "summary.txt").read_text()
    assert (tmp_path / "mae_vs_wavenumber.png").is_file()


def test_resolve_model_reads_the_ports_checkpoints(tmp_path, experts):
    sds = experts[3]
    run = tmp_path / "a_run_1"
    save_checkpoint(run / "best_model", {"model": sds[0]})
    (run / "config.json").write_text(json.dumps({"scale_channels": True, "model_norm": "group"}))
    model, weights, stats = resolve_model(str(run), device="cpu")
    assert stats is None and model.in_channels == 5 and not model.training
    assert isinstance(model.enc1.bn1, torch.nn.GroupNorm) and weights.keys() == sds[0].keys()
    _, direct, _ = resolve_model(str(run / "best_model"), device="cpu")  # the checkpoint dir
    assert all(torch.equal(direct[k], v) for k, v in weights.items())
    assert resolve_model(None, results_dir=str(tmp_path), device="cpu")[1].keys() == weights.keys()
    args = SimpleNamespace(model_path_level1=str(run), model_path_level=[("3", str(run))])
    _, seq, _ = resolve_level_experts(str(run), args, device="cpu")
    assert len(seq) == 4 and seq[0] is seq[2] and seq[1] is seq[3]
    with pytest.raises(SystemExit):
        resolve_level_experts(str(run), SimpleNamespace(model_path_level=[("0", str(run))]),
                              device="cpu")
    torch.save({"model_state_dict": sds[0]}, run / "ref.pth")  # beside the run's config
    model, pth_weights, pth_stats = resolve_model(str(run / "ref.pth"), device="cpu")
    assert pth_stats is None and model.in_channels == 5
    assert all(torch.equal(pth_weights[k], v) for k, v in sds[0].items())
    with pytest.raises(FileNotFoundError):
        resolve_model(str(tmp_path / "missing"), device="cpu")


def test_clis_freeze_and_evaluate_a_bundle(tmp_path, capsys):
    history = train_cli.main(["--generate", "--gen_standard", "4", "--gen_subdomain", "4",
                              "--batch_size", "4", "--epochs", "1", "--physics_weight", "0.3",
                              "--normalization", "per_sample", "--scale_channels",
                              "--results", str(tmp_path / "results"), "--device", "cpu"])
    run = str(history["run_dir"])
    _, _, stats = resolve_model(run, device="cpu")
    assert stats is not None and stats.u_std.ndim == 0  # the checkpoint's norm_stats
    bundle = tmp_path / "bundle"
    common = ["--target", "160", "--k", "9", "10", "--seed", "1", "--device", "cpu"]
    upscale.main(["--model_path", run, "--model_path_level1", run, "--tile_levels", "20", "40",
                  "--amp_calibrate", "2", "--amp_k", "8", "12", "--save_bundle", str(bundle),
                  "--out", str(tmp_path / "assembled"), *common])
    _, variables, amp, manifest = load_bundle(bundle, device="cpu")
    assert manifest["coarse_tile"] == (20, 40) and manifest["extra"]["amp_calibrate"] == 2
    assert manifest["variables_files"] == ["level0", "level1"]  # the expert, the generalist
    assert all(torch.equal(variables[0][k], v) for k, v in variables[1].items())
    assert [a.shape for a in amp] == [(48, 48), (48, 48)]
    upscale.main(["--bundle", str(bundle), "--out", str(tmp_path / "served"), *common])
    for res in (80, 160):
        assert np.array_equal(np.load(tmp_path / "served" / f"ml_{res}x{res}.npy"),
                              np.load(tmp_path / "assembled" / f"ml_{res}x{res}.npy"))
    stat = statistical.main(["--bundle", str(bundle), "--n_examples", "2", "--resolutions", "80",
                             "160", "--out", str(tmp_path / "stat"), "--device", "cpu"])
    sweep = resolution_comparison.main(["--bundle", str(bundle), "--resolutions", "80", "160",
                                        "--refine_cycles", "1", "--out", str(tmp_path / "sweep"),
                                        "--device", "cpu"])
    saved = json.loads((tmp_path / "stat" / "statistical_results.json").read_text())
    assert saved["stats_mode"] == "tile" and len(saved["records"]) == 2
    assert np.array_equal(np.asarray(saved["amp_levels"][1], np.float32), amp[1].numpy())
    assert set(stat["aggregate"]) == {80, 160} and "ml_physics" in sweep["metrics"]
    for name in ("summary.txt", "statistical_results.csv"):
        assert (tmp_path / "stat" / name).is_file()
    assert (tmp_path / "sweep" / "resolution_metrics.json").is_file()
    out = capsys.readouterr().out
    assert "bundle saved to" in out and "ml+physics MAE" in out and "advantage" in out


@pytest.mark.parametrize("model, config", [
    ("attention_unet", {"scale_channels": True}),
    ("resnet", {"model_norm": "group"}),
    ("swinir", {"scale_channels": True}),
])
def test_a_frozen_bundle_names_the_runs_model(model, config, tmp_path, monkeypatch):
    """``upscale --save_bundle`` writes the run's own registry entry: its
    ``model``, 5 input channels under ``scale_channels``, its ``model_norm``;
    a default U-Net run's manifest is as it always was. (The cascade itself
    is replaced: the manifest is written before it runs.)"""
    from superresolution_for_pdes_tpu_torch.cascade import upscale as cascade_upscale
    from superresolution_for_pdes_tpu_torch.models import build_model

    run = tmp_path / "run"
    overrides = {"in_channels": 5} if config.get("scale_channels") else {}
    if "model_norm" in config:
        overrides["norm"] = config["model_norm"]
    save_checkpoint(run / "best_model", {"model": build_model(model, **overrides).state_dict()})
    cfg = {"model": model, **config}
    if model == "attention_unet":
        del cfg["model"]  # a run written before runs named their model
    (run / "config.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(cascade_upscale, "ml_cascade", lambda *a, **k: {})
    bundle = tmp_path / "bundle"
    upscale.main(["--model_path", str(run), "--save_bundle", str(bundle), "--target", "80",
                  "--out", str(tmp_path / "out"), "--device", "cpu"])
    written = json.loads((bundle / "manifest.json").read_text())["model_config"]
    assert list(written.items()) == [("name", model), *overrides.items()]
    served, variables, _, _ = load_bundle(bundle, device="cpu")
    served.load_state_dict(variables)  # the architecture the weights were trained as


def test_eval_clis_reject_unported_flags(tmp_path, capsys):
    """``--shard_tiles``, once refused, splits each model call's tiles over the
    visible devices: with ``--device cpu`` one part, the unsplit sweep bit for
    bit (``tests/test_torch_shard_tiles.py`` splits over two)."""
    from superresolution_for_pdes_tpu_torch.deploy import save_bundle
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet
    from torch_port_helpers import TINY

    experts = [AttentionUNet(in_channels=5, **TINY,
                             generator=torch.Generator().manual_seed(i)).state_dict()
               for i in range(2)]
    bundle = save_bundle(tmp_path / "bundle", {"name": "attention_unet", "in_channels": 5,
                                               **TINY}, experts, coarse_tile=(20, 40))
    argv = ["--bundle", str(bundle), "--resolutions", "80", "160", "--device", "cpu"]
    split = resolution_comparison.main([*argv, "--shard_tiles", "--out", str(tmp_path / "a")])
    assert "split over 1 device(s): cpu" in capsys.readouterr().out
    plain = resolution_comparison.main([*argv, "--out", str(tmp_path / "b")])
    assert split["metrics"] == plain["metrics"]
    for name, by_res in plain["solutions"].items():
        for res, field in by_res.items():
            assert torch.equal(split["solutions"][name][res], field), (name, res)
