"""PyTorch port, the router's harnesses: the deterministic steps of
``evaluate_out_of_sample`` and ``run_generalization_grid`` fed JAX's
datasets against JAX's summaries (one model and the 4-arm router),
``run_single_example`` against JAX's on one scene, the sample figure's
indices against JAX's, and CPU runs of the ``out_of_sample`` and
``compare_test_cases`` commands with the router and with one
``--model_path``."""

import json
import math

import jax
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.cascade import multires as jmultires
from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.eval import plots as jplots
from superresolution_for_pdes_tpu.eval import statistical as jstatistical
from superresolution_for_pdes_tpu.eval.out_of_sample import evaluate_out_of_sample as jax_oos
from superresolution_for_pdes_tpu.eval.test_cases import GRID as JAX_GRID
from superresolution_for_pdes_tpu.eval.test_cases import run_generalization_grid as jax_grid
from superresolution_for_pdes_tpu.models import router as jrouter
from superresolution_for_pdes_tpu_torch.__main__ import COMMANDS
from superresolution_for_pdes_tpu_torch.cli import compare_test_cases
from superresolution_for_pdes_tpu_torch.cli import generate_data as gen_cli
from superresolution_for_pdes_tpu_torch.cli import out_of_sample
from superresolution_for_pdes_tpu_torch.eval import plots
from superresolution_for_pdes_tpu_torch.eval.out_of_sample import out_of_sample_on_data
from superresolution_for_pdes_tpu_torch.eval.statistical import (
    run_single_example,
    single_example_on_scene,
)
from superresolution_for_pdes_tpu_torch.eval.test_cases import (
    GRID,
    generalization_grid_on_data,
    grid_datasets,
)
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.router import RegimeRouter
from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

from torch_port_helpers import T, tiny_experts

METRIC_REL = 1e-3  # PERF.md section 2: metrics of fields that agree to 1e-4


@pytest.fixture(scope="module")
def experts():
    return tiny_experts(41, n_levels=4)


def _model(kind, experts):
    """``(JAX model, JAX variables, port model, port weights)``: one TINY
    expert, or the 4-arm router over four (the varying arm per sample)."""
    fmodel, jvars, tmodel, sds = experts
    if kind == "single":
        return fmodel, jvars[0], tmodel, sds[0]
    ref = jrouter.RegimeRouter(fmodel, jvars[0], fmodel, jvars[1],
                               varying_normalization="per_sample",
                               const_high_model=fmodel, const_high_variables=jvars[2],
                               varying_high_model=fmodel, varying_high_variables=jvars[3],
                               k_threshold=6.0, k_threshold_varying=6.5)
    ours = RegimeRouter((tmodel, sds[0], "dataset"), (tmodel, sds[1], "per_sample"),
                        const_high=(tmodel, sds[2], "dataset"),
                        varying_high=(tmodel, sds[3], "dataset"),
                        k_threshold=6.0, k_threshold_varying=6.5)
    return ref, None, ours, None


def _assert_summaries(ours, ref, what):
    assert set(ours) == set(ref) == {"ml", "bilinear", "bicubic"}
    for method, metrics in ref.items():
        for name, value in metrics.items():
            assert ours[method][name] == pytest.approx(value, rel=METRIC_REL), \
                f"{what} {method} {name}"


@pytest.mark.parametrize("kind,normalization,constant_theta", [
    ("single", "dataset", True),
    ("single", "per_sample", False),
    ("router", "dataset", False),
])
def test_out_of_sample_matches_jax(kind, normalization, constant_theta, experts, tmp_path):
    jm, jv, tm, tv = _model(kind, experts)
    key = jax.random.key(7)
    ref = jax_oos(jm, jv, key, n_samples=4, normalization=normalization,
                  constant_theta=constant_theta)
    # the set JAX's harness draws from this key
    data = jgen.generate_test_dataset(key, 4, (5.0, 8.0), constant_theta=constant_theta)
    save_dir = tmp_path if kind == "router" else None  # the figures once
    ours = out_of_sample_on_data(tm, tv, {k: T(v) for k, v in data.items()}, save_dir=save_dir,
                                 n_plot=1, normalization=normalization)
    assert ours["label"] == "out_of_sample" and ours["n_samples"] == 4
    _assert_summaries(ours["summary"], ref["summary"], kind)
    if save_dir is None:
        return
    avg = json.loads((tmp_path / "average_metrics.json").read_text())
    assert avg["avg_ml_mae"] == ours["summary"]["ml"]["mae"] and len(avg) == 12
    for name in ("out_of_sample_metrics.json", "error_distribution_1.png",
                 "cross_section_1.png"):
        assert (tmp_path / name).is_file(), name


@pytest.mark.parametrize("kind", ["single", "router"])
def test_generalization_grid_matches_jax(kind, experts, tmp_path):
    assert GRID == JAX_GRID
    jm, jv, tm, tv = _model(kind, experts)
    key = jax.random.key(11)
    ref = jax_grid(jm, jv, key, n_samples=3)
    datasets = {}
    for label, k_range, const_theta in JAX_GRID:  # JAX's draw, split by split
        key, sub = jax.random.split(key)
        data = jgen.generate_test_dataset(sub, 3, k_range, constant_theta=const_theta)
        datasets[label] = {k: T(v) for k, v in data.items()}
    save_dir = tmp_path if kind == "router" else None  # the figures once
    ours = generalization_grid_on_data(tm, tv, datasets, save_dir=save_dir, n_plot=1)
    assert list(ours) == [label for label, _, _ in GRID]
    for label in ours:
        _assert_summaries(ours[label]["summary"], ref[label]["summary"], f"{kind} {label}")
    if save_dir is None:
        return
    written = json.loads((tmp_path / "comprehensive_test_results.json").read_text())
    assert written == {label: r["summary"] for label, r in ours.items()}
    for name in ("comparison_mae.png", "comparison_rmse_log.png",
                 "out_of_sample_varying_theta_metrics.json"):
        assert (tmp_path / name).is_file(), name


def test_grid_datasets_draw_five_sets_in_order():
    sets = grid_datasets(3, n_samples=4, device="cpu")
    again = grid_datasets(torch.Generator().manual_seed(3), n_samples=4, device="cpu")
    assert list(sets) == [label for label, _, _ in GRID]
    for (label, (lo, hi), const), data in zip(GRID, sets.values()):
        assert torch.equal(data["u_fine"], again[label]["u_fine"])
        k = torch.stack([data["k1"], data["k2"]])
        assert bool(((k >= lo) & (k <= hi)).all()), label
        assert bool((data["theta_fine"].std(dim=(-2, -1)) < 1e-6).all()) == const, label
    assert not torch.equal(sets["in_sample_const_theta"]["k1"], sets["training_like"]["k1"])


def test_run_single_example_matches_jax(experts):
    fmodel, jvars, tmodel, sds = experts
    key = jax.random.key(5)
    ref = jstatistical.run_single_example(fmodel, jvars[0], key, (80, 160), (8.0, 12.0), "tile",
                                          timings=False)
    jscene = jmultires.solve_multi_resolution(key, resolutions=(80, 160), k_range=(8.0, 12.0))
    scene = {"k1": jscene["k1"], "k2": jscene["k2"],
             **{f: {r: T(v) for r, v in jscene[f].items()} for f in ("u", "f", "theta")}}
    ours = single_example_on_scene(tmodel, sds[0], scene, (80, 160), "tile")
    assert ours["k1"] == pytest.approx(ref["k1"], rel=1e-7) and ours["solve_times"] == {}
    for res in (80, 160):
        for method in ("ml", "bilinear"):
            for name, value in ref[res][method].items():
                assert ours[res][method][name] == pytest.approx(value, rel=METRIC_REL), \
                    (res, method, name)
        assert ours[res]["ml_time"] > 0 and ours[res]["bilinear_time"] > 0
    drawn = run_single_example(tmodel, sds[0], 0, (80, 160), (8.0, 12.0), "tile", device="cpu")
    assert set(drawn["solve_times"]) == {40, 80, 160} and 8.0 <= drawn["k1"] <= 12.0
    assert all(math.isfinite(v) for r in (80, 160) for v in drawn[r]["ml"].values())


def test_sample_indices_match_jax(tmp_path, monkeypatch):
    """The indices JAX's ``plot_dataset_samples`` draws (read off its
    generator), then the port's figure through ``generate_data``."""
    drawn = []
    real = np.random.default_rng

    class Recorder:
        def __init__(self, seed):
            self.rng = real(seed)

        def choice(self, *args, **kwargs):
            drawn.append(self.rng.choice(*args, **kwargs))
            return drawn[-1]

    ds = {k: np.zeros((9, 4, 4), np.float32) for k in ("u_coarse", "u_fine", "theta_fine",
                                                        "f_fine")}
    for n, seed in ((5, 3), (20, 42)):
        monkeypatch.setattr(jplots.np.random, "default_rng", Recorder)
        jplots.plot_dataset_samples(ds, n_samples=n, seed=seed, out_dir=tmp_path / "jax")
        monkeypatch.undo()
        assert plots.sample_indices(9, n, seed).tolist() == drawn[-1].tolist()
    assert len(drawn[-1]) == 9  # capped at the dataset's size
    path = gen_cli.main(["--n_standard", "3", "--n_subdomain", "2", "--plot_samples", "4",
                         "--out", str(tmp_path / "data"), "--device", "cpu"])
    assert (path.parent / "dataset_samples" / "random_samples.png").is_file()


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Four full-width BatchNorm U-Net run dirs (the varying one per sample,
    5 channels)."""
    root = tmp_path_factory.mktemp("experts")
    runs = {}
    for i, name in enumerate(("const", "varying", "const_hi", "varying_hi")):
        cfg = ({"normalization": "per_sample", "scale_channels": True} if name == "varying"
               else {})
        model = AttentionUNet(in_channels=5 if cfg else 3,
                              generator=torch.Generator().manual_seed(60 + i))
        save_checkpoint(root / f"{name}_run_0" / "best_model", {"model": model.state_dict()})
        (root / f"{name}_run_0" / "config.json").write_text(json.dumps(cfg))
        runs[name] = str(root / f"{name}_run_0")
    return runs


def test_clis_run_the_router_and_one_model(run_dirs, tmp_path, capsys):
    router = ["--expert_const", run_dirs["const"], "--expert_varying", run_dirs["varying"],
              "--expert_const_highk", run_dirs["const_hi"], "--k_threshold", "6.0",
              "--expert_varying_highk", run_dirs["varying_hi"], "--k_threshold_varying", "6.5"]
    cpu = ["--device", "cpu"]
    grid = compare_test_cases.main([*router, "--n_samples", "2", "--out",
                                    str(tmp_path / "grid"), *cpu])
    single = compare_test_cases.main(["--model_path", run_dirs["varying"], "--n_samples", "1",
                                      "--out", str(tmp_path / "grid1"), *cpu])
    for result, out in ((grid, "grid"), (single, "grid1")):
        assert list(result) == [label for label, _, _ in GRID]
        saved = json.loads((tmp_path / out / "comprehensive_test_results.json").read_text())
        assert saved == {label: r["summary"] for label, r in result.items()}
    oos = out_of_sample.main([*router, "--n_samples", "2", "--varying_theta", "--out",
                              str(tmp_path / "oos"), *cpu])
    oos1 = out_of_sample.main(["--model_path", run_dirs["varying"], "--n_samples", "1",
                               "--out", str(tmp_path / "oos1"), *cpu])
    for result, out in ((oos, "oos"), (oos1, "oos1")):
        assert all(math.isfinite(v) for ms in result["summary"].values() for v in ms.values())
        for name in ("average_metrics.json", "out_of_sample_metrics.json"):
            assert (tmp_path / out / name).is_file(), (out, name)
    printed = capsys.readouterr().out
    assert "out_of_sample_varying_theta: ML MAE" in printed and "bicubic: MAE" in printed
    with pytest.raises(SystemExit, match="together"):
        out_of_sample.main(["--expert_const", run_dirs["const"], *cpu])
    assert {"out_of_sample", "compare_test_cases"} <= set(COMMANDS) and len(COMMANDS) == 9
