"""PyTorch port, self-fed cascade tiles: ``selffeed_from_params`` against the
JAX package's ``selffeed_cascade_dataset`` on JAX's replayed draws with the
same per-level TINY weights; the scene chunks, the errors, and CPU runs of
``train`` on a pure self-fed job and of ``generate_data --n_selffeed_scenes``
with a full-width random teacher."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu_torch import cli
from superresolution_for_pdes_tpu_torch.cli import generate_data as gen_cli
from superresolution_for_pdes_tpu_torch.cli import train as train_cli
from superresolution_for_pdes_tpu_torch.data import generate
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.unet import BatchNorm2d
from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

from torch_port_helpers import T, assert_rel_close, np_, tiny_experts, use_jax_forcing

CASCADE_REL = 1e-4  # max|diff| <= 1e-4 * max|JAX field| per key (PERF.md section 2)
DST_REL = 1e-5      # the exact solves (tests/test_torch_solver.py)


@pytest.fixture(scope="module")
def experts():
    return tiny_experts(11, n_levels=2)


def _replayed_draws(key, n_scenes, finest, harvested, tiles, tile):
    """The JAX generator's own draws: theta on the finest grid and one origins
    tensor per harvested level pair."""
    scene_key, tile_key = jax.random.split(key)
    _, _, t_key = jax.random.split(scene_key, 3)
    theta = jax.random.uniform(t_key, (n_scenes, finest, finest), jnp.float32, *jgen.THETA_RANGE)
    origins = []
    for res in harvested[:-1]:
        tile_key, o_key = jax.random.split(tile_key)
        origins.append(T(jax.random.randint(o_key, (n_scenes, tiles, 2), 0, res - tile + 1)))
    return T(theta), origins


CASES = {
    # the SFL2F shape: one 80 -> 160 pair with the teacher's predicted-80 input
    "finest160_harvest80_tile": dict(finest=160, harvest_from=80, stats_mode="tile",
                                     tile_size=40, teacher_tile=20, amp=False),
    "finest160_oracle": dict(finest=160, harvest_from=None, stats_mode="oracle",
                             tile_size=20, teacher_tile=20, amp=False),
    # two teacher levels with their own tiles and modal gains, three pairs
    "finest320_teacher_tiles_amp": dict(finest=320, harvest_from=None, stats_mode="tile",
                                        tile_size=20, teacher_tile=[20, 40], amp=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_selffeed_step_matches_jax(case, experts, monkeypatch):
    use_jax_forcing(monkeypatch)
    c = CASES[case]
    fmodel, jvars, tmodel, sds = experts
    key, n_scenes, tiles = jax.random.key(41), 2, 2
    gains = np.random.default_rng(5).uniform(0.8, 1.2, (2, 48, 48)).astype(np.float32)
    kw = dict(stats_mode=c["stats_mode"], harvest_from=c["harvest_from"],
              tile_size=c["tile_size"], teacher_tile=c["teacher_tile"])
    ref = jgen.selffeed_cascade_dataset(
        fmodel, jvars, key, n_scenes, tiles_per_level=tiles, finest=c["finest"],
        amp_levels=[jnp.asarray(g) for g in gains] if c["amp"] else None, **kw)
    harvested = [r for r in generate.cascade_resolutions(40, c["finest"])
                 if c["harvest_from"] is None or r >= c["harvest_from"]]
    theta, origins = _replayed_draws(key, n_scenes, c["finest"], harvested, tiles, c["tile_size"])
    k1, k2 = (T(ref[k][: n_scenes * tiles: tiles]) for k in ("k1", "k2"))
    ours = generate.selffeed_from_params(
        tmodel, sds, k1, k2, theta, origins,
        amp_levels=[T(g) for g in gains] if c["amp"] else None, **kw)
    n = n_scenes * tiles * (len(harvested) - 1)
    fine = 2 * c["tile_size"]
    assert set(ours) == set(ref) and ours["u_fine"].shape == (n, fine, fine)
    for name in ref:
        if name == "u_coarse":
            assert_rel_close(ours[name], ref[name], CASCADE_REL, name)
        elif name == "u_fine":
            assert_rel_close(ours[name], ref[name], DST_REL, name)
        else:
            np.testing.assert_array_equal(np_(ours[name]), np_(ref[name]), err_msg=name)
    if c["harvest_from"] is None:
        # the coarsest pair's inputs are exact solves, the deeper ones the teacher's
        exact = generate.cascade_from_params(k1, k2, theta, origins, tile_size=c["tile_size"])
        m = n_scenes * tiles
        assert torch.equal(ours["u_coarse"][:m], exact["u_coarse"][:m])
        assert not torch.equal(ours["u_coarse"][m:], exact["u_coarse"][m:])


def test_scene_chunks_draw_in_turn_and_match_one_batch(experts):
    _, _, tmodel, sds = experts
    kw = dict(tiles_per_level=2, finest=160, stats_mode="tile")
    chunked = generate.selffeed_cascade_dataset(tmodel, sds, torch.Generator().manual_seed(3), 4,
                                                scene_chunk=2, **kw)
    # the same per-chunk draws, replayed from the same seed, as one batch
    gen = torch.Generator().manual_seed(3)
    draws = []
    for _ in range(2):
        k1, k2 = generate._wave_numbers(gen, 2, (0.5, 12.0), torch.float32)
        theta = generate._theta_fields(gen, 2, 160, False, torch.float32)
        draws.append((k1, k2, theta, generate.sample_tile_origins(gen, 2, [40, 80, 160], 2)))
    whole = generate.selffeed_from_params(
        tmodel, sds, *(torch.cat([d[i] for d in draws]) for i in range(3)),
        [torch.cat([d[3][p] for d in draws]) for p in range(2)], stats_mode="tile")
    # chunk-major against pair-major order: (chunk, pair, scene, tile)
    order = torch.arange(16).reshape(2, 2, 2, 2).permute(1, 0, 2, 3).reshape(-1)
    for name, value in chunked.items():
        assert_rel_close(value, whole[name][order], 1e-5, name)
    assert chunked["u_fine"].shape == (16, 40, 40)


def test_selffeed_errors(experts):
    _, _, tmodel, sds = experts
    with pytest.raises(ValueError, match="multiple of scene_chunk"):
        generate.selffeed_cascade_dataset(tmodel, sds, 0, 4, scene_chunk=3, finest=80,
                                          device="cpu")
    with pytest.raises(ValueError, match="harvest_from=160 leaves no"):
        generate.selffeed_cascade_dataset(tmodel, sds, 0, 2, finest=160, harvest_from=160,
                                          device="cpu")


def test_fold_in_is_a_pure_function_of_the_seed():
    gen = torch.Generator().manual_seed(9)
    first = generate.fold_in(gen, 7)
    torch.rand(5, generator=gen)  # draws from gen do not move it
    assert torch.equal(torch.rand(3, generator=first),
                       torch.rand(3, generator=generate.fold_in(gen, 7)))
    assert generate.fold_in(gen, 7).initial_seed() != generate.fold_in(gen, 8).initial_seed()


def _teacher_run(path, seed):
    """A run dir of a full-width 5-channel random expert, as ``train`` writes."""
    model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(seed))
    save_checkpoint(path / "best_model", {"model": model.state_dict()})
    (path / "config.json").write_text(json.dumps({"scale_channels": True}))
    return str(path)


def test_train_cli_runs_a_pure_selffeed_job(tmp_path, monkeypatch):
    teachers = []
    resolve = cli.resolve_level_experts

    def spy(*args, **kwargs):
        teachers.append(resolve(*args, **kwargs))
        return teachers[-1]

    monkeypatch.setattr(cli, "resolve_level_experts", spy)
    r7, level1 = _teacher_run(tmp_path / "r7", 1), _teacher_run(tmp_path / "l1", 2)
    history = train_cli.main([
        "--generate", "--gen_stream", "--gen_theta", "mixed", "--gen_standard", "0",
        "--gen_subdomain", "0", "--gen_cascade_scenes", "0", "--gen_selffeed_scenes", "2",
        "--gen_selffeed_model", r7, "--gen_selffeed_model_level1", level1,
        "--gen_selffeed_finest", "160", "--gen_selffeed_harvest_from", "80",
        "--gen_selffeed_amp", "2", "--gen_selffeed_k", "6", "12",
        "--gen_selffeed_teacher_tile", "20", "--gen_tiles_per_level", "8", "--epochs", "2",
        "--batch_size", "4", "--normalization", "per_sample", "--scale_channels",
        "--physics_weight", "0.3", "--results", str(tmp_path / "results"), "--device", "cpu"])
    assert history["num_epochs"] == 2 and np.isfinite(history["train_loss"]).all()
    # 2 scenes x 8 tiles of the one harvested pair, each epoch's set regenerated
    assert history["train_steps"] == [4, 4] and history["regen_seconds"][1] > 0
    assert len(teachers) == 1  # resolved once for the run
    teacher, variables, _ = teachers[0]
    student = history["model"]
    assert teacher is not student and not teacher.training
    assert len(variables) == 2 and variables[0] is not variables[1]
    fresh = [m for m in AttentionUNet(in_channels=5).modules() if isinstance(m, BatchNorm2d)]
    trained = [m for m in student.modules() if isinstance(m, BatchNorm2d)]
    for a, b in zip(fresh, trained):
        assert not torch.equal(a.running_mean, b.running_mean)
        assert not torch.equal(a.running_var, b.running_var)


def test_generate_data_cli_appends_selffeed_tiles(tmp_path, capsys):
    teacher = _teacher_run(tmp_path / "r7", 3)
    path = gen_cli.main(["--n_standard", "2", "--n_subdomain", "2", "--n_selffeed_scenes", "1",
                         "--selffeed_model", teacher, "--cascade_tiles_per_level", "2",
                         "--cascade_finest", "160", "--out", str(tmp_path / "data"),
                         "--device", "cpu"])
    with np.load(path) as z:
        assert z["u_fine"].shape == (4 + 1 * 2 * 2, 40, 40)
        assert z["is_subdomain"].tolist() == [False] * 2 + [True] * 2 + [True] * 4
        assert np.isfinite(z["u_coarse"]).all()
    assert "+ 4 self-feeding cascade tiles" in capsys.readouterr().out
