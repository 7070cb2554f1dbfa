"""PyTorch port, ``data/`` and the training bookkeeping: the deterministic
generator steps against the JAX generators (fed JAX's own draws), the
sampling steps' ranges and reproducibility, ``.npz`` files across the two
packages, the stratified split, the schedules, ``TrainConfig`` and run
directories."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.data import io as jio
from superresolution_for_pdes_tpu.data import pipeline as jpipe
from superresolution_for_pdes_tpu.train import config as jconfig
from superresolution_for_pdes_tpu.train import schedule as jschedule
from superresolution_for_pdes_tpu_torch.data import generate, io, pipeline
from superresolution_for_pdes_tpu_torch.train import config, schedule
from superresolution_for_pdes_tpu_torch.utils import runs

from torch_port_helpers import assert_rel_close, np_

DST_REL = 1e-5  # tests/test_torch_solver.py's float32 DST tolerance against JAX


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def jax_forcing(monkeypatch):
    """The port's generators evaluate the forcing with JAX's ``linspace`` grid,
    which is 1 ulp off at some points (``tests/test_torch_ops.py`` holds the
    forcing itself), so that the fields differ by the solves alone."""

    def forcing(k1, k2, n, dtype, device):
        f = jgen._batched_forcing(jnp.asarray(np_(k1)), jnp.asarray(np_(k2)), n, jnp.float32)
        return torch.from_numpy(np.array(f)).to(device)

    monkeypatch.setattr(generate, "forcing_term", forcing)


def _assert_dataset_matches(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        if key.startswith("u_"):
            assert_rel_close(ours[key], ref[key], DST_REL, key)
        else:
            np.testing.assert_array_equal(np_(ours[key]), np_(ref[key]), err_msg=key)


@pytest.mark.parametrize("constant_theta", [True, False])
def test_standard_step_matches_jax(constant_theta, jax_forcing):
    ref = jgen.generate_standard_dataset(jax.random.key(3), 6, constant_theta=constant_theta,
                                         dtype=jnp.float32)
    ours = generate.standard_from_params(_t(ref["k1"]), _t(ref["k2"]), _t(ref["theta_fine"]))
    _assert_dataset_matches(ours, ref)


def test_subdomain_step_matches_jax(jax_forcing):
    key = jax.random.key(4)
    ref = jgen.generate_subdomain_dataset(key, 6, constant_theta=False, dtype=jnp.float32)
    _, _, t_key, o_key = jax.random.split(key, 4)  # replay the generator's draws
    theta_sf = jax.random.uniform(t_key, (6, 80, 80), jnp.float32, *jgen.THETA_RANGE)
    origins = jax.random.randint(o_key, (6, 2), 0, 40)
    ours = generate.subdomain_from_params(_t(ref["k1"]), _t(ref["k2"]), _t(theta_sf),
                                          _t(origins))
    _assert_dataset_matches(ours, ref)


@pytest.mark.parametrize("tile", [20, 40])
def test_cascade_step_matches_jax(tile, jax_forcing):
    key, n_scenes, tiles = jax.random.key(5), 2, 3
    ref = jgen.generate_cascade_dataset(key, n_scenes, tiles_per_level=tiles, finest=160,
                                        constant_theta=False, dtype=jnp.float32,
                                        tile_size=tile)
    scene_key, tile_key = jax.random.split(key)
    _, _, t_key = jax.random.split(scene_key, 3)
    theta = jax.random.uniform(t_key, (n_scenes, 160, 160), jnp.float32, *jgen.THETA_RANGE)
    origins = []
    for res in (40, 80):
        tile_key, o_key = jax.random.split(tile_key)
        origins.append(_t(jax.random.randint(o_key, (n_scenes, tiles, 2), 0, res - tile + 1)))
    k1, k2 = (_t(ref[k][: n_scenes * tiles: tiles]) for k in ("k1", "k2"))
    ours = generate.cascade_from_params(k1, k2, _t(theta), origins, tile_size=tile)
    assert ours["u_fine"].shape == (2 * n_scenes * tiles, 2 * tile, 2 * tile)
    _assert_dataset_matches(ours, ref)


def test_sampling_steps_draw_in_range_and_repeat_by_seed():
    a = generate.generate_mixed_dataset(7, 4, 4, theta="mixed", n_cascade_scenes=2,
                                        cascade_tiles_per_level=3, cascade_finest=160,
                                        device="cpu")
    b = generate.generate_mixed_dataset(torch.Generator().manual_seed(7), 4, 4, theta="mixed",
                                        n_cascade_scenes=2, cascade_tiles_per_level=3,
                                        cascade_finest=160)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    # constant standard, constant subdomain, varying standard, varying subdomain, cascade
    assert a["u_fine"].shape == (4 * 4 + 2 * 3 * 2, 40, 40)
    flags = a["is_subdomain"].tolist()
    assert flags == [False] * 4 + [True] * 4 + [False] * 4 + [True] * 4 + [True] * 12
    assert torch.all(a["theta_fine"][:8] == 1)
    varying = a["theta_fine"][8:]
    assert float(varying.min()) >= 0.5 and float(varying.max()) < 2.0
    assert float(a["k1"][:4].max()) < 5.0 and float(a["k1"][4:8].max()) < 12.0
    assert float(a["k1"].min()) >= 0.5
    # a subdomain sample's coarse fields are the stride of its fine window
    assert torch.equal(a["u_coarse"][4], a["u_fine"][4, ::2, ::2])
    c = generate.generate_mixed_dataset(8, 4, 4, theta="mixed", device="cpu")
    assert not torch.equal(c["k1"], a["k1"][:16])


def test_tile_origins_cover_their_range():
    gen = torch.Generator().manual_seed(0)
    origins = generate.sample_tile_origins(gen, 64, [40, 80, 160], 8, coarse_tile=20)
    assert [int(o.max()) for o in origins] == [20, 60]  # res - tile, inclusive
    assert all(int(o.min()) == 0 for o in origins)


def test_combine_and_recipe_errors():
    empty = {k: torch.zeros((0, 20, 20)) for k in ("u_fine", "u_coarse")}
    full = {k: torch.ones((2, 40, 40)) for k in ("u_fine", "u_coarse")}
    assert generate.combine_datasets(empty, full) is full
    assert generate.combine_datasets(full, empty) is full
    assert generate.combine_datasets(full, full)["u_fine"].shape == (4, 40, 40)
    with pytest.raises(ValueError, match="key mismatch"):
        generate.combine_datasets(full, {"u_fine": full["u_fine"]})
    with pytest.raises(ValueError, match="cascade_tile_size"):
        generate.generate_mixed_dataset(0, 1, 1, n_cascade_scenes=1, cascade_tile_size=40,
                                        device="cpu")
    with pytest.raises(ValueError, match="theta"):
        generate.generate_mixed_dataset(0, 1, 1, theta="other", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        generate.generate_mixed_dataset(0, 0, 0, device="cpu")
    with pytest.raises(ValueError, match="scene_chunk"):
        generate.selffeed_cascade_dataset(None, None, 0, 3, scene_chunk=2, device="cpu")


def test_npz_loads_across_packages(tmp_path):
    ref = jgen.generate_standard_dataset(jax.random.key(1), 3, dtype=jnp.float32)
    ours = io.load_dataset(jio.save_dataset(ref, tmp_path / "jax.npz"), device="cpu")
    assert set(ours) == set(ref) and ours["is_subdomain"].dtype == torch.bool
    for key in ref:
        np.testing.assert_array_equal(np_(ours[key]), np_(ref[key]), err_msg=key)
    back = jio.load_dataset(io.save_dataset(ours, tmp_path / "port"), dtype=jnp.float32)
    assert (tmp_path / "port" / io.DEFAULT_FILENAME).exists()
    for key in ref:
        np.testing.assert_array_equal(np_(back[key]), np_(ref[key]), err_msg=key)
    # the reference's standard sets carry no is_subdomain
    np.savez(tmp_path / "ref.npz", **{k: np.asarray(v) for k, v in ref.items()
                                      if k != "is_subdomain"})
    flags = io.load_dataset(tmp_path / "ref.npz", device="cpu")["is_subdomain"]
    assert flags.dtype == torch.bool and not bool(flags.any())


@pytest.mark.parametrize("seed,sizes", [(0, (50, 70)), (3, (3, 2)), (42, (0, 9))])
def test_stratified_split_matches_jax(seed, sizes):
    flags = np.random.default_rng(seed).permutation(
        np.array([False] * sizes[0] + [True] * sizes[1]))
    ours = pipeline.stratified_split(seed, flags, 0.2)
    ref = jpipe.stratified_split(seed, flags, 0.2)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_epoch_batch_indices():
    idx = pipeline.epoch_batch_indices(torch.Generator().manual_seed(0), 70, 16)
    assert idx.shape == (4, 16) and len(set(idx.flatten().tolist())) == 64
    again = pipeline.epoch_batch_indices(torch.Generator().manual_seed(0), 70, 16)
    assert torch.equal(idx, again)
    with pytest.raises(ValueError, match="exceeds"):
        pipeline.epoch_batch_indices(torch.Generator(), 8, 16)


def test_schedules_match_jax():
    rng = np.random.default_rng(0)
    metric, metrics = 1.0, []
    for _ in range(120):
        if rng.random() < 0.15:
            metric *= 0.8
        metrics.append(metric * (1 + 0.01 * rng.standard_normal()))
    ours_p = schedule.ReduceLROnPlateau(lr=2e-4, patience=5)
    ref_p = jschedule.ReduceLROnPlateau(lr=2e-4, patience=5)
    ours_e, ref_e = schedule.EarlyStopping(patience=8), jschedule.EarlyStopping(patience=8)
    for epoch, m in enumerate(metrics):
        assert ours_p.step(m) == ref_p.step(m)
        assert ours_e.step(m, epoch) == ref_e.step(m, epoch)
        assert ours_p.state_dict() == ref_p.state_dict()
        assert ours_e.state_dict() == ref_e.state_dict()
    assert ours_p.lr < 2e-4  # the sequence did reduce the LR
    restored = schedule.EarlyStopping.from_state_dict(ref_e.state_dict())
    assert restored == ours_e


def test_train_config_matches_jax(tmp_path):
    ours, ref = config.TrainConfig(), jconfig.TrainConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    ref_custom = jconfig.TrainConfig(batch_size=8, physics_weight=0.3, gen_every=2)
    ref_custom.to_json(tmp_path / "config.json")
    loaded = config.TrainConfig.from_json(tmp_path / "config.json")
    assert dataclasses.asdict(loaded) == dataclasses.asdict(ref_custom)


def test_run_dirs(tmp_path):
    run = runs.create_run_dir(tmp_path, "p_")
    assert run.name.startswith("p_run_")
    with pytest.raises(FileNotFoundError):
        runs.find_latest_run_dir(tmp_path)
    (run / "best_model").mkdir()
    assert runs.find_latest_run_dir(tmp_path) == run
