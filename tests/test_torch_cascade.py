"""PyTorch port, ``data/normalization.py`` and ``cascade/``: normalization,
tiles, modal correction, the multi-resolution scene step and the whole
cascade, each against the JAX package on the same inputs and (for the
cascade) the same per-level weights carried by ``models/convert.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.cascade import modal as jmodal
from superresolution_for_pdes_tpu.cascade import tiles as jtiles
from superresolution_for_pdes_tpu.cascade import upscale as jup
from superresolution_for_pdes_tpu.cascade.multires import solve_multi_resolution_batch
from superresolution_for_pdes_tpu.data import normalization as jnorm
from superresolution_for_pdes_tpu.models import AttentionUNet as FlaxUNet
from superresolution_for_pdes_tpu.models.torch_import import torch_state_dict_to_variables
from superresolution_for_pdes_tpu_torch.cascade import modal, tiles, upscale
from superresolution_for_pdes_tpu_torch.cascade.multires import multi_resolution_from_params
from superresolution_for_pdes_tpu_torch.data import normalization as norm
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.convert import variables_to_state_dict

from torch_port_helpers import TINY, assert_rel_close, f32, np_

CASCADE_REL = 1e-4  # max|diff| <= 1e-4 * max|JAX field| at every level


def T(a):
    """A torch tensor holding a copy of ``a`` (JAX arrays are read-only)."""
    return torch.from_numpy(np.array(a))


def _nchw(x):
    return np.moveaxis(np_(x), -1, -3)


@pytest.fixture
def rng():
    """Each test's own seeded draws. The suite's shared generator would hand
    these tests whatever is left after the files that ran before them in the
    same worker, so their inputs would change with the scheduling."""
    return np.random.default_rng(42)


# ------------------------------------------------------------ normalization
def _stats_close(ours, ref, rel=1e-6):
    """Stds to ``rel``; means to ``rel`` of their field's std (a mean near 0
    has no relative scale of its own)."""
    for field in ("u", "f", "theta"):
        std = np_(getattr(ref, f"{field}_std")).astype(np.float64)
        assert_rel_close(getattr(ours, f"{field}_std"), std, rel, f"{field}_std")
        diff = np.abs(np_(getattr(ours, f"{field}_mean")) - np_(getattr(ref, f"{field}_mean")))
        assert np.all(diff <= rel * std), f"{field}_mean"
    np.testing.assert_array_equal(np_(ours.theta_is_constant), np_(ref.theta_is_constant))


@pytest.mark.parametrize("constant_theta", [False, True])
def test_normalization_matches_jax(constant_theta, rng):
    u_c, u_f, f = f32(rng, 4, 20, 20), f32(rng, 4, 40, 40), f32(rng, 4, 40, 40)
    theta = (np.ones((4, 40, 40), np.float32) if constant_theta
             else f32(rng, 4, 40, 40, lo=0.5, hi=2.0))
    ref = jnorm.NormStats.from_fields(jnp.asarray(u_f), jnp.asarray(f), jnp.asarray(theta))
    ours = norm.NormStats.from_fields(T(u_f), T(f), T(theta))
    _stats_close(ours, ref)
    assert bool(ours.theta_is_constant) == constant_theta
    per_ref = jnorm.per_sample_stats(jnp.asarray(u_c), jnp.asarray(f), jnp.asarray(theta))
    per = norm.per_sample_stats(T(u_c), T(f), T(theta))
    assert per.u_std.shape == (4, 1, 1)
    _stats_close(per, per_ref)
    for scale in (False, True):
        x_ref = jnorm.make_model_inputs(jnp.asarray(u_c), jnp.asarray(f), jnp.asarray(theta),
                                        per_ref, scale_channels=scale)
        x = norm.make_model_inputs(T(u_c), T(f), T(theta), per, scale_channels=scale)
        assert x.shape == (4, 5 if scale else 3, 40, 40)
        assert_rel_close(x, _nchw(x_ref), 1e-6, "model inputs")
    assert_rel_close(norm.make_targets(T(u_f), ours),
                     _nchw(jnorm.make_targets(jnp.asarray(u_f), ref)), 1e-6, "targets")
    assert_rel_close(ours.denormalize_u(ours.normalize_u(T(u_f))), u_f, 1e-6, "roundtrip")


def test_per_sample_std_floor():
    zero = torch.zeros(2, 20, 20)
    st = norm.per_sample_stats(zero, torch.zeros(2, 40, 40), torch.ones(2, 40, 40))
    assert torch.all(st.u_std == 1e-20) and torch.all(st.theta_is_constant)


# -------------------------------------------------------------------- tiles
def test_tiles_match_jax(rng):
    field = f32(rng, 2, 80, 80)
    for tile in (20, 40, 80):
        ours = tiles.split_tiles(T(field), tile)
        np.testing.assert_array_equal(np_(ours), np_(jtiles.split_tiles(jnp.asarray(field), tile)))
        np.testing.assert_array_equal(np_(tiles.stitch_tiles(ours)), field)
    np.testing.assert_array_equal(np_(tiles.blend_weights(40)), np_(jtiles.blend_weights(40)))
    for tile, stride in ((40, 20), (20, 10)):
        ours = tiles.split_tiles_overlapping(T(field), tile, stride)
        ref = jtiles.split_tiles_overlapping(jnp.asarray(field), tile, stride)
        np.testing.assert_array_equal(np_(ours), np_(ref))
        preds = f32(rng, *ours.shape)  # inconsistent windows: a real feathered blend
        assert_rel_close(tiles.stitch_tiles_overlapping(T(preds), 80, stride),
                         jtiles.stitch_tiles_overlapping(jnp.asarray(preds), 80, stride),
                         1e-6, "overlap-add")
        assert_rel_close(tiles.stitch_tiles_overlapping(ours, 80, stride), field, 1e-6,
                         "overlap inverse")


# -------------------------------------------------------------------- modal
def test_modal_correction_matches_jax(rng):
    n, bpo = 80, 4
    np.testing.assert_array_equal(modal.radial_band_index(n, bpo), jmodal.radial_band_index(n, bpo))
    np.testing.assert_array_equal(modal.axis_band_index(n, bpo), jmodal.axis_band_index(n, bpo))
    field = f32(rng, 2, n, n)
    assert_rel_close(modal.dst2(T(field)), jmodal.dst2(jnp.asarray(field)), 1e-5, "dst2")
    nb = modal.N_OCTAVES * bpo
    for gains in (np.float32(0.9), f32(rng, nb, lo=0.8, hi=1.2), f32(rng, nb, nb, lo=0.8, hi=1.2)):
        ours = modal.apply_level_correction(T(field), T(np.asarray(gains)))
        ref = jmodal.apply_level_correction(jnp.asarray(field), jnp.asarray(gains))
        assert_rel_close(ours, ref, 1e-5, f"gains ndim {np.ndim(gains)}")


# ----------------------------------------------------------- scenes (JAX)
@pytest.fixture(scope="module")
def scenes():
    """Two JAX scenes at 40..640 (float32)."""
    return solve_multi_resolution_batch(jax.random.key(11), 2, k_range=(10.0, 11.0))


def _torch_scene(scenes, index=None, max_res=640):
    pick = (lambda a: np.asarray(a)) if index is None else (lambda a: np.asarray(a)[index])
    return {key: {r: T(pick(a)) for r, a in scenes[key].items() if r <= max_res}
            for key in ("u", "f", "theta")}


def _jax_scene(scenes, index=None, max_res=640):
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    return {key: {r: pick(a) for r, a in scenes[key].items() if r <= max_res}
            for key in ("u", "f", "theta")}


def test_multires_deterministic_step_matches_jax(scenes):
    k1, k2 = np.asarray(scenes["k1"]), np.asarray(scenes["k2"])
    ours = multi_resolution_from_params(T(k1), T(k2), T(np.asarray(scenes["theta"][640])))
    for res in (40, 80, 160, 320, 640):
        np.testing.assert_array_equal(np_(ours["theta"][res]), np.asarray(scenes["theta"][res]))
        # the grid may differ from XLA's CPU linspace by 1 ulp (see test_torch_ops)
        assert_rel_close(ours["f"][res], scenes["f"][res], 1e-5, f"f {res}")
        assert_rel_close(ours["u"][res], scenes["u"][res], 1e-4, f"u {res}")
    one = multi_resolution_from_params(float(k1[0]), float(k2[0]),
                                       T(np.asarray(scenes["theta"][640][0])),
                                       resolutions=(160, 640))
    assert_rel_close(one["u"][160], ours["u"][160][0], 1e-6, "single scene")


# ------------------------------------------------------------------ cascade
def _tiny_variables(rng):
    """Seeded 5-channel TINY Flax variables (numpy), non-trivial BatchNorm."""
    layout = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in AttentionUNet(in_channels=5, **TINY).state_dict().items()})

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / (shape[0] * shape[1] * shape[2])), shape)
        if name == "scale":
            return rng.uniform(0.9, 1.1, shape)
        if name == "var":
            return rng.uniform(0.8, 1.25, shape)
        return rng.normal(0.0, 0.02, shape)

    return jax.tree_util.tree_map_with_path(lambda p, x: draw(p, x).astype(np.float32), layout)


@pytest.fixture(scope="module")
def experts():
    """Four per-level TINY experts: (Flax model, JAX variables, port model,
    port state_dicts)."""
    rng = np.random.default_rng(5)
    jvars = tuple(jax.tree.map(jnp.asarray, _tiny_variables(rng)) for _ in range(4))
    sds = tuple(variables_to_state_dict(jax.device_get(v)) for v in jvars)
    return FlaxUNet(in_channels=5, **TINY), jvars, AttentionUNet(in_channels=5, **TINY), sds


def _grid_gains(seed, levels):
    g = np.random.default_rng(seed).uniform(0.8, 1.2, (levels, 48, 48)).astype(np.float32)
    return tuple(jnp.asarray(x) for x in g), tuple(T(x) for x in g)


def _cascades_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for res in ref:
        assert_rel_close(ours[res], ref[res], CASCADE_REL, f"level {res}")


@pytest.mark.parametrize("refine_cycles", [0, 2])
def test_champion_cascade_matches_jax(refine_cycles, scenes, experts):
    """Tile stats, coarse tiles (40, 80, 80), per-level experts, grid gains,
    one scene to 640, with and without physics refinement."""
    fmodel, jvars, tmodel, sds = experts
    jg, tg = _grid_gains(1, 4)
    kw = dict(stats_mode="tile", coarse_tile=(40, 80, 80), refine_cycles=refine_cycles)
    ref = jup.ml_cascade(fmodel, jvars, _jax_scene(scenes, 0), 640, amp_levels=jg, **kw)
    ours = upscale.ml_cascade(tmodel, sds, _torch_scene(scenes, 0), 640, amp_levels=tg, **kw)
    _cascades_close(ours, ref)
    if refine_cycles:  # kernel wiring (plain twins on the CPU) at 160/320/640
        wired = upscale.ml_cascade(tmodel, sds, _torch_scene(scenes, 0), 640, amp_levels=tg,
                                   use_kernels=True, **kw)
        _cascades_close(wired, ref)


def _train_stats(scenes):
    args = [scenes[k][80] for k in ("u", "f", "theta")]
    ref = jnorm.NormStats.from_fields(*args)
    ours = norm.NormStats(**{f: T(np.asarray(getattr(ref, f))) for f in
                             ("u_mean", "u_std", "f_mean", "f_std", "theta_mean", "theta_std",
                              "theta_is_constant")})
    return ref, ours


SCHEDULES = {
    # the configurations __graft_entry__.py runs first (its overlap and
    # symmetrize runs merged into one)
    "plain_scene": dict(overlap=False, stats_mode="scene"),
    "overlap_symmetrize_tile": dict(overlap=True, symmetrize=True, stats_mode="tile"),
    # per-level experts with a mixed overlap schedule, symmetrize and gains
    "mixed_train": dict(overlap=(False, True), symmetrize=True, stats_mode="train", experts=2),
    "windows_oracle": dict(coarse_tile=(40, 80), stats_mode="oracle", experts=2),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_cascade_schedules_match_jax_on_two_scenes(schedule, scenes, experts):
    fmodel, jvars, tmodel, sds = experts
    kw = dict(SCHEDULES[schedule])
    n_experts = kw.pop("experts", 0)
    jv, tv = (jvars[:n_experts], sds[:n_experts]) if n_experts else (jvars[0], sds[0])
    if kw["stats_mode"] == "train":
        kw["train_stats"] = _train_stats(scenes)
    jkw = {**kw, "train_stats": kw["train_stats"][0]} if "train_stats" in kw else kw
    tkw = {**kw, "train_stats": kw["train_stats"][1]} if "train_stats" in kw else kw
    if n_experts:
        jg, tg = _grid_gains(2, 2)
        jkw, tkw = {**jkw, "amp_levels": jg}, {**tkw, "amp_levels": tg}
    ref = jup.ml_cascade(fmodel, jv, _jax_scene(scenes, max_res=160), 160, **jkw)
    ours = upscale.ml_cascade(tmodel, tv, _torch_scene(scenes, max_res=160), 160, **tkw)
    assert ours[160].shape == (2, 160, 160)
    _cascades_close(ours, ref)


def test_batch_equals_scene_by_scene_and_weights_forms(scenes, experts):
    """The written-out scene batch equals one scene at a time, and weights
    given as a module or as a state_dict give the same field."""
    _, _, tmodel, sds = experts
    both = upscale.ml_cascade(tmodel, sds[0], _torch_scene(scenes, max_res=160), 160,
                              stats_mode="scene")
    module = AttentionUNet(in_channels=5, **TINY)
    module.load_state_dict(sds[0])
    for i in range(2):
        one = upscale.ml_cascade(tmodel, module, _torch_scene(scenes, i, 160), 160,
                                 stats_mode="scene")
        assert_rel_close(both[160][i], one[160], 1e-6, f"scene {i}")
    top = upscale.ml_multi_level_upscale(tmodel, sds[0], _torch_scene(scenes, max_res=160), 160,
                                         stats_mode="scene")
    assert torch.equal(top, both[160])


def test_interpolation_baselines_match_jax(scenes):
    u40 = np.asarray(scenes["u"][40])
    for method in ("bilinear", "bicubic"):
        assert_rel_close(upscale.interpolation_upscale(T(u40), 160, method),
                         jup.interpolation_upscale(jnp.asarray(u40), 160, method), 1e-5, method)
        assert_rel_close(upscale.multi_level_interpolation_upscale(T(u40), 160, method),
                         jup.multi_level_interpolation_upscale(jnp.asarray(u40), 160, method),
                         1e-5, method)


def test_level_schedules_and_errors(experts):
    assert upscale._level_tile((40, 80), 3) == 80 and upscale._level_tile(20, 2) == 20
    assert upscale._level_overlap([True, False], 0) and not upscale._level_overlap(False, 1)
    _, _, tmodel, sds = experts
    with pytest.raises(ValueError):
        upscale.ml_cascade(tmodel, sds[0], {}, 80, stats_mode="nope")
    with pytest.raises(ValueError):
        upscale.ml_cascade(tmodel, sds[0], {}, 80, stats_mode="train")
