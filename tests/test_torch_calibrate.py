"""PyTorch port, calibration and the stepwise cascade: ``band_gains``
(radial and grid), ``calibrate_amplitude`` and ``calibrate_modal`` fit on the
JAX package's own calibration scenes, and ``ml_cascade_stepwise``, each
against the JAX package with the same per-level TINY weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.cascade import modal as jmodal
from superresolution_for_pdes_tpu.cascade import upscale as jup
from superresolution_for_pdes_tpu.cascade.multires import solve_multi_resolution_batch
from superresolution_for_pdes_tpu_torch.cascade import modal, upscale

from torch_port_helpers import T, assert_rel_close, f32, tiny_experts

CASCADE_REL = 1e-4  # max|diff| <= 1e-4 * max|JAX field| at every level (PERF.md section 2)
# gains are ratios of sums over the cascade's fields, and a band with little
# energy divides two small sums: measured up to 4e-5 of the largest gain
GAIN_REL = 2e-4


@pytest.fixture(scope="module")
def experts():
    return tiny_experts(7, n_levels=2)


def _scenes(key, n, k_range):
    """The JAX package's scenes (as its calibration draws them from ``key``)
    and the same fields as torch tensors."""
    jsc = solve_multi_resolution_batch(key, n, resolutions=(80, 160), k_range=k_range)
    tsc = {k: {r: T(a) for r, a in jsc[k].items()} for k in ("u", "f", "theta")}
    tsc.update(k1=T(jsc["k1"]), k2=T(jsc["k2"]))
    return jsc, tsc


@pytest.mark.parametrize("kind", ["radial", "grid"])
def test_band_gains_match_jax(kind):
    rng = np.random.default_rng(3)
    truth = f32(rng, 3, 80, 80)
    pred = (1.1 * truth + 0.3 * f32(rng, 3, 80, 80)).astype(np.float32)
    ref = jmodal.band_gains(jnp.asarray(pred), jnp.asarray(truth), 4, kind)
    ours = modal.band_gains(T(pred), T(truth), 4, kind)
    assert ours.shape == ref.shape == ((48,) if kind == "radial" else (48, 48))
    assert_rel_close(ours, ref, 1e-5, kind)
    # bands below mode index 1 or above Nyquist hold no mode: gain 0
    assert torch.equal(ours == 0, T(np.asarray(ref) == 0)) and bool(torch.any(ours == 0))
    assert torch.equal(modal.band_gains(T(pred[0]), T(truth[0]), 4, kind),
                       modal.band_gains(T(pred[:1]), T(truth[:1]), 4, kind))
    with pytest.raises(ValueError):
        modal.band_gains(T(pred), T(truth), 4, "ring")


KW = dict(target_resolution=160, k_range=(6.0, 12.0), stats_mode="tile", coarse_tile=(20, 40))


def test_calibrate_amplitude_matches_jax(experts):
    fmodel, jvars, tmodel, sds = experts
    key = jax.random.key(21)
    ref = jup.calibrate_amplitude(fmodel, jvars, key, n_scenes=2, **KW)
    _, tsc = _scenes(key, 2, KW["k_range"])
    kw = {k: v for k, v in KW.items() if k != "k_range"}
    ours = upscale.fit_amplitudes(tmodel, sds, tsc, **kw)
    assert ours.shape == (2,)
    assert_rel_close(ours, ref, GAIN_REL, "amplitudes")
    # the seeded entry point draws its own scenes on the device asked for
    seeded = upscale.calibrate_amplitude(tmodel, sds, 5, n_scenes=2, device="cpu", **KW)
    assert torch.equal(seeded, upscale.calibrate_amplitude(tmodel, sds, 5, n_scenes=2,
                                                           device="cpu", **KW))


@pytest.mark.parametrize("kind", ["grid", "radial"])
def test_calibrate_modal_matches_jax(kind, experts):
    fmodel, jvars, tmodel, sds = experts
    key = jax.random.key(22)
    ref = jmodal.calibrate_modal(fmodel, jvars, key, n_scenes=2, kind=kind, **KW)
    _, tsc = _scenes(key, 2, KW["k_range"])
    kw = {k: v for k, v in KW.items() if k != "k_range"}
    ours = modal.fit_modal_gains(tmodel, sds, tsc, kind=kind, **kw)
    assert len(ours) == len(ref) == 2
    for level, (g, r) in enumerate(zip(ours, ref)):
        assert_rel_close(g, r, GAIN_REL, f"level {level}")
    again = modal.fit_modal_gains(tmodel, sds, tsc, kind=kind, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, ours))


def test_ml_cascade_stepwise_matches_jax_and_ml_cascade(experts):
    fmodel, jvars, tmodel, sds = experts
    jsc, tsc = _scenes(jax.random.key(23), 2, (8.0, 12.0))
    rng = np.random.default_rng(4)
    gains = [rng.uniform(0.8, 1.2, (48, 48)).astype(np.float32) for _ in range(2)]
    kw = dict(stats_mode="scene", coarse_tile=20, refine_cycles=1)
    ref, ref_times = jup.ml_cascade_stepwise(fmodel, jvars, jsc, 160,
                                             amp_levels=[jnp.asarray(g) for g in gains], **kw)
    ours, times = upscale.ml_cascade_stepwise(tmodel, sds, tsc, 160,
                                              amp_levels=[T(g) for g in gains], **kw)
    assert sorted(times) == sorted(ref_times) == [80, 160] and all(t > 0 for t in times.values())
    for res in (80, 160):
        assert_rel_close(ours[res], ref[res], CASCADE_REL, f"level {res}")
    fused = upscale.ml_cascade(tmodel, sds, tsc, 160, amp_levels=[T(g) for g in gains], **kw)
    assert all(torch.equal(fused[res], ours[res]) for res in (80, 160))
    upscale.warmup_cascade_stepwise(tmodel, sds, tsc, 160, amp_levels=[T(g) for g in gains],
                                    **kw)
