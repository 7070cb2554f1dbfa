"""PyTorch port, ``models/router.py``: the wavenumber estimator against the
JAX package's on seeded forcings of the generalization grid's ranges and at
the k = 6 boundary, the regime and high-k masks, the 2-, 3- and 4-arm
routers' predictions against JAX's ``RegimeRouter`` on JAX's data with
shared TINY weights, and ``cli.resolve_expert``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.models import router as jrouter
from superresolution_for_pdes_tpu_torch.cli import resolve_expert
from superresolution_for_pdes_tpu_torch.eval.test_cases import GRID, grid_datasets
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.router import RegimeRouter, estimate_wavenumbers
from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
from superresolution_for_pdes_tpu_torch.train.checkpoint import save_checkpoint

from torch_port_helpers import T, assert_rel_close, tiny_experts

K_ABS = 1e-4  # the estimator's two FFTs round differently; a wrong bin is >= 0.1
ROUTED_REL = 1e-4  # PERF.md section 2: the same TINY weights through each expert


def _forcings(rng, k_range, n=8, size=40):
    """Seeded ``sin(2 pi k1 x) sin(2 pi k2 y)`` on ``linspace(0, 1, size)``,
    float32, with k1, k2 ~ U(k_range)."""
    k = rng.uniform(*k_range, size=(2, n))
    g = np.linspace(0.0, 1.0, size)
    f = np.sin(2 * np.pi * k[0, :, None, None] * g[None, None, :]) * \
        np.sin(2 * np.pi * k[1, :, None, None] * g[None, :, None])
    return f.astype(np.float32)


@pytest.mark.parametrize("label,k_range,const", GRID)
def test_estimate_wavenumbers_matches_jax(label, k_range, const, rng):
    """k1 as JAX's; k2 as JAX's, or, where JAX's peak fell in the last row
    (whose neighbour JAX clamps and the port wraps to row 0), as JAX's k1 of
    the transposed field, which reads the same row of the spectrum along an
    axis with no clamp in the way. The grid's own sets, drawn by the port, in
    float32 and float64: the chip check's comparison."""
    f = _forcings(rng, k_range, n=16)
    ours = estimate_wavenumbers(torch.from_numpy(f))
    ref = jrouter.estimate_wavenumbers(jnp.asarray(f))
    ref_t, _ = jrouter.estimate_wavenumbers(jnp.asarray(f.transpose(0, 2, 1)))
    assert all(o.dtype == torch.float32 and o.shape == (16,) for o in ours)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=0, atol=K_ABS)
    k2, same, mirrored = ours[1].numpy(), np.asarray(ref[1]), np.asarray(ref_t)
    assert np.all((np.abs(k2 - same) <= K_ABS) | (np.abs(k2 - mirrored) <= K_ABS)), label
    sets = grid_datasets(3, 10, device="cpu")
    for o32, o64 in zip(estimate_wavenumbers(sets[label]["f_fine"]),
                        estimate_wavenumbers(sets[label]["f_fine"].double())):
        np.testing.assert_allclose(o32.numpy(), o64.numpy(), rtol=0, atol=K_ABS)


def test_a_peak_in_the_last_row_reads_row_0():
    """``sin(2 pi (3.3 x - 1.2 y))`` peaks in row h - 1: the port's k2 is the
    one its mirror image in row 1 gives; JAX's clamp reads row h - 1 twice."""
    g = np.linspace(0.0, 1.0, 40)
    f = np.sin(2 * np.pi * (3.3 * g[None, :] - 1.2 * g[:, None])).astype(np.float32)
    k1, k2 = estimate_wavenumbers(torch.from_numpy(np.stack([f, f[::-1].copy()])))
    assert float(k2[0]) == pytest.approx(float(k2[1]), abs=K_ABS)  # rows h - 1 and 1
    assert abs(float(k2[0]) - 1.2) < 0.1 and abs(float(k1[0]) - 3.3) < 0.1
    assert float(jrouter.estimate_wavenumbers(jnp.asarray(f[None]))[1][0]) < 0.5


@pytest.mark.parametrize("k_true", [5.55, 5.75, 5.95, 6.05, 6.25, 6.45])
def test_the_k6_boundary_separates(k_true):
    """``tests/test_model_registry.py``'s boundary cases: no estimate from k <
    6 crosses 6, none from k > 6 falls below it."""
    k1, k2 = estimate_wavenumbers(forcing_term(k_true, k_true, 40)[None])
    assert (float(k1[0]) >= 6.0) == (k_true > 6.0), (k_true, float(k1[0]))
    ref_k1, _ = jrouter.estimate_wavenumbers(jnp.asarray(forcing_term(k_true, k_true, 40)[None]))
    assert float(k1[0]) == pytest.approx(float(ref_k1[0]), abs=K_ABS)
    assert float(k2[0]) == pytest.approx(float(k1[0]), abs=K_ABS)


@pytest.fixture(scope="module")
def routed_data():
    """JAX's sets: theta == 1 at low and high k, varying theta at low and high
    k, two samples each; as numpy for JAX and torch for the port."""
    parts = [jgen.generate_test_dataset(jax.random.key(20 + i), 2, k_range, constant_theta=c,
                                        dtype=jnp.float32)
             for i, (k_range, c) in enumerate((((1.0, 4.0), True), ((6.5, 8.0), True),
                                               ((1.0, 4.0), False), ((7.0, 8.0), False)))]
    ref = parts[0]
    for part in parts[1:]:
        ref = jgen.combine_datasets(ref, part)
    return ref, {k: T(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def experts():
    return tiny_experts(31, n_levels=4)


def _routers(arms, experts):
    """The JAX and port routers with ``arms`` experts; the varying expert
    normalizes per sample."""
    fmodel, jvars, tmodel, sds = experts
    norms = ("dataset", "per_sample", "dataset", "dataset")
    jkw, tkw = {}, {}
    if arms >= 3:
        jkw.update(const_high_model=fmodel, const_high_variables=jvars[2], k_threshold=6.0)
        tkw.update(const_high=(tmodel, sds[2], norms[2]), k_threshold=6.0)
    if arms == 4:
        jkw.update(varying_high_model=fmodel, varying_high_variables=jvars[3],
                   k_threshold_varying=6.5)
        tkw.update(varying_high=(tmodel, sds[3], norms[3]), k_threshold_varying=6.5)
    ref = jrouter.RegimeRouter(fmodel, jvars[0], fmodel, jvars[1], const_normalization=norms[0],
                               varying_normalization=norms[1], **jkw)
    ours = RegimeRouter((tmodel, sds[0], norms[0]), (tmodel, sds[1], norms[1]), **tkw)
    return ref, ours


def test_masks_match_jax(routed_data, experts):
    ref_data, data = routed_data
    jr, ours = _routers(4, experts)
    const = ours.regime_mask(data["theta_fine"])
    assert const.tolist() == np.asarray(jr.regime_mask(ref_data["theta_fine"])).tolist()
    assert const.tolist() == [True] * 4 + [False] * 4
    for threshold in (None, 6.5):
        hi = ours.highk_mask(data["f_fine"], threshold)
        assert hi.tolist() == np.asarray(jr.highk_mask(ref_data["f_fine"], threshold)).tolist()
        assert hi.tolist() == [False, False, True, True] * 2
    # ddof 0 (jnp.std), not the normalization layer's ddof 1: a field whose
    # unbiased std is just above the tolerance and biased std just below it
    n = 40 * 40
    theta = torch.ones(1, 40, 40, dtype=torch.float64)
    theta[0, 0, 0] += 1e-6 * np.sqrt(n * n / (n - 0.5))
    assert theta.std(correction=1) > 1e-6 > theta.std(correction=0)
    assert ours.regime_mask(theta).tolist() == [True]
    assert np.asarray(jr.regime_mask(jnp.asarray(theta.numpy()))).tolist() == [True]


@pytest.mark.parametrize("arms", [2, 3, 4])
def test_router_predict_matches_jax(arms, routed_data, experts):
    ref_data, data = routed_data
    jr, ours = _routers(arms, experts)
    ref = np.asarray(jr.predict(ref_data))
    routed = ours.predict(data)
    assert_rel_close(routed, ref, ROUTED_REL, f"{arms}-arm router")
    # each sample is its expert's own prediction
    from superresolution_for_pdes_tpu_torch.eval.single_level import predict_dataset

    arm = {2: [0, 0, 0, 0, 1, 1, 1, 1], 3: [0, 0, 2, 2, 1, 1, 1, 1],
           4: [0, 0, 2, 2, 1, 1, 3, 3]}[arms]
    expert_list = [ours.const, ours.varying, ours.const_high, ours.varying_high]
    for i, e in enumerate(arm):
        model, weights, norm = expert_list[e]
        own = predict_dataset(model, weights, data, normalization=norm)[i]
        assert torch.equal(routed[i], own), (arms, i, e)


def test_resolve_expert_reads_the_normalization(tmp_path, capsys):
    weights = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(2)).state_dict()
    run = tmp_path / "results" / "per_run_1"
    save_checkpoint(run / "best_model", {"model": weights})
    (run / "config.json").write_text(json.dumps({"normalization": "per_sample",
                                                 "scale_channels": True}))
    plain = tmp_path / "results" / "plain_run_0"
    save_checkpoint(plain / "best_model", {"model": AttentionUNet().state_dict()})
    for path in (run, run / "best_model"):
        model, state, norm = resolve_expert(str(path), device="cpu")
        assert norm == "per_sample" and model.in_channels == 5 and not model.training
        assert all(torch.equal(state[k], v) for k, v in weights.items())
    model, _, norm = resolve_expert(str(plain), device="cpu")
    assert norm == "dataset" and model.in_channels == 3
    torch.save({"model_state_dict": weights}, run / "reference.pth")
    assert resolve_expert(str(run / "reference.pth"), device="cpu")[2] == "per_sample"
    _, _, norm = resolve_expert(None, results_dir=str(tmp_path / "results"), device="cpu")
    assert norm == "per_sample" and "using latest run" in capsys.readouterr().out
