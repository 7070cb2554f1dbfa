"""PyTorch port, ``models/resnet.py``: the residual CNN against the Flax
``PDEResNet`` (TINY and full width, 3 and 5 channels, batch and group norm)
with weights carried by ``models/convert.py``, its parameter count and
initialization, one TINY training step with the physics loss against JAX's
step in float64, and a CPU run of ``train --model resnet``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.data.normalization import NormStats as JaxNormStats
from superresolution_for_pdes_tpu.models import PDEResNet as FlaxResNet
from superresolution_for_pdes_tpu.models.unet import init_unet
from superresolution_for_pdes_tpu.train import loop as jloop
from superresolution_for_pdes_tpu.train.config import TrainConfig as JaxTrainConfig
from superresolution_for_pdes_tpu_torch.cli import resolve_model
from superresolution_for_pdes_tpu_torch.cli import train as train_cli
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.models import PDEResNet, build_model, count_parameters
from superresolution_for_pdes_tpu_torch.models.convert import variables_to_state_dict
from superresolution_for_pdes_tpu_torch.train import loop

from torch_port_helpers import assert_rel_close, f32, np_

FORWARD_REL = 1e-4  # PERF.md section 2: f32 through the model, same weights
TINY_RES = dict(features=8, num_blocks=2)


def _flax_variables(rng, in_channels, norm, **widths):
    """Seeded Flax ``{params, batch_stats}`` of a ``PDEResNet`` drawn in numpy
    (kernels with std ``1/sqrt(fan_in)``, small biases, non-trivial norm
    scales and running stats); the tree's layout is Flax's own."""
    model = FlaxResNet(in_channels=in_channels, norm=norm, **widths)
    _, layout = init_unet(jax.random.key(0), model)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / (shape[0] * shape[1] * shape[2])), shape)
        if name == "scale":
            return rng.uniform(0.9, 1.1, shape)
        if name == "var":
            return rng.uniform(0.8, 1.25, shape)
        return rng.normal(0.0, 0.02, shape)  # bias, mean

    return model, jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), jax.device_get(layout))


@pytest.mark.parametrize("widths,channels,norm", [
    (TINY_RES, 3, "batch"),
    (TINY_RES, 5, "group"),
    ({}, 3, "batch"),
    ({}, 5, "batch"),
    ({}, 5, "group"),
])
def test_forward_matches_flax(widths, channels, norm, rng):
    fmodel, variables = _flax_variables(rng, channels, norm, **widths)
    port = PDEResNet(in_channels=channels, norm=norm, **widths)
    port.load_state_dict(variables_to_state_dict(variables), strict=True)
    if norm == "group":
        assert port.block1.bn1.num_groups == port.block1.bn1.num_channels // 8
    x = f32(rng, 2, channels, 40, 40)
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x))
    ref = fmodel.apply(jax.tree.map(jnp.asarray, variables),
                       jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    assert_rel_close(ours, np.asarray(ref).transpose(0, 3, 1, 2), FORWARD_REL,
                     f"resnet {widths or 'full'} {channels}ch {norm}")


def test_parameter_count_and_init():
    model = build_model("resnet", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, PDEResNet) and model.in_channels == 3
    assert count_parameters(model) == 594_753
    assert count_parameters(build_model("resnet", in_channels=5)) == 594_753 + 2 * 9 * 64
    fmodel, fvars = init_unet(jax.random.key(0), FlaxResNet())
    assert sum(np.size(a) for a in jax.tree.leaves(fvars["params"])) == 594_753
    for conv in (model.block3.conv2, model.stem):  # fan_out 64 * 9
        std = float(conv.weight.detach().std())
        assert std == pytest.approx(np.sqrt(2.0 / (64 * 9)), rel=0.1)
    assert all(torch.all(c.bias == 0) for c in (model.stem, model.block3.conv2, model.head))
    assert torch.all(model.block1.bn1.weight == 1) and torch.all(model.block1.bn1.running_var == 1)
    same = build_model("resnet", generator=torch.Generator().manual_seed(0))
    assert torch.equal(same.block8.conv1.weight, model.block8.conv1.weight)


def test_tiny_train_step_matches_jax():
    """One step with the physics loss (weight 0.3, per-sample stats, 5
    channels, BatchNorm) against JAX's step run in float64, as
    ``tests/test_torch_train.py`` holds the U-Net's."""
    ds = jgen.generate_standard_dataset(jax.random.key(3), 8, constant_theta=False,
                                        dtype=jnp.float32)
    f64 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float64) if a.dtype.kind == "f"
                                    else a, tree)
    jstats = JaxNormStats.from_dataset(f64(ds))
    jarrays = f64(jloop.prepare_arrays(ds, JaxNormStats.from_dataset(ds), per_sample=True,
                                       scale_channels=True))
    _, variables = init_unet(jax.random.key(1), FlaxResNet(in_channels=5, **TINY_RES))
    params, batch_stats = f64(variables["params"]), f64(variables["batch_stats"])
    tx = jloop.make_optimizer(JaxTrainConfig())
    state = jloop.TrainState(params=params, batch_stats=batch_stats, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))
    fmodel = FlaxResNet(in_channels=5, dtype=jnp.float64, **TINY_RES)
    train_epoch, _ = jloop.make_train_fns(fmodel, tx, jstats, physics_weight=0.3)
    new_state, ref_loss = train_epoch(state, jarrays, jnp.arange(8, dtype=jnp.int32)[None])
    # the clipped gradient, read back from Adam's first moment: mu = (1 - 0.9) g
    adam = new_state.opt_state[1].inner_state[0]
    ref_grads = variables_to_state_dict({"params": jax.tree.map(lambda m: m / 0.1, adam.mu)})

    dataset = {k: torch.from_numpy(np.array(v)) for k, v in ds.items()}
    stats = NormStats.from_dataset(dataset)
    arrays = loop.prepare_arrays(dataset, stats, per_sample=True, scale_channels=True)
    model = PDEResNet(in_channels=5, **TINY_RES)
    model.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    loss = loop.batch_loss(model.train(), arrays, stats, physics_weight=0.3)
    loss.backward()
    loop.clip_by_global_norm_(model.parameters(), 1.0)
    assert_rel_close(loss.detach(), ref_loss, 1e-5, "loss")
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    top = max(float(np.abs(np_(g)).max()) for g in ref_grads.values())
    for name, ref in ref_grads.items():
        if float(np.abs(np_(ref)).max()) >= 1e-6 * top:  # not a bias feeding BatchNorm
            assert_rel_close(grads[name], ref, 1e-4, name)
    ref_stats = variables_to_state_dict({"params": new_state.params,
                                         "batch_stats": new_state.batch_stats})
    running = [name for name in model.state_dict() if "running" in name]
    assert len(running) == 2 * 2 * 2  # two blocks, two norms, mean and var
    for name in running:
        assert_rel_close(model.state_dict()[name], ref_stats[name], 1e-5, name)


def test_train_cli_trains_a_resnet(tmp_path, capsys):
    history = train_cli.main(["--model", "resnet", "--generate", "--gen_standard", "4",
                              "--gen_subdomain", "4", "--gen_theta", "mixed", "--batch_size", "8",
                              "--epochs", "1", "--physics_weight", "0.1",
                              "--results", str(tmp_path), "--device", "cpu"])
    assert history["train_steps"] == [1] and np.isfinite(history["train_loss"]).all()
    assert isinstance(history["model"], PDEResNet)
    for which in ("", "final_model"):
        model, weights, stats = resolve_model(str(history["run_dir"] / which), device="cpu")
        assert isinstance(model, PDEResNet) and count_parameters(model) == 594_753
        model.load_state_dict(weights)
        assert stats is not None
    x = torch.randn(2, 3, 40, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model.eval()(x), history["model"].eval()(x))
    assert "best val loss" in capsys.readouterr().out
