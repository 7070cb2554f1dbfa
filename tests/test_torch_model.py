"""PyTorch port, ``models/``: the attention U-Net against the Flax model, with
weights carried both ways (``models/convert.py`` into the port, the JAX
package's ``torch_state_dict_to_variables`` back), at full width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.models import AttentionUNet as FlaxUNet
from superresolution_for_pdes_tpu.models.torch_import import torch_state_dict_to_variables
from superresolution_for_pdes_tpu_torch.models import (
    AttentionUNet,
    PDEResNet,
    available_models,
    build_model,
    count_parameters,
)
from superresolution_for_pdes_tpu_torch.models.convert import variables_to_state_dict

from torch_port_helpers import TINY, f32

RTOL, ATOL = 1e-4, 1e-5  # tests/test_model.py's torch-oracle tolerance


def _flax_variables(rng, norm="batch", **widths):
    """Seeded Flax ``{params, batch_stats}`` drawn in numpy: kernels with std
    ``1/sqrt(fan_in)`` (activations stay O(1), as under PyTorch's default init
    that tests/test_model.py's oracle uses, so the elementwise tolerance
    measures arithmetic and not amplitude), small biases, non-trivial norm
    scales/shifts and running stats. The tree's layout is the Flax model's
    (read off the importer's output)."""
    layout = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in AttentionUNet(**widths).state_dict().items()})

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / (shape[0] * shape[1] * shape[2])), shape)
        if name == "scale":
            return rng.uniform(0.9, 1.1, shape)
        if name == "var":
            return rng.uniform(0.8, 1.25, shape)
        return rng.normal(0.0, 0.02, shape)  # bias, mean

    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), layout)
    if norm == "group":
        variables["batch_stats"] = {}
    return variables


def _flax_forward(variables, x_nchw, **model_kw):
    model = FlaxUNet(**model_kw)
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    y = apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
    return np.asarray(y).transpose(0, 3, 1, 2)


def _port_forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("channels,size", [(3, 40), (5, 80)])
def test_full_width_forward_matches_flax(channels, size, rng):
    variables = _flax_variables(rng, in_channels=channels)
    port = AttentionUNet(in_channels=channels)
    port.load_state_dict(variables_to_state_dict(variables), strict=True)
    x = f32(rng, 2, channels, size, size)
    ours = _port_forward(port, x)
    assert ours.shape == (2, 1, size, size)
    ref = _flax_forward(variables, x, in_channels=channels)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_port_state_dict_reads_into_flax(rng):
    """Reverse direction: port weights -> JAX's torch importer -> same output."""
    port = AttentionUNet(in_channels=5)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # O(1) activations, as in _flax_variables
        for m in port.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
                m.bias.normal_(0.0, 0.02, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.02, generator=g)
                m.running_var.uniform_(0.8, 1.25, generator=g)
                m.weight.uniform_(0.9, 1.1, generator=g)
    variables = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()})
    x = f32(rng, 2, 5, 80, 80)
    np.testing.assert_allclose(_port_forward(port, x), _flax_forward(variables, x, in_channels=5),
                               rtol=RTOL, atol=ATOL)
    # and back again: the converter restores the port's exact state_dict
    back = variables_to_state_dict(variables)
    for key, value in port.state_dict().items():
        assert torch.equal(back[key], value), key


def test_parameter_count_and_init():
    model = AttentionUNet(generator=torch.Generator().manual_seed(0))
    assert count_parameters(model) == 7_834_588
    assert count_parameters(AttentionUNet(in_channels=5)) == 7_834_588 + 2 * 9 * 64
    w = model.enc2.conv1.weight  # (128, 64, 3, 3): fan_out = 128 * 9
    assert float(w.detach().std()) == pytest.approx(np.sqrt(2.0 / (128 * 9)), rel=0.1)
    assert torch.all(model.enc2.conv1.bias == 0) and torch.all(model.enc2.bn1.weight == 1)
    same = AttentionUNet(generator=torch.Generator().manual_seed(0))
    assert torch.equal(same.final.weight, model.final.weight)


def test_tiny_group_norm_matches_flax(rng):
    variables = _flax_variables(rng, norm="group", **TINY)
    sd = variables_to_state_dict(variables)
    assert not any("running" in k for k in sd)
    port = build_model("attention_unet", norm="group", **TINY)
    port.load_state_dict(sd, strict=True)
    assert isinstance(port.enc1.bn1, torch.nn.GroupNorm) and port.enc1.bn1.num_groups == 1
    assert port.bridge[1].num_groups == 4  # 32 channels, group size 8
    x = f32(rng, 2, 3, 40, 40)
    np.testing.assert_allclose(_port_forward(port, x),
                               _flax_forward(variables, x, norm="group", **TINY),
                               rtol=RTOL, atol=ATOL)


def test_registry():
    wide = build_model("attention_unet_wide", enc_features=(16, 32, 64))
    assert wide.bridge[0].out_channels == 768
    assert available_models() == ("attention_unet", "attention_unet_wide", "resnet", "swinir",
                                  "hat", "restormer")
    resnet = build_model("resnet", features=16, num_blocks=2)
    assert isinstance(resnet, PDEResNet) and resnet.block2.conv1.out_channels == 16
    with pytest.raises(ValueError, match="unknown model"):
        build_model("nope")
