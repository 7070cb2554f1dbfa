"""PyTorch port, ``models/swinir.py``: SwinIR against the benchmark's plain
reference (``portbench/families/swin_ir.py``, written out as upstream's
``network_swinir.py``: explicit ``q k^T``, ``softmax``, ``torch.roll`` and the
mask from the 3x3 slicing), at TINY widths with a window of 4 and two
blocks a group, so that every group has a shifted block, on seeded random
weights (every tensor, the LayerNorms and the bias tables included); its
registry entry and state_dict; a bundle of it served through the cascade.
There is no JAX twin."""

import json

import pytest
import torch

from portbench.families import swin_ir as reference
from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
from superresolution_for_pdes_tpu_torch.cli import train as train_cli
from superresolution_for_pdes_tpu_torch.deploy import load_bundle, save_bundle
from superresolution_for_pdes_tpu_torch.models import SwinIR, build_model, count_parameters

import torch_port_helpers  # noqa: F401  (thread limit)

ARCH = {"in_channels": 5, **reference.TINY}
PUBLISHED = {"in_channels": 5, "embed_dim": 180, "depths": [6] * 6, "num_heads": [6] * 6,
             "window_size": 8, "mlp_ratio": 2}
# float32 throughout; the two sides order their sums differently (fused
# attention on heads padded to 8 against q k^T, the windows' reshapes and the
# proj after the roll back): about 5e-7 of max|output| at these sizes, so
# 1e-5 leaves room for the platform's kernels and fails on any wrong term
OUT_REL = 1e-5
# each parameter's gradient sums over every token and window, and the
# LayerNorms' gradients cancel: 1e-4 of the parameter's max|grad|
GRAD_REL = 1e-4
# square multiples of the window, and a size that is not (reflect padding, crop)
SIZES = [(16, 16), (24, 24), (18, 22)]


def _weights(arch, seed):
    """A state_dict of ``arch`` with every tensor drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {key: 0.2 * torch.randn(shape, generator=gen)
            for key, shape, _ in reference.layout({"family": "swin_ir", **arch})}


def _model(arch, state):
    model = build_model(**reference.program_config(arch))
    model.load_state_dict(state)
    return model


def _input(size, seed=1):
    return torch.randn(3, 5, *size, generator=torch.Generator().manual_seed(seed))


def _close(got, want, rel, what):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_matches_the_reference(size):
    state = _weights(ARCH, 11)
    model = _model(ARCH, state).eval()
    x = _input(size)
    with torch.no_grad():
        got = model(x)
    assert got.shape == (3, 1, *size)
    _close(got, reference.forward(ARCH, state, x), OUT_REL, "output")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_training_gradients_match_the_reference(size):
    """Training mode (nothing in the model differs from evaluation): the
    output and the gradient of a loss on it, for every parameter."""
    state = _weights(ARCH, 12)
    model = _model(ARCH, state).train()
    x = _input(size, seed=2)
    target = torch.randn(3, 1, *size, generator=torch.Generator().manual_seed(3))
    got = model(x)
    ((got - target) ** 2).mean().backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    want = reference.forward(ARCH, leaves, x, train=True)
    grads = torch.autograd.grad(((want - target) ** 2).mean(), list(leaves.values()))
    _close(got.detach(), want.detach(), OUT_REL, "output")
    params = dict(model.named_parameters())
    assert params.keys() == leaves.keys()
    for key, g in zip(leaves, grads):
        _close(params[key].grad, g, GRAD_REL, key)


@pytest.mark.parametrize("arch", [ARCH, PUBLISHED], ids=["tiny", "published"])
def test_state_dict_is_the_layout(arch):
    """The state_dict holds the learned tensors only, under the layout's keys
    (upstream's, less its index and mask buffers); at the published widths
    11,504,161 parameters."""
    model = build_model(**reference.program_config(arch))
    entries = reference.layout({"family": "swin_ir", **arch})
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
        [(k, tuple(s)) for k, s, _ in entries]
    assert count_parameters(model) == sum(v.numel() for v in model.state_dict().values())
    if arch is PUBLISHED:
        assert count_parameters(model) == 11_504_161
        assert isinstance(model, SwinIR) and model.in_channels == 5


def test_a_bundle_serves_the_cascade(tmp_path):
    """``save_bundle`` -> ``load_bundle`` -> ``ml_cascade`` gives the fields
    that ``ml_cascade`` gives with the modules' own weights."""
    experts = [_weights(ARCH, 20 + i) for i in range(2)]
    save_bundle(tmp_path / "b", reference.program_config(ARCH), experts, stats_mode="tile",
                coarse_tile=(20, 40))
    manifest = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert manifest["model_config"]["name"] == "swinir"
    model, variables, _, loaded = load_bundle(tmp_path / "b", device="cpu")
    assert isinstance(model, SwinIR) and loaded["coarse_tile"] == (20, 40)
    gen = torch.Generator().manual_seed(4)
    scene = {"u": {40: torch.randn(40, 40, generator=gen)},
             "f": {r: torch.randn(r, r, generator=gen) for r in (80, 160)},
             "theta": {r: torch.rand(r, r, generator=gen) + 0.5 for r in (80, 160)}}
    served = ml_cascade(model, variables, scene, 160, stats_mode="tile", coarse_tile=(20, 40))
    modules = [_model(ARCH, sd).eval() for sd in experts]
    direct = ml_cascade(modules[0], modules, scene, 160, stats_mode="tile", coarse_tile=(20, 40))
    assert sorted(served) == [80, 160]
    for r in served:
        _close(served[r], direct[r], 1e-6, f"level {r}")


def test_group_norm_is_refused(tmp_path):
    """SwinIR normalises with LayerNorm only: ``--model_norm group`` stops
    with an error that says so, in the registry and through ``train``."""
    with pytest.raises(ValueError, match="no BatchNorm"):
        build_model("swinir", in_channels=5, norm="group")
    with pytest.raises(ValueError, match="no BatchNorm"):
        train_cli.main(["--model", "swinir", "--model_norm", "group", "--generate",
                        "--gen_standard", "2", "--gen_subdomain", "2", "--batch_size", "2",
                        "--epochs", "1", "--results", str(tmp_path), "--device", "cpu"])
