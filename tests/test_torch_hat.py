"""PyTorch port, ``models/hat.py``: HAT against the benchmark's plain reference
(``portbench/families/hat.py``, written out as upstream's ``hat_arch.py``:
``torch.roll``, window partition and reverse, ``F.unfold`` with zero padding
for the overlapping attention's keys and values, explicit ``q k^T`` and
``softmax``, the CAB's convolutions, pool and sigmoid), at TINY widths (window
4, key window 6, two blocks a group, so that every group has a shifted block
and an OCAB whose border windows attend zero keys), on seeded random weights
(every tensor, the LayerNorms and both bias tables included); its registry
entry and state_dict; a bundle of it served through the cascade. There is no
JAX twin."""

import json

import pytest
import torch

from portbench.families import hat as reference
from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
from superresolution_for_pdes_tpu_torch.cli import train as train_cli
from superresolution_for_pdes_tpu_torch.deploy import load_bundle, save_bundle
from superresolution_for_pdes_tpu_torch.models import HAT, build_model, count_parameters
from superresolution_for_pdes_tpu_torch.models.hat import OCAB
from superresolution_for_pdes_tpu_torch.ops import window_attention as wa

import torch_port_helpers  # noqa: F401  (thread limit)

ARCH = {"in_channels": 5, **reference.TINY}
PUBLISHED = {"in_channels": 5, "embed_dim": 180, "depths": [6] * 6, "num_heads": [6] * 6,
             "window_size": 16, "overlap_ratio": 0.5, "compress_ratio": 3,
             "squeeze_factor": 30, "conv_scale": 0.01, "mlp_ratio": 2}
# float32 throughout; the two sides order their sums differently (the
# attentions in token layout against the windows' reshapes, the roll and the
# unfold; q scaled after q k^T rather than before): 1.2e-7 to 1.7e-7 of
# max|output| at these sizes, so 1e-5 leaves room for the platform's kernels
# and fails on any wrong term, and on the same model computed in bfloat16
# (4.4e-3: test_bfloat16_fails_the_tolerances)
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
            for key, shape, _ in reference.layout(arch)}


def _model(arch, state):
    model = build_model(**reference.program_config(arch))
    model.load_state_dict(state)
    return model


def _input(size, seed=1):
    return torch.randn(3, 5, *size, generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _close(got, want, rel, what):
    err = _rel(got, want)
    assert err <= rel, f"{what}: {err:.3e} > {rel:g}"


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


def test_bfloat16_fails_the_tolerances():
    """The tolerances tell float32 from the nearest precision below it: the
    same model and reference computed in bfloat16 miss the output's."""
    state = _weights(ARCH, 11)
    model = _model(ARCH, state).eval()
    x = _input((16, 16))
    want = reference.forward(ARCH, state, x)
    with torch.no_grad():
        low = model.bfloat16()(x.bfloat16()).float()
    assert _rel(low, want) > OUT_REL


def test_border_windows_attend_zero_keys():
    """An OCAB on a map of one window row: every key window reaches past the
    map, whose keys and values are zero with their bias alone as a logit;
    the block equals upstream's, gradients included."""
    torch.manual_seed(0)
    block = OCAB(12, 2, 4, 0.5, 2.0)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.3 * torch.randn_like(p))
    p = {f"x.{k}": v.detach().clone().requires_grad_(True) for k, v in block.state_dict().items()}
    t = torch.randn(2, 4 * 8, 12, requires_grad=True)
    got = block(t, 4, 8)
    want = reference._ocab(p, "x", t, 4, 8, 2, 4, 6)
    _close(got.detach(), want.detach(), OUT_REL, "output")
    g = torch.randn_like(got)
    mine = torch.autograd.grad(got, [t, *block.parameters()], g)
    theirs = torch.autograd.grad(want, [t, *p.values()], g)
    for a, b in zip(mine, theirs):
        _close(a, b, GRAD_REL, "gradient")
    # the zero keys carry weight: the bias rows only they use have a gradient
    table = block.relative_position_bias_table
    outside = wa.overlap_relative_index(4, 6)[0, 0]  # query (0, 0), key (-1, -1) off the map
    assert float(mine[1 + list(block.parameters()).index(table)][outside].abs().max()) > 0


def test_ocab_index_is_upstreams():
    """``ops/window_attention.py``'s index equals upstream's ``calculate_rpi_oca``
    (the reference's, negative entries wrapped) at the published and TINY
    widths, and is a bijection onto the table's rows."""
    for ws, ows in ((16, 24), (4, 6)):
        rows = (ws + ows - 1) ** 2
        upstream = reference._oca_index(ws, ows, "cpu") % rows
        index = wa.overlap_relative_index(ws, ows)
        assert torch.equal(index, upstream)
        assert int(index.min()) >= 0 and int(index.max()) == rows - 1


@pytest.mark.parametrize("arch", [ARCH, PUBLISHED], ids=["tiny", "published"])
def test_state_dict_is_the_layout(arch):
    """The state_dict holds the learned tensors only, under the layout's keys
    (upstream's, less its index buffers) and in its order; a strict load from
    the layout works; at the published widths 20,376,469 parameters."""
    model = build_model(**reference.program_config(arch))
    entries = reference.layout(arch)
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
        [(k, tuple(s)) for k, s, _ in entries]
    model.load_state_dict({k: torch.zeros(s) for k, s, _ in entries}, strict=True)
    assert count_parameters(model) == sum(v.numel() for v in model.state_dict().values())
    if arch is PUBLISHED:
        assert count_parameters(model) == 20_376_469
        assert isinstance(model, HAT) and model.in_channels == 5 and model.window_size == 16


def test_a_bundle_serves_the_cascade(tmp_path):
    """``save_bundle`` -> ``load_bundle`` -> ``ml_cascade`` gives the fields
    that ``ml_cascade`` gives with the modules' own weights."""
    experts = [_weights(ARCH, 20 + i) for i in range(2)]
    save_bundle(tmp_path / "b", reference.program_config(ARCH), experts, stats_mode="tile",
                coarse_tile=(20, 40))
    manifest = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert manifest["model_config"]["name"] == "hat"
    model, variables, _, loaded = load_bundle(tmp_path / "b", device="cpu")
    assert isinstance(model, HAT) and loaded["coarse_tile"] == (20, 40)
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
    """HAT normalises with LayerNorm only: ``--model_norm group`` stops with
    an error that says so, in the registry and through ``train``."""
    with pytest.raises(ValueError, match="hat has no BatchNorm"):
        build_model("hat", in_channels=5, norm="group")
    with pytest.raises(ValueError, match="no BatchNorm"):
        train_cli.main(["--model", "hat", "--model_norm", "group", "--generate",
                        "--gen_standard", "2", "--gen_subdomain", "2", "--batch_size", "2",
                        "--epochs", "1", "--results", str(tmp_path), "--device", "cpu"])
