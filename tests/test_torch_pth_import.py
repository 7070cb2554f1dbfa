"""PyTorch port, ``models/torch_import.py``: a reference ``.pth`` the test
writes in the reference's key names (wrapped and raw, with and without
``num_batches_tracked``) loads through ``resolve_model`` and runs as the JAX
package's ``load_torch_checkpoint`` + Flax forward does; ``upscale
--model_path x.pth`` assembles a cascade."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu.models import AttentionUNet as FlaxUNet
from superresolution_for_pdes_tpu.models.torch_import import (
    load_torch_checkpoint as jax_load_torch_checkpoint,
)
from superresolution_for_pdes_tpu_torch.cli import resolve_model
from superresolution_for_pdes_tpu_torch.cli.upscale import main as upscale_main
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.torch_import import load_torch_checkpoint

from torch_port_helpers import assert_rel_close, f32

FORWARD_REL = 1e-4  # PERF.md section 2


@pytest.fixture(scope="module")
def reference():
    """A full-width reference state_dict (O(1) activations, non-trivial
    running statistics), an input, and the JAX package's forward of it."""
    g = torch.Generator().manual_seed(17)
    model = AttentionUNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
                m.bias.normal_(0.0, 0.02, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.02, generator=g)
                m.running_var.uniform_(0.8, 1.25, generator=g)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    x = f32(np.random.default_rng(3), 2, 3, 40, 40)
    return sd, x


@pytest.mark.parametrize("wrapped,tracked", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_pth_loads_and_runs_as_jax_does(wrapped, tracked, reference, tmp_path):
    sd, x = reference
    saved = {k: v for k, v in sd.items() if tracked or not k.endswith("num_batches_tracked")}
    path = tmp_path / "reference.pth"
    torch.save({"epoch": 3, "model_state_dict": saved} if wrapped else saved, path)
    loaded = load_torch_checkpoint(path)
    assert loaded.keys() == sd.keys()
    assert all(torch.equal(loaded[k], v) for k, v in sd.items() if "num_batches" not in k)
    model, weights, stats = resolve_model(str(path), device="cpu")
    assert stats is None and isinstance(model, AttentionUNet) and model.in_channels == 3
    model.load_state_dict(weights, strict=True)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x))
    variables = jax_load_torch_checkpoint(path)
    ref = FlaxUNet().apply(jax.tree.map(jnp.asarray, variables),
                           jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    assert_rel_close(ours, np.asarray(ref).transpose(0, 3, 1, 2), FORWARD_REL, "pth forward")


def test_pth_reads_its_runs_config_and_serves_a_cascade(reference, tmp_path):
    sd, _ = reference
    model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(4))
    torch.save({"model_state_dict": model.state_dict()}, tmp_path / "ref5.pth")
    (tmp_path / "config.json").write_text(json.dumps({"scale_channels": True}))
    loaded, weights, _ = resolve_model(str(tmp_path / "ref5.pth"), device="cpu")
    assert loaded.in_channels == 5 and weights.keys() == model.state_dict().keys()
    upscale_main(["--model_path", str(tmp_path / "ref5.pth"), "--target", "80", "--k", "3", "4",
                  "--out", str(tmp_path / "out"), "--device", "cpu"])
    field = np.load(tmp_path / "out" / "ml_80x80.npy")
    assert field.shape == (80, 80) and np.isfinite(field).all()
    assert json.loads((tmp_path / "out" / "metrics.json").read_text())["80"]["mae"] > 0
