"""Everything ``BENCHMARK.json`` names resolves by name to files of its own,
and a cell, a configuration, a traffic mix, a metric or a model family is
added by adding files alone."""

import json
import re
import shutil

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, tiny_cell
from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    spec = next(w for w in BENCH["workloads"] if w["name"] == cell)
    resolved = harness.load_cell(cell)
    assert (resolved.spec["config"], resolved.spec["traffic"]) == (spec["config"], spec["traffic"])
    assert resolved.spec["why"] == spec["why"] and resolved.spec["chips"] == spec["chips"]
    config = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert (ROOT / config["file"]).resolve() == (harness.HERE / "configs"
                                                 / f"{spec['config']}.json").resolve()
    assert resolved.config["name"] == config["name"]
    assert resolved.config["source"] == config["source"]
    assert resolved.config["reduced"] == config["reduced"]
    for attr in ("setup", "window", "traced", "check", "UNIT"):
        assert hasattr(resolved.driver, attr), attr
    assert resolved.family.__file__ == str(harness.HERE / "families"
                                           / f"{resolved.config['architecture']['family']}.py")
    assert set(resolved.limits) and all(v > 0 for v in resolved.limits.values())


@pytest.mark.parametrize("metric", METRICS)
def test_metric_resolves_to_its_reader(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    module = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    assert module.LAYER == entry["layer"]
    assert callable(module.read)
    for cell in entry["workloads"]:
        moved = harness.reported(BENCH, cell, per_layer=False)
        assert entry["moves"] in {m["name"] for m in moved}
        assert entry in harness.reported(BENCH, cell, per_layer=True)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_widths_give_the_published_parameter_count(config):
    arch = harness._json(harness.HERE / "configs" / f"{config}.json")["architecture"]
    family = harness.load_module(harness.HERE / "families" / f"{arch['family']}.py")
    count = sum(_numel(s) for _, s, kind in family.layout(arch) if kind in family.TRAINABLE)
    assert count == arch["parameters"]


def _numel(shape):
    out = 1
    for s in shape:
        out *= s
    return out


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix with its own driver, a cell and a
    per-layer metric, each a new file in a copy of the folder."""
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = sorted(p.relative_to(copy) for p in copy.rglob("*") if p.is_file())
    config = json.loads((copy / "configs" / "champion_unet.json").read_text())
    config["architecture"].update(enc_features=[96, 192, 384], bridge_features=768,
                                  head_features=[48, 24])
    (copy / "configs" / "champion_unet_wide.json").write_text(json.dumps(config))
    shutil.copy(copy / "drivers" / "serve_cascade.py", copy / "drivers" / "serve_copy.py")
    traffic = json.loads((copy / "traffic" / "serve_scene.json").read_text())
    (copy / "traffic" / "serve_refine1.json").write_text(
        json.dumps({**traffic, "driver": "serve_copy", "refine_cycles": 1}))
    (copy / "workloads" / "wide_serve_refine1.json").write_text(json.dumps(
        {"config": "champion_unet_wide", "traffic": "serve_refine1", "chips": 1,
         "why": "one V-cycle a level, 1.5x widths", "limits": {"field_err": 1e-4}}))
    (copy / "metrics" / "requests_per_scene.py").write_text(
        'LAYER = "cascade dispatch (cascade/upscale.py)"\n\n\ndef read(r):\n    return None\n')
    cell = harness.load_cell("wide_serve_refine1", base=copy)
    assert cell.traffic["refine_cycles"] == 1 and cell.driver.UNIT == "scene"
    assert cell.driver.__file__.endswith("serve_copy.py")
    assert cell.config["architecture"]["bridge_features"] == 768
    metric = harness.load_module(copy / "metrics" / "requests_per_scene.py")
    assert metric.read(None) is None
    after = sorted(p.relative_to(copy) for p in copy.rglob("*") if p.is_file()
                   and "__pycache__" not in p.parts)
    assert set(before) <= set(after)
    for rel in before:  # no file that was there changed
        assert (copy / rel).read_bytes() == (harness.HERE / rel).read_bytes()


def test_an_unknown_family_stops_as_a_missing_file(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((copy / "configs" / "round1_resnet.json").read_text())
    config["architecture"]["family"] = "swinir"
    (copy / "configs" / "round1_resnet.json").write_text(json.dumps(config))
    with pytest.raises(SystemExit, match=r"families/swinir\.py not found"):
        harness.load_cell("resnet_train_b32", base=copy)


# A model family that is not a convolutional network, as a new file: a 1x1
# projection, a LayerNorm over the channels, a GELU MLP of linear layers with
# a skip, a 1x1 head and the coarse solution. Its LayerNorm and linear
# tensors are kinds the shared draws do not know.
TOY_FAMILY = '''"""A toy mixer: 1x1 projection, channel LayerNorm, GELU MLP, 1x1 head."""
import math

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.layers import conv, conv_entries

TRAINABLE = ("conv", "bias", "linear", "ln_weight", "ln_bias")
TINY = {}


def program_config(arch):
    return {"name": "toy_mixer", "in_channels": arch["in_channels"],
            "features": arch["features"], "hidden": arch["hidden"]}


def _linear(name, cin, cout):
    return [(f"{name}.weight", (cout, cin), "linear"), (f"{name}.bias", (cout,), "bias")]


def layout(arch):
    c, h = arch["features"], arch["hidden"]
    return (conv_entries("proj", arch["in_channels"], c, 1)
            + [("norm.weight", (c,), "ln_weight"), ("norm.bias", (c,), "ln_bias")]
            + _linear("fc1", c, h) + _linear("fc2", h, c) + conv_entries("head", c, 1, 1))


def _linear_law(gen, shapes, device):
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=gen, device=device)
    out, at = [], 0
    for s in shapes:
        out.append(flat[at:at + math.prod(s)].reshape(s) / math.sqrt(s[1]))
        at += math.prod(s)
    return out


DRAWS = {"linear": _linear_law,
         "ln_weight": lambda gen, shapes, device: [
             1 + 0.1 * torch.randn(s, generator=gen, device=device) for s in shapes],
         "ln_bias": lambda gen, shapes, device: [
             0.1 * torch.randn(s, generator=gen, device=device) for s in shapes]}


def forward(arch, p, x, train=False):
    t = conv(p, "proj", x, padding=0).permute(0, 2, 3, 1)
    m = F.layer_norm(t, t.shape[-1:], p["norm.weight"], p["norm.bias"])
    m = F.linear(F.gelu(F.linear(m, p["fc1.weight"], p["fc1.bias"])), p["fc2.weight"],
                 p["fc2.bias"])
    return conv(p, "head", (t + m).permute(0, 3, 1, 2), padding=0) + x[:, 0:1]


def flops_forward(arch, size):
    c, h = arch["features"], arch["hidden"]
    return (flops.conv(arch["in_channels"], c, 1, size) + 4 * c * h * size * size
            + flops.conv(c, 1, 1, size))


def flops_train_step(arch, size):
    return 3 * flops_forward(arch, size) - flops.conv(arch["in_channels"], arch["features"], 1,
                                                      size)
'''


class ToyMixer(nn.Module):
    """The program's side of the toy family, registered as ``toy_mixer``."""

    def __init__(self, in_channels=5, features=8, hidden=16):
        super().__init__()
        self.in_channels = in_channels
        self.proj = nn.Conv2d(in_channels, features, 1)
        self.norm = nn.LayerNorm(features)
        self.fc1 = nn.Linear(features, hidden)
        self.fc2 = nn.Linear(hidden, features)
        self.head = nn.Conv2d(features, 1, 1)

    def forward(self, x):
        t = self.proj(x).permute(0, 2, 3, 1)
        t = t + self.fc2(F.gelu(self.fc1(self.norm(t))))
        return self.head(t.permute(0, 3, 1, 2)) + x[:, 0:1]


def test_a_model_family_added_as_files_is_found_without_an_edit(tmp_path, monkeypatch):
    """A new family file, a configuration of it, and a serve and a train
    cell of it, each a new file in a copy of the folder: both cells run
    through the harness on the CPU (set-up, a one-second window, the check)
    and come back correct, and no file that was there changed."""
    from superresolution_for_pdes_tpu_torch.models import registry

    monkeypatch.setitem(registry._REGISTRY, "toy_mixer", ToyMixer)
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = sorted(p.relative_to(copy) for p in copy.rglob("*") if p.is_file())
    (copy / "families" / "toy_mixer.py").write_text(TOY_FAMILY)
    config = json.loads((copy / "configs" / "champion_unet.json").read_text())
    config.update(name="toy_mixer_tiny", source="a toy", reduced=[])
    config["architecture"] = {"family": "toy_mixer", "in_channels": 5, "features": 8,
                              "hidden": 16, "norm": "layer", "parameters": 353}
    (copy / "configs" / "toy_mixer_tiny.json").write_text(json.dumps(config))
    limits = {"serve_scene": {"field_err": 3e-4},
              "train_b32": {"loss_gap": 6e-6, "grad_gap": 0.06, "change_gap": 0.1}}
    for traffic, limit in limits.items():
        (copy / "workloads" / f"toy_{traffic}.json").write_text(json.dumps(
            {"config": "toy_mixer_tiny", "traffic": traffic, "chips": 1, "why": "a toy",
             "limits": limit}))
    cpu = torch.device("cpu")
    for traffic in limits:
        cell = tiny_cell(f"toy_{traffic}", copy)
        assert cell.family.__file__ == str(copy / "families" / "toy_mixer.py")
        result = harness.run(cell, 2 ** 37 + 9, 1.0, False, 0.0, cpu, benchmark=BENCH)
        assert result["correct"], result["checks"]
        assert set(result["checks"]) == set(limits[traffic])

    family = harness.load_cell("toy_serve_scene", base=copy).family
    arch = config["architecture"]
    model = ToyMixer(5, 8, 16)
    assert sum(p.numel() for p in model.parameters()) == arch["parameters"] == sum(
        _numel(s) for _, s, kind in family.layout(arch) if kind in family.TRAINABLE)
    x = torch.randn(3, 5, 24, 24)
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            model(x)
    assert counter.get_total_flops() == 3 * family.flops_forward(arch, 24)
    with FlopCounterMode(display=False) as counter:
        model(x).sum().backward()
    assert counter.get_total_flops() == 3 * family.flops_train_step(arch, 24)

    after = {p.relative_to(copy) for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert set(before) <= after
    for rel in before:  # no file that was there changed
        assert (copy / rel).read_bytes() == (harness.HERE / rel).read_bytes()
