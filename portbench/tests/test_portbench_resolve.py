"""Everything ``BENCHMARK.json`` names resolves by name to files of its own,
and a cell, a configuration, a traffic mix or a metric is added by adding
files alone."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench import harness
from portbench.reference.models import layout

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
    count = sum(_numel(s) for _, s, kind in layout(arch)
                if kind in ("conv", "bias", "bn_weight", "bn_bias"))
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
