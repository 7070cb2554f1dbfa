"""What the benchmark runs imports neither JAX nor the JAX package (top-level
module names compared whole: the port's name begins with the JAX package's),
the reference and the model families' files import nothing of the program,
and ``run.py`` never falls back to the CPU."""

import ast
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from portbench import harness

_PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench import harness, repeat, trace, flops, inputs, weights, peaks
here = Path({here!r})
for folder in ("drivers", "metrics", "families"):
    for path in sorted((here / folder).glob("*.py")):
        harness.load_module(path)
for cell in ("champion_serve_scene", "champion_train_b32"):
    harness.load_cell(cell)
import superresolution_for_pdes_tpu_torch.cascade.upscale
import superresolution_for_pdes_tpu_torch.deploy
import superresolution_for_pdes_tpu_torch.train.loop
print(",".join(harness.forbidden_modules()))
"""


def test_nothing_the_benchmark_runs_imports_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                                              here=str(harness.HERE))],
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "superresolution_for_pdes_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "superresolution_for_pdes_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "superresolution_for_pdes_tpu.ops", object())
    assert "superresolution_for_pdes_tpu" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module == "portbench":
            yield from (f"portbench.{a.name}" for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py"))
                         + sorted((ROOT / "portbench" / "families").glob("*.py")),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "functools", "typing", "numpy", "torch", "portbench"}, tops
    inner = {name for name in _imports(path) if name.startswith("portbench")}
    # a family's FLOPs take their pieces from portbench.flops, which imports nothing
    assert all(name.startswith("portbench.reference") or name == "portbench.flops"
               for name in inner), inner


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would use it")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "champion_serve_scene", "--seed", str(2 ** 33 + 1), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
