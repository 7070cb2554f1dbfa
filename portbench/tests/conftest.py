"""Tests of the port's benchmark. Run from the root of the repository:

    python -m pytest -q portbench/tests

Tests marked ``cuda`` need an NVIDIA card and skip without one; whether a
card is present is decided inside the ``card`` fixture, never at import.
Everything else runs on the CPU at TINY sizes.
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control readings are taken on the card")
    return torch.device("cuda", 0)


def tiny_cell(name: str, base=None):
    """The cell ``name`` at TINY widths (its model family's ``TINY``) and
    sizes: the same configuration keys and traffic, a 160^2 target, a few
    scenes and samples."""
    from portbench import harness

    cell = harness.load_cell(name, base) if base else harness.load_cell(name)
    config = copy.deepcopy(cell.config)
    config["architecture"].update(cell.family.TINY)
    if "train" in config:
        config["train"]["batch_size"] = 8
        data = config["train"]["data"]
        data.update(n_standard=16, n_subdomain=16)
        if data.get("cascade_scenes"):
            data.update(cascade_scenes=4, cascade_finest=160)
    traffic = dict(cell.traffic)
    if traffic["driver"] == "serve_cascade":
        traffic.update(target=160, pool_scenes=4, check_requests=3, warmup_requests=1)
    else:
        traffic.update(rows_per_call=2)
    return harness.Cell(name, config, traffic, cell.spec, cell.driver, cell.family)


@pytest.fixture
def tiny():
    return tiny_cell
