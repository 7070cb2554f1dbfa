"""The control of each cell fails its comparison on the card: the plain
reference in TF32, put in the program's place, reads above the cell's limit
on at least one number. At a size a test run holds: full widths, a 160^2
target and two scenes for serving, batches of 8 for training."""

import pytest

from portbench import control, harness

pytestmark = pytest.mark.cuda


def _small(name):
    cell = harness.load_cell(name)
    traffic = dict(cell.traffic)
    config = {**cell.config}
    if cell.driver.UNIT == "scene":
        traffic.update(target=160, pool_scenes=2, check_requests=2)
    else:
        config["train"] = {**config["train"], "batch_size": 8}
    return harness.Cell(name, config, traffic, cell.spec, cell.driver, cell.family)


@pytest.mark.parametrize("name", ["champion_serve_scene", "champion_serve_refine2",
                                  "champion_train_b32", "resnet_train_b32"])
def test_the_control_is_not_correct(name, card):
    cell = _small(name)
    readings = control.readings(cell, 2 ** 36 + 5, card)
    tf32 = readings["tf32"]
    assert any(tf32[k] > cell.limits[k] for k in cell.limits), (tf32, cell.limits)
    if "half_batch" in readings:
        half = readings["half_batch"]
        assert any(half[k] > cell.limits[k] for k in cell.limits), (half, cell.limits)
