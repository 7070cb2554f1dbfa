"""The benchmark's counters of operations and bytes: the model families'
FLOP counts against ``torch.utils.flop_counter`` on the program's models at
the cells' shapes (counted on the meta device), and the byte counters
against the sizes the port's kernel records give."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, harness
from portbench.drivers.train_steps import build_model

UNET = harness.load_cell("champion_serve_scene")
RESNET = harness.load_cell("resnet_train_b32")


def _counted(model, x, backward: bool) -> int:
    with FlopCounterMode(display=False) as counter:
        if backward:
            model(x).sum().backward()
        else:
            with torch.no_grad():
                model(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("size", [80, 160])
def test_unet_forward_flops_match_flop_counter(size):
    arch = UNET.config["architecture"]
    with torch.device("meta"):
        model = build_model(UNET.family, arch).eval()
        x = torch.empty(3, arch["in_channels"], size, size)
    assert 3 * UNET.family.flops_forward(arch, size) == _counted(model, x, backward=False)


def test_served_scene_is_931_6_gflop():
    serve = UNET.config["serve"]
    total = flops.served_scene(UNET.family, UNET.config["architecture"], 40, 640,
                               serve["coarse_tile"])
    assert flops.cascade_tiles(40, 640, serve["coarse_tile"]) == [(1, 80), (1, 160), (4, 160),
                                                                  (16, 160)]
    assert total == pytest.approx(931.6e9, rel=1e-4)


@pytest.mark.parametrize("cell, per_sample", [(UNET, 8.06e9), (RESNET, 5.67e9)])
def test_train_step_flops_match_flop_counter(cell, per_sample):
    arch, size = cell.config["architecture"], cell.config["train"]["size"]
    with torch.device("meta"):
        model = build_model(cell.family, arch).train()
        x = torch.empty(4, arch["in_channels"], size, size)
    assert 4 * cell.family.flops_train_step(arch, size) == _counted(model, x, backward=True)
    assert cell.family.flops_train_step(arch, size) == pytest.approx(per_sample, rel=1e-3)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_k1_loss_bytes_match_the_kernel_records():
    nbytes, ops = _reader("k1_roofline_pct.train").step_work(32, 40, per_sample=True)
    # the loss forward 819 KB, its backward 410 KB at (32, 40^2)
    forward = 4 * 32 * 1600 * 4 + 4 * 3 * 32 + 4
    assert forward == pytest.approx(819e3, rel=1e-3)
    assert nbytes - forward == pytest.approx(410e3, rel=1e-3)
    assert ops == 23 * 32 * 1600


def test_stencil_bytes_match_the_kernel_records():
    work = _reader("stencil_roofline_pct.refine").scene_work
    refine = UNET.config["serve"]["refine"]
    one_cycle_640, _ = work({**refine, "kernel_min_n": 640}, 1, 320, 640)
    # K3 4.9 MB and the fused pre-smooth and residual 6.6 MB at (1, 640^2)
    assert one_cycle_640 == pytest.approx(4.9e6 + 6.6e6, rel=0.01)
    nbytes, _ = work(refine, 2, 40, 640)
    assert nbytes == 2 * 28 * (160 ** 2 + 320 ** 2 + 640 ** 2)
