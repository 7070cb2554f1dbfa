"""The model families' files give the numbers the benchmark gave before
they were split out of shared modules: the weights drawn from a seed, bit
for bit, and the FLOP counts. The digests and counts were recorded from the
code before the split (seed 11, the CPU, TINY widths for the weights, full
widths for the FLOPs)."""

import copy
import hashlib

import pytest
import torch

from portbench import flops, harness, weights

CELL = {"champion_unet": "champion_serve_scene", "round1_resnet": "resnet_train_b32"}
DIGESTS = {
    ("champion_unet", 0): "7a086022b96fc03d21034770a479356031d6d9c3a12c33d178fc374a1b60a856",
    ("champion_unet", 3): "432cf1d821df69beb4f70283abe5be73f4c62ce1592d8a6a3b4ae1b7b4a724e8",
    ("round1_resnet", 0): "bec907fd5a6f863ac3930c90000958b67f806ae82093babbdd409ab6d3100c20",
    ("round1_resnet", 3): "5cb3c50b501e687499df31c4dfbc496065bc8ccd94d34b639ba2ec461f48b15c",
}
# (forward, train step) of one sample at 40^2, 80^2 and 160^2, and a served
# scene 40^2 -> 640^2 with coarse tiles 40/80/80
FLOPS = {
    "champion_unet": ({40: (2694340608, 8058445824), 80: (10838673408, 32356276224),
                       160: (43846084608, 130407757824)}, 931606450176),
    "round1_resnet": ({40: (1893171200, 5673984000), 80: (7572684800, 22695936000),
                       160: (30290739200, 90783744000)}, 643678208000),
}


def _digest(state):
    h = hashlib.sha256()
    for key, v in state.items():
        v = v.detach().contiguous()
        h.update(f"{key}|{v.dtype}|{tuple(v.shape)}|".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config, tag", sorted(DIGESTS))
def test_weights_are_the_same_bits(config, tag):
    cell = harness.load_cell(CELL[config])
    arch = copy.deepcopy(cell.config["architecture"])
    arch.update(cell.family.TINY)
    state = weights.make_state_dict(cell.family, arch, 11, torch.device("cpu"), tag=tag)
    assert _digest(state) == DIGESTS[(config, tag)]


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_flop_counts_are_unchanged(config):
    cell = harness.load_cell(CELL[config])
    arch = cell.config["architecture"]
    per_size, scene = FLOPS[config]
    for size, (forward, step) in per_size.items():
        assert cell.family.flops_forward(arch, size) == forward
        assert cell.family.flops_train_step(arch, size) == step
    assert flops.served_scene(cell.family, arch, 40, 640, [40, 80, 80]) == scene
