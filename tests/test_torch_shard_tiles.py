"""PyTorch port, ``--shard_tiles``: the tile batch of every model call split
into contiguous parts over a list of devices (``cascade.upscale.TileSplit``),
against the unsplit call, for the cascade and the resolution sweep.

On the CPU the devices are ``cpu`` (the fields' own: the part runs the given
weights) and ``cpu:1`` (another name of the same memory: the part runs a
replica, as a second card would). oneDNN picks convolution kernels by batch
size, so a part's tiles are not bit-identical to the same tiles in one call:
fields agree within 1e-5 of max|field| (as scene chunks do); a split of one
part is the unsplit call, bit for bit."""

import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu_torch.cascade.multires import solve_multi_resolution_batch
from superresolution_for_pdes_tpu_torch.cascade.upscale import TileSplit, ml_cascade
from superresolution_for_pdes_tpu_torch.eval import resolution
from superresolution_for_pdes_tpu_torch.models import AttentionUNet

from torch_port_helpers import TINY

SPLIT_REL = 1e-5
SCHEDULE = dict(stats_mode="tile", coarse_tile=(20, 40))


def _experts(n=2):
    model = AttentionUNet(in_channels=5, **TINY, generator=torch.Generator().manual_seed(0))
    sds = [AttentionUNet(in_channels=5, **TINY,
                         generator=torch.Generator().manual_seed(1 + i)).state_dict()
           for i in range(n)]
    return model, sds


@pytest.fixture(scope="module")
def scenes():
    return solve_multi_resolution_batch(3, 2, resolutions=(80, 160), k_range=(8.0, 12.0),
                                        device="cpu")


def _close(ours, ref, what):
    err = float((ours - ref).abs().max())
    assert err <= SPLIT_REL * float(ref.abs().max()), f"{what}: {err:.3e}"


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("weights", ["per-level", "module"])
def test_split_cascade_matches_one_call(scenes, symmetrize, weights):
    model, sds = _experts()
    variables = sds if weights == "per-level" else None
    kw = dict(symmetrize=symmetrize, **SCHEDULE)
    ref = ml_cascade(model, variables, scenes, 160, **kw)
    one = ml_cascade(model, variables, scenes, 160, tile_devices=["cpu"], **kw)
    split = TileSplit(["cpu", "cpu:1"])
    two = ml_cascade(model, variables, scenes, 160, tile_devices=split, **kw)
    for res in (80, 160):
        assert torch.equal(one[res], ref[res]), res  # one part: the unsplit call
        _close(two[res], ref[res], f"{res}")
    # one replica per expert and device, made once and kept
    assert len(split._replicas) == (2 if weights == "per-level" else 1)
    assert all(p.device.type == "cpu" for r in split._replicas.values()
               for p in r[0].parameters())


def test_split_resolution_sweep_matches_unsplit(scenes):
    model, sds = _experts()
    scene = {k: {r: v[0] for r, v in scenes[k].items()} for k in ("u", "f", "theta")}
    scene.update(k1=scenes["k1"][0], k2=scenes["k2"][0])
    kw = dict(scene=scene, resolutions=(80, 160), refine_cycles=1, **SCHEDULE)
    ref = resolution.run_resolution_sweep(model, sds, **kw)
    two = resolution.run_resolution_sweep(model, sds, tile_devices=["cpu", "cpu:1"], **kw)
    one = resolution.run_resolution_sweep(model, sds, tile_devices=["cpu"], **kw)
    assert one["metrics"] == ref["metrics"]
    for name, by_res in ref["solutions"].items():
        for res in (80, 160):
            assert torch.equal(one["solutions"][name][res], by_res[res])
            _close(two["solutions"][name][res], by_res[res], f"{name} {res}")
            for metric, value in ref["metrics"][name][res].items():
                assert two["metrics"][name][res][metric] == pytest.approx(value, rel=1e-4)
    assert np.isfinite(two["metrics"]["ml_physics"][160]["mae"])


def test_tile_split_needs_a_device():
    with pytest.raises(ValueError, match="at least one device"):
        TileSplit([])
