"""Share of its roofline that Restormer's transposed attention reaches in a
served scene: the least time of its work (``bound_s`` of the bytes and
operations the model family's ``transposed_attention_work`` counts, level by
level over every tile of the cascade, as ``flops.served_scene`` walks them)
over the device time of its kernels (``transposed_attention_ms_per_scene``),
in %. A program or family without them gives nothing to read."""

from pathlib import Path

from portbench import flops
from portbench.harness import load_module
from portbench.peaks import bound_s

LAYER = "transposed attention (models/restormer.py)"
_TIME = load_module(Path(__file__).with_name("transposed_attention_ms_per_scene.py"))


def read(r):
    work = getattr(r.family, "transposed_attention_work", None)
    if r.unit != "scene" or work is None:
        return None
    ms = _TIME.read(r)
    if ms is None:
        return None
    arch = r.config["architecture"]
    least = sum(bound_s(*work(arch, n, size), r.config["precision"])
                for n, size in flops.cascade_tiles(r.traffic["start"], r.traffic["target"],
                                                   r.config["serve"]["coarse_tile"]))
    return 100.0 * least / (ms * 1e-3)
