"""The served scenes' model FLOPs (``portbench.flops.served_scene``: the
model family's forward over every tile of every level) over the traced
window's wall time and the card's peak in the configuration's precision, in %."""

from portbench import flops
from portbench.peaks import FLOPS_PER_S

LAYER = "whole request"


def read(r):
    if r.unit != "scene":
        return None
    serve = r.config["serve"]
    per_scene = flops.served_scene(r.family, r.config["architecture"], r.traffic["start"],
                                   r.traffic["target"], serve["coarse_tile"])
    return 100.0 * per_scene * r.units / (r.trace.window_s * FLOPS_PER_S[r.config["precision"]])
