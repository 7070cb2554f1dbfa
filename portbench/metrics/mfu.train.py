"""The train steps' model FLOPs (the model family's ``flops_train_step``:
forward and backward of every sample of a batch) over the traced window's
wall time and the card's peak in the configuration's precision, in %."""

from portbench.peaks import FLOPS_PER_S

LAYER = "whole step"


def read(r):
    if r.unit != "step":
        return None
    train = r.config["train"]
    per_step = train["batch_size"] * r.family.flops_train_step(r.config["architecture"],
                                                                 train["size"])
    return 100.0 * per_step * r.units / (r.trace.window_s * FLOPS_PER_S[r.config["precision"]])
