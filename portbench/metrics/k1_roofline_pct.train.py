"""Share of its roofline that the physics loss on K1 reaches in a train
step: the least time of the loss's forward and backward (``bound_s`` of their
bytes and operations) over the summed device time of the kernels that do
them, in %.

Counted per step of ``B`` samples of ``n x n``: the forward reads the
prediction, theta and f and the statistics (per sample, or three numbers)
and writes the backward's seed and the loss; the backward reads the seed,
u's std and the incoming gradient and writes the prediction's gradient:
each byte once, 4 bytes a float32. Operations: 15 a point forward, 8
backward."""

from portbench.peaks import bound_s

LAYER = "physics loss K1 (physics/loss.py, csrc/stencil.cu)"
KERNELS = ("pde_loss_forward", "pde_loss_backward")


def step_work(batch: int, n: int, per_sample: bool) -> tuple[float, float]:
    """``(bytes, operations)`` of one step's loss forward and backward."""
    points, stats = batch * n * n, batch if per_sample else 1
    forward = 4 * (3 * points + 3 * stats + points + 1)
    backward = 4 * (points + stats + 1 + points)
    return forward + backward, (15 + 8) * points


def read(r):
    train = r.config["train"]
    if r.unit != "step" or train["physics_weight"] <= 0:
        return None
    spent = r.trace.device_seconds(lambda a: any(k in a.name for k in KERNELS))
    if spent <= 0:
        return None
    nbytes, ops = step_work(train["batch_size"], train["size"],
                            train["normalization"] == "per_sample")
    return 100.0 * r.units * bound_s(nbytes, ops, r.config["precision"]) / spent
