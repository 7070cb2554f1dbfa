"""Share of their roofline that the V-cycle's stencil kernels reach on the
refined cascade: the least time of the work they do (``bound_s`` of its
bytes and operations) over their summed device time, in %.

The work counted is the operation, whatever kernel implements it: per
refined level whose finest grid the kernels serve (n >= the configuration's
``kernel_min_n``) and per V-cycle, the pre-smooth with its residual (``pre``
sweeps; reads u and b, writes u and r: 16 bytes a point) and the post-smooth
(``post`` sweeps; reads u and b, writes u: 12 bytes), each input read once and
each output written once. Operations: 9 a point per sweep, 7 for the
residual."""

from portbench.peaks import bound_s

LAYER = "stencil kernels K2/K3/fused (csrc/stencil.cu)"
KERNELS = ("jacobi_kernel", "smooth_residual_kernel")


def scene_work(refine: dict, cycles: int, start: int, target: int) -> tuple[float, float]:
    """``(bytes, operations)`` of one scene's V-cycle stencil work."""
    points, res = 0, start * 2
    while res <= target:
        if res >= refine["kernel_min_n"]:
            points += res * res
        res *= 2
    per_point_bytes = 16 + 12
    per_point_ops = 9 * refine["pre_sweeps"] + 7 + 9 * refine["post_sweeps"]
    return cycles * points * per_point_bytes, cycles * points * per_point_ops


def read(r):
    cycles = r.traffic.get("refine_cycles", 0)
    if r.unit != "scene" or cycles == 0:
        return None
    spent = r.trace.device_seconds(lambda a: any(k in a.name for k in KERNELS))
    if spent <= 0:
        return None
    nbytes, ops = scene_work(r.config["serve"]["refine"], cycles, r.traffic["start"],
                             r.traffic["target"])
    least = r.units * bound_s(nbytes, ops, r.config["precision"])
    return 100.0 * least / spent
