"""Host milliseconds inside the program's ``cascade.refine`` spans (the
Galerkin V-cycles of every level) per served scene, in the device-only window."""

from portbench.metrics._spans import host_ms_per_unit

LAYER = "refinement (solver/multigrid.py)"


def read(r):
    if r.unit != "scene":
        return None
    return host_ms_per_unit(r, "cascade.refine")
