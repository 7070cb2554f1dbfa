"""Multi-process parallelism (port of ``parallel/``): process groups and
device meshes over them, data-parallel training, and the online train step
that generates its own data.

The JAX package shards one program over a mesh of devices (GSPMD). The port
runs one process per card, launched by ``torchrun``
(``python -m torch.distributed.run``), joined by
:func:`initialize_multihost`; :func:`data_mesh` and :func:`grid_mesh` are
``DeviceMesh``es over the ranks, and ``train_model(mesh=...)`` trains
data-parallel over a 1-D one (:mod:`.data`). Without a process group the
world is one process.
"""

from superresolution_for_pdes_tpu_torch.parallel.mesh import (  # noqa: F401
    data_mesh,
    device_count,
    grid_mesh,
)
from superresolution_for_pdes_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
)
from superresolution_for_pdes_tpu_torch.parallel.online import (  # noqa: F401
    calibration_stats,
    make_online_train_step,
)
