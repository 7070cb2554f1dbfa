"""PyTorch/CUDA port of :mod:`superresolution_for_pdes_tpu`.

Module names mirror the JAX package (``ops/``, ``solver/``, ``data/``,
``models/``, ``cascade/``, ``deploy.py``, ``eval/``, ``cli/``, ``train/``,
``parallel/``, ``utils/``, ``native/``), so the
counterpart of every ported function sits at the same relative path. This
package imports torch and numpy only; it never imports JAX or the JAX
package.

Entry points that create tensors (``deploy.load_bundle``/``run_bundle``,
``cascade.multires.solve_multi_resolution``, the data generators seeded with
an int, ``data.io.load_dataset``, ``train.train_model`` and the
``generate_data``, ``train`` and ``upscale`` CLIs) take a ``device``
argument. It defaults to ``cuda``; without a card they raise instead of
running on the CPU, so a CPU run is always asked for explicitly
(``device="cpu"``). Functions on tensors run on the device of their inputs.

The 5-point stencil kernels of the physics loss (K1) and of the multigrid
finest level (K2, K3) are hand-written CUDA C++ (``csrc/stencil.cu``), built
with ``nvcc`` at their first call on a CUDA tensor (:mod:`.ops._build`); on
CPU tensors their plain PyTorch twins run instead.
"""

from superresolution_for_pdes_tpu_torch.device import resolve_device  # noqa: F401
