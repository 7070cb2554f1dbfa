"""Plain-PyTorch pieces that the model families' references share
(``portbench/families/<family>.py``): the layout entries of a convolution
and of a BatchNorm, and their functional forward calls, NCHW, float32, on a
flat dict of tensors.

A layout is ``[(key, shape, kind)]``. Its keys follow the checkpoint
namespace the program reads (``enc1.conv1.weight``, ``bridge.1.running_mean``,
...), so the benchmark hands one dict of weights it made itself to both
sides; its kinds say how ``portbench/weights.py`` draws each tensor and
which are parameters.

BatchNorm is ``F.batch_norm`` with the running statistics in evaluation
mode and the batch statistics (biased variance) in training mode; the
running averages are not updated, since no compared number reads them.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Layout = List[Tuple[str, tuple, str]]

BN_EPS = 1e-5


def conv_entries(name: str, cin: int, cout: int, k: int) -> Layout:
    return [(f"{name}.weight", (cout, cin, k, k), "conv"), (f"{name}.bias", (cout,), "bias")]


def bn_entries(name: str, c: int) -> Layout:
    return [(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "running_mean"),
            (f"{name}.running_var", (c,), "running_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def conv(p: Params, name: str, x: torch.Tensor, padding: int = 1,
         dilation: int = 1) -> torch.Tensor:
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], padding=padding,
                    dilation=dilation)


def batch_norm(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"], p[f"{name}.bias"], True, 0.0,
                            BN_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, BN_EPS)
