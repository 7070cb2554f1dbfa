"""Flax ``{params, batch_stats}`` -> port ``state_dict`` (the weight carrier),
for the attention U-Net and the residual CNN.

The inverse of the JAX package's ``models/torch_import.py``: conv kernels go
from HWIO to OIHW; BatchNorm ``scale``/``bias`` become ``weight``/``bias`` and
``mean``/``var`` become ``running_mean``/``running_var``; GroupNorm carries
``weight``/``bias`` only. Input leaves are numpy arrays (or anything
``np.asarray`` takes); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CONV_BLOCKS = ("enc1", "enc2", "enc3", "dec1", "dec2", "dec3")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(out: Dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{name}.bias"] = _tensor(p["bias"])


def _norm(out: Dict, name: str, p: Mapping, stats: Mapping | None) -> None:
    out[f"{name}.weight"] = _tensor(p["scale"])
    out[f"{name}.bias"] = _tensor(p["bias"])
    if stats is not None:  # BatchNorm; GroupNorm has no running statistics
        out[f"{name}.running_mean"] = _tensor(stats["mean"])
        out[f"{name}.running_var"] = _tensor(stats["var"])
        out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert Flax ``{params, batch_stats}`` of an ``AttentionUNet`` or a
    ``PDEResNet`` (a tree with a ``stem``; batch or group norm) into a
    state_dict for the port's model of the same name."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}

    def st(*path):
        node = stats
        for key in path:
            if key not in node:
                return None
            node = node[key]
        return node

    sd: Dict[str, torch.Tensor] = {}
    if "stem" in params:
        _conv(sd, "stem", params["stem"])
        i = 1
        while f"block{i}" in params:
            for j in (1, 2):
                name = f"block{i}"
                _conv(sd, f"{name}.conv{j}", params[name][f"conv{j}"])
                _norm(sd, f"{name}.bn{j}", params[name][f"bn{j}"], st(name, f"bn{j}"))
            i += 1
        _conv(sd, "head", params["head"])
        return sd
    for block in _CONV_BLOCKS:
        for i in (1, 2):
            _conv(sd, f"{block}.conv{i}", params[block][f"conv{i}"])
            _norm(sd, f"{block}.bn{i}", params[block][f"bn{i}"], st(block, f"bn{i}"))
    for i, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4)), start=1):
        _conv(sd, f"bridge.{conv_idx}", params[f"bridge_conv{i}"])
        _norm(sd, f"bridge.{bn_idx}", params[f"bridge_bn{i}"], st(f"bridge_bn{i}"))
    for k in (1, 2, 3):
        gate = params[f"att{k}"]
        _conv(sd, f"att{k}.channel_attention.1", gate["ca_squeeze"])
        _conv(sd, f"att{k}.channel_attention.3", gate["ca_excite"])
        _conv(sd, f"att{k}.spatial_attention.0", gate["sa_conv"])
    i = 1
    while f"out_conv{i}" in params:
        _conv(sd, f"out_conv{i}", params[f"out_conv{i}"])
        _norm(sd, f"out_bn{i}", params[f"out_bn{i}"], st(f"out_bn{i}"))
        i += 1
    _conv(sd, "final", params["final"])
    return sd
