"""Reference ``.pth`` checkpoints (port of ``models/torch_import.py``).

The reference saves ``torch.save`` dicts with a ``model_state_dict`` entry, or
a raw state_dict. Its key names are the port's ``AttentionUNet`` attribute
names (``enc{1..3}.conv{1,2}``, ``bridge.{0,1,3,4}``,
``att{k}.channel_attention.{1,3}``, ``out_conv{i}``, ``final``, ...), so the
state_dict loads as it is: nothing is transposed or renamed.
"""

from __future__ import annotations

from typing import Dict

import torch


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference ``.pth`` (raw, or wrapped in
    ``{"model_state_dict": ...}``), on the CPU, with a zero
    ``num_batches_tracked`` beside every BatchNorm that lacks one. The file
    comes from outside, so it is read with ``weights_only=True`` (tensors,
    numbers, strings and containers of them: what the reference saves)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: v.detach() for k, v in sd.items()}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd.setdefault(key[: -len("running_mean")] + "num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    return sd
