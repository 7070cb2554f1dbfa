"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when ``cuda`` is asked for (explicitly or by default) and no card is
    present: the port never falls back to the CPU on its own. For a card it
    turns TF32 off for matmuls and for cuDNN's convolutions: the port's parity
    limits against the JAX package hold in float32 (PERF.md section 2).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
