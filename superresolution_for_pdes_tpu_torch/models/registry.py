"""Model registry: name -> architecture builder (port of ``models/registry.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from superresolution_for_pdes_tpu_torch.models.unet import AttentionUNet


def _wide_unet(**kw):
    """1.5x-width attention U-Net (~17M parameters)."""
    kw.setdefault("enc_features", (96, 192, 384))
    kw.setdefault("bridge_features", 768)
    kw.setdefault("head_features", (48, 24))
    return AttentionUNet(**kw)


_REGISTRY: Dict[str, Callable[..., Any]] = {
    "attention_unet": AttentionUNet,
    "attention_unet_wide": _wide_unet,
}

# names of the JAX package's registry that the port does not build yet
NOT_PORTED = ("resnet",)


def build_model(name: str, **overrides):
    """Build a model on the CPU; move it with ``.to(device)``."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (see ROADMAP.md, Queue 1)")
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {', '.join(_REGISTRY)}") from None
    return builder(**overrides)
