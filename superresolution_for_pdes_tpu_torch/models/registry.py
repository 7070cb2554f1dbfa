"""Model registry: name -> architecture builder (port of ``models/registry.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from superresolution_for_pdes_tpu_torch.models.resnet import PDEResNet
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
    "resnet": PDEResNet,
}


def available_models() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def build_model(name: str, **overrides):
    """Build a model on the CPU; move it with ``.to(device)``."""
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {', '.join(_REGISTRY)}") from None
    return builder(**overrides)
