"""Model registry: name -> architecture builder (port of ``models/registry.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from superresolution_for_pdes_tpu_torch.models.hat import HAT
from superresolution_for_pdes_tpu_torch.models.resnet import PDEResNet
from superresolution_for_pdes_tpu_torch.models.restormer import Restormer
from superresolution_for_pdes_tpu_torch.models.swinir import SwinIR
from superresolution_for_pdes_tpu_torch.models.unet import AttentionUNet


def _wide_unet(**kw):
    """1.5x-width attention U-Net (~17M parameters)."""
    kw.setdefault("enc_features", (96, 192, 384))
    kw.setdefault("bridge_features", 768)
    kw.setdefault("head_features", (48, 24))
    return AttentionUNet(**kw)


def _layer_normed(name: str, cls):
    """``cls``'s builder: it normalises with LayerNorm only, so a ``norm``
    choice (``train --model_norm``) has nothing to apply to."""

    def build(norm=None, **kw):
        if norm is not None:
            raise ValueError(f"{name} has no BatchNorm to replace with norm={norm!r}: "
                             "it normalises with LayerNorm; leave --model_norm at batch")
        return cls(**kw)

    build.__doc__ = f"{cls.__name__} (``{cls.__module__}``); LayerNorm only."
    return build


_REGISTRY: Dict[str, Callable[..., Any]] = {
    "attention_unet": AttentionUNet,
    "attention_unet_wide": _wide_unet,
    "resnet": PDEResNet,
    "swinir": _layer_normed("swinir", SwinIR),
    "hat": _layer_normed("hat", HAT),
    "restormer": _layer_normed("restormer", Restormer),
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
