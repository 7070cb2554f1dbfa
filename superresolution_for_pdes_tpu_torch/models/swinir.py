"""SwinIR, a shifted-window transformer for image restoration (Liang et al.,
"SwinIR: Image Restoration Using Swin Transformer", arXiv:2108.10257; the
upstream ``models/network_swinir.py``), as a same-resolution refiner, NCHW.

The upstream model with ``upscale=1``, ``upsampler=''`` (its denoising
head), ``resi_connection='1conv'``, ``ape=False`` and ``patch_norm=True``:

* ``conv_first``: 3x3 convolution from ``in_channels`` to ``embed_dim``;
* tokens: the feature map flattened, then ``patch_embed.norm`` (LayerNorm);
* ``layers``: residual groups (``len(depths)``), each ``t + embed(conv3x3(
  unembed(blocks(t))))`` over ``depths[i]`` Swin blocks;
* ``norm`` (LayerNorm), then ``conv_after_body(unembed(t)) + x0``;
* ``conv_last``: 3x3 convolution to one channel, plus input channel 0.

A Swin block is ``t + proj(WMSA(norm1(t)))`` then ``t + fc2(GELU(fc1(norm2(t))))``;
odd blocks roll the map by ``-window_size // 2`` before cutting it into
``window_size``-square windows and roll it back after. The window attention
(WMSA) adds the learned relative-position bias ``table[index]`` to the logits
(``index = (dh + ws - 1)(2 ws - 1) + (dw + ws - 1)``) and, on shifted blocks,
upstream's region mask (-100 between tokens of different regions of the
3x3 slicing by ``(-ws, -shift)``). Inputs are reflect-padded to a multiple of
the window and the output cropped, as upstream's ``check_image_size``.

Departures from upstream:

* 5 inputs (``in_channels``) and 1 output with the input-channel-0 residual:
  upstream's ``x + conv_last(res)`` restricted to the predicted channel;
* no mean subtraction (upstream's is zero for ``img_range=1`` and
  ``in_chans != 3``);
* ``drop_path`` 0 (upstream trains with 0.1): stochastic depth would make a
  step impossible to compare with a reference;
* initialisation: linear weights and the bias table truncated normal (std
  0.02, bounds +-2 as upstream's ``trunc_normal_``), linear biases 0,
  LayerNorm (1, 0); convolutions by :func:`~.unet.init_weights`;
* the attention acts on the map in token layout
  (``ops/window_attention.py``): the qkv linear runs on the map as it is, a
  window's tokens are read at their places in the map rolled by ``-shift``,
  the relative-position bias and the region mask come from the tokens'
  places, and the attended tokens are written back to the same places, where
  the proj linear reads them; so no roll, window partition or reverse is a
  tensor of its own, and neither are the relative index and the region masks
  (upstream stores both as buffers, at its training size): the ``state_dict``
  holds learned tensors only, under upstream's keys. On CUDA it is a
  hand-written CUDA kernel pair (``csrc/window_attention.cu``) in float32
  whose heads keep their size 30, built for the published widths (window 8,
  heads of 30) and the tests' TINY ones (window 4, heads of 6), and the
  tiled kernels beside it for HAT's window 16 with heads of 30
  (``models/hat.py``, which reuses these modules); bfloat16 under autocast is
  widened to them, and other widths raise. On the CPU a plain PyTorch twin
  of the same arithmetic.

The linears and LayerNorms of the Swin blocks and the tokens (:class:`Linear`,
:class:`LayerNorm`) are ``nn.Linear`` and ``nn.LayerNorm`` with the same
forward, state and input and weight gradients, whose bias (and LayerNorm
weight) gradients are column sums over the tokens by ``ops/token_reduce.py``:
on CUDA a hand-written reduction (``csrc/token_reduce.cu``), on the CPU its
plain twin.

Parameter count at the published widths (180, 6x6 blocks, 6 heads, window
8, MLP ratio 2) with 5 input channels: 11,504,161.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from superresolution_for_pdes_tpu_torch.models.unet import init_weights
from superresolution_for_pdes_tpu_torch.ops import token_reduce
from superresolution_for_pdes_tpu_torch.ops.window_attention import window_attention
from superresolution_for_pdes_tpu_torch.utils.profiling import span


class Linear(nn.Linear):
    """``nn.Linear`` whose backward sums its bias gradient over the tokens by
    ``ops/token_reduce.py`` (on CUDA the hand-written kernel); the same
    forward, input and weight gradients."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return token_reduce.linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last dimension whose backward sums its
    weight and bias gradients over the tokens by ``ops/token_reduce.py``; the
    same forward and input gradient."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return token_reduce.layer_norm(x, self.weight, self.bias, self.eps)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside the windows of the map rolled by
    ``-shift``, with the relative-position bias (and, shifted, the region
    mask); takes the normalised map ``(B, Hp, Wp, C)`` and returns the
    attended map, projected, in the same places."""

    def __init__(self, dim: int, window_size: int, num_heads: int, shift: int = 0):
        super().__init__()
        self.window_size, self.num_heads, self.shift = window_size, num_heads, shift
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hp, wp, _ = x.shape
        ws, h = self.window_size, self.num_heads
        with span("swinir.attention", b * (hp // ws) * (wp // ws) * h):
            o = window_attention(self.qkv(x), self.relative_position_bias_table, h, ws,
                                 self.shift, self.scale)
            return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm window attention and MLP, each with a residual; the attention
    takes its windows from the map rolled by ``-shift``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, shift)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        b, length, c = t.shape
        t = t + self.attn(self.norm1(t).view(b, hp, wp, c)).reshape(b, length, c)
        return t + self.mlp(self.norm2(t))


class _Blocks(nn.Module):
    """Upstream's ``BasicLayer``: the blocks of a residual group."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResidualGroup(nn.Module):
    """Upstream's ``RSTB``: Swin blocks, then a 3x3 convolution on the map,
    with a skip over both."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float):
        super().__init__()
        self.residual_group = _Blocks(
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio) for i in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        x = t
        for block in self.residual_group.blocks:
            x = block(x, hp, wp)
        return t + self.conv(_unembed(x, hp, wp)).flatten(2).transpose(1, 2)


class _PatchEmbed(nn.Module):
    """Upstream's ``PatchEmbed`` with ``patch_norm``: the tokens' LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


def _unembed(t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], hp, wp)


class SwinIR(nn.Module):
    """Same-resolution SwinIR with the coarse-solution skip. Input
    ``(N, in_channels, H, W)``, output ``(N, 1, H, W)``. ``group`` builds a
    residual group from ``(dim, depth, heads, window_size, mlp_ratio)``
    (:class:`ResidualGroup`; HAT's ``models/hat.py`` passes its own)."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6, num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 generator: Optional[torch.Generator] = None,
                 group: Callable[..., nn.Module] = ResidualGroup):
        super().__init__()
        if len(depths) != len(num_heads):
            raise ValueError(f"depths {tuple(depths)} and num_heads {tuple(num_heads)} "
                             "name different numbers of groups")
        self.in_channels, self.window_size = in_channels, window_size
        self.conv_first = nn.Conv2d(in_channels, embed_dim, 3, padding=1)
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            group(embed_dim, depth, heads, window_size, mlp_ratio)
            for depth, heads in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_last = nn.Conv2d(embed_dim, 1, 3, padding=1)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                    m.bias.zero_()
                elif hasattr(m, "relative_position_bias_table"):  # a window attention's
                    nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                          generator=generator)
            init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        ws = self.window_size
        if h % ws or w % ws:
            x = F.pad(x, (0, -w % ws, 0, -h % ws), mode="reflect")
        hp, wp = x.shape[-2:]
        x0 = self.conv_first(x)
        t = self.patch_embed.norm(x0.flatten(2).transpose(1, 2))
        for layer in self.layers:
            with span("swinir.stage", t.shape[0] * t.shape[1]):
                t = layer(t, hp, wp)
        res = self.conv_after_body(_unembed(self.norm(t), hp, wp)) + x0
        return (self.conv_last(res) + x[:, 0:1])[..., :h, :w]
