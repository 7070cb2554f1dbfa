"""HAT, the Hybrid Attention Transformer for image restoration (Chen et al.,
"Activating More Pixels in Image Super-Resolution Transformer", CVPR 2023,
arXiv:2205.04437; the upstream ``hat/archs/hat_arch.py``), as a
same-resolution refiner, NCHW.

HAT keeps SwinIR's skeleton (``models/swinir.py``, whose modules it reuses)
and changes the block. The upstream model with ``resi_connection='1conv'``,
``ape=False`` and ``patch_norm=True``:

* ``conv_first``, the tokens' LayerNorm, ``norm``, ``conv_after_body`` and
  the head as :class:`~.swinir.SwinIR`;
* ``layers``: residual hybrid attention groups (RHAG), each ``t + embed(
  conv3x3(unembed(OCAB(HABs(t)))))``;
* a HAB (hybrid attention block) is, with ``y = norm1(t)`` as a map,
  ``t + WMSA(y) + conv_scale CAB(y)`` then ``t + fc2(GELU(fc1(norm2(t))))``:
  SwinIR's shifted-window attention (:class:`~.swinir.WindowAttention`,
  every second block shifted by half a window under the region mask) beside
  a channel-attention block (CAB: ``conv3x3(C -> C / compress_ratio)``, GELU,
  ``conv3x3(-> C)``, times ``sigmoid(conv1x1(ReLU(conv1x1(avgpool(.)))))``
  with ``C / squeeze_factor`` channels between, the pool over the whole
  padded map of each sample);
* an OCAB (overlapping cross-attention block) closes each group: ``t +
  proj(OCA(norm1(t)))`` then the MLP; OCA's queries come from the
  ``window_size``-square windows (not shifted), its keys and values from the
  ``window_size (1 + overlap_ratio)``-square windows centred on them, cut from
  the map of k and v after the qkv linear with zero padding (a key outside
  the map is a zero vector, whose logit is its bias alone), with a bias table
  of ``(window_size + key window - 1)^2`` rows indexed as upstream's
  ``calculate_rpi_oca`` and no mask (``ops/window_attention.py``:
  :func:`~superresolution_for_pdes_tpu_torch.ops.window_attention.overlapping_window_attention`).

Inputs are reflect-padded to a multiple of the window and the output
cropped, as upstream's ``check_image_size``. The ``state_dict`` holds
learned tensors only, under upstream's keys (no relative-index or mask
buffers: both are index arithmetic of the attention).

On CUDA both attentions run hand-written kernels (``csrc/window_attention.cu``:
the tiled kernels at window 16 with heads of 30 and the overlapping ones at
key window 24; TINY's window 4 runs the window-8 pair's (4, 6) instantiation
and its key window 6 the tiled one), float32 on the CUDA cores, bfloat16
under autocast widened to them; other widths raise. On the CPU their plain
twins. The linears and LayerNorms are :class:`~.swinir.Linear` and
:class:`~.swinir.LayerNorm` (their bias sums on ``csrc/token_reduce.cu``).

Departures from upstream (also the configuration's ``assumed``):

* as ``models/swinir.py``'s: 5 inputs (``in_channels``) and 1 output with the
  input-channel-0 residual, no mean subtraction, ``drop_path`` 0, and its
  initialisation (linear weights and both bias tables truncated normal, std
  0.02; LayerNorm (1, 0); convolutions by :func:`~.unet.init_weights`, the
  CAB's too);
* no pixel-shuffle upsampler: the cascade feeds an expert at its output
  resolution.

Parameter count at the published widths (180, 6x6 blocks, 6 heads, window
16, overlap 0.5, compress 3, squeeze 30, MLP ratio 2) with 5 input channels:
20,376,469.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn

from superresolution_for_pdes_tpu_torch.models.swinir import (
    LayerNorm,
    Linear,
    Mlp,
    SwinIR,
    WindowAttention,
    _Blocks,
    _unembed,
)
from superresolution_for_pdes_tpu_torch.ops.window_attention import overlapping_window_attention
from superresolution_for_pdes_tpu_torch.utils.profiling import span


class ChannelAttention(nn.Module):
    """``x * sigmoid(conv1x1(ReLU(conv1x1(avgpool(x)))))``, upstream's
    squeeze-and-excitation."""

    def __init__(self, channels: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, channels // squeeze_factor, 1),
            nn.ReLU(inplace=True), nn.Conv2d(channels // squeeze_factor, channels, 1),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


class CAB(nn.Module):
    """The channel-attention block: two 3x3 convolutions through
    ``channels / compress_ratio`` with a GELU, then :class:`ChannelAttention`."""

    def __init__(self, channels: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        mid = channels // compress_ratio
        self.cab = nn.Sequential(
            nn.Conv2d(channels, mid, 3, padding=1), nn.GELU(),
            nn.Conv2d(mid, channels, 3, padding=1), ChannelAttention(channels, squeeze_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cab(x)


class HAB(nn.Module):
    """The hybrid attention block: window attention and the CAB side by side
    on the normalised map, then the MLP; each with a residual."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 compress_ratio: int, squeeze_factor: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.conv_scale = conv_scale
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, shift)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        b, length, c = t.shape
        y = self.norm1(t).view(b, hp, wp, c)
        attn = self.attn(y).reshape(b, length, c)
        with span("hat.cab", b * length):
            # the map in token layout is NCHW in channels-last memory, as it stands
            cab = self.conv_block(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(b, length, c)
        t = t + attn + cab * self.conv_scale
        return t + self.mlp(self.norm2(t))


class OCAB(nn.Module):
    """The overlapping cross-attention block: each window's queries attend to
    the keys and values of the wider window centred on it, then the MLP; each
    with a residual."""

    def __init__(self, dim: int, num_heads: int, window_size: int, overlap_ratio: float,
                 mlp_ratio: float):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.key_window = int(window_size * overlap_ratio) + window_size
        self.scale = (dim // num_heads) ** -0.5
        self.norm1 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window_size + self.key_window - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        b, length, c = t.shape
        ws, h = self.window_size, self.num_heads
        with span("hat.ocab", b * (hp // ws) * (wp // ws) * h):
            y = self.norm1(t).view(b, hp, wp, c)
            o = overlapping_window_attention(self.qkv(y), self.relative_position_bias_table, h,
                                             ws, self.key_window, self.scale)
            t = t + self.proj(o).reshape(b, length, c)
            return t + self.mlp(self.norm2(t))


class _AttenBlocks(_Blocks):
    """Upstream's ``AttenBlocks``: a group's HABs and its OCAB."""

    def __init__(self, blocks: Sequence[nn.Module], overlap_attn: nn.Module):
        super().__init__(blocks)
        self.overlap_attn = overlap_attn


class RHAG(nn.Module):
    """Upstream's residual hybrid attention group: HABs, the OCAB, then a 3x3
    convolution on the map, with a skip over all of them."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, mlp_ratio: float,
                 overlap_ratio: float, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float):
        super().__init__()
        self.residual_group = _AttenBlocks(
            [HAB(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                 compress_ratio, squeeze_factor, conv_scale, mlp_ratio) for i in range(depth)],
            OCAB(dim, num_heads, window_size, overlap_ratio, mlp_ratio))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        x = t
        for block in self.residual_group.blocks:
            x = block(x, hp, wp)
        x = self.residual_group.overlap_attn(x, hp, wp)
        return t + self.conv(_unembed(x, hp, wp)).flatten(2).transpose(1, 2)


class HAT(SwinIR):
    """Same-resolution HAT with the coarse-solution skip: SwinIR's body with
    :class:`RHAG` groups. Input ``(N, in_channels, H, W)``, output
    ``(N, 1, H, W)``."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6, num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 16, overlap_ratio: float = 0.5, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01, mlp_ratio: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, embed_dim, depths, num_heads, window_size, mlp_ratio,
                         generator,
                         group=functools.partial(RHAG, overlap_ratio=overlap_ratio,
                                                 compress_ratio=compress_ratio,
                                                 squeeze_factor=squeeze_factor,
                                                 conv_scale=conv_scale))
