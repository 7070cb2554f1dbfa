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
* the relative index is a non-persistent buffer and the region masks a
  per-size cache filled on the device at the first (eager) call of a size,
  so the ``state_dict`` holds learned tensors only (upstream also stores
  both, at its training size); its keys are upstream's;
* the attention is ``F.scaled_dot_product_attention`` with bias plus mask as
  one additive float mask, on heads zero-padded to a multiple of 8 (the
  products and the result are unchanged): SDPA's memory-efficient kernel
  takes a float32 head size only in multiples of 4, and at 30 PyTorch falls
  back to its unfused math path; the proj and the roll back act per token,
  so they run after the windows are put back in place.

Parameter count at the published widths (180, 6x6 blocks, 6 heads, window
8, MLP ratio 2) with 5 input channels: 11,504,161.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from superresolution_for_pdes_tpu_torch.models.unet import init_weights
from superresolution_for_pdes_tpu_torch.utils.profiling import span

HEAD_ALIGN = 8  # heads are zero-padded to a multiple of this for SDPA's fused kernels
MASK = -100.0   # upstream's logit between tokens of different shift regions


def relative_position_index(ws: int) -> torch.Tensor:
    """``(ws^2 * ws^2,)`` row of the bias table for each pair of window tokens."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    coords = coords.flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).flatten()


def shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """``(windows, ws^2, ws^2)`` region mask of a map of ``hp x wp`` rolled by
    ``-shift``: 0 within a region, -100 across, made on ``device``."""

    def regions(n):
        i = torch.arange(n, device=device)
        return (i >= n - ws).long() + (i >= n - shift).long()

    ids = regions(hp)[:, None] * 3 + regions(wp)[None, :]
    win = ids.view(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    across = win[:, None, :] != win[:, :, None]
    return torch.zeros(across.shape, device=device).masked_fill_(across, MASK)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside windows with the relative-position
    bias; takes the normalised map ``(B, Hp, Wp, C)`` (rolled on shifted
    blocks) and returns the attended map, projected, in the same place."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, hp, wp, c = x.shape
        ws, h, d = self.window_size, self.num_heads, self.head_dim
        nw, n = (hp // ws) * (wp // ws), ws * ws
        with span("swinir.attention", b * nw * h):
            qkv = self.qkv(x).view(b, hp // ws, ws, wp // ws, ws, 3, h, d)
            qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7)  # (3, B, rows, cols, heads, ws, ws, d)
            pad = -d % HEAD_ALIGN
            if pad:
                qkv = F.pad(qkv, (0, pad))
            q, k, v = qkv.reshape(3, b, nw, h, n, d + pad).unbind(0)
            bias = self.relative_position_bias_table.t()[:, self.relative_position_index]
            bias = bias.view(1, h, n, n)
            if mask is None:  # one bias for every window: windows are the batch
                q, k, v = (t.view(b * nw, h, n, d + pad) for t in (q, k, v))
            else:  # a bias and mask per window and head: both are the heads
                q, k, v = (t.view(b, nw * h, n, d + pad) for t in (q, k, v))
                bias = (mask[:, None] + bias).view(1, nw * h, n, n)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=self.scale)
            o = o.view(b, hp // ws, wp // ws, h, ws, ws, d + pad)[..., :d]
            o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
            return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm window attention and MLP, each with a residual; ``shift``
    rolls the map by ``-shift`` around the attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t: torch.Tensor, hp: int, wp: int, mask: torch.Tensor) -> torch.Tensor:
        b, length, c = t.shape
        x = self.norm1(t).view(b, hp, wp, c)
        s = self.shift
        if s:
            x = torch.roll(x, (-s, -s), (1, 2))
        x = self.attn(x, mask if s else None)
        if s:
            x = torch.roll(x, (s, s), (1, 2))
        t = t + x.reshape(b, length, c)
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

    def forward(self, t: torch.Tensor, hp: int, wp: int, mask: torch.Tensor) -> torch.Tensor:
        x = t
        for block in self.residual_group.blocks:
            x = block(x, hp, wp, mask)
        return t + self.conv(_unembed(x, hp, wp)).flatten(2).transpose(1, 2)


class _PatchEmbed(nn.Module):
    """Upstream's ``PatchEmbed`` with ``patch_norm``: the tokens' LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


def _unembed(t: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], hp, wp)


class SwinIR(nn.Module):
    """Same-resolution SwinIR with the coarse-solution skip. Input
    ``(N, in_channels, H, W)``, output ``(N, 1, H, W)``."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6, num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(depths) != len(num_heads):
            raise ValueError(f"depths {tuple(depths)} and num_heads {tuple(num_heads)} "
                             "name different numbers of groups")
        self.in_channels, self.window_size = in_channels, window_size
        self.conv_first = nn.Conv2d(in_channels, embed_dim, 3, padding=1)
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            ResidualGroup(embed_dim, depth, heads, window_size, mlp_ratio)
            for depth, heads in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_last = nn.Conv2d(embed_dim, 1, 3, padding=1)
        self._masks: Dict[tuple, torch.Tensor] = {}
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, WindowAttention):
                    nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                          generator=generator)
            init_weights(self, generator)

    def _shift_mask(self, hp: int, wp: int, device) -> torch.Tensor:
        """The region mask of an ``hp x wp`` map, kept per size and device
        from its first call (one made while a CUDA graph captures is not
        kept: its memory belongs to the graph's pool)."""
        key = (hp, wp, device)
        mask = self._masks.get(key)
        if mask is None:
            mask = shift_mask(hp, wp, self.window_size, self.window_size // 2, device)
            if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
                self._masks[key] = mask
        return mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        ws = self.window_size
        if h % ws or w % ws:
            x = F.pad(x, (0, -w % ws, 0, -h % ws), mode="reflect")
        hp, wp = x.shape[-2:]
        x0 = self.conv_first(x)
        t = self.patch_embed.norm(x0.flatten(2).transpose(1, 2))
        mask = self._shift_mask(hp, wp, x.device)
        for layer in self.layers:
            with span("swinir.stage", t.shape[0] * t.shape[1]):
                t = layer(t, hp, wp, mask)
        res = self.conv_after_body(_unembed(self.norm(t), hp, wp)) + x0
        return (self.conv_last(res) + x[:, 0:1])[..., :h, :w]
