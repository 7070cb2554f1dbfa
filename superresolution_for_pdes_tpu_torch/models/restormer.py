"""Restormer, an efficient transformer for high-resolution image restoration
(Zamir et al., "Restormer: Efficient Transformer for High-Resolution Image
Restoration", CVPR 2022, arXiv:2111.09881; the upstream
``basicsr/models/archs/restormer_arch.py``), as a same-resolution refiner,
NCHW.

The upstream model with ``dual_pixel_task=False``:

* ``patch_embed``: a 3x3 convolution from ``in_channels`` to ``dim``;
* a four-scale U of transformer blocks: ``encoder_level1`` (``dim``),
  ``down1_2``, ``encoder_level2`` (``2 dim``), ``down2_3``,
  ``encoder_level3`` (``4 dim``), ``down3_4``, ``latent`` (``8 dim``), then
  ``up4_3``, the skip concatenated and reduced by a 1x1 convolution
  (``reduce_chan_level3``), ``decoder_level3``, ``up3_2``,
  ``reduce_chan_level2``, ``decoder_level2``, ``up2_1``, the skip
  concatenated (no reduction: ``decoder_level1`` runs at ``2 dim``), then
  ``refinement`` at ``2 dim``; a downsampling is a 3x3 convolution to half
  the channels and ``PixelUnshuffle(2)``, an upsampling a 3x3 convolution to
  twice the channels and ``PixelShuffle(2)``;
* a transformer block is ``x + MDTA(norm1(x))`` then ``x + GDFN(norm2(x))``,
  each norm a LayerNorm over the channels of every pixel (``WithBias``);
* MDTA, multi-Dconv head transposed attention: a 1x1 convolution ``C ->
  3C``, a depthwise 3x3, then per head of ``d = C / heads`` channels
  ``softmax(temperature_h q^ k^T) v`` over the ``d x d`` channel logits,
  ``q^`` and ``k^`` each channel's row of tokens L2-normalised
  (``F.normalize``), then a 1x1 projection (``ops/transposed_attention.py``);
* GDFN, gated-Dconv feed-forward: a 1x1 convolution ``C -> 2 hidden``
  (``hidden = int(C ffn_expansion_factor)``), a depthwise 3x3, ``gelu(x1) x2``
  of its two halves, a 1x1 convolution back to ``C``;
* ``output``: a 3x3 convolution to the output channels, plus the input.

Inputs whose sides are not a multiple of 8 (three halvings) are
reflect-padded and the output cropped. Every convolution is built without
a bias, as the published configuration's ``bias=False``. The ``state_dict``
holds upstream's keys.

On CUDA, where no gradient is taken (serving, evaluation), the transposed
attention runs three hand-written CUDA kernels (``csrc/transposed_attention.cu``:
the Gram product over the tokens, the normalised softmax, ``A v``), built
for heads of 48 and 96 channels in float32; under autograd, and on the CPU,
its plain twin, upstream's operations. The LayerNorms are
:class:`~.swinir.LayerNorm` on the map's channels-last view (their weight
and bias gradients on ``csrc/token_reduce.cu``).

Departures from upstream (also the configuration's ``assumed``):

* 5 inputs (``in_channels``) and 1 output with the input-channel-0
  residual: upstream's ``output(x) + inp_img`` restricted to the predicted
  channel;
* the reflect padding to a multiple of 8 (upstream's test scripts pad too;
  its forward takes such inputs only).

Initialisation is PyTorch's default for the convolutions (upstream sets
none), temperatures 1, LayerNorms (1, 0). Parameter count at the published
widths (``dim`` 48, blocks [4, 6, 6, 8], 4 refinement blocks, heads
[1, 2, 4, 8], expansion 2.66, no biases) with 5 inputs and 1 output:
26,125,780 (26,126,644 with upstream's 3 and 3, the paper's 26.1M).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from superresolution_for_pdes_tpu_torch.models.swinir import LayerNorm as TokenLayerNorm
from superresolution_for_pdes_tpu_torch.ops.transposed_attention import transposed_attention
from superresolution_for_pdes_tpu_torch.utils.profiling import span

SCALES = 8  # the input side's divisor: three halvings


class LayerNorm(nn.Module):
    """Upstream's ``LayerNorm(dim, 'WithBias')``: each pixel's channels
    normalised (biased variance, eps 1e-5), scaled and shifted; NCHW in and out."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = TokenLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous()


class Attention(nn.Module):
    """MDTA: qkv by a 1x1 and a depthwise 3x3 convolution, attention across
    each head's channels, a 1x1 projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("restormer.attention", x.shape[0] * self.num_heads):
            qkv = self.qkv_dwconv(self.qkv(x))
            return self.project_out(transposed_attention(qkv, self.temperature, self.num_heads))


class FeedForward(nn.Module):
    """GDFN: a 1x1 convolution to two hidden halves, a depthwise 3x3,
    ``gelu(x1) x2``, a 1x1 convolution back."""

    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1, groups=hidden * 2,
                                bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("restormer.ffn", x.shape[0] * x.shape[2] * x.shape[3]):
            x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
            return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False),
                                  nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False),
                                  nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Restormer(nn.Module):
    """Same-resolution Restormer with the coarse-solution skip. Input
    ``(N, in_channels, H, W)``, output ``(N, 1, H, W)``."""

    def __init__(self, in_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(num_blocks) != 4 or len(heads) != 4:
            raise ValueError(f"Restormer has four scales: num_blocks {tuple(num_blocks)}, "
                             f"heads {tuple(heads)}")

        def blocks(n, width, h):
            return nn.Sequential(*(TransformerBlock(width, h, ffn_expansion_factor)
                                   for _ in range(n)))

        self.in_channels = in_channels
        self.patch_embed = OverlapPatchEmbed(in_channels, dim)
        self.encoder_level1 = blocks(num_blocks[0], dim, heads[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = blocks(num_blocks[1], dim * 2, heads[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = blocks(num_blocks[2], dim * 4, heads[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = blocks(num_blocks[3], dim * 8, heads[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=False)
        self.decoder_level3 = blocks(num_blocks[2], dim * 4, heads[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=False)
        self.decoder_level2 = blocks(num_blocks[1], dim * 2, heads[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = blocks(num_blocks[0], dim * 2, heads[0])
        self.refinement = blocks(num_refinement_blocks, dim * 2, heads[0])
        self.output = nn.Conv2d(dim * 2, 1, 3, padding=1, bias=False)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):  # nn.Conv2d.reset_parameters, from ``generator``
                    nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if h % SCALES or w % SCALES:
            x = F.pad(x, (0, -w % SCALES, 0, -h % SCALES), mode="reflect")
        enc1 = self.encoder_level1(self.patch_embed(x))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        latent = self.latent(self.down3_4(enc3))
        dec3 = self.decoder_level3(self.reduce_chan_level3(torch.cat([self.up4_3(latent), enc3],
                                                                     1)))
        dec2 = self.decoder_level2(self.reduce_chan_level2(torch.cat([self.up3_2(dec3), enc2], 1)))
        dec1 = self.refinement(self.decoder_level1(torch.cat([self.up2_1(dec2), enc1], 1)))
        return (self.output(dec1) + x[:, 0:1])[..., :h, :w]
