"""The Restormer family (Zamir et al., "Restormer: Efficient Transformer for
High-Resolution Image Restoration", CVPR 2022, arXiv:2111.09881; the
upstream ``basicsr/models/archs/restormer_arch.py`` with
``LayerNorm_type='WithBias'``, ``bias=False``, ``dual_pixel_task=False``):
the program's ``models/restormer.py::Restormer``, registered as
``restormer``.

A four-scale U of transformer blocks. A block is ``x + MDTA(norm1(x))`` then
``x + GDFN(norm2(x))``, each norm a LayerNorm over a pixel's channels (to
``(B, HW, C)`` and back, as upstream's ``to_3d`` / ``to_4d``). MDTA: a 1x1
convolution to ``3C``, a depthwise 3x3, ``q``, ``k``, ``v`` split per head
into ``(d, HW)``, ``q`` and ``k`` L2-normalised over the tokens, ``A =
softmax(temperature_h q k^T)`` (``d x d``), ``A v``, a 1x1 projection. GDFN: a
1x1 convolution to ``2 hidden``, a depthwise 3x3, ``gelu(x1) x2``, a 1x1
convolution back. Downsampling is a 3x3 convolution to half the channels and
``pixel_unshuffle``; upsampling a 3x3 convolution to twice the channels and
``pixel_shuffle``; the skips are concatenated and, at levels 3 and 2,
reduced by a 1x1 convolution; decoder level 1 and the refinement run at
``2 dim``.

Written out as upstream writes it, in float32 (the harness turns TF32 off
for the reference): its LayerNorm's mean and biased variance,
``F.normalize``, explicit ``q k^T``, ``softmax`` and ``A v``.
Departures from upstream, as the program's (marked DEPARTURE below): 5
inputs and one output plus input channel 0 in place of the 3-channel
global residual; inputs reflect-padded to a multiple of 8 and the output
cropped. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.layers import Layout, Params
from portbench.reference.windows import ln_entries

TRAINABLE = ("conv_default", "temperature", "ln_weight", "ln_bias")
# widths at which the CPU tests run it: two heads at the first scale, so that
# every scale has more than one head; the same expansion factor
TINY = {"dim": 8, "num_blocks": [1, 1, 1, 2], "num_refinement_blocks": 1,
        "heads": [2, 2, 4, 4], "ffn_expansion_factor": 2.66}
LN_EPS = 1e-5
SCALES = 8  # DEPARTURE: inputs padded to a multiple of 8 (three halvings)


def _uniform(gen, shapes, device):
    """PyTorch's default for a convolution without bias (upstream sets no
    initialisation): U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in one draw cut into
    tensors."""
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    return [(part * torch.Size(s[1:]).numel() ** -0.5).reshape(s)
            for part, s in zip(flat.split(sizes), shapes)]


DRAWS: Dict = {
    "conv_default": _uniform,
    "temperature": lambda gen, shapes, device: [torch.ones(s, device=device) for s in shapes],
    "ln_weight": lambda gen, shapes, device: [torch.ones(s, device=device) for s in shapes],
    "ln_bias": lambda gen, shapes, device: [torch.zeros(s, device=device) for s in shapes]}


def program_config(arch: Dict) -> Dict:
    """The program's registry name and keyword arguments of ``arch``."""
    return {"name": "restormer", "in_channels": arch["in_channels"], "dim": arch["dim"],
            "num_blocks": tuple(arch["num_blocks"]),
            "num_refinement_blocks": arch["num_refinement_blocks"],
            "heads": tuple(arch["heads"]),
            "ffn_expansion_factor": float(arch["ffn_expansion_factor"])}


def _hidden(arch: Dict, c: int) -> int:
    return int(c * arch["ffn_expansion_factor"])


def _stages(arch: Dict):
    """``[(module prefix, blocks, channels, heads, scale)]`` in forward order;
    scale 0 is the input's size, each next one half of it."""
    dim, n, h = arch["dim"], arch["num_blocks"], arch["heads"]
    return [("encoder_level1", n[0], dim, h[0], 0), ("encoder_level2", n[1], 2 * dim, h[1], 1),
            ("encoder_level3", n[2], 4 * dim, h[2], 2), ("latent", n[3], 8 * dim, h[3], 3),
            ("decoder_level3", n[2], 4 * dim, h[2], 2), ("decoder_level2", n[1], 2 * dim, h[1], 1),
            ("decoder_level1", n[0], 2 * dim, h[0], 0),
            ("refinement", arch["num_refinement_blocks"], 2 * dim, h[0], 0)]


# ----------------------------------------------------------------- layout
def _conv(name: str, cin: int, cout: int, k: int, groups: int = 1) -> Layout:
    return [(f"{name}.weight", (cout, cin // groups, k, k), "conv_default")]


def _block(name: str, c: int, heads: int, hidden: int) -> Layout:
    return (ln_entries(f"{name}.norm1.body", c)
            + [(f"{name}.attn.temperature", (heads, 1, 1), "temperature")]
            + _conv(f"{name}.attn.qkv", c, 3 * c, 1)
            + _conv(f"{name}.attn.qkv_dwconv", 3 * c, 3 * c, 3, groups=3 * c)
            + _conv(f"{name}.attn.project_out", c, c, 1)
            + ln_entries(f"{name}.norm2.body", c)
            + _conv(f"{name}.ffn.project_in", c, 2 * hidden, 1)
            + _conv(f"{name}.ffn.dwconv", 2 * hidden, 2 * hidden, 3, groups=2 * hidden)
            + _conv(f"{name}.ffn.project_out", hidden, c, 1))


def layout(arch: Dict) -> Layout:
    """``[(key, shape, kind)]`` of the model's tensors (upstream's keys), in
    the program's ``state_dict`` order."""
    dim = arch["dim"]
    stages = {name: (n, c, h) for name, n, c, h, _ in _stages(arch)}

    def blocks(name):
        n, c, h = stages[name]
        return [e for i in range(n) for e in _block(f"{name}.{i}", c, h, _hidden(arch, c))]

    # DEPARTURE: output has one channel (upstream: in_channels)
    return (_conv("patch_embed.proj", arch["in_channels"], dim, 3) + blocks("encoder_level1")
            + _conv("down1_2.body.0", dim, dim // 2, 3) + blocks("encoder_level2")
            + _conv("down2_3.body.0", 2 * dim, dim, 3) + blocks("encoder_level3")
            + _conv("down3_4.body.0", 4 * dim, 2 * dim, 3) + blocks("latent")
            + _conv("up4_3.body.0", 8 * dim, 16 * dim, 3)
            + _conv("reduce_chan_level3", 8 * dim, 4 * dim, 1) + blocks("decoder_level3")
            + _conv("up3_2.body.0", 4 * dim, 8 * dim, 3)
            + _conv("reduce_chan_level2", 4 * dim, 2 * dim, 1) + blocks("decoder_level2")
            + _conv("up2_1.body.0", 2 * dim, 4 * dim, 3) + blocks("decoder_level1")
            + blocks("refinement") + _conv("output", 2 * dim, 1, 3))


# ----------------------------------------------------------------- forward
def _conv2d(p: Params, name: str, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, None, padding=w.shape[-1] // 2, groups=groups)


def _layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Upstream's ``LayerNorm(dim, 'WithBias')``: to ``(B, HW, C)``, the mean
    and biased variance over C, back to NCHW."""
    b, c, h, w = x.shape
    t = x.flatten(2).transpose(1, 2)
    mu = t.mean(-1, keepdim=True)
    sigma = t.var(-1, keepdim=True, unbiased=False)
    t = (t - mu) / torch.sqrt(sigma + LN_EPS) * p[f"{name}.body.weight"] + p[f"{name}.body.bias"]
    return t.transpose(1, 2).reshape(b, c, h, w)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              temperature: torch.Tensor) -> torch.Tensor:
    """Upstream's MDTA core on ``(B, heads, d, HW)`` each: ``softmax(t q^ k^T) v``."""
    q = F.normalize(q, dim=-1)
    k = F.normalize(k, dim=-1)
    attn = (q @ k.transpose(-2, -1)) * temperature
    return attn.softmax(dim=-1) @ v


def _mdta(p: Params, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, c, h, w = x.shape
    qkv = _conv2d(p, f"{name}.qkv_dwconv", _conv2d(p, f"{name}.qkv", x), groups=3 * c)
    q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in qkv.chunk(3, dim=1))
    out = attention(q, k, v, p[f"{name}.temperature"])
    return _conv2d(p, f"{name}.project_out", out.reshape(b, c, h, w))


def _gdfn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    y = _conv2d(p, f"{name}.project_in", x)
    x1, x2 = _conv2d(p, f"{name}.dwconv", y, groups=y.shape[1]).chunk(2, dim=1)
    return _conv2d(p, f"{name}.project_out", F.gelu(x1) * x2)


def _blocks(p: Params, name: str, n: int, heads: int, x: torch.Tensor) -> torch.Tensor:
    for i in range(n):
        blk = f"{name}.{i}"
        x = x + _mdta(p, f"{blk}.attn", _layer_norm(p, f"{blk}.norm1", x), heads)
        x = x + _gdfn(p, f"{blk}.ffn", _layer_norm(p, f"{blk}.norm2", x))
    return x


def forward(arch: Dict, p: Params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """``(N, C, H, W) -> (N, 1, H, W)`` in float32 (no layer differs in training)."""
    stages = {name: (n, h) for name, n, _, h, _ in _stages(arch)}

    def run(name, y):
        return _blocks(p, name, *stages[name], y)

    h0, w0 = x.shape[-2:]
    x = F.pad(x, (0, -w0 % SCALES, 0, -h0 % SCALES), "reflect")  # DEPARTURE
    enc1 = run("encoder_level1", _conv2d(p, "patch_embed.proj", x))
    enc2 = run("encoder_level2", F.pixel_unshuffle(_conv2d(p, "down1_2.body.0", enc1), 2))
    enc3 = run("encoder_level3", F.pixel_unshuffle(_conv2d(p, "down2_3.body.0", enc2), 2))
    latent = run("latent", F.pixel_unshuffle(_conv2d(p, "down3_4.body.0", enc3), 2))
    dec3 = torch.cat([F.pixel_shuffle(_conv2d(p, "up4_3.body.0", latent), 2), enc3], 1)
    dec3 = run("decoder_level3", _conv2d(p, "reduce_chan_level3", dec3))
    dec2 = torch.cat([F.pixel_shuffle(_conv2d(p, "up3_2.body.0", dec3), 2), enc2], 1)
    dec2 = run("decoder_level2", _conv2d(p, "reduce_chan_level2", dec2))
    dec1 = torch.cat([F.pixel_shuffle(_conv2d(p, "up2_1.body.0", dec2), 2), enc1], 1)
    dec1 = run("refinement", run("decoder_level1", dec1))
    # DEPARTURE: one output channel plus input channel 0 (upstream: + inp_img)
    return (_conv2d(p, "output", dec1) + x[:, 0:1])[:, :, :h0, :w0]


# ----------------------------------------------------------------- FLOPs
# Convolutions at 2 (c_in / groups) c_out k^2 a point (the depthwise ones
# too); the attention's two products at 2 d^2 a token and head each (q k^T
# and A v: 4 C d a token for C channels in heads of d); a backward at twice
# its forward, except the first layer's input gradient. The normalisation,
# the temperature, the softmax, LayerNorm, GELU, the gate, pixel (un)shuffle,
# the concatenations and the adds are not counted. Every layer runs on the
# map padded to a multiple of 8.
def _padded(size: int) -> int:
    return -(-size // SCALES) * SCALES


def _block_per_token(arch: Dict, c: int, heads: int) -> int:
    hid = _hidden(arch, c)
    mdta = 2 * c * 3 * c + 2 * 9 * 3 * c + 4 * c * (c // heads) + 2 * c * c
    gdfn = 2 * c * 2 * hid + 2 * 9 * 2 * hid + 2 * hid * c
    return mdta + gdfn


def _parts(arch: Dict, size: int) -> tuple[int, int]:
    """``(forward, first convolution)`` of one sample."""
    dim, s = arch["dim"], _padded(size)
    total = sum(n * _block_per_token(arch, c, h) * (s >> scale) ** 2
                for _, n, c, h, scale in _stages(arch))
    first = flops.conv(arch["in_channels"], dim, 3, s)
    convs = (first + flops.conv(dim, dim // 2, 3, s) + flops.conv(2 * dim, dim, 3, s // 2)
             + flops.conv(4 * dim, 2 * dim, 3, s // 4) + flops.conv(8 * dim, 16 * dim, 3, s // 8)
             + flops.conv(8 * dim, 4 * dim, 1, s // 4) + flops.conv(4 * dim, 8 * dim, 3, s // 4)
             + flops.conv(4 * dim, 2 * dim, 1, s // 2) + flops.conv(2 * dim, 4 * dim, 3, s // 2)
             + flops.conv(2 * dim, 1, 3, s))
    return total + convs, first


def flops_forward(arch: Dict, size: int) -> int:
    """One sample's forward pass at ``size x size``."""
    return _parts(arch, size)[0]


def flops_train_step(arch: Dict, size: int) -> int:
    """One sample's forward and backward pass at ``size x size``."""
    total, first = _parts(arch, size)
    return 3 * total - first


# ----------------------------------------------------------------- attention
def attention_heads(arch: Dict, batch: float) -> float:
    """Samples times heads the transposed attention attends in one forward
    over ``batch`` samples: ``batch sum(blocks x heads)`` over the stages."""
    return batch * sum(n * h for _, n, _, h, _ in _stages(arch))


def transposed_attention_work(arch: Dict, batch: float, size: int) -> tuple[float, float]:
    """``(bytes, FLOPs)`` of the transposed attention in one forward over
    ``batch`` samples of ``size x size``: what it must read and write, each
    tensor once, float32, whatever scratch a kernel keeps. A block of ``C``
    channels over ``N`` tokens reads q, k and v (``3 C N``) and writes the
    attended map (``C N``); the heads' temperatures and the ``d x d``
    attention are not counted. FLOPs: ``q k^T`` and ``A v``, ``4 C d N``."""
    s = _padded(size)
    nbytes = ops = 0.0
    for _, n, c, h, scale in _stages(arch):
        tokens = batch * n * (s >> scale) ** 2
        nbytes += 4 * 4 * c * tokens
        ops += 4 * c * (c // h) * tokens
    return nbytes, ops
