"""The HAT family (Chen et al., "Activating More Pixels in Image
Super-Resolution Transformer", CVPR 2023, arXiv:2205.04437; the upstream
``hat/archs/hat_arch.py`` with ``resi_connection='1conv'``, ``ape=False``,
``patch_norm=True``): the program's ``models/hat.py::HAT``, registered as
``hat``.

SwinIR's skeleton (``swin_ir.py``; the shared pieces in
``portbench/reference/windows.py``) with residual hybrid attention groups:
each group is hybrid attention blocks (HAB: window attention beside a
channel-attention block, CAB, scaled by ``conv_scale``, then a GELU MLP; every
second block on windows shifted by half a window under the region mask), an
overlapping cross-attention block (OCAB: the queries of each window attend
to the keys and values of the ``window (1 + overlap_ratio)``-square window
centred on it, cut by ``nn.Unfold`` with zero padding from the map after the
qkv linear, with its own bias table and no mask), then a 3x3 convolution and
a skip. Inputs are reflect-padded to a multiple of the window and the output
is cropped.

Written out as upstream writes it, in float32: ``torch.roll``, window
partition and reverse by reshapes, the mask from the 3x3 slicing,
``F.unfold`` for OCAB's keys and values, attention as ``softmax(q k^T scale
+ bias (+ mask)) v``, the CAB as convolutions, an average pool and a
sigmoid. It departs from upstream only where the program does (5 inputs and
one output with the channel-0 residual; no mean shift; no stochastic depth;
no pixel-shuffle upsampler). Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.layers import Layout, Params, conv, conv_entries
from portbench.reference.windows import (DRAWS, dense, embed, layer_norm, linear_entries,  # noqa: F401
                                         ln_entries, partition, region_mask, reverse, unembed,
                                         window_attention)

TRAINABLE = ("conv", "bias", "linear", "ln_weight", "ln_bias", "rel_bias")
# widths at which the CPU tests run it: shifted blocks in both groups, heads
# of 6, a key window of 6; squeeze 3 so that the squeeze keeps 4 channels
TINY = {"embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2], "window_size": 4,
        "overlap_ratio": 0.5, "compress_ratio": 3, "squeeze_factor": 3, "conv_scale": 0.01,
        "mlp_ratio": 2}


def program_config(arch: Dict) -> Dict:
    """The program's registry name and keyword arguments of ``arch``."""
    return {"name": "hat", "in_channels": arch["in_channels"], "embed_dim": arch["embed_dim"],
            "depths": tuple(arch["depths"]), "num_heads": tuple(arch["num_heads"]),
            "window_size": arch["window_size"], "overlap_ratio": float(arch["overlap_ratio"]),
            "compress_ratio": arch["compress_ratio"], "squeeze_factor": arch["squeeze_factor"],
            "conv_scale": float(arch["conv_scale"]), "mlp_ratio": float(arch["mlp_ratio"])}


def key_window(arch: Dict) -> int:
    """OCAB's key window: ``int(window overlap_ratio) + window``."""
    return int(arch["window_size"] * arch["overlap_ratio"]) + arch["window_size"]


# ----------------------------------------------------------------- layout
def _hidden(arch: Dict) -> int:
    return int(arch["embed_dim"] * arch["mlp_ratio"])


def layout(arch: Dict) -> Layout:
    """``[(key, shape, kind)]`` of the model's tensors (upstream's keys, less
    its relative-index buffers), in the program's ``state_dict`` order."""
    c, ws, hid = arch["embed_dim"], arch["window_size"], _hidden(arch)
    mid, sq = c // arch["compress_ratio"], c // arch["squeeze_factor"]
    out = conv_entries("conv_first", arch["in_channels"], c, 3) + ln_entries("patch_embed.norm", c)
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        group = f"layers.{i}.residual_group"
        for j in range(depth):
            blk = f"{group}.blocks.{j}"
            cab = f"{blk}.conv_block.cab"
            out += (ln_entries(f"{blk}.norm1", c)
                    + [(f"{blk}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads),
                        "rel_bias")]
                    + linear_entries(f"{blk}.attn.qkv", c, 3 * c) + linear_entries(f"{blk}.attn.proj", c, c)
                    + conv_entries(f"{cab}.0", c, mid, 3) + conv_entries(f"{cab}.2", mid, c, 3)
                    + conv_entries(f"{cab}.3.attention.1", c, sq, 1)
                    + conv_entries(f"{cab}.3.attention.3", sq, c, 1)
                    + ln_entries(f"{blk}.norm2", c)
                    + linear_entries(f"{blk}.mlp.fc1", c, hid) + linear_entries(f"{blk}.mlp.fc2", hid, c))
        oca = f"{group}.overlap_attn"
        out += ([(f"{oca}.relative_position_bias_table", ((ws + key_window(arch) - 1) ** 2, heads),
                  "rel_bias")]
                + ln_entries(f"{oca}.norm1", c) + linear_entries(f"{oca}.qkv", c, 3 * c)
                + linear_entries(f"{oca}.proj", c, c) + ln_entries(f"{oca}.norm2", c)
                + linear_entries(f"{oca}.mlp.fc1", c, hid) + linear_entries(f"{oca}.mlp.fc2", hid, c))
        out += conv_entries(f"layers.{i}.conv", c, c, 3)
    return (out + ln_entries("norm", c) + conv_entries("conv_after_body", c, c, 3)
            + conv_entries("conv_last", c, 1, 3))


# ----------------------------------------------------------------- forward
def _mlp(p: Params, name: str, t: torch.Tensor) -> torch.Tensor:
    return t + dense(p, f"{name}.mlp.fc2", F.gelu(dense(p, f"{name}.mlp.fc1",
                                                          layer_norm(p, f"{name}.norm2", t))))


def _cab(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Upstream's ``CAB`` on an NCHW map."""
    y = conv(p, f"{name}.cab.2", F.gelu(conv(p, f"{name}.cab.0", x)))
    a = F.adaptive_avg_pool2d(y, 1)
    a = conv(p, f"{name}.cab.3.attention.1", a, padding=0)
    a = torch.sigmoid(conv(p, f"{name}.cab.3.attention.3", F.relu(a), padding=0))
    return y * a


def _hab(p: Params, name: str, t: torch.Tensor, h: int, w: int, heads: int, ws: int,
         shift: int, mask: torch.Tensor, arch: Dict) -> torch.Tensor:
    b, length, c = t.shape
    x = layer_norm(p, f"{name}.norm1", t).view(b, h, w, c)
    conv_x = _cab(p, f"{name}.conv_block", x.permute(0, 3, 1, 2))
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, length, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = partition(x, ws).view(-1, ws * ws, c)
    windows = window_attention(p, f"{name}.attn", windows, heads, ws, mask if shift else None)
    x = reverse(windows.view(-1, ws, ws, c), ws, h, w)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    t = t + x.view(b, length, c) + conv_x * arch["conv_scale"]
    return _mlp(p, name, t)


def _oca_index(ws: int, ows: int, device) -> torch.Tensor:
    """Upstream's ``calculate_rpi_oca``: ``(ws^2, ows^2)``, negative entries
    left to wrap in the table's indexing."""
    ori = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                                   indexing="ij")), 1)
    ext = torch.flatten(torch.stack(torch.meshgrid([torch.arange(ows), torch.arange(ows)],
                                                   indexing="ij")), 1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1).to(device)


def _ocab(p: Params, name: str, t: torch.Tensor, h: int, w: int, heads: int, ws: int,
          ows: int) -> torch.Tensor:
    """Upstream's ``OCAB``."""
    b, length, c = t.shape
    d = c // heads
    x = layer_norm(p, f"{name}.norm1", t).view(b, h, w, c)
    qkv = dense(p, f"{name}.qkv", x).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    q_windows = partition(q, ws).view(-1, ws * ws, c)
    kv_windows = F.unfold(kv, kernel_size=(ows, ows), stride=ws, padding=(ows - ws) // 2)
    nw = kv_windows.shape[-1]
    kv_windows = kv_windows.view(b, 2, c, ows * ows, nw).permute(1, 0, 4, 3, 2) \
        .reshape(2, b * nw, ows * ows, c)
    bw = q_windows.shape[0]
    qh = q_windows.reshape(bw, ws * ws, heads, d).permute(0, 2, 1, 3) * d ** -0.5
    kh = kv_windows[0].reshape(bw, ows * ows, heads, d).permute(0, 2, 1, 3)
    vh = kv_windows[1].reshape(bw, ows * ows, heads, d).permute(0, 2, 1, 3)
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[_oca_index(ws, ows, t.device).view(-1)].view(ws * ws, ows * ows, -1)
    attn = qh @ kh.transpose(-2, -1) + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    windows = (torch.softmax(attn, dim=-1) @ vh).transpose(1, 2).reshape(bw, ws * ws, c)
    x = reverse(windows.view(-1, ws, ws, c), ws, h, w).view(b, length, c)
    t = dense(p, f"{name}.proj", x) + t
    return _mlp(p, name, t)


def forward(arch: Dict, p: Params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """``(N, C, H, W) -> (N, 1, H, W)`` in float32 (no layer differs in training)."""
    ws, ows = arch["window_size"], key_window(arch)
    h0, w0 = x.shape[-2:]
    x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), "reflect")
    h, w = x.shape[-2:]
    mask = region_mask(h, w, ws, ws // 2, x.device)
    x0 = conv(p, "conv_first", x)
    t = layer_norm(p, "patch_embed.norm", embed(x0))
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        group = f"layers.{i}.residual_group"
        s = t
        for j in range(depth):
            s = _hab(p, f"{group}.blocks.{j}", s, h, w, heads, ws, 0 if j % 2 == 0 else ws // 2,
                     mask, arch)
        s = _ocab(p, f"{group}.overlap_attn", s, h, w, heads, ws, ows)
        t = embed(conv(p, f"layers.{i}.conv", unembed(s, h, w))) + t
    res = conv(p, "conv_after_body", unembed(layer_norm(p, "norm", t), h, w)) + x0
    return (x[:, 0:1] + conv(p, "conv_last", res))[:, :, :h0, :w0]


# ----------------------------------------------------------------- FLOPs
# Linear layers and convolutions at 2 in out a point (the CAB's 1x1
# convolutions at one point a sample, on the pooled map); the attentions' two
# products at 4 N d a query and head (N keys: ws^2 in a HAB, the key window's
# ows^2 in an OCAB; d the head size); a backward at twice its forward,
# except the first layer's input gradient. Softmax, LayerNorm, GELU, the
# pool, the sigmoid, the bias gather, unfold and the adds are not counted.
# Every layer runs on the map padded to a multiple of the window.
def _padded(arch: Dict, size: int) -> int:
    ws = arch["window_size"]
    return -(-size // ws) * ws


def _parts(arch: Dict, size: int) -> tuple[int, int]:
    """``(forward, first convolution)`` of one sample."""
    c, ws, hid = arch["embed_dim"], arch["window_size"], _hidden(arch)
    mid, sq = c // arch["compress_ratio"], c // arch["squeeze_factor"]
    s = _padded(arch, size)
    tokens = s * s
    linears = 2 * (c * 3 * c + c * c + c * hid + hid * c)
    hab = linears + 4 * ws * ws * c + 2 * 9 * (c * mid + mid * c)
    ocab = linears + 4 * key_window(arch) ** 2 * c
    per_token = sum(arch["depths"]) * hab + len(arch["depths"]) * ocab
    squeeze = sum(arch["depths"]) * 2 * 2 * c * sq  # the two 1x1 convolutions on the pool
    first = flops.conv(arch["in_channels"], c, 3, s)
    convs = (first + (len(arch["depths"]) + 1) * flops.conv(c, c, 3, s)
             + flops.conv(c, 1, 3, s))
    return per_token * tokens + squeeze + convs, first


def flops_forward(arch: Dict, size: int) -> int:
    """One sample's forward pass at ``size x size``."""
    return _parts(arch, size)[0]


def flops_train_step(arch: Dict, size: int) -> int:
    """One sample's forward and backward pass at ``size x size``."""
    total, first = _parts(arch, size)
    return 3 * total - first


# ----------------------------------------------------------------- attentions
def _windows(arch: Dict, size: int) -> int:
    return (_padded(arch, size) // arch["window_size"]) ** 2


def attention_window_heads(arch: Dict, batch: float, size: int) -> float:
    """Windows times heads the HABs' window attention attends in one pass over
    ``batch`` samples: ``batch (padded size / ws)^2 sum(heads x depth)``."""
    return batch * _windows(arch, size) * sum(
        h * d for h, d in zip(arch["num_heads"], arch["depths"]))


def ocab_window_heads(arch: Dict, batch: float, size: int) -> float:
    """Windows times heads the OCABs attend in one pass over ``batch``
    samples: ``batch (padded size / ws)^2 sum(heads)``."""
    return batch * _windows(arch, size) * sum(arch["num_heads"])


def _work(arch: Dict, batch: float, size: int, ows: int, blocks) -> tuple[float, float]:
    """``(bytes, FLOPs)`` of a train step's forward and backward of one kind
    of attention over ``batch`` samples, ``blocks(depth)`` blocks of it a
    group, with ``ws^2`` queries and ``ows^2`` keys a window: what the
    attention must read and write, each tensor once, float32, whatever
    scratch a kernel keeps. A window and head of ``nq`` queries and head size
    ``d``: forward, q, k and v read (``3 nq d``: every token's k and v once,
    whatever windows share it), the output and its log-sum-exp written (``nq
    d + nq``); backward, q, k, v, the output, its gradient and the
    log-sum-exp read (``5 nq d + nq``), the gradients of q, k and v written
    (``3 nq d``); a call, the bias table of ``(ws + ows - 1)^2`` rows a head
    read twice and its gradient written. FLOPs: ``4 nq ows^2 d`` forward,
    twice that backward (the backward's recomputed logits not counted)."""
    ws, c = arch["window_size"], arch["embed_dim"]
    nq, nk, rows = ws * ws, ows * ows, (ws + ows - 1) ** 2
    windows = batch * _windows(arch, size)
    nbytes = ops = 0.0
    for depth, heads in zip(arch["depths"], arch["num_heads"]):
        d, wh = c // heads, windows * heads * blocks(depth)
        nbytes += 4 * (wh * (12 * nq * d + 2 * nq) + 3 * rows * heads * blocks(depth))
        ops += 3 * wh * 4 * nq * nk * d
    return nbytes, ops


def attention_work(arch: Dict, batch: float, size: int) -> tuple[float, float]:
    """``(bytes, FLOPs)`` of one train step's HAB window attention over
    ``batch`` samples of ``size x size`` (:func:`_work`; a shifted block's
    mask is computed from the tokens' places, not read)."""
    ws = arch["window_size"]
    return _work(arch, batch, size, ws, lambda depth: depth)


def ocab_work(arch: Dict, batch: float, size: int) -> tuple[float, float]:
    """``(bytes, FLOPs)`` of one train step's OCAB attention over ``batch``
    samples of ``size x size`` (:func:`_work`, one OCAB a group)."""
    return _work(arch, batch, size, key_window(arch), lambda depth: 1)
