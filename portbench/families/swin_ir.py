"""The SwinIR family (Liang et al., arXiv:2108.10257; the upstream
``models/network_swinir.py`` with ``upscale=1``, ``upsampler=''``,
``resi_connection='1conv'``, ``ape=False``, ``patch_norm=True``): the
program's ``models/swinir.py::SwinIR``, registered as ``swinir``. (The file
is ``swin_ir.py``: ``test_portbench_resolve.py`` takes ``swinir`` as its
example of a family that has no file.)

A 3x3 ``conv_first`` to ``embed_dim``; the map flattened to tokens and
LayerNorm-ed; residual groups of Swin blocks (window attention with a
learned relative-position bias, every second block on windows shifted by
half a window under upstream's region mask, then a GELU MLP; both pre-norm
with a residual), each group closed by a 3x3 convolution on the map and a
skip; a LayerNorm, ``conv_after_body`` plus the first features, and a 3x3
``conv_last`` to one channel plus the coarse solution (input channel 0).
Inputs are reflect-padded to a multiple of the window and the output is
cropped.

Written out as upstream writes it, in float32: window partition and reverse
by reshapes, ``torch.roll``, the mask from the 3x3 slicing, and attention as
``softmax(q k^T * scale + bias + mask) v``. It departs from upstream only
where the program does (5 inputs and one output with the channel-0
residual; no mean shift; no stochastic depth). Nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.layers import Layout, Params, conv, conv_entries

TRAINABLE = ("conv", "bias", "linear", "ln_weight", "ln_bias", "rel_bias")
# widths at which the CPU tests run it: shifted blocks in both groups, heads
# of 6 (not a multiple of the program's padding)
TINY = {"embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2], "window_size": 4,
        "mlp_ratio": 2}
MASK = -100.0
LN_EPS = 1e-5


def program_config(arch: Dict) -> Dict:
    """The program's registry name and keyword arguments of ``arch``."""
    return {"name": "swinir", "in_channels": arch["in_channels"],
            "embed_dim": arch["embed_dim"], "depths": tuple(arch["depths"]),
            "num_heads": tuple(arch["num_heads"]), "window_size": arch["window_size"],
            "mlp_ratio": float(arch["mlp_ratio"])}


# ----------------------------------------------------------------- layout
def _linear(name: str, cin: int, cout: int) -> Layout:
    return [(f"{name}.weight", (cout, cin), "linear"), (f"{name}.bias", (cout,), "bias")]


def _ln(name: str, c: int) -> Layout:
    return [(f"{name}.weight", (c,), "ln_weight"), (f"{name}.bias", (c,), "ln_bias")]


def _hidden(arch: Dict) -> int:
    return int(arch["embed_dim"] * arch["mlp_ratio"])


def layout(arch: Dict) -> Layout:
    """``[(key, shape, kind)]`` of the model's tensors (upstream's keys, less
    its relative-index and mask buffers)."""
    c, ws, hid = arch["embed_dim"], arch["window_size"], _hidden(arch)
    out = conv_entries("conv_first", arch["in_channels"], c, 3) + _ln("patch_embed.norm", c)
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        for j in range(depth):
            blk = f"layers.{i}.residual_group.blocks.{j}"
            out += (_ln(f"{blk}.norm1", c)
                    + [(f"{blk}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads),
                        "rel_bias")]
                    + _linear(f"{blk}.attn.qkv", c, 3 * c) + _linear(f"{blk}.attn.proj", c, c)
                    + _ln(f"{blk}.norm2", c)
                    + _linear(f"{blk}.mlp.fc1", c, hid) + _linear(f"{blk}.mlp.fc2", hid, c))
        out += conv_entries(f"layers.{i}.conv", c, c, 3)
    return (out + _ln("norm", c) + conv_entries("conv_after_body", c, c, 3)
            + conv_entries("conv_last", c, 1, 3))


# ----------------------------------------------------------------- draws
def _trunc_normal(gen, shapes, device):
    """Truncated normal, std 0.02, bounds +-2 (upstream's ``trunc_normal_``),
    in one draw cut into tensors."""
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, std=0.02, generator=gen)
    return [part.reshape(s) for part, s in zip(flat.split(sizes), shapes)]


DRAWS = {"linear": _trunc_normal, "rel_bias": _trunc_normal,
         "ln_weight": lambda gen, shapes, device: [torch.ones(s, device=device) for s in shapes],
         "ln_bias": lambda gen, shapes, device: [torch.zeros(s, device=device) for s in shapes]}


# ----------------------------------------------------------------- forward
def _layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def _dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``(B, H, W, C) -> (B * windows, ws, ws, C)``."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def _reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """``(B * windows, ws, ws, C) -> (B, H, W, C)``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def _relative_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).to(device)


def _region_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """``(windows, ws^2, ws^2)``: 0 within a region of the shifted map, -100 across."""
    img = torch.zeros((1, h, w, 1), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = _partition(img, ws).view(-1, ws * ws)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, MASK).masked_fill(diff == 0, 0.0)


def _attention(p: Params, name: str, x: torch.Tensor, heads: int, ws: int,
               mask: torch.Tensor | None) -> torch.Tensor:
    """Window attention of ``(B * windows, N, C)`` tokens."""
    bw, n, c = x.shape
    d = c // heads
    qkv = _dense(p, f"{name}.qkv", x).reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[_relative_index(ws, x.device).view(-1)].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return _dense(p, f"{name}.proj", (attn @ v).transpose(1, 2).reshape(bw, n, c))


def _block(p: Params, name: str, t: torch.Tensor, h: int, w: int, heads: int, ws: int,
           shift: int, mask: torch.Tensor | None) -> torch.Tensor:
    b, length, c = t.shape
    x = _layer_norm(p, f"{name}.norm1", t).view(b, h, w, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = _partition(x, ws).view(-1, ws * ws, c)
    windows = _attention(p, f"{name}.attn", windows, heads, ws, mask if shift else None)
    x = _reverse(windows.view(-1, ws, ws, c), ws, h, w)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    t = t + x.view(b, length, c)
    m = _dense(p, f"{name}.mlp.fc2", F.gelu(_dense(p, f"{name}.mlp.fc1",
                                                   _layer_norm(p, f"{name}.norm2", t))))
    return t + m


def _embed(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def _unembed(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def forward(arch: Dict, p: Params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """``(N, C, H, W) -> (N, 1, H, W)`` in float32 (no layer differs in training)."""
    ws = arch["window_size"]
    h0, w0 = x.shape[-2:]
    x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), "reflect")
    h, w = x.shape[-2:]
    mask = _region_mask(h, w, ws, ws // 2, x.device)
    x0 = conv(p, "conv_first", x)
    t = _layer_norm(p, "patch_embed.norm", _embed(x0))
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        s = t
        for j in range(depth):
            s = _block(p, f"layers.{i}.residual_group.blocks.{j}", s, h, w, heads, ws,
                       0 if j % 2 == 0 else ws // 2, mask)
        t = _embed(conv(p, f"layers.{i}.conv", _unembed(s, h, w))) + t
    res = conv(p, "conv_after_body", _unembed(_layer_norm(p, "norm", t), h, w)) + x0
    return (x[:, 0:1] + conv(p, "conv_last", res))[:, :, :h0, :w0]


# ----------------------------------------------------------------- FLOPs
# Linear layers and convolutions at 2 in out a point (token); the attention's
# two products at 4 N d a query and head (N = ws^2 tokens a window, d the
# head size); a backward at twice its forward, except the first layer's input
# gradient. Softmax, LayerNorm, GELU, the bias gather and the adds are not
# counted (as BatchNorm is not in the other families). Every layer runs on
# the map padded to a multiple of the window.
def _padded(arch: Dict, size: int) -> int:
    ws = arch["window_size"]
    return -(-size // ws) * ws


def _parts(arch: Dict, size: int) -> tuple[int, int]:
    """``(forward, first convolution)`` of one sample."""
    c, ws, hid = arch["embed_dim"], arch["window_size"], _hidden(arch)
    s = _padded(arch, size)
    tokens = s * s
    block = 2 * (c * 3 * c + c * c + c * hid + hid * c) + 4 * ws * ws * c
    per_token = sum(arch["depths"]) * block
    first = flops.conv(arch["in_channels"], c, 3, s)
    convs = (first + (len(arch["depths"]) + 1) * flops.conv(c, c, 3, s)
             + flops.conv(c, 1, 3, s))
    return per_token * tokens + convs, first


def flops_forward(arch: Dict, size: int) -> int:
    """One sample's forward pass at ``size x size``."""
    return _parts(arch, size)[0]


def flops_train_step(arch: Dict, size: int) -> int:
    """One sample's forward and backward pass at ``size x size``."""
    total, first = _parts(arch, size)
    return 3 * total - first


# ----------------------------------------------------------------- window attention
def attention_window_heads(arch: Dict, batch: float, size: int) -> float:
    """Windows times heads attended in one pass over ``batch`` samples:
    ``batch (size / ws)^2 sum(heads x depth)``."""
    windows = (_padded(arch, size) // arch["window_size"]) ** 2
    return batch * windows * sum(h * d for h, d in zip(arch["num_heads"], arch["depths"]))


def attention_work(arch: Dict, batch: float, size: int) -> tuple[float, float]:
    """``(bytes, FLOPs)`` of one train step's window attention over ``batch``
    samples of ``size x size``, forward and backward, each tensor counted
    once in float32. A window and head of ``N`` tokens of size ``d``: the
    forward reads q, k, v and writes the output and its log-sum-exp
    (``4 N d + N``); the backward reads q, k, v, the output, its gradient and
    the log-sum-exp and writes the gradients of q, k and v (``8 N d + N``).
    The additive mask is read once and its gradient (the bias table's)
    written once: a bias per head on plain blocks, a bias and mask per
    window and head on shifted ones. FLOPs: ``4 N^2 d`` forward, twice that
    backward."""
    c, ws = arch["embed_dim"], arch["window_size"]
    n = ws * ws
    windows = (_padded(arch, size) // ws) ** 2
    nbytes = ops = 0.0
    for depth, heads in zip(arch["depths"], arch["num_heads"]):
        d = c // heads
        wh = batch * windows * heads * depth
        nbytes += 4 * wh * (12 * n * d + 2 * n)
        shifted = depth // 2
        nbytes += 4 * 2 * heads * n * n * ((depth - shifted) + shifted * windows)
        ops += 3 * wh * 4 * n * n * d
    return nbytes, ops
