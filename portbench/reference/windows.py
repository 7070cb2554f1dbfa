"""Plain-PyTorch pieces of the window-attention transformers' references
(``portbench/families/hat.py``), written out as upstream's Swin code writes
them, float32, on a flat dict of tensors: the layout entries of a linear
layer and a LayerNorm, their functional calls, window partition and
reverse, the relative index and the region mask of shifted windows, window
attention as ``softmax(q k^T scale + bias (+ mask)) v``, the tokens' embed
and unembed, and the truncated-normal draws of linear weights and bias
tables. (``families/swin_ir.py`` holds the same pieces of its own.)

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.layers import Layout, Params

MASK = -100.0
LN_EPS = 1e-5


def linear_entries(name: str, cin: int, cout: int) -> Layout:
    return [(f"{name}.weight", (cout, cin), "linear"), (f"{name}.bias", (cout,), "bias")]


def ln_entries(name: str, c: int) -> Layout:
    return [(f"{name}.weight", (c,), "ln_weight"), (f"{name}.bias", (c,), "ln_bias")]


def _trunc_normal(gen, shapes, device):
    """Truncated normal, std 0.02, bounds +-2 (upstream's ``trunc_normal_``),
    in one draw cut into tensors."""
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, std=0.02, generator=gen)
    return [part.reshape(s) for part, s in zip(flat.split(sizes), shapes)]


DRAWS: Dict = {
    "linear": _trunc_normal, "rel_bias": _trunc_normal,
    "ln_weight": lambda gen, shapes, device: [torch.ones(s, device=device) for s in shapes],
    "ln_bias": lambda gen, shapes, device: [torch.zeros(s, device=device) for s in shapes]}


def layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``(B, H, W, C) -> (B * windows, ws, ws, C)``."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """``(B * windows, ws, ws, C) -> (B, H, W, C)``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).to(device)


def region_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """``(windows, ws^2, ws^2)``: 0 within a region of the shifted map, -100 across."""
    img = torch.zeros((1, h, w, 1), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = partition(img, ws).view(-1, ws * ws)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, MASK).masked_fill(diff == 0, 0.0)


def window_attention(p: Params, name: str, x: torch.Tensor, heads: int, ws: int,
                     mask: torch.Tensor | None) -> torch.Tensor:
    """Window attention of ``(B * windows, N, C)`` tokens, the qkv and proj
    linears included."""
    bw, n, c = x.shape
    d = c // heads
    qkv = dense(p, f"{name}.qkv", x).reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[relative_index(ws, x.device).view(-1)].view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    return dense(p, f"{name}.proj", (attn @ v).transpose(1, 2).reshape(bw, n, c))


def embed(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def unembed(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)
