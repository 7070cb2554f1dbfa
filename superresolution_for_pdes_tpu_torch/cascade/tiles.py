"""Tiling of 2-D fields (port of ``cascade/tiles.py``).

Non-overlapping tiles are a reshape/permute; overlapping windows are
``F.unfold`` and their feathered overlap-add is ``F.fold``. Tiles are in
row-major order: tile ``[i][j]`` covers rows ``i*t:(i+1)*t`` and columns
``j*t:(j+1)*t`` (windows: origins ``i*stride``, ``j*stride``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def split_tiles(field: torch.Tensor, tile: int) -> torch.Tensor:
    """(..., H, W) -> (..., ny*nx, tile, tile), row-major tile order."""
    *lead, H, W = field.shape
    ny, nx = H // tile, W // tile
    if ny * tile != H or nx * tile != W:
        raise ValueError(f"field {H}x{W} not divisible into {tile}x{tile} tiles")
    t = field.reshape(*lead, ny, tile, nx, tile).transpose(-3, -2)
    return t.reshape(*lead, ny * nx, tile, tile)


def stitch_tiles(tiles: torch.Tensor, ny: int | None = None) -> torch.Tensor:
    """(..., ny*nx, tile, tile) -> (..., ny*tile, nx*tile); inverse of
    :func:`split_tiles`."""
    *lead, n_tiles, tile, tile2 = tiles.shape
    if ny is None:
        ny = int(round(n_tiles**0.5))
    nx = n_tiles // ny
    if ny * nx != n_tiles:
        raise ValueError(f"cannot stitch {n_tiles} tiles into {ny} rows")
    t = tiles.reshape(*lead, ny, nx, tile, tile2).transpose(-3, -2)
    return t.reshape(*lead, ny * tile, nx * tile2)


def _window_count(size: int, tile: int, stride: int) -> int:
    if (size - tile) % stride != 0:
        raise ValueError(f"(size-tile)={size - tile} not divisible by stride {stride}")
    return (size - tile) // stride + 1


def split_tiles_overlapping(field: torch.Tensor, tile: int, stride: int) -> torch.Tensor:
    """(..., H, W) -> (..., ny*nx, tile, tile) windows at ``stride``."""
    *lead, H, W = field.shape
    ny, nx = _window_count(H, tile, stride), _window_count(W, tile, stride)
    cols = F.unfold(field.reshape(-1, 1, H, W), tile, stride=stride)  # (N, t*t, L)
    return cols.transpose(1, 2).reshape(*lead, ny * nx, tile, tile)


def blend_weights(tile: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Separable tent (feathering) window, strictly positive, max 1 (cached
    per tile, dtype and device, so a stitch copies nothing from the host)."""
    return _blend_weights_cached(tile, dtype, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _blend_weights_cached(tile: int, dtype, device) -> torch.Tensor:
    ramp = np.minimum(np.arange(tile) + 1, tile - np.arange(tile)).astype(np.float64)
    w = np.outer(ramp, ramp)
    return torch.as_tensor(w / w.max(), dtype=dtype, device=device)


def stitch_tiles_overlapping(tiles: torch.Tensor, out_size: int, stride: int) -> torch.Tensor:
    """Feathered overlap-add of (..., ny*nx, tile, tile) windows back to
    (..., out_size, out_size); the inverse of :func:`split_tiles_overlapping`
    for consistent tiles."""
    *lead, L, tile, _ = tiles.shape
    n = _window_count(out_size, tile, stride)
    if n * n != L:
        raise ValueError(f"{L} windows do not cover a {out_size}^2 field at stride {stride}")
    w = blend_weights(tile, tiles.dtype, tiles.device)
    cols = (tiles * w).reshape(-1, L, tile * tile).transpose(1, 2)
    acc = F.fold(cols, (out_size, out_size), tile, stride=stride)
    wcols = w.reshape(1, tile * tile, 1).expand(1, tile * tile, L)
    wsum = F.fold(wcols, (out_size, out_size), tile, stride=stride)
    return (acc / wsum).reshape(*lead, out_size, out_size)
