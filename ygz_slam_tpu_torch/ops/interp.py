"""Bilinear sampling and patch extraction (counterpart of
ygz_slam_tpu/ops/interp.py).  Coordinates are (x, y), u right, v down."""
from __future__ import annotations

import torch


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of `img [H, W]` at `xy [..., 2]`; out-of-range
    coordinates are clamped (callers mask validity with `in_bounds`)."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0.to(img.dtype)
    wy = y - y0.to(img.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def in_bounds(xy: torch.Tensor, h: int, w: int, margin: float = 0.0) -> torch.Tensor:
    """Mask [...] of coords with a full bilinear support inside the image."""
    x, y = xy[..., 0], xy[..., 1]
    return (x >= margin) & (y >= margin) & (x < w - 1 - margin) & (y < h - 1 - margin)


def sample_patches(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear [N, size, size] patches at sub-pixel centers [N, 2] on the
    symmetric grid arange(size) - (size-1)/2."""
    d = torch.arange(size, dtype=img.dtype, device=img.device) - (size - 1) / 2.0
    n = centers.shape[0]
    gx = (centers[:, None, None, 0] + d[None, None, :]).expand(n, size, size)
    gy = (centers[:, None, None, 1] + d[None, :, None]).expand(n, size, size)
    return bilinear(img, torch.stack([gx, gy], dim=-1))
