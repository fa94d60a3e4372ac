"""Bilinear sampling and patch extraction (counterpart of
ygz_slam_tpu/ops/interp.py).  Coordinates are (x, y), u right, v down."""
from __future__ import annotations

import torch


def bilinear_multi(imgs: torch.Tensor, img_idx: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """`bilinear` over an image stack: point set n reads `imgs[img_idx[n]]`.
    imgs [S, H, W], img_idx [N] integer, xy [N, ..., 2] -> [N, ...]; one flat
    indexed gather per corner."""
    _, H, W = imgs.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0.to(imgs.dtype)
    wy = y - y0.to(imgs.dtype)
    s = img_idx.long().reshape((-1,) + (1,) * (x.dim() - 1))
    return (imgs[s, y0, x0] * (1 - wx) * (1 - wy) + imgs[s, y0, x1] * wx * (1 - wy)
            + imgs[s, y1, x0] * (1 - wx) * wy + imgs[s, y1, x1] * wx * wy)


def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of `img [H, W]` at `xy [..., 2]`; out-of-range
    coordinates are clamped (callers mask validity with `in_bounds`)."""
    return bilinear_multi(img[None], torch.zeros(1, dtype=torch.long, device=img.device),
                          xy[None])[0]


def in_bounds(xy: torch.Tensor, h: int, w: int, margin: float = 0.0) -> torch.Tensor:
    """Mask [...] of coords with a full bilinear support inside the image."""
    x, y = xy[..., 0], xy[..., 1]
    return (x >= margin) & (y >= margin) & (x < w - 1 - margin) & (y < h - 1 - margin)


def extract_patches(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """Integer-aligned [N, size, size] patches around `centers [N, 2]`:
    centers are rounded (half to even) and a patch touching the border is
    shifted inside (callers mask those)."""
    H, W = img.shape
    half = size // 2
    cx = torch.clamp(torch.round(centers[..., 0]).long() - half, 0, W - size)
    cy = torch.clamp(torch.round(centers[..., 1]).long() - half, 0, H - size)
    ar = torch.arange(size, device=img.device)
    return img[(cy[:, None] + ar)[:, :, None], (cx[:, None] + ar)[:, None, :]]


def sample_patches(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear [N, size, size] patches at sub-pixel centers [N, 2] on the
    symmetric grid arange(size) - (size-1)/2."""
    d = torch.arange(size, dtype=img.dtype, device=img.device) - (size - 1) / 2.0
    n = centers.shape[0]
    gx = (centers[:, None, None, 0] + d[None, None, :]).expand(n, size, size)
    gy = (centers[:, None, None, 1] + d[None, :, None]).expand(n, size, size)
    return bilinear(img, torch.stack([gx, gy], dim=-1))


def image_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (dx, dy) of `img [H, W]`, the same
    shape, zero on the border rows and columns they cannot reach."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy
