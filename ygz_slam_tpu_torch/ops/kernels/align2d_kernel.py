"""K1: integer-origin window gather, and bilinear patches built on it.

Counterpart of ygz_slam_tpu/ops/pallas/align2d_kernel.py.  The CUDA
kernel (csrc/gather_windows.cu) replaces `gather_windows` there; the
TPU's aligned super-windows and shift matmuls are not carried over.
"""
from __future__ import annotations

import torch

from . import I, P, launch, on_card, require, stream

PATCH = 8
# Cached-window aligner geometry: one CACHE_WIN window per point, fetched
# once; a point may drift CACHE_SLACK px from its init before sampling
# clamps (the caller rejects such points).
CACHE_WIN = 32
CACHE_SLACK = (CACHE_WIN - PATCH - 1) // 2  # 11 px


def gather_windows_plain(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                         win: int) -> torch.Tensor:
    """Plain version of K1: [H, W] image + int origins [N] -> [N, win, win],
    origins clamped to [0, W-win] x [0, H-win]."""
    H, W = img.shape
    x0 = torch.clamp(xi.long(), 0, W - win)
    y0 = torch.clamp(yi.long(), 0, H - win)
    ar = torch.arange(win, device=img.device)
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def gather_windows(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                   win: int) -> torch.Tensor:
    """[H, W] float32 image + int32 origins [N] -> [N, win, win] windows,
    origins clamped to the image.  K1 on the card, the plain version on
    the CPU."""
    H, W = img.shape
    if win > H or win > W:
        raise ValueError(f"window {win} larger than image {H}x{W}")
    if not on_card(img):
        return gather_windows_plain(img, xi, yi, win)
    N = xi.shape[0]
    require(img, "img", torch.float32, (H, W), img.device)
    require(xi, "xi", torch.int32, (N,), img.device)
    require(yi, "yi", torch.int32, (N,), img.device)
    out = torch.empty((N, win, win), dtype=torch.float32, device=img.device)
    launch("gather_windows", "gather_windows_launch", [P, I, I, P, P, I, I, P, P],
           img.data_ptr(), H, W, xi.data_ptr(), yi.data_ptr(), N, win, out.data_ptr(),
           stream(img.device))
    gather_windows.launches += 1
    return out


gather_windows.launches = 0


def bilinear_patches(img: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear [N, size, size] patches at sub-pixel `centers [N, 2]` on the
    symmetric grid, from one (size+1)-window per point (K1).  Wild centers
    (NaN, +-1e12 from behind-camera projections of masked points) are
    clamped into the image first, so the mix weights stay finite."""
    H, W = img.shape
    half = (size - 1) / 2.0
    win = size + 1
    cx = torch.clamp(torch.nan_to_num(centers[:, 0]), 0.0, W - 1.0)
    cy = torch.clamp(torch.nan_to_num(centers[:, 1]), 0.0, H - 1.0)
    x0f = torch.clamp(torch.floor(cx - half), 0, W - win)
    y0f = torch.clamp(torch.floor(cy - half), 0, H - win)
    w = gather_windows(img, x0f.to(torch.int32), y0f.to(torch.int32), win)
    fx = (cx - half - x0f)[:, None, None]
    fy = (cy - half - y0f)[:, None, None]
    return (w[:, :size, :size] * (1 - fx) * (1 - fy)
            + w[:, :size, 1:] * fx * (1 - fy)
            + w[:, 1:, :size] * (1 - fx) * fy
            + w[:, 1:, 1:] * fx * fy)
