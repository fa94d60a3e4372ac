"""FAST corner detection, Shi-Tomasi scoring and gridded selection over the
whole image plane (counterpart of ygz_slam_tpu/ops/fast.py).

The 16-pixel Bresenham circle test runs for every pixel at once on shifted
views of the edge-padded image, Shi-Tomasi is dense from gradient maps, non-max suppression is
a 3x3 max-pool compare, and grid selection is a reshape plus a per-cell
argmax, giving fixed-shape [N] corner sets.  None of it is inside a Pallas
kernel in the JAX package, so it is plain PyTorch here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .select import top_k

# Bresenham circle of radius 3 (FAST's 16 offsets); (dx, dy).
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
BORDER = 3


def _padded(img: torch.Tensor, r: int) -> torch.Tensor:
    """[H + 2r, W + 2r]: the image with its edge pixels repeated r times, so
    that p[r + dy: r + dy + H, r + dx: r + dx + W] is img shifted by
    (dx, dy) with edge clamping (border pixels are masked out of the corner
    test anyway)."""
    return F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]


def fast_score_map(img: torch.Tensor, threshold: float, arc_length: int = 10) -> torch.Tensor:
    """Boolean corner map of the FAST segment test (FAST-10 by default): a
    pixel is a corner if at least `arc_length` contiguous circle pixels are
    all brighter than center + t or all darker than center - t."""
    H, W = img.shape
    p = _padded(img, BORDER)
    ring = torch.stack([p[BORDER + dy: BORDER + dy + H, BORDER + dx: BORDER + dx + W]
                        for dx, dy in CIRCLE])                          # [16, H, W]
    bright = ring > (img + threshold)[None]
    dark = ring < (img - threshold)[None]

    def has_arc(flags):
        # Running count around the circle (wrapped): an arc starts where
        # the next `arc_length` flags are all set.
        doubled = torch.cat([flags, flags[: arc_length - 1]], dim=0)
        run = F.pad(torch.cumsum(doubled, dim=0, dtype=torch.int32), (0, 0, 0, 0, 1, 0))
        return torch.any(run[arc_length:] - run[:-arc_length] == arc_length, dim=0)

    corner = has_arc(bright) | has_arc(dark)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = (yy >= BORDER) & (yy < H - BORDER) & (xx >= BORDER) & (xx < W - BORDER)
    return corner & inside


def shi_tomasi_map(img: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense Shi-Tomasi score (least eigenvalue of the structure tensor
    over an 8x8 box of unhalved central differences, normalised by twice the
    box area; FeatureDetector.cpp:467-507).  The box sums come from a
    float32 integral image (two cumulative sums), as in the JAX package."""
    p = _padded(img, 1)
    dx = (0.5 * (p[1:-1, 2:] - p[1:-1, :-2])) * 2.0
    dy = (0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])) * 2.0
    box = 2 * halfbox

    def box_sum(x):
        # window at (v, u): rows [v-h, v+h), cols [u-h, u+h)
        ii = F.pad(torch.cumsum(torch.cumsum(x, dim=0), dim=1), (1, 0, 1, 0))
        core = ii[box:, box:] - ii[:-box, box:] - ii[box:, :-box] + ii[:-box, :-box]
        out = torch.zeros_like(x)
        out[halfbox: halfbox + core.shape[0], halfbox: halfbox + core.shape[1]] = core
        return out

    norm = 1.0 / (2.0 * box * box)
    dxx, dyy, dxy = box_sum(dx * dx) * norm, box_sum(dy * dy) * norm, box_sum(dx * dy) * norm
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc)


def nonmax_3x3(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keep the 3x3 local maxima of `score` among `mask` pixels."""
    s = torch.where(mask, score, -torch.inf)
    m = F.max_pool2d(s[None, None], 3, stride=1, padding=1)[0, 0]
    return mask & (s >= m) & torch.isfinite(s)


class Corners(NamedTuple):
    """Fixed-capacity corner set for one pyramid level."""
    xy: torch.Tensor     # [N, 2] float (x, y) at the detection level's scale
    score: torch.Tensor  # [N]
    mask: torch.Tensor   # [N] bool: rows beyond the detected count are invalid


def grid_select(score: torch.Tensor, corner_mask: torch.Tensor, cell: int,
                max_corners: int, min_score: float = 1e-5) -> Corners:
    """One best corner per cell x cell grid cell, then the global top
    `max_corners` (FeatureDetector.cpp:390-426 keeps one feature per cell;
    the capacity replaces its dynamic vector)."""
    H, W = score.shape
    Hc, Wc = H // cell, W // cell
    dev = score.device
    s = torch.where(corner_mask, score, -torch.inf)
    s = s[: Hc * cell, : Wc * cell].reshape(Hc, cell, Wc, cell)
    s = s.permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)
    best = torch.argmax(s, dim=1)
    best_score = torch.gather(s, 1, best[:, None])[:, 0]
    cells = torch.arange(Hc * Wc, device=dev)
    cy = best // cell + (cells // Wc) * cell
    cx = best % cell + (cells % Wc) * cell
    valid = torch.isfinite(best_score) & (best_score > min_score)
    k = min(max_corners, Hc * Wc)
    top_scores, top_idx = top_k(torch.where(valid, best_score, -torch.inf), k)
    xy = torch.stack([cx[top_idx].float(), cy[top_idx].float()], dim=-1)
    mask = torch.isfinite(top_scores)
    out_scores = torch.where(mask, top_scores, 0.0)
    if k < max_corners:
        pad = max_corners - k
        xy = torch.cat([xy, torch.zeros((pad, 2), dtype=xy.dtype, device=dev)])
        out_scores = torch.cat([out_scores, torch.zeros(pad, dtype=out_scores.dtype, device=dev)])
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return Corners(xy=xy, score=out_scores, mask=mask)


def detect(img: torch.Tensor, threshold: float, cell: int, max_corners: int,
           arc_length: int = 10, min_score: float = 1e-5) -> Corners:
    """Single-level detection: FAST mask -> dense Shi-Tomasi -> 3x3 nonmax
    -> grid selection to a fixed-capacity corner set."""
    corner = fast_score_map(img, threshold, arc_length)
    score = shi_tomasi_map(img)
    keep = nonmax_3x3(score, corner)
    return grid_select(score, keep, cell, max_corners, min_score)
