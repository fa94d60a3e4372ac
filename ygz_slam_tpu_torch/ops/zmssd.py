"""Zero-mean SSD patch scoring and the discrete epipolar-segment search
(counterpart of ygz_slam_tpu/ops/zmssd.py; the reference's
FindEpipolarMatchDirect + ZMSSD, include/ygz/utils.h:221-230, :269-465).

Every row's candidates along its segment are scored at once; callers refine
the winner with `ops.align.align1d`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .interp import bilinear, in_bounds

PATCH = 8


def zmssd(ref_patch: torch.Tensor, cur_patches: torch.Tensor) -> torch.Tensor:
    """Zero-mean SSD of one reference patch per row against candidate
    patches: [N, p, p] x [N, S, p, p] -> [N, S]."""
    rz = ref_patch - torch.mean(ref_patch, dim=(-2, -1), keepdim=True)
    cz = cur_patches - torch.mean(cur_patches, dim=(-2, -1), keepdim=True)
    d = cz - rz[:, None]
    return torch.sum(d * d, dim=(-2, -1))


class EpipolarMatch(NamedTuple):
    xy: torch.Tensor        # [N, 2] best position on the segment
    score: torch.Tensor     # [N] best ZMSSD
    ok: torch.Tensor        # [N]


def segment_samples(n: int, device) -> torch.Tensor:
    """[n] sample positions 0..1 along a segment, rounded as the JAX
    package's `jnp.linspace(0, 1, n)` rounds them on the CPU (i times the
    float32 reciprocal of n - 1, the last exactly 1), so both packages scan
    the same points."""
    t = torch.arange(n, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / max(n - 1, 1), dtype=torch.float32, device=device)
    t[-1] = 1.0
    return t


def epipolar_search(cur_img: torch.Tensor, ref_patches: torch.Tensor, px_a: torch.Tensor,
                    px_b: torch.Tensor, mask: torch.Tensor, n_samples: int = 32,
                    max_score: float = 2e4) -> EpipolarMatch:
    """The best of `n_samples` positions on each segment px_a -> px_b [N, 2]
    by ZMSSD against `ref_patches [N, 8, 8]` (positions whose patch leaves
    the image score +inf); ok where the row is in `mask` and the best score
    is finite and below `max_score`."""
    H, W = cur_img.shape
    t = segment_samples(n_samples, cur_img.device)[None, :, None]        # [1, S, 1]
    centers = px_a[:, None, :] * (1 - t) + px_b[:, None, :] * t           # [N, S, 2]
    d = torch.arange(PATCH, dtype=cur_img.dtype, device=cur_img.device) - (PATCH - 1) / 2.0
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    coords = torch.stack([centers[..., 0][..., None, None] + gx,
                          centers[..., 1][..., None, None] + gy], dim=-1)   # [N, S, p, p, 2]
    scores = zmssd(ref_patches, bilinear(cur_img, coords))
    inb = in_bounds(centers, H, W, margin=PATCH / 2 + 1)
    scores = torch.where(inb, scores, torch.inf)
    best_score, best = torch.min(scores, dim=1)
    xy = torch.gather(centers, 1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    ok = mask & torch.isfinite(best_score) & (best_score < max_score)
    return EpipolarMatch(xy=xy, score=best_score, ok=ok)
