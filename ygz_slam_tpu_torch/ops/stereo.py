"""Rectified stereo matching: a depth per left-image feature from a
left/right pair (counterpart of ygz_slam_tpu/ops/stereo.py; the reference
declares a STEREO sensor, system.h:19-21, :49-52, with no stereo code).

Per feature: a ZMSSD scan along the horizontal segment of disparities
[fx b / max_depth, fx b / min_depth] in the right image, `align1d` along x
to sub-pixel, then a left-right check: the right patch searched again in
the left image over the mirrored range and refined, which must come back
within 1.5 px of the feature.  depth = fx b / disparity.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .align import align1d
from .interp import in_bounds, sample_patches
from .zmssd import epipolar_search


class StereoDepth(NamedTuple):
    depth: torch.Tensor      # [N] z-depth in the left camera (-1 where not ok)
    disparity: torch.Tensor  # [N] px
    ok: torch.Tensor         # [N]


def _shifted(px: torch.Tensor, dx: float) -> torch.Tensor:
    """px [N, 2] moved by dx along x."""
    return px + torch.stack([torch.full_like(px[:, 0], dx), torch.zeros_like(px[:, 1])], dim=-1)


def match_stereo(left_img: torch.Tensor, right_img: torch.Tensor, px_left: torch.Tensor,
                 valid: torch.Tensor, fx, baseline: float, min_depth: float = 0.3,
                 max_depth: float = 20.0, n_samples: int = 48,
                 max_err: float = 20.0) -> StereoDepth:
    """Depths of the features `px_left [N, 2]` (rows in `valid [N]`) of a
    rectified pair [H, W] with `baseline` metres between the cameras, in
    [min_depth, max_depth]."""
    H, W = left_img.shape
    # The disparity range in float32, as the JAX package computes it.
    fxb = np.float32(fx) * np.float32(baseline)
    d_min = float(fxb / np.float32(max_depth))
    d_max = float(fxb / np.float32(min_depth))
    m = epipolar_search(right_img, sample_patches(left_img, px_left, 8), _shifted(px_left, -d_min),
                        _shifted(px_left, -d_max), valid, n_samples=n_samples)
    direction = torch.tensor([[1.0, 0.0]], device=px_left.device).expand(px_left.shape[0], 2)
    res = align1d(right_img, sample_patches(left_img, px_left, 10), m.xy, direction,
                  max_error=max_err)
    disparity = px_left[:, 0] - res.xy[:, 0]
    # Left-right consistency: the right patch searched again in the left
    # image (a search, not an alignment seeded at px_left, which would
    # converge trivially); a texture alias does not come back.
    mb = epipolar_search(left_img, sample_patches(right_img, res.xy, 8), _shifted(res.xy, d_min),
                         _shifted(res.xy, d_max), valid, n_samples=n_samples)
    back = align1d(left_img, sample_patches(right_img, res.xy, 10), mb.xy, direction,
                   max_error=max_err)
    lr_ok = (mb.ok & back.converged & (torch.abs(back.xy[:, 0] - px_left[:, 0]) < 1.5)
             & (torch.abs(back.xy[:, 1] - px_left[:, 1]) < 1.5))
    ok = (valid & m.ok & res.converged & lr_ok & (disparity > max(d_min, float(np.float32(0.1))))
          & (disparity < d_max) & in_bounds(res.xy, H, W, margin=4.0))
    # A true division (a Python number over a tensor would multiply by the
    # reciprocal).
    depth = torch.full_like(disparity, float(fxb)) / torch.clamp(disparity, min=1e-6)
    depth = torch.where(ok, depth, -1.0)
    return StereoDepth(depth=depth, disparity=disparity, ok=ok)
