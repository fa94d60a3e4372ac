"""Batched 8x8 patch alignment (counterpart of align2d in
ygz_slam_tpu/ops/align.py, kernel path only).

cvutils::Align2D (CVUtils.cpp:186-318) for all N points at once: the
cached-window GN loop of K4 plus the JAX package's acceptance gates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .interp import in_bounds
from .kernels.align2d_fused import A2DWindows, Align2DPrep, align2d_fused, align2d_prepare
from .kernels.align2d_kernel import CACHE_SLACK, PATCH


class AlignResult(NamedTuple):
    xy: torch.Tensor         # [N, 2] refined positions
    converged: torch.Tensor  # [N] bool
    error: torch.Tensor      # [N] final mean abs residual


def substitute_inits(xy_init: torch.Tensor, H: int, W: int):
    """(inits the aligner starts from, in-bounds mask): inits outside a
    PATCH/2 + 2 px margin are replaced by (PATCH + 2, PATCH + 2)."""
    inb0 = in_bounds(xy_init, H, W, margin=PATCH / 2 + 2)
    return torch.where(inb0[:, None], xy_init, torch.full_like(xy_init, PATCH + 2.0)), inb0


def align2d(cur_img: torch.Tensor, ref_patch_border: torch.Tensor,
            xy_init: torch.Tensor, n_iter: int = 10,
            conv_eps: float = 0.03, max_error: float = 30.0,
            prep: Align2DPrep | None = None,
            pregathered: A2DWindows | None = None) -> AlignResult:
    """Refine N positions in `cur_img` so each 8x8 patch matches its
    reference (with a 1-px border for gradients, [N, 10, 10]), estimating
    (du, dv, mean offset).

    Gates (ops/align.py:79-112 of the JAX package): inits outside a
    6 px margin are replaced by (10, 10) and never accepted; a result is
    accepted when it lies inside a 5 px margin, its final mean |r| is
    below `max_error`, and it drifted less than min(16, CACHE_SLACK) px
    (beyond that the cached window clamps the sampling).  `pregathered`
    hands over cache windows fetched beforehand around `xy_init` (from a
    pyramid stack, say) with their origins; K4 then samples those."""
    H, W = cur_img.shape
    xy0s, inb0 = substitute_inits(xy_init.to(cur_img.dtype), H, W)
    if prep is None:
        prep = align2d_prepare(ref_patch_border)
    xy, _, err = align2d_fused(cur_img, prep, xy0s, n_iter=n_iter, conv_eps=conv_eps,
                               pregathered=pregathered)
    converged = accepted(xy, err, xy_init, inb0, H, W, max_error)
    return AlignResult(xy=xy, converged=converged, error=err)


def accepted(xy, err, xy_init, inb0, H: int, W: int,
             max_error: float = 30.0) -> torch.Tensor:
    """align2d's acceptance of refined positions: in-bounds init, result
    inside a PATCH/2 + 1 px margin, err below `max_error`, and drift from
    the init below min(2 PATCH, CACHE_SLACK) px."""
    inb = in_bounds(xy, H, W, margin=PATCH / 2 + 1)
    drift = torch.linalg.norm(xy - xy_init, dim=-1)
    max_drift = min(PATCH * 2.0, float(CACHE_SLACK))
    return inb0 & inb & (err < max_error) & (drift < max_drift)
