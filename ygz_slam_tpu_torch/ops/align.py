"""Batched patch alignment (counterpart of ygz_slam_tpu/ops/align.py):
align2d on the kernel path only, and the pyramidal KLT of monocular
initialization in plain PyTorch.

align2d is cvutils::Align2D (CVUtils.cpp:186-318) for all N points at once:
the cached-window GN loop of K4 plus the JAX package's acceptance gates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .interp import bilinear, in_bounds
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
    pyramid's levels, say) with their origins; K4 then samples those."""
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


def _window_coords(xy: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return torch.stack([xy[:, 0, None, None] + gx[None], xy[:, 1, None, None] + gy[None]],
                       dim=-1)


def klt_pyramidal(ref_pyr, cur_pyr, xy_ref: torch.Tensor, xy_init: torch.Tensor | None = None,
                  win: int = 21, iters: int = 10, min_eig: float = 1e-3,
                  max_residual: float = 25.0) -> AlignResult:
    """Batched pyramidal Lucas-Kanade tracking (the KLT Tracker,
    Tracker.cpp:65-113: window 21, OPTFLOW_USE_INITIAL_FLOW semantics
    through `xy_init`).  Coarse to fine over the shared pyramid; per level
    `iters` inverse-compositional translation-only GN steps on the
    reference window's 2x2 normal matrix, all N tracks together.  A track is
    accepted inside a 2 px margin (its reference too), with a finite
    position and a zero-mean window residual below `max_residual`."""
    n_levels = len(ref_pyr)
    if xy_init is None:
        xy_init = xy_ref
    xy = xy_init / (2.0 ** (n_levels - 1))
    d = torch.arange(win, dtype=torch.float32, device=xy_ref.device) - (win - 1) / 2.0
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    one_x = torch.tensor([1.0, 0.0], device=xy_ref.device)
    one_y = torch.tensor([0.0, 1.0], device=xy_ref.device)
    for lvl in range(n_levels - 1, -1, -1):
        ref_img, cur_img = ref_pyr[lvl], cur_pyr[lvl]
        coords_r = _window_coords(xy_ref / (2.0 ** lvl), gx, gy)
        ref_w = bilinear(ref_img, coords_r)                                 # [N, w, w]
        Ix = 0.5 * (bilinear(ref_img, coords_r + one_x) - bilinear(ref_img, coords_r - one_x))
        Iy = 0.5 * (bilinear(ref_img, coords_r + one_y) - bilinear(ref_img, coords_r - one_y))
        Ixx = torch.sum(Ix * Ix, dim=(1, 2))
        Iyy = torch.sum(Iy * Iy, dim=(1, 2))
        Ixy = torch.sum(Ix * Iy, dim=(1, 2))
        det = Ixx * Iyy - Ixy * Ixy
        tr = Ixx + Iyy
        eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
        trackable = (eig_min / (win * win) > min_eig)[:, None]
        det_safe = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
        for _ in range(iters):
            r = bilinear(cur_img, _window_coords(xy, gx, gy)) - ref_w
            bx = torch.sum(Ix * r, dim=(1, 2))
            by = torch.sum(Iy * r, dim=(1, 2))
            upd = torch.stack([(Iyy * bx - Ixy * by) / det_safe,
                               (Ixx * by - Ixy * bx) / det_safe], dim=-1)
            xy = xy - torch.where(trackable, upd, 0.0)
        if lvl > 0:
            xy = xy * 2.0
    ref_w = bilinear(ref_pyr[0], _window_coords(xy_ref, gx, gy))
    cur_w = bilinear(cur_pyr[0], _window_coords(xy, gx, gy))
    err = torch.mean(torch.abs((cur_w - cur_w.mean(dim=(1, 2), keepdim=True))
                               - (ref_w - ref_w.mean(dim=(1, 2), keepdim=True))), dim=(1, 2))
    H0, W0 = cur_pyr[0].shape
    ok = (in_bounds(xy, H0, W0, margin=2.0) & in_bounds(xy_ref, H0, W0, margin=2.0)
          & (err < max_residual) & torch.isfinite(xy).all(dim=-1))
    return AlignResult(xy=xy, converged=ok, error=err)
