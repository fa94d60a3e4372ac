"""Semi-dense direct tracking (the SEMI_DENSE_DIRECT frontend and the
SEMI_DENSE map type; counterpart of ygz_slam_tpu/models/semidense.py).

- Each keyframe carries a fixed-capacity set of high-gradient pixels
  (LSD-style selection: central-difference gradient magnitude, the best
  pixel per grid cell through the FAST detector's `grid_select`) with a
  Bayesian inverse-depth seed each (the depth filter, map/depth_filter.py).
- Per frame, the sparse-direct whole-frame alignment runs over the
  keyframe's features and its usable gradient pixels together
  (`alignment_point_set`): more points, the same kernel path (K1, K3).
- Converged seeds form the semi-dense map: per-keyframe (pixel, depth)
  tables back-projected to a world point cloud (`export_points`).

Everything is fixed shape: M gradient pixels per keyframe, masked.  Plain
PyTorch, as the JAX package's is jnp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import SE3
from ..map import depth_filter as dfilt
from ..ops import fast


def select_gradient_pixels(img: torch.Tensor, cell: int = 8, budget: int = 512,
                           min_grad: float = 8.0, margin: int = 8):
    """High-gradient pixel selection: the magnitude of the central
    differences (wrapping at the border, as `jnp.roll`; the margin masks
    the wrapped rows and columns), one best pixel per `cell` x `cell` grid
    cell above `min_grad`, the top `budget` overall.  Returns (px [M, 2]
    float32, valid [M] bool)."""
    gx = (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) * 0.5
    gy = (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0)) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (xx >= margin) & (xx < W - margin) & (yy >= margin) & (yy < H - margin)
    mag = torch.where(interior, mag, 0.0)
    c = fast.grid_select(mag, mag > min_grad, cell, budget)
    return c.xy, c.mask


class SemiDensePoints(NamedTuple):
    """The gradient-pixel set of one keyframe with its depth seeds."""

    px: torch.Tensor         # [M, 2] pixels in the keyframe
    seeds: dfilt.Seeds       # inverse-depth seeds over px
    kf_slot: int             # the keyframe's slot in the map

    @staticmethod
    def init(img, kf_slot: int, depth_mean: float, depth_min: float, cell: int = 8,
             budget: int = 512, min_grad: float = 8.0) -> "SemiDensePoints":
        px, valid = select_gradient_pixels(img, cell=cell, budget=budget, min_grad=min_grad)
        return SemiDensePoints(px=px, seeds=dfilt.Seeds.init(px, valid, depth_mean=depth_mean,
                                                             depth_min=depth_min),
                               kf_slot=int(kf_slot))

    def usable(self, max_rel_sigma: float = 0.25) -> torch.Tensor:
        """Seeds certain enough for direct alignment: relative inverse-depth
        std below `max_rel_sigma`."""
        s = self.seeds
        rel = torch.sqrt(s.sigma2) / torch.clamp(torch.abs(s.mu), min=1e-6)
        return s.valid & (rel < max_rel_sigma)

    def depths(self) -> torch.Tensor:
        return self.seeds.depth()


def update(sd: SemiDensePoints, kf_img, cur_img, cam, T_cur_kf: SE3) -> SemiDensePoints:
    """The gradient pixels' seeds refined against an ordinary frame
    (DepthFilter::UpdateSeeds over the semi-dense set)."""
    return sd._replace(seeds=dfilt.update_seeds_from_frame(sd.seeds, kf_img, cur_img, cam,
                                                           T_cur_kf))


def alignment_point_set(sd: SemiDensePoints, feat_px, feat_depth, feat_valid):
    """The union point set of semi-dense alignment: the keyframe's features
    with a depth (feat_px [F, 2], feat_depth [F], feat_valid [F]), then its
    usable gradient pixels at their seed depths.  Returns (px [F+M, 2],
    depth [F+M], mask [F+M])."""
    return (torch.cat([feat_px, sd.px]), torch.cat([feat_depth, sd.depths()]),
            torch.cat([feat_valid & (feat_depth > 0), sd.usable()]))


def export_points(sd: SemiDensePoints, T_kf_cw: SE3, cam, conv_ratio: float = 100.0):
    """Converged seeds -> world points (the SEMI_DENSE map's content).
    Returns (points [M, 3] world, valid [M])."""
    conv = sd.seeds.converged(ratio=conv_ratio) & sd.seeds.valid
    return cam.pixel_to_world(sd.px, T_kf_cw, depth=sd.depths()), conv
