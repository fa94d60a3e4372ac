"""The tracking step's own entry point (counterpart of
`__graft_entry__.entry()`): sparse-direct alignment (K1 + K3) and pose-only
BA (K5) on a random 240x320 problem drawn from `default_rng(0)`.

    from ygz_slam_tpu_torch.entry import entry
    fn, args = entry()                  # on the card; entry("cpu") for the plain versions
    T7, n_inliers, chi2 = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .geometry.camera import PinholeCamera
from .geometry.se3 import SE3
from .ops import pyramid
from .ops.sparse_align import sparse_image_align
from .solvers.ba import pose_only_ba


def example_tracking_problem(H: int = 240, W: int = 320, N: int = 200, n_levels: int = 3,
                             device=None):
    """The JAX entry's problem (`__graft_entry__._example_tracking_problem`),
    the same draws from `default_rng(0)`, on `device` (the card unless the
    caller names another): two uniform-noise images and N points of random
    depth seen 1 px off in the current one.  Returns (cam, ref_pyr,
    cur_pyr, px, depth, mask, pts_w, obs_px)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    cam = PinholeCamera.create(0.5 * W, 0.5 * W, W / 2, H / 2)
    ref_pyr = pyramid.build_pyramid(f32(rng.uniform(0, 255, (H, W))), n_levels)
    cur_pyr = pyramid.build_pyramid(f32(rng.uniform(0, 255, (H, W))), n_levels)
    px = f32(np.c_[rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)])
    depth = f32(rng.uniform(2.0, 5.0, N))
    mask = torch.ones(N, dtype=torch.bool, device=dev)
    pts_w = cam.pixel_to_world(px, SE3.identity(device=dev), depth=depth)
    return cam, ref_pyr, cur_pyr, px, depth, mask, pts_w, px + 1.0


def entry(device=None):
    """(fn, example_args): fn(*example_args) aligns the current pyramid to
    the reference from the identity, then refines the pose by pose-only BA
    against the observations, and returns (pose params7 [7], inlier count,
    chi2 of the last BA round)."""
    cam, *example_args = example_tracking_problem(device=device)

    def fn(ref_pyr, cur_pyr, px, depth, mask, pts_w, obs_px):
        stats = sparse_image_align(ref_pyr, cur_pyr, cam, px, depth, mask,
                                   SE3.identity(device=px.device), distorted=False)
        T, inlier, chi2 = pose_only_ba(stats.T_cur_ref, pts_w, obs_px, mask, cam)
        return T.params7(), torch.sum(inlier), chi2

    return fn, tuple(example_args)
