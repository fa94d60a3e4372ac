"""The SPARSE_DIRECT monocular tracking step, assembled (counterpart of
`track_step` in bench.py and of _bench_common.py).

Per frame (`track_step`): build the pyramid, align sparse-direct to the
keyframe (K1 gathers + K3), align each map point's 8x8 patch (K1 + K4),
then 4-round pose-only BA (K5).  `fused_track_step` is the whole-step
configuration (`_bench_ab2.py` variant F): the same pyramid, then K1's four
window fetches at the frame-init pose and all three stages in one launch of
K11.  The keyframe side (reference pyramid, patches, Jacobians, inverse
normal matrices) is computed once in `make_state`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..ops import pyramid
from ..ops.align import align2d
from ..ops.interp import sample_patches
from ..ops.kernels.align2d_fused import Align2DPrep, align2d_prepare
from ..ops.kernels.track_fused import track_step_fused
from ..ops.sparse_align import ReferencePrep, prepare_reference, sparse_image_align
from ..solvers.ba import pose_only_ba
from ..utils.synthetic import PlaneScene

N_LEVELS = 3
# The reference envelope (bench.py): 640x480 frames, 200 landmarks, 0.5%
# sensor noise, the smooth trajectory of _bench_common.make_workload.
H, W, N = 480, 640, 200
NOISE = 0.005


class KeyframeState(NamedTuple):
    """Everything the tracking step needs from the keyframe."""
    cam: PinholeCamera
    ref_pyr: tuple            # reference pyramid, level 0 full resolution
    px: torch.Tensor          # [N, 2] keyframe feature pixels
    depth: torch.Tensor       # [N] their depths
    mask: torch.Tensor        # [N] bool
    pts_w: torch.Tensor       # [N, 3] world points
    patches: torch.Tensor     # [N, 10, 10] bordered reference patches
    ref_prep: ReferencePrep
    a2d_prep: Align2DPrep


def make_state(cam, ref_pyr, px, depth, mask, pts_w, patches) -> KeyframeState:
    """Keyframe state with its per-keyframe precomputation."""
    ref_prep = prepare_reference(ref_pyr, cam, px, depth, mask, distorted=False)
    return KeyframeState(cam, tuple(ref_pyr), px, depth, mask, pts_w, patches,
                         ref_prep, align2d_prepare(patches))


def track_step(state: KeyframeState, T_init7: torch.Tensor, img: torch.Tensor):
    """One frame: returns (pose params7 [7], inlier count)."""
    cam = state.cam
    cur_pyr = pyramid.build_pyramid(img, N_LEVELS)
    stats = sparse_image_align(state.ref_pyr, cur_pyr, cam, state.px, state.depth,
                               state.mask, SE3.from_params7(T_init7), distorted=False,
                               ref_prep=state.ref_prep)
    proj = cam.world_to_pixel(state.pts_w, stats.T_cur_ref, distorted=False)
    ares = align2d(cur_pyr[0], state.patches, proj, prep=state.a2d_prep)
    T, inlier, _ = pose_only_ba(stats.T_cur_ref, state.pts_w, ares.xy,
                                ares.converged & state.mask, cam)
    return T.params7(), torch.sum(inlier)


def fused_track_step(state: KeyframeState, T_init7: torch.Tensor, img: torch.Tensor):
    """One frame through K11 (`_bench_ab2.py:51-64`): returns (pose params7
    [7], inlier count int32).  The world frame is the reference camera
    here, so the landmarks double as K11's reference-frame points."""
    cur_pyr = pyramid.build_pyramid(img, N_LEVELS)
    T = SE3.from_params7(T_init7)
    R, t, _, _, n_inl, _, _, _, _ = track_step_fused(
        cur_pyr, state.ref_prep.levels, state.ref_prep.p_ref, state.a2d_prep, state.pts_w,
        state.mask, T.R, T.t, state.cam, distorted=False, max_level=N_LEVELS - 1)
    return SE3(R, t).params7(), n_inl.to(torch.int32)


def track_frames(state: KeyframeState, frames: torch.Tensor, T_init7: torch.Tensor,
                 step=track_step):
    """Track frames [F, H, W] in order with `step` (`track_step` or
    `fused_track_step`), each warm-started from the last pose.  Returns
    (poses params7 [F, 7], inlier counts [F])."""
    T7 = T_init7
    poses, inliers = [], []
    for img in frames:
        T7, n_inl = step(state, T7, img)
        poses.append(T7)
        inliers.append(n_inl)
    return torch.stack(poses), torch.stack(inliers)


def _pose(i: int, device) -> SE3:
    """Ground-truth pose of frame i (_bench_common.make_workload)."""
    s = 2.0 * np.pi * i / 40.0
    xi = np.array([
        0.050 * np.sin(s), 0.035 * np.sin(2 * s + 0.7), 0.030 * np.cos(s) - 0.030,
        0.0040 * np.sin(s + 0.3), 0.0050 * np.cos(2 * s), 0.0030 * np.sin(s),
    ], np.float32)
    base = np.array([0.04, -0.02, 0.01, 0.004, -0.006, 0.003], np.float32)
    return se3.exp(torch.from_numpy(base + xi).to(device))


def make_workload(n_frames: int, device=None, n_points: int = N):
    """The tracking workload of _bench_common.make_workload, same seeds,
    rendered on `device` (the card unless the caller names another).
    `n_points` other than N draws that many landmarks from the same seed.

    Returns (cam, px, depth, mask, pts_w, patches, ref_pyr, frames
    [F, H, W], T_gt7 [F, 7])."""
    dev = resolve_device(device)
    cam = PinholeCamera.create(517.3, 516.5, W / 2, H / 2)
    scene = PlaneScene(cam, plane_z=3.0, seed=0, tex_per_meter=220.0, device=dev)
    T_ref = SE3.identity(device=dev)
    img_ref = scene.render(T_ref, (H, W))
    rng = np.random.default_rng(0)
    px = torch.from_numpy(np.c_[rng.uniform(30, W - 30, n_points),
                                rng.uniform(30, H - 30, n_points)].astype(np.float32)).to(dev)
    depth = scene.depth(px, T_ref)
    mask = torch.ones(n_points, dtype=torch.bool, device=dev)
    pts_w = cam.pixel_to_world(px, T_ref, depth=depth, distorted=False)
    patches = sample_patches(img_ref, px, 10)
    ref_pyr = pyramid.build_pyramid(img_ref, N_LEVELS)
    Ts = [_pose(i, dev) for i in range(n_frames)]
    frames = torch.empty((n_frames, H, W), dtype=torch.float32, device=dev)
    for i, T in enumerate(Ts):
        noise = np.random.default_rng(100 + i).normal(0, NOISE, (H, W)).astype(np.float32)
        frames[i] = scene.render(T, (H, W)) + torch.from_numpy(noise).to(dev)
    T_gt7 = torch.stack([T.params7() for T in Ts])
    return cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7


def gate(T7_all: torch.Tensor, inliers: torch.Tensor, T_gt7: torch.Tensor):
    """Per-frame accuracy gate of _bench_common.gate: every pose within
    2e-2 of its ground truth and more than 75% of the landmarks inliers.
    Returns (max_err, min_inliers, ok)."""
    d = se3.distance(SE3.from_params7(T7_all), SE3.from_params7(T_gt7))
    max_err = float(torch.max(d))
    min_inl = int(torch.min(inliers))
    ok = max_err < 2e-2 and min_inl > int(0.75 * N)     # False for a NaN error
    return max_err, min_inl, ok
