"""Multi-sequence batch tracking, assembled: the workload and frame loop
of bench_batch.py (counterpart of its `main`).

S sequences, each its own textured-plane scene seen at 640x480 through a
3-level pyramid with 200 landmarks, all on the shared smooth trajectory of
`tracking._pose` with 0.5% sensor noise.  Every frame advances all S
sequences one step (`parallel.batched_track_step`), each warm-started
from its last pose.  The keyframe side (one ReferencePrep per sequence,
K3's constants stacked from them, one Align2DPrep over the flattened
patches) is computed once in `make_batch_state`.
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
from ..ops.interp import sample_patches
from ..ops.kernels.align2d_fused import Align2DPrep, align2d_prepare
from ..ops.sparse_align import prepare_reference
from ..parallel import batched_track_step
from ..parallel.batch_tracking import BatchRef, stack_preps
from ..utils import profiling
from ..utils.synthetic import PlaneScene
from .tracking import H, N, N_LEVELS, NOISE, W, _pose

S_DEFAULT = 8           # bench_batch.py's default batch


class BatchState(NamedTuple):
    """Everything the batched step needs from the S keyframes."""
    cam: PinholeCamera
    ref_pyrs: tuple           # per level [S, h, w]
    px: torch.Tensor          # [S, N, 2] keyframe feature pixels
    depth: torch.Tensor       # [S, N]
    mask: torch.Tensor        # [S, N] bool
    pts_w: torch.Tensor       # [S, N, 3] world points
    patches: torch.Tensor     # [S, N, 10, 10] bordered reference patches
    ref_preps: tuple          # S ReferencePreps
    a2d_prep: Align2DPrep     # of the S*N flattened patches
    batch_ref: BatchRef       # K3's constants of the S ReferencePreps, stacked


def make_batch_workload(S: int = S_DEFAULT, n_frames: int = 60, device=None):
    """bench_batch.py's workload, same seeds, rendered on `device` (the
    card unless the caller names another): sequence s views the scene of
    seed s (220 texels per metre); the landmark pixels of all sequences
    come from one default_rng(0), sequence after sequence; frame i of
    sequence s carries the noise of default_rng(1000 s + i).

    Returns (cam, px [S, N, 2], depth [S, N], mask [S, N], pts_w [S, N, 3],
    patches [S, N, 10, 10], ref_pyrs (per level [S, h, w]), frames
    [F, S, H, W], T_gt7 [F, 7])."""
    dev = resolve_device(device)
    cam = PinholeCamera.create(517.3, 516.5, W / 2, H / 2)
    T_ref = SE3.identity(device=dev)
    Ts = [_pose(i, dev) for i in range(n_frames)]
    rng = np.random.default_rng(0)
    pxs, depths, ptsws, patches, refs = [], [], [], [], []
    frames = torch.empty((n_frames, S, H, W), dtype=torch.float32, device=dev)
    for s in range(S):
        scene = PlaneScene(cam, plane_z=3.0, seed=s, tex_per_meter=220.0, device=dev)
        img_ref = scene.render(T_ref, (H, W))
        px = torch.from_numpy(np.c_[rng.uniform(30, W - 30, N),
                                    rng.uniform(30, H - 30, N)].astype(np.float32)).to(dev)
        depth = scene.depth(px, T_ref)
        pxs.append(px)
        depths.append(depth)
        ptsws.append(cam.pixel_to_world(px, T_ref, depth=depth, distorted=False))
        patches.append(sample_patches(img_ref, px, 10))
        refs.append(img_ref)
        for i, T in enumerate(Ts):
            noise = np.random.default_rng(1000 * s + i).normal(0, NOISE, (H, W))
            frames[i, s] = scene.render(T, (H, W)) + torch.from_numpy(
                noise.astype(np.float32)).to(dev)
    ref_pyrs = pyramid.build_pyramid(torch.stack(refs), N_LEVELS)
    T_gt7 = torch.stack([T.params7() for T in Ts])
    return (cam, torch.stack(pxs), torch.stack(depths),
            torch.ones((S, N), dtype=torch.bool, device=dev), torch.stack(ptsws),
            torch.stack(patches), ref_pyrs, frames, T_gt7)


def make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches) -> BatchState:
    """Batch state with its per-keyframe precomputation."""
    S = px.shape[0]
    ref_preps = tuple(prepare_reference(tuple(r[s] for r in ref_pyrs), cam, px[s], depth[s],
                                        mask[s], distorted=False) for s in range(S))
    a2d_prep = align2d_prepare(patches.reshape(S * patches.shape[1], *patches.shape[2:]))
    return BatchState(cam, tuple(ref_pyrs), px, depth, mask, pts_w, patches, ref_preps,
                      a2d_prep, stack_preps(ref_preps))


def track_batch_step(state: BatchState, T_init7: torch.Tensor, imgs: torch.Tensor):
    """One frame of every sequence, imgs [S, H, W], from poses T_init7
    [S, 7].  Returns (poses params7 [S, 7], inlier counts [S])."""
    with profiling.span("batch_step"):
        with profiling.span("batch_pyramid"):
            cur_pyrs = pyramid.build_pyramid(imgs, N_LEVELS)
        T, n_inl = batched_track_step(state.ref_pyrs, cur_pyrs, state.cam, state.px, state.depth,
                                      state.mask, state.pts_w, SE3.from_params7(T_init7),
                                      state.batch_ref, state.a2d_prep)
        return T.params7(), n_inl


def track_batch_frames(state: BatchState, frames: torch.Tensor, T_init7: torch.Tensor):
    """Track frames [F, S, H, W] in order, each step warm-started from the
    last poses.  Returns (poses params7 [F, S, 7], inlier counts [F, S])."""
    T7 = T_init7
    poses, inliers = [], []
    for imgs in frames:
        T7, n_inl = track_batch_step(state, T7, imgs)
        poses.append(T7)
        inliers.append(n_inl)
    return torch.stack(poses), torch.stack(inliers)


def batch_gate(T7_all: torch.Tensor, inliers: torch.Tensor, T_gt7: torch.Tensor):
    """bench_batch.py's gate: every sequence's every frame within 2e-2 of
    its ground-truth pose (T_gt7 [F, 7], shared by the sequences) and more
    than 75% of the landmarks inliers.  Returns (max_err, min_inliers,
    ok)."""
    d = se3.distance(SE3.from_params7(T7_all),
                     SE3.from_params7(T_gt7[:, None].expand_as(T7_all)))
    max_err = float(torch.max(d))
    min_inl = int(torch.min(inliers))
    ok = max_err < 2e-2 and min_inl > 0.75 * N          # False for a NaN error
    return max_err, min_inl, ok
