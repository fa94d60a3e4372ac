"""The tracking step's own entry point (counterpart of
`__graft_entry__.entry()`): sparse-direct alignment (K1 + K3) and pose-only
BA (K5) on a random 240x320 problem drawn from `default_rng(0)`; and
`dryrun_multichip`, one step of each distributed program over a mesh.

    from ygz_slam_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()                  # on the card; entry("cpu") for the plain versions
    T7, n_inliers, chi2 = fn(*args)
    poses, points, chi2, T_seq = dryrun_multichip()   # one shard per card
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .geometry import so3
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


def dryrun_multichip(n_devices: int | None = None, device=None):
    """One distributed map-refinement step and one distributed tracking
    step over a mesh of n_devices shards (`__graft_entry__.dryrun_multichip`,
    the same draws from `default_rng(0)`), on `device` (the card unless the
    caller names another; n_devices defaults to the cards visible, or 1 on
    the CPU): `sharded_local_ba` (K = 4 keyframes, 8 landmarks per shard,
    2 iterations), then `sharded_batch_align` (a 64x64 sequence per shard, 16
    points, 3 iterations).  With no process group it runs in a world of one
    and ends that group.  Raises on a non-finite result.  Returns (poses,
    this rank's landmark rows, chi2, this rank's sequence poses)."""
    from .parallel import make_mesh, partition_observations, sharded_batch_align, sharded_local_ba

    dev = resolve_device(device)
    n = n_devices if n_devices is not None else (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    started = not dist.is_initialized()
    try:
        mesh = make_mesh(n, device=dev)
        K, L = 4, 8 * n
        cam = PinholeCamera.create(100.0, 100.0, 64.0, 48.0)
        pts = f32(np.c_[rng.uniform(-1, 1, (L, 2)), rng.uniform(3, 5, L)])
        Rs, ts = [], []
        for k in range(K):
            Rs.append(so3.exp(f32(rng.normal(size=3) * 0.02)))
            ts.append(f32([0.1 * k, 0, 0]))
        poses = SE3(torch.stack(Rs), torch.stack(ts))
        px = cam.world_to_pixel(pts, SE3(poses.R[:, None], poses.t[:, None]), distorted=False)
        kf_idx = np.repeat(np.arange(K, dtype=np.int32), L)
        pt_idx = np.tile(np.arange(L, dtype=np.int32), K)
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[0] = True
        sobs, L_pad = partition_observations(kf_idx, pt_idx, px.reshape(-1, 2),
                                             np.ones(K * L, bool), L, n, device=dev)
        pts_pad = torch.cat([pts, torch.zeros((L_pad - L, 3), device=dev)])
        poses_out, pts_out, chi2 = sharded_local_ba(
            mesh, poses, mesh.local_rows(pts_pad), type(sobs)(*map(mesh.local_rows, sobs)), cam,
            fixed, n_iter=2)
        if not bool(torch.isfinite(chi2)):
            raise AssertionError("distributed BA produced a non-finite chi2")
        # The sequence axis over the same mesh: one 64x64 sequence per shard.
        S, N, h, w = n, 16, 64, 64
        cam2 = PinholeCamera.create(40.0, 40.0, w / 2, h / 2)
        pyrs = pyramid.build_pyramid(f32(rng.uniform(0, 255, (S, h, w))), 3)
        px2 = f32(np.stack([np.c_[rng.uniform(10, w - 10, N), rng.uniform(10, h - 10, N)]
                            for _ in range(S)]))
        d2 = f32(rng.uniform(2.0, 4.0, (S, N)))
        m2 = torch.ones((S, N), dtype=torch.bool, device=dev)
        mine = tuple(mesh.local_rows(p) for p in pyrs)
        T_out = sharded_batch_align(mesh, mine, mine, cam2, mesh.local_rows(px2),
                                    mesh.local_rows(d2), mesh.local_rows(m2),
                                    SE3.identity((mesh.local_rows(px2).shape[0],), device=dev),
                                    n_iter=3)
        if not bool(torch.isfinite(T_out.params7()).all()):
            raise AssertionError("sharded batch tracking produced non-finite poses")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return poses_out, pts_out, chi2, T_out
