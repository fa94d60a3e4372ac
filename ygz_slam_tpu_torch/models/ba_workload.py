"""Bundle-adjustment workloads: bench_scaling.py's distributed-BA problem
and the point-only BA and optimize_current problems of
tests/test_solvers.py, drawn with numpy and built with the port's geometry
on the device the caller names.

    from ygz_slam_tpu_torch.models import ba_workload as bw
    from ygz_slam_tpu_torch.parallel import make_mesh, sharded_local_ba
    p = bw.ba_problem(3072, device="cpu")
    mesh = make_mesh(8, device="cpu")
    poses, pts, chi2 = sharded_local_ba(mesh, *bw.shard_inputs(mesh, p), p.cam, p.fixed)
    print(bw.pose_gate(poses, p))      # (mean pose distance, bench_scaling's error)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3, so3
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..parallel.sharded_ba import ShardedObs, partition_observations
from ..solvers import ba


class BAProblem(NamedTuple):
    cam: PinholeCamera
    poses: SE3               # the truth [K]
    points: torch.Tensor     # the truth [L, 3]
    noisy_poses: SE3         # the start: the first two exact, the others ~1 cm / 0.6 deg off
    noisy_points: torch.Tensor
    obs: ba.Observations     # raw pixels, 0.3 px noise
    fixed: torch.Tensor      # [K] bool: the first two poses


def ba_problem(L: int = 3072, K: int = 10, obs_per_pt: int = 5, device=None) -> BAProblem:
    """bench_scaling.py's problem (its draws from default_rng(0)): L
    landmarks 2-8 m ahead, each seen by obs_per_pt of K keyframes spaced 0.1
    m, 0.3 px of pixel noise; the first two poses fixed (gauge and scale),
    the others perturbed by 0.01 in each tangent coordinate, the landmarks
    by 3 cm."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    cam = PinholeCamera.create(517.3, 516.5, 320.0, 240.0)
    pts = f32(np.c_[rng.uniform(-2, 2, (L, 2)), rng.uniform(2, 8, L)])
    Rs, ts = [], []
    for k in range(K):
        Rs.append(so3.exp(f32(rng.normal(size=3) * 0.02)))
        ts.append(f32([0.1 * k, 0, 0] + rng.normal(size=3) * 0.01))
    poses = SE3(torch.stack(Rs), torch.stack(ts))
    kf_idx = np.concatenate([rng.choice(K, obs_per_pt, replace=False)
                             for _ in range(L)]).astype(np.int32)
    pt_idx = np.repeat(np.arange(L, dtype=np.int32), obs_per_pt)
    k, p = torch.from_numpy(kf_idx).to(dev).long(), torch.from_numpy(pt_idx).to(dev).long()
    px = cam.camera_to_pixel(SE3(poses.R[k], poses.t[k]).apply(pts[p]), distorted=False)
    px = px + f32(rng.normal(0, 0.3, tuple(px.shape)))
    obs = ba.Observations(torch.from_numpy(kf_idx).to(dev), torch.from_numpy(pt_idx).to(dev), px,
                          torch.ones(L * obs_per_pt, dtype=torch.bool, device=dev))
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[:2] = True
    noisy_poses = se3.boxplus(poses, f32(np.r_[np.zeros((2, 6)), rng.normal(0, 0.01, (K - 2, 6))]))
    noisy_pts = pts + f32(rng.normal(0, 0.03, tuple(pts.shape)))
    return BAProblem(cam, poses, pts, noisy_poses, noisy_pts, obs, fixed)


def shard_inputs(mesh, p: BAProblem):
    """`sharded_local_ba`'s inputs on this rank of `mesh`: (the start poses,
    this rank's zero-padded landmark rows, this rank's ShardedObs)."""
    L = p.points.shape[0]
    sobs, L_pad = partition_observations(*p.obs, L, mesh.shards, device=mesh.device)
    pts = torch.cat([p.noisy_points, p.noisy_points.new_zeros((L_pad - L, 3))])
    return p.noisy_poses, mesh.local_rows(pts), ShardedObs(*map(mesh.local_rows, sobs))


def pose_gate(poses: SE3, p: BAProblem) -> tuple[float, float]:
    """(mean pose distance to the truth, bench_scaling.py's error: the norm
    of the free poses' translation errors, gated < 0.05)."""
    return (float(se3.distance(poses, p.poses).mean()),
            float(torch.linalg.norm(poses.t[2:] - p.poses.t[2:])))


def point_problem(device=None):
    """tests/test_solvers.py's point-only BA problem: `make_scene(n_kf=4,
    n_pts=32)` (default_rng(0): landmarks 4-6 m ahead, keyframes 0.15 m
    apart), exact pixels, the landmarks 5 cm off (default_rng(2)).  Returns
    (cam, poses SE3 [4], the truth [32, 3], the start [32, 3],
    Observations)."""
    dev = resolve_device(device)
    K, N = 4, 32
    rng = np.random.default_rng(0)
    cam = PinholeCamera.create(500.0, 500.0, 320.0, 240.0)
    pts = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    Rs, ts = [], []
    for k in range(K):
        w = rng.normal(size=3) * 0.03
        t = np.array([k * 0.15, 0.0, 0.0]) + rng.normal(size=3) * 0.02
        Rs.append(so3.exp(torch.tensor(w, dtype=torch.float32, device=dev)))
        ts.append(torch.tensor(t, dtype=torch.float32, device=dev))
    poses = SE3(torch.stack(Rs), torch.stack(ts))
    truth = torch.tensor(pts, device=dev)
    px = cam.world_to_pixel(truth, SE3(poses.R[:, None], poses.t[:, None]), distorted=False)
    noisy = truth + torch.tensor(np.random.default_rng(2).normal(0, 0.05, pts.shape),
                                 dtype=torch.float32, device=dev)
    obs = ba.Observations(torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(N),
                          torch.arange(N, dtype=torch.int32, device=dev).repeat(K),
                          px.reshape(K * N, 2), torch.ones(K * N, dtype=torch.bool, device=dev))
    return cam, poses, truth, noisy, obs


def current_problem(device=None):
    """tests/test_solvers.py's optimize_current problem: 4 keyframes
    (se3.exp of k x (0.15, 0.02, 0.05, 0.01, -0.02, 0)) observing 60
    landmarks 2.5-5 m ahead with 0.3 px noise (default_rng(0)); keyframe 3
    is the current one, its pose perturbed by (0.05, -0.04, 0.03, 0.01,
    -0.01, 0.02), the landmarks by 2 cm (default_rng(1)).  Returns (cam, the
    truth SE3 [4], the start SE3 [4], the truth [60, 3], the start [60, 3],
    Observations, 3)."""
    dev = resolve_device(device)
    K, L, cur = 4, 60, 3
    rng = np.random.default_rng(0)
    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    pts = torch.tensor(np.concatenate([rng.uniform(-1.5, 1.5, (L, 2)),
                                       rng.uniform(2.5, 5, (L, 1))], 1).astype(np.float32),
                       device=dev)
    poses = se3.exp(torch.tensor([[0.15 * k, 0.02 * k, 0.05 * k, 0.01 * k, -0.02 * k, 0.0]
                                  for k in range(K)], dtype=torch.float32, device=dev))
    px = []
    for k in range(K):
        uv = cam.camera_to_pixel(SE3(poses.R[k], poses.t[k]).apply(pts))
        px.append(uv + torch.tensor(rng.normal(0, 0.3, tuple(uv.shape)), dtype=torch.float32,
                                    device=dev))
    obs = ba.Observations(torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(L),
                          torch.arange(L, dtype=torch.int32, device=dev).repeat(K),
                          torch.cat(px), torch.ones(K * L, dtype=torch.bool, device=dev))
    bad = se3.boxplus(SE3(poses.R[cur], poses.t[cur]),
                      torch.tensor([0.05, -0.04, 0.03, 0.01, -0.01, 0.02], device=dev))
    R0, t0 = poses.R.clone(), poses.t.clone()
    R0[cur], t0[cur] = bad.R, bad.t
    noisy = pts + 0.02 * torch.tensor(np.random.default_rng(1).normal(size=(L, 3)),
                                      dtype=torch.float32, device=dev)
    return cam, poses, SE3(R0, t0), pts, noisy, obs, cur
