"""Offline trajectory and map figures, and the point-cloud file
(counterpart of ygz_slam_tpu/system/viewer.py; the reference's Pangolin
viewer, src/viewer.cpp, written to disk for a host without a display).

`save_ply` needs numpy only.  The plotting functions import matplotlib (Agg
backend) when called, so the package imports without it.
"""
from __future__ import annotations

import numpy as np

from ..utils import np_se3
from .trajectory import camera_centers


def save_ply(path: str, points) -> None:
    """An [N, 3] world point cloud as ASCII PLY (finite rows only): the
    portable file of the DENSE map type, for any mesh viewer."""
    if hasattr(points, "detach"):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def plot_trajectory(path: str, est_poses_cw, gt_poses_cw=None, title: str = "trajectory"):
    """Top-down and 3D trajectory figure (png) from T_cw poses (SE3s or
    params7)."""
    plt = _pyplot()
    est = camera_centers(est_poses_cw)
    fig = plt.figure(figsize=(10, 5))
    ax1 = fig.add_subplot(121)
    ax1.plot(est[:, 0], est[:, 2], "-", lw=1.5, label="estimate")
    if gt_poses_cw is not None:
        gt = camera_centers(gt_poses_cw)
        ax1.plot(gt[:, 0], gt[:, 2], "--", lw=1.0, label="ground truth")
    ax1.set_xlabel("x")
    ax1.set_ylabel("z")
    ax1.axis("equal")
    ax1.legend()
    ax1.set_title(title)
    ax2 = fig.add_subplot(122, projection="3d")
    ax2.plot(est[:, 0], est[:, 1], est[:, 2], lw=1.0)
    if gt_poses_cw is not None:
        ax2.plot(gt[:, 0], gt[:, 1], gt[:, 2], "--", lw=0.8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_map(path: str, map_state, trajectory=None, title: str = "map"):
    """Keyframe frusta and landmarks of a MapState (the Pangolin view)."""
    plt = _pyplot()
    pts = _np(map_state.pt_pos)[_np(map_state.pt_valid)]
    pose7 = _np(map_state.kf_pose7)
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=2, alpha=0.5, label=f"{len(pts)} landmarks")
    corners = np.array([[-1, -0.75, 1], [1, -0.75, 1], [1, 0.75, 1], [-1, 0.75, 1]]) * 0.1
    for k in np.where(_np(map_state.kf_valid))[0]:
        R, t = np_se3.params7_to_Rt(pose7[k])
        c = -(R.T @ t)
        pts_w = corners @ R + c          # (R^T corners^T)^T + c
        for p in pts_w:
            ax.plot(*zip(c, p), "r-", lw=0.5)
        loop = np.vstack([pts_w, pts_w[:1]])
        ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], "r-", lw=0.5)
    if trajectory is not None:
        tr = camera_centers(trajectory)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], "g-", lw=1.0, label="trajectory")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_tracked_points(path: str, img, px_prev, px_cur, mask, title: str = "tracked"):
    """Tracked-feature overlay (Tracker::PlotTrackedPoints,
    Tracker.cpp:129-149) written to disk."""
    plt = _pyplot()
    m = _np(mask).astype(bool)
    p0, p1 = _np(px_prev)[m], _np(px_cur)[m]
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(_np(img), cmap="gray")
    for a, b in zip(p0, p1):
        ax.plot([a[0], b[0]], [a[1], b[1]], "g-", lw=0.6)
    ax.plot(p1[:, 0], p1[:, 1], "r.", ms=2)
    ax.set_title(f"{title} ({len(p1)} tracks)")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
