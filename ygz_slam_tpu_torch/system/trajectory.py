"""Trajectory save/load in the TUM format and the Sim(3)-aligned ATE
(counterpart of ygz_slam_tpu/system/trajectory.py).

Everything here runs on the host in numpy: poses are params7 arrays
(wxyz quaternion + t of T_cw) or port SE3s, which are fetched once.
Trajectories are written as the TUM RGB-D benchmark writes them
(`timestamp tx ty tz qx qy qz qw`, camera-to-world).
"""
from __future__ import annotations

import numpy as np

from ..geometry.se3 import SE3
from ..utils import np_se3


def _params7(p) -> np.ndarray:
    """params7 of T_cw from a port SE3 or anything array-like of 7 values."""
    if isinstance(p, SE3):
        p = p.params7()
    if hasattr(p, "detach"):
        p = p.detach().cpu().numpy()
    return np.asarray(p, np.float64)


def save_tum(path: str, stamps, poses_cw) -> None:
    """Write T_cw poses (SE3 or params7) in TUM format: camera-to-world,
    quaternion in xyzw order."""
    with open(path, "w") as f:
        for ts, p in zip(stamps, poses_cw):
            q_t = np_se3.inverse7(_params7(p))
            q, t = q_t[:4], q_t[4:]
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def load_tum(path: str):
    """Read a TUM trajectory -> (stamps [N], T_cw params7 [N, 7])."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, tx, ty, tz, qx, qy, qz, qw = (float(x) for x in line.split()[:8])
            stamps.append(ts)
            poses.append(np_se3.inverse7(np.asarray([qw, qx, qy, qz, tx, ty, tz])))
    return np.asarray(stamps), np.asarray(poses).reshape(-1, 7)


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity (or rigid) alignment est -> gt.
    Returns (s, R, t) with gt ~ s * R @ est + t."""
    est, gt = np.asarray(est, float), np.asarray(gt, float)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = g.T @ e / len(e)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e ** 2).sum() / len(e)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_centers, gt_centers, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment
    (monocular: with_scale=True)."""
    est = np.asarray(est_centers, float)
    gt = np.asarray(gt_centers, float)
    s, R, t = umeyama_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(axis=1).mean()))


def camera_centers(poses_cw) -> np.ndarray:
    """[N, 3] camera centres in the world frame, -R^T t, from T_cw poses
    (SE3s or params7)."""
    out = []
    for p in poses_cw:
        R, t = np_se3.params7_to_Rt(_params7(p))
        out.append(-(R.T @ t))
    return np.asarray(out).reshape(-1, 3)
