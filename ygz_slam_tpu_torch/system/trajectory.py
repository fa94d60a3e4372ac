"""Trajectory save/load in the TUM format, the Sim(3)-aligned ATE and the
relative pose error (counterpart of ygz_slam_tpu/system/trajectory.py).

Poses are params7 arrays (wxyz quaternion + t of T_cw) or port SE3s.
Everything but `rpe_rmse` runs on the host in numpy; `rpe_rmse` composes
the poses as one batch on their device and fetches the errors once.
Trajectories are written as the TUM RGB-D benchmark writes them
(`timestamp tx ty tz qx qy qz qw`, camera-to-world).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import so3
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


def _stacked(poses) -> SE3:
    """One batched SE3 [n] of a list of SE3s, of params7 tensors (on their
    device) or of params7 arrays (on the CPU)."""
    if isinstance(poses[0], SE3):
        return SE3(torch.stack([p.R for p in poses]), torch.stack([p.t for p in poses]))
    if isinstance(poses[0], torch.Tensor):
        return SE3.from_params7(torch.stack(list(poses)))
    return SE3.from_params7(torch.as_tensor(np.asarray(poses, np.float32)))


def rpe_rmse(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over `delta`-frame intervals: est_poses /
    gt_poses are lists of T_cw (SE3s or params7).  Returns (trans_rmse,
    rot_rmse_rad) as floats, NaN when no interval fits."""
    n = min(len(est_poses), len(gt_poses))
    if n <= delta:
        return float("nan"), float("nan")
    E, G = _stacked(est_poses[:n]), _stacked(gt_poses[:n])
    G = SE3(G.R.to(E.R.device), G.t.to(E.t.device))

    def step(T: SE3) -> SE3:
        return SE3(T.R[delta:], T.t[delta:]).compose(SE3(T.R[:-delta], T.t[:-delta]).inverse())

    err = step(G).inverse().compose(step(E))
    et_er = torch.stack([torch.linalg.norm(err.t, dim=-1),
                         torch.linalg.norm(so3.log(err.R), dim=-1)]).cpu().numpy()
    return tuple(float(np.sqrt(np.mean(np.square(v.astype(np.float64))))) for v in et_er)


def camera_centers(poses_cw) -> np.ndarray:
    """[N, 3] camera centres in the world frame, -R^T t, from T_cw poses
    (SE3s or params7)."""
    out = []
    for p in poses_cw:
        R, t = np_se3.params7_to_Rt(_params7(p))
        out.append(-(R.T @ t))
    return np.asarray(out).reshape(-1, 3)
