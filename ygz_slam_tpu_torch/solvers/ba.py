"""Pose-only bundle adjustment (counterpart of the pose_only_ba entry of
ygz_slam_tpu/solvers/ba.py).  The port has only the fused path: K5 on
the card, its plain version on the CPU."""
from __future__ import annotations

import torch

from ..geometry.se3 import SE3
from ..ops.kernels.pose_ba_fused import CHI2_2D, pose_only_ba_fused


def pose_only_ba(T_cw: SE3, points: torch.Tensor, px: torch.Tensor,
                 mask: torch.Tensor, cam, rounds: int = 4,
                 iters_per_round: int = 10, chi2_th: float = CHI2_2D):
    """Optimize one camera pose against fixed 3D points: 4 rounds of
    robust Gauss-Newton with chi2 inlier reclassification (BA.cpp:188-264).
    `px` are raw detections; they are undistorted once here.  Returns
    (pose, inlier mask [N] bool, final chi2)."""
    if points.dtype != torch.float32:
        raise ValueError(f"pose_only_ba takes float32 points, got {points.dtype}")
    return pose_only_ba_fused(T_cw, points, cam.undistort_px(px), mask, cam,
                              rounds=rounds, iters_per_round=iters_per_round,
                              chi2_th=chi2_th)
