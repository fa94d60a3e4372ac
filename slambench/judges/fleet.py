"""Fleet cells: `pose_err_max` is the largest ||log(T T_true^-1)|| over every
stream's every step of the window, and `inlier_share_min` the smallest share
of a stream's landmarks a step counted as inliers."""
from __future__ import annotations

import numpy as np

from slambench import scene


def judge(out: dict) -> dict:
    win = np.asarray(out["frame"])[out["window_from"]:]
    poses = out["pose7"][out["window_from"]:]
    inl = out["inliers"][out["window_from"]:]
    if len(win) == 0:
        return {"pose_err_max": float("inf"), "inlier_share_min": 0.0}
    worst = 0.0
    for i, p in zip(win, poses):
        for p7 in p:
            R, t = scene.pose7_to_Rt(p7)
            d = scene.pose_distance(R, t, out["R_gt"][i], out["t_gt"][i])
            worst = max(worst, d if np.isfinite(d) else float("inf"))
    return {"pose_err_max": worst,
            "inlier_share_min": float(inl.min()) / out["landmarks_n"]}
