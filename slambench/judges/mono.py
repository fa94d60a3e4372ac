"""Monocular cells.  The window's GOOD frames are cut into segments of
`SEGMENT` frames (a last one shorter than half a segment joins the one
before); each segment's returned camera path is aligned to the truth by the
Sim(3) of Umeyama (1991), since the map's scale and frame are the system's
own and drift slowly.  `ate_m` is the largest segment RMS of the distance
from the truth, `pose_err_max_m` the largest single distance, and
`landmark_wall_median_m` and `landmark_wall_p90_m` the median and 90th
percentile distance from the room's walls of the map's landmarks after the
window, aligned by the last segment's Sim(3).  `good_share` is the share of
the window's frames that came back GOOD.  So the numbers read the same
whatever the window's length."""
from __future__ import annotations

import numpy as np

from slambench import scene
from slambench.reference import centres, umeyama_sim3

SEGMENT = 100


def segments(n: int) -> list:
    """[start, end) ranges covering n frames."""
    cuts = list(range(0, n, SEGMENT)) + [n]
    if len(cuts) > 2 and cuts[-1] - cuts[-2] < SEGMENT // 2:
        del cuts[-2]
    return list(zip(cuts[:-1], cuts[1:]))


def judge(out: dict) -> dict:
    window = np.asarray(out["frame"]) >= out["window_from"]
    sel = window & np.asarray([s == "GOOD" for s in out["status"]])
    numbers = {"good_share": float(sel.sum()) / max(int(window.sum()), 1),
               "ate_m": float("inf"), "pose_err_max_m": float("inf"),
               "landmark_wall_median_m": float("inf"), "landmark_wall_p90_m": float("inf")}
    if sel.sum() < 3:
        return numbers
    c_est = centres(out["R"], out["t"])[sel]
    c_gt = centres(out["R_gt"], out["t_gt"])[sel]
    rms, worst = 0.0, 0.0
    for a, b in segments(len(c_est)):
        s, R, t = umeyama_sim3(c_est[a:b], c_gt[a:b])
        err = np.linalg.norm(s * c_est[a:b] @ R.T + t - c_gt[a:b], axis=-1)
        rms = max(rms, float(np.sqrt(np.mean(err ** 2))))
        worst = max(worst, float(err.max()))
    numbers.update(ate_m=rms, pose_err_max_m=worst)
    pts = out["landmarks"]
    if len(pts):
        wall = scene.box_surface_distance(out["half"], s * pts @ R.T + t)
        numbers.update(landmark_wall_median_m=float(np.median(wall)),
                       landmark_wall_p90_m=float(np.percentile(wall, 90)))
    return numbers
