"""The reference's comparison on known answers."""
import numpy as np
import pytest

from slambench import reference, scene


def _rot(seed):
    R, _ = scene.se3_exp(np.random.default_rng(seed).normal(size=6))
    return R


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(40, 3))
    R, t, s = _rot(1), np.array([0.3, -1.0, 2.0]), 2.5
    s2, R2, t2 = reference.umeyama_sim3(src, s * src @ R.T + t)
    assert s2 == pytest.approx(s) and np.allclose(R2, R) and np.allclose(t2, t)


def test_se3_log_inverts_exp():
    xi = np.array([0.1, -0.2, 0.3, 0.4, -0.5, 0.6])
    R, t = scene.se3_exp(xi)
    assert np.allclose(scene.se3_log(R, t), xi)
    assert scene.pose_distance(R, t, R, t) == pytest.approx(0.0, abs=1e-12)


def test_box_surface_distance():
    d = scene.box_surface_distance([4, 2, 4], np.array([[0, 0, 0], [3.5, 0, 0], [5, 0, 0],
                                                         [0, 2, 3]]))
    assert np.allclose(d, [2.0, 0.5, 1.0, 0.0])


def _mono_case(n=260):
    """A monocular run that returned the truth up to a similarity, with
    landmarks on the walls."""
    Rs, ts = [], []
    for k in range(n):
        R, t = scene.loop_pose(0.004 * k, 1.8, 0.08, np.zeros(3))
        Rs.append(R)
        ts.append(t)
    R_gt, t_gt = np.stack(Rs), np.stack(ts)
    # The map's frame: world = s * Q * map + c.
    s, Q, c = 2.0, _rot(3), np.array([0.5, 0.1, -0.3])
    R_est = np.einsum("nij,jk->nik", R_gt, Q)
    t_est = (t_gt + np.einsum("nij,j->ni", R_gt, c)) / s
    walls = np.array([[4.0, 0.3, 1.0], [-1.0, 2.0, 0.5], [0.2, -0.4, -4.0]])
    pts = ((walls - c) @ Q) / s
    return dict(frame=np.arange(n), status=["GOOD"] * n, R=R_est, t=t_est, R_gt=R_gt,
                t_gt=t_gt, window_from=20, landmarks=pts, half=[4.0, 2.0, 4.0])


def test_judge_mono_exact():
    out = _mono_case()
    got = reference.judge("mono", out)
    assert got["ate_m"] < 1e-9 and got["pose_err_max_m"] < 1e-9
    assert got["landmark_wall_median_m"] < 1e-9 and got["landmark_wall_p90_m"] < 1e-9
    assert got["good_share"] == 1.0


def test_judge_mono_counts_frames_not_tracked():
    """Frames that came back LOST count against the window, and set-up frames
    do not."""
    out = _mono_case()
    out["status"] = ["LOST" if k < 20 or k % 4 == 0 else "GOOD" for k in range(len(out["t"]))]
    got = reference.judge("mono", out)
    assert got["good_share"] == pytest.approx(1.0 - 60 / 240)
    assert got["ate_m"] < 1e-9


def test_judge_mono_sees_a_map_wrong_in_part():
    """A fifth of the landmarks off the walls leaves the median and moves
    the 90th percentile."""
    out = _mono_case()
    rng = np.random.default_rng(1)
    walls = np.c_[rng.uniform(-1, 1, 50), rng.uniform(-0.5, 0.5, 50), np.full(50, -4.0)]
    walls[:10, 2] += 1.0
    s, Q, c = 2.0, _rot(3), np.array([0.5, 0.1, -0.3])
    out["landmarks"] = ((walls - c) @ Q) / s
    got = reference.judge("mono", out)
    assert got["landmark_wall_median_m"] < 1e-9
    assert got["landmark_wall_p90_m"] == pytest.approx(1.0)


def test_judge_mono_sees_one_altered_pose():
    out = _mono_case()
    out["t"] = out["t"].copy()
    out["t"][130] += np.array([0.25, 0.0, 0.0])
    got = reference.judge("mono", out)
    assert got["pose_err_max_m"] > 0.3


def test_judge_fleet():
    R, t = scene.se3_exp(np.array([0.04, -0.02, 0.01, 0.004, -0.006, 0.003]))
    q = np.array([1.0, 0, 0, 0])
    out = dict(frame=np.array([0, 0]), pose7=np.array([[np.r_[q, t]], [np.r_[q, t]]]),
               inliers=np.array([[200], [150]]), R_gt=R[None], t_gt=t[None], window_from=1,
               landmarks_n=200, inlier_gate=0.75)
    got = reference.judge("fleet", out)
    assert got["pose_err_max"] == pytest.approx(np.linalg.norm([0.004, -0.006, 0.003]),
                                                rel=1e-3)
    assert got["inlier_share_min"] == 0.75


def test_verdict():
    ok, rows = reference.verdict({"a": 1.0, "b": 0.8},
                                 {"a": {"limit": 2.0, "better": "lower"},
                                  "b": {"limit": 0.75, "better": "higher"}})
    assert ok and rows[0] == ("a", 1.0, 2.0, "<=")
    ok, _ = reference.verdict({"a": float("nan")}, {"a": {"limit": 2.0, "better": "lower"}})
    assert not ok


def test_mono_segments():
    from slambench.judges import mono

    assert mono.segments(40) == [(0, 40)]
    assert mono.segments(240) == [(0, 100), (100, 240)]
    assert mono.segments(260) == [(0, 100), (100, 200), (200, 260)]


def test_judge_mono_forgives_slow_scale_drift():
    """A path whose scale drifts 20% over the window: each segment still
    aligns, so the numbers stay near 0."""
    out = _mono_case()
    k = np.arange(len(out["t"]))[:, None]
    out["t"] = out["t"] * (1.0 + 0.2 * k / len(k))
    got = reference.judge("mono", out)
    assert got["ate_m"] < 0.02
