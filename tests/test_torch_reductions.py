"""CPU checks of the order of the port's reductions, on a numpy model of the
pose-BA kernel's grouped bisection and on the local BA's segment sums.

- The pose-BA body (csrc/pose_ba.cuh::med_bisect) takes its 12-step
  bisection medians 3 steps per reduction: it counts the 7 thresholds the
  next 3 steps could visit and walks the 3 decisions.  A float32 numpy
  model of it must give the 12-step binary search's result bit for bit.
- Local BA sums its blocks per segment in a canonical order
  (solvers/ba.py::block_segments), so the same observations in any row
  order give the same `_assemble` outputs bit for bit (on the card the
  float atomics of `index_add_` ordered them at random; the row
  permutation is the CPU's stand-in for that).
"""
import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.solvers import ba
from ygz_slam_tpu_torch.system.system import System

torch.set_num_threads(1)

F32 = np.float32


# -- grouped bisection ---------------------------------------------------

def _bisect_12(vals, mask, half):
    """The 12-step masked bisection median of pose_ba_gn_plain, in float32."""
    lo, hi = F32(0), F32((vals * mask).max())
    for _ in range(12):
        mid = F32(0.5) * (lo + hi)
        if F32(np.sum(mask * (vals <= mid))) >= half:
            hi = mid
        else:
            lo = mid
    return F32(0.5) * (lo + hi)


def _bisect_grouped(vals, mask, half):
    """The kernel's: 4 groups of 3 steps, each one count of 7 thresholds."""
    lo, hi = F32(0), F32((vals * mask).max())
    h = F32(0.5)
    for _ in range(4):
        m0 = h * (lo + hi)
        m1, m2 = h * (lo + m0), h * (m0 + hi)
        m = [m0, m1, m2, h * (lo + m1), h * (m1 + m0), h * (m0 + m2), h * (m2 + hi)]
        c = [F32(np.sum(mask * (vals <= t))) for t in m]
        l0 = c[0] >= half
        lo, hi = (lo, m[0]) if l0 else (m[0], hi)
        c1, t1 = (c[1], m[1]) if l0 else (c[2], m[2])
        l1 = c1 >= half
        lo, hi = (lo, t1) if l1 else (t1, hi)
        c2 = (c[3] if l1 else c[4]) if l0 else (c[5] if l1 else c[6])
        t2 = (m[3] if l1 else m[4]) if l0 else (m[5] if l1 else m[6])
        lo, hi = (lo, t2) if c2 >= half else (t2, hi)
    return h * (lo + hi)


def _residuals(seed, n):
    rng = np.random.default_rng(seed)
    vals = np.abs(rng.standard_cauchy(n)).astype(F32) * F32(rng.uniform(0.1, 5.0))
    mask = (rng.random(n) < rng.uniform(0.3, 1.0)).astype(F32)
    return vals, mask


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("n", [1, 7, 31, 200, 512])
def test_grouped_bisection_is_the_12_step_bisection(seed, n):
    vals, mask = _residuals(seed, n)
    half = F32(0.5) * F32(mask.sum())
    for center in (F32(0), _bisect_12(vals, mask, half)):      # the median, then the MAD
        v = np.abs(vals - center).astype(F32)
        a, b = _bisect_12(v, mask, half), _bisect_grouped(v, mask, half)
        assert a.tobytes() == b.tobytes(), (a, b)


@pytest.mark.parametrize("seed", range(6))
def test_grouped_bisection_with_ties_at_a_midpoint(seed):
    """Residuals planted on the thresholds the search visits (each one a
    midpoint the bisection compares with `<=`), so the counts change
    exactly at a visited threshold."""
    vals, mask = _residuals(100 + seed, 200)
    half = F32(0.5) * F32(mask.sum())
    lo, hi = F32(0), F32((vals * mask).max())
    visited = []
    for _ in range(12):
        mid = F32(0.5) * (lo + hi)
        visited.append(mid)
        if F32(np.sum(mask * (vals <= mid))) >= half:
            hi = mid
        else:
            lo = mid
    rng = np.random.default_rng(seed)
    idx = rng.choice(200, 60, replace=False)
    vals[idx] = np.asarray(visited, F32)[rng.integers(0, 12, 60)]
    mask[idx] = 1.0
    half = F32(0.5) * F32(mask.sum())
    assert _bisect_12(vals, mask, half).tobytes() == _bisect_grouped(vals, mask, half).tobytes()
    # All on one midpoint: the count jumps from 0 to all there.
    same = np.full(50, visited[5], F32)
    ones = np.ones(50, F32)
    assert (_bisect_12(same, ones, F32(25)).tobytes()
            == _bisect_grouped(same, ones, F32(25)).tobytes())


# -- local BA: order-independent block sums --------------------------------

def _ba_problem(seed, K=5, L=150, F=96):
    """A local-BA problem in the map's table layout: K keyframes x F
    feature rows, each keyframe observing a distinct subset of L landmarks,
    rows past the observations masked (landmark index 0, as the map's
    unlinked rows clamp to)."""
    rng = np.random.default_rng(seed)
    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    pts = np.c_[rng.uniform(-1.5, 1.5, (L, 2)), rng.uniform(2.0, 5.0, L)].astype(F32)
    Ts = [tse3.exp(torch.tensor([0.1 * k, 0.01 * k, 0.02 * k, 0.004 * k, -0.02 * k, 0.003 * k],
                                dtype=torch.float32)) for k in range(K)]
    kf, pt, px, mask = [], [], [], []
    for k in range(K):
        seen = rng.choice(L, F - 10, replace=False)
        uv = cam.world_to_pixel(torch.tensor(pts[seen]), Ts[k]).numpy()
        uv = uv + rng.normal(0, 0.7, uv.shape).astype(F32)
        kf += [k] * F
        pt += list(seen) + [0] * 10
        px.append(np.r_[uv, np.zeros((10, 2), F32)])
        mask += [True] * (F - 10) + [False] * 10
    poses = SE3(torch.stack([T.R for T in Ts]), torch.stack([T.t for T in Ts]))
    pts0 = torch.tensor(pts + rng.normal(0, 0.01, pts.shape).astype(F32))
    obs = ba.Observations(torch.tensor(kf, dtype=torch.int32), torch.tensor(pt, dtype=torch.int32),
                          torch.tensor(np.concatenate(px)), torch.tensor(mask))
    fixed = torch.tensor([True, True] + [False] * (K - 2))
    return cam, poses, pts0, obs, fixed


def _permuted(obs, perm):
    return ba.Observations(*(a[perm] for a in obs))


@pytest.mark.parametrize("seed", range(4))
def test_assemble_is_independent_of_row_order(seed):
    cam, poses, pts, obs, fixed = _ba_problem(seed)
    K, L = fixed.shape[0], pts.shape[0]
    out = ba._assemble(poses, pts, obs, cam, fixed, 2.0, ba.block_segments(obs, K, L))
    perm = torch.from_numpy(np.random.default_rng(10 + seed).permutation(obs.mask.shape[0]))
    pobs = _permuted(obs, perm)
    pout = ba._assemble(poses, pts, pobs, cam, fixed, 2.0, ba.block_segments(pobs, K, L))
    for name, a, b in zip(("Hcc", "Hll", "W", "bc", "bl"), out[:5], pout[:5]):
        assert torch.equal(a, b), name
    # chi2 is a plain sum over the rows (order-dependent in the last bits).
    chi2, pchi2 = float(out[5].sum()), float(pout[5].sum())
    assert abs(chi2 - pchi2) <= 1e-5 * chi2
    # With frozen weights too, as the LM loop calls it.
    r, _, _, valid = ba.reproject(poses, pts, obs, cam)
    w = ba._irls_weights(r, valid, 2.0)
    a = ba._assemble(poses, pts, obs, cam, fixed, 2.0, ba.block_segments(obs, K, L), w)
    b = ba._assemble(poses, pts, pobs, cam, fixed, 2.0, ba.block_segments(pobs, K, L), w[perm])
    assert all(torch.equal(x, y) for x, y in zip(a[:5], b[:5]))


@pytest.mark.parametrize("seed", range(3))
def test_segment_sums_are_index_add_over_unmasked_rows(seed):
    cam, poses, pts, obs, fixed = _ba_problem(seed)
    K, L = fixed.shape[0], pts.shape[0]
    seg = ba.block_segments(obs, K, L)
    v = torch.tensor(np.random.default_rng(seed).normal(size=(obs.mask.shape[0], 3, 2)),
                     dtype=torch.float64)
    m = obs.mask
    kf, pt = obs.kf_idx.long(), obs.pt_idx.long()
    for got, idx, n in ((ba.segment_sum(v, seg.kf), kf, K), (ba.segment_sum(v, seg.pt), pt, L),
                        (ba.segment_sum(v, seg.pair), kf * L + pt, K * L)):
        want = torch.zeros((n, 3, 2), dtype=v.dtype).index_add_(0, idx[m], v[m])
        assert got.shape == want.shape and torch.allclose(got, want, rtol=0, atol=1e-12)


def test_local_ba_row_order_gives_the_same_result():
    cam, poses, pts, obs, fixed = _ba_problem(7)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(obs.mask.shape[0]))
    a = ba.local_ba(poses, pts, obs, cam, fixed, n_iter=5)
    b = ba.local_ba(poses, pts, _permuted(obs, perm), cam, fixed, n_iter=5)
    assert torch.equal(a.poses.R, b.poses.R) and torch.equal(a.poses.t, b.poses.t)
    assert torch.equal(a.points, b.points)
    assert torch.equal(a.inlier[perm], b.inlier)


# -- System's signature -------------------------------------------------------

def test_system_config_file_is_not_ported(tmp_path):
    """Configuration files are ported now: a path is read as YAML (a
    missing file raises as `open` does) and its camera and options apply."""
    from ygz_slam_tpu_torch.system.config import Config
    with pytest.raises(FileNotFoundError):
        System(str(tmp_path / "missing.yaml"))
    p = tmp_path / "cfg.yaml"
    p.write_text("camera:\n  fx: 300.0\n  fy: 300.0\n  cx: 160.0\n  cy: 120.0\n"
                 "keyframe:\n  min_frames: 7\n")
    try:
        s = System(str(p), device="cpu")
    finally:
        Config.clear()
    assert s.vo.cam.fx == 300.0 and s.vo.o.kf_min_frames == 7


def test_system_takes_the_camera_by_keyword():
    from ygz_slam_tpu_torch.models import mono_workload as mw
    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    s = System(camera=cam, options=mw.mono_options(), device="cpu")
    assert s.vo.cam is cam or s.vo.cam.fx == cam.fx
    s2 = System(None, cam, options=mw.mono_options(), device="cpu")   # the JAX order
    assert s2.status is s.status
    with pytest.raises(TypeError, match="camera="):
        System(cam, options=mw.mono_options(), device="cpu")
    with pytest.raises(ValueError, match="no camera"):
        System(options=mw.mono_options(), device="cpu")
