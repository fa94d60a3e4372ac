"""The batch path's kernels against the JAX package's, on the CPU: K2
`gather_windows_multi` (and `bilinear_patches_multi`), K6
`gather_windows_grouped` and K8 `pose_only_ba_fused_batch`, the JAX side
run in interpret mode, the port's side through its plain versions."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.ops.pallas import align2d_kernel as jak
from ygz_slam_tpu.ops.pallas.pose_ba_fused_batch import (
    pose_only_ba_fused_batch as jpose_only_ba_fused_batch)

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tak
from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused_batch as tk8

from _torch_port import jax_camera, jax_kernels_interpreted, np32

torch.set_num_threads(1)

# Bilinear mixes of 0-255 intensities in the same order (~1e-7 relative).
TOL_PATCH = 1e-4
# K8: the same rounds and GN iterations per sequence in float32, differing
# only in reduction order, so poses agree far below the 1e-4 stopping step
# (K5's tolerances).
TOL_POSE = 1e-4
MIN_INLIER_AGREE = 0.99


def _origins(rng, n, H, W, win, off_image):
    """int32 window origins: inside the image, or from [-40, W+10] x
    [-40, H+10] with the corners beyond W - win / H - win planted."""
    if off_image:
        xi = rng.integers(-40, W + 11, n)
        yi = rng.integers(-40, H + 11, n)
        xi[:4], yi[:4] = [-3, W - win + 3, -win - 2, 5], [H - win + 2, -2, 5, H + 4]
    else:
        xi = rng.integers(0, W - win + 1, n)
        yi = rng.integers(0, H - win + 1, n)
    return xi.astype(np.int32), yi.astype(np.int32)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("off_image", [False, True], ids=["inside", "off_image"])
def test_gather_windows_multi_exact(S, off_image):
    """K2's plain version returns the JAX kernel's windows bit for bit,
    zeros outside the image included."""
    rng = np.random.default_rng(20 + S)
    H, W, win = 120, 160, 32
    imgs = rng.uniform(0, 255, (S, H, W)).astype(np.float32)
    idx = rng.integers(0, S, 50).astype(np.int32)
    xi, yi = _origins(rng, 50, H, W, win, off_image)
    with jax_kernels_interpreted():
        ref = np.asarray(jak.gather_windows_multi(jnp.asarray(imgs), jnp.asarray(idx),
                                                  jnp.asarray(xi), jnp.asarray(yi), win))
    out = tak.gather_windows_multi(torch.tensor(imgs), torch.tensor(idx), torch.tensor(xi),
                                   torch.tensor(yi), win)
    np.testing.assert_array_equal(out.numpy(), ref)
    if off_image:
        assert (ref == 0).any()


@pytest.mark.parametrize("bad", [-1, 3], ids=["negative", "past_the_stack"])
def test_gather_windows_multi_rejects_bad_index(bad):
    """An image index outside [0, S) names no image of the stack: K2's
    plain version raises instead of wrapping or reading another image (the
    kernel stops on a device-side assert: tests/test_torch_cuda.py)."""
    imgs = torch.zeros(3, 40, 40)
    o = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(IndexError):
        tak.gather_windows_multi(imgs, torch.tensor([0, bad, 2], dtype=torch.int32), o, o, 7)


def test_bilinear_patches_multi():
    rng = np.random.default_rng(24)
    S, H, W = 3, 240, 320
    imgs = rng.uniform(0, 255, (S, H, W)).astype(np.float32)
    idx = rng.integers(0, S, 44).astype(np.int32)
    c = np.r_[np.c_[rng.uniform(0, W - 1, 40), rng.uniform(0, H - 1, 40)],
              [[0, 0], [W - 1, H - 1], [W - 4, H - 2], [2, H - 3]]].astype(np.float32)
    with jax_kernels_interpreted():
        ref = np.asarray(jak.bilinear_patches_multi(jnp.asarray(imgs), jnp.asarray(idx),
                                                    jnp.asarray(c), 6))
    out = tak.bilinear_patches_multi(torch.tensor(imgs), torch.tensor(idx), torch.tensor(c), 6)
    print(f"measured: bilinear_patches_multi max |port - JAX| {np.abs(out.numpy() - ref).max():.3e}")
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL_PATCH)


@pytest.mark.parametrize("off_image", [False, True], ids=["inside", "off_image"])
def test_gather_windows_grouped_exact(off_image):
    """K6's plain version against the JAX kernel: four requests of mixed
    image sizes, windows and counts, the first image named twice."""
    rng = np.random.default_rng(25)
    imgs = [rng.uniform(0, 255, s).astype(np.float32) for s in ((240, 320), (120, 160),
                                                                 (60, 80))]
    spec = [(0, 16, 30), (1, 16, 30), (2, 7, 20), (0, 32, 25)]
    groups_np = [(imgs[k], *_origins(rng, n, *imgs[k].shape, win, off_image), win)
                 for k, win, n in spec]
    with jax_kernels_interpreted():
        jimgs = [jnp.asarray(a) for a in imgs]
        ref = jak.gather_windows_grouped(
            [(jimgs[k], jnp.asarray(xi), jnp.asarray(yi), win)
             for (k, _, _), (_, xi, yi, win) in zip(spec, groups_np)])
    timgs = [torch.tensor(a) for a in imgs]
    out = tak.gather_windows_grouped(
        [(timgs[k], torch.tensor(xi), torch.tensor(yi), win)
         for (k, _, _), (_, xi, yi, win) in zip(spec, groups_np)])
    assert len(out) == len(ref) == len(spec)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_req", [24, 48])
def test_gather_windows_grouped_many_requests(n_req):
    """K6's plain version against the JAX kernel on a batched frame's worth
    of requests (S=8 and S=16 sequences of three levels: 24 and 48): three
    image sizes, windows 7, 16 and 32 in turn, a third of the origins off
    the image, the first image named in every third request."""
    rng = np.random.default_rng(26 + n_req)
    imgs = [rng.uniform(0, 255, s).astype(np.float32) for s in ((240, 320), (120, 160),
                                                                 (60, 80))]
    spec = [(0 if k % 3 == 0 else k % 3, (7, 16, 32)[k % 3], 6 + k % 5) for k in range(n_req)]
    groups_np = [(imgs[i], *_origins(rng, n, *imgs[i].shape, win, k % 3 == 1), win)
                 for k, (i, win, n) in enumerate(spec)]
    with jax_kernels_interpreted():
        jimgs = [jnp.asarray(a) for a in imgs]
        ref = jak.gather_windows_grouped(
            [(jimgs[i], jnp.asarray(xi), jnp.asarray(yi), win)
             for (i, _, _), (_, xi, yi, win) in zip(spec, groups_np)])
    timgs = [torch.tensor(a) for a in imgs]
    out = tak.gather_windows_grouped(
        [(timgs[i], torch.tensor(xi), torch.tensor(yi), win)
         for (i, _, _), (_, xi, yi, win) in zip(spec, groups_np)])
    assert len(out) == len(ref) == n_req <= tak.MAX_GROUPS
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert any((np.asarray(b) == 0).all(axis=(1, 2)).any() for b in ref)


def test_gather_windows_grouped_takes_at_most_eight():
    img = torch.zeros(40, 40)
    o = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tak.gather_windows_grouped([(img, o, o, 7)] * (tak.MAX_GROUPS + 1))


CAM = PinholeCamera.create(500.0, 500.0, 320.0, 240.0)


def _pose_problem(S, N, seed, n_out, n_masked, dead=()):
    """S pose-only BA problems: points 2.5-6 m ahead, observed at a true
    pose with 0.3 px noise, `n_out` gross outliers (15-60 px) and
    `n_masked` masked rows each; sequences in `dead` fully masked.  Each
    starts ~0.02 from its truth."""
    rng = np.random.default_rng(seed)
    pts, px, msk, T07, T_true = [], [], [], [], []
    for s in range(S):
        p = np.c_[rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                  rng.uniform(2.5, 6.0, N)].astype(np.float32)
        T = tse3.exp(torch.tensor(rng.uniform(-1, 1, 6) * [0.05, 0.05, 0.08, 0.02, 0.02, 0.02],
                                  dtype=torch.float32))
        o = np32(CAM.world_to_pixel(torch.tensor(p), T, distorted=False))
        o = o + rng.normal(0, 0.3, o.shape)
        bad = rng.choice(N, n_out + n_masked, replace=False)
        o[bad[:n_out]] += rng.uniform(15, 60, (n_out, 2))
        m = np.ones(N, bool)
        m[bad[n_out:]] = False
        if s in dead:
            m[:] = False
        dT = tse3.exp(torch.tensor(rng.uniform(-1, 1, 6) * [0.01, 0.01, 0.01, 0.004, 0.004, 0.004],
                                   dtype=torch.float32))
        pts.append(p)
        px.append(o.astype(np.float32))
        msk.append(m)
        T07.append(np32(dT.compose(T).params7()))
        T_true.append(T)
    return np.stack(pts), np.stack(px), np.stack(msk), np.stack(T07), T_true


POSE_CASES = {"outliers": (4, 200, 30, 30, 10, ()),
              "one_sequence_masked": (3, 150, 31, 20, 5, (1,))}


@pytest.mark.parametrize("name", sorted(POSE_CASES))
def test_pose_ba_batch_matches_jax_kernel(name):
    """K8's plain version against the interpreted JAX K8, per sequence."""
    S, N, seed, n_out, n_mask, dead = POSE_CASES[name]
    pts, px, msk, T07, T_true = _pose_problem(S, N, seed, n_out, n_mask, dead)
    with jax_kernels_interpreted():
        Tj, inl_j, chi2_j = jpose_only_ba_fused_batch(
            JSE3.from_params7(jnp.asarray(T07)), jnp.asarray(pts), jnp.asarray(px),
            jnp.asarray(msk), jax_camera(CAM))
    Rj, tj = np32(Tj.R), np32(Tj.t)
    assert np.isfinite(Rj).all() and np.isfinite(tj).all(), "JAX reference pose not finite"
    T, inl, chi2 = tk8.pose_only_ba_fused_batch(
        TSE3.from_params7(torch.tensor(T07)), torch.tensor(pts), torch.tensor(px),
        torch.tensor(msk), CAM)
    d = tse3.distance(T, TSE3(torch.tensor(Rj), torch.tensor(tj)))
    agree = (np32(inl) == np32(inl_j)).mean(axis=1)
    print(f"measured: K8 {name} pose distance {float(d.max()):.3e}, "
          f"inlier agreement {agree.min():.4f}")
    assert float(d.max()) <= TOL_POSE, d
    assert agree.min() >= MIN_INLIER_AGREE, agree
    np.testing.assert_allclose(np32(chi2), np32(chi2_j), rtol=1e-3, atol=1e-6)
    assert not np32(inl)[~msk].any()                  # masked rows never inliers
    for s in range(S):
        if s in dead:                                 # nothing to fit: pose kept
            np.testing.assert_allclose(np32(T.t[s]), T07[s, 4:], atol=1e-6)
        else:
            assert float(tse3.distance(TSE3(T.R[s], T.t[s]), T_true[s])) < 5e-3


def test_pose_ba_batch_independent_of_a_diverging_neighbour():
    """A sequence started ~20 px off its observations, beside a normal one.
    The JAX kernel's solve of the first goes NaN (its step guard keeps a
    NaN step, ROADMAP queue 3), and since its shared loop counter is
    derived from chi2, a NaN chi2 also ends the GN loop of the other
    sequence; the port solves each sequence on its own: the first
    converges, the second matches the JAX kernel run on it alone."""
    rng = np.random.default_rng(1)
    N = 150
    p = np.c_[rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
              rng.uniform(2.5, 6.0, N)].astype(np.float32)
    T_far = tse3.exp(torch.tensor([0.0333, -0.0425, 0.0526, 0.0126, -0.0163, 0.0129]))
    o = np32(CAM.world_to_pixel(torch.tensor(p), T_far, distorted=False))
    o = (o + rng.normal(0, 0.3, o.shape)).astype(np.float32)
    T0_far = tse3.exp(torch.tensor([0.0231, 0.0051, 0.0303, -0.0061, 0.0101, -0.0048]))
    pts1, px1, msk1, T07_1, T_true1 = _pose_problem(1, N, 30, 20, 5)
    pts, px = np.stack([p, pts1[0]]), np.stack([o, px1[0]])
    msk = np.stack([np.ones(N, bool), msk1[0]])
    T07 = np.stack([np32(T0_far.params7()), T07_1[0]])

    def jax_k8(sl):
        with jax_kernels_interpreted():
            return jpose_only_ba_fused_batch(
                JSE3.from_params7(jnp.asarray(T07[sl])), jnp.asarray(pts[sl]),
                jnp.asarray(px[sl]), jnp.asarray(msk[sl]), jax_camera(CAM))

    Tj_pair, _, _ = jax_k8(slice(0, 2))
    Tj_alone, inl_j, _ = jax_k8(slice(1, 2))
    T, inl, _ = tk8.pose_only_ba_fused_batch(
        TSE3.from_params7(torch.tensor(T07)), torch.tensor(pts), torch.tensor(px),
        torch.tensor(msk), CAM)
    jpose = [TSE3(torch.tensor(np32(Tj.R[k])), torch.tensor(np32(Tj.t[k])))
             for Tj, k in ((Tj_pair, 1), (Tj_alone, 0))]
    d_alone = float(tse3.distance(TSE3(T.R[1], T.t[1]), jpose[1]))
    print(f"measured: JAX pair, first sequence finite: {bool(np.isfinite(np32(Tj_pair.t[0])).all())}"
          f"; second sequence, JAX pair vs JAX alone "
          f"{float(tse3.distance(jpose[0], jpose[1])):.3e}, port vs JAX alone {d_alone:.3e}; "
          f"port's first sequence {float(tse3.distance(TSE3(T.R[0], T.t[0]), T_far)):.3e} "
          f"from its truth, {int(inl[0].sum())} inliers")
    assert bool(torch.isfinite(T.R).all() and torch.isfinite(T.t).all())
    assert float(tse3.distance(TSE3(T.R[0], T.t[0]), T_far)) < 5e-3
    assert d_alone <= TOL_POSE
    assert (np32(inl[1]) == np32(inl_j[0])).mean() >= MIN_INLIER_AGREE
