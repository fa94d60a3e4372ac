"""The port's public helpers that no ported path calls, each against its JAX
original on the CPU: `so3.vee` / `normalize`, `SE3.matrix` / `normalize`,
the camera's `K`, `distort_px`, `world_to_camera`, `camera_to_world`,
`in_frame` and `scaled`, `jacobians.dnorm_dxi`, `interp.image_gradients`,
`trajectory.rpe_rmse`, `warp.warp_patches`, `hamming.popcount_u32` and
`local_mapping.MappingResult`.  Inputs are made with numpy from seeds (or
tests/test_geometry.py's, where it has them) and handed to both packages.

Tolerances: elementwise float32 geometry TOL_GEOM (a few ulp: XLA and
PyTorch fuse and order differently); the SVD projection TOL_SVD (LAPACK's
and XLA's SVDs agree to ~1e-6, and the polar factor of a full-rank R is
unique, so their sign conventions do not matter); bilinear patches of
0-255 images TOL_PATCH (the 2x2 inverse is an adjugate here and an LU
there, so a sample coordinate may round to the next float32, 3.1e-5 px
near x = 300, and the texture steps by up to 255 per px: 7.8e-3), with
the mean held to TOL_PATCH_MEAN; `rpe_rmse` TOL_RPE
relative (a batched product here, one pose at a time there).  The image
gradients and popcounts are exact."""
import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry import jacobians as tjac, se3 as tse3, so3 as tso3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.models import local_mapping as tlm
from ygz_slam_tpu_torch.ops import hamming as tham, interp as tinterp, warp as twarp
from ygz_slam_tpu_torch.system import trajectory as ttraj
from ygz_slam_tpu_torch.utils import synthetic as tsyn

from _torch_port import jax_camera, np32

torch.set_num_threads(1)

TOL_GEOM = 2e-5
TOL_PX = 1e-3             # distort_px and its round trip, px (~16 float32 ulps at 500 px)
TOL_SVD = 1e-5
TOL_PATCH = 1e-2
TOL_PATCH_MEAN = 1e-4
TOL_RPE = 1e-5

# tests/test_geometry.py's TestCamera camera (TUM fr1, k1 = 0.2624) and a
# pinhole one.
FR1 = (517.3, 516.5, 325.1, 249.7, 0.2624, -0.9531, -0.0054, 0.0026)
PINHOLE = (320.0, 320.0, 160.0, 120.0)


def _tangent(n, scale=1.0, seed=1):
    """tests/test_geometry.py's random_tangent, as float32 numpy."""
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


def _jse3(T: SE3):
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import SE3 as JSE3

    return JSE3(jnp.asarray(np32(T.R)), jnp.asarray(np32(T.t)))


def _poses(batch, seed=3):
    """Port SE3s of shape `batch`, rotations up to ~1 rad, t up to ~2."""
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=tuple(batch) + (6,)) * [2.0, 2.0, 2.0, 0.6, 0.6, 0.6]).astype(np.float32)
    return tse3.exp(torch.from_numpy(xi))


def test_hat_vee():
    """vee inverts hat on test_hat_vee's tangents, and reads a general
    matrix as the JAX vee does."""
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import so3 as jso3

    w = _tangent(8)
    assert np.array_equal(tso3.vee(tso3.hat(torch.from_numpy(w))).numpy(), w)
    W = np.random.default_rng(5).normal(size=(2, 4, 3, 3)).astype(np.float32)
    assert np.array_equal(tso3.vee(torch.from_numpy(W)).numpy(),
                          np.asarray(jso3.vee(jnp.asarray(W))))


@pytest.mark.parametrize("case", ["rotation", "perturbed", "batched", "reflection"])
def test_so3_normalize(case):
    """The SVD projection onto SO(3) against JAX's: on rotations (a fixed
    point), on rotations with 1e-2 noise, on a [2, 3] batch and on matrices
    whose determinant is negative (the det(u vt) sign flip)."""
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import so3 as jso3

    rng = np.random.default_rng(9)
    R = np32(tso3.exp(torch.from_numpy(_tangent(16, 0.8))))
    if case == "perturbed":
        R = R + rng.normal(size=R.shape).astype(np.float32) * 1e-2
    elif case == "batched":
        R = (R[:6] + rng.normal(size=(6, 3, 3)).astype(np.float32) * 1e-2).reshape(2, 3, 3, 3)
    elif case == "reflection":
        # Distinct singular values (1.5, 1, 0.5): with tied ones the flipped
        # direction, and so the projection, would not be unique.
        R = R * np.asarray([1.5, 1.0, -0.5], np.float32)
    got = tso3.normalize(torch.from_numpy(R))
    want = np.asarray(jso3.normalize(jnp.asarray(R)))
    err = float(np.abs(got.numpy() - want).max())
    print(f"so3.normalize {case}: max |port - JAX| {err:.2e} (tolerance {TOL_SVD})")
    assert got.dtype == torch.float32 and got.shape == R.shape and err <= TOL_SVD
    eye = torch.eye(3).expand(got.shape)
    assert float((got @ got.transpose(-1, -2) - eye).abs().max()) <= TOL_SVD
    assert float((torch.linalg.det(got) - 1.0).abs().max()) <= TOL_SVD
    if case == "rotation":
        assert float((got - torch.from_numpy(R)).abs().max()) <= TOL_SVD


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_se3_matrix_and_normalize(batch):
    """`SE3.matrix` ([..., 4, 4], the batch shape kept) equals JAX's bit for
    bit; `SE3.normalize` projects R as `so3.normalize` and keeps t."""
    T = _poses(batch)
    J = _jse3(T)
    M = T.matrix()
    assert M.shape == tuple(batch) + (4, 4)
    assert np.array_equal(M.numpy(), np.asarray(J.matrix()))
    Tn = SE3(T.R * 1.003, T.t).normalize()
    Jn = SE3(T.R * 1.003, T.t)
    Jn = _jse3(Jn).normalize()
    assert torch.equal(Tn.t, T.t)
    assert float(np.abs(Tn.R.numpy() - np.asarray(Jn.R)).max()) <= TOL_SVD


@pytest.mark.parametrize("method", ["K", "distort_px", "world_to_camera", "camera_to_world",
                                    "in_frame", "scaled"])
@pytest.mark.parametrize("params", [FR1, PINHOLE], ids=["fr1", "pinhole"])
def test_camera(method, params):
    """Each camera helper against the JAX camera of the same intrinsics; the
    distorted camera's `distort_px` also round-trips through the port's
    `undistort_px`."""
    import jax.numpy as jnp

    cam = PinholeCamera.create(*params)
    jcam = jax_camera(cam)
    rng = np.random.default_rng(4)
    if method == "K":
        K = cam.K(device="cpu")
        assert K.dtype == torch.float32 and K.device.type == "cpu"
        assert np.array_equal(K.numpy(), np.asarray(jcam.K))
    elif method == "distort_px":
        # Ideal pixels within a normalized radius of ~0.35, where fr1's
        # k2 = -0.95 keeps the model invertible (test_world_pixel_roundtrip).
        px = (np.asarray([cam.cx, cam.cy]) + rng.uniform(-0.35, 0.35, size=(64, 2))
              * np.asarray([cam.fx, cam.fy])).astype(np.float32)
        got = cam.distort_px(torch.from_numpy(px))
        want = np.asarray(jcam.distort_px(jnp.asarray(px)))
        err = float(np.abs(got.numpy() - want).max())
        back = float((cam.undistort_px(got) - torch.from_numpy(px)).abs().max())
        print(f"distort_px: max |port - JAX| {err:.2e} px, undistort_px round trip {back:.2e} px")
        assert err <= TOL_PX and back <= TOL_PX
        if not cam.has_distortion:
            assert torch.equal(got, torch.from_numpy(px))
        else:
            assert float((got - torch.from_numpy(px)).abs().max()) > 1.0
    elif method in ("world_to_camera", "camera_to_world"):
        T = _poses((), seed=6)
        p = rng.uniform(-1.0, 1.0, size=(32, 3)).astype(np.float32)
        got = getattr(cam, method)(torch.from_numpy(p), T)
        want = np.asarray(getattr(jcam, method)(jnp.asarray(p), _jse3(T)))
        assert float(np.abs(got.numpy() - want).max()) <= TOL_GEOM
        inv = "camera_to_world" if method == "world_to_camera" else "world_to_camera"
        assert float((getattr(cam, inv)(got, T) - torch.from_numpy(p)).abs().max()) <= 1e-5
    elif method == "in_frame":
        # tests/test_geometry.py::test_in_frame's pixels, then random ones.
        px = np.asarray([[10.0, 10.0], [-1.0, 5.0], [639.0, 479.0], [635.0, 100.0]], np.float32)
        assert cam.in_frame(torch.from_numpy(px), 640, 480, boundary=20).tolist() == [False] * 4
        assert cam.in_frame(torch.from_numpy(px), 640, 480).tolist() == [True, False, True, True]
        px = rng.uniform(-20, 660, size=(256, 2)).astype(np.float32)
        for b in (0, 3, 20):
            got = cam.in_frame(torch.from_numpy(px), 640, 480, boundary=b)
            assert got.dtype == torch.bool
            assert np.array_equal(got.numpy(), np.asarray(jcam.in_frame(jnp.asarray(px), 640, 480,
                                                                        boundary=b)))
    else:
        for factor in (0.5, 0.25, 1.0 / 3.0, 1.7):
            got, want = cam.scaled(factor), jcam.scaled(factor)
            assert isinstance(got, PinholeCamera)
            assert [np.float32(v) for v in got] == [np.float32(np.asarray(v)) for v in want]


def test_dnorm_dxi():
    """dnorm_dxi against JAX's on points in front of the camera, and equal
    to duv_dxi at fx = fy = 1."""
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import jacobians as jjac

    pc = np.random.default_rng(2).uniform(-1.0, 1.0, size=(3, 17, 3)).astype(np.float32)
    pc[..., 2] = np.abs(pc[..., 2]) + 0.5
    got = tjac.dnorm_dxi(torch.from_numpy(pc))
    assert got.shape == (3, 17, 2, 6)
    assert float(np.abs(got.numpy() - np.asarray(jjac.dnorm_dxi(jnp.asarray(pc)))).max()) \
        <= TOL_GEOM
    assert torch.equal(got, tjac.duv_dxi(torch.from_numpy(pc), 1.0, 1.0))


@pytest.mark.parametrize("image", ["rendered", "random", "tiny"])
def test_image_gradients(image):
    """Central differences with zero borders, equal to JAX's bit for bit."""
    import jax.numpy as jnp
    from ygz_slam_tpu.ops import interp as jinterp

    if image == "rendered":
        cam = PinholeCamera.create(*PINHOLE)
        img = np32(tsyn.PlaneScene(cam, seed=0, device="cpu").render(
            SE3.identity(device="cpu"), (240, 320)))
    elif image == "random":
        img = np.random.default_rng(8).uniform(0, 255, size=(37, 53)).astype(np.float32)
    else:
        img = np.arange(6, dtype=np.float32).reshape(2, 3) ** 2
    gx, gy = tinterp.image_gradients(torch.from_numpy(img))
    jx, jy = jinterp.image_gradients(jnp.asarray(img))
    assert gx.shape == gy.shape == img.shape
    assert np.array_equal(gx.numpy(), np.asarray(jx)) and np.array_equal(gy.numpy(), np.asarray(jy))
    assert not gx[:, 0].any() and not gx[:, -1].any() and not gy[0].any() and not gy[-1].any()


@pytest.mark.parametrize("case", ["perturbed_d1", "perturbed_d3", "identical", "params7", "short"])
def test_rpe_rmse(case):
    """rpe_rmse on a loop_trajectory and a perturbed copy against JAX's
    (delta 1 and 3), zero on identical lists (tests/test_system.py::test_rpe),
    the same from params7 as from SE3s, and NaN when no interval fits."""
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import se3 as jse3
    from ygz_slam_tpu.system import trajectory as jtraj

    gt = tsyn.loop_trajectory(24, device="cpu")
    noise = np.random.default_rng(12).normal(size=(24, 6)).astype(np.float32) * 1e-2
    est = [tse3.exp(torch.from_numpy(n)).compose(T) for n, T in zip(noise, gt)]
    if case == "identical":
        poses = [jse3.exp(jnp.asarray([0.1 * k, 0, 0, 0, 0, 0], jnp.float32)) for k in range(10)]
        tposes = [SE3(torch.tensor(np32(T.R)), torch.tensor(np32(T.t))) for T in poses]
        t_err, r_err = ttraj.rpe_rmse(tposes, tposes)
        assert t_err < 1e-6 and r_err < 1e-6
        return
    if case == "short":
        assert all(np.isnan(ttraj.rpe_rmse(est[:3], gt[:3], delta=3)))
        return
    delta = 3 if case == "perturbed_d3" else 1
    want = jtraj.rpe_rmse([_jse3(T) for T in est], [_jse3(T) for T in gt], delta=delta)
    if case == "params7":
        got = ttraj.rpe_rmse([T.params7().numpy() for T in est], [T.params7() for T in gt],
                             delta=delta)
    else:
        got = ttraj.rpe_rmse(est, gt, delta=delta)
    rel = [abs(g - w) / w for g, w in zip(got, want)]
    print(f"rpe_rmse {case}: port {got}, JAX {want}, relative {rel} (tolerance {TOL_RPE})")
    assert all(isinstance(v, float) for v in got)
    assert max(rel) <= TOL_RPE


@pytest.mark.parametrize("warp", ["identity", "rotated", "scaled"])
def test_warp_patches(warp):
    """warp_patches on a rendered PlaneScene image against JAX's, with
    identity, rotated and scaled affine maps, each at level_ref and
    search_level 0-2 and the default and a 4-pixel half patch."""
    import jax.numpy as jnp
    from ygz_slam_tpu.ops import warp as jwarp

    cam = PinholeCamera.create(*PINHOLE)
    img = np32(tsyn.PlaneScene(cam, seed=0, device="cpu").render(
        tse3.exp(torch.tensor([0.05, -0.02, 0.0, 0.01, -0.01, 0.0])), (240, 320)))
    rng = np.random.default_rng(21)
    n = 27
    px = rng.uniform([40.0, 40.0], [280.0, 200.0], size=(n, 2)).astype(np.float32)
    level_ref = np.repeat(np.arange(3, dtype=np.int32), n // 3)
    search_level = np.tile(np.arange(3, dtype=np.int32), n // 3)
    if warp == "identity":
        A = np.tile(np.eye(2, dtype=np.float32), (n, 1, 1))
    elif warp == "rotated":
        a = rng.uniform(-0.6, 0.6, size=n)
        A = np.stack([np.stack([np.cos(a), -np.sin(a)], -1), np.stack([np.sin(a), np.cos(a)], -1)],
                     -2).astype(np.float32)
    else:
        A = (np.eye(2) * rng.uniform(0.5, 2.5, size=(n, 1, 1))
             + rng.normal(size=(n, 2, 2)) * 0.05).astype(np.float32)
    err, mean = 0.0, 0.0
    for half in (twarp.WARP_HALF + 1, 4):
        got = twarp.warp_patches(torch.from_numpy(img), torch.from_numpy(px),
                                 torch.from_numpy(level_ref), torch.from_numpy(A),
                                 torch.from_numpy(search_level), half_patch=half)
        want = np.asarray(jwarp.warp_patches(jnp.asarray(img), jnp.asarray(px),
                                             jnp.asarray(level_ref), jnp.asarray(A),
                                             jnp.asarray(search_level), half_patch=half))
        assert got.shape == (n, 2 * half, 2 * half) == want.shape
        err = max(err, float(np.abs(got.numpy() - want).max()))
        mean = max(mean, float(np.abs(got.numpy() - want).mean()))
    print(f"warp_patches {warp}: max |port - JAX| {err:.2e} (tolerance {TOL_PATCH}), mean "
          f"{mean:.2e} ({TOL_PATCH_MEAN})")
    assert err <= TOL_PATCH and mean <= TOL_PATCH_MEAN
    if warp == "identity":
        # At level 0 with the identity the warp samples the symmetric grid
        # around px (tests/test_align.py::test_warp_patches_identity).
        lvl0 = (level_ref == 0) & (search_level == 0)
        p = twarp.warp_patches(torch.from_numpy(img), torch.from_numpy(px[lvl0]),
                               torch.zeros(int(lvl0.sum()), dtype=torch.int32),
                               torch.from_numpy(A[lvl0]),
                               torch.zeros(int(lvl0.sum()), dtype=torch.int32))
        direct = tinterp.sample_patches(torch.from_numpy(img), torch.from_numpy(px[lvl0]), 10)
        assert float((p - direct).abs().max()) <= 1e-2


def test_popcount_u32():
    """popcount_u32 on int32 words equals the JAX function on the same bits
    viewed as uint32: random words, 0, 0xFFFFFFFF, the sign bit alone and
    test_frontend_ops.py's cases."""
    import jax.numpy as jnp
    from ygz_slam_tpu.ops import hamming as jham

    words = np.random.default_rng(13).integers(0, 2 ** 32, size=(64, 8), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[0, :6] = [0, 1, 0xFFFFFFFF, 0xF0F0F0F0, 0x80000000, 0x7FFFFFFF]
    got = tham.popcount_u32(torch.from_numpy(words.view(np.int32)))
    want = np.asarray(jham.popcount_u32(jnp.asarray(words)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert got[0, :6].tolist() == [0, 1, 32, 16, 1, 31]


def test_mapping_result():
    """MappingResult is a NamedTuple with the JAX fields, in order."""
    from ygz_slam_tpu.models import local_mapping as jlm

    assert tlm.MappingResult._fields == jlm.MappingResult._fields == ("map", "n_culled", "ba_chi2")
    r = tlm.MappingResult(None, torch.tensor(3), torch.tensor(1.5))
    assert r.n_culled == 3 and r._replace(map=1).map == 1
