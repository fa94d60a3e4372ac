"""K11, the whole tracking step in one kernel: the port's plain version
against the JAX package's `track_step_fused` run in interpret mode, on the
CPU, on the scene of tests/test_track_fused.py (240x320, 80 FAST corners
of a textured plane, landmarks 0-9 masked); against the port's composed
step on the same inputs; and `fused_track_step` on the tracking workload.

The interpreted JAX kernel takes ~40 s here, almost all of it tracing; it
runs once, in the module fixture, and every case compares against it."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import tracking as tr
from ygz_slam_tpu_torch.ops import sparse_align as tsa
from ygz_slam_tpu_torch.ops.align import align2d
from ygz_slam_tpu_torch.ops.kernels import align2d_fused as tk4
from ygz_slam_tpu_torch.ops.kernels import track_fused as tk11
from ygz_slam_tpu_torch.solvers.ba import pose_only_ba

from _torch_port import jax_kernels_interpreted, np32

torch.set_num_threads(1)

MOTION = [0.02, -0.01, 0.015, 0.001, -0.002, 0.001]   # test_masked_landmarks_stay_out
N_MASKED = 10
# Plain version against the interpreted JAX kernel: the same three solvers
# in float32, differing in reduction order only (~1e-6 relative per sum),
# far below the 1e-4 stopping steps, as each stage's own test holds.
TOL_POSE = 1e-4
TOL_CHI2_REL = 1e-4
TOL_XY = 1e-3           # px, on >= MIN_AGREE of the points both accept: a
MIN_AGREE = 0.98        # 0.03 px freeze decision may flip on rounding
MIN_INLIER_AGREE = 0.99
# Fused against composed (test_track_fused.py:84-99): the fused step
# fetches align2d's windows at the frame-init pose, takes unclamped align2d
# steps and a bisection MAD, so the two differ by more than rounding.
TOL_TRUTH = 1e-2
TOL_FUSED_COMPOSED = 2e-3


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_track_fused.py:22-39 (seed 5), landmarks
    0-9 masked, through the interpreted JAX `track_step_fused` from the
    identity; every input handed to the port as numpy arrays."""
    from ygz_slam_tpu.geometry import SE3, PinholeCamera, se3
    from ygz_slam_tpu.ops import fast, pyramid
    from ygz_slam_tpu.ops import sparse_align as jsa
    from ygz_slam_tpu.ops.interp import sample_patches
    from ygz_slam_tpu.ops.pallas.align2d_fused import align2d_prepare
    from ygz_slam_tpu.ops.pallas.track_fused import track_step_fused
    from ygz_slam_tpu.utils.synthetic import PlaneScene

    H, W = 240, 320
    cam = PinholeCamera.create(320.0, 320.0, W / 2, H / 2)
    plane = PlaneScene(cam, plane_z=3.0, seed=5)
    T_gt = se3.exp(jnp.asarray(MOTION, jnp.float32))
    img_r = plane.render(SE3.identity(), (H, W))
    img_c = plane.render(T_gt, (H, W))
    c = fast.detect(img_r, 20.0, cell=16, max_corners=80)
    depth = plane.depth(c.xy, SE3.identity())
    rp, cp = pyramid.build_pyramid(img_r, 3), pyramid.build_pyramid(img_c, 3)
    patches = sample_patches(img_r, c.xy, 10)
    pts_ref = cam.pixel_to_camera(c.xy, depth, distorted=False)
    mask2 = np.asarray(c.mask).copy()
    mask2[:N_MASKED] = False
    with jax_kernels_interpreted():
        ref_prep = jsa.prepare_reference(rp, cam, c.xy, depth, c.mask, distorted=False)
        a2d_prep = align2d_prepare(patches)
        out = track_step_fused(cp, ref_prep.levels, ref_prep.p_ref, a2d_prep, pts_ref,
                               jnp.asarray(mask2), jnp.eye(3, dtype=jnp.float32),
                               jnp.zeros(3, jnp.float32), cam, distorted=False, max_level=2)
    port_cam = convert.camera_from_numpy(*cam)
    t = dict(
        cam=port_cam, ref_pyr=[torch.tensor(np32(lv)) for lv in rp],
        cur_pyr=tuple(torch.tensor(np32(lv)) for lv in cp),
        xy=torch.tensor(np32(c.xy)), depth=torch.tensor(np32(depth)),
        mask=torch.tensor(np32(c.mask)), mask2=torch.tensor(mask2),
        patches=torch.tensor(np32(patches)), pts_ref=torch.tensor(np32(pts_ref)),
        T_gt=TSE3(torch.tensor(np32(T_gt.R)), torch.tensor(np32(T_gt.t))),
        prep=convert.reference_prep_from_numpy(
            np32(ref_prep.p_ref), [(np32(lv.vis), np32(lv.ref_patch), np32(lv.J))
                                   for lv in ref_prep.levels], "cpu"),
        a2d_prep=convert.align2d_prep_from_numpy(np32(a2d_prep.ref), np32(a2d_prep.jx),
                                                 np32(a2d_prep.jy), np32(a2d_prep.hinv),
                                                 "cpu"))
    t["jax"] = [np32(o) for o in out]
    return t


def _fused(s, **kw):
    eye, zero = torch.eye(3), torch.zeros(3)
    return tk11.track_step_fused(s["cur_pyr"], s["prep"].levels, s["prep"].p_ref,
                                 s["a2d_prep"], s["pts_ref"], s["mask2"], eye, zero, s["cam"],
                                 distorted=False, max_level=2, **kw)


def _args(s, R0=None, t0=None):
    return tk11.track_args(s["cur_pyr"], s["prep"].levels, s["prep"].p_ref, s["a2d_prep"],
                           s["pts_ref"], s["mask2"], torch.eye(3) if R0 is None else R0,
                           torch.zeros(3) if t0 is None else t0, s["cam"], False, 2)


def test_plain_matches_jax_kernel(scene):
    Rj, tj, chi2_sp_j, chi2_ba_j, n_j, xy_j, err_j, conv_j, inl_j = scene["jax"]
    assert np.isfinite(Rj).all() and np.isfinite(tj).all(), "JAX reference pose not finite"
    R, t, chi2_sp, chi2_ba, n_inl, xy, err, conv, inl = _fused(scene)
    d = float(tse3.distance(TSE3(R, t), TSE3(torch.tensor(Rj), torch.tensor(tj))))
    e_sp = abs(float(chi2_sp) - float(chi2_sp_j)) / abs(float(chi2_sp_j))
    e_ba = abs(float(chi2_ba) - float(chi2_ba_j)) / abs(float(chi2_ba_j))
    conv, inl = conv.numpy(), inl.numpy()
    both = conv & conv_j
    dxy = np.linalg.norm(xy.numpy() - xy_j, axis=1)[both]
    conv_agree, inl_agree = (conv == conv_j).mean(), (inl == inl_j).mean()
    print(f"K11 plain vs interpreted JAX: pose distance {d:.3e}, chi2 sparse {e_sp:.1e} and "
          f"BA {e_ba:.1e} relative, xy max {dxy.max():.3e} px on {both.sum()} points both "
          f"accept, converged {conv_agree:.4f} and inliers {inl_agree:.4f} equal, inliers "
          f"{int(n_inl)} vs {int(n_j)}")
    assert d <= TOL_POSE
    assert e_sp <= TOL_CHI2_REL and e_ba <= TOL_CHI2_REL
    assert both.sum() >= 0.5 * scene["mask2"].sum().item()
    assert (dxy <= TOL_XY).mean() >= MIN_AGREE
    assert conv_agree >= MIN_AGREE and inl_agree >= MIN_INLIER_AGREE
    assert int(n_inl) == int(inl.sum())
    for c_, i_ in ((conv, inl), (conv_j, inl_j)):
        assert not c_[:N_MASKED].any() and not i_[:N_MASKED].any()


def test_fused_against_composed_step(scene):
    """The port's composed step (plain K3, K4 and K5) on the same inputs:
    both within 1e-2 of the truth and within 2e-3 of each other."""
    s = scene
    R, t, *_ = _fused(s)
    st = tsa.sparse_image_align(s["ref_pyr"], s["cur_pyr"], s["cam"], s["xy"], s["depth"],
                                s["mask"], TSE3.identity(device="cpu"), distorted=False,
                                ref_prep=s["prep"])
    proj = s["cam"].camera_to_pixel(st.T_cur_ref.apply(s["pts_ref"]), distorted=False)
    ares = align2d(s["cur_pyr"][0], s["patches"], proj, prep=s["a2d_prep"])
    T_c, inl_c, _ = pose_only_ba(st.T_cur_ref, s["pts_ref"], ares.xy,
                                 ares.converged & s["mask2"], s["cam"])
    d_f = float(tse3.distance(TSE3(R, t), s["T_gt"]))
    d_c = float(tse3.distance(T_c, s["T_gt"]))
    print(f"fused {d_f:.3e} and composed {d_c:.3e} from the truth, "
          f"{abs(d_f - d_c):.3e} apart")
    assert d_f < TOL_TRUTH and d_c < TOL_TRUTH
    assert float(tse3.distance(TSE3(R, t), T_c)) < TOL_FUSED_COMPOSED
    assert not bool(inl_c[:N_MASKED].any())


def test_align2d_stage_is_unclamped():
    """Planted-fault guard.  On a bilinear intensity ramp, bilinear sampling
    and central differences are exact, so one Gauss-Newton step of align2d
    from a 3 px offset is the whole 3 px.  With no usable sparse point the
    step starts align2d at the projections of an init pose 3 px off: one
    iteration of K11's stage 2 moves every point ~3 px, where K4's plain
    loop from the same inits clamps the step to 1 px.  A port that reused
    K4's clamp fails here."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.ops import pyramid
    from ygz_slam_tpu_torch.ops.interp import sample_patches

    H, W = 120, 160
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    img = xx + 0.5 * yy + 0.01 * xx * yy
    cam = PinholeCamera.create(100.0, 100.0, W / 2, H / 2)
    px = torch.tensor([[60.0, 40.0], [100.0, 40.0], [60.0, 80.0], [100.0, 80.0]])
    depth = torch.full((4,), 2.0)
    mask = torch.ones(4, dtype=torch.bool)
    pyr = pyramid.build_pyramid(img, 3)
    prep = tsa.prepare_reference(pyr, cam, px, depth, mask, distorted=False)
    pts = cam.pixel_to_camera(px, depth, distorted=False)
    t0 = torch.tensor([0.06, 0.0, 0.0])                    # 3 px at depth 2, f = 100
    args = list(tk11.track_args(pyr, prep.levels, prep.p_ref,
                                tk4.align2d_prepare(sample_patches(img, px, 10)), pts, mask,
                                torch.eye(3), t0, cam, False, 2))
    args[4] = torch.zeros_like(args[4])                    # no level has a usable point
    out, xy, per = tk11.track_gn_plain(*args, a2d_iter=1)
    xy0 = px + torch.tensor([3.0, 0.0])
    k4 = tk4.a2d_gn_plain(*args[12:19], xy0, n_iter=1)
    step, step_k4 = (xy - xy0).abs().amax(dim=1), (k4[:, :2] - xy0).abs().amax(dim=1)
    print(f"one align2d iteration from 3 px off: steps {step.tolist()} px unclamped, "
          f"{step_k4.tolist()} px through K4's plain loop")
    assert torch.equal(out[15:27], args[7])
    assert bool((step > 2.5).all()) and bool((step_k4 <= 1.0).all())
    torch.testing.assert_close(xy, px, rtol=0, atol=0.05)


def test_no_usable_point_keeps_the_pose(scene):
    """No level with a usable point: the sparse stage leaves the init pose
    bit for bit (H = 0, b = 0, a zero step accepted) and its chi2 is 0."""
    R0 = torch.tensor([[1.0, -0.002, 0.001], [0.002, 1.0, -0.003], [-0.001, 0.003, 1.0]])
    args = list(_args(scene, R0=R0, t0=torch.tensor([0.01, -0.02, 0.005])))
    args[4] = torch.zeros_like(args[4])
    out, _, _ = tk11.track_gn_plain(*args)
    assert torch.equal(out[15:27], args[7]) and float(out[12]) == 0.0


def test_fused_path_passes_gate():
    """`fused_track_step` over 5 frames of the tracking workload: every
    frame inside the gate and within 2e-3 of `track_step`'s poses."""
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(
        5, device="cpu")
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)
    T0 = TSE3.identity(device="cpu").params7()
    T7, inl = tr.track_frames(state, frames, T0, step=tr.fused_track_step)
    T7c, _ = tr.track_frames(state, frames, T0)
    max_err, min_inl, ok = tr.gate(T7, inl, T_gt7)
    d = tse3.distance(TSE3.from_params7(T7), TSE3.from_params7(T7c))
    print(f"fused path, 5 frames: gate max error {max_err:.3e}, min inliers {min_inl}; "
          f"{float(d.max()):.3e} from track_step")
    assert ok, (max_err, min_inl)
    assert inl.dtype == torch.int32
    assert float(d.max()) <= TOL_FUSED_COMPOSED
