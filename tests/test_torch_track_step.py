"""The slice as a whole: one 640x480 / 200-landmark frame of bench.py's
tracking step through the JAX package (its kernels in interpret mode)
and through the PyTorch port on the CPU, plus the port's workload
against _bench_common's.

The JAX step is the only slice-level guard and costs ~30-40 s on the
CPU, almost all of it tracing the interpreted kernels; it runs once per
module, in this file of its own."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.ops import pyramid as jpyr
from ygz_slam_tpu.ops.align import align2d as jalign2d
from ygz_slam_tpu.ops.pallas.align2d_fused import align2d_prepare as jalign2d_prepare
from ygz_slam_tpu.ops.sparse_align import prepare_reference as jprepare_reference
from ygz_slam_tpu.ops.sparse_align import sparse_image_align as jsparse_image_align
from ygz_slam_tpu.solvers import pose_only_ba as jpose_only_ba

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import tracking as tr
from ygz_slam_tpu_torch.ops import sparse_align as tsa

from _torch_port import jax_kernels_interpreted, np32

torch.set_num_threads(1)

# Port versus JAX step: three solvers in a row, each differing from its
# counterpart in float32 reduction order only; the stages' own tests hold
# each to 1e-4, and the slice compounds them.
TOL_SLICE = 1e-3
# Rendered images: the same texture and bilinear lookup.  The ray
# geometry (pose inverse, ray-plane intersection) is summed in another
# order by XLA and PyTorch, so world points differ by ~1 float32 ulp;
# where that flips the rounding of a texture coordinate (~6e-5 texel at
# ~600) the finest texture octave (~120 intensity per texel) turns it
# into up to ~1e-2.  That happens on ~0.02% of the pixels of a moved
# camera; every other pixel agrees to 1e-3.
TOL_IMG = 1e-3
# Reference patches: bilinear mixes of 0-255 intensities (~1e-7 relative).
TOL_PATCH = 1e-4
# Jacobians: patch gradients (<= ~100) times duv_dxi (<= ~1e3 px per unit).
TOL_J_REL = 1e-5
TOL_IMG_FLIP = 1e-2
MIN_IMG_AGREE = 0.999


@pytest.fixture(scope="module")
def jax_slice():
    """_bench_common's workload and bench.py's track_step on frame 0 from
    the identity, as bench.py runs it."""
    import _bench_common as bc

    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = bc.make_workload(2)
    with jax_kernels_interpreted():
        ref_prep = jprepare_reference(ref_pyr, cam, px, depth, mask, distorted=False)
        a2d_prep = jalign2d_prepare(patches)
        cur_pyr = jpyr.build_pyramid(frames[0], 3)
        stats = jsparse_image_align(ref_pyr, cur_pyr, cam, px, depth, mask, JSE3.identity(),
                                    distorted=False, ref_prep=ref_prep)
        proj = cam.world_to_pixel(pts_w, stats.T_cur_ref, distorted=False)
        ares = jalign2d(cur_pyr[0], patches, proj, prep=a2d_prep)
        T, inlier, _ = jpose_only_ba(stats.T_cur_ref, pts_w, ares.xy, ares.converged & mask,
                                     cam)
    return dict(
        cam=cam, px=np32(px), depth=np32(depth), mask=np32(mask), pts_w=np32(pts_w),
        patches=np32(patches), ref_pyr=[np32(lv) for lv in ref_pyr], frames=np32(frames),
        T_gt7=np32(T_gt7), T7=np32(T.params7()), n_inl=int(jnp.sum(inlier)),
        ref_prep=ref_prep, a2d_prep=a2d_prep)


def _port_cam(jcam):
    return convert.camera_from_numpy(*jcam)


def _gate_frame(T7, n_inl, T_gt7):
    d = float(tse3.distance(TSE3.from_params7(torch.tensor(np32(T7))),
                            TSE3.from_params7(torch.tensor(np32(T_gt7)))))
    return d < 2e-2 and n_inl > 150, d


def test_workload_matches_bench_common(jax_slice):
    j = jax_slice
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(
        2, device="cpu")
    assert tuple(cam) == tuple(_port_cam(j["cam"]))
    np.testing.assert_array_equal(np32(px), j["px"])
    np.testing.assert_array_equal(np32(mask), j["mask"])
    np.testing.assert_allclose(np32(depth), j["depth"], rtol=1e-6)
    np.testing.assert_allclose(np32(pts_w), j["pts_w"], atol=1e-5)
    np.testing.assert_allclose(np32(patches), j["patches"], atol=TOL_IMG)
    for a, b in zip(ref_pyr, j["ref_pyr"]):
        np.testing.assert_allclose(np32(a), b, atol=TOL_IMG)
    dimg = np.abs(np32(frames) - j["frames"])
    assert (dimg <= TOL_IMG).mean() >= MIN_IMG_AGREE and dimg.max() <= TOL_IMG_FLIP, \
        ((dimg > TOL_IMG).mean(), dimg.max())
    np.testing.assert_allclose(np32(T_gt7), j["T_gt7"], atol=1e-6)


def test_prepare_reference_matches_jax(jax_slice):
    """The port's keyframe prep (K1's bilinear_patches, Jacobians) against
    the JAX prepare_reference (its window kernel interpreted)."""
    j = jax_slice
    tprep = tsa.prepare_reference([torch.tensor(lv) for lv in j["ref_pyr"]],
                                  _port_cam(j["cam"]), torch.tensor(j["px"]),
                                  torch.tensor(j["depth"]), torch.tensor(j["mask"]),
                                  distorted=False)
    jprep = j["ref_prep"]
    np.testing.assert_allclose(np32(tprep.p_ref), np32(jprep.p_ref), rtol=1e-6)
    for lt, lj in zip(tprep.levels, jprep.levels):
        np.testing.assert_array_equal(np32(lt.vis), np32(lj.vis))
        np.testing.assert_allclose(np32(lt.ref_patch), np32(lj.ref_patch), atol=TOL_PATCH)
        J = np32(lj.J)
        np.testing.assert_allclose(np32(lt.J), J, atol=TOL_J_REL * np.abs(J).max())


def test_slice_matches_jax_step(jax_slice):
    """The port's own keyframe prep and step on the JAX workload's
    arrays: the same pose as the JAX step, both inside the gate."""
    j = jax_slice
    state = tr.make_state(_port_cam(j["cam"]), [torch.tensor(lv) for lv in j["ref_pyr"]],
                          torch.tensor(j["px"]), torch.tensor(j["depth"]),
                          torch.tensor(j["mask"]), torch.tensor(j["pts_w"]),
                          torch.tensor(j["patches"]))
    T7, n_inl = tr.track_step(state, TSE3.identity(device="cpu").params7(), torch.tensor(j["frames"][0]))
    ok_j, d_j = _gate_frame(j["T7"], j["n_inl"], j["T_gt7"][0])
    assert np.isfinite(j["T7"]).all() and ok_j, ("JAX step outside the gate", d_j, j["n_inl"])
    ok_t, d_t = _gate_frame(T7, int(n_inl), j["T_gt7"][0])
    assert ok_t, (d_t, int(n_inl))
    d = float(tse3.distance(TSE3.from_params7(T7), TSE3.from_params7(torch.tensor(j["T7"]))))
    assert d <= TOL_SLICE, d
    assert abs(int(n_inl) - j["n_inl"]) <= 2


def test_slice_from_converted_state(jax_slice):
    """convert.py: the JAX keyframe state (preps included) brought across
    as numpy arrays gives the port the same step result."""
    j = jax_slice
    rp, ap = j["ref_prep"], j["a2d_prep"]
    state = convert.keyframe_state_from_numpy(
        _port_cam(j["cam"]), j["ref_pyr"], j["px"], j["depth"], j["mask"], j["pts_w"],
        j["patches"],
        convert.reference_prep_from_numpy(
            np32(rp.p_ref), [(np32(lv.vis), np32(lv.ref_patch), np32(lv.J))
                             for lv in rp.levels], "cpu"),
        convert.align2d_prep_from_numpy(np32(ap.ref), np32(ap.jx), np32(ap.jy),
                                        np32(ap.hinv), "cpu"),
        "cpu")
    T7, n_inl = tr.track_step(state, TSE3.identity(device="cpu").params7(), torch.tensor(j["frames"][0]))
    d = float(tse3.distance(TSE3.from_params7(T7), TSE3.from_params7(torch.tensor(j["T7"]))))
    assert d <= TOL_SLICE, d
    assert abs(int(n_inl) - j["n_inl"]) <= 2


def test_port_alone_passes_gate():
    """The port on its own workload, first 5 frames, each warm-started
    from the last: every frame inside the bench gate."""
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(
        5, device="cpu")
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)
    T7, inl = tr.track_frames(state, frames, TSE3.identity(device="cpu").params7())
    max_err, min_inl, ok = tr.gate(T7, inl, T_gt7)
    assert ok, (max_err, min_inl)
