"""Parity of the port's sparse-direct alignment (K1 + K3 through
sparse_image_align) with the JAX package's sparse_align_mega kernel run
in interpret mode, on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.ops import sparse_align as jsa

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera as TCam
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.ops import pyramid as tpyr, sparse_align as tsa
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import (
    jax_camera, jax_kernels_interpreted, jax_prep_from_port, np32, workload)

torch.set_num_threads(1)

# Twin versus the JAX kernel on identical inputs: both run the same GN
# iterations in float32 and differ only in reduction order (~1e-6
# relative in each normal equation), far below the 1e-4 step at which
# the loop stops; a pose moves by less than that unless a rollback
# decision flips, which these inputs do not provoke.
TOL_POSE = 1e-4


def _jpyr(pyr):
    return tuple(jnp.asarray(np32(lv)) for lv in pyr)


@pytest.fixture(scope="module")
def case():
    """Frame 1 of the tracking workload, warm-started from frame 0's
    ground truth, through both packages on the same keyframe prep (the
    port's; tests/test_torch_track_step.py holds the two preps together)."""
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = workload(2)
    cur_pyr = tpyr.build_pyramid(frames[1], 3)
    prep = tsa.prepare_reference(ref_pyr, cam, px, depth, mask, distorted=False)
    T_init7 = np32(T_gt7[0])
    with jax_kernels_interpreted():
        jst = jsa.sparse_image_align(
            _jpyr(ref_pyr), _jpyr(cur_pyr), jax_camera(cam), jnp.asarray(np32(px)),
            jnp.asarray(np32(depth)), jnp.asarray(np32(mask)),
            JSE3.from_params7(jnp.asarray(T_init7)), distorted=False,
            ref_prep=jax_prep_from_port(prep))
    return dict(cam=cam, px=px, depth=depth, mask=mask, ref_pyr=ref_pyr, cur_pyr=cur_pyr,
                T_init7=T_init7, T_gt7=T_gt7, prep=prep, jst=jst)


def test_mega_twin_matches_jax_kernel(case):
    jst = case["jst"]
    Rj, tj = np32(jst.T_cur_ref.R), np32(jst.T_cur_ref.t)
    assert np.isfinite(Rj).all() and np.isfinite(tj).all(), "JAX reference pose not finite"
    tst = tsa.sparse_image_align(
        case["ref_pyr"], case["cur_pyr"], case["cam"], case["px"], case["depth"],
        case["mask"], TSE3.from_params7(torch.tensor(case["T_init7"])), distorted=False,
        ref_prep=case["prep"])
    d = float(tse3.distance(tst.T_cur_ref, TSE3(torch.tensor(Rj), torch.tensor(tj))))
    assert d <= TOL_POSE, d
    assert float(tst.chi2) == pytest.approx(float(jst.chi2), rel=1e-3)
    np.testing.assert_allclose(np32(tst.H), np32(jst.H), rtol=1e-4, atol=1e-2)
    # Both land on the ground truth of frame 1 (the tracking gate's 2e-2).
    gt = TSE3.from_params7(case["T_gt7"][1])
    assert float(tse3.distance(tst.T_cur_ref, gt)) < 2e-2


def test_port_alone_tracks_first_frames():
    """The port's own prep and K3 plain version over frames 0-4, each
    warm-started from the last result, stay on the ground truth."""
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = workload(5)
    prep = tsa.prepare_reference(ref_pyr, cam, px, depth, mask, distorted=False)
    T = TSE3.identity(device="cpu")
    for i in range(5):
        st = tsa.sparse_image_align(ref_pyr, tpyr.build_pyramid(frames[i], 3), cam, px,
                                    depth, mask, T, distorted=False, ref_prep=prep)
        T = st.T_cur_ref
        assert float(tse3.distance(T, TSE3.from_params7(T_gt7[i]))) < 2e-2
        assert int(st.n_visible) == 200


def test_distorted_camera_matches_jax_kernel():
    """K3's radial-tangential projection: a distorted camera over a
    rendered plane, the port's prep fed to both packages."""
    H, W, N = 240, 320, 200
    cam = TCam.create(260.0, 258.0, 161.0, 122.0, -0.21, 0.05, 3e-4, -2e-4)
    scene = PlaneScene(cam, plane_z=3.0, seed=1, tex_per_meter=110.0, device="cpu")
    T_gt = tse3.exp(torch.tensor([0.02, -0.015, 0.01, 0.002, -0.003, 0.001]))
    ref_pyr = tpyr.build_pyramid(scene.render(TSE3.identity(device="cpu"), (H, W)), 3)
    cur_pyr = tpyr.build_pyramid(scene.render(T_gt, (H, W)), 3)
    rng = np.random.default_rng(5)
    px = torch.tensor(np.c_[rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)],
                      dtype=torch.float32)
    depth = scene.depth(px, TSE3.identity(device="cpu"))
    mask = torch.ones(N, dtype=torch.bool)
    prep = tsa.prepare_reference(ref_pyr, cam, px, depth, mask, distorted=True)
    with jax_kernels_interpreted():
        jst = jsa.sparse_image_align(
            _jpyr(ref_pyr), _jpyr(cur_pyr), jax_camera(cam), jnp.asarray(np32(px)),
            jnp.asarray(np32(depth)), jnp.asarray(np32(mask)), JSE3.identity(),
            distorted=True, ref_prep=jax_prep_from_port(prep))
    Rj, tj = np32(jst.T_cur_ref.R), np32(jst.T_cur_ref.t)
    assert np.isfinite(Rj).all() and np.isfinite(tj).all(), "JAX reference pose not finite"
    tst = tsa.sparse_image_align(ref_pyr, cur_pyr, cam, px, depth, mask, TSE3.identity(device="cpu"),
                                 distorted=True, ref_prep=prep)
    d = float(tse3.distance(tst.T_cur_ref, TSE3(torch.tensor(Rj), torch.tensor(tj))))
    assert d <= TOL_POSE, d
    assert float(tse3.distance(tst.T_cur_ref, T_gt)) < 1e-2


@pytest.mark.parametrize("junk", [1e19, float("inf"), float("nan")])
def test_masked_rows_are_never_read(case, junk):
    """A masked row may hold anything: the VO hands over landmark rows at
    depth ~0, whose Jacobians' squares overflow float32.  The kernel skips
    such rows, and so must the plain version: a 0 weight would not do
    (inf * 0 is NaN, and the guarded solve then takes no step at all)."""
    prep, mask = case["prep"], case["mask"].clone()
    mask[::5] = False
    T0 = TSE3.from_params7(torch.tensor(case["T_init7"]))

    def run(fill):
        keep = mask[None, :, None]
        p = prep._replace(
            mega_refp=torch.where(keep, prep.mega_refp, fill),
            mega_jl=torch.where(keep[..., None], prep.mega_jl, fill),
            levels=tuple(lr._replace(vis=lr.vis & mask, J=torch.where(mask[:, None, None], lr.J, fill))
                         for lr in prep.levels))
        return tsa.sparse_image_align(case["ref_pyr"], case["cur_pyr"], case["cam"], case["px"],
                                      case["depth"], mask, T0, distorted=False, ref_prep=p)

    clean, dirty = run(0.0), run(junk)
    assert int(clean.n_visible) == int(mask.sum())
    assert float(tse3.distance(clean.T_cur_ref, TSE3.from_params7(case["T_gt7"][1]))) < 2e-2
    assert torch.equal(dirty.T_cur_ref.R, clean.T_cur_ref.R)
    assert torch.equal(dirty.T_cur_ref.t, clean.T_cur_ref.t)
    assert torch.equal(dirty.chi2, clean.chi2) and torch.equal(dirty.H, clean.H)
