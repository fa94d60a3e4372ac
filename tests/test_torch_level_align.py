"""Parity of K9 (one pyramid level of sparse-direct alignment, v1 and v2)
and of the port's per-level `sparse_image_align` (FUSED_VARIANT 1 and 2)
with the JAX package's level_align_fused / _v2 run in interpret mode, on
the CPU.

The scene is tests/test_pallas_kernels.py's: 240x320, the plane of seed 3,
at most 80 FAST corners of the reference image.  Both packages get the
port's rendered frames and the port's reference prep (the lane packs made
from it), so they differ only in the order of float32 sums."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.ops import sparse_align as jsa
from ygz_slam_tpu.ops.pallas import sparse_align_fused as jsf

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera as TCam
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.ops import fast, pyramid as tpyr, sparse_align as tsa
from ygz_slam_tpu_torch.ops.kernels import _gn6, sparse_align_fused as k9
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_camera, jax_kernels_interpreted, jax_prep_from_port, np32

torch.set_num_threads(1)

# Both run the same GN iterations in float32 and differ in reduction order
# only (~1e-6 relative per normal equation), far below the 1e-4 step at
# which a level stops.
TOL_POSE = 1e-4
TOL_REL = 1e-4          # chi2 and H, relative
# The interpreted v1 kernel is unrolled over its iterations and takes ~40 s
# to compile at the full cap of 12; v1 is compared at a cap of 4 (set in
# both packages), v2 at the full cap.
V1_ITER = 4
SMALL = [0.03, -0.02, 0.01, 0.002, -0.004, 0.002]
LARGE = [0.06, 0.04, -0.02, -0.004, 0.006, 0.004]   # ~10 px: rollbacks happen


def _scene(motion):
    cam = TCam.create(320.0, 320.0, 160.0, 120.0)
    scene = PlaneScene(cam, plane_z=3.0, seed=3, device="cpu")
    T_gt = tse3.exp(torch.tensor(motion, dtype=torch.float32))
    ident = TSE3.identity(device="cpu")
    img_r = scene.render(ident, (240, 320))
    img_c = scene.render(T_gt, (240, 320))
    c = fast.detect(img_r, 20.0, 16, 80)
    depth = scene.depth(c.xy, ident)
    rp, cp = tpyr.build_pyramid(img_r, 3), tpyr.build_pyramid(img_c, 3)
    prep = tsa.prepare_reference(rp, cam, c.xy, depth, c.mask, distorted=False)
    return cam, T_gt, c, depth, rp, cp, prep


@pytest.fixture(scope="module", params=[("small", SMALL), ("large", LARGE)],
                ids=lambda p: p[0])
def scene(request):
    return _scene(request.param[1])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("variant", [1, 2])
def test_level_plain_matches_jax_kernel(scene, variant, monkeypatch):
    """One coarse level (2) from the identity: the level with the most
    correction to make, so rollback and the iteration cap are exercised."""
    cam, T_gt, c, depth, rp, cp, prep = scene
    level = 2
    n_iter = V1_ITER if variant == 1 else k9.MAX_ITER
    monkeypatch.setattr(k9, "MAX_ITER", n_iter)
    jprep = jax_prep_from_port(prep)
    lr, jlr = prep.levels[level], jprep.levels[level]
    R0, t0 = torch.eye(3), torch.zeros(3)
    port = (k9.level_align_fused_v2 if variant == 2 else k9.level_align_fused)(
        cp[level], lr, prep.p_ref, R0, t0, cam, level, distorted=False)
    if variant == 2:
        # On the CPU the entry point is the plain version, which takes the
        # kernel's arguments (no factor) and returns H0 beside the pose.
        plain = k9.level_gn_v2_plain(*k9.level_args(cp[level], lr, prep.p_ref, R0, t0, cam,
                                                    level, False))
        assert torch.equal(torch.cat([port[0].reshape(9), port[1], port[2].reshape(1)]),
                           plain[:13]) and torch.equal(port[3], k9._sym6(plain[13:]))
    jimg, jcam = jnp.asarray(np32(cp[level])), jax_camera(cam)
    with jax_kernels_interpreted():
        if variant == 2:
            ref = jsf.level_align_fused_v2(jimg, jlr.refp_lanes, jlr.jlanes, jlr.J, jprep.p_ref,
                                           jlr.vis, jnp.eye(3), jnp.zeros(3), jcam, level,
                                           distorted=False, n_iter=n_iter)
        else:
            ref = jsf.level_align_fused(jimg, jlr.refp_lanes, jlr.jlanes, jprep.p_ref, jlr.vis,
                                        jnp.eye(3), jnp.zeros(3), jcam, level, distorted=False,
                                        n_iter=n_iter)
    d = float(tse3.distance(TSE3(port[0], port[1]),
                            TSE3(torch.tensor(np32(ref[0])), torch.tensor(np32(ref[1])))))
    gaps = (d, _rel(np32(port[2]), np32(ref[2])), _rel(np32(port[3]), np32(ref[3])))
    print(f"K9 v{variant} level {level}: pose distance {gaps[0]:.2e}, chi2 {gaps[1]:.2e}, "
          f"H {gaps[2]:.2e} (relative)")
    assert gaps[0] <= TOL_POSE and gaps[1] <= TOL_REL and gaps[2] <= TOL_REL, gaps
    assert float(port[2]) > 0


def test_singular_level_keeps_pose():
    """Every point invisible: H0 = 0, b = 0, so neither variant moves the
    pose and chi2 is 0."""
    cam, T_gt, c, depth, rp, cp, prep = _scene(SMALL)
    lr = prep.levels[0]
    lr = lr._replace(vis=torch.zeros_like(lr.vis))
    R0, t0 = T_gt.R, T_gt.t
    for fn in (k9.level_align_fused, k9.level_align_fused_v2):
        R, t, chi2, H = fn(cp[0], lr, prep.p_ref, R0, t0, cam, 0, distorted=False)
        assert torch.equal(R, R0) and torch.equal(t, t0)
        assert float(chi2) == 0.0 and float(H.abs().max()) == 0.0


def _h0_cases():
    """H0s for the factor rule: positive definite; rank-deficient (two equal
    columns of 1s at one point's 16 pixels, the rest 0: the last pivot is
    16 - 4 * 4 = 0 exactly in any order of operations); 0 (no usable
    point: 1e-4 I); negative definite; NaN."""
    A = torch.randn(6, 6, generator=torch.Generator().manual_seed(0))
    J = torch.zeros(16, 6)
    J[:, 4:] = 1.0
    return {"positive definite": A @ A.T + torch.eye(6), "rank-deficient": J.T @ J,
            "zero": torch.zeros(6, 6), "negative definite": -(A @ A.T + torch.eye(6)),
            "nan": torch.full((6, 6), float("nan"))}


@pytest.mark.parametrize("case", list(_h0_cases()))
def test_frozen_factor_rule(case):
    """cholesky(H0 + 1e-8 I) where it succeeds; the identity where H0 + 1e-8 I
    is not positive definite or not finite.  The kernel's factor
    (common.cuh::chol6_frozen, through its float32 twin `_gn6.chol6_frozen`)
    follows `frozen_factor`, the plain version's, on each case."""
    H = _h0_cases()[case]
    lf = k9.frozen_factor(H)
    il, jl = torch.tril_indices(6, 6)
    Lm = torch.zeros(6, 6).index_put((il, jl), lf)
    twin = torch.tensor(np.array(_gn6.chol6_frozen(_gn6.upper21(H)), np.float32))
    eye = torch.eye(6)
    if case == "positive definite":
        assert torch.allclose(Lm @ Lm.T, H + 1e-8 * eye, atol=1e-4)
        torch.testing.assert_close(twin, Lm, rtol=1e-5, atol=1e-6)
    elif case == "zero":
        torch.testing.assert_close(Lm, 1e-4 * eye, rtol=1e-6, atol=0.0)
        assert torch.equal(twin, Lm)
    else:
        assert torch.equal(Lm, eye) and torch.equal(twin, eye)


@pytest.mark.parametrize("variant", [1, 2])
def test_sparse_image_align_variant_matches_jax(scene, variant, monkeypatch):
    """The whole coarse-to-fine alignment under FUSED_VARIANT 1 / 2 in both
    packages (the JAX one with on_tpu forced and its kernels interpreted):
    v2 over three levels, v1 (at its reduced cap) over levels 1 and 0."""
    cam, T_gt, c, depth, rp, cp, prep = scene
    n_iter = V1_ITER if variant == 1 else k9.MAX_ITER
    max_level = 1 if variant == 1 else 2
    monkeypatch.setattr(k9, "MAX_ITER", n_iter)
    monkeypatch.setattr(tsa, "FUSED_VARIANT", variant)
    monkeypatch.setattr(jsa, "FUSED_VARIANT", variant)
    tst = tsa.sparse_image_align(rp, cp, cam, c.xy, depth, c.mask, TSE3.identity(device="cpu"),
                                 max_level=max_level, distorted=False, ref_prep=prep)
    with jax_kernels_interpreted():
        jst = jsa.sparse_image_align(
            tuple(jnp.asarray(np32(x)) for x in rp), tuple(jnp.asarray(np32(x)) for x in cp),
            jax_camera(cam), jnp.asarray(np32(c.xy)), jnp.asarray(np32(depth)),
            jnp.asarray(np32(c.mask)), JSE3.identity(), n_iter=n_iter, max_level=max_level,
            distorted=False, ref_prep=jax_prep_from_port(prep))
    d = float(tse3.distance(tst.T_cur_ref, TSE3(torch.tensor(np32(jst.T_cur_ref.R)),
                                                torch.tensor(np32(jst.T_cur_ref.t)))))
    gaps = (d, _rel(np32(tst.chi2), np32(jst.chi2)), _rel(np32(tst.H), np32(jst.H)))
    print(f"sparse_image_align variant {variant}: pose distance {gaps[0]:.2e}, chi2 "
          f"{gaps[1]:.2e}, H {gaps[2]:.2e} (relative)")
    assert gaps[0] <= TOL_POSE and gaps[1] <= TOL_REL and gaps[2] <= TOL_REL, gaps
    assert int(tst.n_visible) == int(jst.n_visible)
    if variant == 2:
        assert float(tse3.distance(tst.T_cur_ref, T_gt)) < 1e-2


@pytest.mark.parametrize("variant", [1, 2])
def test_distorted_flag_reaches_the_level_kernels(variant, monkeypatch):
    """A camera with nonzero distortion, the scene rendered through it and
    the reference prepared with it: under FUSED_VARIANT 1 / 2 the port's
    `sparse_image_align` with distorted=False gives another pose than with
    distorted=True, because it hands the caller's flag to K9
    (ops/sparse_align.py).  The JAX package gives the same pose for both:
    its `_level_align` passes distorted=True to K9 whatever the caller asks
    (ygz_slam_tpu/ops/sparse_align.py:163, 169; ROADMAP queue 3).  Prints
    the gap between the two packages; fails if the port stops honouring
    the flag or the packages part where both project with distortion."""
    cam = TCam.create(320.0, 320.0, 160.0, 120.0, k1=-0.08, k2=0.01, p1=5e-4, p2=-5e-4)
    scene = PlaneScene(cam, plane_z=3.0, seed=3, device="cpu")
    ident = TSE3.identity(device="cpu")
    img_r = scene.render(ident, (240, 320))
    img_c = scene.render(tse3.exp(torch.tensor(SMALL, dtype=torch.float32)), (240, 320))
    c = fast.detect(img_r, 20.0, 16, 80)
    depth = scene.depth(c.xy, ident)
    rp, cp = tpyr.build_pyramid(img_r, 3), tpyr.build_pyramid(img_c, 3)
    prep = tsa.prepare_reference(rp, cam, c.xy, depth, c.mask, distorted=True)
    n_iter = V1_ITER if variant == 1 else k9.MAX_ITER
    max_level = 1 if variant == 1 else 2
    monkeypatch.setattr(k9, "MAX_ITER", n_iter)
    monkeypatch.setattr(tsa, "FUSED_VARIANT", variant)
    monkeypatch.setattr(jsa, "FUSED_VARIANT", variant)
    port, ref = {}, {}
    for flag in (False, True):
        port[flag] = tsa.sparse_image_align(rp, cp, cam, c.xy, depth, c.mask, ident,
                                            max_level=max_level, distorted=flag,
                                            ref_prep=prep).T_cur_ref
        with jax_kernels_interpreted():
            jst = jsa.sparse_image_align(
                tuple(jnp.asarray(np32(x)) for x in rp), tuple(jnp.asarray(np32(x)) for x in cp),
                jax_camera(cam), jnp.asarray(np32(c.xy)), jnp.asarray(np32(depth)),
                jnp.asarray(np32(c.mask)), JSE3.identity(), n_iter=n_iter, max_level=max_level,
                distorted=flag, ref_prep=jax_prep_from_port(prep))
        ref[flag] = TSE3(torch.tensor(np32(jst.T_cur_ref.R)), torch.tensor(np32(jst.T_cur_ref.t)))
    moved = float(tse3.distance(port[False], port[True]))
    moved_jax = float(tse3.distance(ref[False], ref[True]))
    gap = {flag: float(tse3.distance(port[flag], ref[flag])) for flag in (False, True)}
    print(f"variant {variant}, distorted camera: the port's pose moves by {moved:.3e} between "
          f"distorted=False and True, the JAX package's by {moved_jax:.3e}; gap between the "
          f"packages {gap[False]:.3e} with distorted=False, {gap[True]:.3e} with True")
    assert moved > 10 * TOL_POSE
    assert gap[True] <= TOL_POSE
