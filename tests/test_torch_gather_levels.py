"""K1 over a pyramid (`gather_windows_levels`: every level's windows of one
pyramid in one launch), on the CPU.

Its plain version against the per-level K1 stack and against the JAX
`gather_windows` of each level (interpreted, as tests/test_pallas_kernels.py
runs it), exactly: a gather is a copy; `bilinear_patches_levels` the same
way.  Then the callers that moved to it (`mega_args` under
`sparse_image_align` and `track_step_fused`, `prepare_reference`,
`gather_frame_windows`) against the per-level call order (one K1 request
per level, then torch.stack), built here on the same seeded inputs,
exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.ops.pallas import align2d_kernel as jak

from ygz_slam_tpu_torch.geometry import jacobians as tjac
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera as TCam
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import tracking as tr
from ygz_slam_tpu_torch.ops import pyramid as tpyr, sparse_align as tsa
from ygz_slam_tpu_torch.ops.interp import in_bounds
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tak
from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as tk3
from ygz_slam_tpu_torch.ops.kernels import track_fused as tk11

from _torch_port import jax_kernels_interpreted

torch.set_num_threads(1)

SHAPES = ((480, 640), (240, 320), (120, 160))     # a three-level 640x480 pyramid


def _case(L, win, n, seed=21):
    """L images of the pyramid's shapes and int32 origins [L, n]: a third
    of each level's drawn off the image (negative and beyond W - win /
    H - win), four corner cases planted, the rest inside."""
    rng = np.random.default_rng(seed)
    imgs, xs, ys = [], [], []
    for H, W in SHAPES[:L]:
        imgs.append(torch.tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32))
        x = rng.integers(0, W - win + 1, n)
        y = rng.integers(0, H - win + 1, n)
        k = n // 3
        x[:k], y[:k] = rng.integers(-40, W + 11, k), rng.integers(-40, H + 11, k)
        m = min(n, 4)
        x[:m] = [-3, W - win + 3, -win - 2, 5][:m]
        y[:m] = [H - win + 2, -2, 5, H + 4][:m]
        xs.append(x)
        ys.append(y)
    return (tuple(imgs), torch.tensor(np.array(xs).reshape(L, n), dtype=torch.int32),
            torch.tensor(np.array(ys).reshape(L, n), dtype=torch.int32))


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("win", [7, 16, 32])
def test_levels_plain_is_the_per_level_stack(L, win):
    """[L, N, win, win]: level l's windows of its zero-padded image, exactly
    the per-level K1 stack; the wrapper on CPU tensors gives the same."""
    imgs, xi, yi = _case(L, win, 60)
    out = tak.gather_windows_levels_plain(imgs, xi, yi, win)
    ref = torch.stack([tak.gather_windows_plain(imgs[l], xi[l], yi[l], win) for l in range(L)])
    assert out.shape == (L, 60, win, win)
    assert torch.equal(out, ref)
    assert torch.equal(tak.gather_windows_levels(imgs, xi, yi, win), ref)
    assert bool((out[:, :4] == 0).any()) and bool((out[:, :4] != 0).any())


@pytest.mark.parametrize("n", [0, 1])
def test_levels_plain_few_windows(n):
    imgs, xi, yi = _case(3, 16, n)
    out = tak.gather_windows_levels(imgs, xi, yi, 16)
    assert out.shape == (3, n, 16, 16)
    assert torch.equal(out, torch.stack([tak.gather_windows_plain(imgs[l], xi[l], yi[l], 16)
                                         for l in range(3)]))


@pytest.mark.parametrize("win", [7, 16, 32])
def test_levels_match_jax_per_level(win):
    """Each level against the JAX gather_windows kernel on that level's
    image and origins (interpret mode), exactly."""
    imgs, xi, yi = _case(3, win, 40, seed=22)
    out = tak.gather_windows_levels(imgs, xi, yi, win).numpy()
    with jax_kernels_interpreted():
        for l, img in enumerate(imgs):
            ref = np.asarray(jak.gather_windows(jnp.asarray(img.numpy()),
                                                jnp.asarray(xi[l].numpy()),
                                                jnp.asarray(yi[l].numpy()), win))
            np.testing.assert_array_equal(out[l], ref)


def test_levels_refuse_what_the_kernel_does_not_take():
    """More than MAX_LEVELS levels, origins of another shape, and a window
    larger than a level raise, on the CPU as on the card."""
    imgs, xi, yi = _case(1, 7, 5)
    many = imgs * (tak.MAX_LEVELS + 1)
    n = tak.MAX_LEVELS + 1
    with pytest.raises(ValueError, match="levels"):
        tak.gather_windows_levels(many, xi.expand(n, 5), yi.expand(n, 5), 7)
    with pytest.raises(ValueError, match="origins"):
        tak.gather_windows_levels(imgs, xi[0], yi[0], 7)
    with pytest.raises(ValueError, match="larger"):
        tak.gather_windows_levels(imgs, xi, yi, 481)


def test_bilinear_patches_levels():
    """`bilinear_patches_levels` on three levels (every level's windows in
    one K1 request) equals `bilinear_patches` level by level, stacked,
    exactly, and each level matches the JAX `bilinear_patches` (interpret
    mode) within 1e-4; centers off the image, NaN and +-1e12 included."""
    L = 3
    rng = np.random.default_rng(26)
    imgs = tuple(torch.tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32)
                 for H, W in SHAPES[:L])
    c = np.stack([np.stack([rng.uniform(-8, W + 8, 50), rng.uniform(-8, H + 8, 50)], 1)
                  for H, W in SHAPES[:L]]).astype(np.float32)
    c[:, :3] = [[np.nan, 3.0], [1e12, -1e12], [0.0, 119.0]]
    centers = torch.tensor(c)
    out = tak.bilinear_patches_levels(imgs, centers, 6)
    ref = torch.stack([tak.bilinear_patches(imgs[l], centers[l], 6) for l in range(L)])
    assert out.shape == (L, 50, 6, 6) and torch.isfinite(out).all()
    assert torch.equal(out, ref)
    with jax_kernels_interpreted():
        for l, img in enumerate(imgs):
            want = np.asarray(jak.bilinear_patches(jnp.asarray(img.numpy()),
                                                   jnp.asarray(c[l, 3:]), 6))
            np.testing.assert_allclose(out[l, 3:].numpy(), want, atol=1e-4, rtol=0)


# -- the callers, against the per-level call order ----------------------------

def _per_level_prep(ref_pyr, cam, px_ref, depth_ref, mask, max_level, distorted):
    """prepare_reference in the per-level call order: `bilinear_patches`
    (one K1 request) and the Jacobians level by level, then torch.stack."""
    p_ref = cam.pixel_to_camera(px_ref, depth_ref, distorted=distorted)
    visible0 = mask & (depth_ref > 1e-3)
    levels = []
    for lv in range(max_level + 1):
        scale = 1.0 / (2.0 ** lv)
        Hh, Ww = ref_pyr[lv].shape
        u = px_ref * scale
        p6 = tak.bilinear_patches(ref_pyr[lv], u, tsa.PATCH + 2)
        ref_patch = p6[:, 1:5, 1:5].reshape(-1, tsa.PATCH_AREA)
        dx = (0.5 * (p6[:, 1:5, 2:6] - p6[:, 1:5, 0:4])).reshape(-1, tsa.PATCH_AREA)
        dy = (0.5 * (p6[:, 2:6, 1:5] - p6[:, 0:4, 1:5])).reshape(-1, tsa.PATCH_AREA)
        J_proj = tjac.duv_dxi(p_ref, cam.fx * scale, cam.fy * scale)
        J = dx[..., None] * J_proj[:, None, 0, :] + dy[..., None] * J_proj[:, None, 1, :]
        vis = visible0 & in_bounds(u, Hh, Ww, margin=tsa.PATCH_HALF + 2)
        levels.append(tsa.LevelRef(vis=vis, ref_patch=ref_patch.contiguous(),
                                   J=J.contiguous()))
    return tsa.ReferencePrep(p_ref.contiguous(), tuple(levels),
                             torch.stack([lr.ref_patch for lr in levels]).contiguous(),
                             torch.stack([lr.J for lr in levels]).contiguous())


def _per_level_windows(cur_pyr, p_ref, T0, cam, distorted, n_levels):
    """K3's windows in the per-level call order: each level's origins
    around the frame-init projection, one K1 request per level, then
    torch.stack."""
    pc0 = p_ref @ T0.R.T + T0.t
    px0_l0 = torch.nan_to_num(cam.camera_to_pixel(pc0, distorted=distorted))
    oxs, oys, wins = [], [], []
    for li in range(n_levels):
        Hl, Wl = cur_pyr[li].shape
        px0 = px0_l0 / (2.0 ** li)
        ox = torch.clamp(torch.floor(px0[:, 0] - tk3._HALF) - tk3.SLACK, 0, Wl - tk3.CWIN)
        oy = torch.clamp(torch.floor(px0[:, 1] - tk3._HALF) - tk3.SLACK, 0, Hl - tk3.CWIN)
        oxs.append(ox.to(torch.int32))
        oys.append(oy.to(torch.int32))
        wins.append(tak.gather_windows(cur_pyr[li], oxs[-1], oys[-1], tk3.CWIN))
    return tk3.MegaWindows(torch.stack(wins), torch.stack(oxs), torch.stack(oys), pc0, px0_l0)


def _prep_tensors(prep):
    return ([prep.p_ref, prep.mega_refp, prep.mega_jl]
            + [t for lr in prep.levels for t in (lr.vis, lr.ref_patch, lr.J)])


def _align_tensors(st):
    return [st.T_cur_ref.R, st.T_cur_ref.t, st.chi2, st.n_visible, st.H]


@pytest.fixture(scope="module")
def workload():
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(2, "cpu")
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)
    return state, tpyr.build_pyramid(frames[1], tr.N_LEVELS), TSE3.from_params7(T_gt7[0])


def _outputs(case, workload, monkeypatch):
    """(the caller's outputs, the same outputs by the per-level call order)."""
    state, cur_pyr, T0 = workload
    cam = state.cam
    top = tr.N_LEVELS - 1
    prep_args = (state.ref_pyr, cam, state.px, state.depth, state.mask, top, False)
    old_prep = _per_level_prep(*prep_args)
    if case == "prepare_reference":
        return _prep_tensors(tsa.prepare_reference(*prep_args)), _prep_tensors(old_prep)
    if case == "prepare_reference_distorted_border":
        # Radial-tangential camera, levels 0-1 only, points on and past the
        # image border (windows clamp) beside the workload's.
        dcam = TCam.create(517.3, 516.5, 320.0, 240.0, -0.28, 0.07, 2e-4, -1e-4)
        px = torch.cat([torch.tensor([[0.0, 0.0], [639.0, 479.0], [-7.5, 240.25],
                                      [700.0, -30.0], [2.5, 477.75]]), state.px])
        depth = torch.cat([torch.full((5,), 2.5), state.depth])
        mask = torch.cat([torch.tensor([True, True, False, True, True]), state.mask])
        args = (state.ref_pyr, dcam, px, depth, mask, 1, True)
        return (_prep_tensors(tsa.prepare_reference(*args)),
                _prep_tensors(_per_level_prep(*args)))
    old_fw = tsa.FrameWindows(_per_level_windows(cur_pyr, old_prep.p_ref, T0, cam, False,
                                                 tr.N_LEVELS), None)
    align = (state.ref_pyr, cur_pyr, cam, state.px, state.depth, state.mask, T0)
    if case.startswith("sparse_image_align_v"):
        # Under variants 1 and 2 only the prep moved (K9 gathers per level).
        monkeypatch.setattr(tsa, "FUSED_VARIANT", int(case[-1]))
        new = tsa.sparse_image_align(*align, distorted=False, ref_prep=state.ref_prep)
        old = tsa.sparse_image_align(*align, distorted=False, ref_prep=old_prep,
                                     frame_windows=old_fw)
        return _align_tensors(new), _align_tensors(old)
    if case == "sparse_image_align_own_prep":
        # No ref_prep: the reference prepared inside, as the VO step does.
        new = tsa.sparse_image_align(*align, distorted=False)
        old = tsa.sparse_image_align(*align, distorted=False, ref_prep=old_prep,
                                     frame_windows=old_fw)
        return _align_tensors(new), _align_tensors(old)
    if case == "track_step_fused":
        def step(prep):
            return list(tk11.track_step_fused(cur_pyr, prep.levels, prep.p_ref, state.a2d_prep,
                                              state.pts_w, state.mask, T0.R, T0.t, cam,
                                              distorted=False, max_level=top))
        new = step(state.ref_prep)
        mega_args = tk11.mega_args
        monkeypatch.setattr(tk11, "mega_args",
                            lambda *a: mega_args(*a, pregathered=old_fw.mega_wins))
        return new, step(old_prep)
    if case == "gather_frame_windows":
        centers = state.px + 3.25
        fw = tsa.gather_frame_windows(cur_pyr, cam, state.ref_prep, T0, distorted=True,
                                      a2d_centers=centers)
        old = _per_level_windows(cur_pyr, old_prep.p_ref, T0, cam, True, tr.N_LEVELS)
        a2d = tak.gather_windows(cur_pyr[0], fw.a2d.ox, fw.a2d.oy, tak.CACHE_WIN)
        return list(fw.mega_wins) + [fw.a2d.wins], list(old) + [a2d]
    raise KeyError(case)


CASES = ["gather_frame_windows", "prepare_reference", "prepare_reference_distorted_border",
         "sparse_image_align_own_prep", "sparse_image_align_v1", "sparse_image_align_v2",
         "sparse_image_align_v3", "track_step_fused"]


@pytest.mark.parametrize("case", CASES)
def test_callers_keep_their_bits(case, workload, monkeypatch):
    """Each caller that moved to the pyramid form gives exactly the outputs
    of the per-level call order (one K1 request per level, then
    torch.stack) on the same seeded inputs."""
    new, old = _outputs(case, workload, monkeypatch)
    assert len(new) == len(old)
    for k, (a, b) in enumerate(zip(new, old)):
        assert a.dtype == b.dtype and a.shape == b.shape, (case, k)
        assert torch.equal(a, b), (case, k, float((a.double() - b.double()).abs().max()))
