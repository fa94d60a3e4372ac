"""The port's CUDA kernels against their plain versions, on the card, on
inputs the main paths do not give them: K1 with origins outside the
image, on one image and over a pyramid of one and three levels (windows
7, 16 and 32, 1 to 512 points, every windows-per-block setting; nine
levels refused), K2 on a stack (40 images: no cap) and on a table of a
pyramid's levels (windows 7 and 32, origins off the image, a 61x83
pyramid whose level 2 is smaller than the window; the table equal to the
levels' zero-padded stack; nine images refused) and with an image index
past its stack or its table, K5 with planted outliers
and masked points, K6 with 8, 24 and 48 requests and on a batched frame's
windows at 8, 16 and 22 sequences (one launch, one, two), K8 with one
sequence fully masked beside normal ones, K10 with an empty side, with one
row and from 1 x 1 to 2560 x 3072 with all-ones, sign-bit-only and zero
words, K9 v1
and v2 at every level of a frame pair, on a level with no usable point and
on windows clamped at the border, K9 v1 from 1 to 1500 points (one to
eight CTAs of its cluster), without spills and with its pass marks on; K9
v2 from 1 to 1500 points, with a rank-deficient H0 (the identity factor),
and building H0 inside the kernel (no cholesky_ex or einsum on the card);
K4 from 1 to 1600 points, K4 and K9 v2 without spills; K11 on frame 1 of the fused path and with
ten landmarks masked, from 1 to 1500 map points (one to eight CTAs, the
last range cut at N) with its stage 1 against K3 and its stage 3 against
K5 bit for bit, and with its stage marks on; K3 and K5 from 1 to 1500 points and K3 with every
point masked, K8 at 16 sequences, K5, K8 and K11 refusing a float mask,
and second launches of K3, K4, K5, K8, K9 and K11 (the same bits); five frames of the single-sequence step, ten of
the fused step, three of the batch step, twelve of the VO slice (with one
keyframe cycle) and forty of the monocular System from raw frames on the
card against the CPU, and that System run twice on the card (the same
bits); the chunk step of `VisualOdometry.add_frames` replayed as a CUDA
graph against the eager step under each FUSED_VARIANT (bit for bit), its
warm-up, capture and replay under torch.cuda.set_sync_debug_mode("error"),
both also for the step with the depth filter's seed update, forty frames
through `track_monocular_chunk` against `track_monocular` (bit for bit),
and BoxScene rendered on the card against the CPU.
chip_smoke.py holds every kernel against its plain version on the main
paths' own inputs.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: kernel and plain version run the same float32 algorithm and
differ in the order of their sums only (warp shuffles versus PyTorch
reductions; the kernels are built without multiply-add contraction, so
each per-point value rounds as the plain version's does), so poses agree
far below the 1e-4 GN stopping step and K1's copy is exact.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import batch as bm
from ygz_slam_tpu_torch.models import tracking as tr
from ygz_slam_tpu_torch.models import vo_workload as vw
from ygz_slam_tpu_torch.ops import hamming as tham
from ygz_slam_tpu_torch.ops import kernels
from ygz_slam_tpu_torch.ops.kernels import align2d_fused as tk4
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tk1
from ygz_slam_tpu_torch.ops.kernels import hamming_kernel as tk10
from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused as tk5
from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused_batch as tk8
from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as tk3
from ygz_slam_tpu_torch.ops.kernels import track_fused as tk11

from _torch_port import cuda_device, zero_padded_stack  # noqa: F401

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL_POSE = 1e-4
TOL_SLICE = 1e-3        # whole step, card versus CPU, three solvers in a row
TOL_MAPPED = 5e-3       # the monocular System after a mapping pass (see its test)


@pytest.fixture(scope="module")
def card_workload():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    out = tr.make_workload(5, dev)
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = out
    return dict(out=out, state=tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches),
                dev=dev)


def _pose(out):
    return TSE3(out[:9].reshape(3, 3), out[9:12])


def test_gather_windows(cuda_device):
    rng = np.random.default_rng(14)
    img = torch.tensor(rng.uniform(0, 255, (480, 640)), dtype=torch.float32, device=cuda_device)
    xi = torch.tensor(rng.integers(-5, 640, 200), dtype=torch.int32, device=cuda_device)
    yi = torch.tensor(rng.integers(-5, 480, 200), dtype=torch.int32, device=cuda_device)
    for win in (7, 16, 32):
        n0 = tk1.gather_windows.launches
        out = tk1.gather_windows(img, xi, yi, win)
        assert tk1.gather_windows.launches == n0 + 1
        torch.testing.assert_close(out, tk1.gather_windows_plain(img, xi, yi, win),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 200, 512])
@pytest.mark.parametrize("win", [7, 16, 32])
@pytest.mark.parametrize("levels", [1, 3])
def test_gather_windows_levels(cuda_device, levels, win, n):
    """K1 over a pyramid (640x480, 320x240, 160x120) against its plain
    version bit for bit, a third of each level's origins off the image
    (negative and past W - win / H - win); one launch per call."""
    rng = np.random.default_rng(16 + win + n)
    imgs, xs, ys = [], [], []
    for H, W in ((480, 640), (240, 320), (120, 160))[:levels]:
        imgs.append(torch.tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32,
                                 device=cuda_device))
        x, y = rng.integers(0, W - win + 1, n), rng.integers(0, H - win + 1, n)
        k = max(1, n // 3)
        x[:k], y[:k] = rng.integers(-40, W + 11, k), rng.integers(-40, H + 11, k)
        xs.append(x)
        ys.append(y)
    xi = torch.tensor(np.array(xs), dtype=torch.int32, device=cuda_device)
    yi = torch.tensor(np.array(ys), dtype=torch.int32, device=cuda_device)
    ref = tk1.gather_windows_levels_plain(tuple(imgs), xi, yi, win)
    n0 = tk1.gather_windows_levels.launches
    out = tk1.gather_windows_levels(tuple(imgs), xi, yi, win)
    assert tk1.gather_windows_levels.launches == n0 + 1
    assert torch.equal(out, ref)


def test_gather_windows_levels_refuses_nine_levels(cuda_device):
    img = torch.zeros((64, 64), device=cuda_device)
    xi = torch.zeros((9, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="levels"):
        tk1.gather_windows_levels((img,) * 9, xi, xi, 16)


def test_pose_ba_fused(card_workload):
    st, (cam, *_, frames, T_gt7) = card_workload["state"], card_workload["out"]
    rng = np.random.default_rng(2)
    obs = cam.world_to_pixel(st.pts_w, TSE3.from_params7(T_gt7[1]), distorted=False)
    noise = rng.normal(0, 0.3, obs.shape)
    noise[:30] += rng.uniform(8, 30, (30, 2))                       # gross outliers
    obs = obs + torch.tensor(noise, dtype=torch.float32, device=obs.device)
    mask = st.mask.clone()
    mask[30:40] = False
    args = tk5.pose_ba_args(TSE3.from_params7(T_gt7[0]), st.pts_w, obs, mask, cam)
    n0 = tk5.pose_ba_gn.launches
    out, inl = tk5.pose_ba_gn(*args)
    assert tk5.pose_ba_gn.launches == n0 + 1
    ref, inl_ref = tk5.pose_ba_gn_plain(*args)
    assert float(tse3.distance(_pose(out), _pose(ref))) <= TOL_POSE
    assert float(((inl > 0.5) == (inl_ref > 0.5)).float().mean()) >= 0.99
    assert not bool((inl[:40] > 0.5).any())


def test_track_step_card_matches_cpu(card_workload):
    """Five frames of the step on the card (kernels) against the CPU
    (plain versions), each kernel launched as often as the step calls it."""
    out, state, dev = card_workload["out"], card_workload["state"], card_workload["dev"]
    counters = (tk1.gather_windows_levels, tk1.gather_windows, tk3.mega_gn, tk4.a2d_gn,
                tk5.pose_ba_gn)
    before = [c.launches for c in counters]
    T7, inl = tr.track_frames(state, out[7], TSE3.identity(device=dev).params7())
    assert [c.launches - b for c, b in zip(counters, before)] == [5, 5, 5, 5, 5]
    assert tr.gate(T7, inl, out[8])[2]
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, _ = [
        a.cpu() if isinstance(a, torch.Tensor) else a for a in out]
    state_c = tr.make_state(cam, [lv.cpu() for lv in ref_pyr], px, depth, mask, pts_w,
                            patches)
    T7c, _ = tr.track_frames(state_c, frames, TSE3.identity(device="cpu").params7())
    d = tse3.distance(TSE3.from_params7(T7.cpu()), TSE3.from_params7(T7c))
    assert float(d.max()) <= TOL_SLICE


@pytest.mark.parametrize("n_masked", [0, 10], ids=["frame1", "ten_masked"])
def test_track_fused_kernel_matches_plain(card_workload, n_masked):
    """K11 against its plain version on the inputs frame 1 of the fused path
    gives it, and with landmarks 0-9 masked (none of them may be accepted
    by align2d or be an inlier)."""
    from ygz_slam_tpu_torch.ops import pyramid

    st, (cam, *_, frames, T_gt7) = card_workload["state"], card_workload["out"]
    mask = st.mask.clone()
    mask[:n_masked] = False
    T0 = TSE3.from_params7(T_gt7[0])
    args = tk11.track_args(pyramid.build_pyramid(frames[1], 3), st.ref_prep.levels,
                           st.ref_prep.p_ref, st.a2d_prep, st.pts_w, mask, T0.R, T0.t, cam,
                           False, 2)
    n0 = tk11.track_gn.launches
    out, xy, per = tk11.track_gn(*args)
    assert tk11.track_gn.launches == n0 + 1
    ref, xy_r, per_r = tk11.track_gn_plain(*args)
    assert float(tse3.distance(_pose(out), _pose(ref))) <= TOL_POSE
    assert float(tse3.distance(_pose(out[15:]), _pose(ref[15:]))) <= TOL_POSE
    for k in (12, 13):
        assert abs(float(out[k]) - float(ref[k])) <= 1e-4 * max(abs(float(ref[k])), 1e-6)
    conv, conv_r = per[1] > 0.5, per_r[1] > 0.5
    both = conv & conv_r
    dxy = torch.linalg.norm(xy[both] - xy_r[both], dim=1)
    assert float((conv == conv_r).float().mean()) >= 0.98
    assert float((dxy <= 1e-3).float().mean()) >= 0.98 and float(dxy.max()) <= 0.05
    assert float(((per[2] > 0.5) == (per_r[2] > 0.5)).float().mean()) >= 0.99
    assert float(out[14]) == float(per[2].sum()) > 150 - n_masked
    assert not bool((per[1:, :n_masked] > 0.5).any())


def test_fused_path_card_matches_cpu(cuda_device):
    """Ten frames of `fused_track_step` on the card (K1 twice, the
    pyramid's levels in one launch, and K11 once per frame, no K3, K4 or
    K5) against the CPU (plain versions)."""
    out = tr.make_workload(10, cuda_device)
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = out
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)
    counters = (tk1.gather_windows_levels, tk1.gather_windows, tk11.track_gn, tk3.mega_gn,
                tk4.a2d_gn, tk5.pose_ba_gn)
    before = [c.launches for c in counters]
    T7, inl = tr.track_frames(state, frames, TSE3.identity(device=cuda_device).params7(),
                              step=tr.fused_track_step)
    assert [c.launches - b for c, b in zip(counters, before)] == [10, 10, 10, 0, 0, 0]
    assert tr.gate(T7, inl, T_gt7)[2]
    state_c = tr.make_state(cam, [lv.cpu() for lv in ref_pyr], px.cpu(), depth.cpu(),
                            mask.cpu(), pts_w.cpu(), patches.cpu())
    T7c, inl_c = tr.track_frames(state_c, frames.cpu(), TSE3.identity(device="cpu").params7(),
                                 step=tr.fused_track_step)
    d = tse3.distance(TSE3.from_params7(T7.cpu()), TSE3.from_params7(T7c))
    print(f"fused path, card versus CPU over 10 frames: max pose distance {float(d.max()):.3e}, "
          f"inliers {inl.tolist()} vs {inl_c.tolist()}")
    assert float(d.max()) <= TOL_SLICE
    assert int((inl.cpu() - inl_c).abs().max()) <= 2


def test_gather_windows_grouped_eight_groups(cuda_device):
    """K6 at its limit of eight requests: three image sizes, windows 7, 16
    and 32, one image named three times, origins off the image, and one
    empty request."""
    rng = np.random.default_rng(15)
    imgs = [torch.tensor(rng.uniform(0, 255, s), dtype=torch.float32, device=cuda_device)
            for s in ((480, 640), (240, 320), (120, 160))]
    groups = []
    for k, (i, win, n) in enumerate([(0, 16, 200), (1, 16, 200), (2, 16, 200), (0, 32, 200),
                                     (0, 7, 50), (1, 32, 0), (2, 7, 64), (1, 16, 33)]):
        H, W = imgs[i].shape
        xi = torch.tensor(rng.integers(-40, W + 11, n), dtype=torch.int32, device=cuda_device)
        yi = torch.tensor(rng.integers(-40, H + 11, n), dtype=torch.int32, device=cuda_device)
        groups.append((imgs[i], xi, yi, win))
    n0 = tk1.gather_windows_grouped.launches
    out = tk1.gather_windows_grouped(groups)
    assert tk1.gather_windows_grouped.launches == n0 + 1
    for o, ref in zip(out, tk1.gather_windows_grouped_plain(groups)):
        torch.testing.assert_close(o, ref, rtol=0, atol=0)


@pytest.mark.parametrize("n_req", [24, 48])
def test_gather_windows_grouped_many_requests(cuda_device, n_req):
    """K6 on a batched frame's worth of requests (S=8 and S=16 sequences of
    three levels): three image sizes, windows 7, 16 and 32, the first image
    named in every third request, a third of the origins off the image,
    one request empty; one launch, equal to the plain version."""
    rng = np.random.default_rng(17 + n_req)
    imgs = [torch.tensor(rng.uniform(0, 255, s), dtype=torch.float32, device=cuda_device)
            for s in ((480, 640), (240, 320), (120, 160))]
    groups = []
    for k in range(n_req):
        img, win, n = imgs[0 if k % 3 == 0 else k % 3], (7, 16, 32)[k % 3], 200 - 7 * (k % 5)
        n = 0 if k == 5 else n
        H, W = img.shape
        x, y = rng.integers(0, W - win + 1, n), rng.integers(0, H - win + 1, n)
        k = n // 3
        x[:k], y[:k] = rng.integers(-40, W + 11, k), rng.integers(-40, H + 11, k)
        groups.append((img, torch.tensor(x, dtype=torch.int32, device=cuda_device),
                       torch.tensor(y, dtype=torch.int32, device=cuda_device), win))
    n0 = tk1.gather_windows_grouped.launches
    out = tk1.gather_windows_grouped(groups)
    assert tk1.gather_windows_grouped.launches == n0 + 1
    for o, ref in zip(out, tk1.gather_windows_grouped_plain(groups)):
        assert torch.equal(o, ref)


@pytest.mark.parametrize("S,launches", [(8, 1), (16, 1), (22, 2)])
def test_gather_frames_windows_launches(cuda_device, S, launches):
    """Every sequence's sparse-align windows of a batched frame in one K6
    launch up to 21 sequences (63 requests), in two at 22; equal bit for
    bit to the CPU's gathering of the same frame (the plain version), and
    the batch path's own stage (`batched_sparse_align`) launches K6 as
    often."""
    from ygz_slam_tpu_torch.ops import pyramid, sparse_align
    from ygz_slam_tpu_torch.parallel import batch_tracking as bt

    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, T_gt7 = \
        bm.make_batch_workload(S, 2, cuda_device)
    state = bm.make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches)
    cur = pyramid.build_pyramid(frames[1], len(ref_pyrs))
    T0 = TSE3.from_params7(T_gt7[0][None].repeat(S, 1))
    T0s = [TSE3.from_params7(T_gt7[0]) for _ in range(S)]
    cps = [tuple(c[s] for c in cur) for s in range(S)]
    n0 = tk1.gather_windows_grouped.launches
    fws = sparse_align.gather_frames_windows(cps, cam, state.ref_preps, T0s)
    assert tk1.gather_windows_grouped.launches == n0 + launches
    cpu = sparse_align.gather_frames_windows(
        [tuple(lv.cpu() for lv in cp) for cp in cps], cam,
        [_to(p, "cpu") for p in state.ref_preps],
        [TSE3.from_params7(T_gt7[0].cpu()) for _ in range(S)])
    for fw, fc in zip(fws, cpu):
        for a, b in zip(fw.mega_wins, fc.mega_wins):
            assert torch.equal(a.cpu(), b)
    n0 = tk1.gather_windows_grouped.launches
    bt.batched_sparse_align(state.ref_pyrs, cur, cam, state.px, state.depth, state.mask, T0,
                            state.ref_preps)
    assert tk1.gather_windows_grouped.launches == n0 + launches


def test_gather_windows_multi_bad_index_stops(cuda_device):
    """K2 given an image index past its stack stops on its device-side
    assert instead of reading past the stack.  The assert leaves the CUDA
    context unusable, so the launch runs in a child process."""
    code = (
        "import torch\n"
        "from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as k\n"
        "imgs = torch.zeros(2, 64, 64, device='cuda')\n"
        "o = torch.zeros(3, dtype=torch.int32, device='cuda')\n"
        "idx = torch.tensor([0, 1, 2], dtype=torch.int32, device='cuda')\n"
        "k.gather_windows_multi(imgs, idx, o, o, 16)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no error" not in r.stdout, (r.stdout, r.stderr)
    assert "device-side assert" in r.stderr, r.stderr[-2000:]


def _k2_problem(dev, way, case, win, n, seed):
    """K2's arguments: the levels of a 480x640 pyramid (case "inside" or
    "off_image": a third of the origins off the image) or of a 61x83 one
    ("tiny": level 2 is 16x21, smaller than the 32-px window, with origins
    past each level's own edge and off the image), named as a table or as
    their zero-padded stack."""
    from ygz_slam_tpu_torch.ops import pyramid

    rng = np.random.default_rng(seed)
    shape = (61, 83) if case == "tiny" else (480, 640)
    levels = pyramid.build_pyramid(
        torch.tensor(rng.uniform(0, 255, shape), dtype=torch.float32, device=dev), 3)
    H, W = shape
    idx = rng.integers(0, 3, n)
    hl = np.array([lv.shape[0] for lv in levels])[idx]
    wl = np.array([lv.shape[1] for lv in levels])[idx]
    x = (rng.uniform(0, 1, n) * np.maximum(wl - win + 1, 1)).astype(int)
    y = (rng.uniform(0, 1, n) * np.maximum(hl - win + 1, 1)).astype(int)
    if case != "inside":
        k = max(1, n // 3)
        x[:k], y[:k] = rng.integers(-40, W + 11, k), rng.integers(-40, H + 11, k)
    if case == "tiny":
        x[-k:], y[-k:] = wl[-k:] - win + 1 + rng.integers(0, 20, k), rng.integers(-5, H, k)
    imgs = zero_padded_stack(levels) if way == "stack" else tuple(levels)
    return (imgs, *(torch.tensor(v, dtype=torch.int32, device=dev) for v in (idx, x, y)), win)


@pytest.mark.parametrize("case", ["inside", "off_image", "tiny"])
@pytest.mark.parametrize("win", [7, 32])
@pytest.mark.parametrize("way", ["stack", "table"])
def test_gather_windows_multi_both_ways(cuda_device, way, win, case):
    """K2 on a uniform stack and on a table of images of their own shapes
    against its plain version bit for bit (windows 7: scalar stores, 32:
    float4 stores), with origins off the image and, on a 61x83 pyramid, a
    level smaller than the window; one launch per call."""
    a2 = _k2_problem(cuda_device, way, case, win, 512, 60 + win)
    n0 = tk1.gather_windows_multi.launches
    out = tk1.gather_windows_multi(*a2)
    assert tk1.gather_windows_multi.launches == n0 + 1
    assert torch.equal(out, tk1.gather_windows_multi_plain(*a2))


@pytest.mark.parametrize("case", ["inside", "tiny"])
@pytest.mark.parametrize("n", [1, 512, 3000])
def test_gather_windows_multi_table_equals_stack(cuda_device, n, case):
    """K2 on a pyramid's levels, read in place, gives K2's windows on their
    zero-padded stack bit for bit (the VO's route against the one it
    replaced)."""
    table = _k2_problem(cuda_device, "table", case, 32, n, 70)
    stack = _k2_problem(cuda_device, "stack", case, 32, n, 70)
    assert torch.equal(tk1.gather_windows_multi(*table), tk1.gather_windows_multi(*stack))


def test_gather_windows_multi_stack_has_no_cap(cuda_device):
    """The stack way takes any number of images (40 here, five times the
    table's cap)."""
    rng = np.random.default_rng(71)
    imgs = torch.tensor(rng.uniform(0, 255, (40, 64, 96)), dtype=torch.float32,
                        device=cuda_device)
    idx, x, y = rng.integers(0, 40, 400), rng.integers(-10, 80, 400), rng.integers(-10, 50, 400)
    a2 = (imgs, *(torch.tensor(v, dtype=torch.int32, device=cuda_device) for v in (idx, x, y)),
          32)
    assert torch.equal(tk1.gather_windows_multi(*a2), tk1.gather_windows_multi_plain(*a2))


def test_gather_windows_multi_table_refuses_nine_images(cuda_device):
    img = torch.zeros((64, 64), device=cuda_device)
    o = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="table"):
        tk1.gather_windows_multi((img,) * 9, o, o, o, 16)


def test_gather_windows_multi_table_bad_index_stops(cuda_device):
    """K2 given an image index past its table stops on its device-side
    assert, in a child process (see the stack's test above)."""
    code = (
        "import torch\n"
        "from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as k\n"
        "imgs = (torch.zeros(64, 64, device='cuda'), torch.zeros(32, 32, device='cuda'))\n"
        "o = torch.zeros(3, dtype=torch.int32, device='cuda')\n"
        "idx = torch.tensor([0, 1, 2], dtype=torch.int32, device='cuda')\n"
        "k.gather_windows_multi(imgs, idx, o, o, 16)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no error" not in r.stdout, (r.stdout, r.stderr)
    assert "device-side assert" in r.stderr, r.stderr[-2000:]


def test_pose_ba_batch_one_sequence_masked(card_workload):
    """K8 on four sequences built from frame 1's observations with
    different noise and outliers, the third fully masked: each sequence
    agrees with the plain version, the masked one keeps its initial pose
    and has no inliers."""
    st, (cam, *_, frames, T_gt7) = card_workload["state"], card_workload["out"]
    rng = np.random.default_rng(6)
    S = 4
    obs = cam.world_to_pixel(st.pts_w, TSE3.from_params7(T_gt7[1]), distorted=False)
    px = obs[None] + torch.tensor(rng.normal(0, 0.3, (S,) + obs.shape), dtype=torch.float32,
                                  device=obs.device)
    px[:, :20] += torch.tensor(rng.uniform(8, 30, (S, 20, 2)), dtype=torch.float32,
                               device=obs.device)
    mask = st.mask[None].repeat(S, 1)
    mask[2] = False
    mask[0, 40:60] = False
    T0 = TSE3.from_params7(T_gt7[0][None].repeat(S, 1))
    args = tk8.pose_ba_batch_args(T0, st.pts_w[None].repeat(S, 1, 1), px, mask, cam)
    n0 = tk8.pose_ba_batch_gn.launches
    out, inl = tk8.pose_ba_batch_gn(*args)
    assert tk8.pose_ba_batch_gn.launches == n0 + 1
    ref, inl_ref = tk8.pose_ba_batch_gn_plain(*args)
    for s in range(S):
        assert float(tse3.distance(_pose(out[s]), _pose(ref[s]))) <= TOL_POSE
        assert float(((inl[s] > 0.5) == (inl_ref[s] > 0.5)).float().mean()) >= 0.99
    torch.testing.assert_close(out[2, :12], args[3][2], rtol=0, atol=0)
    assert not bool((inl[2] > 0.5).any()) and not bool((inl[:, :20] > 0.5).any())
    assert bool(torch.isfinite(out).all())


def test_batch_step_card_matches_cpu(cuda_device):
    """Three frames of the batch step (S=3) on the card against the CPU,
    each kernel launched as often as the step calls it."""
    S, F = 3, 3
    out = bm.make_batch_workload(S, F, cuda_device)
    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, T_gt7 = out
    state = bm.make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches)
    counters = (tk1.gather_windows, tk1.gather_windows_grouped, tk3.mega_gn,
                tk1.gather_windows_multi, tk4.a2d_gn, tk8.pose_ba_batch_gn)
    before = [c.launches for c in counters]
    T7, inl = bm.track_batch_frames(state, frames, TSE3.identity((S,), device=cuda_device)
                                    .params7())
    assert [c.launches - b for c, b in zip(counters, before)] == [0, F, S * F, F, F, F]
    assert bm.batch_gate(T7, inl, T_gt7)[2]
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in out]
    state_c = bm.make_batch_state(cam, [lv.cpu() for lv in ref_pyrs], *cpu[1:6])
    T7c, inl_c = bm.track_batch_frames(state_c, cpu[7], TSE3.identity((S,), device="cpu")
                                       .params7())
    d = tse3.distance(TSE3.from_params7(T7.cpu()), TSE3.from_params7(T7c))
    assert float(d.max()) <= TOL_SLICE
    assert int((inl.cpu() - inl_c).abs().max()) <= 2


def _words(n, seed, device):
    r = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    return torch.from_numpy(r.view(np.int32)).to(device)


@pytest.mark.parametrize("n,m", [(0, 5), (5, 0), (0, 0), (1, 1), (1, 300), (300, 1), (33, 129)])
def test_hamming_edge_shapes(cuda_device, n, m):
    """K10 with an empty side (no launch), one row, and sizes one past a
    tile edge: equal to the plain version, integers."""
    a, b = _words(n, 0, cuda_device), _words(m, 1, cuda_device)
    before = tk10.distance_matrix.launches
    out = tham.distance_matrix(a, b)
    assert tk10.distance_matrix.launches - before == (1 if n and m else 0)
    assert out.dtype == torch.int32 and tuple(out.shape) == (n, m)
    assert torch.equal(out.cpu(), tk10.distance_matrix_plain(a.cpu(), b.cpu()))


@pytest.mark.parametrize("n,m", [(1, 1), (15, 9), (16, 8), (17, 9), (130, 77), (128, 256),
                                 (128, 512), (256, 3072), (2560, 3072), (65535 * 32 + 17, 9)])
def test_hamming_sizes(cuda_device, n, m):
    """K10 exact against its plain version from one pair to 2560 x 3072,
    across and one past its 16 x 8 tensor-core tiles, with all-ones,
    sign-bit-only and zero words planted in both sides; and more row tiles
    than a grid's y dimension holds (65535), on its one-dimensional grid."""
    a, b = _words(n, 3 + n, cuda_device), _words(m, 4 + m, cuda_device)
    for t in (a, b):
        t[0] = -1
        if t.shape[0] > 2:
            t[1], t[2] = -2 ** 31, 0
    before = tk10.distance_matrix.launches
    out = tham.distance_matrix(a, b)
    assert tk10.distance_matrix.launches == before + 1
    assert torch.equal(out, tk10.distance_matrix_plain(a, b))
    assert int(out[0, 0]) == 0
    if n > 2 and m > 2:
        assert (int(out[0, 2]), int(out[1, 2]), int(out[0, 1])) == (256, 8, 248)


def test_hamming_refuses_what_the_kernel_does_not_take(cuda_device):
    a = _words(8, 2, cuda_device)
    for bad in (a.long(), a[:, :7].contiguous(), a[::2], a.cpu()):
        with pytest.raises(ValueError):
            tham.distance_matrix(a, bad)


def _to(x, device):
    """A VOState (nested tuples of tensors and plain values) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields") and not isinstance(x[0], float):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_to(v, device) for v in x)
    return x


def test_vo_slice_card_matches_cpu(cuda_device):
    """Twelve frames of the VO slice with the keyframe cycle at frame 10, on
    the card (kernels) against the CPU (plain versions) from the same
    bootstrapped state, each kernel launched as often as the steps call it.
    The detector's float32 integral image is summed in another order on the
    card, so a few corners of the new keyframe may differ."""
    state, frames, T_gt7 = vw.make_vo_workload(13, cuda_device)
    counters = (tk1.gather_windows_levels, tk1.gather_windows, tk1.gather_windows_multi,
                tk3.mega_gn, tk4.a2d_gn, tk5.pose_ba_gn, tk10.distance_matrix)
    before = [c.launches for c in counters]
    st, T7, inl, log = vw.track_vo_frames(state, frames[1:])
    assert [c.launches - b for c, b in zip(counters, before)] == [24, 0, 12, 12, 12, 12, 2]
    assert vw.vo_gate(T7, inl, T_gt7[1:])[2]
    # The CPU run, frame by frame, keeping the state each frame started from.
    st_c, starts, T7c, inl_c, log_c = _to(state, "cpu"), [], [], [], []
    for img in frames[1:].cpu():
        starts.append(st_c)
        st_c, pyr_c, tm_c = vw.track_vo_frame(st_c, img)
        T7c.append(st_c.prev_T_cw7)
        inl_c.append(tm_c.n_inliers)
        if st_c.frame_id % st_c.opts.kf_min_frames == 0:
            st_c, counts = vw.insert_vo_keyframe(st_c, pyr_c, tm_c)
            log_c.append(counts)
    T7c, inl_c = torch.stack(T7c), torch.stack(inl_c)
    # One step from the same state: the kernels against their plain versions
    # through the whole `track`, the frame after the keyframe cycle included.
    # From frame 7 on the NS selection hands K3 masked landmark rows at depth
    # ~0, whose Jacobians' squares overflow float32: rows that neither the
    # kernel nor its plain version may read.
    for i, start in enumerate(starts):
        one, _, tm1 = vw.track_vo_frame(_to(start, cuda_device), frames[1 + i])
        d1 = float(tse3.distance(TSE3.from_params7(one.prev_T_cw7.cpu()),
                                 TSE3.from_params7(T7c[i])))
        assert d1 <= TOL_POSE, (i, d1)
        assert abs(int(tm1.n_inliers) - int(inl_c[i])) <= 1, i
    # Chained, each run feeds its own found set and pose forward.
    d = tse3.distance(TSE3.from_params7(T7.cpu()), TSE3.from_params7(T7c))
    print(f"card versus CPU over 12 chained VO frames: max pose distance {float(d.max()):.3e}, "
          f"inliers {inl.tolist()} vs {inl_c.tolist()}")
    assert float(d.max()) <= TOL_SLICE
    assert int((inl.cpu() - inl_c).abs().max()) <= 3
    assert len(log) == len(log_c) == 1
    assert (log[0]["slot"], log[0]["evicted"]) == (log_c[0]["slot"], log_c[0]["evicted"]) == (1, False)
    assert abs(log[0]["landmarks"] - log_c[0]["landmarks"]) <= 3
    m, mc = st.mstate, st_c.mstate
    assert float((m.feat_valid[1].cpu() == mc.feat_valid[1]).float().mean()) >= 0.95
    assert torch.equal(m.kf_valid.cpu(), mc.kf_valid) and torch.equal(m.kf_id.cpu(), mc.kf_id)


def test_recorded_launches_are_the_steps_own(cuda_device):
    """One VO frame and a keyframe cycle under `record_launches`: the
    kernels in the order the steps launch them, each entry holding the
    arguments its wrapper was given (replayed, the gathers and K10 equal
    their plain versions)."""
    state, frames, _ = vw.make_vo_workload(2, cuda_device)
    with kernels.record_launches() as rec:
        vw.track_vo_frames(state, frames[1:], kf_every=1)
    names = [fn.__name__ for fn, _ in rec]
    assert names == (["gather_windows_levels"] * 2 + ["mega_gn", "gather_windows_multi",
                                                      "a2d_gn", "pose_ba_gn"]
                     + ["distance_matrix"] * 2)
    assert [(len(a[0]), a[3]) for fn, a in rec[:2]] == [(3, 7), (3, 16)]
    # Both triangulation neighbours' 256 descriptors stacked (here both are
    # the bootstrap keyframe), then the fusion with every landmark row.
    assert [tuple(a[0].shape) + tuple(a[1].shape) for fn, a in rec[6:]] == \
        [(128, 8, 512, 8), (256, 8, 3072, 8)]
    plain = {tk1.gather_windows_levels: tk1.gather_windows_levels_plain,
             tk1.gather_windows_multi: tk1.gather_windows_multi_plain,
             tk10.distance_matrix: tk10.distance_matrix_plain}
    for fn, args in rec:
        if fn in plain:
            assert torch.equal(fn(*args), plain[fn](*args))
    with kernels.record_launches() as rec2:
        pass
    assert rec2 == []


def _level_case(dev, motion, n_max=256):
    """One 640x480 frame pair of the plane (FAST corners of the reference,
    at most n_max): (camera, reference prep, current pyramid) on `dev`."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.ops import fast, pyramid, sparse_align
    from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

    cam = PinholeCamera.create(640.0, 640.0, 320.0, 240.0)
    scene = PlaneScene(cam, plane_z=3.0, seed=3, device=dev)
    ident = TSE3.identity(device=dev)
    ref = scene.render(ident, (480, 640))
    cur = scene.render(tse3.exp(torch.tensor(motion, dtype=torch.float32, device=dev)),
                       (480, 640))
    c = fast.detect(ref, 20.0, 16, n_max)
    prep = sparse_align.prepare_reference(pyramid.build_pyramid(ref, 3), cam, c.xy,
                                          scene.depth(c.xy, ident), c.mask, distorted=False)
    return cam, prep, pyramid.build_pyramid(cur, 3)


def _k9_agree(args, v2=False):
    """K9 v1 or v2 against its plain version on `args`; H (v1: at the last
    accepted state, v2: H0) relative."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    fn, plain = (tk9.level_gn_v2, tk9.level_gn_v2_plain) if v2 else \
        (tk9.level_gn, tk9.level_gn_plain)
    n0 = fn.launches
    out, ref = fn(*args), plain(*args)
    assert fn.launches == n0 + 1
    torch.testing.assert_close(out[13:], ref[13:], rtol=1e-4, atol=1e-4 * float(
        ref[13:].abs().max()))
    assert float(tse3.distance(_pose(out), _pose(ref))) <= TOL_POSE
    assert abs(float(out[12]) - float(ref[12])) <= 1e-4 * max(abs(float(ref[12])), 1e-6)
    return out


@pytest.mark.parametrize("motion", [[0.03, -0.02, 0.01, 0.002, -0.004, 0.002],
                                    [0.06, 0.04, -0.02, -0.004, 0.006, 0.004]],
                         ids=["small", "large"])
def test_level_align_kernels_match_plain(cuda_device, motion):
    """K9 v1 and v2 at every level of a 640x480 frame pair from the
    identity (the large motion makes the coarse level roll back), on one
    level where no point is usable (the pose must not move), and with the
    windows of a shifted init pose clamped at the image border."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    cam, prep, cur = _level_case(cuda_device, motion)
    R0 = torch.eye(3, device=cuda_device)
    t0 = torch.zeros(3, device=cuda_device)
    for level in range(3):
        args = tk9.level_args(cur[level], prep.levels[level], prep.p_ref, R0, t0, cam, level,
                              False)
        _k9_agree(args)
        _k9_agree(args, v2=True)
    lr = prep.levels[0]._replace(vis=torch.zeros_like(prep.levels[0].vis))
    args = tk9.level_args(cur[0], lr, prep.p_ref, R0, t0, cam, 0, False)
    for v2 in (False, True):
        out = _k9_agree(args, v2)
        torch.testing.assert_close(out[:12], args[7], rtol=0, atol=0)
        assert float(out[12]) == 0.0 and float(out[13:].abs().max()) == 0.0
    # A 0.5 m sideways shift of the init pose: a third of the projections
    # leave the image, and the windows of those near its edge are clamped.
    t_side = torch.tensor([0.5, 0.3, 0.0], device=cuda_device)
    for level in range(3):
        lr = prep.levels[level]
        args = tk9.level_args(cur[level], lr, prep.p_ref, R0, t_side, cam, level, False)
        Hl, Wl = cur[level].shape
        ox, oy = args[5], args[6]
        clamped = (ox == 0) | (ox == Wl - tk9.CWIN) | (oy == 0) | (oy == Hl - tk9.CWIN)
        assert int((clamped & lr.vis).sum()) > 0
        _k9_agree(args)
        _k9_agree(args, v2=True)


def test_mono_system_card_matches_cpu(cuda_device, monkeypatch):
    """The monocular System from raw frames (640x480, 40 frames of the
    workload) on the card against the CPU: the same init frame and model,
    equal statuses, keyframes on the same frames, poses within 1e-3 of the
    map's unit up to the first keyframe and within 5e-3 after its mapping
    pass.  A CUDA and a CPU generator of one seed draw other RANSAC
    samples, so the CPU runs are handed the card run's draws.

    The looser bound after the first mapping pass is the system's own
    sensitivity to summation order: local BA's LM accept/reject and the
    keyframe's detections amplify rounding.  A second CPU run with another
    thread count (another order of the CPU's own sums) parts from the
    first by the same order of magnitude, printed beside the card's gap."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.solvers import initializer as tin
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, T_gt7 = mw.make_mono_workload(40, device=cuda_device)
    draws = {}
    real_sample = tin.sample_hypotheses

    def card_sample(mask, n, gen):
        draws[gen.initial_seed()] = idx = real_sample(mask, n, gen)
        return idx

    def cpu_sample(mask, n, gen):
        return draws[gen.initial_seed()].cpu()

    def run(dev, imgs, sample):
        monkeypatch.setattr(tin, "sample_hypotheses", sample)
        s = System(camera=cam, options=mw.mono_options(), device=dev)
        kf = []

        def on_frame(k, r):
            if s.vo.stats["keyframes"] > len(kf):
                kf.append(k)

        st, T7, _ = mw.run_mono(s, imgs, on_frame)
        return st, torch.tensor(T7), kf, s.vo.init_used_h

    card = run(cuda_device, frames, card_sample)
    cpu = run("cpu", frames.cpu(), cpu_sample)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cpu4 = run("cpu", frames.cpu(), cpu_sample)
    finally:
        torch.set_num_threads(threads)
    assert draws
    k0 = mw.init_frame(card[0])
    assert k0 == mw.init_frame(cpu[0]) >= 0 and card[3] == cpu[3]
    assert card[0] == cpu[0] and card[2] == cpu[2] and len(card[2]) >= 2

    def gap(a, b):
        return tse3.distance(TSE3.from_params7(a[1]), TSE3.from_params7(b[1]))

    d, d_cpu = gap(card, cpu), gap(cpu4, cpu)
    first_kf = card[2][0]
    print(f"mono System over 40 frames, init frame {k0}, keyframes {card[2]}: card versus "
          f"CPU max pose distance {float(d[:first_kf + 1].max()):.3e} up to the first keyframe, "
          f"{float(d.max()):.3e} overall; CPU 4 threads versus 1 thread "
          f"{float(d_cpu[:first_kf + 1].max()):.3e} and {float(d_cpu.max()):.3e}")
    assert float(d[:first_kf + 1].max()) <= TOL_SLICE
    assert float(d.max()) <= TOL_MAPPED
    assert mw.mono_gate(card[0], card[1].numpy(), T_gt7.cpu())[2]


# -- the Hopper redesign of K3 and of the pose-BA body (K5, K8, K11) ------

_SIZED = {}


def _sized(dev, n):
    """The tracking workload with n landmarks (two frames) and its state."""
    if n not in _SIZED:
        out = tr.make_workload(2, dev, n_points=n)
        cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = out
        _SIZED[n] = (out, tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches))
    return _SIZED[n]


def _k3_args(dev, n):
    from ygz_slam_tpu_torch.ops import pyramid

    (cam, *_, frames, T_gt7), st = _sized(dev, n)
    T0 = TSE3.from_params7(T_gt7[0])
    return tk3.mega_args(pyramid.build_pyramid(frames[1], 3), st.ref_prep.levels,
                         st.ref_prep.p_ref, T0.R, T0.t, cam, False, 3, st.ref_prep.mega_refp,
                         st.ref_prep.mega_jl)[0]


def _k5_args(dev, n, seed=4):
    (cam, *_, frames, T_gt7), st = _sized(dev, n)
    rng = np.random.default_rng(seed)
    obs = cam.world_to_pixel(st.pts_w, TSE3.from_params7(T_gt7[1]), distorted=False)
    noise = rng.normal(0, 0.3, obs.shape)
    k = max(1, n // 10)
    noise[:k] += rng.uniform(8, 30, (k, 2))                         # gross outliers
    obs = obs + torch.tensor(noise, dtype=torch.float32, device=dev)
    mask = st.mask.clone()
    mask[k:k + n // 20] = False
    return tk5.pose_ba_args(TSE3.from_params7(T_gt7[0]), st.pts_w, obs, mask, cam)


@pytest.mark.parametrize("n", [1, 31, 200, 512, 1500])
def test_sparse_align_mega_sizes(cuda_device, n):
    """K3 against its plain version from 1 to 1500 points (the kernel's
    fixed block of 512 threads takes the 16 pixels of each point on 16
    lanes: 1500 points are three rounds of its warps), and two launches
    equal bit for bit."""
    args = _k3_args(cuda_device, n)
    out = tk3.mega_gn(*args)
    stats = {}
    ref = tk3.mega_gn_plain(*args, stats=stats)
    d = float(tse3.distance(_pose(out), _pose(ref)))
    print(f"K3 N={n}: pose distance {d:.3e}, passes {stats['passes']}")
    assert d <= TOL_POSE and bool(torch.isfinite(out).all())
    assert abs(float(out[12]) - float(ref[12])) <= 1e-4 * max(abs(float(ref[12])), 1e-6)
    assert torch.equal(tk3.mega_gn(*args), out)


def test_sparse_align_mega_every_point_masked(cuda_device):
    """No visible point on any level: the pose stays the init pose bit for
    bit and chi2 is 0, as in the plain version."""
    args = _k3_args(cuda_device, 200)
    args = args[:4] + (torch.zeros_like(args[4]),) + args[5:]
    out = tk3.mega_gn(*args)
    torch.testing.assert_close(out[:12], args[7], rtol=0, atol=0)
    assert float(out[12]) == 0.0
    torch.testing.assert_close(tk3.mega_gn_plain(*args), out, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 31, 200, 512, 1500])
def test_pose_ba_sizes(cuda_device, n):
    """K5 against its plain version from 1 to 1500 points (one point per
    thread up to 1024, then the loop over each thread's points), with
    outliers and masked rows, and two launches equal bit for bit."""
    args = _k5_args(cuda_device, n)
    out, inl = tk5.pose_ba_gn(*args)
    ref, inl_ref = tk5.pose_ba_gn_plain(*args)
    d = float(tse3.distance(_pose(out), _pose(ref)))
    agree = float(((inl > 0.5) == (inl_ref > 0.5)).float().mean())
    print(f"K5 N={n}: pose distance {d:.3e}, inlier sets agree {agree:.4f}")
    assert d <= TOL_POSE and agree >= 0.99 and bool(torch.isfinite(out).all())
    out2, inl2 = tk5.pose_ba_gn(*args)
    assert torch.equal(out2, out) and torch.equal(inl2, inl)


def test_pose_ba_kernels_refuse_a_float_mask(cuda_device):
    """K5, K8 and K11's stage 3 count each point's weight as 0 or 1, so
    their wrappers take the mask as bool on the card and refuse a float
    one (a fractional weight would make kernel and plain version differ)."""
    from ygz_slam_tpu_torch.ops import pyramid

    args = _k5_args(cuda_device, 31)
    half = args[2].float() * 0.5
    with pytest.raises(ValueError, match="msk"):
        tk5.pose_ba_gn(*args[:2], half, *args[3:])
    args8 = tuple(a[None].contiguous() for a in args[:4]) + (args[4],)
    tk8.pose_ba_batch_gn(*args8)
    with pytest.raises(ValueError, match="msk"):
        tk8.pose_ba_batch_gn(*args8[:2], half[None], *args8[3:])
    (cam, *_, frames, T_gt7), st = _sized(cuda_device, 31)
    T0 = TSE3.from_params7(T_gt7[0])
    a11 = tk11.track_args(pyramid.build_pyramid(frames[1], 3), st.ref_prep.levels,
                          st.ref_prep.p_ref, st.a2d_prep, st.pts_w, st.mask, T0.R, T0.t, cam,
                          False, 2)
    assert a11[20].dtype == torch.bool
    with pytest.raises(ValueError, match="a2_mask"):
        tk11.track_gn(*a11[:20], a11[20].float())


def test_pose_ba_batch_sixteen_sequences(cuda_device):
    """K8 at S=16 (each sequence its own noise, outliers and masked rows)
    against its plain version, and two launches equal bit for bit."""
    S = 16
    parts = [_k5_args(cuda_device, 200, seed=20 + s) for s in range(S)]
    cam = parts[0][4]
    args = tuple(torch.stack([p[k] for p in parts]).contiguous() for k in range(4)) + (cam,)
    out, inl = tk8.pose_ba_batch_gn(*args)
    ref, inl_ref = tk8.pose_ba_batch_gn_plain(*args)
    for s in range(S):
        assert float(tse3.distance(_pose(out[s]), _pose(ref[s]))) <= TOL_POSE
        assert float(((inl[s] > 0.5) == (inl_ref[s] > 0.5)).float().mean()) >= 0.99
    out2, inl2 = tk8.pose_ba_batch_gn(*args)
    assert torch.equal(out2, out) and torch.equal(inl2, inl)


def test_level_align_and_track_fused_repeat(cuda_device):
    """Two launches of K9 v1, K9 v2 and K11 on the same inputs give the
    same bits."""
    from ygz_slam_tpu_torch.ops import pyramid
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    cam, prep, cur = _level_case(cuda_device, [0.03, -0.02, 0.01, 0.002, -0.004, 0.002])
    R0, t0 = torch.eye(3, device=cuda_device), torch.zeros(3, device=cuda_device)
    for level in range(3):
        args = tk9.level_args(cur[level], prep.levels[level], prep.p_ref, R0, t0, cam, level,
                              False)
        assert torch.equal(tk9.level_gn(*args), tk9.level_gn(*args))
        assert torch.equal(tk9.level_gn_v2(*args), tk9.level_gn_v2(*args))
    (cam, *_, frames, T_gt7), st = _sized(cuda_device, 200)
    T0 = TSE3.from_params7(T_gt7[0])
    args = tk11.track_args(pyramid.build_pyramid(frames[1], 3), st.ref_prep.levels,
                           st.ref_prep.p_ref, st.a2d_prep, st.pts_w, st.mask, T0.R, T0.t, cam,
                           False, 2)
    a, b = tk11.track_gn(*args), tk11.track_gn(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_mono_system_repeats_on_the_card(cuda_device):
    """`test_mono_system_card_matches_cpu`'s run (40 frames of the
    monocular System, a mapping pass with local BA after each keyframe)
    twice on the card: equal bit for bit.  Local BA sums its blocks in a
    fixed order (no float atomics), and every kernel reduces in a fixed
    order."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, _ = mw.make_mono_workload(40, device=cuda_device)
    runs = []
    for _ in range(2):
        s = System(camera=cam, options=mw.mono_options(), device=cuda_device)
        st, T7, _ = mw.run_mono(s, frames)
        m = s.vo.server.state
        runs.append(([x.name for x in st], T7, m.kf_pose7.cpu(), m.pt_pos.cpu()))
    assert s.vo.stats["keyframes"] >= 2
    a, b = runs
    assert a[0] == b[0]
    assert a[1].tobytes() == b[1].tobytes(), \
        f"trajectories differ by up to {float(abs(a[1] - b[1]).max()):.3e}"
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


# -- K11 on K3's and K5's block, its align2d stage over a cluster ----------

TOL_BA_CHAIN = 1e-3     # K11's BA chi2 against the plain chain's (chip_smoke.py's):
                        # one align2d freeze flip moves one point of stage 3's input


def _k11_args(dev, n):
    from ygz_slam_tpu_torch.ops import pyramid

    (cam, *_, frames, T_gt7), st = _sized(dev, n)
    T0 = TSE3.from_params7(T_gt7[0])
    return tk11.track_args(pyramid.build_pyramid(frames[1], 3), st.ref_prep.levels,
                           st.ref_prep.p_ref, st.a2d_prep, st.pts_w, st.mask, T0.R, T0.t, cam,
                           False, 2)


@pytest.mark.parametrize("n", [1, 31, 200, 512, 1500])
def test_track_fused_sizes(cuda_device, n):
    """K11 against its plain version from 1 to 1500 map points: one CTA at
    N=1, two at 31 (16 and 15 points), the portable 8 from 113 on (25, 64
    and 188 points per CTA at 200, 512 and 1500, the last CTA's range cut
    at N).  Stage 1 equals K3 and stage 3 equals K5 on K11's own stage-2
    output, bit for bit; a second launch gives the same bits."""
    args = _k11_args(cuda_device, n)
    part = tk11.track_partition(n)
    res = tk11.track_gn(*args)
    out, xy, per = res
    stats = {}
    ref, xy_r, per_r = tk11.track_gn_plain(*args, stats=stats)
    d = float(tse3.distance(_pose(out), _pose(ref)))
    d_sp = float(tse3.distance(_pose(out[15:]), _pose(ref[15:])))
    chain = abs(float(out[13]) - float(ref[13])) / max(abs(float(ref[13])), 1e-6)
    conv, conv_r = per[1] > 0.5, per_r[1] > 0.5
    both = conv & conv_r
    dxy = torch.linalg.norm(xy[both] - xy_r[both], dim=1)
    # K3 on K11's stage-1 arguments; K5 on K11's own stage-2 output
    # (positions, accepted points) from K11's stage-1 pose.
    out3 = tk3.mega_gn(*args[:12])
    out5, inl5 = tk5.pose_ba_gn(args[19], xy, per[1] > 0.5, out[15:27].contiguous(), args[8])
    same1 = torch.equal(out[15:27], out3[:12]) and torch.equal(out[12], out3[12])
    same3 = (torch.equal(out[:12], out5[:12]) and torch.equal(out[13], out5[12])
             and torch.equal(per[2], inl5))
    print(f"K11 N={n} ({part}): pose distance {d:.3e}, after stage 1 {d_sp:.3e}, BA chi2 "
          f"against the plain chain {chain:.1e}, max |xy diff| "
          f"{float(dxy.max()) if dxy.numel() else 0.0:.3e} on {int(both.sum())} points, "
          f"stage 1 == K3 {same1}, stage 3 == K5 {same3}, passes {stats['passes']}")
    assert d <= TOL_POSE and d_sp <= TOL_POSE and bool(torch.isfinite(out).all())
    assert abs(float(out[12]) - float(ref[12])) <= 1e-4 * max(abs(float(ref[12])), 1e-6)
    assert chain <= TOL_BA_CHAIN
    assert float((conv == conv_r).float().mean()) >= 0.98
    assert not dxy.numel() or float(dxy.max()) <= 0.05
    assert float(((per[2] > 0.5) == (per_r[2] > 0.5)).float().mean()) >= 0.99
    assert float(out[14]) == float(per[2].sum())
    assert same1 and same3
    assert all(torch.equal(a, b) for a, b in zip(tk11.track_gn(*args), res))


def test_track_fused_stamps(cuda_device):
    """The stage marks come in order, and passing them changes no result."""
    args = _k11_args(cuda_device, 200)
    stamps = torch.zeros(10, dtype=torch.int64, device=cuda_device)
    res = tk11.track_gn(*args, stamps=stamps)
    assert all(torch.equal(a, b) for a, b in zip(res, tk11.track_gn(*args)))
    clk, ns = stamps[0::2].tolist(), stamps[1::2].tolist()
    assert clk == sorted(clk) and ns == sorted(ns) and clk[-1] > clk[0]


# -- K9 v1 over a thread-block cluster ---------------------------------------

def _k9_args(dev, n, level):
    """K9 v1's arguments at one level of frame 1 of the tracking workload
    with n landmarks, from frame 0's pose."""
    from ygz_slam_tpu_torch.ops import pyramid
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    (cam, *_, frames, T_gt7), st = _sized(dev, n)
    T0 = TSE3.from_params7(T_gt7[0])
    cur = pyramid.build_pyramid(frames[1], 3)
    return tk9.level_args(cur[level], st.ref_prep.levels[level], st.ref_prep.p_ref, T0.R, T0.t,
                          cam, level, False)


@pytest.mark.parametrize("n", [1, 31, 100, 256, 1500])
def test_level_align_v1_sizes(cuda_device, n):
    """K9 v1 against its plain version from 1 to 1500 points at levels 2
    and 0: one CTA at N=1 and 31, four at 100 (25 points each), the
    portable 8 at 256 (32 each) and 1500 (188 each, the last range cut at
    N); a second launch gives the same bits; with no usable point the pose
    does not move."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    part = kernels.cluster_partition(n, tk9.POINTS_PER_CTA)
    assert part.cluster == {1: 1, 31: 1, 100: 4, 256: 8, 1500: 8}[n]
    assert part.cluster * part.per_cta >= n > (part.cluster - 1) * part.per_cta
    for level in (2, 0):
        args = _k9_args(cuda_device, n, level)
        out = _k9_agree(args)
        assert torch.equal(tk9.level_gn(*args), out)
    zero = args[:4] + (torch.zeros_like(args[4]),) + args[5:]
    out = _k9_agree(zero)
    assert torch.equal(out[:12], zero[7]) and float(out[12]) == 0.0


def test_level_align_v1_does_not_spill(cuda_device):
    """ptxas's report on K9 v1 (the build's log): no spill stores or loads."""
    from ygz_slam_tpu_torch import _build

    res = {k: r for k, r in _build.kernel_resources("sparse_align_fused").items()
           if "level_align_v1_kernel" in k}
    print(f"K9 v1 ptxas: {res}")
    assert res and all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in res.values())


def test_level_align_v1_stamps(cuda_device):
    """The pass marks come in order inside the kernel's start and end, and
    passing them changes no result."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    args = _k9_args(cuda_device, 256, 0)
    stamps = torch.zeros(tk9.V1_STAMPS, dtype=torch.int64, device=cuda_device)
    out = tk9.level_gn(*args, stamps=stamps)
    assert torch.equal(out, tk9.level_gn(*args))
    s = stamps.tolist()
    marks = [m for m in s[4:] if m]
    assert len(marks) % 4 == 0 and marks == sorted(marks)
    assert s[0] < s[2] and s[1] <= marks[0] and marks[-1] <= s[3]


# -- K9 v2 (H0 and its factor in the kernel) and K4 (exit once frozen) ------

@pytest.mark.parametrize("n", [1, 31, 100, 256, 1500])
def test_level_align_v2_sizes(cuda_device, n):
    """K9 v2 against its plain version (pose, chi2 and H0) from 1 to 1500
    points at levels 2 and 0, over K9 v1's cluster partition (one to eight
    CTAs), a second launch giving the same bits; with no usable point H0
    is 0 and the pose does not move."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    part = kernels.cluster_partition(n, tk9.POINTS_PER_CTA)
    assert part.cluster == {1: 1, 31: 1, 100: 4, 256: 8, 1500: 8}[n]
    for level in (2, 0):
        args = _k9_args(cuda_device, n, level)
        out = _k9_agree(args, v2=True)
        assert torch.equal(tk9.level_gn_v2(*args), out)
    zero = args[:4] + (torch.zeros_like(args[4]),) + args[5:]
    out = _k9_agree(zero, v2=True)
    assert torch.equal(out[:12], zero[7]) and float(out[12]) == 0.0
    assert float(out[13:].abs().max()) == 0.0


def test_level_align_v2_rank_deficient_h0(cuda_device):
    """A rank-deficient H0 takes the identity factor in the kernel as in the
    plain version: every Jacobian row 0 but columns 4 and 5 of one usable
    point's 16 pixels, both 1, so H0 is 16 on that 2x2 block and the last
    pivot 16 - 4 * 4 = 0 in any order of operations.  With the identity
    factor the step is b itself."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    from ygz_slam_tpu_torch.ops.kernels import _gn6

    args = _k9_args(cuda_device, 200, 0)
    wins, refp, jac, p_ref, vis, ox, oy, pose0, cam, distorted, Hl, Wl, _ = args
    usable, _ = tk3.level_passes(wins, refp, jac, vis > 0.5, ox, oy, p_ref, cam, distorted, Hl,
                                 Wl, 1.0)
    i = int(torch.nonzero(usable(*_gn6.pose_from_tensor(pose0))[0])[0, 0])
    jac = torch.zeros_like(args[2])
    jac[i, :, 4:] = 1.0
    args = args[:2] + (jac,) + args[3:]
    out = _k9_agree(args, v2=True)
    H0 = tk9._sym6(out[13:])
    expect = torch.zeros(6, 6, device=cuda_device)
    expect[4:, 4:] = 16.0
    assert torch.equal(H0, expect)
    assert torch.equal(tk9.frozen_factor(H0), torch.eye(6, device=cuda_device)[
        tuple(torch.tril_indices(6, 6, device=cuda_device))])


def test_level_align_fused_v2_builds_h0_in_the_kernel(cuda_device):
    """On the card `level_align_fused_v2` launches K1 and K9 v2 and assembles
    and factors no H0 outside the kernel: the profiler records no
    `cholesky_ex` and no `einsum`, and one K9 v2 kernel."""
    from torch.profiler import ProfilerActivity, profile

    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    cam, prep, cur = _level_case(cuda_device, [0.03, -0.02, 0.01, 0.002, -0.004, 0.002])
    R0, t0 = torch.eye(3, device=cuda_device), torch.zeros(3, device=cuda_device)
    tk9.level_align_fused_v2(cur[1], prep.levels[1], prep.p_ref, R0, t0, cam, 1, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tk9.level_align_fused_v2(cur[1], prep.levels[1], prep.p_ref, R0, t0, cam, 1, False)
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()]
    print(f"level_align_fused_v2 on the card: {keys}")
    assert not any("cholesky" in k or "einsum" in k for k in keys)
    assert sum(e.count for e in prof.key_averages() if "level_align_v2_kernel" in e.key) == 1


def _k4_args(dev, n):
    """K4's arguments on frame 1 of the tracking workload with n landmarks,
    from their projections at frame 0's pose (inits off the image
    substituted, as `align2d` does), and the acceptance inputs."""
    from ygz_slam_tpu_torch.ops.align import substitute_inits

    (cam, *_, frames, T_gt7), st = _sized(dev, n)
    proj = cam.world_to_pixel(st.pts_w, TSE3.from_params7(T_gt7[0]), distorted=False)
    H, W = frames.shape[1:]
    xy0, inb0 = substitute_inits(proj, H, W)
    return tk4.a2d_args(frames[1], st.a2d_prep, xy0), proj, inb0, H, W


@pytest.mark.parametrize("n", [1, 3, 200, 512, 1600])
def test_align2d_sizes(cuda_device, n):
    """K4 against its plain version from 1 to 1600 points (a block of one
    warp per point, each leaving its loop once its point is frozen): the
    positions of points both accept within 1e-3 px on 98% of them and 0.05
    px on all, the acceptance masks agreeing on 98%, and a second launch
    giving the same bits."""
    from ygz_slam_tpu_torch.ops.align import accepted

    args, proj, inb0, H, W = _k4_args(cuda_device, n)
    out = tk4.a2d_gn(*args)
    stats = {}
    ref = tk4.a2d_gn_plain(*args, stats=stats)
    ma, mb = (accepted(o[:, :2], o[:, 3], proj, inb0, H, W) for o in (out, ref))
    both = ma & mb
    dxy = torch.linalg.norm(out[both, :2] - ref[both, :2], dim=1)
    print(f"K4 N={n}: {int(both.sum())} accepted by both, max |xy diff| "
          f"{float(dxy.max()) if dxy.numel() else 0.0:.3e}, masks agree "
          f"{float((ma == mb).float().mean()):.4f}, iterations before freezing "
          f"{torch.bincount(stats['iterations']).tolist()}")
    assert bool(torch.isfinite(out).all())
    assert float((ma == mb).float().mean()) >= 0.98
    assert not dxy.numel() or (float((dxy <= 1e-3).float().mean()) >= 0.98
                               and float(dxy.max()) <= 0.05)
    assert torch.equal(tk4.a2d_gn(*args), out)


def test_align2d_and_level_v2_do_not_spill(cuda_device):
    """ptxas's report on K4 and K9 v2 (the build's log): no spill stores or
    loads."""
    from ygz_slam_tpu_torch import _build

    res = {k: r for src, name in (("align2d_fused", "align2d_fused_kernel"),
                                  ("sparse_align_fused", "level_align_v2_kernel"))
           for k, r in _build.kernel_resources(src).items() if name in k}
    print(f"K4 and K9 v2 ptxas: {res}")
    assert len(res) >= 2
    assert all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in res.values())


# -- chunked tracking: the step as a CUDA graph ------------------------------

def _mono_vo_after_init(dev, n_frames=14):
    """A VisualOdometry on the card that has initialised on the monocular
    workload (640x480) and tracked up to frame 12, with the frames."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models.visual_odometry import Status, VisualOdometry

    cam, frames, _ = mw.make_mono_workload(n_frames, device=dev)
    vo = VisualOdometry(cam, mw.mono_options(), device=dev)
    for k in range(12):
        vo.add_frame(frames[k], float(k))
    assert vo.status is Status.GOOD
    return vo, frames


@pytest.mark.parametrize("variant", [3, 2, 1])
def test_chunk_graph_replay_equals_eager_step(cuda_device, variant, monkeypatch):
    """The chunk step on frames 12-13 twice from the same state: the first
    pass runs frame 12 eagerly (the warm-up) and captures the graph, the
    second replays it for both frames.  The records equal bit for bit, under
    each FUSED_VARIANT (K3; K9 v2 and v1, launched as thread-block
    clusters)."""
    from ygz_slam_tpu_torch.models import visual_odometry as tvo
    from ygz_slam_tpu_torch.ops import sparse_align

    monkeypatch.setattr(sparse_align, "FUSED_VARIANT", variant)
    vo, frames = _mono_vo_after_init(cuda_device)
    step = tvo.ChunkStep(vo, 2)
    recs = []
    for _ in range(2):
        step.load(vo, frames[12:14])
        if step.graph is None:
            step.run(0)                     # eager warm-up, then the capture
            eager0 = [r[0].clone() for r in _records(step)]
            step.run(1)
        else:
            step.run(0)
            step.run(1)
        torch.cuda.synchronize()
        recs.append([r.clone() for r in _records(step)])
    assert step.replays == 3 and step.captured
    for a, b in zip(recs[0], recs[1]):
        assert torch.equal(a, b)
    for a, b in zip(eager0, recs[1]):
        assert torch.equal(a, b[0])
    print(f"FUSED_VARIANT {variant}: replays equal the eager step bit for bit; the graph "
          f"launches {[w.__name__ for w in step.captured]}")


def _records(step):
    return (step.rec_R, step.rec_t, step.rec_vR, step.rec_vt, step.rec_found, step.rec_cand,
            step.rec_obs, step.rec_out)


def test_chunk_capture_makes_no_hidden_sync(cuda_device):
    """The warm-up frame, the capture and a replay of the chunk step under
    torch.cuda.set_sync_debug_mode("error"): no operation of the step waits
    for the device (a host-to-device copy from pageable memory or a
    device-to-host read would raise)."""
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    vo, frames = _mono_vo_after_init(cuda_device)
    step = tvo.ChunkStep(vo, 2)
    step.load(vo, frames[12:14])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.run(0)
        step.run(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step.replays == 1
    assert bool(torch.isfinite(step.rec_out).all())


def _mono_vo_with_seeds(dev):
    """A VisualOdometry on the card with the depth filter on, tracked on the
    monocular workload (640x480) until it holds seeds on a keyframe, with
    the frames and the index of the next frame."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models.visual_odometry import Status, VisualOdometry

    cam, frames, _ = mw.make_mono_workload(40, device=dev)
    vo = VisualOdometry(cam, mw.mono_options(use_depth_filter=True), device=dev)
    for k in range(36):
        vo.add_frame(frames[k], float(k))
        if vo.seeds is not None and vo.status is Status.GOOD and vo.frames_since_kf >= 1:
            return vo, frames, k + 1
    raise AssertionError("no seeds within 36 frames")


def test_seeded_chunk_graph_replay_equals_eager_step(cuda_device):
    """The chunk step with the depth filter's seed update (align1d and the
    Bayes update against the seed keyframe, a device index into the static
    keyframe images) on two frames twice from the same state: the first
    pass runs the first frame eagerly and captures the graph, the second
    replays it for both.  Every record, the seed table's included, equals
    bit for bit."""
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    vo, frames, k = _mono_vo_with_seeds(cuda_device)
    step = tvo.ChunkStep(vo, 2)
    assert step.seeds is not None
    recs = []
    for _ in range(2):
        step.load(vo, frames[k:k + 2])
        if step.graph is None:
            step.run(0)                     # eager warm-up, then the capture
            eager0 = [r[0].clone() for r in _records(step) + tuple(step.rec_seeds)]
            step.run(1)
        else:
            step.run(0)
            step.run(1)
        torch.cuda.synchronize()
        recs.append([r.clone() for r in _records(step) + tuple(step.rec_seeds)])
    assert step.replays == 3
    for a, b in zip(recs[0], recs[1]):
        assert torch.equal(a, b)
    for a, b in zip(eager0, recs[1]):
        assert torch.equal(a, b[0])
    moved = (step.rec_seeds.sigma2[1] != vo.seeds.sigma2) & vo.seeds.valid
    print(f"seeded step: replays equal the eager step bit for bit; seeds updated on frame "
          f"{k + 1}: {int(moved.sum())} of {int(vo.seeds.valid.sum())}")
    assert bool(moved.any())


def test_seeded_chunk_capture_makes_no_hidden_sync(cuda_device):
    """The seeded chunk step's warm-up frame, capture and a replay under
    torch.cuda.set_sync_debug_mode("error"): align1d's 2x2 solve and the
    seed update wait for nothing on the device."""
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    vo, frames, k = _mono_vo_with_seeds(cuda_device)
    step = tvo.ChunkStep(vo, 2)
    step.load(vo, frames[k:k + 2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.run(0)
        step.run(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step.replays == 1
    assert all(bool(torch.isfinite(t).all()) for t in (step.rec_out, step.rec_seeds.mu,
                                                       step.rec_seeds.sigma2))


def test_chunked_equals_per_frame_on_the_card(cuda_device):
    """40 frames of the monocular System (640x480) through
    `track_monocular_chunk(chunk=6)` and through `track_monocular`: equal
    statuses, keyframes, trajectory and map, bit for bit; the chunks ran as
    graph replays."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, _ = mw.make_mono_workload(40, device=cuda_device)
    runs = []
    for chunked in (True, False):
        s = System(camera=cam, options=mw.mono_options(), device=cuda_device)
        if chunked:
            res = s.track_monocular_chunk(frames, [float(k) for k in range(40)], chunk=6)
        else:
            res = [s.track_monocular(frames[k], float(k)) for k in range(40)]
        runs.append((s, res))
    (sc, rc), (sf, rf) = runs
    steps = list(sc.vo._chunk_steps.values())
    print(f"chunked: {dict(sc.vo.chunk_stats)}, replays {[st.replays for st in steps]}")
    assert [r.status for r in rc] == [r.status for r in rf]
    assert sc.vo.server.kf_used == sf.vo.server.kf_used
    assert sc.vo.stats == sf.vo.stats and sc.vo.stats["keyframes"] >= 2
    assert np.stack([p for _, p in sc.vo.trajectory]).tobytes() == \
        np.stack([p for _, p in sf.vo.trajectory]).tobytes()
    assert all(torch.equal(a, b) for a, b in zip(sc.vo.server.state, sf.vo.server.state))
    assert sum(st.replays for st in steps) > 0


def test_box_scene_card_matches_cpu(cuda_device):
    """BoxScene (2048-texel faces, vignette 0.25, gain and bias) rendered at
    640x480 on the card against the CPU render: the same mip stacks (numpy),
    pixels within 1e-3 on >= 99.9% and within 1e-2 everywhere (the
    tolerance of the rendered workloads against the JAX package's)."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.utils.synthetic import BoxScene, loop_trajectory

    cam = PinholeCamera.create(640.0, 640.0, 320.0, 240.0)
    card = BoxScene(cam, vignette=0.25, device=cuda_device)
    cpu = BoxScene(cam, vignette=0.25, device="cpu")
    assert torch.equal(card.texs.cpu(), cpu.texs)
    Ts = loop_trajectory(4000, radius=1.8, laps=2.2, face="out", device="cpu")
    for k in (0, 100, 250):
        gain, bias = 1.0 + 0.08 * np.sin(2 * np.pi * k / 400.0), 4.0 * np.sin(2 * np.pi * k / 270.0)
        a = card.render(TSE3(Ts[k].R.to(cuda_device), Ts[k].t.to(cuda_device)), (480, 640),
                        gain=gain, bias=bias).cpu()
        b = cpu.render(Ts[k], (480, 640), gain=gain, bias=bias)
        d = (a - b).abs()
        print(f"BoxScene frame {k}: {float((d <= 1e-3).float().mean()):.6f} of pixels within "
              f"1e-3, max {float(d.max()):.3e}")
        assert float((d <= 1e-3).float().mean()) >= 0.999 and float(d.max()) <= 1e-2
