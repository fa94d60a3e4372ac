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
windows at 8, 16 and 22 sequences (one launch, one, two), the batched K3
at 8, 16 and 22 sequences (one launch a step, each sequence's pose equal
to its own single-sequence launch) and the monocular K3 against its
recorded bits, K8 with one
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
bits); twelve frames of `run_synthetic_mono` on the card against the CPU; the chunk step of `VisualOdometry.add_frames` replayed as a CUDA
graph against the eager step under each FUSED_VARIANT (bit for bit), its
warm-up, capture and replay under torch.cuda.set_sync_debug_mode("error"),
both also for the step with the depth filter's seed update, forty frames
through `track_monocular_chunk` against `track_monocular` (bit for bit),
and BoxScene rendered on the card against the CPU; the Sim(3) pose graph
and the global Sim(3) closure against the CPU (and repeating bit for bit),
an archive loop detection recorded on the card against the CPU with the
card's P3P draws, and the default options with async mapping equal to the
synchronous run, per frame and chunked (graphs captured and replayed); the
RGBD and stereo starts, `match_stereo` and an RGBD map file (the DENSE
cloud, the vocabulary, archive rows) on the card against the CPU, the file
written on the card, loaded on the CPU and back bit for bit; one step of
SPARSE_ORB (`track_map_orb`, its matching) and of SEMI_DENSE_DIRECT
(`track_sd`) on a CPU run's map on the card against the CPU; the sharded
local BA in an NCCL world of one against a gloo world on the CPU.
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


@pytest.mark.parametrize("S,k6", [(8, 1), (16, 1), (22, 2)])
def test_batched_k3_one_launch(cuda_device, S, k6):
    """One `track_batch_step` of S sequences launches the batched K3 once
    (its `sequences` count up by S, no single-sequence K3) and K6 once up
    to 21 sequences, twice at 22 (`gather_windows_stacked`, counted as
    K6 in `gather_windows_grouped`), its windows equal to its plain
    version's;
    the sparse-align stage's poses, from init poses ~0.01 off the truth,
    equal S single-sequence K3 launches on the same windows, bit for
    bit."""
    from ygz_slam_tpu_torch.ops import pyramid
    from ygz_slam_tpu_torch.parallel import batch_tracking as bt

    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, T_gt7 = \
        bm.make_batch_workload(S, 2, cuda_device)
    state = bm.make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches)
    rng = np.random.default_rng(40 + S)
    T0 = TSE3.from_params7(T_gt7[0][None].repeat(S, 1)).compose(tse3.exp(torch.tensor(
        rng.uniform(-0.01, 0.01, (S, 6)), dtype=torch.float32, device=cuda_device)))
    T7 = T0.params7()
    n3, q3 = tk3.mega_gn_batch.launches, tk3.mega_gn_batch.sequences
    n1, n6 = tk3.mega_gn.launches, tk1.gather_windows_grouped.launches
    with kernels.record_launches() as rec:
        bm.track_batch_step(state, T7, frames[1])
    assert (tk3.mega_gn_batch.launches, tk3.mega_gn_batch.sequences) == (n3 + 1, q3 + S)
    assert tk3.mega_gn.launches == n1 and tk1.gather_windows_grouped.launches == n6 + k6
    assert [f.__name__ for f, _ in rec].count("gather_windows_stacked") == k6
    cur = pyramid.build_pyramid(frames[1], len(ref_pyrs))
    ref = state.batch_ref
    T = bt.batched_sparse_align(state.ref_pyrs, cur, cam, state.px, state.depth, state.mask, T0,
                                ref)
    ox, oy = bt.batch_window_origins(cur, ref.p_ref, T0, cam)
    n6 = tk1.gather_windows_grouped.launches
    wins = tk1.gather_windows_stacked(cur, ox, oy, tk3.CWIN)
    assert tk1.gather_windows_grouped.launches == n6 + k6
    assert torch.equal(wins.cpu(), tk1.gather_windows_stacked_plain(
        [lv.cpu() for lv in cur], ox.cpu(), oy.cpu(), tk3.CWIN))
    H0, W0 = frames.shape[-2:]
    for s in range(S):
        one = tk3.mega_gn(wins[s], ref.refp[s], ref.jac[s], ref.p_ref[s], ref.lvis[s], ox[s],
                          oy[s], torch.cat([T0.R[s].reshape(9), T0.t[s]]), cam, bt.DISTORTED,
                          H0, W0)
        assert torch.equal(T.R[s], one[:9].reshape(3, 3)) and torch.equal(T.t[s], one[9:12]), s
    d = tse3.distance(T, TSE3.from_params7(T_gt7[1][None].repeat(S, 1)))
    assert float(d.max()) < 5e-3, d


# The monocular route's K3 result on the card workload's frame 1 from frame
# 0's pose (`sparse_image_align`, 200 points): R, t and the finest level's
# chi2 as float32 bits, as the kernel gave them before its launch had a
# sequence axis (NVIDIA H100 80GB HBM3).
K3_MONO_BITS = (1065353094, -1150915330, -1161765905, 996531776, 1065352837, -1145289253,
                985890987, 1002183222, 1065352921, 1028050577, 1008681308, 1008623743,
                1116647791)


def test_sparse_align_mono_keeps_its_bits(card_workload):
    """The monocular route's K3, now the launch at S = 1 of the batched
    grid, gives the bits it gave as a one-CTA launch of its own."""
    from ygz_slam_tpu_torch.ops import pyramid, sparse_align

    (cam, *_, frames, T_gt7), st = card_workload["out"], card_workload["state"]
    n0 = tk3.mega_gn.launches
    a = sparse_align.sparse_image_align(st.ref_pyr, pyramid.build_pyramid(frames[1], 3), cam,
                                        st.px, st.depth, st.mask, TSE3.from_params7(T_gt7[0]),
                                        distorted=False, ref_prep=st.ref_prep)
    assert tk3.mega_gn.launches == n0 + 1
    got = torch.cat([a.T_cur_ref.R.reshape(9), a.T_cur_ref.t, a.chi2.reshape(1)])
    assert got.cpu().view(torch.int32).tolist() == list(K3_MONO_BITS)


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
    counters = (tk1.gather_windows, tk1.gather_windows_grouped, tk3.mega_gn, tk3.mega_gn_batch,
                tk1.gather_windows_multi, tk4.a2d_gn, tk8.pose_ba_batch_gn)
    before = [c.launches for c in counters]
    T7, inl = bm.track_batch_frames(state, frames, TSE3.identity((S,), device=cuda_device)
                                    .params7())
    assert [c.launches - b for c, b in zip(counters, before)] == [0, F, 0, F, F, F, F]
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



def test_run_synthetic_mono_card_matches_cpu(cuda_device, monkeypatch, tmp_path):
    """`python -m ygz_slam_tpu_torch.run_synthetic_mono`'s `main` over 12
    frames on the card against the CPU (each renders SyntheticDataset on
    its own device; the CPU run is handed the card run's RANSAC draws): the
    same statuses and window keyframes per frame, the GOOD frames' camera
    centres within TOL_SLICE up to the first keyframe after the init pair
    and within TOL_MAPPED after its mapping pass (the mono System's card
    tolerances above), both trajectory files written."""
    from ygz_slam_tpu_torch import run_synthetic_mono as rsm
    from ygz_slam_tpu_torch.solvers import initializer as tin

    draws = {}
    real_sample = tin.sample_hypotheses

    def card_sample(mask, n, gen):
        draws[gen.initial_seed()] = idx = real_sample(mask, n, gen)
        return idx

    def run(dev, sample):
        monkeypatch.setattr(tin, "sample_hypotheses", sample)
        return rsm.main(["--frames", "12", "--device", dev, "--out", str(tmp_path / dev)])

    card = run("cuda", card_sample)
    cpu = run("cpu", lambda mask, n, gen: draws[gen.initial_seed()].cpu())
    assert draws and [(r.status, r.keyframes) for r in card] == [(r.status, r.keyframes)
                                                                for r in cpu]
    good = [k for k, r in enumerate(card) if r.center is not None]
    first_kf = next(k for k, r in enumerate(card) if r.keyframes > 2)
    d = np.array([np.linalg.norm(card[k].center - cpu[k].center) for k in good])
    early = np.array([k <= first_kf for k in good])
    print(f"run_synthetic_mono over 12 frames, card against CPU: GOOD frames {good}, first "
          f"keyframe after the init pair at {first_kf}; camera centres {d.max():.3e} at most "
          f"({d[early].max():.3e} up to that keyframe); ATE card {rsm.ate(card):.5f}, CPU "
          f"{rsm.ate(cpu):.5f} m")
    assert len(good) >= 6 and d[early].max() <= TOL_SLICE and d.max() <= TOL_MAPPED
    for dev in ("cuda", "cpu"):
        assert (tmp_path / dev / "trajectory_tum.txt").stat().st_size > 0

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


@pytest.mark.parametrize("n_iter", [1, 3])
def test_sparse_align_mega_iteration_cap(cuda_device, n_iter):
    """K3 below its cap of 12 GN iterations per level (sharded_batch_align's
    n_iter, dryrun_multichip's 3) against its plain version at the same
    cap, on the 200-point frame; the cap stops at least one level, and two
    launches are equal bit for bit."""
    args = _k3_args(cuda_device, 200)[:12] + (n_iter,)
    out = tk3.mega_gn(*args)
    stats = {}
    ref = tk3.mega_gn_plain(*args, stats=stats)
    d = float(tse3.distance(_pose(out), _pose(ref)))
    print(f"K3 n_iter={n_iter}: pose distance {d:.3e}, passes {stats['passes']}")
    assert d <= TOL_POSE and bool(torch.isfinite(out).all())
    assert abs(float(out[12]) - float(ref[12])) <= 1e-4 * max(abs(float(ref[12])), 1e-6)
    assert max(stats["passes"]) == n_iter + 1
    assert torch.equal(tk3.mega_gn(*args), out)
    assert not torch.equal(out, tk3.mega_gn(*args[:12]))


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


def test_hamming_relocalization_shape(cuda_device):
    """K10 at relocalization's shape: 256 query rows against 10 candidates'
    256 features, gathered into one table (a fresh, aligned tensor) from a
    larger one, exactly the plain version; each candidate's column block
    equals its own launch."""
    q = _words(256, 21, cuda_device)
    table = _words(10 * 256 + 37, 22, cuda_device)
    rows = torch.randperm(table.shape[0], device=cuda_device)[:2560]
    cands = table[rows]
    d = tk10.distance_matrix(q, cands)
    assert torch.equal(d, tk10.distance_matrix_plain(q, cands))
    for c in (0, 4, 9):
        blk = cands[c * 256:(c + 1) * 256].contiguous()
        assert torch.equal(d[:, c * 256:(c + 1) * 256], tk10.distance_matrix(q, blk))


def test_pose_ba_batch_ten_candidates_equal_k5(cuda_device):
    """K8 at relocalization's shape (S = 10 candidates, N = 256) equals ten
    K5 launches on the same inputs bit for bit, a candidate seeded at a NaN
    pose and one fully masked beside sound ones included: one sequence
    cannot change another's."""
    rng = np.random.default_rng(12)
    S = 10
    per = [_k5_args(cuda_device, 256, seed=20 + s) for s in range(S)]
    pts, px, msk, pose0 = (torch.stack([a[i] for a in per]).contiguous() for i in range(4))
    cam = per[0][4]
    pose0[3] = float("nan")                     # a degenerate seed
    msk[6] = False                              # no usable point
    pose0[8, 9:12] += torch.tensor(rng.normal(0, 0.05, 3), dtype=torch.float32,
                                   device=cuda_device)
    out, inl = tk8.pose_ba_batch_gn(pts, px, msk, pose0, cam)
    for s in range(S):
        o5, i5 = tk5.pose_ba_gn(pts[s], px[s], msk[s], pose0[s], cam)
        assert torch.equal(out[s].view(torch.int32), o5.view(torch.int32)), s
        assert torch.equal(inl[s].view(torch.int32), i5.view(torch.int32)), s
    sound = [s for s in range(S) if s not in (3, 6)]
    assert bool(torch.isfinite(out[sound]).all())
    assert not bool((inl[6] > 0.5).any())


def _reloc_map_on(dev, n_pre=30):
    """A 240x320 monocular map with the vocabulary on, after the
    blackout-and-revisit run of models/reloc_workload.py."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import reloc_workload as rw
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, T_gt7 = mw.make_mono_workload(40, device=dev, shape=(240, 320), du=1 / 39)
    s = System(camera=cam, options=rw.reloc_options(), device=dev)
    out = rw.blackout_revisit(s, frames, n_pre=n_pre, n_after=8)
    return s, frames, out


def test_relocalize_card_matches_cpu(cuda_device):
    """One relocalization attempt on the card against the CPU on the same
    map, features and P3P triples (the card's draws): BoW scores within
    1e-6, the same candidates, matches and winner, inlier counts within the
    K8-against-plain agreement, the pose within 1e-4; one K10 and one K8
    launch."""
    from ygz_slam_tpu_torch.map import vocabulary as voc
    from ygz_slam_tpu_torch.models import frontend as tfe
    from ygz_slam_tpu_torch.models import relocalization as rl

    s, frames, out = _reloc_map_on(cuda_device)
    assert out["ok"], {k: v for k, v in out.items() if k not in ("T7", "statuses")}
    vo = s.vo
    q = vo._detect(tfe.preprocess(frames[out["revisit_fid"]], vo.o.n_levels))
    m = vo.server.state
    args = [q.desc, q.px, q.valid, vo.kf_bow, m.kf_valid, m.kf_pose7, m.feat_desc.reshape(-1, 8),
            vo.kf_nodes.reshape(-1), m.feat_point.reshape(-1), m.feat_valid.reshape(-1),
            m.pt_pos, m.pt_valid]
    kw = dict(min_inliers=20, top_c=10, use_pnp=True)
    st_card, st_cpu = {}, {}
    n10, n8 = tk10.distance_matrix.launches, tk8.pose_ba_batch_gn.launches
    r_card = rl.relocalize(vo.vocab, vo.cam, *args, feat_angle_flat=m.feat_angle.reshape(-1),
                           q_angle=q.angle, generator=torch.Generator(cuda_device).manual_seed(3),
                           stages=st_card, **kw)
    assert (tk10.distance_matrix.launches - n10, tk8.pose_ba_batch_gn.launches - n8) == (1, 1)
    a = st_card["attempt"]
    r_cpu = rl.relocalize(voc.from_state_dict(voc.state_dict(vo.vocab), device="cpu"), vo.cam,
                          *(t.cpu() for t in args), feat_angle_flat=m.feat_angle.reshape(-1).cpu(),
                          q_angle=q.angle.cpu(), draws=a.draws.cpu(), stages=st_cpu, **kw)
    b = st_cpu["attempt"]
    d_pose = float(tse3.distance(TSE3(r_card.T_cw.R.cpu(), r_card.T_cw.t.cpu()), r_cpu.T_cw))
    print(f"scores within {float((a.scores.cpu() - b.scores).abs().max()):.2e}; inliers "
          f"{a.n_inl.tolist()} / {b.n_inl.tolist()}; pose distance {d_pose:.2e}")
    assert float((a.scores.cpu() - b.scores).abs().max()) <= 1e-6
    assert torch.equal(a.cand.cpu(), b.cand) and torch.equal(a.match_idx.cpu(), b.match_idx)
    assert int((a.n_inl.cpu() - b.n_inl).abs().max()) <= 0.01 * q.desc.shape[0]
    assert bool(r_card.success) and bool(r_cpu.success)
    assert int(r_card.n_inliers) == int(r_cpu.n_inliers)
    assert int(r_card.kf_slot) == int(r_cpu.kf_slot) and d_pose <= TOL_POSE


def test_chunked_equals_per_frame_across_a_relocalization_on_the_card(cuda_device):
    """The blackout-and-revisit frames through `track_monocular_chunk`
    (chunk=4) and through `track_monocular` on the card: equal statuses,
    trajectory, map, BoW rows and stats bit for bit, one relocalization in
    each, graph replays on both sides of it."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import reloc_workload as rw
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, _ = mw.make_mono_workload(40, device=cuda_device, shape=(240, 320), du=1 / 39)
    seq = torch.cat([frames[:30], rw.noise_frames(4, (240, 320), device=cuda_device),
                     frames[:9]])
    ts = [float(k) for k in range(seq.shape[0])]
    sc = System(camera=cam, options=rw.reloc_options(), device=cuda_device)
    rc = sc.track_monocular_chunk(seq, ts, chunk=4)
    sf = System(camera=cam, options=rw.reloc_options(), device=cuda_device)
    rf = [sf.track_monocular(seq[k], ts[k]) for k in range(seq.shape[0])]
    assert [r.status for r in rc] == [r.status for r in rf]
    assert sf.vo.stats["relocalizations"] == 1 and sc.vo.stats == sf.vo.stats
    assert np.stack([p for _, p in sc.vo.trajectory]).tobytes() == \
        np.stack([p for _, p in sf.vo.trajectory]).tobytes()
    assert all(torch.equal(a, b) for a, b in zip(sc.vo.server.state, sf.vo.server.state))
    assert torch.equal(sc.vo.kf_bow, sf.vo.kf_bow) and torch.equal(sc.vo.kf_nodes, sf.vo.kf_nodes)
    assert sum(st.replays for st in sc.vo._chunk_steps.values()) > 0


@pytest.mark.parametrize("A", [16, 128, 512])
def test_hamming_archive_shapes(cuda_device, A):
    """K10 at the archive scoring's shape (256 query rows against A
    archived keyframes' 256 features, [256, A * 256]) exactly the plain
    version, and `archive_match_scores` on the card equal to the CPU's with
    one K10 launch per ARCHIVE_CHUNK rows."""
    q = _words(256, 31, cuda_device)
    arc = _words(A * 256, 32 + A, cuda_device)
    d = tk10.distance_matrix(q, arc)
    assert torch.equal(d, tk10.distance_matrix_plain(q, arc))
    g = torch.Generator(device="cpu").manual_seed(A)
    qv = (torch.rand(256, generator=g) < 0.9).to(cuda_device)
    av = (torch.rand((A, 256), generator=g) < 0.8).to(cuda_device)
    arc3 = arc.reshape(A, 256, 8).clone()
    arc3[:, :40] = q[None, :40]                    # planted matches
    n10 = tk10.distance_matrix.launches
    s_card = tham.archive_match_scores(q, qv, arc3, av)
    assert tk10.distance_matrix.launches - n10 == -(-A // tham.ARCHIVE_CHUNK)
    s_cpu = tham.archive_match_scores(q.cpu(), qv.cpu(), arc3.cpu(), av.cpu())
    assert torch.equal(s_card.cpu(), s_cpu) and int(s_cpu.max()) > 0


def _archive_vo_on(dev, n=None):
    """The port's VisualOdometry after models/archive_workload.py's sweep
    (240x320) on `dev`."""
    from ygz_slam_tpu_torch.models import archive_workload as aw
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    cam, frames, _ = aw.sweep_frames((240, 320), device=dev)
    vo = tvo.VisualOdometry(cam, aw.archive_options(), device=dev)
    for k in range(n or frames.shape[0]):
        vo.add_frame(frames[k], float(k))
    return vo, frames


def test_relocalize_archive_card_matches_cpu(cuda_device):
    """One archive relocalization on the card against the CPU on the same
    archive, features and P3P triples (the card's draws): retrieval scores
    equal, the same candidates, matches and winner, the pose within 1e-4;
    one K10 launch to score the archive, one for the candidates, one K8."""
    from ygz_slam_tpu_torch.map import vocabulary as voc
    from ygz_slam_tpu_torch.models import frontend as tfe
    from ygz_slam_tpu_torch.models import relocalization as rl
    from ygz_slam_tpu_torch.map.archive import ArchiveView

    vo, frames = _archive_vo_on(cuda_device)
    fid = int(vo.archive.frame_ids().min())
    q = vo._detect(tfe.preprocess(frames[fid], vo.o.n_levels))
    arc = vo.archive.device_view()
    kw = dict(min_inliers=vo.o.reloc_min_inliers, top_c=10, use_pnp=True)
    st_card, st_cpu = {}, {}
    n10, n8 = tk10.distance_matrix.launches, tk8.pose_ba_batch_gn.launches
    r_card = rl.relocalize_archive(vo.vocab, vo.cam, q.desc, q.px, q.valid, arc, q_angle=q.angle,
                                   generator=torch.Generator(cuda_device).manual_seed(4),
                                   stages=st_card, **kw)
    assert (tk10.distance_matrix.launches - n10, tk8.pose_ba_batch_gn.launches - n8) == (2, 1)
    a = st_card["attempt"]
    r_cpu = rl.relocalize_archive(voc.from_state_dict(voc.state_dict(vo.vocab), device="cpu"),
                                  vo.cam, q.desc.cpu(), q.px.cpu(), q.valid.cpu(),
                                  ArchiveView(*(t.cpu() for t in arc)), q_angle=q.angle.cpu(),
                                  draws=a.draws.cpu(), stages=st_cpu, **kw)
    b = st_cpu["attempt"]
    d_pose = float(tse3.distance(TSE3(r_card.T_cw.R.cpu(), r_card.T_cw.t.cpu()), r_cpu.T_cw))
    print(f"archive {vo.archive.count} rows: scores {a.scores.cpu()[:vo.archive.count].tolist()}; "
          f"inliers {a.n_inl.tolist()} / {b.n_inl.tolist()}; pose distance {d_pose:.2e}")
    assert torch.equal(a.scores.cpu(), b.scores)
    assert torch.equal(a.cand.cpu(), b.cand) and torch.equal(a.match_idx.cpu(), b.match_idx)
    assert int((a.n_inl.cpu() - b.n_inl).abs().max()) <= 0.01 * q.desc.shape[0]
    assert bool(r_card.success) and bool(r_cpu.success)
    assert int(r_card.n_inliers) == int(r_cpu.n_inliers)
    assert int(r_card.kf_slot) == int(r_cpu.kf_slot) and d_pose <= TOL_POSE


def _plant_loop(vo):
    """The VO's map with a loop planted: the landmarks of the window
    keyframe whose BoW row scores best against the newest keyframe's copied
    into free rows and its features linked to the copies, so it shares no
    landmark with the newest keyframe but sees the same place.  Returns
    (MapState, newest slot, planted slot)."""
    from ygz_slam_tpu_torch.map import vocabulary as voc

    m = type(vo.server.state)(*(t.clone() for t in vo.server.state))
    used = vo.server.kf_used
    new = used[-1]
    sc = voc.score_l1(vo.kf_bow[new][None], vo.kf_bow).cpu()
    slot = max((s for s in used if s != new), key=lambda s: float(sc[s]))
    F = m.feat_point.shape[1]
    fp = m.feat_point[slot].cpu().numpy()
    linked = np.where(fp >= 0)[0]
    free = np.where(~m.pt_valid.cpu().numpy())[0][:len(linked)]
    src = torch.as_tensor(fp[linked[:len(free)]], dtype=torch.long, device=m.pt_pos.device)
    dst = torch.as_tensor(free, dtype=torch.long, device=m.pt_pos.device)
    fields = {}
    for name in ("pt_pos", "pt_desc", "pt_valid", "pt_obs", "pt_visible", "pt_found",
                 "pt_first_kf", "pt_ref_feat"):
        t = getattr(m, name).clone()
        t[dst] = t[src]
        fields[name] = t
    fields["pt_ref_feat"][dst] = (slot * F + torch.as_tensor(linked[:len(free)],
                                                             device=dst.device)).to(torch.int32)
    feat_point = m.feat_point.clone()
    feat_point[slot, torch.as_tensor(linked[:len(free)], device=dst.device)] = dst.to(torch.int32)
    return m._replace(feat_point=feat_point, **fields), new, slot


def test_mapping_pass_with_the_loop_block_repeats_on_the_card(cuda_device):
    """The mapping pass with the loop block on a planted loop, twice from
    the same state on the card: the loop found, the same bits (the pose
    graph's blocks are summed without atomics), one more K10 and one more K5
    launch than the pass without it; and the loop block alone (detect_loop,
    close_loop) on the card against the CPU: the same candidate and
    inliers, the corrected poses within 1e-4."""
    from ygz_slam_tpu_torch.map import vocabulary as voc
    from ygz_slam_tpu_torch.map.memory import refresh_covisibility
    from ygz_slam_tpu_torch.models import relocalization as rl
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    s, frames, out = _reloc_map_on(cuda_device)
    vo = s.vo
    m, new, slot = _plant_loop(vo)
    fixed = torch.zeros(vo.o.map_K, dtype=torch.bool, device=cuda_device)
    fixed[vo.server.kf_used[:2]] = True
    loop = (vo.vocab, new, vo.kf_bow, vo.kf_nodes)
    n10, n5 = tk10.distance_matrix.launches, tk5.pose_ba_gn.launches
    a = tvo.mapping_pass(vo.cam, vo.o, m, fixed, loop=loop)
    d10, d5 = tk10.distance_matrix.launches - n10, tk5.pose_ba_gn.launches - n5
    b = tvo.mapping_pass(vo.cam, vo.o, m, fixed, loop=loop)
    n10, n5 = tk10.distance_matrix.launches, tk5.pose_ba_gn.launches
    tvo.mapping_pass(vo.cam, vo.o, m, fixed)
    assert (d10 - (tk10.distance_matrix.launches - n10), d5 - (tk5.pose_ba_gn.launches - n5)) \
        == (1, 1)
    assert bool(a[2]) and bool(b[2])
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and torch.equal(a[1], b[1])

    def loop_block(mm, vocab, kf_bow, kf_nodes):
        mm = refresh_covisibility(mm)
        lp = rl.detect_loop(vocab, vo.cam, new, kf_bow, mm.kf_valid, mm.kf_pose7, mm.cov_weight,
                            mm.feat_desc.reshape(-1, 8), kf_nodes.reshape(-1),
                            mm.feat_px.reshape(-1, 2), mm.feat_point.reshape(-1),
                            mm.feat_valid.reshape(-1), mm.pt_pos, mm.pt_valid,
                            feat_angle_flat=mm.feat_angle.reshape(-1))
        pose7, _, _ = rl.close_loop(mm.kf_pose7, mm.kf_valid, mm.cov_weight, mm.pt_pos,
                                    mm.pt_valid, mm.pt_first_kf, new, lp,
                                    feat_point=mm.feat_point, feat_valid=mm.feat_valid)
        return lp, pose7

    lc, pc = loop_block(m, vo.vocab, vo.kf_bow, vo.kf_nodes)
    lh, ph = loop_block(type(m)(*(t.cpu() for t in m)),
                        voc.from_state_dict(voc.state_dict(vo.vocab), device="cpu"),
                        vo.kf_bow.cpu(), vo.kf_nodes.cpu())
    used = vo.server.kf_used
    d = float(tse3.distance(TSE3.from_params7(pc[used].cpu()),
                            TSE3.from_params7(ph[used])).max())
    print(f"planted slot {slot}, new {new}: loop block card against CPU {d:.2e}; inliers "
          f"{int(lc.n_inl)} / {int(lh.n_inl)}")
    assert bool(lc.found) and bool(lh.found) and int(lc.loop_kf) == int(lh.loop_kf) == slot
    assert int(lc.n_inl) == int(lh.n_inl) and d < TOL_POSE


def test_chunked_equals_per_frame_across_an_archive_relocalization_on_the_card(cuda_device):
    """models/archive_workload.py's kidnapped sweep through
    `track_monocular_chunk` (chunk=4) and through `track_monocular` on the
    card: equal statuses, trajectory, map, archive and stats bit for bit,
    one archive relocalization in each, graph replays on both sides of it."""
    from ygz_slam_tpu_torch.models import archive_workload as aw
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, _ = aw.sweep_frames((240, 320), device=cuda_device)
    sf = System(camera=cam, options=aw.archive_options(), device=cuda_device)
    out = aw.kidnapped_sweep(sf.vo, frames, feed=sf.track_monocular)
    seq = aw.fed_frames(frames, out["fed"])
    ts = [float(k) for k in range(seq.shape[0])]
    sc = System(camera=cam, options=aw.archive_options(), device=cuda_device)
    rc = sc.track_monocular_chunk(seq, ts, chunk=4)
    assert [r.status for r in rc] == out["statuses"] and out["ok"]
    assert sf.vo.stats["relocs_archive"] == 1 and sc.vo.stats == sf.vo.stats
    assert np.stack([p for _, p in sc.vo.trajectory]).tobytes() == \
        np.stack([p for _, p in sf.vo.trajectory]).tobytes()
    assert all(torch.equal(a, b) for a, b in zip(sc.vo.server.state, sf.vo.server.state))
    assert all(torch.equal(a, b) for a, b in zip(sc.vo.archive.device_view(),
                                                 sf.vo.archive.device_view()))
    assert sum(st.replays for st in sc.vo._chunk_steps.values()) > 0


def _drifted_loop(K=24, drift=1.02):
    """tests/test_sim3.py's scale-drifted circle: (gt params7, drifted
    params7, edges i, j, params8 with the loop edge at the measured scale)."""
    from ygz_slam_tpu_torch.utils import np_se3

    c = np.asarray([[2 * np.cos(2 * np.pi * k / K), 2 * np.sin(2 * np.pi * k / K), 0.0]
                    for k in range(K)], np.float32)
    gt7 = np.stack([np.concatenate([[1, 0, 0, 0], -x]) for x in c]).astype(np.float32)
    est7 = [gt7[0]]
    for k in range(1, K):
        T_rel = np_se3.relative7(gt7[k], gt7[k - 1]).copy()
        T_rel[4:7] *= drift ** k
        est7.append(np_se3.compose7(T_rel, est7[-1]))
    est7 = np.asarray(est7, np.float32)
    T7 = [np_se3.relative7(est7[k + 1], est7[k]) for k in range(K - 1)]
    T7.append(np_se3.relative7(gt7[0], gt7[K - 1]))
    e8 = np.asarray([np.concatenate([T7[k], [1.0]]) for k in range(K - 1)]
                    + [np.concatenate([T7[K - 1], [drift ** -(K - 1)]])], np.float32)
    return gt7, est7, np.arange(K, dtype=np.int32), np.roll(np.arange(K, dtype=np.int32), -1), e8


def test_optimize_sim3_card_matches_cpu(cuda_device):
    """The Sim(3) pose graph on the drifted loop and the global Sim(3)
    closure (16 keyframes archived, 8 active) on the card against the CPU:
    poses and scales within TOL_POSE, and a second solve on the card equal
    bit for bit (the blocks are summed without atomics)."""
    from ygz_slam_tpu_torch.geometry.sim3 import Sim3
    from ygz_slam_tpu_torch.models import relocalization as rl
    from ygz_slam_tpu_torch.solvers import pose_graph as pg
    from ygz_slam_tpu_torch.utils import np_se3

    gt7, est7, ii, jj, e8 = _drifted_loop()
    K = est7.shape[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True

    def solve(dev):
        edges = pg.Sim3Edges(torch.tensor(ii, device=dev), torch.tensor(jj, device=dev),
                             torch.tensor(e8, device=dev), torch.ones(K, device=dev),
                             torch.ones(K, dtype=torch.bool, device=dev))
        p, chi2 = pg.optimize_sim3(Sim3.from_se3(TSE3.from_params7(torch.tensor(est7, device=dev))),
                                   edges, torch.tensor(fixed, device=dev), n_iter=30)
        return p.params8().cpu(), float(chi2)

    (p_card, c_card), (p_card2, _), (p_cpu, c_cpu) = solve(cuda_device), solve(cuda_device), \
        solve("cpu")
    d = float((p_card - p_cpu).abs().max())
    A = 16
    args = (est7[:A], np.arange(A, dtype=np.int32), est7[A:], np.arange(A, K, dtype=np.int32),
            np.zeros((K - A, K - A), np.int32), 0, K - A - 1,
            np_se3.relative7(gt7[K - 1], gt7[0]).astype(np.float32))
    g_card = rl.close_loop_global_sim3(*args, loop_scale=1.02 ** (K - 1), n_iter=30,
                                       device=cuda_device)
    g_cpu = rl.close_loop_global_sim3(*args, loop_scale=1.02 ** (K - 1), n_iter=30, device="cpu")
    dg = max(float(np.abs(a - b).max()) for a, b in zip(g_card[:4], g_cpu[:4]))
    print(f"optimize_sim3 card against CPU {d:.2e}, chi2 {c_card:.4e} / {c_cpu:.4e}; "
          f"close_loop_global_sim3 {dg:.2e}")
    assert torch.equal(p_card, p_card2)
    assert d < TOL_POSE and dg < TOL_POSE
    assert abs(c_card - c_cpu) <= 1e-3 * max(c_cpu, 1e-9)


def _archive_loop_call(device):
    """The port's out-and-back sweep (models/archive_workload.py, 240x320,
    mapping synchronous) on `device` up to the first archive detection that
    finds a loop: that call's arguments, cloned, and the vocabulary."""
    from ygz_slam_tpu_torch.models import archive_workload as aw
    from ygz_slam_tpu_torch.models import relocalization as rl
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    cam, frames, _ = aw.out_and_back_frames((240, 320), device=device)
    vo = tvo.VisualOdometry(cam, aw.loop_options(async_mapping=False), device=device)
    found = []
    real = rl.detect_loop_archive

    def recording(*a, **kw):
        out = real(*a, **kw)
        if not found and bool(out.found):
            clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
            arc = type(a[12])(*(t.clone() for t in a[12]))
            found.append(([clone(x) for x in a[:12]] + [arc], dict(kw)))
        return out

    rl.detect_loop_archive = recording
    try:
        for k in range(frames.shape[0]):
            vo.add_frame(frames[k], float(k))
            if found:
                break
    finally:
        rl.detect_loop_archive = real
    assert found, "no archive loop found in the sweep"
    return found[0], vo.vocab


def test_detect_loop_archive_card_matches_cpu(cuda_device):
    """An archive loop detection recorded on the card, replayed on the card
    and on the CPU with the card's P3P draws: retrieval scores, candidates,
    matches, winner and inliers equal, T_loop7 within TOL_POSE, the scale
    within 1e-5 relative."""
    from ygz_slam_tpu_torch.map import vocabulary as voc
    from ygz_slam_tpu_torch.models import relocalization as rl

    (args, kw), vocab = _archive_loop_call(cuda_device)
    sc, sh = {}, {}
    lc = rl.detect_loop_archive(*args, **kw, stages=sc)
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    a_cpu = [voc.from_state_dict(voc.state_dict(vocab), device="cpu")] + [cpu(x) for x in args[1:12]]
    a_cpu.append(type(args[12])(*(t.cpu() for t in args[12])))
    lh = rl.detect_loop_archive(*a_cpu, **{k: cpu(v) for k, v in kw.items()},
                                draws=sc["attempt"].draws.cpu(), stages=sh)
    a, b = sc["attempt"], sh["attempt"]
    d = float(tse3.distance(TSE3.from_params7(lc.T_loop7.cpu()), TSE3.from_params7(lh.T_loop7)))
    ds = abs(float(lc.scale) - float(lh.scale)) / float(lh.scale)
    print(f"archive loop: row {int(lc.loop_kf)} / {int(lh.loop_kf)}, inliers {a.n_inl.tolist()} / "
          f"{b.n_inl.tolist()}, T_loop7 {d:.2e}, scale {float(lc.scale):.6f} / {float(lh.scale):.6f}")
    assert torch.equal(a.scores.cpu(), b.scores) and torch.equal(a.cand.cpu(), b.cand)
    assert torch.equal(a.match_idx.cpu(), b.match_idx)
    assert bool(lc.found) and bool(lh.found) and int(lc.loop_kf) == int(lh.loop_kf)
    assert int(lc.n_inl) == int(lh.n_inl) and d < TOL_POSE and ds < 1e-5


def _default_runs(device, async_mapping: bool, chunk=None):
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import visual_odometry as tvo
    from ygz_slam_tpu_torch.system.system import System

    cam, frames, _ = mw.make_mono_workload(40, device=device, shape=(240, 320), du=1 / 39)
    s = System(camera=cam, options=tvo.VOOptions(**mw.VO_OPTS, async_mapping=async_mapping),
               device=device)
    if chunk:
        s.track_monocular_chunk(frames, [float(k) for k in range(40)], chunk=chunk)
    else:
        for k in range(40):
            s.track_monocular(frames[k], float(k))
    s.shutdown()
    return s


def _same_run(a, b) -> bool:
    pa, pb = a.vo.trajectory_poses(), b.vo.trajectory_poses()
    return (np.stack([p for _, p in pa]).tobytes() == np.stack([p for _, p in pb]).tobytes()
            and all(torch.equal(x, y) for x, y in zip(a.vo.server.state, b.vo.server.state))
            and a.vo.stats == b.vo.stats)


def test_async_mapping_equals_sync_on_the_card(cuda_device):
    """tests/test_async_mapping.py's run with the default options on the
    card: the mapping pass on the worker thread (launching on the caller's
    stream) gives the synchronous run's trajectory, map and stats bit for
    bit."""
    sa, ss = _default_runs(cuda_device, True), _default_runs(cuda_device, False)
    print(f"keyframes {sa.vo.stats['keyframes']}, stats {dict(sa.vo.stats)}")
    assert sa.vo.stats["keyframes"] >= 3 and _same_run(sa, ss)


def test_chunked_async_mapping_captures_and_replays_on_the_card(cuda_device):
    """The same run through `track_monocular_chunk` (chunk=6) with async
    mapping: every chunk starts after the join, its graph is captured and
    replayed without error, and the run equals the per-frame one bit for
    bit."""
    sc = _default_runs(cuda_device, True, chunk=6)
    sf = _default_runs(cuda_device, True)
    replays = sum(st.replays for st in sc.vo._chunk_steps.values())
    print(f"chunks {dict(sc.vo.chunk_stats)}, replays {replays}")
    assert replays > 0 and _same_run(sc, sf)


# -- depth sensors and the map file (slice 11) ---------------------------------

def _sensor_start(device, depth: bool):
    """Frame 0 of tests/test_system.py's RGBD sequence (240x320) through a
    VisualOdometry on `device` with its depth image, or, with depth=False,
    tests/test_stereo.py's pair (seed 12) with the right image: (VO,
    feature pixels, feature depths, landmark positions of keyframe 0)."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.models import visual_odometry as tvo
    from ygz_slam_tpu_torch.utils.datasets import SyntheticDataset
    from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    if depth:
        fd = next(iter(SyntheticDataset(cam, n_frames=16, shape=(240, 320), with_depth=True,
                                        motion_scale=0.5, device="cpu")))
        kw = dict(img=fd.gray, depth=fd.depth)
    else:
        scene = PlaneScene(cam, plane_z=3.0, seed=12, device="cpu")
        kw = dict(img=scene.render(TSE3.identity(device="cpu"), (240, 320)),
                  right=scene.render(TSE3(torch.eye(3), torch.tensor([-0.1, 0.0, 0.0])),
                                     (240, 320)))
    vo = tvo.VisualOdometry(cam, tvo.VOOptions(use_vocabulary=False, archive_map=False,
                                               async_mapping=False), device=device)
    r = vo.add_frame(timestamp=0.0, **{k: v.to(device) for k, v in kw.items()})
    assert r.status is tvo.Status.GOOD
    m = vo.server.state
    fp, fv = m.feat_point[0].cpu(), m.feat_valid[0].cpu()
    pos = torch.where((fp >= 0)[:, None], m.pt_pos.cpu()[fp.clamp(min=0).long()], 0.0)
    return vo, m.feat_px[0].cpu()[fv], m.feat_depth[0].cpu()[fv], pos[fv]


@pytest.mark.parametrize("depth", [True, False], ids=["rgbd", "stereo"])
def test_sensor_start_card_matches_cpu(cuda_device, depth):
    """The depth-sensor start on the card against the CPU: >= 95% of the
    features at the same pixel (Shi-Tomasi's float32 noise), and where they
    coincide the same sensor decision on >= 98% and depths and landmarks
    within 1e-4 m."""
    _, px_c, d_c, p_c = _sensor_start(cuda_device, depth)
    _, px_h, d_h, p_h = _sensor_start("cpu", depth)
    dist = (px_c[:, None] - px_h[None]).abs().amax(-1)
    hit = dist.amin(1) <= 1e-3
    j = dist.argmin(1)[hit]
    same = ((d_c[hit] > 0) == (d_h[j] > 0)).float().mean().item()
    both = (d_c[hit] > 0) & (d_h[j] > 0)
    dd = (d_c[hit][both] - d_h[j][both]).abs().max().item()
    dp = (p_c[hit][both] - p_h[j][both]).abs().max().item()
    print(f"{'RGBD' if depth else 'STEREO'} start: {hit.float().mean().item():.4f} of "
          f"{len(px_c)} features coincide, decisions equal on {same:.4f}, depth within {dd:.3e}, "
          f"landmarks within {dp:.3e} m")
    assert hit.float().mean().item() >= 0.95 and same >= 0.98 and dd <= 1e-4 and dp <= 1e-4


def test_match_stereo_card_matches_cpu(cuda_device):
    """`match_stereo` on tests/test_stereo.py's pair (seed 11) and its
    corners, the same inputs on both devices: >= 98% equal ok flags, depth
    within 1e-4 relative where both accept."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.ops import fast, stereo
    from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    scene = PlaneScene(cam, plane_z=3.0, seed=11, device="cpu")
    left = scene.render(TSE3.identity(device="cpu"), (240, 320))
    right = scene.render(TSE3(torch.eye(3), torch.tensor([-0.1, 0.0, 0.0])), (240, 320))
    c = fast.detect(left, 20.0, cell=16, max_corners=120)
    out = {dev: stereo.match_stereo(left.to(dev), right.to(dev), c.xy.to(dev), c.mask.to(dev),
                                    cam.fx, 0.1, min_depth=0.5, max_depth=10.0)
           for dev in (cuda_device, "cpu")}
    g, h = out[cuda_device], out["cpu"]
    agree = (g.ok.cpu() == h.ok).float().mean().item()
    both = g.ok.cpu() & h.ok
    rel = ((g.depth.cpu() - h.depth).abs() / h.depth)[both]
    print(f"match_stereo card against CPU: ok agree {agree:.4f}, {int(both.sum())} in both, "
          f"depth within {rel.max().item():.3e} relative")
    assert agree >= 0.98 and int(both.sum()) > 60 and (rel <= 1e-4).float().mean().item() >= 0.98


def test_map_file_card_to_cpu_bit_for_bit(cuda_device, tmp_path):
    """An RGBD map with the DENSE cloud, the vocabulary and archive rows,
    written on the card, loads on the CPU and back on the card; each writes
    it again: the three files equal array by array, bit for bit, and the
    loaded state lies on the System's device."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.models import visual_odometry as tvo
    from ygz_slam_tpu_torch.system.system import Sensor, System
    from ygz_slam_tpu_torch.utils.datasets import SyntheticDataset

    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    opts = tvo.VOOptions(kf_min_frames=3, kf_max_trans=0.05, map_K=4, map_type=tvo.MapType.DENSE)
    s = System(camera=cam, sensor=Sensor.RGBD, options=opts, device=cuda_device)
    for fd in SyntheticDataset(cam, n_frames=16, shape=(240, 320), with_depth=True,
                               motion_scale=0.5, device=cuda_device):
        s.track_rgbd(fd.gray, fd.depth, fd.timestamp)
    paths = [str(tmp_path / f"m{i}.npz") for i in range(3)]
    s.save_map(paths[0])
    for i, dev in ((1, "cpu"), (2, cuda_device)):
        t = System(camera=cam, sensor=Sensor.RGBD, options=opts, device=dev)
        t.load_map(paths[i - 1])
        assert t.vo.server.state.pt_pos.device.type == torch.device(dev).type
        assert t.vo.kf_images.device.type == torch.device(dev).type
        t.save_map(paths[i])
    files = [dict(np.load(p)) for p in paths]
    assert s.vo.archive.count > 0 and "__aux_cloud" in files[0]
    assert set(files[0]) == set(files[1]) == set(files[2])
    for k in files[0]:
        assert all(f[k].dtype == files[0][k].dtype and np.array_equal(f[k], files[0][k])
                   for f in files[1:]), k


def _frontend_vo_on_cpu(vo_type, n: int = 14):
    """The port's VisualOdometry with `vo_type` (and the SEMI_DENSE map) on
    the CPU over tests/test_vo.py's first n frames at 240x320, the
    vocabulary, archive, loops and async mapping off: (camera, frames, the
    VisualOdometry, the motion model's prediction for frame n)."""
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    cam, frames, _ = mw.make_mono_workload(n + 1, device="cpu", shape=(240, 320), du=1.0 / 39)
    opts = tvo.VOOptions(vo_type=vo_type, map_type=tvo.MapType.SEMI_DENSE, use_vocabulary=False,
                         archive_map=False, loop_closing=False, async_mapping=False,
                         **mw.VO_OPTS)
    vo = tvo.VisualOdometry(cam, opts, device="cpu")
    for k in range(n):
        vo.add_frame(frames[k], float(k))
    assert vo.status is tvo.Status.GOOD
    return cam, frames, vo, vo.velocity.compose(vo.prev_T_cw)


def test_orb_tracking_card_matches_cpu(cuda_device):
    """SPARSE_ORB on the card against the CPU: frame 14 of tests/test_vo.py's
    sequence through `track_map_orb` with the map of a SPARSE_ORB
    VisualOdometry run on the CPU and the same detections on both devices:
    pass 1's match decisions equal on >= 99% of the 3072 landmarks (and the
    observations where both match), the pose within TOL_POSE, inlier sets
    equal on >= 99%."""
    from ygz_slam_tpu_torch.models import frontend as tfe
    from ygz_slam_tpu_torch.models import orb_tracking as torb
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    cam, frames, vo, T_pred = _frontend_vo_on_cpu(tvo.VOType.SPARSE_ORB)
    o, st = vo.o, vo.server.state
    pyr = tfe.preprocess(frames[14], o.n_levels)
    feats = tfe.detect_multilevel(pyr, o.detect_threshold, o.grid_cell, o.feat_budgets)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        args = (cam, _to(T_pred, dev), st.pt_pos.to(dev), st.pt_valid.to(dev),
                st.pt_desc.to(dev), _to(feats, dev))
        m, obs, _ = torb.match_by_projection(*args, radius=o.orb_match_radius,
                                             max_dist=o.orb_max_hamming)
        tm = torb.track_map_orb((240, 320), *args, radius_coarse=o.orb_match_radius,
                                max_dist=o.orb_max_hamming, max_step_motion=o.max_step_motion)
        out.append((m.cpu(), obs.cpu(), _to(tm, "cpu")))
    (m_g, obs_g, tm_g), (m_h, obs_h, tm_h) = out
    both = m_g & m_h
    agree = (m_g == m_h).float().mean().item()
    inl = (tm_g.found == tm_h.found).float().mean().item()
    d = float(tse3.distance(tm_g.T_cw, tm_h.T_cw))
    print(f"SPARSE_ORB card against CPU: {int(m_g.sum())} / {int(m_h.sum())} matched, decisions "
          f"agree {agree:.4f}; pose {d:.2e} apart; inliers {int(tm_g.n_inliers)} / "
          f"{int(tm_h.n_inliers)}, sets agree {inl:.4f}")
    assert agree >= 0.99 and torch.equal(obs_g[both], obs_h[both]) and int(both.sum()) > 30
    assert d <= TOL_POSE and inl >= 0.99


def test_semidense_step_card_matches_cpu(cuda_device):
    """SEMI_DENSE_DIRECT on the card against the CPU: frame 14 of
    tests/test_vo.py's sequence through `track_sd` (alignment over 256 +
    512 points, map tracking over 3072 rows, the gradient pixels' seed
    update) with the map and gradient-pixel set of a VisualOdometry run on
    the CPU: the pose within TOL_SLICE, inlier sets and the seeds updated
    equal on >= 98% of the rows."""
    from ygz_slam_tpu_torch.map import state as ms
    from ygz_slam_tpu_torch.models import frontend as tfe
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    cam, frames, vo, T_pred = _frontend_vo_on_cpu(tvo.VOType.SEMI_DENSE_DIRECT)
    o, sd = vo.o, vo.sd
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        sd_d = sd._replace(px=sd.px.to(dev), seeds=_to(sd.seeds, dev))
        kf_images = vo.kf_images.to(dev)
        tm, _, ok, sd_new = tvo.track_sd(
            cam, o, sd_d, ms.row(kf_images, sd.kf_slot), tfe.preprocess(frames[14].to(dev),
                                                                          o.n_levels),
            T_pred.params7().to(dev), _to(vo.server.state, dev), kf_images)
        out.append((_to(tm, "cpu"), sd_new.seeds.sigma2.cpu()))
    (tm_g, s_g), (tm_h, s_h) = out
    d = float(tse3.distance(tm_g.T_cw, tm_h.T_cw))
    inl = (tm_g.found == tm_h.found).float().mean().item()
    upd = ((s_g != sd.seeds.sigma2) == (s_h != sd.seeds.sigma2)).float().mean().item()
    print(f"SEMI_DENSE_DIRECT card against CPU: pose {d:.2e} apart; inliers "
          f"{int(tm_g.n_inliers)} / {int(tm_h.n_inliers)}, sets agree {inl:.4f}; updated seeds "
          f"agree {upd:.4f}")
    assert d <= TOL_SLICE and inl >= 0.98 and upd >= 0.98 and int(tm_h.n_inliers) > 30


def test_sharded_local_ba_nccl_matches_cpu(cuda_device):
    """Main path 14a at a small size: bench_scaling.py's problem at 256
    landmarks on 4 shards of one rank, in an NCCL world of one on the card
    and a gloo world of one on the CPU (one after the other: a process
    group has one backend), held to each other at the tolerances of
    tests/test_torch_sharded_ba.py; two all_reduce calls per iteration."""
    import torch.distributed as dist
    from ygz_slam_tpu_torch.models import ba_workload as bw
    from ygz_slam_tpu_torch.parallel import mesh as pmesh
    from ygz_slam_tpu_torch.parallel import sharded_ba as sba

    assert not dist.is_initialized()
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = bw.ba_problem(256, device=dev)
        mesh = pmesh.make_mesh(4, device=dev)
        try:
            assert dist.get_backend() == pmesh.backend_for(dev)
            c0 = pmesh.reduce_sum.calls
            P, X, C = sba.sharded_local_ba(mesh, *bw.shard_inputs(mesh, p), p.cam, p.fixed)
            assert pmesh.reduce_sum.calls - c0 == 20
            out.append((P.params7().cpu(), X.cpu(), float(C), bw.pose_gate(P, p)))
        finally:
            dist.destroy_process_group()
    (pg, xg, cg, eg), (ph, xh, ch, eh) = out
    dp, dx = float((pg - ph).abs().max()), float((xg - xh).abs().max())
    print(f"sharded local BA, NCCL on the card against gloo on the CPU: params7 {dp:.2e}, "
          f"landmarks {dx:.2e}, chi2 {cg:.4f} / {ch:.4f}; pose errors {eg} / {eh}")
    assert dp <= 2e-5 and dx <= 2e-4 and abs(cg - ch) <= 1e-4 * ch
    assert eg[1] < 0.05
