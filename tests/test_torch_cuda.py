"""The port's CUDA kernels against their plain versions, on the card, on
inputs the main paths do not give them: K1 with origins outside the
image, K2 with an image index past its stack, K5 with planted outliers
and masked points, K6 with eight requests, K8 with one sequence fully
masked beside normal ones, K10 with an empty side and with one row, K9 v1
and v2 at every level of a frame pair, on a level with no usable point and
on windows clamped at the border; and five frames of the single-sequence
step, three of the batch step, twelve of the VO slice (with one keyframe
cycle) and forty of the monocular System from raw frames on the card
against the CPU.
chip_smoke.py holds every kernel against its plain version on the main
paths' own inputs.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: kernel and plain version run the same float32 algorithm and
differ in summation order (warp shuffles versus PyTorch reductions) and
multiply-add contraction only, so poses agree far below the 1e-4 GN
stopping step and K1's copy is exact.
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

from _torch_port import cuda_device  # noqa: F401

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
    counters = (tk1.gather_windows, tk3.mega_gn, tk4.a2d_gn, tk5.pose_ba_gn)
    before = [c.launches for c in counters]
    T7, inl = tr.track_frames(state, out[7], TSE3.identity(device=dev).params7())
    assert [c.launches - b for c, b in zip(counters, before)] == [20, 5, 5, 5]
    assert tr.gate(T7, inl, out[8])[2]
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, _ = [
        a.cpu() if isinstance(a, torch.Tensor) else a for a in out]
    state_c = tr.make_state(cam, [lv.cpu() for lv in ref_pyr], px, depth, mask, pts_w,
                            patches)
    T7c, _ = tr.track_frames(state_c, frames, TSE3.identity(device="cpu").params7())
    d = tse3.distance(TSE3.from_params7(T7.cpu()), TSE3.from_params7(T7c))
    assert float(d.max()) <= TOL_SLICE


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
    assert [c.launches - b for c, b in zip(counters, before)] == [0, S * F, S * F, F, F, F]
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
    counters = (tk1.gather_windows, tk1.gather_windows_multi, tk3.mega_gn, tk4.a2d_gn,
                tk5.pose_ba_gn, tk10.distance_matrix)
    before = [c.launches for c in counters]
    st, T7, inl, log = vw.track_vo_frames(state, frames[1:])
    assert [c.launches - b for c, b in zip(counters, before)] == [72, 12, 12, 12, 12, 3]
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
    assert names == (["gather_windows"] * 6 + ["mega_gn", "gather_windows_multi", "a2d_gn",
                                               "pose_ba_gn"] + ["distance_matrix"] * 3)
    assert [a[3] for fn, a in rec[:6]] == [7, 7, 7, 16, 16, 16]
    assert [tuple(a[0].shape) + tuple(a[1].shape) for fn, a in rec[10:]] == \
        [(128, 8, 256, 8), (128, 8, 256, 8), (256, 8, 3072, 8)]
    plain = {tk1.gather_windows: tk1.gather_windows_plain,
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


def _k9_agree(args, lfac=None):
    """K9 v1 (lfac None) or v2 against its plain version on `args`."""
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as tk9

    if lfac is None:
        n0 = tk9.level_gn.launches
        out, ref = tk9.level_gn(*args), tk9.level_gn_plain(*args)
        assert tk9.level_gn.launches == n0 + 1
        torch.testing.assert_close(out[13:], ref[13:], rtol=1e-4, atol=1e-4 * float(
            ref[13:].abs().max()))
    else:
        v2 = args[:8] + (lfac,) + args[8:]
        n0 = tk9.level_gn_v2.launches
        out, ref = tk9.level_gn_v2(*v2), tk9.level_gn_v2_plain(*v2)
        assert tk9.level_gn_v2.launches == n0 + 1
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
        lr = prep.levels[level]
        args, pc0, px0 = tk9.level_args(cur[level], lr, prep.p_ref, R0, t0, cam, level, False)
        _k9_agree(args)
        H0 = tk3.frozen_h0(lr.J, lr.vis, pc0, px0, *cur[level].shape)
        _k9_agree(args, tk9.frozen_factor(H0))
    lr = prep.levels[0]._replace(vis=torch.zeros_like(prep.levels[0].vis))
    args, pc0, px0 = tk9.level_args(cur[0], lr, prep.p_ref, R0, t0, cam, 0, False)
    H0 = tk3.frozen_h0(lr.J, lr.vis, pc0, px0, *cur[0].shape)
    assert float(H0.abs().max()) == 0.0
    for lfac in (None, tk9.frozen_factor(H0)):
        out = _k9_agree(args, lfac)
        torch.testing.assert_close(out[:12], args[7], rtol=0, atol=0)
        assert float(out[12]) == 0.0
    # A 0.5 m sideways shift of the init pose: a third of the projections
    # leave the image, and the windows of those near its edge are clamped.
    t_side = torch.tensor([0.5, 0.3, 0.0], device=cuda_device)
    for level in range(3):
        lr = prep.levels[level]
        args, pc0, px0 = tk9.level_args(cur[level], lr, prep.p_ref, R0, t_side, cam, level,
                                        False)
        Hl, Wl = cur[level].shape
        ox, oy = args[5], args[6]
        clamped = (ox == 0) | (ox == Wl - tk9.CWIN) | (oy == 0) | (oy == Hl - tk9.CWIN)
        assert int((clamped & lr.vis).sum()) > 0
        _k9_agree(args)
        _k9_agree(args, tk9.frozen_factor(tk3.frozen_h0(lr.J, lr.vis, pc0, px0, Hl, Wl)))


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
        s = System(cam, options=mw.mono_options(), device=dev)
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
