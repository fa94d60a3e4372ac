"""The port's CUDA kernels against their plain versions, on the card, on
inputs the main paths do not give them: K1 with origins outside the
image, K2 with an image index past its stack, K5 with planted outliers
and masked points, K6 with eight requests, K8 with one sequence fully
masked beside normal ones; and five frames of
the single-sequence step and three of the batch step on the card against
the CPU.  chip_smoke.py holds every kernel against its plain version on
the main paths' own inputs.

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
from ygz_slam_tpu_torch.ops.kernels import align2d_fused as tk4
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tk1
from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused as tk5
from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused_batch as tk8
from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as tk3

from _torch_port import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL_POSE = 1e-4
TOL_SLICE = 1e-3        # whole step, card versus CPU, three solvers in a row


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
