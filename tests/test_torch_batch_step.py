"""The batch path as a whole: multi-sequence tracking through the JAX
package's kernel path (`parallel.batched_track_step` with its Pallas
kernels in interpret mode) and through the PyTorch port on the CPU, on
the problem of tests/test_batch_tracking.py (S=2 sequences, N=50
landmarks, 240x320); plus the port's batch workload against
bench_batch.py's.

The interpreted JAX step costs ~30 s on the CPU, almost all of it
tracing the interpreted kernels; it runs once per module, on the port's
keyframe preps handed across, in this file of its own."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.geometry import se3 as jse3
from ygz_slam_tpu.ops import sparse_align as jsa
from ygz_slam_tpu.ops.pallas.align2d_fused import align2d_prepare as jalign2d_prepare
from ygz_slam_tpu.parallel import batch_tracking as jbt

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import batch as tbm
from ygz_slam_tpu_torch.ops import pyramid as tpyr
from ygz_slam_tpu_torch.ops import sparse_align as tsa
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tk1
from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as tk3
from ygz_slam_tpu_torch.ops.kernels.align2d_fused import align2d_prepare
from ygz_slam_tpu_torch.parallel import batch_tracking as tbt

import test_batch_tracking
from _torch_port import jax_kernels_interpreted, jax_prep_from_port, np32

torch.set_num_threads(1)

# Port versus JAX step: three solvers in a row per sequence, each
# differing from its counterpart in float32 reduction order only; the
# kernels' own tests hold each to 1e-4, and the step compounds them.
TOL_STEP = 1e-3
TOL_TRUTH = 5e-3        # tests/test_batch_tracking.py's bound on the JAX step
TOL_POSE = 1e-4         # sparse-direct alignment of one sequence (K3's)
TOL_XY = 1e-3           # align2d, px, on >= MIN_AGREE of the points (K4's)
MIN_AGREE = 0.98
# Rendering tolerances of slice 1 (tests/test_torch_track_step.py).
TOL_IMG = 1e-3
TOL_IMG_FLIP = 1e-2
MIN_IMG_AGREE = 0.999


def _port_cam(jcam):
    return convert.camera_from_numpy(*jcam)


@pytest.fixture(scope="module")
def problem():
    """tests/test_batch_tracking.py's problem (S=2, N=50), the port's own
    keyframe preps of it, and the JAX fused batch step on those preps
    (its kernels interpreted) from the identity."""
    rp, cp, px, d, pw, pat, T_gt, S, N = \
        test_batch_tracking.TestBatchedTrackStep()._problem(S=2, N=50)
    cam = _port_cam(test_batch_tracking.CAM)
    a = dict(ref_pyrs=[np32(lv) for lv in rp], cur_pyrs=[np32(lv) for lv in cp], px=np32(px),
             depth=np32(d), mask=np.ones((S, N), bool), pts_w=np32(pw), patches=np32(pat))
    state = tbm.make_batch_state(cam, [torch.tensor(lv) for lv in a["ref_pyrs"]],
                                 *(torch.tensor(a[k]) for k in
                                   ("px", "depth", "mask", "pts_w", "patches")))
    jpreps = [jax_prep_from_port(p) for p in state.ref_preps]
    ja2d = jalign2d_prepare(jnp.asarray(a["patches"]).reshape(S * N, 10, 10))
    T0 = JSE3.from_params7(jnp.tile(JSE3.identity().params7()[None], (S, 1)))
    with jax_kernels_interpreted():
        T_j, inl_j = jbt.batched_track_step(
            rp, cp, test_batch_tracking.CAM, px, d, jnp.asarray(a["mask"]), pw, pat, T0,
            ref_preps=jpreps, a2d_prep=ja2d)
    return dict(a, S=S, N=N, cam=cam, jcam=test_batch_tracking.CAM, state=state,
                jpreps=jpreps, ja2d=ja2d, T_gt7=np32(T_gt.params7()),
                T7_j=np32(T_j.params7()), inl_j=np32(inl_j))


def _dist(T7a, T7b):
    return tse3.distance(TSE3.from_params7(torch.tensor(np32(T7a))),
                         TSE3.from_params7(torch.tensor(np32(T7b))))


def _check_step(p, T7, inl):
    """The port's step against the JAX step's, per sequence."""
    S = p["S"]
    assert np.isfinite(p["T7_j"]).all(), "JAX reference pose not finite"
    gt = np.broadcast_to(p["T_gt7"], (S, 7))
    d_j, d_t = _dist(p["T7_j"], gt), _dist(T7, gt)
    assert float(d_j.max()) < TOL_TRUTH and float(d_t.max()) < TOL_TRUTH, (d_j, d_t)
    d = _dist(T7, p["T7_j"])
    print(f"measured: batch step pose distance port vs JAX {d.numpy()}, from the truth "
          f"JAX {d_j.numpy()} port {d_t.numpy()}, inliers {np32(inl)} vs {p['inl_j']}")
    assert float(d.max()) <= TOL_STEP, d
    assert np.abs(np32(inl).astype(int) - p["inl_j"].astype(int)).max() <= 2


def test_gather_frame_windows_and_sparse_align(problem):
    """One sequence, from an init ~0.01 off its truth: every level's
    windows plus an align2d cache group on level 0 (the same image twice)
    in one K6 request list, exact against the JAX kernel; then
    sparse_image_align on those windows."""
    p = problem
    s = 1
    cp = [lv[s] for lv in p["cur_pyrs"]]
    T0_7 = np.asarray([1.0, 0.002, -0.003, 0.004, 0.01, -0.005, 0.002], np.float32)
    T0_7[:4] /= np.linalg.norm(T0_7[:4])
    centers = p["px"][s] + np.random.default_rng(3).uniform(-2, 2, (p["N"], 2)).astype(np.float32)
    with jax_kernels_interpreted():
        jcp = tuple(jnp.asarray(lv) for lv in cp)
        jT0 = JSE3.from_params7(jnp.asarray(T0_7))
        jfw = jsa.gather_frame_windows(jcp, p["jcam"], p["jpreps"][s], jT0, distorted=True,
                                       a2d_centers=jnp.asarray(centers))
        jst = jsa.sparse_image_align(
            tuple(jnp.asarray(lv[s]) for lv in p["ref_pyrs"]), jcp, p["jcam"],
            jnp.asarray(p["px"][s]), jnp.asarray(p["depth"][s]), jnp.asarray(p["mask"][s]),
            jT0, n_iter=15, distorted=True, ref_prep=p["jpreps"][s], frame_windows=jfw)
    tcp = tuple(torch.tensor(lv) for lv in cp)
    tT0 = TSE3.from_params7(torch.tensor(T0_7))
    fw = tsa.gather_frame_windows(tcp, p["cam"], p["state"].ref_preps[s], tT0, distorted=True,
                                  a2d_centers=torch.tensor(centers))
    for a, b in zip(fw.mega_wins.wins, jfw.mega_wins):
        np.testing.assert_array_equal(np32(a), np32(b))
    np.testing.assert_array_equal(np32(fw.a2d.wins), np32(jfw.a2d.wins))
    np.testing.assert_array_equal(np32(fw.a2d.ox), np32(jfw.a2d.ox))
    np.testing.assert_array_equal(np32(fw.a2d.oy), np32(jfw.a2d.oy))
    st = tsa.sparse_image_align(tuple(torch.tensor(lv[s]) for lv in p["ref_pyrs"]), tcp,
                                p["cam"], None, None, None, tT0, distorted=True,
                                ref_prep=p["state"].ref_preps[s], frame_windows=fw)
    d = float(tse3.distance(st.T_cur_ref, TSE3(torch.tensor(np32(jst.T_cur_ref.R)),
                                                torch.tensor(np32(jst.T_cur_ref.t)))))
    print(f"measured: sparse alignment on K6's windows, pose distance port vs JAX {d:.3e}")
    assert d <= TOL_POSE, d
    assert float(tse3.distance(st.T_cur_ref, TSE3.from_params7(torch.tensor(p["T_gt7"])))) \
        < TOL_TRUTH
    # The windows K1 would gather at the same pose give the same result.
    st1 = tsa.sparse_image_align(tuple(torch.tensor(lv[s]) for lv in p["ref_pyrs"]), tcp,
                                 p["cam"], None, None, None, tT0, distorted=True,
                                 ref_prep=p["state"].ref_preps[s])
    np.testing.assert_array_equal(np32(st1.T_cur_ref.R), np32(st.T_cur_ref.R))


def test_frame_windows_carry_their_origins(problem):
    """gather_frame_windows hands K3 the origins and init projection it
    gathered at, and they are the ones the K1 path computes at that pose."""
    p = problem
    s = 0
    prep = p["state"].ref_preps[s]
    cp = tuple(torch.tensor(lv[s]) for lv in p["cur_pyrs"])
    T0 = TSE3.from_params7(torch.tensor([1.0, 0.0, 0.0, 0.0, 0.01, -0.004, 0.003]))
    fw = tsa.gather_frame_windows(cp, p["cam"], prep, T0, distorted=True)
    _, mw = tk3.mega_args(cp, prep.levels, prep.p_ref, T0.R, T0.t, p["cam"], True, len(cp),
                          prep.mega_refp, prep.mega_jl)
    for a, b in zip(fw.mega_wins, mw):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fw.mega_wins.wins.shape == (len(cp), p["N"], tk3.CWIN, tk3.CWIN)
    assert fw.a2d is None


def _per_sequence_windows(cps, cam, preps, T0s, centers=None):
    """Each sequence's frame windows gathered on its own (one K6 request
    list per sequence)."""
    return [tsa.gather_frame_windows(cp, cam, prep, T0, distorted=True,
                                     a2d_centers=None if centers is None else centers[s])
            for s, (cp, prep, T0) in enumerate(zip(cps, preps, T0s))]


def _assert_windows_equal(fws, ref):
    assert len(fws) == len(ref)
    for fw, rw in zip(fws, ref):
        for a, b in zip(fw.mega_wins, rw.mega_wins):
            assert torch.equal(a, b)
        assert (fw.a2d is None) == (rw.a2d is None)
        if fw.a2d is not None:
            for a, b in zip(fw.a2d, rw.a2d):
                assert torch.equal(a, b)


@pytest.fixture(scope="module")
def batch8():
    """Frame 1 of the port's batch workload at S=8 (bench_batch.py's
    sequences), its keyframe preps and per-sequence init poses ~0.01 off
    the truth."""
    S = 8
    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, T_gt7 = \
        tbm.make_batch_workload(S, 2, device="cpu")
    state = tbm.make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches)
    cur_pyrs = tpyr.build_pyramid(frames[1], len(ref_pyrs))
    rng = np.random.default_rng(11)
    T0s = [TSE3.from_params7(T_gt7[0]).compose(tse3.exp(torch.tensor(
        rng.uniform(-0.01, 0.01, 6), dtype=torch.float32))) for _ in range(S)]
    cps = [tuple(c[s] for c in cur_pyrs) for s in range(S)]
    centers = [px[s] + torch.tensor(rng.uniform(-2, 2, (px.shape[1], 2)), dtype=torch.float32)
               for s in range(S)]
    return dict(S=S, cam=cam, state=state, cps=cps, T0s=T0s, centers=centers)


@pytest.mark.parametrize("with_a2d", [False, True], ids=["levels", "levels_and_a2d"])
def test_gather_frames_windows_equals_per_sequence(batch8, with_a2d):
    """All eight sequences' windows in one request list (24 requests, or
    32 with align2d's cache windows) equal each sequence gathered on its
    own, bit for bit."""
    b = batch8
    centers = b["centers"] if with_a2d else None
    fws = tsa.gather_frames_windows(b["cps"], b["cam"], b["state"].ref_preps, b["T0s"],
                                    distorted=True, a2d_centers=centers)
    _assert_windows_equal(fws, _per_sequence_windows(b["cps"], b["cam"], b["state"].ref_preps,
                                                     b["T0s"], centers))
    assert all((fw.a2d is not None) == with_a2d for fw in fws)


@pytest.mark.parametrize("cap", [5, 24, tsa.MAX_GROUPS])
def test_gather_frames_windows_splits_long_lists(batch8, monkeypatch, cap):
    """A request list longer than MAX_GROUPS goes to K6 in launches of at
    most MAX_GROUPS requests, in order; the windows do not change.  At S=8
    (24 requests) the batch path's list is one launch."""
    b = batch8
    calls = []
    grouped = tsa.gather_windows_grouped

    def counting(groups):
        calls.append(len(groups))
        return grouped(groups)

    monkeypatch.setattr(tsa, "gather_windows_grouped", counting)
    monkeypatch.setattr(tsa, "MAX_GROUPS", cap)
    fws = tsa.gather_frames_windows(b["cps"], b["cam"], b["state"].ref_preps, b["T0s"],
                                    distorted=True)
    n_req = 3 * b["S"]
    assert calls == [cap] * (n_req // cap) + ([n_req % cap] if n_req % cap else [])
    monkeypatch.setattr(tsa, "gather_windows_grouped", grouped)
    _assert_windows_equal(fws, _per_sequence_windows(b["cps"], b["cam"], b["state"].ref_preps,
                                                     b["T0s"]))


def test_batched_sparse_align_same_bits(problem):
    """`batched_sparse_align` (every sequence's windows in one K6 request
    list, then the S alignments) gives the poses of the per-sequence route
    (each sequence's windows gathered on its own before its alignment), bit
    for bit."""
    p = problem
    st = p["state"]
    cur = tuple(torch.tensor(lv) for lv in p["cur_pyrs"])
    T0 = TSE3.from_params7(torch.tensor(np.array([[1.0, 0.0, 0.0, 0.0, 0.01, -0.004, 0.003],
                                                  [1.0, 0.0, 0.0, 0.0, -0.006, 0.005, 0.0]],
                                                 np.float32)))
    T = tbt.batched_sparse_align(st.ref_pyrs, cur, p["cam"], st.px, st.depth, st.mask, T0,
                                 st.ref_preps)
    T7_in = T0.params7()
    for s, prep in enumerate(st.ref_preps):
        cp = tuple(c[s] for c in cur)
        T0s = TSE3.from_params7(T7_in[s])
        fw = tsa.gather_frame_windows(cp, p["cam"], prep, T0s, distorted=True)
        one = tsa.sparse_image_align(tuple(r[s] for r in st.ref_pyrs), cp, p["cam"], st.px[s],
                                     st.depth[s], st.mask[s], T0s, distorted=True,
                                     ref_prep=prep, frame_windows=fw)
        assert torch.equal(T.params7()[s], one.T_cur_ref.params7())
    assert float(_dist(np32(T.params7()), np.broadcast_to(p["T_gt7"], (p["S"], 7))).max()) \
        < TOL_TRUTH


def _k3_batch_args(b, S, T0s):
    """The batched K3's arguments for the first S sequences of `batch8`
    from the init poses T0s (a list of S SE3): the route's own origins and
    K6 windows."""
    ref = tbt.stack_preps(b["state"].ref_preps[:S])
    cur = tuple(torch.stack([cp[li] for cp in b["cps"][:S]]) for li in range(len(b["cps"][0])))
    T0 = TSE3(torch.stack([T.R for T in T0s]), torch.stack([T.t for T in T0s]))
    ox, oy = tbt.batch_window_origins(cur, ref.p_ref, T0, b["cam"])
    wins = tk1.gather_windows_stacked(cur, ox, oy, tk3.CWIN)
    pose0 = torch.cat([T0.R.reshape(S, 9), T0.t], dim=1)
    H0, W0 = cur[0].shape[1:]
    return [wins, ref.refp, ref.jac, ref.p_ref, ref.lvis, ox, oy, pose0, b["cam"],
            tbt.DISTORTED, H0, W0]


def test_batched_k3_plain_equals_per_sequence(batch8):
    """The batched K3's plain version at S=3 equals `mega_gn_plain` run on
    each sequence alone, bit for bit, where the second sequence has every
    point masked or outside its windows and the third diverges (its
    Jacobians negated, so every step goes uphill and the first trial of
    every level is rolled back).  The first sequence's result does not
    change with its neighbours."""
    b = batch8
    S = 3
    args = _k3_batch_args(b, S, b["T0s"][:S])
    clean = tk3.mega_gn_batch(*args)
    wins, refp, jac, p_ref, lvis, ox, oy, pose0 = (a.clone() for a in args[:8])
    N = lvis.shape[2]
    lvis[1, :, :N // 2] = 0.0                     # half masked, half outside its windows
    ox[1, :, N // 2:] += 100
    jac[2] *= -1.0
    args[:8] = wins, refp, jac, p_ref, lvis, ox, oy, pose0
    n0 = tk3.mega_gn_batch.launches
    out = tk3.mega_gn_batch(*args)
    assert out.shape == (S, 13) and tk3.mega_gn_batch.launches == n0
    stats = []
    for s in range(S):
        st = {}
        one = tk3.mega_gn_plain(*(a[s] for a in args[:8]), *args[8:], stats=st)
        stats.append(st["passes"])
        assert torch.equal(out[s], one), s
    print(f"measured: batched K3 plain, passes per level {stats}")
    assert torch.equal(out[0], clean[0])
    assert torch.equal(out[1, :12], pose0[1]) and float(out[1, 12]) == 0.0
    assert stats[2] == [2, 2, 2] and torch.equal(out[2, :12], pose0[2])
    assert not torch.equal(out[0, :12], pose0[0]) and max(stats[0]) > 2


def test_batch_window_origins_equal_per_sequence(batch8):
    """The batched window origins [S, L, N] equal `mega_window_origins` run
    on each sequence alone, bit for bit, through a distorted copy of the
    camera (the batch path projects through the distortion model), at
    batch8's init poses and at poses that push the points off the image (5
    m along x), behind the camera (turned about y by pi) and onto the
    camera plane 100 m off the axis, where the distortion polynomial
    overflows, the projection is NaN and the clamp sets it."""
    b = batch8
    S = b["S"]
    c = b["cam"]
    cam = PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, k1=0.1, k2=-0.05, p1=1e-3, p2=-1e-3)
    ref = tbt.stack_preps(b["state"].ref_preps)
    T0s = list(b["T0s"])
    T0s[1] = TSE3(T0s[1].R, T0s[1].t + torch.tensor([5.0, 0.0, 0.0]))
    T0s[2] = tse3.exp(torch.tensor([0.0, 0.0, 0.0, 0.0, np.pi, 0.0]))
    p0 = ref.p_ref[3, 0]
    T0s[3] = TSE3(torch.eye(3), torch.stack([-p0[0], torch.tensor(100.0), -p0[2]]))
    cur = tuple(torch.stack([cp[li] for cp in b["cps"]]) for li in range(len(b["cps"][0])))
    T0 = TSE3(torch.stack([T.R for T in T0s]), torch.stack([T.t for T in T0s]))
    ox, oy = tbt.batch_window_origins(cur, ref.p_ref, T0, cam)
    assert ox.shape == oy.shape == (S, len(cur), ref.p_ref.shape[1])
    assert ox.dtype == oy.dtype == torch.int32
    for s in range(S):
        _, _, ox_s, oy_s = tk3.mega_window_origins(b["cps"][s], ref.p_ref[s], T0s[s].R, T0s[s].t,
                                                   cam, tbt.DISTORTED, len(cur))
        assert torch.equal(ox[s], ox_s) and torch.equal(oy[s], oy_s), s
    pc = ref.p_ref @ T0.R.transpose(-1, -2) + T0.t[:, None]
    assert bool(torch.isnan(cam.camera_to_pixel(pc[3], distorted=tbt.DISTORTED)).any())
    assert bool((pc[2, :, 2] < 0).all())
    u1 = cam.camera_to_pixel(pc[1], distorted=tbt.DISTORTED)[:, 0]
    off = u1 > cur[0].shape[2]
    print(f"measured: {int(off.sum())} of {off.numel()} points off the image at 5 m along x")
    assert float(off.float().mean()) > 0.9
    assert bool((ox[1, :, off] == ox[1, :, off].amax(dim=-1, keepdim=True)).all())


def test_stacked_windows_equal_per_sequence(batch8):
    """The batch route's windows (`batch_window_origins`, then
    `gather_windows_stacked` into one [S, L, N, 16, 16] buffer) equal each
    sequence's windows gathered on its own (`gather_frame_windows`), bit for
    bit."""
    b = batch8
    S = b["S"]
    cur = tuple(torch.stack([cp[li] for cp in b["cps"]]) for li in range(len(b["cps"][0])))
    T0 = TSE3(torch.stack([T.R for T in b["T0s"]]), torch.stack([T.t for T in b["T0s"]]))
    ox, oy = tbt.batch_window_origins(cur, b["state"].batch_ref.p_ref, T0, b["cam"])
    wins = tk1.gather_windows_stacked(cur, ox, oy, tk3.CWIN)
    assert wins.shape == (S, len(cur), ox.shape[2], tk3.CWIN, tk3.CWIN)
    for s, fw in enumerate(_per_sequence_windows(b["cps"], b["cam"], b["state"].ref_preps,
                                                 b["T0s"])):
        assert torch.equal(wins[s], fw.mega_wins.wins), s
        assert torch.equal(ox[s], fw.mega_wins.ox) and torch.equal(oy[s], fw.mega_wins.oy), s


def test_batched_align2d_matches_jax(problem):
    """All S*N patches through K2 + K4 against the JAX kernel path, on the
    keyframe images from inits up to 2 px off the keyframe pixels, three
    of them outside the image margin."""
    p = problem
    S, N = p["S"], p["N"]
    rng = np.random.default_rng(5)
    init = (p["px"] + rng.uniform(-2, 2, (S, N, 2))).astype(np.float32)
    init[0, :3] = [[2.0, 2.0], [p["cur_pyrs"][0].shape[2] - 3.0, 50.0], [-30.0, 40.0]]
    with jax_kernels_interpreted():
        xy_j, conv_j, _ = jbt.batched_align2d(jnp.asarray(p["ref_pyrs"][0]),
                                              jnp.asarray(p["patches"]), jnp.asarray(init),
                                              a2d_prep=p["ja2d"])
    xy, conv, _ = tbt.batched_align2d(torch.tensor(p["ref_pyrs"][0]), torch.tensor(init),
                                      p["state"].a2d_prep)
    conv, conv_j = np32(conv), np32(conv_j)
    assert (conv == conv_j).mean() >= MIN_AGREE
    assert not conv[0, :3].any()
    both = conv & conv_j
    dxy = np.linalg.norm(np32(xy)[both] - np32(xy_j)[both], axis=1)
    print(f"measured: batched_align2d masks agree {(conv == conv_j).mean():.4f}, "
          f"max |xy diff| {dxy.max():.3e} px on {both.sum()} points both accept")
    assert both.sum() > 0.8 * S * N and (dxy <= TOL_XY).mean() >= MIN_AGREE, dxy.max()


def test_batched_track_step_matches_jax(problem):
    """The port's own keyframe state and batched step on the problem's
    arrays: the same poses as the JAX step, both near the truth."""
    p = problem
    T0 = TSE3.identity((p["S"],), device="cpu")
    T, inl = tbt.batched_track_step(
        p["state"].ref_pyrs, tuple(torch.tensor(lv) for lv in p["cur_pyrs"]), p["cam"],
        p["state"].px, p["state"].depth, p["state"].mask, p["state"].pts_w, T0,
        p["state"].ref_preps, p["state"].a2d_prep)
    _check_step(p, T.params7(), inl)


def test_batch_step_from_converted_state(problem):
    """convert.py: the JAX batch state (its S ReferencePreps and its
    flattened Align2DPrep) brought across as numpy gives the port the JAX
    step's poses; track_batch_step runs on it."""
    p = problem
    rps = [convert.reference_prep_from_numpy(
        np32(jp.p_ref), [(np32(lv.vis), np32(lv.ref_patch), np32(lv.J)) for lv in jp.levels],
        "cpu") for jp in p["jpreps"]]
    ja = p["ja2d"]
    state = convert.batch_state_from_numpy(
        p["cam"], p["ref_pyrs"], p["px"], p["depth"], p["mask"], p["pts_w"], p["patches"], rps,
        convert.align2d_prep_from_numpy(np32(ja.ref), np32(ja.jx), np32(ja.jy), np32(ja.hinv),
                                        "cpu"), "cpu")
    # The cached patch prep is the JAX one: same inverses as the port's own.
    np.testing.assert_allclose(np32(state.a2d_prep.hinv),
                               np32(align2d_prepare(state.patches.reshape(-1, 10, 10)).hinv),
                               rtol=1e-4, atol=1e-6)
    T7, inl = tbm.track_batch_step(state, TSE3.identity((p["S"],), device="cpu").params7(),
                                   torch.tensor(p["cur_pyrs"][0]))
    _check_step(p, T7, inl)


def _bench_batch_workload(S, n_frames):
    """bench_batch.py's workload construction (its `main`, before the
    step), S sequences, n_frames frames, with the JAX package."""
    import _bench_common as bc
    from ygz_slam_tpu.geometry import PinholeCamera
    from ygz_slam_tpu.ops import pyramid
    from ygz_slam_tpu.ops.interp import sample_patches
    from ygz_slam_tpu.utils.synthetic import PlaneScene

    H, W, N = 480, 640, 200
    cam = PinholeCamera.create(517.3, 516.5, W / 2, H / 2)

    def pose(i):
        s = 2.0 * np.pi * i / 40.0
        xi = np.array([0.050 * np.sin(s), 0.035 * np.sin(2 * s + 0.7), 0.030 * np.cos(s) - 0.030,
                       0.0040 * np.sin(s + 0.3), 0.0050 * np.cos(2 * s), 0.0030 * np.sin(s)],
                      np.float32)
        base = np.array([0.04, -0.02, 0.01, 0.004, -0.006, 0.003], np.float32)
        return jse3.exp(jnp.asarray(base + xi))

    Ts = [pose(i) for i in range(n_frames)]
    rng = np.random.default_rng(0)
    out = dict(px=[], depth=[], pts_w=[], patches=[], ref=[], frames=[])
    for s in range(S):
        scene = PlaneScene(cam, plane_z=3.0, seed=s, tex_per_meter=220.0)
        img_ref = scene.render(JSE3.identity(), (H, W))
        px = jnp.asarray(np.c_[rng.uniform(30, W - 30, N), rng.uniform(30, H - 30, N)],
                         jnp.float32)
        depth = scene.depth(px, JSE3.identity())
        out["px"].append(px)
        out["depth"].append(depth)
        out["pts_w"].append(cam.pixel_to_world(px, JSE3.identity(), depth=depth,
                                               distorted=False))
        out["patches"].append(sample_patches(img_ref, px, 10))
        out["ref"].append(img_ref)
        out["frames"].append(jnp.stack([
            scene.render(T, (H, W)) + jnp.asarray(np.random.default_rng(1000 * s + i).normal(
                0, bc.NOISE, (H, W)), jnp.float32) for i, T in enumerate(Ts)]))
    res = {k: np32(jnp.stack(v)) for k, v in out.items()}
    res["frames"] = res["frames"].transpose(1, 0, 2, 3)             # [F, S, H, W]
    res["ref_pyrs"] = [np32(lv) for lv in jax.vmap(
        lambda im: pyramid.build_pyramid(im, 3))(jnp.stack(out["ref"]))]
    res["T_gt7"] = np32(jnp.stack([T.params7() for T in Ts]))
    res["cam"] = cam
    return res


def test_batch_workload_matches_bench_batch():
    """make_batch_workload keeps bench_batch.py's seeds: two sequences
    (the second draws its landmarks after the first), two frames."""
    j = _bench_batch_workload(2, 2)
    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, T_gt7 = \
        tbm.make_batch_workload(2, 2, device="cpu")
    assert tuple(cam) == tuple(_port_cam(j["cam"]))
    np.testing.assert_array_equal(np32(px), j["px"])
    assert bool(mask.all())
    np.testing.assert_allclose(np32(depth), j["depth"], rtol=1e-6)
    np.testing.assert_allclose(np32(pts_w), j["pts_w"], atol=1e-5)
    np.testing.assert_allclose(np32(patches), j["patches"], atol=TOL_IMG)
    for a, b in zip(ref_pyrs, j["ref_pyrs"]):
        np.testing.assert_allclose(np32(a), b, atol=TOL_IMG)
    dimg = np.abs(np32(frames) - j["frames"])
    assert (dimg <= TOL_IMG).mean() >= MIN_IMG_AGREE and dimg.max() <= TOL_IMG_FLIP, \
        ((dimg > TOL_IMG).mean(), dimg.max())
    np.testing.assert_allclose(np32(T_gt7), j["T_gt7"], atol=1e-6)


def test_port_batch_alone_passes_gate():
    """The port on its own batch workload (S=2, 4 frames), each step
    warm-started from the last: every sequence's every frame inside
    bench_batch.py's gate."""
    cam, px, depth, mask, pts_w, patches, ref_pyrs, frames, T_gt7 = \
        tbm.make_batch_workload(2, 4, device="cpu")
    state = tbm.make_batch_state(cam, ref_pyrs, px, depth, mask, pts_w, patches)
    T7, inl = tbm.track_batch_frames(state, frames, TSE3.identity((2,), device="cpu").params7())
    assert T7.shape == (4, 2, 7) and inl.shape == (4, 2)
    max_err, min_inl, ok = tbm.batch_gate(T7, inl, T_gt7)
    assert ok, (max_err, min_inl)
