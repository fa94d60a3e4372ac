"""The VO slice as a whole: the per-frame map-tracking step and the
keyframe cycle through the JAX package (`VisualOdometry._jit_track` and
`_jit_kf_cycle`, its kernels in interpret mode, configured without
vocabulary and depth filter) and through the PyTorch port on the CPU.

Small size: 240x320 frames, map_K=4, map_F=64 with feat_budgets (40, 16, 8),
map_L=256, so NS = NSV = 256.  The port bootstraps the map; it crosses to
the JAX package as numpy arrays (`convert.map_state_to_numpy`).  Tracking
runs three frames in each package on its own state, so differences compound
as they would in use; the keyframe cycles start both packages from the same
state."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.map import state as jms
from ygz_slam_tpu.models import frontend as jfe
from ygz_slam_tpu.models import visual_odometry as jvo

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.models import vo_workload as vw
from ygz_slam_tpu_torch.ops import hamming as tham
from ygz_slam_tpu_torch.ops import kernels

from _torch_port import jax_camera, jax_kernels_interpreted, np32

torch.set_num_threads(1)

SHAPE = (240, 320)
OPTS = tvo.VOOptions(map_K=4, map_F=64, map_L=256, feat_budgets=(40, 16, 8))
FL = OPTS.map_F // 2
# Three solvers in a row per frame (K3, K4, K5), each differing from its
# counterpart in float32 reduction order only, on ~40 landmarks; over three
# frames each package feeds its own results forward.
TOL_POSE = 1e-3
MIN_SET_AGREE = 0.98     # found / candidate sets, over the landmark rows in use
TOL_POS = 1e-3           # new landmark positions, scene units (depth ~3)
MAX_BITS = 8             # descriptor bits that may flip on rounding


def jax_map(tm):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(tm).items()})


def bits_differing(a, b):
    x = (np.asarray(a).view(np.uint32) ^ np.asarray(b).view(np.uint32)).reshape(-1)
    return np.array([bin(int(v)).count("1") for v in x]).reshape(-1, 8).sum(1)


@pytest.fixture(scope="module")
def setup():
    state, frames, T_gt7 = vw.make_vo_workload(10, device="cpu", shape=SHAPE, opts=OPTS)
    jopts = jvo.VOOptions(
        use_vocabulary=False, use_depth_filter=False, archive_map=False, async_mapping=False,
        loop_closing=False, map_K=OPTS.map_K, map_F=OPTS.map_F, map_L=OPTS.map_L,
        feat_budgets=OPTS.feat_budgets)
    jv = jvo.VisualOdometry(jax_camera(state.cam), jopts)
    return state, frames, T_gt7, jv


@pytest.fixture(scope="module")
def tracked(setup):
    """Frames 1-3 through both packages, each on its own state."""
    state, frames, _, jv = setup
    port, ref = [], []
    st = state
    jm, jkf = jax_map(state.mstate), jnp.asarray(np32(state.kf_images))
    jprev_pyr = jfe.preprocess(jnp.asarray(np32(frames[0])), OPTS.n_levels)
    jprev_T = JSE3.from_params7(jnp.asarray(np32(state.prev_T_cw7)))
    jvel = JSE3.identity()
    jfound, jobs = jnp.asarray(np32(state.prev_found)), jnp.asarray(np32(state.prev_obs_px))
    with jax_kernels_interpreted():
        for img in frames[1:4]:
            st, pyr, tm = vw.track_vo_frame(st, img)
            port.append((st, pyr, tm))
            jpyr = jfe.preprocess(jnp.asarray(np32(img)), OPTS.n_levels)
            jtm, jm, jok = jv._jit_track(jprev_pyr, jpyr, jprev_T.params7(),
                                         jvel.compose(jprev_T).params7(), jm, jkf, jfound, jobs)
            ref.append((jtm, jm, jpyr, jok))
            jvel = jtm.T_cw.compose(jprev_T.inverse())
            jprev_pyr, jprev_T, jfound, jobs = jpyr, jtm.T_cw, jtm.found, jtm.obs_px
    return port, ref


class TestTrack:
    @pytest.mark.parametrize("i", [0, 1, 2])
    def test_frame(self, setup, tracked, i):
        _, _, T_gt7, _ = setup
        (st, _, tm), (jtm, jm, _, jok) = tracked[0][i], tracked[1][i]
        d = float(tse3.distance(tm.T_cw, TSE3(torch.from_numpy(np.array(jtm.T_cw.R)),
                                              torch.from_numpy(np.array(jtm.T_cw.t)))))
        assert d < TOL_POSE
        assert bool(jok)
        used = np32(st.mstate.pt_valid)
        assert used.sum() >= 30
        for name in ("found", "candidate"):
            a, b = np32(getattr(tm, name)), np.asarray(getattr(jtm, name))
            assert a.shape == b.shape == (OPTS.map_L,)
            assert not a[~used].any() and not b[~used].any()
            assert (a[used] == b[used]).mean() >= MIN_SET_AGREE, name
        n_j = int(jtm.n_inliers)
        assert n_j >= 25 and abs(int(tm.n_inliers) - n_j) <= max(1, 0.02 * n_j)
        both = np32(tm.found) & np.asarray(jtm.found)
        assert np.abs(np32(tm.obs_px)[both] - np.asarray(jtm.obs_px)[both]).max() < 0.05
        for name in ("pt_visible", "pt_found"):
            a, b = np32(getattr(st.mstate, name)), np.asarray(getattr(jm, name))
            assert (a[used] == b[used]).mean() >= MIN_SET_AGREE, name
        # and the JAX package itself tracks this workload about as well
        gt = TSE3.from_params7(T_gt7[i + 1])
        d_gt_j = float(tse3.distance(TSE3(torch.from_numpy(np.array(jtm.T_cw.R)),
                                          torch.from_numpy(np.array(jtm.T_cw.t))), gt))
        d_gt_t = float(tse3.distance(tm.T_cw, gt))
        assert abs(d_gt_t - d_gt_j) < TOL_POSE


def run_kf_cycle_both(jv, state, pyr, tm, nbr2):
    """One keyframe cycle in both packages from the port's state."""
    T7 = state.prev_T_cw7
    t_out = tvo.kf_cycle(state.cam, OPTS, state.mstate, pyr, tm.found, tm.obs_px, T7,
                         state.last_kf_slot, nbr2, state.frame_id, state.kf_images)
    Fn = OPTS.map_F - FL
    j_out = jv._jit_kf_cycle(
        jax_map(state.mstate), tuple(jnp.asarray(np32(lv)) for lv in pyr),
        jnp.asarray(np32(tm.found)), jnp.asarray(np32(tm.obs_px)), jnp.asarray(np32(T7)),
        jnp.asarray(state.last_kf_slot, jnp.int32), jnp.asarray(nbr2, jnp.int32), state.frame_id,
        jnp.asarray(np32(state.kf_images)), None, None, None, jnp.asarray(0, jnp.int32),
        jnp.zeros((Fn,), jnp.int32))
    return t_out, (j_out[0], j_out[1], j_out[5])


def compare_kf_cycle(t_out, j_out, state, want_evicted):
    (tm_, tkf, thost), (jm_, jkf, jhost) = t_out, j_out
    slot = int(thost[0])
    # --- the host block: slot, eviction, the victim's id, depthless flag ---
    assert slot == int(jhost[0])
    assert bool(thost[1]) == bool(jhost[1]) == want_evicted
    assert int(thost[2]) == int(jhost[2])
    assert bool(thost[3]) == bool(jhost[3])
    # --- the archive snapshot: plain indexing of the same input state ---
    assert len(thost) == 13 and len(jhost) == 15     # the JAX block adds BoW row and nodes
    for a, b in zip(thost[4:], jhost[4:13]):
        a, b = np32(a), np.asarray(b)
        if a.dtype == np.int32 and b.dtype == np.uint32:
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, b)
    got = convert.map_state_to_numpy(tm_)
    want = {k: np.asarray(v) for k, v in jm_._asdict().items()}
    # --- keyframe table ---
    for name in ("kf_valid", "kf_id"):
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_allclose(got["kf_pose7"], want["kf_pose7"], atol=1e-6)
    np.testing.assert_array_equal(np32(tkf), np.asarray(jkf))
    # --- the new keyframe's features: the same rows (the landmark half is
    # the same selection; the detections coincide at this size) ---
    np.testing.assert_array_equal(got["feat_valid"][slot], want["feat_valid"][slot])
    v = want["feat_valid"][slot]
    assert v[:FL].sum() >= 20 and v[FL:].sum() >= 5
    np.testing.assert_array_equal(got["feat_px"][slot][v], want["feat_px"][slot][v])
    np.testing.assert_array_equal(got["feat_level"][slot][v], want["feat_level"][slot][v])
    da = np.abs(np.angle(np.exp(1j * (got["feat_angle"][slot][v] - want["feat_angle"][slot][v]))))
    assert da.max() < 1e-3     # as in test_torch_detect.py
    bits = bits_differing(got["feat_desc"][slot][v], want["feat_desc"][slot][v])
    assert bits.max() <= MAX_BITS
    # Links and rows: integer fields are equal outright when the descriptors
    # are; a flipped bit may move a match across a threshold, so with flips
    # the features whose own descriptor is equal must still link alike.
    same_desc = np.ones(OPTS.map_F, bool)
    same_desc[v] = bits == 0
    rows_eq = got["feat_point"][slot] == want["feat_point"][slot]
    assert rows_eq[same_desc].mean() >= MIN_SET_AGREE
    if bits.max() == 0:
        assert rows_eq.all()
        for name in ("pt_valid", "pt_visible", "pt_found", "pt_first_kf", "pt_ref_feat",
                     "pt_obs", "cov_weight", "feat_point", "feat_valid"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    linked = rows_eq & (want["feat_point"][slot] >= 0)
    np.testing.assert_allclose(got["feat_depth"][slot][linked], want["feat_depth"][slot][linked],
                               atol=TOL_POS)
    # --- landmarks: rows valid in both hold the same point and descriptor ---
    assert (got["pt_valid"] == want["pt_valid"]).mean() >= MIN_SET_AGREE
    pv = got["pt_valid"] & want["pt_valid"]
    np.testing.assert_allclose(got["pt_pos"][pv], want["pt_pos"][pv], atol=TOL_POS)
    assert bits_differing(got["pt_desc"][pv], want["pt_desc"][pv]).max() <= MAX_BITS
    before = np32(state.mstate.pt_valid)
    return slot, int((pv & ~before).sum())


class TestKeyframeCycle:
    def test_free_slot(self, setup, tracked):
        """After frame 3: slot 1 is free, both triangulation neighbours are
        the bootstrap keyframe."""
        _, _, _, jv = setup
        st, pyr, tm = tracked[0][2]
        t_out, j_out = run_kf_cycle_both(jv, st, pyr, tm, nbr2=0)
        slot, _ = compare_kf_cycle(t_out, j_out, st, want_evicted=False)
        assert slot == 1

    def test_eviction(self, setup):
        """Keyframes at frames 2, 4 and 6 fill the map; the cycle at frame 8
        must evict, sweep the orphans and allocate rows as the JAX one."""
        state, frames, _, jv = setup
        st, _, _, log = vw.track_vo_frames(state, frames[1:7], kf_every=2)
        assert [c["slot"] for c in log] == [1, 2, 3] and not any(c["evicted"] for c in log)
        st, pyr, tm = vw.track_vo_frame(st, frames[7])
        st, pyr, tm = vw.track_vo_frame(st, frames[8])
        nbr2 = st.kf_used[-4]
        t_out, j_out = run_kf_cycle_both(jv, st, pyr, tm, nbr2=nbr2)
        slot, _ = compare_kf_cycle(t_out, j_out, st, want_evicted=True)
        assert slot != st.last_kf_slot
        # the frame loop does the same bookkeeping from the host block
        st2, counts = vw.insert_vo_keyframe(st, pyr, tm)
        assert counts["slot"] == slot and counts["evicted"]
        assert st2.kf_used[-1] == slot and st2.kf_used.count(slot) == 1 and len(st2.kf_used) == 4


class TestTriangulationMatrices:
    def test_kf_cycle_computes_two_matrices(self, setup, monkeypatch):
        """With keyframes at frames 2 and 4 beside the bootstrap one, the
        cycle at frame 6 computes two Hamming matrices: its detections
        against both neighbours' descriptors stacked, then the keyframe's
        features against every landmark row."""
        state, frames, _, _ = setup
        st, _, _, log = vw.track_vo_frames(state, frames[1:6], kf_every=2)
        assert [c["slot"] for c in log] == [1, 2]
        st, pyr, tm = vw.track_vo_frame(st, frames[6])
        assert st.last_kf_slot != st.kf_used[0]
        shapes = []
        dm = tham.distance_matrix

        def recording(a, b):
            shapes.append((a.shape[0], b.shape[0]))
            return dm(a, b)

        monkeypatch.setattr(tham, "distance_matrix", recording)
        monkeypatch.setattr(tvo, "distance_matrix", recording)
        vw.insert_vo_keyframe(st, pyr, tm)
        Fn = OPTS.map_F - FL
        assert shapes == [(Fn, 2 * OPTS.map_F), (OPTS.map_F, OPTS.map_L)]


class TestEntryPoints:
    def test_gate_and_loop_at_small_size(self, setup):
        state, frames, T_gt7, _ = setup
        st, T7, inl, log = vw.track_vo_frames(state, frames[1:], kf_every=4)
        assert T7.shape == (9, 7) and inl.shape == (9,) and [c["frame"] for c in log] == [4, 8]
        max_err, min_inl, _ = vw.vo_gate(T7, inl, T_gt7[1:], OPTS)
        # ~40 landmarks on 240x320 frames: the small size tracks to ~5e-2, not
        # to the full size's 2e-2 (the gate's bound; held on the card).
        assert max_err < 8e-2 and min_inl >= OPTS.min_track_inliers
        assert vw.vo_gate(T_gt7[1:], inl, T_gt7[1:], OPTS)[2]
        assert not vw.vo_gate(T_gt7[1:], inl * 0, T_gt7[1:], OPTS)[2]

    def test_on_stage_names_the_steps_own_stages(self, setup):
        """`on_stage` is called from inside the step, in stage order, and
        changes nothing of what the step returns."""
        state, frames, _, _ = setup
        names = []
        st_a, _, tm_a = vw.track_vo_frame(state, frames[1], on_stage=names.append)
        st_b, _, tm_b = vw.track_vo_frame(state, frames[1])
        assert names == ["pyramid", "sparse_align", "visible_patches", "local_map"]
        assert torch.equal(st_a.prev_T_cw7, st_b.prev_T_cw7)
        assert torch.equal(tm_a.found, tm_b.found) and torch.equal(tm_a.obs_px, tm_b.obs_px)
        assert torch.equal(st_a.mstate.pt_found, st_b.mstate.pt_found)

    def test_record_launches(self, setup):
        """A launch is kept, with its wrapper's arguments, only while the
        recording is open; on the CPU the step launches nothing."""
        def wrapper():
            pass

        wrapper.launches = 0
        kernels.launched(wrapper, "before")
        with kernels.record_launches() as rec:
            kernels.launched(wrapper, "a", 2)
            with pytest.raises(RuntimeError, match="already open"):
                with kernels.record_launches():
                    pass
            kernels.launched(wrapper)
        kernels.launched(wrapper, "after")
        assert wrapper.launches == 4
        assert rec == [(wrapper, ("a", 2)), (wrapper, ())]
        state, frames, _, _ = setup
        with kernels.record_launches() as rec:
            vw.track_vo_frame(state, frames[1])
        assert rec == []

    def test_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vw.make_vo_workload(2, shape=SHAPE, opts=OPTS)
