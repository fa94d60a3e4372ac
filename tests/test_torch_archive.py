"""The keyframe archive, the port against the JAX package, both on the CPU:
`KeyframeArchive` on the same rows (appends across a capacity doubling, a
pop in the middle, epochs, pose corrections, the state dict carried both
ways), `hamming.archive_match_scores` and `_archive_retrieval_scores`
(across the 1024-row BoW prefilter), and one `relocalize_archive` call on
an archive of the kidnapped sweep (models/archive_workload.py, 240x320)
carried into both packages, the port handed the JAX package's P3P draws
(`fold_in(PRNGKey(23), row)`).

Tolerances: the archive's rows and views are equal (bit for bit, the
descriptors as uint32 words); match-count scores are integers and equal;
BoW retrieval scores within 1e-6; `set_poses7`'s re-anchored landmarks
within 1e-6 (the same float64 host arithmetic); relocalize_archive's
candidates, matches, inlier counts and winner equal and its pose within
1e-4 of the JAX package's with its pose-BA kernel (K5, interpreted; the
port's K8 runs K5's body per candidate)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.map import archive as jarc
from ygz_slam_tpu.map import vocabulary as jvoc
from ygz_slam_tpu.models import relocalization as jrl
from ygz_slam_tpu.models import visual_odometry as jvo
from ygz_slam_tpu.ops import hamming as jhm

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.map import archive as tarc
from ygz_slam_tpu_torch.models import archive_workload as aw
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import relocalization as trl
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.ops import hamming as thm

from _torch_port import jax_camera, jax_kernels_interpreted, jax_pnp_draws, np32

torch.set_num_threads(1)

F, W = 32, 50            # narrow rows: the plain K10 stays cheap on the CPU
TOL_SCORE = 1e-6         # BoW L1 scores (float32 sums)
TOL_PTS = 1e-6           # set_poses7's re-anchored landmark positions
TOL_POSE = 1e-4          # relocalize_archive's pose on identical inputs


def random_row(rng, F=F, W=W, shape=(6, 5)):
    """One archive row of random contents (JAX `append` arguments)."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return dict(
        frame_id=int(rng.integers(0, 10 ** 4)),
        pose7=np.concatenate([q, rng.normal(size=3)]).astype(np.float32),
        bow=rng.random(W).astype(np.float32), nodes=rng.integers(-1, 100, F).astype(np.int32),
        desc=rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint64).astype(np.uint32),
        px=rng.uniform(0, 300, (F, 2)).astype(np.float32),
        feat_valid=rng.random(F) < 0.8, pt_pos=rng.normal(size=(F, 3)).astype(np.float32),
        pt_ok=rng.random(F) < 0.6, angle=rng.uniform(-3, 3, F).astype(np.float32),
        level=rng.integers(0, 3, F).astype(np.int32),
        image=rng.integers(0, 256, shape).astype(np.uint8), epoch=int(rng.integers(0, 3)))


def append_both(j, t, row):
    r = dict(row)
    args = [r.pop(k) for k in ("frame_id", "pose7", "bow", "nodes", "desc", "px", "feat_valid",
                               "pt_pos", "pt_ok")]
    j.append(*args, **r)
    t.append(*args, **r)


def assert_same_view(jv, tv):
    for name in jarc.ArchiveView._fields:
        a, b = np.asarray(getattr(jv, name)), np32(getattr(tv, name))
        if name == "desc":
            b = b.view(np.uint32)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape)
        assert np.array_equal(a, b), name


def assert_same_archive(j, t):
    assert t.count == j.count
    assert np.array_equal(t.frame_ids(), j.frame_ids())
    assert np.array_equal(t.epochs(), j.epochs())
    assert np.array_equal(t.poses7(), j.poses7())
    assert_same_view(j.device_view(), t.device_view())
    js, ts = j.state_dict(), t.state_dict()
    assert sorted(js) == sorted(ts)
    for k in js:
        assert np.array_equal(np.asarray(js[k]), ts[k]) and np.asarray(js[k]).dtype == ts[k].dtype, k


@pytest.fixture
def filled():
    rng = np.random.default_rng(0)
    j, t = jarc.KeyframeArchive(F, W), tarc.KeyframeArchive(F, W, device="cpu")
    for _ in range(17):
        append_both(j, t, random_row(rng))
    return rng, j, t


def test_append_and_view_across_a_capacity_doubling():
    rng = np.random.default_rng(1)
    j, t = jarc.KeyframeArchive(F, W), tarc.KeyframeArchive(F, W, device="cpu")
    assert_same_view(j.device_view(), t.device_view())       # empty: capacity 16
    for n in range(1, 34):
        append_both(j, t, random_row(rng))
        if n in (1, 15, 16, 17, 32, 33):
            assert t.device_view().valid.shape[0] == j.device_view().valid.shape[0]
            assert_same_archive(j, t)
    assert t.device_view().valid.shape[0] == 64


def test_pop_in_the_middle_shifts_the_later_rows(filled):
    _, j, t = filled
    for idx in (5, 0, -1):
        idx = idx % t.count                                   # the last row
        jr, tr = j.pop(idx), t.pop(idx)
        for k, v in jr.items():
            got = tr[k]
            got = np32(got) if isinstance(got, torch.Tensor) else np.asarray(got)
            if k == "desc":
                got = got.view(np.uint32)
            assert np.array_equal(np.asarray(v), got), k
        assert_same_archive(j, t)
    assert t.device_view().valid.shape[0] == 16             # 14 rows: back to capacity 16


def test_epochs_set_epoch_and_rebase(filled):
    _, j, t = filled
    for a in (j, t):
        a.set_epoch(1, 7)
    assert_same_archive(j, t)
    assert [j.epoch_of(i) for i in range(j.count)] == [t.epoch_of(i) for i in range(t.count)]

    def fn_pose7(p):
        return np.asarray(p) * np.float32(0.5)

    def fn_points(p):
        return np.asarray(p) + np.float32(1.25)

    for a in (j, t):
        a.rebase_epoch(7, fn_pose7, fn_points)
    assert_same_archive(j, t)


@pytest.mark.parametrize("scale", [False, True])
def test_set_poses7_reanchors_the_landmarks(filled, scale):
    rng, j, t = filled
    new = np.stack([random_row(rng)["pose7"] for _ in range(j.count)])
    sc = rng.uniform(0.5, 2.0, j.count).astype(np.float32) if scale else None
    j.set_poses7(new, scale=sc)
    t.set_poses7(new, scale=sc)
    d = float(np.abs(np.asarray(j.device_view().pt_pos) - np32(t.device_view().pt_pos)).max())
    print(f"re-anchored landmarks within {d:.2e} (tol {TOL_PTS})")
    assert d <= TOL_PTS
    assert np.array_equal(j.poses7(), t.poses7())


def test_state_dict_round_trips_across_packages(filled):
    _, j, t = filled
    t2 = convert.archive_from_numpy(j.state_dict(), F, W, device="cpu")
    assert_same_archive(j, t2)
    j2 = jarc.KeyframeArchive(F, W)
    j2.load_state_dict(t.state_dict())
    assert_same_archive(j2, t)
    empty = convert.archive_from_numpy({}, F, W, device="cpu")
    assert empty.count == 0 and empty.state_dict() == {}


def test_recompute_bow(filled):
    _, j, t = filled
    j.recompute_bow(lambda d, v: (np.full(7, v.sum(), np.float32),
                                  np.where(v, 3, -1).astype(np.int32)), 7)
    t.recompute_bow(lambda d, v: (torch.full((7,), float(v.sum())),
                                  torch.where(v, 3, -1).to(torch.int32)), 7)
    assert_same_archive(j, t)


def test_appended_image_is_truncated_not_rounded():
    """The JAX VO stores np.clip(img, 0, 255).astype(np.uint8)."""
    t = tarc.KeyframeArchive(F, W, device="cpu")
    img = torch.tensor([[-3.0, 0.4, 0.6, 254.9, 300.0]])
    row = random_row(np.random.default_rng(2))
    t.append(row["frame_id"], row["pose7"], row["bow"], row["nodes"], row["desc"], row["px"],
             row["feat_valid"], row["pt_pos"], row["pt_ok"], image=img)
    assert np.array_equal(np32(t.row(0)["image"]), np.clip(img.numpy(), 0, 255).astype(np.uint8))


# -- archive_match_scores ------------------------------------------------------
def scoring_inputs(rng, A, F=F, planted=True):
    """A query [F, 8] and an archive [A, F, 8] with masked features, fully
    masked rows, and planted matches: copies of query descriptors (twice in
    one row: a tie) and descriptors exactly max_dist = 64 bits away."""
    q = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint64).astype(np.uint32)
    q_valid = rng.random(F) < 0.9
    arc = rng.integers(0, 2 ** 32, (A, F, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.random((A, F)) < 0.85
    valid[rng.integers(0, A)] = False
    if planted:
        for a in range(A):
            for f in rng.choice(F, 6, replace=False):
                arc[a, f] = q[rng.integers(0, F)]
            arc[a, 1] = arc[a, 0]                          # a tie
            for f in rng.choice(F, 3, replace=False):     # exactly 64 bits away
                d = q[rng.integers(0, F)].copy()
                bits = rng.choice(256, 64, replace=False)
                for b in bits:
                    d[b // 32] ^= np.uint32(1 << (b % 32))
                arc[a, f] = d
    return q, q_valid, arc, valid


@pytest.mark.parametrize("A", [20, 32, 45])
def test_archive_match_scores_equal_jax(A):
    rng = np.random.default_rng(A)
    q, qv, arc, valid = scoring_inputs(rng, A)
    want = np.asarray(jhm.archive_match_scores(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(arc),
                                               jnp.asarray(valid)))
    args = (torch.tensor(q.view(np.int32)), torch.tensor(qv), torch.tensor(arc.view(np.int32)),
            torch.tensor(valid))
    got = thm.archive_match_scores(*args)
    got_small = thm.archive_match_scores(*args, chunk=7)       # several K10 launches
    print(f"A={A}: scores {np32(got).tolist()}")
    assert got.dtype == torch.int32
    assert np.array_equal(np32(got), want) and np.array_equal(np32(got_small), want)
    assert want.max() > 0 and (want == 0).any()


# -- _archive_retrieval_scores ---------------------------------------------------
@pytest.fixture(scope="module")
def vocabs():
    jvocab = jvo._shared_vocabulary()
    return jvocab, convert.vocabulary_from_numpy(jvoc.state_dict(jvocab), device="cpu")


def jax_view(arc_np):
    """A JAX ArchiveView holding `arc_np`'s fields."""
    return jarc.ArchiveView(**{k: jnp.asarray(v) for k, v in arc_np.items()})


@pytest.mark.parametrize("A", [100, 1100])
def test_archive_retrieval_scores_equal_jax(vocabs, A):
    """Below and across the 1024-row BoW prefilter (planted equal BoW rows:
    the prefilter's ties go to the lower row in both)."""
    jvocab, tvocab = vocabs
    rng = np.random.default_rng(7)
    q, qv, desc, valid = scoring_inputs(rng, A)
    Wv = tvocab.n_words
    bow = rng.random((A, Wv)).astype(np.float32) ** 8
    bow /= bow.sum(1, keepdims=True)
    bow[50] = bow[40]
    bow[A - 3] = bow[40]
    row_valid = rng.random(A) < 0.95
    arc_np = dict(frame_id=np.arange(A, dtype=np.int32),
                  pose7=np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32), (A, 1)), bow=bow,
                  nodes=np.full((A, F), -1, np.int32), desc=desc,
                  px=np.zeros((A, F, 2), np.float32), angle=np.zeros((A, F), np.float32),
                  feat_valid=valid, pt_pos=np.zeros((A, F, 3), np.float32),
                  pt_ok=rng.random((A, F)) < 0.9, valid=row_valid)
    jv = jax_view(arc_np)
    want = np.asarray(jrl._archive_retrieval_scores(jvocab, jnp.asarray(q), jnp.asarray(qv), jv,
                                                    jv.valid))
    tv = tarc.ArchiveView(**{k: convert._like(v, "cpu") for k, v in arc_np.items()})
    got = np32(trl._archive_retrieval_scores(tvocab, torch.tensor(q.view(np.int32)),
                                             torch.tensor(qv), tv, tv.valid))
    d = float(np.abs(got - want).max())
    print(f"A={A}: {int((want >= 0).sum())} rows scored, max |port - JAX| {d:.2e}")
    assert np.array_equal(got >= 0, want >= 0)
    assert d <= TOL_SCORE
    if A > trl.ARCHIVE_PREFILTER:
        assert int((want >= 0).sum()) == trl.ARCHIVE_PREFILTER


# -- relocalize_archive -------------------------------------------------------------
@pytest.fixture(scope="module")
def swept(vocabs):
    """The port's kidnapped sweep up to its end; its archive's state dict
    and the query: the features of the oldest archived keyframe's frame."""
    cam, frames, _ = aw.sweep_frames((240, 320), device="cpu")
    vo = tvo.VisualOdometry(cam, aw.archive_options(), device="cpu")
    for k in range(frames.shape[0]):
        vo.add_frame(frames[k], float(k))
    ids = vo.archive.frame_ids()
    fid = int(ids.min())
    o = vo.o
    q = tfe.detect_multilevel(tfe.preprocess(frames[fid], o.n_levels), o.detect_threshold,
                              o.grid_cell, o.feat_budgets)
    return dict(cam=cam, sd=vo.archive.state_dict(), n_words=vo.archive.W, q=q, fid=fid, o=o,
                vo=vo, frames=frames)


def test_relocalize_archive_on_a_jax_archive_matches_jax(vocabs, swept):
    jvocab, tvocab = vocabs
    q, o, cam = swept["q"], swept["o"], swept["cam"]
    ja = jarc.KeyframeArchive(o.map_F, swept["n_words"])
    ja.load_state_dict(swept["sd"])
    jv = ja.device_view()
    ta = convert.archive_from_numpy(ja.state_dict(), o.map_F, swept["n_words"], device="cpu")
    tv = ta.device_view()
    assert_same_view(jv, tv)
    qd = jnp.asarray(np32(q.desc).view(np.uint32))
    qv, qpx, qang = (jnp.asarray(np32(x)) for x in (q.valid, q.px, q.angle))
    with jax_kernels_interpreted():
        jr = jax.jit(functools.partial(
            jrl.relocalize_archive, jvocab, jax_camera(cam), min_inliers=o.reloc_min_inliers,
            top_c=o.reloc_top_c, use_pnp=True))(qd, qpx, qv, jv, q_angle=qang)
    jscores = np.asarray(jrl._archive_retrieval_scores(jvocab, qd, qv, jv, jv.valid))
    jcand = np.asarray(jax.lax.top_k(jnp.asarray(jscores), o.reloc_top_c)[1])
    jmatch = []
    for a in jcand:
        cv = jnp.asarray(jv.feat_valid[a] & jv.pt_ok[a])
        idx, ok = jhm.match_nn(qd, jv.desc[a], qv, cv, max_dist=64, ratio=1.0, cross_check=True)
        ok = jhm.rotation_consistency(qang, jv.angle[a][jnp.clip(idx, 0, o.map_F - 1)], ok)
        jmatch.append(np.where(np.asarray(ok), np.asarray(idx), -1))
    stages = {}
    r = trl.relocalize_archive(tvocab, cam, q.desc, q.px, q.valid, tv,
                               min_inliers=o.reloc_min_inliers, q_angle=q.angle,
                               top_c=o.reloc_top_c, use_pnp=True, stages=stages,
                               draws=functools.partial(jax_pnp_draws, key=23))
    a = stages["attempt"]
    d_score = float(np.abs(np32(a.scores) - jscores).max())
    d_pose = float(tse3.distance(r.T_cw, SE3(torch.tensor(np32(jr.T_cw.R)),
                                             torch.tensor(np32(jr.T_cw.t)))))
    print(f"archive of {ta.count} rows (capacity {tv.valid.shape[0]}), query frame {swept['fid']}: "
          f"scores within {d_score:.2e}, candidates {np32(a.cand).tolist()}, inliers per "
          f"candidate {np32(a.n_inl).tolist()}; winner row {int(r.kf_slot)} / {int(jr.kf_slot)} "
          f"with {int(r.n_inliers)} / {int(jr.n_inliers)}; pose distance {d_pose:.2e} "
          f"(tol {TOL_POSE})")
    assert d_score == 0.0
    assert np.array_equal(np32(a.cand), jcand)
    assert np.array_equal(np32(a.match_idx), np.stack(jmatch))
    assert bool(r.success) and bool(jr.success)
    assert int(r.n_inliers) == int(jr.n_inliers) and int(r.kf_slot) == int(jr.kf_slot)
    assert d_pose < TOL_POSE


def test_relocalization_after_a_reset_sees_only_the_new_epoch(swept):
    """After a reset the archive holds the old window too, all of epoch 0,
    and the new epoch is 1: a lost frame's archive attempt admits no row of
    the old epoch (another world frame), so the start view that the archive
    relocalized before now fails; the rows themselves stay."""
    vo, frames = swept["vo"], swept["frames"]
    pyr = tfe.preprocess(frames[swept["fid"]], vo.o.n_levels)
    n0 = vo.archive.count
    vo.frame_id += 1
    assert vo._try_relocalize(pyr) is not None and vo._last_reloc_arc_idx is not None
    vo.reset()
    assert vo.epoch == 1 and set(vo.archive.epochs().tolist()) == {0}
    assert vo.archive.count > n0 and vo.server.on_evict is not None
    attempts = vo.stats["reloc_archive_attempts"]
    assert vo._try_relocalize(pyr) is None and vo._last_reloc_arc_idx is None
    assert vo.stats["reloc_archive_attempts"] == attempts + 1


def test_warmup_archive_runs_each_capacity_and_leaves_the_archive(swept):
    vo = tvo.VisualOdometry(swept["cam"], aw.archive_options(), device="cpu")
    vo.warmup_archive(max_capacity=32)
    assert vo.archive.count == 0 and vo.stats == {}


def test_system_warmup_fills_the_capacity_buckets(swept, monkeypatch):
    """System.warmup runs archive relocalization and archive loop detection
    once at each capacity 16, 32, ... up to its argument (the JAX package's
    buckets), on all-invalid views, and leaves the archive and stats empty."""
    from ygz_slam_tpu_torch.system.system import System

    seen = {"reloc": [], "loop": []}
    real_reloc, real_loop = trl.relocalize_archive, trl.detect_loop_archive

    def reloc(vocab, cam, q_desc, q_px, q_valid, arc, **kw):
        seen["reloc"].append(int(arc.valid.shape[0]))
        return real_reloc(vocab, cam, q_desc, q_px, q_valid, arc, **kw)

    def loop(*a, **kw):
        seen["loop"].append(int(a[12].valid.shape[0]))
        return real_loop(*a, **kw)

    monkeypatch.setattr(trl, "relocalize_archive", reloc)
    monkeypatch.setattr(trl, "detect_loop_archive", loop)
    s = System(camera=swept["cam"], options=aw.loop_options(), device="cpu")
    s.warmup(archive_capacity=64)
    assert seen == {"reloc": [16, 32, 64], "loop": [16, 32, 64]}
    assert s.vo.archive.count == 0 and s.vo.stats == {}
