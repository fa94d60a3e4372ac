"""Chunked tracking (`VisualOdometry.add_frames`, `System.track_monocular_chunk`
and `track_monocular_stream`) on the CPU: a port of tests/test_vo.py's
TestChunkedTracking (26 frames 240x320 of the textured plane, seed 11,
chunks of 6, so several chunks are cut at keyframes) and of the JAX
package's `_accept_counters`.

Both paths run the same `track` on the same inputs (on the CPU the chunk
step runs eagerly; on the card it is a CUDA-graph replay, tested in
test_torch_cuda.py), so the chunked run must equal the per-frame run bit
for bit: statuses, keyframes, stats, trajectory and map.  (The JAX package
decides its keyframes inside its scan in float32 and holds the two to
4.5e-3.)  Against the JAX package's per-frame run the chunked run is held
to test_torch_mono_vo.py's tolerances, with the port handed the JAX
package's RANSAC draw."""
import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.system.system import System
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_mono_run, jax_ransac_indices, jax_vo_options

torch.set_num_threads(1)

N = 26
CHUNK = 6
CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
TOL_TRAJ = 1e-2                    # test_torch_mono_vo.py: camera centres, map units
ATE_MAX = 0.05                     # tests/test_vo.py:99


def _frames():
    """tests/test_vo.py's render_sequence(26, seed=11), rendered by the port."""
    scene = PlaneScene(CAM, plane_z=3.0, seed=11, device="cpu")
    Ts = mw.trajectory(N, 1.0 / (N - 1), "cpu")
    return (torch.stack([scene.render(T, (240, 320)) for T in Ts]),
            torch.stack([T.params7() for T in Ts]))


def _run(frames, mode: str, chunk: int = CHUNK, on_chunk=None, on_frame=None, **opts):
    """The port's System over `frames` with mono_options(**opts), per frame
    ("frame"), through track_monocular_chunk ("chunk") or
    track_monocular_stream ("stream"), with the JAX package's RANSAC draw.
    `on_chunk(vo, j)`, if given, is called after each chunk with the number
    of frames it kept; `on_frame(vo)` after each frame of the per-frame
    run."""
    ts = [float(k) for k in range(len(frames))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        s = System(camera=CAM, options=mw.mono_options(**opts), device="cpu")
        if on_chunk is not None:
            real = s.vo._track_chunk

            def track_chunk(fr, t):
                out = real(fr, t)
                on_chunk(s.vo, len(out))
                return out

            mp.setattr(s.vo, "_track_chunk", track_chunk)
        if mode == "frame":
            res = []
            for k in range(len(frames)):
                res.append(s.track_monocular(frames[k], ts[k]))
                if on_frame is not None:
                    on_frame(s.vo)
        elif mode == "chunk":
            res = s.track_monocular_chunk(frames, ts, chunk=chunk)
        else:
            res = s.track_monocular_stream(zip(frames, ts), chunk=chunk)
    return s, res


@pytest.fixture(scope="module")
def runs():
    frames, T_gt7 = _frames()
    return dict(frames=frames, T_gt7=T_gt7, frame=_run(frames, "frame"),
                chunk=_run(frames, "chunk"))


def _assert_runs_equal(a, b):
    (sa, ra), (sb, rb) = a, b
    assert len(ra) == len(rb) == N
    assert [r.status for r in ra] == [r.status for r in rb]
    assert [r.n_inliers for r in ra] == [r.n_inliers for r in rb]
    for x, y in zip(ra, rb):
        assert torch.equal(x.T_cw.R, y.T_cw.R) and torch.equal(x.T_cw.t, y.T_cw.t)
    va, vb = sa.vo, sb.vo
    assert va.server.kf_used == vb.server.kf_used
    assert va.stats == vb.stats
    assert (va.frame_id, va.frames_since_kf, va._low_streak) == \
        (vb.frame_id, vb.frames_since_kf, vb._low_streak)
    assert np.stack([p for _, p in va.trajectory]).tobytes() == \
        np.stack([p for _, p in vb.trajectory]).tobytes()
    assert [(t, f) for t, f, _ in va.traj_rel] == [(t, f) for t, f, _ in vb.traj_rel]
    assert np.stack([p for *_, p in va.traj_rel]).tobytes() == \
        np.stack([p for *_, p in vb.traj_rel]).tobytes()
    for x, y in zip(va.server.state, vb.server.state):
        assert torch.equal(x, y)
    for x, y in ((va.prev_found, vb.prev_found), (va.prev_obs_px, vb.prev_obs_px),
                 (va.velocity.R, vb.velocity.R), (va.velocity.t, vb.velocity.t)):
        assert torch.equal(x, y)
    assert (va.seeds is None) == (vb.seeds is None) and va.seed_kf_slot == vb.seed_kf_slot
    if va.seeds is not None:
        assert all(torch.equal(x, y) for x, y in zip(va.seeds, vb.seeds))


def test_chunked_equals_per_frame(runs):
    """tests/test_vo.py::TestChunkedTracking::test_matches_per_frame_path,
    bit for bit."""
    _assert_runs_equal(runs["chunk"], runs["frame"])
    cs = runs["chunk"][0].vo.chunk_stats
    print(f"chunks: {dict(cs)}; keyframes {runs['chunk'][0].vo.stats['keyframes']}")
    assert cs["chunks"] >= 2 and runs["chunk"][0].vo.stats["keyframes"] >= 2
    # Every computed frame step was kept or discarded at a cut.
    kept = cs["frames_computed"] - cs["frames_discarded"]
    assert 0 < kept < N and cs["frames_discarded"] >= 1


def test_truncated_chunk_counters_equal_per_frame(runs):
    """After each chunk cut short by a flagged frame, the landmark
    statistics (`accept_counters` over the kept prefix) equal the per-frame
    run's after the same frame."""
    per_frame = {}
    frames = runs["frames"]
    s = System(camera=CAM, options=mw.mono_options(), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        for k in range(N):
            s.track_monocular(frames[k], float(k))
            st = s.vo.server.state
            per_frame[s.vo.frame_id] = (st.pt_visible.clone(), st.pt_found.clone())
    cuts = []

    def on_chunk(vo, j):
        if 0 < j < CHUNK:
            st = vo.server.state
            cuts.append((vo.frame_id, st.pt_visible.clone(), st.pt_found.clone()))

    _run(frames, "chunk", on_chunk=on_chunk)
    assert cuts, "no chunk was cut short"
    for fid, vis, fnd in cuts:
        assert torch.equal(vis, per_frame[fid][0]) and torch.equal(fnd, per_frame[fid][1])


def test_accept_counters_sum_the_prefix():
    """`accept_counters(m, cand, found, j)` adds the first j rows of the
    masks, as j frame-by-frame increments do."""
    rng = np.random.default_rng(3)
    m = tvo.ms.empty_map(2, 4, 50, device="cpu")
    m = m._replace(pt_visible=torch.tensor(rng.integers(0, 9, 50), dtype=torch.int32),
                   pt_found=torch.tensor(rng.integers(0, 9, 50), dtype=torch.int32))
    cand = torch.tensor(rng.random((6, 50)) < 0.5)
    found = cand & torch.tensor(rng.random((6, 50)) < 0.5)
    for j in (0, 1, 4, 6):
        out = tvo.accept_counters(m, cand, found, j)
        vis, fnd = m.pt_visible.clone(), m.pt_found.clone()
        for k in range(j):
            vis += cand[k].to(torch.int32)
            fnd += found[k].to(torch.int32)
        assert torch.equal(out.pt_visible, vis) and torch.equal(out.pt_found, fnd)
        assert out.pt_visible.dtype == torch.int32


def test_stream_equals_chunk(runs):
    """track_monocular_stream (buffers of 2 x 4 frames) gives the chunked
    run's results: every frame equals the per-frame path's."""
    _assert_runs_equal(_run(runs["frames"], "stream", chunk=4), runs["chunk"])


def test_short_input_takes_the_per_frame_path(runs):
    """Fewer frames than a chunk: every frame through add_frame, no chunk."""
    frames = runs["frames"]
    s, res = _run(frames, "chunk", chunk=N + 1)
    assert not s.vo.chunk_stats and len(res) == N
    assert [r.status for r in res] == [r.status for r in runs["frame"][1]]
    assert tvo.VOOptions().chunk_frames == 32


def test_chunked_matches_jax_per_frame(runs):
    """The chunked run against the JAX VisualOdometry's per-frame run on the
    same frames: equal statuses, keyframes on the same frames (+-1), camera
    centres within 1e-2 map units, both ATEs under 0.05 m."""
    s, res = runs["chunk"]
    jnames, jT7, jkf, jv = jax_mono_run(CAM, runs["frames"], jax_vo_options(mw.mono_options()))
    statuses = [r.status for r in res]
    assert [x.name for x in statuses] == jnames
    assert s.vo.stats["keyframes"] == jv.stats["keyframes"] == len(jkf)
    T7 = np.stack([p for _, p in s.vo.trajectory])
    good = [k for k, x in enumerate(statuses) if x is tvo.Status.GOOD]
    d = np.linalg.norm(traj.camera_centers(T7[good]) - traj.camera_centers(jT7[good]), axis=1)
    ate = mw.good_ate(statuses, T7, runs["T_gt7"])
    jate = mw.good_ate([tvo.Status[n] for n in jnames], jT7, runs["T_gt7"])
    print(f"chunked port against JAX per-frame: max camera-centre gap {d.max():.2e}, ATE "
          f"{ate:.5f} / {jate:.5f} m, keyframes at {jkf}")
    assert d.max() <= TOL_TRAJ
    assert ate < ATE_MAX and jate < ATE_MAX
    assert s.vo.server.kf_used == jv.server.kf_used


@pytest.fixture(scope="module")
def seeded(runs):
    """The same frames with the depth filter on, per frame (the seed table
    after every frame kept by frame id) and chunked (the seed table after
    every chunk cut short by a flagged frame)."""
    per_frame, cuts = {}, []

    def on_frame(vo):
        per_frame[vo.frame_id] = None if vo.seeds is None else [t.clone() for t in vo.seeds]

    def on_chunk(vo, j):
        if 0 < j < CHUNK and vo.seeds is not None:
            cuts.append((vo.frame_id, [t.clone() for t in vo.seeds]))

    frames = runs["frames"]
    return dict(frame=_run(frames, "frame", on_frame=on_frame, use_depth_filter=True),
                chunk=_run(frames, "chunk", on_chunk=on_chunk, use_depth_filter=True),
                per_frame=per_frame, cuts=cuts)


def test_chunked_equals_per_frame_with_seeds(seeded):
    """With the depth filter on (the seed update in the chunk step, seeds
    promoted at keyframes), chunked tracking equals per-frame tracking bit
    for bit: statuses, trajectory, keyframes, stats, map and the seed
    table."""
    _assert_runs_equal(seeded["chunk"], seeded["frame"])
    vo = seeded["chunk"][0].vo
    seeded_keys = [k for k in vo._chunk_steps if k[-1]]
    print(f"seeded chunks: {dict(vo.chunk_stats)}; stats {dict(vo.stats)}; chunk steps "
          f"{list(vo._chunk_steps)}")
    assert vo.stats["seeds_promoted"] > 0 and vo.seeds is not None
    assert seeded_keys and all(vo._chunk_steps[k].rec_seeds is not None for k in seeded_keys)


def test_truncated_chunk_takes_the_seeds_of_the_frame_before_the_cut(seeded):
    """A chunk cut short by a flagged frame has run the seed update on the
    flagged frame and the one after it (IN_FLIGHT); the VO takes the seed
    table recorded after the last kept frame, which equals the per-frame
    run's after the same frame."""
    assert seeded["cuts"], "no chunk with seeds was cut short"
    for fid, seeds in seeded["cuts"]:
        want = seeded["per_frame"][fid]
        assert want is not None and all(torch.equal(a, b) for a, b in zip(seeds, want))
    print(f"{len(seeded['cuts'])} cut chunks with seeds, at frame ids "
          f"{[f for f, _ in seeded['cuts']]}")
