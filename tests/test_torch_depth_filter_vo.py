"""The monocular System with the depth filter on, the port against the JAX
package, both on the CPU: test_torch_mono_vo.py's 40-frame 240x320 run
(tests/test_vo.py's sequence) through the port's `System.track_monocular`
and the JAX `VisualOdometry`, both with `use_depth_filter=True` in the
port's configuration (no vocabulary, archive or async mapping), the port
handed the JAX package's RANSAC draw.

After initialisation the two track with different algorithms (the JAX
package's CPU route runs its jnp per-level `gauss_newton`, the port the
plain versions of its kernels), and each feeds its own seeds forward: the
seed update's one-pixel uncertainty tau is a difference of nearly equal
float32 numbers, so it differs between the packages (and between the JAX
package's own jit and eager runs) by ~1e-4, and a seed's convergence test
may flip.  So the run is held at outcome level: statuses frame by frame,
keyframes on the same frames, seeds promoted per keyframe within 1, camera
centres within test_torch_mono_vo.py's 1e-2 map units.  The keyframe
cycle's seed block, given one state and one seed table in both packages,
must agree row for row."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.map import depth_filter as jdf
from ygz_slam_tpu.map import state as jms
from ygz_slam_tpu.models import visual_odometry as jvo

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.system.system import System

from _torch_port import jax_camera, jax_mono_run, jax_ransac_indices, jax_vo_options, np32

torch.set_num_threads(1)

N_FRAMES = 40
SHAPE = (240, 320)
DU = 1.0 / (N_FRAMES - 1)          # tests/test_vo.py: t = k / (n - 1)
TOL_TRAJ = 1e-2                    # camera centres, map units (test_torch_mono_vo.py)
ATE_MAX = 0.05                     # tests/test_vo.py:99
MAX_PROMOTED_DIFF = 1              # seeds promoted per keyframe
TOL_POS = 1e-5                     # promoted landmark positions, map units (depth ~1)
MIN_ROWS_AGREE = 0.95              # new seed rows at the same detection (tie order)
OPTS = mw.mono_options(use_depth_filter=True)


def _promoted(m_in: dict, m_out: dict, seed_slot: int, F: int, idx: np.ndarray) -> np.ndarray:
    """Landmark rows a keyframe cycle promoted from seeds: valid after it,
    not holding the same landmark before, first seen in the seed keyframe
    and referring to one of its seed features."""
    new = m_out["pt_valid"] & ~(m_in["pt_valid"] & (m_in["pt_ref_feat"] == m_out["pt_ref_feat"]))
    return np.where(new & (m_out["pt_first_kf"] == seed_slot)
                    & np.isin(m_out["pt_ref_feat"], seed_slot * F + idx))[0]


@pytest.fixture(scope="module")
def runs():
    cam, frames, T_gt7 = mw.make_mono_workload(N_FRAMES, device="cpu", shape=SHAPE, du=DU)
    F = OPTS.map_F
    port_cycles = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        real = tvo.kf_cycle

        def kf_cycle(cam_, o, mstate, *a, **kw):
            out = real(cam_, o, mstate, *a, **kw)
            port_cycles.append(dict(args=(mstate,) + a, kw=kw, out=out))
            return out

        mp.setattr(tvo, "kf_cycle", kf_cycle)
        s = System(camera=cam, options=OPTS, device="cpu")
        kf = []

        def on_frame(k, r):
            if s.vo.stats["keyframes"] > len(kf):
                kf.append(k)

        statuses, T7, _ = mw.run_mono(s, frames, on_frame)
    jv = jvo.VisualOdometry(jax_camera(cam), jvo.VOOptions(**jax_vo_options(OPTS)))
    jcycles = []
    jreal = jv._jit_kf_cycle

    def jkf_cycle(*a):
        out = jreal(*a)
        jcycles.append((a, out))
        return out

    jv._jit_kf_cycle = jkf_cycle
    jnames, jT7, jkf, jv = jax_mono_run(cam, frames, {}, jv=jv)
    # Seeds promoted per keyframe, counted the same way in both packages.
    pcount = []
    for c in port_cycles:
        seeds = c["kw"]["seeds"]
        if seeds is None:
            pcount.append(0)
            continue
        m_in = convert.map_state_to_numpy(c["args"][0])
        m_out = convert.map_state_to_numpy(c["out"][0])
        pcount.append(len(_promoted(m_in, m_out, c["kw"]["seed_slot"], F,
                                    np32(c["kw"]["seed_feat_idx"]))))
    jcount = []
    for a, out in jcycles:
        if a[11] is None:
            jcount.append(0)
            continue
        m_in = {k: np.asarray(v) for k, v in a[0]._asdict().items()}
        m_out = {k: np.asarray(v) for k, v in out[0]._asdict().items()}
        jcount.append(len(_promoted(m_in, m_out, int(a[12]), F, np.asarray(a[13]))))
    return dict(cam=cam, frames=frames, T_gt7=np32(T_gt7), port=(statuses, T7, kf, s),
                jax=(jnames, jT7, jkf, jv), port_cycles=port_cycles, jax_cycles=jcycles,
                counts=(pcount, jcount))


def test_statuses_and_keyframes_match(runs):
    """Statuses frame by frame, keyframes on the same frames, the same
    window of slots; both gated by mono_gate."""
    statuses, T7, kf, s = runs["port"]
    jnames, jT7, jkf, jv = runs["jax"]
    print(f"statuses {[x.name for x in statuses].count('GOOD')} GOOD; keyframes {kf} / {jkf}")
    assert [x.name for x in statuses] == jnames
    assert kf == jkf and len(kf) >= 3
    assert s.vo.server.kf_used == jv.server.kf_used
    assert mw.mono_gate(statuses, T7, runs["T_gt7"])[2]


def test_seeds_promoted_per_keyframe(runs):
    """Seeds promoted at each keyframe, from the state before and after the
    cycle in each package: within 1 (a seed at the edge of sigma < z_range
    / 100 may converge in one package only).  The port's counter equals
    its own count, and seeds are promoted at all."""
    pcount, jcount = runs["counts"]
    s = runs["port"][3]
    print(f"seeds promoted per keyframe: port {pcount}, JAX {jcount}; port stats "
          f"{dict(s.vo.stats)}")
    assert len(pcount) == len(jcount) == s.vo.stats["keyframes"]
    assert sum(pcount) == s.vo.stats["seeds_promoted"] > 0
    assert all(abs(a - b) <= MAX_PROMOTED_DIFF for a, b in zip(pcount, jcount))


def test_trajectories_match(runs):
    """Camera centres of the GOOD frames within 1e-2 map units of the JAX
    package's, both ATEs under 0.05 m."""
    statuses, T7, _, _ = runs["port"]
    jnames, jT7, _, _ = runs["jax"]
    T_gt7 = runs["T_gt7"]
    good = [k for k, x in enumerate(statuses) if x is tvo.Status.GOOD]
    d = np.linalg.norm(traj.camera_centers(T7[good]) - traj.camera_centers(jT7[good]), axis=1)
    ate = mw.good_ate(statuses, T7, T_gt7)
    jate = mw.good_ate([tvo.Status[n] for n in jnames], jT7, T_gt7)
    print(f"depth filter on: max camera-centre gap {d.max():.2e} map units over {len(good)} GOOD "
          f"frames; ATE port {ate:.5f} m, JAX {jate:.5f} m")
    assert d.max() <= TOL_TRAJ
    assert ate < ATE_MAX and jate < ATE_MAX


def test_kf_cycle_seed_block_matches(runs):
    """One keyframe cycle with seeds, from the port's recorded inputs (its
    state and seed table, handed across with `convert`), in both packages:
    the same slot, the same rows promoted with the same links and depths
    and landmark positions, and the same new seed table."""
    cyc = next(c for c in runs["port_cycles"] if c["kw"]["seeds"] is not None
               and bool(c["kw"]["seeds"].converged(100.0).any()))
    mstate, pyr, found, obs_px, T7, last_kf, nbr2, fid, kf_images = cyc["args"]
    seeds, seed_slot, idx = cyc["kw"]["seeds"], cyc["kw"]["seed_slot"], cyc["kw"]["seed_feat_idx"]
    F = OPTS.map_F
    st, _, new_seeds, host = cyc["out"]
    jv = runs["jax"][3]
    jseeds = jdf.Seeds(**{k: jnp.asarray(v) for k, v in convert.seeds_to_numpy(seeds).items()})
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(mstate).items()})
    jout = jv._jit_kf_cycle(
        jm, tuple(jnp.asarray(np32(lv)) for lv in pyr), jnp.asarray(np32(found)),
        jnp.asarray(np32(obs_px)), jnp.asarray(np32(T7)), jnp.asarray(last_kf, jnp.int32),
        jnp.asarray(nbr2, jnp.int32), fid, jnp.asarray(np32(kf_images)), None, None, jseeds,
        jnp.asarray(seed_slot, jnp.int32), jnp.asarray(np32(idx)))
    jst, jnew, jhost = jout[0], jout[4], jout[5]
    slot = int(host[0])
    assert slot == int(jhost[0]) and slot != seed_slot
    m_in = convert.map_state_to_numpy(mstate)
    got = convert.map_state_to_numpy(st)
    want = {k: np.asarray(v) for k, v in jst._asdict().items()}
    rows = _promoted(m_in, got, seed_slot, F, np32(idx))
    jrows = _promoted(m_in, want, seed_slot, F, np32(idx))
    print(f"keyframe cycle at frame {fid}: seeds of slot {seed_slot}, "
          f"{int(np32(seeds.valid).sum())} valid, promoted rows {len(rows)} / {len(jrows)}, "
          f"count in the host block {int(host[-1])}")
    assert len(rows) > 0 and np.array_equal(rows, jrows) and int(host[-1]) == len(rows)
    for name in ("feat_point", "feat_valid"):
        np.testing.assert_array_equal(got[name][seed_slot], want[name][seed_slot], err_msg=name)
    for name in ("pt_ref_feat", "pt_first_kf", "pt_visible", "pt_found", "pt_obs"):
        np.testing.assert_array_equal(got[name][rows], want[name][rows], err_msg=name)
    np.testing.assert_array_equal(got["pt_desc"][rows], want["pt_desc"][rows])
    np.testing.assert_allclose(got["pt_pos"][rows], want["pt_pos"][rows], atol=TOL_POS)
    np.testing.assert_allclose(got["feat_depth"][seed_slot], want["feat_depth"][seed_slot],
                               rtol=1e-6)
    # The new seeds on this keyframe's depthless detections: detections that
    # tie may come in another order (ROADMAP section 3, "Tie order"), so the
    # rows holding the same pixel must hold the same seed.
    assert bool(host[3]) == bool(jhost[3])
    a = convert.seeds_to_numpy(new_seeds)
    b = {k: np.asarray(v) for k, v in jnew._asdict().items()}
    same = (a["px"] == b["px"]).all(axis=1)
    print(f"new seeds: {int(a['valid'].sum())} / {int(b['valid'].sum())} valid, pixels equal on "
          f"{same.mean():.4f} of the rows")
    assert same.mean() >= MIN_ROWS_AGREE and a["valid"].sum() == b["valid"].sum()
    for name in ("a", "b", "z_range", "sigma2", "valid"):
        np.testing.assert_array_equal(a[name][same], b[name][same], err_msg=name)
    np.testing.assert_allclose(a["mu"], b["mu"], rtol=1e-5)


def test_seed_keyframe_is_never_evicted_or_culled():
    """On a map of 4 slots (so keyframes are evicted and culled), the seed
    keyframe is always the newest keyframe, valid, and in the used window:
    the victim of an eviction excludes the newest slot, and culling
    protects it."""
    cam, frames, _ = mw.make_mono_workload(N_FRAMES, device="cpu", shape=SHAPE, du=DU)
    s = System(camera=cam, options=mw.mono_options(use_depth_filter=True, map_K=4), device="cpu")
    checked = 0
    for k in range(N_FRAMES):
        n_kf = s.vo.stats["keyframes"]
        s.track_monocular(frames[k], float(k))
        vo = s.vo
        if vo.seed_kf_slot >= 0:
            assert vo.seed_kf_slot == vo.last_kf_slot == vo.server.kf_used[-1]
            assert bool(vo.server.state.kf_valid[vo.seed_kf_slot])
            checked += vo.stats["keyframes"] > n_kf
    print(f"map K=4: {dict(s.vo.stats)}; keyframes checked {checked}")
    assert checked == s.vo.stats["keyframes"] >= 3
    assert s.vo.stats["evictions"] + s.vo.stats["keyframes_culled"] >= 1
