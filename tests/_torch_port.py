"""Helpers shared by the parity tests of the PyTorch port
(tests/test_torch_*.py): the JAX package run as its own kernel tests run
it on the CPU, and inputs passed between the packages as numpy arrays.

    JAX_PLATFORMS=cpu python tests/_torch_port.py

runs the JAX package's VisualOdometry on the CPU over the port's monocular
workload (models/mono_workload.py, 640x480, 160 frames) and prints its
init frame, model, keyframes and ATE: the reference of that workload's
gate.

    JAX_PLATFORMS=cpu python tests/_torch_port.py box PACKAGE H W N THREADS

runs bench_accuracy's BoxScene (`nonplanar_workload.box_workload`, N
frames at HxW) with the depth filter on (`box_df_options`) through the
port's System ("port"), the JAX VisualOdometry's CPU route ("jax") or its
TPU kernels interpreted ("jax-interpreted"), on THREADS torch threads, and
prints one JSON line: the ATE over the run and over its first n frames,
the GOOD share, the first LOST frame, segments, valid landmark rows every
40 frames, seeds promoted per keyframe (port) and the stats.  A run's
outcome moves with float32 rounding (the thread count changes it), so
compare several.

    JAX_PLATFORMS=cpu python tests/_torch_port.py frontend PACKAGE VO MAP [THREADS]

runs chip_smoke.py's path 13 (`VOOptions()` with only the frontend VO,
e.g. sparse_orb, and the map type MAP changed, over the 640x480 monocular
workload) through the JAX ("jax") or the port's ("port") VisualOdometry on
the CPU and prints one JSON line: the GOOD share, the ATE over the GOOD
frames, keyframes, the exported cloud and the landmarks, and for a
gradient-pixel set its seeds' depth spread on the plane: the reference of
path 13's gates."""
import contextlib
import functools
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def jax_kernels_interpreted():
    """Dispatch the JAX package to its Pallas kernels, run in interpret
    mode (tests/test_pallas_kernels.py: pallas_call(interpret=True) and
    align2d_kernel.on_tpu forced)."""
    from jax.experimental import pallas as pl
    from ygz_slam_tpu.ops.pallas import align2d_kernel as ak

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(ak, "on_tpu", lambda: True)
        yield


def zero_padded_stack(levels) -> torch.Tensor:
    """The zero-padded [levels, H, W] stack of a pyramid, on its device, as
    the JAX package's frontend builds it (ygz_slam_tpu/models/frontend.py)."""
    H, W = levels[0].shape
    stack = torch.zeros((len(levels), H, W), dtype=levels[0].dtype, device=levels[0].device)
    for l, img in enumerate(levels):
        stack[l, :img.shape[0], :img.shape[1]] = img
    return stack


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def jax_camera(cam):
    """The JAX PinholeCamera of a port camera."""
    from ygz_slam_tpu.geometry import PinholeCamera

    return PinholeCamera.create(*cam)


def workload(n_frames, n_points=200):
    """The port's tracking workload on the CPU (the same seeds as
    _bench_common.make_workload)."""
    from ygz_slam_tpu_torch.models import tracking as tr

    return tr.make_workload(n_frames, device="cpu", n_points=n_points)


def jax_prep_from_port(ref_prep):
    """A JAX ReferencePrep (lane packs included) holding the port's
    reference data, for JAX-side runs that skip the interpreted prep."""
    import jax.numpy as jnp
    from ygz_slam_tpu.ops import sparse_align as jsa
    from ygz_slam_tpu.ops.pallas import sparse_align_fused as sf

    levels = []
    for lr in ref_prep.levels:
        rp, J = jnp.asarray(np32(lr.ref_patch)), jnp.asarray(np32(lr.J))
        levels.append(jsa.LevelRef(vis=jnp.asarray(np32(lr.vis)), ref_patch=rp, J=J,
                                   refp_lanes=sf.pack_patch_lanes(rp),
                                   jlanes=sf.pack_jacobian_lanes(J)))
    return jsa.ReferencePrep(
        p_ref=jnp.asarray(np32(ref_prep.p_ref)), levels=tuple(levels),
        mega_refp=jnp.concatenate([lv.refp_lanes for lv in levels], axis=1),
        mega_jl=jnp.concatenate([lv.jlanes for lv in levels], axis=1))


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernel-versus-plain tests run only where the
    kernels can launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def jax_mono_run(cam, frames, opts: dict, on_frame=None, jv=None):
    """The JAX package's VisualOdometry on the CPU over `frames` ([n, H, W]
    numpy or tensor) with VOOptions(**opts), or `jv` if given; `on_frame(k,
    jv)`, if given, is called after each frame.  Returns (status names [n],
    tracked params7 [n, 7], frame indices where a keyframe was inserted,
    the VisualOdometry)."""
    from ygz_slam_tpu.models import visual_odometry as jvo

    if jv is None:
        jv = jvo.VisualOdometry(jax_camera(cam), jvo.VOOptions(**opts))
    names, kf_frames = [], []
    for k in range(len(frames)):
        n_kf = jv.stats["keyframes"]
        r = jv.add_frame(np32(frames[k]), float(k))
        names.append(r.status.name)
        if jv.stats["keyframes"] > n_kf:
            kf_frames.append(k)
        if on_frame is not None:
            on_frame(k, jv)
    return names, np.stack([p for _, p in jv.trajectory]), kf_frames, jv


def jax_ransac_indices(mask, seed: int, n_hypotheses: int = 200) -> np.ndarray:
    """The [n_hypotheses, 8] indices the JAX package's `ransac_hf` draws
    from `jax.random.key(seed)` on `mask` [N] (initializer.py:166-171)."""
    import jax
    import jax.numpy as jnp

    p = jnp.asarray(np32(mask), jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    keys = jax.random.split(jax.random.key(seed), n_hypotheses)
    n = p.shape[0]
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(8,), replace=False, p=p))(keys))


def jax_pnp_draws(mask, cand, n_hyp: int = 256, key: int = 17) -> torch.Tensor:
    """The [C, n_hyp, 3] P3P triples the JAX package's `relocalize` draws
    for candidate keyframes `cand [C]` on their match masks `mask [C, N]`
    (`ransac_pnp`'s categorical under `fold_in(PRNGKey(key), kf)`,
    relocalization.py:115-118; `relocalize_archive` draws under key 23 with
    archive rows for `cand`), on mask's device."""
    import jax
    import jax.numpy as jnp

    base = key
    out = []
    for m, kf in zip(np32(mask), np32(cand)):
        key = jax.random.fold_in(jax.random.PRNGKey(base), int(kf))
        logits = jnp.where(jnp.asarray(m), 0.0, -1e9)
        out.append(np.asarray(jax.random.categorical(
            key, logits[None, :].repeat(n_hyp * 3, 0)).reshape(n_hyp, 3)))
    return torch.tensor(np.stack(out), dtype=torch.long, device=mask.device)


def jax_vo_options(opts) -> dict:
    """The JAX VOOptions keyword arguments of a port VOOptions: the fields
    both define, with the port's values (an enum as the JAX package's member
    of the same name)."""
    import dataclasses
    import enum

    from ygz_slam_tpu.models import visual_odometry as jvo

    def jax_value(v):
        return getattr(jvo, type(v).__name__)[v.name] if isinstance(v, enum.Enum) else v

    names = {f.name for f in dataclasses.fields(jvo.VOOptions)}
    return {f.name: jax_value(getattr(opts, f.name)) for f in dataclasses.fields(opts)
            if f.name in names}


# -- the depth-sensor VO runs (tests/test_torch_sensors.py, test_torch_stereo.py) --

SENSOR_MIN_COINCIDE = 0.95   # start features at the same pixel (Shi-Tomasi's float32 noise)
SENSOR_TOL_PX = 1e-3         # px: "the same pixel"
SENSOR_TOL_POS = 1e-5        # start landmarks and feature depths, metres
SENSOR_TOL_TRAJ = 1e-2       # camera centres, metres (test_torch_mono_vo.py's bound)
SENSOR_ATE_MAX = 0.03        # tests/test_system.py, tests/test_stereo.py: rigid ATE, metres


def _sensor_options():
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    return (tvo.VOOptions(kf_min_frames=5, kf_max_trans=0.05, use_vocabulary=False,
                          archive_map=False, loop_closing=False, async_mapping=False),
            tvo.VOOptions(kf_min_frames=5, kf_max_trans=0.05))


# The parity runs' options (the port's configuration: no vocabulary, archive
# or async mapping) and the JAX sensor tests' own (the defaults, faster keyframes).
SENSOR_PARITY_OPTS, SENSOR_GATE_OPTS = _sensor_options()


def sensor_runs(cam, frames, kw_of, opts):
    """The port's and the JAX package's VisualOdometry on the CPU over
    `frames`, each frame's keyword arguments from kw_of(frame) (numpy for
    the JAX side): for each, (status names, params7 per frame, keyframe
    frames, the map after frame 0 as numpy, the VO)."""
    from ygz_slam_tpu.models import visual_odometry as jvo
    from ygz_slam_tpu_torch import convert
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    out = {}
    for name in ("port", "jax"):
        vo = (tvo.VisualOdometry(cam, opts, device="cpu") if name == "port"
              else jvo.VisualOdometry(jax_camera(cam), jvo.VOOptions(**jax_vo_options(opts))))
        names, kfs, m0 = [], [], None
        for k, f in enumerate(frames):
            n_kf = vo.stats["keyframes"]
            kw = kw_of(f)
            if name == "jax":
                kw = {key: np32(v) for key, v in kw.items()}
            r = vo.add_frame(timestamp=float(k), **kw)
            names.append(r.status.name)
            if vo.stats["keyframes"] > n_kf:
                kfs.append(k)
            if k == 0:
                m0 = (convert.map_state_to_numpy(vo.server.state) if name == "port"
                      else {f_: np.asarray(v) for f_, v in vo.server.state._asdict().items()})
        out[name] = (names, np.stack([np32(p) for _, p in vo.trajectory]), kfs, m0, vo)
    return out


def compare_sensor_start(m_port: dict, m_jax: dict, label: str) -> None:
    """Keyframe 0's features coincide by pixel on >= SENSOR_MIN_COINCIDE,
    with the same sensor decision, and depth and landmark within
    SENSOR_TOL_POS where they do."""
    keys = ("feat_px", "feat_valid", "feat_depth", "feat_point")
    fp, fj = {k: m_port[k][0] for k in keys}, {k: m_jax[k][0] for k in keys}
    ip, ij = np.where(fp["feat_valid"])[0], np.where(fj["feat_valid"])[0]
    d = np.abs(fp["feat_px"][ip][:, None] - fj["feat_px"][ij][None]).max(-1)
    pairs = [(a, ij[b]) for a, b, h in zip(ip, d.argmin(1), d.min(1) <= SENSOR_TOL_PX) if h]
    share = len(pairs) / max(len(ip), len(ij))
    same_ok = np.mean([(fp["feat_point"][a] >= 0) == (fj["feat_point"][b] >= 0) for a, b in pairs])
    both = [(a, b) for a, b in pairs if fp["feat_point"][a] >= 0 and fj["feat_point"][b] >= 0]
    d_depth = max(abs(fp["feat_depth"][a] - fj["feat_depth"][b]) for a, b in both)
    d_pos = max(np.abs(m_port["pt_pos"][fp["feat_point"][a]]
                       - m_jax["pt_pos"][fj["feat_point"][b]]).max() for a, b in both)
    print(f"{label} start: {len(ip)} port / {len(ij)} JAX features, {share:.4f} coincide by "
          f"pixel, the sensor decision equal on {same_ok:.4f} of them; {len(both)} landmarks in "
          f"both: depth within {d_depth:.3e}, position within {d_pos:.3e} m (tolerance "
          f"{SENSOR_TOL_POS})")
    assert share >= SENSOR_MIN_COINCIDE and same_ok >= SENSOR_MIN_COINCIDE
    assert d_depth <= SENSOR_TOL_POS and d_pos <= SENSOR_TOL_POS
    assert int(m_port["pt_valid"].sum()) == int((fp["feat_point"] >= 0).sum())


def compare_sensor_run(runs: dict, label: str) -> None:
    """Statuses and keyframe frames equal (at least one keyframe), camera
    centres within SENSOR_TOL_TRAJ."""
    from ygz_slam_tpu_torch.system import trajectory as traj

    (n_p, T_p, kf_p, _, _), (n_j, T_j, kf_j, _, _) = runs["port"], runs["jax"]
    d = float(np.abs(traj.camera_centers(T_p) - traj.camera_centers(T_j)).max())
    print(f"{label}: statuses {''.join(x[0] for x in n_p)} (JAX {''.join(x[0] for x in n_j)}), "
          f"keyframes at {kf_p} (JAX {kf_j}), camera centres within {d:.3e} m "
          f"(tolerance {SENSOR_TOL_TRAJ})")
    assert n_p == n_j and kf_p == kf_j and len(kf_p) >= 1
    assert d <= SENSOR_TOL_TRAJ


def sensor_gate(results, gt_poses, n_min: int, label: str) -> None:
    """At least n_min GOOD frames and a rigid ATE < SENSOR_ATE_MAX over them."""
    from ygz_slam_tpu_torch.models.visual_odometry import Status
    from ygz_slam_tpu_torch.system import trajectory as traj

    good = [k for k, r in enumerate(results) if r.status is Status.GOOD]
    est = traj.camera_centers([results[k].T_cw for k in good])
    ate = traj.ate_rmse(est, traj.camera_centers([gt_poses[k] for k in good]), with_scale=False)
    print(f"{label}: {len(good)} of {len(results)} GOOD (>= {n_min}), rigid ATE {ate:.5f} m "
          f"(< {SENSOR_ATE_MAX})")
    assert len(good) >= n_min and ate < SENSOR_ATE_MAX


def box_depth_filter_run(package: str, shape, n: int) -> dict:
    """BoxScene with the depth filter through one package on the CPU: the
    outcome of the run as a dict (see the module docstring)."""
    import contextlib
    import time

    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import nonplanar_workload as nw
    from ygz_slam_tpu_torch.models.visual_odometry import Status

    cam, frames, T_gt7 = nw.box_workload(n, device="cpu", shape=tuple(shape))
    opts = nw.box_df_options()
    rows, promoted, last = {}, [], {"kf": 0, "promoted": 0}
    t0 = time.perf_counter()
    if package == "port":
        from ygz_slam_tpu_torch.system.system import System

        s = System(camera=cam, options=opts, device="cpu")

        def on_frame(k, r):
            stats = s.vo.stats
            if stats["keyframes"] > last["kf"]:
                promoted.append(stats["seeds_promoted"] - last["promoted"])
                last.update(kf=stats["keyframes"], promoted=stats["seeds_promoted"])
            if (k + 1) % 40 == 0:
                rows[k] = int(s.vo.server.state.pt_valid.sum())

        statuses, T7, _ = mw.run_mono(s, frames, on_frame)
        stats = s.vo.stats
    else:
        def on_frame(k, jv):
            if (k + 1) % 40 == 0:
                rows[k] = int(np.asarray(jv.server.state.pt_valid).sum())

        ctx = (jax_kernels_interpreted() if package == "jax-interpreted"
               else contextlib.nullcontext())
        with ctx:
            names, T7, _, jv = jax_mono_run(cam, frames, jax_vo_options(opts), on_frame=on_frame)
        statuses = [Status[x] for x in names]
        stats = jv.stats
    spans = [m for m in (100, 160, 200, 240, 280, 320, 360, 400) if m <= n]
    return dict(package=package, shape=list(shape), frames=n,
                wall_s=time.perf_counter() - t0, ate=mw.good_ate(statuses, T7, T_gt7),
                ate_first=[(m, mw.good_ate(statuses[:m], T7[:m], T_gt7[:m])) for m in spans],
                good=statuses.count(Status.GOOD) / n,
                first_lost=statuses.index(Status.LOST) if Status.LOST in statuses else None,
                segments=nw.segments(statuses), rows=rows, promoted=promoted,
                stats={k: int(v) for k, v in stats.items()})


def frontend_run(package: str, vo_name: str, map_name: str) -> dict:
    """chip_smoke.py's path 13 on the CPU: `VOOptions()` with only the
    frontend and the map type changed, over the monocular workload
    (models/mono_workload.py, 640x480, 160 frames), through the JAX
    VisualOdometry ("jax") or the port's ("port").  Returns the run's
    outcome (`mono_workload.frontend_report`) with its wall seconds."""
    import time

    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import visual_odometry as tvo

    cam, frames, T_gt7 = mw.make_mono_workload(device="cpu")
    opts = mw.frontend_options(tvo.VOType[vo_name.upper()], tvo.MapType[map_name.upper()])
    t0 = time.perf_counter()
    if package == "port":
        vo = tvo.VisualOdometry(cam, opts, device="cpu")
        names = [vo.add_frame(frames[k], float(k)).status.name for k in range(len(frames))]
        T7 = np.stack([p for _, p in vo.trajectory])
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        names, T7, _, vo = jax_mono_run(cam, frames, jax_vo_options(opts))
    wall = time.perf_counter() - t0
    sd = None if vo.sd is None else (np32(vo.sd.px), np32(vo.sd.usable()),
                                     np32(vo.sd.depths()), int(vo.sd.kf_slot))
    out = mw.frontend_report(names, T7, T_gt7, vo.export_point_cloud(),
                             int(np32(vo.server.state.pt_valid).sum()), dict(vo.stats), sd,
                             np32(vo.server.state.kf_id), cam)
    return dict(out, package=package, wall_s=wall)


if __name__ == "__main__":
    import json
    import time

    if sys.argv[1:2] == ["frontend"]:
        torch.set_num_threads(int(sys.argv[5]) if len(sys.argv) > 5 else 1)
        print(json.dumps(frontend_run(sys.argv[2], sys.argv[3], sys.argv[4])))
        sys.exit(0)
    if sys.argv[1:2] == ["box"]:
        package, H, W, n, threads = sys.argv[2], *map(int, sys.argv[3:7])
        torch.set_num_threads(threads)
        if package != "port":
            import jax

            jax.config.update("jax_platforms", "cpu")
        out = box_depth_filter_run(package, (H, W), n)
        print(json.dumps(dict(out, threads=threads)))
        sys.exit(0)

    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models.visual_odometry import Status

    cam, frames, T_gt7 = mw.make_mono_workload(device="cpu")
    t0 = time.perf_counter()
    names, T7, kf_frames, jv = jax_mono_run(cam, frames, jax_vo_options(mw.mono_options()))
    statuses = [Status[n] for n in names]
    k0, ate, ok = mw.mono_gate(statuses, T7, T_gt7)
    print(f"JAX VisualOdometry, CPU, {len(names)} frames 640x480 in "
          f"{time.perf_counter() - t0:.1f} s: init frame {k0} "
          f"(model {'H' if jv.init_used_h else 'F'}), {len(kf_frames)} keyframes at {kf_frames}, "
          f"{names.count('LOST')} LOST, ATE {ate!r} m, final valid landmarks "
          f"{int(np.asarray(jv.server.state.pt_valid).sum())}, stats {dict(jv.stats)}")
