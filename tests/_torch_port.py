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
compare several."""
import contextlib
import functools

import numpy as np
import pytest
import torch


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
    both define, with the port's values."""
    import dataclasses

    from ygz_slam_tpu.models import visual_odometry as jvo

    names = {f.name for f in dataclasses.fields(jvo.VOOptions)}
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)
            if f.name in names and f.name != "vo_type"}


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


if __name__ == "__main__":
    import json
    import os
    import sys
    import time

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
