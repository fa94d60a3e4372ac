"""Helpers shared by the parity tests of the PyTorch port
(tests/test_torch_*.py): the JAX package run as its own kernel tests run
it on the CPU, and inputs passed between the packages as numpy arrays.

    JAX_PLATFORMS=cpu python tests/_torch_port.py

runs the JAX package's VisualOdometry on the CPU over the port's monocular
workload (models/mono_workload.py, 640x480, 160 frames) and prints its
init frame, model, keyframes and ATE: the reference of that workload's
gate."""
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


def jax_vo_options(opts) -> dict:
    """The JAX VOOptions keyword arguments of a port VOOptions: the fields
    both define, with the port's values."""
    import dataclasses

    from ygz_slam_tpu.models import visual_odometry as jvo

    names = {f.name for f in dataclasses.fields(jvo.VOOptions)}
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)
            if f.name in names and f.name != "vo_type"}


if __name__ == "__main__":
    import time

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
