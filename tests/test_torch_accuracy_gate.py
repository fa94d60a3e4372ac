"""The accuracy gate on the benchmark world, in both packages on the CPU:
tests/test_accuracy_gate.py's 150-frame prefix of bench_accuracy.py's
BoxScene loop (horizon 2000, face-out, vignette 0.25 with its gain and
bias drift, 240x320) through the port's `System.track_monocular` and the
JAX `VisualOdometry`, both with bench_accuracy.py's options in the port's
configuration (no vocabulary, depth filter, archive or async mapping).
Both get the port's rendered frames.

In the port's configuration this loop starves the map: without the depth
filter, the keyframes past frame ~80 triangulate almost nothing, and
inliers decay until tracking is lost near frame 110 (ROADMAP section 3).
Each package has two routes for sparse-direct alignment: on the CPU the
JAX package runs full Gauss-Newton per level (`gauss_newton`, the Hessian
rebuilt every iteration); its TPU route, and the port's default, is
FUSED_VARIANT 3 (K3: every level in one launch, the Hessian frozen at
each level's init pose).

- The port's default route against the JAX package's CPU route, gated
  over the first SPAN frames (test_accuracy_gate's gates there: GOOD on
  every frame after init, Sim(3)-aligned ATE under 0.10 m; the port's ATE
  at most 1.5x the JAX run's); the whole prefix is printed.
- The frozen-Hessian route in both (the JAX package's TPU kernels run
  interpreted): the same init, GOOD in both through frame 100, and where
  one loses track the other loses it within 10 frames.
- With the depth filter on (`box_options(use_depth_filter=True)`), the
  keyframes' depthless detections become landmarks as their seeds
  converge and the map holds: over the whole prefix, in the port's default
  route and the JAX package's CPU route, no LOST frame, no reset and an ATE
  under 0.05 m, the port's at most 1.5x the JAX run's."""
import pytest
import torch

from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import nonplanar_workload as nw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.ops import sparse_align
from ygz_slam_tpu_torch.system.system import System

from _torch_port import jax_kernels_interpreted, jax_mono_run, jax_vo_options

pytestmark = pytest.mark.slow          # 150-frame runs of both packages, minutes on the CPU

torch.set_num_threads(1)

N_FRAMES = 150
SPAN = 80                              # the gated span: frames before the map starves
GOOD_THROUGH = 100                     # frozen-Hessian route: GOOD in both up to here
LOSS_WITHIN = 10                       # ... and lost within this many frames of each other
DF_ATE_MAX = 0.05                      # the depth filter on: ATE over the whole prefix


@pytest.fixture(scope="module")
def workload():
    return nw.box_workload(N_FRAMES, device="cpu")


def _port_run(workload, variant, monkeypatch, **opts):
    cam, frames, T_gt7 = workload
    monkeypatch.setattr(sparse_align, "FUSED_VARIANT", variant)
    s = System(camera=cam, options=nw.box_options(**opts), device="cpu")
    statuses, T7, _ = mw.run_mono(s, frames)
    return statuses, T7, s


def _summary(statuses, T7, T_gt7) -> dict:
    return dict(frac_good=statuses.count(tvo.Status.GOOD) / len(statuses),
                segments=nw.segments(statuses), ate=mw.good_ate(statuses, T7, T_gt7),
                first_lost=(statuses.index(tvo.Status.LOST) if tvo.Status.LOST in statuses
                            else None))


def test_box_loop_prefix_ate(workload, monkeypatch):
    """The port's default route against the JAX package's CPU route: both
    GOOD on every frame from init to frame SPAN - 1, ATE over those frames
    under 0.10 m in both, the port's at most 1.5x the JAX run's."""
    cam, frames, T_gt7 = workload
    statuses, T7, s = _port_run(workload, 3, monkeypatch)
    jnames, jT7, _, jv = jax_mono_run(cam, frames, jax_vo_options(nw.box_options()))
    jstatuses = [tvo.Status[n] for n in jnames]
    res = {"port": _summary(statuses, T7, T_gt7), "jax": _summary(jstatuses, jT7, T_gt7)}
    span = {name: mw.good_ate(st[:SPAN], P[:SPAN], T_gt7[:SPAN])
            for name, st, P in (("port", statuses, T7), ("jax", jstatuses, jT7))}
    print(f"BoxScene prefix: ATE over frames 0-{SPAN - 1} {span}; whole prefix {res}; port "
          f"stats {dict(s.vo.stats)}; JAX stats {dict(jv.stats)}")
    k0 = mw.init_frame(statuses)
    assert k0 == mw.init_frame(jstatuses)
    for st in (statuses, jstatuses):
        assert all(x is tvo.Status.GOOD for x in st[k0:SPAN])
    assert span["port"] < 0.10 and span["jax"] < 0.10
    assert span["port"] <= 1.5 * span["jax"], span


def test_box_loop_prefix_frozen_hessian_route(workload, monkeypatch):
    """The port's default route (K3) against the JAX package's TPU route
    (its kernels interpreted) on the same frames: the same init frame and
    model, both GOOD through frame 100, and a loss of track in one within
    10 frames of a loss in the other."""
    cam, frames, T_gt7 = workload
    statuses, T7, s = _port_run(workload, 3, monkeypatch)
    with jax_kernels_interpreted():
        jnames, jT7, _, jv = jax_mono_run(cam, frames, jax_vo_options(nw.box_options()))
    jstatuses = [tvo.Status[n] for n in jnames]
    res = {"port": _summary(statuses, T7, T_gt7), "jax": _summary(jstatuses, jT7, T_gt7)}
    print(f"BoxScene prefix, frozen-Hessian route: {res}")
    k0 = mw.init_frame(statuses)
    assert k0 == mw.init_frame(jstatuses) and s.vo.init_used_h == jv.init_used_h
    for st in (statuses, jstatuses):
        assert all(x is tvo.Status.GOOD for x in st[k0:GOOD_THROUGH + 1])
    a, b = res["port"]["first_lost"], res["jax"]["first_lost"]
    assert (a is None) == (b is None) and (a is None or abs(a - b) <= LOSS_WITHIN), res


def test_box_loop_prefix_with_depth_filter(workload, monkeypatch):
    """The depth filter on, the port's default route against the JAX
    package's CPU route over the whole 150-frame prefix: no LOST frame, one
    segment, ATE under 0.05 m in both, the port's at most 1.5x the JAX
    run's, and seeds promoted in the port."""
    cam, frames, T_gt7 = workload
    statuses, T7, s = _port_run(workload, 3, monkeypatch, use_depth_filter=True)
    jnames, jT7, _, jv = jax_mono_run(cam, frames,
                                      jax_vo_options(nw.box_options(use_depth_filter=True)))
    jstatuses = [tvo.Status[n] for n in jnames]
    res = {"port": _summary(statuses, T7, T_gt7), "jax": _summary(jstatuses, jT7, T_gt7)}
    print(f"BoxScene prefix with the depth filter: {res}; port stats {dict(s.vo.stats)}, "
          f"{int(s.vo.server.state.pt_valid.sum())} valid landmarks; JAX stats {dict(jv.stats)}, "
          f"{int(jv.server.state.pt_valid.sum())} valid landmarks")
    for r in res.values():
        assert r["first_lost"] is None and r["segments"] == 1 and r["ate"] < DF_ATE_MAX, res
    assert res["port"]["ate"] <= 1.5 * res["jax"]["ate"], res
    assert s.vo.stats["seeds_promoted"] > 0
