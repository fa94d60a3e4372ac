"""The monocular System on a non-planar world, the port against the JAX
package, both on the CPU: tests/test_nonplanar.py's TwoPlaneScene run (40
frames 240x320, a near plane occluding a far one) through
`System.track_monocular` in the port and the JAX `VisualOdometry`, both in
the port's configuration (no vocabulary, depth filter, archive or async
mapping) with test_vo's keyframe gates.  Both get the port's rendered
frames, and the port's RANSAC sampler is handed the JAX package's draw, as
in test_torch_mono_vo.py.

Initialisation must take the F/E model in both (the world is far from one
plane), the statuses must be equal frame by frame, and each ATE must be
under test_nonplanar's 0.06 m."""
import pytest
import torch

from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import nonplanar_workload as nw
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system.system import System

from _torch_port import jax_mono_run, jax_ransac_indices, jax_vo_options

torch.set_num_threads(1)

N_FRAMES = nw.TWO_PLANE_FRAMES
ATE_MAX = 0.06                     # tests/test_nonplanar.py


@pytest.fixture(scope="module")
def runs():
    cam, frames, T_gt7 = nw.two_plane_workload(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        s = System(camera=cam, options=mw.mono_options(), device="cpu")
        statuses, T7, _ = mw.run_mono(s, frames)
    jnames, jT7, _, jv = jax_mono_run(cam, frames, jax_vo_options(mw.mono_options()))
    return dict(port=(statuses, T7, s), jax=(jnames, jT7, jv), T_gt7=T_gt7)


def test_both_initialise_with_f(runs):
    _, _, s = runs["port"]
    _, _, jv = runs["jax"]
    print(f"port {dict(s.vo.stats)}; JAX {dict(jv.stats)}")
    for stats in (s.vo.stats, jv.stats):
        assert stats["init_model_f"] >= 1 and stats["init_model_h"] == 0, dict(stats)
    assert s.vo.init_used_h is False and jv.init_used_h is False


def test_statuses_match_frame_by_frame(runs):
    statuses, _, _ = runs["port"]
    jnames, _, _ = runs["jax"]
    assert [x.name for x in statuses] == jnames
    assert statuses[-1] is tvo.Status.GOOD, "lost on the depth discontinuity"
    assert sum(x is tvo.Status.GOOD for x in statuses) > N_FRAMES * 0.5


def test_ate_under_bound(runs):
    statuses, T7, s = runs["port"]
    jnames, jT7, _ = runs["jax"]
    ate = mw.good_ate(statuses, T7, runs["T_gt7"])
    jate = mw.good_ate([tvo.Status[n] for n in jnames], jT7, runs["T_gt7"])
    print(f"non-planar ATE: port {ate!r} m, JAX {jate!r} m; port map "
          f"{int(s.vo.server.state.pt_valid.sum())} valid landmarks, "
          f"{s.vo.stats['keyframes']} keyframes")
    assert ate < ATE_MAX and jate < ATE_MAX
