"""The archive loops in the port's VisualOdometry, the port alone on the
CPU, with the default VOOptions (the depth filter, the vocabulary,
relocalization, the archive, loop closing against the window and the
archive, the Sim(3) global pose graph, async mapping) and tests/test_archive.py's
ARC_OPTS: the ports of test_archive.py's
`test_out_and_back_closes_global_loop` and
`test_loop_correction_improves_or_keeps_consistency` on its out-and-back
sweep (`archive_workload.out_and_back_frames`, 110 frames 240x320,
PlaneScene seeds 3 and 7), and of test_map_merge.py's
`test_reset_then_revisit_merges_epochs` (`archive_workload.reset_and_revisit`),
each with the JAX test's gates (`archive_workload.out_and_back_gates`)."""
import torch

from ygz_slam_tpu_torch.models import archive_workload as aw
from ygz_slam_tpu_torch.models import visual_odometry as tvo

torch.set_num_threads(1)

SHAPE = (240, 320)


def out_and_back(seed: int) -> dict:
    cam, frames, T_gt7 = aw.out_and_back_frames(SHAPE, seed=seed, device="cpu")
    vo = tvo.VisualOdometry(cam, aw.loop_options(), device="cpu")
    for k in range(frames.shape[0]):
        vo.add_frame(frames[k], float(k))
    g = aw.out_and_back_gates(vo, T_gt7)
    print(f"seed {seed}: {g}; stats {dict(vo.stats)}")
    return g


def test_out_and_back_closes_global_loop():
    """The camera leaves, more keyframes than the window holds pass, it
    returns: a loop closes against an archived keyframe and the corrected
    trajectory's Sim(3)-aligned ATE stays below 0.10."""
    g = out_and_back(3)
    assert g["archived"] > aw.ARC_OPTS["map_K"], g
    assert g["closed"] >= 1, g
    assert g["ate"] < 0.10, g


def test_loop_correction_improves_or_keeps_consistency():
    """After the return the corrected end pose is near the start pose (the
    gap below 0.35 of the span); a loop either closed or, declined by the
    significance gate, was verified as a confirmation."""
    g = out_and_back(7)
    if g["closed"] == 0:
        assert g["confirmed"] >= 1, g
    assert g["gap"] < 0.35 * max(g["span"], 1e-6), g


def test_reset_then_revisit_merges_epochs():
    """After a reset the young map re-initialises in a fresh frame and scale;
    its keyframe loop against an epoch-0 archived keyframe merges it back
    (epoch 0 again), and the last pose agrees with epoch 0's at the same
    view."""
    cam, frames, _ = aw.merge_frames(SHAPE, device="cpu")
    vo = tvo.VisualOdometry(cam, aw.merge_options(), device="cpu")
    out = aw.reset_and_revisit(vo, frames)
    print(f"after the reset {out['after_reset']}; merged {out['merged']}, last pose "
          f"{out['dt']:.4f} map units and {out['ang']:.4f} rad from epoch 0's; {dict(vo.stats)}")
    assert out["good0"]
    assert out["after_reset"]["epoch"] == 1 and out["after_reset"]["rows"] >= 3
    assert out["after_reset"]["epochs"] == [0]
    assert vo.stats["maps_merged"] >= 1 and vo.epoch == 0
    assert out["statuses"][-1] is tvo.Status.GOOD
    assert out["dt"] < 0.12 and out["ang"] < 0.1, out
