"""The relocalization workload: the monocular System (models/mono_workload.py)
with the vocabulary on, blacked out and brought back to a place it mapped.

- `blackout_revisit`: `n_pre` frames of the PlaneScene sweep, `n_noise`
  frames of uniform noise (the sensor blacked out: tracking is lost), then
  the view of the oldest keyframe still in the window again (the map's
  first keyframe, which culling never retires, far from where tracking was
  lost, so the lost-frame retry cannot recover it) and the `n_after` frames
  that followed it.  Only relocalization can recover: the motion model is
  useless after the jump.
- `kidnapped_pose`: tests/test_relocalization.py's kidnapped camera on this
  world, an upside-down (roll 180 deg) view of a mapped region from beside
  a keyframe, more than 170 deg from every stored keyframe pose; only a
  P3P-RANSAC seed computed from the matches recovers it.

`reloc_options` are mono_workload's options with the vocabulary on and the
parts the port does not run yet off (loop closing, archive, async mapping).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..geometry.se3 import SE3
from ..utils.synthetic import PlaneScene
from .mono_workload import mono_options
from .visual_odometry import Status, VOOptions

N_PRE = 60           # frames tracked before the blackout
N_NOISE = 4          # noise frames
N_AFTER = 20         # frames after the revisited view, all GOOD
TOL_REVISIT = 5e-2   # recovered pose against the revisited keyframe's, map units
TOL_KIDNAP = 5e-2    # tests/test_relocalization.py: P3P-seeded pose error, map units
KIDNAP_OFFSET = (0.08, -0.05, 0.1)   # the kidnapped camera beside a keyframe, world units


def reloc_options(**overrides) -> VOOptions:
    """mono_workload's options with the vocabulary on, loop closing off."""
    return mono_options(**{**dict(use_vocabulary=True, loop_closing=False), **overrides})


def noise_frames(n: int, shape, device=None) -> torch.Tensor:
    """[n, H, W] frames of uniform noise in [0, 255), drawn with numpy from
    seed 0 (the same frames on every device)."""
    rng = np.random.default_rng(0)
    return torch.tensor(rng.uniform(0, 255, (n,) + tuple(shape)), dtype=torch.float32,
                        device=device)


def blackout_revisit(system, frames, n_pre: int = N_PRE, n_noise: int = N_NOISE,
                     n_after: int = N_AFTER) -> dict:
    """Drive `system` (a System or its VisualOdometry's owner) through the
    blackout and revisit of `frames` (mono_workload's, at least n_pre; the
    revisited frame and the n_after after it must exist).  Returns the run
    and its gates:

    statuses, T7 [n, 7] as tracked, fed (the source frame index of each fed
    frame, -1 for noise), revisit_slot / revisit_fid (the keyframe whose view
    comes back), reloc_frame (the first GOOD frame after the noise, or None),
    reloc_error (its pose against the keyframe's stored pose, map units),
    and the gates: noise_lost (every noise frame after the first LOST; the
    first may be tracked through on the inlier hysteresis), relocalized (the
    first revisit frame GOOD through relocalization, no reset), near
    (reloc_error < TOL_REVISIT), after_good (the n_after frames GOOD), ok
    (all four)."""
    vo = system.vo
    statuses, fed = [], []

    def feed(img, src):
        r = system.track_monocular(img, float(len(statuses)))
        statuses.append(r.status)
        fed.append(src)
        return r

    for k in range(n_pre):
        feed(frames[k], k)
    slot = vo.server.kf_used[0]
    fid = int(vo.server.state.kf_id[slot])
    kf_pose = SE3.from_params7(vo.server.state.kf_pose7[slot].clone())
    for img in noise_frames(n_noise, tuple(frames.shape[1:]), device=frames.device):
        feed(img, -1)
    relocs0 = vo.stats["relocalizations"]
    r = feed(frames[fid], fid)
    k_rev = len(statuses) - 1
    reloc_error = (float(se3.distance(r.T_cw, kf_pose)) if r.status is Status.GOOD
                   else float("inf"))
    relocalized = (r.status is Status.GOOD and vo.stats["relocalizations"] == relocs0 + 1)
    for k in range(fid + 1, fid + 1 + n_after):
        feed(frames[k], k)
    noise = statuses[n_pre:n_pre + n_noise]
    after = statuses[k_rev + 1:]
    ever_reset = any(a in (Status.GOOD, Status.LOST) and b in (Status.NOT_READY, Status.INITING)
                     for a, b in zip(statuses, statuses[1:]))
    out = dict(statuses=statuses, T7=np.stack([p for _, p in vo.trajectory[-len(statuses):]]),
               fed=fed, revisit_slot=slot, revisit_fid=fid,
               reloc_frame=k_rev if r.status is Status.GOOD else None, reloc_error=reloc_error,
               noise_lost=all(s is Status.LOST for s in noise[1:]),
               relocalized=relocalized and not ever_reset, near=reloc_error < TOL_REVISIT,
               after_good=len(after) == n_after and all(s is Status.GOOD for s in after))
    out["ok"] = out["noise_lost"] and out["relocalized"] and out["near"] and out["after_good"]
    return out


def kidnapped_pose(vo, T_gt7, fed=None):
    """tests/test_relocalization.py's kidnapped camera on this map: the
    camera centre of a keyframe's ground-truth pose moved by KIDNAP_OFFSET
    (world units), aimed where that keyframe's optical axis meets the plane z = 3,
    and rolled by 180 deg.  The keyframe is the window's farthest from the
    origin (frame ids map to rows of T_gt7 through `fed`, blackout_revisit's
    list, if given).  Returns (T_world: the pose to render, T_map: the same
    pose in the map's units).  The map's world frame is the init reference
    frame's, the identity of the ground truth here (frame 0); its scale is
    taken from that keyframe."""
    m = vo.server.state
    kf_id = m.kf_id.cpu().numpy()
    pose7 = m.kf_pose7.cpu().numpy().astype(np.float64)
    gt7 = np.asarray(T_gt7.detach().cpu(), np.float64)
    src = {s: fed[kf_id[s]] if fed is not None else int(kf_id[s]) for s in vo.server.kf_used}
    slot = max(src, key=lambda s: np.linalg.norm(gt7[src[s], 4:7]))
    gt = gt7[src[slot]]
    R_gt = SE3.from_params7(torch.tensor(gt, dtype=torch.float32)).R.numpy().astype(np.float64)
    t_gt = gt[4:7]
    s_map = float(np.linalg.norm(pose7[slot, 4:7])) / max(float(np.linalg.norm(t_gt)), 1e-9)
    centre = -R_gt.T @ t_gt
    axis = R_gt.T @ np.asarray([0.0, 0.0, 1.0])
    target = centre + axis * (3.0 - centre[2]) / axis[2]
    c = centre + np.asarray(KIDNAP_OFFSET)
    fwd = (target - c) / np.linalg.norm(target - c)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], 1)
    R_cw = np.diag([-1.0, -1.0, 1.0]) @ R_wc.T
    dev = m.kf_pose7.device
    T_world = SE3(torch.tensor(R_cw, dtype=torch.float32, device=dev),
                  torch.tensor(-R_cw @ c, dtype=torch.float32, device=dev))
    return T_world, SE3(T_world.R, T_world.t * s_map)


def kidnapped_frame(cam, T_world: SE3, shape) -> torch.Tensor:
    """mono_workload's world (PlaneScene seed 0, the plane at z = 3) seen
    from T_world."""
    return PlaneScene(cam, plane_z=3.0, seed=0, device=T_world.R.device).render(T_world, shape)
