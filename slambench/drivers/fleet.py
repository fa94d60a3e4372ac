"""A fleet of cameras through `models.batch.track_batch_step`, closed loop:
one step advances every stream one frame, warm-started from the poses the
last step returned, and the next step starts when its poses and inlier
counts are on the host.

Set-up draws each stream's world, keyframe (its pixels, their true depths
and world points, the patches and the reference pyramid) and clip from the
seed on the device, builds the batch state, and runs the clip once.  The
window replays the clip; at each wrap every stream restarts from the
keyframe's pose, as it did at the clip's first frame.  `plant` breaks the
window's steps for the control and the fault tests (`slambench.control`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import scene, traffic


def render(cfg: dict, mix: dict, seed: int, device):
    """(frames [F, S, H, W], keyframe images [S, H, W], px [S, N, 2],
    depth [S, N], pts_w [S, N, 3], R_cw [F, 3, 3], t_cw [F, 3]), the
    keyframe at the identity pose.  The S worlds and keyframe pixels come
    from the configuration's world seed, so every run tracks the same set of
    streams; the run's seed orders them and draws the sensor noise."""
    S, N = cfg["streams"], cfg["landmarks"]
    H, W = cfg["shape"]
    cam = scene.Camera.from_config(cfg["camera"])
    w = cfg["world"]
    fixed = torch.Generator(device=device).manual_seed(w["seed"])
    world = scene.PlaneWorld(cam, S, w["plane_z"], w["tex_size"], w["tex_per_meter"], fixed,
                             device)
    f32 = dict(dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    idx = torch.randperm(S, generator=gen, device=device)
    eye = torch.eye(3, **f32).expand(S, 3, 3)
    zero = torch.zeros((S, 3), **f32)
    refs = world.render(idx, eye, zero, (H, W))
    m = cfg["keyframe_margin_px"]
    u = torch.rand((S, N, 2), generator=fixed, **f32)[idx]
    px = torch.stack([m + u[..., 0] * (W - 2 * m), m + u[..., 1] * (H - 2 * m)], -1)
    depth = world.depth_at(px, eye, zero)
    pts_w = torch.stack([(px[..., 0] - cam.cx) / cam.fx, (px[..., 1] - cam.cy) / cam.fy,
                         torch.ones_like(depth)], -1) * depth[..., None]
    F = mix["path"]["clip"]
    R, t = traffic.poses(mix, seed, F)
    sigma = mix.get("photometric", {}).get("noise_sigma", 0.0)
    frames = torch.empty((F, S, H, W), **f32)
    for i in range(F):
        img = world.render(idx, torch.as_tensor(R[i], **f32).expand(S, 3, 3),
                           torch.as_tensor(t[i], **f32).expand(S, 3), (H, W))
        frames[i] = img + sigma * torch.randn(img.shape, generator=gen, **f32)
    return frames, refs, px, depth, pts_w, R, t


class Session:
    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, device):
        from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
        from ygz_slam_tpu_torch.models import batch
        from ygz_slam_tpu_torch.ops import pyramid
        from ygz_slam_tpu_torch.ops.interp import sample_patches

        self.cfg = cfg
        S, N = cfg["streams"], cfg["landmarks"]
        self.frames_per_step = S
        self.frames, refs, px, depth, pts_w, self.R_gt, self.t_gt = render(cfg, mix, seed, device)
        patches = torch.stack([sample_patches(refs[s], px[s], cfg["patch"]) for s in range(S)])
        ref_pyrs = pyramid.build_pyramid(refs, cfg["levels"])
        mask = torch.ones((S, N), dtype=torch.bool, device=device)
        self.state = batch.make_batch_state(PinholeCamera.create(**cfg["camera"]), ref_pyrs, px,
                                            depth, mask, pts_w, patches)
        self._step = batch.track_batch_step
        self.T_init7 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], device=device).repeat(S, 1)
        self.T7 = self.T_init7
        self.k = 0
        self.results = []          # (clip frame, poses [S, 7], inliers [S]) on the host
        self.spans = []            # (label, t0 ns, t1 ns, frames) of the window's steps
        self.enqueue_ns = []       # host ns until the step returned, before the sync
        self._timed = False
        for _ in range(mix["setup_frames"]):
            self.step()
        self.k0 = self.k

    def start_window(self) -> None:
        self._timed = True
        self.k0 = self.k

    def more(self) -> bool:
        return True

    def step(self) -> None:
        i = self.k % self.frames.shape[0]
        T7 = self.T_init7 if i == 0 else self.T7
        t0 = time.perf_counter_ns()
        T7, n_inl = self._step(self.state, T7, self.frames[i])
        t1 = time.perf_counter_ns()
        host = (T7.cpu(), n_inl.cpu())
        t2 = time.perf_counter_ns()
        if self._timed:
            self.spans.append(("step", t0, t2, self.frames_per_step))
            self.enqueue_ns.append(t1 - t0)
        self.T7 = T7
        self.results.append((i, *host))
        self.k += 1

    def finish(self) -> None:
        pass

    def counters(self) -> dict:
        return {"steps": self.k - self.k0}

    def failed(self) -> int:
        gate = self.cfg["inlier_gate"] * self.cfg["landmarks"]
        return sum(int((n <= gate).sum()) for _, _, n in self.results[self.k0:])

    def outputs(self) -> dict:
        """Every returned pose [steps, S, 7] and inlier count [steps, S],
        with each step's clip frame and the clip's truth."""
        return dict(frame=np.asarray([i for i, _, _ in self.results]),
                    pose7=torch.stack([p for _, p, _ in self.results]).double().numpy(),
                    inliers=torch.stack([n for _, _, n in self.results]).numpy(),
                    R_gt=self.R_gt, t_gt=self.t_gt, window_from=self.k0,
                    landmarks_n=self.cfg["landmarks"], inlier_gate=self.cfg["inlier_gate"])

    def free(self) -> None:
        del self.state, self.frames


ALTER = 0.5      # metres added to one returned pose's x in the `altered` fault


def plant(sess, mode: str) -> None:
    """Break the window's calls underneath (`slambench.control`'s modes)."""
    step = sess._step
    S = sess.cfg["streams"]
    if mode in ("control", "unchanged"):
        sess._step = lambda state, T7, imgs: (T7, step(state, T7, imgs)[1])
    elif mode == "half_batch":
        def half(state, T7, imgs):
            out7, n = step(state, T7, imgs)
            keep = torch.arange(S, device=T7.device)[:, None] < S // 2
            return torch.where(keep, out7, T7), n
        sess._step = half
    elif mode == "altered":
        calls = [0]

        def altered(state, T7, imgs):
            out7, n = step(state, T7, imgs)
            calls[0] += 1
            if calls[0] == 5:
                out7 = out7.clone()
                out7[0, 4] += ALTER
            return out7, n
        sess._step = altered
    elif mode != "sound":
        raise ValueError(f"no {mode!r} fault for a fleet cell")


def setup(cfg, mix, seed, seconds, device) -> Session:
    return Session(cfg, mix, seed, seconds, device)
