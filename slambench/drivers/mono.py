"""One live monocular camera through `System.track_monocular`, closed loop:
each frame is sent when the last one's pose has returned.

Set-up renders every frame the run can use on the device, builds the
System with the configuration's options, runs the archive's capacity
buckets and then the mix's set-up frames (initialisation and the first
keyframes) through the same call the window makes.  `plant` breaks the
window's calls for the control and the fault tests (`slambench.control`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import scene, traffic

RENDER_BATCH = 16


def render(cfg: dict, mix: dict, seed: int, n: int, device):
    """(frames [n, H, W] float32 on the device, world, R_cw [n, 3, 3],
    t_cw [n, 3]) of the mix's first n frames.  The room's textures come
    from the configuration's world seed, so every run tracks the same room;
    the run's seed draws the camera's wobble phases and the sensor noise."""
    w = cfg["world"]
    world = scene.BoxWorld(scene.Camera.from_config(cfg["camera"]), w["half"], w["tex_size"],
                           w["tex_per_meter"], w["vignette"], w["tex_decay"],
                           torch.Generator(device=device).manual_seed(w["seed"]), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    R, t = traffic.poses(mix, seed, n)
    gain, bias = traffic.exposure(mix, n)
    sigma = mix.get("photometric", {}).get("noise_sigma", 0.0)
    shape = tuple(cfg["shape"])
    frames = torch.empty((n, *shape), dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    for a in range(0, n, RENDER_BATCH):
        b = min(n, a + RENDER_BATCH)
        img = world.render(torch.as_tensor(R[a:b], **f32), torch.as_tensor(t[a:b], **f32), shape,
                           torch.as_tensor(gain[a:b], **f32), torch.as_tensor(bias[a:b], **f32))
        if sigma:
            img = img + sigma * torch.randn(img.shape, generator=gen, **f32)
        frames[a:b] = img
    return frames, world, R, t


def build_system(cfg: dict, device):
    """The System under test, with the configuration's camera and options."""
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.models.visual_odometry import VOOptions
    from ygz_slam_tpu_torch.system.system import System

    return System(camera=PinholeCamera.create(**cfg["camera"]),
                  options=VOOptions(**cfg.get("options", {})), device=device)


class Session:
    frames_per_step = 1

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, device):
        self.n_setup = mix["setup_frames"]
        n = self.n_setup + traffic.window_frames(mix, seconds)
        self.frames, self.world, self.R_gt, self.t_gt = render(cfg, mix, seed, n, device)
        self.system = build_system(cfg, device)
        self.vo = self.system.vo
        if mix.get("archive_warmup"):
            self.system.warmup(archive_capacity=mix["archive_warmup"])
        self.dt = 1.0 / cfg["rate_hz"]
        self.k = 0
        self.results = []          # (frame, status name, T_cw) of every call
        self.spans = []            # (label, t0 ns, t1 ns, frames) of the window's calls
        self._timed = False
        self._after_kf = False
        for _ in range(self.n_setup):
            self.step()
        # The window opens with no mapping pass in flight.
        self.system.shutdown()
        self.start_counts = dict(self.vo.stats)
        self.k0 = self.k

    def start_window(self) -> None:
        self._timed = True
        self.start_counts = dict(self.vo.stats)
        self.k0 = self.k

    def more(self) -> bool:
        return self.k < self.frames.shape[0]

    def step(self) -> None:
        k = self.k
        kf0 = self.vo.stats["keyframes"]
        t0 = time.perf_counter_ns()
        res = self.system.track_monocular(self.frames[k], k * self.dt)
        t1 = time.perf_counter_ns()
        kf = self.vo.stats["keyframes"] > kf0
        if self._timed:
            label = "keyframe" if kf else ("after_keyframe" if self._after_kf else "ordinary")
            self.spans.append((label, t0, t1, 1))
        self._after_kf = kf
        self.results.append((k, res.status.name, res.T_cw))
        self.k += 1

    def finish(self) -> None:
        """Join the mapping worker (the window's last keyframe pass)."""
        self.system.shutdown()

    def counters(self) -> dict:
        """The system's counters over the window."""
        return {k: v - self.start_counts.get(k, 0) for k, v in self.vo.stats.items()}

    def failed(self) -> int:
        return sum(s != "GOOD" for k, s, _ in self.results[self.k0:])

    def outputs(self) -> dict:
        """What the judge compares: every returned pose (host float64, with
        its frame and status), the truth, and the map's landmarks."""
        idx = [k for k, s, _ in self.results]
        status = [s for _, s, _ in self.results]
        R = torch.stack([T.R for _, _, T in self.results]).double().cpu().numpy()
        t = torch.stack([T.t for _, _, T in self.results]).double().cpu().numpy()
        st = self.vo.server.state
        pts = st.pt_pos[st.pt_valid].double().cpu().numpy()
        return dict(frame=np.asarray(idx), status=status, R=R, t=t,
                    R_gt=self.R_gt[idx], t_gt=self.t_gt[idx], window_from=self.k0,
                    landmarks=pts, half=self.world.half)

    def free(self) -> None:
        del self.system, self.vo, self.frames, self.world


ALTER = 0.5      # map units added to one returned pose's x in the `altered` fault


def _moved(T, dx: float):
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    d = torch.zeros_like(T.t)
    d[..., 0] = dx
    return SE3(T.R, T.t + d)


def plant(sess, mode: str) -> None:
    """Break the window's calls underneath (`slambench.control`'s modes)."""
    vo = sess.vo
    run_tracker = vo._run_tracker
    if mode == "control":
        def tracker(pyr, T_pred):
            tm, st, ok = run_tracker(pyr, T_pred)
            return tm._replace(T_cw=T_pred), st, ok
        vo._run_tracker = tracker
    elif mode == "unchanged":
        def tracker(pyr, T_pred):
            tm, st, ok = run_tracker(pyr, T_pred)
            return tm._replace(T_cw=vo.prev_T_cw), st, ok
        vo._run_tracker = tracker
    elif mode == "altered":
        track = sess.system.track_monocular
        calls = [0]

        def track_monocular(img, ts=0.0):
            res = track(img, ts)
            calls[0] += 1
            if calls[0] == 5:
                res.T_cw = _moved(res.T_cw, ALTER)
            return res
        sess.system.track_monocular = track_monocular
    elif mode != "sound":
        raise ValueError(f"no {mode!r} fault for a monocular cell")


def setup(cfg, mix, seed, seconds, device) -> Session:
    return Session(cfg, mix, seed, seconds, device)
