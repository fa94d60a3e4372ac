"""System facade: the user-facing entry point (counterpart of
ygz_slam_tpu/system/system.py, monocular only).

`System(config_file=None, camera=None, sensor=MONOCULAR, options=None,
device=None)` takes the JAX package's arguments in its order, `device` last,
and wires a camera and VOOptions into a VisualOdometry on the card (or the
named device); `track_monocular` tracks one frame, `track_monocular_chunk`
and `track_monocular_stream` track many through chunked tracking
(`VisualOdometry.add_frames`), with the depth filter if the options ask
for it.  Not ported yet (ROADMAP queue 1): async mapping with `shutdown`,
`warmup` and `export_point_cloud`; the vocabulary, relocalization,
keyframe archive, loop closing and map save/load; the SPARSE_ORB and SEMI_DENSE_DIRECT frontends; RGBD and
stereo sensors; configuration files (a `config_file` raises
NotImplementedError until `system/config.py` is ported); the viewer.
"""
from __future__ import annotations

import enum
import os

from ..models.visual_odometry import Status, VisualOdometry, VOOptions
from . import trajectory as traj


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class System:
    """Camera + options -> VisualOdometry (legacy system.h:45-67)."""

    def __init__(self, config_file: str | None = None, camera=None,
                 sensor: Sensor = Sensor.MONOCULAR, options: VOOptions | None = None,
                 device=None):
        if config_file is not None and not isinstance(config_file, (str, os.PathLike)):
            raise TypeError(f"config_file must be a path, got {type(config_file).__name__}: "
                            "pass the camera as camera=")
        if config_file:
            raise NotImplementedError(
                "configuration files are not ported yet (ROADMAP queue 1, step 6: "
                "system/config.py); pass camera= and options=")
        if sensor is not Sensor.MONOCULAR:
            raise ValueError(f"the port runs the MONOCULAR sensor only, not {sensor.name}")
        if camera is None:
            raise ValueError("no camera")
        self.sensor = sensor
        self.vo = VisualOdometry(camera, options or VOOptions(), device=device)

    def track_monocular(self, img, timestamp: float = 0.0):
        """One image [H, W] -> TrackResult (status, T_cw, inliers)."""
        return self.vo.add_frame(img, timestamp)

    def track_monocular_chunk(self, imgs, timestamps=None, chunk: int | None = None) -> list:
        """Consecutive images -> a TrackResult each, through chunked
        tracking (`VisualOdometry.add_frames`): the same results as repeated
        `track_monocular`, with the host's per-frame work paid per chunk."""
        return self.vo.add_frames(imgs, timestamps, chunk=chunk)

    def track_monocular_stream(self, frames_iter, chunk: int | None = None) -> list:
        """An iterator of (image, timestamp) pairs -> a TrackResult each, in
        order: frames are buffered 2 * chunk at a time and tracked by
        `track_monocular_chunk`, so a buffer's results come when it is
        flushed."""
        chunk = chunk or self.vo.o.chunk_frames
        buf, ts_buf, out = [], [], []
        for img, ts in frames_iter:
            buf.append(img)
            ts_buf.append(ts)
            if len(buf) >= 2 * chunk:
                out += self.vo.add_frames(buf, ts_buf, chunk=chunk)
                buf, ts_buf = [], []
        if buf:
            out += self.vo.add_frames(buf, ts_buf, chunk=chunk)
        return out

    def reset(self) -> None:
        self.vo.reset()

    @property
    def status(self) -> Status:
        return self.vo.status

    def save_trajectory(self, path: str, corrected: bool = True) -> None:
        """The trajectory in TUM format (see VisualOdometry.trajectory_poses
        for `corrected`)."""
        entries = self.vo.trajectory_poses(corrected=corrected)
        traj.save_tum(path, [t for t, _ in entries], [p for _, p in entries])
