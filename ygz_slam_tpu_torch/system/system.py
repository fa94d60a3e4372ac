"""System facade: the user-facing entry point (counterpart of
ygz_slam_tpu/system/system.py, monocular only).

`System(config_file=None, camera=None, sensor=MONOCULAR, options=None,
device=None)` takes the JAX package's arguments in its order, `device` last,
and wires a camera and VOOptions into a VisualOdometry on the card (or the
named device); `track_monocular` tracks one frame.  Not ported:
configuration files (a `config_file` raises NotImplementedError until
`system/config.py` is ported), RGBD and stereo sensors, map save/load and
chunked tracking.
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
