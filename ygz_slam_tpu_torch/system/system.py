"""System facade: the user-facing entry point (counterpart of
ygz_slam_tpu/system/system.py).

`System(config_file=None, camera=None, sensor=MONOCULAR, options=None,
device=None)` takes the JAX package's arguments in its order, `device` last,
and wires a camera and VOOptions into a VisualOdometry on the card (or the
named device).  A YAML `config_file` (`system/config.py`) may set the camera
(camera.*), the sensor (system.sensor), the frontend (system.vo), the map
type (system.map) and the fields of `VO_CONFIG_KEYS`.  With `VOOptions()`
unchanged it runs the JAX package's default configuration: SPARSE_DIRECT
with the depth filter, the vocabulary, relocalization, the keyframe
archive, loop closing against the window and the archive and async mapping.
Every frontend (SPARSE_DIRECT, SPARSE_ORB, SEMI_DENSE_DIRECT) runs with
every map type (SPARSE, SEMI_DENSE, DENSE) and every sensor.
Sensors: MONOCULAR (`track_monocular`, and `track_monocular_chunk` /
`track_monocular_stream` through chunked tracking), RGBD (`track_rgbd`: a
depth image in metres) and rectified STEREO (`track_stereo`).  `save_map` /
`load_map` (and the functions `save_map(vo, path)` / `load_map(vo, path)`
on a VisualOdometry) write and read the JAX package's npz layout, so a map
file of either package loads in the other; a loaded map resumes by
relocalization.
`warmup` runs the archive's capacity buckets ahead, `shutdown` waits for
the mapping worker, `export_point_cloud` returns the map's points.
"""
from __future__ import annotations

import dataclasses
import enum
import os

import numpy as np
import torch

from .. import convert
from ..map import vocabulary as voc
from ..models.visual_odometry import MapType, Status, VisualOdometry, VOOptions, VOType
from . import trajectory as traj
from .config import VO_CONFIG_KEYS, Config, apply_to, camera_from_config


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class System:
    """Config -> camera -> VisualOdometry (legacy system.h:45-67)."""

    def __init__(self, config_file: str | None = None, camera=None,
                 sensor: Sensor = Sensor.MONOCULAR, options: VOOptions | None = None,
                 device=None):
        if config_file is not None and not isinstance(config_file, (str, os.PathLike)):
            raise TypeError(f"config_file must be a path, got {type(config_file).__name__}: "
                            "pass the camera as camera=")
        if config_file:
            Config.set_parameter_file(config_file)
            sensor_key = Config.get("system.sensor")
            if sensor_key is not None:
                sensor = Sensor[str(sensor_key).upper()]
        self.sensor = sensor
        cam = camera_from_config(default=camera)
        if cam is None:
            raise ValueError("no camera: pass camera= or camera.* config keys")
        opts = options or VOOptions()
        if config_file:
            opts = apply_to(opts, VO_CONFIG_KEYS)
            vo_key, map_key = Config.get("system.vo"), Config.get("system.map")
            if vo_key is not None:
                opts = dataclasses.replace(opts, vo_type=VOType[str(vo_key).upper()])
            if map_key is not None:
                opts = dataclasses.replace(opts, map_type=MapType[str(map_key).upper()])
        self.vo = VisualOdometry(cam, opts, device=device)

    def warmup(self, archive_capacity: int = 128) -> None:
        """Run the archive's capacity buckets 16, 32, ... up to
        `archive_capacity` once (`VisualOdometry.warmup_archive`): the kernels
        of archive relocalization and archive loop detection are built and
        launched before a tracking step needs them."""
        self.vo.warmup_archive(archive_capacity)

    def track_monocular(self, img, timestamp: float = 0.0):
        """One image [H, W] -> TrackResult (status, T_cw, inliers)."""
        assert self.sensor is Sensor.MONOCULAR
        return self.vo.add_frame(img, timestamp)

    def track_monocular_chunk(self, imgs, timestamps=None, chunk: int | None = None) -> list:
        """Consecutive images -> a TrackResult each, through chunked
        tracking (`VisualOdometry.add_frames`): the same results as repeated
        `track_monocular`, with the host's per-frame work paid per chunk."""
        assert self.sensor is Sensor.MONOCULAR
        return self.vo.add_frames(imgs, timestamps, chunk=chunk)

    def track_monocular_stream(self, frames_iter, chunk: int | None = None) -> list:
        """An iterator of (image, timestamp) pairs -> a TrackResult each, in
        order: frames are buffered 2 * chunk at a time and tracked by
        `track_monocular_chunk`, so a buffer's results come when it is
        flushed."""
        assert self.sensor is Sensor.MONOCULAR
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

    def track_rgbd(self, img, depth, timestamp: float = 0.0):
        """One image and its registered depth image [H, W] in metres (<= 0
        where unknown) -> TrackResult."""
        assert self.sensor is Sensor.RGBD
        return self.vo.add_frame(img, timestamp, depth=depth)

    def track_stereo(self, left, right, timestamp: float = 0.0):
        """One rectified pair (the right camera displaced along the left
        one's x by `VOOptions.stereo_baseline`) -> TrackResult."""
        assert self.sensor is Sensor.STEREO
        return self.vo.add_frame(left, timestamp, right=right)

    def reset(self) -> None:
        self.vo.reset()

    def shutdown(self) -> None:
        """Wait for the mapping worker (async mapping), re-raising its
        exception if it failed."""
        self.vo._join_mapping()

    def export_point_cloud(self) -> np.ndarray:
        """The map's points, [N, 3] world coordinates: the landmarks and,
        with the DENSE map type, the keyframes' back-projected depth images."""
        return self.vo.export_point_cloud()

    @property
    def status(self) -> Status:
        return self.vo.status

    def save_trajectory(self, path: str, corrected: bool = True) -> None:
        """The trajectory in TUM format (see VisualOdometry.trajectory_poses
        for `corrected`)."""
        entries = self.vo.trajectory_poses(corrected=corrected)
        traj.save_tum(path, [t for t, _ in entries], [p for _, p in entries])

    # -- the map file (system.h:63-67, unimplemented there) ----------------
    def save_map(self, path: str) -> None:
        """`save_map(self.vo, path)`."""
        save_map(self.vo, path)

    def load_map(self, path: str) -> None:
        """`load_map(self.vo, path)`."""
        load_map(self.vo, path)


def save_map(vo: VisualOdometry, path: str) -> None:
    """The VO's map as a compressed npz in the JAX package's layout (its
    `System.save_map`): the MapState fields (descriptors as uint32 words),
    `__kf_used`, `__next_frame_id`, `__kf_images`, with a vocabulary
    `__kf_bow`, `__kf_nodes` and the vocabulary itself (`__vocab_*`, so the
    map relocalizes in any process), `__aux_cloud` (the DENSE cloud), and the
    archive's rows (`__arc_*`).  The mapping worker is joined first."""
    vo._join_mapping()
    srv = vo.server
    arrays = convert.map_state_to_numpy(srv.state)
    arrays["__kf_used"] = np.asarray(srv.kf_used, np.int32)
    arrays["__next_frame_id"] = np.asarray([srv.next_frame_id], np.int32)
    if vo.kf_images is not None:
        arrays["__kf_images"] = vo.kf_images.cpu().numpy()
    if vo.vocab is not None:
        arrays["__kf_bow"] = vo.kf_bow.cpu().numpy()
        arrays["__kf_nodes"] = vo.kf_nodes.cpu().numpy()
        for key, arr in voc.state_dict(vo.vocab).items():
            arrays[f"__vocab_{key}"] = arr
    if vo.semidense_cloud or vo.dense_cloud:
        arrays["__aux_cloud"] = np.concatenate(vo.semidense_cloud + vo.dense_cloud, axis=0)
    if vo.archive is not None and vo.archive.count:
        arrays.update(vo.archive.state_dict())
    np.savez_compressed(path, **arrays)


def load_map(vo: VisualOdometry, path: str) -> None:
    """Restore a map file of either package into the VO, on its device (the
    JAX `System.load_map`; the mapping worker joined first).  With a
    vocabulary, the file's vocabulary replaces it and its BoW rows are taken
    as saved; the keyframe pose log is rebuilt from the window and the
    archive.  The next frame, NOT_READY, resumes by relocalizing against the
    map.  A ChunkStep copies the map in at every chunk and new keyframe
    images by identity, so none needs dropping."""
    vo._join_mapping()
    dev = vo.device
    with np.load(path) as f:
        data = dict(f)
    srv = vo.server
    srv.state = convert.map_state_from_numpy(data, device=dev)
    srv.kf_used = [int(x) for x in data["__kf_used"]]
    srv.next_frame_id = int(data["__next_frame_id"][0])
    if "__kf_images" in data:
        vo.kf_images = torch.as_tensor(data["__kf_images"], dtype=torch.float32, device=dev)
    if "__vocab_meta" in data and vo.vocab is not None:
        vo.set_vocabulary(voc.from_state_dict(data, prefix="__vocab_", device=dev),
                          recompute=False)
    if "__kf_bow" in data and vo.vocab is not None:
        vo.kf_bow = torch.as_tensor(data["__kf_bow"], dtype=torch.float32, device=dev)
        vo.kf_nodes = torch.as_tensor(data["__kf_nodes"], dtype=torch.int32, device=dev)
    if "__aux_cloud" in data:
        vo.semidense_cloud = [np.asarray(data["__aux_cloud"])]
    if vo.archive is not None:
        vo.archive.load_state_dict(data)
    ids, pose7 = data["kf_id"], data["kf_pose7"]
    for s in srv.kf_used:
        vo.kf_pose_log[int(ids[s])] = pose7[s].copy()
    if vo.archive is not None and vo.archive.count:
        for fid, p in zip(vo.archive.frame_ids(), vo.archive.poses7()):
            vo.kf_pose_log[int(fid)] = np.asarray(p)
