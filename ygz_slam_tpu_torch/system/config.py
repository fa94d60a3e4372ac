"""YAML configuration (counterpart of ygz_slam_tpu/system/config.py).

`Config` is a process-wide key-value store: `Config.set_parameter_file(path)`
(PyYAML, imported there and nowhere else, so the package imports without it)
or `Config.set_dict(d)`, then `Config.get("camera.fx", default)` with dotted
keys over nested mappings or flat "a.b" keys.  `camera_from_config` builds a
PinholeCamera from the camera.* keys; `apply_to` overwrites option fields
from config keys (`VO_CONFIG_KEYS` for VOOptions, the reference's
config/default.yaml names).
"""
from __future__ import annotations

import dataclasses
from typing import Any


class Config:
    """Process-wide key-value config (class state: every caller that sets it
    clears it when done)."""

    _data: dict = {}

    @classmethod
    def set_parameter_file(cls, path: str) -> None:
        import yaml

        with open(path) as f:
            cls._data = yaml.safe_load(f) or {}

    @classmethod
    def set_dict(cls, d: dict) -> None:
        cls._data = dict(d)

    @classmethod
    def get(cls, key: str, default: Any = None) -> Any:
        """Dotted access: a flat 'a.b' key first, then nested mappings."""
        if key in cls._data:
            return cls._data[key]
        node = cls._data
        for part in key.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return default
        return node

    @classmethod
    def clear(cls) -> None:
        cls._data = {}


def camera_from_config(default=None):
    """A PinholeCamera from the camera.* keys (Camera.h:13-26), or `default`
    when camera.fx is not set."""
    from ..geometry.camera import PinholeCamera

    g = Config.get
    if g("camera.fx") is None:
        return default
    return PinholeCamera.create(g("camera.fx"), g("camera.fy"), g("camera.cx"), g("camera.cy"),
                               g("camera.k1", 0.0), g("camera.k2", 0.0),
                               g("camera.p1", 0.0), g("camera.p2", 0.0))


def apply_to(options, mapping: dict[str, str]):
    """A copy of the dataclass `options` with each field of `mapping` (field
    name -> config key) that the config sets, converted to the field's type
    (the reference's per-class LoadParams, e.g. FeatureDetector.cpp:331-340)."""
    updates = {}
    for field, key in mapping.items():
        v = Config.get(key)
        if v is not None:
            cur = getattr(options, field)
            updates[field] = type(cur)(v) if cur is not None else v
    return dataclasses.replace(options, **updates)


# VOOptions field -> config key (config/default.yaml names).
VO_CONFIG_KEYS = {
    "n_levels": "frame.pyramid",
    "detect_threshold": "feature.detection_threshold",
    "grid_cell": "feature.grid_size",
    "init_min_features": "init.min_features",
    "init_min_disparity": "init.min_disparity",
    "init_min_inliers": "init.min_inliers",
    "min_track_inliers": "localmapping.min_track_localmap_inliers",
    "kf_min_frames": "keyframe.min_frames",
    "kf_max_rot": "keyframe.max_rot",
    "kf_max_trans": "keyframe.max_trans",
    "map_K": "localmapping.num_local_keyframes",
    "map_L": "localmapping.num_local_map_points",
}
