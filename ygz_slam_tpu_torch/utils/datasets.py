"""Dataset loaders (counterpart of ygz_slam_tpu/utils/datasets.py): TUM
RGB-D sequences, EuRoC MAV sequences in ASL format, and rendered synthetic
sequences with exact ground truth, all yielding `FrameData`.

`TumDataset` reads associate.txt (the file the reference's tests parse,
test/test_vo_init.cpp:26-39) or pairs rgb.txt and depth.txt by nearest
timestamp, and decodes depth PNGs at 1/5000 m; `EurocDataset` reads
mav0/<cam>/data.csv and the ground-truth csv.  Images are read with OpenCV,
else PIL, each imported when a frame is read.  Ground truth is (stamps,
T_cw params7 [N, 7]), as `system.trajectory.load_tum` returns it.
`SyntheticDataset` renders a PlaneScene on `device` (the card unless named)
and yields its images and depths as tensors there.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3 as se3m
from ..geometry import so3
from ..geometry.se3 import SE3
from .synthetic import PlaneScene, _pixel_grid


def _imread_gray(path: str) -> np.ndarray | None:
    """Grayscale image as float32 [H, W]: OpenCV when present, else PIL."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        return None if img is None else img.astype(np.float32)
    except ImportError:
        pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("L"), np.float32)
    except Exception:
        return None


def _imread_raw(path: str) -> np.ndarray | None:
    """An image as stored (a 16-bit depth PNG stays uint16)."""
    try:
        import cv2

        return cv2.imread(path, cv2.IMREAD_UNCHANGED)
    except ImportError:
        pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im)
    except Exception:
        return None


@dataclass
class FrameData:
    timestamp: float
    gray: np.ndarray | torch.Tensor             # [H, W] float32
    depth: np.ndarray | torch.Tensor | None     # [H, W] float32 metres, or None
    T_cw_gt: SE3 | None                         # ground truth, if known


class TumDataset:
    """A TUM RGB-D sequence: associate.txt, or rgb.txt and depth.txt paired
    by nearest timestamp (within 0.02 s)."""

    DEPTH_SCALE = 5000.0  # TUM depth PNG units per metre

    def __init__(self, root: str):
        self.root = root
        assoc = os.path.join(root, "associate.txt")
        self.pairs: list[tuple[float, str, str | None]] = []
        if os.path.exists(assoc):
            with open(assoc) as f:
                for line in f:
                    p = line.split()
                    if len(p) >= 4:
                        self.pairs.append((float(p[0]), p[1], p[3]))
        else:
            rgb = self._read_list(os.path.join(root, "rgb.txt"))
            dep = self._read_list(os.path.join(root, "depth.txt"))
            dts = np.asarray([t for t, _ in dep]) if dep else None
            for t, path in rgb:
                dpath = None
                if dep:
                    i = int(np.argmin(np.abs(dts - t)))
                    if abs(dts[i] - t) < 0.02:
                        dpath = dep[i][1]
                self.pairs.append((t, path, dpath))
        self.groundtruth = self._read_groundtruth()

    @staticmethod
    def _read_list(path):
        out = []
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                out.append((float(p[0]), p[1]))
        return out

    def _read_groundtruth(self):
        path = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        from ..system.trajectory import load_tum

        return load_tum(path)

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        for ts, rgb_rel, depth_rel in self.pairs:
            img = _imread_gray(os.path.join(self.root, rgb_rel))
            if img is None:
                continue
            depth = None
            if depth_rel:
                d = _imread_raw(os.path.join(self.root, depth_rel))
                if d is not None:
                    depth = d.astype(np.float32) / self.DEPTH_SCALE
                    depth[depth <= 0] = -1.0
            yield FrameData(ts, img, depth, None)


class EurocDataset:
    """A EuRoC MAV sequence in ASL format (`BASELINE.json` config 4, EuRoC
    MH_01): grayscale mav0/<cam>/data.csv (timestamp_ns, filename) and, if
    present, state_groundtruth_estimate0/data.csv (p_WB, q_WB wxyz), whose
    body poses are inverted to camera-from-world (body ~ cam0 up to the
    fixed extrinsic, which cancels in ATE)."""

    def __init__(self, root: str, cam: str = "cam0"):
        base = os.path.join(root, "mav0")
        if not os.path.isdir(base):
            base = root                      # already mav0
        self.img_dir = os.path.join(base, cam, "data")
        self.items: list[tuple[float, str]] = []
        with open(os.path.join(base, cam, "data.csv")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split(",")
                self.items.append((int(p[0]) * 1e-9, p[1].strip()))
        self.groundtruth = self._read_gt(os.path.join(base, "state_groundtruth_estimate0",
                                                      "data.csv"))

    @staticmethod
    def _read_gt(path):
        """(stamps [N], T_cw params7 [N, 7]): the csv parsed at once, then one
        batched quaternion -> rotation and inverse in float32 on the CPU."""
        if not os.path.exists(path):
            return None
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split(",")[:8]])
        if not rows:
            return None
        v = np.asarray(rows, np.float64)
        t_wb = torch.tensor(v[:, 1:4], dtype=torch.float32)
        R_wb = so3.from_quaternion(torch.tensor(v[:, 4:8], dtype=torch.float32))
        return v[:, 0] * 1e-9, SE3(R_wb, t_wb).inverse().params7().numpy()

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for ts, name in self.items:
            img = _imread_gray(os.path.join(self.img_dir, name))
            if img is None:
                continue
            yield FrameData(ts, img, None, None)


class SyntheticDataset:
    """A rendered textured-plane sequence with exact ground truth, on
    `device`; frames and depths are tensors there."""

    def __init__(self, cam, n_frames: int = 60, shape=(480, 640), seed: int = 0,
                 motion_scale: float = 1.0, with_depth: bool = False, plane_z: float = 3.0,
                 device=None):
        dev = resolve_device(device)
        self.scene = PlaneScene(cam, plane_z=plane_z, seed=seed, tex_per_meter=220.0, device=dev)
        self.cam = cam
        self.shape = shape
        self.with_depth = with_depth
        self.poses = []
        for k in range(n_frames):
            t = k / max(n_frames - 1, 1)
            xi = torch.tensor(np.asarray(
                [1.0 * t * motion_scale, 0.2 * np.sin(2 * t) * motion_scale,
                 0.25 * t * motion_scale, 0.03 * np.sin(3 * t), -0.15 * t * motion_scale,
                 0.03 * t], np.float32), device=dev)
            self.poses.append(se3m.exp(xi))

    def __len__(self):
        return len(self.poses)

    def __iter__(self):
        px = _pixel_grid(self.shape, self.scene.tex.device)[2] if self.with_depth else None
        for k, T in enumerate(self.poses):
            depth = self.scene.depth(px, T) if self.with_depth else None
            yield FrameData(float(k) / 30.0, self.scene.render(T, self.shape), depth, T)
