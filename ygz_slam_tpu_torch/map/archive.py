"""KeyframeArchive: the global-map tier above the active keyframe window
(counterpart of ygz_slam_tpu/map/archive.py).

The reference's Memory singleton keeps every keyframe for good
(include/ygz/Basic/Memory.h:16-56); the active window is a fixed-capacity
MapState, so without this tier relocalization and loop closing reach only
the last ~K keyframes.  When a keyframe leaves the window (evicted by the
keyframe cycle or culled), its pose, BoW row, vocabulary nodes, features
and the world position of the landmark each feature observed are appended
here, together with its level-0 image as uint8 (the patch source if the
keyframe is later reactivated).

The rows live on the device, in padded buffers whose capacity starts at 16
and doubles (the JAX package's `_capacity`, so a padded view has the same
shape, and `top_k` over it the same candidates, as there); an append writes
one row in place, straight from device tensors.  Only the small bookkeeping
stays on the host: the count, the frame ids and the epochs.  `device_view`
returns the first `_capacity()` rows of each buffer as an `ArchiveView`:
views into the buffers, valid until the next append, pop or correction.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import np_se3

MIN_CAPACITY = 16


class ArchiveView(NamedTuple):
    """Padded device view of the archive (capacity A >= count)."""

    frame_id: torch.Tensor    # [A] int32 (-1 padding)
    pose7: torch.Tensor       # [A, 7] T_cw at archive / last-correction time
    bow: torch.Tensor         # [A, W] BoW vectors
    nodes: torch.Tensor       # [A, F] vocabulary nodes (-1 padding)
    desc: torch.Tensor        # [A, F, 8] int32 ORB descriptor words
    px: torch.Tensor          # [A, F, 2] level-0 pixels
    angle: torch.Tensor       # [A, F] ORB angles
    feat_valid: torch.Tensor  # [A, F] bool
    pt_pos: torch.Tensor      # [A, F, 3] world position of each feature's landmark
    pt_ok: torch.Tensor       # [A, F] bool: the feature had a live landmark
    valid: torch.Tensor       # [A] bool


# The padded buffers: name -> (per-row shape given F and W, dtype, padding).
def _fields(F: int, W: int) -> dict:
    f32, i32, b = torch.float32, torch.int32, torch.bool
    return dict(frame_id=((), i32, -1), pose7=((7,), f32, 0), bow=((W,), f32, 0),
                nodes=((F,), i32, -1), desc=((F, 8), i32, 0), px=((F, 2), f32, 0),
                angle=((F,), f32, 0), feat_valid=((F,), b, False), pt_pos=((F, 3), f32, 0),
                pt_ok=((F,), b, False), valid=((), b, False), level=((F,), i32, 0))


# state_dict's row keys, in the JAX package's row order.
ROW_KEYS = ("frame_id", "pose7", "bow", "nodes", "desc", "px", "angle", "feat_valid",
            "pt_pos", "pt_ok", "level", "image", "epoch")


class KeyframeArchive:
    """Device store of the keyframes that left the window (insertion order
    is eviction order; `frame_ids` gives temporal order)."""

    def __init__(self, F: int, n_words: int, device=None):
        self.F = F
        self.W = n_words
        self.device = resolve_device(device)
        self._ids: list[int] = []
        self._epochs: list[int] = []
        self._images: list[torch.Tensor] = []   # uint8 [H, W] per row, on the device
        self._buf = self._alloc(MIN_CAPACITY)

    def _alloc(self, cap: int) -> dict:
        return {name: torch.full((cap,) + shape, fill, dtype=dtype, device=self.device)
                for name, (shape, dtype, fill) in _fields(self.F, self.W).items()}

    @property
    def count(self) -> int:
        return len(self._ids)

    def _capacity(self) -> int:
        c = MIN_CAPACITY
        while c < self.count:
            c *= 2
        return c

    def append(self, frame_id: int, pose7, bow, nodes, desc, px, feat_valid, pt_pos, pt_ok,
               angle=None, level=None, image=None, epoch: int = 0) -> None:
        """Write one row (device tensors or arrays; descriptors as int32 or
        uint32 words) at index `count`, doubling the buffers if full.
        `image` is stored as given when uint8, else clipped to [0, 255] and
        truncated to uint8."""
        n = self.count
        have = self._buf["valid"].shape[0]
        if n == have:
            grown = self._alloc(2 * have)
            for name, t in self._buf.items():
                grown[name][:have] = t
            self._buf = grown
        if angle is None:
            angle = torch.zeros(self.F)
        if level is None:
            level = torch.zeros(self.F, dtype=torch.int32)
        if image is None:
            image = torch.zeros((1, 1), dtype=torch.uint8)
        row = dict(frame_id=frame_id, pose7=pose7, bow=bow, nodes=nodes, desc=desc, px=px,
                   angle=angle, feat_valid=feat_valid, pt_pos=pt_pos, pt_ok=pt_ok, level=level,
                   valid=True)
        for name, v in row.items():
            t = self._buf[name]
            t[n] = _as_device(v, t.dtype, self.device)
        self._images.append(as_uint8_image(image, self.device))
        self._ids.append(int(frame_id))
        self._epochs.append(int(epoch))

    # -- device view ----------------------------------------------------
    def device_view(self) -> ArchiveView:
        """The first `_capacity()` rows of every buffer."""
        A = self._capacity()
        return ArchiveView(**{name: self._buf[name][:A] for name in ArchiveView._fields})

    def row(self, idx: int) -> dict:
        """Row `idx` as device tensors (copies), with its frame id, epoch and
        image."""
        out = {name: t[idx].clone() for name, t in self._buf.items() if name != "valid"}
        out.update(frame_id=self._ids[idx], epoch=self._epochs[idx], image=self._images[idx])
        return out

    # -- corrections ----------------------------------------------------
    def poses7(self) -> np.ndarray:
        """[count, 7] archived poses (host)."""
        return self._buf["pose7"][:self.count].cpu().numpy().copy()

    def frame_ids(self) -> np.ndarray:
        return np.asarray(self._ids, np.int32)

    def set_poses7(self, pose7, reanchor: bool = True, scale=None) -> None:
        """Overwrite the archived poses after a global correction.  With
        `reanchor`, each row's landmark snapshot moves with its keyframe,
        p' = R_new^T (p_cam / s - t_new) with p_cam = R_old p + t_old (s the
        row's Sim(3) correction scale, 1 without `scale`): the JAX package's
        host arithmetic (float64 rotations, float32 results), row by row."""
        n = self.count
        new = np.asarray(pose7, np.float32)
        assert new.shape[0] == n
        sc = np.ones(n, np.float32) if scale is None else np.asarray(scale, np.float32)
        if reanchor and n:
            old = self.poses7()
            pts = self._buf["pt_pos"][:n].cpu().numpy().copy()
            ok = self._buf["pt_ok"][:n].cpu().numpy()
            for a in range(n):
                if ok[a].any():
                    R_old, t_old = np_se3.params7_to_Rt(old[a])
                    R_new, t_new = np_se3.params7_to_Rt(new[a])
                    p_cam = pts[a] @ R_old.T + t_old
                    pts[a] = ((p_cam / sc[a] - t_new) @ R_new).astype(np.float32)
            self._buf["pt_pos"][:n] = torch.from_numpy(pts).to(self.device)
        self._buf["pose7"][:n] = torch.from_numpy(new.copy()).to(self.device)

    def recompute_bow(self, fn, n_words: int) -> None:
        """Every row's BoW vector and nodes under a new vocabulary of
        `n_words` words: fn(desc [F, 8], valid [F]) -> (bow [W'], nodes [F])."""
        self.W = n_words
        bow = torch.zeros((self._buf["valid"].shape[0], n_words), dtype=torch.float32,
                          device=self.device)
        for a in range(self.count):
            b, nodes = fn(self._buf["desc"][a], self._buf["feat_valid"][a])
            bow[a] = _as_device(b, torch.float32, self.device)
            self._buf["nodes"][a] = _as_device(nodes, torch.int32, self.device)
        self._buf["bow"] = bow

    def epoch_of(self, idx: int) -> int:
        return self._epochs[idx]

    def epochs(self) -> np.ndarray:
        return np.asarray(self._epochs, np.int32)

    def rebase_epoch(self, epoch: int, fn_pose7, fn_points) -> None:
        """A world-frame change applied to every row of one epoch, on the host
        as in the JAX package: fn_pose7(pose7 [7]) -> [7] and
        fn_points(p [F, 3]) -> [F, 3] (numpy), the latter only on rows with a
        landmark snapshot."""
        for a, e in enumerate(self._epochs):
            if e != epoch:
                continue
            self._buf["pose7"][a] = torch.from_numpy(np.asarray(
                fn_pose7(self._buf["pose7"][a].cpu().numpy().copy()), np.float32)).to(self.device)
            if bool(self._buf["pt_ok"][a].any()):
                self._buf["pt_pos"][a] = torch.from_numpy(np.asarray(
                    fn_points(self._buf["pt_pos"][a].cpu().numpy().copy()), np.float32)).to(self.device)

    def set_epoch(self, old: int, new: int) -> None:
        self._epochs = [new if e == old else e for e in self._epochs]

    def pop(self, idx: int) -> dict:
        """Remove row `idx` and return it (`row`): the later rows move down
        one index, as a list pop does (keyframe reactivation: the row goes
        back into the window, and a copy left here would duplicate its
        pose-graph node)."""
        out = self.row(idx)
        n = self.count
        for name, (_, _, fill) in _fields(self.F, self.W).items():
            t = self._buf[name]
            if idx + 1 < n:
                t[idx:n - 1] = t[idx + 1:n].clone()
            t[n - 1] = fill
        del self._ids[idx], self._epochs[idx], self._images[idx]
        return out

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        """The JAX package's npz layout: `__arc_<key>` stacked over the rows
        (descriptors as uint32 words), images under per-row keys
        `__arc_image_<i>`; {} when empty."""
        n = self.count
        if not n:
            return {}
        out = {}
        for k in ROW_KEYS:
            if k == "frame_id":
                out["__arc_frame_id"] = np.asarray(self._ids, np.int64)
            elif k == "epoch":
                out["__arc_epoch"] = np.asarray(self._epochs, np.int32)
            elif k != "image":
                out[f"__arc_{k}"] = self._buf[k][:n].cpu().numpy().copy()
        out["__arc_desc"] = out["__arc_desc"].view(np.uint32)
        for i, img in enumerate(self._images):
            out[f"__arc_image_{i}"] = img.cpu().numpy().copy()
        return out

    def load_state_dict(self, data) -> None:
        """Rows from a `state_dict` of either package (older maps without
        angle, level or epoch get zeros; without images a 1x1 placeholder)."""
        self._ids, self._epochs, self._images = [], [], []
        n = data["__arc_frame_id"].shape[0] if "__arc_frame_id" in data else 0
        if n:
            self.W = int(np.asarray(data["__arc_bow"]).shape[1])
        self._buf = self._alloc(MIN_CAPACITY)
        for i in range(n):
            if f"__arc_image_{i}" in data:
                img = np.asarray(data[f"__arc_image_{i}"])
            elif "__arc_image" in data:
                img = np.asarray(data["__arc_image"][i])
            else:
                img = np.zeros((1, 1), np.uint8)

            def get(k, default=None):
                return np.asarray(data[f"__arc_{k}"][i]) if f"__arc_{k}" in data else default

            self.append(int(get("frame_id")), get("pose7"), get("bow"), get("nodes"),
                        get("desc"), get("px"), get("feat_valid"), get("pt_pos"), get("pt_ok"),
                        angle=get("angle", np.zeros(self.F, np.float32)),
                        level=get("level", np.zeros(self.F, np.int32)), image=img,
                        epoch=int(get("epoch", 0)))


def _as_device(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A value for a buffer row: a tensor moved without a copy where it
    already matches, an array (uint32 words read as int32) converted."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    a = np.asarray(v)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device).to(dtype)


def as_uint8_image(img, device) -> torch.Tensor:
    """A keyframe image as the archive keeps it: uint8 as given, else
    clipped to [0, 255] and truncated (numpy's astype, the JAX package's
    `np.clip(img, 0, 255).astype(np.uint8)`)."""
    t = img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img))
    if t.dtype != torch.uint8:
        t = torch.clamp(t, 0, 255).to(torch.uint8)
    return t.to(device)
