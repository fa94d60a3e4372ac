"""MapServer: host-side slot bookkeeping over the device MapState
(counterpart of ygz_slam_tpu/map/memory.py).

The only component that hands out keyframe slots and landmark rows.  The
array contents live on the device in MapState (map/state.py); the server
keeps the used slots in insertion order and pulls small masks to the host
at keyframe rate, never per frame.  Slot choice and free-row search are the
numpy code paths of ygz_slam_tpu/native.py (`alloc_kf_slot`, `free_rows`),
copied, and `partition_obs`, a numpy copy of the native observation
partitioner (native/map_store.cpp); no native library is loaded.
"""
from __future__ import annotations

import numpy as np
import torch

from . import state as ms


def alloc_kf_slot(used: np.ndarray, cov: np.ndarray, ref_slot: int,
                  newest_slot: int) -> tuple[int, bool]:
    """(slot, evicted): the first free slot, else the used slot least
    covisible with `ref_slot` (neither it nor `newest_slot`)."""
    free = np.where(used == 0)[0]
    if len(free):
        return int(free[0]), False
    cands = [s for s in range(used.shape[0])
             if used[s] and s != ref_slot and s != newest_slot]
    w = [cov[ref_slot, s] for s in cands]
    return int(cands[int(np.argmin(w))]), True


def free_rows(valid: np.ndarray, want: int) -> np.ndarray:
    """Up to `want` free rows of the validity mask, ascending."""
    return np.where(valid == 0)[0][:want].astype(np.int32)


def partition_obs(kf_idx, pt_idx, px, mask, L: int, n_shards: int):
    """Observations grouped by landmark shard (shard s owns landmark rows
    [s * Ls, (s + 1) * Ls), Ls = ceil(L / n_shards)), each shard padded to
    the largest count (at least 1): (out_kf, out_pt shard-local, out_px,
    out_mask bool, o_shard), flat [n_shards * o_shard, ...].  Masked rows
    and rows of no shard are dropped; a shard's rows keep their table order
    and its padding is zero, exactly as the native partitioner
    (ms_partition_obs) writes them: that order sets the order of the
    segmented sums downstream."""
    kf = np.ascontiguousarray(kf_idx, np.int32)
    pt = np.ascontiguousarray(pt_idx, np.int32)
    px = np.ascontiguousarray(px, np.float32).reshape(-1, 2)
    mask = np.asarray(mask).astype(bool)
    Ls = -(-L // n_shards)
    # C++ integer division truncates toward zero.
    shard = np.where(pt >= 0, pt // Ls, -(-pt // Ls))
    keep = mask & (shard >= 0) & (shard < n_shards)
    rows = np.nonzero(keep)[0]
    s = shard[rows]
    counts = np.bincount(s, minlength=n_shards)
    o_shard = int(max(1, counts.max(initial=0)))
    rows = rows[np.argsort(s, kind="stable")]
    s = shard[rows]
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = s * o_shard + np.arange(rows.shape[0]) - first[s]
    n = n_shards * o_shard
    out_kf = np.zeros(n, np.int32)
    out_pt = np.zeros(n, np.int32)
    out_px = np.zeros((n, 2), np.float32)
    out_mask = np.zeros(n, bool)
    out_kf[out] = kf[rows]
    out_pt[out] = pt[rows] - s * Ls
    out_px[out] = px[rows]
    out_mask[out] = True
    return out_kf, out_pt, out_px, out_mask, o_shard


def refresh_covisibility(state: ms.MapState) -> ms.MapState:
    """Covisibility and observation counts recomputed, then the landmarks
    no keyframe observes any more invalidated."""
    state = ms.update_covisibility(state)
    return state._replace(pt_valid=state.pt_valid & (state.pt_obs != 0))


class MapServer:
    def __init__(self, K: int, F: int, L: int, device=None):
        self.Kcap, self.Fcap, self.Lcap = K, F, L
        self.state = ms.empty_map(K, F, L, device=device)
        self.kf_used: list[int] = []   # slots in insertion order
        self.next_frame_id = 0         # kept for the map file (`__next_frame_id`)
        # Called with the slot just before its contents are invalidated: the
        # VO archives the keyframe there (map/archive.py).
        self.on_evict = None

    def alloc_kf_slot(self) -> int:
        """A free slot, or the slot least covisible with the newest,
        evicted."""
        used = np.zeros(self.Kcap, np.uint8)
        used[list(self.kf_used)] = 1
        newest = self.kf_used[-1] if self.kf_used else 0
        cov = self.state.cov_weight.cpu().numpy()
        slot, evicted = alloc_kf_slot(used, cov, newest, newest)
        if evicted:
            self.evict_kf(slot)
        return slot

    def evict_kf(self, slot: int) -> None:
        if self.on_evict is not None:
            self.on_evict(slot)
        m = self.state
        self.state = m._replace(
            kf_valid=ms.set_row(m.kf_valid, slot, False),
            feat_valid=ms.set_row(m.feat_valid, slot, False),
            feat_point=ms.set_row(m.feat_point, slot, -1))
        self.kf_used.remove(slot)

    def alloc_landmark_rows(self, n: int) -> np.ndarray:
        """Up to n free landmark rows (the validity mask pulled to the host)."""
        return free_rows(self.state.pt_valid.cpu().numpy().astype(np.uint8), n)

    def register_keyframe(self, *args, **kwargs) -> int:
        """`state.insert_keyframe` into an allocated slot; returns the slot."""
        slot = self.alloc_kf_slot()
        self.state = ms.insert_keyframe(self.state, slot, *args, **kwargs)
        self.kf_used.append(slot)
        return slot

    def refresh_covisibility(self) -> None:
        self.state = refresh_covisibility(self.state)

    @property
    def device(self) -> torch.device:
        return self.state.pt_pos.device
