"""MapServer: host-side slot bookkeeping over the device MapState
(counterpart of ygz_slam_tpu/map/memory.py).

The only component that hands out keyframe slots and landmark rows.  The
array contents live on the device in MapState (map/state.py); the server
keeps the used slots in insertion order and pulls small masks to the host
at keyframe rate, never per frame.  Slot choice and free-row search are the
numpy code paths of ygz_slam_tpu/native.py (`alloc_kf_slot`, `free_rows`),
copied; no native library is loaded.
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
