"""MapState: the fixed-capacity tensor map (counterpart of
ygz_slam_tpu/map/state.py).

A NamedTuple of tensors on one device with validity masks: keyframes
(capacity K), features (K x F), landmarks (L) and a dense [K, K]
covisibility matrix.  Every function is pure: it returns a new MapState and
leaves its argument untouched.  Slots and rows may be Python ints or 0-d
tensors; tensor slots are read and written with index ops, never through
`.item()`, so nothing here waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..geometry.se3 import SE3
from ..ops.select import top_k


def _index1(i, device) -> torch.Tensor:
    return torch.as_tensor(i, device=device).long().reshape(1)


def row(t: torch.Tensor, i) -> torch.Tensor:
    """t[i] for a Python int or a 0-d tensor `i`, without a host sync."""
    return t.index_select(0, _index1(i, t.device)).squeeze(0)


def set_row(t: torch.Tensor, i, v) -> torch.Tensor:
    """Copy of `t` with t[i] = v (the JAX `.at[i].set(v)`)."""
    v = torch.as_tensor(v, dtype=t.dtype, device=t.device).expand(t.shape[1:])
    return t.index_copy(0, _index1(i, t.device), v[None])


class MapState(NamedTuple):
    # --- keyframes [K] ---
    kf_pose7: torch.Tensor     # [K, 7] T_cw as quat(wxyz)+t
    kf_valid: torch.Tensor     # [K] bool
    kf_id: torch.Tensor        # [K] int32 global frame id (-1 empty)
    # --- features [K, F] ---
    feat_px: torch.Tensor      # [K, F, 2] level-0 pixel
    feat_level: torch.Tensor   # [K, F] int32 detection pyramid level
    feat_angle: torch.Tensor   # [K, F] ORB angle (radians)
    feat_desc: torch.Tensor    # [K, F, 8] int32 packed ORB
    feat_depth: torch.Tensor   # [K, F] depth in the keyframe (-1 unknown)
    feat_point: torch.Tensor   # [K, F] int32 landmark index (-1 none)
    feat_valid: torch.Tensor   # [K, F] bool
    # --- landmarks [L] ---
    pt_pos: torch.Tensor       # [L, 3] world position
    pt_valid: torch.Tensor     # [L] bool
    pt_desc: torch.Tensor      # [L, 8] int32 representative descriptor
    pt_visible: torch.Tensor   # [L] int32 times expected visible
    pt_found: torch.Tensor     # [L] int32 times actually matched
    pt_first_kf: torch.Tensor  # [L] int32 creating keyframe slot
    pt_ref_feat: torch.Tensor  # [L] int32 flat (kf*F + feat) of the reference
                               # observation (patch source for direct projection)
    pt_obs: torch.Tensor       # [L] int32 number of observing keyframes
    # --- covisibility [K, K] ---
    cov_weight: torch.Tensor   # [K, K] int32 shared-landmark counts

    @property
    def K(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def F(self) -> int:
        return self.feat_valid.shape[1]

    @property
    def L(self) -> int:
        return self.pt_valid.shape[0]

    def kf_pose(self, k=None) -> SE3:
        """SE3 view of keyframe poses (all, or one slot)."""
        return SE3.from_params7(self.kf_pose7 if k is None else row(self.kf_pose7, k))

    def found_ratio(self) -> torch.Tensor:
        """[L] GetFoundRatio (MapPoint.h:23-25)."""
        return self.pt_found.float() / torch.clamp(self.pt_visible.float(), min=1.0)


def empty_map(K: int, F: int, L: int, device=None) -> MapState:
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    ident = torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=f32, device=dev).repeat(K, 1)
    return MapState(
        kf_pose7=ident,
        kf_valid=torch.zeros(K, dtype=torch.bool, device=dev),
        kf_id=torch.full((K,), -1, dtype=i32, device=dev),
        feat_px=torch.zeros((K, F, 2), dtype=f32, device=dev),
        feat_level=torch.zeros((K, F), dtype=i32, device=dev),
        feat_angle=torch.zeros((K, F), dtype=f32, device=dev),
        feat_desc=torch.zeros((K, F, 8), dtype=i32, device=dev),
        feat_depth=torch.full((K, F), -1.0, dtype=f32, device=dev),
        feat_point=torch.full((K, F), -1, dtype=i32, device=dev),
        feat_valid=torch.zeros((K, F), dtype=torch.bool, device=dev),
        pt_pos=torch.zeros((L, 3), dtype=f32, device=dev),
        pt_valid=torch.zeros(L, dtype=torch.bool, device=dev),
        pt_desc=torch.zeros((L, 8), dtype=i32, device=dev),
        pt_visible=torch.zeros(L, dtype=i32, device=dev),
        pt_found=torch.zeros(L, dtype=i32, device=dev),
        pt_first_kf=torch.full((L,), -1, dtype=i32, device=dev),
        pt_ref_feat=torch.full((L,), -1, dtype=i32, device=dev),
        pt_obs=torch.zeros(L, dtype=i32, device=dev),
        cov_weight=torch.zeros((K, K), dtype=i32, device=dev),
    )


def insert_keyframe(m: MapState, slot, frame_id, T_cw: SE3, feat_px, feat_level,
                    feat_angle, feat_desc, feat_depth, feat_point, feat_valid) -> MapState:
    """Write a keyframe into `slot` (Memory::RegisterKeyFrame + the feature
    recording of VisualOdometry::SetKeyframe, :187-203)."""
    return m._replace(
        kf_pose7=set_row(m.kf_pose7, slot, T_cw.params7()),
        kf_valid=set_row(m.kf_valid, slot, True),
        kf_id=set_row(m.kf_id, slot, frame_id),
        feat_px=set_row(m.feat_px, slot, feat_px),
        feat_level=set_row(m.feat_level, slot, feat_level),
        feat_angle=set_row(m.feat_angle, slot, feat_angle),
        feat_desc=set_row(m.feat_desc, slot, feat_desc),
        feat_depth=set_row(m.feat_depth, slot, feat_depth),
        feat_point=set_row(m.feat_point, slot, feat_point),
        feat_valid=set_row(m.feat_valid, slot, feat_valid),
    )


def add_landmarks(m: MapState, slots: torch.Tensor, write_mask: torch.Tensor,
                  pos: torch.Tensor, desc: torch.Tensor, first_kf,
                  ref_feat: torch.Tensor | None = None) -> MapState:
    """Scatter new landmarks into rows `slots [N]` where `write_mask [N]`
    (Memory::CreateMapPoint, Memory.cpp:45-52); the caller hands out free
    rows.  Masked rows write into a sentinel row L that is sliced off."""
    safe = torch.where(write_mask, slots.long(), m.L)
    n = slots.shape[0]

    def put(t, v):
        v = torch.as_tensor(v, dtype=t.dtype, device=t.device).expand((n,) + t.shape[1:])
        padded = torch.cat([t, torch.zeros((1,) + t.shape[1:], dtype=t.dtype, device=t.device)])
        padded[safe] = v
        return padded[:-1]

    if ref_feat is None:
        ref_feat = torch.full((n,), -1, dtype=torch.int32, device=slots.device)
    return m._replace(
        pt_pos=put(m.pt_pos, pos), pt_valid=put(m.pt_valid, True), pt_desc=put(m.pt_desc, desc),
        pt_visible=put(m.pt_visible, 1), pt_found=put(m.pt_found, 1),
        pt_first_kf=put(m.pt_first_kf, first_kf), pt_ref_feat=put(m.pt_ref_feat, ref_feat),
        pt_obs=put(m.pt_obs, 1),
    )


def observations_from_features(m: MapState):
    """Feature->landmark links flattened into BA observation tensors
    (kf_idx [K*F], pt_idx [K*F], px [K*F, 2], mask [K*F])."""
    K, F = m.feat_valid.shape
    kf_idx = torch.arange(K, dtype=torch.int32, device=m.feat_valid.device).repeat_interleave(F)
    pt_idx = m.feat_point.reshape(-1)
    pt_safe = torch.clamp(pt_idx, 0, m.L - 1)
    mask = (m.feat_valid.reshape(-1) & (pt_idx >= 0) & m.kf_valid[kf_idx.long()]
            & m.pt_valid[pt_safe.long()])
    return kf_idx, pt_safe, m.feat_px.reshape(-1, 2), mask


def _incidence(m: MapState) -> torch.Tensor:
    """[K, L] float32 0/1: keyframe k observes landmark l."""
    K, F = m.feat_valid.shape
    pt = torch.clamp(m.feat_point, 0, m.L - 1).long()
    valid = m.feat_valid & (m.feat_point >= 0) & m.kf_valid[:, None] & m.pt_valid[pt]
    kf_rows = torch.arange(K, device=pt.device)[:, None].expand(K, F)
    hits = torch.zeros((K, m.L), dtype=torch.float32, device=pt.device)
    hits.index_put_((kf_rows, pt), valid.float(), accumulate=True)
    return (hits > 0).float()


def update_covisibility(m: MapState) -> MapState:
    """Recompute the covisibility matrix and the per-landmark observation
    counts from the feature-landmark links (Frame::UpdateConnections,
    Frame.cpp:86-152, for all keyframes at once): cov[a, b] = landmarks
    observed by both a and b, a != b.  The product runs in float32, where
    counts up to L are exact (there is no int32 matmul on CUDA)."""
    inc = _incidence(m)
    cov = (inc @ inc.T).round().to(torch.int32)
    cov = cov * (1 - torch.eye(m.K, dtype=torch.int32, device=cov.device))
    return m._replace(cov_weight=cov, pt_obs=inc.sum(dim=0).to(torch.int32))


def best_covisible(m: MapState, slot, n: int):
    """Indices of the up-to-n keyframes best covisible with `slot`
    (GetBestCovisibilityKeyframes, Frame.cpp:73-78): (idx [n], valid [n])."""
    w = row(m.cov_weight, slot) * m.kf_valid.to(torch.int32)
    vals, idx = top_k(w, n)
    return idx, vals > 0
