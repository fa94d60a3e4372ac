"""Brings keyframe state of the JAX package across, as numpy arrays.

The JAX package's prepared state (ReferencePrep, Align2DPrep) carries
TPU lane packs beside natural layouts; this module takes the natural
fields and unpacks what exists only packed, so both packages can be fed
identical keyframe state.  It takes numpy arrays only: nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .geometry.camera import PinholeCamera
from .models.batch import BatchState
from .models.tracking import KeyframeState
from .ops.kernels.align2d_fused import Align2DPrep
from .ops.kernels.align2d_kernel import CACHE_WIN, PATCH
from .ops.sparse_align import LevelRef, ReferencePrep


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=resolve_device(device))


def camera_from_numpy(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> PinholeCamera:
    """PinholeCamera from the JAX camera's (0-d array) fields."""
    return PinholeCamera.create(*(float(np.asarray(v)) for v in (fx, fy, cx, cy, k1, k2, p1, p2)))


def reference_prep_from_numpy(p_ref, levels, device) -> ReferencePrep:
    """ReferencePrep from `p_ref [N, 3]` and, per level, (vis [N],
    ref_patch [N, 16], J [N, 16, 6]) in the JAX LevelRef's natural fields."""
    lrs = tuple(LevelRef(vis=_t(vis, device, torch.bool), ref_patch=_t(rp, device),
                         J=_t(J, device)) for vis, rp, J in levels)
    return ReferencePrep(p_ref=_t(p_ref, device), levels=lrs,
                         mega_refp=torch.stack([lr.ref_patch for lr in lrs]).contiguous(),
                         mega_jl=torch.stack([lr.J for lr in lrs]).contiguous())


def align2d_prep_from_numpy(ref, jx, jy, hinv, device) -> Align2DPrep:
    """Align2DPrep from the JAX one: patch lanes [N, 1024] hold entry
    (r, c) at lane 32r + c; hinv [N, 16] holds the row-major 3x3 inverse in
    its first 9 lanes."""
    def unpack(a):
        a = np.asarray(a)
        return _t(a.reshape(a.shape[0], CACHE_WIN, CACHE_WIN)[:, :PATCH, :PATCH], device)

    h = np.asarray(hinv)
    return Align2DPrep(ref=unpack(ref), jx=unpack(jx), jy=unpack(jy),
                       hinv=_t(h[:, :9].reshape(-1, 3, 3), device))


def keyframe_state_from_numpy(cam: PinholeCamera, ref_pyr, px, depth, mask, pts_w,
                              patches, ref_prep: ReferencePrep,
                              a2d_prep: Align2DPrep, device) -> KeyframeState:
    """KeyframeState from numpy arrays plus converted preps."""
    return KeyframeState(
        cam=cam, ref_pyr=tuple(_t(lv, device) for lv in ref_pyr), px=_t(px, device),
        depth=_t(depth, device), mask=_t(mask, device, torch.bool),
        pts_w=_t(pts_w, device), patches=_t(patches, device),
        ref_prep=ref_prep, a2d_prep=a2d_prep)


def batch_state_from_numpy(cam: PinholeCamera, ref_pyrs, px, depth, mask, pts_w, patches,
                           ref_preps, a2d_prep: Align2DPrep, device) -> BatchState:
    """BatchState of the multi-sequence path from numpy arrays (ref_pyrs
    per level [S, h, w]; px [S, N, 2] and so on) plus converted preps: one
    ReferencePrep per sequence (`reference_prep_from_numpy`) and one
    Align2DPrep of the S*N flattened patches (`align2d_prep_from_numpy`)."""
    return BatchState(
        cam=cam, ref_pyrs=tuple(_t(lv, device) for lv in ref_pyrs), px=_t(px, device),
        depth=_t(depth, device), mask=_t(mask, device, torch.bool),
        pts_w=_t(pts_w, device), patches=_t(patches, device),
        ref_preps=tuple(ref_preps), a2d_prep=a2d_prep)
