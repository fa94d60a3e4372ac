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
from .geometry.se3 import SE3
from .map.archive import KeyframeArchive
from .map.depth_filter import Seeds
from .map.state import MapState
from .map.vocabulary import Vocabulary, from_state_dict
from .models.batch import BatchState
from .models.frontend import Features
from .models.tracking import KeyframeState
from .ops.kernels.align2d_fused import Align2DPrep
from .ops.kernels.align2d_kernel import CACHE_WIN, PATCH
from .ops.sparse_align import LevelRef, ReferencePrep
from .parallel.batch_tracking import stack_preps
from .solvers.initializer import InitResult


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=resolve_device(device))


def _like(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the port's type for it: uint32 words
    become int32 with the same bits, other integers int32, floats float32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    dtype = (torch.bool if a.dtype == np.bool_ else
             torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32)
    return _t(a, device, dtype)


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
        ref_preps=tuple(ref_preps), a2d_prep=a2d_prep, batch_ref=stack_preps(ref_preps))


def map_state_from_numpy(fields: dict, device=None) -> MapState:
    """MapState from a dict of numpy arrays named after its fields (the JAX
    MapState's `_asdict()`, say); descriptors may be uint32 or int32 words."""
    return MapState(**{name: _like(fields[name], device) for name in MapState._fields})


def map_state_to_numpy(m: MapState) -> dict:
    """The fields of a MapState as numpy arrays, descriptors as the uint32
    words the JAX package holds."""
    out = {name: t.detach().cpu().numpy() for name, t in m._asdict().items()}
    for name in ("feat_desc", "pt_desc"):
        out[name] = out[name].view(np.uint32)
    return out


def seeds_from_numpy(fields: dict, device=None) -> Seeds:
    """Seeds from a dict of numpy arrays named after its fields (the JAX
    Seeds' `_asdict()`, say)."""
    return Seeds(**{name: _like(fields[name], device) for name in Seeds._fields})


def seeds_to_numpy(seeds: Seeds) -> dict:
    """The fields of a Seeds as numpy arrays."""
    return {name: t.detach().cpu().numpy() for name, t in seeds._asdict().items()}


def archive_from_numpy(state_dict: dict, F: int, n_words: int, device=None) -> KeyframeArchive:
    """The port's KeyframeArchive holding the rows of a JAX package archive,
    from its `state_dict` (numpy, uint32 descriptors; `{}` for an empty
    archive of F features and n_words BoW words)."""
    arc = KeyframeArchive(F, n_words, device=device)
    arc.load_state_dict({k: np.asarray(v) for k, v in state_dict.items()})
    return arc


def vocabulary_from_numpy(state_dict: dict, device=None) -> Vocabulary:
    """The port's Vocabulary from the JAX package's vocabulary arrays (its
    `vocabulary.state_dict`: nodes_<level> uint32, weights, meta)."""
    return from_state_dict({k: np.asarray(v) for k, v in state_dict.items()}, device=device)


def features_from_numpy(px, level, score, angle, desc, depth, valid, device=None) -> Features:
    """Features from the JAX Features' fields as numpy arrays."""
    return Features(*(_like(a, device) for a in (px, level, score, angle, desc, depth, valid)))


def init_result_from_numpy(success, R, t, points3d, good, used_h, device=None) -> InitResult:
    """InitResult from the JAX one's fields (T21 as its R [3, 3] and t [3])."""
    return InitResult(success=_t(success, device, torch.bool),
                      T21=SE3(_t(R, device), _t(t, device)), points3d=_t(points3d, device),
                      good=_t(good, device, torch.bool), used_h=_t(used_h, device, torch.bool))


def init_result_to_numpy(res: InitResult) -> dict:
    """The fields of an InitResult as numpy arrays, T21 as R and t."""
    def np_(x):
        return x.detach().cpu().numpy()

    return dict(success=np_(res.success), R=np_(res.T21.R), t=np_(res.T21.t),
                points3d=np_(res.points3d), good=np_(res.good), used_h=np_(res.used_h))
