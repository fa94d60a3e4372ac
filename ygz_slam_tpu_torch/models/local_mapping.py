"""Local mapping: new-landmark triangulation, landmark fusion, local BA
over the map and culling (counterpart of
ygz_slam_tpu/models/local_mapping.py).

All steps are pure functions over MapState with fixed shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3
from ..geometry.se3 import SE3
from ..geometry.triangulation import depth_from_triangulation
from ..map import state as ms
from ..ops import hamming
from ..solvers import ba as bam
from ..solvers.robust import CHI2_2D


def match_new_features_for_triangulation(
        cam, desc_new, px_new, valid_new, T_new: SE3,
        desc_ref, px_ref, valid_ref, T_ref: SE3,
        max_dist: int = 50, epipolar_sigma: float = 1.5,
        min_parallax_cos: float = 0.9998, angle_new=None, angle_ref=None, dist=None):
    """Descriptor-match unlinked features of a new keyframe against a
    neighbour keyframe, gate by the known epipolar geometry, and triangulate
    (Matcher::SearchForTriangulation + the core of CreateNewMapPoints; the
    all-pairs Hamming matrix stands in for the BoW gating).  `dist`, if
    given, is that matrix, `hamming.distance_matrix(desc_new, desc_ref)`,
    computed by the caller; the descriptors are then not read (and may be
    None).

    Returns (pos_world [N, 3], good [N], ref_idx [N]) for the new
    keyframe's feature rows."""
    idx, ok = hamming.match_nn(desc_new, desc_ref, valid_new, valid_ref,
                               max_dist=max_dist, ratio=0.9, d=dist)
    idx_safe = torch.clamp(idx, 0, px_ref.shape[0] - 1).long()
    if angle_new is not None and angle_ref is not None:
        ok = hamming.rotation_consistency(angle_new, angle_ref[idx_safe], ok)
    p_ref = px_ref[idx_safe]
    # Epipolar check from the known poses: angular distance of the ref
    # bearing from the epipolar plane of the new feature.
    T_rn = T_ref.compose(T_new.inverse())
    f_new = cam.pixel_to_bearing(px_new)
    f_ref = cam.pixel_to_bearing(p_ref)
    E = so3.hat(T_rn.t) @ T_rn.R
    l_ref = torch.einsum("ij,nj->ni", E, f_new)
    dist = torch.abs(torch.sum(f_ref * l_ref, dim=-1)) / torch.clamp(
        torch.linalg.norm(l_ref[:, :2], dim=-1), min=1e-9)
    ep_ok = dist * cam.fx < 3.0 * epipolar_sigma
    # Parallax + triangulation.
    T_nr = T_new.compose(T_ref.inverse())
    depth_ref, tri_ok = depth_from_triangulation(T_nr, f_ref, f_new)
    cosp = torch.sum(f_new * torch.einsum("ij,nj->ni", T_nr.R, f_ref), dim=-1)
    pos_world = T_ref.inverse().apply(f_ref * depth_ref[:, None])
    # Reprojection gate in both views.
    e_n = torch.sum((cam.world_to_pixel(pos_world, T_new) - px_new) ** 2, dim=-1)
    e_r = torch.sum((cam.world_to_pixel(pos_world, T_ref) - p_ref) ** 2, dim=-1)
    z_new = T_new.apply(pos_world)[:, 2]
    good = (ok & ep_ok & tri_ok & (depth_ref > 0.05) & (z_new > 0.05)
            & (cosp < min_parallax_cos) & (e_n < CHI2_2D) & (e_r < CHI2_2D))
    return pos_world, good, idx_safe


def search_in_neighbors(m: ms.MapState, cam, slot, max_dist: int = 50,
                        radius: float = 6.0) -> ms.MapState:
    """Fuse the new keyframe's unlinked features with existing landmarks:
    project every valid landmark into the keyframe, match descriptors within
    a pixel radius, and link.  A landmark the keyframe already observes is
    never re-linked, at most one feature links to any landmark (the reverse
    argmin must point back), and ambiguous matches are dropped by a Lowe
    ratio test."""
    T = m.kf_pose(slot)
    proj = cam.world_to_pixel(m.pt_pos, T)                    # [L, 2]
    z = T.apply(m.pt_pos)[:, 2]
    fp = ms.row(m.feat_point, slot)
    f_valid = ms.row(m.feat_valid, slot)
    fp_safe = torch.clamp(fp, 0, m.L - 1).long()
    # Accumulating scatter: the unlinked rows all clip to 0 and must not
    # overwrite a hit with a miss.
    observed_here = torch.zeros(m.L, dtype=torch.float32, device=z.device).index_put_(
        (fp_safe,), (f_valid & (fp >= 0)).float(), accumulate=True) > 0
    cand = m.pt_valid & (z > 0.05) & ~observed_here
    f_px = ms.row(m.feat_px, slot)                            # [F, 2]
    f_free = f_valid & (fp < 0)
    d2 = torch.sum((f_px[:, None, :] - proj[None, :, :]) ** 2, dim=-1)
    near = d2 < radius * radius
    dd = hamming.distance_matrix(ms.row(m.feat_desc, slot), m.pt_desc)
    dd = torch.where(near & cand[None, :] & f_free[:, None], dd, hamming.BIG)
    best, best_d, second_d = hamming.best_two(dd)
    rev_best = torch.argmin(dd, dim=0)                        # [L]
    mutual = rev_best[best] == torch.arange(dd.shape[0], device=dd.device)
    link = (f_free & (best_d <= max_dist) & (best_d.float() < 0.9 * second_d.float())
            & mutual)
    new_fp = torch.where(link, best.to(torch.int32), fp)
    new_fd = torch.where(link, z[best], ms.row(m.feat_depth, slot))
    return m._replace(feat_point=ms.set_row(m.feat_point, slot, new_fp),
                      feat_depth=ms.set_row(m.feat_depth, slot, new_fd))


class MappingResult(NamedTuple):
    """A mapping pass's outcome: the map, the landmarks culled and local
    BA's final chi2."""
    map: ms.MapState
    n_culled: torch.Tensor
    ba_chi2: torch.Tensor


def map_point_culling(m: ms.MapState, min_found_ratio: float = 0.25, min_obs: int = 2,
                      grace_kf: int = 2) -> ms.MapState:
    """Invalidate unreliable landmarks (MapPointCulling,
    LocalMapping.cpp:348-373): found ratio below 0.25 once seen 4 times, or
    too few observing keyframes after a grace period; culled landmarks are
    unlinked from their features."""
    ratio_bad = m.found_ratio() < min_found_ratio
    seen_enough = m.pt_visible >= 4
    obs_bad = (m.pt_obs < min_obs) & (m.pt_visible >= 2 + grace_kf)
    cull = m.pt_valid & ((ratio_bad & seen_enough) | obs_bad)
    pt_valid = m.pt_valid & ~cull
    pt_safe = torch.clamp(m.feat_point, 0, m.L - 1).long()
    linked_ok = pt_valid[pt_safe] & (m.feat_point >= 0)
    return m._replace(pt_valid=pt_valid, feat_point=torch.where(linked_ok, m.feat_point, -1))


def keyframe_culling_scores(m: ms.MapState) -> torch.Tensor:
    """Redundancy score per keyframe: the share of its landmarks seen by at
    least 3 other keyframes (KeyFrameCulling's 90% rule,
    LocalMapping.cpp:579-618)."""
    pt_safe = torch.clamp(m.feat_point, 0, m.L - 1).long()
    linked = m.feat_valid & (m.feat_point >= 0) & m.pt_valid[pt_safe]
    redundant = linked & (m.pt_obs[pt_safe] >= 4)             # self + 3 others
    n_linked = torch.clamp(torch.sum(linked, dim=1), min=1)
    return torch.sum(redundant, dim=1) / n_linked


def local_ba_on_map(m: ms.MapState, cam, fixed_slots: torch.Tensor, n_iter: int = 10):
    """Windowed BA over every valid keyframe and landmark of the map
    (LocalMapping::LocalBA -> ba::LocalBAG2O, BA.cpp:386-543), written back
    into the map: only valid keyframes and landmarks move.  fixed_slots [K]
    bool are gauge-fixed.  Returns (map, chi2)."""
    kf_idx, pt_idx, px, mask = ms.observations_from_features(m)
    obs = bam.Observations(kf_idx=kf_idx, pt_idx=pt_idx, px=px, mask=mask)
    res = bam.local_ba(m.kf_pose(), m.pt_pos, obs, cam, fixed_slots | ~m.kf_valid,
                       n_iter=n_iter)
    pose7 = torch.where(m.kf_valid[:, None], res.poses.params7(), m.kf_pose7)
    pts = torch.where(m.pt_valid[:, None], res.points, m.pt_pos)
    return m._replace(kf_pose7=pose7, pt_pos=pts), res.chi2
