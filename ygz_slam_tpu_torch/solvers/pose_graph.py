"""Pose-graph optimisation over relative SE(3) and Sim(3) constraints
(counterpart of ygz_slam_tpu/solvers/pose_graph.py: `PoseGraphEdges`,
`edge_residuals`, `optimize`, `edges_from_covisibility`, and the Sim(3)
half, `Sim3Edges`, `edge_residuals_sim3`, `optimize_sim3`,
`sim3_edges_from_covisibility`, `correct_landmarks_sim3`).

After a verified loop, keyframe poses are corrected by minimising
sum_e w_e ||log(T_meas_e T_i T_j^-1)||^2 over covisibility and loop edges:
Gauss-Newton with first-order Jacobians (J_i = Ad(T_meas), J_j = -Ad(T_meas
T_i T_j^-1)), the dense [dK, dK] normal equations (d = 6 for SE(3), 7 for
Sim(3), whose scale absorbs a monocular map's scale drift), the gauge fixed
on chosen poses, a step kept only if it lowers chi2.

Everything stays on the device with no host sync: the solve is
`torch.linalg.solve_ex` and a failed or non-finite step is zeroed.  The
d x d blocks are summed per block by a segmented reduction over the
contributions sorted once per call (no float atomics, so the card repeats
bit for bit), in the order the JAX package's scatter-adds take them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry import sim3 as sim3m
from ..geometry.se3 import SE3
from ..geometry.sim3 import Sim3
from .ba import _segments, segment_sum


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] int32 source keyframe index
    j: torch.Tensor       # [E] int32 target keyframe index
    T_ji7: torch.Tensor   # [E, 7] measured T_j * T_i^-1 (params7)
    weight: torch.Tensor  # [E] information scale
    mask: torch.Tensor    # [E] bool


def _take(poses: SE3, idx: torch.Tensor) -> SE3:
    return SE3(poses.R[idx], poses.t[idx])


def edge_residuals(poses: SE3, edges: PoseGraphEdges) -> torch.Tensor:
    """[E, 6] residual log(T_meas * T_i * T_j^-1) per edge."""
    i, j = edges.i.long(), edges.j.long()
    err = SE3.from_params7(edges.T_ji7).compose(_take(poses, i)).compose(
        _take(poses, j).inverse())
    return se3m.log(err)


def _by_key(keys: torch.Tensor, n: int):
    """Segments of the rows of `keys` (values in [0, n)) grouped by key,
    each in row order."""
    key_s, order = torch.sort(keys, stable=True)
    return _segments(key_s, order, torch.arange(n + 1, device=keys.device))


def _blocks(r, Ji, Jj, edges, fixed, H_seg, b_seg):
    """(H [K, K, d, d], b [K, d], chi2) from the edges' residuals r [E, d]
    and Jacobians J_i, J_j [E, d, d]: the blocks summed by `H_seg` and
    `b_seg`, the gauge (1e6 on fixed poses, 1e-6 on every pose) on the
    diagonal."""
    K = fixed.shape[0]
    d = r.shape[-1]
    i, j = edges.i.long(), edges.j.long()
    w = torch.where(edges.mask, edges.weight, 0.0)
    free = (~fixed).to(r.dtype)
    Ji = Ji * free[i][:, None, None]
    Jj = Jj * free[j][:, None, None]
    wJi, wJj = Ji * w[:, None, None], Jj * w[:, None, None]
    Hii = wJi.transpose(-1, -2) @ Ji
    Hjj = wJj.transpose(-1, -2) @ Jj
    Hij = wJi.transpose(-1, -2) @ Jj
    blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
    H = segment_sum(blocks, H_seg).reshape(K, K, d, d)
    bi = -(wJi.transpose(-1, -2) @ r[..., None])[..., 0]
    bj = -(wJj.transpose(-1, -2) @ r[..., None])[..., 0]
    b = segment_sum(torch.cat([bi, bj]), b_seg)
    chi2 = torch.sum(w * torch.sum(r * r, dim=-1))
    # Gauge: identity blocks for fixed poses.
    ar = torch.arange(K, device=r.device)
    eye = torch.eye(d, dtype=r.dtype, device=r.device)
    H[ar, ar] += eye[None] * (fixed.to(r.dtype)[:, None, None] * 1e6 + 1e-6)
    return H, b, chi2


def _normal_equations(pose7, edges: PoseGraphEdges, fixed, H_seg, b_seg):
    """(H [K, K, 6, 6], b [K, 6], chi2) at `pose7`."""
    p = SE3.from_params7(pose7)
    i, j = edges.i.long(), edges.j.long()
    T_meas = SE3.from_params7(edges.T_ji7)
    err = T_meas.compose(_take(p, i)).compose(_take(p, j).inverse())
    return _blocks(se3m.log(err), se3m.adjoint(T_meas), -se3m.adjoint(err), edges, fixed,
                   H_seg, b_seg)


def _solve_step(H, b, eye):
    """The Gauss-Newton step of the dense system (H + 1e-6 I) dx = b
    ([K, d]), a non-finite one zeroed."""
    K, d = b.shape
    Hm = H.permute(0, 2, 1, 3).reshape(d * K, d * K)
    dx, _ = torch.linalg.solve_ex(Hm + 1e-6 * eye, b.reshape(-1))
    return torch.where(torch.isfinite(dx), dx, 0.0).reshape(K, d)


def _graph_segments(edges, K: int):
    i, j = edges.i.long(), edges.j.long()
    return (_by_key(torch.cat([i * K + i, j * K + j, i * K + j, j * K + i]), K * K),
            _by_key(torch.cat([i, j]), K))


def _chi2(pose7, edges: PoseGraphEdges) -> torch.Tensor:
    r = edge_residuals(SE3.from_params7(pose7), edges)
    w = torch.where(edges.mask, edges.weight, 0.0)
    return torch.sum(w * torch.sum(r * r, dim=-1))


def optimize(poses: SE3, edges: PoseGraphEdges, fixed: torch.Tensor,
             n_iter: int = 20) -> tuple[SE3, torch.Tensor]:
    """Gauss-Newton pose-graph solve; returns (poses, final chi2).  Each
    iteration assembles and solves the dense [6K, 6K] system
    (H + 1e-6 I) dx = b, zeroes a non-finite step and the fixed poses'
    steps, retracts every pose by exp(dx_k) T_k and keeps the result only
    if chi2 falls."""
    K = fixed.shape[0]
    dev = fixed.device
    H_seg, b_seg = _graph_segments(edges, K)
    eye = torch.eye(6 * K, dtype=torch.float32, device=dev)
    pose7 = poses.params7()
    chi2 = torch.full((), float("inf"), dtype=pose7.dtype, device=dev)
    for _ in range(n_iter):
        H, b, chi2_cur = _normal_equations(pose7, edges, fixed, H_seg, b_seg)
        dx = _solve_step(H, b, eye)
        dx = dx * (~fixed)[:, None].to(dx.dtype)
        pose7_new = se3m.boxplus(SE3.from_params7(pose7), dx).params7()
        chi2_new = _chi2(pose7_new, edges)
        accept = chi2_new < chi2_cur
        pose7 = torch.where(accept, pose7_new, pose7)
        chi2 = torch.where(accept, chi2_new, chi2_cur)
    return SE3.from_params7(pose7), chi2


def edges_from_covisibility(kf_pose7: torch.Tensor, cov_weight: torch.Tensor,
                            kf_valid: torch.Tensor, min_weight: int = 10) -> PoseGraphEdges:
    """One edge per keyframe pair (i < j, both valid) with covisibility at
    least `min_weight`, measured at the current relative pose, weighted by
    sqrt(max(cov, 1)); the K x K pairs all, the rest masked."""
    K = kf_valid.shape[0]
    dev = kf_valid.device
    ii, jj = torch.meshgrid(torch.arange(K, device=dev), torch.arange(K, device=dev),
                            indexing="ij")
    mask = (ii < jj) & kf_valid[ii] & kf_valid[jj] & (cov_weight >= min_weight)
    poses = SE3.from_params7(kf_pose7)
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    T_ji = _take(poses, jj).compose(_take(poses, ii).inverse())
    w = torch.sqrt(torch.clamp(cov_weight.to(torch.float32), min=1.0))
    return PoseGraphEdges(i=ii.to(torch.int32), j=jj.to(torch.int32), T_ji7=T_ji.params7(),
                          weight=w.reshape(-1), mask=mask.reshape(-1))


class Sim3Edges(NamedTuple):
    """Edges of a 7-DoF similarity pose graph (monocular loop closure: each
    keyframe's scale is free, so a loop correction absorbs scale drift)."""
    i: torch.Tensor       # [E] int32 source keyframe index
    j: torch.Tensor       # [E] int32 target keyframe index
    S_ji8: torch.Tensor   # [E, 8] measured S_j * S_i^-1 (params8)
    weight: torch.Tensor  # [E] information scale
    mask: torch.Tensor    # [E] bool


def _take_sim3(poses: Sim3, idx: torch.Tensor) -> Sim3:
    return Sim3(poses.R[idx], poses.t[idx], poses.s[idx])


def edge_residuals_sim3(poses: Sim3, edges: Sim3Edges) -> torch.Tensor:
    """[E, 7] residual log(S_meas * S_i * S_j^-1) per edge."""
    i, j = edges.i.long(), edges.j.long()
    err = Sim3.from_params8(edges.S_ji8).compose(_take_sim3(poses, i)).compose(
        _take_sim3(poses, j).inverse())
    return sim3m.log(err)


def _normal_equations_sim3(pose8, edges: Sim3Edges, fixed, H_seg, b_seg):
    """(H [K, K, 7, 7], b [K, 7], chi2) at `pose8`."""
    p = Sim3.from_params8(pose8)
    i, j = edges.i.long(), edges.j.long()
    S_meas = Sim3.from_params8(edges.S_ji8)
    err = S_meas.compose(_take_sim3(p, i)).compose(_take_sim3(p, j).inverse())
    return _blocks(sim3m.log(err), sim3m.adjoint(S_meas), -sim3m.adjoint(err), edges, fixed,
                   H_seg, b_seg)


def _chi2_sim3(pose8, edges: Sim3Edges) -> torch.Tensor:
    r = edge_residuals_sim3(Sim3.from_params8(pose8), edges)
    w = torch.where(edges.mask, edges.weight, 0.0)
    return torch.sum(w * torch.sum(r * r, dim=-1))


def optimize_sim3(poses: Sim3, edges: Sim3Edges, fixed: torch.Tensor,
                  n_iter: int = 20) -> tuple[Sim3, torch.Tensor]:
    """Gauss-Newton Sim(3) pose-graph solve; returns (poses, final chi2).
    `optimize` with 7-dim tangent blocks, J_i = Ad(S_meas), J_j =
    -Ad(S_meas S_i S_j^-1) and the dense [7K, 7K] system; a fixed pose pins
    the rigid gauge and the global scale."""
    K = fixed.shape[0]
    dev = fixed.device
    H_seg, b_seg = _graph_segments(edges, K)
    eye = torch.eye(7 * K, dtype=torch.float32, device=dev)
    pose8 = poses.params8()
    chi2 = torch.full((), float("inf"), dtype=pose8.dtype, device=dev)
    for _ in range(n_iter):
        H, b, chi2_cur = _normal_equations_sim3(pose8, edges, fixed, H_seg, b_seg)
        dx = _solve_step(H, b, eye)
        dx = dx * (~fixed)[:, None].to(dx.dtype)
        pose8_new = sim3m.boxplus(Sim3.from_params8(pose8), dx).params8()
        chi2_new = _chi2_sim3(pose8_new, edges)
        accept = chi2_new < chi2_cur
        pose8 = torch.where(accept, pose8_new, pose8)
        chi2 = torch.where(accept, chi2_new, chi2_cur)
    return Sim3.from_params8(pose8), chi2


def sim3_edges_from_covisibility(kf_pose7: torch.Tensor, cov_weight: torch.Tensor,
                                 kf_valid: torch.Tensor, min_weight: int = 10) -> Sim3Edges:
    """`edges_from_covisibility` lifted into Sim(3) with unit relative scale
    (odometry measures no scale change; only loop edges carry one)."""
    e = edges_from_covisibility(kf_pose7, cov_weight, kf_valid, min_weight)
    return Sim3Edges(i=e.i, j=e.j, S_ji8=Sim3.from_se3(SE3.from_params7(e.T_ji7)).params8(),
                     weight=e.weight, mask=e.mask)


def correct_landmarks_sim3(pt_pos: torch.Tensor, anchor_kf: torch.Tensor,
                           old_pose7: torch.Tensor, new_sim38: torch.Tensor) -> torch.Tensor:
    """Landmarks [L, 3] re-anchored after a Sim(3) correction: each moves
    (and rescales) with its anchor keyframe, p' = S_cw_new^-1(T_cw_old(p))
    (ORB-SLAM's CorrectLoop map-point update)."""
    a = torch.clamp(anchor_kf, 0, old_pose7.shape[0] - 1).long()
    T_old = SE3.from_params7(old_pose7[a])
    S_new = Sim3.from_params8(new_sim38[a])
    return S_new.inverse().apply(T_old.apply(pt_pos))
