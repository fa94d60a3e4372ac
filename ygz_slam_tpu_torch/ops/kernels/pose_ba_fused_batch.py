"""K8: S independent pose-only bundle adjustments in one kernel.

Counterpart of ygz_slam_tpu/ops/pallas/pose_ba_fused_batch.py.  The CUDA
kernel (csrc/pose_ba_fused_batch.cu) runs K5's body once per sequence,
one CTA each; `pose_ba_batch_gn` is its wrapper and
`pose_ba_batch_gn_plain` its plain version, K5's plain version once per
sequence.  Each sequence's result is the single-pose solve's, as in the
JAX kernel, whose shared loop freezes every sequence once it stops.
"""
from __future__ import annotations

import torch

from . import Fl, I, P, launch, launched, on_card, require, stream
from .pose_ba_fused import CHI2_2D, pose_ba_gn_plain
from ...geometry.se3 import SE3


def pose_ba_batch_gn_plain(pts, px, msk, pose0, cam, chi2_th=CHI2_2D, rounds=4, iters=10,
                           eps=1e-4, stats: dict | None = None):
    """Plain version of K8.

    pts [S, N, 3], px [S, N, 2] ideal-pinhole pixels, msk [S, N] bool,
    pose0 [S, 12].  Returns ([S, 13]: R, t, last round's chi2 per
    sequence; inliers [S, N] 0/1).  `stats`, if given, receives
    "normal_eqs": the normal-equation passes run, per sequence."""
    outs, inls, n_eq = [], [], []
    for s in range(pts.shape[0]):
        st = {}
        out, inl = pose_ba_gn_plain(pts[s], px[s], msk[s], pose0[s], cam, chi2_th, rounds,
                                    iters, eps, stats=st)
        outs.append(out)
        inls.append(inl)
        n_eq.append(st["normal_eqs"])
    if stats is not None:
        stats["normal_eqs"] = n_eq
    return torch.stack(outs), torch.stack(inls)


def pose_ba_batch_gn(pts, px, msk, pose0, cam, chi2_th=CHI2_2D, rounds=4, iters=10,
                     eps=1e-4):
    """K8 on the card, its plain version on the CPU; arguments as for
    `pose_ba_batch_gn_plain`, msk bool on the card (as for K5)."""
    if not on_card(pts):
        return pose_ba_batch_gn_plain(pts, px, msk, pose0, cam, chi2_th, rounds, iters, eps)
    S, N = msk.shape
    dev = pts.device
    require(pts, "pts", torch.float32, (S, N, 3), dev)
    require(px, "px", torch.float32, (S, N, 2), dev)
    require(msk, "msk", torch.bool, (S, N), dev)
    require(pose0, "pose0", torch.float32, (S, 12), dev)
    out = torch.empty((S, 13), dtype=torch.float32, device=dev)
    inl = torch.empty((S, N), dtype=torch.float32, device=dev)
    scratch = torch.empty((S, N), dtype=torch.float32, device=dev)
    launch("pose_ba_fused_batch", "pose_ba_fused_batch_launch",
           [P] * 7 + [I, I] + [Fl] * 5 + [I, I, Fl, P],
           pts.data_ptr(), px.data_ptr(), msk.data_ptr(), pose0.data_ptr(), out.data_ptr(),
           inl.data_ptr(), scratch.data_ptr(), S, N, cam.fx, cam.fy, cam.cx, cam.cy, chi2_th,
           rounds, iters, eps, stream(dev))
    launched(pose_ba_batch_gn, pts, px, msk, pose0, cam, chi2_th, rounds, iters, eps)
    return out, inl


pose_ba_batch_gn.launches = 0


def pose_ba_batch_args(T_cw: SE3, points: torch.Tensor, px: torch.Tensor,
                       mask: torch.Tensor, cam) -> tuple:
    """K8's inputs: (pts, px, msk, pose0, cam) in the kernel's layout, from
    a batched pose T_cw [S] and per-sequence points [S, N, 3], pixels
    [S, N, 2] and mask [S, N]."""
    S = points.shape[0]
    pose0 = torch.cat([T_cw.R.reshape(S, 9), T_cw.t.reshape(S, 3)], dim=1)
    return (points.to(torch.float32).contiguous(), px.to(torch.float32).contiguous(),
            mask.to(torch.bool).contiguous(), pose0.to(torch.float32).contiguous(), cam)


def pose_only_ba_fused_batch(T_cw: SE3, points: torch.Tensor, px: torch.Tensor,
                             mask: torch.Tensor, cam, rounds: int = 4,
                             iters_per_round: int = 10, chi2_th: float = CHI2_2D,
                             eps: float = 1e-4):
    """S pose-only BAs (pinhole).  Returns (SE3 batched [S], inlier mask
    [S, N] bool, chi2 [S])."""
    out, inl = pose_ba_batch_gn(*pose_ba_batch_args(T_cw, points, px, mask, cam), chi2_th,
                                rounds, iters_per_round, eps)
    S = out.shape[0]
    return SE3(out[:, :9].reshape(S, 3, 3), out[:, 9:12]), inl > 0.5, out[:, 12]
