"""K5: pose-only bundle adjustment, all rounds in one kernel.

Counterpart of ygz_slam_tpu/ops/pallas/pose_ba_fused.py (EARLY_EXIT and
MAD_IN_KERNEL on, pinhole only).  The CUDA kernel
(csrc/pose_ba_fused.cu) replaces `_kernel`; `pose_ba_gn` is its wrapper
and `pose_ba_gn_plain` its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import Fl, I, P, _gn6, launch, launched, on_card, require, stream
from ...geometry.se3 import SE3
from ...solvers import robust

F = _gn6.F
MIN_DEPTH = 1e-2
CHI2_2D = robust.CHI2_2D
TUKEY_B = robust.TUKEY_B


def pose_ba_gn_plain(pts, px, msk, pose0, cam, chi2_th=CHI2_2D, rounds=4, iters=10,
                     eps=1e-4, stats: dict | None = None):
    """Plain version of K5.

    pts [N, 3] world points, px [N, 2] ideal-pinhole pixels, msk [N] bool
    (or 0/1), pose0 [12].  Returns ([13]: R, t, last round's chi2; inliers
    [N] 0/1).  `stats`, if given, receives "normal_eqs": the
    normal-equation passes run (the work this input needs)."""
    dev = pts.device
    msk = msk.to(torch.float32)
    X, Y, Z = pts[:, 0], pts[:, 1], pts[:, 2]
    U, V = px[:, 0], px[:, 1]
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    th = float(F(chi2_th))
    huber_k = float(np.sqrt(F(chi2_th)))

    def reproj(R, t):
        R = [float(v) for v in R]
        t = [float(v) for v in t]
        x = R[0] * X + R[1] * Y + R[2] * Z + t[0]
        y = R[3] * X + R[4] * Y + R[5] * Z + t[1]
        z = R[6] * X + R[7] * Y + R[8] * Z + t[2]
        valid = msk * (z > MIN_DEPTH).to(torch.float32)
        zi = 1.0 / torch.clamp(z, min=MIN_DEPTH)
        zi2 = zi * zi
        ru = fx * x * zi + cx - U
        rv = fy * y * zi + cy - V
        zero = torch.zeros_like(zi)
        Ju = torch.stack([fx * zi, zero, -fx * x * zi2, -fx * x * y * zi2,
                          fx * (1.0 + x * x * zi2), -fx * y * zi], dim=1)
        Jv = torch.stack([zero, fy * zi, -fy * y * zi2, -fy * (1.0 + y * y * zi2),
                          fy * x * y * zi2, fy * x * zi], dim=1)
        return ru, rv, Ju, Jv, valid

    def normal_eq(R, t, wf):
        ru, rv, Ju, Jv, valid = reproj(R, t)
        w = wf * valid
        keep = (w != 0)[:, None]             # the kernel skips zero-weight points
        wJu, wJv = w[:, None] * Ju, w[:, None] * Jv
        Hp = wJu[:, :, None] * Ju[:, None, :] + wJv[:, :, None] * Jv[:, None, :]
        H = torch.where(keep[:, :, None], Hp, 0.0).sum(0)
        bp = w[:, None] * (Ju * ru[:, None] + Jv * rv[:, None])
        b = -torch.where(keep, bp, 0.0).sum(0)
        chi2 = torch.where(keep[:, 0], w * (ru * ru + rv * rv), 0.0).sum()
        return (_gn6.upper21(H), [F(v) for v in b.cpu().numpy()], F(chi2.item()))

    def med_bisect(vals, vmask, half_cnt):
        lo, hi = F(0.0), F((vals * vmask).max().item())
        for _ in range(12):
            mid = F(0.5) * (lo + hi)
            cnt = F((vmask * (vals <= float(mid)).to(torch.float32)).sum().item())
            if cnt >= half_cnt:
                hi = mid
            else:
                lo = mid
        return F(0.5) * (lo + hi)

    R, t = _gn6.pose_from_tensor(pose0)
    inlier = msk.clone()
    chi2_out = F(0.0)
    n_eq = 0
    for round_i in range(rounds):
        ru, rv, _, _, valid = reproj(R, t)
        valid0 = valid * inlier
        rn = torch.sqrt(ru * ru + rv * rv)
        if round_i == 0:
            half_cnt = F(0.5) * F(valid0.sum().item())
            med = med_bisect(rn, valid0, half_cnt)
            mad = med_bisect(torch.abs(rn - float(med)), valid0, half_cnt)
            sigma0 = max(F(robust.MAD_SCALE) * mad, F(1.0))
            xw = rn / float(sigma0 * F(TUKEY_B))
            wt = 1.0 - xw * xw
            w = torch.where(torch.abs(xw) < 1.0, wt * wt, 0.0)
        elif round_i < rounds - 1:
            w = torch.where(rn <= huber_k, 1.0, huber_k / torch.clamp(rn, min=1e-12))
        else:
            w = torch.ones_like(rn)
        wf = w * valid0

        H21, bv, chi2 = normal_eq(R, t, wf)
        n_eq += 1
        for _ in range(iters):
            n_eq += 1
            dx = _gn6.subst6(_gn6.chol6(H21), bv)
            conv = max(abs(d) for d in dx) < F(eps)
            Rn, tn = _gn6.retract_left(R, t, dx)
            Hn, bn, chi2n = normal_eq(Rn, tn, wf)
            worse = not (chi2n <= chi2)          # a NaN trial counts as worse
            if not worse:
                R, t, H21, bv, chi2 = Rn, tn, Hn, bn, chi2n
            if worse or conv:
                break
        chi2_out = chi2

        ru, rv, _, _, valid = reproj(R, t)
        new = valid * ((ru * ru + rv * rv) < th).to(torch.float32)
        if new.sum().item() > 0.5:               # else keep the old inlier set
            inlier = new
    if stats is not None:
        stats["normal_eqs"] = n_eq
    return _gn6.pose_to_tensor(R, t, chi2_out, dev), inlier


def pose_ba_gn(pts, px, msk, pose0, cam, chi2_th=CHI2_2D, rounds=4, iters=10, eps=1e-4):
    """K5 on the card, its plain version on the CPU; arguments as for
    `pose_ba_gn_plain`, except that on the card msk must be bool: the
    kernel's counts take each point's weight as 0 or 1."""
    if not on_card(pts):
        return pose_ba_gn_plain(pts, px, msk, pose0, cam, chi2_th, rounds, iters, eps)
    N = pts.shape[0]
    dev = pts.device
    require(pts, "pts", torch.float32, (N, 3), dev)
    require(px, "px", torch.float32, (N, 2), dev)
    require(msk, "msk", torch.bool, (N,), dev)
    require(pose0, "pose0", torch.float32, (12,), dev)
    out = torch.empty(13, dtype=torch.float32, device=dev)
    inl = torch.empty(N, dtype=torch.float32, device=dev)
    scratch = torch.empty(N, dtype=torch.float32, device=dev)
    launch("pose_ba_fused", "pose_ba_fused_launch", [P] * 7 + [I] + [Fl] * 5 + [I, I, Fl, P],
           pts.data_ptr(), px.data_ptr(), msk.data_ptr(), pose0.data_ptr(), out.data_ptr(),
           inl.data_ptr(), scratch.data_ptr(), N, cam.fx, cam.fy, cam.cx, cam.cy, chi2_th,
           rounds, iters, eps, stream(dev))
    launched(pose_ba_gn, pts, px, msk, pose0, cam, chi2_th, rounds, iters, eps)
    return out, inl


pose_ba_gn.launches = 0


def pose_ba_args(T_cw: SE3, points: torch.Tensor, px: torch.Tensor,
                 mask: torch.Tensor, cam) -> tuple:
    """K5's inputs: (pts, px, msk, pose0, cam) in the kernel's layout."""
    pose0 = torch.cat([T_cw.R.reshape(9), T_cw.t.reshape(3)]).to(torch.float32).contiguous()
    return (points.contiguous(), px.to(torch.float32).contiguous(),
            mask.to(torch.bool).contiguous(), pose0, cam)


def pose_only_ba_fused(T_cw: SE3, points: torch.Tensor, px: torch.Tensor,
                       mask: torch.Tensor, cam, rounds: int = 4,
                       iters_per_round: int = 10, chi2_th: float = CHI2_2D,
                       eps: float = 1e-4):
    """Pose-only BA (pinhole).  Returns (SE3, inlier mask [N] bool, chi2)."""
    out, inl = pose_ba_gn(*pose_ba_args(T_cw, points, px, mask, cam), chi2_th,
                          rounds, iters_per_round, eps)
    return SE3(out[:9].reshape(3, 3), out[9:12]), inl > 0.5, out[12]
