"""K3: all pyramid levels of sparse-direct alignment in one kernel.

Counterpart of ygz_slam_tpu/ops/pallas/sparse_align_mega.py.  The CUDA
kernel (csrc/sparse_align_mega.cu) replaces `_mega_kernel`; `mega_gn` is
its wrapper and `mega_gn_plain` its plain version.  Windows are gathered
at the frame-init pose, SLACK px at each level's own scale: by K1 here, or
beforehand by the caller (K6 through `sparse_align.gather_frame_windows`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import Fl, I, P, _gn6, launch, launched, on_card, require, stream
from .align2d_kernel import gather_windows

# Geometry of the TPU kernel (ops/pallas/sparse_align_fused.py), kept here.
CWIN = 16                      # cached window side
PATCH = 4                      # 4x4 patch
SUP = PATCH + 1                # 5x5 bilinear support
SLACK = (CWIN - SUP) // 2      # 5 px at the level's scale
_HALF = (PATCH - 1) / 2.0      # 1.5: patch grid arange(4) - 1.5
_MARGIN = float(PATCH // 2 + 2)
MAX_ITER = 12                  # GN iterations per level, at most
STOP_STEP = 1e-4               # a level stops once max|dx| falls below this


def level_dims(H0: int, W0: int, li: int) -> tuple[int, int]:
    """Pyramid level li's shape (each level halves with ceil)."""
    for _ in range(li):
        H0, W0 = (H0 + 1) // 2, (W0 + 1) // 2
    return H0, W0


class MegaWindows(NamedTuple):
    """K3's windows of every level, gathered at the frame-init pose, with
    the origins they start at and that pose's projection."""
    wins: torch.Tensor     # [L, N, CWIN, CWIN]
    ox: torch.Tensor       # [L, N] int32 window origins
    oy: torch.Tensor       # [L, N] int32
    pc0: torch.Tensor      # [N, 3] reference points in the init camera
    px0_l0: torch.Tensor   # [N, 2] their level-0 pixels


def mega_window_requests(cur_pyr, p_ref, R0, t0, cam, distorted: bool, n_levels: int):
    """The reference points projected at the frame-init pose, and each
    level's (img, ox, oy, CWIN) gather request around them.  Returns (pc0,
    px0_l0, requests)."""
    pc0 = p_ref @ R0.T + t0
    px0_l0 = torch.nan_to_num(cam.camera_to_pixel(pc0, distorted=distorted))
    reqs = []
    for li in range(n_levels):
        img = cur_pyr[li]
        Hl, Wl = img.shape
        px0 = px0_l0 / (2.0 ** li)
        ox = torch.clamp(torch.floor(px0[:, 0] - _HALF) - SLACK, 0, Wl - CWIN).to(torch.int32)
        oy = torch.clamp(torch.floor(px0[:, 1] - _HALF) - SLACK, 0, Hl - CWIN).to(torch.int32)
        reqs.append((img, ox, oy, CWIN))
    return pc0, px0_l0, reqs


def mega_windows(pc0, px0_l0, reqs, wins) -> MegaWindows:
    """The MegaWindows of `mega_window_requests`' output and the windows
    fetched for its requests (per level [N, CWIN, CWIN])."""
    return MegaWindows(torch.stack(tuple(wins)), torch.stack([r[1] for r in reqs]),
                       torch.stack([r[2] for r in reqs]), pc0, px0_l0)


def _distortion(cam, distorted: bool) -> tuple[float, float, float, float]:
    return (cam.k1, cam.k2, cam.p1, cam.p2) if distorted else (0.0, 0.0, 0.0, 0.0)


def used_rows(J: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """J [N, 16, 6] with the rows outside `m [N]` set to 0.  The kernel never
    reads a masked row; a product with a 0 weight would, and a masked row
    may hold anything (a landmark row at depth ~0 has Jacobians whose
    squares overflow, and inf * 0 is NaN)."""
    return torch.where(m[:, None, None], J, 0.0)


def frozen_h0(J, vis, pc0, px0, Hl: int, Wl: int) -> torch.Tensor:
    """H0 = J^T W0 J over the points usable at the level-init pose: visible,
    in front (z > 1e-3) and inside the kernel's image margin.  Masked rows
    are never read (they may hold anything)."""
    margin = PATCH // 2 + 2
    w0 = (vis & (pc0[:, 2] > 1e-3) & (px0[:, 0] >= margin) & (px0[:, 0] < Wl - 1 - margin)
          & (px0[:, 1] >= margin) & (px0[:, 1] < Hl - 1 - margin))
    J0 = used_rows(J, w0)
    return torch.einsum("npa,npb->ab", J0, J0)


def level_passes(w_l, rp_l, J_l, vis, ox_l, oy_l, p_ref, cam, distorted: bool,
                 Hl: int, Wl: int, scale: float):
    """The per-pose passes of one level's GN loop, as the kernels run them
    (shared by the plain versions of K3 and K9): `usable(R, t)` -> (mask,
    window-relative support origin x, y) and `residuals(R, t, with_h)` ->
    (H 21-list or None, b 6-list, chi2), host float32 scalars.  w_l [N,
    16, 16] windows, rp_l [N, 16] patches, J_l [N, 16, 6], vis [N] bool,
    ox_l / oy_l [N] window origins; R, t are 9- and 3-lists."""
    N = vis.shape[0]
    dev = w_l.device
    k1, k2, p1, p2 = _distortion(cam, distorted)
    prx, pry, prz = p_ref[:, 0], p_ref[:, 1], p_ref[:, 2]
    fxs, fys, cxs, cys = cam.fx * scale, cam.fy * scale, cam.cx * scale, cam.cy * scale
    oxf, oyf = ox_l.to(torch.float32), oy_l.to(torch.float32)
    ar = torch.arange(SUP, device=dev)
    rows_n = torch.arange(N, device=dev)[:, None, None]

    def usable(R, t):
        R = [float(v) for v in R]
        t = [float(v) for v in t]
        x = R[0] * prx + R[1] * pry + R[2] * prz + t[0]
        y = R[3] * prx + R[4] * pry + R[5] * prz + t[1]
        z = R[6] * prx + R[7] * pry + R[8] * prz + t[2]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        xn = x / zs
        yn = y / zs
        r2 = xn * xn + yn * yn
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
        yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
        u = fxs * xd + cxs
        v = fys * yd + cys
        okc = (vis & (z > 1e-3) & (u >= _MARGIN) & (u < Wl - 1.0 - _MARGIN)
               & (v >= _MARGIN) & (v < Hl - 1.0 - _MARGIN))
        fxw = u - _HALF - oxf
        fyw = v - _HALF - oyf
        inwin = (fxw >= 0.0) & (fxw <= CWIN - SUP) & (fyw >= 0.0) & (fyw <= CWIN - SUP)
        return okc & inwin, fxw, fyw

    def residuals(R, t, with_h: bool = False):
        m, fxw, fyw = usable(R, t)
        fxw = torch.clamp(fxw, 0.0, float(CWIN - SUP))
        fyw = torch.clamp(fyw, 0.0, float(CWIN - SUP))
        x0 = torch.floor(fxw)
        y0 = torch.floor(fyw)
        ax = (fxw - x0)[:, None, None]
        ay = (fyw - y0)[:, None, None]
        sub = w_l[rows_n, (y0.long()[:, None] + ar)[:, :, None],
                  (x0.long()[:, None] + ar)[:, None, :]]          # [N, 5, 5]
        cur = ((1 - ax) * (1 - ay) * sub[:, :4, :4] + ax * (1 - ay) * sub[:, :4, 1:]
               + (1 - ax) * ay * sub[:, 1:, :4] + ax * ay * sub[:, 1:, 1:])
        r = torch.where(m[:, None], cur.reshape(N, PATCH * PATCH) - rp_l, 0.0)
        Jm = used_rows(J_l, m)
        bv = -torch.einsum("npa,np->a", Jm, r)
        num = torch.sum(r * r)
        den = torch.clamp(torch.sum(m).to(torch.float32) * (PATCH * PATCH), min=1.0)
        h = _gn6.upper21(torch.einsum("npa,npb->ab", Jm, Jm)) if with_h else None
        return h, [_gn6.F(v) for v in bv.cpu().numpy()], _gn6.F((num / den).item())

    return usable, residuals


def mega_gn_plain(wins, refp, jac, p_ref, lvis, ox, oy, pose0, cam, distorted,
                  H0, W0, stats: dict | None = None):
    """Plain version of K3.

    wins [L, N, 16, 16], refp [L, N, 16], jac [L, N, 16, 6], p_ref [N, 3],
    lvis [L, N] (0/1), ox/oy [L, N] int32 window origins, pose0 [12]
    (R row-major, t).  Returns [13]: R, t, chi2 of the finest level.
    `stats`, if given, receives "passes": the residual passes run per
    level, coarse to fine (the work this input needs)."""
    L = lvis.shape[0]
    R, t = _gn6.pose_from_tensor(pose0)
    chi2 = _gn6.F(0.0)
    passes = []
    for li in range(L - 1, -1, -1):
        Hl, Wl = level_dims(H0, W0, li)
        usable, residuals = level_passes(wins[li], refp[li], jac[li], lvis[li] > 0.5, ox[li],
                                         oy[li], p_ref, cam, distorted, Hl, Wl,
                                         1.0 / float(2 ** li))
        # Hessian frozen at the level-init pose and visibility.
        J0 = used_rows(jac[li], usable(R, t)[0])
        Lc = _gn6.chol6(_gn6.upper21(torch.einsum("npa,npb->ab", J0, J0)))
        _, bv, chi2 = residuals(R, t)
        passes.append(1)
        for _ in range(MAX_ITER):
            passes[-1] += 1
            dx = _gn6.subst6(Lc, bv)
            conv = max(abs(d) for d in dx) < _gn6.F(STOP_STEP)
            Rn, tn = _gn6.retract_right(R, t, dx)
            _, bn, chi2n = residuals(Rn, tn)
            worse = not (chi2n <= chi2)          # a NaN trial counts as worse
            if not worse:
                R, t, bv, chi2 = Rn, tn, bn, chi2n
            if worse or conv:
                break
    if stats is not None:
        stats["passes"] = passes
    return _gn6.pose_to_tensor(R, t, chi2, wins.device)


def mega_gn(wins, refp, jac, p_ref, lvis, ox, oy, pose0, cam, distorted, H0, W0):
    """K3 on the card, its plain version on the CPU; arguments as for
    `mega_gn_plain`."""
    if not on_card(wins):
        return mega_gn_plain(wins, refp, jac, p_ref, lvis, ox, oy, pose0, cam,
                             distorted, H0, W0)
    L, N = lvis.shape
    dev = wins.device
    require(wins, "wins", torch.float32, (L, N, CWIN, CWIN), dev)
    require(refp, "refp", torch.float32, (L, N, PATCH * PATCH), dev)
    require(jac, "jac", torch.float32, (L, N, PATCH * PATCH, 6), dev)
    require(p_ref, "p_ref", torch.float32, (N, 3), dev)
    require(lvis, "lvis", torch.float32, (L, N), dev)
    require(ox, "ox", torch.int32, (L, N), dev)
    require(oy, "oy", torch.int32, (L, N), dev)
    require(pose0, "pose0", torch.float32, (12,), dev)
    out = torch.empty(13, dtype=torch.float32, device=dev)
    threads = min(1024, max(32, -(-N // 32) * 32))
    k1, k2, p1, p2 = _distortion(cam, distorted)
    launch("sparse_align_mega", "sparse_align_mega_launch",
           [P] * 9 + [I] * 4 + [Fl] * 8 + [I, Fl, I, P],
           wins.data_ptr(), refp.data_ptr(), jac.data_ptr(), p_ref.data_ptr(),
           lvis.data_ptr(), ox.data_ptr(), oy.data_ptr(), pose0.data_ptr(), out.data_ptr(),
           N, L, H0, W0, cam.fx, cam.fy, cam.cx, cam.cy, k1, k2, p1, p2, MAX_ITER, STOP_STEP,
           threads, stream(dev))
    launched(mega_gn, wins, refp, jac, p_ref, lvis, ox, oy, pose0, cam, distorted, H0, W0)
    return out


mega_gn.launches = 0


def mega_args(cur_pyr, level_refs, p_ref, R0, t0, cam, distorted: bool, n_levels: int,
              mega_refp, mega_jl, pregathered: MegaWindows | None = None):
    """K3's inputs for one frame: the windows of every level gathered (K1)
    at the frame-init pose, or `pregathered` (fetched at that pose
    beforehand, by K6), plus the keyframe constants (`mega_refp` /
    `mega_jl`: every level's patches and Jacobians stacked, as
    ReferencePrep holds them).  Returns (args of `mega_gn`, the
    MegaWindows)."""
    mw = pregathered
    if mw is None:
        pc0, px0_l0, reqs = mega_window_requests(cur_pyr, p_ref, R0, t0, cam, distorted,
                                                 n_levels)
        mw = mega_windows(pc0, px0_l0, reqs, [gather_windows(*r) for r in reqs])
    lvis = torch.stack([level_refs[li].vis for li in range(n_levels)]).to(torch.float32)
    pose0 = torch.cat([R0.reshape(9), t0.reshape(3)]).to(torch.float32).contiguous()
    H0, W0 = cur_pyr[0].shape
    args = (mw.wins, mega_refp, mega_jl, p_ref.contiguous(), lvis, mw.ox, mw.oy, pose0, cam,
            distorted, H0, W0)
    return args, mw


def sparse_align_mega(cur_pyr, level_refs, p_ref, R0, t0, cam, distorted: bool,
                      max_level: int, mega_refp, mega_jl, pregathered=None):
    """All levels max_level..0 of sparse-direct alignment in one kernel.

    Windows for every level are gathered (K1) at the frame-init pose,
    unless `pregathered` (a MegaWindows) holds them.  Returns (R, t, chi2,
    H) with H the finest level's frozen Hessian (Fisher information for
    AlignStats, a plain product here)."""
    args, mw = mega_args(cur_pyr, level_refs, p_ref, R0, t0, cam, distorted, max_level + 1,
                         mega_refp, mega_jl, pregathered)
    pc0, px0_l0 = mw.pc0, mw.px0_l0
    out = mega_gn(*args)
    H0, W0 = cur_pyr[0].shape
    R, t, chi2 = out[:9].reshape(3, 3), out[9:12], out[12]
    return R, t, chi2, frozen_h0(level_refs[0].J, level_refs[0].vis, pc0, px0_l0, H0, W0)
