"""K9: one pyramid level of sparse-direct alignment in one kernel, in two
variants (counterpart of ygz_slam_tpu/ops/pallas/sparse_align_fused.py).

The CUDA kernels (csrc/sparse_align_fused.cu) replace `_kernel` (v1: the
normal equations recomputed and refactored every iteration) and
`_kernel_v2` (v2: substitutions only, against the Cholesky factor of H0,
the Hessian frozen at the level-init pose).  `level_gn` / `level_gn_v2` are
their wrappers, `level_gn_plain` / `level_gn_v2_plain` their plain
versions, and `level_align_fused` / `level_align_fused_v2` the JAX
package's entry points: windows gathered by K1 around the level-init
projection, then one launch.  `ops.sparse_align` runs them level by level
under FUSED_VARIANT 1 and 2.
"""
from __future__ import annotations

import torch

from . import Fl, I, P, _gn6, launch, launched, on_card, require, stream
from .align2d_kernel import gather_windows
from .sparse_align_mega import (CWIN, MAX_ITER, PATCH, SLACK, STOP_STEP, _HALF, _distortion,
                                frozen_h0, level_passes)

_NPIX = PATCH * PATCH


def level_gn_plain(wins, refp, jac, p_ref, vis, ox, oy, pose0, cam, distorted, Hl, Wl, level,
                   stats: dict | None = None):
    """Plain version of K9 v1.

    wins [N, 16, 16], refp [N, 16], jac [N, 16, 6], p_ref [N, 3], vis [N]
    (0/1), ox/oy [N] int32 window origins, pose0 [12] (R row-major, t), Hl
    / Wl the level's shape.  Returns [34]: R, t, chi2 and the 21
    upper-triangular H entries of the last accepted state.  `stats`, if
    given, receives "passes": the normal-equation passes run."""
    _, residuals = level_passes(wins, refp, jac, vis > 0.5, ox, oy, p_ref, cam, distorted,
                                Hl, Wl, 1.0 / float(2 ** level))
    R, t = _gn6.pose_from_tensor(pose0)
    h, bv, chi2 = residuals(R, t, with_h=True)
    passes = 1
    for _ in range(MAX_ITER):
        passes += 1
        dx = _gn6.subst6(_gn6.chol6(h), bv)
        conv = max(abs(d) for d in dx) < _gn6.F(STOP_STEP)
        Rn, tn = _gn6.retract_right(R, t, dx)
        hn, bn, chi2n = residuals(Rn, tn, with_h=True)
        worse = not (chi2n <= chi2)              # a NaN trial counts as worse
        if not worse:
            R, t, h, bv, chi2 = Rn, tn, hn, bn, chi2n
        if worse or conv:
            break
    if stats is not None:
        stats["passes"] = passes
    out = _gn6.pose_to_tensor(R, t, chi2, wins.device)
    return torch.cat([out, torch.tensor(h, dtype=torch.float32, device=wins.device)])


def level_gn_v2_plain(wins, refp, jac, p_ref, vis, ox, oy, pose0, lfac, cam, distorted, Hl,
                      Wl, level, stats: dict | None = None):
    """Plain version of K9 v2: arguments as for `level_gn_plain` plus lfac
    [21], the lower-triangular Cholesky factor of the frozen H0, row-major.
    Returns [13]: R, t, chi2."""
    _, residuals = level_passes(wins, refp, jac, vis > 0.5, ox, oy, p_ref, cam, distorted,
                                Hl, Wl, 1.0 / float(2 ** level))
    lf = [_gn6.F(v) for v in lfac.detach().cpu().numpy()]
    Lc = [[_gn6.F(0.0)] * 6 for _ in range(6)]
    k = 0
    for i in range(6):
        for q in range(i + 1):
            Lc[i][q] = lf[k]
            k += 1
    R, t = _gn6.pose_from_tensor(pose0)
    _, bv, chi2 = residuals(R, t)
    passes = 1
    for _ in range(MAX_ITER):
        passes += 1
        dx = _gn6.subst6(Lc, bv)
        conv = max(abs(d) for d in dx) < _gn6.F(STOP_STEP)
        Rn, tn = _gn6.retract_right(R, t, dx)
        _, bn, chi2n = residuals(Rn, tn)
        worse = not (chi2n <= chi2)
        if not worse:
            R, t, bv, chi2 = Rn, tn, bn, chi2n
        if worse or conv:
            break
    if stats is not None:
        stats["passes"] = passes
    return _gn6.pose_to_tensor(R, t, chi2, wins.device)


def _check_level_args(wins, refp, jac, p_ref, vis, ox, oy, pose0):
    N = vis.shape[0]
    dev = wins.device
    require(wins, "wins", torch.float32, (N, CWIN, CWIN), dev)
    require(refp, "refp", torch.float32, (N, _NPIX), dev)
    require(jac, "jac", torch.float32, (N, _NPIX, 6), dev)
    require(p_ref, "p_ref", torch.float32, (N, 3), dev)
    require(vis, "vis", torch.float32, (N,), dev)
    require(ox, "ox", torch.int32, (N,), dev)
    require(oy, "oy", torch.int32, (N,), dev)
    require(pose0, "pose0", torch.float32, (12,), dev)
    return N, dev, min(1024, max(32, -(-N // 32) * 32))


def level_gn(wins, refp, jac, p_ref, vis, ox, oy, pose0, cam, distorted, Hl, Wl, level):
    """K9 v1 on the card, its plain version on the CPU; arguments as for
    `level_gn_plain`."""
    if not on_card(wins):
        return level_gn_plain(wins, refp, jac, p_ref, vis, ox, oy, pose0, cam, distorted, Hl,
                              Wl, level)
    N, dev, threads = _check_level_args(wins, refp, jac, p_ref, vis, ox, oy, pose0)
    out = torch.empty(13 + 21, dtype=torch.float32, device=dev)
    launch("sparse_align_fused", "level_align_v1_launch",
           [P] * 9 + [I] * 3 + [Fl] * 9 + [I, Fl, I, P],
           wins.data_ptr(), refp.data_ptr(), jac.data_ptr(), p_ref.data_ptr(), vis.data_ptr(),
           ox.data_ptr(), oy.data_ptr(), pose0.data_ptr(), out.data_ptr(), N, Hl, Wl,
           1.0 / float(2 ** level), cam.fx, cam.fy, cam.cx, cam.cy, *_distortion(cam, distorted),
           MAX_ITER, STOP_STEP, threads, stream(dev))
    launched(level_gn, wins, refp, jac, p_ref, vis, ox, oy, pose0, cam, distorted, Hl, Wl,
             level)
    return out


level_gn.launches = 0


def level_gn_v2(wins, refp, jac, p_ref, vis, ox, oy, pose0, lfac, cam, distorted, Hl, Wl,
                level):
    """K9 v2 on the card, its plain version on the CPU; arguments as for
    `level_gn_v2_plain`."""
    if not on_card(wins):
        return level_gn_v2_plain(wins, refp, jac, p_ref, vis, ox, oy, pose0, lfac, cam,
                                 distorted, Hl, Wl, level)
    N, dev, threads = _check_level_args(wins, refp, jac, p_ref, vis, ox, oy, pose0)
    require(lfac, "lfac", torch.float32, (21,), dev)
    out = torch.empty(13, dtype=torch.float32, device=dev)
    launch("sparse_align_fused", "level_align_v2_launch",
           [P] * 10 + [I] * 3 + [Fl] * 9 + [I, Fl, I, P],
           wins.data_ptr(), refp.data_ptr(), jac.data_ptr(), p_ref.data_ptr(), vis.data_ptr(),
           ox.data_ptr(), oy.data_ptr(), pose0.data_ptr(), lfac.data_ptr(), out.data_ptr(), N,
           Hl, Wl, 1.0 / float(2 ** level), cam.fx, cam.fy, cam.cx, cam.cy,
           *_distortion(cam, distorted), MAX_ITER, STOP_STEP, threads, stream(dev))
    launched(level_gn_v2, wins, refp, jac, p_ref, vis, ox, oy, pose0, lfac, cam, distorted, Hl,
             Wl, level)
    return out


level_gn_v2.launches = 0


def frozen_factor(H0: torch.Tensor) -> torch.Tensor:
    """The v2 factor of the JAX package: cholesky(H0 + 1e-8 I) with no pivot
    floor, the identity where the factorization failed, and any non-finite
    entry replaced by the identity's (sparse_align_fused.py:648-649).
    `cholesky_ex` neither raises nor waits for the device.  Returns the 21
    lower-triangular entries, row-major."""
    eye = torch.eye(6, dtype=H0.dtype, device=H0.device)
    Lm, info = torch.linalg.cholesky_ex(H0 + 1e-8 * eye)
    Lm = torch.where((info == 0) & torch.isfinite(Lm), Lm, eye)
    il, jl = torch.tril_indices(6, 6, device=H0.device)
    return Lm[il, jl].contiguous()


def level_args(cur_img, level_ref, p_ref, R0, t0, cam, level: int, distorted: bool):
    """K9's inputs for one level (everything but v2's factor): the points
    projected at the level-init pose (R0, t0), each one's 16x16 window
    gathered by K1 with its origin SLACK px up-left of the support and
    clamped inside the image, and the keyframe constants.  Returns (args
    of `level_gn`, the level-init camera points pc0 [N, 3], their level
    pixels px0 [N, 2])."""
    Hl, Wl = cur_img.shape
    pc0 = p_ref @ R0.T + t0
    px0 = torch.nan_to_num(cam.camera_to_pixel(pc0, distorted=distorted) / (2.0 ** level))
    ox = torch.clamp(torch.floor(px0[:, 0] - _HALF) - SLACK, 0, Wl - CWIN).to(torch.int32)
    oy = torch.clamp(torch.floor(px0[:, 1] - _HALF) - SLACK, 0, Hl - CWIN).to(torch.int32)
    wins = gather_windows(cur_img, ox, oy, CWIN)
    pose0 = torch.cat([R0.reshape(9), t0.reshape(3)]).to(torch.float32).contiguous()
    args = (wins, level_ref.ref_patch, level_ref.J, p_ref.contiguous(),
            level_ref.vis.to(torch.float32), ox, oy, pose0, cam, distorted, Hl, Wl, level)
    return args, pc0, px0


def _unpack(out):
    return out[:9].reshape(3, 3), out[9:12], out[12]


def _sym6(h21: torch.Tensor) -> torch.Tensor:
    iu, ju = torch.triu_indices(6, 6, device=h21.device)
    H = torch.zeros((6, 6), dtype=h21.dtype, device=h21.device).index_put((iu, ju), h21)
    return H + torch.triu(H, 1).T


def level_align_fused(cur_img, level_ref, p_ref, R0, t0, cam, level: int,
                      distorted: bool = True):
    """One pyramid level of sparse-direct alignment, v1.  cur_img [Hl, Wl]
    the current image at this level, level_ref its LevelRef (vis, 4x4
    reference patches, Jacobians), p_ref [N, 3] reference-camera points,
    (R0, t0) the init T_cur_ref.  Returns (R, t, chi2, H [6, 6] at the
    last accepted state)."""
    args, _, _ = level_args(cur_img, level_ref, p_ref, R0, t0, cam, level, distorted)
    out = level_gn(*args)
    R, t, chi2 = _unpack(out)
    return R, t, chi2, _sym6(out[13:34])


def level_align_fused_v2(cur_img, level_ref, p_ref, R0, t0, cam, level: int,
                         distorted: bool = True):
    """`level_align_fused` with the frozen-Hessian kernel: H0 assembled at
    the level-init visibility and factored once here (`frozen_factor`),
    substitutions only in the kernel.  Returns (R, t, chi2, H0)."""
    args, pc0, px0 = level_args(cur_img, level_ref, p_ref, R0, t0, cam, level, distorted)
    Hl, Wl = cur_img.shape
    H0 = frozen_h0(level_ref.J, level_ref.vis, pc0, px0, Hl, Wl)
    out = level_gn_v2(*args[:8], frozen_factor(H0), *args[8:])
    R, t, chi2 = _unpack(out)
    return R, t, chi2, H0
