"""K4: batched 8x8 patch alignment, the whole Gauss-Newton loop in one
kernel.

Counterpart of ygz_slam_tpu/ops/pallas/align2d_fused.py (default path:
DELTA_ROLLS on, EARLY_EXIT off).  The CUDA kernel
(csrc/align2d_fused.cu) replaces `_fused_kernel`; `a2d_gn` is its wrapper
and `a2d_gn_plain` its plain version.  The prep keeps natural layouts
([N, 8, 8] patches, [N, 3, 3] inverses) instead of the TPU's lane packs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import Fl, I, P, launch, launched, on_card, require, stream
from .align2d_kernel import CACHE_SLACK, CACHE_WIN, PATCH, gather_windows

_HALF = (PATCH - 1) / 2.0                 # 3.5
_LIM = float(CACHE_WIN - PATCH - 1)       # 23: lattice clamp inside the cache


class A2DWindows(NamedTuple):
    """Cache windows fetched beforehand (K2 on the batch path, K6 through
    `sparse_align.gather_frame_windows`), with the origins they were
    fetched at."""
    wins: torch.Tensor    # [N, 32, 32]
    ox: torch.Tensor      # [N] int32 window origins
    oy: torch.Tensor      # [N] int32


class Align2DPrep(NamedTuple):
    """Pose-independent side of align2d; computed once per keyframe."""
    ref: torch.Tensor    # [N, 8, 8] reference patch
    jx: torch.Tensor     # [N, 8, 8] x-gradient
    jy: torch.Tensor     # [N, 8, 8] y-gradient
    hinv: torch.Tensor   # [N, 3, 3] inverse of the damped 3x3 normal matrix


def align2d_prepare(ref_patch_border: torch.Tensor) -> Align2DPrep:
    """Reference patch, central-difference gradients and inverse normal
    matrix from [N, 10, 10] bordered patches."""
    b = ref_patch_border
    N = b.shape[0]
    ref = b[:, 1:-1, 1:-1]
    dx = 0.5 * (b[:, 1:-1, 2:] - b[:, 1:-1, :-2])
    dy = 0.5 * (b[:, 2:, 1:-1] - b[:, :-2, 1:-1])
    J = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1).reshape(N, -1, 3)
    H3 = torch.einsum("npa,npb->nab", J, J)
    eye = torch.eye(3, dtype=b.dtype, device=b.device)
    hinv = torch.linalg.inv(H3 + 1e-6 * eye)
    return Align2DPrep(ref.contiguous(), dx.contiguous(), dy.contiguous(),
                       hinv.contiguous())


def a2d_window_origins(center_xy: torch.Tensor, H, W):
    """Cache-window origins (int32) for patch centers [N, 2] in images of
    H x W pixels: ints, or [N] tensors where each point has an image size
    of its own (the levels of a pyramid)."""
    def origin(c, size):
        o = torch.clamp(torch.floor(c - _HALF) - CACHE_SLACK, min=0)
        return torch.clamp(o, max=size - CACHE_WIN)      # a number or a tensor bound

    return (origin(center_xy[:, 0], W).to(torch.int32),
            origin(center_xy[:, 1], H).to(torch.int32))


def a2d_gn_plain(wins, ref, jx, jy, hinv, ox, oy, xy0, n_iter=10, conv_eps=0.03,
                 clamp_step: bool = True, exit_frozen: bool = False,
                 stats: dict | None = None):
    """Plain version of K4 (clamp_step True: each step clamped to +-1 px)
    and of K11's second stage (clamp_step False: the unclamped loop of
    ops/pallas/track_fused.py).

    wins [N, 32, 32], ref/jx/jy [N, 8, 8], hinv [N, 3, 3], ox/oy [N] int32,
    xy0 [N, 2].  Returns [N, 4]: x, y, mean offset, final mean |r|.  Every
    point runs n_iter iterations, its updates gated off once it is frozen,
    as the JAX kernel runs them; with `exit_frozen` each iteration takes
    only the points not yet frozen and the loop ends once all are (the
    kernels leave a point's loop once it is frozen), which must give the
    same bits.  `stats`, if given, receives "iterations" [N]: the iterations
    each point ran up to the one that froze it (n_iter if none did)."""
    N = xy0.shape[0]
    dev = wins.device
    oxf, oyf = ox.to(torch.float32), oy.to(torch.float32)
    ref = ref.reshape(N, -1)
    jx = jx.reshape(N, -1)
    jy = jy.reshape(N, -1)
    h = hinv.reshape(N, 9)
    ar = torch.arange(PATCH + 1, device=dev)

    def residual(i, x, y, mean):
        """Residuals [len(i), 64] of the points i at (x, y, mean) [len(i)]."""
        fx = torch.clamp(x - _HALF - oxf[i], 0.0, _LIM)
        fy = torch.clamp(y - _HALF - oyf[i], 0.0, _LIM)
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        ax = (fx - x0)[:, None, None]
        ay = (fy - y0)[:, None, None]
        sub = wins[i[:, None, None], (y0.long()[:, None] + ar)[:, :, None],
                   (x0.long()[:, None] + ar)[:, None, :]]           # [n, 9, 9]
        cur = ((1 - ax) * (1 - ay) * sub[:, :PATCH, :PATCH] + ax * (1 - ay) * sub[:, :PATCH, 1:]
               + (1 - ax) * ay * sub[:, 1:, :PATCH] + ax * ay * sub[:, 1:, 1:])
        return cur.reshape(len(i), -1) - ref[i] + mean[:, None]

    x, y = xy0[:, 0].clone(), xy0[:, 1].clone()
    mean = torch.zeros(N, dtype=torch.float32, device=dev)
    frozen = torch.zeros(N, dtype=torch.bool, device=dev)
    iters = torch.full((N,), n_iter, dtype=torch.int64, device=dev)
    every = torch.arange(N, device=dev)
    for it in range(n_iter):
        i = torch.nonzero(~frozen)[:, 0] if exit_frozen else every
        if len(i) == 0:
            break
        e = residual(i, x[i], y[i], mean[i])
        gx = torch.sum(e * jx[i], dim=1)
        gy = torch.sum(e * jy[i], dim=1)
        gm = torch.sum(e, dim=1)
        hi = h[i]
        du = hi[:, 0] * gx + hi[:, 1] * gy + hi[:, 2] * gm
        dv = hi[:, 3] * gx + hi[:, 4] * gy + hi[:, 5] * gm
        dm = hi[:, 6] * gx + hi[:, 7] * gy + hi[:, 8] * gm
        small = du * du + dv * dv < conv_eps * conv_eps
        if clamp_step:                       # <= 1 px per iteration
            du = torch.clamp(du, -1.0, 1.0)
            dv = torch.clamp(dv, -1.0, 1.0)
        act = ~small & ~frozen[i]            # a step that freezes is not applied
        x[i] = torch.where(act, x[i] - du, x[i])
        y[i] = torch.where(act, y[i] - dv, y[i])
        mean[i] = torch.where(act, mean[i] - dm, mean[i])
        iters[i] = torch.where(small & ~frozen[i], it + 1, iters[i])
        frozen[i] = frozen[i] | small
    if stats is not None:
        stats["iterations"] = iters
    err = torch.sum(torch.abs(residual(every, x, y, mean)), dim=1) / float(PATCH * PATCH)
    return torch.stack([x, y, mean, err], dim=1)


def a2d_gn(wins, ref, jx, jy, hinv, ox, oy, xy0, n_iter=10, conv_eps=0.03):
    """K4 on the card, its plain version on the CPU; arguments as for
    `a2d_gn_plain`."""
    if not on_card(wins):
        return a2d_gn_plain(wins, ref, jx, jy, hinv, ox, oy, xy0, n_iter, conv_eps)
    N = xy0.shape[0]
    dev = wins.device
    require(wins, "wins", torch.float32, (N, CACHE_WIN, CACHE_WIN), dev)
    for name, a in (("ref", ref), ("jx", jx), ("jy", jy)):
        require(a, name, torch.float32, (N, PATCH, PATCH), dev)
    require(hinv, "hinv", torch.float32, (N, 3, 3), dev)
    require(ox, "ox", torch.int32, (N,), dev)
    require(oy, "oy", torch.int32, (N,), dev)
    require(xy0, "xy0", torch.float32, (N, 2), dev)
    out = torch.empty((N, 4), dtype=torch.float32, device=dev)
    launch("align2d_fused", "align2d_fused_launch", [P] * 9 + [I, I, Fl, P],
           wins.data_ptr(), ref.data_ptr(), jx.data_ptr(), jy.data_ptr(), hinv.data_ptr(),
           ox.data_ptr(), oy.data_ptr(), xy0.data_ptr(), out.data_ptr(), N, n_iter,
           conv_eps * conv_eps, stream(dev))
    launched(a2d_gn, wins, ref, jx, jy, hinv, ox, oy, xy0, n_iter, conv_eps)
    return out


a2d_gn.launches = 0


def a2d_args(cur_img: torch.Tensor, prep: Align2DPrep, xy_init: torch.Tensor,
             pregathered: A2DWindows | None = None) -> tuple:
    """K4's inputs: one 32x32 window per point gathered (K1) around
    `xy_init`, or the `pregathered` ones, plus the keyframe prep.  Returns
    the args of `a2d_gn`."""
    xy_init = xy_init.to(torch.float32).contiguous()
    if pregathered is None:
        ox, oy = a2d_window_origins(xy_init, *cur_img.shape)
        wins = gather_windows(cur_img, ox, oy, CACHE_WIN)
    else:
        wins, ox, oy = pregathered.wins, pregathered.ox, pregathered.oy
    return wins, prep.ref, prep.jx, prep.jy, prep.hinv, ox, oy, xy_init


def align2d_fused(cur_img: torch.Tensor, prep: Align2DPrep, xy_init: torch.Tensor,
                  n_iter: int = 10, conv_eps: float = 0.03,
                  pregathered: A2DWindows | None = None):
    """Cached-window align2d: one 32x32 window per point (K1) centered on
    `xy_init`, or the `pregathered` ones, then the GN loop (K4).  Returns
    (xy [N, 2], mean [N], err [N]); the caller rejects drift beyond
    CACHE_SLACK."""
    out = a2d_gn(*a2d_args(cur_img, prep, xy_init, pregathered), n_iter, conv_eps)
    return out[:, :2], out[:, 2], out[:, 3]
