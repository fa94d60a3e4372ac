"""Distributed bundle adjustment: landmark blocks sharded over a mesh, the
reduced camera system summed over it (counterpart of
ygz_slam_tpu/parallel/sharded_ba.py).

Each rank holds its shards' landmark rows and the observations of those
landmarks (the host partitions the table by landmark, `partition_observations`);
the K poses are replicated.  Per LM iteration:
  1. per shard: residuals, Jacobians, the camera blocks Hcc, the landmark
     blocks Hll, the coupling W, the gradients and chi2, under IRLS weights
     frozen at the iteration's start, every block a segmented sum over the
     observation rows sorted once per call (`solvers/ba.block_segments`):
     no float atomics, so a solve repeats bit for bit;
  2. per shard: the landmarks' share of the reduced system,
     -W Hll^-1 W^T and -W Hll^-1 bl;
  3. one reduction (`mesh.reduce_sum`: over the rank's shards, then one
     all_reduce) of S, b_red, Hcc and chi2: (K^2 * 36 + 42 K + 1) floats,
     whatever the landmark count;
  4. the gauge-fixed [6K, 6K] solve, replicated on every rank;
  5. the landmark back-substitution, local to its shard;
  6. a second reduction, of the new chi2, and the accept / reject and the
     damping schedule, decided on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from ..map.memory import partition_obs
from ..solvers import ba
from .mesh import Mesh, reduce_sum


class ShardedObs(NamedTuple):
    """Observations partitioned by landmark shard: rows [s * O_shard,
    (s + 1) * O_shard) belong to shard s; pt_idx is local to the shard
    (0 .. L_shard - 1)."""
    kf_idx: torch.Tensor   # [O] int32, global keyframe index
    pt_idx: torch.Tensor   # [O] int32, shard-local landmark index
    px: torch.Tensor       # [O, 2]
    mask: torch.Tensor     # [O] bool


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def partition_observations(kf_idx, pt_idx, px, mask, L: int, n_shards: int, device=None):
    """Group the observation table by landmark shard on the host, each shard
    padded to the largest count: landmark row l belongs to shard
    l // L_shard, with L_pad = ceil(L / n_shards) * n_shards rows in all, so
    callers shard the (zero-padded) landmark array by rows.  Returns
    (ShardedObs of every shard on `device`, the card unless the caller names
    another; L_pad)."""
    dev = resolve_device(device)
    out_kf, out_pt, out_px, out_mask, _ = partition_obs(
        _numpy(kf_idx), _numpy(pt_idx), _numpy(px), _numpy(mask), L, n_shards)
    sobs = ShardedObs(*(torch.from_numpy(a).to(dev) for a in (out_kf, out_pt, out_px, out_mask)))
    return sobs, -(-L // n_shards) * n_shards


def _shard_chi2(poses, points, obs, cam, w_frozen, n):
    """Each shard's chi2 [n] under the frozen weights."""
    r, _, _, valid = ba.reproject(poses, points, obs, cam)
    w = torch.where(valid, w_frozen, 0.0)
    return torch.sum((w * torch.sum(r * r, dim=-1)).reshape(n, -1), dim=1)


def sharded_local_ba(mesh: Mesh, poses: SE3, points: torch.Tensor, obs: ShardedObs, cam,
                     fixed_pose: torch.Tensor, n_iter: int = 10, huber_delta: float = 2.447,
                     stats: dict | None = None):
    """Distributed Schur-complement BA over `mesh`.

    poses: SE3 [K], the same on every rank; points: this rank's landmark rows
    [local * L_shard, 3] (`mesh.local_rows` of the padded array); obs: this
    rank's rows of `partition_observations`' table, raw pixels (undistorted
    here, at the solver boundary); fixed_pose [K] bool, gauge-fixed cameras.
    Returns (poses, this rank's landmark rows, chi2).  `stats`, if given,
    receives per iteration "chi2" [n_iter] (at its start), "chi2_new"
    [n_iter] (at its trial step) and "accept" [n_iter] bool."""
    n = mesh.local
    if points.shape[0] % n or obs.kf_idx.shape[0] % n:
        raise ValueError(f"{points.shape[0]} landmark rows or {obs.kf_idx.shape[0]} observation "
                         f"rows do not split over this rank's {n} shards")
    Ls, Os = points.shape[0] // n, obs.kf_idx.shape[0] // n
    K = fixed_pose.shape[0]
    dev, dtype = points.device, points.dtype
    shard = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(Os)
    flat = ba.Observations(kf_idx=obs.kf_idx, pt_idx=obs.pt_idx + shard * Ls,
                           px=cam.undistort_px(obs.px), mask=obs.mask)
    seg = ba.block_segments(flat, K, n * Ls, shards=n)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    T, pts = poses, points
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    chi2_c = torch.tensor(torch.inf, dtype=dtype, device=dev)
    trace = None if stats is None else {"chi2": [], "chi2_new": [], "accept": []}
    for _ in range(n_iter):
        r, _, _, valid = ba.reproject(T, pts, flat, cam)
        w_frozen = ba._irls_weights(r, valid, huber_delta)
        # Step 1: each shard's sums over its own rows (camera segment k * n + s).
        Hcc, Hll, W, bc, bl, e = ba._assemble(T, pts, flat, cam, fixed_pose, huber_delta, seg,
                                              w_frozen)
        # The landmarks' share of the reduced system, per shard.
        Hll_inv = ba.inv3x3(Hll + (lam + 1e-6) * eye3)
        Wv = W.reshape(K, n, Ls, 6, 3)
        A = torch.einsum("kslab,slbc->kslac", Wv, Hll_inv.reshape(n, Ls, 3, 3))
        S_l = -torch.einsum("kslac,mslbc->skmab", A, Wv)
        b_l = -torch.einsum("kslac,slc->ska", A, bl.reshape(n, Ls, 3))
        red = reduce_sum(mesh, torch.cat([
            S_l.reshape(n, -1), (bc.reshape(K, n, 6).transpose(0, 1) + b_l).reshape(n, -1),
            Hcc.reshape(K, n, 36).transpose(0, 1).reshape(n, -1),
            torch.sum(e.reshape(n, -1), dim=1)[:, None]], dim=1))
        S = red[:K * K * 36].reshape(K, K, 6, 6)
        b_red = red[K * K * 36:K * K * 36 + 6 * K].reshape(K, 6)
        Hcc_g = red[K * K * 36 + 6 * K:-1].reshape(K, 6, 6)
        chi2 = red[-1]
        dc = ba._camera_step(S, b_red, Hcc_g, fixed_pose, lam)
        dl = ba._landmark_step(Hll_inv, W, bl, dc)
        T_new = se3m.boxplus(T, dc)
        pts_new = pts + dl
        chi2_new = reduce_sum(mesh, _shard_chi2(T_new, pts_new, flat, cam, w_frozen, n)[:, None])[0]
        T, pts, lam, chi2_c, accept = ba._lm_update(T, pts, T_new, pts_new, lam, chi2, chi2_new)
        if trace is not None:
            for k, v in (("chi2", chi2), ("chi2_new", chi2_new), ("accept", accept)):
                trace[k].append(v)
    if trace is not None and n_iter:
        stats.update({k: torch.stack(v) for k, v in trace.items()})
    return T, pts, chi2_c
