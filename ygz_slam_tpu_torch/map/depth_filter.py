"""Batched Bayesian depth filter, SVO-style inverse-depth seeds
(counterpart of ygz_slam_tpu/map/depth_filter.py).

Each depthless feature of the last keyframe carries a seed: inverse depth
as a Gaussian (mu, sigma2) mixed with a uniform outlier component through
a Beta(a, b) inlier ratio (Seed, optimizer.h:84-200).  Every ordinary frame
updates the whole table at once: an epipolar search for each seed
(`ops.align.align1d` along the line), a triangulated depth observation with
its one-pixel uncertainty tau (ComputeTau, optimizer.cpp:724-740) and the
Vogiatzis Gaussian-Beta posterior update (UpdateSeed, optimizer.cpp:690-722).

Every clamp, `where` and epsilon is the JAX package's, in its order of
operations: the table is small, but its decisions (a match accepted, a
triangulation kept, a seed converged) flip on rounding.  Nothing here reads
the device from the host, so the update runs inside a CUDA graph.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import SE3
from ..geometry.triangulation import depth_from_triangulation
from ..ops.align import align1d
from ..ops.interp import in_bounds, sample_patches

# Float32 constants as the JAX package rounds them.
_PI = float(np.float32(math.pi))
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * math.pi)))


class Seeds(NamedTuple):
    """Per-feature inverse-depth seeds (fixed capacity, masked)."""

    px: torch.Tensor        # [N, 2] pixel in the owning keyframe
    a: torch.Tensor         # [N] Beta inlier count
    b: torch.Tensor         # [N] Beta outlier count
    mu: torch.Tensor        # [N] inverse-depth mean
    z_range: torch.Tensor   # [N] scene inverse-depth range
    sigma2: torch.Tensor    # [N] inverse-depth variance
    valid: torch.Tensor     # [N] bool

    @staticmethod
    def init(px: torch.Tensor, valid: torch.Tensor, depth_mean: float,
             depth_min: float) -> "Seeds":
        """Seed::Seed (optimizer.h:93-104): mu = 1/depth_mean,
        z_range = 1/depth_min, sigma2 = (z_range/6)^2."""
        n = px.shape[0]

        def full(v):
            return torch.full((n,), v, dtype=torch.float32, device=px.device)

        z_range = full(1.0 / depth_min)
        return Seeds(px=px, a=full(10.0), b=full(10.0), mu=full(1.0 / depth_mean),
                     z_range=z_range, sigma2=(z_range / 6.0) ** 2, valid=valid)

    def depth(self) -> torch.Tensor:
        return 1.0 / torch.clamp(self.mu, min=1e-6)

    def converged(self, ratio: float = 200.0) -> torch.Tensor:
        """Seed accepted when sigma < z_range / ratio (UpdateSeeds'
        convergence test, optimizer.cpp:664-680)."""
        return self.valid & (torch.sqrt(self.sigma2) < self.z_range / ratio)


def compute_tau(T_ref_cur: SE3, f: torch.Tensor, z: torch.Tensor,
                px_error_angle: float) -> torch.Tensor:
    """Depth uncertainty from one-pixel disparity (ComputeTau,
    optimizer.cpp:724-740), batched over seeds: f [N, 3] bearings, z [N]
    depths along them."""
    t = T_ref_cur.t
    a = f * z[:, None] - t[None, :]
    t_norm = torch.linalg.norm(t)
    a_norm = torch.linalg.norm(a, dim=-1)
    alpha = torch.arccos(torch.clamp(
        torch.sum(f * t[None, :], dim=-1) / torch.clamp(t_norm, min=1e-9), -1, 1))
    beta = torch.arccos(torch.clamp(
        -torch.sum(a * t[None, :], dim=-1) / torch.clamp(t_norm * a_norm, min=1e-9), -1, 1))
    beta_plus = beta + px_error_angle
    gamma = _PI - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.clamp(torch.sin(gamma), min=1e-6)
    return torch.abs(z_plus - z)


def update_seed(seeds: Seeds, x: torch.Tensor, tau2: torch.Tensor,
                obs_ok: torch.Tensor) -> Seeds:
    """Vogiatzis Gaussian-Beta update for all seeds at once (UpdateSeed,
    optimizer.cpp:690-722); x is the observed inverse depth, tau2 its
    variance, obs_ok which seeds got an observation."""
    a, b, mu, sigma2 = seeds.a, seeds.b, seeds.mu, seeds.sigma2
    norm_scale = torch.sqrt(sigma2 + tau2)
    s2 = 1.0 / (1.0 / torch.clamp(sigma2, min=1e-12) + 1.0 / torch.clamp(tau2, min=1e-12))
    m = s2 * (mu / torch.clamp(sigma2, min=1e-12) + x / torch.clamp(tau2, min=1e-12))
    # Gaussian pdf of x under N(mu, norm_scale^2).
    inv_ns = 1.0 / torch.clamp(norm_scale, min=1e-9)
    C1 = a / (a + b) * inv_ns / _SQRT_2PI * torch.exp(-0.5 * ((x - mu) * inv_ns) ** 2)
    C2 = b / (a + b) / torch.clamp(seeds.z_range, min=1e-9)
    norm = torch.clamp(C1 + C2, min=1e-12)
    C1, C2 = C1 / norm, C2 / norm
    f_ = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = (C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
         + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0)))
    mu_new = C1 * m + C2 * mu
    sigma2_new = C1 * (s2 + m * m) + C2 * (sigma2 + mu ** 2) - mu_new ** 2
    a_new = (e - f_) / torch.clamp(f_ - e / torch.clamp(f_, min=1e-12), min=1e-12)
    b_new = a_new * (1.0 - f_) / torch.clamp(f_, min=1e-12)
    upd = obs_ok & seeds.valid
    return seeds._replace(
        mu=torch.where(upd, mu_new, mu),
        sigma2=torch.where(upd, torch.clamp(sigma2_new, min=1e-12), sigma2),
        a=torch.where(upd, torch.clamp(a_new, 1e-3, 1e4), a),
        b=torch.where(upd, torch.clamp(b_new, 1e-3, 1e4), b))


def pixel_error_angle(fx: float, px_noise: float = 1.0) -> float:
    """The angle one pixel of noise subtends, 2 atan(px_noise / (2 fx)),
    in float32 (ComputeTau's px_error_angle)."""
    f32 = np.float32
    return float(f32(np.arctan(f32(px_noise) / (f32(2.0) * f32(fx)))) * f32(2.0))


def update_seeds_from_frame(seeds: Seeds, ref_img: torch.Tensor, cur_img: torch.Tensor, cam,
                            T_cur_ref: SE3, px_noise: float = 1.0) -> Seeds:
    """One frame's worth of seed updates (DepthFilter::UpdateSeeds,
    optimizer.cpp:547-688), all seeds at once: alignment along the
    epipolar line around the projected mean depth, triangulation, tau,
    Bayes update.  ref_img is the seeds' keyframe image, cur_img the new
    frame's level 0, T_cur_ref the keyframe-to-frame motion."""
    H, W = cur_img.shape
    z = seeds.depth()
    # Raw detection -> undistorted bearing (identity without distortion).
    f_ref = cam.pixel_to_bearing(seeds.px, distorted=True)
    p_ref = f_ref * (z / torch.clamp(f_ref[:, 2], min=1e-6))[:, None]
    p_cur = T_cur_ref.apply(p_ref)
    # Sampling positions on the raw image: projected with distortion.
    px_mean = cam.camera_to_pixel(p_cur, distorted=True)
    # The epipolar direction around the mean depth: the chord to the
    # projection at mu + sigma.
    z_minus = 1.0 / torch.clamp(seeds.mu + torch.sqrt(seeds.sigma2), min=1e-6)
    p_minus = T_cur_ref.apply(f_ref * (z_minus / torch.clamp(f_ref[:, 2], min=1e-6))[:, None])
    px_minus = cam.camera_to_pixel(p_minus, distorted=True)
    direction = px_minus - px_mean
    dn = torch.linalg.norm(direction, dim=-1)
    unit = direction / torch.clamp(dn, min=1e-6)[:, None]
    has = dn > 1e-6
    direction = torch.stack([torch.where(has, unit[:, 0], 1.0),
                             torch.where(has, unit[:, 1], 0.0)], dim=-1)
    visible = seeds.valid & (p_cur[:, 2] > 0.05) & in_bounds(px_mean, H, W, margin=8.0)
    patches = sample_patches(ref_img, seeds.px, 10)
    res = align1d(cur_img, patches, px_mean, direction, max_error=25.0)
    matched = visible & res.converged
    # Triangulate the matched position.  depth_from_triangulation returns
    # the range along the unit bearing; seeds hold inverse z-depth, so
    # convert through the bearing's z component.
    f_cur = cam.pixel_to_bearing(res.xy, distorted=True)
    range_new, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    depth_new = range_new * f_ref[:, 2]
    ok = matched & tri_ok & (depth_new > 0.05)
    # The observation in inverse depth, with tau.
    tau = compute_tau(T_cur_ref.inverse(), f_ref, depth_new, pixel_error_angle(cam.fx, px_noise))
    x = 1.0 / torch.clamp(depth_new, min=1e-6)
    tau_inv = 0.5 * (1.0 / torch.clamp(depth_new - tau, min=1e-6)
                     - 1.0 / torch.clamp(depth_new + tau, min=1e-6))
    seeds = update_seed(seeds, x, tau_inv ** 2, ok)
    # A failed epipolar match counts against the Beta inlier ratio
    # (UpdateSeeds increments b on failure, optimizer.cpp:627-633).
    fail = visible & ~ok
    return seeds._replace(b=torch.where(fail, seeds.b + 1.0, seeds.b))
