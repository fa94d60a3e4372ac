"""The benchmark's own worlds, cameras and trajectories, in plain PyTorch and
NumPy: frozen copies of the port's synthetic renderers (`PlaneScene`,
`BoxScene`, `loop_trajectory`, bench_batch.py's clip), written to make their
textures and frames on the device from a seed in a few large calls.

They are the ground truth the reference judges the system by, so nothing
here imports the system under test.  Poses are world -> camera (T_cw) as a
rotation [3, 3] and a translation [3]; host poses are float64 NumPy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# ---------------------------------------------------------------- SE(3)


def hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = hat(w)
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K + (1.0 - math.cos(th)) / th ** 2 * K @ K


def se3_exp(xi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rho, phi) -> (R, t), float64."""
    rho, phi = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = float(np.linalg.norm(phi))
    K = hat(phi)
    if th < 1e-12:
        V = np.eye(3) + 0.5 * K
    else:
        V = (np.eye(3) + (1.0 - math.cos(th)) / th ** 2 * K
             + (th - math.sin(th)) / th ** 3 * K @ K)
    return so3_exp(phi), V @ rho


def so3_log(R: np.ndarray) -> np.ndarray:
    c = float(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    th = math.acos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-7:
        return 0.5 * v
    if th > math.pi - 1e-5:
        # Near pi: the axis from the symmetric part.
        M = (R + np.eye(3)) / 2.0
        axis = M[:, int(np.argmax(np.diag(M)))]
        return th * axis / np.linalg.norm(axis)
    return th / (2.0 * math.sin(th)) * v


def se3_log(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    phi = so3_log(R)
    th = float(np.linalg.norm(phi))
    K = hat(phi)
    if th < 1e-12:
        Vinv = np.eye(3) - 0.5 * K
    else:
        Vinv = (np.eye(3) - 0.5 * K
                + (1.0 / th ** 2) * (1.0 - th * math.sin(th) / (2.0 * (1.0 - math.cos(th))))
                * K @ K)
    return np.concatenate([Vinv @ t, phi])


def pose_distance(Ra, ta, Rb, tb) -> float:
    """||log(Ta Tb^-1)||, the tracking gate's pose error."""
    R = Ra @ Rb.T
    return float(np.linalg.norm(se3_log(R, ta - R @ tb)))


def quat_to_R(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = (float(v) for v in q / np.linalg.norm(q))
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def pose7_to_Rt(p7: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """params7 (quaternion w, x, y, z, then t) -> (R, t), float64."""
    p7 = np.asarray(p7, np.float64)
    return quat_to_R(p7[:4]), p7[4:7]


# --------------------------------------------------------------- camera


@dataclass(frozen=True)
class Camera:
    """Pinhole camera of rectified images."""
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_config(c: dict) -> "Camera":
        return Camera(*(float(c[k]) for k in ("fx", "fy", "cx", "cy")))

    def bearings(self, shape, device) -> torch.Tensor:
        """[H, W, 3] camera-frame rays (z = 1) through every pixel."""
        H, W = shape
        v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                              torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
        return torch.stack([(u - self.cx) / self.fx, (v - self.cy) / self.fy,
                            torch.ones_like(u)], dim=-1)


# ------------------------------------------------------------- textures


def _box_filter(x: torch.Tensor, k: int, dim: int, centred: bool) -> torch.Tensor:
    """Running mean of width k along `dim` by cumulative sums (float64),
    edge-replicated back to the input's length: trailing for the texture
    octaves, centred for the mip levels (as the port's renderers take them)."""
    n = x.shape[dim]
    c = torch.cumsum(torch.nn.functional.pad(x.double().movedim(dim, -1), (1, 0)), dim=-1)
    b = (c[..., k:] - c[..., :-k]) / k
    lead = k // 2 if centred else 0
    tail = n - b.shape[-1] - lead
    b = torch.cat([b[..., :1].expand(*b.shape[:-1], lead), b,
                   b[..., -1:].expand(*b.shape[:-1], tail)], dim=-1)
    return b.movedim(-1, dim).to(x.dtype)


def textures(n: int, size: int, gen: torch.Generator, device, octaves: int = 4,
             decay: float = 0.5) -> torch.Tensor:
    """[n, size, size] smooth multi-octave random textures in [40, 215]
    (the port's `texture_array`, drawn on the device): octave o is uniform
    noise on a (size >> (octaves-1-o))^2 grid, blown up and box-filtered,
    weighted decay^(octaves-1-o)."""
    tex = torch.zeros((n, size, size), dtype=torch.float32, device=device)
    for o in range(octaves):
        s = size >> (octaves - 1 - o)
        layer = torch.rand((n, s, s), generator=gen, device=device) * 2.0 - 1.0
        rep = size // s
        layer = layer.repeat_interleave(rep, 1).repeat_interleave(rep, 2)
        k = max(rep // 2, 1)
        if k > 1:
            layer = _box_filter(_box_filter(layer, k, 1, False), k, 2, False)
        tex += layer * decay ** (octaves - 1 - o)
    lo = tex.amin(dim=(1, 2), keepdim=True)
    hi = tex.amax(dim=(1, 2), keepdim=True)
    return 40.0 + 175.0 * (tex - lo) / (hi - lo)


def mip_stacks(tex: torch.Tensor, n_mips: int) -> torch.Tensor:
    """[n, n_mips, S, S]: level k low-passed with a centred (2^k)-texel box."""
    out = [tex]
    for k in range(1, n_mips):
        w = 1 << k
        out.append(_box_filter(_box_filter(tex, w, 1, True), w, 2, True))
    return torch.stack(out, dim=1)


def bilinear(stack: torch.Tensor, idx: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """stack [M, H, W] sampled at uv [..., 2] (x, y) of image idx [...],
    coordinates clamped to the image."""
    _, H, W = stack.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.0)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    wx, wy = x - x0, y - y0
    flat = stack.reshape(-1)
    base = idx.long() * (H * W)

    def at(yy, xx):
        return flat[base + yy * W + xx]

    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy)
            + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)


# --------------------------------------------------------------- worlds


def _rays(cam: Camera, R_cw: torch.Tensor, t_cw: torch.Tensor, shape):
    """World ray directions [B, H, W, 3] and centres [B, 3] of B poses."""
    b = cam.bearings(shape, R_cw.device)
    R_wc = R_cw.transpose(-1, -2)
    d_w = torch.einsum("bij,hwj->bhwi", R_wc, b)
    o_w = -torch.einsum("bij,bj->bi", R_wc, t_cw)
    return d_w, o_w


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(d) < 1e-9, 1e-9, d)


class BoxWorld:
    """The inside of a textured box room [-half, half] (the port's BoxScene):
    six faces with their own textures, the nearest positive face hit per ray,
    each face's mip stack sampled trilinearly at the pixel's texel
    footprint, exposure gain and bias, radial vignetting."""

    FACES = [(0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0), (2, -1.0), (2, 1.0)]
    N_MIPS = 5

    def __init__(self, cam: Camera, half, tex_size: int, tex_per_meter: float, vignette: float,
                 tex_decay: float, gen: torch.Generator, device):
        self.cam = cam
        self.half = [float(h) for h in half]
        self.tex_size = tex_size
        self.tex_per_meter = float(tex_per_meter)
        self.vignette = float(vignette)
        base = textures(6, tex_size, gen, device, decay=tex_decay)
        self.mips = mip_stacks(base, self.N_MIPS).reshape(6 * self.N_MIPS, tex_size, tex_size)

    def render(self, R_cw: torch.Tensor, t_cw: torch.Tensor, shape, gain: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
        """[B, H, W] images of B poses, clip(V * (gain * texel + bias), 0, 255)."""
        H, W = shape
        d_w, o_w = _rays(self.cam, R_cw, t_cw, shape)
        o = o_w[:, None, None, :]
        t_best = torch.full(d_w.shape[:-1], 1e9, dtype=d_w.dtype, device=d_w.device)
        f_best = torch.zeros(d_w.shape[:-1], dtype=torch.int64, device=d_w.device)
        for f, (ax, sign) in enumerate(self.FACES):
            t = (sign * self.half[ax] - o[..., ax]) / _safe(d_w[..., ax])
            hit = o + t[..., None] * d_w
            a, b = (i for i in range(3) if i != ax)
            inside = ((torch.abs(hit[..., a]) <= self.half[a] + 1e-4)
                      & (torch.abs(hit[..., b]) <= self.half[b] + 1e-4))
            ok = (t > 1e-4) & inside & (t < t_best)
            t_best = torch.where(ok, t, t_best)
            f_best = torch.where(ok, f, f_best)
        pts = o + t_best[..., None] * d_w
        # Texel footprint over the wall-incidence cosine (clamped at 0.25).
        axes = torch.tensor([f[0] for f in self.FACES], device=d_w.device)
        d_norm = torch.linalg.norm(d_w, dim=-1)
        d_ax = torch.gather(d_w, -1, axes[f_best][..., None])[..., 0]
        cos_inc = torch.clamp(torch.abs(d_ax) / torch.clamp(d_norm, min=1e-9), 0.25, 1.0)
        foot = t_best * d_norm * self.tex_per_meter / self.cam.fx / cos_inc
        lvl = torch.clamp(torch.log2(torch.clamp(foot, min=1.0)), 0.0, self.N_MIPS - 1 - 1e-4)
        l0 = lvl.long()
        frac = lvl - l0
        l1 = torch.clamp(l0 + 1, max=self.N_MIPS - 1)
        # The face's two in-plane coordinates: (a, b) = the other two axes.
        in_a = torch.tensor([1, 1, 0, 0, 0, 0], device=d_w.device)[f_best]
        in_b = torch.tensor([2, 2, 2, 2, 1, 1], device=d_w.device)[f_best]
        centre = self.tex_size / 2
        uv = torch.stack([torch.gather(pts, -1, in_a[..., None])[..., 0],
                          torch.gather(pts, -1, in_b[..., None])[..., 0]], -1)
        uv = uv * self.tex_per_meter + centre
        v0 = bilinear(self.mips, f_best * self.N_MIPS + l0, uv)
        v1 = bilinear(self.mips, f_best * self.N_MIPS + l1, uv)
        img = gain[:, None, None] * (v0 * (1.0 - frac) + v1 * frac) + bias[:, None, None]
        if self.vignette > 0.0:
            v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=d_w.device),
                                  torch.arange(W, dtype=torch.float32, device=d_w.device),
                                  indexing="ij")
            cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
            img = img * (1.0 - self.vignette * ((u - cx) ** 2 + (v - cy) ** 2)
                         / (cx * cx + cy * cy))
        return torch.clamp(img, 0.0, 255.0)


class PlaneWorld:
    """A textured plane z = plane_z per stream (the port's PlaneScene);
    texture coordinates are world (x, y) * tex_per_meter + size / 2."""

    def __init__(self, cam: Camera, n: int, plane_z: float, tex_size: int, tex_per_meter: float,
                 gen: torch.Generator, device):
        self.cam = cam
        self.plane_z = float(plane_z)
        self.tex_size = tex_size
        self.tex_per_meter = float(tex_per_meter)
        self.tex = textures(n, tex_size, gen, device)

    def points(self, R_cw: torch.Tensor, t_cw: torch.Tensor, d_w: torch.Tensor,
               o_w: torch.Tensor) -> torch.Tensor:
        o = o_w.reshape(o_w.shape[0], *([1] * (d_w.dim() - 2)), 3)
        t = (self.plane_z - o[..., 2]) / _safe(d_w[..., 2])
        return o + t[..., None] * d_w

    def render(self, idx: torch.Tensor, R_cw: torch.Tensor, t_cw: torch.Tensor,
               shape) -> torch.Tensor:
        """[B, H, W] images: pose b sees the plane of stream idx[b]."""
        d_w, o_w = _rays(self.cam, R_cw, t_cw, shape)
        pts = self.points(R_cw, t_cw, d_w, o_w)
        uv = pts[..., :2] * self.tex_per_meter + self.tex_size / 2
        return bilinear(self.tex, idx[:, None, None].expand(uv.shape[:-1]), uv)

    def depth_at(self, px: torch.Tensor, R_cw: torch.Tensor, t_cw: torch.Tensor) -> torch.Tensor:
        """z-depth [B, N] at pixels px [B, N, 2] of poses [B]."""
        c = self.cam
        b = torch.stack([(px[..., 0] - c.cx) / c.fx, (px[..., 1] - c.cy) / c.fy,
                         torch.ones_like(px[..., 0])], -1)
        R_wc = R_cw.transpose(-1, -2)
        d_w = torch.einsum("bij,bnj->bni", R_wc, b)
        o_w = -torch.einsum("bij,bj->bi", R_wc, t_cw)
        pts = self.points(R_cw, t_cw, d_w, o_w)
        return torch.einsum("bij,bnj->bni", R_cw, pts)[..., 2] + t_cw[:, None, 2]


def box_surface_distance(half, pts: np.ndarray) -> np.ndarray:
    """Distance [N] of world points [N, 3] to the walls of the room [-half, half]."""
    q = np.abs(pts) - np.asarray(half, np.float64)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    return np.where(np.all(q <= 0.0, axis=-1), -np.max(q, axis=-1), outside)


# --------------------------------------------------------- trajectories


def loop_pose(a: float, radius: float, bob: float, ph: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The port's `loop_trajectory` pose at loop angle a, facing radially
    out: a circle in the x-z plane with a small y-bob and attitude wobble."""
    c = np.array([radius * math.sin(a), bob * math.sin(3 * a + ph[0]), -radius * math.cos(a)])
    yaw = math.pi - a + 0.12 * math.sin(2 * a + ph[1])
    pitch = 0.05 * math.sin(2.4 * a + ph[2])
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    fwd = np.array([sy * cp, -sp, cy * cp])
    right = np.array([cy, 0.0, -sy])
    R_cw = np.stack([right, np.cross(fwd, right), fwd], axis=1).T
    return R_cw, -R_cw @ c
