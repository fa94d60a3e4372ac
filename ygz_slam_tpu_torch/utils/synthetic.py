"""Synthetic photometric scenes with exact ground truth (counterpart of
make_texture, PlaneScene, BoxScene, loop_trajectory and TwoPlaneScene in
ygz_slam_tpu/utils/synthetic.py).

Textures, BoxScene's mip stacks and trajectories are made with numpy from a
seed, so they are the JAX package's bit for bit; rendering runs on the
texture's device, the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geometry.se3 import SE3
from ..ops.interp import bilinear


def texture_array(size: int = 1024, seed: int = 0, octaves: int = 4,
                  decay: float = 0.5) -> np.ndarray:
    """Smooth multi-octave random texture [size, size] float32 in [40, 215],
    as a numpy array.  `decay` is the per-octave amplitude falloff from fine
    to coarse: larger values keep more coarse contrast."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        s = size >> (octaves - 1 - o)
        layer = rng.uniform(-1, 1, size=(s, s)).astype(np.float32)
        rep = size // s
        layer = np.kron(layer, np.ones((rep, rep), np.float32))
        k = max(rep // 2, 1)
        if k > 1:
            c = np.cumsum(np.pad(layer, ((1, 0), (0, 0))), axis=0)
            layer = (c[k:] - c[:-k]) / k
            layer = np.pad(layer, ((0, size - layer.shape[0]), (0, 0)), mode="edge")
            c = np.cumsum(np.pad(layer, ((0, 0), (1, 0))), axis=1)
            layer = (c[:, k:] - c[:, :-k]) / k
            layer = np.pad(layer, ((0, 0), (0, size - layer.shape[1])), mode="edge")
        tex += layer * (decay ** (octaves - 1 - o))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return np.asarray(40.0 + 175.0 * tex, np.float32)


def make_texture(size: int = 1024, seed: int = 0, octaves: int = 4,
                 decay: float = 0.5, device=None) -> torch.Tensor:
    """`texture_array` as a tensor on `device` (the card by default)."""
    return torch.from_numpy(texture_array(size, seed, octaves, decay)).to(
        resolve_device(device))


def _pixel_grid(shape, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u [H, W], v [H, W], px [H, W, 2]): every pixel's (x, y)."""
    H, W = shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return u, v, torch.stack([u, v], dim=-1)


def _fma_matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M [3, 3] @ x [..., 3] in float32, each row a chain of fused
    multiply-adds in column order (emulated in float64), which is how the
    JAX package's einsum rounds on the CPU: ray origins and directions, and
    with them texture coordinates, come out as its bits."""
    M64, x64 = M.double(), x.double()
    acc = (M64[:, 0] * x64[..., 0:1]).float()
    for j in (1, 2):
        acc = (M64[:, j] * x64[..., j:j + 1] + acc.double()).float()
    return acc


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v rounded as an IEEE division on every device: a CUDA tensor
    divided by a Python number is multiplied by its reciprocal instead,
    which moves texture coordinates by an ulp."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _rays(cam, px: torch.Tensor, T_cw: SE3):
    """World-frame ray directions [..., 3] through raw pixels (the bearing of
    `cam.pixel_to_camera(px, 1.0, distorted=True)`: a raw pixel looks along
    its undistorted ray) and the camera centre."""
    R_wc = T_cw.R.transpose(-1, -2)
    xn = cam.undistort(torch.stack([_div(px[..., 0] - cam.cx, cam.fx),
                                    _div(px[..., 1] - cam.cy, cam.fy)], dim=-1))
    bearing_c = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    return _fma_matvec(R_wc, bearing_c), -_fma_matvec(R_wc, T_cw.t)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(d) < 1e-9, 1e-9, d)


class _Scene:
    """`depth` and `project_to`, shared by the scenes below, over each
    scene's `world_from_pixel`."""

    def depth(self, px: torch.Tensor, T_cw: SE3) -> torch.Tensor:
        """Ground-truth z-depth at pixels [..., 2]."""
        return T_cw.apply(self.world_from_pixel(px, T_cw))[..., 2]

    def project_to(self, px_a: torch.Tensor, T_a: SE3, T_b: SE3) -> torch.Tensor:
        """Ground-truth correspondence: pixels in view a -> pixels in view b."""
        return self.cam.world_to_pixel(self.world_from_pixel(px_a, T_a), T_b, distorted=True)


class PlaneScene(_Scene):
    """World: textured plane z = plane_z; cameras look roughly along +z.
    Texture coordinates: world (x, y) * tex_per_meter + tex_size / 2."""

    def __init__(self, cam, plane_z: float = 3.0, tex_size: int = 1024,
                 tex_per_meter: float = 120.0, seed: int = 0, device=None):
        self.cam = cam
        self.plane_z = plane_z
        self.tex = make_texture(tex_size, seed, device=resolve_device(device))
        self.tex_per_meter = tex_per_meter
        self.tex_size = tex_size

    def world_from_pixel(self, px: torch.Tensor, T_cw: SE3) -> torch.Tensor:
        """Intersect pixel rays with the plane -> world points [..., 3].
        The rays are einsums of the camera's bearings, which the planar
        workloads' frames are made with (on the card they round other than
        the JAX package's by an ulp in places); the non-planar scenes use
        `_rays`."""
        T_wc = T_cw.inverse()
        d_w = torch.einsum("ij,...j->...i", T_wc.R,
                           self.cam.pixel_to_camera(px, 1.0, distorted=True))
        o_w = T_wc.t
        t = (self.plane_z - o_w[2]) / _safe(d_w[..., 2])
        return o_w + t[..., None] * d_w

    def render(self, T_cw: SE3, shape: tuple[int, int]) -> torch.Tensor:
        """Render an [H, W] image from camera pose T_cw."""
        _, _, px = _pixel_grid(shape, self.tex.device)
        w_pts = self.world_from_pixel(px, T_cw)
        tx = w_pts[..., 0] * self.tex_per_meter + self.tex_size / 2
        ty = w_pts[..., 1] * self.tex_per_meter + self.tex_size / 2
        return bilinear(self.tex, torch.stack([tx, ty], dim=-1))


def mip_stack(tex: np.ndarray, n_mips: int) -> np.ndarray:
    """[n_mips, S, S] float32: level k is `tex` low-passed with a centred
    (2^k)-texel box, edge-replicated (BoxScene._mip_stack, in float64
    cumulative sums as the JAX package takes them)."""
    out = [tex]
    size = tex.shape[0]
    for k in range(1, n_mips):
        w = 1 << k
        c = np.cumsum(np.pad(tex, ((1, 0), (0, 0))), axis=0, dtype=np.float64)
        b = (c[w:] - c[:-w]) / w
        b = np.pad(b, ((w // 2, size - b.shape[0] - w // 2), (0, 0)), mode="edge")
        c = np.cumsum(np.pad(b, ((0, 0), (1, 0))), axis=1, dtype=np.float64)
        b = (c[:, w:] - c[:, :-w]) / w
        b = np.pad(b, ((0, 0), (w // 2, size - b.shape[1] - w // 2)), mode="edge")
        out.append(b.astype(np.float32))
    return np.stack(out)


class BoxScene(_Scene):
    """Non-planar world: the inside of a textured axis-aligned box room,
    [-half, half].  Each of the six faces carries its own multi-octave
    texture; a ray takes the nearest positive face hit, so corners are
    occlusion and depth-discontinuity boundaries that move with the camera.
    Rendering samples each face's mip stack trilinearly at the pixel's
    texel footprint, and applies exposure gain and bias and radial
    vignetting.  `textures`, if given, are six square float32 images that
    replace the procedural ones."""

    # Faces: (axis, sign), the plane at coordinate sign * half[axis].
    _FACES = [(0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0), (2, -1.0), (2, 1.0)]
    # Level k of a face's mip stack is its texture low-passed with a
    # (2^k)-texel box.
    N_MIPS = 5

    def __init__(self, cam, half=(4.0, 2.0, 4.0), tex_size: int = 2048,
                 tex_per_meter: float = 220.0, seed: int = 0,
                 vignette: float = 0.0, tex_decay: float = 0.7,
                 textures: list | None = None, device=None):
        self.cam = cam
        self.half = np.asarray(half, np.float32)
        if textures is not None:
            if len(textures) != 6:
                raise ValueError(f"BoxScene takes 6 face textures, got {len(textures)}")
            base = [np.asarray(t, np.float32) for t in textures]
            tex_size = base[0].shape[0]
        else:
            base = [texture_array(tex_size, seed + 101 * f, decay=tex_decay) for f in range(6)]
        self.tex_size = tex_size
        self.tex_per_meter = tex_per_meter
        self.vignette = float(vignette)
        self.texs = torch.from_numpy(np.stack([mip_stack(t, self.N_MIPS) for t in base])).to(
            resolve_device(device))                                 # [6, N_MIPS, S, S]

    def _hits(self, px: torch.Tensor, T_cw: SE3):
        """Nearest positive face hit of each pixel ray: (points [..., 3]
        world, face [...] int64, ray parameter t [...], ray directions
        [..., 3])."""
        d_w, o_w = _rays(self.cam, px, T_cw)
        t_best = torch.full(px.shape[:-1], 1e9, dtype=px.dtype, device=px.device)
        f_best = torch.zeros(px.shape[:-1], dtype=torch.int64, device=px.device)
        for f, (ax, sign) in enumerate(self._FACES):
            coord = float(sign * self.half[ax])
            t = (coord - o_w[ax]) / _safe(d_w[..., ax])
            hit = o_w + t[..., None] * d_w
            # Inside the other two extents, with a hair of slack so that a
            # corner ray always lands on exactly one face.
            a, b = (i for i in range(3) if i != ax)
            inside = ((torch.abs(hit[..., a]) <= float(self.half[a] + 1e-4))
                      & (torch.abs(hit[..., b]) <= float(self.half[b] + 1e-4)))
            ok = (t > 1e-4) & inside & (t < t_best)
            t_best = torch.where(ok, t, t_best)
            f_best = torch.where(ok, f, f_best)
        return o_w + t_best[..., None] * d_w, f_best, t_best, d_w

    def world_from_pixel(self, px: torch.Tensor, T_cw: SE3) -> torch.Tensor:
        return self._hits(px, T_cw)[0]

    def _footprint(self, d_w: torch.Tensor, face: torch.Tensor, t_best: torch.Tensor):
        """Texels one pixel spans at each hit: distance * tex_per_meter / fx
        over the wall-incidence cosine (clamped at 0.25: grazing rays would
        blur without bound)."""
        d_norm = torch.linalg.norm(d_w, dim=-1)
        dist = t_best * d_norm
        axes = torch.tensor([f[0] for f in self._FACES], device=face.device)
        d_ax = torch.gather(d_w, -1, axes[face][..., None])[..., 0]
        cos_inc = torch.clamp(torch.abs(d_ax) / torch.clamp(d_norm, min=1e-9), 0.25, 1.0)
        return _div(dist * self.tex_per_meter, self.cam.fx) / cos_inc

    def _shade(self, pts: torch.Tensor, face: torch.Tensor, footprint: torch.Tensor):
        """Each face's texture at the hit's two in-plane world coordinates,
        trilinear across the mip stack at the texel footprint."""
        lvl = torch.clamp(torch.log2(torch.clamp(footprint, min=1.0)), 0.0,
                          float(self.N_MIPS - 1) - 1e-4)
        l0 = lvl.to(torch.int64)
        frac = lvl - l0.to(lvl.dtype)
        l1 = torch.clamp(l0 + 1, max=self.N_MIPS - 1)
        out = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
        for f, (ax, _) in enumerate(self._FACES):
            a, b = (i for i in range(3) if i != ax)
            tx = pts[..., a] * self.tex_per_meter + self.tex_size / 2
            ty = pts[..., b] * self.tex_per_meter + self.tex_size / 2
            uv = torch.stack([tx, ty], dim=-1)
            mips = torch.stack([bilinear(self.texs[f, k], uv) for k in range(self.N_MIPS)])
            v0 = torch.gather(mips, 0, l0[None])[0]
            v1 = torch.gather(mips, 0, l1[None])[0]
            out = torch.where(face == f, v0 * (1.0 - frac) + v1 * frac, out)
        return out

    def render(self, T_cw: SE3, shape: tuple[int, int], gain: float = 1.0,
               bias: float = 0.0) -> torch.Tensor:
        """An [H, W] image from pose T_cw with photometric perturbation:
        clip(V(px) * (gain * v + bias), 0, 255) under radial vignetting
        V = 1 - vignette * (r / r_max)^2."""
        H, W = shape
        u, v, px = _pixel_grid(shape, self.texs.device)
        pts, face, t_best, d_w = self._hits(px, T_cw)
        img = float(gain) * self._shade(pts, face, self._footprint(d_w, face, t_best)) \
            + float(bias)
        if self.vignette > 0.0:
            cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
            r2 = _div((u - cx) ** 2 + (v - cy) ** 2, cx * cx + cy * cy)
            img = img * (1.0 - self.vignette * r2)
        return torch.clamp(img, 0.0, 255.0)


def loop_trajectory(n_frames: int, radius: float = 2.2, laps: float = 1.08,
                    bob: float = 0.08, seed: int = 0, face: str = "tangent",
                    device=None) -> list:
    """Camera loop inside a BoxScene: a circle in the x-z plane with a small
    smooth y-bob and attitude perturbations; `laps` > 1 revisits the start.
    `face` is the viewing direction: "tangent" along the direction of
    travel, "out" radially outward.  Returns T_cw (world -> camera) per
    frame, from the JAX package's numpy arithmetic."""
    dev = resolve_device(device)
    poses = []
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 3)
    for k in range(n_frames):
        a = 2 * np.pi * laps * k / n_frames
        c = np.asarray([radius * np.sin(a), bob * np.sin(3 * a + ph[0]),
                        -radius * np.cos(a)], np.float32)
        if face == "out":
            yaw = np.pi - a + 0.12 * np.sin(2 * a + ph[1])    # the outward radial
        else:
            yaw = a + 0.12 * np.sin(2 * a + ph[1])
        pitch = 0.05 * np.sin(2.4 * a + ph[2])
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Rz = np.asarray([sy * cp, -sp, cy * cp], np.float32)   # forward
        Rx = np.asarray([cy, 0.0, -sy], np.float32)            # right
        Ry = np.cross(Rz, Rx)
        R_cw = np.stack([Rx, Ry, Rz], axis=1).T
        t_cw = -R_cw @ c
        poses.append(SE3(torch.from_numpy(np.ascontiguousarray(R_cw)).to(dev),
                         torch.from_numpy(t_cw).to(dev)))
    return poses


class TwoPlaneScene(_Scene):
    """Non-planar world: a near plane (z = z_near, world x < x_split)
    occluding a far plane (z = z_far, everywhere), each with its own
    texture: a depth discontinuity whose occlusion boundary moves with the
    camera (the F/E initialisation path and tracking through occlusion)."""

    def __init__(self, cam, z_near: float = 2.0, z_far: float = 4.5,
                 x_split: float = 0.15, tex_size: int = 1024,
                 tex_per_meter: float = 110.0, seed: int = 0, device=None):
        dev = resolve_device(device)
        self.cam = cam
        self.z_near = z_near
        self.z_far = z_far
        self.x_split = x_split
        self.tex = make_texture(tex_size, seed, device=dev)
        self.tex_far = make_texture(tex_size, seed + 7919, device=dev)
        self.tex_per_meter = tex_per_meter
        self.tex_size = tex_size

    def _hits(self, px: torch.Tensor, T_cw: SE3):
        d_w, o_w = _rays(self.cam, px, T_cw)
        dz = _safe(d_w[..., 2])
        t_near = (self.z_near - o_w[2]) / dz
        t_far = (self.z_far - o_w[2]) / dz
        h_near = o_w + t_near[..., None] * d_w
        h_far = o_w + t_far[..., None] * d_w
        return h_near, h_far, (t_near > 0) & (h_near[..., 0] < self.x_split)

    def world_from_pixel(self, px: torch.Tensor, T_cw: SE3) -> torch.Tensor:
        h_near, h_far, near_ok = self._hits(px, T_cw)
        return torch.where(near_ok[..., None], h_near, h_far)

    def render(self, T_cw: SE3, shape: tuple[int, int]) -> torch.Tensor:
        _, _, px = _pixel_grid(shape, self.tex.device)
        h_near, h_far, near_ok = self._hits(px, T_cw)

        def tex_at(tex, pts):
            tx = pts[..., 0] * self.tex_per_meter + self.tex_size / 2
            ty = pts[..., 1] * self.tex_per_meter + self.tex_size / 2
            return bilinear(tex, torch.stack([tx, ty], dim=-1))

        return torch.where(near_ok, tex_at(self.tex, h_near), tex_at(self.tex_far, h_far))
