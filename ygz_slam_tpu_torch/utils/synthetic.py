"""Synthetic photometric scene with exact ground truth (counterpart of
make_texture and PlaneScene in ygz_slam_tpu/utils/synthetic.py).

The texture is made with numpy from a seed, so it is the JAX package's
texture bit for bit; rendering runs on the texture's device, the card
unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geometry.se3 import SE3
from ..ops.interp import bilinear


def make_texture(size: int = 1024, seed: int = 0, octaves: int = 4,
                 decay: float = 0.5, device=None) -> torch.Tensor:
    """Smooth multi-octave random texture [size, size] float32 in [40, 215]."""
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
    return torch.from_numpy(np.asarray(40.0 + 175.0 * tex, np.float32)).to(
        resolve_device(device))


class PlaneScene:
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
        """Intersect pixel rays with the plane -> world points [..., 3]."""
        T_wc = T_cw.inverse()
        bearing_c = self.cam.pixel_to_camera(px, 1.0, distorted=True)
        d_w = torch.einsum("ij,...j->...i", T_wc.R, bearing_c)
        o_w = T_wc.t
        d_z = d_w[..., 2]
        t = (self.plane_z - o_w[2]) / torch.where(torch.abs(d_z) < 1e-9, 1e-9, d_z)
        return o_w + t[..., None] * d_w

    def render(self, T_cw: SE3, shape: tuple[int, int]) -> torch.Tensor:
        """Render an [H, W] image from camera pose T_cw."""
        H, W = shape
        dev = self.tex.device
        v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                              torch.arange(W, dtype=torch.float32, device=dev),
                              indexing="ij")
        w_pts = self.world_from_pixel(torch.stack([u, v], dim=-1), T_cw)
        tx = w_pts[..., 0] * self.tex_per_meter + self.tex_size / 2
        ty = w_pts[..., 1] * self.tex_per_meter + self.tex_size / 2
        return bilinear(self.tex, torch.stack([tx, ty], dim=-1))

    def depth(self, px: torch.Tensor, T_cw: SE3) -> torch.Tensor:
        """Ground-truth z-depth of the plane at pixels [..., 2]."""
        return T_cw.apply(self.world_from_pixel(px, T_cw))[..., 2]
