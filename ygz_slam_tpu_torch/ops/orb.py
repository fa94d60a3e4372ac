"""ORB orientation and binary descriptors, batched over keypoints
(counterpart of ygz_slam_tpu/ops/orb.py).

Per-keypoint 31x31 patches are gathered once; the intensity-centroid
moments and all 256 steered-BRIEF comparisons run over the patch axis.  The
256-pair pattern is the generated one (seeded Gaussian pairs clipped to the
radius-13 disc): numpy's `default_rng(1234)` gives both packages the same
pairs.  Descriptors are packed to 8 int32 words (bit i of word w = bit
32 w + i; the bit pattern of the JAX package's uint32 words).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .interp import extract_patches
from .pyramid import _conv1d

PATCH = 31
HALF_PATCH = 15
PATTERN_RADIUS = 13
N_BITS = 256


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 2, 2] int32 (pair, endpoint, (x, y)) Gaussian test pairs, iid
    N(0, (PATCH/5)^2), rejected outside the radius-13 disc so any in-plane
    rotation keeps them inside the 31x31 patch."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(0.0, PATCH / 5.0, size=(N_BITS, 2))
        cand = np.round(cand).astype(np.int32)
        keep = (cand[:, 0] ** 2 + cand[:, 1] ** 2) <= PATTERN_RADIUS ** 2
        pts.extend(cand[keep].tolist())
    pts = np.asarray(pts[: N_BITS * 2], dtype=np.int32)
    return pts.reshape(N_BITS, 2, 2)


PATTERN = _make_pattern()       # [256, 2, 2]


def _circle_umax() -> np.ndarray:
    """Per-row half-width of the radius-15 circular patch (ORB-SLAM's
    u_max construction)."""
    umax = np.zeros(HALF_PATCH + 1, dtype=np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _circular_mask() -> np.ndarray:
    """[31, 31] float mask of the IC_Angle circular patch."""
    umax = _circle_umax()
    m = np.zeros((PATCH, PATCH), dtype=np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = umax[abs(v)]
        m[v + HALF_PATCH, HALF_PATCH - d: HALF_PATCH + d + 1] = 1.0
    return m


@lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(mask, xx, yy [31, 31] float32; pattern x, y [256, 2] float32; bit
    weights [32] int32) on `device`."""
    ar = np.arange(-HALF_PATCH, HALF_PATCH + 1).astype(np.float32)
    xx = np.broadcast_to(ar[None, :], (PATCH, PATCH)).copy()
    yy = np.broadcast_to(ar[:, None], (PATCH, PATCH)).copy()
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    arrs = (_circular_mask(), xx, yy, PATTERN[..., 0].astype(np.float32),
            PATTERN[..., 1].astype(np.float32), weights)
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per patch [N, 31, 31] -> radians [N]:
    atan2(m01, m10) over the radius-15 circular patch (IC_Angle,
    FeatureDetector.cpp:509-537)."""
    mask, xx, yy = _constants(patches.device)[:3]
    w = patches * mask[None]
    m10 = torch.sum(w * xx[None], dim=(1, 2))
    m01 = torch.sum(w * yy[None], dim=(1, 2))
    return torch.atan2(m01, m10)


def describe_patches(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF descriptors: [N, 31, 31] patches + [N] angles -> packed
    int32 [N, 8].  Pattern points are rotated by the keypoint angle, rounded
    to integers, and the 256 comparisons gathered in one pass
    (ComputeOrbDescriptor, FeatureDetector.cpp:539-578)."""
    N = patches.shape[0]
    px, py = _constants(patches.device)[3:5]                         # [256, 2]
    ca, sa = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    rx = torch.round(px[None] * ca - py[None] * sa)
    ry = torch.round(px[None] * sa + py[None] * ca)
    ix = torch.clamp(rx.long() + HALF_PATCH, 0, PATCH - 1)           # [N, 256, 2]
    iy = torch.clamp(ry.long() + HALF_PATCH, 0, PATCH - 1)
    flat = patches.reshape(N, PATCH * PATCH)
    vals = torch.gather(flat, 1, (iy * PATCH + ix).reshape(N, -1)).reshape(N, N_BITS, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 (bit i of word w = bit 32 w + i)."""
    weights = _constants(bits.device)[5]
    b = bits.reshape(bits.shape[0], 8, 32).to(torch.int32)
    return torch.sum(b * weights[None, None, :], dim=-1, dtype=torch.int32)


def blur_for_descriptors(img: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Gaussian pre-blur before BRIEF sampling: three passes of the
    separable 5-tap binomial filter (the JAX package's measured choice)."""
    for _ in range(passes):
        img = _conv1d(_conv1d(img, 0), 1)
    return img


def compute(img: torch.Tensor, xy: torch.Tensor):
    """Angles [N] + packed descriptors [N, 8] for keypoints `xy [N, 2]` on
    one pyramid level (ComputeAngleAndDescriptor).  Angles use the raw
    image; BRIEF bits sample the blurred image."""
    angles = ic_angle(extract_patches(img, xy, PATCH))
    return angles, describe_patches(extract_patches(blur_for_descriptors(img), xy, PATCH), angles)
