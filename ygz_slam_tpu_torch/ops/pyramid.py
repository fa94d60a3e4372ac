"""Image pyramid (counterpart of ygz_slam_tpu/ops/pyramid.py).

pyrDown = edge-replicated 5-tap Gaussian [1,4,6,4,1]/16 + 2x decimation,
folded into two constant banded matrices: A_r @ img @ A_c^T.  A plain
float32 product outside any kernel (the package turns TF32 off, so the
blur stays f32-exact).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _conv1d(img: torch.Tensor, axis: int) -> torch.Tensor:
    """Edge-replicated 5-tap [1, 4, 6, 4, 1]/16 filter along one axis of an
    [H, W] image, as five shifted adds in tap order."""
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(-2, n + 2, device=img.device), 0, n - 1)
    x = img.index_select(axis, idx)
    out = None
    for t, k in enumerate((1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)):
        term = x.narrow(axis, t, n) * k
        out = term if out is None else out + term
    return out


@lru_cache(maxsize=None)
def _decim_matrix(n: int) -> np.ndarray:
    """[ceil(n/2), n]: out[j] = sum_t k[t] * in[clamp(2j + t - 2, 0, n-1)]."""
    m = (n + 1) // 2
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    A = np.zeros((m, n), np.float32)
    for t in range(5):
        idx = np.clip(2 * np.arange(m) + t - 2, 0, n - 1)
        A[np.arange(m), idx] += k[t]
    A.setflags(write=False)
    return A


@lru_cache(maxsize=None)
def _decim_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_decim_matrix(n).copy()).to(device)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid step: blur + 2x decimation as two banded products, of an
    image [H, W] or a stack [S, H, W]."""
    H, W = img.shape[-2:]
    Ar = _decim_tensor(H, img.device)
    Ac = _decim_tensor(W, img.device)
    return (Ar @ img) @ Ac.T


def build_pyramid(img: torch.Tensor, n_levels: int) -> tuple[torch.Tensor, ...]:
    """Gray image [H, W] (or a stack [S, H, W]) -> tuple of n_levels images
    (stacks), level 0 full res."""
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return tuple(levels)
