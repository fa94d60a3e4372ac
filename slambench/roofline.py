"""Operations and bytes of the tracking kernels and of the fleet's step, and
the least time the card could take for them: a frozen copy of the
arithmetic behind `PERF.md`'s kernel table (chip_smoke.py's `_bound`,
`_gather_bytes` and the K3, K4, K8 counts), and the step's bound built on it.

Peaks: one NVIDIA H100 SXM (data sheet, 700 W): 3.35 TB/s of HBM3, 67
TFLOP/s in float32 outside the tensor cores.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Floats per point per level that K3 reads: its 16x16 frame window (256),
# the 4x4 reference patch (16), its Jacobians (16 x 6 = 96), a valid flag
# and the keyframe pixel (2).
K3_WINDOW, K3_KEYFRAME = 256, 16 + 96 + 1 + 2
# Bytes per point that K4 reads and writes: its 32x32 window, the 8x8
# patch with its two gradients, the 3x3 inverse normal matrix, the init,
# the result, the error and the flags.
K4_WINDOW, K4_KEYFRAME, K4_IO = 1024 * 4, 3 * 64 * 4 + 36, 8 + 8 + 16


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bytes(requests) -> int:
    """The least bytes a launch that gathers windows moves, for requests
    (img [H, W], xi [N], yi [N], win): each image pixel some window covers,
    read once (an image several requests name counts once), each window
    written once, and two int32 origins per window."""
    covered = {}
    nbytes = 0
    for img, xi, yi, win in requests:
        H, W = img.shape
        mask = covered.setdefault((img.data_ptr(), H, W),
                                  torch.zeros(H * W, dtype=torch.bool, device=img.device))
        d = torch.arange(win, device=img.device)
        r = yi.long()[:, None, None] + d[None, :, None]
        c = xi.long()[:, None, None] + d[None, None, :]
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        mask[(r * W + c)[inside]] = True
        nbytes += xi.shape[0] * (win * win * 4 + 8)
    return nbytes + 4 * sum(int(m.sum()) for m in covered.values())


def k3_bytes(n: int, levels: int = 3) -> int:
    return levels * n * (K3_WINDOW + K3_KEYFRAME) * 4 + n * 12 + 48 + 52


def k3_flops(n: int, passes) -> int:
    """A Hessian pass (~700 operations a point) and `p` residual passes
    (~400 each) per level."""
    return sum(n * (700 + 400 * p) for p in passes)


def k4_bytes(n: int) -> int:
    return n * (K4_WINDOW + K4_KEYFRAME + K4_IO)


def k8_bytes(s: int, n: int) -> int:
    return s * (n * (12 + 8 + 4) + 48 + n * 4 + 52)


def k8_flops(n: int, normal_eqs) -> int:
    """Per sequence: 180 operations a point per normal equation, the 6x6
    solve (27 x 25) and 4 rounds of the robust scale (30)."""
    return sum(n * (180 * ne + 27 * 25 + 4 * 30) for ne in normal_eqs)


def fleet_step(streams: int, points: int, shape, levels: int) -> tuple[int, int]:
    """(bytes, operations) the fleet's tracking step cannot do without,
    whatever kernels compute it: every input byte read once (the S frames,
    each stream's keyframe side for K3 at every level, for K4 and for K8)
    and the poses and inlier counts written once; operations for one
    Hessian and one residual pass of K3 per level, and one normal equation
    of K8.  Windows, pyramid levels and aligned pixels are intermediates
    a fused step need never write, so they are not counted."""
    H, W = shape
    S, N = streams, points
    frames = S * H * W * 4
    keyframe = S * (levels * N * K3_KEYFRAME * 4 + N * 12 + 48 + 52     # K3
                    + N * K4_KEYFRAME                                   # K4
                    + N * (12 + 4) + 48)                                # K8: points, mask, pose
    out = S * (7 + 1) * 4
    flops = S * k3_flops(N, [1] * levels) + k8_flops(N, [1] * S)
    return frames + keyframe + out, flops
