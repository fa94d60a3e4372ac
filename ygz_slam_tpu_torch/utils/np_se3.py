"""Pure-NumPy SE(3) helpers over params7 (wxyz quaternion + t), a copy of
ygz_slam_tpu/utils/np_se3.py.

Host-side bookkeeping (the keyframe decision, trajectory anchoring)
composes poses at frame rate on the host, where a device pose would cost a
transfer per operation.  The conventions are geometry/se3.py's (T_cw as
quat(wxyz)+t acting by x' = R x + t).
"""
from __future__ import annotations

import numpy as np


def params7_to_Rt(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[..., 7] -> (R [..., 3, 3], t [..., 3]); batched."""
    p = np.asarray(p, np.float64)
    q = p[..., :4]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], axis=-1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], axis=-1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)
    return R, p[..., 4:7]


def Rt_to_params7(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(R [..., 3, 3], t [..., 3]) -> [..., 7]; batched.

    Full four-branch Shepperd method: branch on the largest of
    (tr, m00, m11, m22) per element and derive the remaining
    components from off-diagonal SUMS for that branch.  A
    copysign-on-antisymmetric-terms shortcut fails for 180-degree
    rotations (R21-R12 = 4wx etc. all vanish there), mis-signing the
    axis — this path feeds trajectory anchoring and pose-graph edges,
    so it must be exact everywhere on SO(3)."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    m01, m02, m10 = R[..., 0, 1], R[..., 0, 2], R[..., 1, 0]
    m12, m20, m21 = R[..., 1, 2], R[..., 2, 0], R[..., 2, 1]
    tr = m00 + m11 + m22

    def _s(x):
        return 2.0 * np.sqrt(np.maximum(x, 1e-12))

    s0 = _s(1.0 + tr)                  # branch 0: qw dominant
    c0 = np.stack([s0 / 4, (m21 - m12) / s0,
                   (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    s1 = _s(1.0 + m00 - m11 - m22)     # branch 1: qx dominant
    c1 = np.stack([(m21 - m12) / s1, s1 / 4,
                   (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    s2 = _s(1.0 - m00 + m11 - m22)     # branch 2: qy dominant
    c2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2,
                   s2 / 4, (m12 + m21) / s2], axis=-1)
    s3 = _s(1.0 - m00 - m11 + m22)     # branch 3: qz dominant
    c3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                   (m12 + m21) / s3, s3 / 4], axis=-1)

    branch = np.argmax(np.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    cands = np.stack([c0, c1, c2, c3], axis=-2)  # [..., 4branch, 4q]
    q = np.take_along_axis(
        cands, branch[..., None, None], axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0 (params7 convention elsewhere).
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    return np.concatenate([q, t], axis=-1).astype(np.float64)


def compose7(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """params7 of A @ B (apply B first); batched."""
    Ra, ta = params7_to_Rt(a)
    Rb, tb = params7_to_Rt(b)
    R = Ra @ Rb
    t = np.einsum("...ij,...j->...i", Ra, tb) + ta
    return Rt_to_params7(R, t)


def inverse7(a: np.ndarray) -> np.ndarray:
    """params7 of A^-1; batched."""
    R, t = params7_to_Rt(a)
    Rt = np.swapaxes(R, -1, -2)
    return Rt_to_params7(Rt, -np.einsum("...ij,...j->...i", Rt, t))


def relative7(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """params7 of A @ B^-1 (the pose of A relative to B); batched."""
    return compose7(a, inverse7(b))


def log6(p: np.ndarray) -> np.ndarray:
    """SE(3) log of a single params7 pose -> [6] (trans, rot) twist, the
    host mirror of geometry.se3.log that the keyframe decision reads."""
    R, t = params7_to_Rt(np.asarray(p, np.float64))
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(cos))
    vee = 0.5 * np.asarray(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    if th < 1e-7:
        w = vee
        Vinv = np.eye(3) - 0.5 * _hat(w)
    else:
        w = th / np.sin(th) * vee
        W = _hat(w)
        # V^{-1} = I - W/2 + (1/th^2)(1 - th sin th / (2 (1-cos th))) W^2
        coef = (1.0 - th * np.sin(th) / (2.0 * (1.0 - np.cos(th)))) / (
            th * th
        )
        Vinv = np.eye(3) - 0.5 * W + coef * (W @ W)
    v = Vinv @ t
    return np.concatenate([v, w]).astype(np.float64)


def _hat(w: np.ndarray) -> np.ndarray:
    return np.asarray([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])
