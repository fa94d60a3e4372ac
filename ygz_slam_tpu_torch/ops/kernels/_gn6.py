"""Pose-level scalar math of the Gauss-Newton twins (K3, K5, K9), in float32.

The CUDA kernels solve each 6x6 system and apply each retraction in
registers, entry by entry.  The twins do the same on the host with
numpy float32 scalars, so every operation rounds to float32 as the
kernels' do (every constant is wrapped in `F`, so no step widens to
float64 whatever numpy's promotion rules).  Poses are a 9-list (R,
row-major) and a 3-list (t).
"""
from __future__ import annotations

import numpy as np
import torch

F = np.float32
_ZERO = F(0.0)
_ONE = F(1.0)


def upper21(H: torch.Tensor) -> list:
    """[6, 6] tensor -> its 21 upper-triangular entries (a <= b)."""
    h = H.detach().to("cpu", torch.float32).numpy()
    return [h[a, b] for a in range(6) for b in range(a, 6)]


def chol6(h21: list) -> list:
    """Cholesky of the damped 6x6 (diagonal + 1e-8, pivot floor 1e-20)."""
    A = [[None] * 6 for _ in range(6)]
    k = 0
    for a in range(6):
        for b in range(a, 6):
            A[a][b] = A[b][a] = F(h21[k])
            k += 1
    L = [[_ZERO] * 6 for _ in range(6)]
    for j in range(6):
        d = A[j][j] + F(1e-8)
        for q in range(j):
            d = d - L[j][q] * L[j][q]
        ljj = np.sqrt(max(d, F(1e-20)))
        L[j][j] = ljj
        for i in range(j + 1, 6):
            s = A[i][j]
            for q in range(j):
                s = s - L[i][q] * L[j][q]
            L[i][j] = s / ljj
    return L


def chol6_frozen(h21: list) -> list:
    """K9 v2's factor (common.cuh::chol6_frozen): the Cholesky of the 6x6
    plus 1e-8 on the diagonal with no pivot floor; the identity when a
    pivot is not positive (or NaN), and any non-finite entry replaced by
    the identity's."""
    A = [[None] * 6 for _ in range(6)]
    k = 0
    for a in range(6):
        for b in range(a, 6):
            A[a][b] = A[b][a] = F(h21[k])
            k += 1
    L = [[_ZERO] * 6 for _ in range(6)]
    ok = True
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for j in range(6):
            d = A[j][j] + F(1e-8)
            for q in range(j):
                d = d - L[j][q] * L[j][q]
            ok = ok and bool(d > _ZERO)          # False for NaN
            ljj = np.sqrt(d)
            L[j][j] = ljj
            for i in range(j + 1, 6):
                s = A[i][j]
                for q in range(j):
                    s = s - L[i][q] * L[j][q]
                L[i][j] = s / ljj
    for i in range(6):
        for q in range(i + 1):
            if not (ok and np.isfinite(L[i][q])):
                L[i][q] = _ONE if i == q else _ZERO
    return L


def subst6(L: list, b: list) -> list:
    """Solve L L^T dx = b; a step with a non-finite or |.| >= 1e9 entry
    becomes zero (the guard of solvers.nlls._solve_spd)."""
    y = [_ZERO] * 6
    for i in range(6):
        s = F(b[i])
        for q in range(i):
            s = s - L[i][q] * y[q]
        y[i] = s / L[i][i]
    dx = [_ZERO] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for q in range(i + 1, 6):
            s = s - L[q][i] * dx[q]
        dx[i] = s / L[i][i]
    if not all(abs(d) < F(1e9) for d in dx):    # False for NaN too
        return [_ZERO] * 6
    return dx


def exp_se3_taylor(dx: list) -> tuple[list, list]:
    """exp(dx) for dx = (rho, phi) by the sqrt-free Taylor series with the
    1.2 rad trust clamp: (Re 9-list, te 3-list)."""
    t2 = dx[3] * dx[3] + dx[4] * dx[4] + dx[5] * dx[5]
    theta = np.sqrt(max(t2, F(1e-24)))
    sc = min(_ONE, F(1.2) / theta)
    d = [v * sc for v in dx]
    tt = t2 * sc * sc
    a = _ONE - tt / F(6) * (_ONE - tt / F(20) * (_ONE - tt / F(42) * (_ONE - tt / F(72))))
    b = F(0.5) * (_ONE - tt / F(12) * (_ONE - tt / F(30) * (_ONE - tt / F(56) * (_ONE - tt / F(90)))))
    c = (_ONE / F(6)) * (_ONE - tt / F(20) * (_ONE - tt / F(42) * (_ONE - tt / F(72) * (_ONE - tt / F(110)))))
    wx, wy, wz = d[3], d[4], d[5]
    W = [_ZERO, -wz, wy, wz, _ZERO, -wx, -wy, wx, _ZERO]
    W2 = [_ZERO] * 9
    for i in range(3):
        for j in range(3):
            acc = _ZERO
            for q in range(3):
                acc = acc + W[3 * i + q] * W[3 * q + j]
            W2[3 * i + j] = acc
    eye = [_ONE, _ZERO, _ZERO, _ZERO, _ONE, _ZERO, _ZERO, _ZERO, _ONE]
    Re = [eye[i] + a * W[i] + b * W2[i] for i in range(9)]
    V = [eye[i] + b * W[i] + c * W2[i] for i in range(9)]
    te = [V[3 * i] * d[0] + V[3 * i + 1] * d[1] + V[3 * i + 2] * d[2] for i in range(3)]
    return Re, te


def _mat3(A: list, B: list) -> list:
    return [A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
            for i in range(3) for j in range(3)]


def _vec3(A: list, v: list) -> list:
    return [A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2] for i in range(3)]


def retract_right(R: list, t: list, dx: list) -> tuple[list, list]:
    """T <- T * exp(dx)."""
    Re, te = exp_se3_taylor(dx)
    return _mat3(R, Re), [a + b for a, b in zip(_vec3(R, te), t)]


def retract_left(R: list, t: list, dx: list) -> tuple[list, list]:
    """T <- exp(dx) * T."""
    Re, te = exp_se3_taylor(dx)
    return _mat3(Re, R), [a + b for a, b in zip(_vec3(Re, t), te)]


def pose_from_tensor(pose12: torch.Tensor) -> tuple[list, list]:
    p = pose12.detach().to("cpu", torch.float32).numpy()
    return [F(v) for v in p[:9]], [F(v) for v in p[9:12]]


def pose_to_tensor(R: list, t: list, chi2, device) -> torch.Tensor:
    """[13] float32: R row-major, t, chi2 (the kernels' output layout)."""
    return torch.from_numpy(np.array(list(R) + list(t) + [chi2], np.float32)).to(device)
