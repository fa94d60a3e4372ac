"""The plain reference that decides `correct`: the truth the benchmark
rendered from, and what the system returned, compared in NumPy (float64).
Each driver's comparison is `slambench/judges/<driver>.py`; this module holds
what they share and the verdict against a cell's limits.

Nothing here imports the system under test; its outputs are only read.
"""
from __future__ import annotations

import importlib

import numpy as np


def umeyama_sim3(src: np.ndarray, dst: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """(s, R, t) minimising sum ||dst - (s R src + t)||^2 over points [N, 3]."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    cov = b.T @ a / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    E = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        E[2, 2] = -1.0
    R = U @ E @ Vt
    var = (a ** 2).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ E) / var) if var > 0 else 0.0
    return s, R, mu_d - s * R @ mu_s


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres [N, 3] of T_cw poses R [N, 3, 3], t [N, 3]."""
    return -np.einsum("nji,nj->ni", R, t)


def judge(driver: str, out: dict) -> dict:
    """The compared numbers of a run of `driver`, by `slambench/judges/<driver>.py`."""
    return importlib.import_module(f"slambench.judges.{driver}").judge(out)


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit, "<=" or ">=")]) for the cell's limits:
    a number with `better` "lower" must not exceed its limit, one with
    "higher" must not fall below it; a NaN fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = numbers[name]
        if lim["better"] == "lower":
            good, op = v <= lim["limit"], "<="
        else:
            good, op = v >= lim["limit"], ">="
        ok = ok and bool(good)
        rows.append((name, v, lim["limit"], op))
    return ok, rows
