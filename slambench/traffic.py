"""The one traffic generator: reads a mix from `slambench/traffic/<name>.json`
and makes its camera poses, exposure and noise from the seed.

A camera path is

    T_cw(k) = exp(xi(k)) * T_base(k)

where T_base is a point on the box-room loop (`scene.loop_pose`: centre on a
circle of `radius`, facing out, `frames_per_lap` frames a lap (none: the
camera stays at `start_angle`), the wobble's phases drawn from the seed) or
the identity when the mix has no `loop`, and xi(k) [6] = (rho, phi) in the
camera frame is `offset` plus `waves` ([axis, amplitude, period in frames,
phase]) plus `ramps` ([axis, amount, first frame, frames], a smoothstep).
`clip` frames, when given, repeat: frame k is frame k mod clip of the path.

Each seed sees the same path shape, sizes and frame count; it moves the
loop's wobble phases and the sensor noise (the drivers draw the noise).
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from . import scene

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _smoothstep(x: float) -> float:
    x = min(max(x, 0.0), 1.0)
    return x * x * (3.0 - 2.0 * x)


def xi_at(path: dict, k: int) -> np.ndarray:
    xi = np.asarray(path.get("offset", [0.0] * 6), np.float64).copy()
    for axis, amp, period, phase in path.get("waves", []):
        xi[int(axis)] += amp * math.sin(2.0 * math.pi * k / period + phase)
    for axis, amount, first, frames in path.get("ramps", []):
        xi[int(axis)] += amount * _smoothstep((k - first) / frames)
    return xi


def poses(mix: dict, seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(R_cw [n, 3, 3], t_cw [n, 3]) float64 of frames 0..n-1."""
    path = mix["path"]
    loop = path.get("loop")
    ph = np.random.default_rng(seed % 2 ** 63).uniform(0.0, 2.0 * math.pi, 3)
    clip = path.get("clip")
    Rs, ts = np.empty((n, 3, 3)), np.empty((n, 3))
    for k in range(n):
        j = k % clip if clip else k
        if loop:
            lap = loop.get("frames_per_lap")
            a = loop.get("start_angle", 0.0) + (2.0 * math.pi * j / lap if lap else 0.0)
            Rb, tb = scene.loop_pose(a, loop["radius"], loop.get("bob", 0.0), ph)
        else:
            Rb, tb = np.eye(3), np.zeros(3)
        Rx, tx = scene.se3_exp(xi_at(path, j))
        Rs[k], ts[k] = Rx @ Rb, Rx @ tb + tx
    return Rs, ts


def exposure(mix: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame gain and bias (the accuracy benchmark's slow drift)."""
    p = mix.get("photometric", {})
    k = np.arange(n, dtype=np.float64)
    gain = 1.0 + p.get("gain_amp", 0.0) * np.sin(2 * np.pi * k / p.get("gain_period", 1.0))
    bias = p.get("bias_amp", 0.0) * np.sin(2 * np.pi * k / p.get("bias_period", 1.0))
    return gain, bias


def window_frames(mix: dict, seconds: float) -> int:
    """Frames made for the measured window: the most the window could use
    at `max_rate_hz`, or the clip, which the window replays."""
    if mix["path"].get("clip"):
        return 0
    return int(math.ceil(mix["max_rate_hz"] * seconds))
