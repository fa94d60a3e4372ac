#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ygz_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on failure:

1. Header: the card's name and power limit, torch and CUDA versions, and
   the nvcc build of every kernel in ygz_slam_tpu_torch/csrc.
2. Kernel versus plain version: each kernel of the tracking step (K1
   gather_windows, K3 sparse_align_mega, K4 align2d_fused, K5
   pose_ba_fused) is called on the inputs the main path gives it on
   frame 1 of the workload and held against its plain PyTorch version on
   the same inputs, at the stated tolerance; K3-K5 again at 512
   landmarks.  Kernel times are medians of per-launch CUDA-event
   intervals with the host's enqueue hidden behind a sleep kernel.
3. Main path: the 640x480 / 200-landmark tracking workload, rendered on
   the card, through `track_frames`, every frame held to the accuracy
   gate; the launch counters must show K3, K4 and K5 once per frame and
   K1 four times per frame.
4. A short torch.profiler window over the main path: device busy share
   and the kernels that take the most device time.
5. One JSON line {"kernels": [...]}, then the last line
   {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when no CUDA device is available
or the package is not beside it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_FRAMES = 240
REPS = 30               # kernel timing: per-launch intervals, median
PLAIN_REPS = 5          # plain versions sync on the host: fewer reps
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

# Tolerances, kernel versus plain version on the same inputs.  The two
# sum in different orders (warp shuffles versus PyTorch reductions) and
# the kernels contract multiply-adds, so results differ in float32
# rounding only: ~1e-6 relative in each normal equation.
TOL_POSE = 1e-4         # K3/K5 pose distance: rounding can move a pose by
                        # a fraction of the 1e-4 stopping step
TOL_XY = 1e-3           # K4, px, on >= 98% of the points both accept;
TOL_XY_ALL = 0.05       # all of them within 0.05 px: a 0.03 px freeze
                        # decision may flip on rounding and skip one step
MIN_MASK_AGREE = 0.98   # K4 acceptance masks
MIN_INLIER_AGREE = 0.99  # K5 inlier sets


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _time_kernel(torch, fn, reps=REPS):
    """Median device time (ms) of one launch of fn(): events between
    consecutive launches, the host's enqueue hidden behind a sleep."""
    fn()
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(20_000_000)
    evs[0].record()
    for i in range(reps):
        fn()
        evs[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1]) for i in range(reps))


def _time_host(torch, fn, reps=PLAIN_REPS):
    """Median wall time (ms) of fn() to completion (plain versions, which
    synchronise with the host inside)."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ygz_slam_tpu_torch")):
        print("chip_smoke: the ygz_slam_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    from ygz_slam_tpu_torch import _build
    from ygz_slam_tpu_torch.geometry import se3
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.models import tracking as tr
    from ygz_slam_tpu_torch.ops import pyramid
    from ygz_slam_tpu_torch.ops.kernels import align2d_fused as k4
    from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as k1
    from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused as k5
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as k3
    from ygz_slam_tpu_torch.ops.align import accepted, align2d, substitute_inits

    # -- 1. header ------------------------------------------------------
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.sources())} sources "
          f"(nvcc {_build.last_build_seconds:.2f} s)", flush=True)
    dev = torch.device("cuda")

    # -- 2. kernel versus plain version ---------------------------------
    t0 = time.perf_counter()
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(
        N_FRAMES, dev)
    torch.cuda.synchronize()
    print(f"workload: {N_FRAMES} frames 640x480, {px.shape[0]} landmarks, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)

    def frame_inputs(st, img, T_init):
        """Each kernel's inputs on one frame of the main path."""
        cur_pyr = pyramid.build_pyramid(img, tr.N_LEVELS)
        a3, _, _ = k3.mega_args(cur_pyr, st.ref_prep.levels, st.ref_prep.p_ref, T_init.R,
                                T_init.t, st.cam, False, tr.N_LEVELS,
                                st.ref_prep.mega_refp, st.ref_prep.mega_jl)
        T_sa = SE3(*_pose_of(k3.mega_gn(*a3)))
        proj = st.cam.world_to_pixel(st.pts_w, T_sa, distorted=False)
        ares = align2d(cur_pyr[0], st.patches, proj, prep=st.a2d_prep)
        H, W = cur_pyr[0].shape
        xy0s, inb0 = substitute_inits(proj, H, W)
        a4 = k4.a2d_args(cur_pyr[0], st.a2d_prep, xy0s)
        a5 = k5.pose_ba_args(T_sa, st.pts_w, ares.xy, ares.converged & st.mask, st.cam)
        g1 = [(cur_pyr[li], a3[5][li], a3[6][li], k3.CWIN) for li in range(tr.N_LEVELS)]
        g1.append((cur_pyr[0], a4[5], a4[6], k1.CACHE_WIN))
        return g1, a3, (a4, proj, inb0, H, W), a5

    def _pose_of(out):
        return out[:9].reshape(3, 3), out[9:12]

    report = {}

    def check_k1(g1, tag):
        err = 0.0
        for img, ox, oy, win in g1:
            a = k1.gather_windows(img, ox, oy, win)
            b = k1.gather_windows_plain(img, ox, oy, win)
            lib = img.unfold(0, win, 1).unfold(1, win, 1)[oy.long(), ox.long()]
            err = max(err, float((a - b).abs().max()), float((a - lib).abs().max()))
        print(f"K1 gather_windows {tag}: max |kernel - plain| = {err} (tolerance 0, exact copy)")
        if err != 0.0:
            raise AssertionError("K1 disagrees with its plain version")
        return err

    def check_k3(a3, tag):
        out = k3.mega_gn(*a3)
        stats = {}
        ref = k3.mega_gn_plain(*a3, stats=stats)
        d = float(se3.distance(SE3(*_pose_of(out)), SE3(*_pose_of(ref))))
        err = float((out[:12] - ref[:12]).abs().max())
        print(f"K3 sparse_align_mega {tag}: pose distance {d:.3e} (tolerance {TOL_POSE}), "
              f"max |R,t diff| {err:.3e}, chi2 {float(out[12]):.4f} vs {float(ref[12]):.4f}, "
              f"passes per level {stats['passes']}")
        if not d <= TOL_POSE:
            raise AssertionError("K3 disagrees with its plain version")
        return err, stats

    def check_k4(k4_in, tag):
        a4, proj, inb0, H, W = k4_in
        out = k4.a2d_gn(*a4)
        ref = k4.a2d_gn_plain(*a4)
        ma, mb = (accepted(o[:, :2], o[:, 3], proj, inb0, H, W) for o in (out, ref))
        agree = float((ma == mb).float().mean())
        both = ma & mb
        dxy = torch.linalg.norm(out[both, :2] - ref[both, :2], dim=1)
        err = float(dxy.max()) if dxy.numel() else 0.0
        close = float((dxy <= TOL_XY).float().mean()) if dxy.numel() else 1.0
        print(f"K4 align2d_fused {tag}: max |xy diff| {err:.3e} px on {int(both.sum())} "
              f"accepted points, {close:.4f} within {TOL_XY} px (need {MIN_MASK_AGREE}), "
              f"all within {TOL_XY_ALL}; accept masks agree {agree:.4f} "
              f"(need {MIN_MASK_AGREE})")
        if not (err <= TOL_XY_ALL and close >= MIN_MASK_AGREE and agree >= MIN_MASK_AGREE):
            raise AssertionError("K4 disagrees with its plain version")
        return err

    def check_k5(a5, tag):
        out, inl = k5.pose_ba_gn(*a5)
        stats = {}
        ref, inl_ref = k5.pose_ba_gn_plain(*a5, stats=stats)
        d = float(se3.distance(SE3(*_pose_of(out)), SE3(*_pose_of(ref))))
        err = float((out[:12] - ref[:12]).abs().max())
        agree = float(((inl > 0.5) == (inl_ref > 0.5)).float().mean())
        print(f"K5 pose_ba_fused {tag}: pose distance {d:.3e} (tolerance {TOL_POSE}), "
              f"max |R,t diff| {err:.3e}, inliers {int((inl > 0.5).sum())} vs "
              f"{int((inl_ref > 0.5).sum())}, sets agree {agree:.4f} "
              f"(need {MIN_INLIER_AGREE}), normal equations {stats['normal_eqs']}")
        if not (d <= TOL_POSE and agree >= MIN_INLIER_AGREE):
            raise AssertionError("K5 disagrees with its plain version")
        return err, stats

    T_init = SE3.from_params7(T_gt7[0])
    g1, a3, a4, a5 = frame_inputs(state, frames[1], T_init)
    torch.cuda.synchronize()
    e1 = check_k1(g1, "N=200")
    e3, st3 = check_k3(a3, "N=200")
    e4 = check_k4(a4, "N=200")
    e5, st5 = check_k5(a5, "N=200")

    # Times and bounds at the main path's shapes.
    N = px.shape[0]
    L = tr.N_LEVELS
    k1_ms = sum(_time_kernel(torch, lambda g=g: k1.gather_windows(*g)) for g in g1)
    k1_plain = sum(_time_host(torch, lambda g=g: k1.gather_windows_plain(*g)) for g in g1)
    # Yardstick: one advanced-indexing gather on int64 origins made beforehand.
    g1_lib = [(img, oy.long(), ox.long(), win) for img, ox, oy, win in g1]
    k1_lib = sum(_time_kernel(torch, lambda g=g: g[0].unfold(0, g[3], 1).unfold(1, g[3], 1)
                              [g[1], g[2]]) for g in g1_lib)
    k1_bytes = sum(N * (2 * g[3] * g[3] * 4 + 8) for g in g1)
    report["K1"] = dict(ms=k1_ms, plain=k1_plain, lib=k1_lib, err=e1,
                        bound=_bound(k1_bytes, 0.0))
    k3_ms = _time_kernel(torch, lambda: k3.mega_gn(*a3))
    k3_plain = _time_host(torch, lambda: k3.mega_gn_plain(*a3))
    k3_bytes = L * N * (256 + 16 + 96 + 1 + 2) * 4 + N * 12 + 48 + 52
    # per point: Hessian pass ~700 flops, residual pass ~400 flops
    k3_flops = sum(N * (700 + 400 * p) for p in st3["passes"])
    report["K3"] = dict(ms=k3_ms, plain=k3_plain, lib=None, err=e3,
                        bound=_bound(k3_bytes, k3_flops))
    k4_ms = _time_kernel(torch, lambda: k4.a2d_gn(*a4[0]))
    k4_plain = _time_host(torch, lambda: k4.a2d_gn_plain(*a4[0]))
    k4_bytes = N * (1024 * 4 + 3 * 64 * 4 + 36 + 8 + 8 + 16)
    k4_flops = N * 11 * (64 * 15 + 30)          # 10 iterations + final residual
    report["K4"] = dict(ms=k4_ms, plain=k4_plain, lib=None, err=e4,
                        bound=_bound(k4_bytes, k4_flops))
    k5_ms = _time_kernel(torch, lambda: k5.pose_ba_gn(*a5))
    k5_plain = _time_host(torch, lambda: k5.pose_ba_gn_plain(*a5))
    k5_bytes = N * (12 + 8 + 4) + 48 + N * 4 + 52
    # per point: normal equation ~180 flops; 27 bisection/count passes ~25
    k5_flops = N * (180 * st5["normal_eqs"] + 27 * 25 + 4 * 30)
    report["K5"] = dict(ms=k5_ms, plain=k5_plain, lib=None, err=e5,
                        bound=_bound(k5_bytes, k5_flops))
    print("K1 times below are per frame: the sum over its 4 launches (3 levels x 16^2, 32^2)")
    for k, r in report.items():
        lib = "null" if r["lib"] is None else f"{r['lib']:.4f}"
        print(f"{k}: kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, library {lib} ms, "
              f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)

    # The same kernels at 512 landmarks (the VO's visible-subset size).
    cam5, px5, depth5, mask5, pts5, patches5, ref_pyr5, frames5, T_gt5 = tr.make_workload(
        2, dev, n_points=512)
    state5 = tr.make_state(cam5, ref_pyr5, px5, depth5, mask5, pts5, patches5)
    g1_5, a3_5, a4_5, a5_5 = frame_inputs(state5, frames5[1], SE3.from_params7(T_gt5[0]))
    check_k1(g1_5, "N=512")
    check_k3(a3_5, "N=512")
    check_k4(a4_5, "N=512")
    check_k5(a5_5, "N=512")

    # -- 3. main path -----------------------------------------------------
    counters = (k1.gather_windows, k3.mega_gn, k4.a2d_gn, k5.pose_ba_gn)
    T0 = SE3.identity(device=dev).params7()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T7, inl = tr.track_frames(state, frames, T0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    max_err, min_inl, ok = tr.gate(T7, inl, T_gt7)
    print(f"main path: {N_FRAMES} frames in {wall:.3f} s = {N_FRAMES / wall:.1f} frames/s; "
          f"gate max pose error {max_err:.3e} (< 2e-2), min inliers {min_inl} (> 150): "
          f"{'pass' if ok else 'FAIL'}; launches {launches}", flush=True)
    if not ok:
        raise AssertionError("main path failed the per-frame accuracy gate")
    want = {"gather_windows": 4 * N_FRAMES, "mega_gn": N_FRAMES, "a2d_gn": N_FRAMES,
            "pose_ba_gn": N_FRAMES}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    reps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.track_frames(state, frames, T0)
        torch.cuda.synchronize()
        reps.append(N_FRAMES / (time.perf_counter() - t0))
    print(f"main path repeats: {[round(r, 1) for r in reps]} frames/s", flush=True)

    # -- 4. profile window ---------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    n_prof = 30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.track_frames(state, frames[:n_prof], T0)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue                     # device-side events only: no double count
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt, e.key, e.count))
    busy_us = sum(r[0] for r in rows)
    print(f"profile: {n_prof} frames, wall {wall_prof * 1e3 / n_prof:.3f} ms/frame, "
          f"device busy {busy_us / n_prof / 1e3:.3f} ms/frame "
          f"({busy_us / (wall_prof * 1e6):.3f} of wall)")
    for dt, key, count in sorted(rows, reverse=True)[:10]:
        print(f"  {dt / n_prof:9.2f} us/frame  {count // n_prof:3d}/frame  {key[:90]}")

    # -- 5. result lines ------------------------------------------------------
    meta = {
        "K1": ("gather_windows", "ygz_slam_tpu_torch/csrc/gather_windows.cu",
               "ygz_slam_tpu/ops/pallas/align2d_kernel.py:77", launches["gather_windows"]),
        "K3": ("sparse_align_mega", "ygz_slam_tpu_torch/csrc/sparse_align_mega.cu",
               "ygz_slam_tpu/ops/pallas/sparse_align_mega.py:338", launches["mega_gn"]),
        "K4": ("align2d_fused", "ygz_slam_tpu_torch/csrc/align2d_fused.cu",
               "ygz_slam_tpu/ops/pallas/align2d_fused.py:317", launches["a2d_gn"]),
        "K5": ("pose_ba_fused", "ygz_slam_tpu_torch/csrc/pose_ba_fused.cu",
               "ygz_slam_tpu/ops/pallas/pose_ba_fused.py:326", launches["pose_ba_gn"]),
    }
    kernels = []
    for k, (name, src, replaces, n_launch) in meta.items():
        r = report[k]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n_launch, "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": r["lib"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
