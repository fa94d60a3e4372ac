#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ygz_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on failure:

1. Header: the card's name and power limit, torch and CUDA versions, and
   the nvcc build of every kernel in ygz_slam_tpu_torch/csrc.
2. Kernel versus plain version, at the stated tolerances.  Kernel times
   are medians of per-launch CUDA-event intervals with the host's enqueue
   hidden behind a sleep kernel.
   a. The single-sequence tracking step's kernels (K1 gather_windows, K3
      sparse_align_mega, K4 align2d_fused, K5 pose_ba_fused) on the inputs
      that path gives them on frame 1 of its workload; K3-K5 again at 512
      landmarks; K1 with origins off the image.
   b. The batch path's kernels (K6 gather_windows_grouped, K3 on K6's
      windows, K2 gather_windows_multi, K4 over all S*N rows, K8
      pose_ba_fused_batch) on that path's frame-1 inputs at S=8; K2, K6
      and K8 again at S=16; K2 and K6 with origins off the image, K6 with
      a request list that names one image twice.
   c. K10 (Hamming distance matrix) against its plain version, exactly, at
      the keyframe cycle's two shapes (128 x 256 and 256 x 3072, on frame-0
      descriptors of the VO workload), at 2560 x 3072, at a ragged
      130 x 77 and with all-ones and sign-bit-only words; `match_nn` and
      the tie-breaking argmins on the card against the CPU, exactly.
   d. K1, K3, K2, K4 and K5 against their plain versions on the inputs
      that frame 10 of the VO path gives them (N=256 with masked rows for
      K3, 512 rows on the three-level pyramid stack for K2, K4 and K5),
      recorded from the step itself.
   e. K9 v1 (level_align_fused) and v2 (level_align_fused_v2) against
      their plain versions on the three per-level launches that frame 12
      of main path 4 makes under FUSED_VARIANT 1 and 2 (recorded from
      `System.track_monocular`), on level 0 with no usable point (the
      pose must not move) and with an init pose shifted so that windows
      clamp at the border; per-launch times, bounds and plain times.
   K10 is also timed against `torch.cdist(p=0)` on descriptors unpacked to
   256 float bits beforehand (the unpacking left out of its time).
3. Main path 1: the 640x480 / 200-landmark tracking workload, rendered on
   the card, through `tracking.track_frames`, every frame held to the
   accuracy gate; the launch counters must show K3, K4 and K5 once per
   frame, K1 four times per frame and the batch kernels never.
4. Main path 2: bench_batch.py's workload, S=8 sequences x 60 frames,
   through `batch.track_batch_frames`, every sequence's every frame held
   to the gate; the counters must show K6 and K3 S times per frame, K2,
   K4 and K8 once per frame, K1 and K5 never.  Aggregate frames/s is the
   median of 3 further runs.
5. Main path 3: the VO's map-tracking step and keyframe cycle, 240 frames
   640x480 on a map of K=10 keyframes x F=256 features and L=3072 landmark
   rows bootstrapped on frame 0, through `vo_workload.track_vo_frames`: a
   keyframe every 10 frames, so slots are evicted from the 10th insertion
   on; every frame held to `vo_gate`.  The counters must show, per frame,
   K3, K2, K4 and K5 once and K1 six times (three reference-patch levels
   and three window levels: the reference is the previous frame, prepared
   anew each frame); per keyframe K10 three times (two triangulation
   neighbours and the fusion with the map); K6 and K8 never.
5b. Main path 4: the monocular System from raw frames
   (`models/mono_workload.py`: 160 frames 640x480, 3 levels, map K=10 x
   F=256 x L=3072, NS=256, NSV=512) through `System.track_monocular`,
   under FUSED_VARIANT 3, 2 and 1, each run held to `mono_gate` (GOOD
   within 30 frames, no LOST frame after, Sim(3)-aligned ATE < 0.05 m)
   with at least 12 keyframes and keyframe culling at work.  Per frame
   through `track`: K2, K4, K5 once and K1 six times (three 7x7 reference
   levels, three 16x16 window levels, for K3 or for each K9 launch); K3
   once under 3, the variant's K9 entry three times under 1 or 2; K10
   three times per keyframe; K6 and K8 never.  Then, from a fresh System,
   synchronised times of the init step, `track`, the keyframe cycle and
   the mapping pass.
6. A short torch.profiler window over each main path (path 4 under
   variant 2, frames 30-49, keyframes in the window): device busy share
   and the kernels that take the most device time.
7. One JSON line {"kernels": [...]} (launches summed over the four main
   paths), then the last line {"ok": true, "device": {...}}.

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
S_BATCH = 8              # bench_batch.py's defaults: 8 sequences x 60 frames
F_BATCH = 60
N_VO = 240               # main path 3: frame 0 bootstraps the map, 239 are tracked
S_BIG = 16               # BASELINE.json config 5: 16 concurrent sequences
E2_FRAME = 12            # main path 4's frame whose K9 launches phase 2e replays
P4_PROFILE = (30, 50)    # main path 4's profiled frames (keyframes fall every ~7)
REPS = 30               # kernel timing: per-launch intervals, median
PLAIN_REPS = 5          # plain versions sync on the host: fewer reps
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores (K10's
                              # integer XOR/popcount/add are counted at this rate:
                              # the data sheet gives none for int32)

# Tolerances, kernel versus plain version on the same inputs.  The two
# sum in different orders (warp shuffles versus PyTorch reductions) and
# the kernels contract multiply-adds, so results differ in float32
# rounding only: ~1e-6 relative in each normal equation.  The gathers
# (K1, K2, K6) copy and must be exact.
TOL_POSE = 1e-4         # K3/K5/K8 pose distance: rounding can move a pose
                        # by a fraction of the 1e-4 stopping step
TOL_XY = 1e-3           # K4, px, on >= 98% of the points both accept;
TOL_XY_ALL = 0.05       # all of them within 0.05 px: a 0.03 px freeze
                        # decision may flip on rounding and skip one step
MIN_MASK_AGREE = 0.98   # K4 acceptance masks
MIN_INLIER_AGREE = 0.99  # K5/K8 inlier sets
TOL_REL = 1e-4          # K9 chi2 and H, relative


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


def _profile(torch, fn, n, label):
    """Device busy share and top kernels of fn() (n frames) under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    print(f"profile {label}: {n} frames, wall {wall * 1e3 / n:.3f} ms/frame, "
          f"device busy {busy_us / n / 1e3:.3f} ms/frame ({busy_us / (wall * 1e6):.3f} of wall), "
          f"{sum(r[2] for r in rows) / n:.1f} device kernels/frame")
    for dt, key, count in sorted(rows, reverse=True)[:10]:
        print(f"  {dt / n:9.2f} us/frame  {count / n:6.1f}/frame  {key[:90]}")


def main() -> int:
    import numpy as np
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
    from ygz_slam_tpu_torch.models import batch as bm
    from ygz_slam_tpu_torch.models import frontend as fe
    from ygz_slam_tpu_torch.models import tracking as tr
    from ygz_slam_tpu_torch.models import vo_workload as vw
    from ygz_slam_tpu_torch.ops import hamming, kernels
    from ygz_slam_tpu_torch.ops import pyramid, sparse_align
    from ygz_slam_tpu_torch.ops.kernels import align2d_fused as k4
    from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as k1
    from ygz_slam_tpu_torch.ops.kernels import hamming_kernel as k10
    from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused as k5
    from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused_batch as k8
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_fused as k9
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as k3
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import visual_odometry as vo_mod
    from ygz_slam_tpu_torch.system.system import System
    from ygz_slam_tpu_torch.ops.align import accepted, align2d, substitute_inits
    from ygz_slam_tpu_torch.parallel import batch_tracking as bt

    # -- 1. header ------------------------------------------------------
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t_start = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t_start:.2f} s for {len(_build.sources())} sources "
          f"(nvcc {_build.last_build_seconds:.2f} s)", flush=True)
    dev = torch.device("cuda")
    L = tr.N_LEVELS

    # -- 2a. single-sequence kernels versus plain versions -------------------
    t0 = time.perf_counter()
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(
        N_FRAMES, dev)
    torch.cuda.synchronize()
    print(f"workload: {N_FRAMES} frames 640x480, {px.shape[0]} landmarks, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)

    def frame_inputs(st, img, T_init):
        """Each kernel's inputs on one frame of the main path."""
        cur_pyr = pyramid.build_pyramid(img, L)
        a3, _ = k3.mega_args(cur_pyr, st.ref_prep.levels, st.ref_prep.p_ref, T_init.R,
                             T_init.t, st.cam, False, L, st.ref_prep.mega_refp,
                             st.ref_prep.mega_jl)
        T_sa = SE3(*_pose_of(k3.mega_gn(*a3)))
        proj = st.cam.world_to_pixel(st.pts_w, T_sa, distorted=False)
        ares = align2d(cur_pyr[0], st.patches, proj, prep=st.a2d_prep)
        H, W = cur_pyr[0].shape
        xy0s, inb0 = substitute_inits(proj, H, W)
        a4 = k4.a2d_args(cur_pyr[0], st.a2d_prep, xy0s)
        a5 = k5.pose_ba_args(T_sa, st.pts_w, ares.xy, ares.converged & st.mask, st.cam)
        g1 = [(cur_pyr[li], a3[5][li], a3[6][li], k3.CWIN) for li in range(L)]
        g1.append((cur_pyr[0], a4[5], a4[6], k1.CACHE_WIN))
        return g1, a3, (a4, proj, inb0, H, W), a5

    def _pose_of(out):
        return out[:9].reshape(3, 3), out[9:12]

    report = {}
    rng = np.random.default_rng(7)

    def off_image(xi, yi, H, W, win):
        """Copies of int32 origins [N] with a third of them drawn from
        [-40, W+10] x [-40, H+10], corners beyond W - win / H - win planted."""
        xo, yo = xi.clone(), yi.clone()
        n = xi.shape[0] // 3
        xs = rng.integers(-40, W + 11, n)
        ys = rng.integers(-40, H + 11, n)
        xs[:4], ys[:4] = [-3, W - win + 3, -win - 2, 5], [H - win + 2, -2, 5, H + 4]
        xo[:n] = torch.tensor(xs, dtype=torch.int32, device=xi.device)
        yo[:n] = torch.tensor(ys, dtype=torch.int32, device=yi.device)
        return xo, yo

    def check_k1(g1, tag, with_library=True):
        err = 0.0
        for img, ox, oy, win in g1:
            a = k1.gather_windows(img, ox, oy, win)
            b = k1.gather_windows_plain(img, ox, oy, win)
            err = max(err, float((a - b).abs().max()))
            if with_library:
                lib = img.unfold(0, win, 1).unfold(1, win, 1)[oy.long(), ox.long()]
                err = max(err, float((a - lib).abs().max()))
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
    # K1 off the image: the zero-padded window at the requested origin.
    check_k1([(img, *off_image(ox, oy, *img.shape, win), win) for img, ox, oy, win in g1],
             "origins off the image", with_library=False)

    # -- 2b. batch kernels versus plain versions -----------------------------
    def batch_frame_inputs(bst, imgs, T7):
        """Each batch kernel's inputs on one frame of the batch path, from
        that path's own stages: (K6 request lists per sequence, K3 args per
        sequence, K2 args, K4 inputs, K8 args)."""
        cur_pyrs = pyramid.build_pyramid(imgs, L)
        H, W = imgs.shape[1:]
        g6, a3s = [], []
        for s, prep in enumerate(bst.ref_preps):
            cp = tuple(c[s] for c in cur_pyrs)
            T0 = SE3.from_params7(T7[s])
            g6.append(k3.mega_window_requests(cp, prep.p_ref, T0.R, T0.t, bst.cam, bt.DISTORTED,
                                              L)[2])
            fw = sparse_align.gather_frame_windows(cp, bst.cam, prep, T0, distorted=bt.DISTORTED)
            a3s.append(k3.mega_args(cp, prep.levels, prep.p_ref, T0.R, T0.t, bst.cam,
                                    bt.DISTORTED, L, prep.mega_refp, prep.mega_jl,
                                    pregathered=fw.mega_wins)[0])
        T = bt.batched_sparse_align(bst.ref_pyrs, cur_pyrs, bst.cam, bst.px, bst.depth,
                                    bst.mask, SE3.from_params7(T7), bst.ref_preps)
        proj = bt.project_landmarks(bst.cam, bst.pts_w, T)
        a2, xy0, xy0s, inb0 = bt.batched_align2d_inputs(cur_pyrs[0], proj)
        a4b = k4.a2d_args(cur_pyrs[0][0], bst.a2d_prep, xy0s,
                          pregathered=k4.A2DWindows(k1.gather_windows_multi(*a2), a2[2], a2[3]))
        xy, conv, _ = bt.batched_align2d(cur_pyrs[0], proj, bst.a2d_prep)
        a8 = k8.pose_ba_batch_args(*bt.batched_pose_ba_inputs(T, bst.pts_w, xy, conv, bst.mask,
                                                              bst.cam))
        return g6, a3s, a2, (a4b, xy0, inb0, H, W), a8

    def check_exact(name, out, ref, tag):
        err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(out, ref))
        print(f"{name} {tag}: max |kernel - plain| = {err} (tolerance 0, exact copy)")
        if err != 0.0:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    def check_k2(a2, tag):
        imgs, idx, ox, oy, win = a2
        H, W = imgs.shape[1:]
        e = check_exact("K2 gather_windows_multi", [k1.gather_windows_multi(*a2)],
                        [k1.gather_windows_multi_plain(*a2)], tag)
        off = (imgs, idx, *off_image(ox, oy, H, W, win), win)
        check_exact("K2 gather_windows_multi", [k1.gather_windows_multi(*off)],
                    [k1.gather_windows_multi_plain(*off)], tag + ", origins off the image")
        return e

    def check_k6(g6, a2, tag):
        e = check_exact("K6 gather_windows_grouped", k1.gather_windows_grouped(g6[0]),
                        k1.gather_windows_grouped_plain(g6[0]), tag)
        # Level 0 named twice (its 16^2 windows and the a2d 32^2 cache of
        # the same frame), every origin list partly off the image.
        img0 = g6[0][0][0]
        twice = [(img, *off_image(ox, oy, *img.shape, win), win) for img, ox, oy, win in g6[0]]
        twice.append((img0, *off_image(a2[2][:200], a2[3][:200], *img0.shape, k1.CACHE_WIN),
                      k1.CACHE_WIN))
        check_exact("K6 gather_windows_grouped", k1.gather_windows_grouped(twice),
                    k1.gather_windows_grouped_plain(twice),
                    tag + ", level 0 named twice, origins off the image")
        return e

    def check_k8(a8, tag):
        out, inl = k8.pose_ba_batch_gn(*a8)
        stats = {}
        ref, inl_ref = k8.pose_ba_batch_gn_plain(*a8, stats=stats)
        S = out.shape[0]
        d = max(float(se3.distance(SE3(*_pose_of(out[s])), SE3(*_pose_of(ref[s]))))
                for s in range(S))
        err = float((out[:, :12] - ref[:, :12]).abs().max())
        agree = float(((inl > 0.5) == (inl_ref > 0.5)).float().mean(dim=1).min())
        print(f"K8 pose_ba_fused_batch {tag}: max pose distance {d:.3e} (tolerance {TOL_POSE}), "
              f"max |R,t diff| {err:.3e}, inliers per sequence "
              f"{(inl > 0.5).sum(dim=1).tolist()} vs {(inl_ref > 0.5).sum(dim=1).tolist()}, "
              f"least set agreement {agree:.4f} (need {MIN_INLIER_AGREE}), "
              f"normal equations {stats['normal_eqs']}")
        if not (d <= TOL_POSE and agree >= MIN_INLIER_AGREE):
            raise AssertionError("K8 disagrees with its plain version")
        return err, stats

    t0 = time.perf_counter()
    wl_b = bm.make_batch_workload(S_BATCH, F_BATCH, dev)
    torch.cuda.synchronize()
    print(f"batch workload: {S_BATCH} sequences x {F_BATCH} frames 640x480, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cam_b, px_b, depth_b, mask_b, ptsw_b, patches_b, ref_pyrs_b, frames_b, T_gt7_b = wl_b
    bstate = bm.make_batch_state(cam_b, ref_pyrs_b, px_b, depth_b, mask_b, ptsw_b, patches_b)
    T7_1 = T_gt7_b[0][None].repeat(S_BATCH, 1)
    g6, a3s, a2, a4b, a8 = batch_frame_inputs(bstate, frames_b[1], T7_1)
    tag = f"S={S_BATCH}"
    e6 = check_k6(g6, a2, tag)
    for s, a in enumerate(a3s):
        check_k3(a, f"{tag} sequence {s}, K6's windows")
    e2 = check_k2(a2, tag)
    check_k4(a4b, f"{tag}, {S_BATCH * N} rows on K2's windows")
    e8, st8 = check_k8(a8, tag)

    Nb = S_BATCH * N
    k2_ms = _time_kernel(torch, lambda: k1.gather_windows_multi(*a2))
    k2_plain = _time_host(torch, lambda: k1.gather_windows_multi_plain(*a2))
    lib2 = (a2[0], a2[1].long(), a2[3].long(), a2[2].long(), a2[4])
    k2_lib = _time_kernel(torch, lambda: lib2[0].unfold(1, lib2[4], 1).unfold(2, lib2[4], 1)
                          [lib2[1], lib2[2], lib2[3]])
    report["K2"] = dict(ms=k2_ms, plain=k2_plain, lib=k2_lib, err=e2,
                        bound=_bound(Nb * (2 * 32 * 32 * 4 + 12), 0.0))
    k6_ms = _time_kernel(torch, lambda: k1.gather_windows_grouped(g6[0]))
    k6_plain = _time_host(torch, lambda: k1.gather_windows_grouped_plain(g6[0]))
    g6_lib = [(img, oy.long(), ox.long(), win) for img, ox, oy, win in g6[0]]
    k6_lib = sum(_time_kernel(torch, lambda g=g: g[0].unfold(0, g[3], 1).unfold(1, g[3], 1)
                              [g[1], g[2]]) for g in g6_lib)
    report["K6"] = dict(ms=k6_ms, plain=k6_plain, lib=k6_lib, err=e6,
                        bound=_bound(sum(N * (2 * g[3] * g[3] * 4 + 8) for g in g6[0]), 0.0))
    k8_ms = _time_kernel(torch, lambda: k8.pose_ba_batch_gn(*a8))
    k8_plain = _time_host(torch, lambda: k8.pose_ba_batch_gn_plain(*a8))
    k8_bytes = S_BATCH * (N * (12 + 8 + 4) + 48 + N * 4 + 52)
    k8_flops = sum(N * (180 * ne + 27 * 25 + 4 * 30) for ne in st8["normal_eqs"])
    report["K8"] = dict(ms=k8_ms, plain=k8_plain, lib=None, err=e8,
                        bound=_bound(k8_bytes, k8_flops))
    k4b_ms = _time_kernel(torch, lambda: k4.a2d_gn(*a4b[0]))
    k3b_ms = statistics.median(_time_kernel(torch, lambda a=a: k3.mega_gn(*a)) for a in a3s)
    for k in ("K2", "K6", "K8"):
        r = report[k]
        lib = "null" if r["lib"] is None else f"{r['lib']:.4f}"
        print(f"{k} ({tag}): kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, library {lib} "
              f"ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)
    print(f"K8 is bound by its chain of ~40 dependent block reductions per sequence, not by "
          f"bytes or operations; K4 over {Nb} rows {k4b_ms:.4f} ms; K3 on K6's windows "
          f"{k3b_ms:.4f} ms (median over the {S_BATCH} sequences)", flush=True)

    # The same kernels at 16 sequences.
    cam16, px16, depth16, mask16, ptsw16, patches16, ref_pyrs16, frames16, T_gt16 = \
        bm.make_batch_workload(S_BIG, 2, dev)
    bst16 = bm.make_batch_state(cam16, ref_pyrs16, px16, depth16, mask16, ptsw16, patches16)
    g6_16, _, a2_16, _, a8_16 = batch_frame_inputs(bst16, frames16[1],
                                                   T_gt16[0][None].repeat(S_BIG, 1))
    tag16 = f"S={S_BIG}"
    check_k6(g6_16, a2_16, tag16)
    check_k2(a2_16, tag16)
    check_k8(a8_16, tag16)
    print(f"S={S_BIG}: K2 {_time_kernel(torch, lambda: k1.gather_windows_multi(*a2_16)):.4f} ms "
          f"over {S_BIG * N} windows, K8 {_time_kernel(torch, lambda: k8.pose_ba_batch_gn(*a8_16)):.4f} "
          f"ms", flush=True)
    del frames16, bst16, g6_16, a2_16, a8_16

    # -- 2c. K10 versus its plain version ------------------------------------
    t0 = time.perf_counter()
    vstate, vframes, vT_gt7 = vw.make_vo_workload(N_VO, dev)
    torch.cuda.synchronize()
    vo_opts = vstate.opts
    m0 = vstate.mstate
    print(f"VO workload: {N_VO} frames 640x480, map K={vo_opts.map_K} F={vo_opts.map_F} "
          f"L={vo_opts.map_L}, {int(m0.pt_valid.sum())} landmarks bootstrapped on frame 0, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(10)

    def words(n):
        r = torch.randint(0, 2 ** 32, (n, 8), generator=gen, device=dev)
        return (r - 2 ** 31).to(torch.int32)

    Fn_vo = vo_opts.map_F - vo_opts.map_F // 2
    feat0 = m0.feat_desc[0].contiguous()
    all_feat = torch.where(m0.feat_valid.reshape(-1, 1), m0.feat_desc.reshape(-1, 8),
                           words(vo_opts.map_K * vo_opts.map_F)).contiguous()
    all_pt = torch.where(m0.pt_valid[:, None], m0.pt_desc, words(vo_opts.map_L)).contiguous()
    edge_a, edge_b = words(130), words(77)
    for t in (edge_a, edge_b):
        t[0], t[1], t[2] = -1, -2 ** 31, 0            # all ones, sign bits only, zero
    k10_cases = [
        (f"{Fn_vo} x {vo_opts.map_F} (triangulation, frame-0 descriptors)", feat0[:Fn_vo], feat0),
        (f"{vo_opts.map_F} x {vo_opts.map_L} (fusion, frame-0 map)", feat0, m0.pt_desc),
        (f"{all_feat.shape[0]} x {vo_opts.map_L} (all map features x all landmark rows)",
         all_feat, all_pt),
        ("130 x 77 (ragged)", words(130), words(77)),
        ("130 x 77 with all-ones, sign-bit-only and zero words", edge_a, edge_b),
    ]
    e10 = 0
    for tag, a, b in k10_cases:
        out, ref = k10.distance_matrix(a, b), k10.distance_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = int((out - ref).abs().max())
        print(f"K10 hamming distance_matrix {tag}: max |kernel - plain| = {err} (tolerance 0, "
              f"integers), distances {int(out.min())}..{int(out.max())}")
        if err != 0 or out.shape != (a.shape[0], b.shape[0]) or out.dtype != torch.int32:
            raise AssertionError("K10 disagrees with its plain version")
        e10 = max(e10, err)
    # Ties: argmin and match_nn on the card must choose as on the CPU.
    valid0 = m0.feat_valid[0]
    low = words(256) & 3                                # 16-bit-wide words: ties everywhere
    for tag, a, b, ma, mb in (
            ("frame-0 descriptors", feat0[:Fn_vo], feat0, valid0[:Fn_vo], valid0),
            ("low-entropy words", low[:128].contiguous(), low, None, None)):
        ma = torch.ones(a.shape[0], dtype=torch.bool, device=dev) if ma is None else ma
        mb = torch.ones(b.shape[0], dtype=torch.bool, device=dev) if mb is None else mb
        d = hamming.distance_matrix(a, b)
        on_card_ = hamming.match_nn(a, b, ma, mb) + hamming.best_two(d) + (torch.argmin(d, dim=0),)
        d_cpu = hamming.distance_matrix(a.cpu(), b.cpu())
        on_cpu = (hamming.match_nn(a.cpu(), b.cpu(), ma.cpu(), mb.cpu()) + hamming.best_two(d_cpu)
                  + (torch.argmin(d_cpu, dim=0),))
        same = all(torch.equal(x.cpu(), y) for x, y in zip(on_card_, on_cpu))
        print(f"match_nn / argmin ties, card versus CPU, {tag}: "
              f"{int(on_card_[1].sum())} matches, {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("match_nn or an argmin chooses differently on the card")
    # Time and bound per launch at the path's two shapes, and per keyframe:
    # two triangulation matrices and one fusion matrix.  The `kernels` line
    # carries the per-keyframe sums (as K1's row carries a frame's launches).
    def k10_bound(a, b):
        n, m = a.shape[0], b.shape[0]
        return _bound((n + m) * 32 + n * m * 4, n * m * 8 * 3)      # xor, popc, add per word

    # Library yardstick: torch.cdist(p=0) counts the differing entries of two
    # rows, the Hamming distance of descriptors unpacked to 256 float bits.
    # The unpacking is done beforehand and left out of its time.
    shifts = torch.arange(32, device=dev, dtype=torch.int32)

    def unpack_bits(w):
        return ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], 256).to(torch.float32)

    per_launch = []
    for tag, a, b in k10_cases[:3]:
        ms = _time_kernel(torch, lambda: k10.distance_matrix(a, b))
        plain = _time_host(torch, lambda: k10.distance_matrix_plain(a, b))
        ab, bb = unpack_bits(a), unpack_bits(b)
        lib_out = torch.cdist(ab, bb, p=0)
        if not torch.equal(lib_out.to(torch.int32), k10.distance_matrix(a, b)):
            raise AssertionError("torch.cdist(p=0) on the unpacked bits is not K10's distance")
        lib = _time_kernel(torch, lambda: torch.cdist(ab, bb, p=0))
        per_launch.append((ms, plain, k10_bound(a, b), lib))
        print(f"K10 one launch, {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms (torch.cdist p=0 on the bits unpacked beforehand, equal), bound "
              f"{per_launch[-1][2][0]:.6f} ms ({per_launch[-1][2][1]})", flush=True)
    tri, fus = per_launch[0], per_launch[1]
    report["K10"] = dict(ms=2 * tri[0] + fus[0], plain=2 * tri[1] + fus[1],
                         lib=2 * tri[3] + fus[3], err=e10,
                         bound=(2 * tri[2][0] + fus[2][0], fus[2][1]))
    r = report["K10"]
    print(f"K10 per keyframe (2 x {Fn_vo}x{vo_opts.map_F} + {vo_opts.map_F}x{vo_opts.map_L}, the "
          f"sums of the launches above): kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, "
          f"library {r['lib']:.4f} ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]})",
          flush=True)

    # -- 2d. the VO path's kernels on the inputs that path gives them ---------
    # Frame 10 through the entry point (`track`, then the keyframe cycle) with
    # every launch recorded: each kernel and its plain version then get the
    # arguments the step itself passed.  By then the NS selection is padded
    # with unused landmark rows whose depth in the previous camera is ~0
    # (masked rows holding huge Jacobians, which neither K3 nor its plain
    # version may read).
    st9 = vw.track_vo_frames(vstate, vframes[1:10])[0]
    with kernels.record_launches() as rec:
        vw.track_vo_frames(st9, vframes[10:11])
    ref_win = sparse_align.PATCH + 3                  # a 6x6 bilinear patch needs 7x7 pixels
    want_rec = (["gather_windows"] * 6 + ["mega_gn", "gather_windows_multi", "a2d_gn",
                                          "pose_ba_gn"] + ["distance_matrix"] * 3)
    if [fn.__name__ for fn, _ in rec] != want_rec:
        raise AssertionError(f"VO frame 10 launched {[fn.__name__ for fn, _ in rec]}, "
                             f"expected {want_rec}")

    def recorded(fn):
        return [args for f, args in rec if f is fn]

    g1v, (a3v,), (a2v,) = recorded(k1.gather_windows), recorded(k3.mega_gn), \
        recorded(k1.gather_windows_multi)
    (a4v,), (a5v,), d10v = recorded(k4.a2d_gn), recorded(k5.pose_ba_gn), \
        recorded(k10.distance_matrix)
    if [g[3] for g in g1v] != [ref_win] * L + [k3.CWIN] * L:
        raise AssertionError(f"VO frame 10: K1 windows {[g[3] for g in g1v]}")
    n_sel = g1v[0][1].shape[0]
    tagv = (f"VO frame 10, N={n_sel} ({int((a3v[4][0] < 0.5).sum())} masked, max |J| "
            f"{float(a3v[2].abs().max()):.1e})")
    check_k1(g1v, tagv + f", {L} levels x {ref_win}^2 on the previous frame and {L} x "
             f"{k3.CWIN}^2 on this one")
    check_k3(a3v, tagv)
    tagv = f"VO frame 10, N={a2v[1].shape[0]} ({int(a5v[2].sum())} matched)"
    check_k2(a2v, tagv + f", {a2v[0].shape[0]}-level stack")
    # Substituted inits (PATCH + 2, PATCH + 2) are the out-of-bounds ones,
    # which `align2d` never accepts; every other init is the path's center.
    xy0v = a4v[7]
    check_k4((a4v, xy0v, (xy0v != k1.PATCH + 2.0).any(dim=1), *vframes.shape[1:]), tagv)
    check_k5(a5v, tagv)
    for a, b in d10v:
        check_exact("K10 hamming distance_matrix", [k10.distance_matrix(a, b)],
                    [k10.distance_matrix_plain(a, b)],
                    f"VO frame 10 keyframe cycle, {a.shape[0]} x {b.shape[0]}")
    k1v_ms = sum(_time_kernel(torch, lambda g=g: k1.gather_windows(*g)) for g in g1v)
    k1v_plain = sum(_time_host(torch, lambda g=g: k1.gather_windows_plain(*g)) for g in g1v)
    k1v_bound = _bound(sum(n_sel * (2 * g[3] * g[3] * 4 + 8) for g in g1v), 0.0)
    print(f"VO frame 10: K1 per frame (sum over its 6 launches: {L} x {ref_win}^2, {L} x "
          f"{k3.CWIN}^2, {n_sel} windows each) kernel {k1v_ms:.4f} ms, plain {k1v_plain:.4f} ms, "
          f"bound {k1v_bound[0]:.6f} ms ({k1v_bound[1]}); K3 "
          f"{_time_kernel(torch, lambda: k3.mega_gn(*a3v)):.4f} ms, K2 "
          f"{_time_kernel(torch, lambda: k1.gather_windows_multi(*a2v)):.4f} ms, K4 "
          f"{_time_kernel(torch, lambda: k4.a2d_gn(*a4v)):.4f} ms, K5 "
          f"{_time_kernel(torch, lambda: k5.pose_ba_gn(*a5v)):.4f} ms", flush=True)
    del st9, rec, g1v, a3v, a2v, a4v, a5v, d10v

    # -- 2e. K9 on the inputs main path 4 gives it under variants 1 and 2 -----
    # The monocular System from raw frames, initialised and tracked to frame
    # E2_FRAME under each per-level variant; that frame's `track` is recorded
    # and each K9 launch (one per level, coarse to fine) replayed against its
    # plain version.  Two edge cases from level 0's recorded arguments: no
    # usable point (H0 = 0: b = 0, so neither variant may move the pose) and
    # the init pose shifted sideways so that windows clamp at the border.
    t0 = time.perf_counter()
    cam_m, frames_m, T_gt_m = mw.make_mono_workload(mw.N_FRAMES, dev)
    torch.cuda.synchronize()
    print(f"mono workload: {mw.N_FRAMES} frames {mw.W}x{mw.H}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def check_k9(args, lfac, tag):
        """K9 v1 (lfac None) or v2 against its plain version; returns
        (max |R,t diff|, plain passes, kernel output)."""
        stats = {}
        if lfac is None:
            out, ref = k9.level_gn(*args), k9.level_gn_plain(*args, stats=stats)
            name = "K9 level_align_fused (v1)"
            h_err = float((out[13:] - ref[13:]).abs().max() / ref[13:].abs().max().clamp(min=1e-30))
        else:
            v2 = args[:8] + (lfac,) + args[8:]
            out, ref = k9.level_gn_v2(*v2), k9.level_gn_v2_plain(*v2, stats=stats)
            name = "K9 level_align_fused_v2"
            h_err = 0.0
        d = float(se3.distance(SE3(*_pose_of(out)), SE3(*_pose_of(ref))))
        err = float((out[:12] - ref[:12]).abs().max())
        c_err = abs(float(out[12]) - float(ref[12])) / max(abs(float(ref[12])), 1e-6)
        print(f"{name} {tag}: pose distance {d:.3e} (tolerance {TOL_POSE}), max |R,t diff| "
              f"{err:.3e}, chi2 {float(out[12]):.4f} vs {float(ref[12]):.4f} (relative "
              f"{c_err:.1e}, tolerance {TOL_REL}), H relative {h_err:.1e}, passes "
              f"{stats['passes']}")
        if not (d <= TOL_POSE and c_err <= TOL_REL and h_err <= TOL_REL):
            raise AssertionError(f"{name} disagrees with its plain version")
        return err, stats["passes"], out

    def k9_bound(args, passes, v1):
        """Bytes: windows, patches, Jacobians, points, masks, origins, pose
        read once, the output written once; operations: per point and
        residual pass the projection (~40) and 16 pixels of bilinear sample,
        residual, gradient and chi2 (~22), plus v1's 21 Hessian products."""
        n = args[0].shape[0]
        nbytes = n * (16 * 16 + 16 + 96 + 3 + 1 + 2) * 4 + 12 * 4 + (34 if v1 else 13) * 4
        per_pass = 40 + 16 * (22 + (42 if v1 else 0))
        return _bound(nbytes, n * per_pass * passes)

    e2_report = {}
    for variant, fn in ((1, k9.level_gn), (2, k9.level_gn_v2)):
        sparse_align.FUSED_VARIANT = variant
        sysm = System(cam_m, options=mw.mono_options(), device=dev)
        for k in range(E2_FRAME):
            sysm.track_monocular(frames_m[k], float(k))
        if sysm.status is not vo_mod.Status.GOOD:
            raise AssertionError(f"variant {variant}: not GOOD by frame {E2_FRAME}")
        with kernels.record_launches() as rec:
            sysm.track_monocular(frames_m[E2_FRAME], float(E2_FRAME))
        names = [f.__name__ for f, _ in rec]
        want_rec = (["gather_windows"] * 3 + ["gather_windows", fn.__name__] * L
                    + ["gather_windows_multi", "a2d_gn", "pose_ba_gn"])
        if names != want_rec:
            raise AssertionError(f"variant {variant}, frame {E2_FRAME} launched {names}, "
                                 f"expected {want_rec}")
        k9_calls = [a for f, a in rec if f is fn]
        level_imgs = [a[0] for f, a in rec[3:3 + 2 * L:2]]
        if [a[-1] for a in k9_calls] != list(range(L - 1, -1, -1)):
            raise AssertionError(f"K9 levels {[a[-1] for a in k9_calls]}")
        errs, times, plains, bounds, passes = [], [], [], [], []
        for a in k9_calls:
            lfac = a[8] if variant == 2 else None
            args = a if variant == 1 else a[:8] + a[9:]
            tag = (f"variant {variant}, frame {E2_FRAME}, level {args[12]}, N={args[0].shape[0]} "
                   f"({int((args[4] < 0.5).sum())} invisible)")
            e, p, _ = check_k9(args, lfac, tag)
            errs.append(e)
            passes.append(p)
            times.append(_time_kernel(torch, lambda a=a: fn(*a)))
            plains.append(_time_host(torch, lambda a=a: (k9.level_gn_plain(*a) if variant == 1
                                                         else k9.level_gn_v2_plain(*a))))
            bounds.append(k9_bound(args, p, variant == 1))
        # Edge cases on level 0's arguments.
        a0 = k9_calls[-1] if variant == 1 else k9_calls[-1][:8] + k9_calls[-1][9:]
        zero_vis = a0[:4] + (torch.zeros_like(a0[4]),) + a0[5:]
        lfac0 = k9.frozen_factor(torch.zeros((6, 6), device=dev)) if variant == 2 else None
        _, _, out = check_k9(zero_vis, lfac0, f"variant {variant}, level 0, no usable point")
        if not (torch.equal(out[:12], a0[7]) and float(out[12]) == 0.0):
            raise AssertionError("K9 moved the pose on a level with no usable point")
        lr0 = sparse_align.LevelRef(vis=a0[4] > 0.5, ref_patch=a0[1], J=a0[2])
        R0, t0_ = a0[7][:9].reshape(3, 3), a0[7][9:]
        side = torch.tensor([0.2, 0.15, 0.0], device=dev)
        bargs, pc0, px0 = k9.level_args(level_imgs[-1], lr0, a0[3], R0, t0_ + side, a0[8], 0,
                                        a0[9])
        Hl, Wl = level_imgs[-1].shape
        clamped = ((bargs[5] == 0) | (bargs[5] == Wl - k9.CWIN) | (bargs[6] == 0)
                   | (bargs[6] == Hl - k9.CWIN)) & lr0.vis
        if int(clamped.sum()) == 0:
            raise AssertionError("the shifted pose clamps no window")
        lfacb = (k9.frozen_factor(k3.frozen_h0(lr0.J, lr0.vis, pc0, px0, Hl, Wl))
                 if variant == 2 else None)
        check_k9(bargs, lfacb, f"variant {variant}, level 0, init pose shifted by "
                 f"{side.tolist()}: {int(clamped.sum())} visible points' windows clamped")
        key = "K9v1" if variant == 1 else "K9v2"
        b_ms = sum(b[0] for b in bounds)
        report[key] = dict(ms=sum(times), plain=sum(plains), lib=None, err=max(errs),
                           bound=(b_ms, bounds[-1][1]))
        e2_report[key] = dict(times=times, plains=plains, bounds=bounds, passes=passes)
        print(f"{key} per launch (levels 2, 1, 0): kernel "
              f"{[round(t, 4) for t in times]} ms, plain {[round(t, 3) for t in plains]} ms, "
              f"bound {[f'{b[0]:.6f} ({b[1]})' for b in bounds]} ms, passes {passes}; per "
              f"frame (3 launches) kernel {sum(times):.4f} ms, plain {sum(plains):.3f} ms, "
              f"bound {b_ms:.6f} ms; library null (PyTorch has no single call for it)",
              flush=True)
        del sysm, rec, k9_calls
    sparse_align.FUSED_VARIANT = 3

    # -- 3. main path 1: single-sequence tracking ----------------------------
    counters = (k1.gather_windows, k1.gather_windows_grouped, k1.gather_windows_multi,
                k3.mega_gn, k4.a2d_gn, k5.pose_ba_gn, k8.pose_ba_batch_gn, k10.distance_matrix)

    def reset():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()

    T0 = SE3.identity(device=dev).params7()
    reset()
    t0 = time.perf_counter()
    T7, inl = tr.track_frames(state, frames, T0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches1 = {c.__name__: c.launches for c in counters}
    max_err, min_inl, ok = tr.gate(T7, inl, T_gt7)
    print(f"main path 1 (track_frames): {N_FRAMES} frames in {wall:.3f} s = "
          f"{N_FRAMES / wall:.1f} frames/s; gate max pose error {max_err:.3e} (< 2e-2), "
          f"min inliers {min_inl} (> 150): {'pass' if ok else 'FAIL'}; launches {launches1}",
          flush=True)
    if not ok:
        raise AssertionError("main path 1 failed the per-frame accuracy gate")
    want1 = {"gather_windows": 4 * N_FRAMES, "gather_windows_grouped": 0,
             "gather_windows_multi": 0, "mega_gn": N_FRAMES, "a2d_gn": N_FRAMES,
             "pose_ba_gn": N_FRAMES, "pose_ba_batch_gn": 0, "distance_matrix": 0}
    if launches1 != want1:
        raise AssertionError(f"launch counts {launches1}, expected {want1}")
    reps = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.track_frames(state, frames, T0)
        torch.cuda.synchronize()
        reps.append(N_FRAMES / (time.perf_counter() - t0))
    print(f"main path 1 repeats: {[round(r, 1) for r in reps]} frames/s", flush=True)

    # -- 4. main path 2: multi-sequence batch tracking -----------------------
    T0b = SE3.identity((S_BATCH,), device=dev).params7()
    reset()
    t0 = time.perf_counter()
    T7b, inl_b = bm.track_batch_frames(bstate, frames_b, T0b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches2 = {c.__name__: c.launches for c in counters}
    max_err, min_inl, ok = bm.batch_gate(T7b, inl_b, T_gt7_b)
    n_agg = S_BATCH * F_BATCH
    print(f"main path 2 (track_batch_frames): {S_BATCH} sequences x {F_BATCH} frames in "
          f"{wall:.3f} s = {n_agg / wall:.1f} aggregate frames/s; gate max pose error "
          f"{max_err:.3e} (< 2e-2), min inliers {min_inl} (> 150): {'pass' if ok else 'FAIL'}; "
          f"launches {launches2}", flush=True)
    if not ok:
        raise AssertionError("main path 2 failed the per-frame accuracy gate")
    want2 = {"gather_windows": 0, "gather_windows_grouped": S_BATCH * F_BATCH,
             "gather_windows_multi": F_BATCH, "mega_gn": S_BATCH * F_BATCH,
             "a2d_gn": F_BATCH, "pose_ba_gn": 0, "pose_ba_batch_gn": F_BATCH,
             "distance_matrix": 0}
    if launches2 != want2:
        raise AssertionError(f"launch counts {launches2}, expected {want2}")
    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm.track_batch_frames(bstate, frames_b, T0b)
        torch.cuda.synchronize()
        reps.append(n_agg / (time.perf_counter() - t0))
    print(f"main path 2: aggregate {statistics.median(reps):.1f} frames/s (median of 3 runs: "
          f"{[round(r, 1) for r in reps]}), {1e3 * S_BATCH / statistics.median(reps):.3f} ms "
          f"per batched frame", flush=True)

    # Time split of the batched step over 10 frames, each stage ended by a
    # synchronize, so a stage's host time and the device time it waits
    # for are both inside it.
    split = dict(pyramid=0.0, sparse_align=0.0, align2d=0.0, pose_ba=0.0)
    T7s = T0b
    n_split = min(10, F_BATCH)
    for imgs in frames_b[:n_split]:
        t = [time.perf_counter()]
        cur_pyrs = pyramid.build_pyramid(imgs, L)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        T = bt.batched_sparse_align(bstate.ref_pyrs, cur_pyrs, cam_b, bstate.px, bstate.depth,
                                    bstate.mask, SE3.from_params7(T7s), bstate.ref_preps)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        xy, conv, _ = bt.batched_align2d(cur_pyrs[0], bt.project_landmarks(cam_b, bstate.pts_w, T),
                                         bstate.a2d_prep)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        T_out, _, _ = k8.pose_only_ba_fused_batch(*bt.batched_pose_ba_inputs(
            T, bstate.pts_w, xy, conv, bstate.mask, cam_b))
        T7s = T_out.params7()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, b in zip(split, t[:-1], t[1:]):
            split[k] += (b - a) * 1e3 / n_split
    print(f"main path 2 time split, ms per batched frame (stages synchronised): "
          f"{ {k: round(v, 3) for k, v in split.items()} }, sum {sum(split.values()):.3f}",
          flush=True)

    # -- 5. main path 3: the VO's map tracking and keyframe cycle -------------
    n_f = N_VO - 1
    reset()
    t0 = time.perf_counter()
    vend, T7v, inl_v, kf_log = vw.track_vo_frames(vstate, vframes[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches3 = {c.__name__: c.launches for c in counters}
    max_err, min_inl, ok = vw.vo_gate(T7v, inl_v, vT_gt7[1:], vo_opts)
    n_kf = len(kf_log)
    print(f"main path 3 (track_vo_frames): {n_f} frames, {n_kf} keyframes "
          f"({sum(c['evicted'] for c in kf_log)} into evicted slots) in {wall:.3f} s = "
          f"{n_f / wall:.1f} frames/s; gate max pose error {max_err:.3e} (< 2e-2), min inliers "
          f"{min_inl} (>= {vo_opts.min_track_inliers}): {'pass' if ok else 'FAIL'}; "
          f"launches {launches3}", flush=True)
    print(f"main path 3 keyframes (frame: slot, triangulated + fused): "
          + ", ".join(f"{c['frame']}: {c['slot']}{'e' if c['evicted'] else ''}, "
                      f"{c['triangulated']}+{c['fused']}" for c in kf_log)
          + f"; valid landmarks at the end {int(vend.mstate.pt_valid.sum())}", flush=True)
    if not ok:
        raise AssertionError("main path 3 failed the per-frame gate")
    if n_kf != n_f // vo_opts.kf_min_frames or not any(c["evicted"] for c in kf_log):
        raise AssertionError(f"main path 3 inserted {n_kf} keyframes, none into an evicted slot?")
    want3 = {"gather_windows": 6 * n_f, "gather_windows_grouped": 0,
             "gather_windows_multi": n_f, "mega_gn": n_f, "a2d_gn": n_f, "pose_ba_gn": n_f,
             "pose_ba_batch_gn": 0, "distance_matrix": 3 * n_kf}
    if launches3 != want3:
        raise AssertionError(f"launch counts {launches3}, expected {want3}")
    # Synchronised times of the two steps over 60 frames (6 keyframes), twice
    # from the same state: first each step as a whole, then `track` with a
    # synchronisation at the end of each of its stages (`on_stage`), so the
    # stage times are read off the step itself.  Detection is the keyframe
    # cycle's first stage, timed alone without the tracked features' exclusion.
    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    t_track, t_kf, t_detect, t_stage = [], [], [], []
    for staged in (False, True):
        st_v = vstate
        for img in vframes[1:61]:
            marks = [("start", now())]
            st_v, pyr_v, tm_v = vw.track_vo_frame(
                st_v, img, on_stage=(lambda name: marks.append((name, now()))) if staged else None)
            marks.append(("rest", now()))
            if staged:
                t_stage.append({n: (t1 - t0) * 1e3
                                for (_, t0), (n, t1) in zip(marks[:-1], marks[1:])})
            else:
                t_track.append((marks[-1][1] - marks[0][1]) * 1e3)
            if st_v.frame_id % vo_opts.kf_min_frames == 0:
                t0 = now()
                if not staged:
                    fe.detect_multilevel(pyr_v, vo_opts.detect_threshold, vo_opts.grid_cell,
                                         vo_opts.feat_budgets)
                    t_detect.append((now() - t0) * 1e3)
                t0 = now()
                st_v, _ = vw.insert_vo_keyframe(st_v, pyr_v, tm_v)
                if not staged:
                    t_kf.append((now() - t0) * 1e3)
    split3 = {k: round(statistics.median(r[k] for r in t_stage), 3) for k in t_stage[0]}
    if list(split3) != ["pyramid", "sparse_align", "visible_patches", "local_map", "rest"]:
        raise AssertionError(f"track reported the stages {list(split3)}")
    print(f"main path 3 step times (synchronised, medians over {len(t_track)} frames and "
          f"{len(t_kf)} keyframes): track {statistics.median(t_track):.3f} ms, keyframe cycle "
          f"{statistics.median(t_kf):.3f} ms (detection alone "
          f"{statistics.median(t_detect):.3f} ms); track's stages, each ended by a "
          f"synchronisation inside the step, {split3}, sum {sum(split3.values()):.3f}", flush=True)

    # -- 5b. main path 4: the monocular System from raw frames ----------------
    # Under each FUSED_VARIANT: one run for the gate, the launch counts and
    # frames/s, then a second from a fresh System with the init step,
    # `track`, the keyframe cycle and the mapping pass each wrapped in
    # synchronisations (the VO looks these up by name when it calls them).
    counters4 = counters + (k9.level_gn, k9.level_gn_v2)
    launches4 = {}

    def timed_run(variant):
        times = {"init": [], "track": [], "kf_cycle": [], "mapping_pass": []}

        def wrap(name, fn):
            def timed(*a, **kw):
                t0 = now()
                out = fn(*a, **kw)
                times[name].append((now() - t0) * 1e3)
                return out
            return timed

        sysm = System(cam_m, options=mw.mono_options(), device=dev)
        sysm.vo._try_init = wrap("init", sysm.vo._try_init)
        saved = {n: getattr(vo_mod, n) for n in ("track", "kf_cycle", "mapping_pass")}
        try:
            for n, fn in saved.items():
                setattr(vo_mod, n, wrap(n, fn))
            mw.run_mono(sysm, frames_m)
        finally:
            for n, fn in saved.items():
                setattr(vo_mod, n, fn)
        return times

    for variant in (3, 2, 1):
        sparse_align.FUSED_VARIANT = variant
        sysm = System(cam_m, options=mw.mono_options(), device=dev)
        for c in counters4:
            c.launches = 0
        st_m, T7_m, wall = mw.run_mono(sysm, frames_m)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters4}
        launches4[variant] = got
        k0, ate, ok = mw.mono_gate(st_m, T7_m, T_gt_m)
        vo_m = sysm.vo
        n_track = len(st_m) - k0 - 1                   # frames through `track`
        n_kf = vo_m.stats["keyframes"]
        print(f"main path 4 (System.track_monocular), FUSED_VARIANT {variant}: {len(st_m)} "
              f"frames in {wall:.3f} s = {len(st_m) / wall:.1f} frames/s; init at frame {k0} "
              f"(model {'H' if vo_m.init_used_h else 'F'}), {n_track} tracked frames, "
              f"{n_kf} keyframes, {vo_m.stats['evictions']} evictions, "
              f"{vo_m.stats['keyframes_culled']} culled keyframes, "
              f"{sum(s is vo_mod.Status.LOST for s in st_m)} LOST frames, final valid landmarks "
              f"{int(vo_m.server.state.pt_valid.sum())}; ATE {ate!r} m (bound "
              f"{mw.ATE_FLOOR}): gate {'pass' if ok else 'FAIL'}; launches {got}", flush=True)
        if not ok:
            raise AssertionError(f"main path 4, variant {variant}, failed mono_gate")
        if n_kf < 12 or vo_m.stats["keyframes_culled"] == 0:
            raise AssertionError(f"main path 4 inserted {n_kf} keyframes, culled "
                                 f"{vo_m.stats['keyframes_culled']}")
        want4 = {"gather_windows": 6 * n_track, "gather_windows_grouped": 0,
                 "gather_windows_multi": n_track, "mega_gn": n_track if variant == 3 else 0,
                 "a2d_gn": n_track, "pose_ba_gn": n_track, "pose_ba_batch_gn": 0,
                 "distance_matrix": 3 * n_kf,
                 "level_gn": 3 * n_track if variant == 1 else 0,
                 "level_gn_v2": 3 * n_track if variant == 2 else 0}
        if got != want4:
            raise AssertionError(f"launch counts {got}, expected {want4}")
        times = timed_run(variant)
        med = {k: statistics.median(v) for k, v in times.items() if k != "init"}
        klt_only = statistics.median(times["init"][:-1] or [float("nan")])
        print(f"main path 4, FUSED_VARIANT {variant}, synchronised ms: init step (KLT, "
              f"RANSAC H/F, two-view BA, first local BA) {times['init'][-1]:.3f} (the "
              f"{len(times['init']) - 1} KLT-only init frames before it, median "
              f"{klt_only:.3f}); medians of `track` "
              f"{med['track']:.3f} over {len(times['track'])} frames, keyframe cycle "
              f"{med['kf_cycle']:.3f} and mapping pass {med['mapping_pass']:.3f} over "
              f"{len(times['kf_cycle'])} keyframes", flush=True)
        del sysm
    sparse_align.FUSED_VARIANT = 3

    # -- 6. profile windows ----------------------------------------------------
    _profile(torch, lambda: tr.track_frames(state, frames[:30], T0), 30, "main path 1")
    _profile(torch, lambda: bm.track_batch_frames(bstate, frames_b[:10], T0b), 10,
             f"main path 2 (per batched frame of {S_BATCH} sequences)")
    _profile(torch, lambda: vw.track_vo_frames(vstate, vframes[1:31]), 30,
             "main path 3 (30 frames with 3 keyframe cycles)")
    # Path 4 under variant 2, past init, over a window with keyframes in it.
    sparse_align.FUSED_VARIANT = 2
    sysm = System(cam_m, options=mw.mono_options(), device=dev)
    for k in range(P4_PROFILE[0]):
        sysm.track_monocular(frames_m[k], float(k))
    n_kf0 = sysm.vo.stats["keyframes"]
    _profile(torch, lambda: [sysm.track_monocular(frames_m[k], float(k))
                             for k in range(*P4_PROFILE)],
             P4_PROFILE[1] - P4_PROFILE[0], f"main path 4, FUSED_VARIANT 2 (frames "
             f"{P4_PROFILE[0]}-{P4_PROFILE[1] - 1})")
    n_kf_win = sysm.vo.stats["keyframes"] - n_kf0
    print(f"main path 4 profile window: {n_kf_win} keyframes in it")
    if n_kf_win < 1:
        raise AssertionError("main path 4's profile window holds no keyframe")
    sparse_align.FUSED_VARIANT = 3
    del sysm

    # -- 7. result lines ------------------------------------------------------
    def launches(name):
        return (launches1.get(name, 0) + launches2.get(name, 0) + launches3.get(name, 0)
                + sum(v[name] for v in launches4.values()))

    gw = "ygz_slam_tpu_torch/csrc/gather_windows.cu"
    pk = "ygz_slam_tpu/ops/pallas/"
    meta = {
        "K1": ("gather_windows", gw, pk + "align2d_kernel.py:77", launches("gather_windows")),
        "K2": ("gather_windows_multi", gw, pk + "align2d_kernel.py:298",
               launches("gather_windows_multi")),
        "K3": ("sparse_align_mega", "ygz_slam_tpu_torch/csrc/sparse_align_mega.cu",
               pk + "sparse_align_mega.py:338", launches("mega_gn")),
        "K4": ("align2d_fused", "ygz_slam_tpu_torch/csrc/align2d_fused.cu",
               pk + "align2d_fused.py:317", launches("a2d_gn")),
        "K5": ("pose_ba_fused", "ygz_slam_tpu_torch/csrc/pose_ba_fused.cu",
               pk + "pose_ba_fused.py:326", launches("pose_ba_gn")),
        "K6": ("gather_windows_grouped", gw, pk + "align2d_kernel.py:219",
               launches("gather_windows_grouped")),
        "K8": ("pose_ba_fused_batch", "ygz_slam_tpu_torch/csrc/pose_ba_fused_batch.cu",
               pk + "pose_ba_fused_batch.py:194", launches("pose_ba_batch_gn")),
        "K10": ("hamming_distance_matrix", "ygz_slam_tpu_torch/csrc/hamming.cu",
                pk + "hamming_kernel.py:48", launches("distance_matrix")),
        "K9v1": ("level_align_fused", "ygz_slam_tpu_torch/csrc/sparse_align_fused.cu",
                 pk + "sparse_align_fused.py:519", launches("level_gn")),
        "K9v2": ("level_align_fused_v2", "ygz_slam_tpu_torch/csrc/sparse_align_fused.cu",
                 pk + "sparse_align_fused.py:597", launches("level_gn_v2")),
    }
    kernels = []
    for k, (name, src, replaces, n_launch) in meta.items():
        r = report[k]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n_launch, "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": r["lib"]})
    print(f"total {time.perf_counter() - t_start:.1f} s after the header")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
