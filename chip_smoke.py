#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ygz_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on failure:

1. Header: the card's name and power limit, torch and CUDA versions, the
   nvcc build of every kernel in ygz_slam_tpu_torch/csrc, and ptxas's
   registers, stack, spills and static shared memory of the chained
   kernels (K3, K5, K8, K9 v1/v2, K11), K2, K4, K6 and K10; a spill in K3,
   K4, K5, K9 v1, K9 v2 or K11 fails the run at the end.
2. Kernel versus plain version, at the stated tolerances, and for K3, K5,
   K8, K9 and K11 a second launch on the same inputs giving the same
   bits.  Kernel times are medians of per-launch CUDA-event intervals with
   the host's enqueue hidden behind a sleep kernel; K3's and K5's chains
   (dependent passes or reductions per launch, from the plain versions'
   iteration counts) and µs per link beside them.
   a. The single-sequence tracking step's kernels (K1 gather_windows, K3
      sparse_align_mega, K4 align2d_fused, K5 pose_ba_fused) on the inputs
      that path gives them on frame 1 of its workload (K1's recorded from
      the step: the pyramid's three levels in one launch, then K4's
      windows); K3-K5 again at 512 landmarks; K1 with origins off the
      image, per image and for the pyramid.
   b. The batch path's kernels (K6 gather_windows_stacked and
      gather_windows_grouped, the batched K3 on K6's windows, K2
      gather_windows_multi, K4 over all S*N rows, K8 pose_ba_fused_batch)
      on that path's frame-1 inputs at S=8 (K6's and K3's recorded from
      `batched_sparse_align`: every sequence's levels in one stacked K6
      launch, held exactly to its plain version on the path's own
      arguments; every sequence's alignment in one K3 launch, held to the
      batched plain version, each sequence within TOL_POSE); K2, K6 and K8
      again at S=16 (K6: 48 requests in one launch); K2 and K6 (stacked
      and grouped) with origins off the image, K6 with a request
      list that names one image twice; K6 timed per batched frame beside
      the S launches of one sequence's levels that it replaced; K2's
      CUDA-event ms, profiler µs per launch, plain and library ms and
      bound at S=8 and S=16.
   c. K10 (Hamming distance matrix) against its plain version, exactly, at
      the keyframe cycle's two shapes (128 x 512: both triangulation
      neighbours stacked, and 256 x 3072, on frame-0 descriptors of the VO
      workload), at 128 x 256 (one neighbour), at 2560 x 3072, at a ragged
      130 x 77 and with all-ones and sign-bit-only words; `match_nn` and
      the tie-breaking argmins on the card against the CPU, exactly.
   d. K1, K3, K2, K4 and K5 against their plain versions on the inputs
      that frame 10 of the VO path gives them (K1's two pyramid launches,
      N=256 with masked rows for K3, 512 rows for K2, K4 and K5: K2 reads
      the three levels in place, as a table of images), recorded from the
      step itself; K2 on that table against K2 on the levels' zero-padded
      stack (the formulation it replaced, built here as a check), and both
      ways on a 61x83 frame whose level 2 (16x21) is smaller than the
      window, with the VO's own origins there; K2's times at the VO's
      shape; the iterations K4's points run up to the one that freezes
      them (the plain version's count: the largest, the mean and the
      histogram) on path 1's, the VO's and the batch's arguments.
   e. K9 v1 (level_align_fused) and v2 (level_align_fused_v2, which
      builds and factors H0 itself) against their plain versions (pose,
      chi2 and H: v2's H0) on the three per-level launches that frame 12
      of main path 4 makes under FUSED_VARIANT 1 and 2 (recorded from
      `System.track_monocular`), on level 0 with no usable point (the
      pose must not move) and with an init pose shifted so that windows
      clamp at the border; per-launch times, bounds and plain times; K9
      v1's cluster and the split of its passes (pixel steps, block
      reduction, cluster exchange, solve and retraction; CTA 0's SM clock
      marks) per level, and K9 v2's cluster per level.
   f. K11 (track_step_fused, the whole step in one kernel) against its
      plain version on the arguments that frame 1 of main path 5 gives it
      (recorded from `fused_track_step`), at 512 landmarks, with ten
      landmarks masked (none may converge or be an inlier) and with no
      usable sparse point (stage 1 must leave the init pose bit for bit);
      its BA chi2 against the plain chain's on frames 1-16 at 200 and 512
      landmarks beside two float16 controls (TOL_BA_CHAIN must separate
      them); its partition over the cluster (CTAs, points per CTA, shared
      bytes) and, at both sizes, its stage 1 against K3 on the same
      arguments and its stage 3 against K5 on its own stage-2 output, bit
      for bit; a split by stage (CTA 0's SM clock at each stage's end,
      converted at the global timer's rate over the kernel) beside K3 and
      K5 alone; per-launch times, bound and plain time beside the summed
      times of the kernels it replaces on path 1's frame 1 (K1 x 2, K3,
      K4, K5).
      Then `entry()`, the step's own entry point, once on the card against
      the CPU.
   K10 is also timed against `torch.cdist(p=0)` on descriptors unpacked to
   256 float bits beforehand (the unpacking left out of its time).
3. Main path 1: the 640x480 / 200-landmark tracking workload, rendered on
   the card, through `tracking.track_frames`, every frame held to the
   accuracy gate; the launch counters must show K3, K4 and K5 once per
   frame, K1 twice per frame (the pyramid's windows in one launch, K4's
   windows) and the batch kernels and K11 never.
4. Main path 2: bench_batch.py's workload, S=8 sequences x 60 frames,
   through `batch.track_batch_frames`, every sequence's every frame held
   to the gate; the counters must show K3 S times per frame, K6, K2, K4
   and K8 once per frame, K1 and K5 never.  Aggregate frames/s is the
   median of 3 further runs.
5. Main path 3: the VO's map-tracking step and keyframe cycle, 240 frames
   640x480 on a map of K=10 keyframes x F=256 features and L=3072 landmark
   rows bootstrapped on frame 0, through `vo_workload.track_vo_frames`: a
   keyframe every 10 frames, so slots are evicted from the 10th insertion
   on; every frame held to `vo_gate`.  The counters must show, per frame,
   K3, K2, K4 and K5 once and K1 twice (the three reference-patch levels
   in one launch, the three window levels in another: the reference is
   the previous frame, prepared anew each frame); per keyframe K10 twice
   (both triangulation neighbours in one launch, then the fusion with the
   map); K6 and K8 never.
5b. Main path 4: the monocular System from raw frames
   (`models/mono_workload.py`: 160 frames 640x480, 3 levels, map K=10 x
   F=256 x L=3072, NS=256, NSV=512) through `System.track_monocular`,
   under FUSED_VARIANT 3, 2 and 1, each run held to `mono_gate` (GOOD
   within 30 frames, no LOST frame after, Sim(3)-aligned ATE < 0.05 m)
   with at least 12 keyframes and keyframe culling at work.  Per frame
   through `track`: K2, K4, K5 once; K1 once for the three 7x7 reference
   levels, then once for the three 16x16 window levels under 3 or once
   per level (before each K9 launch) under 1 and 2; K3 once under 3, the
   variant's K9 entry three times under 1 or 2; K10
   twice per keyframe; K6 and K8 never.  Then, from a fresh System,
   synchronised times of the init step, `track`, the keyframe cycle and
   the mapping pass; that second run must equal the first bit for bit
   (statuses, trajectory, keyframe poses, landmarks).
5c. Main path 5: path 1's workload through `tracking.track_frames` with
   `step=fused_track_step` (the whole-step configuration), every frame
   held to the gate; the counters must show K11 once and K1 twice per
   frame (the three sparse levels, the align2d cache) and no other kernel.  Frames/s beside path 1's, the two run
   in turns (1, 5, 5, 1).
5d. Main path 6: the System on non-planar worlds
   (`models/nonplanar_workload.py`).  (a) tests/test_nonplanar.py's
   TwoPlaneScene run (40 frames 320x240) through `System.track_monocular`:
   init with F (init_model_f >= 1, init_model_h == 0), the last frame
   GOOD, more than half GOOD, Sim(3)-aligned ATE < 0.06 m.  (b) BoxScene at
   640x480 (bench_accuracy.py's world, camera f = 640, horizon 4000,
   vignette 0.25 with its gain and bias drift; its options with the
   vocabulary, depth filter, archive and async mapping off) on path 4's map
   (K=10, F=256, L=3072), N_BOX frames, gated over its first BOX_SPAN:
   GOOD on every frame after init, ATE < 0.10 m, the map grown past its
   init rows; the whole run is reported (past frame ~180 the loop enters a
   section where this configuration starves its map and loses track, in
   both packages: ROADMAP section 3).  (c) Evictions: the same frames'
   first EVICT_FRAMES on a map of EVICT_K slots under FUSED_VARIANT 2:
   evictions > 0, more than 90% GOOD, one segment, ATE < 0.10 m.  Each run
   holds path 4's launch counts per call of `track` and per keyframe.
5e. Main path 7: path 6b's frames through `System.track_monocular_chunk`
   (chunk=32), runs in turns per frame, chunked, chunked, per frame, each
   equal to the first bit for bit (statuses, trajectory, keyframe slots,
   stats, keyframe poses, landmarks), the chunks replaying a CUDA graph
   of the step.  Launches on the graph path are counted per replay: the
   wrappers a capture saw (`ops/kernels.capture_launches`), once each per
   replay (`kernels.replayed`); the chunked run must show the per-frame
   run's launches plus one step's kernels for every frame it computed and
   discarded at or after a cut.  It prints frames/s of the four runs, the
   wall ms per chunk frame in the chunk loop, and the frames computed and
   discarded.
5f. Main path 8: the System with the depth filter
   (`nonplanar_workload.box_df_options`: path 6b's options with
   `use_depth_filter=True`).  (a) N_DF BoxScene frames at 640x480 through
   `System.track_monocular`, gated over path 6b's span (its first BOX_SPAN
   frames): GOOD on every frame after init, Sim(3)-aligned ATE < DF_ATE,
   and more valid landmark rows at frame BOX_SPAN than path 6b; the whole
   run is reported (in both packages this configuration loses track in
   some runs past frame ~190 and drifts in others, ROADMAP section 3): the
   GOOD share, first LOST, resets, evictions, keyframes, seeds promoted per
   keyframe, valid landmark rows every DF_ROWS_EVERY frames, mean inliers
   and the ATE over the first 160-240 frames; it holds path 4's launch
   counts (the seed update launches no
   kernel of the port's own: it is plain PyTorch, as the JAX package's is
   jnp).  The seed update of frame SEED_FRAME, recorded, runs again on the
   CPU in float32 and float64: the seeds updated agree on >=
   MIN_SEED_AGREE of the rows, and mu and sigma2 on the card are within
   max(TOL_SEED, SEED_SPREAD x the CPU's distance from float64) of the
   CPU's.  (b) The same frames through `track_monocular_chunk(chunk=32)`,
   runs in turns per frame (8a), chunked, chunked, per frame, each equal to
   8a bit for bit, the seed table included; a graph with the seed update
   captured and replayed; frames/s of the four runs.
5g. Main path 9: relocalization (`models/reloc_workload.py`; the vocabulary
   on, the packaged 10^4-word asset, `reloc_top_c` 10 candidates, 256 P3P
   hypotheses each).  (a) Path 4's PlaneScene run with the vocabulary:
   `reloc_workload.N_PRE` frames, N_NOISE noise frames, then the view of
   the window's oldest keyframe and the N_AFTER frames after it, through
   `System.track_monocular`: every noise frame after the first LOST (the
   first may pass on the inlier hysteresis), the revisit frame GOOD through
   relocalization with no reset, its pose within TOL_REVISIT of the
   keyframe's, the N_AFTER frames GOOD, and the frames before the blackout
   equal to path 4's (variant 3) bit for bit; path 4's launch counts plus
   one K10 and one K8 per attempt.  Then ten more attempts: one K10 and one
   K8 launch each, their synchronised ms, one attempt's kernels and device
   µs under the profiler, and the ms of a keyframe's BoW row.  (b)
   tests/test_relocalization.py's kidnapped (upside-down) query against
   9a's map: with the P3P seed a success within TOL_KIDNAP; seeded at the
   stored pose a failure or an error over 10x that.  (c) One attempt on
   the card against the CPU (the map, features and the card's P3P draws
   copied): BoW scores within 1e-6, candidates and matches equal, inlier
   counts within the K8-against-plain agreement and the winner's equal,
   the pose within TOL_POSE; its recorded K10 [256, 2560] and K8 [S=10]
   arguments against their plain versions, with kernel ms, profiler µs,
   plain and library ms and bounds.  (d) Path 8a's frames and options with
   the vocabulary on: 8a's gates, equal to 8a bit for bit up to the first
   frame that attempts a relocalization (the whole run if none does); the
   attempts, relocalizations, resets and ATE over 160-240 frames reported.
   (e) Path 6b's frames and options (no depth filter; 6b loses track past
   frame ~180) with the vocabulary on: equal to 6b bit for bit up to the
   first attempt; attempts, relocalizations, resets and ATE reported
   beside 6b's.
5h. Main path 10: the keyframe archive and loop closing within the active
   window (`models/archive_workload.py`; the vocabulary on).  (a)
   tests/test_archive.py's kidnapped sweep at 640x480 (PlaneScene seed 3,
   a 3.4 m one-way sweep of 52 frames on a 6-slot window, the archive on,
   loop closing and the depth filter off), 4 noise frames, then the oldest
   archived keyframe's view and the 16 frames after it, through
   `VisualOdometry.add_frame`: the revisit relocalized through the archive
   with the keyframe reactivated, its pose within TOL_REVISIT of the
   archived one, every frame after GOOD, the archive's rows equal to the
   evictions plus culls less the reactivations, and the sweep equal bit
   for bit to the same run with the archive off; path 4's launch counts
   plus one K10 and one K8 per active-window attempt and two K10 and one
   K8 per archive attempt; each attempt's synchronised ms, and the archive
   attempt's kernels and device µs under the profiler.  (b) Archives of
   capacity 16, 128, 512 and 2048 filled with 10a's rows: K10 at the
   scoring shape [256, min(rows, 512) x 256] (ms, profiler µs, byte bound,
   torch.cdist on the unpacked bits), the retrieval scores and one whole
   `relocalize_archive` (synchronised ms); at 16 and 128 the match-count
   and retrieval scores on the card equal to the CPU's.  (c) Path 9d's
   BoxScene frames and options with `loop_closing` on (first 240 frames),
   twice (the same bits): equal to 9d bit for bit up to the first
   keyframe whose `detect_loop` finds a loop, path 4's launch counts plus
   one K10 and one K5 per mapping pass with the loop block; the pass's
   synchronised ms with and without the loop block, one recorded pass's
   kernels and device µs both ways, its K10 [256, 256] and K5 against
   their plain versions; tests/test_relocalization.py's planted 6-keyframe
   loop through `close_loop` on the card against the CPU (TOL_POSE, loop
   residual < 0.05).  (d) 10a's archive attempt on the card against the CPU
   (the archive, features and the card's P3P draws copied): retrieval
   scores, candidates, matches and winner equal, the pose within TOL_POSE;
   its K10 and K8 launches against their plain versions.
5i. Main path 11: the archive loops and async mapping (the JAX defaults:
   `VOOptions()` runs in the port).  (a) tests/test_archive.py's
   out-and-back sweep at its own 240x320 (`archive_workload.out_and_back_frames`,
   110 frames, PlaneScene seed 3; at 640x480 the return's correction sits at
   the significance gate's floor, closed or only confirmed as float32
   rounding falls) through `VisualOdometry.add_frame` with
   `loop_options()` (the defaults with ARC_OPTS, async mapping on): more
   keyframes archived than window slots, at least one global loop closed,
   the corrected trajectory's Sim(3)-aligned ATE < 0.10, and the sweep
   equal bit for bit to the same run with the archive off up to the first
   keyframe whose archive detection applies a correction; path 4's launch
   counts plus one K10 and one K5 per mapping pass with the loop block and,
   per archive loop detection, one K10 per 512 scored rows, one K10 for the
   candidates and one K8; each detection's and global closure's
   synchronised ms and the closures' (P, EP); one found detection's kernels
   and device µs under the profiler and its K10 (retrieval, candidates) and
   K8 (S=8) launches against their plain versions; one closure's kernels and
   device µs.  (b) tests/test_map_merge.py's reset and revisit at 640x480:
   `maps_merged` >= 1, epoch 0 after the merge, the last pose within 0.12
   map units and 0.1 rad of epoch 0's at the same view.  (c)
   `System(camera=cam)` with `VOOptions()` unchanged on path 8a's frames
   0-BOX_SPAN, per frame with async mapping, per frame without it and
   through `track_monocular_chunk`: 8a's gate, the three equal bit for bit;
   the median return latency of keyframe frames, of the frame after each
   and of every frame, with and without async mapping.  (d) Path 9e with
   the archive on: equal to 9e bit for bit up to the first archive
   relocalization; attempts, relocalizations, resets and ATE beside 9e's.
   (e) tests/test_sim3.py's drifted loop through `optimize_sim3` and
   `close_loop_global_sim3` on the card against the CPU (TOL_POSE); one
   global closure at P = 512 nodes (300 archived and 10 active keyframes):
   synchronised ms and device kernels.
5j. Main path 12: depth sensors and the map file (`VOOptions()`, path 4's
   camera, 640x480).  (a) `System(sensor=RGBD)`, its camera and options
   set through `Config.set_dict` and `apply_to`, on `SyntheticDataset`'s
   N_SENSOR frames with depth (the JAX dataset's defaults): >= 75% GOOD,
   rigid ATE < SENSOR_ATE (tests/test_system.py's gates); ms per frame,
   each sensor keyframe insertion's synchronised ms (the first under the
   profiler: device kernels and µs) beside path 4's keyframe cycle; path
   4's launch counts plus the loop block's and the archive detections'
   (a sensor keyframe launches K10 twice, as a monocular one does); the
   first DENSE_FRAMES frames with the DENSE map, every cloud on the plane
   within 0.05 m and the exported cloud written by `save_ply`; frame 0's start on the card against the CPU (features at
   the same pixel >= 95%, decisions >= MIN_MASK_AGREE, landmarks within
   TOL_POSE).  (b) The same trajectory as a rectified pair (baseline
   BASELINE) through `System(sensor=STEREO)`: >= 11/14 GOOD, rigid ATE <
   SENSOR_ATE (tests/test_stereo.py's gates); `match_stereo`'s synchronised
   ms, device kernels and µs per call, its first call on the card against
   the CPU (ok flags >= MIN_MASK_AGREE, depth within TOL_STEREO); frame 0's
   start as in (a).  (c) 12a's map and path 11a's (archive rows) written on
   the card (`save_map`), loaded on the card and on the CPU and written
   again, equal bit for bit; 12a's loaded state equal to the saved VO's;
   path 11a's map resumed by relocalization in a fresh System (the frame of
   its third keyframe and the next GOOD, the second with > 50 inliers,
   test_system.py::test_resume_from_saved_map's gates) with its K10 and K8
   launches counted; `save_map` / `load_map` ms and the files' bytes.
5k. Main path 13: the other frontends, `VOOptions()` with only the mode
   changed (`mono_workload.frontend_options`), on path 4's camera and
   frames (640x480, 160), at the map's full width (K=10, F=256, L=3072,
   sd_budget 512).  (a) SPARSE_ORB: per tracker call two K10 [3072, 256]
   and two K5 [3072] launches (four and four on a second-chance frame) and
   no K1-K4; its GOOD share at least the JAX package's CPU run of the same
   frames (ORB13_REF) and its ATE within ATE13_SLACK of it; tracker call
   P13_REC's launches recorded, each held to its plain version with times
   and bounds at these shapes, and its first `match_by_projection` run on
   the card and on the CPU: decisions equal on >= MIN13_MATCH_AGREE of the
   landmarks and equal observations where both match.  (b)
   SEMI_DENSE_DIRECT with the SEMI_DENSE map: per tracker call K1 twice, K3
   once at 768 points (map_F + sd_budget), K2, K4 and K5 once at 3072 rows;
   the exported cloud larger than the landmarks, the last keyframe's usable
   seeds' depth spread on the plane < SEED_SPREAD13, the GOOD share and ATE
   against SD13_REF as in (a); the recorded call's kernels as in (a).  Both
   run frames P13_PROFILE under the profiler (device kernels and µs per
   frame).  (c) tests/test_vo_types.py's second-chance spike (240x320, 13
   frames, 0.25 m at frame SPIKE_AT): the spike frame GOOD with >= 1 hit,
   its launches four K10 and four K5.  Each holds want_loops' counts plus
   its trackers'.
5l. Main path 14: scale-out on an NCCL process group (a world of one
   rank, the card; no gloo and no CPU fallback).  (a) `sharded_local_ba`
   at the map's full width: bench_scaling.py's problem (K=10, L=P14_L
   landmarks, 5 observations each, 0.3 px noise, two gauge-fixed poses,
   default_rng(0)), 10 iterations, on one rank holding 1, 2, 4 and 8
   shards: the gauge poses unmoved (< 1e-6), the mean pose error at most
   1.1x the port's single-device `local_ba` error + 1e-4, bench_scaling's
   pose error < 0.05, every shard count within TOL14_POSE / TOL14_POINT of
   one shard, and the 8-shard solve run again equal bit for bit; per
   iteration the synchronised ms (`utils/profiling.Timers`), the all_reduce
   calls and bytes, and at 8 shards the device kernels and µs in one
   profiler window.  (b) `sharded_batch_align` on path 2's frame-1 inputs
   (S=8) over 8 shards: equal bit for bit to `batched_sparse_align` on the
   same keyframe preps, launching K1 8 times (each sequence's
   ReferencePrep), the stacked K6 once and the batched K3 once, each
   launch recorded and held to its plain version as in (c).  (c)
   `sharded_batch_align` on the same inputs with n_iter=3 (K3 below its
   cap of 12: at least one
   level stopped by the cap) and `dryrun_multichip()` on the card, every
   K1, K6 and K3 launch of both recorded and held to its plain version on
   the same inputs (K1 and the stacked K6 exact, the batched K3 against
   its batched plain version, every sequence within TOL_POSE); then
   `point_only_ba`, `optimize_current`, `gauss_newton` and
   `levenberg_marquardt` on tests/test_solvers.py's problems
   (`models/ba_workload.py`), card against CPU.  The launches of (b) and
   (c) count in the kernels line.  The process group ends with the path.
5m. Main path 15: the last public surface.  (a) `python -m
   ygz_slam_tpu_torch.run_synthetic_mono`'s `main` over N15 frames on the
   card (the JAX example's settings: SyntheticDataset's plane at 240x320,
   VOOptions() with its four init and keyframe fields) inside
   `record_launches`, the counters at 0 first: GOOD reached, the Sim(3)
   ATE < ATE15, the trajectory file holding every frame, the launches equal
   to `want_loops` (K1 twice, K2, K3, K4 and K5 per tracked frame, K10 per
   keyframe, K5 and K10 per mapping pass with the loop block, K8 per
   archive detection) and to the recorded ones; frames per second
   synchronised and launches per frame; every recorded launch replayed
   against its plain version with phase 2's checks.  (b) Each helper that
   no other path calls (`so3.vee` / `normalize`, `SE3.matrix` /
   `normalize`, the camera's `K`, `distort_px`, `world_to_camera`,
   `camera_to_world`, `in_frame`, `dnorm_dxi`, `image_gradients`,
   `rpe_rmse`, `warp_patches`, `popcount_u32`) once on the card against
   the CPU at tests/test_torch_helpers.py's tolerances, image_gradients and
   popcount_u32 exactly.  The launches of (a) count in the kernels line.
6. A short torch.profiler window over each main path (path 4 under
   variants 2 and 1, frames 30-49, keyframes in the window; under
   variant 2 no operator named cholesky may run; paths 6b and 7 on the
   same BoxScene frames, per frame and chunked, with the K3 launches the
   profiler saw against the frames that ran `track`; path 8 per frame over
   path 6b's window, then the synchronised ms of each seed update over the
   next 64 frames and one recorded update alone, its kernels and device
   time): device busy share and the kernels that take the most device
   time; then each
   kernel's device µs per launch in the profiler beside its CUDA-event
   time from phase 2 (whose intervals include the gap between launches;
   K2 in path 2's window and, at the VO's shape, in path 3's), K9 v1's
   pass split beside it.  A profiler window that records no device event
   at all (CUPTI hands the profiler none, now and then) is run again where
   its work may be repeated, up to PROFILE_TRIES windows, and is then
   printed as not measured; the launch counts and CUDA-event times do not
   depend on the profiler.  The windows record device activity only
   (host operators too where their names are checked: path 4's).  Every
   phase prints the clock it starts at.
7. One JSON line {"kernels": [...]} (launches summed over the main
   paths 1-15), then the last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when no CUDA device is available
or the package is not beside it.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

N_FRAMES = 240
S_BATCH = 8              # bench_batch.py's defaults: 8 sequences x 60 frames
F_BATCH = 60
N_VO = 240               # main path 3: frame 0 bootstraps the map, 239 are tracked
S_BIG = 16               # BASELINE.json config 5: 16 concurrent sequences
E2_FRAME = 12            # main path 4's frame whose K9 launches phase 2e replays
P4_PROFILE = (30, 50)    # main path 4's profiled frames (keyframes fall every ~7)
N_BOX = 320              # main paths 6b and 7: BoxScene frames
BOX_SPAN = 160           # path 6b's gated span (its loop starves the map past ~180)
EVICT_K, EVICT_FRAMES = 6, 200   # path 6c: a map of 6 slots, evicted from ~frame 100
BOX_SHAPE = (480, 640)
CHUNK = 32               # main path 7's chunk (VOOptions.chunk_frames)
P7_PROFILE = (32, 96, 160)    # path 7: per-frame to 32, chunked to 96, profiled to 160
N_DF = 240               # main path 8: BoxScene frames with the depth filter (no gate reads
                         # past frame 240: 8a's and 9d's read BOX_SPAN, 10c's N_LOOP, 11c's
                         # BOX_SPAN + 1)
DF_ATE = 0.10            # path 8's gate on the Sim(3)-aligned ATE over its first BOX_SPAN
                         # frames (path 6b's span; past it the run is reported: in both
                         # packages this configuration loses track in some runs and
                         # drifts in others, ROADMAP section 3)
DF_ROWS_EVERY = 40       # path 8 prints the valid landmark rows every this many frames
SEED_FRAME = 100         # path 8's frame whose seed update is held to the CPU's
P8_PROFILE = (96, 160, 224)   # path 8: profiled 96-159 (path 6b's window), seed update timed to 224
TOL_SEED = 1e-4          # seed update, card against CPU, relative: the floor ...
SEED_SPREAD = 2.0        # ... else this many times the CPU's own float32 error (against
                         # float64): tests/test_torch_depth_filter.py's rule, the CPU
                         # run standing where the JAX package's jit run stands there
MIN_SEED_AGREE = 0.98    # seeds updated on the card and on the CPU, share of valid rows
P13_REC = 20             # main path 13: the tracker call whose launches are recorded
P13_PROFILE = (100, 120)  # main path 13's frames under the profiler
SPIKE_AT = 10            # path 13c: the frame the camera jumps 0.25 m (tests/test_vo_types.py)
# Path 13's references: the JAX package's VisualOdometry on the CPU over the
# same frames and options (`JAX_PLATFORMS=cpu python tests/_torch_port.py
# frontend jax VO MAP 2`): its GOOD share and Sim(3)-aligned ATE, m.
ORB13_REF = dict(good=0.93125, ate=0.0123146722443671)      # SPARSE_ORB
SD13_REF = dict(good=0.93125, ate=0.002765455801914738)     # SEMI_DENSE_DIRECT, SEMI_DENSE map
ATE13_SLACK = 1.25       # path 13's ATE bound, times the JAX run's (the port on the CPU: 1.041x)
MIN13_MATCH_AGREE = 0.99  # path 13a: match decisions, card against CPU, share of landmarks
SEED_SPREAD13 = 0.15     # path 13b: seed depth spread on the plane (tests/test_vo_types.py)
P14_L, P14_K, P14_OBS = 3072, 10, 5   # main path 14a: bench_scaling.py's problem at path 3's L
P14_ITERS = 10           # its LM iterations (bench_scaling.py's --iters)
P14_SHARDS = (1, 2, 4, 8)   # the shards one rank of the NCCL world holds, in turn
P14_REPS = 3             # timed solves per shard count
TOL14_POSE = 2e-5        # shard counts against each other: params7 (tests/test_torch_sharded_ba.py)
TOL14_POINT = 2e-4       # ... and landmarks, m
TOL14_CPU = 1e-4         # 14c, card against CPU: landmarks (m) and the solvers' x, relative
TOL14_CPU_POSE = 1e-5    # 14c: optimize_current's free pose (tests/test_torch_solvers.py)
N_SENSOR = 60            # main path 12: SyntheticDataset frames (its default length) ...
SENSOR_SHAPE = (480, 640)   # ... at its default size
SENSOR_ATE = 0.03        # path 12's gate on the rigid ATE (tests/test_system.py, test_stereo.py)
DENSE_FRAMES = 20        # path 12a's frames with the DENSE map
BASELINE = 0.1           # path 12b's stereo baseline, m (tests/test_stereo.py)
TOL_STEREO = 1e-4        # match_stereo depth, card against CPU, relative, where both accept
REPS = 30               # kernel timing: per-launch intervals, median
PLAIN_REPS = 5          # plain versions sync on the host: fewer reps
PROFILE_TRIES = 3       # profiler windows run before one is reported as not measured
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
TOL_POSE_FLAT = 1e-3    # K8 on relocalization candidates, where the final chi2 agrees
                        # within TOL_REL: a candidate held by ~20 points has a
                        # direction along which float32 chi2 does not change, so
                        # kernel and plain stop at different points of it (path
                        # 10d's 20-inlier candidate: 1.5e-4 apart, chi2 1.8e-6
                        # apart, the same gap at eps 1e-6; the plain version alone
                        # on the CPU and on the card: 6.9e-5 on a 34-inlier one)
TOL_XY = 1e-3           # K4, px, on >= 98% of the points both accept;
TOL_XY_ALL = 0.05       # all of them within 0.05 px: a 0.03 px freeze
                        # decision may flip on rounding and skip one step
MIN_MASK_AGREE = 0.98   # K4 acceptance masks
MIN_INLIER_AGREE = 0.99  # K5/K8 inlier sets
TOL_REL = 1e-4          # K9 and K11 chi2 and K9 H, relative
TOL_BA_CHAIN = 1e-3     # K11's BA chi2 against the plain chain's, relative:
                        # an align2d freeze flip (TOL_XY_ALL) moves one
                        # point of stage 3's input.  Phase 2f prints the
                        # readings behind it and fails unless it passes
                        # all of them and no float16 control.
K11_FRAMES = 16         # path 5's frames whose K11 BA chi2 phase 2f reads
# (source, kernel) pairs whose ptxas report the header prints.
PTXAS_KERNELS = (("sparse_align_mega", "sparse_align_mega_kernel"),
                 ("pose_ba_fused", "pose_ba_fused_kernel"),
                 ("pose_ba_fused_batch", "pose_ba_fused_batch_kernel"),
                 ("sparse_align_fused", "level_align_v1_kernel"),
                 ("sparse_align_fused", "level_align_v2_kernel"),
                 ("track_fused", "track_fused_kernel"),
                 ("align2d_fused", "align2d_fused_kernel"),
                 ("gather_windows", "gather_windows_grouped_kernel"),
                 ("gather_windows", "gather_windows_multi_kernel"),
                 ("hamming", "hamming_mma_kernel"))
NO_SPILL = ("sparse_align_mega_kernel", "pose_ba_fused_kernel",    # must not spill
            "track_fused_kernel", "level_align_v1_kernel", "level_align_v2_kernel",
            "align2d_fused_kernel")
TOL_ENTRY = 1e-3        # entry(), card versus CPU: K3's and K5's solves in a
                        # row on noise images (the pyramids' sums differ too)
N15 = 40                 # main path 15: run_synthetic_mono's frames (its default)
ATE15 = 0.05             # path 15a's ATE bound, m (tests/test_vo.py:99; the JAX example's
                         # own CPU run over the same 40 frames: 29 GOOD, 0.0078 m)
# Path 15b, each helper on the card against the CPU, at the tolerances of
# tests/test_torch_helpers.py (which holds the CPU against the JAX package).
TOL15_GEOM = 2e-5        # elementwise float32 geometry, absolute
TOL15_PX = 1e-3          # distort_px, px
TOL15_SVD = 1e-5         # so3.normalize / SE3.normalize (two SVDs)
TOL15_PATCH = 1e-2       # warp_patches: one float32 step of a sample coordinate near
TOL15_PATCH_MEAN = 1e-4  # x = 300 px times the texture's 255 per px step; the mean
TOL15_RPE = 1e-5         # rpe_rmse, relative


def _rel(a, b):
    """|a - b| relative to |b| (floored at 1e-6), of two scalars."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _time_kernel(torch, fn, reps=REPS):
    """Median device time (ms) of one launch of fn(): events between
    consecutive launches, the host's enqueue hidden behind a sleep that
    outlasts the enqueue of all reps (twice one call's host time each, at
    2e9 SM cycles per second: the H100's clock is at most 1.98 GHz)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(max(20_000_000, int(2 * reps * host_s * 2e9)))
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


def _device_events(averages):
    """{kernel name: (device µs, launches)} of a profiler window's device
    events, from its key_averages() (host events left out: no double
    count)."""
    rows = {}
    for e in averages:
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            us, count = rows.get(e.key, (0.0, 0))
            rows[e.key] = (us + dt, count + e.count)
    return rows


def _nm(x, spec, unit=""):
    """x formatted by spec with its unit, or "not measured" for None (a
    profiler window that recorded no device event)."""
    return "not measured" if x is None else format(x, spec) + unit


def _profile_us(torch, fn, sym, n=30):
    """Device µs per launch of the kernels whose name holds `sym`, in a
    torch.profiler window over n calls of fn() (device activity only: the
    host operators' events would only lengthen the trace's parse).  A
    window in which the
    profiler recorded no device event at all (CUPTI handed it none) is run
    again, up to PROFILE_TRIES windows; after that the number is not
    measured (None).  A window with device events but none named `sym`
    fails the run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = _device_events(prof.key_averages())
        if rows:
            break
    else:
        print(f"the profiler recorded no device event in {PROFILE_TRIES} windows of {n} calls "
              f"(for {sym}): not measured", flush=True)
        return None
    hits = [v for key, v in rows.items() if sym in key]
    if not hits:
        raise AssertionError(f"the profiler saw no {sym}; its device events: "
                             f"{[k[:60] for k in rows][:8]} ({len(rows)} names)")
    return sum(h[0] for h in hits) / sum(h[1] for h in hits)


def _k5_links(normal_eqs, rounds=4):
    """K5's dependent block reductions per launch: its normal equations, a
    count per round, round 0's count and two medians of 1 max + 4 grouped
    bisection counts each."""
    return normal_eqs + rounds + 1 + 2 * (1 + 4)


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gather_bytes(torch, requests):
    """The least bytes a launch that gathers windows must move, for its
    requests (img [H, W], xi [N], yi [N], win): each image pixel that some
    window covers, read once (an image that several requests name counts
    once), each window written once, and two int32 origins per window.  A
    window's pixels off its image are zero-filled and read nothing."""
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


def _fingerprint(system, statuses, T7):
    """What a run of main path 4 leaves: its statuses, trajectory and the
    map's keyframe poses and landmarks, as bytes for a bit-for-bit test."""
    m = system.vo.server.state
    return ([s.name for s in statuses], T7.tobytes(), m.kf_pose7.cpu().numpy().tobytes(),
            m.pt_pos.cpu().numpy().tobytes()), (T7, m.kf_pose7.cpu().numpy())


def _check_repeat(first, second, label):
    """Two runs of main path 4 in one process must be equal bit for bit."""
    (fa, (Ta, Ka)), (fb, (Tb, Kb)) = first, second
    same = fa == fb
    d = max(float(abs(Ta - Tb).max()), float(abs(Ka - Kb).max())) if len(Ta) == len(Tb) \
        else float("inf")
    print(f"main path 4 repeated, {label}: statuses {'equal' if fa[0] == fb[0] else 'DIFFERENT'}, "
          f"trajectory, keyframe poses and landmarks "
          f"{'equal bit for bit' if same else 'DIFFERENT'} (max |difference| of poses {d:.3e})",
          flush=True)
    if not same:
        raise AssertionError(f"main path 4 is not repeatable on the card ({label})")


def _profile(torch, fn, n, label, ops=None, again=True):
    """Device busy share and top kernels of fn() (n frames) under
    torch.profiler; returns {kernel name: (device µs, launches)}.  `ops`, a
    set if given, receives the names of every event, host operators too,
    which are recorded only then: they are most of a window's events, and
    parsing the events on the host is most of a window's time.
    A window in which the profiler recorded no device event at all is run
    again when fn() may be repeated (`again`), up to PROFILE_TRIES windows;
    after that the window is not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([] if ops is None else [ProfilerActivity.CPU])
    for _ in range(PROFILE_TRIES if again else 1):
        with profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        if ops is not None:
            ops.update(e.key for e in averages)
        rows = _device_events(averages)
        if rows:
            break
    else:
        print(f"profile {label}: {n} frames, wall {wall * 1e3 / n:.3f} ms/frame; the profiler "
              f"recorded no device event: not measured", flush=True)
        return None
    busy_us = sum(v[0] for v in rows.values())
    print(f"profile {label}: {n} frames, wall {wall * 1e3 / n:.3f} ms/frame, "
          f"device busy {busy_us / n / 1e3:.3f} ms/frame ({busy_us / (wall * 1e6):.3f} of wall), "
          f"{sum(v[1] for v in rows.values()) / n:.1f} device kernels/frame")
    for key, (dt, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {dt / n:9.2f} us/frame  {count / n:6.1f}/frame  {key[:90]}")
    return rows


def _totals(prof, n=1):
    """(device kernels, device µs) of a profiler window per frame of n, or
    (None, None) where the window was not measured."""
    if prof is None:
        return None, None
    return (sum(v[1] for v in prof.values()) / n, sum(v[0] for v in prof.values()) / n)


def _path15(torch, dev, checks, instrumented, want_loops):
    """Main path 15a: `python -m ygz_slam_tpu_torch.run_synthetic_mono`'s
    `main` over N15 frames on the card, inside `instrumented` (the counters
    at 0 first; calls of `track` and mapping passes with the loop block
    counted) and `record_launches`: its gates, its launches against
    `want_loops`, and every recorded launch replayed against its plain
    version by `checks` (phase 2's checks of K1, K2, K3, K4, K5, K8 and the
    exact K10 comparison).  Returns its launch counts."""
    from ygz_slam_tpu_torch import run_synthetic_mono as rsm
    from ygz_slam_tpu_torch.ops import kernels
    from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as k1
    from ygz_slam_tpu_torch.ops.kernels import hamming_kernel as k10

    tmp15 = tempfile.mkdtemp(prefix="ygz_demo_")
    made15, kf15 = [], []        # the VisualOdometry the script makes; its keyframes per frame
    real_vo15 = rsm.VisualOdometry

    def vo15(*a, **kw):
        vo = real_vo15(*a, **kw)
        real_add = vo.add_frame

        def add_frame(*fa, **fkw):
            out = real_add(*fa, **fkw)
            kf15.append(vo.stats["keyframes"])
            return out

        vo.add_frame = add_frame
        made15.append(vo)
        return vo

    def run15():
        with kernels.record_launches() as r:
            out = rsm.main(["--frames", str(N15), "--device", str(dev), "--out", tmp15])
        return out, r

    rsm.VisualOdometry = vo15
    try:
        ((recs15, rec15), wall15, launches15, n_tr15), irec15 = instrumented(run15, timed=False)
    finally:
        rsm.VisualOdometry = real_vo15
    want15 = want_loops(n_tr15, made15[0], irec15)
    recorded15 = {}
    for fn, _ in rec15:
        recorded15[fn.__name__] = recorded15.get(fn.__name__, 0) + 1
    path15_kernels = ("gather_windows_levels", "gather_windows_multi", "mega_gn", "a2d_gn",
                      "pose_ba_gn", "distance_matrix")
    ate15 = rsm.ate(recs15)
    tum15 = os.path.join(tmp15, "trajectory_tum.txt")
    n_tum15 = len(open(tum15).read().splitlines()) if os.path.exists(tum15) else 0
    st15 = [r.status for r in recs15]
    ok15 = ("GOOD" in st15 and ate15 is not None and ate15 < ATE15 and n_tum15 == N15
            and launches15 == want15 and all(launches15[k] for k in path15_kernels)
            and recorded15 == {k: v for k, v in launches15.items() if v})
    print(f"main path 15a (run_synthetic_mono.main, {N15} frames 240x320 on the card): "
          f"statuses {' '.join(f'{s[0]}' for s in st15)} (I INITING, G GOOD), "
          f"{st15.count('GOOD')} GOOD, {recs15[-1].keyframes} keyframes in the window at the "
          f"end; Sim(3) ATE {_nm(ate15, '.5f', ' m')} (< {ATE15}); trajectory file "
          f"{n_tum15} lines; {N15 / wall15:.2f} frames/s synchronised over the whole script "
          f"({wall15:.3f} s, rendering and files included), add_frame median "
          f"{statistics.median(r.ms for r in recs15):.2f} ms (GOOD frames "
          f"{statistics.median(r.ms for r in recs15 if r.status == 'GOOD'):.2f} ms); "
          f"{sum(launches15.values()) / N15:.2f} launches per frame, "
          f"{sum(launches15.values()) / max(n_tr15, 1):.2f} per tracked frame ({n_tr15}); "
          f"launches {launches15} (expected {want15}; recorded {recorded15}): "
          f"{'pass' if ok15 else 'FAIL'}", flush=True)
    if not ok15:
        raise AssertionError("main path 15a failed its gates")
    # Where the script's time goes: add_frame per kind of frame (the init
    # frame and the keyframe frames count the VO's keyframes up), the rest
    # rendering, printing and the files.
    kinds = {}
    for r, n_kf, n_before in zip(recs15, kf15, [0] + kf15[:-1]):
        kind = "keyframe" if n_kf != n_before else r.status
        kinds.setdefault(kind, []).append(r.ms)
    spent = sum(r.ms for r in recs15)
    print("main path 15a, add_frame ms by frame: " + "; ".join(
        f"{k} {len(v)} frames, sum {sum(v):.1f}, median {statistics.median(v):.2f}, max "
        f"{max(v):.2f}" for k, v in kinds.items())
        + f"; outside add_frame {1e3 * wall15 - spent:.1f} ms of {1e3 * wall15:.1f}", flush=True)
    # Every recorded launch against its plain version (the phase-2 checks);
    # their per-launch lines go to a buffer, printed if a check fails.
    buf15, errs15 = io.StringIO(), {}
    H15, W15 = rsm.SHAPE
    try:
        with contextlib.redirect_stdout(buf15):
            for i, (fn, args) in enumerate(rec15):
                tag, name = f"main path 15a, launch {i}", fn.__name__
                if name == "gather_windows_levels":
                    e = checks["K1"]([args], tag, with_library=False)
                elif name == "mega_gn":
                    e = checks["K3"](args, tag)[0]
                elif name == "gather_windows_multi":
                    e = checks["K2"](args, tag)
                elif name == "a2d_gn":
                    xy0 = args[7]
                    inb0 = (xy0 != k1.PATCH + 2.0).any(dim=1)
                    e = checks["K4"]((args, xy0, inb0, H15, W15), tag)
                elif name == "pose_ba_gn":
                    e = checks["K5"](args, tag)[0]
                elif name == "distance_matrix":
                    e = checks["exact"]("K10 hamming distance_matrix",
                                        [k10.distance_matrix(*args)],
                                        [k10.distance_matrix_plain(*args)], tag)
                elif name == "pose_ba_batch_gn":        # a relocalization or archive attempt
                    e = checks["K8"](args, tag, flat=True)[0]
                else:
                    raise AssertionError(f"{tag}: {name} launched")
                n_e, e_max = errs15.get(name, (0, 0.0))
                errs15[name] = (n_e + 1, max(e_max, e))
    except Exception:
        print(buf15.getvalue(), flush=True)
        raise
    print(f"main path 15a: {len(rec15)} launches replayed against their plain versions, "
          f"(launches, largest max |kernel - plain|) per kernel: {errs15}", flush=True)
    shutil.rmtree(tmp15, ignore_errors=True)
    return launches15


def _path15b(torch, dev):
    """Main path 15b: each helper that no other path calls, once on the card
    and once on the CPU on the same seeded inputs (tests/test_torch_helpers.py's
    cases), held at that file's tolerances; image_gradients and
    popcount_u32 exactly.  Returns {helper: (error, tolerance)}."""
    import numpy as np

    from ygz_slam_tpu_torch.geometry import jacobians, se3, so3
    from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.ops import hamming, interp, warp
    from ygz_slam_tpu_torch.system import trajectory
    from ygz_slam_tpu_torch.utils import synthetic

    rng = np.random.default_rng(15)
    cam = PinholeCamera.create(517.3, 516.5, 325.1, 249.7, 0.2624, -0.9531, -0.0054, 0.0026)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    Rn = np.asarray(so3.exp(torch.from_numpy(w * 0.8))) + rng.normal(size=(64, 3, 3)).astype(
        np.float32) * 1e-2
    xi = (rng.normal(size=(16, 6)) * [2.0, 2.0, 2.0, 0.6, 0.6, 0.6]).astype(np.float32)
    pw = rng.uniform(-1.0, 1.0, size=(256, 3)).astype(np.float32)
    px = (np.asarray([cam.cx, cam.cy]) + rng.uniform(-0.35, 0.35, size=(256, 2))
          * np.asarray([cam.fx, cam.fy])).astype(np.float32)
    pc = np.concatenate([pw[:, :2], np.abs(pw[:, 2:]) + 0.5], axis=1)
    frame_px = rng.uniform(-20, 660, size=(256, 2)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, size=(256, 8), dtype=np.uint64).astype(np.uint32)
    words[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    n = 27
    wpx = rng.uniform([40.0, 40.0], [280.0, 200.0], size=(n, 2)).astype(np.float32)
    A = (np.eye(2) * rng.uniform(0.5, 2.5, size=(n, 1, 1))
         + rng.normal(size=(n, 2, 2)) * 0.05).astype(np.float32)
    lv_ref = np.repeat(np.arange(3, dtype=np.int32), n // 3)
    lv_search = np.tile(np.arange(3, dtype=np.int32), n // 3)
    noise = rng.normal(size=(40, 6)).astype(np.float32) * 1e-2
    # One rendered image for both devices (renders on the two differ by ulps).
    image = synthetic.PlaneScene(PinholeCamera.create(320.0, 320.0, 160.0, 120.0), seed=0,
                                 device="cpu").render(SE3.identity(device="cpu"), (240, 320))

    def on(d):
        """Every helper's output on device d, as CPU tensors."""
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(d)
        T = se3.exp(t(xi))
        img = image.to(d)
        gt = synthetic.loop_trajectory(40, device=d)
        est = [se3.exp(t(e)).compose(g) for e, g in zip(noise, gt)]
        out = {
            "so3.vee": so3.vee(so3.hat(t(w))),
            "so3.normalize": so3.normalize(t(Rn)),
            "SE3.matrix": T.matrix(),
            "SE3.normalize": SE3(T.R * 1.003, T.t).normalize().R,
            "PinholeCamera.K": cam.K(d),
            "PinholeCamera.distort_px": cam.distort_px(t(px)),
            "PinholeCamera.world_to_camera": cam.world_to_camera(t(pw), SE3(T.R[0], T.t[0])),
            "PinholeCamera.camera_to_world": cam.camera_to_world(t(pw), SE3(T.R[0], T.t[0])),
            "PinholeCamera.in_frame": cam.in_frame(t(frame_px), 640, 480, boundary=3),
            "jacobians.dnorm_dxi": jacobians.dnorm_dxi(t(pc)),
            "interp.image_gradients": torch.stack(interp.image_gradients(img)),
            "trajectory.rpe_rmse": torch.tensor(trajectory.rpe_rmse(est, gt, delta=1)),
            "warp.warp_patches": warp.warp_patches(img, t(wpx), t(lv_ref), t(A), t(lv_search)),
            "hamming.popcount_u32": hamming.popcount_u32(t(words.view(np.int32))),
        }
        if d != "cpu":
            torch.cuda.synchronize()
        return {k: v.cpu() for k, v in out.items()}

    card, cpu = on(dev), on("cpu")
    tols = {"so3.vee": 0.0, "so3.normalize": TOL15_SVD, "SE3.matrix": TOL15_GEOM,
            "SE3.normalize": TOL15_SVD, "PinholeCamera.K": 0.0,
            "PinholeCamera.distort_px": TOL15_PX, "PinholeCamera.world_to_camera": TOL15_GEOM,
            "PinholeCamera.camera_to_world": TOL15_GEOM, "PinholeCamera.in_frame": 0.0,
            "jacobians.dnorm_dxi": TOL15_GEOM, "interp.image_gradients": 0.0,
            "trajectory.rpe_rmse": TOL15_RPE, "warp.warp_patches": TOL15_PATCH,
            "hamming.popcount_u32": 0.0}
    errs, bad = {}, []
    for k, tol in tols.items():
        a, b = card[k], cpu[k]
        if a.dtype == torch.bool:
            e = float((a != b).sum())
        elif k == "trajectory.rpe_rmse":
            e = float(((a - b).abs() / b.abs()).max())
        else:
            e = float((a.double() - b.double()).abs().max())
        errs[k] = (e, tol)
        if not (e <= tol and a.shape == b.shape):
            bad.append(k)
    mean = float((card["warp.warp_patches"] - cpu["warp.warp_patches"]).abs().mean())
    if mean > TOL15_PATCH_MEAN:
        bad.append("warp.warp_patches (mean)")
    print(f"main path 15b, each helper on the card against the CPU (error, tolerance; exact "
          f"where 0): {errs}; warp_patches mean {mean:.2e} ({TOL15_PATCH_MEAN}); PinholeCamera."
          f"scaled(0.5) {cam.scaled(0.5)}: {'pass' if not bad else 'FAIL ' + str(bad)}",
          flush=True)
    if bad:
        raise AssertionError(f"main path 15b: {bad} disagree between the card and the CPU")
    return errs


def _path14(torch, dev, reset, counters, checks, bstate, frames_b, T7_1):
    """Main path 14: scale-out on an NCCL process group (a world of one
    rank, the card).  `checks` holds phase 2's checks of K1, the batched
    K3 and exact copies against their plain versions.  Returns the launch
    counts of 14b's and 14c's calls."""
    import torch.distributed as dist

    from ygz_slam_tpu_torch.entry import dryrun_multichip
    from ygz_slam_tpu_torch.geometry import se3
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.models import ba_workload as bw
    from ygz_slam_tpu_torch.ops import kernels, pyramid, sparse_align
    from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as k1
    from ygz_slam_tpu_torch.ops.kernels import sparse_align_mega as k3
    from ygz_slam_tpu_torch.parallel import batch_tracking as bt
    from ygz_slam_tpu_torch.parallel import mesh as pmesh
    from ygz_slam_tpu_torch.parallel import sharded_ba as sba
    from ygz_slam_tpu_torch.solvers import ba, nlls
    from ygz_slam_tpu_torch.utils import profiling

    if dist.is_initialized():
        raise AssertionError("a process group is already running before path 14")
    # 14a. sharded_local_ba at the map's full width, 1, 2, 4 and 8 shards.
    p = bw.ba_problem(P14_L, P14_K, P14_OBS, device=dev)
    res1 = ba.local_ba(p.noisy_poses, p.noisy_points, p.obs, p.cam, p.fixed, n_iter=P14_ITERS)
    err1, bs1 = bw.pose_gate(res1.poses, p)
    timers = profiling.Timers()
    outs, lines = {}, []
    for n in P14_SHARDS:
        mesh = pmesh.make_mesh(n, device=dev)
        if dist.get_backend(mesh.group) != "nccl" or mesh.world != 1 or mesh.local != n:
            raise AssertionError(f"path 14a's mesh runs {dist.get_backend(mesh.group)} over "
                                 f"{mesh.world} "
                                 f"rank(s) holding {mesh.local} shards")
        args = bw.shard_inputs(mesh, p)

        def run():
            return sba.sharded_local_ba(mesh, *args, p.cam, p.fixed, n_iter=P14_ITERS)

        out = run()
        c0, b0 = pmesh.reduce_sum.calls, pmesh.reduce_sum.bytes
        for _ in range(P14_REPS):
            with timers.time(f"14a n={n}", block_on=p.points):
                out = run()
        n_it = P14_REPS * P14_ITERS
        calls, nbytes = (pmesh.reduce_sum.calls - c0) / n_it, (pmesh.reduce_sum.bytes - b0) / n_it
        P, X, C = out
        gauge = float(se3.distance(SE3(P.R[:2], P.t[:2]),
                                   SE3(p.noisy_poses.R[:2], p.noisy_poses.t[:2])).max())
        err, bs = bw.pose_gate(P, p)
        ms = 1e3 * timers.total[f"14a n={n}"] / n_it
        ok = (gauge < 1e-6 and err <= 1.1 * err1 + 1e-4 and bs < 0.05
              and bool(torch.isfinite(C)))
        outs[n] = (P.params7(), X[:P14_L])
        lines.append(ms)
        print(f"main path 14a, {n} shard(s) on 1 NCCL rank: {ms:.3f} ms per iteration "
              f"(synchronised, {P14_REPS} solves of {P14_ITERS}), {calls:.1f} all_reduce calls "
              f"and {nbytes:.0f} bytes reduced per iteration; chi2 {float(C):.4f}, gauge poses "
              f"moved {gauge:.1e} (< 1e-6), mean pose error {err:.6f} (local_ba {err1:.6f}, "
              f"bound {1.1 * err1 + 1e-4:.6f}), bench_scaling's error {bs:.6f} (< 0.05): "
              f"{'pass' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"main path 14a failed its gates at {n} shard(s)")
    for n in P14_SHARDS[1:]:
        dp = float((outs[n][0] - outs[1][0]).abs().max())
        dx = float((outs[n][1] - outs[1][1]).abs().max())
        print(f"main path 14a, {n} shards against 1: params7 {dp:.2e} (<= {TOL14_POSE}), "
              f"landmarks {dx:.2e} (<= {TOL14_POINT})", flush=True)
        if dp > TOL14_POSE or dx > TOL14_POINT:
            raise AssertionError(f"main path 14a: {n} shards disagree with one")
    again = run()
    same = all(torch.equal(a, b) for a, b in zip((*again[0], again[1], again[2]),
                                                  (*out[0], out[1], out[2])))
    print(f"main path 14a, 8 shards run again: {'equal bit for bit' if same else 'DIFFERENT'}",
          flush=True)
    if not same:
        raise AssertionError("main path 14a: the 8-shard solve does not repeat bit for bit")
    prof = _profile(torch, run, P14_ITERS, f"main path 14a, {P14_SHARDS[-1]} shards (per "
                    f"iteration, {P14_ITERS} iterations)")
    k14, us14 = _totals(prof, P14_ITERS)
    print(f"main path 14a per iteration at {P14_SHARDS[-1]} shards: {_nm(k14, '.1f')} device "
          f"kernels, {_nm(us14, '.1f', ' us')} of device time; local_ba on one device "
          f"{float(res1.chi2):.4f} chi2", flush=True)

    # 14b. sharded_batch_align on path 2's frame-1 inputs, 8 sequences.
    S = bstate.px.shape[0]
    mesh8 = pmesh.make_mesh(S, device=dev)
    cur_pyrs = pyramid.build_pyramid(frames_b[1], len(bstate.ref_pyrs))
    T0 = SE3.from_params7(T7_1)
    preps = [sparse_align.prepare_reference(tuple(r[s] for r in bstate.ref_pyrs), bstate.cam,
                                            bstate.px[s], bstate.depth[s], bstate.mask[s],
                                            distorted=bt.DISTORTED) for s in range(S)]
    ref = bt.batched_sparse_align(bstate.ref_pyrs, cur_pyrs, bstate.cam, bstate.px,
                                  bstate.depth, bstate.mask, T0, preps).params7()
    reset()
    with kernels.record_launches() as rec:
        T = bt.sharded_batch_align(mesh8, bstate.ref_pyrs, cur_pyrs, bstate.cam, bstate.px,
                                   bstate.depth, bstate.mask, T0)
        torch.cuda.synchronize()
    launches14b = {c.__name__: c.launches for c in counters}
    want = {c.__name__: 0 for c in counters}
    want.update(gather_windows_levels=S, gather_windows_grouped=1, mega_gn_batch=1)
    same = torch.equal(T.params7(), ref)
    print(f"main path 14b (sharded_batch_align, {S} sequences on {mesh8.local} shards of 1 NCCL "
          f"rank): equal to batched_sparse_align bit for bit: {same}; launches {launches14b} "
          f"(expected {want})", flush=True)
    if not same or launches14b != want:
        raise AssertionError("main path 14b failed")

    def replay(rec, tag_of, n_iter):
        """Every launch of `rec` against its plain version: K1 and K6 (the
        stacked wrapper, on the path's own arguments) exact, the batched K3
        every sequence within TOL_POSE.  Returns each K3 launch's passes per
        level of every sequence (the plain version's), by launch index."""
        passes = {}
        for i, (fn, args) in enumerate(rec):
            tag = tag_of(i)
            if fn.__name__ == "mega_gn_batch":
                if args[12] != n_iter:
                    raise AssertionError(f"{tag}: K3 launched with n_iter {args[12]}, not {n_iter}")
                passes[i] = [st["passes"] for st in checks["K3b"](args, tag)[1]]
            elif fn.__name__ == "gather_windows_stacked":
                checks["exact"]("K6 gather_windows_stacked", [k1.gather_windows_stacked(*args)],
                                [k1.gather_windows_stacked_plain(*args)], tag)
            elif fn.__name__ == "gather_windows_levels":
                checks["K1"]([args], tag, with_library=False)
            else:
                raise AssertionError(f"{tag}: {fn.__name__} launched")
        return passes

    replay(rec, lambda i: f"main path 14b, launch {i}", k3.MAX_ITER)
    print(f"main path 14b: {len(rec)} launches replayed against their plain versions",
          flush=True)

    # 14c. sharded_batch_align below K3's iteration cap and dryrun_multichip,
    # every launch recorded and replayed against its plain version; then the
    # solvers with no caller on a path, card against CPU.
    reset()
    with kernels.record_launches() as rec:
        T3 = bt.sharded_batch_align(mesh8, bstate.ref_pyrs, cur_pyrs, bstate.cam, bstate.px,
                                    bstate.depth, bstate.mask, T0, n_iter=3)
        n3 = len(rec)
        _, dx, dc, dT = dryrun_multichip(device=dev)
        torch.cuda.synchronize()
    launches14c = {c.__name__: c.launches for c in counters}
    want = {c.__name__: 0 for c in counters}
    want.update(gather_windows_levels=S + dT.R.shape[0], gather_windows_grouped=2,
                mega_gn_batch=2)
    print(f"main path 14c: sharded_batch_align with n_iter=3 ({S} sequences) and "
          f"dryrun_multichip() on the card ({dx.shape[0]} landmark rows, chi2 {float(dc):.3e}, "
          f"{dT.R.shape[0]} sequence(s)); launches {launches14c} (expected {want})", flush=True)
    if (launches14c != want or not bool(torch.isfinite(T3.params7()).all())
            or torch.equal(T3.params7(), T.params7())):
        raise AssertionError("main path 14c: the n_iter=3 call or dryrun_multichip failed")
    passes = replay(rec, lambda i: (f"main path 14c, "
                                    f"{'n_iter=3 call' if i < n3 else 'dryrun_multichip'}, "
                                    f"launch {i}"), 3)
    capped = sum(max(p) == 4 for i, ps in passes.items() if i < n3 for p in ps)
    print(f"main path 14c: {len(rec)} launches replayed against their plain versions; K3 "
          f"levels stopped by the cap of 3 in {capped} of {S} sequences", flush=True)
    if not capped:
        raise AssertionError("main path 14c: no K3 level of the n_iter=3 call reached the cap")
    cpu = torch.device("cpu")
    errs = {}
    cam, poses, truth, noisy, obs = bw.point_problem(dev)
    out_d = ba.point_only_ba(poses, noisy, obs, cam)
    cam_c, poses_c, truth_c, noisy_c, obs_c = bw.point_problem(cpu)
    out_c = ba.point_only_ba(poses_c, noisy_c, obs_c, cam_c)
    errs["point_only_ba"] = float((out_d.cpu() - out_c).abs().max())
    (cam, gt, start, pts, noisy, obs, cur), (cam_c, gt_c, start_c, pts_c, noisy_c, obs_c, _) = (
        bw.current_problem(dev), bw.current_problem(cpu))
    rd = ba.optimize_current(start, noisy, obs, cam, cur, n_iter=15)
    rc = ba.optimize_current(start_c, noisy_c, obs_c, cam_c, cur, n_iter=15)
    errs["optimize_current points"] = float((rd.points.cpu() - rc.points).abs().max())
    errs["optimize_current pose"] = float(se3.distance(
        SE3(rd.poses.R[cur].cpu(), rd.poses.t[cur].cpu()), SE3(rc.poses.R[cur], rc.poses.t[cur])))
    inl_same = torch.equal(rd.inlier.cpu(), rc.inlier)

    def rosenbrock(p):
        x, y = p[0], p[1]
        r = torch.stack([1.0 - x, 10.0 * (y - x * x)])
        J = torch.stack([torch.stack([-torch.ones_like(x), torch.zeros_like(x)]),
                         torch.stack([-20.0 * x, 10.0 * torch.ones_like(x)])])
        return J.T @ J, -J.T @ r, torch.sum(r * r)

    def line_fit(xs):
        def compute(p):
            r = p[0] * xs + p[1] - (3.0 * xs + 0.5)
            J = torch.stack([xs, torch.ones_like(xs)], dim=-1)
            return J.T @ J, -J.T @ r, torch.sum(r * r)
        return compute

    for name, solver, model, x0, n_iter in (
            ("gauss_newton", nlls.gauss_newton, line_fit, [0.0, 0.0], 5),
            ("levenberg_marquardt", nlls.levenberg_marquardt, None, [-1.2, 1.0], 60)):
        xs = []
        for d in (dev, cpu):
            compute = rosenbrock if model is None else model(torch.linspace(0, 1, 50, device=d))
            xs.append(solver(compute, lambda x, dx: x + dx, torch.tensor(x0, device=d),
                             n_iter=n_iter)[0].cpu())
        errs[name] = float((xs[0] - xs[1]).abs().max())
    ok = (errs["point_only_ba"] <= TOL14_CPU and errs["optimize_current points"] <= TOL14_CPU
          and errs["optimize_current pose"] <= TOL14_CPU_POSE and inl_same
          and errs["gauss_newton"] <= TOL14_CPU and errs["levenberg_marquardt"] <= TOL14_CPU)
    print(f"main path 14c, card against CPU: {errs} (landmarks and x <= {TOL14_CPU}, the pose "
          f"<= {TOL14_CPU_POSE}); optimize_current inliers equal: {inl_same}: "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("main path 14c: a solver on the card disagrees with the CPU")
    dist.destroy_process_group()
    print(f"main path 14a ms per iteration at {P14_SHARDS}: {[round(m, 3) for m in lines]}",
          flush=True)
    return {k: launches14b[k] + launches14c[k] for k in launches14b}


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
    from ygz_slam_tpu_torch.ops.kernels import track_fused as k11
    from ygz_slam_tpu_torch.entry import entry
    from ygz_slam_tpu_torch.models import mono_workload as mw
    from ygz_slam_tpu_torch.models import nonplanar_workload as nw
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
    # ptxas's registers, stack, spills and shared memory of the chained kernels.
    spills, smem_static = {}, {}
    for src, kernel in PTXAS_KERNELS:
        for name, r in _build.kernel_resources(src).items():
            if kernel in name:
                spills[kernel] = r["spill_stores"] + r["spill_loads"]
                smem_static[kernel] = r["smem"]
                print(f"ptxas {src}.cu {kernel}: {r['registers']} registers, {r['stack']} bytes "
                      f"stack, {r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes "
                      f"spill loads, {r['smem']} bytes static shared memory", flush=True)
    dev = torch.device("cuda")
    L = tr.N_LEVELS

    # -- 2a. single-sequence kernels versus plain versions -------------------
    print(f"clock: phase 2a starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t0 = time.perf_counter()
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = tr.make_workload(
        N_FRAMES, dev)
    torch.cuda.synchronize()
    print(f"workload: {N_FRAMES} frames 640x480, {px.shape[0]} landmarks, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    state = tr.make_state(cam, ref_pyr, px, depth, mask, pts_w, patches)

    def frame_inputs(st, img, T_init):
        """Each kernel's inputs on one frame of the main path; K1's are the
        ones `track_step` itself passes (recorded): the pyramid's windows,
        then K4's at K3's pose."""
        with kernels.record_launches() as rec:
            tr.track_step(st, T_init.params7(), img)
        names = [f.__name__ for f, _ in rec]
        if names != ["gather_windows_levels", "mega_gn", "gather_windows", "a2d_gn",
                     "pose_ba_gn"]:
            raise AssertionError(f"track_step launched {names}")
        g1 = [a for f, a in rec if f in (k1.gather_windows_levels, k1.gather_windows)]
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

    def same_launch(name, first, second, tag):
        """A second launch on the same inputs must give the same bits."""
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{name} {tag}: two launches on the same inputs differ")

    def k1_call(g, plain=False):
        """K1 on request g: (img, ox [N], oy [N], win) for one image, or
        (imgs, ox [L, N], oy [L, N], win) for the levels of a pyramid."""
        if isinstance(g[0], tuple):
            return (k1.gather_windows_levels_plain(*g) if plain
                    else k1.gather_windows_levels(*g))
        return k1.gather_windows_plain(*g) if plain else k1.gather_windows(*g)

    def k1_levels(g):
        """Request g as one (img, ox, oy, win) per image."""
        if isinstance(g[0], tuple):
            return [(img, g[1][li], g[2][li], g[3]) for li, img in enumerate(g[0])]
        return [g]

    def k1_off_image(g):
        return [(img, *off_image(ox, oy, *img.shape, win), win) for img, ox, oy, win in
                k1_levels(g)]

    def check_k1(g1, tag, with_library=True):
        err = 0.0
        for g in g1:
            a = k1_call(g)
            err = max(err, float((a - k1_call(g, plain=True)).abs().max()) if a.numel() else 0.0)
            if with_library:
                lib = torch.stack([img.unfold(0, win, 1).unfold(1, win, 1)[oy.long(), ox.long()]
                                   for img, ox, oy, win in k1_levels(g)])
                err = max(err, float((a.reshape(lib.shape) - lib).abs().max()))
        forms = " + ".join(f"{len(g[0])} levels x {g[1].shape[1]} x {g[3]}^2 in one launch"
                           if isinstance(g[0], tuple) else f"{g[1].shape[0]} x {g[3]}^2"
                           for g in g1)
        print(f"K1 gather_windows {tag} ({forms}): max |kernel - plain| = {err} (tolerance 0, "
              f"exact copy)")
        if err != 0.0:
            raise AssertionError("K1 disagrees with its plain version")
        return err

    def check_k3(a3, tag):
        out = k3.mega_gn(*a3)
        same_launch("K3", [out], [k3.mega_gn(*a3)], tag)
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

    def check_k3b(a3, tag):
        """The batched K3 (one launch, a CTA per sequence) against its plain
        version on the same arguments: every sequence's pose within
        TOL_POSE.  Returns (max |R,t diff|, each sequence's plain stats)."""
        out = k3.mega_gn_batch(*a3)
        same_launch("K3 batch", [out], [k3.mega_gn_batch(*a3)], tag)
        stats = []
        ref = k3.mega_gn_batch_plain(*a3, stats=stats)
        S = out.shape[0]
        d = se3.distance(SE3(out[:, :9].reshape(S, 3, 3), out[:, 9:12]),
                         SE3(ref[:, :9].reshape(S, 3, 3), ref[:, 9:12]))
        err = float((out[:, :12] - ref[:, :12]).abs().max())
        print(f"K3 sparse_align_mega, batched, {tag} ({S} sequences in one launch): max pose "
              f"distance {float(d.max()):.3e} (tolerance {TOL_POSE}), max |R,t diff| {err:.3e}, "
              f"max chi2 difference {float((out[:, 12] - ref[:, 12]).abs().max()):.3e}, passes "
              f"per level {[st['passes'] for st in stats]}")
        if not float(d.max()) <= TOL_POSE:
            raise AssertionError("the batched K3 disagrees with its plain version")
        return err, stats

    def check_k4(k4_in, tag):
        a4, proj, inb0, H, W = k4_in
        out = k4.a2d_gn(*a4)
        same_launch("K4", [out], [k4.a2d_gn(*a4)], tag)
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
        same_launch("K5", [out, inl], k5.pose_ba_gn(*a5), tag)
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

    def k4_ops(a):
        """K4's operations on arguments a: per point, each iteration it runs
        before it freezes (the plain version's count) and the final
        residual, each 64 pixels of sample, residual and sums (~15) plus the
        update (~30)."""
        stats = {}
        k4.a2d_gn_plain(*a, stats=stats)
        return int((stats["iterations"] + 1).sum()) * (64 * 15 + 30)

    T_init = SE3.from_params7(T_gt7[0])
    g1, a3, a4, a5 = frame_inputs(state, frames[1], T_init)
    torch.cuda.synchronize()
    e1 = check_k1(g1, "N=200")
    e3, st3 = check_k3(a3, "N=200")
    e4 = check_k4(a4, "N=200")
    e5, st5 = check_k5(a5, "N=200")

    # Times and bounds at the main path's shapes.
    N = px.shape[0]
    k1_ms = sum(_time_kernel(torch, lambda g=g: k1_call(g)) for g in g1)
    k1_plain = sum(_time_host(torch, lambda g=g: k1_call(g, plain=True)) for g in g1)
    # Yardstick: one advanced-indexing gather per image on int64 origins
    # made beforehand.
    g1_lib = [(img, oy.long(), ox.long(), win) for g in g1 for img, ox, oy, win in k1_levels(g)]
    k1_lib = sum(_time_kernel(torch, lambda g=g: g[0].unfold(0, g[3], 1).unfold(1, g[3], 1)
                              [g[1], g[2]]) for g in g1_lib)
    k1_bytes = sum(_gather_bytes(torch, k1_levels(g)) for g in g1)
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
    k4_flops = k4_ops(a4[0])
    report["K4"] = dict(ms=k4_ms, plain=k4_plain, lib=None, err=e4,
                        bound=_bound(k4_bytes, k4_flops))
    k5_ms = _time_kernel(torch, lambda: k5.pose_ba_gn(*a5))
    k5_plain = _time_host(torch, lambda: k5.pose_ba_gn_plain(*a5))
    k5_bytes = N * (12 + 8 + 4) + 48 + N * 4 + 52
    # per point: normal equation ~180 flops; 27 bisection/count passes ~25
    k5_flops = N * (180 * st5["normal_eqs"] + 27 * 25 + 4 * 30)
    report["K5"] = dict(ms=k5_ms, plain=k5_plain, lib=None, err=e5,
                        bound=_bound(k5_bytes, k5_flops))
    print(f"chains at N=200: K3 {sum(st3['passes'])} dependent passes (per level, coarse to "
          f"fine, {st3['passes']}: the frozen Hessian with the first residuals, then one per "
          f"iteration), {k3_ms * 1e3 / sum(st3['passes']):.2f} us per link; K5 "
          f"{_k5_links(st5['normal_eqs'])} dependent block reductions ({st5['normal_eqs']} "
          f"normal equations, 4 reclassification counts, 1 count, 2 x (1 max + 4 grouped "
          f"bisection counts)), {k5_ms * 1e3 / _k5_links(st5['normal_eqs']):.2f} us per link",
          flush=True)
    print("K1 times below are per frame: the sum over its 2 launches (the pyramid's 3 levels x "
          "16^2 in one, 32^2 at K3's pose)")
    for k, r in report.items():
        lib = "null" if r["lib"] is None else f"{r['lib']:.4f}"
        print(f"{k}: kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, library {lib} ms, "
              f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)

    # The same kernels at 512 landmarks (the VO's visible-subset size).
    cam5, px5, depth5, mask5, pts5, patches5, ref_pyr5, frames5, T_gt5 = tr.make_workload(
        K11_FRAMES + 1, dev, n_points=512)
    state5 = tr.make_state(cam5, ref_pyr5, px5, depth5, mask5, pts5, patches5)
    g1_5, a3_5, a4_5, a5_5 = frame_inputs(state5, frames5[1], SE3.from_params7(T_gt5[0]))
    check_k1(g1_5, "N=512")
    _, st3_5 = check_k3(a3_5, "N=512")
    check_k4(a4_5, "N=512")
    _, st5_5 = check_k5(a5_5, "N=512")
    k3_ms_512 = _time_kernel(torch, lambda: k3.mega_gn(*a3_5))
    k5_ms_512 = _time_kernel(torch, lambda: k5.pose_ba_gn(*a5_5))
    print(f"N=512: K3 {k3_ms_512:.4f} ms ({sum(st3_5['passes'])} passes, "
          f"{k3_ms_512 * 1e3 / sum(st3_5['passes']):.2f} us per link), K5 {k5_ms_512:.4f} ms "
          f"({_k5_links(st5_5['normal_eqs'])} reductions, "
          f"{k5_ms_512 * 1e3 / _k5_links(st5_5['normal_eqs']):.2f} us per link)", flush=True)
    # K1 off the image: the zero-padded window at the requested origin, per
    # image and for the pyramid in one launch.
    check_k1([o for g in g1 for o in k1_off_image(g)], "origins off the image",
             with_library=False)
    lv_off = k1_off_image(g1[0])
    check_k1([(tuple(o[0] for o in lv_off), torch.stack([o[1] for o in lv_off]),
               torch.stack([o[2] for o in lv_off]), k3.CWIN)],
             "origins off the image, the pyramid", with_library=False)

    # -- 2b. batch kernels versus plain versions -----------------------------
    print(f"clock: phase 2b starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    def batch_frame_inputs(bst, imgs, T7):
        """Each batch kernel's inputs on one frame of the batch path, from
        that path's own stages: (the stacked K6's arguments, recorded from
        `batched_sparse_align`: every sequence's levels in one launch; the
        same requests as a `gather_windows_grouped` list; the batched K3's
        arguments, recorded after it; K2 args, K4 inputs, K8 args)."""
        cur_pyrs = pyramid.build_pyramid(imgs, L)
        H, W = imgs.shape[1:]
        S = imgs.shape[0]
        with kernels.record_launches() as rec:
            T = bt.batched_sparse_align(bst.ref_pyrs, cur_pyrs, bst.cam, bst.px, bst.depth,
                                        bst.mask, SE3.from_params7(T7), bst.batch_ref)
        names = [f.__name__ for f, _ in rec]
        if names != ["gather_windows_stacked", "mega_gn_batch"]:
            raise AssertionError(f"batched_sparse_align launched {names}")
        a6, a3b = rec[0][1], rec[1][1]
        stacks, xi, yi, win = a6
        g6 = [(stacks[li][s], xi[s, li], yi[s, li], win) for s in range(S) for li in range(L)]
        proj = bt.project_landmarks(bst.cam, bst.pts_w, T)
        a2, xy0, xy0s, inb0 = bt.batched_align2d_inputs(cur_pyrs[0], proj)
        a4b = k4.a2d_args(cur_pyrs[0][0], bst.a2d_prep, xy0s,
                          pregathered=k4.A2DWindows(k1.gather_windows_multi(*a2), a2[2], a2[3]))
        xy, conv, _ = bt.batched_align2d(cur_pyrs[0], proj, bst.a2d_prep)
        a8 = k8.pose_ba_batch_args(*bt.batched_pose_ba_inputs(T, bst.pts_w, xy, conv, bst.mask,
                                                              bst.cam))
        return a6, g6, a3b, a2, (a4b, xy0, inb0, H, W), a8

    def check_k6s(a6, tag):
        """The stacked K6 on the path's own arguments against its plain
        version, then with every level's origins partly off the image."""
        stacks, xi, yi, win = a6
        e = check_exact("K6 gather_windows_stacked", [k1.gather_windows_stacked(*a6)],
                        [k1.gather_windows_stacked_plain(*a6)],
                        f"{tag}, {xi.shape[0]} x {xi.shape[1]} requests")
        xo, yo = xi.clone(), yi.clone()
        for s in range(xi.shape[0]):
            for li, lv in enumerate(stacks):
                xo[s, li], yo[s, li] = off_image(xi[s, li], yi[s, li], *lv.shape[1:], win)
        off = (stacks, xo, yo, win)
        check_exact("K6 gather_windows_stacked", [k1.gather_windows_stacked(*off)],
                    [k1.gather_windows_stacked_plain(*off)], f"{tag}, origins off the image")
        return e

    def check_exact(name, out, ref, tag):
        err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(out, ref))
        print(f"{name} {tag}: max |kernel - plain| = {err} (tolerance 0, exact copy)")
        if err != 0.0:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    def k2_extent(imgs):
        """The (H, W) that bounds K2's images: the stack's, or the table's
        level 0 (the largest level of a pyramid)."""
        return tuple(imgs.shape[1:]) if isinstance(imgs, torch.Tensor) else tuple(imgs[0].shape)

    def k2_stack(levels):
        """The zero-padded [levels, H, W] stack of a pyramid: the formulation
        K2's table replaced on the VO path, built here as a check only."""
        H, W = levels[0].shape
        stack = torch.zeros((len(levels), H, W), dtype=torch.float32, device=dev)
        for l, img in enumerate(levels):
            stack[l, :img.shape[0], :img.shape[1]] = img
        return stack

    def check_k2(a2, tag):
        imgs, idx, ox, oy, win = a2
        H, W = k2_extent(imgs)
        e = check_exact("K2 gather_windows_multi", [k1.gather_windows_multi(*a2)],
                        [k1.gather_windows_multi_plain(*a2)], tag)
        off = (imgs, idx, *off_image(ox, oy, H, W, win), win)
        check_exact("K2 gather_windows_multi", [k1.gather_windows_multi(*off)],
                    [k1.gather_windows_multi_plain(*off)], tag + ", origins off the image")
        return e

    def k2_times(a2, tag):
        """K2's CUDA-event ms, profiler µs per launch, plain and library ms
        and bound on K2's arguments a2.  Library: one unfold-and-index on
        the stack (for a table, on its zero-padded stack, built beforehand
        and left out of its time).  Bound: the image pixels the windows
        cover, each read once, the windows written and an index and two
        origins per window."""
        imgs, idx, ox, oy, win = a2
        stack = imgs if isinstance(imgs, torch.Tensor) else k2_stack(imgs)
        lib = (stack, idx.long(), oy.long(), ox.long())
        n = idx.shape[0]
        images = [imgs[s] for s in range(imgs.shape[0])] if imgs is stack else imgs
        nbytes = 4 * n + _gather_bytes(torch, [(img, ox[idx == s], oy[idx == s], win)
                                               for s, img in enumerate(images)])
        r = dict(ms=_time_kernel(torch, lambda: k1.gather_windows_multi(*a2)),
                 us=_profile_us(torch, lambda: k1.gather_windows_multi(*a2),
                                "gather_windows_multi_kernel"),
                 plain=_time_host(torch, lambda: k1.gather_windows_multi_plain(*a2)),
                 lib=_time_kernel(torch, lambda: lib[0].unfold(1, win, 1).unfold(2, win, 1)
                                  [lib[1], lib[2], lib[3]]),
                 bound=_bound(nbytes, 0.0))
        print(f"K2 {tag}, {n} windows of {win}^2: kernel {r['ms']:.4f} ms, profiler "
              f"{_nm(r['us'], '.2f', ' us')} per launch, plain {r['plain']:.4f} ms, library {r['lib']:.4f} "
              f"ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]}: {nbytes} B, of which "
              f"{nbytes - n * (win * win * 4 + 12)} B of image pixels the windows cover, "
              f"against {n * win * win * 4} B read if every window read its own)", flush=True)
        return r

    def check_k6(g6, a2, tag):
        """K6 on the batched frame's request list (every sequence's levels),
        in one launch, then on the same list with sequence 0's level 0
        named again for the a2d 32^2 cache and every origin list partly off
        the image."""
        n0 = k1.gather_windows_grouped.launches
        e = check_exact("K6 gather_windows_grouped", k1.gather_windows_grouped(g6),
                        k1.gather_windows_grouped_plain(g6),
                        f"{tag}, {len(g6)} requests in one launch")
        if k1.gather_windows_grouped.launches != n0 + 1:
            raise AssertionError("K6 took more than one launch for a batched frame")
        img0 = g6[0][0]
        twice = [(img, *off_image(ox, oy, *img.shape, win), win) for img, ox, oy, win in g6]
        twice.append((img0, *off_image(a2[2][:200], a2[3][:200], *img0.shape, k1.CACHE_WIN),
                      k1.CACHE_WIN))
        check_exact("K6 gather_windows_grouped", k1.gather_windows_grouped(twice),
                    k1.gather_windows_grouped_plain(twice),
                    f"{tag}, {len(twice)} requests, level 0 named twice, origins off the image")
        return e

    def check_k8(a8, tag, flat=False):
        """K8 against its plain version: every sequence's pose within
        TOL_POSE and its inlier set agreeing.  With `flat` (relocalization
        candidates, some matched by a handful of points), a sequence may
        instead lie within TOL_POSE_FLAT when its final chi2 equals the
        plain version's within TOL_REL: the two stop at different points of
        an objective that float32 cannot resolve along some direction."""
        out, inl = k8.pose_ba_batch_gn(*a8)
        same_launch("K8", [out, inl], k8.pose_ba_batch_gn(*a8), tag)
        stats = {}
        ref, inl_ref = k8.pose_ba_batch_gn_plain(*a8, stats=stats)
        S = out.shape[0]
        ds = [float(se3.distance(SE3(*_pose_of(out[s])), SE3(*_pose_of(ref[s]))))
              for s in range(S)]
        d = max(ds)
        flat_s = [s for s in range(S) if flat and TOL_POSE < ds[s] <= TOL_POSE_FLAT
                  and _rel(out[s, 12], ref[s, 12]) <= TOL_REL]
        err = float((out[:, :12] - ref[:, :12]).abs().max())
        agree = float(((inl > 0.5) == (inl_ref > 0.5)).float().mean(dim=1).min())
        print(f"K8 pose_ba_fused_batch {tag}: max pose distance {d:.3e} (tolerance {TOL_POSE}"
              + (f"; flat: {[(s, round(ds[s], 7), _rel(out[s, 12], ref[s, 12])) for s in flat_s]}"
                 f" within {TOL_POSE_FLAT} at chi2 within {TOL_REL}" if flat else "")
              + f"), per sequence {[round(x, 7) for x in ds]}, max |R,t diff| {err:.3e}, inliers "
              f"per sequence {(inl > 0.5).sum(dim=1).tolist()} vs "
              f"{(inl_ref > 0.5).sum(dim=1).tolist()}, least set agreement {agree:.4f} (need "
              f"{MIN_INLIER_AGREE}), normal equations {stats['normal_eqs']}")
        if not (all(x <= TOL_POSE or s in flat_s for s, x in enumerate(ds))
                and agree >= MIN_INLIER_AGREE):
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
    a6, g6, a3b, a2, a4b, a8 = batch_frame_inputs(bstate, frames_b[1], T7_1)
    tag = f"S={S_BATCH}"
    e6 = max(check_k6s(a6, tag), check_k6(g6, a2, tag))
    check_k3b(a3b, f"{tag}, K6's windows")
    e2 = check_k2(a2, tag)
    check_k4(a4b, f"{tag}, {S_BATCH * N} rows on K2's windows")
    e8, st8 = check_k8(a8, tag)

    Nb = S_BATCH * N
    report["K2"] = dict(k2_times(a2, tag), err=e2)
    def k6_times(g6, S):
        """K6 per batched frame (one launch of all S x L requests), the S
        launches of L requests each that the path made before, and the
        bound of the frame's windows."""
        one = _time_kernel(torch, lambda: k1.gather_windows_grouped(g6))
        per_seq = [g6[s * L:(s + 1) * L] for s in range(S)]
        seq = _time_kernel(torch, lambda: [k1.gather_windows_grouped(g) for g in per_seq])
        bound = _bound(_gather_bytes(torch, g6), 0.0)
        print(f"K6 S={S}, per batched frame: one launch of {len(g6)} requests {one:.4f} ms; "
              f"{S} launches of {L} requests (the per-sequence form) {seq:.4f} ms; bound "
              f"{bound[0]:.6f} ms ({bound[1]})", flush=True)
        return one, bound

    k6_ms, k6_bound = k6_times(g6, S_BATCH)
    k6_plain = _time_host(torch, lambda: k1.gather_windows_grouped_plain(g6))
    g6_lib = [(img, oy.long(), ox.long(), win) for img, ox, oy, win in g6]
    k6_lib = sum(_time_kernel(torch, lambda g=g: g[0].unfold(0, g[3], 1).unfold(1, g[3], 1)
                              [g[1], g[2]]) for g in g6_lib)
    report["K6"] = dict(ms=k6_ms, plain=k6_plain, lib=k6_lib, err=e6, bound=k6_bound)
    k8_ms = _time_kernel(torch, lambda: k8.pose_ba_batch_gn(*a8))
    k8_plain = _time_host(torch, lambda: k8.pose_ba_batch_gn_plain(*a8))
    k8_bytes = S_BATCH * (N * (12 + 8 + 4) + 48 + N * 4 + 52)
    k8_flops = sum(N * (180 * ne + 27 * 25 + 4 * 30) for ne in st8["normal_eqs"])
    report["K8"] = dict(ms=k8_ms, plain=k8_plain, lib=None, err=e8,
                        bound=_bound(k8_bytes, k8_flops))
    k4b_ms = _time_kernel(torch, lambda: k4.a2d_gn(*a4b[0]))
    k3b_ms = _time_kernel(torch, lambda: k3.mega_gn_batch(*a3b))
    for k in ("K2", "K6", "K8"):
        r = report[k]
        lib = "null" if r["lib"] is None else f"{r['lib']:.4f}"
        print(f"{k} ({tag}): kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, library {lib} "
              f"ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)
    print(f"K8 is bound by its chain of {_k5_links(max(st8['normal_eqs']))} dependent block "
          f"reductions per sequence, not by bytes or operations; K4 over {Nb} rows "
          f"{k4b_ms:.4f} ms; K3 on K6's windows "
          f"{k3b_ms:.4f} ms (one launch of {S_BATCH} sequences)", flush=True)

    # The same kernels at 16 sequences.
    cam16, px16, depth16, mask16, ptsw16, patches16, ref_pyrs16, frames16, T_gt16 = \
        bm.make_batch_workload(S_BIG, 2, dev)
    bst16 = bm.make_batch_state(cam16, ref_pyrs16, px16, depth16, mask16, ptsw16, patches16)
    a6_16, g6_16, _, a2_16, _, a8_16 = batch_frame_inputs(bst16, frames16[1],
                                                          T_gt16[0][None].repeat(S_BIG, 1))
    tag16 = f"S={S_BIG}"
    check_k6s(a6_16, tag16)
    check_k6(g6_16, a2_16, tag16)
    k6_times(g6_16, S_BIG)
    check_k2(a2_16, tag16)
    check_k8(a8_16, tag16)
    k2_times(a2_16, tag16)
    print(f"S={S_BIG}: K8 {_time_kernel(torch, lambda: k8.pose_ba_batch_gn(*a8_16)):.4f} ms",
          flush=True)
    del frames16, bst16, a6_16, g6_16, a8_16

    # -- 2c. K10 versus its plain version ------------------------------------
    print(f"clock: phase 2c starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
    nbrs2 = all_feat[:2 * vo_opts.map_F]          # slot 0's rows, then slot 1's (random)
    k10_cases = [
        (f"{Fn_vo} x {2 * vo_opts.map_F} (triangulation, both neighbours stacked: frame-0 "
         f"descriptors and random words)", feat0[:Fn_vo], nbrs2),
        (f"{vo_opts.map_F} x {vo_opts.map_L} (fusion, frame-0 map)", feat0, m0.pt_desc),
        (f"{all_feat.shape[0]} x {vo_opts.map_L} (all map features x all landmark rows)",
         all_feat, all_pt),
        (f"{Fn_vo} x {vo_opts.map_F} (triangulation against one neighbour)", feat0[:Fn_vo],
         feat0),
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
    # one triangulation matrix (both neighbours) and one fusion matrix.  The
    # `kernels` line carries the per-keyframe sums (as K1's row carries a
    # frame's launches).
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
    for tag, a, b in k10_cases[:4]:
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
    report["K10"] = dict(ms=tri[0] + fus[0], plain=tri[1] + fus[1], lib=tri[3] + fus[3],
                         err=e10, bound=(tri[2][0] + fus[2][0], fus[2][1]))
    r = report["K10"]
    print(f"K10 per keyframe ({Fn_vo}x{2 * vo_opts.map_F} + {vo_opts.map_F}x{vo_opts.map_L}, the "
          f"sums of the launches above): kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, "
          f"library {r['lib']:.4f} ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]})",
          flush=True)

    # -- 2d. the VO path's kernels on the inputs that path gives them ---------
    print(f"clock: phase 2d starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
    want_rec = (["gather_windows_levels"] * 2 + ["mega_gn", "gather_windows_multi", "a2d_gn",
                                                 "pose_ba_gn"] + ["distance_matrix"] * 2)
    if [fn.__name__ for fn, _ in rec] != want_rec:
        raise AssertionError(f"VO frame 10 launched {[fn.__name__ for fn, _ in rec]}, "
                             f"expected {want_rec}")

    def recorded(fn):
        return [args for f, args in rec if f is fn]

    g1v, (a3v,), (a2v,) = recorded(k1.gather_windows_levels), recorded(k3.mega_gn), \
        recorded(k1.gather_windows_multi)
    (a4v,), (a5v,), d10v = recorded(k4.a2d_gn), recorded(k5.pose_ba_gn), \
        recorded(k10.distance_matrix)
    if [(len(g[0]), g[3]) for g in g1v] != [(L, ref_win), (L, k3.CWIN)]:
        raise AssertionError(f"VO frame 10: K1 levels and windows "
                             f"{[(len(g[0]), g[3]) for g in g1v]}")
    n_sel = g1v[0][1].shape[1]
    tagv = (f"VO frame 10, N={n_sel} ({int((a3v[4][0] < 0.5).sum())} masked, max |J| "
            f"{float(a3v[2].abs().max()):.1e})")
    check_k1(g1v, tagv + f", {ref_win}^2 on the previous frame's pyramid and {k3.CWIN}^2 on "
             f"this one's")
    _, st3v = check_k3(a3v, tagv)
    tagv = f"VO frame 10, N={a2v[1].shape[0]} ({int(a5v[2].sum())} matched)"
    check_k2(a2v, tagv + f", a table of the {len(a2v[0])} levels")
    # The table route against the stack formulation it replaced, on the
    # recorded arguments, and both ways on a frame whose coarsest level is
    # smaller than the window (61x83: level 2 is 16x21), with the VO's own
    # origins there (negative on level 2) and origins off the image.
    if not torch.equal(k1.gather_windows_multi(*a2v),
                       k1.gather_windows_multi(k2_stack(a2v[0]), *a2v[1:])):
        raise AssertionError("K2 on the VO's levels differs from K2 on their stack")
    print(f"K2 {tagv}: the table of levels equals the zero-padded stack, bit for bit",
          flush=True)
    tiny = pyramid.build_pyramid(torch.rand((61, 83), generator=gen, device=dev) * 255, L)
    n_t = 512
    lvl_t = torch.randint(0, L, (n_t,), generator=gen, device=dev, dtype=torch.int32)
    sc_t = 2.0 ** lvl_t.float()
    c_t = torch.stack([torch.rand(n_t, generator=gen, device=dev) * 93 - 5,
                       torch.rand(n_t, generator=gen, device=dev) * 71 - 5], dim=1) / sc_t[:, None]
    ox_t, oy_t = k4.a2d_window_origins(c_t, 61 / sc_t, 83 / sc_t)
    a2t = (tuple(tiny), lvl_t, ox_t, oy_t, k1.CACHE_WIN)
    tag_t = (f"a 61x83 frame, levels {[tuple(t.shape) for t in tiny]}, {n_t} windows with the "
             f"VO's origins ({int((ox_t < 0).sum())} negative)")
    check_k2(a2t, tag_t + ", table")
    check_k2((k2_stack(tiny), *a2t[1:]), tag_t + ", stack")
    if not torch.equal(k1.gather_windows_multi(*a2t),
                       k1.gather_windows_multi(k2_stack(tiny), *a2t[1:])):
        raise AssertionError("K2 on a 61x83 frame's levels differs from K2 on their stack")
    # Substituted inits (PATCH + 2, PATCH + 2) are the out-of-bounds ones,
    # which `align2d` never accepts; every other init is the path's center.
    xy0v = a4v[7]
    k4v_in = (a4v, xy0v, (xy0v != k1.PATCH + 2.0).any(dim=1), *vframes.shape[1:])
    check_k4(k4v_in, tagv)
    _, st5v = check_k5(a5v, tagv)
    for a, b in d10v:
        check_exact("K10 hamming distance_matrix", [k10.distance_matrix(a, b)],
                    [k10.distance_matrix_plain(a, b)],
                    f"VO frame 10 keyframe cycle, {a.shape[0]} x {b.shape[0]}")
    k1v_ms = sum(_time_kernel(torch, lambda g=g: k1_call(g)) for g in g1v)
    k1v_plain = sum(_time_host(torch, lambda g=g: k1_call(g, plain=True)) for g in g1v)
    k1v_bound = _bound(sum(_gather_bytes(torch, k1_levels(g)) for g in g1v), 0.0)
    k3v_ms = _time_kernel(torch, lambda: k3.mega_gn(*a3v))
    k5v_ms = _time_kernel(torch, lambda: k5.pose_ba_gn(*a5v))
    print(f"VO frame 10: K1 per frame (sum over its 2 launches: {L} levels x {ref_win}^2, {L} x "
          f"{k3.CWIN}^2, {n_sel} windows each) kernel {k1v_ms:.4f} ms, plain {k1v_plain:.4f} ms, "
          f"bound {k1v_bound[0]:.6f} ms ({k1v_bound[1]}); K3 {k3v_ms:.4f} ms "
          f"({sum(st3v['passes'])} passes, {k3v_ms * 1e3 / sum(st3v['passes']):.2f} us per link), "
          f"K4 "
          f"{_time_kernel(torch, lambda: k4.a2d_gn(*a4v)):.4f} ms, K5 {k5v_ms:.4f} ms "
          f"({_k5_links(st5v['normal_eqs'])} reductions, "
          f"{k5v_ms * 1e3 / _k5_links(st5v['normal_eqs']):.2f} us per link)", flush=True)
    # The iterations K4's points run before they freeze on path 1's
    # (N=200), the VO's (512 rows) and the batch's (1600 rows) arguments:
    # each warp leaves at its point's count, and the slowest sets the time.
    k4_sets = (("path 1 frame 1", a4), ("VO frame 10", k4v_in), ("S=8 batch frame 1", a4b))
    for name, k4_in in k4_sets:
        stats = {}
        k4.a2d_gn_plain(*k4_in[0], stats=stats)
        its = stats["iterations"]
        print(f"K4 {name}, {its.shape[0]} rows: iterations up to the one that freezes a point "
              f"(10: froze at the last or never), largest "
              f"{int(its.max())}, mean {float(its.float().mean()):.2f}, counts by iterations "
              f"{torch.bincount(its, minlength=11).tolist()}", flush=True)
    report["K2vo"] = k2_times(a2v, "VO frame 10, a table of 3 levels")
    del st9, rec, g1v, a3v, a2v, a4v, a5v, d10v, a2_16

    # -- 2e. K9 on the inputs main path 4 gives it under variants 1 and 2 -----
    print(f"clock: phase 2e starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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

    def check_k9(args, v2, tag):
        """K9 v1 or v2 against its plain version (pose, chi2, and H: v1's at
        the last accepted state, v2's H0); returns (max |R,t diff|, plain
        passes, kernel output)."""
        stats = {}
        fn, plain = (k9.level_gn_v2, k9.level_gn_v2_plain) if v2 else \
            (k9.level_gn, k9.level_gn_plain)
        name = "K9 level_align_fused_v2" if v2 else "K9 level_align_fused (v1)"
        out, ref = fn(*args), plain(*args, stats=stats)
        same_launch(name, [out], [fn(*args)], tag)
        h_err = float((out[13:] - ref[13:]).abs().max() / ref[13:].abs().max().clamp(min=1e-30))
        d = float(se3.distance(SE3(*_pose_of(out)), SE3(*_pose_of(ref))))
        err = float((out[:12] - ref[:12]).abs().max())
        c_err = abs(float(out[12]) - float(ref[12])) / max(abs(float(ref[12])), 1e-6)
        print(f"{name} {tag}: pose distance {d:.3e} (tolerance {TOL_POSE}), max |R,t diff| "
              f"{err:.3e}, chi2 {float(out[12]):.4f} vs {float(ref[12]):.4f} (relative "
              f"{c_err:.1e}, tolerance {TOL_REL}), {'H0' if v2 else 'H'} relative {h_err:.1e}, "
              f"passes {stats['passes']}")
        if not (d <= TOL_POSE and c_err <= TOL_REL and h_err <= TOL_REL):
            raise AssertionError(f"{name} disagrees with its plain version")
        return err, stats["passes"], out

    def k9_bound(args, passes, v1):
        """Bytes: windows, patches, Jacobians, points, masks, origins, pose
        read once, the output written once; operations: per point and
        residual pass the projection (~40) and 16 pixels of bilinear sample,
        residual, gradient and chi2 (~22), plus the 21 Hessian products
        (~42 per pixel) in every pass of v1 and the first of v2."""
        n = args[0].shape[0]
        nbytes = n * (16 * 16 + 16 + 96 + 3 + 1 + 2) * 4 + 12 * 4 + 34 * 4
        ops = n * ((40 + 16 * 22) * passes + 16 * 42 * (passes if v1 else 1))
        return _bound(nbytes, ops)

    def k9_split(a, reps=REPS):
        """K9 v1's pass split: medians over reps launches of the µs per pass
        (CTA 0's SM clock between its marks, at the global timer's rate over
        the kernel) in pixel steps, block reduction, cluster exchange and
        solve + retraction, then the kernel's body on the global timer (µs)
        and its passes."""
        stamps = torch.zeros(k9.V1_STAMPS, dtype=torch.int64, device=dev)
        rows = []
        for _ in range(reps):
            stamps.zero_()
            k9.level_gn(*a, stamps=stamps)
            st_ = stamps.tolist()
            rate = (st_[3] - st_[1]) / max(st_[2] - st_[0], 1)      # cycles per ns
            n_pass = sum(1 for p in range(k9.MAX_ITER + 1) if st_[7 + 4 * p])
            parts, prev = [0.0] * 4, st_[1]
            for p in range(n_pass):
                m = st_[4 + 4 * p:8 + 4 * p]
                for k in range(4):
                    parts[k] += m[k] - (prev if k == 0 else m[k - 1])
                prev = m[3]
            rows.append([x / rate / 1e3 / n_pass for x in parts]
                        + [(st_[2] - st_[0]) / 1e3, n_pass])
        return [statistics.median(r[k] for r in rows) for k in range(6)]

    e2_report = {}
    for variant, fn in ((1, k9.level_gn), (2, k9.level_gn_v2)):
        sparse_align.FUSED_VARIANT = variant
        sysm = System(camera=cam_m, options=mw.mono_options(), device=dev)
        for k in range(E2_FRAME):
            sysm.track_monocular(frames_m[k], float(k))
        if sysm.status is not vo_mod.Status.GOOD:
            raise AssertionError(f"variant {variant}: not GOOD by frame {E2_FRAME}")
        with kernels.record_launches() as rec:
            sysm.track_monocular(frames_m[E2_FRAME], float(E2_FRAME))
        names = [f.__name__ for f, _ in rec]
        want_rec = (["gather_windows_levels"] + ["gather_windows", fn.__name__] * L
                    + ["gather_windows_multi", "a2d_gn", "pose_ba_gn"])
        if names != want_rec:
            raise AssertionError(f"variant {variant}, frame {E2_FRAME} launched {names}, "
                                 f"expected {want_rec}")
        k9_calls = [a for f, a in rec if f is fn]
        level_imgs = [a[0] for f, a in rec[1:1 + 2 * L:2]]
        if [a[-1] for a in k9_calls] != list(range(L - 1, -1, -1)):
            raise AssertionError(f"K9 levels {[a[-1] for a in k9_calls]}")
        errs, times, plains, bounds, passes = [], [], [], [], []
        plain_fn = k9.level_gn_plain if variant == 1 else k9.level_gn_v2_plain
        for a in k9_calls:
            tag = (f"variant {variant}, frame {E2_FRAME}, level {a[12]}, N={a[0].shape[0]} "
                   f"({int((a[4] < 0.5).sum())} invisible)")
            e, p, _ = check_k9(a, variant == 2, tag)
            errs.append(e)
            passes.append(p)
            times.append(_time_kernel(torch, lambda a=a: fn(*a)))
            plains.append(_time_host(torch, lambda a=a: plain_fn(*a)))
            bounds.append(k9_bound(a, p, variant == 1))
        # Edge cases on level 0's arguments.
        a0 = k9_calls[-1]
        zero_vis = a0[:4] + (torch.zeros_like(a0[4]),) + a0[5:]
        _, _, out = check_k9(zero_vis, variant == 2, f"variant {variant}, level 0, no usable "
                             f"point")
        if not (torch.equal(out[:12], a0[7]) and float(out[12]) == 0.0):
            raise AssertionError("K9 moved the pose on a level with no usable point")
        lr0 = sparse_align.LevelRef(vis=a0[4] > 0.5, ref_patch=a0[1], J=a0[2])
        R0, t0_ = a0[7][:9].reshape(3, 3), a0[7][9:]
        side = torch.tensor([0.2, 0.15, 0.0], device=dev)
        bargs = k9.level_args(level_imgs[-1], lr0, a0[3], R0, t0_ + side, a0[8], 0, a0[9])
        Hl, Wl = level_imgs[-1].shape
        clamped = ((bargs[5] == 0) | (bargs[5] == Wl - k9.CWIN) | (bargs[6] == 0)
                   | (bargs[6] == Hl - k9.CWIN)) & lr0.vis
        if int(clamped.sum()) == 0:
            raise AssertionError("the shifted pose clamps no window")
        check_k9(bargs, variant == 2, f"variant {variant}, level 0, init pose shifted by "
                 f"{side.tolist()}: {int(clamped.sum())} visible points' windows clamped")
        key = "K9v1" if variant == 1 else "K9v2"
        b_ms = sum(b[0] for b in bounds)
        report[key] = dict(ms=sum(times), plain=sum(plains), lib=None, err=max(errs),
                           bound=(b_ms, bounds[-1][1]))
        e2_report[key] = dict(times=times, plains=plains, bounds=bounds, passes=passes)
        if variant == 1:
            # The cluster and the split of a pass, per level, beside the
            # CUDA-event interval of one launch.
            splits = []
            for a, t_ms in zip(k9_calls, times):
                part = kernels.cluster_partition(a[0].shape[0], k9.POINTS_PER_CTA)
                pix, red_, clu, sol, body, n_pass = k9_split(a)
                splits.append((part, pix, red_, clu, sol, body, n_pass))
                print(f"K9v1 level {a[12]}: a cluster of {part.cluster} CTAs x "
                      f"{k9.CTA_THREADS} threads, {part.per_cta} points per CTA; per pass "
                      f"(medians of {REPS} launches, CTA 0) pixel steps {pix:.2f} us, block "
                      f"reduction {red_:.2f}, cluster exchange {clu:.2f}, solve and retraction "
                      f"{sol:.2f}; {int(n_pass)} passes, body {body:.2f} us on the global timer, "
                      f"CUDA-event interval {t_ms * 1e3:.2f} us", flush=True)
            e2_report[key]["splits"] = splits
        parts = [kernels.cluster_partition(a[0].shape[0], k9.POINTS_PER_CTA) for a in k9_calls]
        print(f"{key} per launch (levels 2, 1, 0; clusters of "
              f"{[p.cluster for p in parts]} CTAs x {k9.CTA_THREADS} threads): kernel "
              f"{[round(t, 4) for t in times]} ms, plain {[round(t, 3) for t in plains]} ms, "
              f"bound {[f'{b[0]:.6f} ({b[1]})' for b in bounds]} ms, passes {passes}; per "
              f"frame (3 launches) kernel {sum(times):.4f} ms, plain {sum(plains):.3f} ms, "
              f"bound {b_ms:.6f} ms; library null (PyTorch has no single call for it)",
              flush=True)
        del sysm, rec, k9_calls
    sparse_align.FUSED_VARIANT = 3

    # -- 2f. K11 on the inputs main path 5 gives it ----------------------------
    print(f"clock: phase 2f starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # Frame 1 of path 5 (`fused_track_step` from frame 0's ground truth, as
    # 2a's frame) with every launch recorded: K1 x 2 (the three sparse levels
    # in one, the align2d cache), then K11, whose arguments are replayed against its
    # plain version; then 512 landmarks, ten masked landmarks, and no usable
    # sparse point (H = 0, b = 0: stage 1 must return the init pose).
    def check_k11(a11, tag):
        """K11 against its plain version; returns (max |R,t diff|, plain
        stats, kernel outputs)."""
        out, xy, per = k11.track_gn(*a11)
        same_launch("K11", [out, xy, per], k11.track_gn(*a11), tag)
        stats = {}
        ref, xy_r, per_r = k11.track_gn_plain(*a11, stats=stats)
        d = float(se3.distance(SE3(*_pose_of(out)), SE3(*_pose_of(ref))))
        d_sp = float(se3.distance(SE3(*_pose_of(out[15:])), SE3(*_pose_of(ref[15:]))))
        conv, conv_r = per[1] > 0.5, per_r[1] > 0.5
        agree = float((conv == conv_r).float().mean())
        both = conv & conv_r
        dxy = torch.linalg.norm(xy[both] - xy_r[both], dim=1)
        err = float(dxy.max()) if dxy.numel() else 0.0
        close = float((dxy <= TOL_XY).float().mean()) if dxy.numel() else 1.0
        inl_agree = float(((per[2] > 0.5) == (per_r[2] > 0.5)).float().mean())
        # The BA chi2 twice: against the plain chain's (TOL_BA_CHAIN), and,
        # for stage 3 alone, against the plain BA on the kernel's own
        # stage-2 output from the kernel's stage-1 pose (TOL_REL).
        chain = _rel(out[13], ref[13])
        ba_own = float(k5.pose_ba_gn_plain(
            a11[19], xy, per[1] * a11[20], out[15:27].contiguous(), a11[8], a11[26], a11[24],
            a11[25], k11.BA_EPS)[0][12])
        c_err = max(_rel(out[12], ref[12]), _rel(out[13], ba_own))
        print(f"K11 track_step_fused {tag}: pose distance {d:.3e} (after stage 1 {d_sp:.3e}; "
              f"tolerance {TOL_POSE}), chi2 sparse {float(out[12]):.4f} vs {float(ref[12]):.4f}, "
              f"BA {float(out[13]):.4f} vs the plain chain's {float(ref[13]):.4f} (relative "
              f"{chain:.1e}, tolerance {TOL_BA_CHAIN}) and vs the plain BA on the kernel's "
              f"stage 2 {ba_own:.4f} (sparse and stage-3 chi2 relative {c_err:.1e}, "
              f"tolerance {TOL_REL}); align2d max |xy diff| {err:.3e} px on {int(both.sum())} "
              f"points both accept, {close:.4f} within {TOL_XY} px (need {MIN_MASK_AGREE}), all "
              f"within {TOL_XY_ALL}, converged masks agree {agree:.4f}; inliers "
              f"{int(out[14])} vs {int(ref[14])}, sets agree {inl_agree:.4f} (need "
              f"{MIN_INLIER_AGREE}); passes per level {stats['passes']}, normal equations "
              f"{stats['normal_eqs']}", flush=True)
        if not (d <= TOL_POSE and d_sp <= TOL_POSE and c_err <= TOL_REL
                and chain <= TOL_BA_CHAIN and err <= TOL_XY_ALL
                and close >= MIN_MASK_AGREE and agree >= MIN_MASK_AGREE
                and inl_agree >= MIN_INLIER_AGREE and float(out[14]) == float(per[2].sum())):
            raise AssertionError("K11 disagrees with its plain version")
        return float((out[:12] - ref[:12]).abs().max()), stats, (out, xy, per)

    def k11_bound(a11, stats):
        """Bytes: K3's inputs, the map points' windows, patches, gradients,
        inverses, origins, points and mask read once, the outputs written
        once; operations: K3's passes, 11 align2d iterations of 64 pixels
        per point, K5's normal equations and bisection counts."""
        L_, N1 = a11[4].shape
        N2 = a11[19].shape[0]
        nbytes = (L_ * N1 * (256 + 16 + 96 + 1 + 2) * 4 + N1 * 12 + 48
                  + N2 * (1024 + 3 * 64 + 9 + 2 + 3 + 1) * 4 + 27 * 4 + N2 * 5 * 4)
        flops = (sum(N1 * (700 + 400 * p) for p in stats["passes"])
                 + N2 * 11 * (64 * 15 + 30)
                 + N2 * (180 * stats["normal_eqs"] + 27 * 25 + 4 * 30))
        return _bound(nbytes, flops)

    def record_k11(st, img, T_init7):
        with kernels.record_launches() as rec:
            tr.fused_track_step(st, T_init7, img)
        names = [f.__name__ for f, _ in rec]
        if names != ["gather_windows_levels", "gather_windows", "track_gn"]:
            raise AssertionError(f"fused_track_step launched {names}")
        return rec[-1][1]

    a11 = record_k11(state, frames[1], T_gt7[0])
    a11_5 = record_k11(state5, frames5[1], T_gt5[0])
    e11, st11, _ = check_k11(a11, "path 5 frame 1, N=200")
    _, st11_5, _ = check_k11(a11_5, "path 5 frame 1, N=512")
    # The readings behind TOL_BA_CHAIN: K11's BA chi2 against the plain
    # chain's on frames 1..K11_FRAMES of path 5 (each its own noise seed)
    # at both sizes, and two controls on the same inputs, the plain chain
    # with its stage-2 output or stage 3's points rounded to float16.  The
    # tolerance must pass every reading and fail every control.
    gaps, ctrl = {}, {"stage 2 in float16": [], "stage 3 points in float16": []}
    for n_tag, st_k, fr_k, T_k in (("N=200", state, frames, T_gt7),
                                   ("N=512", state5, frames5, T_gt5)):
        gaps[n_tag] = []
        for i in range(1, K11_FRAMES + 1):
            a = record_k11(st_k, fr_k[i], T_k[i - 1])
            out, _, _ = k11.track_gn(*a)
            ref, xy_r, per_r = k11.track_gn_plain(*a)
            gaps[n_tag].append(_rel(out[13], ref[13]))
            ba_args = (per_r[1] * a[20], ref[15:27].contiguous(), a[8], a[26], a[24], a[25],
                       k11.BA_EPS)
            for name, pts_c, xy_c in (("stage 2 in float16", a[19], xy_r.half().float()),
                                      ("stage 3 points in float16", a[19].half().float(),
                                       xy_r)):
                ctrl[name].append(_rel(k5.pose_ba_gn_plain(pts_c, xy_c, *ba_args)[0][12],
                                       ref[13]))
    worst = max(max(g) for g in gaps.values())
    least = min(min(c) for c in ctrl.values())
    for n_tag, g in gaps.items():
        print(f"K11 BA chi2 against the plain chain, {n_tag}, frames 1-{K11_FRAMES}: relative "
              f"{[f'{v:.1e}' for v in g]}, largest {max(g):.3e}", flush=True)
    for name, c in ctrl.items():
        print(f"K11 BA chi2 control, the plain chain with {name}: relative "
              f"{[f'{v:.1e}' for v in c]}, least {min(c):.3e}", flush=True)
    print(f"K11 BA chi2 tolerance {TOL_BA_CHAIN}: largest reading {worst:.3e}, least control "
          f"{least:.3e}", flush=True)
    if not worst <= TOL_BA_CHAIN < least:
        raise AssertionError("TOL_BA_CHAIN does not separate K11's readings from the controls")
    masked = a11[20].clone()
    masked[:10] = 0.0
    _, _, (_, _, per_m) = check_k11(a11[:20] + (masked,) + a11[21:],
                                    "N=200, landmarks 0-9 masked")
    if bool((per_m[1:, :10] > 0.5).any()):
        raise AssertionError("K11 accepted a masked landmark")
    a11_z = a11[:4] + (torch.zeros_like(a11[4]),) + a11[5:]
    _, _, (out_z, _, _) = check_k11(a11_z, "N=200, no usable sparse point")
    if not (torch.equal(out_z[15:27], a11[7]) and float(out_z[12]) == 0.0):
        raise AssertionError("K11's stage 1 moved the pose with no usable point")
    # The partition over the cluster; the redesign's two bit-equalities
    # (stage 1 is K3's code on K3's block, stage 3 K5's code, whose extra
    # warps add +0 partials, so on the same inputs they give K3's and K5's
    # bits); the split by stage beside K3 and K5 alone.
    def k11_split(a, reps=REPS):
        """Medians over reps launches of CTA 0's stage times (µs: SM clock
        between marks at the global timer's rate over the kernel) and of
        the kernel's body on the global timer."""
        stamps = torch.zeros(10, dtype=torch.int64, device=dev)
        rows = []
        for _ in range(reps):
            k11.track_gn(*a, stamps=stamps)
            c, g = stamps[0::2].tolist(), stamps[1::2].tolist()
            rate = (c[4] - c[0]) / max(g[4] - g[0], 1)          # cycles per ns
            rows.append([(c[i + 1] - c[i]) / rate / 1e3 for i in range(4)]
                        + [(g[4] - g[0]) / 1e3])
        return [statistics.median(r[k] for r in rows) for k in range(5)]

    for n_tag, a in (("N=200", a11), ("N=512", a11_5)):
        part = k11.track_partition(a[19].shape[0])
        out_a, xy_a, per_a = k11.track_gn(*a)
        out3 = k3.mega_gn(*a[:12])
        k5_args = (a[19], xy_a, per_a[1] > 0.5, out_a[15:27].contiguous(), a[8], a[26], a[24],
                   a[25], k11.BA_EPS)
        out5, inl5 = k5.pose_ba_gn(*k5_args)
        same1 = torch.equal(out_a[15:27], out3[:12]) and torch.equal(out_a[12], out3[12])
        same3 = (torch.equal(out_a[:12], out5[:12]) and torch.equal(out_a[13], out5[12])
                 and torch.equal(per_a[2], inl5))
        print(f"K11 {n_tag}: a cluster of {part.cluster} CTAs x {k11.THREADS} threads, "
              f"{part.per_cta} map points per CTA, {smem_static['track_fused_kernel']} bytes of "
              f"static shared memory (no dynamic); path 5 frame 1: stage 1 "
              f"{'equals' if same1 else 'DIFFERS FROM'} K3 on the same arguments, stage 3 "
              f"{'equals' if same3 else 'DIFFERS FROM'} K5 on K11's own stage-2 output from "
              f"its stage-1 pose (torch.equal)", flush=True)
        if not (same1 and same3):
            raise AssertionError(f"K11 {n_tag}: stage 1 is not K3's bits or stage 3 not K5's")
        ms = _time_kernel(torch, lambda: k11.track_gn(*a))
        k3_alone = _time_kernel(torch, lambda: k3.mega_gn(*a[:12]))
        k5_alone = _time_kernel(torch, lambda: k5.pose_ba_gn(*k5_args))
        s1, s2own, s2wait, s3, body = k11_split(a)
        print(f"K11 {n_tag} split by stage (CTA 0, medians of {REPS} launches): stage 1 "
              f"{s1:.2f} us (K3 alone on the same arguments {k3_alone * 1e3:.2f}), stage 2 "
              f"{s2own + s2wait:.2f} us (its own points {s2own:.2f}, then waiting at the "
              f"cluster barrier {s2wait:.2f}), stage 3 {s3:.2f} us (K5 alone on K11's stage-2 "
              f"output {k5_alone * 1e3:.2f}); body {body:.2f} us on the global timer, CUDA-event "
              f"interval {ms * 1e3:.2f} us", flush=True)

    k11_ms = _time_kernel(torch, lambda: k11.track_gn(*a11))
    k11_ms_512 = _time_kernel(torch, lambda: k11.track_gn(*a11_5))
    k11_plain = _time_host(torch, lambda: k11.track_gn_plain(*a11))
    k11_plain_512 = _time_host(torch, lambda: k11.track_gn_plain(*a11_5))
    b11, b11_512 = k11_bound(a11, st11), k11_bound(a11_5, st11_5)
    report["K11"] = dict(ms=k11_ms, plain=k11_plain, lib=None, err=e11, bound=b11)
    replaced = sum(report[k]["ms"] for k in ("K1", "K3", "K4", "K5"))   # K1: 2 launches
    print(f"K11 per launch: N=200 {k11_ms:.4f} ms, N=512 {k11_ms_512:.4f} ms; plain "
          f"{k11_plain:.3f} and {k11_plain_512:.3f} ms; bound {b11[0]:.6f} ({b11[1]}) and "
          f"{b11_512[0]:.6f} ({b11_512[1]}) ms; library null (PyTorch has no single call for "
          f"it); what it replaces on path 1's frame 1, K1 x 2 + K3 + K4 + K5: "
          f"{replaced:.4f} ms", flush=True)

    # entry(): the step's own entry point, once on the card, against the CPU.
    fn_e, args_e = entry()
    T7e, n_e, chi2_e = fn_e(*args_e)
    fn_c, args_c = entry("cpu")
    T7c, n_c, chi2_c = fn_c(*args_c)
    d_e = float(se3.distance(SE3.from_params7(T7e.cpu()), SE3.from_params7(T7c)))
    print(f"entry() on the card: pose {[round(v, 6) for v in T7e.tolist()]}, {int(n_e)} "
          f"inliers, chi2 {float(chi2_e):.4f}; against the CPU: pose distance {d_e:.3e} "
          f"(tolerance {TOL_ENTRY}), {int(n_c)} inliers, chi2 {float(chi2_c):.4f}", flush=True)
    if not (d_e <= TOL_ENTRY and int(n_e) == int(n_c) == 200
            and bool(torch.isfinite(T7e).all())):
        raise AssertionError("entry() on the card disagrees with the CPU")

    # -- 3. main path 1: single-sequence tracking ----------------------------
    print(f"clock: phase 3 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    counters = (k1.gather_windows_levels, k1.gather_windows, k1.gather_windows_grouped,
                k1.gather_windows_multi, k3.mega_gn, k3.mega_gn_batch, k4.a2d_gn, k5.pose_ba_gn,
                k8.pose_ba_batch_gn, k10.distance_matrix, k11.track_gn)

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
    want1 = {"gather_windows_levels": N_FRAMES, "gather_windows": N_FRAMES,
             "gather_windows_grouped": 0, "mega_gn_batch": 0,
             "gather_windows_multi": 0, "mega_gn": N_FRAMES, "a2d_gn": N_FRAMES,
             "pose_ba_gn": N_FRAMES, "pose_ba_batch_gn": 0, "distance_matrix": 0,
             "track_gn": 0}
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
    print(f"clock: phase 4 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
    want2 = {"gather_windows_levels": 0, "gather_windows": 0,
             "gather_windows_grouped": F_BATCH,
             "gather_windows_multi": F_BATCH, "mega_gn": 0, "mega_gn_batch": F_BATCH,
             "a2d_gn": F_BATCH, "pose_ba_gn": 0, "pose_ba_batch_gn": F_BATCH,
             "distance_matrix": 0, "track_gn": 0}
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
                                    bstate.mask, SE3.from_params7(T7s), bstate.batch_ref)
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
    print(f"clock: phase 5 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
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
    want3 = {"gather_windows_levels": 2 * n_f, "gather_windows": 0,
             "gather_windows_grouped": 0, "mega_gn_batch": 0,
             "gather_windows_multi": n_f, "mega_gn": n_f, "a2d_gn": n_f, "pose_ba_gn": n_f,
             "pose_ba_batch_gn": 0, "distance_matrix": 2 * n_kf, "track_gn": 0}
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
    print(f"clock: phase 5b starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # Under each FUSED_VARIANT: one run for the gate, the launch counts and
    # frames/s, then a second from a fresh System with the init step,
    # `track`, the keyframe cycle and the mapping pass each wrapped in
    # synchronisations (the VO looks these up by name when it calls them).
    counters4 = counters + (k9.level_gn, k9.level_gn_v2)
    launches4 = {}

    def want_track(n_track, n_kf, variant=3):
        """Launch counts of the System: per frame through `track` K1 twice
        (the reference levels, the window levels under variant 3; under 1
        and 2 once, then once per level before each K9 launch), K2, K4, K5
        once, K3 once under 3 or the variant's K9 three times; per keyframe
        K10 twice; nothing else."""
        want = {c.__name__: 0 for c in counters4}
        want.update(gather_windows_levels=(2 if variant == 3 else 1) * n_track,
                    gather_windows=0 if variant == 3 else 3 * n_track,
                    gather_windows_multi=n_track, a2d_gn=n_track, pose_ba_gn=n_track,
                    mega_gn=n_track if variant == 3 else 0,
                    level_gn=3 * n_track if variant == 1 else 0,
                    level_gn_v2=3 * n_track if variant == 2 else 0, distance_matrix=2 * n_kf)
        return want


    kf_cycle_ms4 = {}                    # FUSED_VARIANT -> median keyframe cycle, ms

    def timed_run(variant):
        times = {"init": [], "track": [], "kf_cycle": [], "mapping_pass": []}

        def wrap(name, fn):
            def timed(*a, **kw):
                t0 = now()
                out = fn(*a, **kw)
                times[name].append((now() - t0) * 1e3)
                return out
            return timed

        sysm = System(camera=cam_m, options=mw.mono_options(), device=dev)
        sysm.vo._try_init = wrap("init", sysm.vo._try_init)
        saved = {n: getattr(vo_mod, n) for n in ("track", "kf_cycle", "mapping_pass")}
        try:
            for n, fn in saved.items():
                setattr(vo_mod, n, wrap(n, fn))
            st_t, T7_t, _ = mw.run_mono(sysm, frames_m)
        finally:
            for n, fn in saved.items():
                setattr(vo_mod, n, fn)
        return times, _fingerprint(sysm, st_t, T7_t)

    for variant in (3, 2, 1):
        sparse_align.FUSED_VARIANT = variant
        sysm = System(camera=cam_m, options=mw.mono_options(), device=dev)
        for c in counters4:
            c.launches = 0
        st_m, T7_m, wall = mw.run_mono(sysm, frames_m)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters4}
        launches4[variant] = got
        if variant == 3:
            st4_v3, T7_4_v3 = st_m, T7_m          # path 9a's frames before its blackout
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
        want4 = want_track(n_track, n_kf, variant)
        if got != want4:
            raise AssertionError(f"launch counts {got}, expected {want4}")
        # The timed run repeats the gate run in this process: bit for bit.
        times, fp_timed = timed_run(variant)
        _check_repeat(_fingerprint(sysm, st_m, T7_m), fp_timed, f"FUSED_VARIANT {variant}")
        med = {k: statistics.median(v) for k, v in times.items() if k != "init"}
        kf_cycle_ms4[variant] = med["kf_cycle"]
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

    # -- 5c. main path 5: the whole-step configuration (K11) ------------------
    print(f"clock: phase 5c starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    for c in counters4:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T7f, inl_f = tr.track_frames(state, frames, T0, step=tr.fused_track_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches5 = {c.__name__: c.launches for c in counters4}
    max_err, min_inl, ok = tr.gate(T7f, inl_f, T_gt7)
    d15 = se3.distance(SE3.from_params7(T7f), SE3.from_params7(T7))
    print(f"main path 5 (track_frames, step=fused_track_step): {N_FRAMES} frames in "
          f"{wall:.3f} s = {N_FRAMES / wall:.1f} frames/s; gate max pose error {max_err:.3e} "
          f"(< 2e-2), min inliers {min_inl} (> 150): {'pass' if ok else 'FAIL'}; max pose "
          f"distance to path 1's poses {float(d15.max()):.3e}; launches {launches5}", flush=True)
    if not ok:
        raise AssertionError("main path 5 failed the per-frame accuracy gate")
    want5 = {name: 0 for name in launches5}
    want5.update(gather_windows_levels=N_FRAMES, gather_windows=N_FRAMES, track_gn=N_FRAMES)
    if launches5 != want5:
        raise AssertionError(f"launch counts {launches5}, expected {want5}")
    fps = {"path 1": [], "path 5": []}
    for key, step in (("path 1", tr.track_step), ("path 5", tr.fused_track_step),
                      ("path 5", tr.fused_track_step), ("path 1", tr.track_step)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.track_frames(state, frames, T0, step=step)
        torch.cuda.synchronize()
        fps[key].append(N_FRAMES / (time.perf_counter() - t0))
    print(f"main paths 1 and 5 in turns (1, 5, 5, 1), frames/s: "
          f"{ {k: [round(v, 1) for v in r] for k, r in fps.items()} }; path 5 / path 1 "
          f"{sum(fps['path 5']) / sum(fps['path 1']):.3f}", flush=True)

    # -- 5d. main path 6: the System on non-planar worlds ----------------------
    print(f"clock: phase 5d starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    def counted(fn):
        """fn() with the counters at 0 and the calls of `track` counted:
        (fn's result, wall s, launches, calls of track)."""
        calls = [0]
        real_track = vo_mod.track

        def track(*a, **kw):
            calls[0] += 1
            return real_track(*a, **kw)

        for c in counters4:
            c.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        vo_mod.track = track
        try:
            out = fn()
        finally:
            vo_mod.track = real_track
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t, {c.__name__: c.launches for c in counters4},
                calls[0])

    def run_counted(system, frames, on_frame=None):
        """`mw.run_mono` under `counted`: (statuses, T7, wall, launches,
        calls of track)."""
        (statuses, T7, wall), _, launches, calls = counted(
            lambda: mw.run_mono(system, frames, on_frame))
        return statuses, T7, wall, launches, calls

    # (a) TwoPlaneScene (tests/test_nonplanar.py's run): init with F across a
    # depth step, tracking through a moving occlusion boundary.
    cam_2p, frames_2p, T_gt_2p = nw.two_plane_workload(device=dev)
    s6a = System(camera=cam_2p, options=mw.mono_options(), device=dev)
    st6a, T7_6a, wall, launches6a, n_tr = run_counted(s6a, frames_2p)
    ate6a = mw.good_ate(st6a, T7_6a, T_gt_2p)
    n_good = sum(x is vo_mod.Status.GOOD for x in st6a)
    stats6a = s6a.vo.stats
    ok6a = (stats6a["init_model_f"] >= 1 and stats6a["init_model_h"] == 0
            and st6a[-1] is vo_mod.Status.GOOD and n_good > len(st6a) / 2 and ate6a < 0.06)
    print(f"main path 6a (System.track_monocular, TwoPlaneScene 320x240): {len(st6a)} frames "
          f"in {wall:.3f} s; init at frame {mw.init_frame(st6a)}, init_model_f "
          f"{stats6a['init_model_f']}, init_model_h {stats6a['init_model_h']}, {n_good} GOOD, "
          f"last {st6a[-1].name}, {stats6a['keyframes']} keyframes, ATE {ate6a!r} m (< 0.06): "
          f"{'pass' if ok6a else 'FAIL'}; launches {launches6a}", flush=True)
    if not ok6a:
        raise AssertionError("main path 6a failed its gate")
    if launches6a != want_track(n_tr, stats6a["keyframes"]):
        raise AssertionError(f"launch counts {launches6a}, expected "
                             f"{want_track(n_tr, stats6a['keyframes'])}")

    # (b) BoxScene at 640x480: bench_accuracy.py's world and options (camera
    # and horizon doubled), map K=10, FUSED_VARIANT 3, N_BOX frames.  Gated
    # over its first BOX_SPAN frames (GOOD on every frame after init, ATE <
    # 0.10 m, the map grown by triangulation); past them the loop enters the
    # section where this configuration starves its map (no depth filter):
    # reported, not gated (ROADMAP section 3).
    t0 = time.perf_counter()
    n_render = max(N_BOX, N_DF)          # paths 6b and 7 take the first N_BOX, path 8 N_DF
    cam_b, frames_box, T_gt_box = nw.box_workload(n_render, device=dev, shape=BOX_SHAPE)
    frames_b6, T_gt_b6 = frames_box[:N_BOX], T_gt_box[:N_BOX]
    torch.cuda.synchronize()
    ts_b6 = [float(k) for k in range(N_BOX)]
    print(f"BoxScene workload: {n_render} frames {BOX_SHAPE[1]}x{BOX_SHAPE[0]} rendered in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    s6b = System(camera=cam_b, options=nw.box_options(), device=dev)
    rows6b = []          # valid landmark rows at init and after each keyframe of the span
    rows6b_span = []     # ... and after frame BOX_SPAN (path 8's map must grow past it)
    inl6b = []           # inliers of the span's GOOD frames
    n_kf6b = [0]

    def on_frame6b(k, r):
        if k < BOX_SPAN and r.status is vo_mod.Status.GOOD:
            inl6b.append(r.n_inliers)
        kf = s6b.vo.stats["keyframes"]
        if k < BOX_SPAN and (kf > n_kf6b[0] or (r.status is vo_mod.Status.GOOD and not rows6b)):
            rows6b.append(int(s6b.vo.server.state.pt_valid.sum()))
        if k == BOX_SPAN:
            rows6b_span.append(int(s6b.vo.server.state.pt_valid.sum()))
        n_kf6b[0] = kf

    st6, T7_6, wall6, launches6, n_tr6 = run_counted(s6b, frames_b6, on_frame6b)
    vo6 = s6b.vo
    k0 = mw.init_frame(st6)
    span = st6[:BOX_SPAN]
    ate6 = mw.good_ate(span, T7_6[:BOX_SPAN], T_gt_b6[:BOX_SPAN])
    ok6 = (0 <= k0 < 30 and all(x is vo_mod.Status.GOOD for x in span[k0:]) and ate6 < 0.10
           and len(rows6b) > 1 and max(rows6b) > rows6b[0])
    first_lost = st6.index(vo_mod.Status.LOST) if vo_mod.Status.LOST in st6 else None
    print(f"main path 6b (System.track_monocular, BoxScene {BOX_SHAPE[1]}x{BOX_SHAPE[0]}, map "
          f"K={vo6.o.map_K}): {N_BOX} frames in {wall6:.3f} s = {N_BOX / wall6:.1f} frames/s; "
          f"init at frame {k0} (model {'H' if vo6.init_used_h else 'F'}); frames {k0}-"
          f"{BOX_SPAN - 1} GOOD: {all(x is vo_mod.Status.GOOD for x in span[k0:])}, ATE over them "
          f"{ate6!r} m (< 0.10), valid landmark rows at init and after each keyframe of "
          f"the span (the map must grow past its init rows) {rows6b}, at frame {BOX_SPAN} "
          f"{rows6b_span}: "
          f"{'pass' if ok6 else 'FAIL'}.  Whole run (reported): GOOD {st6.count(vo_mod.Status.GOOD) / N_BOX:.4f}, "
          f"first LOST frame {first_lost}, {nw.segments(st6)} segment(s), "
          f"{vo6.stats['keyframes']} keyframes, {vo6.stats['evictions']} evictions, "
          f"{vo6.stats['keyframes_culled']} culled, valid landmark rows at the end "
          f"{int(vo6.server.state.pt_valid.sum())} of {vo6.o.map_L}; launches {launches6}",
          flush=True)
    if not ok6:
        raise AssertionError("main path 6b failed its gate")
    if launches6 != want_track(n_tr6, vo6.stats["keyframes"]):
        raise AssertionError(f"launch counts {launches6}, expected "
                             f"{want_track(n_tr6, vo6.stats['keyframes'])}")

    # (c) Evictions: the same frames' first EVICT_FRAMES with map K=EVICT_K
    # under FUSED_VARIANT 2, so the slots fill (and are evicted) before that
    # section: evictions > 0, GOOD > 0.9, one segment, ATE < 0.10 m.
    sparse_align.FUSED_VARIANT = 2
    s6c = System(camera=cam_b, options=nw.box_options(map_K=EVICT_K), device=dev)
    try:
        st6c, T7_6c, wall6c, launches6c, n_tr6c = run_counted(s6c, frames_b6[:EVICT_FRAMES])
    finally:
        sparse_align.FUSED_VARIANT = 3
    vo6c = s6c.vo
    ate6c = mw.good_ate(st6c, T7_6c, T_gt_b6[:EVICT_FRAMES])
    frac6c = st6c.count(vo_mod.Status.GOOD) / EVICT_FRAMES
    ok6c = (vo6c.stats["evictions"] > 0 and frac6c > 0.9 and nw.segments(st6c) == 1
            and ate6c < 0.10)
    print(f"main path 6c (BoxScene, map K={EVICT_K}, FUSED_VARIANT 2): {EVICT_FRAMES} frames "
          f"in {wall6c:.3f} s; GOOD {frac6c:.4f} (> 0.9), {nw.segments(st6c)} segment(s), "
          f"{vo6c.stats['keyframes']} keyframes, {vo6c.stats['evictions']} evictions (> 0), "
          f"{vo6c.stats['keyframes_culled']} culled, valid landmark rows at the end "
          f"{int(vo6c.server.state.pt_valid.sum())}; ATE {ate6c!r} m (< 0.10): "
          f"{'pass' if ok6c else 'FAIL'}; launches {launches6c}", flush=True)
    if not ok6c:
        raise AssertionError("main path 6c failed its gate")
    if launches6c != want_track(n_tr6c, vo6c.stats["keyframes"], variant=2):
        raise AssertionError(f"launch counts {launches6c}, expected "
                             f"{want_track(n_tr6c, vo6c.stats['keyframes'], variant=2)}")
    del s6c

    # -- 5e. main path 7: path 6b's frames through chunked tracking -----------
    print(f"clock: phase 5e starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # Per-frame (P) and chunked (C) runs in turns, P, C, C, P, each from a
    # fresh System (P1 is path 6b's own run): all equal bit for bit.
    def box_run(chunked):
        s = System(camera=cam_b, options=nw.box_options(), device=dev)
        chunk_s = []
        real = s.vo._track_chunk

        def timed_chunk(frames, ts):
            t = time.perf_counter()
            out = real(frames, ts)
            chunk_s.append((time.perf_counter() - t, len(out)))
            return out

        s.vo._track_chunk = timed_chunk
        for c in counters4:
            c.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        if chunked:
            statuses = [r.status for r in s.track_monocular_chunk(frames_b6, ts_b6, chunk=CHUNK)]
        else:
            statuses = [s.track_monocular(frames_b6[k], ts_b6[k]).status for k in range(N_BOX)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return dict(s=s, wall=wall, chunk_s=chunk_s,
                    launches={c.__name__: c.launches for c in counters4},
                    fp=fingerprint7(s, statuses))

    def fingerprint7(s, statuses):
        T7 = np.stack([p for _, p in s.vo.trajectory])
        return _fingerprint(s, statuses, T7)[0] + (tuple(s.vo.server.kf_used),
                                                  tuple(sorted(s.vo.stats.items())))

    box = {"P1": dict(s=s6b, wall=wall6, launches=launches6, fp=fingerprint7(s6b, st6))}
    for key in ("C1", "C2", "P2"):
        box[key] = box_run(key[0] == "C")
    c1 = box["C1"]
    for key in ("C1", "C2", "P2"):
        same = box[key]["fp"] == box["P1"]["fp"]
        print(f"main path 7: run {key} against P1: statuses, trajectory, keyframe slots, "
              f"stats, keyframe poses and landmarks {'equal bit for bit' if same else 'DIFFERENT'}",
              flush=True)
        if not same:
            raise AssertionError(f"main path 7: run {key} differs from the per-frame run")
    # Launches counted per replay (the wrappers a capture saw, once each per
    # replay): C1's are P1's plus one step's kernels for every frame step it
    # computed and discarded at or after a cut.
    vo7 = c1["s"].vo
    steps7 = list(vo7._chunk_steps.values())
    cs = vo7.chunk_stats
    per_step = {"gather_windows_levels": 2, "gather_windows_multi": 1, "mega_gn": 1,
                "a2d_gn": 1, "pose_ba_gn": 1}
    launches7 = c1["launches"]
    want7 = {k: v + cs["frames_discarded"] * per_step.get(k, 0) for k, v in launches6.items()}
    captured7 = sorted({w.__name__ for st in steps7 for w in st.captured})
    kept7 = sum(n for _, n in c1["chunk_s"])
    host_ms7 = 1e3 * sum(t for t, _ in c1["chunk_s"]) / max(kept7, 1)
    fps7 = {k: round(N_BOX / r["wall"], 1) for k, r in box.items()}
    print(f"main path 7 (System.track_monocular_chunk, chunk={CHUNK}): {cs['chunks']} chunks, "
          f"{kept7} frames kept from chunks, {cs['frames_computed']} frame steps computed, "
          f"{cs['frames_discarded']} discarded at or after a cut ("
          f"{cs['frames_discarded'] / max(cs['chunks'], 1):.2f} per chunk), "
          f"{N_BOX - kept7} frames through add_frame; graphs {len(steps7)}, captured "
          f"{[len(st.captured) for st in steps7]} kernel launches ({captured7}), replays "
          f"{[st.replays for st in steps7]}; wall ms per chunk frame {host_ms7:.3f} (the host's "
          f"time in the chunk loop, its waits included); launches {launches7}", flush=True)
    if not steps7 or any(st.graph is None for st in steps7) or sum(
            st.replays for st in steps7) == 0:
        raise AssertionError("main path 7 replayed no CUDA graph")
    if launches7 != want7:
        raise AssertionError(f"launch counts {launches7}, expected {want7}")
    print(f"main paths 6b and 7 in turns (P, C, C, P), frames/s: {fps7}; chunked / per-frame "
          f"{(fps7['C1'] + fps7['C2']) / (fps7['P1'] + fps7['P2']):.3f}", flush=True)
    del box, c1

    # -- 5f. main path 8: the System with the depth filter ---------------------
    print(f"clock: phase 5f starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # (a) BoxScene 640x480 per frame with box_df_options (path 6b's frames and
    # options, the depth filter on), N_DF frames, gated over path 6b's span
    # (its first BOX_SPAN frames): GOOD on every frame after init, ATE <
    # DF_ATE, and more valid landmark rows at frame BOX_SPAN than path 6b;
    # the whole run is reported.  The seed update of frame SEED_FRAME is
    # recorded for the card-against-CPU check.
    from ygz_slam_tpu_torch.map import depth_filter as dfilt

    frames_b8, T_gt_b8 = frames_box[:N_DF], T_gt_box[:N_DF]
    ts_b8 = [float(k) for k in range(N_DF)]
    s8 = System(camera=cam_b, options=nw.box_df_options(), device=dev)
    rows8, prom8, inl8, seed_call, last8 = {}, [], [], {}, {"kf": 0, "prom": 0}
    real_usff = dfilt.update_seeds_from_frame

    def recording_update(seeds, ref_img, cur_img, cam, T_cur_ref, *a, **kw):
        out = real_usff(seeds, ref_img, cur_img, cam, T_cur_ref, *a, **kw)
        if s8.vo.frame_id == SEED_FRAME and not seed_call:
            seed_call.update(
                args=(dfilt.Seeds(*(t.clone() for t in seeds)), ref_img.clone(), cur_img.clone(),
                      SE3(T_cur_ref.R.clone(), T_cur_ref.t.clone())),
                out=dfilt.Seeds(*(t.clone() for t in out)))
        return out

    def on_frame8(k, r):
        vo = s8.vo
        if r.status is vo_mod.Status.GOOD:
            inl8.append((k, r.n_inliers))
        if k == BOX_SPAN:
            rows8["span"] = int(vo.server.state.pt_valid.sum())
        if vo.stats["keyframes"] > last8["kf"]:
            prom8.append(vo.stats["seeds_promoted"] - last8["prom"])
            last8.update(kf=vo.stats["keyframes"], prom=vo.stats["seeds_promoted"])
        if (k + 1) % DF_ROWS_EVERY == 0:
            rows8[k] = int(vo.server.state.pt_valid.sum())

    dfilt.update_seeds_from_frame = recording_update
    try:
        st8, T7_8, wall8, launches8, n_tr8 = run_counted(s8, frames_b8, on_frame8)
    finally:
        dfilt.update_seeds_from_frame = real_usff
    vo8 = s8.vo
    k0 = mw.init_frame(st8)
    ate8 = mw.good_ate(st8, T7_8, T_gt_b8)
    first_lost8 = st8.index(vo_mod.Status.LOST) if vo_mod.Status.LOST in st8 else None
    rows_end8 = int(vo8.server.state.pt_valid.sum())
    good8 = st8.count(vo_mod.Status.GOOD) / N_DF
    ate8_spans = {n: round(mw.good_ate(st8[:n], T7_8[:n], T_gt_b8[:n]), 5)
                  for n in (BOX_SPAN, 200, 240, 320, N_DF) if n <= N_DF}
    span8 = st8[:BOX_SPAN]
    ate8_span = mw.good_ate(span8, T7_8[:BOX_SPAN], T_gt_b8[:BOX_SPAN])
    inl8_span = [n for k, n in inl8 if k < BOX_SPAN]
    ok8 = (0 <= k0 < 30 and all(x is vo_mod.Status.GOOD for x in span8[k0:])
           and ate8_span < DF_ATE and bool(rows6b_span) and rows8.get("span", 0) > rows6b_span[0])
    print(f"main path 8a (System.track_monocular, BoxScene {BOX_SHAPE[1]}x{BOX_SHAPE[0]}, the "
          f"depth filter on): {N_DF} frames in {wall8:.3f} s = {N_DF / wall8:.1f} frames/s; init "
          f"at frame {k0} (model {'H' if vo8.init_used_h else 'F'}); frames {k0}-{BOX_SPAN - 1} "
          f"GOOD: {all(x is vo_mod.Status.GOOD for x in span8[k0:])}, ATE over them "
          f"{ate8_span!r} m (< {DF_ATE}), valid landmark rows at frame {BOX_SPAN} "
          f"{rows8.get('span')} (> path 6b's {rows6b_span}), mean inliers per GOOD frame of the "
          f"span {sum(inl8_span) / max(len(inl8_span), 1):.1f} (path 6b "
          f"{sum(inl6b) / max(len(inl6b), 1):.1f}): {'pass' if ok8 else 'FAIL'}.  Whole run "
          f"(reported): GOOD {good8:.4f} (every frame after init: "
          f"{all(x is vo_mod.Status.GOOD for x in st8[k0:])}), first LOST frame {first_lost8}, "
          f"{nw.segments(st8) - 1} reset(s), {vo8.stats['evictions']} evictions, "
          f"{vo8.stats['keyframes']} keyframes ({vo8.stats['keyframes_culled']} culled), seeds "
          f"promoted {vo8.stats['seeds_promoted']} (per keyframe {prom8}), valid landmark rows "
          f"every {DF_ROWS_EVERY} frames { {k: v for k, v in rows8.items() if k != 'span'} }, at "
          f"the end {rows_end8}, mean inliers per GOOD frame "
          f"{sum(n for _, n in inl8) / max(len(inl8), 1):.1f}, ATE over the first n frames "
          f"{ate8_spans}, over the run {ate8!r} m; launches {launches8}", flush=True)
    if not ok8:
        raise AssertionError("main path 8a failed its gate")
    if launches8 != want_track(n_tr8, vo8.stats["keyframes"]):
        raise AssertionError(f"launch counts {launches8}, expected "
                             f"{want_track(n_tr8, vo8.stats['keyframes'])}")

    # The recorded seed update on the card against the CPU (and both against
    # float64 on the CPU): the seeds updated agree on >= MIN_SEED_AGREE of the
    # valid rows; on rows updated in both, mu and sigma2 within max(TOL_SEED,
    # SEED_SPREAD x the CPU run's own distance from float64).
    if not seed_call:
        raise AssertionError(f"main path 8a ran no seed update on frame {SEED_FRAME}")
    sd, ref_img, cur_img, T_cr = seed_call["args"]
    out_card = seed_call["out"]

    def on_cpu(dtype):
        def cast(t):
            t = t.cpu()
            return t.to(dtype) if t.is_floating_point() else t

        return real_usff(dfilt.Seeds(*(cast(t) for t in sd)), cast(ref_img), cast(cur_img),
                         cam_b, SE3(cast(T_cr.R), cast(T_cr.t)))

    out_cpu, out_64 = on_cpu(torch.float32), on_cpu(torch.float64)
    valid = sd.valid.cpu()
    upd_card = (out_card.sigma2.cpu() != sd.sigma2.cpu()) & valid
    upd_cpu = (out_cpu.sigma2 != sd.sigma2.cpu()) & valid
    agree = float((upd_card == upd_cpu)[valid].float().mean()) if bool(valid.any()) else 1.0
    both = upd_card & upd_cpu

    def rel(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float(((a - b).abs() / b.abs().clamp(min=1e-30))[both].max()) if bool(
            both.any()) else 0.0

    seed_errs = {name: (rel(getattr(out_card, name), getattr(out_cpu, name)),
                        rel(getattr(out_cpu, name), getattr(out_64, name)))
                 for name in ("mu", "sigma2")}
    ok_seed = agree >= MIN_SEED_AGREE and int(both.sum()) > 0 and all(
        card <= max(TOL_SEED, SEED_SPREAD * own) for card, own in seed_errs.values())
    print(f"main path 8a's seed update of frame {SEED_FRAME}, card against CPU: "
          f"{int(valid.sum())} valid seeds, {int(upd_card.sum())} updated on the card and "
          f"{int(upd_cpu.sum())} on the CPU, the sets agree on {agree:.4f} of the rows (>= "
          f"{MIN_SEED_AGREE}); mu and sigma2 on the {int(both.sum())} rows updated in both, "
          f"(card against CPU, CPU against float64): {seed_errs}: "
          f"{'pass' if ok_seed else 'FAIL'}", flush=True)
    if not ok_seed:
        raise AssertionError("main path 8a's seed update on the card differs from the CPU's")

    # (b) The same frames through track_monocular_chunk: runs in turns P1 (8a),
    # C1, C2, P2, each from a fresh System, equal bit for bit (statuses,
    # trajectory, keyframe slots, stats, keyframe poses, landmarks and the
    # seed table); graphs with the seed update captured and replayed.
    def fingerprint8(s, statuses):
        vo = s.vo
        seeds = None if vo.seeds is None else tuple(t.cpu().numpy().tobytes() for t in vo.seeds)
        return fingerprint7(s, statuses) + (vo.seed_kf_slot, seeds)

    def df_run(chunked):
        s = System(camera=cam_b, options=nw.box_df_options(), device=dev)
        for c in counters4:
            c.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        if chunked:
            statuses = [r.status for r in s.track_monocular_chunk(frames_b8, ts_b8, chunk=CHUNK)]
        else:
            statuses = [s.track_monocular(frames_b8[k], ts_b8[k]).status for k in range(N_DF)]
        torch.cuda.synchronize()
        return dict(s=s, wall=time.perf_counter() - t,
                    launches={c.__name__: c.launches for c in counters4},
                    fp=fingerprint8(s, statuses))

    dfr = {"P1": dict(s=s8, wall=wall8, launches=launches8, fp=fingerprint8(s8, st8))}
    for key in ("C1", "C2", "P2"):
        dfr[key] = df_run(key[0] == "C")
        same = dfr[key]["fp"] == dfr["P1"]["fp"]
        print(f"main path 8b: run {key} against 8a: statuses, trajectory, keyframe slots, stats, "
              f"keyframe poses, landmarks and seed table "
              f"{'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
        if not same:
            raise AssertionError(f"main path 8b: run {key} differs from the per-frame run")
    vo8c = dfr["C1"]["s"].vo
    cs8 = vo8c.chunk_stats
    seeded8 = [st for key, st in vo8c._chunk_steps.items() if key[-1]]
    launches8c = dfr["C1"]["launches"]
    want8c = {k: v + cs8["frames_discarded"] * per_step.get(k, 0) for k, v in launches8.items()}
    fps8 = {k: round(N_DF / r["wall"], 1) for k, r in dfr.items()}
    print(f"main path 8b (System.track_monocular_chunk, chunk={CHUNK}, the depth filter on): "
          f"{cs8['chunks']} chunks, {cs8['frames_computed']} frame steps computed, "
          f"{cs8['frames_discarded']} discarded; graphs (frame shape, chunk, variant, seeds) "
          f"{[(k, st.replays) for k, st in vo8c._chunk_steps.items()]}; launches {launches8c}; "
          f"frames/s in turns (P, C, C, P) {fps8}, chunked / per-frame "
          f"{(fps8['C1'] + fps8['C2']) / (fps8['P1'] + fps8['P2']):.3f}", flush=True)
    if not seeded8 or sum(st.replays for st in seeded8) == 0 or any(
            st.graph is None for st in seeded8):
        raise AssertionError("main path 8b replayed no CUDA graph with the seed update")
    if launches8c != want8c:
        raise AssertionError(f"launch counts {launches8c}, expected {want8c}")
    del dfr, vo8c

    # -- 5g. main path 9: relocalization --------------------------------------
    print(f"clock: phase 5g starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    from ygz_slam_tpu_torch.map import vocabulary as voc
    from ygz_slam_tpu_torch.models import reloc_workload as rw
    from ygz_slam_tpu_torch.models import relocalization as rl

    def want_reloc(n_track, n_kf, attempts):
        """Path 4's launch counts plus one K10 and one K8 per relocalization
        attempt."""
        want = want_track(n_track, n_kf)
        want["distance_matrix"] += attempts
        want["pose_ba_batch_gn"] += attempts
        return want

    def reloc_args(vo, q):
        m = vo.server.state
        return (vo.vocab, vo.cam, q.desc, q.px, q.valid, vo.kf_bow, m.kf_valid, m.kf_pose7,
                m.feat_desc.reshape(-1, 8), vo.kf_nodes.reshape(-1), m.feat_point.reshape(-1),
                m.feat_valid.reshape(-1), m.pt_pos, m.pt_valid)

    # (a) Blackout and revisit: path 4's PlaneScene run with the vocabulary on,
    # rw.N_PRE frames, rw.N_NOISE noise frames, then the view of the window's
    # oldest keyframe and the rw.N_AFTER frames after it.
    s9 = System(camera=cam_m, options=rw.reloc_options(), device=dev)
    vo9 = s9.vo
    out9, wall9, launches9a, n_tr9 = counted(lambda: rw.blackout_revisit(s9, frames_m))
    st9 = out9["statuses"]
    k0_9 = mw.init_frame(st9)
    same_pre = (st9[:rw.N_PRE] == st4_v3[:rw.N_PRE]
                and out9["T7"][:rw.N_PRE].tobytes() == T7_4_v3[:rw.N_PRE].tobytes())
    want9a = want_reloc(n_tr9, vo9.stats["keyframes"], vo9.stats["reloc_attempts"])
    print(f"main path 9a (System.track_monocular, PlaneScene {frames_m.shape[2]}x"
          f"{frames_m.shape[1]}, the vocabulary on): {len(st9)} frames in {wall9:.3f} s; init at "
          f"frame {k0_9}; frames 0-{rw.N_PRE - 1} equal to path 4's (FUSED_VARIANT 3) bit for "
          f"bit: {same_pre}; noise frames {[x.name for x in st9[rw.N_PRE:rw.N_PRE + rw.N_NOISE]]}"
          f"; revisited keyframe slot {out9['revisit_slot']} (frame {out9['revisit_fid']}), "
          f"window {vo9.server.kf_used}; relocalized at fed frame {out9['reloc_frame']} "
          f"({vo9.stats['reloc_attempts']} attempts, {vo9.stats['relocalizations']} "
          f"relocalizations), pose against the keyframe's {out9['reloc_error']:.3e} (< "
          f"{rw.TOL_REVISIT}); the {rw.N_AFTER} frames after GOOD: {out9['after_good']}; gates "
          f"noise LOST {out9['noise_lost']}, relocalized without a reset {out9['relocalized']}: "
          f"{'pass' if out9['ok'] and same_pre else 'FAIL'}; stats {dict(vo9.stats)}; launches "
          f"{launches9a}", flush=True)
    if not (out9["ok"] and same_pre):
        raise AssertionError("main path 9a failed its gates")
    if launches9a != want9a:
        raise AssertionError(f"launch counts {launches9a}, expected {want9a}")
    # One attempt's cost: synchronised ms (median of 10 attempts on the revisit
    # frame against the map as the run left it), its launches (one K10 and one
    # K8 each), its kernels and device µs alone, and a keyframe's BoW row.
    pyr9 = fe.preprocess(frames_m[out9["revisit_fid"]], vo9.o.n_levels)
    att_ms = []
    for c in counters4:
        c.launches = 0
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vo9._try_relocalize(pyr9)
        torch.cuda.synchronize()
        att_ms.append(1e3 * (time.perf_counter() - t))
    per_att = {c.__name__: c.launches / 10 for c in counters4 if c.launches}
    if per_att != {"distance_matrix": 1.0, "pose_ba_batch_gn": 1.0}:
        raise AssertionError(f"a relocalization attempt launched {per_att}, not one K10 and one K8")
    prof9 = _profile(torch, lambda: [vo9._try_relocalize(pyr9) for _ in range(10)], 10,
                     "one relocalization attempt (detection, BoW, matching, P3P-RANSAC, pose "
                     "BA; 10 candidates) x 10")
    bow_ms = []
    slot9 = vo9.server.kf_used[-1]
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vo_mod.keyframe_bow(vo9.vocab, vo9.server.state, slot9)
        torch.cuda.synchronize()
        bow_ms.append(1e3 * (time.perf_counter() - t))
    k_att, us_att = _totals(prof9, 10)
    print(f"main path 9a relocalization attempt: {statistics.median(att_ms):.3f} ms synchronised "
          f"(median of 10; min {min(att_ms):.3f}, max {max(att_ms):.3f}), launches per attempt "
          f"{per_att}; alone {_nm(k_att, '.1f')} device kernels and {_nm(us_att, '.2f', ' us')} of "
          f"device time per "
          f"attempt; a keyframe's BoW row {statistics.median(bow_ms):.3f} ms synchronised "
          f"(median of 20)", flush=True)

    # (b) Kidnapped: tests/test_relocalization.py's upside-down query at this
    # size against 9a's map, with and without the P3P-RANSAC seed.
    Tw9, Tm9 = rw.kidnapped_pose(vo9, T_gt_m, out9["fed"])
    q9b = vo9._detect(fe.preprocess(rw.kidnapped_frame(cam_m, Tw9, tuple(frames_m.shape[1:])),
                                    vo9.o.n_levels))
    kid = {}
    for use_pnp in (True, False):
        r = rl.relocalize(*reloc_args(vo9, q9b), min_inliers=15,
                          feat_angle_flat=vo9.server.state.feat_angle.reshape(-1),
                          q_angle=q9b.angle, top_c=vo9.o.reloc_top_c, use_pnp=use_pnp,
                          generator=torch.Generator(device=dev).manual_seed(1))
        kid[use_pnp] = (bool(r.success), int(r.n_inliers), float(se3.distance(r.T_cw, Tm9)))
    ok9b = kid[True][0] and kid[True][2] < rw.TOL_KIDNAP and (
        not kid[False][0] or kid[False][2] > 10 * kid[True][2])
    print(f"main path 9b (kidnapped, upside down): P3P seed (success, inliers, pose error in "
          f"map units) {kid[True]} (error < {rw.TOL_KIDNAP}); stored-pose seed {kid[False]} (must "
          f"fail or land > 10x further): {'pass' if ok9b else 'FAIL'}", flush=True)
    if not ok9b:
        raise AssertionError("main path 9b failed its gate")

    # (c) One attempt on the card against the CPU: the same map, features and
    # P3P triples (the card's draws) copied over.
    q9 = vo9._detect(pyr9)
    stages_card, stages_cpu = {}, {}
    kw9 = dict(min_inliers=vo9.o.reloc_min_inliers, top_c=vo9.o.reloc_top_c, use_pnp=True)
    with kernels.record_launches() as rec9:
        r_card = rl.relocalize(*reloc_args(vo9, q9),
                               feat_angle_flat=vo9.server.state.feat_angle.reshape(-1),
                               q_angle=q9.angle, generator=torch.Generator(device=dev).manual_seed(2),
                               stages=stages_card, **kw9)
    a_card = stages_card["attempt"]

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    vocab_cpu = voc.from_state_dict(voc.state_dict(vo9.vocab), device="cpu")
    r_cpu = rl.relocalize(vocab_cpu, *(cpu(x) for x in reloc_args(vo9, q9)[1:]),
                          feat_angle_flat=vo9.server.state.feat_angle.reshape(-1).cpu(),
                          q_angle=q9.angle.cpu(), draws=a_card.draws.cpu(), stages=stages_cpu,
                          **kw9)
    a_cpu = stages_cpu["attempt"]
    d_sc = float((a_card.scores.cpu() - a_cpu.scores).abs().max())
    same_cand = torch.equal(a_card.cand.cpu(), a_cpu.cand)
    same_match = torch.equal(a_card.match_idx.cpu(), a_cpu.match_idx)
    n_card, n_cpu = a_card.n_inl.cpu(), a_cpu.n_inl
    Nq = q9.desc.shape[0]
    inl_close = int((n_card - n_cpu).abs().max()) <= (1 - MIN_INLIER_AGREE) * Nq
    d_pose = float(se3.distance(SE3(r_card.T_cw.R.cpu(), r_card.T_cw.t.cpu()), r_cpu.T_cw))
    ok9c = (d_sc <= 1e-6 and same_cand and same_match and inl_close
            and int(r_card.n_inliers) == int(r_cpu.n_inliers)
            and int(r_card.kf_slot) == int(r_cpu.kf_slot) and d_pose <= TOL_POSE
            and bool(r_card.success) and bool(r_cpu.success))
    print(f"main path 9c (one attempt, card against CPU, the card's P3P draws): BoW scores within "
          f"{d_sc:.2e} (<= 1e-6), candidates {a_card.cand.tolist()} equal: {same_cand}, matches "
          f"equal: {same_match} ({int((a_card.match_idx >= 0).sum())} kept), inliers per "
          f"candidate {n_card.tolist()} / {n_cpu.tolist()} (equal: {torch.equal(n_card, n_cpu)}; "
          f"within {(1 - MIN_INLIER_AGREE) * Nq:.2f} rows), winner {int(r_card.kf_slot)} / "
          f"{int(r_cpu.kf_slot)} with {int(r_card.n_inliers)} / {int(r_cpu.n_inliers)}, pose "
          f"distance {d_pose:.3e} (<= {TOL_POSE}): {'pass' if ok9c else 'FAIL'}", flush=True)
    if not ok9c:
        raise AssertionError("main path 9c: the attempt on the card differs from the CPU's")
    # The attempt's recorded K10 [Nq, C*F] and K8 [S=C] arguments against their
    # plain versions, and their times, profiler µs and bounds at these shapes.
    a10s = [a for f, a in rec9 if f is k10.distance_matrix]
    a8s = [a for f, a in rec9 if f is k8.pose_ba_batch_gn]
    if len(a10s) != 1 or len(a8s) != 1 or len(rec9) != 2:
        raise AssertionError(f"the attempt launched {[f.__name__ for f, _ in rec9]}")
    a10r, a8r = a10s[0], a8s[0]
    out10 = k10.distance_matrix(*a10r)
    e10r = int((out10 - k10.distance_matrix_plain(*a10r)).abs().max())
    tag10 = f"{a10r[0].shape[0]} x {a10r[1].shape[0]} (relocalization, {kw9['top_c']} candidates)"
    print(f"K10 hamming distance_matrix {tag10}: max |kernel - plain| = {e10r} (tolerance 0)")
    if e10r != 0:
        raise AssertionError("K10 disagrees with its plain version at the relocalization's shape")
    e8r, st8r = check_k8(a8r, f"S={a8r[0].shape[0]} N={a8r[0].shape[1]} (relocalization)")
    ab10, bb10 = unpack_bits(a10r[0]), unpack_bits(a10r[1])
    k10r = dict(ms=_time_kernel(torch, lambda: k10.distance_matrix(*a10r)),
                plain=_time_host(torch, lambda: k10.distance_matrix_plain(*a10r)),
                lib=_time_kernel(torch, lambda: torch.cdist(ab10, bb10, p=0)),
                us=_profile_us(torch, lambda: k10.distance_matrix(*a10r), "hamming_mma_kernel"),
                bound=k10_bound(*a10r))
    S8r, N8r = a8r[0].shape[:2]
    k8r = dict(ms=_time_kernel(torch, lambda: k8.pose_ba_batch_gn(*a8r)),
               plain=_time_host(torch, lambda: k8.pose_ba_batch_gn_plain(*a8r)),
               us=_profile_us(torch, lambda: k8.pose_ba_batch_gn(*a8r),
                              "pose_ba_fused_batch_kernel"),
               bound=_bound(S8r * (N8r * (12 + 8 + 4) + 48 + N8r * 4 + 52),
                            sum(N8r * (180 * ne + 27 * 25 + 4 * 30) for ne in st8r["normal_eqs"])))
    for name, r in (("K10 " + tag10, k10r), (f"K8 S={S8r} N={N8r} (relocalization)", k8r)):
        lib = "null" if r.get("lib") is None else f"{r['lib']:.4f}"
        print(f"{name}: kernel {r['ms']:.4f} ms, profiler {_nm(r['us'], '.2f', ' us')} per launch, plain "
              f"{r['plain']:.4f} ms, library {lib} ms, bound {r['bound'][0]:.6f} ms "
              f"({r['bound'][1]})", flush=True)

    # (d) BoxScene with relocalization: path 8a's frames and options plus the
    # vocabulary; path 8a's gates, and equal to 8a bit for bit up to the first
    # frame that attempts a relocalization (all of it if none does).
    s9d = System(camera=cam_b, options=nw.box_df_options(use_vocabulary=True,
                                                         loop_closing=False), device=dev)
    first9d, rows9d = {}, {}

    def on_frame9d(k, r):
        if s9d.vo.stats["reloc_attempts"] and "k" not in first9d:
            first9d["k"] = k
        if k == BOX_SPAN:
            rows9d["span"] = int(s9d.vo.server.state.pt_valid.sum())

    st9d, T7_9d, wall9d, launches9d, n_tr9d = run_counted(s9d, frames_b8, on_frame9d)
    vo9d = s9d.vo
    k_eq = first9d.get("k", N_DF)
    same9d = st9d[:k_eq] == st8[:k_eq] and T7_9d[:k_eq].tobytes() == T7_8[:k_eq].tobytes()
    k0 = mw.init_frame(st9d)
    span9 = st9d[:BOX_SPAN]
    ate9_span = mw.good_ate(span9, T7_9d[:BOX_SPAN], T_gt_b8[:BOX_SPAN])
    ok9d = (0 <= k0 < 30 and all(x is vo_mod.Status.GOOD for x in span9[k0:])
            and ate9_span < DF_ATE and rows9d.get("span", 0) > rows6b_span[0] and same9d)
    ate9_spans = {n: round(mw.good_ate(st9d[:n], T7_9d[:n], T_gt_b8[:n]), 5)
                  for n in (BOX_SPAN, 240, 320, N_DF) if n <= N_DF}
    print(f"main path 9d (path 8a's BoxScene frames and options with the vocabulary on): "
          f"{N_DF} frames in {wall9d:.3f} s = {N_DF / wall9d:.1f} frames/s; first frame "
          f"attempting a relocalization: {first9d.get('k')}; equal to 8a bit for bit before it "
          f"(over all {N_DF} frames if none): {same9d}; 8a's gates: frames {k0}-{BOX_SPAN - 1} "
          f"GOOD, ATE over them {ate9_span!r} m (< {DF_ATE}), rows at frame {BOX_SPAN} "
          f"{rows9d.get('span')}: {'pass' if ok9d else 'FAIL'}.  Whole run (reported): GOOD "
          f"{st9d.count(vo_mod.Status.GOOD) / N_DF:.4f}, {vo9d.stats['reloc_attempts']} attempts, "
          f"{vo9d.stats['relocalizations']} relocalizations, {nw.segments(st9d) - 1} reset(s), "
          f"first LOST frame "
          f"{st9d.index(vo_mod.Status.LOST) if vo_mod.Status.LOST in st9d else None}, ATE over "
          f"the first n frames {ate9_spans}; launches {launches9d}", flush=True)
    if not ok9d:
        raise AssertionError("main path 9d failed its gates")
    want9d = want_reloc(n_tr9d, vo9d.stats["keyframes"], vo9d.stats["reloc_attempts"])
    if launches9d != want9d:
        raise AssertionError(f"launch counts {launches9d}, expected {want9d}")
    # (e) Path 6b's frames and options (no depth filter: past frame ~180 this
    # loop starves the map and 6b loses track) with the vocabulary on: equal
    # to 6b bit for bit up to the first attempt; whether relocalization takes
    # the place of 6b's reset is reported.
    s9e = System(camera=cam_b, options=nw.box_options(use_vocabulary=True, loop_closing=False),
                 device=dev)
    first9e = {}

    def on_frame9e(k, r):
        if s9e.vo.stats["reloc_attempts"] and "k" not in first9e:
            first9e["k"] = k

    st9e, T7_9e, wall9e, launches9e, n_tr9e = run_counted(s9e, frames_b6, on_frame9e)
    vo9e = s9e.vo
    k_eq = first9e.get("k", N_BOX)
    same9e = st9e[:k_eq] == st6[:k_eq] and T7_9e[:k_eq].tobytes() == T7_6[:k_eq].tobytes()
    ate9e = {n: round(mw.good_ate(st9e[:n], T7_9e[:n], T_gt_b6[:n]), 5)
             for n in (BOX_SPAN, 240, N_BOX)}
    ate6e = {n: round(mw.good_ate(st6[:n], T7_6[:n], T_gt_b6[:n]), 5)
             for n in (BOX_SPAN, 240, N_BOX)}
    print(f"main path 9e (path 6b's frames and options with the vocabulary on): {N_BOX} frames in "
          f"{wall9e:.3f} s; first frame attempting a relocalization: {first9e.get('k')}; equal to "
          f"6b bit for bit before it: {same9e}.  Reported: GOOD "
          f"{st9e.count(vo_mod.Status.GOOD) / N_BOX:.4f} (6b "
          f"{st6.count(vo_mod.Status.GOOD) / N_BOX:.4f}), {vo9e.stats['reloc_attempts']} attempts, "
          f"{vo9e.stats['relocalizations']} relocalizations, {nw.segments(st9e) - 1} reset(s) (6b "
          f"{nw.segments(st6) - 1}), LOST frames {st9e.count(vo_mod.Status.LOST)} (6b "
          f"{st6.count(vo_mod.Status.LOST)}), ATE over the first n frames {ate9e} (6b {ate6e}); "
          f"launches {launches9e}", flush=True)
    n_att9e, n_rel9e = vo9e.stats["reloc_attempts"], vo9e.stats["relocalizations"]
    if not same9e:
        raise AssertionError("main path 9e differs from 6b before any relocalization")
    want9e = want_reloc(n_tr9e, vo9e.stats["keyframes"], vo9e.stats["reloc_attempts"])
    if launches9e != want9e:
        raise AssertionError(f"launch counts {launches9e}, expected {want9e}")
    del s9, s9d, s9e, vo9, vo9d, vo9e

    # -- 5h. main path 10: the keyframe archive and active-window loop closing --
    print(f"clock: phase 5h starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    from ygz_slam_tpu_torch.map import archive as arc_mod
    from ygz_slam_tpu_torch.models import archive_workload as aw

    # (a) The kidnapped sweep at 640x480 with the archive on: the sweep, noise
    # frames, then the oldest archived keyframe's view and the frames after it.
    # The successful archive attempt's arguments are kept for (d).
    cam_a, frames_a, _ = aw.sweep_frames((480, 640), device=dev)
    vo10 = vo_mod.VisualOdometry(cam_a, aw.archive_options(), device=dev)
    att10 = {"ms": [], "arc": None}
    real_try, real_arc = vo10._try_relocalize, rl.relocalize_archive

    def timed_try(pyr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real_try(pyr)
        torch.cuda.synchronize()
        att10["ms"].append(1e3 * (time.perf_counter() - t))
        return r

    def kept_arc(vocab, cam, q_desc, q_px, q_valid, arc, **kw):
        att10["arc"] = (q_desc.clone(), q_px.clone(), q_valid.clone(),
                        arc_mod.ArchiveView(*(t.clone() for t in arc)), dict(kw))
        return real_arc(vocab, cam, q_desc, q_px, q_valid, arc, **kw)

    vo10._try_relocalize = timed_try
    rl.relocalize_archive = kept_arc
    try:
        out10, wall10, launches10a, n_tr10 = counted(
            lambda: aw.kidnapped_sweep(vo10, frames_a, n_after=aw.N_AFTER * 2))
    finally:
        rl.relocalize_archive = real_arc
    st10 = out10["statuses"]
    # The same sweep with the archive off: equal up to the noise, bit for bit.
    vo10b = vo_mod.VisualOdometry(cam_a, aw.archive_options(archive_map=False), device=dev)
    st10b = [vo10b.add_frame(frames_a[k], float(k)).status for k in range(frames_a.shape[0])]
    n_sw = frames_a.shape[0]
    same10 = (st10[:n_sw] == st10b and out10["T7"][:n_sw].tobytes()
              == np.stack([p for _, p in vo10b.trajectory]).tobytes())
    count_ok = vo10.archive.count == (vo10.stats["evictions"] + vo10.stats["keyframes_culled"]
                                      - vo10.stats["keyframes_reactivated"])
    ok10a = (out10["ok"] and same10 and count_ok and vo10.stats["relocs_archive"] >= 1
             and vo10.stats["keyframes_reactivated"] >= 1)
    # Path 4's counts, plus one K10 and one K8 per active-window attempt and,
    # per archive attempt, one K10 per ARCHIVE_CHUNK rows of the scored view
    # (one below 512), one for the candidates and one K8.
    want10a = want_track(n_tr10, vo10.stats["keyframes"])
    n_att, n_arc = vo10.stats["reloc_attempts"], vo10.stats["reloc_archive_attempts"]
    want10a["distance_matrix"] += n_att + 2 * n_arc
    want10a["pose_ba_batch_gn"] += n_att + n_arc
    print(f"main path 10a (the kidnapped sweep, PlaneScene seed 3 {frames_a.shape[2]}x"
          f"{frames_a.shape[1]}, map_K {vo10.o.map_K}, the archive on): {len(st10)} frames in "
          f"{wall10:.3f} s; statuses {''.join(s.name[0] for s in st10)}; the sweep equal to the "
          f"run with the archive off bit for bit: {same10}; {out10['archived_before']} keyframes "
          f"archived at the sweep's end; revisited archived keyframe {out10['revisit_fid']}, "
          f"relocalized at fed frame {out10['reloc_frame']} through the archive with "
          f"reactivation: {out10['relocalized']}, pose against the archived one "
          f"{out10['reloc_error']:.3e} (< {aw.TOL_REVISIT}), the {aw.N_AFTER * 2} frames after "
          f"GOOD: {out10['after_good']}; archive rows {vo10.archive.count} = evictions "
          f"{vo10.stats['evictions']} + culls {vo10.stats['keyframes_culled']} - reactivations "
          f"{vo10.stats['keyframes_reactivated']}: {count_ok}; "
          f"{'pass' if ok10a else 'FAIL'}; stats {dict(vo10.stats)}; launches {launches10a}",
          flush=True)
    if not ok10a:
        raise AssertionError("main path 10a failed its gates")
    if launches10a != want10a:
        raise AssertionError(f"launch counts {launches10a}, expected {want10a}")
    if att10["arc"] is None:
        raise AssertionError("main path 10a made no archive attempt")
    qd10, qpx10, qv10, arcv10, kw10 = att10["arc"]
    arc_once = lambda: rl.relocalize_archive(vo10.vocab, cam_a, qd10, qpx10, qv10, arcv10,
                                             **kw10)
    prof10 = _profile(torch, lambda: [bool(arc_once().success) for _ in range(10)], 10,
                      "one archive relocalization (retrieval over the archive, matching, "
                      "P3P-RANSAC, pose BA; 10 candidates) x 10")
    print(f"main path 10a attempts: {[round(x, 3) for x in att10['ms']]} ms synchronised "
          f"({vo10.stats['reloc_attempts']} active-window attempts, each followed by an archive "
          f"attempt); the archive attempt alone: "
          f"{_nm(_totals(prof10, 10)[0], '.1f')} device kernels and "
          f"{_nm(_totals(prof10, 10)[1], '.2f', ' us')} of device time", flush=True)

    # (b) The archive at scale: views of capacity 16, 128, 512 and 2048 filled
    # with 10a's rows (2048 rows take the BoW prefilter to 1024).
    rows10 = [vo10.archive.row(i) for i in range(vo10.archive.count)]
    scale10 = {}
    for cap in (16, 128, 512, 2048):
        big = arc_mod.KeyframeArchive(vo10.o.map_F, vo10.archive.W, device=dev)
        for i in range(cap):
            r = rows10[i % len(rows10)]
            big.append(r["frame_id"] + 1000 * (i // len(rows10)), r["pose7"], r["bow"], r["nodes"],
                       r["desc"], r["px"], r["feat_valid"], r["pt_pos"], r["pt_ok"],
                       angle=r["angle"], level=r["level"], image=r["image"])
        v = big.device_view()
        assert v.valid.shape[0] == cap
        c_valid = v.feat_valid & v.pt_ok
        scored = min(cap, rl.ARCHIVE_PREFILTER)
        C = min(scored, hamming.ARCHIVE_CHUNK)
        b10 = v.desc[:C].reshape(C * vo10.o.map_F, 8)
        torch.cuda.synchronize()
        k10_us = _profile_us(torch, lambda: k10.distance_matrix(qd10, b10), "hamming_mma_kernel")
        k10_ms = _time_kernel(torch, lambda: k10.distance_matrix(qd10, b10))
        ab, bb = unpack_bits(qd10), unpack_bits(b10)
        lib_ms = _time_kernel(torch, lambda: torch.cdist(ab, bb, p=0), reps=5)
        del ab, bb
        n_launch = -(-scored // hamming.ARCHIVE_CHUNK)
        score_ms = _time_kernel(torch, lambda: rl._archive_retrieval_scores(
            vo10.vocab, qd10, qv10, v, v.valid), reps=10)
        whole = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bool(rl.relocalize_archive(vo10.vocab, cam_a, qd10, qpx10, qv10, v, **kw10).success)
            torch.cuda.synchronize()
            whole.append(1e3 * (time.perf_counter() - t))
        exact = None
        if cap <= 128:
            cpu_v = arc_mod.ArchiveView(*(t.cpu() for t in v))
            vocab_cpu = voc.from_state_dict(voc.state_dict(vo10.vocab), device="cpu")
            m_card = hamming.archive_match_scores(qd10, qv10, v.desc, c_valid)
            m_cpu = hamming.archive_match_scores(qd10.cpu(), qv10.cpu(), cpu_v.desc,
                                                 cpu_v.feat_valid & cpu_v.pt_ok)
            s_card = rl._archive_retrieval_scores(vo10.vocab, qd10, qv10, v, v.valid)
            s_cpu = rl._archive_retrieval_scores(vocab_cpu, qd10.cpu(), qv10.cpu(), cpu_v,
                                                 cpu_v.valid)
            exact = torch.equal(m_card.cpu(), m_cpu) and torch.equal(s_card.cpu(), s_cpu)
            if not exact:
                raise AssertionError(f"archive scores at capacity {cap}: the card differs from "
                                     "the CPU")
        bound = k10_bound(qd10, b10)
        scale10[cap] = dict(k10_ms=k10_ms, k10_us=k10_us, lib_ms=lib_ms, bound=bound,
                            n_launch=n_launch, score_ms=score_ms,
                            reloc_ms=statistics.median(whole))
        print(f"main path 10b capacity {cap}: {scored} rows scored in {n_launch} K10 launch(es) of "
              f"{qd10.shape[0]} x {C * vo10.o.map_F} ({qd10.shape[0] * C * vo10.o.map_F * 4} "
              f"bytes of matrix each): K10 {k10_ms:.4f} ms, profiler {_nm(k10_us, '.2f', ' us')}, bound "
              f"{bound[0]:.6f} ms ({bound[1]}), library {lib_ms:.4f} ms (torch.cdist p=0 on the "
              f"unpacked bits); the retrieval scores {score_ms:.4f} ms; one whole "
              f"relocalize_archive {statistics.median(whole):.3f} ms synchronised (median of 5)"
              + ("" if exact is None else f"; card equal to the CPU: {exact}"), flush=True)
        del big, v

    # (c) Active-window loop closing: path 9d's frames and options with
    # loop_closing on (no archive), over the first N_LOOP frames, twice (the
    # same bits); equal to 9d up to the first keyframe whose detect_loop
    # finds a loop; one K10 and one K5 more per mapping pass with the loop
    # block (4 keyframes or more).
    N_LOOP = 240
    loop_opts = nw.box_df_options(use_vocabulary=True, loop_closing=True, archive_map=False)
    passes10 = {"loop": 0, "ms_loop": [], "ms_plain": [], "rec": None}
    real_pass = vo_mod.mapping_pass

    def counted_pass(cam, o, mstate, fixed, loop=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_pass(cam, o, mstate, fixed, loop=loop)
        torch.cuda.synchronize()
        passes10["ms_loop" if loop is not None else "ms_plain"].append(
            1e3 * (time.perf_counter() - t))
        if loop is not None:
            passes10["loop"] += 1
            if passes10["rec"] is None:
                passes10["rec"] = (cam, o, ms_mod.MapState(*(x.clone() for x in mstate)),
                                   fixed.clone(), loop)
        return out

    def loop_run(n_frames):
        s = System(camera=cam_b, options=loop_opts, device=dev)
        first = {}

        def on_frame(k, r):
            if s.vo.stats["loops_closed_active"] and "k" not in first:
                first["k"] = k

        st, T7, wall, launches, n_tr = run_counted(s, frames_b8[:n_frames], on_frame)
        return s, st, T7, wall, launches, n_tr, first.get("k", n_frames)

    from ygz_slam_tpu_torch.map import state as ms_mod
    vo_mod.mapping_pass = counted_pass
    try:
        s10c, st10c, T7_10c, wall10c, launches10c, n_tr10c, k_loop = loop_run(N_LOOP)
    finally:
        vo_mod.mapping_pass = real_pass
    n_loop_pass = passes10["loop"]
    s10r, st10r, T7_10r, _, _, _, _ = loop_run(N_LOOP)
    repeat10 = (st10r == st10c and T7_10r.tobytes() == T7_10c.tobytes()
                and all(torch.equal(a, b) for a, b in zip(s10c.vo.server.state,
                                                          s10r.vo.server.state)))
    same10c = st10c[:k_loop] == st9d[:k_loop] and T7_10c[:k_loop].tobytes() == \
        T7_9d[:k_loop].tobytes()
    want10c = want_track(n_tr10c, s10c.vo.stats["keyframes"])
    want10c["distance_matrix"] += s10c.vo.stats["reloc_attempts"] + n_loop_pass
    want10c["pose_ba_batch_gn"] += s10c.vo.stats["reloc_attempts"]
    want10c["pose_ba_gn"] += n_loop_pass
    ok10c = same10c and repeat10 and n_loop_pass > 0 and launches10c == want10c
    ate10c = mw.good_ate(st10c, T7_10c, T_gt_b8[:N_LOOP])
    print(f"main path 10c (9d's BoxScene frames and options with loop_closing on, the first "
          f"{N_LOOP}): {wall10c:.3f} s; loops closed {s10c.vo.stats['loops_closed_active']} (first "
          f"at frame {k_loop if k_loop < N_LOOP else None}); equal to 9d bit for bit before it: "
          f"{same10c}; the run repeated bit for bit: {repeat10}; {n_loop_pass} mapping passes "
          f"with the loop block of {len(passes10['ms_loop']) + len(passes10['ms_plain'])}; "
          f"launches {launches10c} (expected {want10c}); GOOD "
          f"{st10c.count(vo_mod.Status.GOOD) / N_LOOP:.4f}, ATE {ate10c!r} m: "
          f"{'pass' if ok10c else 'FAIL'}", flush=True)
    if not ok10c:
        raise AssertionError("main path 10c failed its gates")
    print(f"main path 10c mapping pass: {statistics.median(passes10['ms_loop']):.3f} ms "
          f"synchronised with the loop block (median of {len(passes10['ms_loop'])}), "
          f"{statistics.median(passes10['ms_plain']):.3f} ms without it (median of "
          f"{len(passes10['ms_plain'])}, the passes before 4 keyframes)", flush=True)
    # One recorded pass state: the pass with and without the loop block, its
    # kernels under the profiler, and its K10 [256, 256] and K5 launches
    # against their plain versions.
    cam_p, o_p, m_p, fixed_p, loop_p = passes10["rec"]
    for tag, lp in (("with the loop block", loop_p), ("without it", None)):
        ms_pass = _time_host(torch, lambda: real_pass(cam_p, o_p, m_p, fixed_p, loop=lp))
        prof_p = _profile(torch, lambda: real_pass(cam_p, o_p, m_p, fixed_p, loop=lp), 1,
                          f"one mapping pass {tag}")
        print(f"main path 10c one recorded mapping pass {tag}: {ms_pass:.3f} ms synchronised, "
              f"{_nm(_totals(prof_p)[0], '.0f')} device kernels, "
              f"{_nm(_totals(prof_p)[1], '.1f', ' us')} of device time", flush=True)
    with kernels.record_launches() as rec10:
        real_pass(cam_p, o_p, m_p, fixed_p, loop=loop_p)
    a10l = [a for f, a in rec10 if f is k10.distance_matrix]
    a5l = [a for f, a in rec10 if f is k5.pose_ba_gn]
    if len(a10l) != 1 or len(a5l) != 1:
        raise AssertionError(f"the loop block launched {[f.__name__ for f, _ in rec10]}")
    e10l = int((k10.distance_matrix(*a10l[0]) - k10.distance_matrix_plain(*a10l[0])).abs().max())
    print(f"K10 detect_loop {a10l[0][0].shape[0]} x {a10l[0][1].shape[0]}: max |kernel - plain| "
          f"= {e10l} (tolerance 0); kernel {_time_kernel(torch, lambda: k10.distance_matrix(*a10l[0])):.4f} ms, "
          f"bound {k10_bound(*a10l[0])[0]:.6f} ms", flush=True)
    if e10l:
        raise AssertionError("K10 disagrees with its plain version at detect_loop's shape")
    e5l, st5l = check_k5(a5l[0], "N=256 (detect_loop)")
    N5l = a5l[0][0].shape[0]
    print(f"K5 detect_loop N={N5l}: kernel {_time_kernel(torch, lambda: k5.pose_ba_gn(*a5l[0])):.4f} "
          f"ms, plain {_time_host(torch, lambda: k5.pose_ba_gn_plain(*a5l[0])):.4f} ms, bound "
          f"{_bound(N5l * (12 + 8 + 4) + 48 + N5l * 4 + 52, N5l * (180 * st5l['normal_eqs'] + 27 * 25 + 4 * 30))[0]:.6f} ms",
          flush=True)
    # tests/test_relocalization.py's planted 6-keyframe loop through close_loop
    # on the card against the CPU.
    rng10 = np.random.default_rng(1)
    gt10 = [se3.exp(torch.tensor([0.2 * k, 0, 0, 0, 0.05 * k, 0], dtype=torch.float32))
            for k in range(6)]
    est10 = [se3.exp(torch.tensor(rng10.normal(0, 0.02 * min(k, 1) * k, 6),
                                  dtype=torch.float32)).compose(gt10[k]) for k in range(6)]
    cov10 = torch.zeros((6, 6), dtype=torch.int32)
    for k in range(5):
        cov10[k, k + 1] = cov10[k + 1, k] = 30
    pts10 = torch.tensor(rng10.uniform(-1, 1, (20, 3)), dtype=torch.float32)
    first10 = torch.tensor(rng10.integers(0, 6, 20), dtype=torch.int32)
    T_loop10 = gt10[5].compose(gt10[0].inverse())
    res10 = []
    for d_ in (dev, torch.device("cpu")):
        lp = rl.LoopResult(found=torch.tensor(True, device=d_),
                           loop_kf=torch.tensor(0, device=d_),
                           T_loop7=T_loop10.params7().to(d_), scale=torch.tensor(1.0, device=d_))
        res10.append(rl.close_loop(
            torch.stack([e.params7() for e in est10]).to(d_), torch.ones(6, dtype=torch.bool,
                                                                          device=d_),
            cov10.to(d_), pts10.to(d_), torch.ones(20, dtype=torch.bool, device=d_),
            first10.to(d_), 5, lp))
    p_card, p_cpu = res10[0][0].cpu(), res10[1][0]
    d_close = float(se3.distance(SE3.from_params7(p_card), SE3.from_params7(p_cpu)).max())
    opt10 = SE3.from_params7(p_card)
    resid10 = float(torch.linalg.norm(se3.log(T_loop10.compose(SE3(opt10.R[0], opt10.t[0])).compose(
        SE3(opt10.R[5], opt10.t[5]).inverse()))))
    ok10cl = d_close <= TOL_POSE and resid10 < 0.05
    print(f"main path 10c planted loop (tests/test_relocalization.py) through close_loop: card "
          f"against CPU {d_close:.3e} (<= {TOL_POSE}), loop residual {resid10:.4f} (< 0.05): "
          f"{'pass' if ok10cl else 'FAIL'}", flush=True)
    if not ok10cl:
        raise AssertionError("main path 10c: close_loop on the card differs from the CPU")

    # (d) 10a's archive attempt on the card against the CPU: the same archive,
    # features and P3P triples (the card's draws).
    st_c, st_p = {}, {}
    with kernels.record_launches() as rec10d:
        r_c = rl.relocalize_archive(vo10.vocab, cam_a, qd10, qpx10, qv10, arcv10, stages=st_c,
                                    **{**kw10, "generator": torch.Generator(device=dev).manual_seed(5)})
    a_c = st_c["attempt"]
    r_p = rl.relocalize_archive(voc.from_state_dict(voc.state_dict(vo10.vocab), device="cpu"),
                                cam_a, qd10.cpu(), qpx10.cpu(), qv10.cpu(),
                                arc_mod.ArchiveView(*(t.cpu() for t in arcv10)), stages=st_p,
                                **{**{k: v for k, v in kw10.items() if k != "generator"},
                                   "q_angle": kw10["q_angle"].cpu(), "draws": a_c.draws.cpu()})
    a_p = st_p["attempt"]
    d_p10 = float(se3.distance(SE3(r_c.T_cw.R.cpu(), r_c.T_cw.t.cpu()), r_p.T_cw))
    ok10d = (torch.equal(a_c.scores.cpu(), a_p.scores) and torch.equal(a_c.cand.cpu(), a_p.cand)
             and torch.equal(a_c.match_idx.cpu(), a_p.match_idx)
             and int(r_c.kf_slot) == int(r_p.kf_slot) and int(r_c.n_inliers) == int(r_p.n_inliers)
             and bool(r_c.success) and bool(r_p.success) and d_p10 <= TOL_POSE)
    print(f"main path 10d (10a's archive attempt, card against CPU, the card's P3P draws): "
          f"retrieval scores equal: {torch.equal(a_c.scores.cpu(), a_p.scores)}, candidates "
          f"{a_c.cand.tolist()}, matches equal: {torch.equal(a_c.match_idx.cpu(), a_p.match_idx)}, "
          f"inliers per candidate {a_c.n_inl.tolist()} / {a_p.n_inl.tolist()}, winner row "
          f"{int(r_c.kf_slot)} / {int(r_p.kf_slot)}, pose distance {d_p10:.3e} (<= {TOL_POSE}): "
          f"{'pass' if ok10d else 'FAIL'}", flush=True)
    if not ok10d:
        raise AssertionError("main path 10d: the archive attempt on the card differs from the CPU")
    a10d = [a for f, a in rec10d if f is k10.distance_matrix]
    a8d = [a for f, a in rec10d if f is k8.pose_ba_batch_gn]
    if len(a10d) != 2 or len(a8d) != 1:
        raise AssertionError(f"the archive attempt launched {[f.__name__ for f, _ in rec10d]}")
    for a in a10d:
        e = int((k10.distance_matrix(*a) - k10.distance_matrix_plain(*a)).abs().max())
        print(f"K10 archive attempt {a[0].shape[0]} x {a[1].shape[0]}: max |kernel - plain| = {e} "
              f"(tolerance 0); kernel {_time_kernel(torch, lambda: k10.distance_matrix(*a)):.4f} "
              f"ms, bound {k10_bound(*a)[0]:.6f} ms", flush=True)
        if e:
            raise AssertionError("K10 disagrees with its plain version in the archive attempt")
    e8a, st8a = check_k8(a8d[0], f"S={a8d[0][0].shape[0]} N={a8d[0][0].shape[1]} (archive attempt)",
                         flat=True)
    del vo10, vo10b, s10c, s10r

    # -- 5i. main path 11: the archive loops and async mapping ------------------
    print(f"clock: phase 5i starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    from ygz_slam_tpu_torch.geometry import sim3 as sim3_mod
    from ygz_slam_tpu_torch.solvers import pose_graph as pg_mod
    from ygz_slam_tpu_torch.utils import np_se3

    t11 = time.perf_counter()
    real_det, real_clo, real_mpass = (rl.detect_loop_archive, rl.close_loop_global_sim3,
                                      vo_mod.mapping_pass)

    def instrumented(fn, timed=True):
        """`counted(fn)` with the archive loop detections, the Sim(3) global
        closures and the mapping passes with the loop block seen: each
        detection's view capacity (its retrieval launches) and, with `timed`,
        each detection's and closure's synchronised ms (synchronised on the
        thread that runs them: the bits do not change), the first detection
        that finds a loop and the first closure's arguments kept.  Returns
        (counted's 4-tuple, the record)."""
        rec = {"det_ms": [], "det_A": [], "det": None, "clo_ms": [], "clo_size": [],
               "clo": None, "loop_passes": 0}

        def det(*a, **kw):
            if timed:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_det(*a, **kw)
            rec["det_A"].append(int(a[12].valid.shape[0]))
            if timed:
                found = bool(out.found)
                torch.cuda.synchronize()
                rec["det_ms"].append(1e3 * (time.perf_counter() - t))
                if found and rec["det"] is None:
                    rec["det"] = ([x.clone() if isinstance(x, torch.Tensor) else x for x in a[:12]]
                                  + [arc_mod.ArchiveView(*(x.clone() for x in a[12]))], dict(kw))
            return out

        def clo(*a, **kw):
            size = {}
            if timed:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_clo(*a, **{**kw, "stats": size})
            if timed:
                torch.cuda.synchronize()
            rec["clo_ms"].append(1e3 * (time.perf_counter() - t))
            rec["clo_size"].append((size["P"], size["EP"]))
            if rec["clo"] is None:
                rec["clo"] = (a, dict(kw))
            return out

        def mpass(cam, o, mstate, fixed, loop=None):
            rec["loop_passes"] += loop is not None
            return real_mpass(cam, o, mstate, fixed, loop=loop)

        rl.detect_loop_archive, rl.close_loop_global_sim3, vo_mod.mapping_pass = det, clo, mpass
        try:
            out = counted(fn)
        finally:
            rl.detect_loop_archive, rl.close_loop_global_sim3, vo_mod.mapping_pass = (
                real_det, real_clo, real_mpass)
        return out, rec

    def want_loops(n_track, vo, rec):
        """Path 4's counts plus, per mapping pass with the loop block, one K10
        and one K5; per archive loop detection, one K10 per 512 rows of the
        scored view, one K10 for its candidates and one K8; per relocalization
        attempt, one K10 and one K8 (the active window) and two K10 and one K8
        (the archive)."""
        want = want_track(n_track, vo.stats["keyframes"])
        n_att, n_arc = vo.stats["reloc_attempts"], vo.stats["reloc_archive_attempts"]
        want["distance_matrix"] += (rec["loop_passes"] + n_att + 2 * n_arc + sum(
            -(-min(A, rl.ARCHIVE_PREFILTER) // hamming.ARCHIVE_CHUNK) + 1 for A in rec["det_A"]))
        want["pose_ba_gn"] += rec["loop_passes"]
        want["pose_ba_batch_gn"] += len(rec["det_A"]) + n_att + n_arc
        return want

    # (a) tests/test_archive.py's out-and-back sweep at its own 240x320, the
    # default options with ARC_OPTS (async mapping on); the same sweep with the
    # archive off must equal it bit for bit up to the first keyframe whose
    # archive detection applies a correction.  (At 640x480 the return's
    # measured correction sits at the significance gate's floor: whether it
    # closes or only confirms the loop moves with float32 rounding, 0 or 1
    # closures in CPU runs on 3 and 6 threads.)
    cam_o, frames_o, T_gt_o = aw.out_and_back_frames((240, 320), device=dev)
    n_o = frames_o.shape[0]
    vo11 = vo_mod.VisualOdometry(cam_o, aw.loop_options(), device=dev)
    applied11 = []
    real_handle = vo11._handle_archive_loop

    def handle11(slot, kf_fid, lp):
        done = real_handle(slot, kf_fid, lp)
        if done:
            applied11.append(kf_fid)
        return done

    vo11._handle_archive_loop = handle11

    def sweep11(vo):
        for k in range(n_o):
            vo.add_frame(frames_o[k], float(k))
        return aw.out_and_back_gates(vo, T_gt_o)          # joins the last pass

    (g11, wall11, launches11a, n_tr11), rec11 = instrumented(lambda: sweep11(vo11))
    vo11b = vo_mod.VisualOdometry(cam_o, aw.loop_options(archive_map=False), device=dev)
    sweep_off = [vo11b.add_frame(frames_o[k], float(k)).status for k in range(n_o)]
    vo11b.trajectory_poses()
    k_app = applied11[0] if applied11 else n_o - 1
    T7_on = np.stack([p for _, p in vo11.trajectory])
    T7_off = np.stack([p for _, p in vo11b.trajectory])
    same11 = T7_on[:k_app + 1].tobytes() == T7_off[:k_app + 1].tobytes()
    want11a = want_loops(n_tr11, vo11, rec11)
    ok11a = g11["closes"] and same11
    print(f"main path 11a (tests/test_archive.py's out-and-back sweep, PlaneScene seed 3 "
          f"{frames_o.shape[2]}x{frames_o.shape[1]}, VOOptions() with ARC_OPTS: async mapping, "
          f"the depth filter, loops against the window and the archive): {n_o} frames in "
          f"{wall11:.3f} s; {g11['archived']} keyframes archived (> map_K "
          f"{vo11.o.map_K}), global loops closed {g11['closed']} (>= 1), confirmed "
          f"{g11['confirmed']}, corrected ATE {g11['ate']!r} (< 0.10), end-start gap "
          f"{g11['gap']:.4f} of span {g11['span']:.4f}; first applied correction at keyframe "
          f"frame {applied11[0] if applied11 else None}, the sweep equal to the archive-off run "
          f"bit for bit up to it: {same11} (statuses of the off run "
          f"{''.join(s.name[0] for s in sweep_off)}); {'pass' if ok11a else 'FAIL'}; stats "
          f"{dict(vo11.stats)}; launches {launches11a}", flush=True)
    if not ok11a:
        raise AssertionError("main path 11a failed its gates")
    if launches11a != want11a:
        raise AssertionError(f"launch counts {launches11a}, expected {want11a}")
    print(f"main path 11a archive loop detections: {len(rec11['det_ms'])} keyframes, "
          f"{[round(x, 2) for x in rec11['det_ms']]} ms synchronised (median "
          f"{statistics.median(rec11['det_ms']):.2f}), view capacities {rec11['det_A']}; global "
          f"Sim(3) closures: (P, EP) {rec11['clo_size']}, {[round(x, 2) for x in rec11['clo_ms']]} "
          f"ms synchronised", flush=True)
    if rec11["det"] is None or rec11["clo"] is None:
        raise AssertionError("main path 11a kept no found detection or no closure")
    a_d, kw_d = rec11["det"]
    prof11 = _profile(torch, lambda: [bool(real_det(*a_d, **kw_d).found) for _ in range(10)], 10,
                      "one archive loop detection (retrieval, 8 candidates' matching, P3P-RANSAC, "
                      "pose BA, scale) x 10")
    with kernels.record_launches() as rec11d:
        real_det(*a_d, **kw_d)
    a10_11 = [a for f, a in rec11d if f is k10.distance_matrix]
    a8_11 = [a for f, a in rec11d if f is k8.pose_ba_batch_gn]
    if len(a10_11) != 2 or len(a8_11) != 1:
        raise AssertionError(f"the archive loop detection launched {[f.__name__ for f, _ in rec11d]}")
    for a, what in zip(a10_11, ("retrieval", "candidates")):
        e = int((k10.distance_matrix(*a) - k10.distance_matrix_plain(*a)).abs().max())
        print(f"K10 archive loop {what} {a[0].shape[0]} x {a[1].shape[0]}: max |kernel - plain| = "
              f"{e} (tolerance 0); kernel {_time_kernel(torch, lambda: k10.distance_matrix(*a)):.4f} "
              f"ms, bound {k10_bound(*a)[0]:.6f} ms", flush=True)
        if e:
            raise AssertionError("K10 disagrees with its plain version in the archive loop")
    check_k8(a8_11[0], f"S={a8_11[0][0].shape[0]} N={a8_11[0][0].shape[1]} (archive loop)",
             flat=True)
    a_c, kw_c = rec11["clo"]
    ms_clo = _time_host(torch, lambda: real_clo(*a_c, **kw_c))
    prof11c = _profile(torch, lambda: real_clo(*a_c, **kw_c), 1,
                       f"one global Sim(3) closure (P, EP) {rec11['clo_size'][0]}")
    print(f"main path 11a one archive loop detection: {_nm(_totals(prof11, 10)[0], '.1f')} "
          f"device kernels, {_nm(_totals(prof11, 10)[1], '.2f', ' us')} of device time; one "
          f"global closure at (P, EP) {rec11['clo_size'][0]}: {ms_clo:.3f} ms synchronised, "
          f"{_nm(_totals(prof11c)[0], '.0f')} device kernels, "
          f"{_nm(_totals(prof11c)[1], '.1f', ' us')} of device time", flush=True)

    # (b) tests/test_map_merge.py's reset-and-revisit at 640x480.
    cam_mg, frames_mg, _ = aw.merge_frames((480, 640), device=dev)
    vo11m = vo_mod.VisualOdometry(cam_mg, aw.merge_options(), device=dev)
    (out11b, wall11b, launches11b, n_tr11b), rec11b = instrumented(
        lambda: aw.reset_and_revisit(vo11m, frames_mg))
    vo11m.trajectory_poses()
    want11b = want_loops(n_tr11b, vo11m, rec11b)
    print(f"main path 11b (tests/test_map_merge.py's reset and revisit, {frames_mg.shape[2]}x"
          f"{frames_mg.shape[1]}): {frames_mg.shape[0]} + {aw.N_REVISIT} frames in {wall11b:.3f} "
          f"s; after the reset {out11b['after_reset']}; revisit "
          f"{''.join(s.name[0] for s in out11b['statuses'])}; maps merged "
          f"{vo11m.stats['maps_merged']} (>= 1), epoch {vo11m.epoch} (0), the last pose "
          f"{out11b['dt']:.4f} map units (< 0.12) and {out11b['ang']:.4f} rad (< 0.1) from epoch "
          f"0's: {'pass' if out11b['ok'] else 'FAIL'}; stats {dict(vo11m.stats)}; launches "
          f"{launches11b}", flush=True)
    if not out11b["ok"]:
        raise AssertionError("main path 11b failed its gates")
    if launches11b != want11b:
        raise AssertionError(f"launch counts {launches11b}, expected {want11b}")

    # (c) System(camera=cam) with VOOptions() unchanged on path 8a's frames
    # over BOX_SPAN (and frame BOX_SPAN, where 8a's gate reads the map), per
    # frame with async mapping, per frame without it, and chunked: 8a's gate,
    # the three equal bit for bit; each frame's return latency (host clock,
    # no synchronisation beyond the VO's own).
    n_c = BOX_SPAN + 1
    frames_c, ts_c = frames_b8[:n_c], [float(k) for k in range(n_c)]

    def default_run(async_mapping, chunked=False):
        s = (System(camera=cam_b, device=dev) if async_mapping else
             System(camera=cam_b, options=vo_mod.VOOptions(async_mapping=False), device=dev))
        lat, kf_at = [], []

        def run():
            if chunked:
                return s.track_monocular_chunk(frames_c, ts_c, chunk=CHUNK)
            out = []
            for k in range(n_c):
                n_kf = s.vo.stats["keyframes"]
                t = time.perf_counter()
                out.append(s.track_monocular(frames_c[k], ts_c[k]))
                lat.append(1e3 * (time.perf_counter() - t))
                if s.vo.stats["keyframes"] > n_kf:
                    kf_at.append(k)
            return out

        (res, wall, launches, n_tr), rec = instrumented(run, timed=False)
        s.shutdown()
        return s, res, wall, launches, n_tr, rec, lat, kf_at

    runs11c = {name: default_run(*args) for name, args in
               (("async", (True,)), ("sync", (False,)), ("chunked", (True, True)))}
    s_a, res_a, wall_a, launches11c, n_tr11c, rec11c, lat_a, kf_a = runs11c["async"]
    st11c = [r.status for r in res_a]
    T7_11c = np.stack([p for _, p in s_a.vo.trajectory])

    def same_as_async(s, res):
        return (np.stack([p for _, p in s.vo.trajectory_poses()]).tobytes()
                == np.stack([p for _, p in s_a.vo.trajectory_poses()]).tobytes()
                and [r.status for r in res] == st11c and s.vo.stats == s_a.vo.stats
                and all(torch.equal(x, y) for x, y in zip(s.vo.server.state, s_a.vo.server.state)))

    same11c = {name: same_as_async(v[0], v[1]) for name, v in runs11c.items() if name != "async"}
    k0 = mw.init_frame(st11c)
    span11 = st11c[:BOX_SPAN]
    ate11c = mw.good_ate(span11, T7_11c[:BOX_SPAN], T_gt_b8[:BOX_SPAN])
    rows11c = int(s_a.vo.server.state.pt_valid.sum())
    ok11c = (0 <= k0 < 30 and all(x is vo_mod.Status.GOOD for x in span11[k0:])
             and ate11c < DF_ATE and rows11c > rows6b_span[0] and all(same11c.values()))
    lat_kf = {}
    for name in ("async", "sync"):
        lat, kf_at = runs11c[name][6], runs11c[name][7]
        lat_kf[name] = (statistics.median([lat[k] for k in kf_at]),
                        statistics.median([lat[k + 1] for k in kf_at if k + 1 < len(lat)]),
                        statistics.median(lat))
    print(f"main path 11c (System(camera=cam), VOOptions() unchanged, path 8a's BoxScene frames "
          f"0-{BOX_SPAN}): {n_c} frames in {wall_a:.3f} s per frame with async mapping "
          f"({runs11c['sync'][2]:.3f} s without, {runs11c['chunked'][2]:.3f} s chunked); init at "
          f"frame {k0}, frames {k0}-{BOX_SPAN - 1} GOOD: "
          f"{all(x is vo_mod.Status.GOOD for x in span11[k0:])}, ATE {ate11c!r} m (< {DF_ATE}), "
          f"valid landmark rows at frame {BOX_SPAN} {rows11c} (> path 6b's {rows6b_span}); "
          f"without async mapping and chunked equal to it bit for bit: {same11c}; "
          f"{'pass' if ok11c else 'FAIL'}; stats {dict(s_a.vo.stats)}; launches {launches11c}",
          flush=True)
    print(f"main path 11c return latency, median ms (keyframe frames, the frame after each, "
          f"every frame): async mapping {tuple(round(x, 2) for x in lat_kf['async'])}, "
          f"synchronous {tuple(round(x, 2) for x in lat_kf['sync'])}; keyframes at frames "
          f"{kf_a}", flush=True)
    if not ok11c:
        raise AssertionError("main path 11c failed its gates")
    for name in ("async", "sync"):
        s_, _, _, l_, n_, r_ = runs11c[name][:6]
        if l_ != want_loops(n_, s_.vo, r_):
            raise AssertionError(f"main path 11c {name}: launch counts {l_}, expected "
                                 f"{want_loops(n_, s_.vo, r_)}")
    launches11c_all = [runs11c[name][3] for name in runs11c]

    # (d) Path 9e with the archive on: path 6b's frames and options with the
    # vocabulary and the archive (loop closing off); equal to 9e bit for bit
    # up to the first archive relocalization.
    s11d = System(camera=cam_b, options=nw.box_options(use_vocabulary=True, loop_closing=False,
                                                       archive_map=True), device=dev)
    first11d = {}

    def on_frame11d(k, r):
        if s11d.vo.stats["relocs_archive"] and "k" not in first11d:
            first11d["k"] = k

    st11d, T7_11d, wall11d, launches11d, n_tr11d = run_counted(s11d, frames_b6, on_frame11d)
    vo11d = s11d.vo
    k_eq = first11d.get("k", N_BOX)
    same11d = st11d[:k_eq] == st9e[:k_eq] and T7_11d[:k_eq].tobytes() == T7_9e[:k_eq].tobytes()
    ate11d = {n: round(mw.good_ate(st11d[:n], T7_11d[:n], T_gt_b6[:n]), 5)
              for n in (BOX_SPAN, 240, N_BOX)}
    want11d = want_loops(n_tr11d, vo11d, {"loop_passes": 0, "det_A": []})
    print(f"main path 11d (path 9e with the archive on): {N_BOX} frames in {wall11d:.3f} s; "
          f"first archive relocalization at frame {first11d.get('k')}; equal to 9e bit for bit "
          f"before it: {same11d}.  Reported: GOOD {st11d.count(vo_mod.Status.GOOD) / N_BOX:.4f} "
          f"(9e {st9e.count(vo_mod.Status.GOOD) / N_BOX:.4f}), {vo11d.stats['reloc_attempts']} "
          f"attempts (9e {n_att9e}), {vo11d.stats['reloc_archive_attempts']} archive attempts, "
          f"{vo11d.stats['relocalizations']} relocalizations ({vo11d.stats['relocs_archive']} "
          f"through the archive; 9e {n_rel9e}), {nw.segments(st11d) - 1} reset(s) (9e "
          f"{nw.segments(st9e) - 1}), LOST frames {st11d.count(vo_mod.Status.LOST)} (9e "
          f"{st9e.count(vo_mod.Status.LOST)}), ATE over the first n frames {ate11d} (9e "
          f"{ate9e}); {vo11d.archive.count} archive rows; launches {launches11d}", flush=True)
    if not same11d:
        raise AssertionError("main path 11d differs from 9e before any archive relocalization")
    if launches11d != want11d:
        raise AssertionError(f"launch counts {launches11d}, expected {want11d}")

    # (e) The Sim(3) solves on the card: tests/test_sim3.py's drifted loop
    # through optimize_sim3 and close_loop_global_sim3 against the CPU, then
    # one global closure at P = 512 nodes (~300 archived keyframes, as a
    # 2000-frame run holds, and 10 active), timed.
    K_d, drift = 24, 1.02
    ring = np.asarray([[2 * np.cos(2 * np.pi * k / K_d), 2 * np.sin(2 * np.pi * k / K_d), 0.0]
                       for k in range(K_d)], np.float32)
    gt_d = np.stack([np.concatenate([[1, 0, 0, 0], -c]) for c in ring]).astype(np.float32)
    est_d = [gt_d[0]]
    for k in range(1, K_d):
        T_rel = np_se3.relative7(gt_d[k], gt_d[k - 1]).copy()
        T_rel[4:7] *= drift ** k
        est_d.append(np_se3.compose7(T_rel, est_d[-1]))
    est_d = np.asarray(est_d, np.float32)
    T_d = [np_se3.relative7(est_d[k + 1], est_d[k]) for k in range(K_d - 1)]
    T_d.append(np_se3.relative7(gt_d[0], gt_d[K_d - 1]))
    e8_d = np.asarray([np.concatenate([T_d[k], [1.0]]) for k in range(K_d - 1)]
                      + [np.concatenate([T_d[-1], [drift ** -(K_d - 1)]])], np.float32)
    fixed_d = np.zeros(K_d, bool)
    fixed_d[0] = True

    def sim3_solve(d_):
        edges = pg_mod.Sim3Edges(
            torch.arange(K_d, dtype=torch.int32, device=d_),
            torch.roll(torch.arange(K_d, dtype=torch.int32, device=d_), -1),
            torch.tensor(e8_d, device=d_), torch.ones(K_d, device=d_),
            torch.ones(K_d, dtype=torch.bool, device=d_))
        p, _ = pg_mod.optimize_sim3(
            sim3_mod.Sim3.from_se3(SE3.from_params7(torch.tensor(est_d, device=d_))), edges,
            torch.tensor(fixed_d, device=d_), n_iter=30)
        return p.params8().cpu()

    A_d = 16
    g_args = (est_d[:A_d], np.arange(A_d, dtype=np.int32), est_d[A_d:],
              np.arange(A_d, K_d, dtype=np.int32), np.zeros((K_d - A_d, K_d - A_d), np.int32), 0,
              K_d - A_d - 1, np_se3.relative7(gt_d[-1], gt_d[0]).astype(np.float32))
    g_card = real_clo(*g_args, loop_scale=drift ** (K_d - 1), n_iter=30, device=dev)
    g_cpu = real_clo(*g_args, loop_scale=drift ** (K_d - 1), n_iter=30, device="cpu")
    d_opt = float((sim3_solve(dev) - sim3_solve("cpu")).abs().max())
    d_glob = max(float(np.abs(a - b).max()) for a, b in zip(g_card[:4], g_cpu[:4]))
    ok11e = d_opt <= TOL_POSE and d_glob <= TOL_POSE
    print(f"main path 11e drifted loop (tests/test_sim3.py) on the card against the CPU: "
          f"optimize_sim3 {d_opt:.3e}, close_loop_global_sim3 {d_glob:.3e} (<= {TOL_POSE}): "
          f"{'pass' if ok11e else 'FAIL'}", flush=True)
    if not ok11e:
        raise AssertionError("main path 11e: the Sim(3) solves on the card differ from the CPU")
    n_arc, n_act = 300, 10
    rng11 = np.random.default_rng(11)
    ang = 2 * np.pi * np.arange(n_arc + n_act) / (n_arc + n_act)
    big7 = np.concatenate([np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], 1),
                           np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                                     rng11.normal(0, 0.05, ang.shape)], 1)], 1).astype(np.float32)
    cov_b = np.zeros((n_act, n_act), np.int32)
    for k in range(n_act - 1):
        cov_b[k, k + 1] = cov_b[k + 1, k] = 40
    b_args = (big7[:n_arc], np.arange(n_arc, dtype=np.int32), big7[n_arc:],
              np.arange(n_arc, n_arc + n_act, dtype=np.int32), cov_b, 0, n_act - 1,
              np_se3.relative7(big7[0], big7[0]).astype(np.float32))
    size_b = {}
    real_clo(*b_args, loop_scale=1.05, n_iter=25, device=dev, stats=size_b)
    ms_b = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_clo(*b_args, loop_scale=1.05, n_iter=25, device=dev)
        torch.cuda.synchronize()
        ms_b.append(1e3 * (time.perf_counter() - t))
    prof11e = _profile(torch, lambda: real_clo(*b_args, loop_scale=1.05, n_iter=25, device=dev),
                       1, f"one global Sim(3) closure at (P, EP) ({size_b['P']}, {size_b['EP']})")
    print(f"main path 11e one global closure over {n_arc} archived and {n_act} active keyframes "
          f"(P, EP) ({size_b['P']}, {size_b['EP']}), 25 iterations: {statistics.median(ms_b):.2f} "
          f"ms synchronised (median of 3; {[round(x, 2) for x in ms_b]}), "
          f"{_nm(_totals(prof11e)[0], '.0f')} device kernels, "
          f"{_nm(_totals(prof11e, 1e3)[1], '.3f', ' ms')} of device time", flush=True)
    print(f"main path 11: {time.perf_counter() - t11:.1f} s", flush=True)
    # Path 11a's map (its archive rows included) for path 12c.
    from ygz_slam_tpu_torch.system import system as sysmod

    tmp12 = tempfile.mkdtemp(prefix="ygz_map_")
    map11 = os.path.join(tmp12, "out_and_back.npz")
    sysmod.save_map(vo11, map11)
    arc11_rows = vo11.archive.count
    del vo11, vo11b, vo11m, runs11c, s_a, s11d, vo11d

    # -- 5j. main path 12: depth sensors and the map file ----------------------
    print(f"clock: phase 5j starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    from ygz_slam_tpu_torch.system import trajectory as traj
    from ygz_slam_tpu_torch.system import viewer
    from ygz_slam_tpu_torch.system.config import VO_CONFIG_KEYS, Config, apply_to
    from ygz_slam_tpu_torch.system.system import Sensor
    from ygz_slam_tpu_torch.utils.datasets import SyntheticDataset

    t12 = time.perf_counter()
    ds12 = SyntheticDataset(cam_m, n_frames=N_SENSOR, shape=SENSOR_SHAPE, with_depth=True,
                            device=dev)
    fr12 = list(ds12)
    gt12 = [fd.T_cw_gt for fd in fr12]

    def sensor_gate(res):
        """(GOOD frames, rigid ATE over them)."""
        good = [k for k, r in enumerate(res) if r.status is vo_mod.Status.GOOD]
        ate = traj.ate_rmse(traj.camera_centers([res[k].T_cw for k in good]),
                            traj.camera_centers([gt12[k] for k in good]), with_scale=False)
        return len(good), ate

    def timed_insertions(vo, label):
        """The VO's sensor keyframe insertions, each up to its mapping pass
        (which then runs as it would): the first under the profiler, the rest
        synchronised and timed."""
        rec = {"ms": [], "prof": None, "profiled": False}
        real = vo._insert_sensor_keyframe

        def insert(pyr, T_cw, tm):
            finish, pending = vo._finish_insert, []
            vo._finish_insert = lambda *a: pending.append(a)
            try:
                if not rec["profiled"]:
                    rec["profiled"] = True
                    rec["prof"] = _profile(torch, lambda: real(pyr, T_cw, tm), 1,
                                           f"{label}: one sensor keyframe insertion", again=False)
                else:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    real(pyr, T_cw, tm)
                    torch.cuda.synchronize()
                    rec["ms"].append(1e3 * (time.perf_counter() - t))
            finally:
                vo._finish_insert = finish
            finish(*pending[0])

        vo._insert_sensor_keyframe = insert
        return rec

    def sensor_run(system, track, frames):
        """Every frame through `track` under `instrumented`, the launch
        counts checked: (results, each frame's return latency in ms on the
        host clock, launches)."""
        lat = []

        def run():
            out = []
            for f in frames:
                t = time.perf_counter()
                out.append(track(*f))
                lat.append(1e3 * (time.perf_counter() - t))
            system.shutdown()
            return out

        (res, _, launches, n_tr), rec = instrumented(run, timed=False)
        want = want_loops(n_tr, system.vo, rec)
        if launches != want:
            raise AssertionError(f"main path 12: launch counts {launches}, expected {want}")
        return res, lat, launches

    # (a) RGBD: the JAX SyntheticDataset's defaults at 640x480 through
    # System(sensor=RGBD) with VOOptions(); tests/test_system.py's gates.  The
    # camera and the options come through the configuration (`Config.set_dict`:
    # the card's machine has no PyYAML for a file), which sets path 4's
    # camera and the default keyframe interval.
    Config.set_dict({"camera": {"fx": cam_m.fx, "fy": cam_m.fy, "cx": cam_m.cx, "cy": cam_m.cy},
                     "keyframe": {"min_frames": vo_mod.VOOptions().kf_min_frames}})
    try:
        s12 = System(sensor=Sensor.RGBD, options=apply_to(vo_mod.VOOptions(), VO_CONFIG_KEYS),
                     device=dev)
    finally:
        Config.clear()
    if s12.vo.cam != cam_m or s12.vo.o != vo_mod.VOOptions():
        raise AssertionError("main path 12a: the configuration did not give path 4's camera and "
                             "VOOptions()")
    ins12 = timed_insertions(s12.vo, "main path 12a")
    res12a, lat12a, launches12a = sensor_run(
        s12, s12.track_rgbd, [(fd.gray, fd.depth, fd.timestamp) for fd in fr12])
    good12a, ate12a = sensor_gate(res12a)
    k12, us12 = _totals(ins12["prof"])
    ok12a = good12a >= 0.75 * N_SENSOR and ate12a < SENSOR_ATE
    print(f"main path 12a (RGBD, SyntheticDataset {SENSOR_SHAPE[1]}x{SENSOR_SHAPE[0]}, "
          f"{N_SENSOR} frames, VOOptions()): {good12a} GOOD (>= 75%), rigid ATE {ate12a!r} m "
          f"(< {SENSOR_ATE}): {'pass' if ok12a else 'FAIL'}; return latency "
          f"{statistics.median(lat12a):.2f} ms per frame (median; mean {statistics.mean(lat12a):.2f} with the keyframes, one "
          f"under the profiler); a sensor keyframe insertion "
          f"{statistics.median(ins12['ms'] or [float('nan')]):.2f} ms synchronised (median of "
          f"{len(ins12['ms'])}), "
          f"{_nm(k12, '.0f')} device kernels and {_nm(us12, '.1f', ' us')} of device time (the "
          f"first); path 4's "
          f"monocular keyframe cycle {kf_cycle_ms4[3]:.2f} ms; stats {dict(s12.vo.stats)}; "
          f"launches {launches12a}", flush=True)
    if not ok12a:
        raise AssertionError("main path 12a failed its gates")
    # The first DENSE_FRAMES frames with the DENSE map: every cloud on the plane.
    s12d = System(camera=cam_m, sensor=Sensor.RGBD,
                  options=vo_mod.VOOptions(map_type=vo_mod.MapType.DENSE), device=dev)
    _, _, launches12d = sensor_run(
        s12d, s12d.track_rgbd, [(fd.gray, fd.depth, fd.timestamp) for fd in fr12[:DENSE_FRAMES]])
    dense = s12d.vo.dense_cloud
    z12 = np.concatenate(dense)[:, 2] if dense else np.zeros(0)
    cloud12 = s12d.export_point_cloud()
    ply12 = os.path.join(tmp12, "cloud.ply")
    viewer.save_ply(ply12, cloud12)
    with open(ply12) as f:
        n_ply = sum(1 for _ in f) - 7                         # the header's 7 lines
    ok12d = (len(dense) >= 1 and bool(np.all(np.abs(z12 - 3.0) <= 0.05))
             and n_ply == len(cloud12) == int(s12d.vo.server.state.pt_valid.sum()) + len(z12))
    print(f"main path 12a DENSE, frames 0-{DENSE_FRAMES - 1}: {len(dense)} clouds of "
          f"{[len(c) for c in dense]} points, z in [{z12.min():.4f}, {z12.max():.4f}] (plane 3 "
          f"+- 0.05); the exported cloud ({len(cloud12)} points with the landmarks) in "
          f"`save_ply`'s file: {n_ply} vertices: {'pass' if ok12d else 'FAIL'}; launches "
          f"{launches12d}", flush=True)
    if not ok12d:
        raise AssertionError("main path 12a's DENSE cloud is off the plane")

    def sensor_start(device, **kw):
        """Frame 0 through a fresh VisualOdometry(VOOptions()) on `device`:
        keyframe 0's feature pixels, depths and landmark positions (CPU)."""
        vo = vo_mod.VisualOdometry(cam_m, vo_mod.VOOptions(), device=device)
        vo.add_frame(fr12[0].gray.to(device), 0.0, **{k: v.to(device) for k, v in kw.items()})
        m = vo.server.state
        fp, fv = m.feat_point[0].cpu(), m.feat_valid[0].cpu()
        pos = torch.where((fp >= 0)[:, None], m.pt_pos.cpu()[fp.clamp(min=0).long()], 0.0)
        return m.feat_px[0].cpu()[fv], m.feat_depth[0].cpu()[fv], pos[fv]

    def compare_starts(label, **kw):
        (px_c, d_c, p_c), (px_h, d_h, p_h) = sensor_start(dev, **kw), sensor_start("cpu", **kw)
        dist = (px_c[:, None] - px_h[None]).abs().amax(-1)
        hit = dist.amin(1) <= 1e-3
        j = dist.argmin(1)[hit]
        same = ((d_c[hit] > 0) == (d_h[j] > 0)).float().mean().item()
        both = (d_c[hit] > 0) & (d_h[j] > 0)
        dp = (p_c[hit][both] - p_h[j][both]).abs().max().item()
        ok = hit.float().mean().item() >= 0.95 and same >= MIN_MASK_AGREE and dp <= TOL_POSE
        print(f"main path 12 {label} start on the card against the CPU: "
              f"{hit.float().mean().item():.4f} of {len(px_c)} features at the same pixel, the "
              f"sensor decision equal on {same:.4f}, landmarks within {dp:.3e} m (<= {TOL_POSE}): "
              f"{'pass' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"main path 12: the {label} start differs on the card")

    compare_starts("12a RGBD", depth=fr12[0].depth)

    # (b) STEREO: the same trajectory rendered as a rectified pair.
    shift = SE3(torch.eye(3, device=dev), torch.tensor([-BASELINE, 0.0, 0.0], device=dev))
    right12 = [ds12.scene.render(shift.compose(T), SENSOR_SHAPE) for T in gt12]
    ms_st, st_args, real_ms = [], [], vo_mod.match_stereo

    def timed_match(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_ms(*a, **kw)
        torch.cuda.synchronize()
        ms_st.append(1e3 * (time.perf_counter() - t))
        if not st_args:
            st_args.append(([x.clone() if isinstance(x, torch.Tensor) else x for x in a], kw))
        return out

    s12s = System(camera=cam_m, sensor=Sensor.STEREO, device=dev)
    vo_mod.match_stereo = timed_match
    try:
        res12b, lat12b, launches12b = sensor_run(
            s12s, s12s.track_stereo, [(fd.gray, r, fd.timestamp) for fd, r in zip(fr12, right12)])
    finally:
        vo_mod.match_stereo = real_ms
    good12b, ate12b = sensor_gate(res12b)
    a_st, kw_st = st_args[0]
    k_st, us_st = _totals(_profile(torch, lambda: real_ms(*a_st, **kw_st), 1,
                                    "main path 12b: one match_stereo call"))
    on_card = real_ms(*a_st, **kw_st)
    on_cpu = real_ms(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in a_st], **kw_st)
    agree = (on_card.ok.cpu() == on_cpu.ok).float().mean().item()
    both = on_card.ok.cpu() & on_cpu.ok
    rel = ((on_card.depth.cpu() - on_cpu.depth).abs() / on_cpu.depth)[both]
    ok12b = (14 * good12b >= 11 * N_SENSOR and ate12b < SENSOR_ATE and agree >= MIN_MASK_AGREE
             and (rel <= TOL_STEREO).float().mean().item() >= MIN_MASK_AGREE)
    print(f"main path 12b (STEREO, the same trajectory as a rectified pair, baseline {BASELINE} "
          f"m): {good12b} GOOD (>= 11/14), rigid ATE {ate12b!r} m (< {SENSOR_ATE}); return "
          f"latency {statistics.median(lat12b):.2f} ms per frame (median; mean "
          f"{statistics.mean(lat12b):.2f}); match_stereo {len(ms_st)} calls, "
          f"{statistics.median(ms_st):.2f} ms synchronised (median), {_nm(k_st, '.0f')} device "
          f"kernels and {_nm(us_st, '.1f', ' us')} of device time per call; the first call on the card against the CPU: "
          f"ok flags equal on {agree:.4f} ({int(on_card.ok.sum())} accepted), depth where both "
          f"accept within {rel.max().item():.3e} relative (<= {TOL_STEREO} on "
          f"{(rel <= TOL_STEREO).float().mean().item():.4f}): {'pass' if ok12b else 'FAIL'}; "
          f"stats {dict(s12s.vo.stats)}; launches {launches12b}", flush=True)
    if not ok12b:
        raise AssertionError("main path 12b failed its gates")
    compare_starts("12b STEREO", right=right12[0])

    # (c) The map file: 12a's map and path 11a's, written on the card, loaded
    # on the card and on the CPU and written again (bit for bit), then path
    # 11a's map resumed by relocalization.
    def npz(path):
        with np.load(path) as f:
            return dict(f)

    def same_files(a, b):
        return set(a) == set(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                                        for k in a)

    p12 = os.path.join(tmp12, "rgbd.npz")
    torch.cuda.synchronize()
    t = time.perf_counter()
    s12.save_map(p12)
    save_ms = 1e3 * (time.perf_counter() - t)
    rep12 = {}
    for label, path, make in (
            ("12a RGBD", p12, lambda d: System(camera=cam_m, sensor=Sensor.RGBD, device=d)),
            ("11a out-and-back", map11,
             lambda d: System(camera=cam_o, options=aw.loop_options(), device=d))):
        data = npz(path)
        out = {}
        for d in (dev, "cpu"):
            s_l = make(d)
            torch.cuda.synchronize()
            t = time.perf_counter()
            s_l.load_map(path)
            torch.cuda.synchronize()
            out[str(d)] = 1e3 * (time.perf_counter() - t)
            again = os.path.join(tmp12, f"again_{d}.npz")
            s_l.save_map(again)
            out[f"same_{d}"] = same_files(data, npz(again))
            out[f"s_{d}"] = s_l
        rows = out[f"s_{dev}"].vo.archive.count
        rep12[label] = (out, rows, os.path.getsize(path))
        print(f"main path 12c {label} map file: {os.path.getsize(path)} bytes, {len(data)} arrays, "
              f"{rows} archive rows; load_map {out[str(dev)]:.1f} ms on the card, "
              f"{out['cpu']:.1f} ms on the CPU; written again equal bit for bit: card "
              f"{out[f'same_{dev}']}, CPU {out['same_cpu']}", flush=True)
        if not (out[f"same_{dev}"] and out["same_cpu"]):
            raise AssertionError(f"main path 12c: {label}'s map does not round-trip bit for bit")
    loaded = rep12["12a RGBD"][0][f"s_{dev}"].vo
    same_state = (all(torch.equal(a, b) for a, b in zip(loaded.server.state, s12.vo.server.state))
                  and torch.equal(loaded.kf_images, s12.vo.kf_images)
                  and torch.equal(loaded.kf_bow, s12.vo.kf_bow)
                  and torch.equal(loaded.kf_nodes, s12.vo.kf_nodes)
                  and same_files(loaded.archive.state_dict(), s12.vo.archive.state_dict()))
    if not same_state or rep12["11a out-and-back"][1] != arc11_rows or arc11_rows == 0:
        raise AssertionError(f"main path 12c: the loaded map differs from the saved one "
                             f"({same_state}, archive rows {rep12['11a out-and-back'][1]} of "
                             f"{arc11_rows})")
    # Resume: the loaded out-and-back map tracks the frame of its third
    # keyframe and the next (test_resume_from_saved_map's gates).
    s_r = rep12["11a out-and-back"][0][f"s_{dev}"]
    fid_r = int(s_r.vo.server.state.kf_id[s_r.vo.server.kf_used[2]])
    (res12c, _, launches12c, n_tr12c), rec12c = instrumented(
        lambda: [s_r.track_monocular(frames_o[fid_r + i], 100.0 + i) for i in range(2)],
        timed=False)
    s_r.shutdown()
    want12c = want_loops(n_tr12c, s_r.vo, rec12c)
    ok12c = (res12c[0].status is vo_mod.Status.GOOD and res12c[1].status is vo_mod.Status.GOOD
             and res12c[1].n_inliers > 50 and launches12c == want12c
             and launches12c["distance_matrix"] >= 1 and launches12c["pose_ba_batch_gn"] >= 1)
    print(f"main path 12c resume of the out-and-back map at frame {fid_r}: "
          f"{res12c[0].status.name} ({res12c[0].n_inliers} inliers), then "
          f"{res12c[1].status.name} ({res12c[1].n_inliers}, > 50): {'pass' if ok12c else 'FAIL'}; "
          f"save_map {save_ms:.1f} ms (12a's map); stats {dict(s_r.vo.stats)}; launches "
          f"{launches12c} (expected {want12c})", flush=True)
    if not ok12c:
        raise AssertionError("main path 12c: the loaded map did not resume")
    shutil.rmtree(tmp12, ignore_errors=True)
    print(f"main path 12: {time.perf_counter() - t12:.1f} s", flush=True)
    del s12, s12d, s12s, s_r, rep12, loaded, fr12, right12

    # -- 5k. main path 13: the SPARSE_ORB and SEMI_DENSE_DIRECT frontends ----
    print(f"clock: phase 5k starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    from ygz_slam_tpu_torch.models import orb_tracking as orbt
    from ygz_slam_tpu_torch.models.frontend import Features
    from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

    t13 = time.perf_counter()
    trackers13 = ("track_orb", "track_orb_wide", "track_sd")
    latency13 = {}

    def want13(n_track, vo, rec, calls):
        """`want_loops` plus, per SPARSE_ORB pass (`track_orb`, and
        `track_orb_wide` on a second-chance frame), two K10 [L, F] and two K5
        [L] launches; per SEMI_DENSE_DIRECT frame (`track_sd`) K1 twice (the
        keyframe's 7x7 reference levels, the frame's windows), K3 once at
        map_F + sd_budget points and K2, K4 and K5 once at L rows."""
        want = want_loops(n_track, vo, rec)
        n_orb = calls["track_orb"] + calls["track_orb_wide"]
        n_sd = calls["track_sd"]
        want["distance_matrix"] += 2 * n_orb
        want["pose_ba_gn"] += 2 * n_orb + n_sd
        want["gather_windows_levels"] += 2 * n_sd
        for name in ("mega_gn", "gather_windows_multi", "a2d_gn"):
            want[name] += n_sd
        return want

    def frontend_run(system, frames_, label, rec_call=None, profile_at=None, on_frame=None):
        """Every frame of frames_ through `system.track_monocular` under
        `instrumented` (launches, calls of `track`, loop passes and archive
        detections counted), each frontend tracker's calls counted; call
        `rec_call` of `track_orb` or `track_sd` runs with its launches
        recorded (and, for SPARSE_ORB, its first `match_by_projection`
        call's arguments); frames profile_at[0]..profile_at[1] - 1 run under
        the profiler.  Each other frame's return latency (host clock) lands
        in `latency13[label]`.  Returns (statuses, T7 as tracked, wall s,
        launches, calls of track, tracker calls, instrumented's record, the
        recorded call, the profile window's rows)."""
        calls = dict.fromkeys(trackers13, 0)
        recorded, prof = {}, {}
        lat = latency13.setdefault(label, [])
        reals = {n: getattr(vo_mod, n) for n in trackers13}
        real_match = orbt.match_by_projection

        def wrap(name):
            def fn(*a, **kw):
                calls[name] += 1
                if name == "track_orb_wide" or calls[name] != rec_call:
                    return reals[name](*a, **kw)

                def match(*ma, **mkw):
                    recorded.setdefault("match", (ma, mkw))
                    return real_match(*ma, **mkw)

                orbt.match_by_projection = match
                try:
                    with kernels.record_launches() as r:
                        out = reals[name](*a, **kw)
                finally:
                    orbt.match_by_projection = real_match
                recorded["launches"] = r
                return out
            return fn

        def run():
            statuses, k, n = [], 0, frames_.shape[0]
            while k < n:
                if profile_at is not None and k == profile_at[0]:
                    a, b = profile_at
                    prof["rows"] = _profile(
                        torch, lambda: statuses.extend(
                            system.track_monocular(frames_[j], float(j)).status
                            for j in range(a, b)),
                        b - a, f"main path {label} (frames {a}-{b - 1})", again=False)
                    k = b
                    continue
                t = time.perf_counter()
                statuses.append(system.track_monocular(frames_[k], float(k)).status)
                lat.append(1e3 * (time.perf_counter() - t))
                if on_frame is not None:
                    on_frame(k, system.vo)
                k += 1
            system.shutdown()
            return statuses

        for n in trackers13:
            setattr(vo_mod, n, wrap(n))
        try:
            (st, wall, launches, n_tr), rec = instrumented(run, timed=False)
        finally:
            for n, f in reals.items():
                setattr(vo_mod, n, f)
        T7 = np.stack([p for _, p in system.vo.trajectory])
        return st, T7, wall, launches, n_tr, calls, rec, recorded, prof.get("rows")

    def kernel_rows13(recorded, tag):
        """Each kernel of a recorded frame against its plain version (the
        phase-2 checks) at path 13's shapes, with its CUDA-event ms, plain
        ms, library ms and bound printed."""
        rows = {}
        by = {}
        for fn, args in recorded["launches"]:
            by.setdefault(fn.__name__, []).append(args)
        if "gather_windows_levels" in by:
            g1 = by["gather_windows_levels"]
            e = check_k1(g1, tag)
            rows["K1"] = dict(err=e, ms=sum(_time_kernel(torch, lambda g=g: k1_call(g)) for g in g1),
                              plain=sum(_time_host(torch, lambda g=g: k1_call(g, plain=True))
                                        for g in g1),
                              lib=None, bound=_bound(sum(_gather_bytes(torch, k1_levels(g))
                                                         for g in g1), 0.0),
                              shape=[f"{len(g[0])} levels x {g[1].shape[1]} x {g[3]}^2"
                                     for g in g1])
        if "mega_gn" in by:
            (a3_,) = by["mega_gn"]
            e, st3_ = check_k3(a3_, tag)
            Lq, Nq = a3_[4].shape
            rows["K3"] = dict(err=e, ms=_time_kernel(torch, lambda: k3.mega_gn(*a3_)),
                              plain=_time_host(torch, lambda: k3.mega_gn_plain(*a3_)), lib=None,
                              bound=_bound(Lq * Nq * (256 + 16 + 96 + 1 + 2) * 4 + Nq * 12 + 100,
                                           sum(Nq * (700 + 400 * p) for p in st3_["passes"])),
                              shape=f"N={Nq}", passes=sum(st3_["passes"]))
        if "gather_windows_multi" in by:
            (a2_,) = by["gather_windows_multi"]
            e = check_k2(a2_, tag + f", a table of the {len(a2_[0])} levels")
            r = k2_times(a2_, tag)
            rows["K2"] = dict(r, err=e, shape=f"N={a2_[1].shape[0]}")
        if "a2d_gn" in by:
            (a4_,) = by["a2d_gn"]
            xy0_ = a4_[7]
            e = check_k4((a4_, xy0_, (xy0_ != k1.PATCH + 2.0).any(dim=1), *frames_m.shape[1:]),
                         tag)
            Nq = xy0_.shape[0]
            rows["K4"] = dict(err=e, ms=_time_kernel(torch, lambda: k4.a2d_gn(*a4_)),
                              plain=_time_host(torch, lambda: k4.a2d_gn_plain(*a4_)), lib=None,
                              bound=_bound(Nq * (1024 * 4 + 3 * 64 * 4 + 36 + 8 + 8 + 16),
                                           k4_ops(a4_)), shape=f"N={Nq}")
        for i, a5_ in enumerate(by.get("pose_ba_gn", [])):
            e, st5_ = check_k5(a5_, tag + f", solve {i + 1}")
            Nq = a5_[0].shape[0]
            rows[f"K5.{i + 1}"] = dict(
                err=e, ms=_time_kernel(torch, lambda: k5.pose_ba_gn(*a5_)),
                plain=_time_host(torch, lambda: k5.pose_ba_gn_plain(*a5_)), lib=None,
                bound=_bound(Nq * (12 + 8 + 4) + 48 + Nq * 4 + 52,
                             Nq * (180 * st5_["normal_eqs"] + 27 * 25 + 4 * 30)),
                shape=f"N={Nq} ({int(a5_[2].sum())} matched)", links=_k5_links(st5_["normal_eqs"]))
        for i, (a, b) in enumerate(by.get("distance_matrix", [])):
            e = check_exact("K10 hamming distance_matrix", [k10.distance_matrix(a, b)],
                            [k10.distance_matrix_plain(a, b)], tag + f", {a.shape[0]} x {b.shape[0]}")
            ab, bb = unpack_bits(a), unpack_bits(b)
            rows[f"K10.{i + 1}"] = dict(
                err=e, ms=_time_kernel(torch, lambda: k10.distance_matrix(a, b)),
                plain=_time_host(torch, lambda: k10.distance_matrix_plain(a, b)),
                lib=_time_kernel(torch, lambda: torch.cdist(ab, bb, p=0)), bound=k10_bound(a, b),
                shape=f"[{a.shape[0]}, {b.shape[0]}]")
        for k, r in rows.items():
            lib = "null" if r["lib"] is None else f"{r['lib']:.4f}"
            print(f"path 13 {tag}: {k} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain']:.4f} ms, library {lib} ms, bound {r['bound'][0]:.6f} ms "
                  f"({r['bound'][1]})" + (f", {r['passes']} passes" if "passes" in r else "")
                  + (f", {r['links']} reductions" if "links" in r else ""), flush=True)

    def frontend_gate(label, st, T7, ref, vo, wall, prof, n_calls):
        """The run's report and its gates against the JAX package's CPU run
        of the same frames (`ref`: GOOD share, ATE): a GOOD share at least
        the reference's, an ATE at most ATE13_SLACK x the reference's."""
        sd = None if vo.sd is None else (vo.sd.px.cpu().numpy(), vo.sd.usable().cpu().numpy(),
                                         vo.sd.depths().cpu().numpy(), vo.sd.kf_slot)
        out = mw.frontend_report(st, T7, T_gt_m, vo.export_point_cloud(),
                                 int(vo.server.state.pt_valid.sum()), dict(vo.stats), sd,
                                 vo.server.state.kf_id.cpu().numpy(), cam_m)
        k_f, us_f = _totals(prof, P13_PROFILE[1] - P13_PROFILE[0])
        lat = sorted(latency13[label])
        ok = out["good"] >= ref["good"] and out["ate"] <= ATE13_SLACK * ref["ate"]
        print(f"main path {label}: {len(st)} frames in {wall:.3f} s = {wall * 1e3 / len(st):.2f} "
              f"ms per frame (return latency outside the profile window: median "
              f"{statistics.median(lat):.2f} ms, 90th percentile {lat[int(0.9 * len(lat))]:.2f}, "
              f"max {lat[-1]:.2f}); {n_calls} tracker calls; GOOD {out['good']:.4f} (JAX CPU "
              f"{ref['good']:.4f}), ATE {out['ate']!r} m (JAX CPU {ref['ate']!r}, bound "
              f"{ATE13_SLACK} x): {'pass' if ok else 'FAIL'}; report {out}; profile window "
              f"{_nm(k_f, '.1f')} device kernels and {_nm(us_f, '.1f', ' us')} of device time per "
              f"frame; stats {dict(vo.stats)}", flush=True)
        return ok, out

    # (a) SPARSE_ORB, VOOptions() otherwise, path 4's 160 frames.
    opts13a = mw.frontend_options(vo_mod.VOType.SPARSE_ORB)
    s13a = System(camera=cam_m, options=opts13a, device=dev)
    st13a, T7_13a, wall13a, launches13a, n_tr13a, calls13a, rec13a, recd13a, prof13a = \
        frontend_run(s13a, frames_m, "13a, SPARSE_ORB", rec_call=P13_REC, profile_at=P13_PROFILE)
    want13a = want13(n_tr13a, s13a.vo, rec13a, calls13a)
    ok13a, _ = frontend_gate("13a, SPARSE_ORB", st13a, T7_13a, ORB13_REF,
                                          s13a.vo, wall13a, prof13a, calls13a)
    names13a = [fn.__name__ for fn, _ in recd13a["launches"]]
    print(f"main path 13a launches {launches13a} (expected {want13a}); tracker call {P13_REC} "
          f"launched {names13a}", flush=True)
    if (not ok13a or launches13a != want13a or n_tr13a != 0
            or names13a != ["distance_matrix", "pose_ba_gn"] * 2):
        raise AssertionError("main path 13a failed its gates or launch counts")
    # The card's matches against the CPU's on the recorded frame's first pass.
    (ma13, mkw13) = recd13a["match"]
    m_card, obs_card, _ = orbt.match_by_projection(*ma13, **mkw13)
    cam13, T13, pts13, val13, desc13, feats13 = ma13
    m_cpu, obs_cpu, _ = orbt.match_by_projection(
        cam13, SE3(T13.R.cpu(), T13.t.cpu()), pts13.cpu(), val13.cpu(), desc13.cpu(),
        Features(*(x.cpu() for x in feats13)), **mkw13)
    m_card, obs_card = m_card.cpu(), obs_card.cpu()
    agree13 = float((m_card == m_cpu).float().mean())
    both13 = m_card & m_cpu
    obs_same = torch.equal(obs_card[both13], obs_cpu[both13])
    print(f"main path 13a tracker call {P13_REC}, match_by_projection card against CPU: "
          f"{int(m_card.sum())} / {int(m_cpu.sum())} matched, decisions agree on {agree13:.4f} "
          f"of {m_card.shape[0]} landmarks (need {MIN13_MATCH_AGREE}), observations where both "
          f"match {'equal' if obs_same else 'DIFFERENT'}", flush=True)
    if agree13 < MIN13_MATCH_AGREE or not obs_same:
        raise AssertionError("main path 13a: the card matches otherwise than the CPU")
    kernel_rows13(recd13a, f"13a tracker call {P13_REC}")
    del s13a

    # (b) SEMI_DENSE_DIRECT with the SEMI_DENSE map, VOOptions() otherwise.
    opts13b = mw.frontend_options(vo_mod.VOType.SEMI_DENSE_DIRECT, vo_mod.MapType.SEMI_DENSE)
    s13b = System(camera=cam_m, options=opts13b, device=dev)
    st13b, T7_13b, wall13b, launches13b, n_tr13b, calls13b, rec13b, recd13b, prof13b = \
        frontend_run(s13b, frames_m, "13b, SEMI_DENSE_DIRECT", rec_call=P13_REC,
                     profile_at=P13_PROFILE)
    want13b = want13(n_tr13b, s13b.vo, rec13b, calls13b)
    ok13b, out13b = frontend_gate("13b, SEMI_DENSE_DIRECT", st13b,
                                          T7_13b, SD13_REF, s13b.vo, wall13b, prof13b, calls13b)
    names13b = [fn.__name__ for fn, _ in recd13b["launches"]]
    shapes13b = {fn.__name__: tuple(a[4].shape) if fn is k3.mega_gn else
                 (a[0].shape[0] if fn is k5.pose_ba_gn else None) for fn, a in recd13b["launches"]}
    want_names13b = (["gather_windows_levels"] * 2
                     + ["mega_gn", "gather_windows_multi", "a2d_gn", "pose_ba_gn"])
    ok13b = (ok13b and out13b["cloud"] > out13b["landmarks"]
             and out13b.get("seed_spread", 1.0) < SEED_SPREAD13)
    print(f"main path 13b launches {launches13b} (expected {want13b}); tracker call {P13_REC} "
          f"launched {names13b} (K3 levels x points, K5 rows: {shapes13b}); cloud "
          f"{out13b['cloud']} > landmarks {out13b['landmarks']}, seed depth spread "
          f"{out13b.get('seed_spread')} (< {SEED_SPREAD13}): {'pass' if ok13b else 'FAIL'}",
          flush=True)
    L13 = opts13b.map_L
    if (not ok13b or launches13b != want13b or n_tr13b != 0 or names13b != want_names13b
            or shapes13b["mega_gn"][1] != opts13b.map_F + opts13b.sd_budget
            or shapes13b["pose_ba_gn"] != L13):
        raise AssertionError("main path 13b failed its gates or launch counts")
    kernel_rows13(recd13b, f"13b tracker call {P13_REC}")
    del s13b

    # (c) tests/test_vo_types.py's second-chance spike at 240x320: the spike
    # frame GOOD through the widened pass (two more K10 and K5 launches).
    cam_c, _, _ = mw.make_mono_workload(1, device=dev, shape=(240, 320), du=1.0 / 23)
    scene_c = PlaneScene(cam_c, plane_z=3.0, seed=0, device=dev)
    dT_c = se3.exp(torch.tensor([0.25, 0.0, 0.0, 0.0, 0.0, 0.0], device=dev))
    frames_c13 = torch.stack([scene_c.render(T if k < SPIKE_AT else dT_c.compose(T), (240, 320))
                              for k, T in enumerate(mw.trajectory(13, 1.0 / 23, dev))])
    s13c = System(camera=cam_c, options=vo_mod.VOOptions(vo_type=vo_mod.VOType.SPARSE_ORB,
                                                         **mw.VO_OPTS), device=dev)
    spike = {}

    def on_spike(k, vo):
        if k == SPIKE_AT - 1:
            spike["before"] = ({c.__name__: c.launches for c in counters4},
                               vo.stats["orb_second_chance_hits"], vo.stats["keyframes"])
        elif k == SPIKE_AT:
            spike["after"] = ({c.__name__: c.launches for c in counters4},
                              vo.stats["orb_second_chance_hits"], vo.stats["keyframes"])

    st13c, _, wall13c, launches13c, n_tr13c, calls13c, rec13c, _, _ = frontend_run(
        s13c, frames_c13, "13c", on_frame=on_spike)
    want13c = want13(n_tr13c, s13c.vo, rec13c, calls13c)
    (c0, h0, kf0), (c1, h1, kf1) = spike["before"], spike["after"]
    spike_launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    ok13c = (st13c[SPIKE_AT] is vo_mod.Status.GOOD and s13c.vo.stats["orb_second_chance_hits"] >= 1
             and launches13c == want13c
             and (h1 == h0 or kf1 != kf0
                  or spike_launches == {"distance_matrix": 4, "pose_ba_gn": 4}))
    print(f"main path 13c (second-chance spike, 240x320, 13 frames, spike at {SPIKE_AT}): "
          f"{[s.name for s in st13c]}, {s13c.vo.stats['orb_second_chance_hits']} hits "
          f"({h1 - h0} on the spike frame, whose launches were {spike_launches}); launches "
          f"{launches13c} (expected {want13c}): {'pass' if ok13c else 'FAIL'}", flush=True)
    if not ok13c:
        raise AssertionError("main path 13c failed its gate")
    del s13c
    print(f"main path 13: {time.perf_counter() - t13:.1f} s", flush=True)

    # -- 5l. main path 14: scale-out on an NCCL process group -------------------
    print(f"clock: path 14 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t14 = time.perf_counter()
    launches14 = _path14(torch, dev, reset, counters,
                         dict(K1=check_k1, K3b=check_k3b, exact=check_exact),
                         bstate, frames_b, T7_1)
    print(f"main path 14: {time.perf_counter() - t14:.1f} s", flush=True)

    # -- 5m. main path 15: run_synthetic_mono, and the helpers no path calls ----
    print(f"clock: path 15 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t15 = time.perf_counter()
    launches15 = _path15(torch, dev, dict(K1=check_k1, K2=check_k2, K3=check_k3, K4=check_k4,
                                          K5=check_k5, K8=check_k8, exact=check_exact),
                         instrumented, want_loops)
    _path15b(torch, dev)
    print(f"main path 15: {time.perf_counter() - t15:.1f} s", flush=True)

    # -- 6. profile windows ----------------------------------------------------
    print(f"clock: phase 6 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    prof = {}
    prof[1] = _profile(torch, lambda: tr.track_frames(state, frames[:30], T0), 30,
                       "main path 1")
    prof[5] = _profile(torch, lambda: tr.track_frames(state, frames[:30], T0,
                                                      step=tr.fused_track_step),
                       30, "main path 5 (K11)")
    prof[2] = _profile(torch, lambda: bm.track_batch_frames(bstate, frames_b[:10], T0b), 10,
                       f"main path 2 (per batched frame of {S_BATCH} sequences)")
    prof[3] = _profile(torch, lambda: vw.track_vo_frames(vstate, vframes[1:31]), 30,
                       "main path 3 (30 frames with 3 keyframe cycles)", again=False)
    # Path 4 under variants 2 and 1, past init, over a window with keyframes in it.
    for variant in (2, 1):
        sparse_align.FUSED_VARIANT = variant
        sysm = System(camera=cam_m, options=mw.mono_options(), device=dev)
        for k in range(P4_PROFILE[0]):
            sysm.track_monocular(frames_m[k], float(k))
        n_kf0 = sysm.vo.stats["keyframes"]
        ops4 = set()
        prof[f"4v{variant}"] = _profile(
            torch, lambda: [sysm.track_monocular(frames_m[k], float(k))
                            for k in range(*P4_PROFILE)],
            P4_PROFILE[1] - P4_PROFILE[0], f"main path 4, FUSED_VARIANT {variant} (frames "
            f"{P4_PROFILE[0]}-{P4_PROFILE[1] - 1})", ops=ops4, again=False)
        n_kf_win = sysm.vo.stats["keyframes"] - n_kf0
        chol = sorted(k for k in ops4 if "cholesky" in k)
        print(f"main path 4 profile window: {n_kf_win} keyframes in it; operators named "
              f"cholesky: {chol or 'none'}")
        if n_kf_win < 1:
            raise AssertionError("main path 4's profile window holds no keyframe")
        if variant == 2 and chol:
            raise AssertionError("K9 v2's H0 was factored outside the kernel")
        del sysm
    sparse_align.FUSED_VARIANT = 3
    # Paths 6b and 7 over the same window of BoxScene frames: a System run
    # per frame up to P7_PROFILE[0], then per frame (6b) or chunked (7, its
    # graph captured on the frames before the window) through it.
    a7, b7, c7 = P7_PROFILE
    for key, chunked in (("6b", False), ("7", True)):
        s7 = System(camera=cam_b, options=nw.box_options(), device=dev)
        for k in range(a7):
            s7.track_monocular(frames_b6[k], ts_b6[k])
        for k in range(a7, b7):
            if not chunked:
                s7.track_monocular(frames_b6[k], ts_b6[k])
        if chunked:
            s7.track_monocular_chunk(frames_b6[a7:b7], ts_b6[a7:b7], chunk=CHUNK)
        cs0, n_kf0 = dict(s7.vo.chunk_stats), s7.vo.stats["keyframes"]
        run = ((lambda: s7.track_monocular_chunk(frames_b6[b7:c7], ts_b6[b7:c7], chunk=CHUNK))
               if chunked else
               (lambda: [s7.track_monocular(frames_b6[k], ts_b6[k]) for k in range(b7, c7)]))
        prof[key] = _profile(torch, run, c7 - b7, f"main path {key}, BoxScene "
                             f"{'chunked' if chunked else 'per frame'} (frames {b7}-{c7 - 1})",
                             again=False)
        n_k3 = None if prof[key] is None else sum(
            v[1] for name, v in prof[key].items() if "sparse_align_mega_kernel" in name)
        computed = s7.vo.chunk_stats["frames_computed"] - cs0.get("frames_computed", 0)
        discarded = s7.vo.chunk_stats["frames_discarded"] - cs0.get("frames_discarded", 0)
        print(f"main path {key} profile window: {s7.vo.stats['keyframes'] - n_kf0} keyframes, "
              f"{computed} frame steps computed in chunks ({discarded} discarded); K3 launches "
              f"the profiler saw: {_nm(n_k3, 'd')} (frames through `track`: {c7 - b7 + discarded})",
              flush=True)
        del s7
    # Path 8 per frame over path 6b's window (the kernels the seed update
    # adds per frame), then the synchronised ms of the seed update per frame
    # over the next window, and one recorded update profiled alone.
    a8, b8, c8 = P8_PROFILE
    s8w = System(camera=cam_b, options=nw.box_df_options(), device=dev)
    for k in range(a8):
        s8w.track_monocular(frames_b8[k], ts_b8[k])
    n_kf0 = s8w.vo.stats["keyframes"]
    prof["8"] = _profile(torch, lambda: [s8w.track_monocular(frames_b8[k], ts_b8[k])
                                         for k in range(a8, b8)],
                         b8 - a8, f"main path 8, BoxScene with the depth filter, per frame "
                         f"(frames {a8}-{b8 - 1})", again=False)
    n_kf_w8 = s8w.vo.stats["keyframes"] - n_kf0
    seed_ms, seed_args = [], []
    real_update = vo_mod.update_seeds

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(*a, **kw)
        torch.cuda.synchronize()
        seed_ms.append(1e3 * (time.perf_counter() - t))
        if not seed_args:
            seed_args.append((a, kw))
        return out

    vo_mod.update_seeds = timed_update
    try:
        for k in range(b8, c8):
            s8w.track_monocular(frames_b8[k], ts_b8[k])
    finally:
        vo_mod.update_seeds = real_update
    if not seed_ms:
        raise AssertionError(f"main path 8 ran no seed update in frames {b8}-{c8 - 1}")
    a_, kw_ = seed_args[0]
    prof["8seed"] = _profile(torch, lambda: [real_update(*a_, **kw_) for _ in range(20)], 20,
                             "one seed update (update_seeds, 128 seeds) x 20")

    k8, us8 = _totals(prof["8"], b8 - a8)
    k6, us6 = _totals(prof["6b"], P7_PROFILE[2] - P7_PROFILE[1])
    kseed, usseed = _totals(prof["8seed"], 20)
    print(f"main path 8's seed update: {statistics.median(seed_ms):.3f} ms synchronised per "
          f"frame (median of {len(seed_ms)} frames {b8}-{c8 - 1}; min {min(seed_ms):.3f}, max "
          f"{max(seed_ms):.3f}); alone {_nm(kseed, '.1f')} kernels and "
          f"{_nm(usseed, '.2f', ' us')} of device time per update; window {a8}-{b8 - 1} per frame: "
          f"path 8 {_nm(k8, '.1f')} kernels, {_nm(us8, '.1f', ' us')} busy ({n_kf_w8} keyframes), "
          f"path 6b {_nm(k6, '.1f')} kernels, {_nm(us6, '.1f', ' us')} busy", flush=True)
    del s8w
    # Each kernel's device time per launch in the profiler, in the window
    # whose shapes its phase-2 CUDA-event time was taken at, beside that
    # time (per frame for K1 and K9: 2 and 3 launches; per keyframe for
    # K10: 2): the difference is the gap between back-to-back launches.
    prof_rows = (("K1", 1, "gather_levels_kernel", 2), ("K2", 2, "gather_windows_multi_kernel", 1),
                 ("K2vo", 3, "gather_windows_multi_kernel", 1),
                 ("K3", 1, "sparse_align_mega_kernel", 1), ("K4", 1, "align2d_fused_kernel", 1),
                 ("K5", 1, "pose_ba_fused_kernel", 1),
                 ("K6", 2, "gather_windows_grouped_kernel", 1),
                 ("K8", 2, "pose_ba_fused_batch_kernel", 1), ("K10", 3, "hamming_mma_kernel", 2),
                 ("K9v1", "4v1", "level_align_v1_kernel", 3),
                 ("K9v2", "4v2", "level_align_v2_kernel", 3), ("K11", 5, "track_fused_kernel", 1))
    for k, window, sym, per_unit in prof_rows:
        if prof[window] is None:
            print(f"{k} {sym}: profiler device time not measured (main path {window}'s window "
                  f"recorded no device event); CUDA-event interval "
                  f"{report[k]['ms'] * 1e3:.2f} us per {per_unit} launch(es)", flush=True)
        else:
            hits = [v for key, v in prof[window].items() if sym in key]
            if not hits:
                raise AssertionError(f"the profiler saw no {sym} in main path {window}'s window")
            us = sum(h[0] for h in hits) / sum(h[1] for h in hits)
            print(f"{k} {sym}: profiler device {us:.2f} us per launch ({us * per_unit:.2f} per "
                  f"{per_unit} launch(es), main path {window}'s window); CUDA-event interval "
                  f"{report[k]['ms'] * 1e3:.2f} us per {per_unit} launch(es)", flush=True)
        if k == "K9v1":
            for part, pix, red_, clu, sol, body, n_pass in e2_report[k]["splits"]:
                print(f"  K9v1 at frame {E2_FRAME}'s levels 2, 1, 0: cluster {part.cluster}, "
                      f"{int(n_pass)} passes of {pix + red_ + clu + sol:.2f} us (pixel steps "
                      f"{pix:.2f}, block reduction {red_:.2f}, cluster exchange {clu:.2f}, "
                      f"solve and retraction {sol:.2f}), body {body:.2f} us", flush=True)

    # -- 7. result lines ------------------------------------------------------
    print(f"clock: phase 7 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    spilled = {k: v for k, v in spills.items() if k in NO_SPILL and v}
    if set(NO_SPILL) - set(spills) or spilled:
        raise AssertionError(f"ptxas: spills in {spilled}, or no report for "
                             f"{set(NO_SPILL) - set(spills)}")

    def launches(name):
        return (launches1.get(name, 0) + launches2.get(name, 0) + launches3.get(name, 0)
                + sum(v[name] for v in launches4.values()) + launches5[name]
                + launches6a[name] + launches6[name] + launches6c[name] + launches7[name]
                + launches8[name] + launches8c[name] + launches9a[name] + launches9d[name]
                + launches9e[name] + launches10a[name] + launches10c[name] + launches11a[name]
                + launches11b[name] + sum(l_[name] for l_ in launches11c_all)
                + launches11d[name] + launches12a[name] + launches12d[name] + launches12b[name]
                + launches12c[name] + launches13a[name] + launches13b[name] + launches13c[name]
                + launches14.get(name, 0) + launches15.get(name, 0))

    gw = "ygz_slam_tpu_torch/csrc/gather_windows.cu"
    pk = "ygz_slam_tpu/ops/pallas/"
    meta = {
        "K1": ("gather_windows", gw, pk + "align2d_kernel.py:77",
               launches("gather_windows") + launches("gather_windows_levels")),
        "K2": ("gather_windows_multi", gw, pk + "align2d_kernel.py:298",
               launches("gather_windows_multi")),
        "K3": ("sparse_align_mega", "ygz_slam_tpu_torch/csrc/sparse_align_mega.cu",
               pk + "sparse_align_mega.py:338", launches("mega_gn") + launches("mega_gn_batch")),
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
        "K11": ("track_step_fused", "ygz_slam_tpu_torch/csrc/track_fused.cu",
                pk + "track_fused.py:534", launches("track_gn")),
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
