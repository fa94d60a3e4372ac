"""Multi-sequence batch tracking: S sequences advance one frame together
(counterpart of ygz_slam_tpu/parallel/batch_tracking.py, its kernel path;
the port runs it on every device).

Per frame: every sequence's window origins on every level in one batched
pass, every level's sparse-align windows of all S sequences in one launch
of K6 (written in place into one [S, L, N, 16, 16] buffer), then all S
coarse-to-fine alignments in one launch of K3, a CTA per sequence (the S
serial GN chains side by side on S of the card's SMs); then the map
patches of all S*N points in one launch each of K2 (windows from the
[S, H, W] frame stack) and K4; then the S pose-only BAs in one launch of
K8.  `batched_track_step` is those three stages in a row:
`batched_sparse_align`, `batched_align2d` on the landmarks' projections
(`project_landmarks`), and `pose_only_ba_fused_batch` on
`batched_pose_ba_inputs`.  The keyframe side (one ReferencePrep per
sequence, K3's constants stacked from them in a `BatchRef`, the
Align2DPrep of the flattened patches) is computed once by the caller.
Only the poses leave the sparse-align stage: no per-sequence chi2,
Hessian or visible count, which the step never reads.
`sharded_batch_align` splits the sequences over a mesh (pure data
parallelism, no collective): each rank aligns its own.  The JAX package's
other formulations of the same step (per-iteration multi-image gathers
with segment-sum GN, `align2d_pallas_multi`, the off-TPU `vmap`
fallbacks) are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import SE3
from ..ops import sparse_align as sa
from ..ops.align import accepted, substitute_inits
from ..ops.kernels.align2d_fused import A2DWindows, a2d_window_origins, align2d_fused
from ..ops.kernels.align2d_kernel import CACHE_WIN, gather_windows_multi, gather_windows_stacked
from ..ops.kernels.pose_ba_fused_batch import pose_only_ba_fused_batch
from ..ops.kernels.sparse_align_mega import CWIN, MAX_ITER, level_window_origins, mega_gn_batch
from ..utils import profiling
from .mesh import Mesh

DISTORTED = True        # the JAX batch path projects through the distortion model


class BatchRef(NamedTuple):
    """What K3 reads of S sequences' keyframes (their ReferencePreps),
    stacked once per keyframe."""
    p_ref: torch.Tensor      # [S, N, 3] reference-camera points
    refp: torch.Tensor       # [S, L, N, 16] every level's reference patches
    jac: torch.Tensor        # [S, L, N, 16, 6] every level's Jacobians
    lvis: torch.Tensor       # [S, L, N] float32 (0/1): point usable at the level


def stack_preps(ref_preps) -> BatchRef:
    """The BatchRef of a sequence of ReferencePreps (one per sequence)."""
    return BatchRef(
        p_ref=torch.stack([p.p_ref for p in ref_preps]),
        refp=torch.stack([p.mega_refp for p in ref_preps]),
        jac=torch.stack([p.mega_jl for p in ref_preps]),
        lvis=torch.stack([torch.stack([lv.vis for lv in p.levels])
                          for p in ref_preps]).to(torch.float32))


def batch_window_origins(cur_pyrs, p_ref: torch.Tensor, T_init: SE3, cam):
    """Every sequence's and level's 16x16 window origins at the frame-init
    poses T_init [S] (their R [S, 3, 3] and t [S, 3] as they are), for
    reference points p_ref [S, N, 3] and the current pyramids (per level
    [S, h, w]): `mega_window_origins` of every sequence at once, the same
    ints.  Returns (ox, oy) [S, L, N] int32."""
    pc0 = p_ref @ T_init.R.transpose(-1, -2) + T_init.t[:, None]
    px0 = torch.nan_to_num(cam.camera_to_pixel(pc0, distorted=DISTORTED))
    return level_window_origins(px0, [lv.shape[1:] for lv in cur_pyrs])


def batched_sparse_align(ref_pyrs, cur_pyrs, cam, px_ref: torch.Tensor,
                         depth_ref: torch.Tensor, mask: torch.Tensor, T_init: SE3,
                         ref_preps, n_iter: int = 15) -> SE3:
    """One coarse-to-fine sparse-direct alignment step for S sequences.

    ref_pyrs / cur_pyrs: per level [S, h, w]; px_ref [S, N, 2], depth_ref
    and mask [S, N] (their keyframe side is `ref_preps`); T_init batched
    [S]; `ref_preps`, the sequences' keyframe constants: a BatchRef, or one
    ReferencePrep per sequence (stacked here, per call); at most
    min(n_iter, 12) GN iterations per level.  Every sequence's window
    origins in one batched pass at T_init's R and t, their windows in one
    launch of K6 into one buffer (`gather_windows_stacked`; two from 22
    sequences of three levels), then the S alignments in one launch of K3
    with a CTA per sequence (`mega_gn_batch`): each sequence's pose is the
    one its own `sparse_image_align` gives from the same pose.
    Returns the refined poses, SE3 batched [S]."""
    ref = ref_preps if isinstance(ref_preps, BatchRef) else stack_preps(ref_preps)
    S = ref.p_ref.shape[0]
    ox, oy = batch_window_origins(cur_pyrs, ref.p_ref, T_init, cam)
    wins = gather_windows_stacked(cur_pyrs, ox, oy, CWIN)
    pose0 = torch.cat([T_init.R.reshape(S, 9), T_init.t], dim=1)
    H0, W0 = cur_pyrs[0].shape[1:]
    out = mega_gn_batch(wins, ref.refp, ref.jac, ref.p_ref, ref.lvis, ox, oy, pose0, cam,
                        DISTORTED, H0, W0, min(n_iter, MAX_ITER))
    return SE3(out[:, :9].reshape(S, 3, 3), out[:, 9:12])


def sharded_batch_align(mesh: Mesh, ref_pyrs, cur_pyrs, cam, px: torch.Tensor,
                        depth: torch.Tensor, mask: torch.Tensor, T_init: SE3,
                        n_iter: int = 15) -> SE3:
    """The sequence axis split over `mesh`'s shards: pure data parallelism,
    no collective.  Every argument holds this rank's sequences
    (`mesh.local_rows` of the mesh-wide batch, a whole number per shard), as
    `batched_sparse_align` takes them; the rank prepares each sequence's
    keyframe side (`prepare_reference`, one K1 launch each) and stacks it
    into a BatchRef, then aligns all its sequences in one
    `batched_sparse_align` (one K6 launch, then one K3 launch with a CTA per
    sequence).  Returns this
    rank's poses, SE3 [S_local]."""
    S = px.shape[0]
    if S % mesh.local:
        raise ValueError(f"{S} sequences do not split over this rank's {mesh.local} shards")
    ref = stack_preps([sa.prepare_reference(tuple(r[s] for r in ref_pyrs), cam, px[s], depth[s],
                                            mask[s], distorted=DISTORTED) for s in range(S)])
    return batched_sparse_align(ref_pyrs, cur_pyrs, cam, px, depth, mask, T_init, ref,
                                n_iter=n_iter)


def project_landmarks(cam, pts_w: torch.Tensor, T: SE3) -> torch.Tensor:
    """Pixels [S, N, 2] of the landmarks pts_w [S, N, 3] at the poses T [S]:
    align2d's inits."""
    return cam.world_to_pixel(pts_w, SE3(T.R[:, None], T.t[:, None]), distorted=DISTORTED)


def batched_align2d_inputs(cur_imgs: torch.Tensor, xy_init: torch.Tensor):
    """What `batched_align2d` computes before its kernels, for the S*N
    flattened points: (K2's arguments (cur_imgs, image index, window
    origins, CACHE_WIN), the inits xy0 [S*N, 2], their substitutes inside
    the image, and the in-bounds mask the acceptance gates need)."""
    S, N = xy_init.shape[:2]
    H, W = cur_imgs.shape[1:]
    seq_idx = torch.arange(S, dtype=torch.int32, device=cur_imgs.device).repeat_interleave(N)
    xy0 = xy_init.reshape(S * N, 2).to(cur_imgs.dtype)
    xy0s, inb0 = substitute_inits(xy0, H, W)
    ox, oy = a2d_window_origins(xy0s, H, W)
    return (cur_imgs, seq_idx, ox, oy, CACHE_WIN), xy0, xy0s, inb0


def batched_align2d(cur_imgs: torch.Tensor, xy_init: torch.Tensor, a2d_prep):
    """Patch alignment of all S*N points at once: their 32x32 cache windows
    from the frame stack `cur_imgs [S, H, W]` in one launch of K2, then one
    launch of K4 over the flattened rows, with align2d's acceptance gates.

    xy_init [S, N, 2]; `a2d_prep` is the Align2DPrep of the flattened
    patches (a keyframe constant).  Returns (xy [S, N, 2], converged
    [S, N], err [S, N])."""
    S, N = xy_init.shape[:2]
    H, W = cur_imgs.shape[1:]
    a2, xy0, xy0s, inb0 = batched_align2d_inputs(cur_imgs, xy_init)
    xy, _, err = align2d_fused(cur_imgs[0], a2d_prep, xy0s,
                               pregathered=A2DWindows(gather_windows_multi(*a2), a2[2], a2[3]))
    conv = accepted(xy, err, xy0, inb0, H, W)
    return xy.reshape(S, N, 2), conv.reshape(S, N), err.reshape(S, N)


def batched_pose_ba_inputs(T: SE3, pts_w: torch.Tensor, xy: torch.Tensor,
                           conv: torch.Tensor, mask: torch.Tensor, cam):
    """The arguments of `pose_only_ba_fused_batch` from align2d's output:
    the aligned pixels undistorted, the points that align2d accepted and
    the mask keeps."""
    return T, pts_w, cam.undistort_px(xy), conv & mask, cam


def batched_track_step(ref_pyrs, cur_pyrs, cam, px_ref: torch.Tensor,
                       depth_ref: torch.Tensor, mask: torch.Tensor, pts_w: torch.Tensor,
                       T_init: SE3, ref_preps, a2d_prep):
    """The whole per-frame tracking computation for S sequences:
    sparse-direct alignment, map patch alignment, pose-only BA.

    pts_w [S, N, 3] landmarks; other arguments as for
    `batched_sparse_align` and `batched_align2d`.  Returns (poses, SE3
    batched [S]; inlier counts [S])."""
    with profiling.span("batch_sparse_align"):
        T = batched_sparse_align(ref_pyrs, cur_pyrs, cam, px_ref, depth_ref, mask, T_init,
                                 ref_preps)
    with profiling.span("batch_align2d"):
        xy, conv, _ = batched_align2d(cur_pyrs[0], project_landmarks(cam, pts_w, T), a2d_prep)
    with profiling.span("batch_pose_ba"):
        T_out, inlier, _ = pose_only_ba_fused_batch(*batched_pose_ba_inputs(T, pts_w, xy, conv,
                                                                            mask, cam))
        return T_out, torch.sum(inlier, dim=-1)
