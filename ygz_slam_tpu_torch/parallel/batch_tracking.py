"""Multi-sequence batch tracking: S sequences advance one frame together
(counterpart of ygz_slam_tpu/parallel/batch_tracking.py, its kernel path;
the port runs it on every device).

Per frame: every level's sparse-align windows of all S sequences in one
launch of K6, then each sequence's coarse-to-fine alignment in one launch
of K3; then the map patches of all S*N points in one launch each of K2
(windows from the [S, H, W] frame stack) and K4; then the S pose-only BAs
in one launch of K8.  `batched_track_step` is those three stages in a row:
`batched_sparse_align`, `batched_align2d` on the landmarks' projections
(`project_landmarks`), and `pose_only_ba_fused_batch` on
`batched_pose_ba_inputs`.  The keyframe side (one ReferencePrep per
sequence, the Align2DPrep of the flattened patches) is computed once by
the caller.  `sharded_batch_align` splits the sequences over a mesh (pure
data parallelism, no collective): each rank aligns its own.  The JAX
package's other formulations of the same step (per-iteration multi-image
gathers with segment-sum GN, `align2d_pallas_multi`, the off-TPU `vmap`
fallbacks) are not ported.
"""
from __future__ import annotations

import torch

from ..geometry.se3 import SE3
from ..ops import sparse_align as sa
from ..ops.align import accepted, substitute_inits
from ..ops.kernels.align2d_fused import A2DWindows, a2d_window_origins, align2d_fused
from ..ops.kernels.align2d_kernel import CACHE_WIN, gather_windows_multi
from ..ops.kernels.pose_ba_fused_batch import pose_only_ba_fused_batch
from ..utils import profiling
from .mesh import Mesh

DISTORTED = True        # the JAX batch path projects through the distortion model


def batched_sparse_align(ref_pyrs, cur_pyrs, cam, px_ref: torch.Tensor,
                         depth_ref: torch.Tensor, mask: torch.Tensor, T_init: SE3,
                         ref_preps, n_iter: int = 15) -> SE3:
    """One coarse-to-fine sparse-direct alignment step for S sequences.

    ref_pyrs / cur_pyrs: per level [S, h, w]; px_ref [S, N, 2], depth_ref
    and mask [S, N]; T_init batched [S]; `ref_preps`, one ReferencePrep per
    sequence (keyframe constants); at most min(n_iter, 12) GN iterations per
    level.  Every sequence's windows are gathered first, in one launch of K6
    (`gather_frames_windows`), then the S alignments run (K3 each).
    Returns the refined poses, SE3 batched [S]."""
    T7_in = T_init.params7()
    S = len(ref_preps)
    T0s = [SE3.from_params7(T7_in[s]) for s in range(S)]
    cps = [tuple(c[s] for c in cur_pyrs) for s in range(S)]
    fws = sa.gather_frames_windows(cps, cam, ref_preps, T0s, distorted=DISTORTED)
    T7s = []
    for s, prep in enumerate(ref_preps):
        rp = tuple(r[s] for r in ref_pyrs)
        st = sa.sparse_image_align(rp, cps[s], cam, px_ref[s], depth_ref[s], mask[s], T0s[s],
                                   distorted=DISTORTED, ref_prep=prep, frame_windows=fws[s],
                                   n_iter=n_iter)
        T7s.append(st.T_cur_ref.params7())
    return SE3.from_params7(torch.stack(T7s))


def sharded_batch_align(mesh: Mesh, ref_pyrs, cur_pyrs, cam, px: torch.Tensor,
                        depth: torch.Tensor, mask: torch.Tensor, T_init: SE3,
                        n_iter: int = 15) -> SE3:
    """The sequence axis split over `mesh`'s shards: pure data parallelism,
    no collective.  Every argument holds this rank's sequences
    (`mesh.local_rows` of the mesh-wide batch, a whole number per shard), as
    `batched_sparse_align` takes them; the rank prepares each sequence's
    keyframe side (`prepare_reference`, one K1 launch each), then aligns all
    its sequences in one `batched_sparse_align` (one K6 launch, then K3 per
    sequence).  Returns this rank's poses, SE3 [S_local]."""
    S = px.shape[0]
    if S % mesh.local:
        raise ValueError(f"{S} sequences do not split over this rank's {mesh.local} shards")
    preps = [sa.prepare_reference(tuple(r[s] for r in ref_pyrs), cam, px[s], depth[s], mask[s],
                                  distorted=DISTORTED) for s in range(S)]
    return batched_sparse_align(ref_pyrs, cur_pyrs, cam, px, depth, mask, T_init, preps,
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
