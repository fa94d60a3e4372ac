"""Hamming distance over packed binary descriptors and the matchers built
on it (counterpart of ygz_slam_tpu/ops/hamming.py).

Descriptors are 8 x 32-bit words (256 bits) stored as int32.  The all-pairs
matrix is K10 on the card and its plain version on the CPU
(ops/kernels/hamming_kernel.py); the device of the tensors decides, nothing
else.
"""
from __future__ import annotations

import math

import torch

from .kernels.hamming_kernel import distance_matrix, popcount_i32
# The JAX package's uint32 SWAR popcount, here on the int32 words that hold
# the same bits (torch has no uint32 shifts).
from .kernels.hamming_kernel import popcount_i32 as popcount_u32  # noqa: F401
from .select import top_k

BIG = 1 << 14       # distance of a masked-out pair


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance: a, b [..., 8] int32 -> [...] int32 in
    [0, 256]."""
    return torch.sum(popcount_i32(a ^ b), dim=-1, dtype=torch.int32)


def best_two(d: torch.Tensor):
    """(argmin [N], min [N], second-smallest [N]) along the rows of an
    int32 distance matrix, the first index winning ties; the second-smallest
    is taken with the best entry set to BIG."""
    best_idx = torch.argmin(d, dim=1)
    best = torch.amin(d, dim=1)
    d2 = d.scatter(1, best_idx[:, None], BIG)
    return best_idx, best, torch.amin(d2, dim=1)


def match_nn(desc_a: torch.Tensor, desc_b: torch.Tensor, mask_a: torch.Tensor,
             mask_b: torch.Tensor, max_dist: int = 50, ratio: float = 0.9,
             cross_check: bool = True, d: torch.Tensor | None = None):
    """Nearest-neighbour descriptor matching with Lowe ratio test and
    mutual cross-check (best distance at most `max_dist` and below `ratio`
    times the second best, Matcher.cpp:250-283, for all rows at once).
    `d`, if given, is `distance_matrix(desc_a, desc_b)` computed by the
    caller (a column block of a wider matrix), and the descriptors are not
    read.

    Returns (idx [N] int32, index into b or -1; valid [N] bool)."""
    if d is None:
        d = distance_matrix(desc_a, desc_b)
    d = torch.where(mask_b[None, :], d, BIG)
    best_idx, best, second = best_two(d)
    ok = mask_a & (best <= max_dist) & (best.float() < ratio * second.float())
    if cross_check:
        db = torch.where(mask_a[:, None], d, BIG)
        best_rev = torch.argmin(db, dim=0)                     # [M]
        ok = ok & (best_rev[best_idx] == torch.arange(d.shape[0], device=d.device))
    return torch.where(ok, best_idx, -1).to(torch.int32), ok


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor,
                         matched: torch.Tensor, n_bins: int = 30,
                         n_keep: int = 3) -> torch.Tensor:
    """Rotation-histogram filter: keep matches whose angle difference falls
    in the `n_keep` most popular of `n_bins` bins, dropping a kept bin whose
    count is below a tenth of the dominant one (ComputeThreeMaxima,
    Matcher.cpp:294-336).  Angles in radians; returns the filtered mask."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b, two_pi)           # [0, 2pi)
    bin_idx = torch.clamp((rot * (n_bins / two_pi)).to(torch.int32), 0, n_bins - 1).long()
    counts = torch.zeros(n_bins, dtype=torch.int32, device=matched.device).index_add_(
        0, bin_idx, matched.to(torch.int32))
    top_counts, top_bins = top_k(counts, n_keep)
    strong = top_counts.float() >= 0.1 * top_counts[0].float()
    in_top = torch.any((bin_idx[:, None] == top_bins[None, :]) & strong[None, :], dim=1)
    return matched & in_top


# Archive rows scored per K10 launch by `archive_match_scores`: a
# [F, ARCHIVE_CHUNK * F] int32 matrix, 134,217,728 bytes at F = 256, so an
# archive of capacity 512 takes one launch and the 1024-row prefilter two.
ARCHIVE_CHUNK = 512


def archive_match_scores(q_desc: torch.Tensor, q_valid: torch.Tensor, arc_desc: torch.Tensor,
                         arc_valid: torch.Tensor, max_dist: int = 64,
                         chunk: int = ARCHIVE_CHUNK) -> torch.Tensor:
    """Match-count retrieval score of one query frame against every archived
    keyframe: score[a] = the query's valid descriptors whose nearest valid
    descriptor in archive row a lies within `max_dist` (the JAX package's
    brute-force replacement of DBoW3's inverted-index ranking).

    q_desc [Fq, 8] int32 words, q_valid [Fq] bool, arc_desc [A, F, 8],
    arc_valid [A, F] bool -> [A] int32.  Each `chunk` of archive rows is one
    K10 launch, the query against the chunk's C * F descriptors (a
    [Fq, C * F] matrix), then the masked minimum over each row's F columns
    and the hits counted; the JAX package's chunks of 32 bound memory the
    same way."""
    A, F = arc_desc.shape[0], arc_desc.shape[1]
    flat = arc_desc.reshape(A * F, 8)
    out = []
    for a0 in range(0, A, chunk):
        C = min(chunk, A - a0)
        d = distance_matrix(q_desc, flat[a0 * F:(a0 + C) * F]).reshape(-1, C, F)
        best = torch.amin(torch.where(arc_valid[None, a0:a0 + C], d, BIG), dim=-1)   # [Fq, C]
        hit = (best <= max_dist) & q_valid[:, None]
        out.append(hit.sum(dim=0, dtype=torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=q_desc.device)
    return torch.cat(out)
