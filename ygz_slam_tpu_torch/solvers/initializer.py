"""Monocular initialization: batched RANSAC homography/fundamental
estimation, model selection and relative-pose reconstruction
(counterpart of ygz_slam_tpu/solvers/initializer.py; the reference is
ORB-SLAM's Initializer, src/Algorithm/Initializer.cpp).

200 RANSAC hypotheses of 8-point samples fit H and F in two batched SVDs,
the four best of each model are refit on their inliers (LO-RANSAC), the
model is chosen by rh = sh / (sh + sf) > 0.4, and H (8 Faugeras solutions)
or F -> E (4 solutions) is decomposed and every candidate motion is scored
by cheirality, reprojection and parallax (CheckRT).

The random draw is its own function, `sample_hypotheses`, so that a caller
can hand `ransac_hf_from_samples` indices drawn elsewhere.  Solves and
inverses use the `_ex` forms, which neither raise nor wait for the device;
a failed one yields non-finite values, as `jnp.linalg` gives.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import SE3
from ..geometry.triangulation import triangulate_dlt
from ..ops.select import top_k

CHI2_H = 5.991   # 2-DoF transfer error threshold (CheckHomography)
CHI2_F = 3.841   # 1-DoF epipolar distance threshold (CheckFundamental)
SCORE_F = 5.991  # F scoring cap (the reference scores F with thScore)
LO_TOP_K = 4     # hypotheses refit on their inliers, per model
LO_ROUNDS = 3


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse; NaN where the matrix is singular (jnp.linalg.inv
    returns non-finite values there)."""
    inv, info = torch.linalg.inv_ex(A)
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of A
    [..., m, n] (full V for m < n, as jnp.linalg.svd gives)."""
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1]).Vh[..., -1, :]


def normalize_points(pts: torch.Tensor, mask: torch.Tensor):
    """Zero-mean / unit mean-abs-deviation normalization (Normalize,
    Initializer.cpp:140-194).  Returns (normalized [N, 2], T [3, 3])."""
    n = torch.clamp(mask.sum(), min=1).to(pts.dtype)
    m = torch.sum(torch.where(mask[:, None], pts, 0.0), dim=0) / n
    md = torch.sum(torch.where(mask[:, None], torch.abs(pts - m), 0.0), dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    one = torch.ones((), dtype=pts.dtype, device=pts.device)
    T = torch.stack([torch.stack([s[0], zero, -m[0] * s[0]]),
                     torch.stack([zero, s[1], -m[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - m) * s, T


def _h_from_points(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """DLT homography from >= 4 correspondences [..., n, 2] (ComputeH21);
    per-point weights `w [n]` give the all-inlier refit."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                              # [..., 2n, 9]
    if w is not None:
        A = A * torch.cat([w, w])[:, None]
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _f_from_points(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """Normalized 8-point fundamental with rank-2 projection (ComputeF21);
    optional weights give the all-inlier refit."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)
    if w is not None:
        A = A * w[:, None]
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ torch.diag_embed(S) @ Vh


def _hom(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def check_homography(H21: torch.Tensor, pts1, pts2, mask, sigma: float = 1.0):
    """Symmetric transfer score + inliers (CheckHomography), batched over
    leading dims of H21 [..., 3, 3].  Returns (score [...], ok [..., N])."""
    inv_s2 = 1.0 / (sigma * sigma)
    H12 = _inv(H21 + 1e-12 * _eye(3, H21))

    def transfer(H, a, b):
        p = _hom(a) @ H.transpose(-1, -2)
        w = p[..., 2:3]
        proj = p[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)
        return torch.sum((proj - b) ** 2, dim=-1) * inv_s2

    chi1 = transfer(H21, pts1, pts2)
    chi2 = transfer(H12, pts2, pts1)
    ok = (chi1 < CHI2_H) & (chi2 < CHI2_H) & mask
    score = torch.sum(torch.where(mask & (chi1 < CHI2_H), CHI2_H - chi1, 0.0)
                      + torch.where(mask & (chi2 < CHI2_H), CHI2_H - chi2, 0.0), dim=-1)
    return score, ok


def check_fundamental(F21: torch.Tensor, pts1, pts2, mask, sigma: float = 1.0):
    """Symmetric epipolar-distance score + inliers (CheckFundamental),
    batched over leading dims of F21."""
    inv_s2 = 1.0 / (sigma * sigma)
    x1, x2 = _hom(pts1), _hom(pts2)
    l2 = x1 @ F21.transpose(-1, -2)          # lines in image 2
    l1 = x2 @ F21                            # lines in image 1
    d2 = torch.sum(x2 * l2, dim=-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2,
                                                       min=1e-12)
    d1 = torch.sum(x1 * l1, dim=-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2,
                                                       min=1e-12)
    c2, c1 = d2 * inv_s2, d1 * inv_s2
    ok = (c1 < CHI2_F) & (c2 < CHI2_F) & mask
    score = torch.sum(torch.where(mask & (c2 < CHI2_F), SCORE_F - c2, 0.0)
                      + torch.where(mask & (c1 < CHI2_F), SCORE_F - c1, 0.0), dim=-1)
    return score, ok


class RansacResult(NamedTuple):
    H: torch.Tensor          # best homography (pixel coordinates)
    F: torch.Tensor          # best fundamental
    score_h: torch.Tensor
    score_f: torch.Tensor
    inliers_h: torch.Tensor  # [N]
    inliers_f: torch.Tensor  # [N]
    rh: torch.Tensor         # sh / (sh + sf)


def sample_hypotheses(mask: torch.Tensor, n_hypotheses: int,
                      generator: torch.Generator) -> torch.Tensor:
    """[n_hypotheses, 8] indices of valid matches, each row drawn without
    replacement (a repeated point makes the DLT degenerate)."""
    p = mask.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    return torch.multinomial(p.expand(n_hypotheses, -1), 8, replacement=False,
                             generator=generator)


def _lo_refit(make_model, check, models, scores, pts1, pts2, mask, sigma):
    """Locally optimized RANSAC: from each of the LO_TOP_K best hypotheses,
    refit on the model's inliers LO_ROUNDS times (a weighted least-squares
    fit over all points), keeping a refit only when it scores no worse; the
    best rescored model wins."""
    _, top_idx = top_k(scores, LO_TOP_K)
    best = None
    for i in range(LO_TOP_K):
        M = models[top_idx[i]]
        s, inl = check(M, pts1, pts2, mask, sigma)
        for _ in range(LO_ROUNDS):
            M2 = make_model(inl.to(pts1.dtype))
            s2, inl2 = check(M2, pts1, pts2, mask, sigma)
            take = s2 >= s
            M = torch.where(take, M2, M)
            s = torch.maximum(s, s2)
            inl = torch.where(take, inl2, inl)
        if best is None:
            best = (M, s, inl)
        else:
            take = s > best[1]                        # argmax: the first best wins
            best = (torch.where(take, M, best[0]), torch.where(take, s, best[1]),
                    torch.where(take, inl, best[2]))
    return best


def ransac_hf_from_samples(idx: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                           mask: torch.Tensor, sigma: float = 1.0) -> RansacResult:
    """Fit H and F on the sampled 8-point sets `idx [n_hyp, 8]` (shared by
    both models, TryInitialize's parallel FindHomography /
    FindFundamental), score every hypothesis, and LO-refit the best."""
    n1, T1 = normalize_points(pts1, mask)
    n2, T2 = normalize_points(pts2, mask)
    T2inv = _inv(T2)
    a, b = n1[idx], n2[idx]                                       # [n_hyp, 8, 2]
    Hs = T2inv @ _h_from_points(a, b) @ T1
    Fs = T2.T @ _f_from_points(a, b) @ T1
    shs, _ = check_homography(Hs, pts1, pts2, mask, sigma)
    sfs, _ = check_fundamental(Fs, pts1, pts2, mask, sigma)
    H_best, sh_best, inl_h = _lo_refit(
        lambda w: T2inv @ _h_from_points(n1, n2, w) @ T1, check_homography, Hs, shs,
        pts1, pts2, mask, sigma)
    F_best, sf_best, inl_f = _lo_refit(
        lambda w: T2.T @ _f_from_points(n1, n2, w) @ T1, check_fundamental, Fs, sfs,
        pts1, pts2, mask, sigma)
    rh = sh_best / torch.clamp(sh_best + sf_best, min=1e-9)
    return RansacResult(H=H_best, F=F_best, score_h=sh_best, score_f=sf_best,
                        inliers_h=inl_h, inliers_f=inl_f, rh=rh)


def ransac_hf(pts1, pts2, mask, generator: torch.Generator, n_hypotheses: int = 200,
              sigma: float = 1.0) -> RansacResult:
    """`ransac_hf_from_samples` on `n_hypotheses` sets drawn from `generator`."""
    return ransac_hf_from_samples(sample_hypotheses(mask, n_hypotheses, generator),
                                  pts1, pts2, mask, sigma)


class CheckRTResult(NamedTuple):
    n_good: torch.Tensor
    parallax_deg: torch.Tensor  # min(50th, n_good)-th largest good parallax
    points3d: torch.Tensor      # [N, 3] in frame 1
    good: torch.Tensor          # [N]


def check_rt(R: torch.Tensor, t: torch.Tensor, pts1, pts2, mask, K: torch.Tensor,
             sigma: float = 1.0) -> CheckRTResult:
    """Cheirality + reprojection + parallax scoring of candidate motions
    (CheckRT, Initializer.cpp:505-647), batched over leading dims of R
    [..., 3, 3] / t [..., 3].  Triangulation runs in K-normalised
    coordinates, where the 4x4 SVD keeps full float32 precision."""
    th2 = 4.0 * sigma * sigma
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    f_vec, c_vec = torch.stack([fx, fy]), torch.stack([cx, cy])
    xn1 = (pts1 - c_vec) / f_vec
    xn2 = (pts2 - c_vec) / f_vec
    P1 = torch.cat([_eye(3, K), torch.zeros((3, 1), dtype=K.dtype, device=K.device)], dim=1)
    P2 = torch.cat([R, t[..., None]], dim=-1)                       # [..., 3, 4]
    X = triangulate_dlt(P1, P2[..., None, :, :], xn1, xn2)          # [..., N, 3]
    finite = torch.isfinite(X).all(dim=-1)
    X = torch.where(finite[..., None], X, 0.0)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]              # [..., 3]
    n2v = X - O2[..., None, :]
    cosp = torch.sum(X * n2v, dim=-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2v, dim=-1), min=1e-12)
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]

    def reproj(Xc):
        zz = torch.where(torch.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
        return torch.stack([fx * Xc[..., 0] / zz + cx, fy * Xc[..., 1] / zz + cy], dim=-1)

    e1 = torch.sum((reproj(X) - pts1) ** 2, dim=-1)
    e2 = torch.sum((reproj(X2) - pts2) ** 2, dim=-1)
    good = (mask & finite & (X[..., 2] > 0) & (X2[..., 2] > 0) & (e1 < th2) & (e2 < th2)
            & (cosp < 0.99998))
    n_good = torch.sum(good, dim=-1)
    sorted_cos = torch.sort(torch.where(good, cosp, -1.0), dim=-1).values   # best parallax first
    pick = torch.clamp(n_good - 1, min=0, max=49)
    cos_pick = torch.gather(sorted_cos, -1, pick[..., None])[..., 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cos_pick, -1.0, 1.0)))
    return CheckRTResult(n_good=n_good, parallax_deg=torch.where(n_good > 0, parallax, 0.0),
                         points3d=X, good=good)


def decompose_e(E: torch.Tensor):
    """E -> 4 candidate (R, t) (DecomposeE, Initializer.cpp:940-964)."""
    U, _, Vh = torch.linalg.svd(E)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vh
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_h(H: torch.Tensor, K: torch.Tensor):
    """H -> 8 candidate (R, t) by the Faugeras SVD construction
    (ReconstructH, Initializer.cpp:326-503): ([8, 3, 3], [8, 3]).  H and -H
    give the same eight candidates."""
    A = _inv(K) @ H @ K
    U, w, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = w[0], w[1], w[2]
    eps = 1e-12
    dev, dt = H.device, H.dtype

    def vec(*v):
        return torch.tensor(v, dtype=dt, device=dev)

    den13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = vec(1.0, 1.0, -1.0, -1.0) * aux1
    x3s = vec(1.0, -1.0, 1.0, -1.0) * aux3
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sign4 = vec(1.0, -1.0, -1.0, 1.0)
    zero = torch.zeros(4, dtype=dt, device=dev)
    one = torch.ones(4, dtype=dt, device=dev)

    def rot_y(c, sn, flip):
        """[4, 3, 3]: [[c, 0, -sn], [0, 1, 0], [sn, 0, c]], or with the
        flip [[c, 0, sn], [0, -1, 0], [sn, 0, -c]]."""
        c = c.expand(4)
        if flip:
            rows = [torch.stack([c, zero, sn], -1), torch.stack([zero, -one, zero], -1),
                    torch.stack([sn, zero, -c], -1)]
        else:
            rows = [torch.stack([c, zero, -sn], -1), torch.stack([zero, one, zero], -1),
                    torch.stack([sn, zero, c], -1)]
        return torch.stack(rows, dim=-2)

    # Case d' = +d2: rotation about y by theta.
    sin_t = prod / torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    Rp_pos = rot_y(cos_t, sign4 * sin_t, flip=False)
    tp_pos = torch.stack([x1s, zero, -x3s], dim=-1) * (d1 - d3)
    # Case d' = -d2: rotation about y by phi with a flip.
    sin_p = prod / torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    Rp_neg = rot_y(cos_p, sign4 * sin_p, flip=True)
    tp_neg = torch.stack([x1s, zero, x3s], dim=-1) * (d1 + d3)
    Rp = torch.cat([Rp_pos, Rp_neg])                                 # [8, 3, 3]
    tp = torch.cat([tp_pos, tp_neg])                                 # [8, 3]
    Rs = s * U @ Rp @ Vh
    ts = tp @ U.T
    return Rs, ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=eps)


class InitResult(NamedTuple):
    success: torch.Tensor    # bool
    T21: SE3                 # pose of frame 2 w.r.t. frame 1 (unit-ish t)
    points3d: torch.Tensor   # [N, 3] triangulated in frame 1
    good: torch.Tensor       # [N] triangulation inliers
    used_h: torch.Tensor     # bool: the homography was chosen


def reconstruct(res: RansacResult, pts1, pts2, mask, K: torch.Tensor, sigma: float = 1.0,
                min_good: int = 40, min_parallax_deg: float = 1.0) -> InitResult:
    """Select H or F (rh > 0.4, TryInitialize :65-80), enumerate candidate
    motions, CheckRT them all in one batched pass, and accept the winner
    under the reference's distinctness, parallax and support rules
    (ReconstructF :899-937, ReconstructH :476-502)."""
    use_h = res.rh > 0.40
    Rs_h, ts_h = decompose_h(res.H, K)
    Rs_f, ts_f = decompose_e(K.T @ res.F @ K)
    # F's 4 candidates padded to 8 with the identity (never chosen).
    Rs_f = torch.cat([Rs_f, _eye(3, K).expand(4, 3, 3)])
    ts_f = torch.cat([ts_f, torch.ones((4, 3), dtype=K.dtype, device=K.device)])
    cand_valid = torch.arange(8, device=K.device) < 4
    Rs = torch.where(use_h, Rs_h, Rs_f)
    ts = torch.where(use_h, ts_h, ts_f)
    valid = use_h | cand_valid
    inl = torch.where(use_h, res.inliers_h, res.inliers_f) & mask
    out = check_rt(Rs, ts, pts1, pts2, inl, K, sigma)
    n_goods = torch.where(valid, out.n_good, -1)
    best = torch.argmax(n_goods)                       # the first best wins
    n_best = n_goods[best]
    n_second = torch.sort(n_goods).values[-2]
    n_inl = torch.sum(inl)
    success = ((n_best >= min_good)
               & (n_best.float() > 0.9 * n_inl.float() * 0.5)
               & (n_second.float() < 0.75 * n_best.float())
               & (out.parallax_deg[best] > min_parallax_deg))
    return InitResult(success=success, T21=SE3(Rs[best], ts[best]),
                      points3d=out.points3d[best], good=out.good[best], used_h=use_h)


def initialize_two_view(pts1, pts2, mask, K: torch.Tensor, generator: torch.Generator,
                        sigma: float = 1.0, n_hypotheses: int = 200,
                        min_good: int = 40) -> InitResult:
    """Monocular bootstrap from tracked correspondences
    (Initializer::TryInitialize): RANSAC H+F, model selection,
    reconstruction.  Callers follow with two-view BA and the mean-depth-1
    rescaling (VisualOdometry.cpp:148-151, :261-275)."""
    idx = sample_hypotheses(mask, n_hypotheses, generator)
    res = ransac_hf_from_samples(idx, pts1, pts2, mask, sigma)
    return reconstruct(res, pts1, pts2, mask, K, sigma, min_good)
