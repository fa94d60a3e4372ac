"""Pose-prior-free camera localization: batched P3P inside RANSAC
(counterpart of ygz_slam_tpu/solvers/pnp.py).

H hypothesis triples are drawn at once, every P3P is solved in one batch
(Grunert's quartic through the closed-form solver of `quartic.py`: no
eigendecomposition), and all H x 4 candidate poses are scored against all N
correspondences in one batched reprojection; the best by inlier count wins.
The caller refines it with pose-only BA.

As in `initializer.py`, the random draw is its own function,
`sample_triples`, so a caller can hand `ransac_pnp_from_samples` triples
drawn elsewhere (the JAX package's `jax.random.categorical` draws, in the
tests).  Every function takes leading batch dimensions (relocalization
scores its candidate keyframes in one batch), and none waits for the
device.

P3P algebra (Grunert 1841 / Fischler-Bolles 1981): with unit bearings
f1, f2, f3 to world points P1, P2, P3, the pairwise angles and distances
constrain the depths s_i along each ray by the law of cosines; eliminating
s2 = u s1, s3 = v s1 leaves a quartic in v.  Each real root gives depths,
camera-frame points and the orientation that maps one point triad onto the
other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import SE3
from .quartic import quartic_roots, real_roots_mask

_XS = (-2.0, -1.0, 0.0, 1.0, 2.0)   # abscissae the quartic is sampled at
_VINV: dict = {}                     # device -> the Vandermonde inverse there


def _vandermonde_inverse(device: torch.device) -> torch.Tensor:
    """Inverse of the 5x5 Vandermonde of _XS (rows [1, x, ..., x^4]),
    computed in float64 on the host once and kept on each device as float32
    (a copy per call would wait for the device)."""
    if device not in _VINV:
        xs = np.asarray(_XS, np.float64)
        V = np.stack([xs ** k for k in range(5)], axis=-1)
        _VINV[device] = torch.tensor(np.linalg.inv(V), dtype=torch.float32, device=device)
    return _VINV[device]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


def _triad(p1, p2, p3) -> torch.Tensor:
    """Orthonormal frame [..., 3, 3] (columns) of a point triple."""
    e1 = _unit(p2 - p1)
    v2 = p3 - p1
    e2 = _unit(v2 - torch.sum(v2 * e1, dim=-1, keepdim=True) * e1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def p3p(pts_w: torch.Tensor, f: torch.Tensor):
    """Grunert P3P: world triples [..., 3, 3] and unit camera bearings
    [..., 3, 3] -> up to 4 poses T_cw (x_cam = R x_world + t): (R [..., 4, 3,
    3], t [..., 4, 3], ok [..., 4]), invalid roots masked."""
    P1, P2, P3 = pts_w[..., 0, :], pts_w[..., 1, :], pts_w[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    a = torch.linalg.norm(P2 - P3, dim=-1)
    b = torch.linalg.norm(P1 - P3, dim=-1)
    c = torch.linalg.norm(P1 - P2, dim=-1)
    ca = torch.sum(f2 * f3, dim=-1)        # cos alpha
    cb = torch.sum(f1 * f3, dim=-1)        # cos beta
    cg = torch.sum(f1 * f2, dim=-1)        # cos gamma
    b2 = torch.clamp(b * b, min=1e-12)
    A = (a * a) / b2
    C = (c * c) / b2

    def p_of(v, A, C, ca, cb, cg):
        """The quartic p(v): with u = N(v) / D(v), N^2 - 2 N D cg + D^2 (1 -
        C Q) = 0."""
        Q = v * v - 2.0 * v * cb + 1.0
        N = Q * (A - C) + 1.0 - v * v
        D = 2.0 * (cg - v * ca)
        return N * N - 2.0 * N * D * cg + D * D * (1.0 - C * Q)

    # The coefficients, exactly: p sampled at 5 abscissae, then the fixed
    # Vandermonde inverse (no hand-expanded coefficient algebra).
    ys = torch.stack([p_of(x, A, C, ca, cb, cg) for x in _XS], dim=-1)       # [..., 5]
    coef = torch.einsum("ij,...j->...i", _vandermonde_inverse(ys.device), ys)  # c0..c4
    roots = quartic_roots(coef[..., 4], coef[..., 3], coef[..., 2], coef[..., 1],
                          coef[..., 0])                                    # [..., 4]
    v = roots.real
    ok = real_roots_mask(roots) & (v > 1e-6)
    # Real Newton polish on the direct constraint p(v), better conditioned
    # near the physical root than the sampled polynomial.
    ex = [x[..., None] for x in (A, C, ca, cb, cg)]
    h = 1e-3
    for _ in range(4):
        pv = p_of(v, *ex)
        dp = (p_of(v + h, *ex) - p_of(v - h, *ex)) / (2.0 * h)
        dp = torch.where(torch.abs(dp) < 1e-12, 1e-12, dp)
        v = v - torch.clamp(pv / dp, -0.1, 0.1)

    Q = v * v - 2.0 * v * cb[..., None] + 1.0
    N = Q * (A - C)[..., None] + 1.0 - v * v
    D = 2.0 * (cg[..., None] - v * ca[..., None])
    D = torch.where(torch.abs(D) < 1e-9, 1e-9, D)
    u = N / D
    ok = ok & (u > 1e-6)
    # s1 from the beta law of cosines: s1^2 Q = b^2.
    s1 = b[..., None] / torch.sqrt(torch.clamp(Q, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    X1 = s1[..., None] * f1[..., None, :]           # [..., 4, 3]
    X2 = s2[..., None] * f2[..., None, :]
    X3 = s3[..., None] * f3[..., None, :]
    Bc = _triad(X1, X2, X3)                          # [..., 4, 3, 3]
    Aw = _triad(P1, P2, P3)                          # [..., 3, 3]
    R = Bc @ Aw[..., None, :, :].transpose(-1, -2)
    t = X1 - torch.einsum("...ij,...j->...i", R, P1[..., None, :])
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1) & torch.isfinite(t).all(dim=-1)
    return R, t, ok & finite


class PnPResult(NamedTuple):
    T_cw: SE3
    n_inliers: torch.Tensor
    inlier: torch.Tensor    # [..., N]
    ok: torch.Tensor        # any usable hypothesis found


def sample_triples(mask: torch.Tensor, n_hyp: int, generator: torch.Generator) -> torch.Tensor:
    """[..., n_hyp, 3] row indices drawn uniformly, with replacement, from
    the valid rows of `mask [..., N]` (from all rows where none is valid,
    as the JAX package's categorical over logits of -1e9 does): an
    inverse-CDF draw, so an empty mask neither raises nor waits."""
    N = mask.shape[-1]
    w = mask.to(torch.float32)
    w = torch.where(torch.any(mask, dim=-1, keepdim=True), w, torch.ones_like(w))
    cdf = torch.cumsum(w, dim=-1)                    # whole numbers: exact
    u = torch.rand(tuple(mask.shape[:-1]) + (n_hyp * 3,), generator=generator,
                   device=mask.device) * cdf[..., -1:]
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True), max=N - 1)
    return idx.reshape(tuple(mask.shape[:-1]) + (n_hyp, 3))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, D] at idx [..., H, 3] -> [..., H, 3, D]."""
    flat = idx.reshape(tuple(idx.shape[:-2]) + (-1,)).long()
    g = torch.gather(x, -2, flat[..., None].expand(tuple(flat.shape) + (x.shape[-1],)))
    return g.reshape(tuple(idx.shape) + (x.shape[-1],))


def _pick(x: torch.Tensor, best: torch.Tensor, trailing: int) -> torch.Tensor:
    """x [..., H4, *rest] at best [...] -> [..., *rest] (`trailing` = len(rest))."""
    ix = best.reshape(tuple(best.shape) + (1,) * (trailing + 1))
    ix = ix.expand(tuple(best.shape) + (1,) + tuple(x.shape[x.dim() - trailing:]))
    return torch.gather(x, best.dim(), ix).squeeze(best.dim())


def ransac_pnp_from_samples(pts_w: torch.Tensor, px: torch.Tensor, mask: torch.Tensor, cam,
                            idx: torch.Tensor, inlier_px: float = 4.0,
                            min_sep_px: float = 12.0) -> PnPResult:
    """RANSAC over the P3P hypotheses of the triples `idx [..., H, 3]`
    (everything of `ransac_pnp` after its draw), for world points [..., N,
    3], raw pixels [..., N, 2] and valid rows [..., N].  Inliers are counted
    on the ideal-pinhole reprojection error (pose-only BA's solver
    boundary) with cheirality; a triple whose pixels lie closer than
    `min_sep_px` to each other, or that holds an invalid row, is dropped.
    The best of the H x 4 poses, the first on ties, is returned."""
    pxu = cam.undistort_px(px)
    f_all = _unit(cam.pixel_to_camera(px, 1.0))
    tri_w, tri_f, tri_px = _take(pts_w, idx), _take(f_all, idx), _take(pxu, idx)
    tri_valid = _take(mask[..., None], idx)[..., 0].all(dim=-1)
    d01 = torch.linalg.norm(tri_px[..., 0, :] - tri_px[..., 1, :], dim=-1)
    d02 = torch.linalg.norm(tri_px[..., 0, :] - tri_px[..., 2, :], dim=-1)
    d12 = torch.linalg.norm(tri_px[..., 1, :] - tri_px[..., 2, :], dim=-1)
    tri_valid = tri_valid & (torch.minimum(torch.minimum(d01, d02), d12) >= min_sep_px)

    R, t, ok = p3p(tri_w, tri_f)                             # [..., H, 4, ...]
    lead = tuple(idx.shape[:-2])
    H4 = idx.shape[-2] * 4
    Rf = R.reshape(lead + (H4, 3, 3))
    tf = t.reshape(lead + (H4, 3))
    okf = (ok & tri_valid[..., None]).reshape(lead + (H4,))
    # Score: one [..., H4, N] reprojection.
    pc = torch.einsum("...hij,...nj->...hni", Rf, pts_w) + tf[..., :, None, :]
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    proj = torch.stack([cam.fx * pc[..., 0] / zs + cam.cx,
                        cam.fy * pc[..., 1] / zs + cam.cy], dim=-1)
    err2 = torch.sum((proj - pxu[..., None, :, :]) ** 2, dim=-1)
    good = (err2 < inlier_px * inlier_px) & (z > 1e-3) & mask[..., None, :]
    score = torch.sum(good, dim=-1, dtype=torch.int32) * okf.to(torch.int32)
    best = torch.argmax(score, dim=-1)
    n_inl = _pick(score, best, 0)
    return PnPResult(T_cw=SE3(_pick(Rf, best, 2), _pick(tf, best, 1)), n_inliers=n_inl,
                     inlier=_pick(good, best, 1), ok=(n_inl > 0) & _pick(okf, best, 0))


def ransac_pnp(pts_w: torch.Tensor, px: torch.Tensor, mask: torch.Tensor, cam,
               generator: torch.Generator | None = None, n_hyp: int = 256,
               inlier_px: float = 4.0, min_sep_px: float = 12.0) -> PnPResult:
    """Pose-prior-free RANSAC over batched P3P hypotheses: `n_hyp` triples
    drawn by `sample_triples` with `generator` (a fresh one seeded 0 on the
    points' device if none is given), then `ransac_pnp_from_samples`."""
    if generator is None:
        generator = torch.Generator(device=pts_w.device).manual_seed(0)
    idx = sample_triples(mask, n_hyp, generator)
    return ransac_pnp_from_samples(pts_w, px, mask, cam, idx, inlier_px, min_sep_px)
