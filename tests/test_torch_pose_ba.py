"""Parity of the port's pose-only BA (K5 through solvers.ba.pose_only_ba)
with the JAX package's pose_only_ba_fused kernel run in interpret mode,
on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.solvers import ba as jba

from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.solvers import ba as tba

from _torch_port import jax_camera, jax_kernels_interpreted, np32, workload

torch.set_num_threads(1)

# Twin versus the JAX kernel on identical inputs: the same rounds and GN
# iterations in float32, differing only in reduction order (~1e-6
# relative in each normal equation) and so in poses far below the 1e-4
# stopping step; the bisection medians and chi2 reclassification see the
# same residuals up to that rounding.
TOL_POSE = 1e-4
MIN_INLIER_AGREE = 0.99


def _observations(seed, n_outliers, n_masked):
    """Map points observed in frame 1 with 0.3 px noise, some gross
    outliers and some masked rows; init at frame 0's pose."""
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = workload(2)
    rng = np.random.default_rng(seed)
    obs = cam.world_to_pixel(pts_w, TSE3.from_params7(T_gt7[1]), distorted=False)
    obs = obs + torch.tensor(rng.normal(0, 0.3, obs.shape), dtype=torch.float32)
    bad = rng.choice(obs.shape[0], n_outliers + n_masked, replace=False)
    obs[bad[:n_outliers]] += torch.tensor(rng.uniform(8, 30, (n_outliers, 2)),
                                          dtype=torch.float32)
    mask = torch.ones(obs.shape[0], dtype=torch.bool)
    mask[bad[n_outliers:]] = False
    return cam, pts_w, obs, mask, np32(T_gt7[0]), TSE3.from_params7(T_gt7[1]), bad[:n_outliers]


CASES = {"clean": (1, 0, 0), "outliers": (2, 30, 10)}


@pytest.fixture(scope="module")
def cases():
    out = {}
    with jax_kernels_interpreted():
        for name, (seed, n_out, n_mask) in CASES.items():
            cam, pts_w, obs, mask, T07, T_gt1, outl = _observations(seed, n_out, n_mask)
            T, inl, chi2 = jba.pose_only_ba(
                JSE3.from_params7(jnp.asarray(T07)), jnp.asarray(np32(pts_w)),
                jnp.asarray(np32(obs)), jnp.asarray(np32(mask)), jax_camera(cam),
                use_fused=True)
            out[name] = dict(cam=cam, pts_w=pts_w, obs=obs, mask=mask, T07=T07, T_gt1=T_gt1,
                             outl=outl, jT=(np32(T.R), np32(T.t)), jinl=np32(inl),
                             jchi2=float(chi2))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_jax_kernel(cases, name):
    c = cases[name]
    Rj, tj = c["jT"]
    assert np.isfinite(Rj).all() and np.isfinite(tj).all(), "JAX reference pose not finite"
    T, inl, chi2 = tba.pose_only_ba(TSE3.from_params7(torch.tensor(c["T07"])), c["pts_w"],
                                    c["obs"], c["mask"], c["cam"])
    d = float(tse3.distance(T, TSE3(torch.tensor(Rj), torch.tensor(tj))))
    assert d <= TOL_POSE, d
    assert (np32(inl) == c["jinl"]).mean() >= MIN_INLIER_AGREE
    assert float(chi2) == pytest.approx(c["jchi2"], rel=1e-3)
    assert float(tse3.distance(T, c["T_gt1"])) < 2e-3
    assert not np32(inl)[~np32(c["mask"])].any()        # masked rows never inliers
    assert not np32(inl)[c["outl"]].any()               # gross outliers rejected


def test_keeps_inliers_when_none_pass():
    """Reclassification keeps the previous inlier set when no point passes
    the chi2 test (every observation off by 10 px)."""
    cam, pts_w, obs, mask, T07, _, _ = _observations(3, 0, 0)
    T, inl, _ = tba.pose_only_ba(TSE3.from_params7(torch.tensor(T07)), pts_w,
                                 obs + torch.tensor([10.0, 0.0]) * torch.tensor(
                                     np.random.default_rng(4).choice([-1.0, 1.0], (200, 1)),
                                     dtype=torch.float32), mask, cam)
    assert torch.isfinite(T.R).all() and torch.isfinite(T.t).all()
    assert int(inl.sum()) == int(mask.sum())


def test_kernel_inputs_carry_the_mask_as_bool(cases):
    """K5's and K8's inputs carry the mask as bool (the kernels count each
    point's weight as 0 or 1), and the plain versions give the same bits
    for it as for the same mask in 0/1 floats."""
    from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused as tk5
    from ygz_slam_tpu_torch.ops.kernels import pose_ba_fused_batch as tk8

    c = cases["outliers"]
    T0 = TSE3.from_params7(torch.tensor(c["T07"]))
    args = tk5.pose_ba_args(T0, c["pts_w"], c["obs"], c["mask"], c["cam"])
    assert args[2].dtype == torch.bool and not bool(args[2].all())
    out_b, inl_b = tk5.pose_ba_gn_plain(*args)
    out_f, inl_f = tk5.pose_ba_gn_plain(*args[:2], args[2].float(), *args[3:])
    assert torch.equal(out_b, out_f) and torch.equal(inl_b, inl_f)
    T0b = TSE3(T0.R[None], T0.t[None])
    args8 = tk8.pose_ba_batch_args(T0b, c["pts_w"][None], c["obs"][None], c["mask"][None].float(),
                                   c["cam"])
    assert args8[2].dtype == torch.bool
    out8, inl8 = tk8.pose_ba_batch_gn_plain(*args8)
    assert torch.equal(out8[0], out_b) and torch.equal(inl8[0], inl_b)
