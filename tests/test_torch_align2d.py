"""Parity of the port's patch alignment (align2d_prepare, K1 + K4
through ops.align.align2d) with the JAX package's align2d_fused kernel
run in interpret mode, on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.ops import align as jalign
from ygz_slam_tpu.ops.pallas import align2d_fused as jaf

from ygz_slam_tpu_torch.convert import align2d_prep_from_numpy
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.ops import align as talign
from ygz_slam_tpu_torch.ops.interp import sample_patches
from ygz_slam_tpu_torch.ops.kernels import align2d_fused as tk4
from ygz_slam_tpu_torch.ops.kernels.align2d_kernel import CACHE_SLACK
from ygz_slam_tpu_torch.ops.align import substitute_inits

from _torch_port import jax_kernels_interpreted, np32, workload

torch.set_num_threads(1)

# Positions of points both packages accept: the two run the same ten
# float32 iterations and differ in reduction order only (~1e-6 relative
# in each gradient sum), so accepted positions agree far below the
# 0.03 px convergence step; a freeze decision that flips on rounding can
# move one point by one sub-0.03 px step, which the 98% agreement allows.
TOL_XY = 1e-3
MIN_AGREE = 0.98
# Inverse normal matrices from LAPACK (PyTorch) and XLA's LU (JAX).
TOL_HINV_REL = 1e-4


def _jprep_arrays(jprep):
    return [np32(a) for a in (jprep.ref, jprep.jx, jprep.jy, jprep.hinv)]


@pytest.fixture(scope="module")
def case():
    """Map points of the workload projected with frame 0's pose onto
    frame 1 (~1.5 px of motion), plus a few inits outside the image and
    one far beyond the cache slack."""
    cam, px, depth, mask, pts_w, patches, ref_pyr, frames, T_gt7 = workload(2)
    proj = cam.world_to_pixel(pts_w, TSE3.from_params7(T_gt7[0]), distorted=False)
    proj[:3] = torch.tensor([[2.0, 100.0], [639.0, 470.0], [300.0, -4.0]])
    proj[3] += torch.tensor([float(CACHE_SLACK) + 4.0, 0.0])
    img = frames[1]
    with jax_kernels_interpreted():
        jprep = jaf.align2d_prepare(jnp.asarray(np32(patches)))
        jres = jalign.align2d(jnp.asarray(np32(img)), jnp.asarray(np32(patches)),
                              jnp.asarray(np32(proj)), prep=jprep)
    return dict(img=img, patches=patches, proj=proj, jprep=jprep, jres=jres)


def test_align2d_prepare_matches_jax(case):
    tprep = tk4.align2d_prepare(case["patches"])
    ref, jx, jy, hinv = _jprep_arrays(case["jprep"])
    unpacked = align2d_prep_from_numpy(ref, jx, jy, hinv, "cpu")
    for a, b in zip(tprep[:3], unpacked[:3]):
        np.testing.assert_allclose(np32(a), np32(b), atol=1e-5)
    h = np32(unpacked.hinv)
    np.testing.assert_allclose(np32(tprep.hinv), h, atol=TOL_HINV_REL * np.abs(h).max())


def test_align2d_twin_matches_jax_kernel(case):
    jres = case["jres"]
    jxy, jconv = np32(jres.xy), np32(jres.converged)
    assert np.isfinite(jxy).all(), "JAX reference positions not finite"
    prep = align2d_prep_from_numpy(*_jprep_arrays(case["jprep"]), "cpu")
    tres = talign.align2d(case["img"], case["patches"], case["proj"], prep=prep)
    tconv = np32(tres.converged)
    assert (tconv == jconv).mean() >= MIN_AGREE
    both = tconv & jconv
    dxy = np.linalg.norm(np32(tres.xy)[both] - jxy[both], axis=1)
    assert (dxy <= TOL_XY).mean() >= MIN_AGREE, np.sort(dxy)[-5:]
    np.testing.assert_allclose(np32(tres.error)[both], np32(jres.error)[both], atol=1e-3)
    # The gates: off-image inits are never accepted, and whatever is
    # accepted drifted less than the cache slack from its init.
    assert not tconv[:3].any()
    drift = np.linalg.norm(np32(tres.xy) - np32(case["proj"]), axis=1)
    assert (drift[tconv] < CACHE_SLACK).all()
    assert both.sum() >= 190


def test_port_prep_end_to_end(case):
    """The port's own prep through align2d converges on most points and
    lands them within a fraction of a pixel of the JAX result."""
    tres = talign.align2d(case["img"], case["patches"], case["proj"])
    jxy, jconv = np32(case["jres"].xy), np32(case["jres"].converged)
    both = np32(tres.converged) & jconv
    assert both.sum() >= 190
    assert np.median(np.linalg.norm(np32(tres.xy)[both] - jxy[both], axis=1)) < TOL_XY


def test_drift_beyond_cache_is_rejected():
    """An init farther than CACHE_SLACK from its true position cannot be
    reached inside the cache: align2d must not accept a clamped result."""
    img = torch.tensor(np.random.default_rng(1).uniform(0, 255, (240, 320)),
                       dtype=torch.float32)
    rng = np.random.default_rng(2)
    xy = torch.tensor(np.c_[rng.uniform(40, 280, 32), rng.uniform(40, 200, 32)],
                      dtype=torch.float32)
    init = xy + torch.tensor([[float(CACHE_SLACK) + 4.0, 0.0]])
    res = talign.align2d(img, sample_patches(img, xy, 10), init)
    drift = torch.linalg.norm(res.xy - init, dim=1)
    assert bool((drift[res.converged] < float(CACHE_SLACK)).all())


def test_exit_per_point_is_exact(case):
    """K4 leaves a warp's loop once its points are frozen.  The plain
    version with the same exit (each iteration takes only the points not yet
    frozen, the loop ends once none is left) gives the full ten-iteration
    loop's outputs bit for bit on the recorded inputs, which hold points
    that freeze early, late and never."""
    img = case["img"]
    xy0, _ = substitute_inits(case["proj"], *img.shape)
    args = tk4.a2d_args(img, tk4.align2d_prepare(case["patches"]), xy0)
    stats = {}
    full = tk4.a2d_gn_plain(*args, stats=stats)
    its = stats["iterations"]
    print(f"iterations before freezing: {torch.bincount(its).tolist()} (index = count)")
    assert int(its.min()) <= 3 and int((its == 10).sum()) > 0
    exit_stats = {}
    assert torch.equal(tk4.a2d_gn_plain(*args, exit_frozen=True, stats=exit_stats), full)
    assert torch.equal(exit_stats["iterations"], its)
    assert torch.equal(tk4.a2d_gn(*args), full)
