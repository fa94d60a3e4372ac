"""The port's `entry()` against `__graft_entry__.entry()` on the CPU: the
same example problem (from `default_rng(0)`), and fn's pose, inlier count
and chi2 against the JAX fn's (which takes its CPU route, jnp solvers)."""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft

from ygz_slam_tpu_torch.entry import entry
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3

from _torch_port import np32

torch.set_num_threads(1)

NAMES = ("ref_pyr", "cur_pyr", "px", "depth", "mask", "pts_w", "obs_px")
# Pyramid levels 1-2: the same banded smoothing products, summed in other
# orders by XLA and PyTorch (0-255 intensities, ~1e-7 relative).
TOL_PYR = 1e-4
# The two fns run different solvers (the port K3's and K5's plain versions,
# the JAX package its jnp fallbacks on the CPU), on noise images where sparse
# alignment moves the pose by ~0.08 and pose BA sets the result.
TOL_POSE = 1e-3
TOL_CHI2_REL = 1e-2


@pytest.fixture(scope="module")
def both():
    fn, args = entry("cpu")
    jfn, jargs = graft.entry()
    return fn, args, jax.jit(jfn), jargs


@pytest.mark.parametrize("k", range(len(NAMES)), ids=NAMES)
def test_example_arrays_equal_jax(both, k):
    _, args, _, jargs = both
    a, b = args[k], jargs[k]
    if NAMES[k].endswith("pyr"):
        np.testing.assert_array_equal(np32(a[0]), np32(b[0]))
        for lt, lj in zip(a[1:], b[1:]):
            np.testing.assert_allclose(np32(lt), np32(lj), rtol=0, atol=TOL_PYR)
    else:
        np.testing.assert_array_equal(np32(a), np32(b))


def test_fn_matches_jax(both):
    fn, args, jfn, jargs = both
    T7, n_inl, chi2 = fn(*args)
    jT7, jn, jchi2 = (np32(o) for o in jfn(*jargs))
    d = float(tse3.distance(TSE3.from_params7(T7), TSE3.from_params7(torch.tensor(jT7))))
    e = abs(float(chi2) - float(jchi2)) / abs(float(jchi2))
    moved = float(tse3.distance(TSE3.from_params7(T7), TSE3.identity(device="cpu")))
    print(f"entry fn, port vs JAX on the CPU: pose distance {d:.3e}, inliers {int(n_inl)} vs "
          f"{int(jn)}, chi2 {float(chi2):.4f} vs {float(jchi2):.4f} ({e:.1e} relative); the "
          f"pose moved {moved:.3f} from the identity")
    assert d <= TOL_POSE
    assert int(n_inl) == int(jn) == 200
    assert e <= TOL_CHI2_REL
