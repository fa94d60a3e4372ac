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


# -- dryrun_multichip ----------------------------------------------------------

TOL_DRY_POSE = 2e-5      # test_torch_sharded_ba.py's tolerances
TOL_DRY_POINT = 2e-4
TOL_DRY_CHI2 = 1e-6      # absolute: the 2-iteration solve of noise-free pixels ends at ~1e-9
TOL_DRY_SEQ = 1e-4       # the sequences align a pyramid to itself: both stay at the identity


def _jax_dryrun(n):
    """`__graft_entry__.dryrun_multichip(n)`'s two programs on the same draws,
    returning what it only asserts on: (poses params7, landmark rows, chi2,
    sequence poses params7)."""
    import jax.numpy as jnp
    from ygz_slam_tpu.geometry import SE3, PinholeCamera, so3
    from ygz_slam_tpu.ops import pyramid as jpyr
    from ygz_slam_tpu.parallel import make_mesh, partition_observations, sharded_local_ba
    from ygz_slam_tpu.parallel.batch_tracking import sharded_batch_align

    rng = np.random.default_rng(0)
    K, L = 4, 8 * n
    cam = PinholeCamera.create(100.0, 100.0, 64.0, 48.0)
    pts = np.c_[rng.uniform(-1, 1, (L, 2)), rng.uniform(3, 5, L)].astype(np.float32)
    poses = [SE3(so3.exp(jnp.asarray(rng.normal(size=3) * 0.02, jnp.float32)),
                 jnp.asarray([0.1 * k, 0, 0], jnp.float32)) for k in range(K)]
    poses = jax.tree.map(lambda *xs: jnp.stack(xs), *poses)
    px = jax.vmap(lambda T: cam.world_to_pixel(jnp.asarray(pts), T, distorted=False))(poses)
    kf_idx = np.repeat(np.arange(K, dtype=np.int32), L)
    pt_idx = np.tile(np.arange(L, dtype=np.int32), K)
    mesh = make_mesh(n)
    sobs, L_pad = partition_observations(kf_idx, pt_idx, np.asarray(px).reshape(-1, 2),
                                         np.ones(K * L, bool), L, n)
    p, x, chi2 = jax.jit(lambda p, x, o: sharded_local_ba(
        mesh, p, x, o, cam, jnp.zeros(K, bool).at[0].set(True), n_iter=2))(
        poses, jnp.concatenate([jnp.asarray(pts), jnp.zeros((L_pad - L, 3))]), sobs)
    S, N, h, w = n, 16, 64, 64
    cam2 = PinholeCamera.create(40.0, 40.0, w / 2, h / 2)
    imgs = jnp.asarray(rng.uniform(0, 255, (S, h, w)), jnp.float32)
    pyrs = tuple(jax.vmap(lambda im: jpyr.build_pyramid(im, 3))(imgs))
    px2 = jnp.asarray(np.stack([np.c_[rng.uniform(10, w - 10, N), rng.uniform(10, h - 10, N)]
                                for _ in range(S)]), jnp.float32)
    d2 = jnp.asarray(rng.uniform(2.0, 4.0, (S, N)), jnp.float32)
    T7 = jax.jit(lambda pyrs, px2, d2: sharded_batch_align(
        mesh, pyrs, pyrs, cam2, px2, d2, jnp.ones((S, N), bool), SE3.identity((S,)),
        n_iter=3).params7())(pyrs, px2, d2)
    return np32(p.params7()), np32(x), float(chi2), np32(T7)


def test_dryrun_multichip_matches_jax():
    """`dryrun_multichip(8, device="cpu")` (a rank holding 8 shards) against
    the JAX function's two programs on `make_mesh(8)`, on the same draws."""
    import torch.distributed as dist
    from ygz_slam_tpu_torch.entry import dryrun_multichip

    p, x, chi2, T = dryrun_multichip(8, device="cpu")
    assert not dist.is_initialized()            # the world of one it started has ended
    jp7, jx, jchi2, jT7 = _jax_dryrun(8)
    dp, dx = np.abs(np32(p.params7()) - jp7).max(), np.abs(np32(x) - jx).max()
    ds = float(tse3.distance(T, TSE3.from_params7(torch.tensor(jT7))).max())
    print(f"measured: dryrun_multichip(8) port against JAX: params7 {dp:.2e}, points {dx:.2e}, "
          f"chi2 {float(chi2):.3e} vs {jchi2:.3e}, sequence poses {ds:.2e}")
    assert x.shape == (64, 3) and T.R.shape == (8, 3, 3)
    assert dp <= TOL_DRY_POSE and dx <= TOL_DRY_POINT and abs(float(chi2) - jchi2) <= TOL_DRY_CHI2
    assert ds <= TOL_DRY_SEQ


# -- utils/profiling ------------------------------------------------------------

def test_timers_and_bench_log():
    import json
    from ygz_slam_tpu_torch.utils import profiling

    timers = profiling.Timers()
    x = torch.ones(1000)
    for _ in range(3):
        with timers.time("sum", block_on=(x, [x])):
            (x * 2).sum()
    with timers.time("other"):
        pass
    s = timers.summary()
    assert list(s) == ["other", "sum"] and s["sum"]["count"] == 3 and s["other"]["count"] == 1
    assert json.loads(timers.log_line()) == s
    timers.reset()
    assert timers.summary() == {}


def test_device_trace_writes_a_trace(tmp_path):
    from ygz_slam_tpu_torch.utils import profiling

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
