"""The port's scale-out BA (parallel/mesh.py, parallel/sharded_ba.py,
map/memory.partition_obs) against the JAX package's on the CPU.

The JAX side runs `sharded_local_ba` on `make_mesh(8)` (tests/conftest.py's
8 virtual CPU devices), once per module, on tests/test_parallel.py's
problem (K=6 keyframes, 64 landmarks, 0.3 px noise, two gauge-fixed poses,
12 iterations), with each iteration's start chi2 and its accept / reject
decision read out of the scan.  The port runs the same problem on a gloo
world of one rank holding 1, 2, 4 or 8 shards.

Tolerances: the JAX package holds its own 1-D and 2-D meshes to 1e-5 on
the poses and 1e-4 on the points (test_parallel.py's
test_2d_host_chip_mesh_matches_1d; they agree exactly on this problem);
the port, whose sums run in other orders, is held to twice that.  An
accept decision must agree wherever the trial's chi2 is more than
DECIDE_MARGIN (relative) off the iteration's: closer than that, float32
rounding decides it (at convergence every trial lands within ~5e-6)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from ygz_slam_tpu import native
from ygz_slam_tpu.parallel import make_mesh as jmake_mesh
from ygz_slam_tpu.parallel import partition_observations as jpartition
from ygz_slam_tpu.parallel import sharded_local_ba as jsharded_local_ba

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.map.memory import partition_obs
from ygz_slam_tpu_torch.parallel import mesh as tmesh
from ygz_slam_tpu_torch.parallel import sharded_ba as tsba
from ygz_slam_tpu_torch.solvers import ba as tba

import test_parallel
from _torch_port import np32

torch.set_num_threads(1)

TOL_POSE = 2e-5          # params7, twice test_parallel.py's 1-D versus 2-D bound
TOL_POINT = 2e-4         # landmarks, the same rule
TOL_CHI2_REL = 1e-4      # measured ~4e-6: float32 sums of 384 terms in other orders
DECIDE_MARGIN = 1e-5     # accept decisions compared where |chi2_new - chi2| exceeds this, relative
N_ITER = 12
L = 64


@pytest.fixture(scope="module", autouse=True)
def _one_rank():
    """The port's meshes here run in a gloo world of one; end it after the
    module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def jax_sharded_run(mesh, poses, pts_pad, sobs, cam, fixed, n_iter):
    """The JAX sharded_local_ba, with each iteration's start chi2 and
    damping before and after read out of its scan (accept = the damping
    halved).  Returns (params7, points, chi2, chi2 per iteration, accept per
    iteration)."""
    rec = []
    real_scan = jax.lax.scan

    def scan(f, init, xs, length=None, **kw):
        def body(c, x):
            c2, y = f(c, x)
            return c2, (y, c[2], c2[2])

        out, (ys, lam0, lam1) = real_scan(body, init, xs, length=length, **kw)
        jax.debug.callback(lambda *a: rec.append(tuple(map(np.asarray, a))), ys, lam0, lam1)
        return out, ys

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", scan)
        p, x, c = jsharded_local_ba(mesh, poses, pts_pad, sobs, cam, fixed, n_iter=n_iter)
        jax.block_until_ready(c)
    ys, lam0, lam1 = rec[0]
    return np32(p.params7()), np32(x), float(c), ys, lam1 < lam0


@pytest.fixture(scope="module")
def problem():
    """test_parallel.py's problem as numpy arrays, and the JAX 8-shard
    solve of it."""
    poses, pts, noisy_poses, noisy_pts, kf_idx, pt_idx, pxf, mask, fixed = \
        test_parallel.make_problem()
    sobs, L_pad = jpartition(kf_idx, pt_idx, pxf, mask, L, 8)
    pts_pad = jnp.concatenate([noisy_pts, jnp.zeros((L_pad - L, 3))])
    jp7, jx, jc, jys, jacc = jax_sharded_run(jmake_mesh(8), noisy_poses, pts_pad, sobs,
                                             test_parallel.CAM, fixed, N_ITER)
    return dict(gt7=np32(poses.params7()), pts=np32(pts), p7=np32(noisy_poses.params7()),
                x=np32(noisy_pts), kf=kf_idx, pt=pt_idx, px=pxf, mask=mask, fixed=np32(fixed),
                cam=convert.camera_from_numpy(*test_parallel.CAM),
                j=dict(p7=jp7, x=jx[:L], chi2=jc, chi2s=jys, accept=jacc))


def port_sharded(p, n, n_iter=N_ITER, stats=None):
    mesh = tmesh.make_mesh(n, device="cpu")
    sobs, L_pad = tsba.partition_observations(p["kf"], p["pt"], p["px"], p["mask"], L, n,
                                              device="cpu")
    pts = torch.cat([torch.tensor(p["x"]), torch.zeros(L_pad - L, 3)])
    return tsba.sharded_local_ba(mesh, TSE3.from_params7(torch.tensor(p["p7"])),
                                 mesh.local_rows(pts), tsba.ShardedObs(*map(mesh.local_rows, sobs)),
                                 p["cam"], torch.tensor(p["fixed"]), n_iter=n_iter, stats=stats)


def _pose_err(p7, gt7):
    return float(tse3.distance(TSE3.from_params7(torch.tensor(np32(p7))),
                               TSE3.from_params7(torch.tensor(gt7))).mean())


@pytest.mark.parametrize("L_, S", [(64, 8), (61, 8), (5, 8), (3072, 4)])
def test_partition_obs_equals_native(L_, S):
    """The numpy partitioner writes exactly what the native one writes,
    row for row, on test_native.py's draw (and ragged, sparse and wide
    landmark counts, with indices off both ends)."""
    rng = np.random.default_rng(0)
    O = 500
    kf = rng.integers(0, 6, O).astype(np.int32)
    pt = rng.integers(0, L_, O).astype(np.int32)
    if L_ != 64:
        pt = rng.integers(-3, L_ + 3, O).astype(np.int32)
    px = rng.uniform(0, 640, (O, 2)).astype(np.float32)
    mask = rng.uniform(size=O) > 0.2
    ref = native.partition_obs(kf, pt, px, mask, L_, S)
    assert ref is not None
    for a, b in zip(partition_obs(kf, pt, px, mask, L_, S), ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_matches_jax_8_shards(problem, n):
    """Poses, points, chi2 and the decisive accept / reject decisions
    against the JAX solve on 8 virtual devices, for the port's mesh of one
    rank holding n shards."""
    p, j = problem, problem["j"]
    st = {}
    P, X, C = port_sharded(p, n, stats=st)
    dp, dx = np.abs(np32(P.params7()) - j["p7"]).max(), np.abs(np32(X)[:L] - j["x"]).max()
    dc = abs(float(C) - j["chi2"]) / j["chi2"]
    chi2s, new = np32(st["chi2"]), np32(st["chi2_new"])
    decisive = np.abs(new - chi2s) > DECIDE_MARGIN * chi2s
    acc = np32(st["accept"])
    print(f"measured: {n} shards against JAX: params7 {dp:.2e}, points {dx:.2e}, chi2 {dc:.1e} "
          f"relative; accept {acc.astype(int)} vs {j['accept'].astype(int)}, decisive "
          f"{decisive.astype(int)}")
    assert dp <= TOL_POSE and dx <= TOL_POINT and dc <= TOL_CHI2_REL
    np.testing.assert_allclose(chi2s, j["chi2s"], rtol=TOL_CHI2_REL)
    assert decisive[:3].all()
    np.testing.assert_array_equal(acc[decisive], j["accept"][decisive])


def test_gauge_fixed_poses_unchanged(problem):
    P, _, _ = port_sharded(problem, 8, n_iter=8)
    p7 = torch.tensor(problem["p7"])
    for s in range(2):
        d = float(tse3.distance(TSE3.from_params7(P.params7()[s]), TSE3.from_params7(p7[s])))
        assert d < 1e-6, d


def test_matches_own_local_ba(problem):
    """test_parallel.py's bound: the sharded solve's pose and point errors
    within 1.1x the port's single-device local_ba's, + 1e-4."""
    p = problem
    obs = tba.Observations(torch.tensor(p["kf"]), torch.tensor(p["pt"]), torch.tensor(p["px"]),
                           torch.tensor(p["mask"]))
    res = tba.local_ba(TSE3.from_params7(torch.tensor(p["p7"])), torch.tensor(p["x"]), obs,
                       p["cam"], torch.tensor(p["fixed"]), n_iter=N_ITER)
    P, X, _ = port_sharded(p, 8)
    err1, err2 = _pose_err(res.poses.params7(), p["gt7"]), _pose_err(P.params7(), p["gt7"])
    pt1 = float(np.linalg.norm(np32(res.points) - p["pts"], axis=-1).mean())
    pt2 = float(np.linalg.norm(np32(X)[:L] - p["pts"], axis=-1).mean())
    print(f"measured: pose error local_ba {err1:.5f}, sharded {err2:.5f}; points {pt1:.5f}, "
          f"{pt2:.5f}")
    assert err2 < err1 * 1.1 + 1e-4, (err1, err2)
    assert pt2 < pt1 * 1.1 + 1e-4, (pt1, pt2)


def test_reductions_per_iteration(problem):
    """Two all_reduce calls per iteration, of (K^2 * 36 + 42 K + 1) and 1
    floats, whatever the shard count."""
    K = 6
    for n in (2, 8):
        c0, b0 = tmesh.reduce_sum.calls, tmesh.reduce_sum.bytes
        port_sharded(problem, n, n_iter=3)
        assert tmesh.reduce_sum.calls - c0 == 6
        assert tmesh.reduce_sum.bytes - b0 == 3 * 4 * (K * K * 36 + 42 * K + 2)


def test_mesh_layout_and_backend():
    """A one-rank mesh holds every shard and cuts a mesh-wide array to all
    of it; a 2-D mesh needs one rank per host; the backend follows the
    device."""
    m = tmesh.make_mesh(8, device="cpu")
    assert (m.shards, m.local, m.first, m.world) == (8, 8, 0, 1)
    assert tmesh.landmark_axes(m) == tmesh.LANDMARK_AXIS
    x = torch.arange(16)
    assert torch.equal(m.local_rows(x), x)
    m2 = tmesh.make_mesh_2d(1, 4, device="cpu")
    assert tmesh.landmark_axes(m2) == (tmesh.HOST_AXIS, tmesh.LANDMARK_AXIS) and m2.local == 4
    with pytest.raises(ValueError):
        tmesh.make_mesh_2d(2, 4, device="cpu")
    assert tmesh.backend_for(torch.device("cuda")) == "nccl"
    assert tmesh.backend_for(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError):
        tmesh.make_mesh(8, device="meta")
