"""The port's distributed programs across two processes on the CPU
(counterpart of tests/test_multiprocess.py and tests/_mp_worker.py).

Two child processes (this file run as a script: `python
tests/test_torch_multiprocess.py RANK FOLDER`) meet in a gloo process group
through a `dist.FileStore` in FOLDER (a fixed TCP port would collide
between test workers), each rank holding 4 of 8 landmark shards:

- `sharded_local_ba` on the 2-D (host, chip) mesh `make_mesh_2d(2, 4)`,
  whose host axis is the process boundary: the camera system is summed
  over each rank's 4 shards, then across the two processes;
- `sharded_batch_align` of 8 sequences on the 1-D mesh `make_mesh(8)`
  spanning both processes (sequences 0-3 on rank 0, 4-7 on rank 1).

The parent writes the inputs (tests/test_parallel.py's BA problem, made by
the JAX package; two frames of the port's batch workload) to FOLDER and
reads each rank's rows back.  It holds the BA rows to the JAX 2-D solve on
`make_mesh_2d(2, 4)` (8 virtual devices in one process) and to the port's
one-process 8-shard solve, at test_torch_sharded_ba.py's tolerances, and
the sequences' poses to the port's one-process run bit for bit.  The
children never load JAX (each asserts it), and each is killed if it has
not finished within CHILD_TIMEOUT seconds."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 300
L = 64
N_ITER = 12
TOL_POSE = 2e-5          # test_torch_sharded_ba.py's tolerances
TOL_POINT = 2e-4
TOL_CHI2_REL = 1e-4


def child(rank: int, folder: str) -> None:
    """One rank: both distributed programs, its rows written to FOLDER."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from ygz_slam_tpu_torch import convert
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.parallel import batch_tracking as bt
    from ygz_slam_tpu_torch.parallel import mesh as tm
    from ygz_slam_tpu_torch.parallel import sharded_ba as sba

    torch.set_num_threads(1)
    d = dict(np.load(os.path.join(folder, "inputs.npz")))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tm.init_process_group("cpu", rank=rank, world=2,
                          store=dist.FileStore(os.path.join(folder, "store"), 2))
    mesh2 = tm.make_mesh_2d(2, 4, device="cpu")
    assert (mesh2.rank, mesh2.local, mesh2.first) == (rank, 4, 4 * rank)
    sobs, L_pad = sba.partition_observations(d["kf"], d["pt"], d["px"], d["mask"], L, 8,
                                             device="cpu")
    pts = torch.cat([t["x"], torch.zeros(L_pad - L, 3)])
    P, X, C = sba.sharded_local_ba(mesh2, SE3.from_params7(t["p7"]), mesh2.local_rows(pts),
                                   sba.ShardedObs(*map(mesh2.local_rows, sobs)),
                                   convert.camera_from_numpy(*d["cam"]), t["fixed"],
                                   n_iter=N_ITER)
    mesh1 = tm.make_mesh(8, device="cpu")
    pyr = lambda key: tuple(mesh1.local_rows(t[f"{key}{lv}"]) for lv in range(3))
    T = bt.sharded_batch_align(mesh1, pyr("ref"), pyr("cur"), convert.camera_from_numpy(*d["bcam"]),
                               mesh1.local_rows(t["bpx"]), mesh1.local_rows(t["bdepth"]),
                               mesh1.local_rows(t["bmask"]), SE3.identity((4,), device="cpu"))
    dist.destroy_process_group()
    assert "jax" not in sys.modules, "a child loaded JAX"
    np.savez(os.path.join(folder, f"rank{rank}.npz"), p7=P.params7().numpy(), x=X.numpy(),
             chi2=C.numpy(), seq7=T.params7().numpy())
    print(f"[{rank}] MP-OK", flush=True)


def start_children(folder) -> list:
    """Both ranks, started on FOLDER's inputs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(folder)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=REPO) for r in range(2)]


def finish_children(procs, folder) -> list:
    """Waits for both ranks, each within CHILD_TIMEOUT (all are killed on
    expiry); returns their outputs after checking their exit codes."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"[{r}] MP-OK" in out, f"rank {r} rc={p.returncode}\n{out[-4000:]}"
    return [dict(np.load(os.path.join(folder, f"rank{r}.npz"))) for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, both children's rows, the JAX 2-D solve and the port's
    one-process results."""
    import jax.numpy as jnp
    import torch.distributed as dist
    import test_parallel
    from ygz_slam_tpu.parallel import make_mesh_2d as jmake_mesh_2d
    from ygz_slam_tpu.parallel import partition_observations as jpartition
    from ygz_slam_tpu.parallel import sharded_local_ba as jsharded_local_ba
    from ygz_slam_tpu_torch import convert
    from ygz_slam_tpu_torch.geometry.se3 import SE3
    from ygz_slam_tpu_torch.models import batch as bm
    from ygz_slam_tpu_torch.ops import pyramid
    from ygz_slam_tpu_torch.parallel import batch_tracking as bt
    from ygz_slam_tpu_torch.parallel import mesh as tm
    from test_torch_sharded_ba import port_sharded

    torch.set_num_threads(1)
    folder = tmp_path_factory.mktemp("mp")
    poses, pts, noisy_poses, noisy_pts, kf, pt, px, mask, fixed = test_parallel.make_problem()
    cam, bpx, bdepth, bmask, _, _, ref_pyrs, frames, _ = bm.make_batch_workload(8, 2,
                                                                               device="cpu")
    cur_pyrs = pyramid.build_pyramid(frames[1], 3)
    np32 = lambda a: np.asarray(a, np.float32)
    inputs = dict(p7=np32(noisy_poses.params7()), x=np32(noisy_pts), kf=kf, pt=pt, px=px,
                  mask=mask, fixed=np.asarray(fixed), cam=np32(test_parallel.CAM),
                  bcam=np32(cam), bpx=bpx.numpy(), bdepth=bdepth.numpy(), bmask=bmask.numpy(),
                  **{f"ref{lv}": ref_pyrs[lv].numpy() for lv in range(3)},
                  **{f"cur{lv}": cur_pyrs[lv].numpy() for lv in range(3)})
    np.savez(folder / "inputs.npz", **inputs)
    procs = start_children(folder)
    try:
        # While they run: the JAX 2-D solve, one process of 8 virtual devices ...
        sobs, L_pad = jpartition(kf, pt, px, mask, L, 8)
        jp, jx, jc = jsharded_local_ba(jmake_mesh_2d(2, 4), noisy_poses,
                                       jnp.concatenate([noisy_pts, jnp.zeros((L_pad - L, 3))]),
                                       sobs, test_parallel.CAM, fixed, n_iter=N_ITER)
        # ... and the port in one process: a rank holding all 8 shards.
        pp, px_, pc = port_sharded(dict(inputs, cam=convert.camera_from_numpy(*inputs["cam"])),
                                   8)
        seq = bt.sharded_batch_align(tm.make_mesh(8, device="cpu"), ref_pyrs, cur_pyrs, cam,
                                     bpx, bdepth, bmask, SE3.identity((8,), device="cpu"))
        if dist.is_initialized():
            dist.destroy_process_group()
    finally:
        ranks = finish_children(procs, folder)
    return dict(ranks=ranks, L_pad=L_pad,
                jax=dict(p7=np32(jp.params7()), x=np32(jx), chi2=float(jc)),
                one=dict(p7=pp.params7().numpy(), x=px_.numpy(), chi2=float(pc),
                         seq7=seq.params7().numpy()))


def test_sharded_ba_two_processes(runs):
    """Each rank's poses (replicated) and its landmark rows against the JAX
    2-D solve and the port's one-process solve."""
    per = runs["L_pad"] // 2
    for r, out in enumerate(runs["ranks"]):
        rows = slice(r * per, (r + 1) * per)
        for ref_name in ("jax", "one"):
            ref = runs[ref_name]
            dp = np.abs(out["p7"] - ref["p7"]).max()
            dx = np.abs(out["x"] - ref["x"][rows]).max()
            dc = abs(float(out["chi2"]) - ref["chi2"]) / ref["chi2"]
            print(f"measured: rank {r} against {ref_name}: params7 {dp:.2e}, points {dx:.2e}, "
                  f"chi2 {dc:.1e} relative")
            assert dp <= TOL_POSE and dx <= TOL_POINT and dc <= TOL_CHI2_REL
    np.testing.assert_array_equal(runs["ranks"][0]["p7"], runs["ranks"][1]["p7"])


def test_sharded_batch_align_two_processes(runs):
    """Sequences 0-3 from rank 0 and 4-7 from rank 1 equal the one-process
    run bit for bit."""
    got = np.concatenate([out["seq7"] for out in runs["ranks"]])
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, runs["one"]["seq7"])


if __name__ == "__main__":
    child(int(sys.argv[1]), sys.argv[2])
