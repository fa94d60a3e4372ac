"""`python -m ygz_slam_tpu_torch.run_synthetic_mono` against the JAX package's
examples/run_synthetic_mono.py, both on the CPU over the same 16 frames
(init at frame 4, keyframes after it; SyntheticDataset's motion spans the
sequence, so 16 frames move ~6 cm each).

The JAX side is the example itself: its `main` is loaded from its file and
run with its own arguments, its status lines read from its output and its
camera centres from the trajectory file it writes.  The port's `main`
returns its records.  The port gets the JAX package's RANSAC draw
(`jax.random.key(frame_id)` on the same mask), so both initialise from the
same hypotheses.  After that the JAX VisualOdometry on a CPU tracks with its
jnp per-level Gauss-Newton and the port with its kernels' plain versions,
so the runs are held at outcome level, as tests/test_torch_mono_vo.py holds
the System: equal statuses and window keyframes per frame, camera centres
within TOL_TRAJ map units, and both ATEs under test_vo's 0.05 m.  Measured
on one CPU thread: the init frame ~1e-6 apart, the frames to the fourth
keyframe (frame 12) at most 1.3e-4, frame 13 9.5e-3 (the depth filter's
seeds promoted at that keyframe; with `use_depth_filter=False` both runs
stay within 2.8e-4), then 3.1e-3 and 2.8e-3."""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ygz_slam_tpu_torch import run_synthetic_mono as rsm
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system import trajectory as traj

from _torch_port import jax_ransac_indices

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 16
TOL_TRAJ = 1e-2           # camera centres, map units (tests/test_torch_mono_vo.py)
ATE_MAX = 0.05            # m, tests/test_vo.py


def _status_lines(text: str) -> list[tuple[str, int, int]]:
    """(status, inliers, window keyframes) of each `t=... STATUS inliers=N
    kfs=K` line."""
    lines = (re.fullmatch(r"t=\s*\S+\s+(\w+)\s+inliers=\s*(\d+)\s+kfs=(\d+)", line)
             for line in text.splitlines())
    return [(m[1], int(m[2]), int(m[3])) for m in lines if m]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_j, out_p = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    spec = importlib.util.spec_from_file_location(
        "run_synthetic_mono_example", os.path.join(REPO, "examples", "run_synthetic_mono.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    text = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(text):
        mp.setattr(sys, "argv", ["run_synthetic_mono.py", "--frames", str(N_FRAMES),
                                 "--out", out_j])
        example.main()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        records = rsm.main(["--frames", str(N_FRAMES), "--device", "cpu", "--out", out_p])
    return dict(jax=_status_lines(text.getvalue()), jax_text=text.getvalue(), out_j=out_j,
                records=records, out_p=out_p)


def test_statuses_and_keyframes_match(runs):
    """Every frame's status and window keyframes as the example's; the run
    initialises and inserts keyframes past the two of the init."""
    got = [(r.status, r.keyframes) for r in runs["records"]]
    want = [(s, k) for s, _, k in runs["jax"]]
    print("port", got, "\nJAX ", want)
    assert len(got) == N_FRAMES and got == want
    assert "GOOD" in [s for s, _ in got] and max(k for _, k in got) > 2


def test_camera_centres_match(runs):
    """The trajectory files, frame by frame: the same stamps, camera centres
    within TOL_TRAJ."""
    stamps_j, poses_j = traj.load_tum(os.path.join(runs["out_j"], "trajectory_tum.txt"))
    stamps_p, poses_p = traj.load_tum(os.path.join(runs["out_p"], "trajectory_tum.txt"))
    assert len(stamps_p) == N_FRAMES and np.array_equal(stamps_j, stamps_p)
    d = np.linalg.norm(traj.camera_centers(poses_p) - traj.camera_centers(poses_j), axis=1)
    print(f"camera centres, port against JAX: max {d.max():.2e} (tolerance {TOL_TRAJ}), "
          f"per frame {np.round(d, 6).tolist()}")
    assert d.max() <= TOL_TRAJ


def test_records_and_outputs(runs):
    """The records carry the GOOD frames' centres and an ATE under
    test_vo's bound; the figures are written where matplotlib
    is installed, as the example writes them."""
    recs = runs["records"]
    good = [r for r in recs if r.status == "GOOD"]
    assert all((r.center is not None) == (r.status == "GOOD") for r in recs)
    assert all(r.center_gt.shape == (3,) and r.ms > 0 for r in recs)
    err = rsm.ate(recs)
    jax_mm = float(runs["jax_text"].split("ATE over")[1].split(":")[1].split("mm")[0])
    print(f"ATE over {len(good)} GOOD frames: port {err * 1000:.1f} mm, JAX {jax_mm} mm")
    assert err < ATE_MAX and jax_mm / 1000 < ATE_MAX
    try:
        import matplotlib  # noqa: F401
        names = ("trajectory_tum.txt", "trajectory.png", "map.png")
    except ImportError:
        names = ("trajectory_tum.txt",)
    for name in names:
        assert os.path.getsize(os.path.join(runs["out_p"], name)) > 0, name


def test_no_card_raises_unless_cpu_named(tmp_path, monkeypatch):
    """With no GPU the entry point raises unless --device names the CPU,
    from the command line too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rsm.main(["--frames", "2", "--out", str(tmp_path / "a")])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "ygz_slam_tpu_torch.run_synthetic_mono",
                           "--frames", "2", "--out", str(tmp_path / "b")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "RuntimeError" in proc.stderr
    assert not os.path.exists(tmp_path / "b" / "trajectory_tum.txt")
