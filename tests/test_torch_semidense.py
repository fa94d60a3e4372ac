"""The SEMI_DENSE_DIRECT frontend and the SEMI_DENSE map type
(`models/semidense.py`, `VisualOdometry` with `vo_type=SEMI_DENSE_DIRECT`,
`map_type=SEMI_DENSE`), the port against the JAX package, both on the CPU,
at tests/test_vo.py's size (240x320, its camera and keyframe gates).

The gradient-pixel selection is held as a set, the seeds' initialisation
to float32 rounding, `update` to tests/test_torch_depth_filter.py's
tolerances (the seed update's tau and variance are float32 cancellations:
max(1e-4, 2 x the JAX package's own jit-against-eager spread), decisions
on >= 98% of the rows).  The VisualOdometry guard runs both classes over
18 frames (init at frame 10, a keyframe at 15) with the JAX defaults; the
port gets the JAX package's RANSAC draw.  Its camera centres agreed to
1.6e-4 map units on one CPU thread, so they are held to 1e-3, and the
exported clouds' sizes (648 points in both) to 2%."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.map import depth_filter as jdf
from ygz_slam_tpu.models import semidense as jsdm

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.map import depth_filter as df
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.models import semidense as sdm
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.solvers import initializer as tin
from ygz_slam_tpu_torch.system import trajectory as traj
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_camera, jax_mono_run, jax_ransac_indices, jax_vo_options, np32

torch.set_num_threads(1)

CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)    # tests/test_vo.py's
SHAPE = (240, 320)
N_FRAMES = 18              # init at 10, a keyframe at 15, two frames after it
DU = 1.0 / 39              # tests/test_vo.py's 40-frame sequence
TOL_SEQ = 1e-4             # seed update: floor of the tolerance on mu and sigma2, relative
SPREAD = 2.0               # ... else this many times the JAX jit-against-eager spread
MIN_AGREE = 0.98           # updated / converged decisions
TOL_TRAJ = 1e-3            # VO camera centres, map units (measured spread 1.6e-4)
CLOUD_AGREE = 0.02         # exported cloud sizes, relative
SD_OPTS = dict(vo_type=tvo.VOType.SEMI_DENSE_DIRECT, map_type=tvo.MapType.SEMI_DENSE,
               **mw.VO_OPTS)


def _rel(a, b) -> np.ndarray:
    a, b = np32(a).astype(np.float64), np32(b).astype(np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _render(seed: int, T: SE3 | None = None, shape=SHAPE):
    scene = PlaneScene(CAM, plane_z=3.0, seed=seed, device="cpu")
    return scene, scene.render(T or SE3.identity(device="cpu"), shape)


@pytest.mark.parametrize("seed,cell,budget,min_grad,shape", [
    (4, 8, 256, 5.0, SHAPE),          # tests/test_vo_types.py::test_gradient_selection
    (0, 8, 512, 8.0, SHAPE),          # the VOOptions defaults
    (2, 6, 300, 8.0, (61, 83)),       # cells that do not tile the image
])
def test_select_gradient_pixels(seed, cell, budget, min_grad, shape):
    """The same image through both packages: the same pixels selected (as
    sets), and tests/test_vo_types.py's gate (the selected pixels' gradient
    above the image's mean)."""
    _, img = _render(seed, shape=shape)
    px, valid = sdm.select_gradient_pixels(img, cell=cell, budget=budget, min_grad=min_grad)
    jpx, jvalid = jsdm.select_gradient_pixels(jnp.asarray(np32(img)), cell=cell, budget=budget,
                                              min_grad=min_grad)
    sel = {tuple(p) for p in np32(px)[np32(valid)]}
    jsel = {tuple(p) for p in np.asarray(jpx)[np.asarray(jvalid)]}
    print(f"seed {seed} {shape}: {len(sel)} pixels selected, JAX {len(jsel)}")
    assert sel == jsel and len(sel) > 0
    g = np.gradient(np32(img))
    mag = np.sqrt(g[0] ** 2 + g[1] ** 2)
    p = np32(px)[np32(valid)].astype(int)
    assert mag[p[:, 1], p[:, 0]].mean() > mag.mean()


def _jsd(sd: sdm.SemiDensePoints):
    return jsdm.SemiDensePoints(
        px=jnp.asarray(np32(sd.px)),
        seeds=jdf.Seeds(**{k: jnp.asarray(v) for k, v in convert.seeds_to_numpy(sd.seeds).items()}),
        kf_slot=jnp.asarray(sd.kf_slot, jnp.int32))


def _seeds_equal(seeds: df.Seeds, jseeds) -> float:
    """Asserts equal pixels and masks; returns the worst relative
    difference of the float fields (float32 rounding)."""
    worst = 0.0
    for name in df.Seeds._fields:
        a, b = np32(getattr(seeds, name)), np.asarray(getattr(jseeds, name))
        if a.dtype == np.bool_:
            assert np.array_equal(a, b), name
        else:
            worst = max(worst, float(_rel(a, b).max()))
    return worst


def test_semidense_points_init():
    """`SemiDensePoints.init` in both packages on the same image: the same
    pixels and masks, seeds to float32 rounding."""
    _, img = _render(4)
    sd = sdm.SemiDensePoints.init(img, 3, depth_mean=2.5, depth_min=0.2, budget=256)
    jsd = jsdm.SemiDensePoints.init(jnp.asarray(np32(img)), 3, depth_mean=2.5, depth_min=0.2,
                                    budget=256)
    assert np.array_equal(np32(sd.px), np.asarray(jsd.px)) and sd.kf_slot == int(jsd.kf_slot)
    assert _seeds_equal(sd.seeds, jsd.seeds) <= 2e-7


@pytest.mark.parametrize("depth_mean", [0.93, 2.7])
def test_sd_init_matches_jax(runs, depth_mean):
    """The VisualOdometry's gradient-pixel set of a keyframe (`sd_init`:
    unit-depth seeds rescaled by the map's mean depth) against the JAX
    VisualOdometry's `_jit_sd_init` on the same image and depth: equal to
    float32 rounding."""
    img = runs["frames"][12]
    sd = tvo.sd_init(tvo.VOOptions(**SD_OPTS), img, 1, depth_mean)
    jsd = runs["jv"]._jit_sd_init(jnp.asarray(np32(img)), 1,
                                  jnp.asarray(depth_mean, jnp.float32))
    assert np.array_equal(np32(sd.px), np.asarray(jsd.px))
    worst = _seeds_equal(sd.seeds, jsd.seeds)
    print(f"depth_mean {depth_mean}: worst relative difference {worst:.2e}")
    assert worst <= 2e-7


def _frame_pose(k: int) -> SE3:
    """tests/test_depth_filter.py's camera motion at frame k."""
    return tse3.exp(torch.tensor([0.05 * k, 0.01 * k, 0.0, 0.0, -0.005 * k, 0.0]))


def test_update_matches_jax():
    """Six frames of tests/test_depth_filter.py's motion through `update`
    from the same gradient-pixel set, each package feeding its own set
    forward: the seeds updated on each frame agree on >= 98% of the rows,
    mu and sigma2 within max(TOL_SEQ, SPREAD x the JAX package's own
    jit-against-eager spread) of the JAX jit run; then `export_points` on
    the result, its converged set agreeing on >= 98% of the rows and its
    points within the same tolerance where both export them."""
    scene, img_ref = _render(5)
    sd = sdm.SemiDensePoints.init(img_ref, 0, depth_mean=3.5, depth_min=0.8)
    jcam = jax_camera(CAM)
    jit = jax.jit(lambda s, ref, cur, R, t: jsdm.update(s, ref, cur, jcam, JSE3(R, t)))
    js = je = _jsd(sd)
    jref = jnp.asarray(np32(img_ref))
    v = np32(sd.seeds.valid)
    agree = []
    for k in range(1, 7):
        T = _frame_pose(k)
        cur = scene.render(T, SHAPE)
        args = (jref, jnp.asarray(np32(cur)), jnp.asarray(np32(T.R)), jnp.asarray(np32(T.t)))
        prev, jprev = sd, js
        sd = sdm.update(sd, img_ref, cur, CAM, T)
        js = jit(js, *args)
        je = jsdm.update(je, args[0], args[1], jcam, JSE3(args[2], args[3]))
        upd = np32(sd.seeds.sigma2 != prev.seeds.sigma2)
        jupd = np.asarray(js.seeds.sigma2) != np.asarray(jprev.seeds.sigma2)
        agree.append((upd == jupd)[v].mean())
    print(f"update: {v.sum()} valid gradient pixels, updated sets agree {min(agree):.4f}")
    assert min(agree) >= MIN_AGREE
    for name in ("mu", "sigma2"):
        port = _rel(getattr(sd.seeds, name), getattr(js.seeds, name))[v].max()
        own = _rel(getattr(je.seeds, name), getattr(js.seeds, name))[v].max()
        print(f"  {name}: port {port:.2e}, JAX eager {own:.2e}")
        assert port <= max(TOL_SEQ, SPREAD * own)
    # The usable set and the export at the keyframe's pose.
    assert (np32(sd.usable()) == np.asarray(js.usable()))[v].mean() >= MIN_AGREE
    T_kf = SE3.identity(device="cpu")
    pts, ok = sdm.export_points(sd, T_kf, CAM)
    jpts, jok = jsdm.export_points(js, JSE3.identity(), jcam)
    jpts_e, _ = jsdm.export_points(je, JSE3.identity(), jcam)
    ok, jok = np32(ok), np.asarray(jok)
    both = ok & jok
    print(f"export: {ok.sum()} converged, JAX {jok.sum()}")
    assert (ok == jok)[v].mean() >= MIN_AGREE and both.sum() > 0
    port = _rel(pts, jpts)[both].max()
    own = _rel(jpts_e, jpts)[both].max()
    assert port <= max(TOL_SEQ, SPREAD * own)


def test_alignment_point_set_matches_jax():
    """The union point set (features with a depth, then usable gradient
    pixels) equal in both packages, on a set with some seeds made
    certain."""
    _, img = _render(4)
    sd = sdm.SemiDensePoints.init(img, 0, depth_mean=3.0, depth_min=0.1)
    rng = np.random.default_rng(3)
    sharp = torch.from_numpy(rng.random(sd.px.shape[0]) < 0.4)
    sd = sd._replace(seeds=sd.seeds._replace(sigma2=torch.where(sharp, 1e-4, sd.seeds.sigma2)))
    F = 64
    fpx = torch.from_numpy(rng.uniform(8, 300, (F, 2)).astype(np.float32))
    fdepth = torch.from_numpy(rng.choice([-1.0, 2.0, 3.5], F).astype(np.float32))
    fvalid = torch.from_numpy(rng.random(F) < 0.8)
    out = sdm.alignment_point_set(sd, fpx, fdepth, fvalid)
    jout = jsdm.alignment_point_set(_jsd(sd), jnp.asarray(np32(fpx)), jnp.asarray(np32(fdepth)),
                                    jnp.asarray(np32(fvalid)))
    for a, b in zip(out, jout):
        assert np.array_equal(np32(a), np.asarray(b))
    assert 0 < np32(out[2])[F:].sum() < sd.px.shape[0]


@pytest.fixture(scope="module")
def runs():
    """Both VisualOdometry classes with SEMI_DENSE_DIRECT and the SEMI_DENSE
    map over the first N_FRAMES frames."""
    cam, frames, _ = mw.make_mono_workload(40, device="cpu", shape=SHAPE, du=DU)
    opts = tvo.VOOptions(**SD_OPTS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_hypotheses", lambda mask, n, gen: torch.tensor(
            jax_ransac_indices(mask, gen.initial_seed(), n), dtype=torch.long))
        vo = tvo.VisualOdometry(cam, opts, device="cpu")
        names = [vo.add_frame(frames[k], float(k)).status.name for k in range(N_FRAMES)]
    jnames, jT7, _, jv = jax_mono_run(cam, frames[:N_FRAMES], jax_vo_options(opts))
    return dict(cam=cam, frames=frames, names=names, vo=vo, jnames=jnames, jT7=jT7, jv=jv,
                T7=np.stack([p for _, p in vo.trajectory_poses(corrected=False)]))


def test_vo_matches_jax(runs):
    """Both VisualOdometry classes over the first N_FRAMES frames: the same
    status on every frame and keyframes, camera centres within TOL_TRAJ,
    a gradient-pixel set on the same keyframe slot, and exported clouds
    (landmarks, then converged seeds) larger than the landmarks and of
    sizes within CLOUD_AGREE."""
    vo, jv = runs["vo"], runs["jv"]
    err = float(np.abs(traj.camera_centers(runs["T7"])
                       - traj.camera_centers(runs["jT7"])).max())
    cloud, jcloud = vo.export_point_cloud(), jv.export_point_cloud()
    n_land = int(vo.server.state.pt_valid.sum())
    print(f"statuses {runs['names']}; centres {err:.2e} apart; cloud {cloud.shape[0]} points "
          f"(JAX {jcloud.shape[0]}), {n_land} landmarks; stats {dict(vo.stats)}")
    assert runs["names"] == runs["jnames"] and runs["names"][-1] == "GOOD"
    assert vo.stats["keyframes"] == jv.stats["keyframes"] >= 1
    assert err <= TOL_TRAJ
    assert vo.sd is not None and vo.sd.kf_slot == int(jv.sd.kf_slot) == vo.last_kf_slot
    assert cloud.shape[0] > n_land
    assert abs(cloud.shape[0] - jcloud.shape[0]) <= CLOUD_AGREE * jcloud.shape[0]
    assert (np32(vo.sd.usable()) == np.asarray(jv.sd.usable())).mean() >= MIN_AGREE


def test_reset_drops_the_set(runs):
    """`reset` drops the gradient-pixel set and the semi-dense cloud (the
    JAX `reset`); the next keyframe seeds a new one."""
    import copy

    vo = copy.deepcopy(runs["vo"])
    assert vo.sd is not None
    vo.reset()
    assert vo.sd is None and vo.semidense_cloud == []
    assert vo.export_point_cloud().shape == (0, 3)


def _run_40(opts):
    cam, frames, T_gt7 = mw.make_mono_workload(40, device="cpu", shape=SHAPE, du=DU)
    vo = tvo.VisualOdometry(cam, opts, device="cpu")
    st = [vo.add_frame(frames[k], float(k)).status for k in range(40)]
    return vo, st, np.stack([p for _, p in vo.trajectory_poses(corrected=False)]), np32(T_gt7)


@pytest.mark.slow
def test_tracks_sequence_and_builds_cloud():
    """tests/test_vo_types.py::TestSemiDense::test_tracks_sequence_and_builds_cloud
    on the port (sd_budget 256): more than half of the 40 frames GOOD,
    Sim(3)-aligned ATE < 0.05, a semi-dense cloud beyond the landmarks."""
    vo, st, T7, gt = _run_40(tvo.VOOptions(sd_budget=256, **SD_OPTS))
    good = [k for k, s in enumerate(st) if s is tvo.Status.GOOD]
    ate = traj.ate_rmse(traj.camera_centers(T7[good]), traj.camera_centers(gt[good]))
    cloud = vo.export_point_cloud()
    n_land = int(vo.server.state.pt_valid.sum())
    print(f"{len(good)} GOOD, ATE {ate:.4f}, cloud {cloud.shape[0]}, landmarks {n_land}")
    assert len(good) > 20 and ate < 0.05
    assert vo.sd is not None and cloud.shape[0] > n_land


@pytest.mark.slow
def test_semidense_depths_converge_to_truth():
    """tests/test_vo_types.py::TestSemiDense::test_semidense_depths_converge_to_truth
    on the port (SEMI_DENSE_DIRECT, the SPARSE map, sd_budget 256): the usable
    seeds' depths over the true depths at their keyframe have a relative
    spread < 0.15 (one global scale)."""
    opts = tvo.VOOptions(vo_type=tvo.VOType.SEMI_DENSE_DIRECT, sd_budget=256, **mw.VO_OPTS)
    vo, st, _, _ = _run_40(opts)
    usable = np32(vo.sd.usable())
    assert usable.sum() >= 20
    kf_id = int(vo.server.state.kf_id[vo.sd.kf_slot])
    T_kf = mw.trajectory(40, DU, "cpu")[kf_id]
    scene = PlaneScene(CAM, plane_z=3.0, seed=0, device="cpu")
    ratio = np32(vo.sd.depths())[usable] / np32(scene.depth(vo.sd.px, T_kf))[usable]
    spread = float(np.std(ratio) / np.mean(ratio))
    print(f"{usable.sum()} usable seeds at keyframe frame {kf_id}: spread {spread:.4f}")
    assert spread < 0.15
