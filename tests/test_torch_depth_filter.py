"""The depth filter (`map/depth_filter.py`, `ops/align.align1d`) on the CPU:
ports of tests/test_depth_filter.py on the port's PlaneScene and
`ops/fast`, and parity with the JAX package on the same seeded inputs at
240x320.

Two of the filter's float32 expressions are differences of nearly equal
numbers: tau (z_plus - z, with gamma = pi - alpha - beta a small angle
from two arccos near pi/2: an ulp of arccos moves tau by ~1e-4 relative)
and the new variance (C1 (s2 + m^2) + C2 (sigma2 + mu^2) - mu_new^2).
There the JAX package's jit run (XLA contracts multiply-adds) and its
eager run of the same function on the same inputs part by up to 3e-4
(tau, sigma2) and, over 8 frames of `update_seeds_from_frame`, 1.4e-3
(sigma2), and each is ~1.5e-4 from a float64 evaluation of tau.  So the
port is held to the JAX jit run within max(the stated tolerance, 2 x the
JAX package's own jit-against-eager spread on the same inputs), tau also
to a float64 evaluation no worse than 2 x the JAX run's error; mu, a and b
of `update_seed` to 1e-5 outright; the decisions (which seeds are matched
and updated) must agree on at least 98% of the rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.map import depth_filter as jdf
from ygz_slam_tpu.ops import align as jal

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.map import depth_filter as df
from ygz_slam_tpu_torch.ops import align, fast
from ygz_slam_tpu_torch.ops.interp import sample_patches
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import jax_camera, np32

torch.set_num_threads(1)

CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
SHAPE = (240, 320)
TOL_XY = 1e-4              # align1d positions, px
TOL_REL = 1e-5             # compute_tau and update_seed, relative
TOL_SEQ = 1e-4             # floor of the sequence tolerance on mu and sigma2, relative
SPREAD = 2.0               # ... else this many times the JAX jit-against-eager spread
MIN_AGREE = 0.98           # matched / updated masks


def _frame_pose(k: int) -> SE3:
    """tests/test_depth_filter.py's camera motion at frame k."""
    return tse3.exp(torch.tensor([0.05 * k, 0.01 * k, 0.0, 0.0, -0.005 * k, 0.0],
                                 dtype=torch.float32))


def _reference(seed: int, max_corners: int):
    scene = PlaneScene(CAM, plane_z=3.0, seed=seed, device="cpu")
    img_ref = scene.render(SE3.identity(device="cpu"), SHAPE)
    return scene, img_ref, fast.detect(img_ref, 20.0, cell=16, max_corners=max_corners)


def _jseeds(seeds: df.Seeds) -> jdf.Seeds:
    return jdf.Seeds(**{k: jnp.asarray(v) for k, v in convert.seeds_to_numpy(seeds).items()})


def _rel(a, b) -> np.ndarray:
    a, b = np32(a).astype(np.float64), np32(b).astype(np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _held(port, jit, eager, tol: float, mask=None) -> tuple[float, float]:
    """(port against the JAX jit run, the JAX eager run against it), worst
    relative differences over `mask`; asserts the first is within max(tol,
    SPREAD x the second)."""
    m = slice(None) if mask is None else mask
    port_err, own = _rel(port, jit)[m].max(), _rel(eager, jit)[m].max()
    assert port_err <= max(tol, SPREAD * own), (port_err, own)
    return float(port_err), float(own)


# -- tests/test_depth_filter.py on the port -----------------------------------

def test_seeds_converge_to_gt_depth():
    """Eight frames of sideways motion: more than 40 seeds converge
    (sigma < z_range / 30) and their depths' median error is under 3%."""
    scene, img_ref, c = _reference(2, 100)
    seeds = df.Seeds.init(c.xy, c.mask, depth_mean=3.5, depth_min=0.8)
    for k in range(1, 9):
        T = _frame_pose(k)
        seeds = df.update_seeds_from_frame(seeds, img_ref, scene.render(T, SHAPE), CAM, T)
    gt = scene.depth(c.xy, SE3.identity(device="cpu"))
    conv = np32(seeds.converged(ratio=30.0) & c.mask)
    rel = np.abs(np32(seeds.depth()) - np32(gt)) / np32(gt)
    print(f"{conv.sum()} of {int(c.mask.sum())} seeds converged, median depth error "
          f"{np.median(rel[conv]):.2e}")
    assert conv.sum() > 40
    assert np.median(rel[conv]) < 0.03


def test_variance_decreases():
    """One observation shrinks the variance of most seeds."""
    scene, img_ref, c = _reference(3, 64)
    seeds = df.Seeds.init(c.xy, c.mask, 3.5, 0.8)
    T = tse3.exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.0]))
    out = df.update_seeds_from_frame(seeds, img_ref, scene.render(T, SHAPE), CAM, T)
    m = np32(c.mask)
    shrunk = (np32(out.sigma2)[m] <= np32(seeds.sigma2)[m] + 1e-9).mean()
    print(f"sigma2 shrank on {shrunk:.3f} of the seeds")
    assert shrunk > 0.7


def test_no_observation_no_change():
    """Invalid seeds are never updated."""
    _, img_ref, c = _reference(4, 32)
    seeds = df.Seeds.init(c.xy, torch.zeros_like(c.mask), 3.5, 0.8)
    out = df.update_seeds_from_frame(seeds, img_ref, img_ref, CAM, SE3.identity(device="cpu"))
    np.testing.assert_array_equal(np32(out.mu), np32(seeds.mu))
    np.testing.assert_array_equal(np32(out.b), np32(seeds.b))


# -- parity with the JAX package -----------------------------------------------

def test_seeds_init_and_converters():
    """Seeds.init, depth and converged equal the JAX ones; the table crosses
    both ways through `convert` unchanged."""
    _, _, c = _reference(2, 100)
    seeds = df.Seeds.init(c.xy, c.mask, 1.0, 0.1)
    seeds = seeds._replace(sigma2=seeds.sigma2 * torch.linspace(1e-6, 1.0, seeds.mu.shape[0]))
    js = _jseeds(seeds)
    jinit = jdf.Seeds.init(jnp.asarray(np32(c.xy)), jnp.asarray(np32(c.mask)), 1.0, 0.1)
    for name, a in convert.seeds_to_numpy(df.Seeds.init(c.xy, c.mask, 1.0, 0.1)).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jinit, name)), err_msg=name)
    np.testing.assert_array_equal(np32(seeds.depth()), np.asarray(js.depth()))
    for ratio in (30.0, 100.0, 200.0):
        np.testing.assert_array_equal(np32(seeds.converged(ratio)), np.asarray(js.converged(ratio)))
    back = convert.seeds_from_numpy(convert.seeds_to_numpy(seeds), device="cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(back, seeds))


def test_align1d_matches_jax():
    """align1d against the JAX align1d on the same image, reference
    patches, inits and directions: seeds' patches in the reference image,
    inits 2 px off their true position in the frame along a random
    direction, some inits near or outside the border.  Positions within
    1e-4 px, the accepted mask equal."""
    rng = np.random.default_rng(0)
    scene, img_ref, c = _reference(2, 100)
    T = _frame_pose(2)
    cur = scene.render(T, SHAPE)
    px = c.xy[c.mask]
    true = scene.project_to(px, SE3.identity(device="cpu"), T)
    ang = rng.uniform(0, 2 * np.pi, px.shape[0])
    direction = torch.tensor(np.stack([np.cos(ang), np.sin(ang)], -1), dtype=torch.float32)
    xy0 = true + 2.0 * direction * torch.tensor(rng.choice([-1.0, 1.0], (px.shape[0], 1)),
                                                 dtype=torch.float32)
    xy0[:4] = torch.tensor([[3.0, 50.0], [317.0, 100.0], [150.0, 5.5], [-4.0, 60.0]])
    patches = sample_patches(img_ref, px, 10)
    res = align.align1d(cur, patches, xy0, direction, max_error=25.0)
    jres = jax.jit(lambda *a: jal.align1d(*a, max_error=25.0))(
        *(jnp.asarray(np32(t)) for t in (cur, patches, xy0, direction)))
    d = np.abs(np32(res.xy) - np.asarray(jres.xy)).max(axis=1)
    conv = np32(res.converged)
    print(f"align1d on {px.shape[0]} points: {conv.sum()} accepted; positions within "
          f"{d.max():.2e} px, error within {np.abs(np32(res.error) - np.asarray(jres.error)).max():.2e}")
    assert conv.sum() >= 0.7 * px.shape[0]
    np.testing.assert_array_equal(conv, np.asarray(jres.converged))
    assert d.max() <= TOL_XY
    # Accepted points land on the truth.
    assert np.median(np.linalg.norm(np32(res.xy - true), axis=1)[conv]) < 0.1


def _random_geometry(rng, n: int):
    """A frame-to-keyframe motion (translation 0.1-0.5, rotation up to
    0.05 rad), unit bearings inside a 320-px field of view and depths in
    [1, 5]."""
    xi = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.05, 0.05, 3)])
    xi[:3] *= rng.uniform(0.1, 0.5) / np.linalg.norm(xi[:3])
    T = tse3.exp(torch.tensor(xi, dtype=torch.float32))
    f = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.ones((n, 1))], 1)
    f = torch.tensor(f / np.linalg.norm(f, axis=1, keepdims=True), dtype=torch.float32)
    return T, f, torch.tensor(rng.uniform(1.0, 5.0, n), dtype=torch.float32)


def _tau64(T: SE3, f, z, pea: float) -> np.ndarray:
    """compute_tau's formula in float64 on the same (float32) inputs."""
    t, f, z = (np32(x).astype(np.float64) for x in (T.t, f, z))
    a = f * z[:, None] - t[None]
    tn, an = np.linalg.norm(t), np.linalg.norm(a, axis=-1)
    alpha = np.arccos(np.clip(f @ t / max(tn, 1e-9), -1, 1))
    beta = np.arccos(np.clip(-(a @ t) / np.maximum(tn * an, 1e-9), -1, 1))
    gamma = np.pi - alpha - (beta + pea)
    return np.abs(tn * np.sin(beta + pea) / np.maximum(np.sin(gamma), 1e-6) - z)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_tau_matches_jax(seed):
    """compute_tau on random motions, bearings and depths against the JAX
    one (within max(1e-5, 2 x its jit-against-eager spread)) and against
    float64 (no worse than 2 x the JAX run's error)."""
    rng = np.random.default_rng(seed)
    T, f, z = _random_geometry(rng, 128)
    pea = df.pixel_error_angle(CAM.fx)
    jcam = jax_camera(CAM)
    assert pea == float(jnp.arctan(1.0 / (2.0 * jcam.fx)) * 2.0)
    tau = df.compute_tau(T, f, z, pea)

    def jtau(R, t, f_, z_):
        return jdf.compute_tau(JSE3(R, t), f_, z_, pea)

    args = [jnp.asarray(np32(x)) for x in (T.R, T.t, f, z)]
    jit, eager = jax.jit(jtau)(*args), jtau(*args)
    port_err, own = _held(tau, jit, eager, TOL_REL)
    t64 = _tau64(T, f, z, pea)
    acc, jacc = _rel(tau, t64).max(), _rel(jit, t64).max()
    print(f"compute_tau, seed {seed}: |t| {float(torch.linalg.norm(T.t)):.3f}, tau "
          f"{float(tau.min()):.3e}-{float(tau.max()):.3e}; against the JAX jit run {port_err:.2e} "
          f"(JAX eager {own:.2e}); against float64: port {acc:.2e}, JAX {jacc:.2e}")
    assert acc <= SPREAD * jacc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_seed_matches_jax(seed):
    """update_seed on random seeds, observations and variances, a quarter
    of them unobserved and a tenth invalid: mu, a and b within 1e-5
    relative of the JAX one, sigma2 within max(1e-5, 2 x its jit-against-
    eager spread), and unobserved or invalid seeds unchanged."""
    rng = np.random.default_rng(seed)
    n = 128

    def u(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, n), dtype=torch.float32)

    mu = u(0.2, 1.0)
    seeds = df.Seeds(px=torch.zeros((n, 2)), a=u(1.0, 20.0), b=u(1.0, 20.0), mu=mu,
                     z_range=u(5.0, 10.0), sigma2=u(1e-4, 1.0) ** 2,
                     valid=torch.tensor(rng.random(n) > 0.1))
    x = mu + u(-0.2, 0.2)
    tau2 = u(1e-3, 0.2) ** 2
    ok = torch.tensor(rng.random(n) > 0.25)
    out = df.update_seed(seeds, x, tau2, ok)
    args = (_jseeds(seeds), *(jnp.asarray(np32(t)) for t in (x, tau2, ok)))
    jout, jeager = jax.jit(jdf.update_seed)(*args), jdf.update_seed(*args)
    worst = {"sigma2": _held(out.sigma2, jout.sigma2, jeager.sigma2, TOL_REL)}
    for name in ("mu", "a", "b"):
        worst[name] = _rel(getattr(out, name), getattr(jout, name)).max()
        assert worst[name] <= TOL_REL, (name, worst[name])
    keep = np32(~(ok & seeds.valid))
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_array_equal(np32(getattr(out, name))[keep],
                                      np32(getattr(seeds, name))[keep])
    print(f"update_seed, seed {seed}: worst relative differences {worst}")


@pytest.mark.parametrize("seed", [2, 5])
def test_update_seeds_from_frame_matches_jax(seed):
    """Eight frames of tests/test_depth_filter.py's motion from the same
    Seeds, each package feeding its own table forward: the seeds updated on
    each frame agree on >= 98% of the rows, and mu and sigma2 of the valid
    seeds stay within max(1e-4, 2 x the JAX package's own jit-against-eager
    spread) of the JAX jit run."""
    scene, img_ref, c = _reference(seed, 100)
    seeds = df.Seeds.init(c.xy, c.mask, 3.5, 0.8)
    jit = jax.jit(lambda s, ref, cur, R, t: jdf.update_seeds_from_frame(
        s, ref, cur, jax_camera(CAM), JSE3(R, t)))
    js = je = _jseeds(seeds)
    jref = jnp.asarray(np32(img_ref))
    v = np32(seeds.valid)
    agree = []
    for k in range(1, 9):
        T = _frame_pose(k)
        cur = scene.render(T, SHAPE)
        args = (jref, jnp.asarray(np32(cur)), jnp.asarray(np32(T.R)), jnp.asarray(np32(T.t)))
        prev, jprev = seeds, js
        seeds = df.update_seeds_from_frame(seeds, img_ref, cur, CAM, T)
        js = jit(js, *args)
        je = jdf.update_seeds_from_frame(je, args[0], args[1], jax_camera(CAM),
                                         JSE3(args[2], args[3]))
        upd = np32(seeds.sigma2 != prev.sigma2)
        jupd = np.asarray(js.sigma2) != np.asarray(jprev.sigma2)
        agree.append((upd == jupd)[v].mean())
    print(f"update_seeds_from_frame, scene seed {seed}, {v.sum()} valid seeds: updated sets "
          f"agree {min(agree):.4f} (worst frame)")
    assert min(agree) >= MIN_AGREE
    for name in ("mu", "sigma2"):
        port_err, own = _held(getattr(seeds, name), getattr(js, name), getattr(je, name),
                              TOL_SEQ, v)
        print(f"  {name} against the JAX jit run: port {port_err:.2e}, JAX eager {own:.2e}")


def test_update_seeds_from_frame_makes_no_host_constant(monkeypatch):
    """The update builds no tensor from host data (each would be a
    host-to-device copy per call on the card, which a CUDA-graph capture
    refuses): torch.tensor and torch.as_tensor are never called on a
    Python value."""
    scene, img_ref, c = _reference(2, 32)
    seeds = df.Seeds.init(c.xy, c.mask, 3.5, 0.8)
    T = _frame_pose(1)
    cur = scene.render(T, SHAPE)
    made = []
    real_tensor, real_as = torch.tensor, torch.as_tensor

    def tensor(data, *a, **kw):
        made.append(type(data).__name__)
        return real_tensor(data, *a, **kw)

    def as_tensor(data, *a, **kw):
        if not isinstance(data, torch.Tensor):
            made.append(type(data).__name__)
        return real_as(data, *a, **kw)

    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    df.update_seeds_from_frame(seeds, img_ref, cur, CAM, T)
    assert made == []
