"""The port's quartic solver, P3P and P3P-RANSAC against the JAX package's
(tests/test_pnp.py's cases), on the CPU and on identical inputs; RANSAC is
handed the JAX package's own `jax.random.categorical` draws."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.geometry import PinholeCamera as JCam
from ygz_slam_tpu.geometry import se3 as jse3
from ygz_slam_tpu.solvers import pnp as jpnp
from ygz_slam_tpu.solvers.quartic import quartic_roots as jroots

from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.solvers import pnp as tpnp
from ygz_slam_tpu_torch.solvers.quartic import quartic_roots, real_roots_mask

from _torch_port import np32

torch.set_num_threads(1)

JCAM = JCam.create(320.0, 320.0, 160.0, 120.0)
CAM = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
TOL_ROOT = 1e-3      # tests/test_pnp.py: relative to max(1, |root|)
TOL_PNP = 1e-4       # RANSAC's pose on the JAX draws
TOL_P3P = 1e-2       # tests/test_pnp.py's recovery bound
MIN_RECOVERED = 85   # of 100 noise-free triples (tests/test_pnp.py)


def _set_distance(got: np.ndarray, ref: np.ndarray) -> float:
    """Worst relative distance of each root in `got` to its nearest unused
    root in `ref` (tests/test_pnp.py's greedy matching)."""
    ref = list(ref.astype(np.complex128))
    worst = 0.0
    for g in got.astype(np.complex128):
        j = int(np.argmin(np.abs(np.asarray(ref) - g)))
        worst = max(worst, abs(ref[j] - g) / max(1.0, abs(ref[j])))
        ref.pop(j)
    return worst


def test_random_quartics_against_jax_and_numpy():
    """The 200 random quartics of test_pnp.py: the same roots as the JAX
    package's (as sets: a conjugate pair's order follows the sign of a zero
    imaginary part, which the two packages' complex arithmetic may round
    differently) and as numpy's companion-matrix roots."""
    rng = np.random.default_rng(0)
    cs = rng.normal(0, 2, (200, 5)).astype(np.float32)
    cs[:, 0] = np.where(np.abs(cs[:, 0]) < 0.1, 1.0, cs[:, 0])
    rt = np32(quartic_roots(*(torch.tensor(cs[:, i]) for i in range(5))))
    rj = np.asarray(jroots(*(cs[:, i] for i in range(5))))
    d_jax = max(_set_distance(rt[i], rj[i]) for i in range(200))
    d_np = max(_set_distance(rt[i], np.roots(cs[i].astype(np.float64))) for i in range(200))
    print(f"roots against JAX {d_jax:.2e}, against np.roots {d_np:.2e} (tol {TOL_ROOT}); "
          f"equal bit for bit in order: {float((rt == rj).mean()):.3f}")
    assert d_jax < TOL_ROOT and d_np < TOL_ROOT


def test_four_real_roots_in_jax_order():
    rng = np.random.default_rng(1)
    r = rng.normal(0, 2, (100, 4))
    cs = np.stack([np.poly(ri) for ri in r]).astype(np.float32)
    rt = quartic_roots(*(torch.tensor(cs[:, i]) for i in range(5)))
    rj = np.asarray(jroots(*(cs[:, i] for i in range(5))))
    assert bool(real_roots_mask(rt).all())
    got = np.sort(np32(rt).real, axis=1)
    rel = np.abs(got - np.sort(r, axis=1)).max(1) / np.maximum(1.0, np.abs(r).max(1))
    assert rel.max() < TOL_ROOT, rel.max()
    # Real roots come in the JAX package's order (a hypothesis index is a root's slot).
    assert np.abs(np32(rt).real - rj.real).max() / max(1.0, np.abs(rj).max()) < TOL_ROOT


def test_p3p_recovers_noise_free_poses_as_jax():
    """test_pnp.py's recovery rate, in both packages on the same triples."""
    rng = np.random.default_rng(0)
    n_ok = {"port": 0, "jax": 0}
    for _ in range(100):
        T = jse3.exp(jnp.asarray(rng.normal(0, 0.5, 6).astype(np.float32)))
        P = rng.uniform(-1.5, 1.5, (3, 3)).astype(np.float32)
        P[:, 2] += 4
        Pw = np.asarray(JSE3(T.R, T.t).inverse().apply(jnp.asarray(P)))
        f = P / np.linalg.norm(P, axis=1, keepdims=True)
        sols = {"port": [np32(x)[0] for x in tpnp.p3p(torch.tensor(Pw)[None],
                                                      torch.tensor(f)[None])],
                "jax": [np.asarray(x)[0] for x in jpnp.p3p(jnp.asarray(Pw)[None],
                                                          jnp.asarray(f)[None])]}
        for name, (R, t, ok) in sols.items():
            errs = [max(np.abs(R[i] - np.asarray(T.R)).max(), np.abs(t[i] - np.asarray(T.t)).max())
                    for i in range(4) if ok[i]]
            n_ok[name] += bool(errs) and min(errs) < TOL_P3P
    print(f"noise-free triples recovered within {TOL_P3P}, of 100: {n_ok} (>= {MIN_RECOVERED})")
    assert n_ok["port"] >= MIN_RECOVERED


def _outlier_scene():
    """test_pnp.py's RANSAC scene: 120 points, 60% gross outliers."""
    rng = np.random.default_rng(3)
    T = jse3.exp(jnp.asarray([0.5, -0.3, 0.2, 0.4, -0.5, 0.3], jnp.float32))
    N = 120
    Pc = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(2.5, 6, (N, 1))],
                        1).astype(np.float32)
    Pw = np.asarray(JSE3(T.R, T.t).inverse().apply(jnp.asarray(Pc)))
    px = np.array(JCAM.camera_to_pixel(jnp.asarray(Pc)))
    px += rng.normal(0, 0.5, px.shape)
    out = rng.random(N) < 0.6
    px[out] = rng.uniform([0, 0], [320, 240], (int(out.sum()), 2))
    mask = np.ones(N, bool)
    mask[::17] = False                       # a few rows the draw must avoid
    return T, Pw, px.astype(np.float32), mask, out


@pytest.mark.parametrize("key", [1, 2, 3])
def test_ransac_on_the_jax_draws_matches_jax(key):
    T, Pw, px, mask, out = _outlier_scene()
    jr = jpnp.ransac_pnp(jnp.asarray(Pw), jnp.asarray(px), jnp.asarray(mask), JCAM, key=key)
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    idx = np.asarray(jax.random.categorical(jax.random.PRNGKey(key),
                                            logits[None, :].repeat(256 * 3, 0)).reshape(256, 3))
    tr = tpnp.ransac_pnp_from_samples(torch.tensor(Pw), torch.tensor(px), torch.tensor(mask),
                                      CAM, torch.tensor(idx))
    dR = float(np.abs(np32(tr.T_cw.R) - np.asarray(jr.T_cw.R)).max())
    dt = float(np.abs(np32(tr.T_cw.t) - np.asarray(jr.T_cw.t)).max())
    print(f"key {key}: inliers port {int(tr.n_inliers)} JAX {int(jr.n_inliers)}; pose R within "
          f"{dR:.2e}, t within {dt:.2e} (tol {TOL_PNP})")
    assert bool(tr.ok) and bool(jr.ok)
    assert int(tr.n_inliers) == int(jr.n_inliers)
    assert np.array_equal(np32(tr.inlier), np.asarray(jr.inlier))
    assert dR < TOL_PNP and dt < TOL_PNP
    assert int(tr.n_inliers) > 0.7 * int((~out & mask).sum())
    assert float(np.abs(np32(tr.T_cw.R) - np.asarray(T.R)).max()) < 0.02


def test_ransac_with_a_generator_finds_the_pose():
    T, Pw, px, mask, out = _outlier_scene()
    gen = torch.Generator().manual_seed(4)
    r = tpnp.ransac_pnp(torch.tensor(Pw), torch.tensor(px), torch.tensor(mask), CAM,
                        generator=gen)
    assert bool(r.ok) and int(r.n_inliers) > 0.7 * int((~out & mask).sum())
    assert float(np.abs(np32(r.T_cw.R) - np.asarray(T.R)).max()) < 0.02
    assert float(np.abs(np32(r.T_cw.t) - np.asarray(T.t)).max()) < 0.06


def test_sample_triples_draws_valid_rows_only():
    mask = torch.zeros(2, 50, dtype=torch.bool)
    mask[0, [3, 7, 40]] = True                 # row 1 has no valid entry
    idx = tpnp.sample_triples(mask, 200, torch.Generator().manual_seed(0))
    assert idx.shape == (2, 200, 3) and idx.dtype == torch.int64
    assert set(idx[0].flatten().tolist()) == {3, 7, 40}
    assert len(set(idx[1].flatten().tolist())) > 40        # uniform over all rows


@pytest.mark.parametrize("case", ["empty", "coincident", "collinear"])
def test_degenerate_inputs(case):
    """Empty masks, coincident points and collinear points: no NaN, no
    crash, the JAX package's verdict, and no hypothesis without a valid
    row."""
    N = 30
    if case == "empty":
        Pw = torch.zeros((N, 3)) + torch.tensor([0.0, 0.0, 3.0])
        px, mask = torch.full((N, 2), 100.0), torch.zeros(N, dtype=torch.bool)
    elif case == "coincident":
        Pw = torch.zeros((N, 3)) + torch.tensor([0.0, 0.0, 3.0])
        px, mask = torch.full((N, 2), 100.0), torch.ones(N, dtype=torch.bool)
    else:
        s = torch.linspace(-1, 1, N)
        Pw = torch.stack([s, 0.5 * s, torch.full((N,), 3.0)], dim=1)
        px, mask = CAM.camera_to_pixel(Pw), torch.ones(N, dtype=torch.bool)
    r = tpnp.ransac_pnp(Pw, px, mask, CAM, generator=torch.Generator().manual_seed(0))
    jr = jpnp.ransac_pnp(jnp.asarray(np32(Pw)), jnp.asarray(np32(px)), jnp.asarray(np32(mask)),
                         JCAM, key=0)
    print(f"{case}: ok port {bool(r.ok)} JAX {bool(jr.ok)}, inliers {int(r.n_inliers)} / "
          f"{int(jr.n_inliers)}")
    assert bool(torch.isfinite(r.T_cw.t).all()) and bool(torch.isfinite(r.T_cw.R).all())
    assert bool(r.ok) == bool(jr.ok)
    if case == "empty":
        assert not bool(r.ok)
