"""Parity of the PyTorch port's detection stack (FAST, Shi-Tomasi, grid
selection, ORB angles and descriptors, multi-level detection) with the JAX
package on the CPU, on rendered 240x320 frames handed to both as numpy
arrays.

Comparisons and integer packing are exact.  Where float32 sums are taken in
another order by XLA and PyTorch, the tolerance is stated at the test:
the Shi-Tomasi box sums come from a float32 integral image that reaches
~1e9, so scores of up to ~900 carry ~0.1 of summation rounding in BOTH
packages (measured against a float64 box sum: JAX 0.12, port 0.08); the
ORB moments cancel to ~1e-3 of their terms, so angles agree to 5.4e-4 rad
(the largest gap measured on these frames; 1.3e-4 on frame 0), and a rotated
pattern point that lands within that of a .5 boundary rounds to another
pixel and may flip a descriptor bit.  The angle bound is twice that gap; a
wrong `ic_angle` (axes swapped, patch one pixel off) is 30 to 1000 times
beyond it, which `test_angle_bound_catches_planted_faults` holds."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.models import frontend as jfe
from ygz_slam_tpu.ops import fast as jfast, interp as jinterp, orb as jorb, pyramid as jpyr

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import visual_odometry as tvo, vo_workload as vw
from ygz_slam_tpu_torch.ops import fast as tfast, interp as tinterp, orb as torb
from ygz_slam_tpu_torch.ops import pyramid as tpyr

from _torch_port import np32

torch.set_num_threads(1)

SHAPE = (240, 320)
OPTS = tvo.VOOptions(map_K=4, map_F=64, map_L=256, feat_budgets=(40, 16, 8))
TOL_SCORE = 0.5          # Shi-Tomasi, absolute, on scores up to ~900
TOL_ANGLE = 1e-3         # rad
MAX_BITS = 8             # differing descriptor bits ...
MIN_DESC_SHARE = 0.98    # ... on at least this share of keypoints
MIN_CORNER_SHARE = 0.95  # selected corners that coincide


@pytest.fixture(scope="module")
def frames():
    """Two rendered frames of the VO workload, as numpy arrays."""
    _, fr, _ = vw.make_vo_workload(2, device="cpu", shape=SHAPE, opts=OPTS)
    return fr.numpy()


def tt(a):
    return torch.from_numpy(np.array(a))


def both(img):
    return jnp.asarray(img), tt(img)


def score_f64(img):
    """Shi-Tomasi with float64 box sums (numpy), the yardstick for both."""
    x = img.astype(np.float64)
    H, W = x.shape

    def sh(dx, dy):
        return x[np.clip(np.arange(H) + dy, 0, H - 1)][:, np.clip(np.arange(W) + dx, 0, W - 1)]

    dx, dy = sh(1, 0) - sh(-1, 0), sh(0, 1) - sh(0, -1)

    def box(a):
        ii = np.pad(np.cumsum(np.cumsum(a, 0), 1), ((1, 0), (1, 0)))
        core = ii[8:, 8:] - ii[:-8, 8:] - ii[8:, :-8] + ii[:-8, :-8]
        out = np.zeros_like(a)
        out[4:4 + core.shape[0], 4:4 + core.shape[1]] = core
        return out / 128.0

    dxx, dyy, dxy = box(dx * dx), box(dy * dy), box(dx * dy)
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    return 0.5 * (tr - np.sqrt(np.maximum(tr * tr - 4 * det, 0)))


def corner_set(c):
    xy, mask = np32(c.xy), np32(c.mask)
    return {tuple(p) for p, m in zip(xy.tolist(), mask) if m}


def bit_diff(a, b):
    x = (np32(a).view(np.uint32) ^ np32(b).view(np.uint32)).reshape(-1)
    return np.array([bin(int(v)).count("1") for v in x]).reshape(-1, 8).sum(1)


class TestFast:
    @pytest.mark.parametrize("frame,arc", [(0, 10), (1, 10), (1, 9), (1, 12)])
    def test_fast_score_map_exact(self, frames, frame, arc):
        j, t = both(frames[frame])
        want = np.asarray(jfast.fast_score_map(j, 20.0, arc))
        got = np32(tfast.fast_score_map(t, 20.0, arc))
        assert want.sum() > 500
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("frame", [0, 1])
    def test_shi_tomasi(self, frames, frame):
        j, t = both(frames[frame])
        sj, st = np.asarray(jfast.shi_tomasi_map(j)), np32(tfast.shi_tomasi_map(t))
        s64 = score_f64(frames[frame])
        assert s64.max() > 500
        assert np.abs(st - sj).max() < TOL_SCORE
        assert np.abs(st - s64).max() < TOL_SCORE     # the port is no further from
        assert np.abs(sj - s64).max() < TOL_SCORE     # float64 than the reference is

    def test_shi_tomasi_full_size(self):
        """At 480x640 the integral image reaches ~4e9 and both packages'
        scores carry ~0.5 of summation rounding on scores up to ~900; the
        port stays as close to the float64 box sum as the JAX package."""
        _, fr, _ = vw.make_vo_workload(1, device="cpu")
        img = fr[0].numpy()
        j, t = both(img)
        sj, st = np.asarray(jfast.shi_tomasi_map(j)), np32(tfast.shi_tomasi_map(t))
        s64 = score_f64(img)
        e_j, e_t, e_jt = (np.abs(a - b).max() for a, b in ((sj, s64), (st, s64), (st, sj)))
        print(f"Shi-Tomasi 480x640, scores up to {s64.max():.1f}: |jax - f64| {e_j:.3f}, "
              f"|port - f64| {e_t:.3f}, |port - jax| {e_jt:.3f}")
        assert s64.max() > 500
        assert e_t < 4 * TOL_SCORE and e_j < 4 * TOL_SCORE and e_jt < 4 * TOL_SCORE
        # The scores' rounding reorders near-equal corners but picks the same set.
        want = corner_set(jfast.detect(j, 20.0, 16, 160))
        got = corner_set(tfast.detect(t, 20.0, 16, 160))
        print(f"detect 480x640: {len(want)} corners in JAX, {len(want & got)} of them in the port")
        assert len(want) >= 100 and len(want & got) >= MIN_CORNER_SHARE * len(want)

    @pytest.mark.parametrize("frame", [0, 1])
    def test_nonmax_exact_on_equal_scores(self, frames, frame):
        j, t = both(frames[frame])
        score = np.asarray(jfast.shi_tomasi_map(j))
        mask = np.asarray(jfast.fast_score_map(j, 20.0))
        want = np.asarray(jfast.nonmax_3x3(jnp.asarray(score), jnp.asarray(mask)))
        got = np32(tfast.nonmax_3x3(tt(score), tt(mask)))
        np.testing.assert_array_equal(got, want)

    def test_nonmax_plateau_and_border(self):
        score = np.zeros((12, 14), np.float32)
        score[3:5, 3:5] = 2.0                       # a plateau: all four are maxima
        score[0, 0], score[11, 13], score[7, 8], score[7, 9] = 5.0, 4.0, 1.0, 3.0
        mask = score > 0
        want = np.asarray(jfast.nonmax_3x3(jnp.asarray(score), jnp.asarray(mask)))
        got = np32(tfast.nonmax_3x3(tt(score), tt(mask)))
        np.testing.assert_array_equal(got, want)
        assert got[3:5, 3:5].all() and got[0, 0] and not got[7, 8]

    @pytest.mark.parametrize("budget", [40, 500])
    def test_grid_select_exact_on_equal_inputs(self, frames, budget):
        j, _ = both(frames[1])
        score = jfast.shi_tomasi_map(j)
        keep = jfast.nonmax_3x3(score, jfast.fast_score_map(j, 20.0))
        want = jfast.grid_select(score, keep, 16, budget)
        got = tfast.grid_select(tt(score),
                                tt(keep), 16, budget)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np32(a), np.asarray(b))

    def test_grid_select_ties(self):
        # Equal best scores in several cells and inside one cell: the first
        # pixel of a cell and the lowest cell index win.
        score = np.zeros((32, 48), np.float32)
        for y, x in [(2, 3), (2, 9), (5, 20), (18, 4), (18, 5), (30, 40)]:
            score[y, x] = 7.0
        mask = score > 0
        want = jfast.grid_select(jnp.asarray(score), jnp.asarray(mask), 16, 4)
        got = tfast.grid_select(tt(score), tt(mask), 16, 4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np32(a), np.asarray(b))

    @pytest.mark.parametrize("frame", [0, 1])
    def test_detect(self, frames, frame):
        j, t = both(frames[frame])
        want = corner_set(jfast.detect(j, 20.0, 16, 40))
        got = corner_set(tfast.detect(t, 20.0, 16, 40))
        assert len(want) >= 30
        assert len(want & got) >= MIN_CORNER_SHARE * len(want)


class TestOrb:
    def test_pattern_is_the_jax_pattern(self):
        np.testing.assert_array_equal(torb.PATTERN, np.asarray(jorb.PATTERN))

    def test_pack_bits_exact(self):
        bits = np.random.default_rng(0).random((50, 256)) > 0.5
        bits[0], bits[1] = True, False
        bits[2, 31::32] = True                      # every word's sign bit
        want = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
        got = np32(torb.pack_bits(tt(bits)))
        np.testing.assert_array_equal(got.view(np.uint32), want)

    @pytest.mark.parametrize("size", [31, 10])
    def test_extract_patches_exact(self, frames, size):
        rng = np.random.default_rng(1)
        H, W = SHAPE
        c = np.c_[rng.uniform(-5, W + 5, 60), rng.uniform(-5, H + 5, 60)].astype(np.float32)
        c[:10] = np.round(c[:10]) + 0.5             # ties: round half to even
        j, t = both(frames[0])
        want = np.asarray(jinterp.extract_patches(j, jnp.asarray(c), size))
        got = np32(tinterp.extract_patches(t, tt(c), size))
        np.testing.assert_array_equal(got, want)

    def test_blur(self, frames):
        j, t = both(frames[0])
        want = np.asarray(jorb.blur_for_descriptors(j))
        got = np32(torb.blur_for_descriptors(t))
        # 30 float32 multiply-adds per pixel on 0-255 values, in tap order in
        # both packages; XLA may contract them into FMAs.
        assert np.abs(got - want).max() < 1e-3
        for axis in (0, 1):
            assert np.abs(np32(tpyr._conv1d(t, axis)) - np.asarray(jpyr._conv1d(j, axis))).max() < 1e-4

    @pytest.mark.parametrize("frame", [0, 1])
    def test_angles_and_descriptors(self, frames, frame):
        j, t = both(frames[frame])
        c = jfast.detect(j, 20.0, 16, 40)
        xy, mask = np.asarray(c.xy), np.asarray(c.mask)
        a_j, d_j = jorb.compute(j, jnp.asarray(xy))
        a_t, d_t = torb.compute(t, tt(xy))
        assert d_t.dtype == torch.int32 and tuple(d_t.shape) == (40, 8)
        da = np.abs(np.angle(np.exp(1j * (np.asarray(a_j) - np32(a_t)))))
        assert da[mask].max() < TOL_ANGLE
        bits = bit_diff(d_t, np.asarray(d_j))[mask]
        assert (bits <= MAX_BITS).mean() >= MIN_DESC_SHARE
        # With the reference's angles, only the blur's rounding is left.
        d_same = torb.describe_patches(
            tinterp.extract_patches(torb.blur_for_descriptors(t), tt(xy), 31),
            tt(a_j))
        assert (bit_diff(d_same, np.asarray(d_j))[mask] <= 2).all()


    @pytest.mark.parametrize("fault", ["axes_swapped", "one_pixel_right", "one_pixel_down"])
    def test_angle_bound_catches_planted_faults(self, frames, fault):
        """TOL_ANGLE's other reading: an `ic_angle` fed transposed patches
        (m01 and m10 swapped) or patches cut one pixel off is far outside
        it, on every keypoint for the swap (>= 3e-2 rad measured) and on
        most for the offset (median ~0.16 rad)."""
        j, t = both(frames[1])
        c = jfast.detect(j, 20.0, 16, 40)
        xy, mask = np.asarray(c.xy), np.asarray(c.mask)
        a_j, _ = jorb.compute(j, jnp.asarray(xy))
        if fault == "axes_swapped":
            patches = tinterp.extract_patches(t, tt(xy), torb.PATCH).transpose(1, 2)
        else:
            off = {"one_pixel_right": [1.0, 0.0], "one_pixel_down": [0.0, 1.0]}[fault]
            patches = tinterp.extract_patches(t, tt(xy) + torch.tensor(off), torb.PATCH)
        da = np.abs(np.angle(np.exp(1j * (np.asarray(a_j) - np32(torb.ic_angle(patches))))))[mask]
        assert np.median(da) > 30 * TOL_ANGLE
        assert (da > TOL_ANGLE).mean() >= 0.8
        if fault == "axes_swapped":
            assert da.min() > 30 * TOL_ANGLE


class TestDetectMultilevel:
    @pytest.mark.parametrize("with_existing", [False, True])
    def test_detect_multilevel(self, frames, with_existing):
        j, t = both(frames[1])
        pyr_j, pyr_t = jfe.preprocess(j, 3), tfe.preprocess(t, 3)
        kw_j, kw_t = {}, {}
        if with_existing:
            rng = np.random.default_rng(2)
            ex = np.c_[rng.uniform(0, SHAPE[1], 30), rng.uniform(0, SHAPE[0], 30)].astype(np.float32)
            em = rng.random(30) > 0.2
            kw_j = dict(existing_px=jnp.asarray(ex), existing_mask=jnp.asarray(em))
            kw_t = dict(existing_px=tt(ex), existing_mask=tt(em))
        fj = jfe.detect_multilevel(pyr_j, 20.0, 16, OPTS.feat_budgets, **kw_j)
        ft = tfe.detect_multilevel(pyr_t, 20.0, 16, OPTS.feat_budgets, **kw_t)
        for a, b in zip(ft, fj):
            assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np32(ft.level), np.asarray(fj.level))
        vj, vt = np.asarray(fj.valid), np32(ft.valid)

        def keyed(f, valid):
            return {(float(x), float(y), int(l)): i for i, ((x, y), l, v) in enumerate(
                zip(np32(f.px).tolist(), np32(f.level), valid)) if v}

        kj, kt = keyed(fj, vj), keyed(ft, vt)
        common = sorted(set(kj) & set(kt))
        assert len(kj) >= 30
        assert len(common) >= MIN_CORNER_SHARE * len(kj)
        ij, it = [kj[k] for k in common], [kt[k] for k in common]
        da = np.abs(np.angle(np.exp(1j * (np.asarray(fj.angle)[ij] - np32(ft.angle)[it]))))
        assert da.max() < TOL_ANGLE
        bits = bit_diff(np32(ft.desc)[it], np.asarray(fj.desc)[ij])
        assert (bits <= MAX_BITS).mean() >= MIN_DESC_SHARE
        assert np.abs(np32(ft.score)[it] - np.asarray(fj.score)[ij]).max() < TOL_SCORE
        assert (np32(ft.depth) == -1.0).all()

    def test_features_from_numpy(self, frames):
        """The JAX package's Features cross to the port with the port's
        types, descriptors as int32 words with the same bits."""
        fj = jfe.detect_multilevel(jfe.preprocess(jnp.asarray(frames[0]), 3), 20.0, 16,
                                   OPTS.feat_budgets)
        ft = convert.features_from_numpy(*(np.asarray(a) for a in fj), device="cpu")
        assert isinstance(ft, tfe.Features)
        assert [a.dtype for a in ft] == [torch.float32, torch.int32, torch.float32, torch.float32,
                                         torch.int32, torch.float32, torch.bool]
        for a, b in zip(ft, fj):
            a, b = np32(a), np.asarray(b)
            np.testing.assert_array_equal(a.view(np.uint32) if b.dtype == np.uint32 else a, b)
