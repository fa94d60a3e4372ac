"""Parity of the PyTorch port's map layer with the JAX package on the CPU:
MapState and its functions, the local-mapping steps, the warp helpers and
two-view triangulation.  Both packages start from the same numpy arrays
(`convert.map_state_from_numpy`).  Integer and boolean fields must be equal;
float fields agree to float32 rounding (stated per test)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.geometry import SE3 as JSE3
from ygz_slam_tpu.geometry import se3 as jse3
from ygz_slam_tpu.geometry import triangulation as jtri
from ygz_slam_tpu.map import memory as jmem
from ygz_slam_tpu.map import state as jms
from ygz_slam_tpu.models import local_mapping as jlm
from ygz_slam_tpu.ops import warp as jwarp

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry import se3 as tse3
from ygz_slam_tpu_torch.geometry import triangulation as ttri
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera as TCam
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.map import memory as tmem
from ygz_slam_tpu_torch.map import state as tms
from ygz_slam_tpu_torch.models import local_mapping as tlm
from ygz_slam_tpu_torch.models import visual_odometry as tvo
from ygz_slam_tpu_torch.ops import warp as twarp

from _torch_port import jax_camera, np32

torch.set_num_threads(1)

CAM = TCam.create(320.0, 320.0, 160.0, 120.0)
JCAM = jax_camera(CAM)
TOL = 2e-5              # float32 elementwise geometry, a few ulp at these magnitudes
INT_FIELDS = ("kf_valid", "kf_id", "feat_level", "feat_desc", "feat_point", "feat_valid",
              "pt_valid", "pt_desc", "pt_visible", "pt_found", "pt_first_kf", "pt_ref_feat",
              "pt_obs", "cov_weight")


def tt(a):
    return torch.from_numpy(np.array(a))


def to_port(jm) -> tms.MapState:
    return convert.map_state_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()},
                                        device="cpu")


def assert_maps_equal(tm, jm, tol=TOL):
    got = convert.map_state_to_numpy(tm)
    for name, want in jm._asdict().items():
        want = np.asarray(want)
        assert got[name].shape == want.shape, name
        if name in INT_FIELDS:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, atol=tol, rtol=0, err_msg=name)


def pose7(rng, scale=0.1):
    xi = (rng.normal(0, scale, 6) * [1, 1, 1, 0.3, 0.3, 0.3]).astype(np.float32)
    return np.array(jse3.exp(jnp.asarray(xi)).params7())


def random_map(seed, K=4, F=16, L=50):
    """A JAX MapState with random but self-consistent content."""
    rng = np.random.default_rng(seed)
    m = jms.empty_map(K, F, L)
    fp = rng.integers(-1, L, (K, F)).astype(np.int32)
    fp[rng.random((K, F)) < 0.3] = -1
    pos = np.c_[rng.uniform(-1, 1, L), rng.uniform(-0.8, 0.8, L), rng.uniform(2, 4, L)]
    vis = rng.integers(0, 9, L)
    return m._replace(
        kf_pose7=jnp.asarray(np.stack([pose7(rng) for _ in range(K)])),
        kf_valid=jnp.asarray(rng.random(K) > 0.25),
        kf_id=jnp.asarray(rng.integers(0, 100, K).astype(np.int32)),
        feat_px=jnp.asarray(np.c_[rng.uniform(10, 310, K * F),
                                  rng.uniform(10, 230, K * F)].reshape(K, F, 2).astype(np.float32)),
        feat_level=jnp.asarray(rng.integers(0, 3, (K, F)).astype(np.int32)),
        feat_angle=jnp.asarray(rng.uniform(-3, 3, (K, F)).astype(np.float32)),
        feat_desc=jnp.asarray(rng.integers(0, 2 ** 32, (K, F, 8), dtype=np.uint32)),
        feat_depth=jnp.asarray(rng.uniform(1, 4, (K, F)).astype(np.float32)),
        feat_point=jnp.asarray(fp),
        feat_valid=jnp.asarray(rng.random((K, F)) > 0.2),
        pt_pos=jnp.asarray(pos.astype(np.float32)),
        pt_valid=jnp.asarray(rng.random(L) > 0.3),
        pt_desc=jnp.asarray(rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint32)),
        pt_visible=jnp.asarray(vis.astype(np.int32)),
        pt_found=jnp.asarray(rng.integers(0, vis + 1).astype(np.int32)),
        pt_first_kf=jnp.asarray(rng.integers(0, K, L).astype(np.int32)),
        pt_ref_feat=jnp.asarray(rng.integers(-1, K * F, L).astype(np.int32)),
        pt_obs=jnp.asarray(rng.integers(0, 5, L).astype(np.int32)),
    )


class TestMapState:
    def test_empty_map_and_roundtrip(self):
        jm = jms.empty_map(3, 8, 20)
        assert_maps_equal(tms.empty_map(3, 8, 20, device="cpu"), jm, tol=0)
        jm = random_map(0)
        assert_maps_equal(to_port(jm), jm, tol=0)
        tm = to_port(jm)
        assert (tm.K, tm.F, tm.L) == (4, 16, 50) and tm.feat_desc.dtype == torch.int32

    def test_empty_map_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tms.empty_map(2, 4, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.map_state_from_numpy(
                {k: np.asarray(v) for k, v in jms.empty_map(2, 4, 8)._asdict().items()})

    @pytest.mark.parametrize("slot", [0, 2, "tensor"])
    def test_insert_keyframe(self, slot):
        rng = np.random.default_rng(1)
        jm = random_map(1)
        F = 16
        f = dict(px=rng.uniform(0, 300, (F, 2)).astype(np.float32),
                 level=rng.integers(0, 3, F).astype(np.int32),
                 angle=rng.uniform(-3, 3, F).astype(np.float32),
                 desc=rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32),
                 depth=rng.uniform(1, 4, F).astype(np.float32),
                 point=rng.integers(-1, 50, F).astype(np.int32), valid=rng.random(F) > 0.3)
        p7 = pose7(rng)
        js, ts = (3, torch.tensor(3)) if slot == "tensor" else (slot, slot)
        want = jms.insert_keyframe(jm, js, 77, JSE3.from_params7(jnp.asarray(p7)),
                                   *(jnp.asarray(v) for v in f.values()))
        got = tms.insert_keyframe(to_port(jm), ts, 77, TSE3.from_params7(tt(p7)),
                                  tt(f["px"]), tt(f["level"]), tt(f["angle"]),
                                  tt(f["desc"].view(np.int32)), tt(f["depth"]), tt(f["point"]),
                                  tt(f["valid"]))
        assert_maps_equal(got, want)

    @pytest.mark.parametrize("with_ref", [True, False])
    def test_add_landmarks(self, with_ref):
        rng = np.random.default_rng(2)
        jm = random_map(2)
        n = 12
        slots = rng.permutation(50)[:n].astype(np.int32)
        slots[-3:] = 49                               # padded rows, masked out
        wm = rng.random(n) > 0.3
        wm[-3:] = False
        pos = rng.normal(0, 1, (n, 3)).astype(np.float32)
        desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        ref = rng.integers(0, 64, n).astype(np.int32) if with_ref else None
        want = jms.add_landmarks(jm, jnp.asarray(slots), jnp.asarray(wm), jnp.asarray(pos),
                                 jnp.asarray(desc), 2,
                                 ref_feat=None if ref is None else jnp.asarray(ref))
        tm0 = to_port(jm)
        got = tms.add_landmarks(tm0, tt(slots), tt(wm), tt(pos), tt(desc.view(np.int32)), 2,
                                ref_feat=None if ref is None else tt(ref))
        assert_maps_equal(got, want, tol=0)
        assert_maps_equal(tm0, jm, tol=0)             # the argument is left untouched

    @pytest.mark.parametrize("seed", [3, 4])
    def test_covisibility_and_observations(self, seed):
        jm = random_map(seed)
        want = jms.update_covisibility(jm)
        got = tms.update_covisibility(to_port(jm))
        assert int(np.asarray(want.cov_weight).max()) > 0
        assert_maps_equal(got, want, tol=0)
        for a, b in zip(tms.observations_from_features(got), jms.observations_from_features(want)):
            np.testing.assert_array_equal(np32(a), np.asarray(b))
        for slot in (0, torch.tensor(1)):
            idx_j, ok_j = jms.best_covisible(want, int(slot), 3)
            idx_t, ok_t = tms.best_covisible(got, slot, 3)
            np.testing.assert_array_equal(np32(idx_t), np.asarray(idx_j))
            np.testing.assert_array_equal(np32(ok_t), np.asarray(ok_j))

    def test_found_ratio_and_kf_pose(self):
        jm = random_map(5)
        tm = to_port(jm)
        np.testing.assert_allclose(np32(tm.found_ratio()), np.asarray(jm.found_ratio()), atol=1e-7)
        np.testing.assert_allclose(np32(tm.kf_pose(2).R), np.asarray(jm.kf_pose(2).R), atol=TOL)
        np.testing.assert_allclose(np32(tm.kf_pose().t), np.asarray(jm.kf_pose().t), atol=TOL)

    @pytest.mark.parametrize("n_valid,want", [(0, 8), (45, 8), (48, 8), (50, 8)])
    def test_free_rows(self, n_valid, want):
        rng = np.random.default_rng(6)
        valid = np.zeros(50, bool)
        valid[rng.permutation(50)[:n_valid]] = True
        L = 50
        free = ~valid
        key = jnp.where(jnp.asarray(free), L - jnp.arange(L, dtype=jnp.int32), 0)
        import jax
        _, rows_j = jax.lax.top_k(key, want)
        n_j = min(int(free.sum()), want)
        rows_j = np.where(np.arange(want) < n_j, np.asarray(rows_j), L - 1)
        rows_t, n_t = tvo.free_rows(tt(valid), want)
        assert int(n_t) == n_j and rows_t.dtype == torch.int32
        np.testing.assert_array_equal(np32(rows_t), rows_j)
        np.testing.assert_array_equal(rows_j[:n_j], np.flatnonzero(free)[:n_j])


def base_maps(K=4, F=16, L=50):
    jm = jms.empty_map(K, F, L)
    return jm._replace(kf_valid=jm.kf_valid.at[0].set(True))


def sin_fixture(name):
    """The five fixtures of tests/test_local_mapping.py, as a JAX MapState."""
    seeds = dict(links=0, no_relink=1, one_link=2, far_or_dissimilar=3, behind=4)
    rng = np.random.default_rng(seeds[name])
    d = jnp.asarray(rng.integers(0, 2 ** 32, (2 if name == "far_or_dissimilar" else 1, 8),
                                 dtype=np.uint32))
    z = -3.0 if name == "behind" else 3.0
    m = jms.add_landmarks(base_maps(), jnp.array([0]), jnp.array([True]),
                          jnp.array([[0.0, 0.0, z]]), d[:1], 0)
    c = jnp.array([160.0, 120.0])
    if name in ("links", "behind"):
        return m._replace(feat_px=m.feat_px.at[0, 0].set(c),
                          feat_desc=m.feat_desc.at[0, 0].set(d[0]),
                          feat_valid=m.feat_valid.at[0, 0].set(True))
    px = {"no_relink": (c, c), "one_link": (jnp.array([159.0, 120.0]), jnp.array([161.0, 120.0])),
          "far_or_dissimilar": (jnp.array([40.0, 40.0]), c)}[name]
    d1 = d[1] if name == "far_or_dissimilar" else d[0]
    m = m._replace(feat_px=m.feat_px.at[0, 0].set(px[0]).at[0, 1].set(px[1]),
                   feat_desc=m.feat_desc.at[0, 0].set(d[0]).at[0, 1].set(d1),
                   feat_valid=m.feat_valid.at[0, 0].set(True).at[0, 1].set(True))
    if name == "no_relink":
        m = m._replace(feat_point=m.feat_point.at[0, 0].set(0))
    return m


class TestLocalMapping:
    @pytest.mark.parametrize("name,want_links", [
        ("links", [0, -1]), ("no_relink", [0, -1]), ("one_link", None),
        ("far_or_dissimilar", [-1, -1]), ("behind", [-1, -1])])
    def test_search_in_neighbors_fixture(self, name, want_links):
        jm = sin_fixture(name)
        want = jlm.search_in_neighbors(jm, JCAM, 0)
        got = tlm.search_in_neighbors(to_port(jm), CAM, 0)
        assert_maps_equal(got, want)
        links = got.feat_point[0, :2].tolist()
        if want_links is None:
            assert links.count(0) <= 1
        else:
            assert links == want_links

    @pytest.mark.parametrize("slot", [0, "tensor"])
    def test_search_in_neighbors_dense(self, slot):
        # A keyframe looking at 40 landmarks whose descriptors it carries
        # (some noisy, some duplicated so distances tie), half already linked.
        rng = np.random.default_rng(7)
        jm = random_map(7, K=3, F=32, L=60)
        T = jm.kf_pose(1)
        proj = np.asarray(JCAM.world_to_pixel(jm.pt_pos, T))
        rows = rng.permutation(60)[:32]
        desc = np.asarray(jm.pt_desc)[rows].copy()
        desc[5:10, 0] ^= np.uint32(0xFF)            # 8 bits off
        desc[10:12] = desc[12:14]                   # duplicates: ties
        fp = np.full(32, -1, np.int32)
        fp[20:] = rows[20:]
        jm = jm._replace(
            kf_valid=jm.kf_valid.at[1].set(True), pt_valid=jnp.ones(60, bool),
            feat_px=jm.feat_px.at[1].set(jnp.asarray(proj[rows] + rng.normal(0, 1.5, (32, 2))
                                                     .astype(np.float32))),
            feat_desc=jm.feat_desc.at[1].set(jnp.asarray(desc)),
            feat_point=jm.feat_point.at[1].set(jnp.asarray(fp)),
            feat_valid=jm.feat_valid.at[1].set(True))
        want = jlm.search_in_neighbors(jm, JCAM, 1)
        got = tlm.search_in_neighbors(to_port(jm), CAM, torch.tensor(1) if slot == "tensor" else 1)
        assert int((np.asarray(want.feat_point[1]) != fp).sum()) >= 5
        assert_maps_equal(got, want)

    @pytest.mark.parametrize("with_angles", [True, False])
    def test_match_new_features_for_triangulation(self, with_angles):
        rng = np.random.default_rng(8)
        n = 48
        pts = np.c_[rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n), rng.uniform(2, 5, n)]
        pts = pts.astype(np.float32)
        T_ref7, T_new7 = pose7(rng, 0.02), pose7(rng, 0.02)
        T_new7[4:] += np.float32([0.25, 0.02, 0.0])   # a baseline that gives parallax
        px_ref = np.asarray(JCAM.world_to_pixel(jnp.asarray(pts), JSE3.from_params7(jnp.asarray(T_ref7))))
        px_new = np.asarray(JCAM.world_to_pixel(jnp.asarray(pts), JSE3.from_params7(jnp.asarray(T_new7))))
        px_new = (px_new + rng.normal(0, 0.3, px_new.shape)).astype(np.float32)
        px_new[:6] += 25.0                            # off the epipolar line
        desc_ref = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        perm = rng.permutation(n)
        desc_new = desc_ref[perm].copy()
        desc_new[:, 1] ^= rng.integers(0, 2 ** 10, n).astype(np.uint32)
        px_new = px_new[perm]
        valid_new, valid_ref = rng.random(n) > 0.1, rng.random(n) > 0.1
        ang_ref = rng.uniform(-3, 3, n).astype(np.float32)
        ang_new = (ang_ref[perm] + 0.2 + rng.normal(0, 0.01, n)).astype(np.float32)
        ang_new[:5] += 2.0
        kw_j = dict(angle_new=jnp.asarray(ang_new), angle_ref=jnp.asarray(ang_ref)) if with_angles else {}
        kw_t = dict(angle_new=tt(ang_new), angle_ref=tt(ang_ref)) if with_angles else {}
        pos_j, good_j, idx_j = jlm.match_new_features_for_triangulation(
            JCAM, jnp.asarray(desc_new), jnp.asarray(px_new), jnp.asarray(valid_new),
            JSE3.from_params7(jnp.asarray(T_new7)), jnp.asarray(desc_ref), jnp.asarray(px_ref),
            jnp.asarray(valid_ref), JSE3.from_params7(jnp.asarray(T_ref7)), **kw_j)
        pos_t, good_t, idx_t = tlm.match_new_features_for_triangulation(
            CAM, tt(desc_new.view(np.int32)), tt(px_new), tt(valid_new), TSE3.from_params7(tt(T_new7)),
            tt(desc_ref.view(np.int32)), tt(px_ref), tt(valid_ref), TSE3.from_params7(tt(T_ref7)),
            **kw_t)
        good = np.asarray(good_j)
        assert 10 <= good.sum() < n
        np.testing.assert_array_equal(np32(idx_t), np.asarray(idx_j))
        np.testing.assert_array_equal(np32(good_t), good)
        # positions: a 2x2 solve at ~1 deg of parallax amplifies float32
        # rounding of the bearings ~100x
        np.testing.assert_allclose(np32(pos_t)[good], np.asarray(pos_j)[good], atol=1e-3)
        np.testing.assert_allclose(np32(pos_t)[good], pts[perm][good], atol=0.3)

    @pytest.mark.parametrize("seed", [9, 10])
    def test_culling(self, seed):
        jm = random_map(seed)
        assert_maps_equal(tlm.map_point_culling(to_port(jm)), jlm.map_point_culling(jm), tol=0)
        jm = jms.update_covisibility(jm)
        np.testing.assert_allclose(np32(tlm.keyframe_culling_scores(to_port(jm))),
                                   np.asarray(jlm.keyframe_culling_scores(jm)), atol=1e-7)


class TestWarpAndTriangulation:
    def _setup(self, seed, n=64):
        rng = np.random.default_rng(seed)
        px = np.c_[rng.uniform(20, 300, n), rng.uniform(20, 220, n)].astype(np.float32)
        depth = rng.uniform(0.8, 6.0, n).astype(np.float32)
        level = rng.integers(0, 3, n).astype(np.int32)
        xi = (rng.normal(0, 0.15, (n, 6)) * [1, 1, 2, 0.3, 0.3, 0.5]).astype(np.float32)
        return px, depth, level, xi

    @pytest.mark.parametrize("seed", [11, 12])
    def test_warp_affine_matrix_and_level(self, seed):
        px, depth, level, xi = self._setup(seed)
        Tj = jse3.exp(jnp.asarray(xi))
        Tt = tse3.exp(tt(xi))
        A_j = jwarp.warp_affine_matrix(JCAM, jnp.asarray(px), jnp.asarray(depth),
                                       jnp.asarray(level), Tj)
        A_t = twarp.warp_affine_matrix(CAM, tt(px), tt(depth), tt(level), Tt)
        # differences of projected pixels (~300) divided by 4: ~1e-5 relative
        np.testing.assert_allclose(np32(A_t), np.asarray(A_j), atol=2e-4)
        A = np.asarray(A_j) * np.linspace(0.3, 6.0, 64, dtype=np.float32)[:, None, None]
        lv_j = np.asarray(jwarp.best_search_level(jnp.asarray(A), 2))
        lv_t = twarp.best_search_level(tt(A), 2)
        assert lv_t.dtype == torch.int32 and set(lv_j.tolist()) == {0, 1, 2}
        np.testing.assert_array_equal(np32(lv_t), lv_j)
        np.testing.assert_allclose(np32(twarp.inv2(tt(A))), np.linalg.inv(A.astype(np.float64)),
                                   rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("seed", [13, 14])
    def test_depth_from_triangulation(self, seed):
        rng = np.random.default_rng(seed)
        n = 64
        p_ref = np.c_[rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(1, 5, n)]
        p_ref = p_ref.astype(np.float32)
        xi = np.float32([0.3, -0.1, 0.05, 0.02, -0.03, 0.01])
        Tj, Tt = jse3.exp(jnp.asarray(xi)), tse3.exp(tt(xi))
        p_cur = np.asarray(Tj.apply(jnp.asarray(p_ref)))
        f_ref = p_ref / p_ref[:, 2:]
        f_cur = p_cur / np.linalg.norm(p_cur, axis=1, keepdims=True)
        f_cur[:4] = np.asarray(jnp.einsum("ij,nj->ni", Tj.R, jnp.asarray(f_ref[:4])))  # parallel
        d_j, ok_j = jtri.depth_from_triangulation(Tj, jnp.asarray(f_ref), jnp.asarray(f_cur))
        d_t, ok_t = ttri.depth_from_triangulation(Tt, tt(f_ref), tt(f_cur))
        np.testing.assert_array_equal(np32(ok_t)[4:], np.asarray(ok_j)[4:])
        np.testing.assert_allclose(np32(d_t)[4:], np.asarray(d_j)[4:], rtol=1e-4)
        np.testing.assert_allclose(np32(d_t)[4:], p_ref[4:, 2], rtol=1e-3)

    def test_reprojection_error_and_bearing(self):
        rng = np.random.default_rng(15)
        pw = np.c_[rng.uniform(-1, 1, 32), rng.uniform(-1, 1, 32), rng.uniform(2, 5, 32)]
        pw = pw.astype(np.float32)
        p7 = pose7(rng)
        obs = rng.uniform(0, 320, (32, 2)).astype(np.float32)
        e_j = jtri.reprojection_error(jnp.asarray(pw), JSE3.from_params7(jnp.asarray(p7)),
                                      jnp.asarray(obs), JCAM)
        e_t = ttri.reprojection_error(tt(pw), TSE3.from_params7(tt(p7)), tt(obs), CAM)
        np.testing.assert_allclose(np32(e_t), np.asarray(e_j), atol=1e-3)
        np.testing.assert_allclose(np32(CAM.pixel_to_bearing(tt(obs))),
                                   np.asarray(JCAM.pixel_to_bearing(jnp.asarray(obs))), atol=1e-6)


class TestMapServer:
    """The host MapServer against the JAX one: slots in order while free,
    then the used slot least covisible with the newest evicted (its
    features unlinked), and free landmark rows ascending."""

    def _pair(self, K=4, F=8, L=32):
        return tmem.MapServer(K, F, L, device="cpu"), jmem.MapServer(K, F, L)

    def test_slots_and_eviction(self):
        t, j = self._pair()
        rng = np.random.default_rng(11)
        cov = rng.integers(0, 50, (4, 4)).astype(np.int32)
        cov = cov + cov.T
        picked = []
        for _ in range(7):
            for srv, tensor in ((t, tt), (j, jnp.asarray)):
                srv.state = srv.state._replace(cov_weight=tensor(cov),
                                               feat_point=tensor(np.zeros((4, 8), np.int32)))
            st, sj = t.alloc_kf_slot(), j.alloc_kf_slot()
            assert st == sj and t.kf_used == j.kf_used
            picked.append(st)
            for srv in (t, j):
                srv.kf_used.append(st)
            assert np.array_equal(np32(t.state.feat_point), np32(j.state.feat_point))
            assert np.array_equal(np32(t.state.kf_valid), np32(j.state.kf_valid))
        assert picked[:4] == [0, 1, 2, 3] and len(set(picked[4:])) >= 1

    @pytest.mark.parametrize("want", [0, 5, 40])
    def test_free_rows(self, want):
        t, j = self._pair()
        valid = np.random.default_rng(12).random(32) < 0.6
        t.state = t.state._replace(pt_valid=torch.tensor(valid))
        j.state = j.state._replace(pt_valid=jnp.asarray(valid))
        rows = t.alloc_landmark_rows(want)
        assert np.array_equal(rows, np.asarray(j.alloc_landmark_rows(want)))
        assert np.array_equal(rows, np.where(~valid)[0][:want])
