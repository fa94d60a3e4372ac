"""K2 over a table of images of their own shapes: the VO's pyramid levels,
read in place, where the JAX package (and the port before) built a
zero-padded [levels, H, W] stack of the pyramid for every tracked frame.

The table route's plain version is held bit for bit against the JAX
`gather_windows_multi`, run in interpret mode, on the zero-padded stack of
the same pyramid: origins inside each level, past a level's own edge but
inside level 0's shape, off the image, and a pyramid whose coarsest level
is smaller than the window.  Then the VO's map search and map tracking on
the table route against the stack route they replaced (the stack built
here, in the test), with `torch.equal`."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.ops.pallas import align2d_kernel as jak

from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3 as TSE3
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import vo_workload as vw
from ygz_slam_tpu_torch.ops import pyramid as tpyr
from ygz_slam_tpu_torch.ops.kernels import align2d_kernel as tak

from _torch_port import jax_kernels_interpreted, zero_padded_stack

torch.set_num_threads(1)

WIN = tak.CACHE_WIN
N_WIN = 60


def _pyramid(shape, seed):
    img = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    return tpyr.build_pyramid(torch.tensor(img), 3)


def _origins(case, levels, idx, rng):
    """int32 origins of windows on level idx[n] of `levels`."""
    H, W = levels[0].shape
    hl = np.array([lv.shape[0] for lv in levels])[idx]
    wl = np.array([lv.shape[1] for lv in levels])[idx]
    n = idx.shape[0]
    if case == "inside":
        xi = (rng.uniform(0, 1, n) * (wl - WIN + 1)).astype(int)
        yi = (rng.uniform(0, 1, n) * (hl - WIN + 1)).astype(int)
    elif case == "past_own_edge":
        # Past the level's own right or bottom edge, inside level 0's shape.
        xi = rng.integers(0, W - WIN + 1, n)
        yi = rng.integers(0, H - WIN + 1, n)
        xi[: n // 2] = np.minimum(wl[: n // 2] - WIN + 1 + rng.integers(0, 20, n // 2),
                                  W - WIN)
        yi[n // 2:] = np.minimum(hl[n // 2:] - WIN + 1 + rng.integers(0, 20, n - n // 2),
                                 H - WIN)
    else:
        xi = rng.integers(-40, W + 11, n)
        yi = rng.integers(-40, H + 11, n)
        xi[:4], yi[:4] = [-3, W - WIN + 3, -WIN - 2, 5], [H - WIN + 2, -2, 5, H + 4]
    return xi.astype(np.int32), yi.astype(np.int32)


CASES = [("inside", (128, 176)), ("past_own_edge", (128, 176)), ("off_image", (128, 176)),
         ("level_smaller_than_window", (61, 83))]


@pytest.mark.parametrize("case,shape", CASES, ids=[c for c, _ in CASES])
def test_levels_route_matches_jax_on_the_stack(case, shape):
    """K2's plain version on the pyramid's levels returns, bit for bit, what
    the JAX kernel returns on the zero-padded stack of the same pyramid;
    so does the port's stack route.  The 61x83 frame's level 2 is 16x21,
    smaller than the 32-px window, and its origins are the VO's own
    (`a2d_window_origins` on level 0's size over 2^level), which go
    negative there, mixed with origins off the image."""
    rng = np.random.default_rng(31 + len(case))
    levels = _pyramid(shape, 30)
    if case == "level_smaller_than_window":
        assert min(levels[-1].shape) < WIN
    idx = rng.integers(0, len(levels), N_WIN).astype(np.int32)
    if case == "level_smaller_than_window":
        from ygz_slam_tpu_torch.ops.kernels.align2d_fused import a2d_window_origins

        scale = 2.0 ** idx
        centers = torch.tensor(np.c_[rng.uniform(-5, shape[1] + 5, N_WIN) / scale,
                                     rng.uniform(-5, shape[0] + 5, N_WIN) / scale],
                               dtype=torch.float32)
        s = torch.tensor(scale, dtype=torch.float32)
        ox, oy = a2d_window_origins(centers, shape[0] / s, shape[1] / s)
        xo, yo = _origins("off_image", levels, idx, rng)
        xi, yi = np.r_[ox.numpy()[:40], xo[40:]], np.r_[oy.numpy()[:40], yo[40:]]
        assert (xi[:40][idx[:40] == 2] < 0).any()
    else:
        xi, yi = _origins(case, levels, idx, rng)
    stack = zero_padded_stack(levels)
    with jax_kernels_interpreted():
        ref = np.asarray(jak.gather_windows_multi(jnp.asarray(stack.numpy()), jnp.asarray(idx),
                                                  jnp.asarray(xi), jnp.asarray(yi), WIN))
    args = (torch.tensor(idx), torch.tensor(xi), torch.tensor(yi), WIN)
    out = tak.gather_windows_multi(tuple(levels), *args)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tak.gather_windows_multi(stack, *args).numpy(), ref)
    if case != "inside":
        assert (ref == 0).any()


@pytest.mark.parametrize("n_levels", [0, tak.MAX_LEVELS + 1])
def test_table_outside_its_cap_raises(n_levels):
    """A table of no image or of more than MAX_LEVELS images raises, on the
    CPU as on the card (the kernel's table holds MAX_LEVELS)."""
    imgs = tuple(torch.zeros(40, 40) for _ in range(n_levels))
    o = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tak.gather_windows_multi(imgs, o, o, o, 7)
    with pytest.raises(ValueError):
        tak.gather_windows_multi_plain(imgs, o, o, o, 7)


@pytest.mark.parametrize("bad", [-1, 3], ids=["negative", "past_the_table"])
def test_table_rejects_bad_index(bad):
    """An image index that names no image of the table raises IndexError
    (the kernel stops on its device-side assert: tests/test_torch_cuda.py)."""
    levels = _pyramid((64, 64), 1)
    o = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(IndexError):
        tak.gather_windows_multi(levels, torch.tensor([0, bad, 2], dtype=torch.int32), o, o, 7)


def _stack_route(monkeypatch):
    """Send the frontend's K2 calls through the stack formulation the VO
    used before: the levels copied into a zero-padded stack, one image
    index per level."""
    table_route = tfe.gather_windows_multi

    def on_stack(imgs, *args):
        return table_route(zero_padded_stack(imgs), *args)

    monkeypatch.setattr(tfe, "gather_windows_multi", on_stack)


def _map_problem(shape, n=96, seed=40):
    """A pyramid, camera, landmarks projecting around the frame at 2-4 m
    with a few invalid, search levels on every level, and reference
    patches cut from each landmark's search level at its projection."""
    rng = np.random.default_rng(seed)
    levels = _pyramid(shape, seed)
    H, W = shape
    cam = PinholeCamera.create(0.8 * W, 0.8 * W, W / 2, H / 2)
    z = rng.uniform(2, 4, n)
    u, v = rng.uniform(-10, W + 10, n), rng.uniform(-10, H + 10, n)
    pts = np.c_[(u - W / 2) * z / (0.8 * W), (v - H / 2) * z / (0.8 * W), z]
    lvl = rng.integers(0, 3, n).astype(np.int32)
    patches = np.zeros((n, 10, 10), np.float32)
    for k in range(n):
        img = levels[lvl[k]].numpy()
        x0 = int(np.clip(np.floor(u[k] / 2 ** lvl[k]) - 4, 0, img.shape[1] - 10))
        y0 = int(np.clip(np.floor(v[k] / 2 ** lvl[k]) - 4, 0, img.shape[0] - 10))
        patches[k] = img[y0:y0 + 10, x0:x0 + 10] + rng.normal(0, 2, (10, 10))
    valid = torch.tensor(rng.uniform(0, 1, n) > 0.1)
    return (levels, cam, TSE3.identity(device="cpu"), torch.tensor(pts, dtype=torch.float32), valid,
            torch.tensor(patches), torch.tensor(rng.uniform(0, 1, n) > 0.05),
            torch.tensor(lvl))


@pytest.mark.parametrize("shape", [(61, 83), (121, 163)])
def test_local_map_search_windows_equal_the_stack_route(shape):
    """`local_map_search` hands K2 the pyramid's levels; the windows equal
    those of the stack route on the same arguments, bit for bit, on frames
    whose coarsest level is smaller than the window."""
    levels, cam, T, pts, valid, _, ok, lvl = _map_problem(shape)
    ls = tfe.local_map_search(levels, cam, T, pts, valid, ok, lvl)
    assert isinstance(ls.k2_args[0], tuple) and len(ls.k2_args[0]) == 3
    table = tak.gather_windows_multi(*ls.k2_args)
    stack = tak.gather_windows_multi(zero_padded_stack(levels), *ls.k2_args[1:])
    assert torch.equal(table, stack)
    assert (ls.k2_args[1] == 2).any() and (table == 0).any()


@pytest.mark.parametrize("shape", [(61, 83), (121, 163)])
def test_track_local_map_equals_the_stack_route(shape, monkeypatch):
    """`track_local_map` on the levels gives the stack route's pose,
    inliers, candidates and observations, bit for bit."""
    problem = _map_problem(shape)
    new = tfe.track_local_map(*problem)
    _stack_route(monkeypatch)
    old = tfe.track_local_map(*problem)
    assert int(new.n_inliers) > 0
    for a, b in ((new.T_cw.R, old.T_cw.R), (new.T_cw.t, old.T_cw.t),
                 (new.n_inliers, old.n_inliers), (new.candidate, old.candidate),
                 (new.found, old.found), (new.obs_px, old.obs_px)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(121, 163), (240, 320)])
def test_vo_frames_equal_the_stack_route(shape, monkeypatch):
    """Three frames of the VO slice (`track_vo_frame`: sparse alignment,
    the visible subset, map tracking) on the table route and on the stack
    route give the same poses, inliers and observations, bit for bit; at
    121x163 the coarsest level (31x41) is smaller than the window."""
    state, frames, _ = vw.make_vo_workload(4, device="cpu", shape=shape)
    runs = []
    for route in ("table", "stack"):
        if route == "stack":
            _stack_route(monkeypatch)
        st, out = state, []
        for img in frames[1:]:
            st, _, tm = vw.track_vo_frame(st, img)
            out.append((st.prev_T_cw7, tm.n_inliers, tm.found, tm.obs_px))
        runs.append(out)
    assert int(runs[0][-1][1]) > 20
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
