"""The port's BoW vocabulary against the JAX package's, on the CPU: the
packaged asset, `transform` (words and gating nodes, ties included),
`bow_vector`, `score_l1`, `match_by_nodes`, training and persistence, on
identical descriptors (the port holds them as int32 words with the JAX
package's uint32 bits)."""
import hashlib
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.map import vocabulary as jvoc

from ygz_slam_tpu_torch import convert
from ygz_slam_tpu_torch.geometry.camera import PinholeCamera
from ygz_slam_tpu_torch.geometry.se3 import SE3
from ygz_slam_tpu_torch.map import vocabulary as tvoc
from ygz_slam_tpu_torch.models import frontend as tfe
from ygz_slam_tpu_torch.models import mono_workload as mw
from ygz_slam_tpu_torch.utils.synthetic import PlaneScene

from _torch_port import np32

torch.set_num_threads(1)

JAX_ASSET = os.path.join(os.path.dirname(__file__), "..", "ygz_slam_tpu", "assets",
                         "orbvoc_10k.npz")
TOL_BOW = 1e-7       # bow_vector entries (L1-normalised, each <= 1)
TOL_SCORE = 1e-6     # score_l1 (a float32 sum over 10^4 words)


@pytest.fixture(scope="module")
def vocabs():
    return jvoc.load(JAX_ASSET), tvoc.load(tvoc.ASSET, device="cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return np32(t).view(np.uint32)


def _frame_features(seed: int, shift: float = 0.0):
    """The port's detections on a 240x320 PlaneScene render."""
    cam = PinholeCamera.create(320.0, 320.0, 160.0, 120.0)
    T = SE3(torch.eye(3), torch.tensor([shift, 0.0, 0.0]))
    img = PlaneScene(cam, plane_z=3.0, seed=seed, device="cpu").render(T, (240, 320))
    o = mw.mono_options()
    return tfe.detect_multilevel(tfe.preprocess(img, 3), o.detect_threshold, o.grid_cell,
                                 o.feat_budgets)


def _planted_ties(nodes0: np.ndarray, n: int, rng) -> np.ndarray:
    """n descriptors each exactly halfway between two level-0 nodes whose
    Hamming distance is even (ties of the first sweep)."""
    out = []
    k = nodes0.shape[0]
    while len(out) < n:
        i, j = sorted(rng.choice(k, 2, replace=False))
        bits_i = np.unpackbits(nodes0[i].view(np.uint8))
        bits_j = np.unpackbits(nodes0[j].view(np.uint8))
        diff = np.where(bits_i != bits_j)[0]
        if len(diff) % 2:
            continue
        b = bits_i.copy()
        flip = rng.choice(diff, len(diff) // 2, replace=False)
        b[flip] = bits_j[flip]
        out.append(np.packbits(b).view(np.uint32))
    return np.stack(out)


def test_asset_is_a_copy_of_the_jax_asset(vocabs):
    def sha(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert sha(tvoc.ASSET) == sha(JAX_ASSET)
    jv, tv = vocabs
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words) == (10, 4, 10 ** 4)
    for a, b in zip(jv.nodes, tv.nodes):
        assert b.dtype == torch.int32 and np.array_equal(np.asarray(a), _u32(b))
    assert np.array_equal(np.asarray(jv.weights), np32(tv.weights))
    sd = tvoc.state_dict(tv)
    for key, a in jvoc.state_dict(jv).items():
        assert sd[key].dtype == a.dtype and np.array_equal(sd[key], a)


@pytest.mark.parametrize("case", ["frame", "random", "ties"])
@pytest.mark.parametrize("node_level", [0, 2])
def test_transform_matches_jax(vocabs, case, node_level):
    jv, tv = vocabs
    rng = np.random.default_rng(5)
    if case == "frame":
        f = _frame_features(3)
        desc, mask = _u32(f.desc), np32(f.valid)
    elif case == "random":
        desc = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32)
        mask = rng.random(300) < 0.8
    else:
        nodes0 = np.asarray(jv.nodes[0])
        desc = _planted_ties(nodes0, 64, rng)
        mask = np.ones(64, bool)
        d0 = np.stack([np.bitwise_count(desc ^ nodes0[c]).sum(1) for c in range(jv.k)], 1)
        tied = (d0 == d0.min(1, keepdims=True)).sum(1) >= 2
        assert tied.sum() >= 32, tied.sum()       # most rows tie in the first sweep
    wj, nj = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(mask), node_level=node_level)
    wt, nt = tvoc.transform(tv, torch.tensor(desc.view(np.int32)), torch.tensor(mask),
                            node_level=node_level)
    assert np.array_equal(np.asarray(wj), np32(wt)) and np.array_equal(np.asarray(nj), np32(nt))
    if case == "ties" and node_level == 0:
        # The first index wins a tie, as jnp.argmin.
        assert np.array_equal(np32(nt)[tied], d0[tied].argmin(1))


def test_bow_vector_and_score_match_jax(vocabs):
    jv, tv = vocabs
    vecs_j, vecs_t = [], []
    for seed, shift in ((3, 0.0), (3, 0.05), (4, 0.0)):
        f = _frame_features(seed, shift)
        desc, mask = _u32(f.desc), np32(f.valid)
        wj, _ = jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(mask))
        wt, _ = tvoc.transform(tv, f.desc, f.valid)
        vecs_j.append(jvoc.bow_vector(jv, wj, jnp.asarray(mask)))
        vecs_t.append(tvoc.bow_vector(tv, wt, f.valid))
    d_bow = max(float(np.abs(np.asarray(a) - np32(b)).max()) for a, b in zip(vecs_j, vecs_t))
    sj = np.asarray(jvoc.score_l1(jnp.stack(vecs_j)[:, None, :], jnp.stack(vecs_j)[None, :, :]))
    st = np32(tvoc.score_l1(torch.stack(vecs_t)[:, None, :], torch.stack(vecs_t)[None, :, :]))
    print(f"bow_vector within {d_bow:.2e} (tol {TOL_BOW}); score_l1 within "
          f"{np.abs(sj - st).max():.2e} (tol {TOL_SCORE}); scores\n{st}")
    assert d_bow < TOL_BOW
    assert np.abs(sj - st).max() < TOL_SCORE
    assert st[0, 1] > st[0, 2]          # the shifted view of the same scene scores higher


def test_match_by_nodes_matches_jax(vocabs):
    jv, tv = vocabs
    fa, fb = _frame_features(3), _frame_features(3, 0.03)
    outs = []
    for f in (fa, fb):
        _, nj = jvoc.transform(jv, jnp.asarray(_u32(f.desc)), jnp.asarray(np32(f.valid)))
        _, nt = tvoc.transform(tv, f.desc, f.valid)
        outs.append((nj, nt))
    ij, okj = jvoc.match_by_nodes(jnp.asarray(_u32(fa.desc)), outs[0][0], jnp.asarray(np32(
        fa.valid)), jnp.asarray(_u32(fb.desc)), outs[1][0], jnp.asarray(np32(fb.valid)))
    it, okt = tvoc.match_by_nodes(fa.desc, outs[0][1], fa.valid, fb.desc, outs[1][1], fb.valid)
    assert np.array_equal(np.asarray(ij), np32(it)) and np.array_equal(np.asarray(okj), np32(okt))
    assert int(okt.sum()) > 20


def test_train_gives_the_jax_tree(tmp_path):
    rng = np.random.default_rng(11)
    desc = rng.integers(0, 2 ** 32, (700, 8), dtype=np.uint64).astype(np.uint32)
    jv = jvoc.train(desc, k=4, depth=3, iters=3, seed=2)
    tv = tvoc.train(torch.tensor(desc.view(np.int32)), k=4, depth=3, iters=3, seed=2,
                    device="cpu")
    for a, b in zip(jv.nodes, tv.nodes):
        assert np.array_equal(np.asarray(a), _u32(b))
    assert np.array_equal(np.asarray(jv.weights), np32(tv.weights))
    # Persistence: the port's file loads in the JAX package, and back.
    path = str(tmp_path / "voc.npz")
    tvoc.save(tv, path)
    jl = jvoc.load(path)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(jl.nodes, jv.nodes))
    back = convert.vocabulary_from_numpy(jvoc.state_dict(jl), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.nodes, tv.nodes))
    assert torch.equal(back.weights, tv.weights)
