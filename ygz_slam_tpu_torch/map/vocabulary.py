"""Binary-descriptor vocabulary (counterpart of
ygz_slam_tpu/map/vocabulary.py, the DBoW3 replacement).

A k-ary tree over 256-bit ORB descriptors kept as dense tensors: tree level
l is a [k^(l+1), 8] table of 32-bit words, and a descriptor descends by a
Hamming argmin against its node's k children at each level, all rows at
once.  Training is the JAX package's host-side numpy code (hierarchical
binary k-medians), copied, so the same seed gives the same tree.  Scores
are tf-idf weighted L1.

The JAX package holds the nodes as uint32; the port holds the same bits as
int32 (as it holds every descriptor: PyTorch has next to no arithmetic on
uint32), so XOR and popcount see the same bits.  `state_dict` gives them
back as uint32, so a saved file is the JAX package's.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.hamming import distance_matrix, best_two, hamming_distance, BIG

# The packaged 10^4-word vocabulary (k=10, depth 4): a byte-for-byte copy of
# the JAX package's assets/orbvoc_10k.npz.
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "orbvoc_10k.npz")


class Vocabulary(NamedTuple):
    """k-ary tree: level l has k^(l+1) nodes; the children of node i at
    level l + 1 are rows [i*k, (i+1)*k)."""

    nodes: tuple      # per level: [k^(l+1), 8] int32 words
    weights: torch.Tensor   # [n_words] float32 idf weights
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.nodes[-1].shape[0]

    @property
    def device(self) -> torch.device:
        return self.weights.device


def _as_u32(desc) -> np.ndarray:
    """[N, 8] descriptor words as uint32 numpy (an int32 array or tensor is
    reinterpreted, not converted)."""
    if isinstance(desc, torch.Tensor):
        desc = desc.detach().cpu().numpy()
    desc = np.asarray(desc)
    return desc.view(np.uint32) if desc.dtype == np.int32 else desc.astype(np.uint32)


def _bits_of(desc: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 256] uint8 bits via a byte view."""
    by = desc.astype("<u4").view(np.uint8)          # [N, 32]
    return np.unpackbits(by, axis=1, bitorder="little")


def _pack_bits_fast(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def _kmedians_binary(desc: np.ndarray, k: int, iters: int, rng,
                     bits: np.ndarray | None = None) -> np.ndarray:
    """Binary k-medians: Hamming assignment + bitwise-majority update.
    Returns [k, 8] uint32 centroids (host side; training is offline)."""
    n = desc.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    if bits is None:
        bits = _bits_of(desc)
    centroids = desc[rng.choice(n, size=min(k, n), replace=False)]
    if centroids.shape[0] < k:
        centroids = np.concatenate(
            [centroids, np.tile(centroids[:1], (k - centroids.shape[0], 1))])
    for _ in range(iters):
        dist = np.zeros((n, k), np.int32)
        bya = desc.astype("<u4").view(np.uint8)
        byb = centroids.astype("<u4").view(np.uint8)
        for c in range(k):
            dist[:, c] = np.bitwise_count(bya ^ byb[c][None, :]).sum(1, dtype=np.int32)
        assign = dist.argmin(axis=1)
        for c in range(k):
            sel = assign == c
            if not sel.any():
                centroids[c] = desc[rng.integers(n)]
            else:
                maj = (bits[sel].mean(axis=0) >= 0.5).astype(np.uint8)
                centroids[c] = _pack_bits_fast(maj[None])[0]
    return centroids.astype(np.uint32)


def _from_numpy(levels, weights, k: int, depth: int, device) -> Vocabulary:
    dev = resolve_device(device)
    nodes = tuple(torch.tensor(_as_u32(n).view(np.int32), device=dev) for n in levels)
    return Vocabulary(nodes=nodes, weights=torch.tensor(np.asarray(weights, np.float32),
                                                        device=dev), k=k, depth=depth)


def train(descriptors, k: int = 8, depth: int = 3, iters: int = 6, seed: int = 0,
          device=None) -> Vocabulary:
    """A k^depth-word vocabulary from training descriptors [N, 8] (offline,
    on the host: DBoW3's create()); the idf weights come from the training
    set's word histogram, counted with `transform` on `device`."""
    rng = np.random.default_rng(seed)
    desc = _as_u32(descriptors)
    levels: list[np.ndarray] = []
    groups = [desc]                 # level 0: k clusters of everything
    for level in range(depth):
        nodes = np.zeros((k ** (level + 1), 8), np.uint32)
        next_groups: list[np.ndarray] = []
        for gi, g in enumerate(groups):
            cents = _kmedians_binary(g, k, iters, rng)
            nodes[gi * k:(gi + 1) * k] = cents
            if level < depth - 1:
                if len(g):
                    bya = g.astype("<u4").view(np.uint8)
                    byb = cents.astype("<u4").view(np.uint8)
                    dist = np.stack([np.bitwise_count(bya ^ byb[c][None, :]).sum(
                        1, dtype=np.int32) for c in range(k)], axis=1)
                    assign = dist.argmin(axis=1)
                else:
                    assign = np.zeros(0, int)
                for c in range(k):
                    next_groups.append(g[assign == c] if len(g) else g)
        levels.append(nodes)
        groups = next_groups
    vocab = _from_numpy(levels, np.ones(k ** depth, np.float32), k, depth, device)
    d = torch.tensor(desc.view(np.int32), device=vocab.device)
    words, _ = transform(vocab, d, torch.ones(len(desc), dtype=torch.bool, device=vocab.device))
    counts = np.bincount(words.cpu().numpy(), minlength=k ** depth) + 1
    idf = np.log(len(desc) / counts).clip(min=0.0).astype(np.float32)
    return vocab._replace(weights=torch.tensor(idf, device=vocab.device))


def state_dict(vocab: Vocabulary) -> dict:
    """The vocabulary's arrays as numpy, nodes as uint32 (the JAX package's
    layout: nodes_<level>, weights, meta = [k, depth])."""
    d = {f"nodes_{i}": n.cpu().numpy().view(np.uint32) for i, n in enumerate(vocab.nodes)}
    d["weights"] = vocab.weights.cpu().numpy()
    d["meta"] = np.asarray([vocab.k, vocab.depth], np.int32)
    return d


def from_state_dict(d, prefix: str = "", device=None) -> Vocabulary:
    """A Vocabulary from `state_dict`'s arrays (uint32 or int32 nodes)."""
    k, depth = (int(x) for x in d[prefix + "meta"])
    return _from_numpy([d[f"{prefix}nodes_{i}"] for i in range(depth)], d[prefix + "weights"],
                       k, depth, device)


def save(vocab: Vocabulary, path: str) -> None:
    np.savez_compressed(path, **state_dict(vocab))


def load(path: str, device=None) -> Vocabulary:
    with np.load(path) as data:
        return from_state_dict(dict(data), device=device)


def transform(vocab: Vocabulary, desc: torch.Tensor, mask: torch.Tensor, node_level: int = 0):
    """Descriptors [N, 8] int32 -> (word ids [N], gating node ids [N]),
    both int32 and -1 where `mask` is False.

    `depth` sweeps: each row's node's k children are gathered and the
    child at the least Hamming distance taken, the first index on ties
    (`torch.argmin`, as `ops.hamming.best_two` and `jnp.argmin`).  The
    gating node is the node reached at `node_level` (the k coarse clusters
    at 0: the reference's "feature vector" grouping for SearchByBoW)."""
    k = vocab.k
    dev = desc.device
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=dev)
    mid = node
    ar = torch.arange(k, device=dev)
    for level, nodes in enumerate(vocab.nodes):
        base = node * k
        cands = nodes[base[:, None] + ar[None, :]]               # [N, k, 8]
        d = hamming_distance(cands, desc[:, None, :])             # [N, k]
        node = base + torch.argmin(d, dim=1)
        if level == min(node_level, vocab.depth - 1):
            mid = node
    return (torch.where(mask, node, -1).to(torch.int32),
            torch.where(mask, mid, -1).to(torch.int32))


def bow_vector(vocab: Vocabulary, words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tf-idf-weighted, L1-normalised dense BoW vector [n_words]."""
    w = torch.clamp(words, 0, vocab.n_words - 1).long()
    # The word counts: a scatter-add of 0/1 addends.  On the card these are
    # float atomics in no fixed order, but sums of small whole numbers are
    # exact in float32 in any order, so the counts repeat bit for bit.
    counts = torch.zeros(vocab.n_words, dtype=torch.float32, device=w.device).index_add_(
        0, w, mask.to(torch.float32))
    v = counts * vocab.weights
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def score_l1(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """DBoW3 L1 score in [0, 1]: 1 - 0.5 * ||va - vb||_1 (vectors are
    L1-normalised).  Broadcasts: [.., W] x [.., W] -> [..]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(va - vb), dim=-1)


def match_by_nodes(desc_a, node_a, mask_a, desc_b, node_b, mask_b, max_dist: int = 50,
                   ratio: float = 0.9):
    """SearchByBoW equivalent (Matcher.cpp:196-292): nearest-neighbour
    Hamming matching restricted to descriptor pairs that share a vocabulary
    node, as one masked distance matrix.  Returns (idx [N] int32 or -1,
    ok [N])."""
    d = distance_matrix(desc_a, desc_b)
    same_node = (node_a[:, None] == node_b[None, :]) & (node_a[:, None] >= 0)
    d = torch.where(same_node & mask_b[None, :], d, BIG)
    best_idx, best, second = best_two(d)
    ok = mask_a & (best <= max_dist) & (best.float() < ratio * second.float())
    return torch.where(ok, best_idx, -1).to(torch.int32), ok
