"""Parity of the PyTorch port's Hamming ops with the JAX package on the
CPU: the plain version of K10 against the interpreted Pallas kernel and the
jnp matrix, the matchers built on it, and the stable top-k helper against
`jax.lax.top_k` on inputs full of ties.  Everything here is integer or a
selection, so every comparison is exact."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_slam_tpu.ops import hamming as jham
from ygz_slam_tpu.ops.pallas import hamming_kernel as jhk

from ygz_slam_tpu_torch.ops import hamming as tham
from ygz_slam_tpu_torch.ops.kernels import hamming_kernel as thk
from ygz_slam_tpu_torch.ops.select import top_k

from _torch_port import jax_kernels_interpreted, np32

torch.set_num_threads(1)


def words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def t32(a):
    """uint32 words -> the port's int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def edge_words(rng, n):
    """Random words with all-ones, sign-bit-only and zero rows planted."""
    a = words(rng, n)
    a[0], a[1], a[2] = 0xFFFFFFFF, 0x80000000, 0
    a[3, ::2] = 0x80000001
    return a


class TestDistanceMatrix:
    @pytest.mark.parametrize("shape", [(130, 77), (32, 64), (1, 1), (5, 300)])
    def test_plain_matches_pallas_and_jnp(self, shape):
        rng = np.random.default_rng(0)
        a, b = words(rng, shape[0]), words(rng, shape[1])
        with jax_kernels_interpreted():
            d_pallas = np.asarray(jhk.distance_matrix_pallas(jnp.asarray(a), jnp.asarray(b)))
        d_jnp = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
        d_port = thk.distance_matrix_plain(t32(a), t32(b))
        assert d_port.dtype == torch.int32 and tuple(d_port.shape) == shape
        np.testing.assert_array_equal(np32(d_port), d_pallas)
        np.testing.assert_array_equal(np32(d_port), d_jnp)

    def test_sign_bit_words(self):
        rng = np.random.default_rng(1)
        a, b = edge_words(rng, 130), edge_words(rng, 77)
        with jax_kernels_interpreted():
            d_pallas = np.asarray(jhk.distance_matrix_pallas(jnp.asarray(a), jnp.asarray(b)))
        d_port = np32(tham.distance_matrix(t32(a), t32(b)))
        np.testing.assert_array_equal(d_port, d_pallas)
        assert d_port[0, 2] == 256 and d_port[1, 2] == 8 and d_port[0, 1] == 248

    def test_popcount_every_bit(self):
        v = torch.from_numpy((np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32))
        assert thk.popcount_i32(v).tolist() == [1] * 32
        assert int(thk.popcount_i32(torch.tensor(-1, dtype=torch.int32))) == 32

    def test_empty_sides(self):
        a = t32(words(np.random.default_rng(2), 4))
        e = torch.zeros((0, 8), dtype=torch.int32)
        assert tuple(tham.distance_matrix(a, e).shape) == (4, 0)
        assert tuple(tham.distance_matrix(e, a).shape) == (0, 4)

    @pytest.mark.parametrize("bad", ["dtype", "width", "strided"])
    def test_inputs_checked(self, bad):
        a = t32(words(np.random.default_rng(3), 6))
        b = {"dtype": a.long(), "width": a[:, :7].contiguous(), "strided": a[::2]}[bad]
        with pytest.raises(ValueError):
            tham.distance_matrix(a, b)

    def test_elementwise_distance(self):
        rng = np.random.default_rng(4)
        a, b = edge_words(rng, 40), edge_words(rng, 40)[::-1].copy()
        want = np.asarray(jham.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(np32(tham.hamming_distance(t32(a), t32(b))), want)


class TestTensorCoreForm:
    """The arithmetic of K10's tensor-core form (csrc/hamming.cu), which
    only the card runs: popc(a ^ b) from popc(a & b), and a lane-by-lane
    model of its fragments, shuffles and stores."""

    def test_and_popcount_identity(self):
        """popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b) on every pair of
        int32 words, all-ones, sign-bit-only and zero words among them;
        summed over the 8 words it is K10's plain distance."""
        rng = np.random.default_rng(5)
        a, b = t32(edge_words(rng, 37)), t32(edge_words(rng, 29))
        x, y = a[:, None, :], b[None, :, :]
        pc = thk.popcount_i32
        lhs = pc(x ^ y)
        rhs = pc(x) + pc(y) - 2 * pc(x & y)
        assert torch.equal(lhs, rhs)
        assert int(lhs[0, 2, 0]) == 32 and int(lhs[1, 2, 0]) == 1 and int(lhs[0, 1, 0]) == 31
        assert torch.equal(torch.sum(rhs, dim=-1, dtype=torch.int32),
                           thk.distance_matrix_plain(a, b))

    @staticmethod
    def _mma_model(a, b, n_b, warps):
        """K10's tensor-core kernel, lane by lane: block i of the 1-D grid
        (column tile bx = i % col_tiles, row tile by = i // col_tiles), warp
        w, lane (g, t) = (lane // 4, lane % 4) loads words 2t, 2t + 1 of a's
        rows n0 + g, n0 + g + 8 and of b's column m0 + 8j + g; the single-bit
        MMA is applied to the matrices its fragments stand for in the PTX
        layout of m16n8k256 (a0: row g, k-word t; a1: row g + 8, k-word t;
        a2, a3: k-word t + 4; b0: k-word t, column g; b1: k-word t + 4; c0,
        c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8)."""
        def popc(v):
            return bin(int(v) & 0xFFFFFFFF).count("1")

        N, M = len(a), len(b)
        out = np.full((N, M), -1, np.int64)
        zero = (0, 0)
        col_tiles = -(-M // (8 * n_b * warps))
        for i in range(-(-N // 16) * col_tiles):
            by, bx = divmod(i, col_tiles)
            for w in range(warps):
                n0, m0 = 16 * by, (bx * warps + w) * 8 * n_b
                if m0 >= M:
                    continue
                x0 = [tuple(a[n0 + l // 4, 2 * (l % 4):2 * (l % 4) + 2]) if n0 + l // 4 < N
                      else zero for l in range(32)]
                x1 = [tuple(a[n0 + l // 4 + 8, 2 * (l % 4):2 * (l % 4) + 2])
                      if n0 + l // 4 + 8 < N else zero for l in range(32)]
                af = [(x0[l][0], x1[l][0], x0[l][1], x1[l][1]) for l in range(32)]

                def group_sum(v):
                    return [sum(v[4 * (l // 4):4 * (l // 4) + 4]) for l in range(32)]

                pa0 = group_sum([popc(x0[l][0]) + popc(x0[l][1]) for l in range(32)])
                pa1 = group_sum([popc(x1[l][0]) + popc(x1[l][1]) for l in range(32)])
                A = np.zeros((16, 8), np.int64)
                for l in range(32):
                    g, t = l // 4, l % 4
                    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = af[l]
                for j in range(n_b):
                    y = [tuple(b[m0 + 8 * j + l // 4, 2 * (l % 4):2 * (l % 4) + 2])
                         if m0 + 8 * j + l // 4 < M else zero for l in range(32)]
                    pb = group_sum([popc(y[l][0]) + popc(y[l][1]) for l in range(32)])
                    B = np.zeros((8, 8), np.int64)
                    for l in range(32):
                        B[l % 4, l // 4], B[l % 4 + 4, l // 4] = y[l]
                    D = [[sum(popc(A[r, k] & B[k, c]) for k in range(8)) for c in range(8)]
                         for r in range(16)]
                    for l in range(32):
                        g, t = l // 4, l % 4
                        pb0, pb1 = pb[8 * t], pb[8 * t + 4]
                        c = (D[g][2 * t], D[g][2 * t + 1], D[g + 8][2 * t],
                             D[g + 8][2 * t + 1])
                        v = (pa0[l] + pb0 - 2 * c[0], pa0[l] + pb1 - 2 * c[1],
                             pa1[l] + pb0 - 2 * c[2], pa1[l] + pb1 - 2 * c[3])
                        col = m0 + 8 * j + 2 * t
                        for h, r in enumerate((n0 + g, n0 + g + 8)):
                            for e in range(2):
                                if r < N and col + e < M:
                                    assert out[r, col + e] == -1, "stored twice"
                                    out[r, col + e] = v[2 * h + e]
        return out

    @pytest.mark.parametrize("shape", [(4, 4), (15, 9), (16, 8), (17, 9), (33, 45), (5, 70),
                                       (64, 129), (130, 77)])
    def test_mma_lane_model(self, shape):
        """With the kernel's tiling (16 x 32 warp tiles, 4 warps per block):
        every output written once, and equal to the plain version; the K
        order permuted alike in a and b, the popcounts summed over a lane
        group and fetched from the lanes that hold columns 2t and 2t + 1,
        ragged edges loaded as zeros and left unstored."""
        rng = np.random.default_rng(6)
        a, b = edge_words(rng, shape[0]), edge_words(rng, shape[1])
        got = self._mma_model(a, b, n_b=4, warps=4)
        np.testing.assert_array_equal(got, np32(thk.distance_matrix_plain(t32(a), t32(b))))


def _noisy_copies(rng, base, flips):
    """Copies of `base` rows with `flips[i]` random bits flipped in row i."""
    out = base.copy()
    for i, k in enumerate(flips):
        for bit in rng.choice(256, size=k, replace=False):
            out[i, bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
    return out


class TestMatchers:
    @pytest.mark.parametrize("cross_check", [True, False])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_match_nn(self, seed, cross_check):
        rng = np.random.default_rng(seed)
        b = words(rng, 96)
        # a: noisy copies of rows of b (close matches, some beyond max_dist),
        # duplicates (ties) and unrelated rows.
        src = rng.integers(0, 96, 64)
        a = _noisy_copies(rng, b[src], rng.integers(0, 70, 64))
        a[50:56] = a[44:50]
        b[90:96] = b[10:16]                     # exact duplicates in b: argmin ties
        mask_a = rng.random(64) > 0.1
        mask_b = rng.random(96) > 0.1
        j_idx, j_ok = jham.match_nn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask_a),
                                    jnp.asarray(mask_b), cross_check=cross_check)
        t_idx, t_ok = tham.match_nn(t32(a), t32(b), torch.from_numpy(mask_a),
                                    torch.from_numpy(mask_b), cross_check=cross_check)
        assert t_idx.dtype == torch.int32
        np.testing.assert_array_equal(np32(t_ok), np.asarray(j_ok))
        np.testing.assert_array_equal(np32(t_idx), np.asarray(j_idx))
        assert int(t_ok.sum()) > 5

    def test_argmin_ties_take_the_first(self):
        rng = np.random.default_rng(5)
        low = words(rng, 80) & np.uint32(3)         # distances 0..16: ties everywhere
        d_j = jham.distance_matrix(jnp.asarray(low[:40]), jnp.asarray(low))
        d_t = tham.distance_matrix(t32(low[:40]), t32(low))
        best, best_d, second = tham.best_two(d_t)
        np.testing.assert_array_equal(np32(best), np.asarray(jnp.argmin(d_j, axis=1)))
        np.testing.assert_array_equal(np32(torch.argmin(d_t, dim=0)),
                                      np.asarray(jnp.argmin(d_j, axis=0)))
        d2 = d_j.at[jnp.arange(40), jnp.argmin(d_j, axis=1)].set(1 << 14)
        np.testing.assert_array_equal(np32(second), np.asarray(jnp.min(d2, axis=1)))
        np.testing.assert_array_equal(np32(best_d), np.asarray(jnp.min(d_j, axis=1)))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_rotation_consistency(self, seed):
        rng = np.random.default_rng(seed)
        n = 120
        # Three modes of equal size (equal bin counts: a top-k tie), a weak
        # fourth one and scattered outliers.
        delta = np.concatenate([np.full(30, 0.31), np.full(30, 2.0), np.full(30, 4.4),
                                np.full(4, 5.5), rng.uniform(0, 2 * np.pi, 26)])
        angle_b = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        angle_a = (angle_b + delta).astype(np.float32)
        matched = rng.random(n) > 0.15
        want = jham.rotation_consistency(jnp.asarray(angle_a), jnp.asarray(angle_b),
                                         jnp.asarray(matched))
        got = tham.rotation_consistency(torch.from_numpy(angle_a), torch.from_numpy(angle_b),
                                        torch.from_numpy(matched))
        np.testing.assert_array_equal(np32(got), np.asarray(want))
        assert 0 < int(got.sum()) < int(matched.sum())


class TestStableTopK:
    @pytest.mark.parametrize("case", ["all_ties", "mask", "few_values", "with_inf", "ints"])
    def test_matches_lax_top_k(self, case):
        rng = np.random.default_rng(6)
        x = {
            "all_ties": np.ones(300, np.float32),
            "mask": (rng.random(300) > 0.5).astype(np.float32),
            "few_values": rng.integers(0, 4, 300).astype(np.float32) * 0.25,
            "with_inf": np.where(rng.random(300) > 0.5, -np.inf,
                                 rng.integers(0, 3, 300)).astype(np.float32),
            "ints": rng.integers(0, 5, 300).astype(np.int32),
        }[case]
        for k in (1, 17, 300):
            j_val, j_idx = jax.lax.top_k(jnp.asarray(x), k)
            t_val, t_idx = top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(np32(t_idx), np.asarray(j_idx))
            np.testing.assert_array_equal(np32(t_val), np.asarray(j_val))
