"""CPU checks of K11's launch geometry (ops/kernels/track_fused.py::
track_partition): how one launch spreads the map points over its cluster of
CTAs.  The card tests (tests/test_torch_cuda.py) hold the kernel's
results to the plain version at N = 1 to 1500.  No JAX."""
import pathlib

from ygz_slam_tpu_torch.ops.kernels import track_fused as k11

CSRC = pathlib.Path(k11.__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "track_fused.cu"
COMMON = CSRC / "common.cuh"      # launch_cluster, which makes K11's launch


def _ranges(p, n):
    """Each CTA's (first point, end) as the kernel computes them:
    n0 = min(N, rank * per_cta), n1 = min(N, n0 + per_cta)."""
    return [(min(n, r * p.per_cta), min(n, min(n, r * p.per_cta) + p.per_cta))
            for r in range(p.cluster)]


def test_partition_covers_every_point_once():
    """For N from 0 to 4096: every map point falls in exactly one CTA's
    range, the ranges are contiguous and in rank order, and no CTA of a
    non-empty map is left without a point (it would run stage 1 for
    nothing)."""
    for n in range(0, 4097):
        p = k11.track_partition(n)
        ranges = _ranges(p, n)
        seen = [0] * n
        end = 0
        for n0, n1 in ranges:
            assert n0 == end and n0 <= n1 <= n, (n, ranges)
            assert n1 > n0 or n == 0, (n, ranges)
            for i in range(n0, n1):
                seen[i] += 1
            end = n1
        assert seen == [1] * n, n


def test_partition_fits_the_card():
    """A CTA for every WARPS points (a warp per point), at most the
    portable 8, each with K3's and K5's 512 threads."""
    assert k11.THREADS == 512 and k11.WARPS == 16 and k11.MAX_CLUSTER == 8
    for n in range(0, 4097):
        p = k11.track_partition(n)
        assert p.cluster == max(1, min(8, -(-n // k11.WARPS)))
        assert p.cluster * p.per_cta >= n
        assert p.per_cta <= max(k11.WARPS, -(-n // 8))


def test_kernel_stays_portable():
    """The kernel sets no non-portable cluster size, and its launch refuses
    a cluster above 8 rather than retrying with another; its block is the
    wrapper's."""
    src = SOURCE.read_text()
    launcher = COMMON.read_text()
    assert "NonPortableClusterSizeAllowed" not in src + launcher
    assert "launch_cluster(track_fused_kernel, cluster, per_cta, N2, kThreads" in src
    assert "constexpr int kMaxCluster = 8;" in launcher and "cluster > kMaxCluster" in launcher
    assert "cudaLaunchAttributeClusterDimension" in launcher
    assert f"constexpr int kThreads = {k11.THREADS};" in src
    assert "min(mp.N, (int)blockIdx.x * per_cta)" in src and "min(mp.N, n0 + per_cta)" in src
