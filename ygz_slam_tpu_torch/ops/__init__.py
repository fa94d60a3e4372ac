"""Image ops: interpolation, pyramid, sparse-direct and patch alignment."""

from . import align, fast, hamming, interp, orb, pyramid, sparse_align, warp

__all__ = ["interp", "pyramid", "fast", "orb", "hamming", "align", "warp", "sparse_align"]
