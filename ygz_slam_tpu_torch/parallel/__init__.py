"""Multi-sequence tracking (counterpart of ygz_slam_tpu/parallel; the
batch path only, no meshes or sharding yet)."""
from . import batch_tracking
from .batch_tracking import batched_align2d, batched_sparse_align, batched_track_step

__all__ = ["batch_tracking", "batched_sparse_align", "batched_align2d", "batched_track_step"]
