"""Distribution layer (counterpart of ygz_slam_tpu/parallel): meshes over
torch.distributed, the mesh-sharded local BA, and multi-sequence tracking,
batched on one device or split over a mesh."""
from . import batch_tracking, mesh, sharded_ba
from .batch_tracking import (batched_align2d, batched_sparse_align, batched_track_step,
                             sharded_batch_align)
from .mesh import HOST_AXIS, LANDMARK_AXIS, make_mesh, make_mesh_2d
from .sharded_ba import partition_observations, sharded_local_ba

__all__ = [
    "batch_tracking",
    "mesh",
    "sharded_ba",
    "make_mesh",
    "make_mesh_2d",
    "LANDMARK_AXIS",
    "HOST_AXIS",
    "sharded_local_ba",
    "partition_observations",
    "batched_sparse_align",
    "batched_align2d",
    "batched_track_step",
    "sharded_batch_align",
]
