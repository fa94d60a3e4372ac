"""Meshes over torch.distributed (counterpart of ygz_slam_tpu/parallel/mesh.py).

A mesh is the landmark shards of a distributed solve laid over the ranks of
a process group.  Each rank holds a contiguous run of shards (`local` of
them, shards `first` .. `first + local - 1`) on its own device; the JAX
package's virtual devices of one process are one rank holding several
shards here.  `make_mesh(n)` lays n shards over the group's ranks;
`make_mesh_2d(n_hosts, chips_per_host)` makes every rank a host holding
`chips_per_host` shards.  A sum over the mesh is then hierarchical, as the
JAX package's psum over ("host", "lm") is: first over the rank's own
shards, then one `all_reduce` over the ranks (`reduce_sum`).

The backend follows the device: NCCL for CUDA, gloo for the CPU; a group
of the other backend, or an NCCL that cannot start, raises (there is no
fallback).  With no process group yet, a mesh starts a world of one on an
in-process store; for more ranks the caller starts the group
(`init_process_group`), giving each process its rank, the world size and a
store or address.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device

LANDMARK_AXIS = "lm"
HOST_AXIS = "host"   # the cross-host axis of 2-D meshes


def backend_for(device: torch.device) -> str:
    """The process-group backend a mesh on `device` reduces through."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def init_process_group(device=None, rank: int = 0, world: int = 1, store=None,
                       init_method: str | None = None) -> None:
    """Start the default process group for meshes on `device` (the card
    unless the caller names another): NCCL for CUDA, gloo for the CPU.  A
    world of one needs neither store nor address (an in-process store);
    more ranks need a shared `store` (e.g. `dist.FileStore(path, world)`)
    or an `init_method` (e.g. "tcp://localhost:<port>")."""
    dev = resolve_device(device)
    if store is None and init_method is None:
        if world != 1:
            raise ValueError("a process group of more than one rank needs a store or an "
                             "init_method")
        store = dist.HashStore()
    dist.init_process_group(backend_for(dev), init_method=init_method, store=store, rank=rank,
                            world_size=world)


def _group_for(device: torch.device):
    """The default group, started as a world of one if there is none; raises
    if its backend is not the device's."""
    want = backend_for(device)
    if not dist.is_initialized():
        init_process_group(device)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have}; a mesh on {device} reduces through "
                         f"{want}")
    return dist.group.WORLD


class Mesh(NamedTuple):
    """Landmark shards laid over the ranks of a process group."""
    axis_names: tuple          # (LANDMARK_AXIS,) or (HOST_AXIS, LANDMARK_AXIS)
    shape: tuple               # shards per axis: (n,) or (n_hosts, chips_per_host)
    group: object              # the process group the reductions run in
    rank: int
    world: int
    device: torch.device

    @property
    def shards(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def local(self) -> int:
        """Shards this rank holds."""
        return self.shards // self.world

    @property
    def first(self) -> int:
        """This rank's first shard."""
        return self.rank * self.local

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a mesh-wide array whose leading dimension is
        split evenly over the shards, in shard order."""
        per = x.shape[0] // self.shards
        if per * self.shards != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.shards} shards")
        return x[self.first * per:(self.first + self.local) * per]


def _mesh(axis_names: tuple, shape: tuple, device) -> Mesh:
    dev = resolve_device(device)
    group = _group_for(dev)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    mesh = Mesh(axis_names, shape, group, rank, world, dev)
    if mesh.shards % world:
        raise ValueError(f"{mesh.shards} shards do not split over {world} ranks")
    return mesh


def make_mesh(n_devices: int | None = None, axis: str = LANDMARK_AXIS, device=None) -> Mesh:
    """A 1-D mesh of n_devices shards over the ranks of the process group
    (default: one shard per rank), on `device` (the card unless the caller
    names another)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((axis,), (n_devices,), device)


def make_mesh_2d(n_hosts: int, chips_per_host: int, device=None) -> Mesh:
    """A 2-D (host, chip) mesh: each of the group's n_hosts ranks is a host
    holding chips_per_host shards, host-major.  Landmark blocks shard over
    both axes flattened, so per-landmark work never crosses a rank; the one
    reduction per BA iteration sums the O(K^2) camera system over the
    rank's shards first, then across the ranks: ~(6K)^2 * 4 bytes, ~14 KB
    for a 10-keyframe window, whatever the landmark count."""
    mesh = _mesh((HOST_AXIS, LANDMARK_AXIS), (n_hosts, chips_per_host), device)
    if mesh.world != n_hosts:
        raise ValueError(f"a {n_hosts}x{chips_per_host} mesh needs {n_hosts} ranks, one per "
                         f"host; the process group has {mesh.world}")
    return mesh


def landmark_axes(mesh: Mesh):
    """The axis name (1-D mesh) or the tuple of names (2-D mesh) the
    landmark dimension shards over."""
    names = tuple(mesh.axis_names)
    return names if len(names) > 1 else names[0]


def reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` [local, ...] (one entry per shard this rank holds) over the
    whole mesh: over the rank's shards in order, then one all_reduce over
    the ranks.  Counts its all_reduce calls and the bytes they reduce
    (`reduce_sum.calls`, `reduce_sum.bytes`)."""
    out = t.sum(0)
    dist.all_reduce(out, group=mesh.group)
    reduce_sum.calls += 1
    reduce_sum.bytes += out.numel() * out.element_size()
    return out


reduce_sum.calls = 0
reduce_sum.bytes = 0
