"""Mesh placement/fetch primitives shared by the sharded paths.

Port of cartographer_tpu/parallel/partition.py onto torch.distributed.
Kept free of any cartographer_tpu_torch.ops imports so that the ops
modules (the batched BnB searches, the SPA solvers) can use these helpers
without an import cycle through parallel.sharded.

The JAX package runs its sharded workloads as SPMD programs over a
jax.sharding.Mesh of N devices and lets XLA insert the collectives. The
torch convention is one process per device, so a mesh here is this
process's view of a process group: the group, this process's rank, the
number of ranks and this rank's device. JAX's N local devices in one
process become N ranks. Every rank holds the same host state (the pose
graph is replicated host state driven by identical inputs) and runs the
same program; a table sharded over the mesh gives rank r the rows
[r n // W, (r + 1) n // W) of its n rows, pose vectors and grids stay
replicated. Only pose-space sums and packed result rows cross ranks,
through one collective, all_reduce(SUM). Uneven shards
therefore need no padding rows (the JAX package pads its sharded tables
to a multiple of the mesh). A rank's result rows are gathered with an
all_reduce of a zero-filled buffer in which each rank wrote only its own
rows: adding 0 changes no finite value, so the gather is exact.

Each all-reduced quantity is the same on every rank, so every host
decision taken from it matches and every rank issues its collectives in
the same order. A one-rank mesh without a process group (no
torch.distributed initialised) issues no collective at all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from cartographer_tpu_torch.device import resolve_device

WORKER_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh. `collectives` counts the collectives
    this rank issued, by the device type of their tensors."""

    group: Optional[object]  # torch.distributed ProcessGroup; None: one rank
    rank: int
    world_size: int
    device: torch.device
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=dict, compare=False
    )


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a table lives on a mesh: row-split over the ranks, or
    replicated on every rank."""

    mesh: Mesh
    split: bool


def rank_device(rank: int, device=None) -> torch.device:
    """`device=None` means this rank's card, cuda:{rank % device count};
    raises without CUDA (the port never falls back to the CPU)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


def same_device(a, b) -> bool:
    """Whether two devices name the same one ("cuda" is the current card)."""
    a, b = torch.device(a), torch.device(b)

    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index

    return a.type == b.type and index(a) == index(b)


def mesh_device(device, mesh: Optional[Mesh]) -> torch.device:
    """The device of a module built on `mesh`: `device`, or the mesh's
    when `device` is None. A device other than the mesh's raises."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh.device if device is None else resolve_device(device)
    if not same_device(dev, mesh.device):
        raise ValueError(
            f"device {dev} differs from the mesh's device {mesh.device}"
        )
    return dev


def make_mesh(n_devices=None, devices=None) -> Mesh:
    """This process's mesh over the default process group: one device per
    rank. Without an initialised group it is a one-rank mesh. `devices`
    lists one device per rank (default: rank_device). Asking for more
    ranks than the group has raises; so does asking for fewer, since a
    mesh spans the whole group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"asked for a mesh of {n_devices} ranks; the process group has "
            f"{world} (one device per rank)"
        )
    if devices is None:
        device = rank_device(rank)
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = resolve_device(devices[rank])
    return Mesh(group, rank, world, device)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading axis split over the ranks."""
    return Sharding(mesh, True)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def row_range(n: int, mesh: Optional[Mesh]):
    """Rank r's rows [r n // W, (r + 1) n // W) of an n-row table."""
    if mesh is None:
        return 0, n
    return mesh.rank * n // mesh.world_size, (mesh.rank + 1) * n // mesh.world_size


def pad_to_mesh(n: int, mesh, minimum: int = 8) -> int:
    """Smallest power-of-two >= max(n, minimum, mesh size). Power-of-two
    meshes always divide the result. The row split needs no padding; this
    stays for callers that want power-of-two table sizes."""
    size = 1 if mesh is None else mesh.world_size
    v = max(minimum, 1)
    target = max(n, size, 1)
    while v < target:
        v *= 2
    return v


def all_reduce(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `tensor` in place over the mesh and return it. The tensor must
    lie on the mesh's device: nothing is moved to make a collective work."""
    if mesh.group is None:
        return tensor
    import torch.distributed as dist

    if not same_device(tensor.device, mesh.device):
        raise ValueError(
            f"collective on {tensor.device}, mesh device {mesh.device}"
        )
    kind = tensor.device.type
    mesh.collectives[kind] = mesh.collectives.get(kind, 0) + 1
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor


def put(array, sharding: Sharding) -> torch.Tensor:
    """Place an array (numpy or a tensor) on the mesh's device: this rank's
    rows when split, the whole array when replicated."""
    t = torch.as_tensor(array)
    if sharding.split:
        lo, hi = row_range(t.shape[0], sharding.mesh)
        t = t[lo:hi]
    return t.to(sharding.mesh.device)


def gather_rows(local: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The n-row table whose rank shares (row_range) are `local` on each
    rank, on every rank: an all_reduce of a zero-filled buffer in which
    this rank wrote only its rows (exact)."""
    local = torch.as_tensor(local).to(mesh.device)
    lo, hi = row_range(n, mesh)
    if local.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} holds {local.shape[0]} rows, not {hi - lo}")
    if mesh.group is None:
        return local
    out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype, device=mesh.device)
    out[lo:hi] = local
    return all_reduce(out, mesh)


def fetch(local, mesh: Optional[Mesh] = None, n: Optional[int] = None) -> np.ndarray:
    """Bring a table to the host: with a mesh, `local` is this rank's
    share of an n-row table and the result is the whole table."""
    if mesh is not None:
        local = gather_rows(local, mesh, n)
    return torch.as_tensor(local).cpu().numpy()


def shard_namedtuple(mesh: Mesh, value, sharded_fields):
    """Split the named fields of a NamedTuple of tables on their leading
    axis; replicate the rest (pose tables, flags, scalars)."""
    cand = batch_sharding(mesh)
    rep = replicated_sharding(mesh)
    return type(value)(
        **{
            f: put(getattr(value, f), cand if f in sharded_fields else rep)
            for f in value._fields
        }
    )
