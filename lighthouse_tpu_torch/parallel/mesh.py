"""The rank process group: the port's device mesh.

Counterpart of lighthouse_tpu/parallel/mesh.py. The JAX package lays one
`batch` mesh axis over all chips of one process and splits arrays along it
with shardings; the port runs one process per rank, each on its own
device, joined by a `torch.distributed` process group: NCCL when the
device is `cuda` (one card per rank, ``cuda:<rank>``), gloo when the
caller asks for `cpu`. A `cuda` group with no card, or fewer cards than
ranks, raises: nothing falls back to a CPU group.

The group meets at an explicit rendezvous the caller gives: a
``tcp://host:port`` address, or the path of a `FileStore` file (no port
to clash with when several groups start at once, as under pytest-xdist).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the group: the group, this rank, the number of
    ranks and the device this rank computes on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device


def batch_mesh(rank: int, world_size: int, rendezvous: str, device=None) -> Mesh:
    """Join the process group as `rank` of `world_size` and return its mesh.

    `device` is "cuda" or "cpu" (default: the port's default device);
    `rendezvous` a ``tcp://`` address or a file-store path shared by all
    ranks."""
    dev = resolve_device(device)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a group of {world_size}")
    if dev.type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(
                f"rank {rank} needs card cuda:{rank}, but {torch.cuda.device_count()} are visible"
            )
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if rendezvous.startswith("tcp://"):
        dist.init_process_group(backend, init_method=rendezvous, rank=rank, world_size=world_size)
    else:
        store = dist.FileStore(rendezvous, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return Mesh(dist.group.WORLD, rank, world_size, dev)


def close_mesh(mesh: Mesh) -> None:
    """Leave the group (every rank calls it, after its last collective)."""
    dist.destroy_process_group(mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[1, ...] this rank's row -> [ranks, ...] every rank's, in rank order
    (the collective: NCCL on cards, gloo on the CPU)."""
    out = torch.empty((mesh.size, *x.shape[1:]), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; the card's torch has this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of the leading dimension, on its device
    (the dimension must divide evenly: see `pad_to_multiple`)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    per = n // mesh.size
    return x[mesh.rank * per : (mesh.rank + 1) * per].to(mesh.device)


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor on every rank: rank 0's copy, broadcast."""
    out = x.to(mesh.device).contiguous().clone()
    dist.broadcast(out, src=0, group=mesh.group)
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def bucket_size(n: int, minimum: int = 16) -> int:
    """Round a dynamic batch size up to a power-of-two bucket so jit caches a
    small number of compiled shapes (reference batches gossip work in fixed
    chunks of 64 for the same reason, beacon_processor/src/lib.rs:200)."""
    size = minimum
    while size < n:
        size *= 2
    return size
