"""The sharded Merkle root (K10): the multi-device step of Merkleization.

Counterpart of lighthouse_tpu/ops/merkle_sharded.py. The leaf array is
split over the ranks of a process group (`parallel.mesh`); each rank
reduces its shard to one subtree root, the roots are all-gathered (NCCL
on cards, gloo on the CPU), and every rank folds the small top of the
tree itself, so each returns the same root.

Kernel: ``csrc/merkle_subtree.cu`` replaces ``_sha256_pairs_inline`` and
``_reduce_to_root`` (:24, :34): one launch reduces every run of 2^k
sibling nodes (k <= 9) to their subtree root, the upper levels kept in
shared memory, and a shard takes as many launches as its depth needs in
steps of 9. Its compression is K1's (``csrc/sha256.cuh``). It is bound by
32-bit integer instruction rate, as K1 is. Layout: raw bytes, a node a [32] uint8
row, as ``ops/sha256.py``.

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel, a
CPU tensor to the plain version (``merkle_subtree_roots_plain``, K1's
plain SHA-256 level by level). A failed build or launch raises.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_gather_rows
from .cuda_build import CudaLibrary
from .sha256 import sha256_rows_plain

# Levels one launch reduces: 2^(MAX_LEVELS - 1) = 256 threads a block.
MAX_LEVELS = 9

LIB = CudaLibrary("merkle_subtree.cu", {"merkle_subtree_roots": ("p", "p", "i64", "i32", "p")})

# Kernel launches, counted where the kernel launches and nowhere else.
COUNTS = {"merkle_subtree_roots": 0}


def reset_counts() -> None:
    COUNTS["merkle_subtree_roots"] = 0


def _check_nodes(nodes: torch.Tensor, levels: int) -> None:
    if nodes.dtype != torch.uint8 or nodes.dim() != 2 or nodes.shape[1] != 32:
        raise ValueError(f"nodes: expected [m, 32] uint8, got {list(nodes.shape)} {nodes.dtype}")
    if not nodes.is_contiguous():
        raise ValueError("nodes: tensor must be contiguous")
    if levels < 1:
        raise ValueError(f"levels {levels} < 1")
    if nodes.shape[0] % (1 << levels):
        raise ValueError(f"{nodes.shape[0]} nodes are not runs of 2^{levels}")


def merkle_subtree_roots_plain(nodes: torch.Tensor, levels: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `levels` Merkle levels of
    two-to-one SHA-256 (any number of them), on the nodes' own device."""
    _check_nodes(nodes, levels)
    for _ in range(levels):
        nodes = sha256_rows_plain(nodes.reshape(-1, 64))
    return nodes


def merkle_subtree_roots(nodes: torch.Tensor, levels: int) -> torch.Tensor:
    """[m, 32] uint8 nodes -> [m >> levels, 32] roots of their runs of
    2^levels siblings (1 <= levels <= 9), in one launch on a CUDA tensor."""
    _check_nodes(nodes, levels)
    if levels > MAX_LEVELS:
        raise ValueError(f"levels {levels} above {MAX_LEVELS}: one launch reduces at most 2^{MAX_LEVELS} nodes")
    if nodes.device.type == "cpu":
        return merkle_subtree_roots_plain(nodes, levels)
    if nodes.device.type != "cuda":
        raise ValueError(f"nodes on {nodes.device}: need a CUDA or CPU tensor")
    if nodes.data_ptr() % 16:
        raise ValueError("nodes must be 16-byte aligned")
    m = nodes.shape[0]
    out = torch.empty((m >> levels, 32), dtype=torch.uint8, device=nodes.device)
    LIB.launch("merkle_subtree_roots", nodes.data_ptr(), out.data_ptr(), m, levels, device=nodes.device)
    COUNTS["merkle_subtree_roots"] += 1
    return out


def subtree_root(nodes: torch.Tensor) -> torch.Tensor:
    """[2^d, 32] nodes -> [1, 32] their Merkle root, MAX_LEVELS levels a
    launch (one node is its own root)."""
    m = nodes.shape[0]
    if m < 1 or m & (m - 1):
        raise ValueError(f"node count {m} is not a power of two")
    depth = (m - 1).bit_length()
    while depth:
        levels = min(depth, MAX_LEVELS)
        nodes = merkle_subtree_roots(nodes, levels)
        depth -= levels
    return nodes


def sharded_merkle_root(leaves: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of leaves [2^k, 32] uint8 (rank order is leaf
    order; the rank count a power of two) -> the [32] root of all ranks'
    leaves, the same on every rank. The JAX function's `per_device`."""
    if mesh.size & (mesh.size - 1):
        raise ValueError(f"{mesh.size} ranks: need a power of two")
    return subtree_root(all_gather_rows(subtree_root(leaves), mesh))[0]


def build_sharded_merkle(n_ranks: int, per_rank_leaves: int, device):
    """The sharded root step for `n_ranks` ranks of `per_rank_leaves`
    leaves each (both powers of two) on `device`: a function
    ``step(leaves, mesh) -> [32] root`` that refuses a shard or a mesh of
    another shape."""
    if per_rank_leaves < 1 or per_rank_leaves & (per_rank_leaves - 1):
        raise ValueError(f"per-rank leaves {per_rank_leaves} is not a power of two")
    if n_ranks < 1 or n_ranks & (n_ranks - 1):
        raise ValueError(f"rank count {n_ranks} is not a power of two")
    device = torch.device(device)

    def step(leaves: torch.Tensor, mesh) -> torch.Tensor:
        if mesh.size != n_ranks or mesh.device.type != device.type:
            raise ValueError(f"mesh of {mesh.size} on {mesh.device}: built for {n_ranks} on {device}")
        if tuple(leaves.shape) != (per_rank_leaves, 32) or leaves.device != mesh.device:
            raise ValueError(f"shard {list(leaves.shape)} on {leaves.device}: need [{per_rank_leaves}, 32] on {mesh.device}")
        return sharded_merkle_root(leaves, mesh)

    return step
