"""Entry points of the port: one device step and the multi-device
dry run.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX package's
entry points). ``entry()`` returns the flagship device step, batched
SHA-256 two-to-one compression (the Merkleization inner loop), with
example rows on the default device.

``dryrun_multichip(n, device=None)`` runs the distributed device step
over n ranks started with `torch.multiprocessing` (spawn): Merkle leaves
sharded over the ranks, each rank's subtree root on its device (K10), the
roots all-gathered, the top folded on every rank, checked against
hashlib; then the sharded RLC G1 sum (K11), checked against the host
bigint oracle. On `cuda` each rank takes a card of its own (NCCL) and the
run raises, starting no rank, with fewer than n visible cards; the JAX
version re-runs itself on virtual CPU devices, the port's counterpart is
the caller asking for ``device="cpu"`` (gloo ranks). Nothing drops from
the card to the CPU on its own.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .ops.cuda_build import BUILD_DIR

# Leaves each rank hashes in the dry run (the JAX dry run's size).
PER_RANK_LEAVES = 8


def entry():
    """(fn, example_args): the flagship device step and its inputs."""
    from .ops.sha256 import sha256_pairs

    # 2048 64-byte messages = one gossip-batch-scale Merkle level: the JAX
    # entry's big-endian words 0..32767, as raw bytes
    words = np.arange(2048 * 16, dtype=">u4").view(np.uint8).reshape(2048, 64)
    return sha256_pairs, (torch.from_numpy(words.copy()).to(resolve_device(None)),)


def _dryrun_impl(mesh) -> None:
    """The distributed step on this rank of `mesh`; raises on a mismatch."""
    from .ops.bls381_sharded import dryrun_sharded_bls
    from .ops.merkle_sharded import build_sharded_merkle
    from .parallel.mesh import shard_batch

    step = build_sharded_merkle(mesh.size, PER_RANK_LEAVES, mesh.device)
    n_leaves = mesh.size * PER_RANK_LEAVES
    rng = np.random.default_rng(42)
    leaves = rng.integers(0, 256, size=(n_leaves, 32), dtype=np.uint8)
    root = step(shard_batch(torch.from_numpy(leaves), mesh), mesh).cpu().numpy().tobytes()

    nodes = [row.tobytes() for row in leaves]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest() for i in range(0, len(nodes), 2)]
    if root != nodes[0]:
        raise RuntimeError("multi-rank Merkle root mismatch vs host")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): sharded Merkle root OK ({root.hex()[:16]}…)", flush=True)

    dryrun_sharded_bls(mesh)
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): sharded BLS batch step OK", flush=True)


def _rank_main(rank: int, target, n_ranks: int, rendezvous: str, device: str, args: tuple) -> None:
    from .parallel.mesh import batch_mesh, close_mesh

    if device == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    mesh = batch_mesh(rank, n_ranks, rendezvous, device)
    try:
        target(mesh, *args)
    finally:
        close_mesh(mesh)


def run_ranks(target, n_ranks: int, device=None, args: tuple = (), timeout: float = 900.0) -> None:
    """Spawn `n_ranks` rank processes on `device` ("cuda": one card each,
    NCCL; "cpu": gloo), joined at a file store under the build directory;
    each calls ``target(mesh, *args)`` (a module-level function). Raises
    if a rank fails or the run outlasts `timeout` seconds, its ranks then
    stopped; with `cuda` and fewer than `n_ranks` cards it raises before
    starting any."""
    dev = resolve_device(device)
    if n_ranks < 1:
        raise ValueError(f"rank count {n_ranks} < 1")
    if dev.type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"{n_ranks} ranks on cuda need {n_ranks} cards, {torch.cuda.device_count()} visible")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="rendezvous-", dir=BUILD_DIR) as d:
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(target, n_ranks, os.path.join(d, "store"), dev.type, args),
            nprocs=n_ranks,
            join=False,
            start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n_ranks} ranks did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(30)


def dryrun_multichip(n_ranks: int, device=None, timeout: float = 900.0) -> None:
    """Run the sharded device step over `n_ranks` spawned rank processes on
    `device` (see `run_ranks`); raises on a mismatch, a failed rank or a
    timeout."""
    run_ranks(_dryrun_impl, n_ranks, device, timeout=timeout)
