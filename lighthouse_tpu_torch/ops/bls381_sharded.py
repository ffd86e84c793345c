"""The sharded RLC G1 sum (K11): the multi-device half of batch signature
verification.

Counterpart of lighthouse_tpu/ops/bls381_sharded.py. The signature-set
batch is split over the ranks of a process group (`parallel.mesh`): each
rank runs the 64-bit random-linear-combination ladders for its shard of
G1 points (the per-set aggregate pubkeys) and tree-sums them to one
partial sum; the partial sums are all-gathered (NCCL on cards, gloo on
the CPU), and every rank folds the [ranks] tail itself, so each returns
the same Σ rᵢ·Pᵢ.

Kernels: none of its own. It composes the port's hand-written K2 kernels
of ``csrc/bls381_g.cu``: ``scalar_mul("g1", ...)`` (the ladders,
``bls_g1_scalar_mul``) and ``segment_sum("g1", ...)`` (the tree sums,
``bls_g1_segment_sum``, once over the shard padded with infinities to a
power of two and once for the fold), each of which counts its own
launches in ``ops/bls381.COUNTS``. On a CPU tensor they run their plain
versions. Point addition is not an arithmetic reduction, so the
collective is an all-gather of [ranks, 3, 12] limbs, not an all-reduce.

The tree pairs neighbours (ops/bls381.segment_sum), where JAX's
``_tree_reduce_points`` carries an odd count's last point up: the
Jacobian coordinates differ, the affine points do not. Compare in affine.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_gather_rows, shard_batch
from .bls381 import scalar_mul, scalar_mul_plain, segment_sum, segment_sum_plain, tree_row


def local_sum(pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[n, 3, 12] G1 points, [n] 64-bit scalars (int64 bit patterns) ->
    [1, 3, 12] Σ kᵢ·Pᵢ over this shard."""
    return segment_sum("g1", tree_row(scalar_mul("g1", pts, k)))


def local_sum_plain(pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return segment_sum_plain("g1", tree_row(scalar_mul_plain("g1", pts, k)))


def fold(parts: torch.Tensor) -> torch.Tensor:
    """[ranks, 3, 12] partial sums -> [3, 12] their sum."""
    return segment_sum("g1", tree_row(parts))[0]


def fold_plain(parts: torch.Tensor) -> torch.Tensor:
    return segment_sum_plain("g1", tree_row(parts))[0]


def sharded_rlc_g1(pts: torch.Tensor, k: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of G1 points [n, 3, 12] and 64-bit scalars [n]
    (rank order is batch order) -> the [3, 12] Jacobian Σ rᵢ·Pᵢ over all
    ranks' shards, the same on every rank. The JAX function's
    `per_device`."""
    return fold(all_gather_rows(local_sum(pts, k), mesh))


def build_sharded_bls(n_ranks: int, device):
    """The sharded RLC step for `n_ranks` ranks on `device`: a function
    ``step(pts, k, mesh) -> [3, 12]`` that refuses a mesh of another
    shape."""
    if n_ranks < 1:
        raise ValueError(f"rank count {n_ranks} < 1")
    device = torch.device(device)

    def step(pts: torch.Tensor, k: torch.Tensor, mesh) -> torch.Tensor:
        if mesh.size != n_ranks or mesh.device.type != device.type:
            raise ValueError(f"mesh of {mesh.size} on {mesh.device}: built for {n_ranks} on {device}")
        return sharded_rlc_g1(pts, k, mesh)

    return step


def dryrun_sharded_bls(mesh) -> None:
    """One small sharded RLC step on `mesh` (one point per rank), held to
    the host bigint oracle. Raises on a mismatch."""
    import random

    from ..crypto.bls12_381 import FQ, G1_GEN, inf, pt_eq, pt_mul
    from ..crypto.bls12_381 import pt_add as host_pt_add
    from .bls381 import g1_from_limbs, g1_to_limbs, scalars_to_tensor

    n = mesh.size  # one point per rank: the smallest real shard
    rng = random.Random(1234)
    pts = [pt_mul(FQ, G1_GEN, rng.randrange(1, 1 << 30)) for _ in range(n)]
    scalars = [rng.getrandbits(64) for _ in range(n)]

    fn = build_sharded_bls(n, mesh.device)
    xs = shard_batch(torch.from_numpy(g1_to_limbs(pts)), mesh)
    ks = shard_batch(scalars_to_tensor(scalars), mesh)
    got = g1_from_limbs(fn(xs, ks, mesh).cpu().numpy())[0]

    want = inf(FQ)
    for p, s in zip(pts, scalars):
        want = host_pt_add(FQ, want, pt_mul(FQ, p, s))
    if not pt_eq(FQ, got, want):
        raise RuntimeError("sharded RLC G1 sum mismatch vs host")
