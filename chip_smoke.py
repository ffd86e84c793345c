#!/usr/bin/env python3
"""Drive lighthouse_tpu_torch's main paths on one NVIDIA GPU and hold every
kernel of those paths to its plain PyTorch version.

    python3 chip_smoke.py [--seed S]

Run from the repository root on a machine with a CUDA card; it builds the
kernels from ``lighthouse_tpu_torch/csrc`` itself. Phases, one JSON line
each, any failure ends the run with a non-zero exit code:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, device count;
2. build: every kernel source at once (one nvcc each, in parallel), with
   seconds, registers and spills of each kernel;
3. kernel checks: the SHA-256 kernel byte-equal to its plain version on the
   card and to hashlib; then each BLS kernel (G1/G2 ladders, segment sums
   and affine conversion, the G2 subgroup check, the multi-pairing,
   hash-to-G2 with edge lanes: u = 0, a non-square g(x1), u1 = u0) equal
   to its plain version at the BLS main path's shapes, the G2 ladder on
   affine points as the verifier stages them, on Jacobian ones and at the
   edge scalars 0, 1, 2, 2^63 and 2^64 - 1; the segment sums also on
   rows of pt_add's cases (bls_segment_rows), the verifier's [3, 512]
   chunk, a G2 row padded as the verifier pads it and K11's [1, 4096];
   the affine conversions also
   over three blocks with infinity lanes and at 4,096 lanes;
   each with its time, the plain version's time and its bound; the
   epoch-sweep kernel (one cooperative launch) and the two-kernel sweep it
   replaced, each equal to its plain version at 2^20 validators, in and
   out of the inactivity leak, with edge rows, and at 3.5 M (past the
   shared-memory keep), timed in turns in the same call, with the
   wrapper's copies split into uploads, kernel and downloads; and, on the mainnet
   KZG ceremony's setup, the KZG kernels: the barycentric evaluation at
   [1, 4096], [6, 4096] (also with one z on the domain) and [192, 4096],
   the opening quotient at 4096 lanes (z off
   the domain and on it) and the G1 Pippenger MSM over the 4096 setup
   points with edge cases, each equal to its plain version and, for one
   case, to the host; then the multi-device step's kernels: the Merkle
   subtree reduction at 2^20 leaves (one launch; the kernel it replaced,
   three launches, each timed apart) and at 8 roots, K11's 64-bit chain
   at 1, 37 and 4,096 lanes (scalars 0, 2^63 and 2^64 - 1 among them;
   K2's thread layout timed on the same 4,096 lanes) and the 256-bit G1
   ladder at 1, 37 and 4096 points (scalars 0, 1 and r - 1 among them),
   each equal to its plain version and to the host;
4. main path: the state-root stage of block import. A mainnet-preset Deneb
   BeaconState with 1,000,000 validators is built from ``--seed``,
   given the tree-states representation, and rooted cold through
   ``BeaconState.hash_tree_root()``; then 8 block-sized
   mutations are each re-rooted incrementally. The cold root must equal a
   root folded without the kernel through the host hash lanes, and each
   incremental root the root of the same state with a fresh cache;
5. BLS main path: one mainnet Deneb block's signature sets over that
   registry (proposal, RANDAO, 128 attestations of about 488 signers, the
   sync aggregate: 131 sets, about 63,000 pubkeys) verified five times
   through ``crypto.bls.verify_signature_sets`` under the ``cuda`` backend,
   each time with the signatures decompressed anew (pubkeys cached);
   verdicts on the block, on four altered batches and on a 64-set gossip
   batch equal to the port's host backend's; each chunk's H(m), sum r_i
   sig_i and per-message sum r_i aggpk_i equal to the host oracle's;
6. transition main path: that state made the pre-state of an epoch
   boundary (``epoch_prestate``), then block import across it, as a node
   runs it: ``per_slot_processing`` (the epoch transition, its sweep on the
   epoch-sweep kernel), ``per_block_processing`` of a full, really signed
   Deneb block (128 attestations of the real committees, the sync
   aggregate, an execution payload with withdrawals, six blob
   commitments made on the card) under VERIFY_BULK on the ``cuda``
   backend, and ``hash_tree_root()``; three times, each from a copy of the
   pre-state. The sweep's balances and scores must equal the numpy
   sweep's, the post-block root the host-lane fold, the block must be
   accepted and a copy with one wrong attestation signature refused;
7. blob main path: that block's six blobs through the port's ``Kzg`` on
   the ceremony setup and its ``DataAvailabilityChecker``: (a) commitments
   and blob proofs (one commitment equal to the host MSM's); (b) the blob
   sidecars, ``put_block`` then ``put_blobs`` available, the DA verify of
   the six timed (median of 5), a sidecar with a flipped proof byte
   refused; (c) a range-sync segment of 32 blocks of six blobs made on the
   card and verified as one batch (median of 3), a tampered proof refused;
   (d) the block's 128 data columns with their 768 cell proofs, 64 of them
   put, reconstructed and available;
8. the multi-device step on a process group of one rank (NCCL; one card):
   (a) the sharded Merkle root of the registry's 1,000,000 validator roots
   (zero-padded to 2^20 leaves, then hashed up to the list's limit with
   its length mixed in), equal to the state's own validators root and a
   hashlib fold; (b) the sharded RLC sum of 4,096 seeded G1 points (a
   range-sync segment's 32 blocks of 128 attestation sets) with 64-bit
   scalars (K11's 64-bit chain, then K2's segment sums), equal to its
   plain version and, on 131 points, to the host;
   (c) the ladder MSM of one seeded blob over the ceremony's 4,096
   Lagrange points, equal to K9 Pippenger's commitment and the plain
   ladder; (d) ``entry.dryrun_multichip(1, device="cuda")``.

Then one JSON line with every kernel's numbers, the card's nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
from lighthouse_tpu_torch.ops import bls381 as k_g
from lighthouse_tpu_torch.ops import bls381_htc as k_htc
from lighthouse_tpu_torch.ops import bls381_pairing as k_pair
from lighthouse_tpu_torch.ops import epoch_sweep as k7
from lighthouse_tpu_torch.ops import fr as k_fr
from lighthouse_tpu_torch.ops import merkle_sharded as k_ms
from lighthouse_tpu_torch.ops import msm as k_msm
from lighthouse_tpu_torch.ops import sha256 as k_sha256
from lighthouse_tpu_torch.ops.cuda_build import ptxas_usage
from lighthouse_tpu_torch.parallel import host_pool
from lighthouse_tpu_torch.ssz.merkle import mix_in_length, next_pow_of_two
from lighthouse_tpu_torch.types import MainnetEthSpec, build_types
from lighthouse_tpu_torch.utils.hash import ZERO_HASHES
from lighthouse_tpu_torch.utils.sha256_batch import hash_rows_hashlib

# H100 SXM memory rate (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
# The card issues at most one warp instruction (32 lanes) per clock on
# each of an SM's four schedulers: 128 32-bit operations per clock per SM,
# 132 SMs at the 1.98 GHz boost clock. No 32-bit integer instruction
# stream can go faster.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# The least 32-bit operations SHA-256 of one 64-byte message needs,
# whatever the code (derived in csrc/sha256.cu's header comment).
SHA256_MIN_OPS = 2300
# 32-bit integer multiply results per second: 64 per clock per SM for
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput: 32-bit integer multiply and multiply-add), 132
# SMs at the 1.98 GHz boost clock.
INT32_MUL_PER_S = 132 * 64 * 1.98e9
# The least 32-bit multiplies of one 12-limb Montgomery multiplication
# (CIOS, csrc/bls381_field.cuh): 144 limb products of a*b and 144 of m*p,
# each a low and a high half, and 12 low halves m = t0 * n'.
BLS_FQ_MUL_MIN_OPS = 2 * 144 + 2 * 144 + 12
# Least Fq multiplications of each operation, counted from the cheapest
# known way to compute it, not from the way the kernels compute it
# (derivations in the headers of csrc/bls381_{g,pairing,htc}.cu). An Fq2
# product is 3 Fq products, an Fq2 square 2; a power to a fixed exponent e
# is counted at the floor of any addition chain for e, ceil(log2 e) steps.
BLS_FQ_MULS = {
    "g1_dbl": 7,  # 2M + 5S (a = 0)
    "g1_mdbl": 6,  # 1M + 5S, an affine input
    "g1_add": 16,  # 11M + 5S
    "g1_madd": 11,  # 7M + 4S, an affine addend
    "g1_aadd": 6,  # 4M + 2S, both affine (Z1 = Z2 = 1)
    # affine + affine with Montgomery's batch inversion: the slope, its
    # square and y3 (2M + 1S), 3 products per element of the shared
    # inversion; plus one fq_inv per batch
    "g1_affine_add": 6,
    "g2_dbl": 16,
    "g2_mdbl": 13,  # 1M + 5S, an affine input
    "g2_add": 43,
    "g2_madd": 29,  # 7M + 4S, an affine addend
    "g2_aadd": 16,  # 4M + 2S, both affine
    # a^(p-2), Fermat's chain: K9 fixed-base's bound counts its shared
    # inversions so; the conversions to affine and K9's table count the
    # binary inversion's own work (_binary_inv_ops)
    "fq_inv": 381,
    "subgroup_check": 1166,  # per point
    "miller_steps": 1780,  # per pair: 63 doubling steps (25), 5 addition steps (41)
    "line": 39,  # a sparse line product, 13 Fq2 products
    "miller_sqr": 62 * 36,  # f^2 once per step, shared by all pairs
    "final_exp": 7182,
    "hash_to_g2": 4403,  # per message
}
# The least 32-bit multiplies of one 8-limb Fr Montgomery multiplication
# (csrc/fr.cuh): 64 limb products of a*b and 64 of m*r, each a low and a
# high half, and 8 low halves m = t0 * n'.
FR_MUL_MIN_OPS = 8 * 8 * 2 * 2 + 8
# Least Fr multiplications of the KZG functions (derived in
# csrc/kzg_fr.cu's header), with Montgomery's batch inversion: 3 products
# per inverted element and one inversion per batch, at the floor of any
# addition chain for r - 2. The barycentric sum is z S1 - S0 with S1 =
# sum p_i / (z - w_i) a fraction tree: a blob of n terms costs 3n - 3
# (n - 1 fraction adds of 3; S0 takes additions only).
FR_MULS = {
    "inv": 255,
    "batch_inv": 3,  # per element
    "bary_term": 3,  # a fraction add; 3 fewer per blob
    "bary_blob": 16,  # z^n (12 squarings) and (z N D^-1 - S0) (z^n - 1) n^-1, per blob
    "quotient_term": 1,  # (p_i - y) * inv
}


def bary_fr_muls(m: int, n: int) -> int:
    """The least Fr multiplications of m barycentric evaluations of n
    points: the fraction trees, each blob's finish, the batch inversion of
    the m denominators."""
    return (FR_MULS["bary_term"] * n - 3 + FR_MULS["bary_blob"] + FR_MULS["batch_inv"]) * m + FR_MULS["inv"]

# The epoch sweep (derived in csrc/epoch_sweep.cu's header): the bytes a
# validator moves (six u64 columns, the slashed and participation bytes
# in; the new balance and score out) and the least 32-bit operations it
# needs.
EPOCH_SWEEP_BYTES = 6 * 8 + 1 + 1 + 2 * 8
EPOCH_SWEEP_MIN_OPS = 160
# The bytes a validator moves to and from device memory in each design:
# the cooperative kernel's while its tiles fit in shared memory (the
# bound's), and the replaced two-kernel sweep's, whose second kernel reads
# the five columns of the sums again (26 bytes).
EPOCH_SWEEP_DESIGN_BYTES = {"cooperative": EPOCH_SWEEP_BYTES, "two_pass": EPOCH_SWEEP_BYTES + 26}
# Validators above what the cards' shared memory keeps (~3.3 M on 132 SMs).
EPOCH_SWEEP_ABOVE_KEEP = 3_500_000
# The cooperative launch's shapes timed beside the wrapper's: (threads a
# block, blocks an SM).
EPOCH_SWEEP_SHAPES = ((1024, 1), (512, 2), (256, 4))

# The main path's size: a mainnet registry and a run of block imports.
N_VALIDATORS = 1_000_000
UPDATES = 8
# Timed state transitions (epoch boundary + block + root) in phase 6.
TRANSITION_REPS = 3
# Blob availability in phase 7: a mainnet Deneb block's blobs
# (MAX_BLOBS_PER_BLOCK), their gas, a range-sync segment of 32 blocks of
# six blobs, the columns staged for reconstruction (half of 128), and the
# timed repetitions of the block's DA verify and of the segment's batch.
BLOBS_PER_BLOCK = 6
BLOB_GAS_PER_BLOB = 2**17
SEGMENT_BLOCKS = 32
COLUMNS_KEPT = 64
DA_REPS = 5
SEGMENT_REPS = 3
# The multi-device step in phase 8, on one rank: the registry's validator
# roots padded to a power of two of leaves (the list's limit, 2^40, above
# them), a range-sync segment's attestation sets (32 blocks of 128) for
# the RLC sum, its first block's sets checked on the host, and the timed
# repetitions of each step.
SHARDED_LEAVES = 1 << 20
RLC_POINTS = SEGMENT_BLOCKS * 128
RLC_HOST_POINTS = 131
SHARDED_REPS = 5
# The mainnet KZG ceremony's setup: the port's packaged trusted_setup.json.
CEREMONY_SETUP = TrustedSetup.CEREMONY_SEARCH_PATHS[0]

FAR_FUTURE_EPOCH = 2**64 - 1


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# The seeded state and the block-sized update (also used by the CPU tests,
# which build the same state through the JAX package)
# ---------------------------------------------------------------------------


def build_deneb_state(types, E, n: int, seed: int):
    """A Deneb BeaconState of preset `E` with `n` validators, every field
    made from `seed` with numpy. `types` is a `build_types(E)` namespace of
    either package, so the same state can be built in both."""
    rng = np.random.default_rng(seed)
    T = types.types_for_fork("deneb")

    def roots(k: int) -> list[bytes]:
        buf = rng.bytes(32 * k)
        return [buf[32 * i : 32 * i + 32] for i in range(k)]

    def u64(k: int, lo: int, hi: int) -> list[int]:
        return rng.integers(lo, hi, k, dtype=np.uint64).tolist()

    pub = rng.bytes(48 * n)
    wc = rng.bytes(32 * n)
    eb = (rng.integers(16, 33, n) * 10**9).tolist()
    slashed = (rng.random(n) < 0.001).tolist()
    elig = u64(n, 0, 200_000)
    act = [e + 1 for e in elig]
    exited = rng.random(n) < 0.01
    exit_ep = [
        int(a) + 1000 if x else FAR_FUTURE_EPOCH
        for a, x in zip(act, exited.tolist())
    ]
    wd_ep = [e + 256 if e != FAR_FUTURE_EPOCH else e for e in exit_ep]
    V = types.Validator
    validators = [
        V(
            pubkey=pub[48 * i : 48 * i + 48],
            withdrawal_credentials=wc[32 * i : 32 * i + 32],
            effective_balance=eb[i],
            slashed=slashed[i],
            activation_eligibility_epoch=elig[i],
            activation_epoch=act[i],
            exit_epoch=exit_ep[i],
            withdrawable_epoch=wd_ep[i],
        )
        for i in range(n)
    ]
    balances = [b + d for b, d in zip(eb, u64(n, 0, 10**9))]

    def sync_committee():
        idx = rng.integers(0, n, E.SYNC_COMMITTEE_SIZE).tolist()
        return types.SyncCommittee(
            pubkeys=[pub[48 * i : 48 * i + 48] for i in idx],
            aggregate_pubkey=rng.bytes(48),
        )

    slot = 300_000 * E.SLOTS_PER_EPOCH + int(rng.integers(0, E.SLOTS_PER_EPOCH))
    header = T.ExecutionPayloadHeader(
        parent_hash=rng.bytes(32),
        fee_recipient=rng.bytes(20),
        state_root=rng.bytes(32),
        receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256),
        prev_randao=rng.bytes(32),
        block_number=int(rng.integers(0, 2**40)),
        gas_limit=30_000_000,
        gas_used=int(rng.integers(0, 30_000_000)),
        timestamp=1_606_824_023 + slot * 12,
        extra_data=rng.bytes(32),
        base_fee_per_gas=int(rng.integers(0, 2**62)),
        block_hash=rng.bytes(32),
        transactions_root=rng.bytes(32),
        withdrawals_root=rng.bytes(32),
        blob_gas_used=int(rng.integers(0, 2**20)),
        excess_blob_gas=int(rng.integers(0, 2**20)),
    )
    epoch = slot // E.SLOTS_PER_EPOCH
    return T.BeaconState(
        genesis_time=1_606_824_023,
        genesis_validators_root=rng.bytes(32),
        slot=slot,
        fork=types.Fork(
            previous_version=b"\x03\x00\x00\x00",
            current_version=b"\x04\x00\x00\x00",
            epoch=epoch - 1000,
        ),
        latest_block_header=types.BeaconBlockHeader(
            slot=slot,
            proposer_index=int(rng.integers(0, n)),
            parent_root=rng.bytes(32),
            state_root=b"\x00" * 32,
            body_root=rng.bytes(32),
        ),
        block_roots=roots(E.SLOTS_PER_HISTORICAL_ROOT),
        state_roots=roots(E.SLOTS_PER_HISTORICAL_ROOT),
        historical_roots=roots(64),
        eth1_data=types.Eth1Data(
            deposit_root=rng.bytes(32), deposit_count=n, block_hash=rng.bytes(32)
        ),
        eth1_data_votes=[
            types.Eth1Data(
                deposit_root=rng.bytes(32), deposit_count=n, block_hash=rng.bytes(32)
            )
            for _ in range(16)
        ],
        eth1_deposit_index=n,
        validators=validators,
        balances=balances,
        randao_mixes=roots(E.EPOCHS_PER_HISTORICAL_VECTOR),
        slashings=u64(E.EPOCHS_PER_SLASHINGS_VECTOR, 0, 10**12),
        previous_epoch_participation=bytearray(rng.integers(0, 8, n, dtype=np.uint8).tobytes()),
        current_epoch_participation=bytearray(rng.integers(0, 8, n, dtype=np.uint8).tobytes()),
        justification_bits=[True, True, True, False],
        previous_justified_checkpoint=types.Checkpoint(epoch=epoch - 2, root=rng.bytes(32)),
        current_justified_checkpoint=types.Checkpoint(epoch=epoch - 1, root=rng.bytes(32)),
        finalized_checkpoint=types.Checkpoint(epoch=epoch - 2, root=rng.bytes(32)),
        inactivity_scores=u64(n, 0, 64),
        current_sync_committee=sync_committee(),
        next_sync_committee=sync_committee(),
        latest_execution_payload_header=header,
        next_withdrawal_index=int(rng.integers(0, 2**32)),
        next_withdrawal_validator_index=int(rng.integers(0, n)),
        historical_summaries=[
            types.HistoricalSummary(block_summary_root=rng.bytes(32), state_summary_root=rng.bytes(32))
            for _ in range(32)
        ],
    )


def block_update(state, E, rng: np.random.Generator) -> None:
    """One block's worth of state writes on a tree-states state: the next
    slot, 128 balances and 2 validator records (as bench.py's
    state_root_update does), the participation flags of one slot's
    committees (a shuffled 1/32 of the registry), and that slot's
    block_roots, state_roots and randao_mixes entries."""
    n = len(state.validators)
    state.slot = state.slot + 1
    slot = state.slot
    for i in np.sort(rng.choice(n, 128, replace=False)).tolist():
        state.balances[i] = int(state.balances[i]) + int(rng.integers(1, 10**7))
    for i in rng.choice(n, 2, replace=False).tolist():
        v = state.validators.mutate(i)
        v.effective_balance = int(v.effective_balance) - 10**9
        v.slashed = True
    part = state.current_epoch_participation
    old = np.array(part.load_array(), dtype=np.uint8)
    idx = np.sort(rng.choice(n, max(1, n // E.SLOTS_PER_EPOCH), replace=False))
    new = old.copy()
    new[idx] |= rng.integers(1, 8, idx.size, dtype=np.uint8)
    part.store_array(new, idx[new[idx] != old[idx]])
    state.block_roots[slot % E.SLOTS_PER_HISTORICAL_ROOT] = rng.bytes(32)
    state.state_roots[slot % E.SLOTS_PER_HISTORICAL_ROOT] = rng.bytes(32)
    epoch = slot // E.SLOTS_PER_EPOCH
    state.randao_mixes[epoch % E.EPOCHS_PER_HISTORICAL_VECTOR] = rng.bytes(32)


def epoch_sweep_inputs(rng: np.random.Generator, n: int, in_leak: bool) -> tuple[dict, np.ndarray]:
    """Seeded inputs of the epoch sweep over n validators at mainnet
    constants: the columns (numpy [n] uint64, bool `slashed`, uint8
    `prev_flags`) and the [9] uint64 scalars. Besides ordinary rows they
    hold the edge rows: FAR_FUTURE_EPOCH epochs (pending and active
    validators), exited ones, slashed ones with withdrawable_epoch ahead of
    the previous epoch and behind it, balances below their penalties, and
    effective_balance * score in [2^63, 2^64) as far as the host guard
    (state_processing/altair.py `_device_sweep_applicable`) admits."""
    inc = 10**9
    bias, recovery, quotient = 4, 16, 2**24
    cur = 300_001
    prev = cur - 1
    far = np.uint64(FAR_FUTURE_EPOCH)
    eb = np.full(n, 32 * inc, np.uint64)
    low = rng.random(n) < 0.1
    eb[low] = rng.integers(17, 32, int(low.sum())).astype(np.uint64) * np.uint64(inc)
    act = rng.integers(0, prev, n).astype(np.uint64)
    ext = np.full(n, far)
    wd = np.full(n, far)
    r = rng.random(n)
    act[r < 0.02] = far  # pending
    act[(r >= 0.02) & (r < 0.03)] = cur  # activated at the current epoch
    gone = (r >= 0.03) & (r < 0.05)  # exited or exiting around prev
    ext[gone] = rng.integers(prev - 5, prev + 5, int(gone.sum())).astype(np.uint64)
    wd[gone] = ext[gone] + np.uint64(256)
    slashed = rng.random(n) < 0.01
    ext[slashed] = rng.integers(prev - 10, prev + 3, int(slashed.sum())).astype(np.uint64)
    wd[slashed] = np.uint64(prev)  # prev + 1 < withdrawable is false
    ahead = slashed & (rng.random(n) < 0.5)
    wd[ahead] = np.uint64(prev + 4096)
    flags = np.full(n, 7, np.uint8)
    mixed = rng.random(n) < 0.05
    flags[mixed] = rng.integers(0, 7, int(mixed.sum())).astype(np.uint8)
    scores = np.zeros(n, np.uint64)
    some = rng.random(n) < 0.01
    scores[some] = rng.integers(1, 1000, int(some.sum())).astype(np.uint64)
    bal = (eb.astype(np.int64) + rng.normal(2e7, 1e8, n).astype(np.int64)).clip(0).astype(np.uint64)

    k = max(64, n // 256)
    edge = rng.permutation(n)[: 2 * k]
    big, poor = edge[:k], edge[k:]
    # effective_balance * score >= 2^63 for an active, non-slashed
    # validator that missed its target, up to the guard's limit
    eb[big] = np.uint64(32 * inc)
    act[big] = 0
    ext[big] = far
    wd[big] = far
    slashed[big] = False
    flags[big] = rng.choice(np.array([0, 1, 4, 5], np.uint8), k)
    lo = -(-(1 << 63) // (32 * inc)) + recovery
    hi = (1 << 64) // (32 * inc) - bias
    scores[big] = rng.integers(lo, hi + 1, k, dtype=np.uint64)
    # penalties above the balance
    act[poor] = 0
    ext[poor] = far
    flags[poor] = 0
    bal[poor] = rng.integers(0, 10**6, k).astype(np.uint64)
    if int(scores.max()) + bias > (1 << 64) // int(eb.max()):
        raise AssertionError("epoch_sweep_inputs: outside the host guard")

    active_cur = (act <= np.uint64(cur)) & (np.uint64(cur) < ext)
    total = max(int(eb[active_cur].sum(dtype=np.uint64)), inc)
    scalars = np.array(
        [prev, cur, inc * 64 // math.isqrt(total), total // inc, int(in_leak), bias,
         recovery, bias * quotient, inc],
        dtype=np.uint64,
    )
    cols = dict(
        effective_balance=eb, slashed=slashed, activation_epoch=act, exit_epoch=ext,
        withdrawable_epoch=wd, prev_flags=flags, scores=scores, balances=bal,
    )
    return cols, scalars


# ---------------------------------------------------------------------------
# BLS test material from a seed (also used by the CPU and card tests)
# ---------------------------------------------------------------------------


def bls_scalars(rng: np.random.Generator, n: int, bits: int = 64) -> list[int]:
    """n nonzero scalars below 2^bits."""
    words = rng.integers(0, 2**32, (n, -(-bits // 32)), dtype=np.uint64).tolist()
    out = []
    for w in words:
        v = sum(int(x) << (32 * i) for i, x in enumerate(w)) % (1 << bits)
        out.append(v or 1)
    return out


def bls_g1_points(rng: np.random.Generator, n: int) -> list:
    """n Jacobian G1 points [k]G1 with seeded k, with Z != 1."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, G1_GEN, pt_add, pt_mul

    return [pt_add(FQ, pt_mul(FQ, G1_GEN, k), G1_GEN) for k in bls_scalars(rng, n, 255)]


def bls_g2_points(rng: np.random.Generator, n: int) -> list:
    """n Jacobian G2 points [k]G2 with seeded k, with Z != 1."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ2, G2_GEN, pt_add, pt_mul

    return [pt_add(FQ2, pt_mul(FQ2, G2_GEN, k), G2_GEN) for k in bls_scalars(rng, n, 255)]


def bls_twist_point_outside_subgroup(rng: np.random.Generator):
    """An affine point of the twist E'(Fq2) that is not in G2: a seeded
    x whose x^3 + 4(1+u) is a square, with no cofactor clearing."""
    from lighthouse_tpu_torch.crypto.bls12_381 import B2, FQ2, g2_in_subgroup
    from lighthouse_tpu_torch.crypto.bls12_381 import fields as F

    while True:
        x = tuple(int(v) % F.P for v in bls_scalars(rng, 2, 384))
        y = F.f2_sqrt(F.f2_add(F.f2_mul(F.f2_sqr(x), x), B2))
        if y is not None and not g2_in_subgroup((x, y, FQ2.one)):
            return (x, y)


def bls_twist_point_of_order(rng: np.random.Generator, q: int):
    """An affine point of the twist E'(Fq2) of prime order q, with q^2 a
    factor of the twist's cofactor H2 (13 and 23): [H2 R / q^2]T for a
    seeded twist point T, whose q-part is Z/q x Z/q, so the result has
    order q or is infinity (then the next T). Outside G2: the subgroup
    check's ladder meets infinity on it."""
    from lighthouse_tpu_torch.crypto.bls12_381 import B2, FQ2, H2, R, is_inf, pt_mul, to_affine
    from lighthouse_tpu_torch.crypto.bls12_381 import fields as F

    while True:
        x = tuple(int(v) % F.P for v in bls_scalars(rng, 2, 384))
        y = F.f2_sqrt(F.f2_add(F.f2_mul(F.f2_sqr(x), x), B2))
        if y is None:
            continue
        pt = pt_mul(FQ2, (x, y, FQ2.one), H2 * R // (q * q))
        if not is_inf(FQ2, pt):
            assert is_inf(FQ2, pt_mul(FQ2, pt, q))
            return to_affine(FQ2, pt)


def bls_g1_point_of_order(rng: np.random.Generator, q: int):
    """A Jacobian point of E(Fq) of prime order q, a factor of the G1
    cofactor H1 once (3): [H1 R / q]T for a seeded curve point T, or the
    next T where that is infinity. A 64-bit ladder on it meets P == Q,
    P == -Q and infinity."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, H1, R, is_inf, pt_mul
    from lighthouse_tpu_torch.crypto.bls12_381.fields import P

    while True:
        x = bls_scalars(rng, 1, 384)[0] % P
        y = pow((x**3 + 4) % P, (P + 1) // 4, P)
        if y * y % P != (x**3 + 4) % P:
            continue
        pt = pt_mul(FQ, (x, y, 1), H1 * R // q)
        if not is_inf(FQ, pt) and is_inf(FQ, pt_mul(FQ, pt, q)):
            return pt


def bls_segment_rows(rng: np.random.Generator, group: str, case: str, n: int, k: int, pads: int = 0) -> np.ndarray:
    """[n, k, 3, coord] Montgomery limbs for the segment sums: n rows of k
    (a power of two) points each, the last `pads` lanes of every row the
    verifier's pads (all-zero limbs, Z = 0). Points are chains P, P + S,
    P + 2S, ... from a seeded P and step S. Cases:

    * "affine": affine points (Z = 1, as the verifier stages pubkeys), the
      first pair repeated (a doubling at the first level);
    * "distinct": affine points, none repeated (a block's committees);
    * "jacobian": Jacobian points (Z != 1, as the ladders leave them);
    * "edge": 5 rows (n is ignored; k >= 16) of affine points whose first
      lanes hold pt_add's cases: row 0 [P, P, Q, -Q, J, A, A, J, R', R]
      (an affine doubling, P + (-P), both mixed orders, a Jacobian R' plus
      the same point affine; J Jacobian); row 1
      [P, P, P, P] (the second level doubles a Jacobian 2P); row 2 only
      pads; row 3 [P, -P, pad, pad, Q, R] (the (1, 1, 0) of P + (-P) meets
      a pad's sum, then a live point); row 4 all Jacobian, [J, J', K,
      -K'] with J' = J and K' = K at other Z (a doubling and P + (-P) on
      the general formula)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, G1_GEN, G2_GEN, batch_to_affine, pt_add, pt_mul, pt_neg
    from lighthouse_tpu_torch.crypto.bls12_381.fields import P

    K, gen = (FQ, G1_GEN) if group == "g1" else (FQ2, G2_GEN)
    zero = (K.zero, K.zero, K.zero)

    def chain(m: int) -> list:
        p, s = (pt_mul(K, gen, v) for v in bls_scalars(rng, 2, 255))
        out = []
        for _ in range(m):
            out.append(p)
            p = pt_add(K, p, s)
        return [(x, y, K.one) for x, y in batch_to_affine(K, out)]

    def rescale(pt):  # the same point at a seeded Z: (l^2 X, l^3 Y, l Z)
        v = bls_scalars(rng, 2, 384)
        lam = v[0] % P if group == "g1" else (v[0] % P, v[1] % P)
        l2 = K.sqr(lam)
        return (K.mul(pt[0], l2), K.mul(pt[1], K.mul(l2, lam)), K.mul(pt[2], lam))

    rows = []
    if case == "edge":
        for r in range(5):
            a = chain(k)
            if r == 0:
                p, q, j = a[0], a[1], rescale(a[2])
                a[:10] = [p, p, q, pt_neg(K, q), j, a[3], a[3], j, rescale(a[4]), a[4]]
            elif r == 1:
                a[:4] = [a[0]] * 4
            elif r == 2:
                a = [zero] * k
            elif r == 3:
                a[:4] = [a[0], pt_neg(K, a[0]), zero, zero]
            else:
                a = [rescale(v) for v in a]
                a[1] = rescale(a[0])
                a[3] = rescale(pt_neg(K, a[2]))
            rows.append(a)
    else:
        for _ in range(n):
            a = chain(k)
            if case == "affine":
                a[1] = a[0]
            elif case == "jacobian":
                a = [rescale(v) for v in a]
            rows.append(a)
    for a in rows:
        a[k - pads :] = [zero] * pads
    pts = [v for a in rows for v in a]
    limbs = k_g.g1_to_limbs(pts) if group == "g1" else k_g.g2_to_limbs(pts)
    return limbs.reshape(len(rows), k, *limbs.shape[1:])


def htc_gx1_is_square(u: tuple) -> bool:
    """Is g(x1) a square for the field element u (an Fq2 pair), x1 the
    first SSWU candidate (the host oracle's map_to_curve_sswu)?"""
    from lighthouse_tpu_torch.crypto.bls12_381 import fields as F
    from lighthouse_tpu_torch.crypto.bls12_381 import hash_to_curve as HH

    z_u2 = F.f2_mul(HH._Z, F.f2_sqr(u))
    tv = F.f2_add(F.f2_sqr(z_u2), z_u2)
    x1 = HH._B_OVER_ZA if F.f2_is_zero(tv) else F.f2_mul(HH._MINUS_B_OVER_A, F.f2_add(F.F2_ONE, F.f2_inv(tv)))
    gx1 = F.f2_add(F.f2_add(F.f2_mul(F.f2_sqr(x1), x1), F.f2_mul(HH._A, x1)), HH._B)
    return F.f2_sqrt(gx1) is not None


def htc_edge_field_elements(rng: np.random.Generator, lanes: int) -> tuple[np.ndarray, dict]:
    """hash_to_field output ([lanes, 2, 2, 12] Montgomery limbs) of seeded
    32-byte messages, with message 0's u0 and u1 both 0 (RFC 9380's
    tv2 = 0 exception) and message 1's u0 one whose g(x1) is not a square
    (the first such u of the seeded messages), and the last message's u1
    equal to its u0 (the two maps meet: the sum on E' doubles). Returns the
    limbs and {"zero": [0], "non_square": [lanes whose u0 or u1 is not a
    square], "equal": [lanes - 1]}."""
    from lighthouse_tpu_torch.ops import bls381 as k_g
    from lighthouse_tpu_torch.ops import bls381_htc as k_htc

    u = k_htc.messages_to_field([rng.bytes(32) for _ in range(lanes)])
    vals = np.array(k_g.fq_from_limbs(u), dtype=object).reshape(lanes, 2, 2)
    square = [[htc_gx1_is_square(tuple(vals[i, j])) for j in range(2)] for i in range(lanes)]
    i, j = next((i, j) for i in range(2, lanes) for j in range(2) if not square[i][j])
    u[1, 0], square[1][0] = u[i, j], False
    u[0] = 0
    u[-1, 1], square[-1][1] = u[-1, 0], square[-1][0]
    return u, {"zero": [0], "non_square": [i for i in range(1, lanes) if not all(square[i])], "equal": [lanes - 1]}


def _g1_affine_bytes(x: int, y: int) -> bytes:
    """Compressed G1 encoding of an affine point (curve.py g1_to_bytes
    without its inversion)."""
    from lighthouse_tpu_torch.crypto.bls12_381.fields import P

    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y > (P - 1) // 2 else 0)
    return bytes(out)


def bls_keys(rng: np.random.Generator, count: int):
    """`count` seeded secret keys, their affine public points and their
    compressed pubkeys (one G1 fixed-base multiplication each, one batch
    inversion for all)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, R, batch_to_affine, g1_gen_mul

    sks = [s % R or 1 for s in bls_scalars(rng, count, 255)]
    affs = batch_to_affine(FQ, [g1_gen_mul(sk) for sk in sks])
    return sks, affs, [_g1_affine_bytes(x, y) for x, y in affs]


def bls_sign(sk_sum: int, message: bytes) -> bytes:
    """The aggregate signature of the keys summing to `sk_sum` over
    `message`: [sk_sum] H(m) (one G2 multiplication)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ2, R, g2_to_bytes, hash_to_g2, pt_mul

    return g2_to_bytes(pt_mul(FQ2, hash_to_g2(message), sk_sum % R))


# ---------------------------------------------------------------------------
# KZG test material from a seed (also used by the CPU and card tests)
# ---------------------------------------------------------------------------


def kzg_blobs(rng: np.random.Generator, m: int, n: int = 4096) -> list[bytes]:
    """m blobs of n seeded canonical field elements (32-byte big-endian,
    the top two bits clear, so below r); each blob's first element is
    r - 1 and its second 0."""
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    data = rng.integers(0, 256, (m, n, 32), dtype=np.uint8)
    data[:, :, 0] &= 0x3F
    data[:, 0] = np.frombuffer((R - 1).to_bytes(32, "big"), np.uint8)
    data[:, 1] = 0
    return [bytes(b.tobytes()) for b in data]


def fr_scalars(rng: np.random.Generator, n: int) -> list[int]:
    """n seeded scalars below r (255-bit draws reduced mod r)."""
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    return [s % R for s in bls_scalars(rng, n, 255)]


def msm_edge_case(rng: np.random.Generator, points: list) -> tuple[list, list[int]]:
    """Points and scalars for the MSM check: seeded 255-bit scalars over
    `points`, with zero scalars, r - 1, a point repeated with its scalar
    (both land in the same buckets: the addition meets P == Q) and a point
    beside its negation with one scalar (P == -Q)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, pt_neg
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    pts = list(points)
    sc = fr_scalars(rng, len(pts))
    if len(pts) >= 8:
        sc[0] = sc[5] = 0
        sc[1] = R - 1
        pts[3], sc[3] = pts[2], sc[2]
        pts[7], sc[7] = pt_neg(FQ, pts[6]), sc[6]
    return pts, sc


def wide_edge_scalars() -> list[int]:
    """Scalars at the 256-bit ladder's edges: r - 1, 0, 1, r - 2, 2^255
    mod r; 2^254 (5-bit digits: -16 at window 50, and the top one, 1 at
    window 51, carried from the bit below it), 2^251 (4-bit digits: -8 at
    window 62, 1 at window 63 by its carry) and 2^252 - 1 (4-bit digits:
    -1, 62 zeros, 1 carried on top: doublings alone between)."""
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    return [R - 1, 0, 1, R - 2, (1 << 255) % R, 1 << 254, 1 << 251, (1 << 252) - 1]


def bls_block(state, types, E, spec, seed: int) -> dict:
    """One mainnet Deneb block's signature sets over `state`'s registry, as
    BlockSignatureVerifier builds them: the block proposal and RANDAO sets
    of a seeded proposer, 128 indexed attestations (one per committee of
    the two previous slots; committees drawn as disjoint sets from one
    seeded permutation of the active registry, active / 32 / 64 members
    each, each with its own AttestationData) and the sync aggregate of the
    512-member current sync committee with ~2% of bits clear.

    The signers' pubkeys become real keys from seeded secret keys, written
    into the registry and kept decompressed in the port's pubkey cache (as
    a node keeps its validator pubkey cache); each aggregate signature is
    [sum of the signers' keys] H(m). Returns the sets and the material the
    verdict cases need."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_processing import altair
    from lighthouse_tpu_torch.state_processing import signature_sets as ss
    from lighthouse_tpu_torch.state_processing.accessors import get_block_root_at_slot, get_domain
    from lighthouse_tpu_torch.types.chain_spec import Domain, compute_signing_root

    rng = np.random.default_rng(seed)
    T = types.types_for_fork("deneb")
    slot = int(state.slot)
    epoch = slot // E.SLOTS_PER_EPOCH
    act = np.fromiter((int(v.activation_epoch) for v in state.validators), np.uint64, len(state.validators))
    ext = np.fromiter((int(v.exit_epoch) for v in state.validators), np.uint64, len(state.validators))
    active = np.nonzero((act <= epoch) & (epoch < ext))[0]
    size = len(active) // (E.SLOTS_PER_EPOCH * 64)
    perm = rng.permutation(active)
    committees = [np.sort(perm[c * size : (c + 1) * size]) for c in range(128)]
    sync_idx = rng.choice(active, E.SYNC_COMMITTEE_SIZE, replace=False)
    proposer = int(perm[128 * size])

    signers = np.unique(np.concatenate(committees + [sync_idx, [proposer]]))
    t0 = time.perf_counter()
    sks, affs, pks = bls_keys(rng, len(signers))
    keygen_s = time.perf_counter() - t0
    sk_of = dict(zip(signers.tolist(), sks))
    for i, (x, y), pk in zip(signers.tolist(), affs, pks):
        state.validators.mutate(i).pubkey = pk
        ss._PUBKEY_CACHE.setdefault(pk, bls.PublicKey(pk, (x, y, 1)))
    sync_pks = [state.validators[int(i)].pubkey for i in sync_idx]
    state.current_sync_committee = types.SyncCommittee(
        pubkeys=sync_pks,
        aggregate_pubkey=bls.aggregate_pubkeys([ss.pubkey_from_bytes(pk) for pk in sync_pks]).to_bytes(),
    )

    t0 = time.perf_counter()
    atts = []
    for c, members in enumerate(committees):
        a_slot = slot - 2 + c // 64
        target_epoch = a_slot // E.SLOTS_PER_EPOCH
        data = types.AttestationData(
            slot=a_slot,
            index=c % 64,
            beacon_block_root=get_block_root_at_slot(state, a_slot, E),
            source=state.current_justified_checkpoint,
            target=types.Checkpoint(
                epoch=target_epoch,
                root=get_block_root_at_slot(state, target_epoch * E.SLOTS_PER_EPOCH, E),
            ),
        )
        domain = get_domain(state, Domain.BEACON_ATTESTER, target_epoch, spec, E)
        msg = compute_signing_root(data.hash_tree_root(), domain)
        sk_sum = sum(sk_of[int(i)] for i in members)
        atts.append(
            types.IndexedAttestation(
                attesting_indices=members.tolist(), data=data, signature=bls_sign(sk_sum, msg)
            )
        )
    bits = (rng.random(E.SYNC_COMMITTEE_SIZE) >= 0.02).tolist()
    sync_msg = compute_signing_root(
        get_block_root_at_slot(state, slot - 1, E),
        get_domain(state, Domain.SYNC_COMMITTEE, (slot - 1) // E.SLOTS_PER_EPOCH, spec, E),
    )
    sync_sig = bls_sign(sum(sk_of[int(i)] for i, b in zip(sync_idx, bits) if b), sync_msg)
    sk_p = sk_of[proposer]
    randao_msg = compute_signing_root(
        epoch.to_bytes(8, "little").ljust(32, b"\x00"), get_domain(state, Domain.RANDAO, epoch, spec, E)
    )
    block = T.BeaconBlock(
        slot=slot,
        proposer_index=proposer,
        parent_root=get_block_root_at_slot(state, slot - 1, E),
        state_root=rng.bytes(32),
        body=T.BeaconBlockBody(
            randao_reveal=bls_sign(sk_p, randao_msg),
            graffiti=rng.bytes(32),
            sync_aggregate=types.SyncAggregate(sync_committee_bits=bits, sync_committee_signature=sync_sig),
        ),
    )
    block_msg = compute_signing_root(
        block.hash_tree_root(), get_domain(state, Domain.BEACON_PROPOSER, epoch, spec, E)
    )
    signed = T.SignedBeaconBlock(message=block, signature=bls_sign(sk_p, block_msg))
    sign_s = time.perf_counter() - t0

    sets = [
        ss.block_proposal_signature_set(state, signed, None, spec, E),
        ss.randao_signature_set(state, block, spec, E),
        *(ss.indexed_attestation_signature_set(state, a, spec, E) for a in atts),
        altair.sync_aggregate_signature_set(state, block.body.sync_aggregate, slot, spec, E),
    ]
    # (b) attestation 5 signed by its own committee over another message
    other_msg = compute_signing_root(
        types.AttestationData(
            slot=atts[5].data.slot,
            index=atts[5].data.index,
            beacon_block_root=rng.bytes(32),
            source=atts[5].data.source,
            target=atts[5].data.target,
        ).hash_tree_root(),
        get_domain(state, Domain.BEACON_ATTESTER, int(atts[5].data.target.epoch), spec, E),
    )
    wrong_msg_sig = bls_sign(sum(sk_of[int(i)] for i in committees[5]), other_msg)
    # (e) a gossip batch: 64 single-signer attestations of one subnet, 60
    # over committee 0's data and 4 over a different head
    fork_data = types.AttestationData(
        slot=atts[0].data.slot,
        index=atts[0].data.index,
        beacon_block_root=rng.bytes(32),
        source=atts[0].data.source,
        target=atts[0].data.target,
    )
    gossip = []
    for j, i in enumerate(committees[0][:64].tolist()):
        data = atts[0].data if j < 60 else fork_data
        msg = compute_signing_root(
            data.hash_tree_root(),
            get_domain(state, Domain.BEACON_ATTESTER, int(data.target.epoch), spec, E),
        )
        ia = types.IndexedAttestation(attesting_indices=[i], data=data, signature=bls_sign(sk_of[i], msg))
        gossip.append(ss.indexed_attestation_signature_set(state, ia, spec, E))
    return {
        "sets": sets,
        "gossip": gossip,
        "wrong_msg_sig": wrong_msg_sig,
        "signers": len(signers),
        "committee_size": size,
        "active": len(active),
        "keygen_s": keygen_s,
        "sign_s": sign_s,
        "sk_of": sk_of,
    }


# ---------------------------------------------------------------------------
# The kernel-free oracle: a state root folded through the host hash lanes
# ---------------------------------------------------------------------------


def _host_fold(leaves: np.ndarray, limit_chunks: int) -> bytes:
    """Merkle root of [m, 32] leaves zero-padded to `limit_chunks`."""
    depth = (next_pow_of_two(limit_chunks) - 1).bit_length()
    m = leaves.shape[0]
    if m == 0:
        return ZERO_HASHES[depth]
    level = np.zeros((next_pow_of_two(m), 32), dtype=np.uint8)
    level[:m] = leaves
    while level.shape[0] > 1:
        level = hash_rows_hashlib(level.reshape(-1, 64))
    root = level[0].tobytes()
    for d in range((next_pow_of_two(m) - 1).bit_length(), depth):
        root = hashlib.sha256(root + ZERO_HASHES[d]).digest()
    return root


def _bytes_chunks(data: bytes) -> np.ndarray:
    buf = np.zeros(-(-len(data) // 32) * 32, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(-1, 32)


def _u64_chunks(values) -> np.ndarray:
    return _bytes_chunks(np.asarray(list(values), dtype="<u8").tobytes())


def _validator_roots(validators) -> np.ndarray:
    """[n, 32] Validator container roots, field by field with numpy."""
    vs = list(validators)
    n = len(vs)
    leaves = np.zeros((n, 8, 32), dtype=np.uint8)
    pk = np.zeros((n, 64), dtype=np.uint8)
    pk[:, :48] = np.frombuffer(b"".join(v.pubkey for v in vs), np.uint8).reshape(n, 48)
    leaves[:, 0] = hash_rows_hashlib(pk)
    leaves[:, 1] = np.frombuffer(
        b"".join(v.withdrawal_credentials for v in vs), np.uint8
    ).reshape(n, 32)
    for f, name in enumerate(
        (
            "effective_balance",
            "slashed",
            "activation_eligibility_epoch",
            "activation_epoch",
            "exit_epoch",
            "withdrawable_epoch",
        ),
        start=2,
    ):
        col = np.array([int(getattr(v, name)) for v in vs], dtype="<u8")
        leaves[:, f, :8] = col.view(np.uint8).reshape(n, 8)
    level = leaves.reshape(-1, 32)
    for _ in range(3):  # 8 field chunks -> 1 root
        level = hash_rows_hashlib(level.reshape(-1, 64))
    return level


def host_state_root(state) -> bytes:
    """The state's root folded from its leaves through hashlib only: the
    registry-scale fields leaf by leaf, the small fields through their own
    SSZ roots (all below the kernel's size thresholds)."""
    chunks = []
    for fname, ftype in state._fields.items():
        value = getattr(state, fname)
        limit = ftype.chunk_count()
        if fname == "validators":
            root = mix_in_length(_host_fold(_validator_roots(value), limit), len(value))
        elif fname in ("balances", "inactivity_scores"):
            root = mix_in_length(_host_fold(_u64_chunks(value), limit), len(value))
        elif fname.endswith("_epoch_participation"):
            root = mix_in_length(_host_fold(_bytes_chunks(bytes(value)), limit), len(value))
        elif fname in ("block_roots", "state_roots", "randao_mixes"):
            root = _host_fold(_bytes_chunks(b"".join(value)), limit)
        elif fname == "slashings":
            root = _host_fold(_u64_chunks(value), limit)
        else:
            root = ftype.hash_tree_root_of(value)
        chunks.append(root)
    return _host_fold(np.frombuffer(b"".join(chunks), np.uint8).reshape(-1, 32), len(chunks))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card over `reps` back-to-back calls
    (CUDA events, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sass_instructions(so_path: str, kernel: str) -> int | None:
    """Instructions in `kernel`'s SASS (the kernel is straight-line, so this
    is the count each thread issues), or None without cuobjdump. A
    diagnostic of the compiled code: the bound uses SHA256_MIN_OPS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run(
            [tool, "-sass", so_path], capture_output=True, text=True, timeout=120
        )
    except FileNotFoundError:
        return None
    if out.returncode != 0:
        return None
    count, inside = 0, False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and line.strip().startswith("/*") and "*/" in line:
            op = line.split("*/", 1)[1].strip()
            if op and not op.startswith(("NOP", "BRA", "EXIT")) and op[0] not in "/":
                count += 1
    return count or None


def phase_build() -> dict:
    """Build every kernel source at once (one nvcc each, in parallel) and
    report each one's seconds, registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    libs = {
        "bls381_g": k_g.LIB,
        "bls381_pairing": k_pair.LIB,
        "bls381_htc": k_htc.LIB,
        "epoch_sweep": k7.LIB,
        "kzg_fr": k_fr.LIB,
        "msm": k_msm.LIB,
        "merkle_subtree": k_ms.LIB,
    }
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        futs = [pool.submit(k_sha256.load_kernel)] + [pool.submit(lib.load) for lib in libs.values()]
        for f in futs:
            f.result()
    out = {"phase": "build", "seconds": time.perf_counter() - t0, "sources": {}}
    for name, lib in {"sha256": k_sha256.LIB, **libs}.items():
        out["sources"][name + ".cu"] = {
            "so": lib.info["so"],
            "built_now": lib.info["built"],
            "build_s": lib.info["build_s"],
            "kernels": ptxas_usage(lib.info["ptxas"]),
        }
    out["sources"]["sha256.cu"]["sass_instructions"] = _sass_instructions(
        k_sha256.LIB.info["so"], "sha256_rows_kernel"
    )
    emit(out)
    return out


def phase_kernel_checks(seed: int) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n = 1 << 20
    rows_np = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    rows = torch.from_numpy(rows_np).to(dev)

    got = k_sha256.sha256_pairs(rows)
    want = k_sha256.sha256_rows_plain(rows)
    torch.cuda.synchronize()
    max_abs_err = int((got.int() - want.int()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"sha256_pairs differs from its plain version at n={n}")
    sample = rng.choice(n, 4096, replace=False)
    if not np.array_equal(got.cpu().numpy()[sample], hash_rows_hashlib(rows_np[sample])):
        raise AssertionError("sha256_pairs differs from hashlib on a 4096-row sample")

    ragged = n - 3
    got_r = k_sha256.device_hash_rows(rows_np[:ragged])
    want_r = k_sha256.sha256_rows_plain(rows[:ragged]).cpu().numpy()
    if not np.array_equal(got_r, want_r):
        raise AssertionError(f"device_hash_rows differs from the plain version at n={ragged}")

    leaves_np = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    levels = k_sha256.merkle_tree_levels(leaves_np)
    cur = torch.from_numpy(leaves_np).to(dev)
    plain_levels = [leaves_np]
    while cur.shape[0] > k_sha256._HOST_TOP:
        cur = k_sha256.sha256_rows_plain(cur.view(-1, 64))
        plain_levels.append(cur.cpu().numpy())
    top = plain_levels[-1]
    while top.shape[0] > 1:
        top = hash_rows_hashlib(top.reshape(-1, 64))
        plain_levels.append(top)
    if len(levels) != len(plain_levels) or not all(
        np.array_equal(a, b) for a, b in zip(levels, plain_levels[::-1])
    ):
        raise AssertionError("merkle_tree_levels differs from the plain version")
    fold = leaves_np
    while fold.shape[0] > 1:
        fold = hash_rows_hashlib(fold.reshape(-1, 64))
    if not np.array_equal(levels[0][0], fold[0]):
        raise AssertionError("merkle_tree_levels root differs from a hashlib fold")

    ms = _time_ms(lambda: k_sha256.sha256_pairs(rows), reps=50)
    plain_ms = _time_ms(lambda: k_sha256.sha256_rows_plain(rows), reps=3, warmup=1)
    ops_s = SHA256_MIN_OPS * n / INT32_OPS_PER_S
    bytes_s = 96 * n / HBM_BYTES_PER_S
    out = {
        "phase": "kernel_checks",
        "kernel": "sha256_rows",
        "rows": n,
        "byte_equal_plain": True,
        "byte_equal_hashlib_sample": 4096,
        "device_hash_rows_ragged_n": ragged,
        "merkle_tree_levels_leaves": n,
        "levels_equal_plain": len(levels),
        "root_equal_hashlib_fold": True,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": "none (no PyTorch call computes SHA-256)",
        "min_ops_per_row": SHA256_MIN_OPS,
        "bound_ms_ops": ops_s * 1e3,
        "bound_ms_bytes": bytes_s * 1e3,
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "rows_per_s": n / (ms * 1e-3),
    }
    emit(out)
    return out


def _ladder_fq_muls(scalars, group: str, affine: bool = False) -> int:
    """Least Fq products of [k]P for each k: (bits(k) - 1) doublings and
    (popcount(k) - 1) additions; on an affine P (Z = 1) the first doubling
    and every addition take the affine forms."""
    d, a = BLS_FQ_MULS[group + "_dbl"], BLS_FQ_MULS[group + ("_madd" if affine else "_add")]
    first = BLS_FQ_MULS[group + "_mdbl"] - d if affine else 0
    return sum(d * (k.bit_length() - 1) + a * (bin(k).count("1") - 1) + (first if k > 1 else 0) for k in scalars if k)


def _binary_inv_ops(a: int) -> tuple[int, int]:
    """(32-bit multiplies, other 32-bit operations) at least of the binary
    extended Euclid (csrc/mont_cs.cuh mont_inv_binary<12>) on the
    Montgomery value `a` != 0, round by round as this `a` takes it: a
    shift of u or v by k <= 31 bits is 12 operations, and its x / 2^k mod p
    1 + 24 multiplies (m = x0 n', x + m p) and 24 operations (the shift,
    the subtraction of p); a subtraction is 24 operations (u - v and
    x1 - x2); then one product by R^3. No other Fq product."""
    muls, ops = BLS_FQ_MUL_MIN_OPS, 0

    def strip(w: int) -> int:
        nonlocal muls, ops
        while not w & 1:
            w >>= min((w & -w).bit_length() - 1, 31)
            muls, ops = muls + 25, ops + 36
        return w

    u, v = a, k_g.P
    while True:
        u, v = strip(u), strip(v)
        if u == 1 or v == 1:
            return muls, ops
        if u >= v:
            u -= v
        else:
            v -= u
        ops += 24


def _segment_fq_muls(group: str, pts: torch.Tensor) -> int:
    """The least Fq products of segment sums over [n, k, 3, coord] points,
    on this run's data, a row at a time (csrc/bls381_g.cu's header). The
    row's live points (Z != 0) are taken by value, their repeats and
    cancellations as known: a point and its negation cost nothing; c > 1
    copies of one point are c times it, a doubling (an affine one where a
    copy is affine) and then doublings and additions as a ladder does. The
    m distinct values left add up in a chain, the lesser of two: from two
    affine points at Z1 = Z2 = 1, then a mixed addition for each further
    affine one and a general one for each Jacobian one; or from a Jacobian
    one, every affine one mixed."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, to_affine

    K = FQ if group == "g1" else FQ2
    cost = {op: BLS_FQ_MULS[f"{group}_{op}"] for op in ("dbl", "mdbl", "add", "madd", "aadd")}
    pts_np = pts.cpu().numpy()
    total = 0
    for row in pts_np:
        live = [q for q in (k_g.g1_from_limbs(row) if group == "g1" else k_g.g2_from_limbs(row)) if not K.is_zero(q[2])]
        copies: dict = {}  # affine value -> [copies, whether one is affine]
        for q in live:
            key = q[:2] if q[2] == K.one else to_affine(K, q)
            neg = (key[0], K.neg(key[1]))
            if neg in copies:  # cancels a copy of its negation
                copies[neg][0] -= 1
                if not copies[neg][0]:
                    del copies[neg]
                continue
            c = copies.setdefault(key, [0, False])
            c[0] += 1
            c[1] = c[1] or q[2] == K.one
        affine = jacobian = 0
        for c, any_affine in copies.values():
            if c == 1:
                affine += any_affine
                jacobian += not any_affine
                continue
            total += cost["mdbl" if any_affine else "dbl"] + cost["dbl"] * (c.bit_length() - 2)
            total += cost["madd" if any_affine else "add"] * (bin(c).count("1") - 1)
            jacobian += 1
        chains = []
        if affine >= 2:
            chains.append(cost["aadd"] + (affine - 2) * cost["madd"] + jacobian * cost["add"])
        if jacobian:
            chains.append((jacobian - 1) * cost["add"] + affine * cost["madd"])
        total += min(chains, default=0)
    return total


def _to_affine_work(group: str, pts: torch.Tensor) -> tuple[int, int, int]:
    """The least work of converting the Jacobian `pts` to affine (derived
    in csrc/bls381_g.cu's header): Montgomery's batch inversion over the
    live lanes (an infinity needs none), 3 (live - 1) Fq products and one
    binary inversion of their product D, this run's D; then a lane's z^-1,
    z^-2, x z^-2, z^-3 and y z^-3, 4 Fq products for G1 and 15 for G2 (the
    norm N(Z) = c0^2 + c1^2, 2; conj(Z) N^-1, 2; an Fq2 square, 2; three
    Fq2 products, 9). Returns (Fq products, the inversion's 32-bit
    multiplies, its other 32-bit operations)."""
    z = k_g.fq_from_limbs(pts[:, 2].cpu().numpy())
    d = z if group == "g1" else [(c0 * c0 + c1 * c1) % k_g.P for c0, c1 in zip(z[0::2], z[1::2])]
    live = [v for v in d if v]
    if not live:
        return 0, 0, 0
    prod = 1
    for v in live:
        prod = prod * v % k_g.P
    inv_muls, inv_ops = _binary_inv_ops(prod * k_g.R_MONT % k_g.P)
    return 3 * (len(live) - 1) + (4 if group == "g1" else 15) * len(live), inv_muls, inv_ops


def _bound(muls: int, nbytes: int, field: str = "fq", int_muls: int = 0, int_ops: int = 0) -> dict:
    """The least time for `muls` field multiplications (Fq, or Fr with
    field="fr"), `int_muls` other 32-bit multiplies and `int_ops` other
    32-bit operations (a binary inversion's), and `nbytes` of memory
    traffic: the multiplies at the multiply rate, and all the operations at
    the issue rate."""
    ops_per_mul = {"fq": BLS_FQ_MUL_MIN_OPS, "fr": FR_MUL_MIN_OPS}[field]
    mul_ops = muls * ops_per_mul + int_muls
    ops_s = max(mul_ops / INT32_MUL_PER_S, (mul_ops + int_ops) / INT32_OPS_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {
        f"{field}_muls": muls,
        **({"inv_int32_muls": int_muls, "inv_int32_ops": int_ops} if int_muls or int_ops else {}),
        "bound_ms_ops": ops_s * 1e3,
        "bound_ms_bytes": bytes_s * 1e3,
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
    }


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0


def _plain_ms(fn):
    """(result, ms) of one call (of a plain version, mostly), by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_bls_kernel_checks(seed: int) -> dict:
    """Each BLS kernel at the main path's shapes (32 lanes; [32, 512] for
    the pubkey sums; 33 pairs, and 2 as the KZG checks use), equal to its
    plain version on the card, with its time, its plain version's time and
    its bound; the ladders also at their edge scalars, the G1 ladder at
    K11's 4,096 lanes in each layout and both layouts' times by lane
    count, the subgroup check also on points it must reject, the affine
    conversions (one batch inversion a block of 64 lanes) also over three
    blocks with infinity lanes and at 4,096 lanes."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, G1_GEN, batch_to_affine, inf, pt_add, pt_neg, to_affine

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    lanes, k = 32, 512
    g1 = bls_g1_points(rng, lanes)
    g2 = bls_g2_points(rng, lanes + 1)
    scalars = bls_scalars(rng, lanes)
    kt = k_g.scalars_to_tensor(scalars).to(dev)
    # pubkey grid: rows of 488 affine points (Z = 1, as decompressed
    # pubkeys are), the first repeated, and 24 pads
    rows = []
    for i in range(lanes):
        pt, row = g1[i], []
        for _ in range(488):
            row.append(pt)
            pt = pt_add(FQ, pt, G1_GEN)
        row[1] = row[0]
        row = [(x, y, 1) for x, y in batch_to_affine(FQ, row)]
        rows.append(row + [inf(FQ)] * (k - 488))
    grid = torch.from_numpy(k_g.g1_to_limbs([q for r in rows for q in r]).reshape(lanes, k, 3, 12)).to(dev)
    g1_t = torch.from_numpy(k_g.g1_to_limbs(g1)).to(dev)
    g2_t = torch.from_numpy(k_g.g2_to_limbs(g2)).to(dev)
    g2_row = g2_t[:lanes].reshape(1, lanes, 3, 2, 12).contiguous()
    g1_aff = [to_affine(FQ, q) for q in g1] + [to_affine(FQ, pt_neg(FQ, G1_GEN))]
    g2_aff = [to_affine(FQ2, q) for q in g2]
    # the G2 ladder's points as the verifier stages them: affine, Z = 1
    g2_z1 = torch.from_numpy(k_g.g2_to_limbs([(x, y, FQ2.one) for x, y in g2_aff[:lanes]])).to(dev)
    # its edge scalars, on Jacobian points (Z != 1) in the first half of
    # the lanes and on affine ones in the second
    edge_k = [0, 1, 2, 2**63, 2**64 - 1]
    edge_k = (edge_k + scalars[: lanes // 2 - len(edge_k)]) * 2
    half = lanes // 2
    g2_edge = torch.cat((g2_t[:half], g2_z1[half:])).contiguous()
    edge_t = k_g.scalars_to_tensor(edge_k).to(dev)
    # the G1 ladder's edge scalars, on Jacobian points (Z != 1) in the first
    # half of the lanes and on affine ones (Z = 1) in the second
    g1_z1 = torch.from_numpy(k_g.g1_to_limbs([(x, y, 1) for x, y in g1_aff[:lanes]])).to(dev)
    g1_edge = torch.cat((g1_t[:half], g1_z1[half:])).contiguous()
    # K11's shape: 4,096 lanes (the 32 points again, 4,096 scalars)
    wide = RLC_POINTS
    wide_k = bls_scalars(rng, wide)
    g1_wide = g1_t.repeat(wide // lanes, 1, 1).contiguous()
    wide_t = k_g.scalars_to_tensor(wide_k).to(dev)
    p_aff = torch.from_numpy(k_g.fq_to_limbs([v for a in g1_aff for v in a]).reshape(-1, 2, 12)).to(dev)
    q_aff = torch.from_numpy(k_g.fq_to_limbs([v for a in g2_aff for c in a for v in c]).reshape(-1, 2, 2, 12)).to(dev)
    no_inf = torch.zeros(lanes + 1, dtype=torch.bool, device=dev)
    # the subgroup check's rejections: two points outside G2, twist points
    # of order 13 and 23 (its ladder meets infinity), and a q_inf lane
    sub_edge = list(g2_aff[:lanes])
    sub_edge[3], sub_edge[9] = bls_twist_point_outside_subgroup(rng), bls_twist_point_outside_subgroup(rng)
    sub_edge[14], sub_edge[27] = bls_twist_point_of_order(rng, 13), bls_twist_point_of_order(rng, 23)
    sub_edge_t = torch.from_numpy(k_g.fq_to_limbs([v for a in sub_edge for c in a for v in c]).reshape(-1, 2, 2, 12)).to(dev)
    sub_edge_inf = torch.zeros(lanes, dtype=torch.bool, device=dev)
    sub_edge_inf[20] = True
    sub_edge_want = [i not in (3, 9, 14, 27) for i in range(lanes)]
    # the affine conversions' edge lanes: 130 lanes over three blocks of
    # 64, infinities (Z = 0: 1 in the block's products, (0, 0) out) at
    # lanes 0, 16 and 129 (past the last full block) and across the whole
    # second block, an affine point (Z = 1) at lane 1; and 4,096 lanes
    aff_n = 130
    aff_inf = {0, 16, aff_n - 1, *range(64, 128)}
    g1_aff_edge = [g1[j % lanes] for j in range(aff_n)]
    g2_aff_edge = [g2[j % (lanes + 1)] for j in range(aff_n)]
    g1_aff_edge[1] = (*g1_aff[1], 1)
    g2_aff_edge[1] = (*g2_aff[1], FQ2.one)
    for j in aff_inf:
        g1_aff_edge[j], g2_aff_edge[j] = inf(FQ), inf(FQ2)
    g1_aff_edge_t = torch.from_numpy(k_g.g1_to_limbs(g1_aff_edge)).to(dev)
    g2_aff_edge_t = torch.from_numpy(k_g.g2_to_limbs(g2_aff_edge)).to(dev)
    g2_wide = g2_t.repeat(-(-wide // (lanes + 1)), 1, 1, 1)[:wide].contiguous()
    # seeded messages' field elements with u = 0 in lane 0 and a u whose
    # g(x1) is not a square in lane 1
    u_np, htc_lanes = htc_edge_field_elements(rng, lanes)
    u = torch.from_numpy(u_np).to(dev)
    # the segment sums' other rows: pt_add's cases (bls_segment_rows
    # "edge"; G1 at k = 128, the first level on threads), the verifier's
    # last chunk ([3, 512]), a G2 row padded as the verifier pads 27 sets
    # (nb = 32) and K11's one row of 4,096 Jacobian points
    seg_rows = {
        ("g1", "edge"): bls_segment_rows(rng, "g1", "edge", 0, 128, 8),
        ("g2", "edge"): bls_segment_rows(rng, "g2", "edge", 0, lanes, 5),
        ("g2", "padded"): bls_segment_rows(rng, "g2", "jacobian", 1, lanes, lanes - 27),
        ("g1", str(wide)): bls_segment_rows(rng, "g1", "jacobian", 1, wide),
    }
    seg_rows = {key: torch.from_numpy(t).to(dev) for key, t in seg_rows.items()}
    seg_rows[("g1", f"3,{k}")] = grid[:3].contiguous()

    W = 8  # bytes per limb as the card moves them
    cases = {
        "g1_scalar_mul": (
            lambda: k_g.scalar_mul("g1", g1_t, kt),
            lambda: k_g.scalar_mul_plain("g1", g1_t, kt),
            _ladder_fq_muls(scalars, "g1"),
            2 * g1_t.numel() * W + lanes * 8,
        ),
        "g1_scalar_mul[edge]": (
            lambda: k_g.scalar_mul("g1", g1_edge, edge_t),
            lambda: k_g.scalar_mul_plain("g1", g1_edge, edge_t),
            _ladder_fq_muls(edge_k[:half], "g1") + _ladder_fq_muls(edge_k[half:], "g1", affine=True),
            2 * g1_edge.numel() * W + lanes * 8,
        ),
        **{
            f"g1_scalar_mul[{wide},{layout}]": (
                lambda layout=layout: k_g.scalar_mul("g1", g1_wide, wide_t, layout=layout),
                lambda: k_g.scalar_mul_plain("g1", g1_wide, wide_t),
                _ladder_fq_muls(wide_k, "g1"),
                2 * g1_wide.numel() * W + wide * 8,
            )
            for layout in k_g.G1_LAYOUTS
        },
        # the main path's form (Z = 1: mixed additions), then Jacobian
        # points (Z != 1) and the edge scalars
        "g2_scalar_mul": (
            lambda: k_g.scalar_mul("g2", g2_z1, kt),
            lambda: k_g.scalar_mul_plain("g2", g2_z1, kt),
            _ladder_fq_muls(scalars, "g2", affine=True),
            2 * g2_z1.numel() * W + lanes * 8,
        ),
        "g2_scalar_mul[z!=1]": (
            lambda: k_g.scalar_mul("g2", g2_t[:lanes].contiguous(), kt),
            lambda: k_g.scalar_mul_plain("g2", g2_t[:lanes].contiguous(), kt),
            _ladder_fq_muls(scalars, "g2"),
            2 * g2_t[:lanes].numel() * W + lanes * 8,
        ),
        "g2_scalar_mul[edge]": (
            lambda: k_g.scalar_mul("g2", g2_edge, edge_t),
            lambda: k_g.scalar_mul_plain("g2", g2_edge, edge_t),
            _ladder_fq_muls(edge_k[:half], "g2") + _ladder_fq_muls(edge_k[half:], "g2", affine=True),
            2 * g2_edge.numel() * W + lanes * 8,
        ),
        "g1_segment_sum": (
            lambda: k_g.segment_sum("g1", grid),
            lambda: k_g.segment_sum_plain("g1", grid),
            # a row's repeated pair is an affine doubling, then 486 mixed additions
            _segment_fq_muls("g1", grid),
            grid.numel() * W + lanes * 36 * W,
        ),
        "g2_segment_sum": (
            lambda: k_g.segment_sum("g2", g2_row),
            lambda: k_g.segment_sum_plain("g2", g2_row),
            _segment_fq_muls("g2", g2_row),
            g2_row.numel() * W + 72 * W,
        ),
        **{
            f"{group}_segment_sum[{tag}]": (
                lambda group=group, t=t: k_g.segment_sum(group, t),
                lambda group=group, t=t: k_g.segment_sum_plain(group, t),
                _segment_fq_muls(group, t),
                t.numel() * W + t[:, 0].numel() * W,
            )
            for (group, tag), t in seg_rows.items()
        },
        "g1_to_affine": (
            lambda: k_g.to_affine("g1", g1_t),
            lambda: k_g.to_affine_plain("g1", g1_t),
            _to_affine_work("g1", g1_t),
            g1_t.numel() * W * 5 // 3,
        ),
        "g2_to_affine": (
            lambda: k_g.to_affine("g2", g2_t),
            lambda: k_g.to_affine_plain("g2", g2_t),
            _to_affine_work("g2", g2_t),
            g2_t.numel() * W * 5 // 3,
        ),
        **{
            f"{group}_to_affine[{tag}]": (
                lambda group=group, t=t: k_g.to_affine(group, t),
                lambda group=group, t=t: k_g.to_affine_plain(group, t),
                _to_affine_work(group, t),
                t.numel() * W * 5 // 3,
            )
            for group, tag, t in (
                ("g1", "edge", g1_aff_edge_t),
                ("g2", "edge", g2_aff_edge_t),
                ("g1", wide, g1_wide),
                ("g2", wide, g2_wide),
            )
        },
        "g2_subgroup_check": (
            lambda: k_pair.g2_subgroup_check(q_aff[:lanes], no_inf[:lanes]),
            lambda: k_pair.g2_subgroup_check_plain(q_aff[:lanes], no_inf[:lanes]),
            lanes * BLS_FQ_MULS["subgroup_check"],
            q_aff[:lanes].numel() * W + 2 * lanes,
        ),
        "g2_subgroup_check[edge]": (
            lambda: k_pair.g2_subgroup_check(sub_edge_t, sub_edge_inf),
            lambda: k_pair.g2_subgroup_check_plain(sub_edge_t, sub_edge_inf),
            (lanes - 1) * BLS_FQ_MULS["subgroup_check"],
            sub_edge_t.numel() * W + 2 * lanes,
        ),
        "multi_pairing": (
            lambda: k_pair.multi_pairing(p_aff, no_inf, q_aff, no_inf),
            lambda: k_pair.multi_pairing_plain(p_aff, no_inf, q_aff, no_inf),
            (lanes + 1) * BLS_FQ_MULS["miller_steps"]
            + (68 * (lanes + 1) - 1) * BLS_FQ_MULS["line"]
            + BLS_FQ_MULS["miller_sqr"]
            + BLS_FQ_MULS["final_exp"],
            (p_aff.numel() + q_aff.numel() + 144) * W + 2 * (lanes + 1),
        ),
        # the KZG checks' 2-pair product (phase 7)
        "multi_pairing[2]": (
            lambda: k_pair.multi_pairing(p_aff[:2], no_inf[:2], q_aff[:2], no_inf[:2]),
            lambda: k_pair.multi_pairing_plain(p_aff[:2], no_inf[:2], q_aff[:2], no_inf[:2]),
            2 * BLS_FQ_MULS["miller_steps"]
            + (68 * 2 - 1) * BLS_FQ_MULS["line"]
            + BLS_FQ_MULS["miller_sqr"]
            + BLS_FQ_MULS["final_exp"],
            (p_aff[:2].numel() + q_aff[:2].numel() + 144) * W + 2 * 2,
        ),
        "hash_to_g2": (
            lambda: k_htc.hash_to_g2(u),
            lambda: k_htc.hash_to_g2_plain(u),
            lanes * BLS_FQ_MULS["hash_to_g2"],
            u.numel() * W + lanes * 72 * W,
        ),
    }
    out = {
        "phase": "bls_kernel_checks",
        "lanes": lanes,
        "segment": [lanes, k],
        "pairs": lanes + 1,
        "hash_to_g2_edge_lanes": htc_lanes,
        "kernels": {},
    }
    for name, (kernel, plain, fq_muls, nbytes) in cases.items():
        # a conversion's work: (Fq products, its inversion's 32-bit work)
        fq_muls, *inv_work = fq_muls if isinstance(fq_muls, tuple) else (fq_muls,)
        got = kernel()
        want, plain_ms = _plain_ms(plain)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain version (max_abs_err {err})")
        ms = _time_ms(kernel, reps=3, warmup=1)
        out["kernels"][name] = {
            "equal_plain": True,
            "max_abs_err": err,
            "rows_differing": int((got != want).reshape(max(got.shape[0], 1), -1).any(-1).sum()) if got.dim() else 0,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": None,
            **_bound(fq_muls, nbytes, "fq", *inv_work),
        }
    # the stage values the checks above used are themselves right
    sub = k_pair.g2_subgroup_check(q_aff[:lanes], no_inf[:lanes])
    if not bool(sub.all()):
        raise AssertionError("g2_subgroup_check rejected subgroup points")
    if k_pair.g2_subgroup_check(sub_edge_t, sub_edge_inf).tolist() != sub_edge_want:
        raise AssertionError("g2_subgroup_check's verdicts on the edge points are not the expected ones")
    for group, t in (("g1", g1_aff_edge_t), ("g2", g2_aff_edge_t)):
        if k_g.to_affine(group, t)[sorted(aff_inf)].any():
            raise AssertionError(f"{group}_to_affine: an infinity lane is not (0, 0)")
    # the G1 ladder's two layouts by lane count: where the team's warp a
    # lane stops paying (bls_g1_scalar_mul's G1_TEAM_MAX_LANES)
    out["g1_scalar_mul_layouts_ms"] = {
        n: {
            layout: _time_ms(
                lambda n=n, layout=layout: k_g.scalar_mul("g1", g1_wide[:n], wide_t[:n], layout=layout), reps=3, warmup=1
            )
            for layout in k_g.G1_LAYOUTS
        }
        for n in (lanes, 256, 512, 768, 1024, 2048, wide)
    }
    out["registers"] = {
        "bls381_htc.cu": _ptxas_of(k_htc.LIB, "hash_to_g2"),
        "bls381_g.cu": _ptxas_of(k_g.LIB, "g1_ladder", "g2_ladder", "scalar_mul_kernel", "to_affine", "segment_sum"),
        "bls381_pairing.cu": _ptxas_of(k_pair.LIB, "subgroup_check"),
    }
    emit(out)
    return out


def _u64_max_abs_err(got: np.ndarray, want: np.ndarray) -> int:
    return int(np.where(got > want, got - want, want - got).max()) if got.size else 0


def _sweep_err(got: list, want: list) -> int:
    return max(_u64_max_abs_err(g, w) for g, w in zip(got, want))


def _sweep_plan_info(plan: tuple) -> dict:
    grid, threads, tile, keep = plan
    return {
        "grid": grid, "threads": threads, "tile": tile, "keep": keep,
        "kept_validators": grid * keep,
        "dynamic_shared_bytes": k7.KEPT_BYTES * keep,
    }


def _sweep_wrapper_split(cols: dict, scalars: np.ndarray, dev) -> tuple:
    """`epoch_sweep_arrays`' three steps, called one by one with CUDA
    events between them: the columns' uploads (`sweep_tensors`), the
    kernel (`epoch_sweep`), the two downloads (`sweep_results`) (ms on the
    card's clock), and the host's ms for each. Returns (split, results)."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    h = [time.perf_counter()]
    ev[0].record()
    tensors = k7.sweep_tensors(cols, scalars, dev)
    ev[1].record()
    h.append(time.perf_counter())
    out = k7.epoch_sweep(*tensors)
    ev[2].record()
    h.append(time.perf_counter())
    results = k7.sweep_results(out)
    ev[3].record()
    torch.cuda.synchronize()
    h.append(time.perf_counter())
    split = {
        "uploads_ms": ev[0].elapsed_time(ev[1]),
        "kernel_ms": ev[1].elapsed_time(ev[2]),
        "downloads_ms": ev[2].elapsed_time(ev[3]),
        "host_ms": {k: (b - a) * 1e3 for k, a, b in zip(("uploads", "launch", "downloads"), h, h[1:])},
        "total_ms": (h[3] - h[0]) * 1e3,
        "upload_bytes": sum(int(v.nbytes) for v in cols.values()) + int(scalars.nbytes),
        "download_bytes": 2 * 8 * len(cols["balances"]),
    }
    return split, results


def _sweep_registers() -> dict:
    usage = ptxas_usage(k7.LIB.info.get("ptxas", ""))
    return {
        name: next((v for k, v in usage.items() if name in k), None)
        for name in ("sweep_coop", "sweep_sums", "sweep_apply")
    }


def phase_epoch_sweep_check(seed: int) -> dict:
    """The epoch-sweep kernel (one cooperative launch) and the two-kernel
    sweep it replaced, each equal to the plain version on the card at 2^20
    validators, out of the inactivity leak and in it, with the edge rows of
    `epoch_sweep_inputs`, and at EPOCH_SWEEP_ABOVE_KEEP (past the
    shared-memory keep). Times in the same call, in turns (new, replaced,
    replaced, new): back to back (`_time_ms`, 50 reps, the host's launch
    overhead inside) and on the card alone (`_gpu_ms`); the cooperative
    launch at each of EPOCH_SWEEP_SHAPES; the plain version's; the
    wrapper's with the copies to and from the card (from writable columns
    and from read-only ones, as the main path's), split into uploads,
    kernel and downloads; launch shapes, registers, the bytes each design
    moves, and the bound."""
    dev = torch.device("cuda")
    n = 1 << 20
    rng = np.random.default_rng(seed + 7)
    cases, times = {}, {}
    for leak in (False, True):
        cols, scalars = epoch_sweep_inputs(rng, n, leak)
        args = k7.sweep_tensors(cols, scalars, dev)
        want = k7.sweep_results(k7.epoch_sweep_plain(*args))
        got = k7.sweep_results(k7.epoch_sweep(*args))
        replaced = k7.sweep_results(k7.epoch_sweep_two_pass(*args))
        torch.cuda.synchronize()
        err, replaced_err = _sweep_err(got, want), _sweep_err(replaced, want)
        if err or replaced_err:
            raise AssertionError(
                f"epoch_sweep (in_leak={leak}) differs from its plain version: {err}; the replaced sweep: {replaced_err}"
            )

        def new():
            return k7.epoch_sweep(*args)

        def old():
            return k7.epoch_sweep_two_pass(*args)

        turns = [_time_ms(fn, reps=50) for fn in (new, old, old, new)]
        gpu = _gpu_ms([new, old, old, new])
        _, plain_ms = _plain_ms(lambda: k7.epoch_sweep_plain(*args))
        shapes = {}
        if not leak:
            tensors = dict(zip(k7.COLUMNS, args[:8]))
            for threads, bps in EPOCH_SWEEP_SHAPES:
                plan = k7._shaped_plan(dev, n, threads, bps)
                shape_err = _sweep_err(k7.sweep_results(k7._launch(tensors, args[8], plan)), want)
                if shape_err:
                    raise AssertionError(f"epoch_sweep at {threads} threads x {bps} differs from plain: {shape_err}")
                fn = lambda plan=plan: k7._launch(tensors, args[8], plan)  # noqa: E731
                shapes[f"{threads}x{bps}"] = {
                    **_sweep_plan_info(plan),
                    "ms": _time_ms(fn, reps=50),
                    "gpu_ms": _gpu_ms([fn])[0],
                }
        products = cols["effective_balance"].astype(object) * cols["scores"].astype(object)
        t0 = time.perf_counter()
        k7.epoch_sweep_arrays(cols, scalars, dev)
        torch.cuda.synchronize()
        wrapper_ms = (time.perf_counter() - t0) * 1e3
        # read-only columns, as the main path's EpochArrays hands them over
        frozen = {k: v.copy() for k, v in cols.items()}
        for v in frozen.values():
            v.flags.writeable = False
        t0 = time.perf_counter()
        k7.epoch_sweep_arrays(frozen, scalars, dev)
        torch.cuda.synchronize()
        wrapper_frozen_ms = (time.perf_counter() - t0) * 1e3
        split, split_out = _sweep_wrapper_split(frozen, scalars, dev)
        if _sweep_err(split_out, want):
            raise AssertionError("epoch_sweep_arrays' steps differ from the plain version")
        cases[f"in_leak={int(leak)}"] = {
            "max_abs_err": err,
            "replaced_max_abs_err": replaced_err,
            "ms": (turns[0] + turns[3]) / 2,
            "replaced_ms": (turns[1] + turns[2]) / 2,
            "ms_in_turns": turns,
            "gpu_ms": (gpu[0] + gpu[3]) / 2,
            "replaced_gpu_ms": (gpu[1] + gpu[2]) / 2,
            "gpu_ms_in_turns": gpu,
            "plain_ms": plain_ms,
            "shapes": shapes,
            "wrapper_with_copies_ms": wrapper_ms,
            "wrapper_frozen_columns_ms": wrapper_frozen_ms,
            "wrapper_frozen_columns_split": split,
            "rows_product_ge_2_63": int((products >= 1 << 63).sum()),
            "rows_far_future_exit": int((cols["exit_epoch"] == np.uint64(FAR_FUTURE_EPOCH)).sum()),
            "rows_balance_to_zero": int((got[0] == 0).sum()),
        }
        times[leak] = (cases[f"in_leak={int(leak)}"]["ms"], plain_ms)
        del args

    # past the shared-memory keep: the tiles' tails re-read from device memory
    big = EPOCH_SWEEP_ABOVE_KEEP
    cols, scalars = epoch_sweep_inputs(rng, big, False)
    args = k7.sweep_tensors(cols, scalars, dev)
    plan = k7.launch_plan(dev, big)
    want = k7.sweep_results(k7.epoch_sweep_plain(*args))
    got_big = _sweep_err(k7.sweep_results(k7.epoch_sweep(*args)), want)
    replaced_big = _sweep_err(k7.sweep_results(k7.epoch_sweep_two_pass(*args)), want)
    if got_big or replaced_big or plan[3] >= plan[2]:
        raise AssertionError(
            f"epoch_sweep at {big} validators (plan {plan}): {got_big}, replaced {replaced_big}, or nothing re-read"
        )
    big_turns = [_time_ms(fn, reps=20) for fn in (
        lambda: k7.epoch_sweep(*args), lambda: k7.epoch_sweep_two_pass(*args),
        lambda: k7.epoch_sweep_two_pass(*args), lambda: k7.epoch_sweep(*args),
    )]
    above_keep = {
        "validators": big,
        **_sweep_plan_info(plan),
        "re_read_validators": big - plan[0] * plan[3],
        "max_abs_err": got_big,
        "replaced_max_abs_err": replaced_big,
        "ms": (big_turns[0] + big_turns[3]) / 2,
        "replaced_ms": (big_turns[1] + big_turns[2]) / 2,
        "bound_ms_bytes": EPOCH_SWEEP_BYTES * big / HBM_BYTES_PER_S * 1e3,
    }
    del args

    ops_s = EPOCH_SWEEP_MIN_OPS * n / INT32_OPS_PER_S
    bytes_s = EPOCH_SWEEP_BYTES * n / HBM_BYTES_PER_S
    plan = k7.launch_plan(dev, n)
    out = {
        "phase": "kernel_checks",
        "kernel": "epoch_sweep",
        "validators": n,
        "cases": cases,
        "max_abs_err": max(max(c["max_abs_err"], c["replaced_max_abs_err"]) for c in cases.values()),
        "ms": times[False][0],
        "replaced_ms": cases["in_leak=0"]["replaced_ms"],
        "gpu_ms": cases["in_leak=0"]["gpu_ms"],
        "replaced_gpu_ms": cases["in_leak=0"]["replaced_gpu_ms"],
        "plain_ms": times[False][1],
        "library_ms": "none (no PyTorch call computes the sweep)",
        "launch": {**_sweep_plan_info(plan), "static_shared_bytes": k7._limits(dev, plan[1], 0)[1]},
        "registers": _sweep_registers(),
        "device_bytes_per_validator": EPOCH_SWEEP_DESIGN_BYTES,
        "above_keep": above_keep,
        "bytes_per_validator": EPOCH_SWEEP_BYTES,
        "min_ops_per_validator": EPOCH_SWEEP_MIN_OPS,
        "bound_ms_ops": ops_s * 1e3,
        "bound_ms_bytes": bytes_s * 1e3,
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
    }
    emit(out)
    return out


def phase_bls_main_path(state, types, E, seed: int) -> tuple[dict, dict]:
    """The BLS batch verifier on one mainnet Deneb block at `state`'s
    registry, through crypto.bls.verify_signature_sets under the `cuda`
    backend; verdicts held to the port's host backend, stage values to the
    host oracle."""
    import random
    import statistics

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        FQ,
        FQ2,
        g2_affine_to_bytes,
        g2_from_bytes,
        g2_to_bytes,
        hash_to_g2,
        msm,
        to_affine,
    )
    from lighthouse_tpu_torch.ops.bls381_verify import verify_signature_sets_device_full
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec

    t0 = time.perf_counter()
    blk = bls_block(state, types, E, mainnet_spec(), seed)
    sets = blk["sets"]
    setup_s = time.perf_counter() - t0
    n_pubkeys = sum(len(s.pubkeys) for s in sets)
    chunk = bls.DEFAULT_DEVICE_CHUNK

    # warm the pubkey decompression and limb caches, as a node's validator
    # pubkey cache has them; a new block's signatures are not cached
    bls.set_backend("cuda")
    if not bls.verify_signature_sets(sets, random.Random(seed)):
        raise AssertionError("(a) the cuda backend rejected the valid block")

    def fresh_signatures():
        bls._SIG_CACHE.clear()
        return [bls.SignatureSet(bls.Signature(s.signature.to_bytes()), s.pubkeys, s.message) for s in sets]

    # the main path: counts at zero just before, read just after; each
    # verify decompresses the block's signatures anew
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_bls_counts()
    times = []
    seg_shapes: dict = {"g1_segment_sum": {}, "g2_segment_sum": {}}
    with _segment_sum_shapes(seg_shapes):
        for rep in range(5):
            block = fresh_signatures()
            t0 = time.perf_counter()
            ok = bls.verify_signature_sets(block, random.Random(seed + rep))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not ok:
                raise AssertionError(f"(a) the cuda backend rejected the valid block (run {rep})")
    counts = bls_counts()
    for name, shapes in seg_shapes.items():
        if sum(v["launches"] for v in shapes.values()) != counts[name]:
            raise AssertionError(f"{name}: launches by shape {shapes} do not add up to {counts[name]}")
    peak = torch.cuda.max_memory_allocated()
    block = fresh_signatures()
    t0 = time.perf_counter()
    for s in block:
        s.signature.point()
    sig_decompress_s = time.perf_counter() - t0
    block = fresh_signatures()
    profile = _profile_block(lambda: bls.verify_signature_sets(block, random.Random(seed)))
    missing = [n for n in BLS_KERNELS if counts[n] <= 0]
    if missing:
        raise AssertionError(f"the BLS main path launched no {missing}")

    # verdicts (a)-(e), cuda against host
    def both(name, batch, want):
        bls.set_backend("cuda")
        got_cuda = bls.verify_signature_sets(batch, random.Random(seed))
        bls.set_backend("host")
        t0 = time.perf_counter()
        got_host = bls.verify_signature_sets(batch, random.Random(seed))
        host_s = time.perf_counter() - t0
        if got_cuda is not want or got_host is not want:
            raise AssertionError(f"verdict {name}: cuda {got_cuda}, host {got_host}, expected {want}")
        return host_s

    def replaced(i, sig):
        out = list(sets)
        out[i] = bls.SignatureSet(sig, sets[i].pubkeys, sets[i].message)
        return out

    rng = np.random.default_rng(seed + 3)
    host_block_s = both("(a) block", sets, True)
    both("(b) a signature over another message", replaced(2 + 5, bls.Signature(blk["wrong_msg_sig"])), False)
    x, y = bls_twist_point_outside_subgroup(rng)
    both("(c) a signature outside G2", replaced(2 + 7, bls.Signature(g2_affine_to_bytes((x, y)))), False)
    both("(d) an infinity signature", replaced(2 + 9, bls.Signature(bls.INFINITY_SIGNATURE)), False)
    both("(e) a gossip batch of 64", blk["gossip"], True)
    bls.set_backend("cuda")

    # stage values against the host oracle, with the same scalars
    rand = random.Random(seed)
    stages: list = []
    for i in range(0, len(sets), chunk):
        if not verify_signature_sets_device_full(sets[i : i + chunk], rand, stages=stages):
            raise AssertionError("the stage run rejected the valid block")
    n_msgs = 0
    for c, st in enumerate(stages):
        part = sets[c * chunk : (c + 1) * chunk]
        for m, hm in zip(st["messages"], st["hm"]):
            want = g2_to_bytes(hash_to_g2(m))
            got = g2_affine_to_bytes(_g2_affine(hm))
            if got != want:
                raise AssertionError(f"chunk {c}: H(m) differs from the host hash_to_g2")
            n_msgs += 1
        sig_sum = to_affine(FQ2, msm(FQ2, [g2_from_bytes(s.signature.to_bytes()) for s in part], st["scalars"]))
        if _g2_affine(st["agg_sig"]) != sig_sum:
            raise AssertionError(f"chunk {c}: sum r_i sig_i differs from the host")
        for m, got in zip(st["messages"], st["msg_pk"]):
            idx = [j for j, s in enumerate(part) if s.message == m]
            aggs = [bls.aggregate_pubkeys(part[j].pubkeys).point() for j in idx]
            want = to_affine(FQ, msm(FQ, aggs, [st["scalars"][j] for j in idx]))
            if tuple(k_g.fq_from_limbs(got)) != want:
                raise AssertionError(f"chunk {c}: a message's sum r_i aggpk_i differs from the host")
    med = statistics.median(times)
    out = {
        "phase": "bls_main_path",
        "preset": E.NAME,
        "fork": "deneb",
        "validators": len(state.validators),
        "active": blk["active"],
        "committee_size": blk["committee_size"],
        "sets": len(sets),
        "pubkeys": n_pubkeys,
        "messages": len({s.message for s in sets}),
        "chunks": [len(sets[i : i + chunk]) for i in range(0, len(sets), chunk)],
        "signers": blk["signers"],
        "keygen_s": blk["keygen_s"],
        "sign_s": blk["sign_s"],
        "setup_s": setup_s,
        "verify_s": times,
        "verify_median_s": med,
        "sig_decompress_s": sig_decompress_s,
        "sets_per_s": len(sets) / med,
        "pubkeys_per_s": n_pubkeys / med,
        "launches": {n: counts[n] for n in BLS_KERNELS},
        "launches_per_block": {n: counts[n] / 5 for n in BLS_KERNELS},
        "segment_sum_launches_by_shape": seg_shapes,
        "max_memory_allocated_bytes": peak,
        "profile": profile,
        "host_backend_block_s": host_block_s,
        "verdicts_equal_host": ["(a)", "(b)", "(c)", "(d)", "(e)"],
        "hm_equal_host": n_msgs,
        "stage_sums_equal_host_chunks": len(stages),
    }
    emit(out)
    return out, blk["sk_of"]


@contextlib.contextmanager
def _segment_sum_shapes(log: dict):
    """While open, K2.segment_sum's calls by [n, k] into log[name]: the
    calls and the kernel launches they made (a pass each; the wrapper's
    COUNTS, read around each call)."""
    inner = k_g.segment_sum

    def recorded(group, pts):
        name = f"{group}_segment_sum"
        before = k_g.COUNTS[name]
        out = inner(group, pts)
        v = log[name].setdefault(f"[{pts.shape[0]},{pts.shape[1]}]", {"calls": 0, "launches": 0})
        v["calls"] += 1
        v["launches"] += k_g.COUNTS[name] - before
        return out

    k_g.segment_sum = recorded
    try:
        yield
    finally:
        k_g.segment_sum = inner


def _device_ms_by_name(prof) -> dict:
    """Device self time (ms) of each event name of a torch.profiler run."""
    by_name: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    return by_name


def _profile_block(fn) -> dict:
    """One more block verify under torch.profiler: the card's kernel time
    (the sum of device self times) against the host clock, and the kernels
    that take it. Run after the main path's counts are read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the profiled block verify rejected the valid block")
    by_name = _device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {
        "wall_s": wall,
        "device_kernel_ms": device_ms if by_name else None,
        "device_busy_share": device_ms / (wall * 1e3) if by_name else None,
        "kernels_ms": {k[:60]: v for k, v in top},
    }


def _g2_affine(limbs) -> tuple:
    v = k_g.fq_from_limbs(limbs)
    return ((v[0], v[1]), (v[2], v[3]))


BLS_KERNELS = {
    # name: (module, source, the JAX function it replaces)
    "g1_scalar_mul": (k_g, "bls381_g.cu", "lighthouse_tpu/ops/bls381.py:481"),
    "g2_scalar_mul": (k_g, "bls381_g.cu", "lighthouse_tpu/ops/bls381.py:487"),
    "g1_segment_sum": (k_g, "bls381_g.cu", "lighthouse_tpu/ops/bls381_verify.py:103"),
    "g2_segment_sum": (k_g, "bls381_g.cu", "lighthouse_tpu/ops/bls381_verify.py:108"),
    "g1_to_affine": (k_g, "bls381_g.cu", "lighthouse_tpu/ops/bls381_verify.py:122"),
    "g2_to_affine": (k_g, "bls381_g.cu", "lighthouse_tpu/ops/bls381_verify.py:138"),
    "g2_subgroup_check": (k_pair, "bls381_pairing.cu", "lighthouse_tpu/ops/bls381_pairing.py:418"),
    "multi_pairing": (k_pair, "bls381_pairing.cu", "lighthouse_tpu/ops/bls381_pairing.py:340"),
    "hash_to_g2": (k_htc, "bls381_htc.cu", "lighthouse_tpu/ops/bls381_htc.py:311"),
}


def bls_counts() -> dict:
    return {n: mod.COUNTS[n] for n, (mod, _, _) in BLS_KERNELS.items()}


def reset_bls_counts() -> None:
    for mod in (k_g, k_pair, k_htc):
        mod.reset_counts()


def phase_main_path(n: int, updates: int, seed: int) -> dict:
    E = MainnetEthSpec
    types = build_types(E)
    t0 = time.perf_counter()
    state = build_deneb_state(types, E, n, seed)
    _make_persistent(state)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)

    # the main path: counts at zero just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k_sha256.reset_counts()
    t0 = time.perf_counter()
    cold_root = state.hash_tree_root()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_counts = dict(k_sha256.COUNTS)
    snapshots = [state.copy()]
    roots, update_s = [cold_root], []
    for _ in range(updates):
        block_update(state, E, rng)
        t0 = time.perf_counter()
        roots.append(state.hash_tree_root())
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        snapshots.append(state.copy())
    counts = dict(k_sha256.COUNTS)
    peak_bytes = torch.cuda.max_memory_allocated()
    if counts["launches"] <= 0 or counts["rows"] <= 0:
        raise AssertionError(f"main path launched no SHA-256 kernel: {counts}")

    # checks, after the counts are read
    t0 = time.perf_counter()
    host_root = host_state_root(snapshots[0])
    oracle_s = time.perf_counter() - t0
    if k_sha256.COUNTS != counts:
        raise AssertionError("the host-lane oracle reached the kernel")
    if host_root != cold_root:
        raise AssertionError(
            f"cold root {cold_root.hex()} != host-lane root {host_root.hex()}"
        )
    for i, snap in enumerate(snapshots[1:], start=1):
        snap.__dict__.pop("_thc_cache")
        fresh = snap.hash_tree_root()
        if fresh != roots[i]:
            raise AssertionError(
                f"update {i}: incremental root {roots[i].hex()} != fresh-cache root {fresh.hex()}"
            )
    out = {
        "phase": "main_path",
        "preset": E.NAME,
        "fork": "deneb",
        "validators": n,
        "updates": updates,
        "state_build_s": build_s,
        "cold_root_s": cold_s,
        "update_root_s": update_s,
        "update_root_median_s": float(np.median(update_s)) if update_s else None,
        "cold_root": cold_root.hex(),
        "cold_root_equal_host_lanes": True,
        "host_lane_oracle_s": oracle_s,
        "incremental_equal_fresh_cache": updates,
        "sha256_launches": counts["launches"],
        "sha256_rows": counts["rows"],
        "sha256_launches_cold": cold_counts["launches"],
        "sha256_rows_cold": cold_counts["rows"],
        "max_memory_allocated_bytes": peak_bytes,
    }
    emit(out)
    return out, state


# ---------------------------------------------------------------------------
# Phase 6: the state transition across an epoch boundary
# ---------------------------------------------------------------------------

# Spans of the transition the port's utils/tracing records (histograms
# `trace_span_seconds_<name>`), read as per-rep sums.
TRANSITION_SPANS = (
    "epoch_transition",
    "epoch_stage_columns_refresh",
    "epoch_stage_justification",
    "epoch_stage_rewards",
    "epoch_stage_registry_updates",
    "epoch_stage_slashings",
    "epoch_stage_effective_balances",
    "epoch_stage_final_updates",
    "signature_set_assembly",
    "signature_batch_verify",
    "attestation_apply",
)


def _span_sums() -> dict:
    from lighthouse_tpu_torch.metrics import REGISTRY

    return {name: REGISTRY.histogram(f"trace_span_seconds_{name}").sum for name in TRANSITION_SPANS}


def _column_rebuilds() -> float:
    from lighthouse_tpu_torch.metrics import REGISTRY

    return sum(REGISTRY.counter("registry_columns_rebuilds_total").values().values())


def epoch_prestate(state, E, spec, seed: int) -> dict:
    """Make `state` (the registry of phases 4 and 5, tree-states) the
    pre-state of an epoch transition, in place, from `seed`: the last slot
    of an epoch that is neither a sync-committee period nor a
    historical-summary boundary; justified checkpoints one and two epochs
    back, finalized two back (no inactivity leak); effective balances at or
    below the ejection balance raised to 32 ETH but for 16 that registry
    updates eject; balances spread around the effective balances, so
    hysteresis moves some; 95% of both epochs' participation flags timely
    source, target and head, the rest mixed; 1% of inactivity scores
    nonzero; the slashed validators exiting, half of them at the epoch that
    process_slashings penalises, the rest withdrawable later; 128
    validators entering the activation queue, 128 in it, 64 exits queued.
    Attaches the resident registry columns and warms the root cache."""
    from lighthouse_tpu_torch.state_processing.accessors import get_block_root
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for

    rng = np.random.default_rng(seed + 11)
    n = len(state.validators)
    S = E.SLOTS_PER_EPOCH
    epoch = int(state.slot) // S
    while (epoch + 1) % E.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0 or (epoch + 1) % (
        E.SLOTS_PER_HISTORICAL_ROOT // S
    ) == 0:
        epoch += 1
    state.slot = epoch * S + S - 1
    cols = registry_columns_for(state)
    cols.refresh(state)
    vs = state.validators
    eb = np.array(cols.effective_balance, dtype=np.uint64)
    slashed = np.array(cols.slashed)
    active = (cols.activation_epoch <= np.uint64(epoch)) & (np.uint64(epoch) < cols.exit_epoch)

    def put(idx, field, value):
        vs.set_fields_bulk(idx.tolist(), field, [value] * int(idx.size))

    low = np.nonzero(active & (eb <= np.uint64(spec.ejection_balance)) & ~slashed)[0]
    ejected = rng.choice(low, 16, replace=False)
    raised = np.setdiff1d(low, ejected)
    put(raised, "effective_balance", E.MAX_EFFECTIVE_BALANCE)
    eb[raised] = E.MAX_EFFECTIVE_BALANCE

    sl = np.nonzero(slashed)[0]
    at_penalty = sl[rng.random(sl.size) < 0.5]
    later = np.setdiff1d(sl, at_penalty)
    put(sl, "exit_epoch", epoch + 2)
    put(at_penalty, "withdrawable_epoch", epoch + E.EPOCHS_PER_SLASHINGS_VECTOR // 2)
    put(later, "withdrawable_epoch", epoch + 200)
    for i in range(E.EPOCHS_PER_SLASHINGS_VECTOR):
        state.slashings[i] = 0
    state.slashings[epoch % E.EPOCHS_PER_SLASHINGS_VECTOR] = int(eb[sl].sum())

    pool = np.nonzero(active & ~slashed & (cols.exit_epoch == np.uint64(FAR_FUTURE_EPOCH)))[0]
    pick = rng.choice(np.setdiff1d(pool, ejected), 128 + 128 + 64, replace=False)
    entering, queued, exiting = pick[:128], pick[128:256], pick[256:]
    put(entering, "activation_eligibility_epoch", FAR_FUTURE_EPOCH)
    put(entering, "activation_epoch", FAR_FUTURE_EPOCH)
    put(entering, "effective_balance", E.MAX_EFFECTIVE_BALANCE)
    eb[entering] = E.MAX_EFFECTIVE_BALANCE
    put(queued, "activation_eligibility_epoch", epoch - 3)
    put(queued, "activation_epoch", FAR_FUTURE_EPOCH)
    put(exiting, "exit_epoch", epoch + 3)
    put(exiting, "withdrawable_epoch", epoch + 3 + 256)

    Checkpoint = type(state.finalized_checkpoint)
    state.previous_justified_checkpoint = Checkpoint(epoch=epoch - 2, root=get_block_root(state, epoch - 2, E))
    state.current_justified_checkpoint = Checkpoint(epoch=epoch - 1, root=get_block_root(state, epoch - 1, E))
    state.finalized_checkpoint = Checkpoint(epoch=epoch - 2, root=get_block_root(state, epoch - 2, E))
    state.justification_bits = [True, True, False, False]

    for field in ("previous_epoch_participation", "current_epoch_participation"):
        flags = np.full(n, 7, np.uint8)
        mixed = rng.random(n) < 0.05
        flags[mixed] = rng.integers(0, 7, int(mixed.sum()), dtype=np.uint8)
        getattr(state, field).store_array(flags)
    scores = np.zeros(n, np.uint64)
    some = rng.random(n) < 0.01
    scores[some] = rng.integers(1, 100, int(some.sum()), dtype=np.uint64)
    state.inactivity_scores.store_array(scores)
    balances = (eb.astype(np.int64) + rng.normal(2e7, 1e8, n).astype(np.int64)).clip(0)
    state.balances.store_array(balances.astype(np.uint64))

    cols.refresh(state)
    t0 = time.perf_counter()
    state.hash_tree_root()
    return {
        "epoch": epoch,
        "slot": int(state.slot),
        "ejected": int(ejected.size),
        "effective_balance_raised": int(raised.size),
        "slashed": int(sl.size),
        "slashed_at_penalty_epoch": int(at_penalty.size),
        "activation_entering": int(entering.size),
        "activation_queued": int(queued.size),
        "exits_queued": int(exiting.size),
        "inactivity_scores_nonzero": int(some.sum()),
        "warm_root_s": time.perf_counter() - t0,
    }


def transition_block(pre, types, E, spec, sk_of: dict, seed: int, commitments: list[bytes]) -> dict:
    """One full mainnet Deneb block for the first slot after `pre`'s epoch
    boundary, built with the port's accessors: the proposer from
    get_beacon_proposer_index, its RANDAO reveal, one Attestation per
    committee of the two previous slots (get_beacon_committee; ~98% of
    bits set), the sync aggregate of the current sync committee (~98% of
    bits set), an execution payload with the parent hash, prev_randao,
    timestamp and get_expected_withdrawals the state asks for, and the
    blobs' KZG `commitments` (blob gas to match). Every signature is real: signers without a key from phase 5
    get seeded keys, written into `pre`'s registry and the pubkey cache.
    The block's state_root is the post-state's, from a run without
    signature checks; also returns a copy of the block with one
    attestation signed over another message (re-signed by the proposer)."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_processing import (
        BlockSignatureStrategy,
        per_block_processing,
        per_slot_processing,
    )
    from lighthouse_tpu_torch.state_processing import signature_sets as ss
    from lighthouse_tpu_torch.state_processing.accessors import (
        committee_cache_at,
        get_beacon_committee,
        get_beacon_proposer_index,
        get_block_root,
        get_block_root_at_slot,
        get_domain,
        get_randao_mix,
    )
    from lighthouse_tpu_torch.state_processing.bellatrix import compute_timestamp_at_slot
    from lighthouse_tpu_torch.state_processing.capella import get_expected_withdrawals
    from lighthouse_tpu_torch.types.chain_spec import Domain, compute_signing_root

    rng = np.random.default_rng(seed + 13)
    T = types.types_for_fork("deneb")
    S = E.SLOTS_PER_EPOCH
    slot = int(pre.slot) + 1
    epoch = slot // S
    att_epoch = epoch - 1

    committees = []
    for a_slot in (slot - 2, slot - 1):
        for index in range(committee_cache_at(pre, att_epoch, E).committees_per_slot):
            committees.append((a_slot, index, np.asarray(get_beacon_committee(pre, a_slot, index, E))))
    committees = committees[: E.MAX_ATTESTATIONS]
    bits = [rng.random(c.size) < 0.98 for _, _, c in committees]
    probe = pre.copy()
    per_slot_processing(probe, spec, E)
    proposer = get_beacon_proposer_index(probe, E)
    del probe

    attesters = np.unique(np.concatenate([c[b] for (_, _, c), b in zip(committees, bits)]))
    new = [i for i in np.union1d(attesters, [proposer]).tolist() if i not in sk_of]
    t0 = time.perf_counter()
    sks, affs, pks = bls_keys(rng, len(new))
    keygen_s = time.perf_counter() - t0
    sk_of.update(zip(new, sks))
    pre.validators.set_fields_bulk(new, "pubkey", pks)
    for (x, y), pk in zip(affs, pks):
        ss._PUBKEY_CACHE.setdefault(pk, bls.PublicKey(pk, (x, y, 1)))
    pre.hash_tree_root()

    t0 = time.perf_counter()
    mid = pre.copy()
    per_slot_processing(mid, spec, E)
    if get_beacon_proposer_index(mid, E) != proposer:
        raise AssertionError("the proposer moved with the registry's pubkeys")
    att_domain = get_domain(mid, Domain.BEACON_ATTESTER, att_epoch, spec, E)
    target = types.Checkpoint(epoch=att_epoch, root=get_block_root(mid, att_epoch, E))

    def attestation(a_slot, index, members, b, head=None):
        data = types.AttestationData(
            slot=a_slot,
            index=index,
            beacon_block_root=head or get_block_root_at_slot(mid, a_slot, E),
            source=mid.previous_justified_checkpoint,
            target=target,
        )
        sig = bls_sign(sum(sk_of[int(i)] for i in members[b]), compute_signing_root(data.hash_tree_root(), att_domain))
        return types.Attestation(aggregation_bits=b.tolist(), data=data, signature=sig)

    atts = [attestation(a, i, c, b) for (a, i, c), b in zip(committees, bits)]
    sk_by_pk = {bytes(mid.validators[i].pubkey): sk for i, sk in sk_of.items()}
    sync_pks = [bytes(pk) for pk in mid.current_sync_committee.pubkeys]
    sync_bits = (rng.random(E.SYNC_COMMITTEE_SIZE) >= 0.02).tolist()
    sync_msg = compute_signing_root(
        get_block_root_at_slot(mid, slot - 1, E),
        get_domain(mid, Domain.SYNC_COMMITTEE, (slot - 1) // S, spec, E),
    )
    sync_sig = bls_sign(sum(sk_by_pk[pk] for pk, b in zip(sync_pks, sync_bits) if b), sync_msg)
    randao = bls_sign(
        sk_of[proposer],
        compute_signing_root(epoch.to_bytes(8, "little").ljust(32, b"\x00"), get_domain(mid, Domain.RANDAO, epoch, spec, E)),
    )
    header = mid.latest_execution_payload_header
    withdrawals = get_expected_withdrawals(mid, E)
    payload = T.ExecutionPayload(
        parent_hash=header.block_hash,
        fee_recipient=rng.bytes(20),
        state_root=rng.bytes(32),
        receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256),
        prev_randao=get_randao_mix(mid, epoch, E),
        block_number=int(header.block_number) + 1,
        gas_limit=int(header.gas_limit),
        gas_used=int(rng.integers(0, int(header.gas_limit))),
        timestamp=compute_timestamp_at_slot(mid, spec, E),
        extra_data=rng.bytes(16),
        base_fee_per_gas=int(header.base_fee_per_gas),
        block_hash=rng.bytes(32),
        transactions=[rng.bytes(int(k)) for k in rng.integers(100, 600, 150)],
        withdrawals=withdrawals,
        blob_gas_used=len(commitments) * BLOB_GAS_PER_BLOB,
        excess_blob_gas=0,
    )
    block = T.BeaconBlock(
        slot=slot,
        proposer_index=proposer,
        parent_root=mid.latest_block_header.hash_tree_root(),
        state_root=b"\x00" * 32,
        body=T.BeaconBlockBody(
            randao_reveal=randao,
            eth1_data=mid.eth1_data,
            graffiti=rng.bytes(32),
            attestations=atts,
            sync_aggregate=types.SyncAggregate(sync_committee_bits=sync_bits, sync_committee_signature=sync_sig),
            execution_payload=payload,
            blob_kzg_commitments=commitments,
        ),
    )
    post = mid.copy()
    per_block_processing(
        post, T.SignedBeaconBlock(message=block, signature=b"\x00" * 96), spec, E,
        BlockSignatureStrategy.NO_VERIFICATION, verify_block_root=False,
    )
    block.state_root = post.hash_tree_root()
    proposer_domain = get_domain(mid, Domain.BEACON_PROPOSER, epoch, spec, E)

    def signed(blk):
        msg = compute_signing_root(blk.hash_tree_root(), proposer_domain)
        return T.SignedBeaconBlock(message=blk, signature=bls_sign(sk_of[proposer], msg))

    good = signed(block)
    bad = T.BeaconBlock.deserialize(block.serialize())
    other = attestation(*committees[5], bits[5], head=rng.bytes(32))
    bad.body.attestations[5].signature = other.signature
    return {
        "signed": good.serialize(),
        "tampered": signed(bad).serialize(),
        "mid": mid,
        "post_root": bytes(block.state_root),
        "attestations": len(atts),
        "attesting_validators": int(attesters.size),
        "committees_per_slot": len(committees) // 2,
        "withdrawals": len(withdrawals),
        "blob_commitments": len(commitments),
        "new_keys": len(new),
        "keygen_s": keygen_s,
        "production_s": time.perf_counter() - t0,
    }


def phase_transition_main_path(state, types, E, sk_of: dict, seed: int, commitments: list[bytes]) -> tuple[dict, bytes]:
    """Block import across an epoch boundary on the 1M-validator state, as
    a node runs it: per_slot_processing over the boundary (the epoch
    transition, the sweep on the epoch-sweep kernel), per_block_processing
    of a full signed Deneb block under VERIFY_BULK on the `cuda` BLS
    backend, then hash_tree_root(); TRANSITION_REPS times, each from a
    copy() of the same pre-state. Checks: (a) the kernel's new balances
    and scores byte-equal to the port's numpy sweep on the same pre-state
    arrays; (b) the post-block root equal to the host-lane fold; (c) the
    block accepted; (d) the block with one attestation signed over another
    message refused."""
    import statistics

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_processing import (
        BlockProcessingError,
        BlockSignatureStrategy,
        altair,
        per_block_processing,
        per_slot_processing,
    )
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
    from lighthouse_tpu_torch.types.chain_spec import ForkName, mainnet_spec

    spec = mainnet_spec()
    T = types.types_for_fork("deneb")
    bls.set_backend("cuda")
    t0 = time.perf_counter()
    prestate = epoch_prestate(state, E, spec, seed)
    prestate["setup_s"] = time.perf_counter() - t0
    pre = state
    arrays = altair.EpochArrays(pre, E, columns=registry_columns_for(pre))
    if not altair._device_sweep_applicable(pre, arrays, spec, E):
        raise AssertionError("the host guard keeps the pre-state off the epoch-sweep kernel")
    blk = transition_block(pre, types, E, spec, sk_of, seed, commitments)

    # the main path: counts at zero just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k_sha256.reset_counts()
    reset_bls_counts()
    k7.reset_counts()
    reps = []
    for rep in range(TRANSITION_REPS):
        s = pre.copy()
        signed = T.SignedBeaconBlock.deserialize(blk["signed"])
        bls._SIG_CACHE.clear()
        spans0, rebuilds0, k7_0 = _span_sums(), _column_rebuilds(), k7.COUNTS["launches"]
        t0 = time.perf_counter()
        per_slot_processing(s, spec, E)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # the state root is timed apart below and checked against the
        # block's state_root after the reps
        per_block_processing(s, signed, spec, E, BlockSignatureStrategy.VERIFY_BULK, verify_block_root=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        root = s.hash_tree_root()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        spans = {k: v - spans0[k] for k, v in _span_sums().items()}
        sig_s = spans["signature_set_assembly"] + spans["signature_batch_verify"]
        reps.append(
            {
                "total_s": t3 - t0,
                "per_slot_s": t1 - t0,
                "epoch_transition_s": spans["epoch_transition"],
                "block_s": t2 - t1,
                "block_signatures_s": sig_s,
                "block_rest_s": (t2 - t1) - sig_s,
                "state_root_s": t3 - t2,
                "spans_s": spans,
                "epoch_sweep_launches": k7.COUNTS["launches"] - k7_0,
                "registry_columns_rebuilds": _column_rebuilds() - rebuilds0,
                "root": root.hex(),
            }
        )
        post = s
    counts = {"epoch_sweep": k7.COUNTS["launches"], "sha256_rows": k_sha256.COUNTS["launches"], **bls_counts()}
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"the transition main path launched no {missing}")
    if any(r["epoch_sweep_launches"] != 1 for r in reps):
        raise AssertionError("an epoch transition ran without the epoch-sweep kernel")
    if any(r["registry_columns_rebuilds"] for r in reps[1:]):
        raise AssertionError("resident registry columns rebuilt after the first epoch")
    if len({r["root"] for r in reps}) != 1 or reps[0]["root"] != blk["post_root"].hex():
        raise AssertionError("post-block roots differ between reps or from the block's state_root")

    # (a) the kernel's sweep against the port's numpy sweep, on copies of
    # the same pre-state after justification
    a = pre.copy()
    cols = registry_columns_for(a)
    cols.refresh(a)
    arr = altair.EpochArrays(a, E, columns=cols)
    altair.process_justification_and_finalization_altair(a, E, arr)
    b = a.copy()
    launches = k7.COUNTS["launches"]
    altair._device_rewards_and_inactivity(a, spec, E, ForkName.DENEB, arr)
    if k7.COUNTS["launches"] != launches + 1:
        raise AssertionError("(a) the sweep did not launch the kernel")
    colsb = registry_columns_for(b)
    colsb.refresh(b)
    arrb = altair.EpochArrays(b, E, columns=colsb)
    altair.process_inactivity_updates(b, spec, E, arrb)
    altair.process_rewards_and_penalties_altair(b, spec, E, ForkName.DENEB, arrb)
    for field in ("balances", "inactivity_scores"):
        if getattr(a, field).load_array().tobytes() != getattr(b, field).load_array().tobytes():
            raise AssertionError(f"(a) kernel {field} differ from the numpy sweep")

    # (b) the post-block root against the host-lane fold
    t0 = time.perf_counter()
    if host_state_root(post) != bytes.fromhex(reps[0]["root"]):
        raise AssertionError("(b) post-block root differs from the host-lane fold")
    oracle_s = time.perf_counter() - t0

    # (d) one attestation signed over another message: refused
    refused = False
    try:
        per_block_processing(
            blk["mid"].copy(), T.SignedBeaconBlock.deserialize(blk["tampered"]), spec, E,
            BlockSignatureStrategy.VERIFY_BULK, verify_block_root=False,
        )
    except BlockProcessingError as e:
        refused = "bulk signature verification failed" in str(e)
    if not refused:
        raise AssertionError("(d) the block with a wrong attestation signature was accepted")

    # the cold root of the pre-state with a fresh hash cache, with and
    # without the resident registry columns (phase 4's cold root had none)
    cold = {}
    for label, keep_columns in (("with_columns", True), ("without_columns", False)):
        c = pre.copy()
        c.__dict__.pop("_thc_cache", None)
        if not keep_columns:
            c.__dict__.pop("_registry_columns", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        root = c.hash_tree_root()
        torch.cuda.synchronize()
        cold[label + "_s"] = time.perf_counter() - t0
        if root != pre.hash_tree_root():
            raise AssertionError(f"cold root {label} differs from the pre-state's")

    # one more rep under the profiler, after the counts are read
    s = pre.copy()
    signed = T.SignedBeaconBlock.deserialize(blk["signed"])
    bls._SIG_CACHE.clear()

    def one_rep():
        per_slot_processing(s, spec, E)
        per_block_processing(s, signed, spec, E, BlockSignatureStrategy.VERIFY_BULK, verify_block_root=False)
        return s.hash_tree_root() == blk["post_root"]

    profile = _profile_block(one_rep)

    med = statistics.median(r["total_s"] for r in reps)
    out = {
        "phase": "transition_main_path",
        "preset": E.NAME,
        "fork": "deneb",
        "validators": len(pre.validators),
        "prestate": prestate,
        "block": {k: v for k, v in blk.items() if k not in ("signed", "tampered", "mid", "post_root")},
        "reps": reps,
        "total_median_s": med,
        "epoch_transition_median_s": statistics.median(r["epoch_transition_s"] for r in reps),
        "per_slot_median_s": statistics.median(r["per_slot_s"] for r in reps),
        "block_median_s": statistics.median(r["block_s"] for r in reps),
        "block_signatures_median_s": statistics.median(r["block_signatures_s"] for r in reps),
        "block_rest_median_s": statistics.median(r["block_rest_s"] for r in reps),
        "state_root_median_s": statistics.median(r["state_root_s"] for r in reps),
        "launches": counts,
        "epoch_sweep_launches": counts["epoch_sweep"],
        "registry_columns_rebuilds": [r["registry_columns_rebuilds"] for r in reps],
        "max_memory_allocated_bytes": peak,
        "profile": profile,
        "host_lane_oracle_s": oracle_s,
        "prestate_cold_root": cold,
        "checks": {
            "(a) sweep equal numpy": True,
            "(b) root equal host lanes": True,
            "(c) block accepted": True,
            "(d) wrong attestation signature refused": True,
        },
    }
    emit(out)
    return out, blk["signed"]


# ---------------------------------------------------------------------------
# Phase 3 (KZG) and phase 7: blob data availability
# ---------------------------------------------------------------------------

KZG_KERNELS = {
    # name: (module, source, the JAX function it replaces)
    "barycentric_eval": (k_fr, "kzg_fr.cu", "lighthouse_tpu/ops/fr.py:156"),
    "quotient": (k_fr, "kzg_fr.cu", "lighthouse_tpu/ops/fr.py:189"),
    "msm": (k_msm, "msm.cu", "lighthouse_tpu/ops/msm.py:94"),
    "msm_table": (k_msm, "msm.cu", "lighthouse_tpu/ops/msm.py:94"),
}


def kzg_counts() -> dict:
    """The KZG kernels' counts, with the K2 and K4 kernels that the KZG
    engine also launches: K9's table ends in K2's g1_to_affine, and the
    proof checks run K4's multi-pairing."""
    return {n: mod.COUNTS[n] for n, (mod, _, _) in KZG_KERNELS.items()} | {
        "g1_to_affine": k_g.COUNTS["g1_to_affine"],
        "multi_pairing": k_pair.COUNTS["multi_pairing"],
    }


def reset_kzg_counts() -> None:
    for mod in (k_fr, k_msm, k_g, k_pair):
        mod.reset_counts()


def ceremony_kzg() -> Kzg:
    """A Kzg on the mainnet ceremony's setup, read from CEREMONY_SETUP and
    nothing else (no environment override, no fallback), and refused if
    it is the insecure dev setup, whose proofs skip the kernels."""
    from lighthouse_tpu_torch.das.proofs import _dev_secret

    setup = TrustedSetup.from_json(CEREMONY_SETUP)
    if setup.n != 4096 or _dev_secret(setup) is not None:
        raise AssertionError(f"{CEREMONY_SETUP} is not the mainnet ceremony's setup")
    return Kzg(setup)


def msm_fq_muls(scalars: list[int], bits: int = 255) -> dict:
    """Two least works of the MSM for these scalars, in Fq multiplications
    (csrc/msm.cu's header).

    Pippenger at its best window c: each nonzero digit after the first in
    its bucket is one affine addition, the additions of a bucket a tree
    whose rounds share one inversion across all buckets; running sums per
    window 2^c - 2 steps, each a mixed addition (the bucket sum is affine)
    and a Jacobian one, or both as affine additions batched across the
    windows, whichever is fewer; Horner, c doublings and one Jacobian
    addition per window but the top one.

    Fixed-base over a resident table of 8-bit windows (``fixed_fq_muls``):
    the 32 windows' digits of every scalar index table entries, all summed
    into one set of 255 buckets by the same affine additions and shared
    inversions; one running sum over the buckets (254 mixed and 254
    Jacobian additions); no doublings. `bits`: the scalars' width (255
    for Fr, 64 for the RLC draws)."""
    raw = np.frombuffer(b"".join(s.to_bytes(32, "big") for s in scalars), np.uint8).reshape(-1, 32)
    low = np.unpackbits(raw, axis=1)[:, ::-1][:, :bits].astype(np.int64)  # least significant first
    m = BLS_FQ_MULS

    def bucket_adds(dig: np.ndarray) -> int:
        cnt = np.bincount(dig.ravel(), minlength=2)[1:]
        deepest = max(int(cnt.max()), 1)
        return int(cnt.sum() - (cnt > 0).sum()) * m["g1_affine_add"] + (deepest - 1).bit_length() * m["fq_inv"]

    def windows(c: int) -> np.ndarray:
        nwin = -(-bits // c)
        b = np.pad(low, ((0, 0), (0, nwin * c - bits))).reshape(len(scalars), nwin, c)
        return (b << np.arange(c)).sum(-1)

    best = None
    for c in range(1, 17):
        dig = windows(c)
        nwin = dig.shape[1]
        adds, deepest = 0, 0
        for w in range(nwin):
            cnt = np.bincount(dig[:, w], minlength=1 << c)[1:]
            adds += int(cnt.sum() - (cnt > 0).sum())
            deepest = max(deepest, int(cnt.max()))
        steps = (1 << c) - 2
        running = min(
            steps * nwin * (m["g1_madd"] + m["g1_add"]),
            steps * 2 * (nwin * m["g1_affine_add"] + m["fq_inv"]),
        )
        muls = (
            adds * m["g1_affine_add"]
            + (deepest - 1).bit_length() * m["fq_inv"]
            + running
            + (nwin - 1) * (c * m["g1_dbl"] + m["g1_add"])
        )
        if best is None or muls < best[1]:
            best = (c, muls)
    fixed = bucket_adds(windows(8)) + 254 * (m["g1_madd"] + m["g1_add"])
    return {"window": best[0], "fq_muls": best[1], "fixed_fq_muls": fixed}


def msm_table_work(walk: torch.Tensor) -> tuple[int, int, int]:
    """The least work of the fixed-base table of n affine points, from
    this run's doubling walk ([32, n, 3, 12] Jacobian, window 0 the
    points): 31 windows of 8 doublings each (the first from an affine
    point), then the 31n new entries made affine by one batch inversion
    over the live ones (``_to_affine_work``: 3 products an entry, 4 a lane
    for Z^-2, Z^-3, x, y, and the binary Euclid's own work on the product
    of their Z, as the conversions to affine count it). Returns (Fq
    products, the inversion's 32-bit multiplies, its other operations)."""
    m = BLS_FQ_MULS
    n = walk.shape[1]
    muls, inv_muls, inv_ops = _to_affine_work("g1", walk[1:].reshape(-1, 3, 12))
    return n * (m["g1_mdbl"] + (31 * 8 - 1) * m["g1_dbl"]) + muls, inv_muls, inv_ops


def _ptxas_of(lib, *kernels: str) -> dict:
    usage = ptxas_usage(lib.info.get("ptxas", ""))
    return {k: v for k, v in usage.items() if any(name in k for name in kernels)}


def phase_kzg_kernel_checks(kzg, seed: int) -> dict:
    """The KZG kernels at the main path's shapes, each equal to its plain
    version on the card and to the host for one case: the barycentric
    evaluation at [1, 4096] (a proof), [6, 4096] (a block, and six with
    one z on the domain) and [192, 4096] (a segment), the
    quotient at 4096 lanes (z off the domain and on it), the MSM's table of
    the 4096 setup points with edge cases and the fixed-base MSM over it;
    with times, plain times and bounds."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, msm, pt_eq, pt_mul, to_affine
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    dev = kzg._dev.dev
    rng = np.random.default_rng(seed + 17)
    setup = kzg.setup
    n = setup.n
    roots_t = kzg._dev.roots
    out = {"phase": "kzg_kernel_checks", "domain": n, "kernels": {}}

    def check(name, kernel, plain, fr_muls, nbytes, reps, **extra):
        got = kernel()
        want, plain_ms = _plain_ms(plain)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain version (max_abs_err {err})")
        ms = _time_ms(kernel, reps=reps, warmup=1)
        bound = _bound(fr_muls, nbytes, "fr") if fr_muls is not None else extra.pop("bound")
        out["kernels"][name] = {
            "equal_plain": True,
            "max_abs_err": err,
            "rows_differing": int((got != want).reshape(got.shape[0], -1).any(-1).sum()),
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": None,
            **bound,
            **extra,
        }
        return got

    # a proof's one blob, a block's six, a segment's 192, and six with one
    # z on the domain (its y is 0; the others as off the domain)
    for m, on_domain in ((1, None), (BLOBS_PER_BLOCK, None), (BLOBS_PER_BLOCK * SEGMENT_BLOCKS, None), (BLOBS_PER_BLOCK, 2)):
        words = np.stack([k_fr.words_from_bytes(b, n) for b in kzg_blobs(rng, m, n)])
        zs = fr_scalars(rng, m)
        if on_domain is not None:
            zs[on_domain] = setup.roots_brp[77]
        ev, zt = k_fr.as_i32(words).to(dev), k_fr.as_i32(k_fr.fr_to_words(zs)).to(dev)
        got = check(
            f"barycentric_eval[{m},{n}]" + ("" if on_domain is None else ":on_domain"),
            lambda: k_fr.barycentric_eval(ev, roots_t, zt),
            lambda: k_fr.barycentric_eval_plain(ev, roots_t, zt),
            bary_fr_muls(m, n),
            ev.numel() * 4 + roots_t.numel() * 4 + 2 * zt.numel() * 4,
            reps=3 if m > BLOBS_PER_BLOCK else 5,
        )
        ys = k_fr.fr_from_words(got.cpu().numpy())
        for j in (0, on_domain) if on_domain is not None else (0,):
            want = 0 if j == on_domain else kzg._evaluate_host(k_fr.fr_from_words(words[j]), zs[j])
            if ys[j] != want:
                raise AssertionError(f"barycentric_eval[{m},{n}] blob {j} differs from the host")

    words = k_fr.words_from_bytes(kzg_blobs(rng, 1, n)[0], n)
    ev = k_fr.as_i32(words).to(dev)
    for label, z in (("off_domain", fr_scalars(rng, 1)[0]), ("on_domain", setup.roots_brp[5])):
        y = fr_scalars(rng, 1)[0]
        zy = k_fr.as_i32(k_fr.fr_to_words([z, y])).to(dev)
        got = check(
            f"quotient[{n}]" + ("" if label == "off_domain" else ":on_domain"),
            lambda: k_fr.quotient(ev, roots_t, zy[0], zy[1]),
            lambda: k_fr.quotient_plain(ev, roots_t, zy[0], zy[1]),
            (FR_MULS["batch_inv"] + FR_MULS["quotient_term"]) * n + FR_MULS["inv"],
            2 * ev.numel() * 4 + roots_t.numel() * 4 + zy.numel() * 4,
            reps=5,
        )
        p = k_fr.fr_from_words(words)
        q = k_fr.fr_from_words(got.cpu().numpy())
        want = [0 if w == z else (pi - y) * pow(w - z, R - 2, R) % R for pi, w in zip(p, setup.roots_brp)]
        if q != want:
            raise AssertionError(f"quotient ({label}) differs from the host formula")

    # K9: the table of the edge-case points (the setup's, with a point
    # repeated and one negated), then the fixed-base MSM over it
    pts, sc = msm_edge_case(rng, setup.g1_lagrange)
    pts_t = torch.from_numpy(k_g.g1_to_limbs(pts)).to(dev)
    sc_t = k_fr.as_i32(k_fr.fr_to_words(sc)).to(dev)
    table = k_msm.g1_msm_table(pts_t)
    plain_table, plain_table_ms = _plain_ms(lambda: k_msm.g1_msm_table_plain(pts_t))
    torch.cuda.synchronize()
    for part, got_t, want_t in zip(("xy", "inf"), table, plain_table):
        if not torch.equal(got_t, want_t):
            raise AssertionError(f"msm_table: the {part} differs from its plain version")
    # the table's own kernel, the doubling walk, limb for limb
    walk, walk_inf = k_msm.g1_msm_table_walk(pts_t)
    plain_walk, plain_walk_inf = k_msm.g1_msm_table_walk_plain(pts_t)
    if not (torch.equal(walk, plain_walk) and torch.equal(walk_inf, plain_walk_inf)):
        raise AssertionError("msm_table's doubling walk differs from its plain version")
    del plain_walk
    host_rows = [0, 1, 2, 3, 6, 7, n - 1]
    xy = table.xy.cpu().numpy()
    for w in (0, 1, 17, k_msm.WINDOWS - 1):
        for i in host_rows:
            want_xy = to_affine(FQ, pt_mul(FQ, pts[i], 1 << (k_msm.WINDOW * w)))
            if tuple(k_g.fq_from_limbs(xy[w, i].reshape(2, 12))) != want_xy:
                raise AssertionError(f"msm_table entry ({w}, {i}) differs from the host's pt_mul")
    table_bytes = pts_t.numel() * 8 + table.xy.numel() * 8 + table.inf.numel()
    table_muls, *table_inv = msm_table_work(walk)
    out["kernels"][f"msm_table[{n}]"] = {
        "equal_plain": True,
        "equal_host_entries": 4 * len(host_rows),
        "max_abs_err": _max_abs_err(table.xy, plain_table.xy),
        "rows_differing": int((table.xy != plain_table.xy).reshape(k_msm.WINDOWS * n, -1).any(-1).sum()),
        "ms": _time_ms(lambda: k_msm.g1_msm_table(pts_t), reps=3, warmup=1),
        "plain_ms": plain_table_ms,
        "library_ms": None,
        "table_bytes": table.xy.numel() * 8 + table.inf.numel(),
        **_bound(table_muls, table_bytes, "fq", *table_inv),
        # its two launches: the walk, then K2's conversion of its entries
        "walk_ms": _time_ms(lambda: k_msm.g1_msm_table_walk(pts_t), reps=3, warmup=1),
        "to_affine_ms": _time_ms(lambda: k_g.to_affine("g1", walk.view(-1, 3, 12)), reps=3, warmup=1),
    }
    del walk
    least = msm_fq_muls(sc)
    bound_pippenger = _bound(least["fq_muls"], pts_t.numel() * 8 + sc_t.numel() * 4 + 36 * 8)
    bound_fixed = _bound(least["fixed_fq_muls"], table.xy.numel() * 8 + table.inf.numel() + sc_t.numel() * 4 + 36 * 8)
    lower = min(bound_pippenger, bound_fixed, key=lambda b: b["bound_ms"])
    got = check(
        f"msm[{n}]",
        lambda: k_msm.g1_msm_fixed(table, sc_t),
        lambda: k_msm.g1_msm_fixed_plain(plain_table, sc_t),
        None,
        0,
        reps=5,
        bound=dict(lower),
        best_window=least["window"],
        bound_pippenger=bound_pippenger,
        bound_fixed_base=bound_fixed,
        # a base with no table yet: the table kernel, then the fixed-base MSM
        g1_msm_ms=_time_ms(lambda: k_msm.g1_msm(pts_t, sc_t), reps=3, warmup=1),
    )
    t0 = time.perf_counter()
    if not pt_eq(FQ, k_g.g1_from_limbs(got.cpu().numpy())[0], msm(FQ, pts, sc)):
        raise AssertionError("msm differs from the host Pippenger")
    out["kernels"][f"msm[{n}]"]["host_msm_s"] = time.perf_counter() - t0
    zero = k_msm.g1_msm_fixed(table, torch.zeros_like(sc_t))
    if int(zero[2].abs().sum()):
        raise AssertionError("msm of zero scalars is not the infinity")
    out["registers"] = {
        "kzg_fr.cu": _ptxas_of(k_fr.LIB, "bary", "quotient"),
        "msm.cu": _ptxas_of(k_msm.LIB, "msm_"),
    }
    emit(out)
    return out


def _event_times(fn) -> tuple[float, dict, float]:
    """(wall seconds, {launcher: ms}, copies ms) of one fn(): every launch
    of the KZG and pairing kernels, and every copy of words to the card
    through `_DeviceKzg.to_device`, timed by CUDA events around it."""
    from lighthouse_tpu_torch.crypto.kzg import _DeviceKzg

    marks = []

    def timed(name, call):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = call(*args, **kwargs)
            end.record()
            marks.append((name(args), start, end))
            return res

        return run

    libs = (k_fr.LIB, k_msm.LIB, k_pair.LIB)
    for lib in libs:
        lib.launch = timed(lambda args: args[0], lib.launch)
    to_device = _DeviceKzg.to_device
    _DeviceKzg.to_device = timed(lambda args: "copies", to_device)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for lib in libs:
            del lib.launch  # the class's method again
        _DeviceKzg.to_device = to_device
    ms: dict = {}
    for name, start, end in marks:
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
    return wall, ms, ms.pop("copies", 0.0)


def _time_split(fn) -> dict:
    """fn() split into the card's kernels, the copies of words to the card
    and the host (the rest of the wall time), by `_event_times`."""
    wall, kernels, copies = _event_times(fn)
    kernel_ms = sum(kernels.values())
    return {
        "wall_s": wall,
        "kernels_ms": kernels,
        "device_kernel_ms": kernel_ms,
        "copies_ms": copies,
        "host_ms": wall * 1e3 - kernel_ms - copies,
        "device_busy_share": (kernel_ms + copies) / (wall * 1e3),
    }


def phase_blob_main_path(kzg, blobs: list[bytes], signed_bytes: bytes, types, E, seed: int) -> dict:
    """Blob data availability at mainnet width on the ceremony setup, as a
    node runs it, through the port's Kzg and DataAvailabilityChecker, on a
    `kzg` engine that has made no MSM yet: (a) build the setup's resident
    MSM table, produce the block's six commitments and blob proofs; (b) the block
    route: build_blob_sidecars of phase 6's signed block, put_block, then
    put_blobs -> available (DA verify of the six sidecars timed, median of
    5), a sidecar with one flipped proof byte refused; (c) a range-sync
    segment of 32 blocks of six blobs, produced on the card and verified
    as one batch (median of 3), a tampered proof refused; (d) the column
    route: build_data_column_sidecars (128 columns, 768 cell proofs), then
    put_columns of 64 columns -> reconstruction -> available."""
    import statistics

    from lighthouse_tpu_torch.beacon_chain.data_availability import (
        DataAvailabilityChecker,
        InvalidComponentsError,
    )
    from lighthouse_tpu_torch.crypto.bls12_381.curve import g1_to_bytes
    from lighthouse_tpu_torch.crypto.kzg import _blob_to_evals, _g1_msm
    from lighthouse_tpu_torch.das import build_data_column_sidecars, verify_data_column_sidecars
    from lighthouse_tpu_torch.ssz.merkle_proof import build_blob_sidecars

    T = types.types_for_fork("deneb")
    signed = T.SignedBeaconBlock.deserialize(signed_bytes)
    root = signed.message.hash_tree_root()
    slot = int(signed.message.slot)
    block_commitments = [bytes(c) for c in signed.message.body.blob_kzg_commitments]
    rng = np.random.default_rng(seed + 19)
    steps, launches = {}, {}

    def step(name, fn):
        before = kzg_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        steps[name + "_s"] = time.perf_counter() - t0
        launches[name] = {k: v - before[k] for k, v in kzg_counts().items()}
        return res

    # the main path: counts at zero just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kzg_counts()
    # (a) produce: a node's first MSM builds the setup's fixed-base table,
    # which stays resident for every later commitment and proof
    step("a_table", lambda: kzg._dev.table)
    commitments = step("a_commitments", lambda: [kzg.blob_to_kzg_commitment(b) for b in blobs])
    proofs = step("a_proofs", lambda: [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)])
    # (b) the block route
    sidecars = step("b_build_sidecars", lambda: build_blob_sidecars(signed, blobs, kzg, E))
    chk = DataAvailabilityChecker(kzg, E)
    first = chk.put_block(root, signed, slot=slot)
    avail = step("b_put_blobs", lambda: chk.put_blobs(root, sidecars, slot=slot))
    da_s = []
    for _ in range(DA_REPS):
        t0 = time.perf_counter()
        chk.verify_blob_sidecars(sidecars, root)
        torch.cuda.synchronize()
        da_s.append(time.perf_counter() - t0)
    # (c) a range-sync segment
    seg_blobs = kzg_blobs(rng, len(blobs) * SEGMENT_BLOCKS, kzg.setup.n)
    seg_c = step("c_commitments", lambda: [kzg.blob_to_kzg_commitment(b) for b in seg_blobs])
    seg_p = step("c_proofs", lambda: [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(seg_blobs, seg_c)])
    seg_s, seg_ok = [], []
    for _ in range(SEGMENT_REPS):
        t0 = time.perf_counter()
        seg_ok.append(kzg.verify_blob_kzg_proof_batch(seg_blobs, seg_c, seg_p))
        torch.cuda.synchronize()
        seg_s.append(time.perf_counter() - t0)
    # (d) the column route
    columns = step("d_build_columns", lambda: build_data_column_sidecars(signed, blobs, kzg, E))
    kept = sorted(np.random.default_rng(seed + 23).choice(E.NUMBER_OF_COLUMNS, COLUMNS_KEPT, replace=False).tolist())
    chk_cols = DataAvailabilityChecker(kzg, E)
    chk_cols.put_block(root, signed, slot=slot)
    col_avail = step("d_put_columns", lambda: chk_cols.put_columns(root, [columns[j] for j in kept], slot=slot))
    counts = kzg_counts()
    bary_by_blobs = dict(sorted(k_fr.BARYCENTRIC_BY_BLOBS.items()))
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"the blob main path launched no {missing}")

    # checks, after the counts are read
    if commitments != block_commitments:
        raise AssertionError("(a) the commitments differ from the block's")
    t0 = time.perf_counter()
    host_c = g1_to_bytes(_g1_msm(_blob_to_evals(blobs[0], kzg.setup.n), kzg.setup.g1_lagrange))
    host_msm_s = time.perf_counter() - t0
    if host_c != commitments[0]:
        raise AssertionError("(a) commitment 0 differs from the host's _g1_msm")
    if not kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs):
        raise AssertionError("(a) the block's blob proofs do not verify")
    if first.available or not avail.available or len(avail.blobs) != len(blobs):
        raise AssertionError(f"(b) availability: before the blobs {first.available}, after {avail.available}")
    if [bytes(sc.kzg_proof) for sc in sidecars] != proofs:
        raise AssertionError("(b) the sidecars' proofs differ from (a)'s")
    k = len(sidecars) // 2
    bad = types.BlobSidecar.deserialize(sidecars[k].serialize())
    flipped = bytearray(bytes(bad.kzg_proof))
    flipped[0] ^= 0x20  # the compressed point's sign bit: a valid point, -proof
    bad.kzg_proof = bytes(flipped)
    try:
        DataAvailabilityChecker(kzg, E).put_blobs(root, [*sidecars[:k], bad, *sidecars[k + 1 :]], slot=slot)
        raise AssertionError("(b) a sidecar with a flipped proof byte was accepted")
    except InvalidComponentsError:
        pass
    if not all(seg_ok):
        raise AssertionError("(c) the segment's batch was refused")
    tampered = list(seg_p)
    tampered[len(seg_p) // 2] = seg_p[len(seg_p) // 2 - 1]
    if kzg.verify_blob_kzg_proof_batch(seg_blobs, seg_c, tampered):
        raise AssertionError("(c) a segment with a tampered proof was accepted")
    if len(columns) != E.NUMBER_OF_COLUMNS or not col_avail.available or len(col_avail.columns) != E.NUMBER_OF_COLUMNS:
        raise AssertionError("(d) the column route did not reach availability")
    rebuilt = {int(sc.index): sc for sc in col_avail.columns}
    if any(rebuilt[j].serialize() != columns[j].serialize() for j in range(E.NUMBER_OF_COLUMNS)):
        raise AssertionError("(d) the reconstructed columns differ from the built ones")
    verify_data_column_sidecars(columns[:8], kzg, E)

    # one more rep of (b) and (c), its launches and copies timed, after the counts
    split_b = _time_split(lambda: chk.verify_blob_sidecars(sidecars, root))
    split_c = _time_split(lambda: kzg.verify_blob_kzg_proof_batch(seg_blobs, seg_c, seg_p))
    da_med, seg_med = statistics.median(da_s), statistics.median(seg_s)
    out = {
        "phase": "blob_main_path",
        "setup": os.path.relpath(CEREMONY_SETUP, os.path.dirname(os.path.abspath(__file__))),
        "blobs_per_block": len(blobs),
        "segment_blobs": len(seg_blobs),
        "columns": E.NUMBER_OF_COLUMNS,
        "columns_kept": len(kept),
        "steps_s": steps,
        "da_verify_s": da_s,
        "da_verify_median_s": da_med,
        "da_blobs_per_s": len(blobs) / da_med,
        "segment_verify_s": seg_s,
        "segment_verify_median_s": seg_med,
        "segment_blobs_per_s": len(seg_blobs) / seg_med,
        "launches": counts,
        "launches_per_step": launches,
        "barycentric_launches_by_blobs": bary_by_blobs,
        "quotient_launches_by_step": {k: v["quotient"] for k, v in launches.items() if v["quotient"]},
        "max_memory_allocated_bytes": peak,
        "host_commitment_msm_s": host_msm_s,
        "split_b_da_verify": split_b,
        "split_c_segment_verify": split_c,
        "checks": {
            "(a) commitments equal the block's, commitment 0 the host's, proofs verify": True,
            "(b) available after put_blobs; flipped proof byte -> InvalidComponentsError": True,
            "(c) segment accepted; tampered proof refused": True,
            f"(d) {len(kept)} of {E.NUMBER_OF_COLUMNS} columns reconstruct all -> available": True,
        },
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 3 (the multi-device step's kernels) and phase 8: the sharded step
# ---------------------------------------------------------------------------


def _merkle_bound(leaves: int) -> dict:
    """K10's least time: leaves - 1 two-to-one hashes at SHA256_MIN_OPS
    each, against the leaves read once and the root written once."""
    ops_s = SHA256_MIN_OPS * (leaves - 1) / INT32_OPS_PER_S
    bytes_s = (leaves + 1) * 32 / HBM_BYTES_PER_S
    return {
        "min_ops_per_hash": SHA256_MIN_OPS,
        "bound_ms_ops": ops_s * 1e3,
        "bound_ms_bytes": bytes_s * 1e3,
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
    }


def _subtree_root_plain(nodes: torch.Tensor) -> torch.Tensor:
    """The whole reduction of a power-of-two run through the plain version."""
    depth = (nodes.shape[0] - 1).bit_length()
    return k_ms.merkle_subtree_roots_plain(nodes, depth) if depth else nodes


def _rows_differing(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).reshape(got.shape[0], -1).any(-1).sum())


def _gpu_ms(fns, reps: int = 20) -> list[float]:
    """Median milliseconds of each of fns (launches in that order), by CUDA
    events recorded between them, over `reps` rounds. Each round starts
    behind a spin kernel (torch.cuda._sleep, ~1 ms), so the host has
    enqueued every launch before the first one runs: the times are the
    card's alone, the host's launch overhead hidden."""
    rounds = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
        events[0].record()
        for fn, ev in zip(fns, events[1:]):
            fn()
            ev.record()
        torch.cuda.synchronize()
        rounds.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return [float(np.median(col)) for col in zip(*rounds)]


def merkle_levels_split(leaves: torch.Tensor) -> dict:
    """The kernel K10's merkle_subtree_roots replaced (merkle_subtree_levels:
    9 levels a launch, the levels in shared memory) over these leaves: each
    of its launches timed apart in one sequence (`_gpu_ms`), and its root
    equal to the plain version's."""
    dev = leaves.device
    nodes, depth, launches, fns = leaves, (leaves.shape[0] - 1).bit_length(), [], []
    while depth:
        levels = min(depth, 9)
        out = torch.empty((nodes.shape[0] >> levels, 32), dtype=torch.uint8, device=dev)

        def run(nodes=nodes, out=out, levels=levels):
            k_ms.LIB.launch("merkle_subtree_levels", nodes.data_ptr(), out.data_ptr(), nodes.shape[0], levels, device=dev)

        fns.append(run)
        launches.append({"levels": levels, "blocks": int(out.shape[0]), "threads": 1 << (levels - 1)})
        nodes, depth = out, depth - levels
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    if not torch.equal(nodes, _subtree_root_plain(leaves)):
        raise AssertionError(f"merkle_subtree_levels differs from the plain version at {leaves.shape[0]} leaves")
    for launch, ms in zip(launches, _gpu_ms(fns)):
        launch["gpu_ms"] = ms
    return {"launches": launches, "gpu_ms": sum(x["gpu_ms"] for x in launches), "ms": _time_ms(lambda: [f() for f in fns], reps=20)}


# K10's launch plans timed at 2^20 leaves beside the wrapper's: (leaf
# levels, threads a block)
MERKLE_PLANS = ((4, 512), (4, 256), (3, 512), (2, 512))


def merkle_plans_ms(leaves: torch.Tensor, want: torch.Tensor) -> dict:
    """K10's kernel over these leaves in one launch under each of
    MERKLE_PLANS, each root equal to `want`, with its card time
    (`_gpu_ms`)."""
    dev = leaves.device
    levels = (leaves.shape[0] - 1).bit_length()
    counters = torch.empty(1, dtype=torch.int32, device=dev)
    out_ms = {}
    for leaf, threads in MERKLE_PLANS:
        out = torch.empty((1, 32), dtype=torch.uint8, device=dev)
        roots = torch.empty(((1 << (levels - leaf)) // threads, 32), dtype=torch.uint8, device=dev)

        def run(leaf=leaf, threads=threads, out=out, roots=roots):
            k_ms.LIB.launch(
                "merkle_subtree_roots", leaves.data_ptr(), out.data_ptr(), roots.data_ptr(), counters.data_ptr(),
                leaves.shape[0], levels, leaf, threads, device=dev,
            )

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"merkle_subtree_roots under the plan ({leaf}, {threads}) differs from the plain root")
        out_ms[f"{leaf},{threads}"] = _gpu_ms([run])[0]
    return out_ms


def rlc_chain_edge_case(rng: np.random.Generator, n: int) -> tuple[list, list[int]]:
    """K11's ladder inputs at n lanes: seeded points (131 distinct, repeated)
    and 64-bit draws, with the chain's edge scalars 0, 1, 15, 16, 2^63 - 1,
    2^63 and 2^64 - 1 in the first lanes (2^63 and above arrive as negative
    int64), then an affine point (Z = 1), an infinity point and a point of
    order 3 under 3 (its table's 3 P is infinity) where n allows."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, inf, to_affine

    base = bls_g1_points(rng, min(n, RLC_HOST_POINTS))
    pts = (base * -(-n // len(base)))[:n]
    scalars = ([0, 1, 15, 16, 2**63 - 1, 2**63, 2**64 - 1] + bls_scalars(rng, n))[:n]
    if n > 9:
        pts[7] = (*to_affine(FQ, pts[7]), 1)
        pts[8] = inf(FQ)
        pts[9], scalars[9] = bls_g1_point_of_order(rng, 3), 3
    return pts, scalars


def phase_sharded_kernel_checks(kzg, seed: int) -> dict:
    """The multi-device step's kernels at its main path's shapes, equal to
    their plain versions on the card (0 rows differing) and to the host:
    the Merkle subtree reduction at 2^20 leaves (one launch) and at 8 roots
    (the fold), with the replaced kernel's three launches at 2^20 timed
    apart; K11's 64-bit chain at 1, 37 and 4,096 lanes with the edge
    scalars of `rlc_chain_edge_case`, timed at 4,096 beside K2's thread
    layout on the same lanes; the 256-bit G1 ladder at 1, 37 and 4096
    points with the edge scalars of `wide_edge_scalars` among them, on its
    teams and on the thread layout kept for this comparison (both equal to
    the plain chain); with times, plain times and bounds."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, pt_eq, pt_mul
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 41)
    out = {"phase": "sharded_kernel_checks", "kernels": {}, "g1_scalar_mul_wide_layouts_ms": {}}

    for n in (SHARDED_LEAVES, 8):
        leaves_np = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        leaves = torch.from_numpy(leaves_np).to(dev)
        # the replaced kernel first, each launch apart
        replaced = merkle_levels_split(leaves)
        k_ms.reset_counts()
        got = k_ms.subtree_root(leaves)
        launches = k_ms.COUNTS["merkle_subtree_roots"]
        want, plain_ms = _plain_ms(lambda: _subtree_root_plain(leaves))
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"merkle_subtree_roots differs from its plain version at {n} leaves (max_abs_err {err})")
        fold = leaves_np
        while fold.shape[0] > 1:
            fold = hash_rows_hashlib(fold.reshape(-1, 64))
        if not np.array_equal(got.cpu().numpy()[0], fold[0]):
            raise AssertionError(f"merkle_subtree_roots differs from a hashlib fold at {n} leaves")
        leaf, threads = k_ms.subtree_plan((n - 1).bit_length())
        out["kernels"][f"merkle_subtree_roots[{n}]"] = {
            "equal_plain": True,
            "equal_hashlib_fold": True,
            "max_abs_err": err,
            "rows_differing": _rows_differing(got, want),
            "launches_per_call": launches,
            "plan": {"leaf_levels": leaf, "threads": threads},
            "ms": _time_ms(lambda: k_ms.subtree_root(leaves), reps=20 if n > 8 else 50),
            "gpu_ms": _gpu_ms([lambda: k_ms.subtree_root(leaves)])[0],
            "replaced_ms": replaced["ms"],
            "replaced_gpu_ms": replaced["gpu_ms"],
            "replaced_launches": replaced["launches"],
            **({"plans_gpu_ms": merkle_plans_ms(leaves, want)} if n == SHARDED_LEAVES else {}),
            "plain_ms": plain_ms,
            "library_ms": None,
            **_merkle_bound(n),
        }

    # K11's 64-bit chain, its plain version's steps and the host's points
    for n in (1, 37, RLC_POINTS):
        host_pts, sc = rlc_chain_edge_case(rng, n)
        pt = torch.from_numpy(k_g.g1_to_limbs(host_pts)).to(dev)
        ks = k_g.scalars_to_tensor(sc).to(dev)
        got = k_g.scalar_mul_wide64(pt, ks)
        want, plain_ms = _plain_ms(lambda: k_g.scalar_mul_wide64_plain(pt, ks))
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"g1_scalar_mul_wide64 differs from its plain version at {n} lanes (max_abs_err {err})")
        host_rows = min(n, 37)
        for row, p, k in zip(k_g.g1_from_limbs(got[:host_rows].cpu().numpy()), host_pts, sc):
            if not pt_eq(FQ, row, pt_mul(FQ, p, k)):
                raise AssertionError(f"g1_scalar_mul_wide64 differs from the host pt_mul (k = {k})")
        case = {
            "equal_plain": True,
            "equal_host_rows": host_rows,
            "max_abs_err": err,
            "rows_differing": _rows_differing(got, want),
            "ms": _time_ms(lambda: k_g.scalar_mul_wide64(pt, ks), reps=5, warmup=1),
            "plain_ms": plain_ms,
            "library_ms": None,
        }
        if n == RLC_POINTS:
            # the RLC sum is the function: Pippenger's least work bounds it
            # (as K11's); K2's thread layout on the same lanes beside it
            least = msm_fq_muls(sc, bits=64)
            case.update(
                _bound(least["fq_muls"], pt.numel() * 8 + ks.numel() * 8 + 36 * 8),
                best_window=least["window"],
                k2_thread_ms=_time_ms(lambda: k_g.scalar_mul("g1", pt, ks, layout="thread"), reps=5, warmup=1),
            )
        out["kernels"][f"g1_scalar_mul_wide64[{n}]"] = case

    setup_pts = kzg._dev.points
    for n in (1, 37, kzg.setup.n):
        sc = fr_scalars(rng, n)
        sc[: min(n, 8)] = wide_edge_scalars()[: min(n, 8)]
        if n == kzg.setup.n:
            pt = setup_pts  # the ladder MSM's points
            host_pts = kzg.setup.g1_lagrange
        else:
            host_pts = bls_g1_points(rng, n)
            pt = torch.from_numpy(k_g.g1_to_limbs(host_pts)).to(dev)
        words = k_fr.as_i32(k_fr.fr_to_words(sc)).to(dev)
        got = k_g.scalar_mul_wide(pt, words)
        want, plain_ms = _plain_ms(lambda: k_g.scalar_mul_wide_plain(pt, words))
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"g1_scalar_mul_wide differs from its plain version at {n} points (max_abs_err {err})")
        host_rows = min(n, 37)
        for row, p, k in zip(k_g.g1_from_limbs(got[:host_rows].cpu().numpy()), host_pts, sc):
            if not pt_eq(FQ, row, pt_mul(FQ, p, k)):
                raise AssertionError(f"g1_scalar_mul_wide differs from the host pt_mul (k = {k})")
        case = {
            "equal_plain": True,
            "equal_host_rows": host_rows,
            "max_abs_err": err,
            "rows_differing": _rows_differing(got, want),
            "ms": _time_ms(lambda: k_g.scalar_mul_wide(pt, words), reps=3, warmup=1),
            "plain_ms": plain_ms,
            "library_ms": None,
        }
        if n == kzg.setup.n:
            # the ladder computes the MSM's function: K9's least work bounds it
            least = msm_fq_muls(sc)
            case.update(
                _bound(least["fq_muls"], pt.numel() * 8 + words.numel() * 4 + 36 * 8),
                best_window=least["window"],
                ladder_msm_ms=_time_ms(lambda: k_msm.g1_msm_ladder(pt, words), reps=3, warmup=1),
            )
        out["kernels"][f"g1_scalar_mul_wide[{n}]"] = case
        # both layouts (1: the wrapper's teams, 0: a thread a lane), each
        # equal to the plain chain, timed at the two larger counts
        for layout, team in (("team", 1), ("thread", 0)):
            got_l = torch.empty_like(pt)

            def run(team=team, got_l=got_l):
                k_g.LIB.launch(
                    "bls_g1_scalar_mul_wide_layout", pt.data_ptr(), words.data_ptr(), got_l.data_ptr(), n, team, device=dev
                )

            run()
            torch.cuda.synchronize()
            if not torch.equal(got_l, want):
                raise AssertionError(f"g1_scalar_mul_wide[{n},{layout}] differs from its plain version")
            if n > 1:
                out["g1_scalar_mul_wide_layouts_ms"].setdefault(n, {})[layout] = _time_ms(run, reps=3, warmup=1)
    out["registers"] = {
        "merkle_subtree.cu": _ptxas_of(k_ms.LIB, "merkle"),
        "bls381_g.cu": _ptxas_of(k_g.LIB, "wide"),
    }
    emit(out)
    return out


def _median_event_ms(fn, reps: int = SHARDED_REPS) -> float:
    """Median milliseconds of `reps` single calls of fn(), each timed by
    CUDA events (`_plain_ms`)."""
    return float(np.median([_plain_ms(fn)[1] for _ in range(reps)]))


def phase_sharded_main_path(state, kzg, seed: int) -> dict:
    """The multi-device step on a process group of one rank (NCCL, this
    card): (a) the registry's sharded Merkle root, (b) a segment's sharded
    RLC sum, (c) the ladder MSM of one blob, each with its counts set to 0
    just before its run and read just after; (d) the spawned dry run."""
    from lighthouse_tpu_torch import entry
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, g1_to_bytes, msm, pt_eq
    from lighthouse_tpu_torch.crypto.kzg import _blobs_to_words
    from lighthouse_tpu_torch.ops import bls381_sharded as k_rlc
    from lighthouse_tpu_torch.ops.cuda_build import BUILD_DIR
    from lighthouse_tpu_torch.parallel.mesh import all_gather_rows, batch_mesh, close_mesh
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 43)
    out = {"phase": "sharded_main_path", "ranks": 1, "backend": "nccl"}

    # inputs, before the group: the registry's validator roots (resident
    # columns), seeded points and scalars, one seeded blob
    t0 = time.perf_counter()
    cols = registry_columns_for(state)
    if cols is None:
        raise AssertionError("the phase-4 state has no resident registry columns")
    cols.refresh(state)
    roots = cols.validator_root_rows(None)
    n_val = roots.shape[0]
    if n_val > SHARDED_LEAVES:
        raise AssertionError(f"{n_val} validators exceed {SHARDED_LEAVES} leaves")
    leaves_np = np.zeros((SHARDED_LEAVES, 32), dtype=np.uint8)
    leaves_np[:n_val] = roots
    leaves = torch.from_numpy(leaves_np).to(dev)
    out["validator_roots_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_pts = bls_g1_points(rng, RLC_POINTS)
    scalars = bls_scalars(rng, RLC_POINTS)
    out["rlc_points"] = f"{RLC_POINTS} seeded points (bls_g1_points): phase 5's keys make one block's 128 committee aggregates, not a segment's {RLC_POINTS}"
    out["rlc_points_s"] = time.perf_counter() - t0
    pts = torch.from_numpy(k_g.g1_to_limbs(host_pts)).to(dev)
    ks = k_g.scalars_to_tensor(scalars).to(dev)
    blob = kzg_blobs(rng, 1)[0]
    words = kzg._dev.to_device(_blobs_to_words([blob], kzg.setup.n)[0])
    lagrange = kzg._dev.points

    store = BUILD_DIR / f"phase8-store-{os.getpid()}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mesh = batch_mesh(0, 1, str(store), device="cuda")
    out["group_init_s"] = time.perf_counter() - t0
    try:
        # (a) the sharded registry root: counts at 0 just before, read just after
        torch.cuda.synchronize()
        k_ms.reset_counts()
        root = k_ms.sharded_merkle_root(leaves, mesh)
        torch.cuda.synchronize()
        launches_a = dict(k_ms.COUNTS)
        if launches_a["merkle_subtree_roots"] <= 0:
            raise AssertionError("(a) the sharded root launched no merkle_subtree_roots")
        node = root.cpu().numpy().tobytes()
        ftype = state._fields["validators"]
        limit = ftype.chunk_count()
        for d in range((SHARDED_LEAVES - 1).bit_length(), (next_pow_of_two(limit) - 1).bit_length()):
            node = hashlib.sha256(node + ZERO_HASHES[d]).digest()
        validators_root = mix_in_length(node, n_val)
        state_root_field = state.__dict__["_thc_cache"].field_root(state, "validators", ftype)
        if validators_root != state_root_field:
            raise AssertionError(f"(a) sharded validators root {validators_root.hex()} != the state's {state_root_field.hex()}")
        host_root = mix_in_length(_host_fold(roots, limit), n_val)
        if validators_root != host_root:
            raise AssertionError("(a) sharded validators root differs from the hashlib fold")
        local = k_ms.subtree_root(leaves)
        out["a_registry_root"] = {
            "validators": n_val,
            "leaves": SHARDED_LEAVES,
            "validators_root": validators_root.hex(),
            "equal_state_field_root": True,
            "equal_host_fold": True,
            "launches": launches_a["merkle_subtree_roots"],
            "step_ms": _median_event_ms(lambda: k_ms.sharded_merkle_root(leaves, mesh)),
            "kernels_ms": _median_event_ms(lambda: k_ms.subtree_root(k_ms.subtree_root(leaves))),
            "all_gather_ms": _median_event_ms(lambda: all_gather_rows(local, mesh)),
        }

        # (b) the sharded RLC sum
        torch.cuda.synchronize()
        k_g.reset_counts()
        got = k_rlc.sharded_rlc_g1(pts, ks, mesh)
        torch.cuda.synchronize()
        launches_b = {n: k_g.COUNTS[n] for n in ("g1_scalar_mul_wide64", "g1_segment_sum")}
        if min(launches_b.values()) <= 0:
            raise AssertionError(f"(b) the sharded RLC sum missed a kernel: {launches_b}")
        want, plain_ms = _plain_ms(lambda: k_rlc.fold_plain(k_rlc.local_sum_plain(pts, ks)))
        err = _max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"(b) the sharded RLC sum differs from its plain version (max_abs_err {err})")
        few = k_rlc.sharded_rlc_g1(pts[:RLC_HOST_POINTS].contiguous(), ks[:RLC_HOST_POINTS].contiguous(), mesh)
        if not pt_eq(FQ, k_g.g1_from_limbs(few.cpu().numpy())[0], msm(FQ, host_pts[:RLC_HOST_POINTS], scalars[:RLC_HOST_POINTS])):
            raise AssertionError(f"(b) the sharded RLC sum of {RLC_HOST_POINTS} points differs from the host")
        part = k_rlc.local_sum(pts, ks)
        gathered = all_gather_rows(part, mesh)
        least = msm_fq_muls(scalars, bits=64)
        out["b_rlc_sum"] = {
            "points": RLC_POINTS,
            "scalar_bits": 64,
            "equal_plain": True,
            "max_abs_err": err,
            "equal_host_points": RLC_HOST_POINTS,
            "launches": launches_b,
            "step_ms": _median_event_ms(lambda: k_rlc.sharded_rlc_g1(pts, ks, mesh)),
            # one rank: the local sum is already the gathered [1, 3, 12]
            "kernels_ms": _median_event_ms(lambda: k_rlc.fold(k_rlc.local_sum(pts, ks))),
            "fold_ms": _median_event_ms(lambda: k_rlc.fold(gathered)),
            "all_gather_ms": _median_event_ms(lambda: all_gather_rows(part, mesh)),
            "plain_ms": plain_ms,
            "best_window": least["window"],
            **_bound(least["fq_muls"], pts.numel() * 8 + ks.numel() * 8 + 36 * 8),
        }

        # (c) the ladder MSM of one blob over the ceremony's Lagrange points
        torch.cuda.synchronize()
        k_g.reset_counts()
        total = k_msm.g1_msm_ladder(lagrange, words)
        torch.cuda.synchronize()
        launches_c = {n: k_g.COUNTS[n] for n in ("g1_scalar_mul_wide", "g1_segment_sum")}
        if min(launches_c.values()) <= 0:
            raise AssertionError(f"(c) the ladder MSM missed a kernel: {launches_c}")
        commitment = kzg.blob_to_kzg_commitment(blob)
        if g1_to_bytes(k_g.g1_from_limbs(total.cpu().numpy())[0]) != commitment:
            raise AssertionError("(c) the ladder MSM differs from K9 Pippenger's commitment")
        want_c, plain_c_ms = _plain_ms(lambda: k_msm.g1_msm_ladder_plain(lagrange, words))
        if not torch.equal(total, want_c):
            raise AssertionError("(c) the ladder MSM differs from the plain ladder")
        out["c_ladder_msm"] = {
            "points": int(lagrange.shape[0]),
            "equal_pippenger_commitment": True,
            "equal_plain_ladder": True,
            "launches": launches_c,
            "ms": _median_event_ms(lambda: k_msm.g1_msm_ladder(lagrange, words)),
            # K9: the table kernel and the fixed-base MSM, then the
            # fixed-base MSM alone over the engine's resident table
            "pippenger_ms": _median_event_ms(lambda: k_msm.g1_msm(lagrange, words)),
            "fixed_base_resident_ms": _median_event_ms(lambda: k_msm.g1_msm_fixed(kzg._dev.table, words)),
            "plain_ms": plain_c_ms,
        }
    finally:
        close_mesh(mesh)
        store.unlink(missing_ok=True)

    # (d) the dry run in a spawned rank, as the JAX dry run runs it
    t0 = time.perf_counter()
    entry.dryrun_multichip(1, device="cuda", timeout=300)
    out["d_dryrun_multichip_s"] = time.perf_counter() - t0
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    # the run uses one card: the first visible one
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    smi = _nvidia_smi()
    emit(
        {
            "phase": "environment",
            "nvidia_smi": smi,
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0),
            "host_pool": {"size": host_pool.get_pool().size, "start_method": "fork"},
        }
    )
    phase_build()
    checks = phase_kernel_checks(args.seed)
    bls_checks = phase_bls_kernel_checks(args.seed)
    sweep_check = phase_epoch_sweep_check(args.seed)
    kzg = ceremony_kzg()
    kzg_checks = phase_kzg_kernel_checks(kzg, args.seed)
    sharded_checks = phase_sharded_kernel_checks(kzg, args.seed)
    main_path, state = phase_main_path(N_VALIDATORS, UPDATES, args.seed)
    types = build_types(MainnetEthSpec)
    bls_path, sk_of = phase_bls_main_path(state, types, MainnetEthSpec, args.seed)
    # the block of phase 6 carries the six blobs' commitments, made on the
    # card (phase 7 makes them again inside its counted run)
    blobs = kzg_blobs(np.random.default_rng(args.seed + 29), BLOBS_PER_BLOCK)
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    transition, signed = phase_transition_main_path(state, types, MainnetEthSpec, sk_of, args.seed, commitments)
    # a fresh engine on the same setup: phase 7 builds its table in its run
    blob_path = phase_blob_main_path(Kzg(kzg.setup), blobs, signed, types, MainnetEthSpec, args.seed)
    sharded = phase_sharded_main_path(state, kzg, args.seed)
    host_pool.reset_pool()  # stop the host pool's workers

    emit(
        {
            "kernels": [
                {
                    "name": "sha256_rows",
                    "route": "cuda",
                    "source": "lighthouse_tpu_torch/csrc/sha256.cu",
                    "replaces": "lighthouse_tpu/ops/sha256.py:104",
                    "launches": main_path["sha256_launches"],
                    "max_abs_err": checks["max_abs_err"],
                    "ms": checks["ms"],
                    "plain_ms": checks["plain_ms"],
                    "bound_ms": checks["bound_ms"],
                    "bound_by": checks["bound_by"],
                    "library_ms": None,
                }
            ]
            + [
                {
                    "name": name,
                    "route": "cuda",
                    "source": f"lighthouse_tpu_torch/csrc/{src}",
                    "replaces": replaces,
                    # K4's multi-pairing also runs the KZG checks of phase 7,
                    # K2's g1_to_affine K9's table there
                    "launches": bls_path["launches"][name] + blob_path["launches"].get(name, 0),
                    "max_abs_err": max(
                        c["max_abs_err"] for k, c in bls_checks["kernels"].items() if k.split("[")[0] == name
                    ),
                    "ms": bls_checks["kernels"][name]["ms"],
                    "plain_ms": bls_checks["kernels"][name]["plain_ms"],
                    "bound_ms": bls_checks["kernels"][name]["bound_ms"],
                    "bound_by": bls_checks["kernels"][name]["bound_by"],
                    "library_ms": None,
                    **(
                        {"ms_2_pairs": bls_checks["kernels"]["multi_pairing[2]"]["ms"]}
                        if name == "multi_pairing"
                        else {}
                    ),
                    # the main path's affine points above; Jacobian ones here
                    **(
                        {"ms_z_not_1": bls_checks["kernels"]["g2_scalar_mul[z!=1]"]["ms"]}
                        if name == "g2_scalar_mul"
                        else {}
                    ),
                    # over three blocks with infinity lanes; 4,096 lanes
                    **(
                        {
                            "ms_edge": bls_checks["kernels"][f"{name}[edge]"]["ms"],
                            f"ms_{RLC_POINTS}": bls_checks["kernels"][f"{name}[{RLC_POINTS}]"]["ms"],
                        }
                        if name.endswith("_to_affine")
                        else {}
                    ),
                    # the other rows of phase 3; phase 5's calls and launches by [n, k]
                    **(
                        {
                            f"ms_{key[len(name) + 1 : -1].replace(',', '_')}": c["ms"]
                            for key, c in bls_checks["kernels"].items()
                            if key.startswith(f"{name}[")
                        }
                        | {"launches_by_shape": bls_path["segment_sum_launches_by_shape"][name]}
                        if name.endswith("_segment_sum")
                        else {}
                    ),
                    # K11's 4,096 lanes, in each layout
                    **(
                        {
                            f"ms_{RLC_POINTS}_{layout}": bls_checks["kernels"][f"g1_scalar_mul[{RLC_POINTS},{layout}]"]["ms"]
                            for layout in k_g.G1_LAYOUTS
                        }
                        if name == "g1_scalar_mul"
                        else {}
                    ),
                }
                for name, (_, src, replaces) in BLS_KERNELS.items()
            ]
            + [
                {
                    "name": "epoch_sweep",
                    "route": "cuda",
                    "source": "lighthouse_tpu_torch/csrc/epoch_sweep.cu",
                    "replaces": "lighthouse_tpu/ops/epoch_sweep.py:39",
                    "launches": transition["epoch_sweep_launches"],
                    "max_abs_err": sweep_check["max_abs_err"],
                    "ms": sweep_check["ms"],
                    "plain_ms": sweep_check["plain_ms"],
                    "bound_ms": sweep_check["bound_ms"],
                    "bound_by": sweep_check["bound_by"],
                    "library_ms": None,
                    # the card alone; the replaced two-kernel sweep in the same call
                    **{key: sweep_check[key] for key in ("gpu_ms", "replaced_ms", "replaced_gpu_ms")},
                }
            ]
            + [
                {
                    "name": name,
                    "route": "cuda",
                    "source": f"lighthouse_tpu_torch/csrc/{src}",
                    "replaces": replaces,
                    "launches": blob_path["launches"][name],
                    "max_abs_err": max(
                        c["max_abs_err"] for k, c in kzg_checks["kernels"].items() if k.split("[")[0] == name
                    ),
                    **{
                        key: kzg_checks["kernels"][case][key]
                        for key in ("ms", "plain_ms", "bound_ms", "bound_by")
                    },
                    "library_ms": None,
                    **(
                        {
                            "ms_1_blob": kzg_checks["kernels"]["barycentric_eval[1,4096]"]["ms"],
                            "ms_192_blobs": kzg_checks["kernels"][f"barycentric_eval[{BLOBS_PER_BLOCK * SEGMENT_BLOCKS},4096]"]["ms"],
                            "launches_by_blobs": blob_path["barycentric_launches_by_blobs"],
                        }
                        if name == "barycentric_eval"
                        else {}
                    ),
                    **(
                        {"launches_by_step": blob_path["quotient_launches_by_step"]}
                        if name == "quotient"
                        else {}
                    ),
                    # the table's two launches apart
                    **(
                        {key: kzg_checks["kernels"][case][key] for key in ("walk_ms", "to_affine_ms")}
                        if name == "msm_table"
                        else {}
                    ),
                }
                for (name, (_, src, replaces)), case in zip(
                    KZG_KERNELS.items(),
                    (f"barycentric_eval[{BLOBS_PER_BLOCK},4096]", "quotient[4096]", "msm[4096]", "msm_table[4096]"),
                )
            ]
            + [
                {
                    "name": name,
                    "route": "cuda",
                    "source": src,
                    "replaces": replaces,
                    "launches": launches,
                    "max_abs_err": max(
                        c["max_abs_err"] for k, c in sharded_checks["kernels"].items() if k.split("[")[0] == name
                    ),
                    **{key: sharded_checks["kernels"][case][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
                    "library_ms": None,
                    # both layouts of the 256-bit ladder
                    **(
                        {"ms_by_layout": sharded_checks["g1_scalar_mul_wide_layouts_ms"][kzg.setup.n]}
                        if name == "g1_scalar_mul_wide"
                        else {}
                    ),
                    # the replaced kernel's launches; K2's thread layout on K11's lanes
                    **(
                        {
                            key: sharded_checks["kernels"][case][key]
                            for key in ("launches_per_call", "gpu_ms", "replaced_ms", "replaced_gpu_ms", "replaced_launches")
                        }
                        if name == "merkle_subtree_roots"
                        else {}
                    ),
                    **(
                        {"k2_thread_ms": sharded_checks["kernels"][case]["k2_thread_ms"]}
                        if name == "g1_scalar_mul_wide64"
                        else {}
                    ),
                }
                for name, src, replaces, launches, case in (
                    (
                        "merkle_subtree_roots",
                        "lighthouse_tpu_torch/csrc/merkle_subtree.cu",
                        "lighthouse_tpu/ops/merkle_sharded.py:42",
                        sharded["a_registry_root"]["launches"],
                        f"merkle_subtree_roots[{SHARDED_LEAVES}]",
                    ),
                    (
                        "g1_scalar_mul_wide",
                        "lighthouse_tpu_torch/csrc/bls381_g.cu",
                        "lighthouse_tpu/ops/msm.py:172",
                        sharded["c_ladder_msm"]["launches"]["g1_scalar_mul_wide"],
                        f"g1_scalar_mul_wide[{kzg.setup.n}]",
                    ),
                    (
                        "g1_scalar_mul_wide64",
                        "lighthouse_tpu_torch/csrc/bls381_g.cu",
                        "lighthouse_tpu/ops/bls381_sharded.py:56",
                        sharded["b_rlc_sum"]["launches"]["g1_scalar_mul_wide64"],
                        f"g1_scalar_mul_wide64[{RLC_POINTS}]",
                    ),
                )
            ]
            + [
                {
                    # a composition of bls381_g.cu's kernels (the 64-bit chain,
                    # K2's segment sums) around NCCL's all-gather: its launches
                    # are theirs, its ms theirs alone
                    "name": "sharded_rlc_g1",
                    "route": "cuda",
                    "source": "lighthouse_tpu_torch/ops/bls381_sharded.py",
                    "replaces": "lighthouse_tpu/ops/bls381_sharded.py:52",
                    "launches": sum(sharded["b_rlc_sum"]["launches"].values()),
                    "max_abs_err": sharded["b_rlc_sum"]["max_abs_err"],
                    "ms": sharded["b_rlc_sum"]["kernels_ms"],
                    "plain_ms": sharded["b_rlc_sum"]["plain_ms"],
                    "bound_ms": sharded["b_rlc_sum"]["bound_ms"],
                    "bound_by": sharded["b_rlc_sum"]["bound_by"],
                    "library_ms": None,
                }
            ]
        }
    )
    print(smi, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
