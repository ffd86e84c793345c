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
   out of the inactivity leak, with edge rows, on Electra's rows (effective
   balances up to 2048 ETH, scores just under the host guard), and at
   3.5 M (past the shared-memory keep), timed in turns in the same call, with the
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
   ladder; (d) ``entry.dryrun_multichip(1, device="cuda")``;
9. Electra main path: a copy of phase 6's pre-state upgraded with the
   port's ``upgrade_to_electra`` (timed), given 5% compounding validators
   at 32 to 2048 ETH, 256 pending deposits, 64 pending partial withdrawals
   (8 matured) and 16 pending consolidations, a few validators at the
   ejection balance and an eth1 deposit tree (``electra_prestate``); then
   block import across the boundary twice, each from a copy: the Electra
   epoch (its sweep on the epoch-sweep kernel), a full, really signed
   Electra block with phase 6's contents plus a proposer and an attester
   slashing, 16 voluntary exits, 16 BLS-to-execution changes, 4 bridge
   deposits with proofs from the port's ``DepositTree``, and in the payload
   16 deposit receipts and 16 withdrawal requests (``ElectraOperations``),
   under VERIFY_BULK on the ``cuda`` backend, and ``hash_tree_root()``.
   The sweep must equal the numpy sweep, the root the host-lane fold (the
   pending lists folded leaf by leaf), the block be accepted and the copies
   with an exit and with a BLS change signed over another message refused;
10. chain: block import through the port's ``BeaconChain`` entry points,
   with the BLS backend following the device (no ``set_backend`` call in
   the script: ``cuda`` on the card): (a) ``BeaconChainHarness`` on the
   minimal preset (64 validators) extends the chain 32 slots, each block
   through ``process_block`` and each slot's 8 attestations through
   ``process_attestation_batch`` on the card, to justified epoch 3 and
   finalized 2; a block with one attestation signature swapped for a
   valid signature over another message is refused with the head
   unmoved, and a gossip batch of 8 with one such signature has exactly
   that one refused; (b) a ``BeaconChain`` over an in-memory
   ``HotColdDB`` anchored on a copy of phase 6's 1M-validator pre-state,
   with a ``ManualSlotClock`` and a ``Kzg`` on the card: phase 7's six blob
   sidecars through ``process_blob_sidecars``, then phase 6's block
   through ``verify_block_for_gossip`` and ``process_block``: the head is
   the block, its state root phase 6's post-state root; (c) the
   post-state read back from the store and rooted cold on the card,
   equal; (d) 64 gossip attestations to the new head accepted in one
   batch, and of a batch of 8 only the one signed over another message
   refused. Each step's seconds on a line of its own with the card's
   name and power limit;
11. the Beacon API, every request over HTTP on 127.0.0.1: (a) node A, a
   ``BeaconChain`` anchored on a copy of phase 6's pre-state (as phase 10
   (b)) behind ``HttpApiServer``: the six sidecars through the chain, then
   phase 6's block POSTed through ``eth2.BeaconNodeHttpClient``
   (``publish_block_ssz``): 200, the head the block and its state root
   phase 6's post-state root; the copy with one bad attestation signature
   (its own sidecars staged): 400, head unmoved; 64 gossip attestations
   (200), then 8 with one bad (202, one refused); (b) reads: the head
   root, finality checkpoints, every validator and three by id, every
   balance, the committees, the proposer duties; the block, attestation
   and sync-committee rewards, each equal to the rewards functions called
   directly; the light-client bootstrap at the anchor checked by
   ``initialize_light_client_store``; (c) the same reads through
   ``HttpApiServer(chain, workers=2)``'s public port, equal, with the
   forwards by cause and no worker death (a request that would dispatch a
   kernel in a forked worker goes to the parent); (d) node B from A's head
   block and state over HTTP, the state rooted cold on the card against
   the block's state root, ``BeaconChain.from_checkpoint``; (e) on the
   minimal preset with Altair from genesis, ``checkpoint_boot`` from a
   harness that finalized, the harness's later blocks POSTed to B (each
   verified on the card) until B's head and finality are the harness's,
   and a light client through the update route. Each step's seconds on a
   line of its own with the card's name and power limit;
12. the validator client: (a) on the minimal preset (Altair to Deneb at
   genesis, 64 validators), a harness chain behind ``HttpApiServer``
   whose execution layer is an ``EngineWatchdog`` over the JWT engine API
   (``HttpEngineClient`` to a ``MockEngineServer``); the 64 keys as
   EIP-2335 keystores imported through the keymanager API into a
   ``ValidatorClient`` over ``BeaconNodeFallback([a closed port, the
   node])``, which proposes every block, attests, aggregates and sends
   sync-committee messages over HTTP until the chain finalizes epoch 2;
   one key deleted through the keymanager API signs nothing after, and a
   conflicting attestation is refused (``NotSafe``) ((a) needs nothing of
   the phases before: it runs in phase 15's spawned process, after the
   fleets); (b) at 1M validators, a ``BeaconChain`` from phase 6's
   post-state and block
   (``from_checkpoint``, the engine API as in (a)) and a VC in-process
   with every key phases 5–6 minted: one slot's duties, signatures,
   aggregates and sync messages, all accepted by the node. Each step's
   seconds on a line of its own with the card's name and power limit;
13. the node: (a) ``python3 -m lighthouse_tpu_torch --spec minimal bn
   --validate --slasher`` as users start it (16 validators, 3-second slots
   for 30 s), its Beacon API polled every slot: it exits 0 with
   ``bls_backend=cuda``, imports at least 4 blocks its VC proposed, runs
   one slasher cycle at each epoch edge its clock crosses (its /metrics),
   and watch's ``WatchUpdater`` (here) indexes every block its API serves
   into a ``WatchDB`` with its proposer and blockprint, no slot missed after
   the first block, its ``WatchServer`` routes answering;
   (b) on the minimal preset, nodes over TCP (Noise where the
   ``cryptography`` package is installed; the transport on a line of its
   own): a harness chain finalized at epoch 2 behind ``NetworkService``
   and ``HttpApiServer``, a ``ClientBuilder`` node that range-syncs it, one
   booted from its finalized checkpoint that range-syncs and backfills to
   genesis, then 4 live slots of blocks and attestations over gossip and
   a bad block refused by both; (c) at 1M validators, phase 7's sidecars,
   phase 6's block and phase 12 (b)'s attestations and aggregates gossiped
   from phase 12 (b)'s node to a node on phase 6's pre-state, which
   imports the block and accepts them all, and refuses one attestation
   with another's signature. Each step's seconds and card launches on a
   line of its own with the card's name and power limit;
14. the slasher, the simulator and eth1 genesis: (a) on the minimal
   preset, the simulator's ``LocalNetwork`` of 2 nodes with VCs, node 0 a
   ``SlasherService`` fed a double vote, a surround vote and a double
   proposal signed with interop keys: each slashing emitted once and
   included in a block both nodes import, the offenders slashed in both
   heads, finalized epoch 2; (b) the columnar slasher at the registry's
   1,000,000 validators (4,096 epochs of history) through the native KV
   store, in a spawned process beside phase 13: a warm epoch, then 2,048
   aggregates with three planted offences, exactly those found, their
   signature sets verified on the card and a tampered copy refused; (c) ``Eth1GenesisService`` over 16,384 deposits
   of phase 5's keys signed on the card: a valid genesis whose deposits
   pass one ``verify_signature_sets`` of 512 chunks, its state root the
   host-lane fold's. Each step's seconds and card launches on a line of
   its own with the card's name and power limit;
15. the adversarial fleet (``testing/testnet.py``) with every node's BLS
   backend ``cuda``, in a spawned process started after phase 9 and read
   after phase 11 (it then runs phase 12 (a)): (a) the smoke scenario, 3 nodes and 24 interop
   validators on the minimal preset, one node partitioned from two, healed,
   one head and finality advancing; (b) column withholding on Deneb from
   genesis with 64-element blobs over 16 columns, the KZG engine's dev setup
   on the card: 75% withheld refused while the chain finalizes past it,
   37.5% withheld reconstructed and imported; (c) a proposer's double
   proposal gossiped to the node with the slasher, exactly one
   ProposerSlashing. Each passes the JAX tests' checks and launched every
   BLS kernel; a line a scenario with its seconds, slots, recovery slots,
   oracle passes, fault injections and launches, with the card's name and
   power limit. Phase 3 holds K8 and K9 to their plain versions at this
   64-point domain too.

Then one JSON line with every kernel's numbers, the card's nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
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
    finish = FR_MULS["bary_blob"] - 12 + n.bit_length() - 1  # z^n: log2 n squarings
    return (FR_MULS["bary_term"] * n - 3 + finish + FR_MULS["batch_inv"]) * m + FR_MULS["inv"]

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
TRANSITION_REPS = 2
# Blob availability in phase 7: a mainnet Deneb block's blobs
# (MAX_BLOBS_PER_BLOCK), their gas, a range-sync segment of 32 blocks of
# six blobs, the columns staged for reconstruction (half of 128), and the
# timed repetitions of the block's DA verify and of the segment's batch.
BLOBS_PER_BLOCK = 6
BLOB_GAS_PER_BLOB = 2**17
SEGMENT_BLOCKS = 32
COLUMNS_KEPT = 64
DA_REPS = 5
SEGMENT_REPS = 2
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


def epoch_sweep_inputs(
    rng: np.random.Generator, n: int, in_leak: bool, max_eb_eth: int = 32
) -> tuple[dict, np.ndarray]:
    """Seeded inputs of the epoch sweep over n validators at mainnet
    constants: the columns (numpy [n] uint64, bool `slashed`, uint8
    `prev_flags`) and the [9] uint64 scalars. Besides ordinary rows they
    hold the edge rows: FAR_FUTURE_EPOCH epochs (pending and active
    validators), exited ones, slashed ones with withdrawable_epoch ahead of
    the previous epoch and behind it, balances below their penalties, and
    effective_balance * score in [2^63, 2^64) as far as the host guard
    (state_processing/altair.py `_device_sweep_applicable`) admits.

    `max_eb_eth=2048` gives Electra's range: 5% of the rows (compounding
    validators) take effective balances of 33 to 2048 ETH, and the edge
    rows of large products sit at 2048 ETH with scores just under the
    guard, which the largest effective balance now sets."""
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
    if max_eb_eth > 32:
        comp = rng.random(n) < 0.05
        eb[comp] = rng.integers(33, max_eb_eth + 1, int(comp.sum())).astype(np.uint64) * np.uint64(inc)
        bal[comp] = eb[comp] + rng.integers(0, 2 * inc, int(comp.sum())).astype(np.uint64)

    k = max(64, n // 256)
    edge = rng.permutation(n)[: 2 * k]
    big, poor = edge[:k], edge[k:]
    # effective_balance * score >= 2^63 for an active, non-slashed
    # validator that missed its target, up to the guard's limit
    top = max_eb_eth * inc
    eb[big] = np.uint64(top)
    act[big] = 0
    ext[big] = far
    wd[big] = far
    slashed[big] = False
    flags[big] = rng.choice(np.array([0, 1, 4, 5], np.uint8), k)
    lo = -(-(1 << 63) // top) + recovery
    hi = (1 << 64) // top - bias
    scores[big] = rng.integers(lo, hi + 1, k, dtype=np.uint64)
    if max_eb_eth > 32:
        scores[big[0]] = hi  # the guard's edge itself
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


# below these sizes host work runs inline, above them on the host pool's
# forked workers: scalars multiplied, rows hashed
HOST_POOL_MIN = 1024
HOST_POOL_ROWS = 1 << 16


def _pooled(fn, items: list) -> list:
    """`fn` over contiguous shards of `items`, concatenated in order: on
    the host pool's workers for large inputs (pure-Python bigint work, no
    torch in the children), inline for small ones."""
    pool = host_pool.get_pool()
    if len(items) < HOST_POOL_MIN or pool.inline:
        return fn(items)
    return [x for part in pool.map(fn, host_pool.shard(items, 4 * pool.size)) for x in part]


def _hash_rows(rows: np.ndarray) -> np.ndarray:
    """hashlib's SHA-256 of each [n, 64] row, in shards on the host pool's
    workers for large n (the host-lane oracles fold 8M rows at 1M
    validators)."""
    pool = host_pool.get_pool()
    if rows.shape[0] < HOST_POOL_ROWS or pool.inline:
        return hash_rows_hashlib(rows)
    return np.concatenate(pool.map(hash_rows_hashlib, np.array_split(rows, 4 * pool.size)))


def _g1_points_of(ks: list[int]) -> list:
    """[k]G1 + G1 for each k, Jacobian (a host pool work unit)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, G1_GEN, pt_add, pt_mul

    return [pt_add(FQ, pt_mul(FQ, G1_GEN, k), G1_GEN) for k in ks]


def _g1_gen_affine(sks: list[int]) -> list:
    """[sk]G1 for each key, affine, one inversion for the shard (a host
    pool work unit)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, batch_to_affine, g1_gen_mul

    return batch_to_affine(FQ, [g1_gen_mul(sk) for sk in sks])


def bls_g1_points(rng: np.random.Generator, n: int) -> list:
    """n Jacobian G1 points [k]G1 with seeded k, with Z != 1."""
    return _pooled(_g1_points_of, bls_scalars(rng, n, 255))


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
    inversion a shard)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import R

    if count == 0:
        return [], [], []
    sks = [s % R or 1 for s in bls_scalars(rng, count, 255)]
    affs = _pooled(_g1_gen_affine, sks)
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
        level = _hash_rows(level.reshape(-1, 64))
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
    leaves[:, 0] = _hash_rows(pk)
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
        level = _hash_rows(level.reshape(-1, 64))
    return level


def _u64_container_roots(values, names) -> np.ndarray:
    """[m, 32] roots of containers whose fields `names` are all uint64."""
    width = next_pow_of_two(len(names))
    leaves = np.zeros((len(values), width, 32), dtype=np.uint8)
    for f, name in enumerate(names):
        col = np.array([int(getattr(v, name)) for v in values], dtype="<u8")
        leaves[:, f, :8] = col.view(np.uint8).reshape(-1, 8)
    level = leaves.reshape(-1, 32)
    while level.shape[0] > len(values):
        level = _hash_rows(level.reshape(-1, 64))
    return level


def host_state_root(state) -> bytes:
    """The state's root folded from its leaves through hashlib only: the
    registry-scale fields and Electra's pending lists leaf by leaf, the
    small fields through their own SSZ roots (all below the kernel's size
    thresholds)."""
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
        elif fname in ELECTRA_PENDING_LISTS:
            leaves = _u64_container_roots(list(value), list(ftype.ELEM._fields))
            root = mix_in_length(_host_fold(leaves, limit), len(value))
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
        fold = _hash_rows(fold.reshape(-1, 64))
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
    `epoch_sweep_inputs`, on Electra's rows (effective balances up to 2048
    ETH, scores just under the host guard), and at EPOCH_SWEEP_ABOVE_KEEP
    (past the shared-memory keep). Times in the same call, in turns (new, replaced,
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

    # Electra's range: compounding rows up to 2048 ETH, the edge rows'
    # products at 2048 ETH with scores just under the host guard
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(seed + 8), n, False, max_eb_eth=2048)
    args = k7.sweep_tensors(cols, scalars, dev)
    want = k7.sweep_results(k7.epoch_sweep_plain(*args))
    electra_err = _sweep_err(k7.sweep_results(k7.epoch_sweep(*args)), want)
    electra_replaced_err = _sweep_err(k7.sweep_results(k7.epoch_sweep_two_pass(*args)), want)
    if electra_err or electra_replaced_err:
        raise AssertionError(
            f"epoch_sweep on Electra rows differs from its plain version: {electra_err}; "
            f"the replaced sweep: {electra_replaced_err}"
        )
    eb_max = int(cols["effective_balance"].max())
    products = cols["effective_balance"].astype(object) * cols["scores"].astype(object)
    cases["electra"] = {
        "max_abs_err": electra_err,
        "replaced_max_abs_err": electra_replaced_err,
        "gpu_ms": _gpu_ms([lambda: k7.epoch_sweep(*args)])[0],
        "max_effective_balance": eb_max,
        "max_score": int(cols["scores"].max()),
        "guard_score_limit": (1 << 64) // eb_max,
        "rows_above_32_eth": int((cols["effective_balance"] > np.uint64(32 * 10**9)).sum()),
        "rows_product_ge_2_63": int((products >= 1 << 63).sum()),
    }
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

    # the backend follows the card's device: `cuda`, with no set_backend
    if bls.backend_setting() is not None or bls.backend_name() != "cuda":
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r}), not the device's cuda")
    # warm the pubkey decompression and limb caches, as a node's validator
    # pubkey cache has them; a new block's signatures are not cached
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
        got_cuda = bls.verify_signature_sets(batch, random.Random(seed))
        t0 = time.perf_counter()
        got_host = bls._BACKENDS["host"].verify_signature_sets(batch, random.Random(seed))
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


def transition_block(
    pre, types, E, spec, sk_of: dict, seed: int, commitments: list[bytes], fork: str = "deneb", operations=None
) -> dict:
    """One full block of `fork` (Deneb, or Electra with Electra's
    withdrawals) for the first slot after `pre`'s epoch
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
    attestation signed over another message (re-signed by the proposer).

    `operations` (`ElectraOperations`) adds the block operations phase 6
    bypasses: it picks their validators on `pre` (their signers get keys
    with the attesters'), builds them against the post-slot state, and
    names the altered copies it makes (each re-signed by the proposer)."""
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
    T = types.types_for_fork(fork)
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
    extra = operations.choose(pre, proposer) if operations else []

    attesters = np.unique(np.concatenate([c[b] for (_, _, c), b in zip(committees, bits)]))
    new = [i for i in np.union1d(attesters, [proposer, *extra]).tolist() if i not in sk_of]
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
    if fork == "electra":
        from lighthouse_tpu_torch.state_processing.electra import get_expected_withdrawals_electra

        withdrawals = get_expected_withdrawals_electra(mid, spec, E)[0]
    else:
        withdrawals = get_expected_withdrawals(mid, E)
    ops = operations.build(mid, sk_of) if operations else {"body": {}, "payload": {}, "altered": {}}
    payload = T.ExecutionPayload(
        parent_hash=header.block_hash,
        fee_recipient=rng.bytes(20),
        state_root=rng.bytes(32),
        receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256),
        prev_randao=get_randao_mix(mid, epoch, E),
        block_number=int(header.block_number) + 1,
        gas_limit=int(header.gas_limit),
        gas_used=int(rng.integers(0, max(int(header.gas_limit), 1))),
        timestamp=compute_timestamp_at_slot(mid, spec, E),
        extra_data=rng.bytes(16),
        base_fee_per_gas=int(header.base_fee_per_gas),
        block_hash=rng.bytes(32),
        transactions=[rng.bytes(int(k)) for k in rng.integers(100, 600, 150)],
        withdrawals=withdrawals,
        blob_gas_used=len(commitments) * BLOB_GAS_PER_BLOB,
        excess_blob_gas=0,
        **ops["payload"],
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
            **ops["body"],
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
    altered = {}
    for name, alter in ops["altered"].items():
        copy = T.BeaconBlock.deserialize(block.serialize())
        alter(copy.body)
        altered[name] = signed(copy).serialize()
    return {
        "signed": good.serialize(),
        "tampered": signed(bad).serialize(),
        "altered": altered,
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


def _import_rep(pre, signed, spec, E) -> tuple[dict, object]:
    """One block import across the boundary from a copy() of `pre`, as a
    node runs it: per_slot_processing, per_block_processing of `signed`
    under VERIFY_BULK with the signature cache emptied, hash_tree_root();
    each step timed with a host clock that ends in a card sync. Returns the
    rep's record and the post-state."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_processing import (
        BlockSignatureStrategy,
        per_block_processing,
        per_slot_processing,
    )

    s = pre.copy()
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
    record = {
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
    return record, s


def _sweep_equals_numpy(pre, spec, E, fork) -> None:
    """The epoch-sweep kernel's balances and scores against the port's
    numpy sweep, on copies of `pre` after justification; raises if they
    differ or the kernel was not launched."""
    from lighthouse_tpu_torch.state_processing import altair
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for

    a = pre.copy()
    cols = registry_columns_for(a)
    cols.refresh(a)
    arr = altair.EpochArrays(a, E, columns=cols)
    altair.process_justification_and_finalization_altair(a, E, arr)
    b = a.copy()
    launches = k7.COUNTS["launches"]
    altair._device_rewards_and_inactivity(a, spec, E, fork, arr)
    if k7.COUNTS["launches"] != launches + 1:
        raise AssertionError("(a) the sweep did not launch the kernel")
    colsb = registry_columns_for(b)
    colsb.refresh(b)
    arrb = altair.EpochArrays(b, E, columns=colsb)
    altair.process_inactivity_updates(b, spec, E, arrb)
    altair.process_rewards_and_penalties_altair(b, spec, E, fork, arrb)
    for field in ("balances", "inactivity_scores"):
        if getattr(a, field).load_array().tobytes() != getattr(b, field).load_array().tobytes():
            raise AssertionError(f"(a) kernel {field} differ from the numpy sweep")


def _refused(mid, signed, spec, E) -> bool:
    """Whether per_block_processing of `signed` on a copy of the post-slot
    state `mid` fails its bulk signature verification."""
    from lighthouse_tpu_torch.state_processing import (
        BlockProcessingError,
        BlockSignatureStrategy,
        per_block_processing,
    )

    try:
        per_block_processing(mid.copy(), signed, spec, E, BlockSignatureStrategy.VERIFY_BULK, verify_block_root=False)
    except BlockProcessingError as e:
        return "bulk signature verification failed" in str(e)
    return False


def phase_transition_main_path(state, types, E, sk_of: dict, seed: int, commitments: list[bytes]) -> tuple[dict, bytes, bytes]:
    """Block import across an epoch boundary on the 1M-validator state, as
    a node runs it: per_slot_processing over the boundary (the epoch
    transition, the sweep on the epoch-sweep kernel), per_block_processing
    of a full signed Deneb block under VERIFY_BULK on the `cuda` BLS
    backend, then hash_tree_root(); TRANSITION_REPS times, each from a
    copy() of the same pre-state. Checks: (a) the kernel's new balances
    and scores byte-equal to the port's numpy sweep on the same pre-state
    arrays; (b) the post-block root equal to the host-lane fold; (c) the
    block accepted; (d) the block with one attestation signed over another
    message refused. Returns the record, the block and that refused copy
    (re-signed by its proposer), both SSZ."""
    import statistics

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_processing import (
        BlockSignatureStrategy,
        altair,
        per_block_processing,
        per_slot_processing,
    )
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
    from lighthouse_tpu_torch.types.chain_spec import ForkName, mainnet_spec

    spec = mainnet_spec()
    T = types.types_for_fork("deneb")
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
        record, post = _import_rep(pre, T.SignedBeaconBlock.deserialize(blk["signed"]), spec, E)
        reps.append(record)
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

    # (a) the kernel's sweep against the port's numpy sweep
    _sweep_equals_numpy(pre, spec, E, ForkName.DENEB)

    # (b) the post-block root against the host-lane fold
    t0 = time.perf_counter()
    if host_state_root(post) != bytes.fromhex(reps[0]["root"]):
        raise AssertionError("(b) post-block root differs from the host-lane fold")
    oracle_s = time.perf_counter() - t0

    # (d) one attestation signed over another message: refused
    if not _refused(blk["mid"], T.SignedBeaconBlock.deserialize(blk["tampered"]), spec, E):
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
        "block": {k: v for k, v in blk.items() if k not in ("signed", "tampered", "altered", "mid", "post_root")},
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
    return out, blk["signed"], blk["tampered"]


# ---------------------------------------------------------------------------
# Phase 9: Electra block import across an epoch boundary
# ---------------------------------------------------------------------------

ELECTRA_REPS = 1
# What phase 9 adds to phase 6's pre-state and block (mainnet preset); the
# CPU tests pass smaller counts for a minimal-preset registry.
ELECTRA_SIZES = {
    "compounding": 0.05,  # share of the registry given 0x02 credentials
    "pending_deposits": 256,
    "pending_partials": 64,
    "matured_partials": 8,
    "consolidations": 16,
    "withdrawable_consolidations": 8,
    "ejected": 4,
    "proposer_slashings": 1,
    "attester_slashings": 1,
    "attester_slashing_signers": 4,
    "exits": 16,
    "bls_changes": 16,
    "deposits": 4,
    "receipts": 16,
    "full_exit_requests": 8,
    "partial_requests": 8,
}
ELECTRA_PENDING_LISTS = ("pending_balance_deposits", "pending_partial_withdrawals", "pending_consolidations")


def electra_prestate(state, types, E, spec, seed: int, sizes: dict = ELECTRA_SIZES) -> dict:
    """Make the Electra `state` (tree-states, at the last slot of an epoch)
    the pre-state of phase 9, in place, from `seed`: a `compounding` share
    of the registry, drawn from the active, unslashed, not exiting
    validators above the ejection balance, gets 0x02 credentials and
    effective balances spread between 32 and 2048 ETH (balances up to 1 ETH
    above); the
    pending-deposit queue gets `pending_deposits` top-ups;
    `pending_partials` partial withdrawals of compounding validators are
    queued, the first `matured_partials` withdrawable at the next epoch;
    `consolidations` pending consolidations from exited validators (a
    registry with too few gets some exited) into compounding ones, the
    first `withdrawable_consolidations` of them withdrawable, the rest not
    yet; `ejected` more validators at the ejection balance; and
    the eth1 deposit tree (seeded leaves up to eth1_deposit_index, then
    `deposits` signed deposits of new keys) becomes the state's eth1_data.
    Returns the deposits (with their proofs), the compounding validators,
    those with queued partial withdrawals, the indices the block's
    operations must leave alone, and the counts."""
    from lighthouse_tpu_torch.state_processing.accessors import invalidate_caches
    from lighthouse_tpu_torch.state_processing.genesis import DepositTree
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
    from lighthouse_tpu_torch.state_processing.signature_sets import deposit_signature_message

    rng = np.random.default_rng(seed + 41)
    S = E.SLOTS_PER_EPOCH
    epoch = int(state.slot) // S
    if (int(state.slot) + 1) % S:
        raise AssertionError("electra_prestate: the state is not at the last slot of an epoch")
    gwei = 10**9
    cols = registry_columns_for(state)
    cols.refresh(state)
    vs = state.validators
    n = len(vs)
    eb = np.array(cols.effective_balance, dtype=np.uint64)
    far = np.uint64(FAR_FUTURE_EPOCH)
    active = cols.active_mask(epoch) & cols.active_mask(epoch + 1)
    pool = np.nonzero(
        active & ~np.asarray(cols.slashed) & (cols.exit_epoch == far) & (eb > np.uint64(spec.ejection_balance))
    )[0]
    pick = rng.permutation(pool)
    k = max(1, int(sizes["compounding"] * n))
    comp, rest = np.sort(pick[:k]), pick[k:]
    ejected, rest = np.sort(rest[: sizes["ejected"]]), rest[sizes["ejected"] :]

    addresses = rng.bytes(20 * k)
    vs.set_fields_bulk(
        comp.tolist(),
        "withdrawal_credentials",
        [b"\x02" + bytes(11) + addresses[20 * j : 20 * j + 20] for j in range(k)],
    )
    comp_eb = rng.integers(32, 2049, k).astype(np.uint64) * np.uint64(gwei)
    vs.set_fields_bulk(comp.tolist(), "effective_balance", comp_eb.tolist())
    vs.set_fields_bulk(ejected.tolist(), "effective_balance", [spec.ejection_balance] * int(ejected.size))
    balances = np.array(state.balances.load_array(), dtype=np.uint64)
    balances[comp] = comp_eb + rng.integers(1, gwei, k).astype(np.uint64)
    state.balances.store_array(balances)

    topped = rng.choice(rest, sizes["pending_deposits"], replace=False)
    state.pending_balance_deposits = list(state.pending_balance_deposits) + [
        types.PendingBalanceDeposit(index=int(i), amount=int(a))
        for i, a in zip(topped, rng.integers(1, 32, topped.size) * gwei)
    ]
    partial = rng.choice(comp, sizes["pending_partials"], replace=False)
    m = sizes["matured_partials"]
    when = np.concatenate(
        [epoch + 1 - rng.integers(0, 4, m), epoch + 1 + rng.integers(1, 300, partial.size - m)]
    )
    order = np.argsort(when, kind="stable")
    state.pending_partial_withdrawals = [
        types.PendingPartialWithdrawal(index=int(partial[j]), amount=int(rng.integers(1, gwei)), withdrawable_epoch=int(when[j]))
        for j in order
    ]
    exited = np.nonzero(~np.asarray(cols.slashed) & (cols.exit_epoch <= np.uint64(epoch)))[0]
    need = sizes["consolidations"]
    if exited.size < need:
        # a young registry: exit some (this reshuffles the epoch's committees)
        extra, rest = rest[: need - exited.size], rest[need - exited.size :]
        vs.set_fields_bulk(extra.tolist(), "exit_epoch", [epoch - 1] * int(extra.size))
        invalidate_caches(state)
        exited = np.concatenate([exited, extra])
    w = sizes["withdrawable_consolidations"]
    sources = rng.choice(exited, need, replace=False)
    vs.set_fields_bulk(sources[:w].tolist(), "withdrawable_epoch", [epoch] * w)
    vs.set_fields_bulk(sources[w:].tolist(), "withdrawable_epoch", [epoch + 100] * (need - w))
    targets = rng.choice(np.setdiff1d(comp, partial), need, replace=False)
    state.pending_consolidations = [
        types.PendingConsolidation(source_index=int(a), target_index=int(b)) for a, b in zip(sources, targets)
    ]

    # the eth1 deposit tree: seeded leaves for the deposits already made,
    # then the block's bridge deposits of new keys
    sks, affs, pks = bls_keys(rng, sizes["deposits"])
    datas = []
    for pk in pks:
        data = types.DepositData(
            pubkey=pk,
            withdrawal_credentials=b"\x01" + bytes(11) + rng.bytes(20),
            amount=32 * gwei,
            signature=b"\x00" * 96,
        )
        data.signature = bls_sign(sks[len(datas)], deposit_signature_message(data, spec, E))
        datas.append(data)
    t0 = time.perf_counter()
    tree = DepositTree()
    start = int(state.eth1_deposit_index)
    leaves = rng.bytes(32 * start)
    tree.leaves = [leaves[32 * i : 32 * i + 32] for i in range(start)]
    for d in datas:
        tree.push(d.hash_tree_root())
    state.eth1_data = types.Eth1Data(deposit_root=tree.root(), deposit_count=len(tree.leaves), block_hash=rng.bytes(32))
    deposits = [types.Deposit(proof=tree.proof(start + j), data=d) for j, d in enumerate(datas)]
    tree_s = time.perf_counter() - t0

    cols.refresh(state)
    busy = np.unique(np.concatenate([ejected, sources, targets]))
    return {
        "deposits": deposits,
        "busy": busy,
        "compounding": comp,
        "partials": np.unique(partial),
        "counts": {
            "validators": n,
            "compounding": int(k),
            "effective_balance_max": int(comp_eb.max()),
            "pending_balance_deposits": len(state.pending_balance_deposits),
            "pending_partial_withdrawals": len(state.pending_partial_withdrawals),
            "matured_partials": m,
            "pending_consolidations": len(state.pending_consolidations),
            "withdrawable_consolidations": w,
            "at_ejection_balance": int(
                (
                    active
                    & (np.asarray(cols.effective_balance) <= np.uint64(spec.ejection_balance))
                    & ~np.asarray(cols.slashed)
                ).sum()
            ),
            "eth1_deposits": len(tree.leaves),
            "deposit_tree_s": tree_s,
        },
    }


class ElectraOperations:
    """The block operations phase 6 bypasses, for `transition_block`:
    proposer and attester slashings, voluntary exits, BLS-to-execution
    changes, bridge deposits (from `electra_prestate`), and in the payload
    deposit receipts and withdrawal requests (full exits of 0x01
    validators, partial ones of compounding validators). `choose` picks
    disjoint validators on the pre-state, away from `prestate["busy"]` and
    the proposer, writes the credentials the changes and requests need,
    and names the validators whose keys must sign; `build` makes and signs
    the operations against the post-slot state. The two altered copies:
    an exit and a BLS change, each signed over another message."""

    def __init__(self, types, E, spec, seed: int, prestate: dict, sizes: dict = ELECTRA_SIZES):
        self.types, self.E, self.spec, self.sizes, self.prestate = types, E, spec, sizes, prestate
        self.rng = np.random.default_rng(seed + 43)

    def choose(self, pre, proposer: int) -> list[int]:
        import hashlib

        from lighthouse_tpu_torch.crypto import bls
        from lighthouse_tpu_torch.state_processing import signature_sets as ss
        from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for

        sz, rng, spec = self.sizes, self.rng, self.spec
        nxt = int(pre.slot) // self.E.SLOTS_PER_EPOCH + 1
        cols = registry_columns_for(pre)
        cols.refresh(pre)
        far = np.uint64(FAR_FUTURE_EPOCH)
        eb = np.asarray(cols.effective_balance)
        ok = (
            cols.active_mask(nxt)
            & ~np.asarray(cols.slashed)
            & (cols.exit_epoch == far)
            & (cols.activation_epoch + np.uint64(spec.shard_committee_period) <= np.uint64(nxt))
            & (eb > np.uint64(spec.ejection_balance))
        )
        ok[self.prestate["busy"]] = False
        ok[proposer] = False
        comp = np.zeros(len(ok), bool)
        comp[self.prestate["compounding"]] = True
        comp[self.prestate["partials"]] = False
        plain = rng.permutation(np.nonzero(ok & ~comp)[0])
        counts = [
            sz["exits"],
            sz["proposer_slashings"],
            sz["attester_slashings"] * sz["attester_slashing_signers"],
            sz["bls_changes"],
            sz["full_exit_requests"],
        ]
        cuts = np.cumsum([0, *counts])
        self.exits, self.proposers, signers, self.changes, self.full = (
            np.sort(plain[a:b]) for a, b in zip(cuts[:-1], cuts[1:])
        )
        self.slashers = np.sort(signers).reshape(sz["attester_slashings"], sz["attester_slashing_signers"])
        self.partial = np.sort(rng.choice(np.nonzero(ok & comp)[0], sz["partial_requests"], replace=False))

        # the changes' withdrawal keys, and BLS credentials that name them
        self.w_sks, affs, self.w_pks = bls_keys(rng, self.changes.size)
        for (x, y), pk in zip(affs, self.w_pks):
            ss._PUBKEY_CACHE.setdefault(pk, bls.PublicKey(pk, (x, y, 1)))
        pre.validators.set_fields_bulk(
            self.changes.tolist(),
            "withdrawal_credentials",
            [b"\x00" + hashlib.sha256(pk).digest()[1:] for pk in self.w_pks],
        )
        self.addresses = [rng.bytes(20) for _ in self.full]
        pre.validators.set_fields_bulk(
            self.full.tolist(), "withdrawal_credentials", [b"\x01" + bytes(11) + a for a in self.addresses]
        )
        return np.concatenate([self.exits, self.proposers, self.slashers.ravel()]).tolist()

    def build(self, mid, sk_of: dict) -> dict:
        from lighthouse_tpu_torch.state_processing import signature_sets as ss
        from lighthouse_tpu_torch.state_processing.accessors import get_domain
        from lighthouse_tpu_torch.state_processing.capella import bls_to_execution_change_signature_set
        from lighthouse_tpu_torch.types.chain_spec import Domain, compute_signing_root

        t, E, spec, rng = self.types, self.E, self.spec, self.rng
        S = E.SLOTS_PER_EPOCH
        slot = int(mid.slot)
        epoch = slot // S
        gwei = 10**9

        def header_pair(p: int):
            pair = []
            for body_root in (rng.bytes(32), rng.bytes(32)):
                h = t.BeaconBlockHeader(
                    slot=slot - 1, proposer_index=p, parent_root=rng.bytes(32), state_root=rng.bytes(32), body_root=body_root
                )
                domain = get_domain(mid, Domain.BEACON_PROPOSER, (slot - 1) // S, spec, E)
                pair.append(
                    t.SignedBeaconBlockHeader(message=h, signature=bls_sign(sk_of[p], compute_signing_root(h.hash_tree_root(), domain)))
                )
            return t.ProposerSlashing(signed_header_1=pair[0], signed_header_2=pair[1])

        def double_vote(members):
            source = mid.previous_justified_checkpoint
            target = t.Checkpoint(epoch=epoch - 1, root=rng.bytes(32))
            domain = get_domain(mid, Domain.BEACON_ATTESTER, epoch - 1, spec, E)
            sk = sum(sk_of[int(i)] for i in members)
            out = []
            for _ in range(2):
                data = t.AttestationData(slot=slot - 1, index=0, beacon_block_root=rng.bytes(32), source=source, target=target)
                out.append(
                    t.IndexedAttestation(
                        attesting_indices=[int(i) for i in members],
                        data=data,
                        signature=bls_sign(sk, compute_signing_root(data.hash_tree_root(), domain)),
                    )
                )
            return t.AttesterSlashing(attestation_1=out[0], attestation_2=out[1])

        exit_domain = spec.compute_domain_from_parts(Domain.VOLUNTARY_EXIT, spec.capella_fork_version, mid.genesis_validators_root)

        def signed_exit(i: int, epoch_signed: int):
            message = compute_signing_root(t.VoluntaryExit(epoch=epoch_signed, validator_index=i).hash_tree_root(), exit_domain)
            return t.SignedVoluntaryExit(message=t.VoluntaryExit(epoch=epoch, validator_index=i), signature=bls_sign(sk_of[i], message))

        def change(j: int, address: bytes):
            c = t.BLSToExecutionChange(validator_index=int(self.changes[j]), from_bls_pubkey=self.w_pks[j], to_execution_address=self.change_to[j])
            unsigned = t.SignedBLSToExecutionChange(
                message=t.BLSToExecutionChange(validator_index=c.validator_index, from_bls_pubkey=c.from_bls_pubkey, to_execution_address=address),
                signature=b"\xc0" + bytes(95),
            )
            message = bls_to_execution_change_signature_set(mid, unsigned, spec, E).message
            return t.SignedBLSToExecutionChange(message=c, signature=bls_sign(self.w_sks[j], message))

        self.change_to = [rng.bytes(20) for _ in range(self.changes.size)]
        proposer_slashings = [header_pair(int(p)) for p in self.proposers]
        attester_slashings = [double_vote(members) for members in self.slashers]
        exits = [signed_exit(int(i), epoch) for i in self.exits]
        changes = [change(j, self.change_to[j]) for j in range(self.changes.size)]

        sks, _, pks = bls_keys(rng, self.sizes["receipts"])
        receipts = []
        for j, (sk, pk) in enumerate(zip(sks, pks)):
            data = t.DepositData(
                pubkey=pk, withdrawal_credentials=bytes([1 + j % 2]) + bytes(11) + rng.bytes(20), amount=32 * gwei, signature=b"\x00" * 96
            )
            receipts.append(
                t.DepositReceipt(
                    pubkey=pk,
                    withdrawal_credentials=data.withdrawal_credentials,
                    amount=data.amount,
                    signature=bls_sign(sk, ss.deposit_signature_message(data, spec, E)),
                    index=int(mid.eth1_data.deposit_count) + j,
                )
            )
        requests = [
            t.ExecutionLayerWithdrawalRequest(
                source_address=a, validator_pubkey=mid.validators[int(i)].pubkey, amount=spec.full_exit_request_amount
            )
            for i, a in zip(self.full, self.addresses)
        ] + [
            t.ExecutionLayerWithdrawalRequest(
                source_address=bytes(mid.validators[int(i)].withdrawal_credentials)[12:],
                validator_pubkey=mid.validators[int(i)].pubkey,
                amount=int(rng.integers(1, gwei)),
            )
            for i in self.partial
        ]
        # the altered copies: each signed over another message
        bad_exit = signed_exit(int(self.exits[0]), epoch - 1)
        bad_change = change(0, rng.bytes(20))

        def alter_exit(body):
            body.voluntary_exits[0].signature = bad_exit.signature

        def alter_change(body):
            body.bls_to_execution_changes[0].signature = bad_change.signature

        return {
            "body": {
                "proposer_slashings": proposer_slashings,
                "attester_slashings": attester_slashings,
                "deposits": self.prestate["deposits"],
                "voluntary_exits": exits,
                "bls_to_execution_changes": changes,
            },
            "payload": {"deposit_receipts": receipts, "withdrawal_requests": requests},
            "altered": {"exit_signed_over_another_message": alter_exit, "bls_change_signed_over_another_message": alter_change},
        }

    def counts(self) -> dict:
        return {
            "proposer_slashings": int(self.proposers.size),
            "attester_slashings": int(self.slashers.shape[0]),
            "attester_slashing_signers": int(self.slashers.size),
            "voluntary_exits": int(self.exits.size),
            "bls_to_execution_changes": int(self.changes.size),
            "deposits": len(self.prestate["deposits"]),
            "deposit_receipts": self.sizes["receipts"],
            "withdrawal_requests": int(self.full.size + self.partial.size),
        }


def _block_sets(block) -> int:
    """The signature sets BlockSignatureVerifier makes of `block`."""
    body = block.body
    return (
        2  # proposal, RANDAO
        + 2 * len(body.proposer_slashings)
        + 2 * len(body.attester_slashings)
        + len(body.attestations)
        + len(body.voluntary_exits)
        + int(any(body.sync_aggregate.sync_committee_bits))
        + len(body.bls_to_execution_changes)
    )


def phase_electra_main_path(state, types, E, sk_of: dict, seed: int, commitments: list[bytes]) -> dict:
    """Electra block import across an epoch boundary on a copy of phase
    6's 1M-validator pre-state: the copy upgraded with the port's
    upgrade_to_electra (timed once), given phase 9's Electra pre-state
    (`electra_prestate`: compounding validators up to 2048 ETH, the
    pending queues, validators at the ejection balance, the eth1 deposit
    tree), then ELECTRA_REPS times from a copy() of it: per_slot_processing
    over the boundary (the Electra epoch, its sweep on the epoch-sweep
    kernel), per_block_processing of a full, really signed Electra block
    (phase 6's attestations, sync aggregate, withdrawals led by the matured
    partial withdrawals and six blob commitments, plus `ElectraOperations`)
    under VERIFY_BULK on the `cuda` BLS backend, and hash_tree_root().
    Checks: the kernel launched once a rep; (a) its balances and scores on
    the Electra pre-state byte-equal to the port's numpy sweep; the
    resident columns not rebuilt after the first rep; (b) the post-block
    root equal to the host-lane fold (the pending lists folded leaf by
    leaf); (c) the block accepted; (d) the copies with an exit and with a
    BLS change signed over another message refused; the BLS kernels
    launched, with the number of sets verified."""
    import statistics
    from dataclasses import replace

    from lighthouse_tpu_torch.state_processing import altair
    from lighthouse_tpu_torch.state_processing.electra import upgrade_to_electra
    from lighthouse_tpu_torch.state_processing.registry_columns import registry_columns_for
    from lighthouse_tpu_torch.types.chain_spec import ForkName, mainnet_spec

    T = types.types_for_fork("electra")
    t0 = time.perf_counter()
    pre = state.copy()
    # the fork at the pre-state's own epoch
    spec = replace(mainnet_spec(), electra_fork_epoch=int(pre.slot) // E.SLOTS_PER_EPOCH)
    t1 = time.perf_counter()
    upgrade_to_electra(pre, spec, E)
    upgrade_s = time.perf_counter() - t1
    prestate = electra_prestate(pre, types, E, spec, seed)
    arrays = altair.EpochArrays(pre, E, columns=registry_columns_for(pre))
    if not altair._device_sweep_applicable(pre, arrays, spec, E):
        raise AssertionError("the host guard keeps the Electra pre-state off the epoch-sweep kernel")
    ops = ElectraOperations(types, E, spec, seed, prestate)
    blk = transition_block(pre, types, E, spec, sk_of, seed, commitments, fork="electra", operations=ops)
    signed = T.SignedBeaconBlock.deserialize(blk["signed"])
    setup_s = time.perf_counter() - t0

    # the main path: counts at zero just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k_sha256.reset_counts()
    reset_bls_counts()
    k7.reset_counts()
    reps = []
    for _ in range(ELECTRA_REPS):
        record, post = _import_rep(pre, T.SignedBeaconBlock.deserialize(blk["signed"]), spec, E)
        reps.append(record)
    counts = {"epoch_sweep": k7.COUNTS["launches"], "sha256_rows": k_sha256.COUNTS["launches"], **bls_counts()}
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"the Electra main path launched no {missing}")
    if any(r["epoch_sweep_launches"] != 1 for r in reps):
        raise AssertionError("an Electra epoch transition ran the epoch-sweep kernel other than once")
    if any(r["registry_columns_rebuilds"] for r in reps[1:]):
        raise AssertionError("resident registry columns rebuilt after the first epoch")
    if len({r["root"] for r in reps}) != 1 or reps[0]["root"] != blk["post_root"].hex():
        raise AssertionError("Electra post-block roots differ between reps or from the block's state_root")
    if type(post).__name__ != "BeaconStateElectra":
        raise AssertionError(f"the post-state is a {type(post).__name__}")

    # (a) the kernel's sweep on the Electra pre-state against the numpy sweep
    _sweep_equals_numpy(pre, spec, E, ForkName.ELECTRA)
    # (b) the post-block root against the host-lane fold
    t0 = time.perf_counter()
    if host_state_root(post) != bytes.fromhex(reps[0]["root"]):
        raise AssertionError("(b) the Electra post-block root differs from the host-lane fold")
    oracle_s = time.perf_counter() - t0
    # (d) the altered copies: refused
    for name, data in blk["altered"].items():
        if not _refused(blk["mid"], T.SignedBeaconBlock.deserialize(data), spec, E):
            raise AssertionError(f"(d) the block with an {name.replace('_', ' ')} was accepted")

    epoch_stages = {
        k: statistics.median(r["spans_s"][k] for r in reps) for k in TRANSITION_SPANS if k.startswith("epoch_stage_")
    }
    out = {
        "phase": "electra_main_path",
        "preset": E.NAME,
        "fork": "electra",
        "validators": len(pre.validators),
        "upgrade_s": upgrade_s,
        "setup_s": setup_s,
        "prestate": prestate["counts"],
        "operations": ops.counts(),
        "block": {k: v for k, v in blk.items() if k not in ("signed", "tampered", "altered", "mid", "post_root")},
        "post": {
            "validators": len(post.validators),
            **{f: len(getattr(post, f)) for f in ELECTRA_PENDING_LISTS},
            "earliest_exit_epoch": int(post.earliest_exit_epoch),
            "deposit_receipts_start_index": int(post.deposit_receipts_start_index),
        },
        "signature_sets": _block_sets(signed.message),
        "reps": reps,
        "total_median_s": statistics.median(r["total_s"] for r in reps),
        "per_slot_median_s": statistics.median(r["per_slot_s"] for r in reps),
        "epoch_transition_median_s": statistics.median(r["epoch_transition_s"] for r in reps),
        "block_median_s": statistics.median(r["block_s"] for r in reps),
        "block_signatures_median_s": statistics.median(r["block_signatures_s"] for r in reps),
        "block_rest_median_s": statistics.median(r["block_rest_s"] for r in reps),
        "state_root_median_s": statistics.median(r["state_root_s"] for r in reps),
        "epoch_stages_median_s": epoch_stages,
        "launches": counts,
        "epoch_sweep_launches": counts["epoch_sweep"],
        "registry_columns_rebuilds": [r["registry_columns_rebuilds"] for r in reps],
        "max_memory_allocated_bytes": peak,
        "host_lane_oracle_s": oracle_s,
        "checks": {
            "epoch-sweep kernel once a rep": True,
            "(a) sweep equal numpy": True,
            "columns not rebuilt after the first epoch": True,
            "(b) root equal host lanes": True,
            "(c) block accepted": True,
            "(d) exit signed over another message refused": True,
            "(d) BLS change signed over another message refused": True,
        },
    }
    emit(out)
    return out


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


# The blob counts of the barycentric checks by domain, the last one also
# with one z on the domain: at 4096 a proof's, a block's and a segment's;
# at 64 (phase 15's DasTestnetEthSpec) a proof's and a fleet block's two.
KZG_CHECK_BLOBS = {4096: (1, BLOBS_PER_BLOCK, BLOBS_PER_BLOCK * SEGMENT_BLOCKS), 64: (1, 2)}


def phase_kzg_kernel_checks(kzg, seed: int) -> dict:
    """The KZG kernels at the main path's shapes, each equal to its plain
    version on the card and to the host for one case: the barycentric
    evaluation at [1, 4096] (a proof), [6, 4096] (a block, and six with
    one z on the domain) and [192, 4096] (a segment), the
    quotient at 4096 lanes (z off the domain and on it), the MSM's table of
    the 4096 setup points with edge cases and the fixed-base MSM over it;
    with times, plain times and bounds. On phase 15's 64-point dev setup
    the same checks run at [1, 64] and [2, 64] (KZG_CHECK_BLOBS)."""
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
    counts = KZG_CHECK_BLOBS[n]
    for m, on_domain in [(m, None) for m in counts] + [(counts[1], min(2, counts[1] - 1))]:
        words = np.stack([k_fr.words_from_bytes(b, n) for b in kzg_blobs(rng, m, n)])
        zs = fr_scalars(rng, m)
        if on_domain is not None:
            zs[on_domain] = setup.roots_brp[77 % n]
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
            fold = _hash_rows(fold.reshape(-1, 64))
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


# ---------------------------------------------------------------------------
# Phase 10: the chain
# ---------------------------------------------------------------------------

CHAIN_HARNESS_VALIDATORS = 64
CHAIN_HARNESS_SLOTS = 32
CHAIN_GOSSIP_ATTESTATIONS = 64
CHAIN_GOSSIP_TAMPERED_BATCH = 8


def chain_counts() -> dict:
    """Every kernel counter the chain's calls can move, by kernel name."""
    return (
        {"sha256_rows": k_sha256.COUNTS["launches"], "epoch_sweep": k7.COUNTS["launches"]}
        | bls_counts()
        | kzg_counts()
        | {k: k_g.COUNTS[k] for k in ("g1_scalar_mul_wide", "g1_scalar_mul_wide64")}
        | dict(k_ms.COUNTS)
    )


def reset_chain_counts() -> None:
    k_sha256.reset_counts()
    k7.reset_counts()
    reset_bls_counts()
    reset_kzg_counts()
    k_ms.reset_counts()


def _stepper(tag: str, smi: str, sink=None):
    """A phase's step timer: `step(name, fn, detail=None)` runs `fn`,
    keeps its seconds (after a card sync) in `steps` and the kernels it
    launched in `launches`, and prints both on a `tag` line with the
    card's name and power limit, with `detail()`'s record where given
    (`sink(line)` takes the lines instead, in a spawned process)."""
    steps, launches, details = {}, {}, {}

    def step(name, fn, detail=None):
        before = chain_counts()
        t0 = time.perf_counter()
        res = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        launches[name] = {k: v - before[k] for k, v in chain_counts().items() if v != before[k]}
        details[name] = detail() if detail is not None else None
        line = {"phase": tag, "step": name, "s": steps[name], "launches": launches[name], "card": smi}
        (sink or emit)(line | ({"detail": details[name]} if details[name] is not None else {}))
        return res

    return steps, launches, details, step


def _verdicts(results) -> list:
    return [type(r).__name__ if isinstance(r, Exception) else None for r in results]


def _chain_attestations(state, types, E, spec, sk_of: dict, head_root: bytes, n: int) -> list:
    """`n` unaggregated attestations at `state`'s slot voting for
    `head_root` (the epoch's first block), one a validator, from the
    committee members that have a key in `sk_of`, each signed with it."""
    from lighthouse_tpu_torch.state_processing.accessors import committee_cache_at, get_domain
    from lighthouse_tpu_torch.types.chain_spec import Domain, compute_signing_root

    slot = int(state.slot)
    epoch = slot // E.SLOTS_PER_EPOCH
    cc = committee_cache_at(state, epoch, E)
    domain = get_domain(state, Domain.BEACON_ATTESTER, epoch, spec, E)
    out = []
    for index in range(cc.committees_per_slot):
        committee = [int(v) for v in cc.committee(slot, index)]
        data = types.AttestationData(
            slot=slot,
            index=index,
            beacon_block_root=head_root,
            source=state.current_justified_checkpoint,
            target=types.Checkpoint(epoch=epoch, root=head_root),
        )
        msg = compute_signing_root(data.hash_tree_root(), domain)
        for pos, v in enumerate(committee):
            if v in sk_of:
                bits = [False] * len(committee)
                bits[pos] = True
                out.append(types.Attestation(aggregation_bits=bits, data=data, signature=bls_sign(sk_of[v], msg)))
                if len(out) == n:
                    return out
    raise AssertionError(f"only {len(out)} of {n} attesters at slot {slot} have a key")


def phase_chain_main_path(
    pre, signed_bytes: bytes, post_root: bytes, kzg, blobs: list[bytes], types, E, sk_of: dict, seed: int, smi: str
) -> dict:
    """Block import through the port's BeaconChain entry points, with the
    BLS backend left to follow the device (no set_backend call; `cuda` on
    the card):
    (a) the first milestone: BeaconChainHarness on the minimal preset, 64
        interop validators, extend_chain(32): each block produced, signed
        and imported by process_block, each slot's 8 attestations through
        process_attestation_batch; justified epoch 3, finalized 2, head
        slot 32; a block with one attestation signature swapped for a
        valid signature over another message refused by process_block
        with the head unmoved; a gossip batch of 8 with one such
        signature: exactly one AttestationError, at its index;
    (b) block import at 1M validators (mainnet preset): a BeaconChain
        over HotColdDB(MemoryStore()) anchored on a copy of phase 6's
        pre-state (its filled header the anchor block), a ManualSlotClock
        and a Kzg on the card over the ceremony setup; phase 7's six blob
        sidecars through process_blob_sidecars, then phase 6's signed block
        through verify_block_for_gossip and process_block: the head is the
        block and its state root phase 6's post-state root;
    (c) store round trip: store.get_state(post-state root), rooted cold
        on the card, equal to the root before;
    (d) a gossip batch of 64 unaggregated attestations to the new head,
        signed with phase 5/6's keys, all accepted; a batch of 8 more with
        one signed over another message: only that one refused.
    Each step's seconds on its own line with the card's name and power
    limit; the kernels each step launched."""
    from lighthouse_tpu_torch import default_device
    from lighthouse_tpu_torch.beacon_chain import BeaconChainHarness, BlockError
    from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.ssz.merkle_proof import build_blob_sidecars
    from lighthouse_tpu_torch.state_processing import per_slot_processing
    from lighthouse_tpu_torch.state_processing.accessors import get_beacon_proposer_index
    from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
    from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    want_backend = "cuda" if default_device().type == "cuda" else "host"
    if bls.backend_setting() is not None or bls.backend_name() != want_backend:
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r}), not {want_backend!r}")
    steps, launches, _, step = _stepper("chain_step", smi)

    # prepared outside the counted run: the blob sidecars (phase 7's), the
    # anchor (a copy of phase 6's pre-state)
    T = types.types_for_fork("deneb")
    signed = T.SignedBeaconBlock.deserialize(signed_bytes)
    root = signed.message.hash_tree_root()
    slot = int(signed.message.slot)
    sidecars = build_blob_sidecars(signed, blobs, kzg, E)
    anchor = pre.copy()
    spec = mainnet_spec()

    # the main path: counts at zero just before, read just after
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_chain_counts()

    # (a) the first milestone on the minimal preset
    h = step("a_harness_genesis", lambda: BeaconChainHarness(minimal_spec(), MinimalEthSpec, validator_count=CHAIN_HARNESS_VALIDATORS))
    chain_a = h.chain
    per_call = {"process_block": [], "process_attestation_batch": []}

    def observed(name, fn):
        def call(*args, **kwargs):
            k4 = k_pair.COUNTS["multi_pairing"]
            res = fn(*args, **kwargs)
            per_call[name].append((k_pair.COUNTS["multi_pairing"] - k4, res))
            return res

        return call

    chain_a.process_block = observed("process_block", chain_a.process_block)
    chain_a.process_attestation_batch = observed("process_attestation_batch", chain_a.process_attestation_batch)
    step("a_extend_chain", lambda: h.extend_chain(CHAIN_HARNESS_SLOTS))
    del chain_a.process_block, chain_a.process_attestation_batch
    milestone = (h.justified_epoch, h.finalized_epoch, int(chain_a.head_state.slot))
    if milestone != (3, 2, CHAIN_HARNESS_SLOTS):
        raise AssertionError(f"(a) justified, finalized, head slot {milestone}, not (3, 2, {CHAIN_HARNESS_SLOTS})")
    blocks_a, batches_a = per_call["process_block"], per_call["process_attestation_batch"]
    # on the card, each import and each batch verifies with the pairing kernel
    on_card = want_backend == "cuda"
    if len(blocks_a) != CHAIN_HARNESS_SLOTS or any(on_card and k4 < 1 for k4, _ in blocks_a):
        raise AssertionError(f"(a) {len(blocks_a)} block imports, multi-pairings {[k for k, _ in blocks_a]}")
    if len(batches_a) != CHAIN_HARNESS_SLOTS or any((on_card and k4 < 1) or _verdicts(r) != [None] * 8 for k4, r in batches_a):
        raise AssertionError(f"(a) attestation batches: {[(k, _verdicts(r)) for k, r in batches_a]}")
    # a block whose first attestation carries a valid signature over another message
    head_a = bytes(chain_a.head_root)
    slot_a = CHAIN_HARNESS_SLOTS + 1
    h.slot_clock.set_slot(slot_a)
    proposer_state = chain_a.head_state.copy()
    per_slot_processing(proposer_state, h.spec, h.E)
    proposer = get_beacon_proposer_index(proposer_state, h.E)
    block_a, _ = chain_a.produce_block_on_state(
        slot_a,
        h.randao_reveal(proposer, slot_a, proposer_state),
        sync_aggregate_fn=lambda st: h.make_sync_aggregate(st, slot_a, head_a),
    )
    att = block_a.body.attestations[0]
    other = h.make_attestations(int(att.data.slot), b"\x99" * 32)[int(att.data.index)]
    block_a.body.attestations[0] = chain_a.types.Attestation(aggregation_bits=att.aggregation_bits, data=att.data, signature=other.signature)
    tampered_a = h.sign_block(block_a, proposer_state)

    def refused_block():
        try:
            chain_a.process_block(tampered_a)
        except BlockError as e:
            return str(e)
        raise AssertionError("(a) the block with a swapped attestation signature was imported")

    refused_a = step("a_tampered_block", refused_block)
    if bytes(chain_a.head_root) != head_a:
        raise AssertionError("(a) the head moved on a refused block")
    atts = h.make_unaggregated_attestations(slot_a, head_a)
    resigned = h.make_unaggregated_attestations(slot_a, b"\x99" * 32)
    bad_at = 3
    atts[bad_at] = chain_a.types.Attestation(
        aggregation_bits=atts[bad_at].aggregation_bits, data=atts[bad_at].data, signature=resigned[bad_at].signature
    )
    verdicts_a = _verdicts(step("a_tampered_batch", lambda: chain_a.process_attestation_batch(atts)))
    if verdicts_a != [None] * bad_at + ["AttestationError"] + [None] * (len(atts) - bad_at - 1):
        raise AssertionError(f"(a) the batch with one bad signature gave {verdicts_a}")
    del h, chain_a

    # (b) phase 6's block through the chain at 1M validators
    clock = ManualSlotClock(genesis_time=int(anchor.genesis_time), seconds_per_slot=spec.seconds_per_slot)
    chain = step(
        "b_chain_init",
        lambda: BeaconChain(HotColdDB(MemoryStore()), genesis_state=anchor, spec=spec, E=E, slot_clock=clock, kzg=kzg),
    )
    if chain.genesis_block_root != bytes(signed.message.parent_root):
        raise AssertionError("(b) the block's parent is not the anchor's filled header")
    clock.set_slot(slot)
    staged = step("b_process_blob_sidecars", lambda: chain.process_blob_sidecars(root, sidecars))
    if staged.available:
        raise AssertionError("(b) the blobs were available before their block")
    gossip = step("b_verify_block_for_gossip", lambda: chain.verify_block_for_gossip(signed))
    imported = step("b_process_block", lambda: chain.process_block(gossip))
    if bytes(imported) != root or bytes(chain.head_root) != root:
        raise AssertionError("(b) the head is not the imported block")
    head_root_b = step("b_head_state_root", lambda: chain.head_state.hash_tree_root())
    if bytes(head_root_b) != post_root or bytes(signed.message.state_root) != post_root:
        raise AssertionError("(b) the head state's root is not phase 6's post-state root")
    stored_blobs = chain.store.get_blob_sidecars(root)
    if stored_blobs is None or len(stored_blobs) != len(blobs):
        raise AssertionError("(b) the block's blob sidecars were not stored with it")
    da_launches = launches["b_process_blob_sidecars"]
    if on_card and (da_launches.get("barycentric_eval", 0) < 1 or da_launches.get("multi_pairing", 0) < 1):
        raise AssertionError(f"(b) the DA gate launched {da_launches}")

    # (c) the store round trip
    loaded = step("c_store_get_state", lambda: chain.store.get_state(post_root))
    _make_persistent(loaded)
    root_c = step("c_cold_root", lambda: loaded.hash_tree_root())
    if bytes(root_c) != post_root:
        raise AssertionError("(c) the state read back from the store roots differently")
    del loaded

    # (d) gossip attestations to the new head
    atts = _chain_attestations(
        chain.head_state, types, E, spec, sk_of, root, CHAIN_GOSSIP_ATTESTATIONS + CHAIN_GOSSIP_TAMPERED_BATCH
    )
    clean, rest = atts[:CHAIN_GOSSIP_ATTESTATIONS], atts[CHAIN_GOSSIP_ATTESTATIONS:]
    verdicts_d = _verdicts(step("d_attestation_batch", lambda: chain.process_attestation_batch(clean)))
    if verdicts_d != [None] * len(clean):
        raise AssertionError(f"(d) the clean batch gave {verdicts_d}")
    other_d = _chain_attestations(chain.head_state, types, E, spec, sk_of, b"\x99" * 32, len(atts))[CHAIN_GOSSIP_ATTESTATIONS + bad_at]
    rest[bad_at] = types.Attestation(aggregation_bits=rest[bad_at].aggregation_bits, data=rest[bad_at].data, signature=other_d.signature)
    verdicts_d2 = _verdicts(step("d_tampered_batch", lambda: chain.process_attestation_batch(rest)))
    if verdicts_d2 != [None] * bad_at + ["AttestationError"] + [None] * (len(rest) - bad_at - 1):
        raise AssertionError(f"(d) the batch with one bad signature gave {verdicts_d2}")

    counts = chain_counts()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    required = ["sha256_rows", "epoch_sweep", *BLS_KERNELS, "barycentric_eval"]
    missing = [k for k in required if on_card and counts[k] <= 0]
    if missing:
        raise AssertionError(f"the chain's calls launched no {missing}")
    out = {
        "phase": "chain_main_path",
        "backend": bls.backend_name(),
        "backend_set": bls.backend_setting(),
        "a_minimal": {
            "validators": CHAIN_HARNESS_VALIDATORS,
            "slots": CHAIN_HARNESS_SLOTS,
            "justified_epoch": milestone[0],
            "finalized_epoch": milestone[1],
            "head_slot": milestone[2],
            "multi_pairings_per_block": [k for k, _ in blocks_a],
            "multi_pairings_per_batch": [k for k, _ in batches_a],
            "tampered_block": refused_a,
            "tampered_batch": verdicts_a,
        },
        "b_import": {
            "preset": E.NAME,
            "validators": len(anchor.validators),
            "block_slot": slot,
            "sidecars": len(sidecars),
            "head_is_block": True,
            "post_state_root": post_root.hex(),
        },
        "c_round_trip_root_equal": True,
        "d_gossip": {"attestations": len(clean), "tampered_batch": verdicts_d2},
        "steps_s": steps,
        "launches_per_step": launches,
        "launches": counts,
        "max_memory_allocated_bytes": peak,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 11: the Beacon API
# ---------------------------------------------------------------------------

API_HARNESS_SLOTS = 32
# (e): the harness's blocks after node B boots, at least (an epoch)
API_HARNESS_FOLLOW = 8
SSZ_TYPE = "application/octet-stream"


def _http(base: str, path: str, data: bytes | None = None, content_type: str | None = None, accept: str | None = None) -> tuple:
    """(status, headers, body) of one request to a Beacon API server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, method="GET" if data is None else "POST")
    if accept:
        req.add_header("Accept", accept)
    if content_type:
        req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _metric_series(text: str, name: str) -> dict:
    """{labels: value} of one metric in a Prometheus text exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            labels, value = line[len(name) + 1 :].rsplit("} ", 1)
            out[labels] = float(value)
    return out


def _json_roundtrip(obj):
    return json.loads(json.dumps(obj))


def phase_api_main_path(
    pre, signed_bytes: bytes, tampered_bytes: bytes, post_root: bytes, kzg, blobs: list[bytes], types, E, sk_of: dict, smi: str
) -> dict:
    """The Beacon API on the card, with the BLS backend following the
    device (`cuda`), every request over HTTP on 127.0.0.1:
    (a) node A: a BeaconChain over HotColdDB(MemoryStore()) anchored on a
        copy of phase 6's 1M-validator pre-state (as phase 10 (b)) behind
        HttpApiServer(chain, port=0); the six sidecars through the chain,
        then phase 6's block through BeaconNodeHttpClient.publish_block_ssz:
        200, head the block, its state root phase 6's post-state root; the
        copy with one attestation signed over another message (re-signed
        by its proposer, its own six sidecars staged): 400, head unmoved;
        64 gossip attestations POSTed (200), then 8 with one bad (202, one
        of eight refused, as process_attestation_batch refuses it);
    (b) reads on A: the head state's root (phase 6's post-state root,
        which phase 6 held to the host-lane fold), finality checkpoints,
        every validator and three by id, every balance, the committees,
        the proposer duties; the block, attestation and sync-committee
        rewards of the posted block and the epoch its transition rewarded,
        each equal to the rewards functions called directly; the light
        client's bootstrap at the anchor, checked by
        initialize_light_client_store (the update route answers 404: the
        anchor's finalized checkpoint names a block no chain holds);
    (c) HttpApiServer(chain, workers=2) on A: every (b) read a worker may
        answer, through the public port, equal to (b)'s body; the
        forwards by cause; no worker death;
    (d) node B at 1M: A's head block and head state SSZ over HTTP (A's
        only block; its anchor has none), the block root checked against
        the served head root, the state decoded and rooted cold on the
        card against the block's state root, BeaconChain.from_checkpoint;
        B's head is A's head block;
    (e) the minimal preset: a harness with Altair from genesis (64
        validators) extended until it finalizes, behind a server; node B
        by checkpoint_boot(url, ...); the harness's blocks past B's anchor
        and its next ones, until it finalizes past the anchor and one
        more, POSTed to B's API, each verified on the card; B's
        head and finalized checkpoint equal the harness's; a light client
        bootstrapped at the finalized root takes the update route's
        update (its sync aggregate verified on the host, as the JAX
        package does).
    Each step's seconds on its own line with the card's name and power
    limit; the kernels each step launched."""
    from dataclasses import replace

    from lighthouse_tpu_torch import default_device
    from lighthouse_tpu_torch.beacon_chain import BeaconChainHarness
    from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain
    from lighthouse_tpu_torch.beacon_chain.checkpoint_sync import checkpoint_boot
    from lighthouse_tpu_torch.beacon_chain.rewards import (
        compute_attestation_rewards,
        compute_block_rewards,
        compute_sync_committee_rewards,
    )
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.eth2 import ApiClientError, BeaconNodeHttpClient
    from lighthouse_tpu_torch.http_api import HttpApiServer
    from lighthouse_tpu_torch.http_api.workers import _LOCAL_GET_PREFIXES
    from lighthouse_tpu_torch.light_client import (
        build_light_client_types,
        initialize_light_client_store,
        process_light_client_update,
    )
    from lighthouse_tpu_torch.ssz.core import List as SszList
    from lighthouse_tpu_torch.ssz.merkle_proof import build_blob_sidecars
    from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
    from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    on_card = default_device().type == "cuda"
    if bls.backend_setting() is not None or bls.backend_name() != ("cuda" if on_card else "host"):
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r})")
    steps, launches, _, step = _stepper("api_step", smi)

    # prepared outside the counted run: both blocks' sidecars, the anchor
    T = types.types_for_fork("deneb")
    signed = T.SignedBeaconBlock.deserialize(signed_bytes)
    tampered = T.SignedBeaconBlock.deserialize(tampered_bytes)
    root = bytes(signed.message.hash_tree_root())
    tampered_root = bytes(tampered.message.hash_tree_root())
    slot = int(signed.message.slot)
    epoch = slot // E.SLOTS_PER_EPOCH
    sidecars = build_blob_sidecars(signed, blobs, kzg, E)
    tampered_sidecars = build_blob_sidecars(tampered, blobs, kzg, E)
    anchor = pre.copy()
    spec = mainnet_spec()
    servers = []

    # the main path: counts at zero just before, read just after
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_chain_counts()
    try:
        # (a) node A and the writes
        clock = ManualSlotClock(genesis_time=int(anchor.genesis_time), seconds_per_slot=spec.seconds_per_slot)
        chain = step(
            "a_chain_init",
            lambda: BeaconChain(HotColdDB(MemoryStore()), genesis_state=anchor, spec=spec, E=E, slot_clock=clock, kzg=kzg),
        )
        anchor_root = bytes(chain.genesis_block_root)
        if anchor_root != bytes(signed.message.parent_root):
            raise AssertionError("(a) the block's parent is not the anchor's filled header")
        server = HttpApiServer(chain, port=0).start()
        servers.append(server)
        base = f"http://127.0.0.1:{server.port}"
        client = BeaconNodeHttpClient(base, timeout=900)
        clock.set_slot(slot)
        step("a_process_blob_sidecars", lambda: chain.process_blob_sidecars(root, sidecars))
        code = step("a_publish_block", lambda: client.publish_block_ssz(signed_bytes))
        if code != 200 or bytes(chain.head_root) != root:
            raise AssertionError(f"(a) the posted block answered {code}, head {bytes(chain.head_root).hex()}")
        if bytes(chain.head_state.hash_tree_root()) != post_root:
            raise AssertionError("(a) the head state's root is not phase 6's post-state root")
        step("a_process_tampered_sidecars", lambda: chain.process_blob_sidecars(tampered_root, tampered_sidecars))

        def refused_block():
            try:
                client.publish_block_ssz(tampered_bytes)
            except ApiClientError as e:
                return e.code, str(e)
            raise AssertionError("(a) the block with a wrong attestation signature was accepted")

        tampered_code, tampered_msg = step("a_publish_tampered_block", refused_block)
        if tampered_code != 400 or "signature" not in tampered_msg or bytes(chain.head_root) != root:
            raise AssertionError(f"(a) the tampered block: {tampered_code} {tampered_msg}, head {bytes(chain.head_root).hex()}")
        atts = _chain_attestations(
            chain.head_state, types, E, spec, sk_of, root, CHAIN_GOSSIP_ATTESTATIONS + CHAIN_GOSSIP_TAMPERED_BATCH
        )
        clean, rest = atts[:CHAIN_GOSSIP_ATTESTATIONS], atts[CHAIN_GOSSIP_ATTESTATIONS:]
        bad_at = 3
        other = _chain_attestations(chain.head_state, types, E, spec, sk_of, b"\x99" * 32, len(atts))[CHAIN_GOSSIP_ATTESTATIONS + bad_at]
        rest[bad_at] = types.Attestation(aggregation_bits=rest[bad_at].aggregation_bits, data=rest[bad_at].data, signature=other.signature)
        att_list = SszList[types.Attestation, 1024]
        posted = step(
            "a_publish_attestations",
            lambda: _http(base, "/eth/v1/beacon/pool/attestations", att_list.serialize_value(clean), SSZ_TYPE),
        )
        if posted[0] != 200:
            raise AssertionError(f"(a) the clean attestations answered {posted[0]} {posted[2][:200]!r}")
        posted_bad = step(
            "a_publish_tampered_attestations",
            lambda: _http(base, "/eth/v1/beacon/pool/attestations", att_list.serialize_value(rest), SSZ_TYPE),
        )
        if posted_bad[0] != 202 or f"1/{len(rest)} attestations rejected".encode() not in posted_bad[2]:
            raise AssertionError(f"(a) the batch with one bad signature answered {posted_bad[0]} {posted_bad[2][:200]!r}")

        # (b) reads on A
        bodies = {}

        def read(name, path, accept=None):
            status, headers, body = step(f"b_{name}", lambda: _http(base, path, accept=accept))
            if status != 200:
                raise AssertionError(f"(b) {path}: {status} {body[:200]!r}")
            bodies[path, accept] = (name, body)
            return body, headers

        head_state = chain.head_state
        n = len(head_state.validators)
        served_root = json.loads(read("state_root", "/eth/v1/beacon/states/head/root")[0])["data"]["root"]
        if served_root != "0x" + post_root.hex():
            raise AssertionError("(b) the served head state root is not phase 6's post-state root")
        cps = json.loads(read("finality_checkpoints", "/eth/v1/beacon/states/head/finality_checkpoints")[0])["data"]
        for key, cp in (
            ("previous_justified", head_state.previous_justified_checkpoint),
            ("current_justified", head_state.current_justified_checkpoint),
            ("finalized", head_state.finalized_checkpoint),
        ):
            if cps[key] != {"epoch": str(int(cp.epoch)), "root": "0x" + bytes(cp.root).hex()}:
                raise AssertionError(f"(b) finality checkpoint {key}: {cps[key]}")
        validators = read("validators", "/eth/v1/beacon/states/head/validators")[0]
        if validators.count(b'"validator":{') != n:
            raise AssertionError("(b) the validators route did not list every validator")
        pick = (0, n // 2, n - 1)
        by_id = json.loads(read("validators_by_id", f"/eth/v1/beacon/states/head/validators?id={pick[0]},{pick[1]},0x{bytes(head_state.validators[pick[2]].pubkey).hex()}")[0])["data"]
        if [int(v["index"]) for v in by_id] != list(pick) or any(
            v["validator"]["pubkey"] != "0x" + bytes(head_state.validators[int(v["index"])].pubkey).hex() for v in by_id
        ):
            raise AssertionError(f"(b) validators by id: {[v['index'] for v in by_id]}")
        balances = read("validator_balances", "/eth/v1/beacon/states/head/validator_balances")[0]
        if balances.count(b'"balance":') != n:
            raise AssertionError("(b) the balances route did not list every validator")
        committees = json.loads(read("committees", "/eth/v1/beacon/states/head/committees")[0])["data"]
        seated = sum(len(c["validators"]) for c in committees)
        duties = step("b_proposer_duties", lambda: client.get_proposer_duties(epoch))
        if len(duties) != E.SLOTS_PER_EPOCH or int(duties[0]["validator_index"]) != int(signed.message.proposer_index):
            raise AssertionError("(b) the proposer duties do not name the block's proposer")
        # rewards over HTTP, each against the function called directly
        parent_state = chain.state_for_block_root(anchor_root)
        served = json.loads(read("rewards_block", f"/eth/v1/beacon/rewards/blocks/0x{root.hex()}")[0])["data"]
        direct = step("b_rewards_block_direct", lambda: compute_block_rewards(signed, parent_state, spec, E, chain.types))
        if served != _json_roundtrip(direct):
            raise AssertionError("(b) block rewards over HTTP differ from the direct call")
        rewarded_epoch = epoch - 2
        status, _, body = step(
            "b_rewards_attestations",
            lambda: _http(base, f"/eth/v1/beacon/rewards/attestations/{rewarded_epoch}", b"", "application/json"),
        )
        if status != 200:
            raise AssertionError(f"(b) attestation rewards: {status} {body[:200]!r}")
        end_state = chain.state_for_block_root(anchor_root).copy()
        direct = step(
            "b_rewards_attestations_direct",
            lambda: compute_attestation_rewards(end_state, spec, E, chain.types.fork_of_state(end_state)),
        )
        if json.loads(body)["data"] != _json_roundtrip(direct):
            raise AssertionError("(b) attestation rewards over HTTP differ from the direct call")
        rewarded = len(direct["total_rewards"])
        status, _, body = step(
            "b_rewards_sync_committee",
            lambda: _http(base, f"/eth/v1/beacon/rewards/sync_committee/0x{root.hex()}", b"", "application/json"),
        )
        direct = compute_sync_committee_rewards(signed, parent_state, spec, E, chain.types)
        if status != 200 or json.loads(body)["data"] != _json_roundtrip(direct):
            raise AssertionError(f"(b) sync committee rewards over HTTP differ from the direct call ({status})")
        # the light client: bootstrap at the anchor; no update at 1M
        boot_body, boot_headers = read("light_client_bootstrap", f"/eth/v1/beacon/light_client/bootstrap/0x{anchor_root.hex()}")
        lt = build_light_client_types(E, electra=boot_headers.get("Eth-Consensus-Version") == "electra")
        lc_store = initialize_light_client_store(anchor_root, lt.LightClientBootstrap.deserialize(boot_body), E)
        if bytes(lc_store.finalized_header.beacon.hash_tree_root()) != anchor_root:
            raise AssertionError("(b) the light client's bootstrap header is not the anchor's")
        update_status, _, update_body = _http(base, "/eth/v1/beacon/light_client/update")
        if update_status != 404 or b"finalized state unavailable" not in update_body:
            raise AssertionError(f"(b) the update route answered {update_status} {update_body[:200]!r}")

        # (c) the serving workers, forked from this process
        tier = HttpApiServer(chain, workers=2).start()
        servers.append(tier)
        tier_base = f"http://127.0.0.1:{tier.port}"
        served_by = {}
        for (path, accept), (name, body) in bodies.items():
            if not path.split("?")[0].startswith(_LOCAL_GET_PREFIXES):
                continue
            status, headers, got = step(f"c_{name}", lambda: _http(tier_base, path, accept=accept))
            if status != 200 or got != body:
                raise AssertionError(f"(c) {path} through a worker: {status}, body equal {got == body}")
            served_by[name] = headers.get("X-Api-Served-By")
        time.sleep(1.0)  # the workers' metric snapshots
        metrics = _http(f"http://127.0.0.1:{tier.parent_port}", "/metrics")[2].decode()
        forwards = _metric_series(metrics, "api_worker_requests_forwarded_total")
        respawns = _metric_series(metrics, "api_worker_respawns_total")
        if respawns.get('reason="death"', 0) != 0 or len(tier._pool.worker_info()) != 2:
            raise AssertionError(f"(c) worker respawns {respawns}, workers {tier._pool.worker_info()}")
        tier.stop()
        servers.remove(tier)

        # (d) node B at 1M from A's head block and state
        trusted = bytes.fromhex(client._get("/eth/v1/beacon/blocks/head/root")["data"]["root"][2:])
        state_bytes = step("d_get_state_ssz", lambda: client.get_state_ssz("head"))
        block_bytes = step("d_get_block_ssz", lambda: client.get_block_ssz("0x" + trusted.hex()))
        state_b = step("d_decode_state", lambda: types.decode_by_fork("BeaconState", state_bytes))
        block_b = types.decode_by_fork("SignedBeaconBlock", block_bytes)
        if bytes(block_b.message.hash_tree_root()) != trusted or trusted != root:
            raise AssertionError("(d) the served block does not hash to the served head root")
        _make_persistent(state_b)
        cold = step("d_cold_root", lambda: state_b.hash_tree_root())
        if bytes(cold) != bytes(block_b.message.state_root):
            raise AssertionError("(d) the served state does not root to the block's state root")
        clock_b = ManualSlotClock(genesis_time=int(state_b.genesis_time), seconds_per_slot=spec.seconds_per_slot)
        clock_b.set_slot(slot)
        chain_b = step(
            "d_from_checkpoint",
            lambda: BeaconChain.from_checkpoint(HotColdDB(MemoryStore()), state_b, block_b, spec, E, clock_b, wss_checkpoint=trusted),
        )
        if bytes(chain_b.head_root) != root:
            raise AssertionError("(d) node B's head is not A's head block")
        d_out = {"state_bytes": len(state_bytes), "anchor_slot": int(chain_b.anchor_slot), "head_is_a_head": True}
        del chain_b, state_b, state_bytes
        server.stop()
        servers.remove(server)
        del chain, head_state, parent_state, end_state

        # (e) the minimal preset: checkpoint_boot from a harness that finalized
        spec_m = replace(minimal_spec(), altair_fork_epoch=0)
        h = step("e_harness_genesis", lambda: BeaconChainHarness(spec_m, MinimalEthSpec, validator_count=CHAIN_HARNESS_VALIDATORS))
        step("e_extend_chain", lambda: h.extend_chain(API_HARNESS_SLOTS))
        fin_a = h.chain.finalized_checkpoint
        if int(fin_a.epoch) < 1:
            raise AssertionError(f"(e) the harness did not finalize: {int(fin_a.epoch)}")
        source = HttpApiServer(h.chain).start()
        servers.append(source)
        source_base = f"http://127.0.0.1:{source.port}"
        clock_e = ManualSlotClock(genesis_time=int(h.chain.head_state.genesis_time), seconds_per_slot=spec_m.seconds_per_slot)
        chain_e = step(
            "e_checkpoint_boot", lambda: checkpoint_boot(source_base, HotColdDB(MemoryStore()), spec_m, MinimalEthSpec, slot_clock=clock_e)
        )
        anchor_e = (int(chain_e.anchor_slot), bytes(chain_e.head_root))
        if anchor_e[1] != bytes(fin_a.root):
            raise AssertionError("(e) node B's anchor is not the harness's finalized root")
        node_b = HttpApiServer(chain_e).start()
        servers.append(node_b)
        client_b = BeaconNodeHttpClient(f"http://127.0.0.1:{node_b.port}", timeout=300)
        behind, r = [], bytes(h.chain.head_root)
        while r != anchor_e[1]:
            behind.append(h.chain._blocks_by_root[r])
            r = bytes(behind[-1].message.parent_root)
        blocks_e = list(reversed(behind))
        # on until the harness finalizes past B's anchor, and one block more:
        # that block's parent state names the new checkpoint (the update's)
        fin_epoch = int(fin_a.epoch)

        def follow():
            while len(blocks_e) - len(behind) < API_HARNESS_FOLLOW or int(h.chain.finalized_checkpoint.epoch) == fin_epoch:
                blocks_e.append(h.chain._blocks_by_root[h.extend_chain(1)[0]])
                if len(blocks_e) - len(behind) > 2 * API_HARNESS_FOLLOW:
                    raise AssertionError("(e) the harness did not finalize past node B's anchor")
            blocks_e.append(h.chain._blocks_by_root[h.extend_chain(1)[0]])

        step("e_extend_follow", follow)
        pairings = []

        def post_all():
            for b in blocks_e:
                clock_e.set_slot(int(b.message.slot))
                k4 = k_pair.COUNTS["multi_pairing"]
                if client_b.publish_block_ssz(b.serialize()) != 200:
                    raise AssertionError(f"(e) node B refused the block at slot {int(b.message.slot)}")
                pairings.append(k_pair.COUNTS["multi_pairing"] - k4)

        step("e_post_blocks", post_all)
        if on_card and any(k < 1 for k in pairings):
            raise AssertionError(f"(e) a posted block was not verified on the card: {pairings}")
        if bytes(chain_e.head_root) != bytes(h.chain.head_root) or (
            int(chain_e.finalized_checkpoint.epoch), bytes(chain_e.finalized_checkpoint.root)
        ) != (int(h.chain.finalized_checkpoint.epoch), bytes(h.chain.finalized_checkpoint.root)):
            raise AssertionError("(e) node B's head or finalized checkpoint differs from the harness's")
        # a light client follows the harness: bootstrap at B's anchor, then the update route
        fin_root = anchor_e[1]
        status, headers, boot_raw = _http(source_base, f"/eth/v1/beacon/light_client/bootstrap/0x{fin_root.hex()}")
        lt_e = build_light_client_types(MinimalEthSpec, electra=headers.get("Eth-Consensus-Version") == "electra")
        store_e = initialize_light_client_store(fin_root, lt_e.LightClientBootstrap.deserialize(boot_raw), MinimalEthSpec)
        status, _, update_raw = _http(source_base, "/eth/v1/beacon/light_client/update")
        if status != 200:
            raise AssertionError(f"(e) the update route answered {status}")
        update = lt_e.LightClientUpdate.deserialize(update_raw)
        step(
            "e_light_client_update",
            lambda: process_light_client_update(
                store_e, update, current_slot=int(h.chain.head_state.slot) + 1, spec=spec_m, E=MinimalEthSpec,
                genesis_validators_root=bytes(h.chain.genesis_validators_root),
            ),
        )
        if int(store_e.finalized_header.beacon.slot) <= anchor_e[0]:
            raise AssertionError("(e) the light client's finalized header did not advance")
        e_out = {
            "validators": CHAIN_HARNESS_VALIDATORS,
            "anchor_slot": anchor_e[0],
            "blocks_posted": len(blocks_e),
            "multi_pairings_per_post": pairings,
            "head_slot": int(chain_e.head_state.slot),
            "finalized_epoch": int(chain_e.finalized_checkpoint.epoch),
            "light_client_finalized_slot": int(store_e.finalized_header.beacon.slot),
        }
    finally:
        for srv in servers:
            srv.stop()

    counts = chain_counts()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    required = ["sha256_rows", "epoch_sweep", *BLS_KERNELS, "barycentric_eval"]
    missing = [k for k in required if on_card and counts[k] <= 0]
    if missing:
        raise AssertionError(f"the API's calls launched no {missing}")
    out = {
        "phase": "api_main_path",
        "backend": bls.backend_name(),
        "a_node": {
            "validators": n,
            "block_slot": slot,
            "publish_block": code,
            "tampered_block": [tampered_code, tampered_msg],
            "attestations": [posted[0], posted_bad[0], posted_bad[2].decode(errors="replace")],
        },
        "b_reads": {
            "bytes": {name: len(body) for name, body in bodies.values()},
            "committee_seats": seated,
            "attestation_rewards_validators": rewarded,
            "light_client_update": [update_status, update_body.decode(errors="replace")],
        },
        "c_workers": {"served_by": served_by, "forwards": forwards, "respawns": respawns},
        "d_node_b": d_out,
        "e_minimal": e_out,
        "steps_s": steps,
        "launches_per_step": launches,
        "launches": counts,
        "max_memory_allocated_bytes": peak,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the validator client
# ---------------------------------------------------------------------------

# (a): the minimal harness's validators; the slot after which one key is
# deleted through the keymanager API (the end of epoch 2, so no duty of
# the epoch in progress is cached for it); the epoch the chain must
# finalize (two past genesis) and the slots it may take to get there
VC_HARNESS_VALIDATORS = 64
VC_DELETE_AFTER_SLOT = 3 * 8 - 1
VC_FINALIZED_EPOCH = 2
VC_MAX_SLOTS = 6 * 8
# seconds a request of the VC to the node, the engine or the keymanager
# may take
VC_REQUEST_TIMEOUT = 300


class _PublishLog:
    """A BeaconNodeInterface that hands every call on to `node` and keeps
    what each publish returned (the VC itself drops it)."""

    def __init__(self, node):
        self.node = node
        self.results = {"block": [], "attestations": [], "aggregates": [], "sync": []}
        # what the VC published, for phase 13 to gossip again
        self.sent = {"attestations": [], "aggregates": []}

    def __getattr__(self, name):
        return getattr(self.node, name)

    def publish_block(self, signed_block):
        res = self.node.publish_block(signed_block)
        self.results["block"].append(res)
        return res

    def publish_attestations(self, attestations):
        res = self.node.publish_attestations(attestations)
        self.results["attestations"].append((len(attestations), res))
        self.sent["attestations"].extend(attestations)
        return res

    def publish_aggregates(self, signed_aggregates):
        res = self.node.publish_aggregates(signed_aggregates)
        self.results["aggregates"].append((len(signed_aggregates), res))
        self.sent["aggregates"].extend(signed_aggregates)
        return res

    def publish_sync_committee_messages(self, messages):
        res = self.node.publish_sync_committee_messages(messages)
        self.results["sync"].append((len(messages), res))
        return res


def _count_engine_calls(server) -> dict:
    """Count the JSON-RPC methods a MockEngineServer answers, by name."""
    counts = {}
    dispatch = server._dispatch

    def counted(method, params):
        counts[method] = counts.get(method, 0) + 1
        return dispatch(method, params)

    server._dispatch = counted
    return counts


def _closed_port() -> int:
    """A local port nothing listens on."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _keymanager(base: str, method: str, path: str, body, token: str | None) -> tuple:
    """(status, JSON body) of one keymanager API request."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=VC_REQUEST_TIMEOUT) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _engine_stack(types, E, jwt: bytes, servers: list):
    """A MockEngineServer on 127.0.0.1 serving the port's mock engine, its
    method counts, and the chain's execution layer: an EngineWatchdog over
    an HttpEngineClient that signs every request with a JWT."""
    from lighthouse_tpu_torch.execution_layer import MockExecutionLayer
    from lighthouse_tpu_torch.execution_layer.http import HttpEngineClient, MockEngineServer
    from lighthouse_tpu_torch.execution_layer.watchdog import EngineWatchdog

    server = MockEngineServer(MockExecutionLayer(types, E), jwt, types, E).start()
    servers.append(server)
    calls = _count_engine_calls(server)
    client = HttpEngineClient(server.url, jwt, types, timeout=VC_REQUEST_TIMEOUT)
    return server, calls, EngineWatchdog(client, upcheck_interval=1.0)


def _vc_keypairs(state, sk_of: dict) -> list:
    """The keys of `sk_of` (validator index -> secret) as the VC takes
    them: the registry's pubkey (decompressed only if used) and the
    secret."""
    from types import SimpleNamespace

    from lighthouse_tpu_torch.crypto import bls

    return [
        SimpleNamespace(pk=bls.PublicKey(bytes(state.validators[i].pubkey)), sk=bls.SecretKey(sk))
        for i, sk in sorted(sk_of.items())
    ]


def vc_minimal_over_http(seed: int, smi: str) -> dict:
    """Phase 12 (a) (phase_vc_main_path's docstring), run in the spawned
    process of start_beside_10_11 with the BLS backend following the
    device: its record, its steps' seconds and launches, their lines for
    the parent to print, and its counts (set to 0 just before it)."""
    from dataclasses import replace

    from lighthouse_tpu_torch import default_device
    from lighthouse_tpu_torch.beacon_chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.key_derivation import validator_keypair_path
    from lighthouse_tpu_torch.crypto.keystore import Keystore
    from lighthouse_tpu_torch.eth2 import BeaconNodeHttpClient, HttpBeaconNode
    from lighthouse_tpu_torch.execution_layer import EngineState
    from lighthouse_tpu_torch.http_api import HttpApiServer
    from lighthouse_tpu_torch.metrics import REGISTRY
    from lighthouse_tpu_torch.state_processing import per_slot_processing
    from lighthouse_tpu_torch.state_processing.accessors import get_beacon_proposer_index
    from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec
    from lighthouse_tpu_torch.validator_client import ValidatorClient
    from lighthouse_tpu_torch.validator_client.beacon_node_fallback import BeaconNodeFallback, CandidateHealth
    from lighthouse_tpu_torch.validator_client.http_api import KeymanagerServer
    from lighthouse_tpu_torch.validator_client.slashing_protection import NotSafe

    on_card = default_device().type == "cuda"
    if bls.backend_setting() is not None or bls.backend_name() != ("cuda" if on_card else "host"):
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r})")
    lines = []
    steps, launches, _, step = _stepper("vc_step", smi, sink=lines.append)

    def counter(name: str) -> float:
        return REGISTRY.counter(name).value()

    jwt, token = _vc_secrets(seed)
    servers = []
    reset_chain_counts()
    try:
        # (a) the node, its engine over JWT, the VC over HTTP
        E_m = MinimalEthSpec
        T_m = build_types(E_m)
        spec_a = replace(minimal_spec(), altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0, deneb_fork_epoch=0)
        _, engine_calls, watchdog = _engine_stack(T_m, E_m, jwt, servers)
        offline0 = counter("execution_engine_offline_transitions_total")
        h = step(
            "a_harness_genesis",
            lambda: BeaconChainHarness(spec_a, E_m, validator_count=VC_HARNESS_VALIDATORS, execution_layer=watchdog),
        )
        node_srv = HttpApiServer(h.chain, port=0).start()
        servers.append(node_srv)
        password = "phase-12-keystores"
        # pbkdf2 at c = 2^10 (`_fast_kdf`): the EIP-2335 default (c or
        # scrypt's n at 2^18) costs ~0.5 s a key in hashlib, and the step
        # times the VC's import, not the KDF
        keystores = step(
            "a_write_keystores",
            lambda: [
                Keystore.encrypt(
                    kp.sk.scalar.to_bytes(32, "big"), password, path=validator_keypair_path(i), kdf="pbkdf2",
                    pubkey=kp.pk.to_bytes(), _fast_kdf=True,
                ).to_json()
                for i, kp in enumerate(h.keypairs)
            ],
        )
        dead = HttpBeaconNode(BeaconNodeHttpClient(f"http://127.0.0.1:{_closed_port()}", timeout=VC_REQUEST_TIMEOUT), T_m)
        live = HttpBeaconNode(BeaconNodeHttpClient(f"http://127.0.0.1:{node_srv.port}", timeout=VC_REQUEST_TIMEOUT), T_m)
        fallback = BeaconNodeFallback([dead, live], recheck_interval=3600.0)
        node_a = _PublishLog(fallback)
        vc = ValidatorClient(None, [], spec_a, E_m, node=node_a)
        km = KeymanagerServer(vc, token=token).start()
        servers.append(km)
        km_base = f"http://127.0.0.1:{km.port}"
        body = {"keystores": keystores, "passwords": [password] * len(keystores)}
        refused = _keymanager(km_base, "POST", "/eth/v1/keystores", body, None)[0]
        status, imported = step("a_import_keystores", lambda: _keymanager(km_base, "POST", "/eth/v1/keystores", body, token))
        if refused != 401 or status != 200 or [d["status"] for d in imported["data"]] != ["imported"] * len(keystores):
            raise AssertionError(f"(a) keystore import: {refused} without the token, {status} {str(imported)[:200]}")

        proposed = {}

        def run_slots(first: int, stop) -> int:
            slot = first
            while not stop(slot):
                slot += 1
                if slot > VC_MAX_SLOTS:
                    raise AssertionError(f"(a) no finality by slot {VC_MAX_SLOTS}")
                h.slot_clock.set_slot(slot)
                root = vc.on_slot(slot)
                if root is not None:
                    if bytes(h.chain.head_root) != bytes(root) or bytes(root) not in h.chain._blocks_by_root:
                        raise AssertionError(f"(a) the VC's block at slot {slot} is not the head")
                    proposed[slot] = bytes(root)
            return slot

        last = step("a_vc_epochs_0_to_2", lambda: run_slots(0, lambda s: s == VC_DELETE_AFTER_SLOT))
        if sorted(proposed) != list(range(1, last + 1)):
            raise AssertionError(f"(a) slots without the VC's block: {sorted(set(range(1, last + 1)) - set(proposed))}")
        victim_index = 0
        victim = h.keypairs[victim_index].pk.to_bytes()
        status, deleted = step(
            "a_delete_keystore", lambda: _keymanager(km_base, "DELETE", "/eth/v1/keystores", {"pubkeys": ["0x" + victim.hex()]}, token)
        )
        history = [e for e in json.loads(deleted["slashing_protection"])["data"] if e["pubkey"] == "0x" + victim.hex()]
        if status != 200 or deleted["data"] != [{"status": "deleted"}] or len(history) != 1 or not history[0]["signed_attestations"]:
            raise AssertionError(f"(a) the DELETE answered {status} {str(deleted)[:200]}")
        last = step("a_vc_to_finality", lambda: run_slots(last, lambda s: int(h.chain.finalized_checkpoint.epoch) >= VC_FINALIZED_EPOCH))
        chain_a = h.chain
        after = [
            e for e in vc.store.slashing_db.export_interchange(bytes(chain_a.genesis_validators_root))["data"]
            if e["pubkey"] == "0x" + victim.hex()
        ]
        victim_blocks = [s for s, r in proposed.items() if s > VC_DELETE_AFTER_SLOT and int(chain_a._blocks_by_root[r].message.proposer_index) == victim_index]
        if (
            vc.store.signer_for(victim) is not None
            or after[0]["signed_attestations"] != history[0]["signed_attestations"]
            or after[0]["signed_blocks"] != history[0]["signed_blocks"]
            or victim_blocks
        ):
            raise AssertionError("(a) the deleted key signed after its DELETE")
        # a slot after the DELETE may be empty only if the deleted key was
        # its proposer
        for s in sorted(set(range(VC_DELETE_AFTER_SLOT + 1, last + 1)) - set(proposed)):
            st = chain_a.state_for_block_root(proposed[max(p for p in proposed if p < s)]).copy()
            while int(st.slot) < s:
                per_slot_processing(st, spec_a, E_m)
            if get_beacon_proposer_index(st, E_m) != victim_index:
                raise AssertionError(f"(a) slot {s} has no block, and its proposer's key is held")
        # a second, conflicting attestation for the last slot signed
        head_state = chain_a.head_state
        duties = [d for d in vc.duties_service.attester_duties(last // E_m.SLOTS_PER_EPOCH) if d.slot == last]
        data = vc.attestation_service._attestation_data(head_state, last, b"\x99" * 32, duties[0].committee_index)
        pk = bytes(head_state.validators[duties[0].validator_index].pubkey)
        try:
            vc.store.sign_attestation(pk, data, head_state, spec_a, E_m)
            raise AssertionError("(a) a conflicting attestation was signed")
        except NotSafe as e:
            not_safe = str(e)
        published, refusals0 = len(node_a.results["attestations"]), counter("vc_slashing_protection_refusals_total")
        again = step("a_conflicting_attestations", lambda: vc.attestation_service.attest(last, b"\x99" * 32))
        refused_again = counter("vc_slashing_protection_refusals_total") - refusals0
        if again or len(node_a.results["attestations"]) != published or refused_again != len(duties):
            raise AssertionError(f"(a) conflicting attestations: {len(again)} signed, {refused_again} of {len(duties)} refused")
        # what the node took, the engine, the fallback
        statuses = sorted({r for _, r in node_a.results["attestations"]} | {r for _, r in node_a.results["sync"]})
        if statuses != [200]:
            raise AssertionError(f"(a) the node answered the VC's publishes with {statuses}")
        blocks = len(proposed)
        want_calls = {"engine_forkchoiceUpdatedV3": blocks, "engine_getPayloadV3": blocks, "engine_newPayloadV3": blocks}
        if any(engine_calls.get(k, 0) != v for k, v in want_calls.items()):
            raise AssertionError(f"(a) engine calls {engine_calls} for {blocks} blocks")
        if watchdog.state is not EngineState.ONLINE or counter("execution_engine_offline_transitions_total") != offline0:
            raise AssertionError("(a) the engine watchdog went offline")
        health = [c.health for c in fallback.candidates]
        if health != [CandidateHealth.OFFLINE, CandidateHealth.ONLINE]:
            raise AssertionError(f"(a) the fallback's candidates: {health}")
        head_a = chain_a.head_state
        a_out = {
            "validators": VC_HARNESS_VALIDATORS,
            "slots": last,
            "blocks_proposed_by_vc": blocks,
            "empty_slots": sorted(set(range(1, last + 1)) - set(proposed)),
            "justified_epoch": int(head_a.current_justified_checkpoint.epoch),
            "finalized_epoch": int(chain_a.finalized_checkpoint.epoch),
            "engine_calls": engine_calls,
            "watchdog": watchdog.state.value,
            "fallback": [c.value for c in health],
            "publishes": {k: len(v) for k, v in node_a.results.items()},
            "attestations_published": sum(n for n, _ in node_a.results["attestations"]),
            "aggregates_published": sum(n for n, _ in node_a.results["aggregates"]),
            "sync_messages_published": sum(n for n, _ in node_a.results["sync"]),
            "deleted_key_history": {k: len(v) for k, v in history[0].items() if k != "pubkey"},
            "conflicting": {"not_safe": not_safe, "refused": int(refused_again)},
        }
        if a_out["justified_epoch"] <= VC_FINALIZED_EPOCH or a_out["finalized_epoch"] < VC_FINALIZED_EPOCH:
            raise AssertionError(f"(a) justified {a_out['justified_epoch']}, finalized {a_out['finalized_epoch']}")
    finally:
        for srv in servers:
            srv.stop()
    if on_card:
        got = {k: sum(v.get(k, 0) for v in launches.values()) for k in ("epoch_sweep", *BLS_KERNELS)}
        missing = [k for k, v in got.items() if v <= 0]
        if missing:
            raise AssertionError(f"(a) launched no {missing}")
    return {"a_out": a_out, "steps_s": steps, "launches_per_step": launches, "launches": chain_counts(), "lines": lines}


def _vc_secrets(seed: int) -> tuple[bytes, str]:
    """Phase 12's engine-API JWT secret and keymanager token, from `seed`."""
    rng = np.random.default_rng(seed + 41)
    return rng.bytes(32), rng.bytes(32).hex()


def phase_vc_main_path(pre, signed_bytes: bytes, post_root: bytes, types, E, vc_keys: dict, seed: int, smi: str, vc_a: dict) -> tuple[dict, dict]:
    """The validator client on the card, with the BLS backend following
    the device (`cuda`):
    (a) a VC-driven chain to finality on the minimal preset, every hop over
        HTTP on 127.0.0.1: a BeaconChainHarness genesis (Altair to Deneb at
        epoch 0, 64 interop validators) whose execution layer is an
        EngineWatchdog over an HttpEngineClient, every newPayload,
        forkchoiceUpdated and getPayload a JSON-RPC request with a JWT to a
        MockEngineServer serving the port's mock engine; the chain behind
        HttpApiServer(port=0). The 64 keys written as EIP-2335 keystores
        and imported through the keymanager API (bearer token) into a
        ValidatorClient(None, node=BeaconNodeFallback([closed port, the
        node])), each candidate an HttpBeaconNode. The VC runs every slot:
        it proposes every block (produce_block, publish_block), attests,
        aggregates and sends sync-committee messages through the API. After
        epoch 2 one key is deleted through the keymanager API (its EIP-3076
        interchange returned); the VC runs on until the chain has finalized
        epoch 2. Checks: every block the VC's and imported, each payload
        over the engine API; justified and finalized advance; the watchdog
        stayed ONLINE; the closed port's candidate offline; the deleted
        key signed nothing after; a second, conflicting attestation for a
        slot already signed raises NotSafe and nothing reaches the node.
        (a) needs nothing of the phases before it: it runs in the spawned
        process beside phases 10-11 (vc_minimal_over_http), and `vc_a` is
        its result, read here;
    (b) a VC with every key phases 5-6 minted, attesting at 1M validators
        (mainnet preset) over the in-process LocalBeaconNode: a BeaconChain
        from phase 6's post-state and block (from_checkpoint over
        HotColdDB(MemoryStore())), with the engine API as in (a); on_slot of
        the block's slot + 1: bulk duties from the epoch duty table, every
        held key with a duty signs through sign_batch under one
        slashing-protection transaction and publishes, the selected
        aggregators aggregate, the sync-committee keys sign; the node
        accepts all of it; if the slot's proposer is held, it proposes
        through the engine API. (b) is in-process because HttpBeaconNode
        fetches the whole state as SSZ at every head_state, at least four
        times a slot (phase 11 (d): ~31 s a fetch at 1M).
    Each step's seconds on its own line with the card's name and power
    limit; the kernels each step launched. Returns the record and (b)'s
    node: its chain, and the attestations and aggregates the VC published
    (phase 13 gossips them)."""
    from lighthouse_tpu_torch import default_device
    from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.state_processing import per_slot_processing
    from lighthouse_tpu_torch.state_processing.accessors import get_beacon_proposer_index
    from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock
    from lighthouse_tpu_torch.validator_client import LocalBeaconNode, ValidatorClient

    on_card = default_device().type == "cuda"
    if bls.backend_setting() is not None or bls.backend_name() != ("cuda" if on_card else "host"):
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r})")
    for line in vc_a["lines"]:
        emit(line)
    steps, launches, _, step = _stepper("vc_step", smi)
    steps.update(vc_a["steps_s"])
    launches.update(vc_a["launches_per_step"])
    a_out = vc_a["a_out"]
    jwt, _ = _vc_secrets(seed)
    spec = mainnet_spec()
    # prepared outside the counted run: phase 6's post-state, its block
    T = types.types_for_fork("deneb")
    signed = T.SignedBeaconBlock.deserialize(signed_bytes)
    slot_b = int(signed.message.slot)
    _, post = _import_rep(pre, signed, spec, E)
    if bytes(post.hash_tree_root()) != post_root:
        raise AssertionError("(b) the post-state's root is not phase 6's post-state root")
    servers = []

    # the main path: counts at zero just before, read just after
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_chain_counts()
    try:
        # (b) at 1M: the node from phase 6's post-state, the VC in-process
        _, engine_calls_b, watchdog_b = _engine_stack(types, E, jwt, servers)
        clock = ManualSlotClock(genesis_time=int(post.genesis_time), seconds_per_slot=spec.seconds_per_slot)
        clock.set_slot(slot_b)
        chain = step(
            "b_from_checkpoint",
            lambda: BeaconChain.from_checkpoint(HotColdDB(MemoryStore()), post, signed, spec, E, clock, execution_layer=watchdog_b),
        )
        keypairs = step("b_keypairs", lambda: _vc_keypairs(chain.head_state, vc_keys))
        node_b = _PublishLog(LocalBeaconNode(chain))
        vc_b = step("b_vc_init", lambda: ValidatorClient(chain, keypairs, spec, E, node=node_b))
        probe = chain.head_state.copy()
        per_slot_processing(probe, spec, E)
        proposer = get_beacon_proposer_index(probe, E)
        del probe
        clock.set_slot(slot_b + 1)
        root_b = step("b_on_slot", lambda: vc_b.on_slot(slot_b + 1))
        if (root_b is not None) != (proposer in vc_keys):
            raise AssertionError(f"(b) proposer {proposer} held: {proposer in vc_keys}, proposed: {root_b is not None}")
        if root_b is not None and (
            bytes(chain.head_root) != bytes(root_b) or engine_calls_b.get("engine_newPayloadV3", 0) != 1 or engine_calls_b.get("engine_getPayloadV3", 0) != 1
        ):
            raise AssertionError(f"(b) the VC's block is not the head, or engine calls {engine_calls_b}")
        att_results = [r for _, rs in node_b.results["attestations"] for r in rs]
        agg_results = [r for _, rs in node_b.results["aggregates"] for r in rs]
        rejected = [type(r).__name__ for r in att_results + agg_results if isinstance(r, Exception)]
        n_sync = sum(n for n, _ in node_b.results["sync"])
        sync_members = len(vc_b.sync_committee_service._members)
        if rejected or not att_results or not agg_results or n_sync != sync_members or n_sync == 0:
            raise AssertionError(
                f"(b) attestations {len(att_results)}, aggregates {len(agg_results)}, sync {n_sync}: rejected {rejected[:5]}"
            )
        if on_card:
            missing = [k for k in BLS_KERNELS if launches["b_on_slot"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"(b) on_slot launched no {missing}")
        b_out = {
            "validators": len(chain.head_state.validators),
            "keys_held": len(keypairs),
            "slot": slot_b + 1,
            "proposer": proposer,
            "proposer_held": proposer in vc_keys,
            "proposed": root_b is not None,
            "engine_calls": engine_calls_b,
            "attestations_accepted": len(att_results),
            "aggregates_accepted": len(agg_results),
            "sync_messages_accepted": n_sync,
        }
    finally:
        for srv in servers:
            srv.stop()

    # (b)'s counts here, (a)'s from its process
    counts = {k: v + vc_a["launches"][k] for k, v in chain_counts().items()}
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    if on_card:
        names = [n for n in steps if n.startswith("b_")]
        got = {k: sum(launches[n].get(k, 0) for n in names) for k in BLS_KERNELS}
        missing = [k for k, v in got.items() if v <= 0]
        if missing:
            raise AssertionError(f"(b) launched no {missing}")
    out = {
        "phase": "vc_main_path",
        "backend": bls.backend_name(),
        "a_minimal_over_http": a_out,
        "b_mainnet_in_process": b_out,
        "steps_s": steps,
        "launches_per_step": launches,
        "launches": counts,
        "max_memory_allocated_bytes": peak,
    }
    emit(out)
    return out, {"chain": chain, "attestations": list(node_b.sent["attestations"]), "aggregates": list(node_b.sent["aggregates"])}


# ---------------------------------------------------------------------------
# Phase 13: the node
# ---------------------------------------------------------------------------

NODE_BN_SECONDS_PER_SLOT = 3
# long enough for the node's clock to cross the epoch edge at slot 8
NODE_BN_RUN_FOR = 30
NODE_BN_MIN_BLOCKS = 4
MINIMAL_SLOTS_PER_EPOCH = 8
NODE_HARNESS_VALIDATORS = 64
NODE_HARNESS_SLOTS = 32
NODE_LIVE_SLOTS = 4
# seconds a wait on another node may take before the phase fails
NODE_WAIT = 600


def _wait_for(cond, what: str, timeout: float = NODE_WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.02)


class _ChainLog:
    """Wraps a chain's gossip entry points on the instance and keeps each
    call's outcome in order: per attestation, aggregate, block and sidecar
    call, the exception it gave or None. Each attestation batch also keeps
    its length, its seconds in the chain, and the attestations still
    waiting in the node `processor`'s lane and the batches waiting for a
    worker when it was drained."""

    def __init__(self, chain, processor):
        from lighthouse_tpu_torch.beacon_processor import WorkType

        self.attestations, self.aggregates, self.blocks, self.sidecars = [], [], [], []
        self.batches = []  # (length, seconds, lane depth, hand-off depth)
        batch = chain.process_attestation_batch
        lane = processor._queues.by_type[WorkType.GOSSIP_ATTESTATION]

        def process_attestation_batch(atts, *args, **kwargs):
            depth = (len(lane), processor._work.qsize())
            t0 = time.perf_counter()
            try:
                res = batch(atts, *args, **kwargs)
            except Exception as e:
                self.attestations.extend([e] * len(atts))
                raise
            finally:
                self.batches.append((len(atts), time.perf_counter() - t0, *depth))
            self.attestations.extend(r if isinstance(r, Exception) else None for r in res)
            return res

        chain.process_attestation_batch = process_attestation_batch
        for name, out in (("process_aggregate", self.aggregates), ("process_block", self.blocks), ("process_blob_sidecars", self.sidecars)):
            setattr(chain, name, self._logged(getattr(chain, name), out))

    @staticmethod
    def _logged(fn, out: list):
        def call(*args, **kwargs):
            try:
                res = fn(*args, **kwargs)
            except Exception as e:
                out.append(e)
                raise
            out.append(None)
            return res

        return call

    def batch_summary(self) -> dict:
        """The attestation batches so far: how many, their lengths, their
        seconds in the chain, and the depths at each drain."""
        got = self.batches
        if not got:
            return {"batches": 0}
        sizes, lanes, handoffs = ([b[i] for b in got] for i in (0, 2, 3))
        return {
            "batches": len(got),
            "batch_len": {"min": min(sizes), "median": float(np.median(sizes)), "max": max(sizes), "mean": sum(sizes) / len(got)},
            "batch_len_counts": {str(k): sizes.count(k) for k in sorted(set(sizes))},
            "in_chain_s": sum(b[1] for b in got),
            "lane_depth_at_drain": {"median": float(np.median(lanes)), "max": max(lanes)},
            "handoff_depth_at_drain": {"median": float(np.median(handoffs)), "max": max(handoffs)},
        }


class _BnProcess:
    """(a): `python3 -m lighthouse_tpu_torch --spec minimal bn --validate
    --slasher` as a user starts it (no --bls-backend, no --device on the
    card), its Beacon API polled every slot from a thread while the phase
    goes on: the head, the slasher's cycles from /metrics, and a watch
    WatchUpdater indexing it into a WatchDB that a WatchServer serves here;
    `result()` waits for it and reads its log for the backend, the
    proposals and tracebacks."""

    def __init__(self, device: str):
        import threading

        from lighthouse_tpu_torch.eth2 import BeaconNodeHttpClient
        from lighthouse_tpu_torch.types import MinimalEthSpec
        from lighthouse_tpu_torch.watch import WatchDB, WatchServer, WatchUpdater

        self.device = device
        self.port = _closed_port()
        self.cmd = [
            sys.executable, "-m", "lighthouse_tpu_torch", "--spec", "minimal", "bn", "--validate", "--slasher",
            "--seconds-per-slot", str(NODE_BN_SECONDS_PER_SLOT), "--run-for", str(NODE_BN_RUN_FOR),
            "--http-port", str(self.port), "--network-port", "0",
        ]
        self.watch_db = WatchDB()
        self.watch = WatchUpdater(BeaconNodeHttpClient(f"http://127.0.0.1:{self.port}"), self.watch_db, build_types(MinimalEthSpec))
        self.watch_server = WatchServer(self.watch_db).start()
        self.watch_checks: dict = {}
        if device == "cpu":
            self.cmd += ["--device", "cpu"]  # a rehearsal without a card
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
        self.lines: list[str] = []
        self.polls: list[dict] = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.t_end = None  # when its output ended: the process's own seconds
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.poller = threading.Thread(target=self._poll, daemon=True)
        self.reader.start()
        self.poller.start()

    def _read(self):
        self.lines.extend(self.proc.stdout)
        self.t_end = time.perf_counter()

    def _get(self, path: str):
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}", timeout=2) as r:
            return json.loads(r.read())["data"]

    def _cycles(self) -> float:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/metrics", timeout=2) as r:
            return _metric_series(r.read().decode(), "slasher_process_cycles_total").get('engine="columnar"', 0.0)

    def _api_blocks(self) -> dict:
        """slot -> proposer of every block the node's API serves, from the
        head back to the first block (the genesis anchor has no header)."""
        import urllib.error

        out, block_id = {}, "head"
        while True:
            try:
                msg = self._get(f"/eth/v1/beacon/headers/{block_id}")["header"]["message"]
            except urllib.error.HTTPError as e:
                if e.code == 404 and out:
                    return out
                raise
            if int(msg["slot"]) == 0:
                return out
            out[int(msg["slot"])] = int(msg["proposer_index"])
            block_id = msg["parent_root"]

    def _check_watch(self):
        """Index the node with watch, then hold watch's rows to the blocks
        the node's API serves up to watch's highest slot."""
        from collections import Counter

        self.watch.update()
        db = self.watch_db
        top = db.highest_slot()
        blocks = {k: v for k, v in self._api_blocks().items() if k <= top}
        if blocks:
            self.watch_checks = {
                "highest_slot": top,
                "blocks": len(blocks),
                "first_block_slot": min(blocks),
                "proposers_equal": dict(Counter(blocks.values())) == db.proposer_counts(),
                "blockprints": sum(db.blockprint_for_slot(k) is not None for k in blocks),
                "missed": db.missed_slots(),
            }

    def _poll(self):
        while self.proc.poll() is None:
            try:
                syncing, head = self._get("/eth/v1/node/syncing"), self._get("/eth/v1/beacon/headers/head")
                self.polls.append(
                    {
                        "s": time.perf_counter() - self.t0,
                        "head_slot": int(head["header"]["message"]["slot"]),
                        "sync_distance": int(syncing["sync_distance"]),
                        "slasher_cycles": self._cycles(),
                    }
                )
                self._check_watch()
            except (OSError, ValueError, KeyError):
                pass  # not serving yet, or shutting down
            with contextlib.suppress(subprocess.TimeoutExpired):
                self.proc.wait(timeout=NODE_BN_SECONDS_PER_SLOT)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.watch_server is not None:
            self.watch_server.stop()
            self.watch_server = None

    def result(self) -> dict:
        try:
            rc = self.proc.wait(timeout=NODE_WAIT)
            self.poller.join(timeout=30)
            served = self._watch_routes()
        finally:
            self.stop()
        self.reader.join(timeout=30)
        seconds = (self.t_end or time.perf_counter()) - self.t0
        lines = self.lines
        up = [ln for ln in lines if "beacon node up" in ln]
        proposed = [ln for ln in lines if "slot processed" in ln and "proposed=True" in ln]
        want = "cuda" if self.device == "cuda" else "host"
        heads = [p["head_slot"] for p in self.polls]
        tail = "".join(lines[-40:])
        if rc != 0 or "Traceback" in "".join(lines):
            raise AssertionError(f"(a) bn exited {rc}:\n{tail}")
        if len(up) != 1 or f"bls_backend={want}" not in up[0]:
            raise AssertionError(f"(a) the node came up with {up}, not bls_backend={want}")
        if len(proposed) < NODE_BN_MIN_BLOCKS:
            raise AssertionError(f"(a) {len(proposed)} blocks proposed and imported, fewer than {NODE_BN_MIN_BLOCKS}:\n{tail}")
        if len(heads) < 2 or heads != sorted(heads) or heads[-1] <= heads[0] or heads[-1] < NODE_BN_MIN_BLOCKS - 1:
            raise AssertionError(f"(a) head slots over the polls {heads}")
        # one slasher cycle at each epoch edge the node's clock crossed (the
        # cycle rides a processor lane: a poll may fall between the edge and it)
        spe = MINIMAL_SLOTS_PER_EPOCH
        crossed = [(p["head_slot"] + p["sync_distance"]) // spe + 1 for p in self.polls]
        cycles = [p["slasher_cycles"] for p in self.polls]
        settled = [c == e for c, e in zip(cycles, crossed)]
        if any(not e - 1 <= c <= e for c, e in zip(cycles, crossed)) or cycles[-1] < 2 or not any(
            ok and e >= 2 for ok, e in zip(settled, crossed)
        ):
            raise AssertionError(f"(a) slasher cycles {cycles} over epochs crossed {crossed}")
        w = self.watch_checks
        if (
            not w
            or w["blocks"] < NODE_BN_MIN_BLOCKS
            or not w["proposers_equal"]
            or w["blockprints"] != w["blocks"]
            or any(m >= w["first_block_slot"] for m in w["missed"])
        ):
            raise AssertionError(f"(a) watch's rows against the node's blocks: {w}")
        return {
            "command": " ".join(self.cmd[1:]),
            "exit_code": rc,
            "s": seconds,
            "up_line": up[0].strip(),
            "blocks_proposed_and_imported": len(proposed),
            "polls": self.polls,
            "slasher_cycles": cycles[-1],
            "watch": w,
            "watch_server": served,
        }

    def _watch_routes(self) -> dict:
        """Every WatchServer route answers 200 with the DB's own answer."""
        import urllib.request

        db = self.watch_db
        want = {
            "/v1/slots/missed": db.missed_slots(),
            "/v1/proposers": {str(k): v for k, v in db.proposer_counts().items()},
            "/v1/finality": db.latest_finality(),
            "/v1/packing": db.packing_stats(),
            "/v1/gaps": db.gaps(),
            "/v1/blockprint": db.blockprint_shares(),
            "/v1/rewards": db.rewards_stats(),
        }
        out = {}
        for route, expected in want.items():
            with urllib.request.urlopen(f"http://127.0.0.1:{self.watch_server.port}{route}", timeout=5) as r:
                body = json.loads(r.read())
                if r.status != 200 or body != _json_roundtrip(expected):
                    raise AssertionError(f"(a) watch's {route}: {r.status} {body} (the DB: {expected})")
            out[route] = body
        return out


def phase_node_main_path(
    pre, signed_bytes: bytes, post_root: bytes, kzg, blobs: list[bytes], types, E, vc_node: dict, smi: str
) -> dict:
    """The beacon node, started as users start it, and nodes that sync and
    gossip with each other over TCP on 127.0.0.1, with the BLS backend
    following the device (`cuda` on the card):
    (a) `python3 -m lighthouse_tpu_torch --spec minimal bn --validate`, 16
        interop validators, 3-second slots for 18 s, a subprocess that runs
        while (c) does: it exits 0, logs bls_backend=cuda, imports at least
        4 blocks its VC proposed with the head slot rising over the API
        polls, and prints no traceback;
    (b) minimal preset with Altair from genesis (its epochs run the sweep),
        64 interop validators: node A a BeaconChainHarness
        chain (extend_chain(32): justified 3, finalized 2) behind
        NetworkService and HttpApiServer; node B a ClientBuilder node with
        the same keys whose SyncService range-syncs A's 32 slots; node D a
        ClientBuilder node booted from A's finalized checkpoint over A's
        API, range-synced to A's head and backfilled to genesis through
        blocks_by_range (its proposer signatures in one batch); then 4 live
        slots, each block and its attestations made by A's harness and
        published by A's network, imported by B and D from gossip; a block
        with one attestation signature swapped, published by A, refused by
        B and D with their heads unmoved and A's score with them lowered;
        A, B and D end on one head and one finalized checkpoint;
    (c) mainnet, 1M validators: node A phase 12 (b)'s chain (phase 6's
        block and post-state) behind a NetworkService; node B a BeaconChain
        on a copy of phase 6's pre-state (as phase 10 (b)) with its own
        NetworkService and no sync service. A publishes the six blob
        sidecars and phase 6's block: B's DA gate verifies the sidecars on
        the card and B imports the block from gossip (its head phase 6's
        block, its state root the post-state's); then A publishes every
        attestation but one and every aggregate phase 12 (b)'s VC made,
        each attestation on its subnet, all accepted by B, and last the
        one left out carrying another's signature, the only one refused,
        which lowers A's score with B.
    Each step's seconds and card launches on a line of its own with the
    card's name and power limit."""
    from dataclasses import replace

    from lighthouse_tpu_torch import default_device
    from lighthouse_tpu_torch.beacon_chain import BeaconChainHarness
    from lighthouse_tpu_torch.beacon_chain.attestation_verification import AttestationError
    from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain, BlockError
    from lighthouse_tpu_torch.client import ClientBuilder, ClientConfig
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.http_api import HttpApiServer
    from lighthouse_tpu_torch.network import NetworkService
    from lighthouse_tpu_torch.ssz.merkle_proof import build_blob_sidecars
    from lighthouse_tpu_torch.state_processing import per_slot_processing
    from lighthouse_tpu_torch.state_processing.accessors import get_beacon_proposer_index
    from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
    from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    device = default_device().type
    on_card = device == "cuda"
    if bls.backend_setting() is not None or bls.backend_name() != ("cuda" if on_card else "host"):
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r})")
    # Noise XX where its primitives are installed, plain TCP where not
    noise = importlib.util.find_spec("cryptography") is not None
    emit({"phase": "node_transport", "transport": "noise" if noise else "tcp"})

    def transport():
        from lighthouse_tpu_torch.network.noise import NoiseTransport

        return NoiseTransport() if noise else None

    steps, launches, details, step = _stepper("node_step", smi)

    # prepared outside the counted run: phase 7's sidecars, the anchor (a
    # copy of phase 6's pre-state), the tampered attestation
    T = types.types_for_fork("deneb")
    signed = T.SignedBeaconBlock.deserialize(signed_bytes)
    root_c = signed.message.hash_tree_root()
    slot_c = int(signed.message.slot)
    sidecars = build_blob_sidecars(signed, blobs, kzg, E)
    anchor = pre.copy()
    spec = mainnet_spec()
    chain_a_c = vc_node["chain"]
    # the VC's attestations but its last, which goes out last with the
    # first one's signature: a point on the curve, wrong for its signer
    # (a validator B has not seen attest)
    atts_c, aggs_c = vc_node["attestations"][:-1], vc_node["aggregates"]
    last_att = vc_node["attestations"][-1]
    tampered_att = types.Attestation(aggregation_bits=last_att.aggregation_bits, data=last_att.data, signature=atts_c[0].signature)
    if bytes(chain_a_c.head_root) != root_c:
        raise AssertionError("(c) node A's head is not phase 6's block")

    services = []
    # the main path: counts at zero just before, read just after
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_chain_counts()
    try:
        # (b) three nodes over TCP on the minimal preset, Altair from genesis
        E_m = MinimalEthSpec
        spec_m = replace(minimal_spec(), altair_fork_epoch=0)
        h = step("b_a_harness", lambda: BeaconChainHarness(spec_m, E_m, validator_count=NODE_HARNESS_VALIDATORS))
        step("b_a_extend_chain", lambda: h.extend_chain(NODE_HARNESS_SLOTS))
        if (h.justified_epoch, h.finalized_epoch) != (3, 2):
            raise AssertionError(f"(b) node A justified {h.justified_epoch}, finalized {h.finalized_epoch}")
        chain_a = h.chain
        na = NetworkService(chain_a, port=0, transport=transport()).start()
        services.append(na)
        api = HttpApiServer(chain_a, port=0).start()
        services.append(api)

        def client(**kw):
            cfg = ClientConfig(
                spec=h.spec, E=E_m, validator_count=NODE_HARNESS_VALIDATORS, keypairs=h.keypairs,
                manual_slot_clock=True, http_port=None, network_port=0, noise=noise, **kw,
            )
            c = ClientBuilder(cfg).build().start()
            services.append(c)
            c.slot_clock.set_slot(NODE_HARNESS_SLOTS)
            return c

        b = step("b_b_build", client)
        log_b = _ChainLog(b.chain, b.network.processor)

        def range_sync(c, who):
            c.network.connect("127.0.0.1", na.port)
            _wait_for(lambda: bytes(c.chain.head_root) == bytes(chain_a.head_root), f"{who}'s range sync")

        step("b_b_range_sync", lambda: range_sync(b, "B"))
        d = step("b_d_checkpoint_boot", lambda: client(checkpoint_sync_url=f"http://127.0.0.1:{api.port}"))
        log_d = _ChainLog(d.chain, d.network.processor)
        anchor_d = d.chain._blocks_by_root[d.chain.genesis_block_root]
        if bytes(d.chain.genesis_block_root) != bytes(chain_a.finalized_checkpoint.root):
            raise AssertionError("(b) node D is not anchored on A's finalized checkpoint")
        step("b_d_range_sync", lambda: range_sync(d, "D"))
        peer_d = d.network.peers.get(f"127.0.0.1:{na.port}")
        stored = step("b_d_backfill", lambda: d.network.sync.backfill(peer_d))
        r, oldest = bytes(anchor_d.message.parent_root), None
        while (blk := d.chain.store.get_block(r)) is not None:
            oldest, r = blk, bytes(blk.message.parent_root)
        walk = chain_a._blocks_by_root[bytes(chain_a.head_root)]
        while int(walk.message.slot) > 1:
            walk = chain_a._blocks_by_root[bytes(walk.message.parent_root)]
        genesis_root = bytes(walk.message.parent_root)
        if oldest is None or int(oldest.message.slot) != 1 or r != genesis_root or stored != int(anchor_d.message.slot) - 1:
            raise AssertionError(f"(b) D backfilled {stored} blocks, its oldest {None if oldest is None else int(oldest.message.slot)}")

        def live_slot(slot):
            for c in (b, d):
                c.slot_clock.set_slot(slot)
            root, blk = h.add_block_at_slot(slot)
            na.publish_block(blk)
            _wait_for(lambda: bytes(b.chain.head_root) == bytes(root) and bytes(d.chain.head_root) == bytes(root), f"slot {slot}'s block on B and D")
            atts = h.make_unaggregated_attestations(slot, root)
            n_b, n_d = len(log_b.attestations), len(log_d.attestations)
            if _verdicts(chain_a.process_attestation_batch(atts)) != [None] * len(atts):
                raise AssertionError(f"(b) A refused its own attestations at slot {slot}")
            for att in atts:
                na.publish_attestation(att)
            _wait_for(lambda: len(log_b.attestations) >= n_b + len(atts) and len(log_d.attestations) >= n_d + len(atts), f"slot {slot}'s attestations on B and D")
            got = log_b.attestations[n_b:] + log_d.attestations[n_d:]
            if any(v is not None for v in got):
                raise AssertionError(f"(b) slot {slot}'s attestations refused: {[repr(v) for v in got if v is not None][:3]}")
            return len(atts)

        live = step(
            "b_live_slots",
            lambda: [live_slot(s) for s in range(NODE_HARNESS_SLOTS + 1, NODE_HARNESS_SLOTS + 1 + NODE_LIVE_SLOTS)],
            detail=lambda: {"b": log_b.batch_summary(), "d": log_d.batch_summary()},
        )
        head = bytes(chain_a.head_root)
        # a block whose first attestation carries a valid signature over another message
        slot_bad = NODE_HARNESS_SLOTS + NODE_LIVE_SLOTS + 1
        for clock in (h.slot_clock, b.slot_clock, d.slot_clock):
            clock.set_slot(slot_bad)
        proposer_state = chain_a.head_state.copy()
        per_slot_processing(proposer_state, h.spec, E_m)
        proposer = get_beacon_proposer_index(proposer_state, E_m)
        block_bad, _ = chain_a.produce_block_on_state(
            slot_bad, h.randao_reveal(proposer, slot_bad, proposer_state),
            sync_aggregate_fn=lambda st: h.make_sync_aggregate(st, slot_bad, head),
        )
        att0 = block_bad.body.attestations[0]
        other = h.make_attestations(int(att0.data.slot), b"\x99" * 32)[int(att0.data.index)]
        block_bad.body.attestations[0] = chain_a.types.Attestation(aggregation_bits=att0.aggregation_bits, data=att0.data, signature=other.signature)
        bad = h.sign_block(block_bad, proposer_state)
        a_id = f"127.0.0.1:{na.port}"
        scores = [c.network.peers.get(a_id).score for c in (b, d)]
        n_blocks = (len(log_b.blocks), len(log_d.blocks))

        def publish_bad():
            na.publish_block(bad)
            _wait_for(lambda: len(log_b.blocks) > n_blocks[0] and len(log_d.blocks) > n_blocks[1], "B's and D's verdicts on the bad block")

        step("b_bad_block", publish_bad)
        refusals = [log_b.blocks[-1], log_d.blocks[-1]]
        scores_after = [c.network.peers.get(a_id).score for c in (b, d)]
        if not all(isinstance(e, BlockError) for e in refusals) or any(bytes(c.chain.head_root) != head for c in (b, d)):
            raise AssertionError(f"(b) the bad block: {refusals}")
        if not all(after < before for before, after in zip(scores, scores_after)):
            raise AssertionError(f"(b) A's score with B and D {scores} -> {scores_after}")
        finalized = {bytes(c.finalized_checkpoint.root) + int(c.finalized_checkpoint.epoch).to_bytes(8, "little") for c in (chain_a, b.chain, d.chain)}
        if {bytes(c.head_root) for c in (chain_a, b.chain, d.chain)} != {head} or len(finalized) != 1:
            raise AssertionError("(b) A, B and D do not share one head and one finalized checkpoint")
        b_out = {
            "validators": NODE_HARNESS_VALIDATORS,
            "head_slot": int(chain_a.head_state.slot),
            "justified_epoch": int(chain_a.justified_checkpoint.epoch),
            "finalized_epoch": int(chain_a.finalized_checkpoint.epoch),
            "d_anchor_slot": int(anchor_d.message.slot),
            "d_backfilled": stored,
            "d_oldest_slot": int(oldest.message.slot),
            "live_attestations": live,
            "bad_block": [str(e)[:120] for e in refusals],
            "a_score_with_b_and_d": [scores, scores_after],
            "transport": "noise" if noise else "tcp",
        }
        for svc in reversed(services):
            svc.stop()
        services.clear()
        del h, chain_a, b, d

        # (a) the node as users start it, in its own process while (c) runs:
        # its launches are that process's, not counted here
        bn = _BnProcess(device)
        services.append(bn)

        # (c) phase 6's block, its blobs and phase 12 (b)'s attestations over gossip at 1M
        na_c = NetworkService(chain_a_c, port=0, transport=transport()).start()
        services.append(na_c)
        clock = ManualSlotClock(genesis_time=int(anchor.genesis_time), seconds_per_slot=spec.seconds_per_slot)
        clock.set_slot(slot_c)
        chain_b = step(
            "c_b_chain_init",
            lambda: BeaconChain(HotColdDB(MemoryStore()), genesis_state=anchor, spec=spec, E=E, slot_clock=clock, kzg=kzg),
        )
        nb_c = NetworkService(chain_b, port=0, transport=transport(), sync_service_interval=None).start()
        services.append(nb_c)
        log_c = _ChainLog(chain_b, nb_c.processor)
        a_id = f"127.0.0.1:{na_c.port}"
        nb_c.connect("127.0.0.1", na_c.port)
        # A publishes to the peers it knows to subscribe to each topic
        topics = [na_c.topic_blob_sidecar, na_c.topic_block, na_c.topic_aggregate, *na_c.attestation_topics.values()]
        b_id = f"127.0.0.1:{nb_c.port}"
        _wait_for(lambda: all(b_id in na_c.gossip.behaviour._subscribed_peers(t) for t in topics), "B's subscriptions at A")

        def gossip_sidecars():
            for sc in sidecars:
                na_c.publish_blob_sidecar(sc)
            _wait_for(lambda: len(log_c.sidecars) >= len(sidecars), "B's sidecar verdicts")

        step("c_gossip_sidecars", gossip_sidecars)
        if log_c.sidecars != [None] * len(sidecars):
            raise AssertionError(f"(c) B refused sidecars: {log_c.sidecars}")

        def gossip_block():
            na_c.publish_block(signed)
            _wait_for(lambda: bytes(chain_b.head_root) == root_c or log_c.blocks, "B's import of phase 6's block")

        step("c_gossip_block", gossip_block)
        if bytes(chain_b.head_root) != root_c or log_c.blocks != [None]:
            raise AssertionError(f"(c) B's head is not phase 6's block: {log_c.blocks}")
        if bytes(step("c_b_head_state_root", lambda: chain_b.head_state.hash_tree_root())) != post_root:
            raise AssertionError("(c) B's head state root is not phase 6's post-state root")
        stored_blobs = chain_b.store.get_blob_sidecars(root_c)
        if stored_blobs is None or len(stored_blobs) != len(blobs):
            raise AssertionError("(c) the block's blob sidecars were not stored with it")
        clock.set_slot(slot_c + 1)

        def gossip_attestations():
            for att in atts_c:
                na_c.publish_attestation(att)
            _wait_for(lambda: len(log_c.attestations) >= len(atts_c), "B's attestation verdicts")

        step("c_gossip_attestations", gossip_attestations, detail=log_c.batch_summary)
        refused = [repr(v) for v in log_c.attestations if v is not None]
        if len(log_c.attestations) != len(atts_c) or refused:
            raise AssertionError(f"(c) {len(log_c.attestations)} attestation verdicts, refused {refused[:3]}")

        def gossip_aggregates():
            for agg in aggs_c:
                na_c.publish_aggregate(agg)
            _wait_for(lambda: len(log_c.aggregates) >= len(aggs_c), "B's aggregate verdicts")

        step("c_gossip_aggregates", gossip_aggregates)
        refused = [repr(v) for v in log_c.aggregates if v is not None]
        if len(log_c.aggregates) != len(aggs_c) or refused:
            raise AssertionError(f"(c) {len(log_c.aggregates)} aggregate verdicts, refused {refused[:3]}")
        score = nb_c.peers.get(a_id).score

        def gossip_tampered():
            na_c.publish_attestation(tampered_att)
            _wait_for(lambda: len(log_c.attestations) > len(atts_c), "B's verdict on the tampered attestation")

        step("c_gossip_tampered_attestation", gossip_tampered)
        last = log_c.attestations[-1]
        score_after = nb_c.peers.get(a_id).score
        if len(log_c.attestations) != len(atts_c) + 1 or not isinstance(last, AttestationError) or "signature" not in str(last):
            raise AssertionError(f"(c) the tampered attestation: {last!r}")
        if not score_after < score:
            raise AssertionError(f"(c) A's score with B {score} -> {score_after}")
        a_out = bn.result()
        steps["a_bn"], launches["a_bn"] = a_out["s"], {}
        emit({"phase": "node_step", "step": "a_bn", "s": a_out["s"], "launches": "in its own process", "card": smi})
        c_out = {
            "validators": len(anchor.validators),
            "block_slot": slot_c,
            "sidecars": len(sidecars),
            "post_state_root": post_root.hex(),
            "attestations_accepted": len(atts_c),
            "aggregates_accepted": len(aggs_c),
            "tampered_attestation": str(last),
            "a_score_with_b": [score, score_after],
            "attestations_per_s": len(atts_c) / steps["c_gossip_attestations"],
            "attestation_batches": details["c_gossip_attestations"],
        }
    finally:
        for svc in reversed(services):
            svc.stop()

    counts = chain_counts()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    if on_card:
        for part, names, required in (
            ("b", [n for n in steps if n.startswith("b_")], ["epoch_sweep", *BLS_KERNELS]),
            ("c", [n for n in steps if n.startswith("c_")], ["epoch_sweep", "sha256_rows", "barycentric_eval", *BLS_KERNELS]),
        ):
            got = {k: sum(launches[n].get(k, 0) for n in names) for k in required}
            missing = [k for k, v in got.items() if v <= 0]
            if missing:
                raise AssertionError(f"({part}) launched no {missing}")
    out = {
        "phase": "node_main_path",
        "backend": bls.backend_name(),
        "a_bn": a_out,
        "b_minimal_tcp": b_out,
        "c_mainnet_gossip": c_out,
        "steps_s": steps,
        "launches_per_step": launches,
        "launches": counts,
        "max_memory_allocated_bytes": peak,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the slasher, the simulator and eth1 genesis
# ---------------------------------------------------------------------------

SIM_VALIDATORS = 32
SIM_FINALIZED = 2
SIM_SLOTS = 32
SIM_MAX_SLOTS = 40
# the last three interop validators: held by no VC, they are the offenders
SIM_OFFENDERS = 3
SLASHER_HISTORY = 4096
SLASHER_COMMITTEES = 64 * 32
GENESIS_SAMPLE = 8
# the deposits of (c): None is the preset's MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
GENESIS_DEPOSITS = None


def _rss_kib() -> int:
    """This process's resident set, KiB (0 where /proc has no VmRSS)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def sign_on_card(sks: list[int], roots: list[bytes], device: str) -> list[bytes]:
    """BLS signatures [sk] H(root) of many keys at once on the card: K5's
    hash-to-G2, K2's 64-bit G2 ladder (the key in four 64-bit words,
    sum_i k_i [2^(64 i)] H, the shifts as two ladders by 2^32 each), K2's
    segment sum and conversion to affine; compressed on the host."""
    from lighthouse_tpu_torch.crypto.bls12_381 import g2_to_bytes

    n = len(sks)
    dev = torch.device(device)
    h = k_htc.hash_to_g2(torch.from_numpy(k_htc.messages_to_field(roots)).to(dev))
    shifted = [h]
    two32 = torch.full((n,), 1 << 32, dtype=torch.int64, device=dev)
    for _ in range(3):
        shifted.append(k_g.scalar_mul("g2", k_g.scalar_mul("g2", shifted[-1], two32), two32))
    words = [(sk >> (64 * i)) & ((1 << 64) - 1) for sk in sks for i in range(4)]
    pts = torch.stack(shifted, 1).reshape(n * 4, 3, 2, k_g.NLIMB)
    terms = k_g.scalar_mul("g2", pts, k_g.scalars_to_tensor(words).to(dev)).reshape(n, 4, 3, 2, k_g.NLIMB)
    aff = k_g.to_affine("g2", k_g.segment_sum("g2", terms)).cpu()
    v = k_g.fq_from_limbs(aff)
    return [g2_to_bytes(((v[4 * i], v[4 * i + 1]), (v[4 * i + 2], v[4 * i + 3]), (1, 0))) for i in range(n)]


def _slashing_offenders(slashing) -> set:
    return set(int(i) for i in slashing.attestation_1.attesting_indices) & set(
        int(i) for i in slashing.attestation_2.attesting_indices
    )


def _included_slashings(chain) -> set:
    """The serialized slashings in the bodies of a chain's canonical blocks."""
    out = set()
    root = bytes(chain.head_root)
    while True:
        blk = chain.store.get_block(root)
        if blk is None:
            return out
        body = blk.message.body
        out.update(x.serialize() for x in body.attester_slashings)
        out.update(x.serialize() for x in body.proposer_slashings)
        if int(blk.message.slot) == 0:
            return out
        root = bytes(blk.message.parent_root)


def _sim_offences(state, types, spec, E, keypairs: list, offenders: list, slot: int) -> tuple[list, list]:
    """Signed offences of three interop validators (a double vote, a
    surround vote, a double proposal), as indexed attestations and signed
    blocks over `state`'s domains."""
    from lighthouse_tpu_torch.state_processing.accessors import get_domain
    from lighthouse_tpu_torch.types.chain_spec import Domain, compute_signing_root

    T = types.types_for_fork("altair")
    v_double, v_surround, v_propose = offenders

    def indexed(v, source, target, head):
        data = types.AttestationData(
            slot=target * E.SLOTS_PER_EPOCH,
            index=0,
            beacon_block_root=head,
            source=types.Checkpoint(epoch=source, root=b"\x01" * 32),
            target=types.Checkpoint(epoch=target, root=b"\x02" * 32),
        )
        root = compute_signing_root(data.hash_tree_root(), get_domain(state, Domain.BEACON_ATTESTER, target, spec, E))
        return types.IndexedAttestation(attesting_indices=[v], data=data, signature=keypairs[v].sk.sign(root).to_bytes())

    def block(graffiti):
        m = T.BeaconBlock(
            slot=slot,
            proposer_index=v_propose,
            parent_root=b"\x11" * 32,
            state_root=b"\x22" * 32,
            body=T.BeaconBlockBody(graffiti=graffiti.ljust(32, b"\x00")),
        )
        domain = get_domain(state, Domain.BEACON_PROPOSER, slot // E.SLOTS_PER_EPOCH, spec, E)
        sig = keypairs[v_propose].sk.sign(compute_signing_root(m.hash_tree_root(), domain)).to_bytes()
        return T.SignedBeaconBlock(message=m, signature=sig)

    atts = [
        indexed(v_double, 0, 1, b"\x0a" * 32),
        indexed(v_double, 0, 1, b"\x0b" * 32),
        indexed(v_surround, 0, 3, b"\x0c" * 32),
        indexed(v_surround, 1, 2, b"\x0d" * 32),
    ]
    return atts, [block(b"first"), block(b"second")]


def _flood(types, E, n: int, committees: int, source: int, target: int, rng, skip: set) -> tuple[list, dict]:
    """One epoch's attestations of the whole registry: `committees`
    aggregates (unsigned: the slasher checks no signature) over a seeded
    permutation, the validators in `skip` left out of theirs; and each
    skipped validator's AttestationData."""
    cp = types.Checkpoint(epoch=source, root=b"\x01" * 32)
    ct = types.Checkpoint(epoch=target, root=b"\x02" * 32)
    out, data_of = [], {}
    for i, members in enumerate(np.array_split(rng.permutation(n), committees)):
        data = types.AttestationData(
            slot=target * E.SLOTS_PER_EPOCH + i % E.SLOTS_PER_EPOCH,
            index=i // E.SLOTS_PER_EPOCH,
            beacon_block_root=b"\x03" * 32,
            source=cp,
            target=ct,
        )
        members = np.sort(members)
        for v in skip.intersection(members.tolist()):
            data_of[v] = data
        members = members[~np.isin(members, list(skip))]
        out.append(types.IndexedAttestation(attesting_indices=members.tolist(), data=data, signature=b"\x00" * 96))
    return out, data_of


def planted_slasher_traffic(types, E, n: int, f_epoch: int, offenders: tuple, sks: tuple, domains: dict, rng) -> tuple[list, list]:
    """Two epochs of slasher traffic over `n` validators, the second
    `f_epoch`: 2,048 unsigned aggregates an epoch in which every validator
    attests once, but the three `offenders` (a double vote,
    old-surrounds-new, new-surrounds-old), whose every vote is a
    single-index attestation signed with its key in `sks` over
    `domains[target epoch]` (the attester domain). The warm epoch holds no
    slashable pair; the second holds exactly three."""
    from lighthouse_tpu_torch.types.chain_spec import compute_signing_root

    v_double, v_surrounded, v_surrounder = offenders
    sk_of = dict(zip(offenders, sks))
    planted = set(offenders)
    w_epoch = f_epoch - 1

    def signed(v, data):
        root = compute_signing_root(data.hash_tree_root(), domains[int(data.target.epoch)])
        return types.IndexedAttestation(attesting_indices=[v], data=data, signature=bls_sign(sk_of[v], root))

    def single(v, source, target, head):
        data = types.AttestationData(
            slot=target * E.SLOTS_PER_EPOCH,
            index=0,
            beacon_block_root=head,
            source=types.Checkpoint(epoch=source, root=b"\x01" * 32),
            target=types.Checkpoint(epoch=target, root=b"\x02" * 32),
        )
        return signed(v, data)

    warm, warm_data = _flood(types, E, n, SLASHER_COMMITTEES, w_epoch - 1, w_epoch, rng, planted)
    flood, flood_data = _flood(types, E, n, SLASHER_COMMITTEES, w_epoch, f_epoch, rng, planted)
    warm += [signed(v, warm_data[v]) for v in sorted(planted)]
    # a wide vote that surrounds its own validator's flood vote (not its warm one)
    warm.append(single(v_surrounded, w_epoch - 1, f_epoch + 1, b"\xaa" * 32))
    # a narrow vote that the attacker's flood vote surrounds
    warm.append(single(v_surrounder, f_epoch, f_epoch + 1, b"\xbb" * 32))
    flood += [signed(v, flood_data[v]) for v in sorted(planted)]
    flood.append(single(v_double, w_epoch, f_epoch, b"\xcc" * 32))
    flood.append(single(v_surrounder, w_epoch, f_epoch + 2, b"\xdd" * 32))
    return warm, flood


def attester_domains(state, E, spec, epochs) -> dict:
    """epoch -> the attester domain over `state`'s fork and genesis root."""
    from lighthouse_tpu_torch.state_processing.accessors import get_domain
    from lighthouse_tpu_torch.types.chain_spec import Domain

    return {e: get_domain(state, Domain.BEACON_ATTESTER, e, spec, E) for e in epochs}


def slasher_at_scale(n: int, f_epoch: int, offenders: tuple, sks: tuple, domains: dict, seed: int, store_dir: str) -> dict:
    """Phase 14 (b)'s slasher in a process of its own (spawned: it touches
    no card): the two epochs of planted_slasher_traffic through a columnar
    Slasher over the native store at `store_dir`, 4,096 epochs of history.
    Returns each cycle's stats, seconds and store writes, the counters, the
    RSS, and the emitted slashings as SSZ."""
    from lighthouse_tpu_torch.metrics import REGISTRY
    from lighthouse_tpu_torch.slasher import Slasher, SlasherConfig
    from lighthouse_tpu_torch.slasher.columnar import ColumnarSlasher
    from lighthouse_tpu_torch.store import open_item_store

    E = MainnetEthSpec
    types = build_types(E)
    t0 = time.perf_counter()
    warm, flood = planted_slasher_traffic(types, E, n, f_epoch, offenders, sks, domains, np.random.default_rng(seed))
    out = {"steps_s": {"b_build_floods": time.perf_counter() - t0}, "attestations": {"warm": len(warm), "flood": len(flood)}}
    store = open_item_store(store_dir)
    written = {"puts": 0, "bytes": 0}
    do_atomically = store.do_atomically

    def counted(ops):
        for op in ops:
            if op[0] == "put":
                written["puts"] += 1
                written["bytes"] += len(op[2]) + len(op[3])
        return do_atomically(ops)

    store.do_atomically = counted
    slasher = Slasher(E, SlasherConfig(history_length=SLASHER_HISTORY), store=store)
    out["engine"], out["store"] = type(slasher).__name__, type(store).__name__
    if not isinstance(slasher, ColumnarSlasher):
        return out
    rss0 = _rss_kib()

    def mark():
        return {
            "exact_scans": REGISTRY.counter("slasher_exact_scans_total").value(),
            "tiles": REGISTRY.counter("slasher_span_tiles_flushed_total").value(),
            **written,
        }

    for name, atts, epoch in (("warm", warm, f_epoch - 1), ("flood", flood, f_epoch)):
        before = mark()
        t0 = time.perf_counter()
        for a in atts:
            slasher.accept_attestation(a)
        stats = slasher.process_queued(epoch)
        found, props = slasher.drain_slashings()
        out["steps_s"][f"b_{name}_cycle"] = time.perf_counter() - t0
        out[name] = {"stats": stats, "proposer_slashings": len(props), "attester_slashings": [x.serialize() for x in found]}
        out[name] |= {k: v - before[k] for k, v in mark().items()}
    store.close()
    out["rss_kib"] = {"before": rss0, "after": _rss_kib(), "peak_of_the_process": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}
    return out


def start_slasher_at_scale(state, E, sk_of: dict, seed: int, store_dir: str):
    """Phase 14 (b)'s slasher started in a spawned process beside the
    phases that run until phase 14 reads it: (future, executor, offenders)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec

    rng = np.random.default_rng(seed + 41)
    offenders = tuple(int(v) for v in rng.choice(sorted(sk_of), 3, replace=False))
    f_epoch = int(state.slot) // E.SLOTS_PER_EPOCH
    domains = attester_domains(state, E, mainnet_spec(), range(f_epoch - 1, f_epoch + 3))
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    args = (len(state.validators), f_epoch, offenders, tuple(sk_of[v] for v in offenders), domains, seed + 43, store_dir)
    return pool.submit(slasher_at_scale, *args), pool, offenders


def stop_spawned(run) -> None:
    """End the process of start_slasher_at_scale or start_beside_10_11 (`run`:
    its future, its executor, ...), done or not."""
    pool = run[1]
    for proc in list(getattr(pool, "_processes", {}).values()):
        proc.kill()
    pool.shutdown(wait=True, cancel_futures=True)


def signed_deposits(types, E, spec, keys: list, device: str) -> tuple[list, list]:
    """DepositData of 32 ETH for each (secret key, pubkey) in `keys`, BLS
    withdrawal credentials, signed over the deposit domain on the card
    (sign_on_card); and the signing roots."""
    from lighthouse_tpu_torch.state_processing.genesis import bls_withdrawal_credentials
    from lighthouse_tpu_torch.types.chain_spec import compute_signing_root

    domain = spec.get_deposit_domain()
    msgs = [types.DepositMessage(pubkey=pk, withdrawal_credentials=bls_withdrawal_credentials(pk), amount=E.MAX_EFFECTIVE_BALANCE) for _, pk in keys]
    roots = [compute_signing_root(m.hash_tree_root(), domain) for m in msgs]
    sigs = sign_on_card([sk for sk, _ in keys], roots, device)
    datas = [
        types.DepositData(pubkey=m.pubkey, withdrawal_credentials=m.withdrawal_credentials, amount=m.amount, signature=sig)
        for m, sig in zip(msgs, sigs)
    ]
    return datas, roots


def eth1_genesis(datas: list, spec, E, step=None):
    """Eth1GenesisService over a MockEth1Provider that takes `datas` (the
    spec's MIN_GENESIS_ACTIVE_VALIDATOR_COUNT of them): try_genesis with
    one deposit short (must give None), then with all. The deposits'
    signatures must pass as one verify_signature_sets call: a refusal
    raises at once instead of the per-deposit verifies that would follow.
    Returns (the genesis state, the Eth1Service, [(sets, verdict,
    seconds)] of the verify calls, the card's BLS chunks)."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.eth1 import Eth1GenesisService, Eth1Service, MockEth1Provider
    from lighthouse_tpu_torch.metrics import REGISTRY

    step = step or (lambda name, fn: fn())
    provider = MockEth1Provider(spec, start_time=spec.min_genesis_time - spec.genesis_delay)
    provider.mine_block()
    for d in datas[:-1]:
        provider.submit_deposit(d)
    provider.mine_block()
    service = Eth1Service(provider, spec, E)
    genesis = Eth1GenesisService(service, spec, E)
    if step("c_try_genesis_short", genesis.try_genesis) is not None:
        raise AssertionError("(c) a genesis before the deposit count holds")
    provider.submit_deposit(datas[-1])
    provider.mine_block()
    batches = []
    verify = bls.verify_signature_sets

    def verify_logged(sets, *args, **kwargs):
        t0 = time.perf_counter()
        res = verify(sets, *args, **kwargs)
        batches.append((len(sets), res, time.perf_counter() - t0))
        if not res:
            raise AssertionError("(c) the deposit batch was refused: the per-deposit verifies would follow")
        return res

    chunks = REGISTRY.counter("bls_device_batches_total")
    before = chunks.value()
    bls.verify_signature_sets = verify_logged
    try:
        state = step("c_try_genesis", genesis.try_genesis)
    finally:
        bls.verify_signature_sets = verify
    return state, service, batches, chunks.value() - before


def phase_slasher_main_path(state, types, E, sk_of: dict, slasher_run, smi: str) -> dict:
    """The slasher, the simulator and eth1 genesis, with the BLS backend
    following the device (`cuda` on the card); `sk_of` holds the secret
    keys of `state`'s validators by index (phases 5-6 minted them):
    (a) minimal preset with Altair from genesis: the simulator's
        LocalNetwork of 2 nodes (threads of this process, over TCP on
        127.0.0.1) with VCs on disjoint interop key shares, the last 3
        keys held by none; node 0 carries a SlasherService fed, through
        observe_indexed_attestation and observe_block, a double vote, a
        surround vote and a double proposal signed with those keys. Each
        slashing is emitted once, included in a block both nodes import,
        its offender slashed in both heads; the heads equal, finalized
        epoch >= 2;
    (b) mainnet, the columnar slasher at the registry's 1M validators with
        4,096 epochs of history, through a store of `bn --db-path`'s kind:
        a warm epoch, then one epoch of 2,048 aggregates in which every
        validator attests once, with three planted offenders (a double
        vote, old-surrounds-new, new-surrounds-old), their votes signed
        single-index attestations. It runs in a spawned process
        (`slasher_run`, from start_slasher_at_scale) beside phase 13; here
        its result is read: exactly the three slashings come out, their
        signature sets, built on phase 6's pre-state, pass one
        verify_signature_sets on the card, a copy with a signature swapped
        fails;
    (c) mainnet: Eth1GenesisService over a MockEth1Provider that takes
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT (16,384) deposits of phase 5's
        keys, signed on the card (a sample held against the host signer):
        None before the count holds, then a valid genesis whose deposits
        were verified in one verify_signature_sets of 16,384 sets on the
        card, its deposit root the DepositCache's and its state root the
        host-lane fold's.
    Each step's seconds and card launches on a line of its own with the
    card's name and power limit."""
    from dataclasses import replace

    from lighthouse_tpu_torch import default_device
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.metrics import REGISTRY
    from lighthouse_tpu_torch.slasher.service import SlasherService
    from lighthouse_tpu_torch.state_processing import signature_sets as ss
    from lighthouse_tpu_torch.state_processing.genesis import is_valid_genesis_state
    from lighthouse_tpu_torch.testing.simulator import LocalNetwork
    from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.validator_client import ValidatorClient

    device = default_device().type
    on_card = device == "cuda"
    if bls.backend_setting() is not None or bls.backend_name() != ("cuda" if on_card else "host"):
        raise AssertionError(f"the BLS backend is {bls.backend_name()!r} (set: {bls.backend_setting()!r})")
    counter = REGISTRY.counter
    reset_chain_counts()
    steps, launches, details, step = _stepper("slasher_step", smi)

    # (a) the simulator with a slasher on node 0
    spec_m = replace(minimal_spec(), altair_fork_epoch=0)
    Em = MinimalEthSpec
    types_m = build_types(Em)
    net = step("a_network", lambda: LocalNetwork.create(spec_m, Em, 2, SIM_VALIDATORS))
    try:
        offenders = list(range(SIM_VALIDATORS - SIM_OFFENDERS, SIM_VALIDATORS))
        node0, node1 = net.nodes
        share = SIM_VALIDATORS // 2
        node1.vc = ValidatorClient(
            chain=node1.chain, keypairs=net.keypairs[share : SIM_VALIDATORS - SIM_OFFENDERS], spec=spec_m, E=Em, node=node1.interface
        )
        svc = SlasherService(node0.chain)
        emitted = []
        drain = svc.slasher.drain_slashings

        def drain_logged():
            atts, props = drain()
            emitted.extend(list(atts) + list(props))
            return atts, props

        svc.slasher.drain_slashings = drain_logged
        planted_at = Em.SLOTS_PER_EPOCH + 1

        def run_slots(first, last):
            for slot in range(first, last + 1):
                net.run_slot(slot)
                # the node's slot timer; the network's slot tick competes for the epoch
                svc.on_slot(slot, processor=node0.network.processor)
                if not node0.network.processor.drain(timeout=NODE_WAIT):
                    raise AssertionError(f"(a) node 0's processor did not drain at slot {slot}")
                if slot == planted_at:
                    atts, blocks = _sim_offences(node0.chain.head_state, types_m, spec_m, Em, net.keypairs, offenders, slot)
                    for a in atts:
                        svc.observe_indexed_attestation(a)
                    for b in blocks:
                        svc.observe_block(b)

        cycles0 = counter("slasher_process_cycles_total").value(engine="columnar")
        step("a_slots", lambda: run_slots(1, SIM_SLOTS))
        last = SIM_SLOTS
        while node0.chain.finalized_checkpoint.epoch < SIM_FINALIZED and last < SIM_MAX_SLOTS:
            last += 1
            step(f"a_slot_{last}", lambda: run_slots(last, last))
        net.check_all_heads_equal()
        net.check_finalized_epoch(SIM_FINALIZED)
        att_sl = [x for x in emitted if hasattr(x, "attestation_1")]
        prop_sl = [x for x in emitted if hasattr(x, "signed_header_1")]
        if len(att_sl) != 2 or len(prop_sl) != 1 or len({x.serialize() for x in emitted}) != 3:
            raise AssertionError(f"(a) emitted {len(att_sl)} attester and {len(prop_sl)} proposer slashings")
        found = sorted(_slashing_offenders(x).pop() for x in att_sl) + [int(prop_sl[0].signed_header_1.message.proposer_index)]
        if sorted(found) != offenders:
            raise AssertionError(f"(a) slashings of {found}, planted {offenders}")
        for node in net.nodes:
            included = _included_slashings(node.chain)
            missing = [x for x in emitted if x.serialize() not in included]
            head = node.chain.head_state
            unslashed = [v for v in offenders if not head.validators[v].slashed]
            if missing or unslashed:
                raise AssertionError(f"(a) {node.name}: {len(missing)} slashings not in its chain, {unslashed} not slashed")
        epochs_run = last // Em.SLOTS_PER_EPOCH + 1
        a_cycles = counter("slasher_process_cycles_total").value(engine="columnar") - cycles0
        if a_cycles != epochs_run:
            raise AssertionError(f"(a) {a_cycles} slasher cycles over {epochs_run} epochs")
        a_out = {
            "validators": SIM_VALIDATORS,
            "offenders": offenders,
            "slots": last,
            "head_slot": int(node0.chain.head_state.slot),
            "finalized_epoch": int(node0.chain.finalized_checkpoint.epoch),
            "justified_epoch": int(node0.chain.head_state.current_justified_checkpoint.epoch),
            "slashings_emitted": {"attester": len(att_sl), "proposer": len(prop_sl)},
            "slasher_cycles": a_cycles,
        }
    finally:
        net.shutdown()
    del net, svc

    # (b) the columnar slasher at the registry's size, in its own process
    spec = mainnet_spec()
    future, _, planted = slasher_run
    t0 = time.perf_counter()
    run = future.result(timeout=NODE_WAIT)
    waited = time.perf_counter() - t0
    for name, sec in run["steps_s"].items():
        steps[name], launches[name] = sec, {}
        emit({"phase": "slasher_step", "step": name, "s": sec, "launches": "in its own process", "card": smi})
    if run["engine"] != "ColumnarSlasher":
        raise AssertionError(f"(b) the factory gave {run['engine']}")
    warm, flood = run["warm"], run["flood"]
    if warm["attester_slashings"] or warm["proposer_slashings"] or flood["proposer_slashings"] or warm["stats"]["attester_slashings"]:
        raise AssertionError(f"(b) unplanted slashings: warm {warm['stats']}, flood {flood['proposer_slashings']} proposer")
    flood_att = [types.AttesterSlashing.deserialize(x) for x in flood["attester_slashings"]]
    offenders_b = sorted(sorted(_slashing_offenders(x)) for x in flood_att)
    if flood["stats"]["attester_slashings"] != 3 or offenders_b != sorted([v] for v in planted):
        raise AssertionError(f"(b) the flood cycle found {flood['stats']} of {offenders_b}, planted {sorted(planted)}")
    sets = [ss.indexed_attestation_signature_set(state, ia, spec, E) for x in flood_att for ia in (x.attestation_1, x.attestation_2)]
    ok = step("b_verify_slashings", lambda: bls.verify_signature_sets(sets))
    bad = flood_att[0].attestation_1
    swapped = types.IndexedAttestation(attesting_indices=bad.attesting_indices, data=bad.data, signature=flood_att[1].attestation_2.signature)
    tampered = sets[:1] + [ss.indexed_attestation_signature_set(state, swapped, spec, E)] + sets[2:]
    refused = not step("b_verify_tampered", lambda: bls.verify_signature_sets(tampered))
    if not ok or not refused:
        raise AssertionError(f"(b) the slashings' sets verified {ok}, the tampered copy refused {refused}")
    b_out = {
        "validators": len(state.validators),
        "aggregates": SLASHER_COMMITTEES,
        "attestations": run["attestations"],
        "history_length": SLASHER_HISTORY,
        "planted": dict(zip(("double_vote", "old_surrounds_new", "new_surrounds_old"), planted)),
        "flood_cycle_s": run["steps_s"]["b_flood_cycle"],
        "warm_cycle_s": run["steps_s"]["b_warm_cycle"],
        "aggregates_per_s": run["attestations"]["flood"] / run["steps_s"]["b_flood_cycle"],
        "warm": {k: v for k, v in warm.items() if k not in ("attester_slashings",)},
        "flood": {k: v for k, v in flood.items() if k not in ("attester_slashings",)},
        "rss_kib": run["rss_kib"],
        "store": run["store"],
        "waited_here_s": waited,
    }

    # (c) eth1 genesis at mainnet's MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
    count = GENESIS_DEPOSITS or spec.min_genesis_active_validator_count
    spec_g = replace(spec, min_genesis_active_validator_count=count)
    keyed = sorted(sk_of)[:count]
    if len(keyed) != count:
        raise AssertionError(f"(c) {len(keyed)} keys for {count} deposits")
    datas, roots = step("c_sign_on_card", lambda: signed_deposits(types, E, spec_g, [(sk_of[v], bytes(state.validators[v].pubkey)) for v in keyed], device))
    sample = range(0, count, count // GENESIS_SAMPLE)
    if any(bytes(datas[i].signature) != bls_sign(sk_of[keyed[i]], roots[i]) for i in sample):
        raise AssertionError("(c) a signature made on the card differs from the host signer's")
    pks = [_g1_affine_bytes(x, y) for x, y in _g1_gen_affine([sk_of[keyed[i]] for i in sample])]
    if pks != [bytes(datas[i].pubkey) for i in sample]:
        raise AssertionError("(c) a deposit's pubkey is not its key's: the keys are not the registry's")
    gstate, service, batches, chunks = eth1_genesis(datas, spec_g, E, step)
    if gstate is None or [b[:2] for b in batches] != [(count, True)] or (on_card and chunks != -(-count // bls.DEFAULT_DEVICE_CHUNK)):
        raise AssertionError(f"(c) genesis {gstate is not None}, verify calls {[b[:2] for b in batches]}, card chunks {chunks}")
    if not is_valid_genesis_state(gstate, spec_g, E) or len(gstate.validators) != count:
        raise AssertionError("(c) the genesis state is not valid")
    if bytes(gstate.eth1_data.deposit_root) != service.deposit_cache.deposit_root():
        raise AssertionError("(c) the state's deposit root is not the DepositCache's")
    root = step("c_state_root", lambda: bytes(gstate.hash_tree_root()))
    want = step("c_host_state_root", lambda: host_state_root(gstate))
    if root != want:
        raise AssertionError("(c) the genesis state root differs from the host-lane fold")
    c_out = {
        "deposits": count,
        "signing": "card (K5, K2 G2 ladder, segment sum, to_affine)",
        "sign_s": steps["c_sign_on_card"],  # the deposit messages' roots included
        "sample_held_against_host": len(sample),
        "verify_sets": batches[0][0],
        "verify_s": batches[0][2],
        "verify_chunks": chunks,
        "genesis_build_s": steps["c_try_genesis"] - batches[0][2],
        "genesis_time": int(gstate.genesis_time),
        "state_root": root.hex(),
        "deposit_root": bytes(gstate.eth1_data.deposit_root).hex(),
    }

    counts = chain_counts()
    if on_card:
        for part, required in (("a", ["epoch_sweep", *BLS_KERNELS]), ("b", list(BLS_KERNELS)), ("c", list(BLS_KERNELS))):
            got = {k: sum(launches[s].get(k, 0) for s in steps if s.startswith(part + "_")) for k in required}
            missing = [k for k, v in got.items() if v <= 0]
            if missing:
                raise AssertionError(f"({part}) launched no {missing}")
    out = {
        "phase": "slasher_main_path",
        "backend": bls.backend_name(),
        "a_simulator": a_out,
        "b_slasher_1m": b_out,
        "c_eth1_genesis": c_out,
        "steps_s": steps,
        "launches_per_step": launches,
        "launches": counts,
        # this phase's own seconds; (b)'s slasher ran beside phase 13
        "s": sum(v for k, v in steps.items() if k not in run["steps_s"]) + waited,
        "b_beside_phase_13_s": sum(run["steps_s"].values()),
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 15: the adversarial fleet (testing/testnet.py) on the card
# ---------------------------------------------------------------------------

# (name, runner, its keyword arguments beside bls_backend): the scenarios
# of tests/test_testnet_scenarios.py outside `slow` whose runners take the
# nodes' backend, at their own seeds and sizes (3 nodes, 24 interop
# validators, minimal preset)
FLEET_SCENARIOS = (
    ("a_smoke", "run_smoke_scenario", {}),
    ("b_column_withholding", "run_column_withholding_scenario", {"kzg": "dev"}),
    ("c_equivocation", "run_equivocation_scenario", {}),
)
# seconds the parent waits for the spawned process once phase 11 is done
FLEET_WAIT = 900


def _fleet_check(name: str, report: dict, S: int, faults: dict) -> None:
    """The JAX package's own checks of each scenario
    (tests/test_testnet_scenarios.py): recovery within six epochs, finality
    moving, exactly one slashing, the column regimes' refusal and
    reconstruction."""
    if name == "a_smoke":
        ok = report["recovery_slots"] <= 6 * S and report["recovery_to_finality_s"] > 0
    elif name == "b_column_withholding":
        ok = (
            report["sampling_failures"] >= 1
            and report["reconstructions"] >= 1
            and len(report["withheld_refusal"]) == 12
            and report["recovery_slots"] <= 6 * S
            and faults["withhold"] >= 2
        )
    else:
        ok = report["slashings_emitted"] == 1 and report["slasher_cycles"] >= 1
    if not ok:
        raise AssertionError(f"({name[0]}) the scenario's checks failed: {report}")


def fleet_scenarios(smi: str) -> dict:
    """Phase 15's fleets, in a spawned process (its own BLS backend, which
    ClientBuilder sets process-wide, and its own interpreter beside the
    parent's phases): the kernels that phase_build built are loaded from
    the build cache, never built; one valid batch verify warms the `cuda`
    backend; then each of FLEET_SCENARIOS runs with bls_backend="cuda",
    every kernel counter set to 0 just before it and read just after.
    Returns each scenario's report, seconds, slots, oracle passes, fault
    injections by kind and launches."""
    from dataclasses import replace

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.metrics import REGISTRY
    from lighthouse_tpu_torch.testing import testnet as tn
    from lighthouse_tpu_torch.types import MinimalEthSpec, minimal_spec

    libs = [k_sha256.LIB, k_g.LIB, k_pair.LIB, k_htc.LIB, k7.LIB, k_fr.LIB, k_msm.LIB, k_ms.LIB]
    for lib in libs:
        lib.load()
    built = [lib.info["so"] for lib in libs if lib.info["built"]]
    if built:
        raise AssertionError(f"the fleet's process built {built}: phase_build's cache was not found")
    t0 = time.perf_counter()
    bls.set_backend("cuda")
    kp = bls.interop_keypairs(1)[0]
    msg = b"\x15" * 32
    if not bls.verify_signature_sets([bls.SignatureSet.single(kp.sk.sign(msg), kp.pk, msg)]):
        raise AssertionError("the warm-up batch verify failed on the card")
    out = {"warm_s": time.perf_counter() - t0, "scenarios": {}}
    counter = REGISTRY.counter
    altair = replace(minimal_spec(), altair_fork_epoch=0)
    deneb = replace(altair, bellatrix_fork_epoch=0, capella_fork_epoch=0, deneb_fork_epoch=0)
    create = vars(tn.Testnet)["create"]
    for name, runner, kwargs in FLEET_SCENARIOS:
        das = name == "b_column_withholding"
        spec, E = (deneb, tn.DasTestnetEthSpec) if das else (altair, MinimalEthSpec)
        nets, backends = [], []

        def keep(cls, *args, **kw):
            nets.append(create.__func__(cls, *args, **kw))
            backends.append(bls.backend_name())  # ClientBuilder set it
            return nets[-1]

        faults0 = {k: counter("testnet_fault_injections_total").value(kind=k) for k in tn.FAULT_KINDS}
        passes0 = counter("scenario_invariant_checks_total").value(result="pass")
        tn.Testnet.create = classmethod(keep)
        reset_chain_counts()
        t0 = time.perf_counter()
        try:
            report = getattr(tn, runner)(spec, E, bls_backend="cuda", **kwargs)
        finally:
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            tn.Testnet.create = create
        launches = chain_counts()
        backends.append(bls.backend_name())
        if set(backends) != {"cuda"}:
            raise AssertionError(f"({name[0]}) the fleet ran under {sorted(set(backends))}")
        faults = {k: counter("testnet_fault_injections_total").value(kind=k) - v for k, v in faults0.items()}
        _fleet_check(name, report, E.SLOTS_PER_EPOCH, faults)
        missing = [k for k in BLS_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"({name[0]}) launched no {missing}")
        (net,) = nets
        out["scenarios"][name] = {
            "runner": runner,
            "nodes": len(net.nodes),
            "s": seconds,
            "slots": int(net.nodes[0].client.slot_clock.now()),
            "recovery_slots": report.get("recovery_slots"),
            "oracle_passes": counter("scenario_invariant_checks_total").value(result="pass") - passes0,
            "fault_injections": {k: v for k, v in faults.items() if v},
            "report": report,
            "launches": launches,
            "card": smi,
        }
    bls.set_backend(None)
    return out


def beside_phases_10_11(seed: int, smi: str) -> dict:
    """The spawned process's work, none of it needing the phases before:
    phase 15's fleets, then phase 12 (a); the host pool's workers stopped
    after."""
    try:
        return {"fleet": fleet_scenarios(smi), "vc_a": vc_minimal_over_http(seed, smi)}
    finally:
        host_pool.reset_pool()


def start_beside_10_11(seed: int, smi: str):
    """beside_phases_10_11 started in a spawned process (its own BLS
    backend, which ClientBuilder sets process-wide, and its own
    interpreter's host work beside the parent's): (future, executor)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool.submit(beside_phases_10_11, seed, smi), pool


def phase_fleet_main_path(beside, smi: str) -> tuple[dict, dict]:
    """Phase 15: the adversarial fleet with its nodes verifying on the
    card, run in a spawned process (fleet_scenarios) beside phases 10-11:
    (a) run_smoke_scenario: 3 nodes, 24 interop validators, Altair at
        genesis; one node partitioned from two, healed, one head and
        finality advancing;
    (b) run_column_withholding_scenario: Deneb from genesis on
        DasTestnetEthSpec (64-element blobs, 16 columns), the KZG engine on
        the insecure dev setup of 64 points on the card: 75% of a blob
        block's columns withheld refused while the chain finalizes past it,
        37.5% withheld reconstructed and imported;
    (c) run_equivocation_scenario: a double proposal over gossip, exactly
        one ProposerSlashing from the observer's SlasherService.
    Each passes the JAX tests' checks and launched every BLS kernel. Here
    the result is read: a line a scenario with its seconds, slots,
    recovery slots, oracle passes, fault injections by kind and launches,
    with the card's name and power limit, and how long this process
    waited for the spawned process (`beside`, from start_beside_10_11),
    which then also ran phase 12 (a). Returns the phase's record and phase
    12 (a)'s result."""
    future, _ = beside
    t0 = time.perf_counter()
    done = future.result(timeout=FLEET_WAIT)
    waited = time.perf_counter() - t0
    run, vc_a = done["fleet"], done["vc_a"]
    launches = {}
    for name, sc in run["scenarios"].items():
        emit({"phase": "fleet_scenario", "scenario": name} | {k: v for k, v in sc.items() if k != "report"})
        for k, v in sc["launches"].items():
            launches[k] = launches.get(k, 0) + v
    b = run["scenarios"]["b_column_withholding"]["launches"]
    out = {
        "phase": "fleet_main_path",
        "backend": "cuda",
        "warm_s": run["warm_s"],
        "scenarios": {k: {kk: v for kk, v in sc.items() if kk != "launches"} for k, sc in run["scenarios"].items()},
        "b_kzg_launches": {k: b[k] for k in ("multi_pairing", "barycentric_eval", "quotient", "msm", "msm_table")},
        "launches": launches,
        "beside_phases_10_11_s": run["warm_s"] + sum(sc["s"] for sc in run["scenarios"].values()),
        "phase_12_a_beside_s": sum(vc_a["steps_s"].values()),
        "waited_here_s": waited,
        "card": smi,
    }
    emit(out)
    return out, vc_a


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
    # K8 and K9 at phase 15's domain: the 64-point dev setup of DasTestnetEthSpec
    kzg64_checks = phase_kzg_kernel_checks(Kzg(TrustedSetup.insecure_dev(64)), args.seed)
    sharded_checks = phase_sharded_kernel_checks(kzg, args.seed)
    main_path, state = phase_main_path(N_VALIDATORS, UPDATES, args.seed)
    types = build_types(MainnetEthSpec)
    bls_path, sk_of = phase_bls_main_path(state, types, MainnetEthSpec, args.seed)
    # the block of phase 6 carries the six blobs' commitments, made on the
    # card (phase 7 makes them again inside its counted run)
    blobs = kzg_blobs(np.random.default_rng(args.seed + 29), BLOBS_PER_BLOCK)
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    transition, signed, tampered = phase_transition_main_path(state, types, MainnetEthSpec, sk_of, args.seed, commitments)
    # the keys phases 5-6 minted, whose pubkeys are in the registry (phase 9
    # mints more, into its Electra copy only)
    vc_keys, registry_keys = dict(sk_of), dict(sk_of)
    # a fresh engine on the same setup: phase 7 builds its table in its run
    blob_path = phase_blob_main_path(Kzg(kzg.setup), blobs, signed, types, MainnetEthSpec, args.seed)
    sharded = phase_sharded_main_path(state, kzg, args.seed)
    # phase 6's pre-state (with its keys) upgraded to Electra, on a copy
    electra = phase_electra_main_path(state, types, MainnetEthSpec, sk_of, args.seed, commitments)
    # phase 15's fleets with their nodes verifying on the card, then phase 12
    # (a)'s minimal VC over HTTP, in a spawned process beside phases 10-11:
    # phase 6's pre-state and block through the chain's entry points, and the
    # same block and its refused copy through the Beacon API over HTTP
    beside = start_beside_10_11(args.seed, smi)
    try:
        post_root = bytes.fromhex(transition["reps"][0]["root"])
        chain = phase_chain_main_path(state, signed, post_root, kzg, blobs, types, MainnetEthSpec, sk_of, args.seed, smi)
        api = phase_api_main_path(state, signed, tampered, post_root, kzg, blobs, types, MainnetEthSpec, sk_of, smi)
        fleet, vc_a = phase_fleet_main_path(beside, smi)
    finally:
        stop_spawned(beside)
    # the validator client: (a) to finality over HTTP (run beside phases
    # 10-11), (b) phase 6's keys at 1M
    vc, vc_node = phase_vc_main_path(state, signed, post_root, types, MainnetEthSpec, vc_keys, args.seed, smi, vc_a)
    # the node: `bn` as users start it, nodes over TCP, phase 12 (b)'s
    # attestations gossiped at 1M; beside it, in a spawned process, phase 14
    # (b)'s slasher at 1M validators through a store; then phase 14: the
    # slasher in the simulator, (b)'s slashings verified, and eth1 genesis
    # from 16,384 deposits of phase 5's keys
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slasher_") as tmp:
        slasher_run = start_slasher_at_scale(state, MainnetEthSpec, registry_keys, args.seed, os.path.join(tmp, "slasher"))
        try:
            node = phase_node_main_path(state, signed, post_root, kzg, blobs, types, MainnetEthSpec, vc_node, smi)
            del vc_node
            slasher = phase_slasher_main_path(state, types, MainnetEthSpec, registry_keys, slasher_run, smi)
        finally:
            stop_spawned(slasher_run)
    host_pool.reset_pool()  # stop the host pool's workers

    emit(
        {
            "kernels": [
                {
                    "name": "sha256_rows",
                    "route": "cuda",
                    "source": "lighthouse_tpu_torch/csrc/sha256.cu",
                    "replaces": "lighthouse_tpu/ops/sha256.py:104",
                    # phase 4's state roots; phase 9's Electra block import apart
                    "launches": main_path["sha256_launches"],
                    "launches_electra": electra["launches"]["sha256_rows"],
                    "launches_chain": chain["launches"]["sha256_rows"],
                    "launches_api": api["launches"]["sha256_rows"],
                    "launches_vc": vc["launches"]["sha256_rows"],
                    "launches_node": node["launches"]["sha256_rows"],
                    "launches_slasher": slasher["launches"]["sha256_rows"],
                    "launches_fleet": fleet["launches"]["sha256_rows"],
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
                    # K2's g1_to_affine K9's table there; phase 9's apart
                    "launches": bls_path["launches"][name] + blob_path["launches"].get(name, 0),
                    "launches_electra": electra["launches"][name],
                    "launches_chain": chain["launches"][name],
                    "launches_api": api["launches"][name],
                    "launches_vc": vc["launches"][name],
                    "launches_node": node["launches"][name],
                    "launches_slasher": slasher["launches"][name],
                    "launches_fleet": fleet["launches"][name],
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
                    # phase 6's epochs; phase 9's Electra epochs apart
                    "launches": transition["epoch_sweep_launches"],
                    "launches_electra": electra["epoch_sweep_launches"],
                    "launches_chain": chain["launches"]["epoch_sweep"],
                    "launches_api": api["launches"]["epoch_sweep"],
                    "launches_vc": vc["launches"]["epoch_sweep"],
                    "launches_node": node["launches"]["epoch_sweep"],
                    "launches_slasher": slasher["launches"]["epoch_sweep"],
                    "launches_fleet": fleet["launches"]["epoch_sweep"],
                    "max_abs_err": sweep_check["max_abs_err"],
                    "ms": sweep_check["ms"],
                    "plain_ms": sweep_check["plain_ms"],
                    "bound_ms": sweep_check["bound_ms"],
                    "bound_by": sweep_check["bound_by"],
                    "library_ms": None,
                    # the card alone; the replaced two-kernel sweep in the same call;
                    # Electra's rows (2048-ETH effective balances) on the card alone
                    **{key: sweep_check[key] for key in ("gpu_ms", "replaced_ms", "replaced_gpu_ms")},
                    "electra_rows_gpu_ms": sweep_check["cases"]["electra"]["gpu_ms"],
                }
            ]
            + [
                {
                    "name": name,
                    "route": "cuda",
                    "source": f"lighthouse_tpu_torch/csrc/{src}",
                    "replaces": replaces,
                    "launches": blob_path["launches"][name],
                    "launches_chain": chain["launches"][name],
                    "launches_api": api["launches"][name],
                    "launches_vc": vc["launches"][name],
                    "launches_node": node["launches"][name],
                    "launches_slasher": slasher["launches"][name],
                    "launches_fleet": fleet["launches"][name],
                    "max_abs_err": max(
                        c["max_abs_err"]
                        for checks_n in (kzg_checks, kzg64_checks)
                        for k, c in checks_n["kernels"].items()
                        if k.split("[")[0] == name
                    ),
                    # phase 15's 64-point domain (phase 3's checks on the dev setup)
                    "max_abs_err_64": max(
                        c["max_abs_err"] for k, c in kzg64_checks["kernels"].items() if k.split("[")[0] == name
                    ),
                    "ms_64": kzg64_checks["kernels"][case64]["ms"],
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
                for (name, (_, src, replaces)), case, case64 in zip(
                    KZG_KERNELS.items(),
                    (f"barycentric_eval[{BLOBS_PER_BLOCK},4096]", "quotient[4096]", "msm[4096]", "msm_table[4096]"),
                    ("barycentric_eval[2,64]", "quotient[64]", "msm[64]", "msm_table[64]"),
                )
            ]
            + [
                {
                    "name": name,
                    "route": "cuda",
                    "source": src,
                    "replaces": replaces,
                    "launches": launches,
                    "launches_chain": chain["launches"][name],
                    "launches_api": api["launches"][name],
                    "launches_vc": vc["launches"][name],
                    "launches_node": node["launches"][name],
                    "launches_slasher": slasher["launches"][name],
                    "launches_fleet": fleet["launches"][name],
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
                    "launches_chain": chain["launches"]["g1_scalar_mul_wide64"],
                    "launches_api": api["launches"]["g1_scalar_mul_wide64"],
                    "launches_vc": vc["launches"]["g1_scalar_mul_wide64"],
                    "launches_node": node["launches"]["g1_scalar_mul_wide64"],
                    "launches_slasher": slasher["launches"]["g1_scalar_mul_wide64"],
                    "launches_fleet": fleet["launches"]["g1_scalar_mul_wide64"],
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
