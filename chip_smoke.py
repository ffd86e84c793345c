#!/usr/bin/env python3
"""Drive lighthouse_tpu_torch's main path on one NVIDIA GPU and hold every
kernel of that path to its plain PyTorch version.

    python3 chip_smoke.py [--seed S]

Run from the repository root on a machine with a CUDA card; it builds the
kernels from ``lighthouse_tpu_torch/csrc`` itself. Phases, one JSON line
each, any failure ends the run with a non-zero exit code:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, device count;
2. build: seconds, registers and spills of each kernel;
3. kernel checks: the SHA-256 kernel byte-equal to its plain version on the
   card and to hashlib, its time, the plain version's time and its bound;
4. main path: the state-root stage of block import. A mainnet-preset Deneb
   BeaconState with 1,000,000 validators is built from ``--seed``,
   given the tree-states representation, and rooted cold through
   ``BeaconState.hash_tree_root()``; then 8 block-sized
   mutations are each re-rooted incrementally. The cold root must equal a
   root folded without the kernel through the host hash lanes, and each
   incremental root the root of the same state with a fresh cache.

Then one JSON line with every kernel's numbers, the card's nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.ops import sha256 as k_sha256
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

# The main path's size: a mainnet registry and a run of block imports.
N_VALIDATORS = 1_000_000
UPDATES = 8

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


def phase_build() -> None:
    t0 = time.perf_counter()
    k_sha256.load_kernel()
    info = k_sha256.BUILD_INFO
    out = {
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "kernels": {
            "sha256_rows": {
                "so": info["so"],
                "built_now": info["built"],
                **k_sha256.ptxas_usage(info["ptxas"]),
                "sass_instructions": _sass_instructions(info["so"], "sha256_rows_kernel"),
            }
        },
    }
    emit(out)


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
        }
    )
    phase_build()
    checks = phase_kernel_checks(args.seed)
    main_path = phase_main_path(N_VALIDATORS, UPDATES, args.seed)

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
