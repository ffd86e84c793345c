"""Committees, domains and signing roots as the consensus specs define them
(phase0 beacon-chain.md: ``compute_shuffled_index``, ``get_seed``,
``compute_committee``, ``compute_domain``, ``compute_signing_root``),
vectorized over the registry with numpy and ``hashlib``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .ssz import checkpoint, container, h, uint_chunk

DOMAIN_BEACON_ATTESTER = b"\x01\x00\x00\x00"


def sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def active_indices(f: dict, epoch: int) -> np.ndarray:
    act = f["activation_epoch"]
    ext = f["exit_epoch"]
    e = np.uint64(epoch)
    return np.nonzero((act <= e) & (e < ext))[0]


def get_seed(f: dict, preset: dict, epoch: int, domain_type: bytes) -> bytes:
    vec = preset["EPOCHS_PER_HISTORICAL_VECTOR"]
    mix = f["randao_mixes"][(epoch + vec - preset["MIN_SEED_LOOKAHEAD"] - 1) % vec].tobytes()
    return sha(domain_type + epoch.to_bytes(8, "little") + mix)


def shuffled_positions(n: int, seed: bytes, rounds: int) -> np.ndarray:
    """compute_shuffled_index(i, n, seed) for every i in range(n)."""
    idx = np.arange(n, dtype=np.int64)
    blocks = (n + 255) // 256
    for r in range(rounds):
        rb = bytes([r])
        pivot = int.from_bytes(sha(seed + rb)[:8], "little") % n
        flip = (pivot + n - idx) % n
        position = np.maximum(idx, flip)
        src = np.frombuffer(b"".join(sha(seed + rb + i.to_bytes(4, "little")) for i in range(blocks)), np.uint8)
        byte = src[(position // 256) * 32 + (position % 256) // 8]
        bit = (byte >> (position % 8).astype(np.uint8)) & 1
        idx = np.where(bit == 1, flip, idx)
    return idx


def committees_per_slot(active: int, preset: dict) -> int:
    return max(1, min(preset["MAX_COMMITTEES_PER_SLOT"], active // preset["SLOTS_PER_EPOCH"] // preset["TARGET_COMMITTEE_SIZE"]))


def slot_committees(f: dict, preset: dict, slot: int) -> list[np.ndarray]:
    """The beacon committees of `slot`, each a list of validator indices in
    committee order."""
    spe = preset["SLOTS_PER_EPOCH"]
    epoch = slot // spe
    active = active_indices(f, epoch)
    n = active.size
    seed = get_seed(f, preset, epoch, DOMAIN_BEACON_ATTESTER)
    shuffled = shuffled_positions(n, seed, preset["SHUFFLE_ROUND_COUNT"])
    cps = committees_per_slot(n, preset)
    count = cps * spe
    out = []
    for c in range(cps):
        i = (slot % spe) * cps + c
        out.append(active[shuffled[n * i // count : n * (i + 1) // count]])
    return out


def compute_domain(domain_type: bytes, fork_version: bytes, genesis_validators_root: bytes) -> bytes:
    fork_data_root = h(fork_version.ljust(32, b"\x00"), genesis_validators_root)
    return domain_type + fork_data_root[:28]


def attester_domain(f: dict, preset: dict, epoch: int) -> bytes:
    prev, cur, fork_epoch = f["fork"]
    version = prev if epoch < fork_epoch else cur
    return compute_domain(DOMAIN_BEACON_ATTESTER, version, f["genesis_validators_root"])


def attestation_data_root(slot: int, index: int, block_root: bytes, source: tuple, target: tuple) -> bytes:
    return container([uint_chunk(slot), uint_chunk(index), block_root, checkpoint(*source), checkpoint(*target)])


def signing_root(object_root: bytes, domain: bytes) -> bytes:
    return h(object_root, domain)


def block_header_root(header: dict, state_root: bytes | None = None) -> bytes:
    """A BeaconBlockHeader's root, with `state_root` filled in where given
    (the anchor block of a state whose header still carries zero)."""
    hd = dict(header)
    if state_root is not None:
        hd["state_root"] = state_root
    return container([
        uint_chunk(hd["slot"]), uint_chunk(hd["proposer_index"]), hd["parent_root"], hd["state_root"], hd["body_root"],
    ])
