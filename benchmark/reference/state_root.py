"""The hash tree root of a ``RawState``, folded from its fields as the
consensus specs define them, with no cache: every call hashes every leaf.

The field order and types are those of the specs' BeaconState (Deneb, and
Electra as of v1.5.0-alpha.2: deposit receipts and per-payload withdrawal
requests in the payload header, three pending lists). Pubkey roots never
change under the traffic, so a ``StateRooter`` keeps them between calls.
"""

from __future__ import annotations

import numpy as np

from ..inputs.state import PENDING_FIELDS, PENDING_LISTS, RawState
from . import ssz
from .ssz import container, fixed_bytes_root, merkleize, mix_in_length, u64_chunks, uint_chunk

HEADER_FIELDS = (
    "parent_hash", "fee_recipient", "state_root", "receipts_root", "logs_bloom", "prev_randao",
    "block_number", "gas_limit", "gas_used", "timestamp", "extra_data", "base_fee_per_gas",
    "block_hash", "transactions_root", "withdrawals_root", "blob_gas_used", "excess_blob_gas",
)
ELECTRA_HEADER_FIELDS = ("deposit_receipts_root", "withdrawal_requests_root")
STATE_FIELDS = (
    "genesis_time", "genesis_validators_root", "slot", "fork", "latest_block_header", "block_roots",
    "state_roots", "historical_roots", "eth1_data", "eth1_data_votes", "eth1_deposit_index",
    "validators", "balances", "randao_mixes", "slashings", "previous_epoch_participation",
    "current_epoch_participation", "justification_bits", "previous_justified_checkpoint",
    "current_justified_checkpoint", "finalized_checkpoint", "inactivity_scores",
    "current_sync_committee", "next_sync_committee", "latest_execution_payload_header",
    "next_withdrawal_index", "next_withdrawal_validator_index", "historical_summaries",
)
ELECTRA_FIELDS = (
    "deposit_receipts_start_index", "deposit_balance_to_consume", "exit_balance_to_consume",
    "earliest_exit_epoch", "consolidation_balance_to_consume", "earliest_consolidation_epoch",
    *PENDING_LISTS,
)
U64_FIELDS = {
    "genesis_time", "slot", "eth1_deposit_index", "next_withdrawal_index",
    "next_withdrawal_validator_index", *ELECTRA_FIELDS[:6],
}
# List limits of the mainnet preset, in elements.
REGISTRY_LIMIT = 2**40


def header_root(h: dict) -> bytes:
    """BeaconBlockHeader."""
    return container([
        uint_chunk(h["slot"]), uint_chunk(h["proposer_index"]), h["parent_root"], h["state_root"], h["body_root"],
    ])


def eth1_root(t) -> bytes:
    return container([t[0], uint_chunk(t[1]), t[2]])


def payload_header_root(hd: dict, fork: str) -> bytes:
    names = HEADER_FIELDS + (ELECTRA_HEADER_FIELDS if fork == "electra" else ())
    out = []
    for name in names:
        v = hd[name]
        if name == "extra_data":
            out.append(mix_in_length(merkleize(ssz.bytes_chunks(v), 1, "cpu"), len(v)))
        elif name == "logs_bloom":
            out.append(fixed_bytes_root(v))
        elif name == "fee_recipient":
            out.append(v.ljust(32, b"\x00"))
        elif name == "base_fee_per_gas":
            out.append(v.to_bytes(32, "little"))
        elif isinstance(v, int):
            out.append(uint_chunk(v))
        else:
            out.append(v)
    return container(out)


class StateRooter:
    """Roots RawStates of one registry on `device` (``cpu`` or ``cuda``)."""

    def __init__(self, device: str = "cpu"):
        self.device = device
        self._pubkey_roots: np.ndarray | None = None

    def pubkey_roots(self, pubkeys: np.ndarray) -> np.ndarray:
        if self._pubkey_roots is None or self._pubkey_roots.shape[0] != pubkeys.shape[0]:
            rows = np.zeros((pubkeys.shape[0], 64), dtype=np.uint8)
            rows[:, :48] = pubkeys
            self._pubkey_roots = ssz.hash_pairs(rows, self.device)
        return self._pubkey_roots

    def validators_root(self, f: dict) -> bytes:
        n = f["pubkey"].shape[0]
        cols = [self.pubkey_roots(f["pubkey"]), f["withdrawal_credentials"]]
        cols.append(ssz.u64_column(f["effective_balance"]))
        slashed = np.zeros((n, 32), dtype=np.uint8)
        slashed[:, 0] = f["slashed"]
        cols.append(slashed)
        for name in ("activation_eligibility_epoch", "activation_epoch", "exit_epoch", "withdrawable_epoch"):
            cols.append(ssz.u64_column(f[name]))
        roots = ssz.container_rows(cols, self.device)
        return mix_in_length(merkleize(roots, REGISTRY_LIMIT, self.device), n)

    def _u64_list(self, values: np.ndarray, limit: int) -> bytes:
        return mix_in_length(merkleize(u64_chunks(values), limit * 8 // 32, self.device), len(values))

    def _byte_list(self, values: np.ndarray, limit: int) -> bytes:
        return mix_in_length(merkleize(ssz.bytes_chunks(values.tobytes()), limit // 32, self.device), len(values))

    def _roots_vector(self, rows: np.ndarray) -> bytes:
        return merkleize(rows, rows.shape[0], self.device)

    def _pending_root(self, name: str, rows: np.ndarray, limit: int) -> bytes:
        if rows.shape[0] == 0:
            return mix_in_length(merkleize(np.zeros((0, 32), np.uint8), limit, self.device), 0)
        cols = [ssz.u64_column(rows[:, j]) for j in range(len(PENDING_FIELDS[name]))]
        roots = ssz.container_rows(cols, self.device)
        return mix_in_length(merkleize(roots, limit, self.device), rows.shape[0])

    def field_root(self, raw: RawState, name: str) -> bytes:
        f, p = raw.f, raw.preset
        v = f.get(name)
        if name in U64_FIELDS:
            return uint_chunk(v)
        if name == "genesis_validators_root":
            return v
        if name == "fork":
            return container([v[0].ljust(32, b"\x00"), v[1].ljust(32, b"\x00"), uint_chunk(v[2])])
        if name == "latest_block_header":
            return header_root(v)
        if name in ("block_roots", "state_roots", "randao_mixes"):
            return self._roots_vector(v)
        if name == "historical_roots":
            return mix_in_length(merkleize(v, p["HISTORICAL_ROOTS_LIMIT"], self.device), v.shape[0])
        if name == "eth1_data":
            return eth1_root(v)
        if name == "eth1_data_votes":
            roots = np.frombuffer(b"".join(eth1_root(t) for t in v), np.uint8).reshape(-1, 32)
            limit = p["EPOCHS_PER_ETH1_VOTING_PERIOD"] * p["SLOTS_PER_EPOCH"]
            return mix_in_length(merkleize(roots, limit, self.device), len(v))
        if name == "validators":
            return self.validators_root(f)
        if name in ("balances", "inactivity_scores"):
            return self._u64_list(f[name], REGISTRY_LIMIT)
        if name == "slashings":
            return merkleize(u64_chunks(v), p["EPOCHS_PER_SLASHINGS_VECTOR"] * 8 // 32, self.device)
        if name.endswith("_epoch_participation"):
            return self._byte_list(v, REGISTRY_LIMIT)
        if name == "justification_bits":
            return bytes([sum(1 << i for i, b in enumerate(v) if b)]).ljust(32, b"\x00")
        if name.endswith("_checkpoint"):
            return ssz.checkpoint(v[0], v[1])
        if name.endswith("_sync_committee"):
            pks, agg = v
            rows = np.zeros((pks.shape[0], 64), dtype=np.uint8)
            rows[:, :48] = pks
            pk_roots = ssz.hash_pairs(rows, self.device)
            return container([merkleize(pk_roots, pks.shape[0], self.device), fixed_bytes_root(agg)])
        if name == "latest_execution_payload_header":
            return payload_header_root(v, raw.fork)
        if name == "historical_summaries":
            roots = ssz.container_rows([v[:, 0], v[:, 1]], self.device)
            return mix_in_length(merkleize(roots, p["HISTORICAL_ROOTS_LIMIT"], self.device), v.shape[0])
        if name in PENDING_LISTS:
            return self._pending_root(name, v, p[name.upper() + "_LIMIT"])
        raise KeyError(name)

    def root(self, raw: RawState) -> bytes:
        names = STATE_FIELDS + (ELECTRA_FIELDS if raw.fork == "electra" else ())
        return container([self.field_root(raw, name) for name in names])
