"""A seeded BeaconState as plain arrays, its program counterpart, and the
block-sized writes the state-root traffic applies to both.

``RawState`` is the benchmark's own copy: numpy columns, bytes and ints in the
field order of the consensus specs' BeaconState (Deneb, or Electra as of
v1.5.0-alpha.2). The reference roots it (``reference/state_root.py``);
``to_program`` hands the same values to the program as its own containers.
Every value is drawn from the seed with numpy, so one seed gives one state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_TIME = 1_606_824_023
# Mainnet fork versions (configs/mainnet.yaml).
FORK_VERSIONS = {"deneb": b"\x04\x00\x00\x00", "electra": b"\x05\x00\x00\x00"}
PREVIOUS_VERSIONS = {"deneb": b"\x03\x00\x00\x00", "electra": b"\x04\x00\x00\x00"}
PENDING_LISTS = ("pending_balance_deposits", "pending_partial_withdrawals", "pending_consolidations")
# The u64 fields of each pending list's element, in order.
PENDING_FIELDS = {
    "pending_balance_deposits": ("index", "amount"),
    "pending_partial_withdrawals": ("index", "amount", "withdrawable_epoch"),
    "pending_consolidations": ("source_index", "target_index"),
}
ELECTRA_SCALARS = (
    "deposit_receipts_start_index",
    "deposit_balance_to_consume",
    "exit_balance_to_consume",
    "earliest_exit_epoch",
    "consolidation_balance_to_consume",
    "earliest_consolidation_epoch",
)
VALIDATOR_U64 = ("effective_balance", "activation_eligibility_epoch", "activation_epoch", "exit_epoch", "withdrawable_epoch")


@dataclass
class RawState:
    fork: str
    preset: dict
    f: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.f["effective_balance"])


def build_state(preset: dict, fork: str, n: int, seed: int, slot_in_epoch: int | None = 0,
                pending: dict | None = None, compounding_share: float = 0.0) -> RawState:
    """A mainnet-shaped state of `n` validators from `seed`: every validator
    active since an early epoch (1% exited, 0.1% slashed), balances of 16 to 32
    ETH (32 to 2048 for the `compounding_share` with 0x02 credentials under
    Electra), participation flags and inactivity scores drawn per validator.
    The slot lies 300,000 epochs in, at `slot_in_epoch` (None: drawn)."""
    rng = np.random.default_rng(seed)
    spe = preset["SLOTS_PER_EPOCH"]
    f: dict = {}
    f["pubkey"] = np.frombuffer(rng.bytes(48 * n), np.uint8).reshape(n, 48).copy()
    wc = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32).copy()
    wc[:, 0] = 0x01
    eb = rng.integers(16, 33, n).astype(np.uint64) * np.uint64(10**9)
    if fork == "electra" and compounding_share > 0:
        comp = rng.random(n) < compounding_share
        wc[comp, 0] = 0x02
        eb[comp] = rng.integers(32, 2049, int(comp.sum())).astype(np.uint64) * np.uint64(10**9)
    f["withdrawal_credentials"] = wc
    f["effective_balance"] = eb
    f["slashed"] = (rng.random(n) < 0.001).astype(np.uint8)
    elig = rng.integers(0, 200_000, n).astype(np.uint64)
    f["activation_eligibility_epoch"] = elig
    f["activation_epoch"] = elig + np.uint64(1)
    exited = rng.random(n) < 0.01
    exit_ep = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)
    exit_ep[exited] = f["activation_epoch"][exited] + np.uint64(1000)
    f["exit_epoch"] = exit_ep
    wd = exit_ep.copy()
    wd[exited] = exit_ep[exited] + np.uint64(256)
    f["withdrawable_epoch"] = wd
    f["balances"] = eb + rng.integers(0, 10**9, n).astype(np.uint64)
    f["previous_epoch_participation"] = rng.integers(0, 8, n, dtype=np.uint8)
    f["current_epoch_participation"] = rng.integers(0, 8, n, dtype=np.uint8)
    f["inactivity_scores"] = rng.integers(0, 64, n).astype(np.uint64)

    def roots(k: int) -> np.ndarray:
        return np.frombuffer(rng.bytes(32 * k), np.uint8).reshape(k, 32).copy()

    in_epoch = int(rng.integers(0, spe)) if slot_in_epoch is None else slot_in_epoch
    slot = 300_000 * spe + in_epoch
    epoch = slot // spe
    f["genesis_time"] = GENESIS_TIME
    f["genesis_validators_root"] = rng.bytes(32)
    f["slot"] = slot
    f["fork"] = (PREVIOUS_VERSIONS[fork], FORK_VERSIONS[fork], epoch - 1000)
    f["latest_block_header"] = {
        "slot": slot,
        "proposer_index": int(rng.integers(0, n)),
        "parent_root": rng.bytes(32),
        "state_root": b"\x00" * 32,
        "body_root": rng.bytes(32),
    }
    f["block_roots"] = roots(preset["SLOTS_PER_HISTORICAL_ROOT"])
    f["state_roots"] = roots(preset["SLOTS_PER_HISTORICAL_ROOT"])
    f["historical_roots"] = roots(64)
    f["eth1_data"] = (rng.bytes(32), n, rng.bytes(32))
    f["eth1_data_votes"] = [(rng.bytes(32), n, rng.bytes(32)) for _ in range(16)]
    f["eth1_deposit_index"] = n
    f["randao_mixes"] = roots(preset["EPOCHS_PER_HISTORICAL_VECTOR"])
    f["slashings"] = rng.integers(0, 10**12, preset["EPOCHS_PER_SLASHINGS_VECTOR"]).astype(np.uint64)
    f["justification_bits"] = (True, True, True, False)
    f["previous_justified_checkpoint"] = (epoch - 2, rng.bytes(32))
    f["current_justified_checkpoint"] = (epoch - 1, rng.bytes(32))
    f["finalized_checkpoint"] = (epoch - 2, rng.bytes(32))
    size = preset["SYNC_COMMITTEE_SIZE"]
    for name in ("current_sync_committee", "next_sync_committee"):
        idx = rng.integers(0, n, size)
        f[name] = (f["pubkey"][idx].copy(), rng.bytes(48))
    header = {
        "parent_hash": rng.bytes(32),
        "fee_recipient": rng.bytes(20),
        "state_root": rng.bytes(32),
        "receipts_root": rng.bytes(32),
        "logs_bloom": rng.bytes(256),
        "prev_randao": rng.bytes(32),
        "block_number": int(rng.integers(0, 2**40)),
        "gas_limit": 30_000_000,
        "gas_used": int(rng.integers(0, 30_000_000)),
        "timestamp": GENESIS_TIME + slot * 12,
        "extra_data": rng.bytes(32),
        "base_fee_per_gas": int(rng.integers(0, 2**62)),
        "block_hash": rng.bytes(32),
        "transactions_root": rng.bytes(32),
        "withdrawals_root": rng.bytes(32),
        "blob_gas_used": int(rng.integers(0, 2**20)),
        "excess_blob_gas": int(rng.integers(0, 2**20)),
    }
    if fork == "electra":
        header["deposit_receipts_root"] = rng.bytes(32)
        header["withdrawal_requests_root"] = rng.bytes(32)
    f["latest_execution_payload_header"] = header
    f["next_withdrawal_index"] = int(rng.integers(0, 2**32))
    f["next_withdrawal_validator_index"] = int(rng.integers(0, n))
    f["historical_summaries"] = np.frombuffer(rng.bytes(64 * 32), np.uint8).reshape(32, 2, 32).copy()
    if fork == "electra":
        f["deposit_receipts_start_index"] = n
        f["deposit_balance_to_consume"] = int(rng.integers(0, 10**9))
        f["exit_balance_to_consume"] = int(rng.integers(0, 256 * 10**9))
        f["earliest_exit_epoch"] = epoch + 5
        f["consolidation_balance_to_consume"] = int(rng.integers(0, 256 * 10**9))
        f["earliest_consolidation_epoch"] = epoch + 5
        sizes = pending or {}
        for name in PENDING_LISTS:
            f[name] = _pending_rows(rng, name, int(sizes.get(name, 0)), n, epoch)
    return RawState(fork, preset, f)


def _pending_rows(rng, name: str, k: int, n: int, epoch: int) -> np.ndarray:
    """[k, fields] uint64 rows of a pending list."""
    if name == "pending_balance_deposits":
        cols = [rng.integers(0, n, k), rng.integers(1, 32, k) * 10**9]
    elif name == "pending_partial_withdrawals":
        cols = [rng.integers(0, n, k), rng.integers(1, 10**10, k), epoch + rng.integers(0, 256, k)]
    else:
        cols = [rng.integers(0, n, k), rng.integers(0, n, k)]
    return np.stack([np.asarray(c, dtype=np.uint64) for c in cols], 1).reshape(k, len(cols))


# ---------------------------------------------------------------------------
# The program's containers
# ---------------------------------------------------------------------------


def to_program(raw: RawState, types):
    """The same state as the program's BeaconState of `raw.fork`, built from
    `types` (the program's ``build_types(E)`` namespace)."""
    f = raw.f
    n = raw.n
    T = types.types_for_fork(raw.fork)
    pk = f["pubkey"].tobytes()
    wc = f["withdrawal_credentials"].tobytes()
    cols = {k: f[k].tolist() for k in VALIDATOR_U64}
    slashed = f["slashed"].astype(bool).tolist()
    V = types.Validator
    validators = [
        V(
            pubkey=pk[48 * i : 48 * i + 48],
            withdrawal_credentials=wc[32 * i : 32 * i + 32],
            effective_balance=cols["effective_balance"][i],
            slashed=slashed[i],
            activation_eligibility_epoch=cols["activation_eligibility_epoch"][i],
            activation_epoch=cols["activation_epoch"][i],
            exit_epoch=cols["exit_epoch"][i],
            withdrawable_epoch=cols["withdrawable_epoch"][i],
        )
        for i in range(n)
    ]

    def roots(a: np.ndarray) -> list[bytes]:
        b = a.tobytes()
        return [b[32 * i : 32 * i + 32] for i in range(a.shape[0])]

    def eth1(t):
        return types.Eth1Data(deposit_root=t[0], deposit_count=t[1], block_hash=t[2])

    def sync(t):
        pks, agg = t
        b = pks.tobytes()
        return types.SyncCommittee(pubkeys=[b[48 * i : 48 * i + 48] for i in range(pks.shape[0])], aggregate_pubkey=agg)

    def cp(t):
        return types.Checkpoint(epoch=t[0], root=t[1])

    kw = dict(
        genesis_time=f["genesis_time"],
        genesis_validators_root=f["genesis_validators_root"],
        slot=f["slot"],
        fork=types.Fork(previous_version=f["fork"][0], current_version=f["fork"][1], epoch=f["fork"][2]),
        latest_block_header=types.BeaconBlockHeader(**f["latest_block_header"]),
        block_roots=roots(f["block_roots"]),
        state_roots=roots(f["state_roots"]),
        historical_roots=roots(f["historical_roots"]),
        eth1_data=eth1(f["eth1_data"]),
        eth1_data_votes=[eth1(t) for t in f["eth1_data_votes"]],
        eth1_deposit_index=f["eth1_deposit_index"],
        validators=validators,
        balances=f["balances"].tolist(),
        randao_mixes=roots(f["randao_mixes"]),
        slashings=f["slashings"].tolist(),
        previous_epoch_participation=bytearray(f["previous_epoch_participation"].tobytes()),
        current_epoch_participation=bytearray(f["current_epoch_participation"].tobytes()),
        justification_bits=list(f["justification_bits"]),
        previous_justified_checkpoint=cp(f["previous_justified_checkpoint"]),
        current_justified_checkpoint=cp(f["current_justified_checkpoint"]),
        finalized_checkpoint=cp(f["finalized_checkpoint"]),
        inactivity_scores=f["inactivity_scores"].tolist(),
        current_sync_committee=sync(f["current_sync_committee"]),
        next_sync_committee=sync(f["next_sync_committee"]),
        latest_execution_payload_header=T.ExecutionPayloadHeader(**f["latest_execution_payload_header"]),
        next_withdrawal_index=f["next_withdrawal_index"],
        next_withdrawal_validator_index=f["next_withdrawal_validator_index"],
        historical_summaries=[
            types.HistoricalSummary(block_summary_root=bytes(s[0]), state_summary_root=bytes(s[1]))
            for s in f["historical_summaries"]
        ],
    )
    if raw.fork == "electra":
        for name in ELECTRA_SCALARS:
            kw[name] = f[name]
        for name in PENDING_LISTS:
            kw[name] = pending_elements(types, name, f[name])
    return T.BeaconState(**kw)


def anchored_chain(raw: RawState, types, kzg=None):
    """The program's BeaconChain over an in-memory store, anchored on `raw`
    (its latest block header the head), its clock at the state's slot."""
    from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain
    from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
    from lighthouse_tpu_torch.types import MainnetEthSpec
    from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    spec = mainnet_spec()
    clock = ManualSlotClock(genesis_time=raw.f["genesis_time"], seconds_per_slot=spec.seconds_per_slot)
    clock.set_slot(raw.f["slot"])
    return BeaconChain(HotColdDB(MemoryStore()), genesis_state=to_program(raw, types), spec=spec,
                       E=MainnetEthSpec, slot_clock=clock, kzg=kzg)


def pending_elements(types, name: str, rows: np.ndarray) -> list:
    cls = {
        "pending_balance_deposits": types.PendingBalanceDeposit,
        "pending_partial_withdrawals": types.PendingPartialWithdrawal,
        "pending_consolidations": types.PendingConsolidation,
    }[name]
    names = PENDING_FIELDS[name]
    return [cls(**dict(zip(names, row))) for row in rows.tolist()]


# ---------------------------------------------------------------------------
# One block's writes
# ---------------------------------------------------------------------------


@dataclass
class Writes:
    """One block's state writes, as values: both sides apply the same."""

    slot: int
    balance_idx: np.ndarray
    balance_add: np.ndarray
    slashed_idx: np.ndarray
    part_idx: np.ndarray
    part_xor: np.ndarray  # nonzero: every touched flag byte changes
    block_root: bytes
    state_root: bytes
    randao: bytes
    # Electra: appended rows (the same number dropped from each list's front)
    appends: dict = field(default_factory=dict)
    exit_idx: np.ndarray | None = None
    exit_epoch: int = 0
    exit_balance_to_consume: int = 0


def distinct(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """`k` distinct sorted indices below `n`, uniform, in time of order k."""
    if 4 * k > n:
        return np.sort(rng.choice(n, k, replace=False))
    got = np.unique(rng.integers(0, n, k + k // 8 + 16))
    while got.size < k:
        got = np.unique(np.concatenate([got, rng.integers(0, n, k)]))
    return np.sort(rng.choice(got, k, replace=False))


def draw_writes(raw_slot: int, n: int, preset: dict, traffic: dict, fork: str, rng: np.random.Generator) -> Writes:
    """The writes of the block at `raw_slot` + 1: `traffic` gives the counts
    (balances, slashed validators, the participation share, Electra's
    requests)."""
    slot = raw_slot + 1
    epoch = slot // preset["SLOTS_PER_EPOCH"]
    bal = distinct(rng, n, traffic["balances"])
    part = distinct(rng, n, max(1, n // traffic["participation_divisor"]))
    w = Writes(
        slot=slot,
        balance_idx=bal,
        balance_add=rng.integers(1, 10**7, bal.size).astype(np.uint64),
        slashed_idx=distinct(rng, n, traffic["slashed_validators"]),
        part_idx=part,
        part_xor=rng.integers(1, 8, part.size, dtype=np.uint8),
        block_root=rng.bytes(32),
        state_root=rng.bytes(32),
        randao=rng.bytes(32),
    )
    if fork == "electra":
        w.appends = {
            "pending_balance_deposits": _pending_rows(rng, "pending_balance_deposits", traffic["deposit_receipts"], n, epoch),
            "pending_partial_withdrawals": _pending_rows(
                rng, "pending_partial_withdrawals", traffic["partial_withdrawal_requests"], n, epoch
            ),
        }
        w.exit_idx = distinct(rng, n, traffic["full_exit_requests"])
        w.exit_epoch = epoch + 5 + int(rng.integers(0, 4))
        w.exit_balance_to_consume = int(rng.integers(0, 256 * 10**9))
    return w


def apply_raw(raw: RawState, w: Writes) -> None:
    """The writes on the benchmark's own copy."""
    f = raw.f
    p = raw.preset
    f["slot"] = w.slot
    f["balances"][w.balance_idx] += w.balance_add
    f["effective_balance"][w.slashed_idx] -= np.uint64(10**9)
    f["slashed"][w.slashed_idx] = 1
    f["current_epoch_participation"][w.part_idx] ^= w.part_xor
    f["block_roots"][w.slot % p["SLOTS_PER_HISTORICAL_ROOT"]] = np.frombuffer(w.block_root, np.uint8)
    f["state_roots"][w.slot % p["SLOTS_PER_HISTORICAL_ROOT"]] = np.frombuffer(w.state_root, np.uint8)
    epoch = w.slot // p["SLOTS_PER_EPOCH"]
    f["randao_mixes"][epoch % p["EPOCHS_PER_HISTORICAL_VECTOR"]] = np.frombuffer(w.randao, np.uint8)
    if raw.fork == "electra":
        for name, rows in w.appends.items():
            f[name] = np.concatenate([f[name][len(rows) :], rows])
        f["exit_epoch"][w.exit_idx] = np.uint64(w.exit_epoch)
        f["withdrawable_epoch"][w.exit_idx] = np.uint64(w.exit_epoch + 256)
        f["exit_balance_to_consume"] = w.exit_balance_to_consume
        f["earliest_exit_epoch"] = max(f["earliest_exit_epoch"], w.exit_epoch)


def apply_program(state, w: Writes, types, preset: dict) -> None:
    """The same writes on the program's tree-states BeaconState, through its
    persistent lists' own write paths."""
    state.slot = w.slot
    balances = state.balances
    for i, d in zip(w.balance_idx.tolist(), w.balance_add.tolist()):
        balances[i] = int(balances[i]) + d
    for i in w.slashed_idx.tolist():
        v = state.validators.mutate(i)
        v.effective_balance = int(v.effective_balance) - 10**9
        v.slashed = True
    part = state.current_epoch_participation
    old = np.array(part.load_array(), dtype=np.uint8)
    new = old.copy()
    new[w.part_idx] ^= w.part_xor
    part.store_array(new, w.part_idx[new[w.part_idx] != old[w.part_idx]])
    state.block_roots[w.slot % preset["SLOTS_PER_HISTORICAL_ROOT"]] = w.block_root
    state.state_roots[w.slot % preset["SLOTS_PER_HISTORICAL_ROOT"]] = w.state_root
    epoch = w.slot // preset["SLOTS_PER_EPOCH"]
    state.randao_mixes[epoch % preset["EPOCHS_PER_HISTORICAL_VECTOR"]] = w.randao
    if w.exit_idx is not None:
        for name, rows in w.appends.items():
            lst = getattr(state, name)
            del lst[: len(rows)]
            lst.extend(pending_elements(types, name, rows))
        for i in w.exit_idx.tolist():
            v = state.validators.mutate(i)
            v.exit_epoch = w.exit_epoch
            v.withdrawable_epoch = w.exit_epoch + 256
        state.exit_balance_to_consume = w.exit_balance_to_consume
        state.earliest_exit_epoch = max(int(state.earliest_exit_epoch), w.exit_epoch)
