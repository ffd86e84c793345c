"""Eth1 deposit-contract follower (beacon_node/eth1 analog).

Caches eth1 blocks + deposit logs behind the follow distance
(src/{block_cache,deposit_cache,service}.rs): deposits carry incremental
Merkle proofs for block inclusion, `eth1_data_for_voting` implements the
spec's voting-period majority vote, and `Eth1GenesisService` watches the
chain until the genesis criteria hold and builds the genesis state
(src/eth1_genesis_service.rs). The provider seam is any object with
`eth1_blocks()`/`deposit_logs()` — the in-process mock below stands in for
the JSON-RPC client."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..state_processing.genesis import DepositTree
from ..types.chain_spec import ChainSpec


@dataclass
class Eth1Block:
    number: int
    block_hash: bytes
    timestamp: int
    deposit_root: bytes = b"\x00" * 32
    deposit_count: int = 0


@dataclass
class DepositLog:
    index: int
    deposit_data: object  # DepositData container
    block_number: int


class DepositCacheError(ValueError):
    pass


class DepositCache:
    """Ordered deposit logs + incremental Merkle tree (deposit_cache.rs)."""

    def __init__(self, E):
        self.E = E
        self.logs: list[DepositLog] = []
        self.tree = DepositTree()

    def insert_log(self, log: DepositLog):
        if log.index != len(self.logs):
            if log.index < len(self.logs):
                return  # duplicate replay
            raise DepositCacheError(
                f"non-contiguous deposit log {log.index} (have {len(self.logs)})"
            )
        self.logs.append(log)
        self.tree.push(log.deposit_data.hash_tree_root())

    def deposit_root(self, count: int | None = None) -> bytes:
        if count is None or count == len(self.logs):
            return self.tree.root()
        if count > len(self.logs):
            # a root over logs we don't have would silently mismatch
            raise DepositCacheError(
                f"deposit root at count {count} needs logs beyond {len(self.logs)}"
            )
        # historical root: rebuild a tree over the prefix (cold path)
        t = DepositTree()
        for log in self.logs[:count]:
            t.push(log.deposit_data.hash_tree_root())
        return t.root()

    def get_deposits(self, start: int, end: int, deposit_count: int):
        """Deposit containers (with proofs against the tree at
        `deposit_count`) for inclusion in a block."""
        from ..types.containers import build_types

        if end > deposit_count or end > len(self.logs):
            raise DepositCacheError("requested deposits beyond known logs")
        if deposit_count > len(self.logs):
            # proofs must verify against the root at deposit_count; without
            # those logs the tree (and every proof) would be wrong
            raise DepositCacheError(
                f"proof tree at count {deposit_count} needs logs beyond "
                f"{len(self.logs)}"
            )
        t = build_types(self.E)
        # proofs must verify against the root at deposit_count
        tree = DepositTree()
        for log in self.logs[:deposit_count]:
            tree.push(log.deposit_data.hash_tree_root())
        out = []
        for log in self.logs[start:end]:
            out.append(
                t.Deposit(
                    proof=tree.proof(log.index),
                    data=log.deposit_data,
                )
            )
        return out


class BlockCache:
    def __init__(self):
        self.blocks: list[Eth1Block] = []

    def insert(self, block: Eth1Block):
        if self.blocks and block.number <= self.blocks[-1].number:
            return
        self.blocks.append(block)

    def block_by_timestamp(self, max_timestamp: int) -> Eth1Block | None:
        """Latest block at/before a timestamp (voting-period lookup)."""
        best = None
        for b in self.blocks:
            if b.timestamp <= max_timestamp:
                best = b
        return best


class Eth1Service:
    """Follower service: polls the provider, fills the caches, and answers
    the two consensus questions — eth1_data to vote for, and deposits to
    include (service.rs)."""

    def __init__(self, provider, spec: ChainSpec, E):
        self.provider = provider
        self.spec = spec
        self.E = E
        self.deposit_cache = DepositCache(E)
        self.block_cache = BlockCache()

    def update(self):
        for block in self.provider.eth1_blocks():
            self.block_cache.insert(block)
        for log in self.provider.deposit_logs():
            self.deposit_cache.insert_log(log)

    # -- eth1 data voting (spec get_eth1_vote) --------------------------------

    def _candidate_blocks(self, period_start: int) -> list[Eth1Block]:
        """Blocks inside the spec candidate window: FOLLOW_DISTANCE to
        2×FOLLOW_DISTANCE eth1-blocks behind the period start."""
        spec = self.spec
        dist = spec.eth1_follow_distance * spec.seconds_per_eth1_block
        return [
            b
            for b in self.block_cache.blocks
            if b.timestamp + dist <= period_start
            and b.timestamp + 2 * dist >= period_start
        ]

    def eth1_data_for_voting(self, state) -> object:
        """Spec get_eth1_vote: tally the period's existing votes over the
        candidate-window blocks; majority wins, latest candidate breaks
        ties/absence, current eth1_data when no candidate qualifies."""
        from ..types.containers import build_types

        t = build_types(self.E)
        period_start = _voting_period_start_time(state, self.spec, self.E)
        votes_to_consider = []
        for b in self._candidate_blocks(period_start):
            if (
                b.deposit_count >= state.eth1_data.deposit_count
                and b.deposit_count <= len(self.deposit_cache.logs)
            ):
                votes_to_consider.append(
                    t.Eth1Data(
                        deposit_root=self.deposit_cache.deposit_root(
                            b.deposit_count
                        ),
                        deposit_count=b.deposit_count,
                        block_hash=b.block_hash,
                    )
                )
        if not votes_to_consider:
            return state.eth1_data  # default vote (spec behavior)
        valid_votes = [
            v for v in state.eth1_data_votes if v in votes_to_consider
        ]
        if valid_votes:
            best = max(
                valid_votes,
                key=lambda v: (valid_votes.count(v), -valid_votes.index(v)),
            )
            return best
        return votes_to_consider[-1]  # latest candidate

    def deposits_for_block(self, state) -> list:
        """Deposits the next block must include (eth1_deposit_index →
        min(count, index + MAX_DEPOSITS))."""
        start = state.eth1_deposit_index
        count = state.eth1_data.deposit_count
        end = min(count, start + self.E.MAX_DEPOSITS)
        if (
            end <= start
            or end > len(self.deposit_cache.logs)
            or count > len(self.deposit_cache.logs)
        ):
            return []  # logs not fully synced yet: can't build valid proofs
        return self.deposit_cache.get_deposits(start, end, count)


def _voting_period_start_time(state, spec: ChainSpec, E) -> int:
    period_slots = E.EPOCHS_PER_ETH1_VOTING_PERIOD * E.SLOTS_PER_EPOCH
    period_start_slot = state.slot - state.slot % period_slots
    return state.genesis_time + period_start_slot * spec.seconds_per_slot


class Eth1GenesisService:
    """Watches deposits until MIN_GENESIS criteria hold, then builds the
    genesis state (eth1_genesis_service.rs)."""

    def __init__(self, service: Eth1Service, spec: ChainSpec, E):
        self.service = service
        self.spec = spec
        self.E = E

    def try_genesis(self):
        """None until genesis conditions hold; then the genesis state."""
        self.service.update()
        cache = self.service.deposit_cache
        if len(cache.logs) < self.spec.min_genesis_active_validator_count:
            return None
        block = self.service.block_cache.blocks[-1] if (
            self.service.block_cache.blocks
        ) else None
        if block is None:
            return None
        genesis_time = (
            block.timestamp + self.spec.genesis_delay
        )
        if block.timestamp < self.spec.min_genesis_time - self.spec.genesis_delay:
            return None
        datas = [log.deposit_data for log in cache.logs]
        from ..state_processing.genesis import _genesis_with_incremental_proofs

        state = _genesis_with_incremental_proofs(
            block.block_hash, genesis_time, datas, self.spec, self.E
        )
        state.genesis_time = genesis_time
        from ..state_processing.genesis import is_valid_genesis_state

        if not is_valid_genesis_state(state, self.spec, self.E):
            return None
        return state


# ---------------------------------------------------------------------------
# In-process provider (the JSON-RPC client's test stand-in)
# ---------------------------------------------------------------------------


class MockEth1Provider:
    """Deterministic eth1 chain + deposit feed."""

    def __init__(self, spec: ChainSpec, start_time: int = 1_500_000_000):
        self.spec = spec
        self._blocks: list[Eth1Block] = []
        self._logs: list[DepositLog] = []
        self._time = start_time

    def mine_block(self):
        n = len(self._blocks)
        self._time += self.spec.seconds_per_eth1_block
        self._blocks.append(
            Eth1Block(
                number=n,
                block_hash=hashlib.sha256(b"eth1" + n.to_bytes(8, "little")).digest(),
                timestamp=self._time,
                deposit_count=len(self._logs),
            )
        )

    def submit_deposit(self, deposit_data):
        self._logs.append(
            DepositLog(
                index=len(self._logs),
                deposit_data=deposit_data,
                block_number=len(self._blocks),
            )
        )

    def eth1_blocks(self):
        return list(self._blocks)

    def deposit_logs(self):
        return list(self._logs)
