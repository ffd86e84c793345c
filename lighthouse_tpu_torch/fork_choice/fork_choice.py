"""Spec fork choice over the proto-array

Counterpart of lighthouse_tpu/fork_choice/fork_choice.py, copied.

(consensus/fork_choice/src/fork_choice.rs: on_block :642, on_attestation
:1037, get_head :468, proposer boost, equivocation handling).

The store tracks justified/finalized checkpoints and the proposer boost;
weights come from the justified state's effective balances, supplied by a
`balances_provider` (the beacon chain's justified-balances cache in the
reference)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..state_processing.accessors import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_active_validator_indices,
    get_current_epoch,
)
from ..types.chain_spec import GENESIS_EPOCH, ChainSpec

_EMPTY_BALANCES = np.zeros(0, dtype=np.uint64)

# Same-slot gossip votes held back for one slot (spec ATTESTATION_DELAY).
# Bounded: at the target scale one slot carries ~31k aggregates, so a cap
# well above that only trips on a flood, where shedding the tail is the
# right call anyway.
_MAX_DEFERRED_ATTESTATIONS = 65_536

from ..metrics import REGISTRY  # noqa: E402

_DEFERRED_ATTESTATIONS = REGISTRY.counter(
    "fork_choice_deferred_attestations_total",
    "same-slot gossip attestations held for the next tick, by outcome",
)
for _outcome in ("deferred", "applied", "dropped"):
    # lint: allow(metric-hygiene) -- bounded by the literal tuple above
    _DEFERRED_ATTESTATIONS.inc(0, outcome=_outcome)


class ForkChoiceError(ValueError):
    pass


class InvalidAttestation(ForkChoiceError):
    pass


class UnknownAncestor(InvalidAttestation):
    """The head block's chain cannot be walked to the target epoch (the
    ancestor is pre-finalization / pruned out of the proto-array). Distinct
    from genuine FFG/LMD target inconsistency so callers can treat it as
    queueable rather than invalid (spec: unknown blocks are ignored, not
    rejected)."""


class InvalidBlock(ForkChoiceError):
    pass


@dataclass
class Checkpoint:
    epoch: int
    root: bytes


@dataclass
class ForkChoiceStore:
    """Spec Store subset (fork_choice_store.rs trait surface)."""

    current_slot: int
    justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    unrealized_justified_checkpoint: Checkpoint
    unrealized_finalized_checkpoint: Checkpoint
    proposer_boost_root: bytes = b"\x00" * 32
    equivocating_indices: set[int] = field(default_factory=set)


class ForkChoice:
    def __init__(self, store: ForkChoiceStore, proto, spec: ChainSpec, E):
        from .proto_array import ProtoArrayForkChoice

        self.store = store
        self.proto: ProtoArrayForkChoice = proto
        self.spec = spec
        self.E = E
        # Gossip attestations for the CURRENT slot: the spec forbids
        # counting them before slot+1 (validate_on_attestation's
        # "from the future" rule), but dropping them starves the weights
        # a proposer-boost re-org decision reads one slot later. Queue
        # them here and drain at the next on_tick — fork_choice.rs
        # queued_attestations / ATTESTATION_DELAY_SLOTS.
        self._deferred_attestations: list = []
        # Effective balances of active validators at the justified state,
        # held as a uint64 array: the proto-array keeps a reference (its
        # "old balances" for the next delta round) instead of re-copying a
        # 1M-element Python list per get_head. Replaced wholesale on
        # justified-checkpoint changes, never mutated in place.
        self._justified_balances = _EMPTY_BALANCES
        # Set when a checkpoint promotion couldn't materialize the justified
        # state (tick-path with a cold cache); get_head retries the provider
        # so head selection never keeps stale weights longer than necessary.
        self._justified_balances_stale = False
        # Optional: block_root -> state, so justified balances come from the
        # actual justified checkpoint state (the reference's justified
        # balances cache); falls back to the importing block's state.
        self.state_provider = None

    # ------------------------------------------------------------------ init

    @classmethod
    def from_anchor(cls, anchor_root: bytes, anchor_state, spec: ChainSpec, E):
        """Initialize from a genesis or checkpoint (weak subjectivity) state
        (fork_choice.rs from_anchor)."""
        from .proto_array import ProtoArrayForkChoice

        epoch = get_current_epoch(anchor_state, E)
        cp = Checkpoint(epoch=max(epoch, GENESIS_EPOCH), root=anchor_root)
        store = ForkChoiceStore(
            current_slot=anchor_state.slot,
            justified_checkpoint=cp,
            finalized_checkpoint=cp,
            unrealized_justified_checkpoint=cp,
            unrealized_finalized_checkpoint=cp,
        )
        proto = ProtoArrayForkChoice(
            finalized_root=anchor_root,
            finalized_slot=anchor_state.slot,
            finalized_state_root=anchor_state.hash_tree_root(),
            justified_epoch=cp.epoch,
            finalized_epoch=cp.epoch,
        )
        fc = cls(store, proto, spec, E)
        fc._justified_balances = _active_balances(anchor_state, E)
        return fc

    # ------------------------------------------------------------------ ticks

    def on_tick(self, slot: int):
        """Advance wall-clock slot; reset proposer boost at slot start and,
        on epoch boundaries, promote the unrealized checkpoints to the store
        (spec on_tick_per_slot) — without this, justification can lag
        indefinitely when no new blocks arrive."""
        while self.store.current_slot < slot:
            self.store.current_slot += 1
            self.store.proposer_boost_root = b"\x00" * 32
            if self.store.current_slot % self.E.SLOTS_PER_EPOCH == 0:
                self._update_checkpoints(
                    self.store.unrealized_justified_checkpoint,
                    self.store.unrealized_finalized_checkpoint,
                    state=None,
                )
        self._drain_deferred_attestations()

    def _drain_deferred_attestations(self):
        """Apply queued same-slot votes that the clock has now cleared.
        Entries whose slot is still current stay queued (an on_tick that
        doesn't advance the slot must not re-defer or double-count)."""
        q = self._deferred_attestations
        if not q:
            return
        cur = self.store.current_slot
        ready = [ia for ia in q if int(ia.data.slot) < cur]
        if not ready:
            return
        self._deferred_attestations = [
            ia for ia in q if int(ia.data.slot) >= cur
        ]
        # per-item isolation inside the batch: a vote that went stale in
        # the queue (e.g. pruned head) costs only itself
        self.on_attestation_batch(ready)
        _DEFERRED_ATTESTATIONS.inc(len(ready), outcome="applied")

    # ------------------------------------------------------------------ block

    def on_block(
        self,
        current_slot: int,
        block,
        block_root: bytes,
        state,
        is_timely: bool = False,
    ):
        """Register an imported block (fork_choice.rs:642). `state` is the
        post-state; unrealized checkpoints are drawn from it by running
        justification processing on a throwaway copy."""
        self.on_tick(max(current_slot, self.store.current_slot))
        if block.slot > current_slot:
            raise InvalidBlock(f"future block: {block.slot} > {current_slot}")
        if not self.proto.contains_block(block.parent_root):
            raise InvalidBlock("unknown parent")
        finalized_slot = compute_start_slot_at_epoch(
            self.store.finalized_checkpoint.epoch, self.E
        )
        if block.slot <= finalized_slot:
            raise InvalidBlock("block conflicts with finality (too old)")
        if not self.proto.proto_array.is_descendant(
            self.store.finalized_checkpoint.root, block.parent_root
        ):
            raise InvalidBlock("block does not descend from finalized root")

        # Proposer boost: first timely block for the current slot.
        if (
            is_timely
            and block.slot == current_slot
            and self.store.proposer_boost_root == b"\x00" * 32
        ):
            self.store.proposer_boost_root = block_root

        unrealized_j, unrealized_f = self._compute_unrealized_checkpoints(state)

        # Checkpoint update rules (pull-up tips)
        self._update_checkpoints(
            Checkpoint(
                state.current_justified_checkpoint.epoch,
                state.current_justified_checkpoint.root,
            ),
            Checkpoint(
                state.finalized_checkpoint.epoch, state.finalized_checkpoint.root
            ),
            state,
        )
        if unrealized_j.epoch > self.store.unrealized_justified_checkpoint.epoch:
            self.store.unrealized_justified_checkpoint = unrealized_j
        if unrealized_f.epoch > self.store.unrealized_finalized_checkpoint.epoch:
            self.store.unrealized_finalized_checkpoint = unrealized_f
        # Blocks from prior epochs are pulled up immediately.
        if compute_epoch_at_slot(block.slot, self.E) < compute_epoch_at_slot(
            current_slot, self.E
        ):
            self._update_checkpoints(unrealized_j, unrealized_f, state)

        self.proto.on_block(
            slot=block.slot,
            root=block_root,
            parent_root=block.parent_root,
            state_root=block.state_root,
            justified_epoch=state.current_justified_checkpoint.epoch,
            finalized_epoch=state.finalized_checkpoint.epoch,
            unrealized_justified_epoch=unrealized_j.epoch,
            unrealized_finalized_epoch=unrealized_f.epoch,
        )

    def _update_checkpoints(
        self, justified: Checkpoint, finalized: Checkpoint, state=None
    ):
        if justified.epoch > self.store.justified_checkpoint.epoch:
            self.store.justified_checkpoint = justified
            # Vote weights must come from the justified state's effective
            # balances (spec). The provider serves the actual justified
            # state; the importing block's post-state is a fallback whose
            # active set matches at the justified epoch in all but deep-reorg
            # edge cases; with neither, keep the previous balances but mark
            # them stale so get_head retries the provider before selecting.
            balance_state = None
            if self.state_provider is not None:
                balance_state = self.state_provider(justified.root)
            if balance_state is None:
                balance_state = state
            if balance_state is not None:
                self._justified_balances = _active_balances(
                    balance_state, self.E, at_epoch=justified.epoch
                )
                self._justified_balances_stale = False
            else:
                self._justified_balances_stale = True
        if finalized.epoch > self.store.finalized_checkpoint.epoch:
            self.store.finalized_checkpoint = finalized
            self.proto.proto_array.maybe_prune(finalized.root)

    def _compute_unrealized_checkpoints(self, state):
        """Run justification on a throwaway copy to see what this chain tip
        would justify at the next boundary (compute_pulled_up_tip)."""
        from ..state_processing.per_epoch import (
            process_justification_and_finalization,
        )

        epoch = get_current_epoch(state, self.E)
        if epoch <= GENESIS_EPOCH + 1:
            return (
                Checkpoint(
                    state.current_justified_checkpoint.epoch,
                    state.current_justified_checkpoint.root,
                ),
                Checkpoint(
                    state.finalized_checkpoint.epoch,
                    state.finalized_checkpoint.root,
                ),
            )
        tmp = state.copy()
        process_justification_and_finalization(tmp, self.E)
        return (
            Checkpoint(
                tmp.current_justified_checkpoint.epoch,
                tmp.current_justified_checkpoint.root,
            ),
            Checkpoint(
                tmp.finalized_checkpoint.epoch, tmp.finalized_checkpoint.root
            ),
        )

    # ------------------------------------------------------------------ votes

    def on_attestation(self, indexed_attestation, is_from_block: bool = False):
        """Track latest messages (fork_choice.rs:1037)."""
        data = indexed_attestation.data
        if self._maybe_defer(indexed_attestation, is_from_block):
            return
        self._validate_on_attestation(data, is_from_block)
        for vi in indexed_attestation.attesting_indices:
            if vi not in self.store.equivocating_indices:
                self.proto.process_attestation(
                    vi, data.beacon_block_root, data.target.epoch
                )

    def on_attestation_batch(
        self, indexed_attestations, is_from_block: bool = False
    ) -> list:
        """Batch latest-message tracking for a drained gossip batch: each
        attestation is validated exactly like `on_attestation`, then the
        accepted ones are grouped by (head root, target epoch) and their
        attesting-index arrays (the columnar assembly —
        `attesting_indices` is a PersistentList whose `load_array` is one
        C-speed conversion) concatenate into ONE vectorized vote write per
        group instead of ~16k per-validator dict operations. Returns one
        entry per input: None on acceptance, the InvalidAttestation
        otherwise (callers treat fork-choice rejection as non-fatal,
        exactly like the scalar path's per-item try/except)."""
        groups: dict[tuple[bytes, int], list] = {}
        results: list = []
        for ia in indexed_attestations:
            # per-item guard, matching the scalar path's per-attestation
            # try/except: one malformed attestation must cost only its own
            # vote, never the rest of the batch
            try:
                data = ia.data
                if self._maybe_defer(ia, is_from_block):
                    results.append(None)
                    continue
                self._validate_on_attestation(data, is_from_block)
                indices = ia.attesting_indices
                arr = (
                    indices.load_array()
                    if hasattr(indices, "load_array")
                    else np.asarray(list(indices), dtype=np.uint64)
                )
            except Exception as e:  # noqa: BLE001 — per-item isolation
                results.append(
                    e
                    if isinstance(e, InvalidAttestation)
                    else InvalidAttestation(str(e))
                )
                continue
            results.append(None)
            groups.setdefault(
                (bytes(data.beacon_block_root), int(data.target.epoch)), []
            ).append(arr)
        equivocating = self.store.equivocating_indices
        eq_arr = None
        if equivocating:
            eq_arr = np.fromiter(
                equivocating, dtype=np.uint64, count=len(equivocating)
            )
        for (root, epoch), chunks in groups.items():
            try:
                v = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
                if eq_arr is not None:
                    v = v[~np.isin(v, eq_arr)]
                self.proto.process_attestation_batch(v, root, epoch)
            except Exception:  # noqa: BLE001 — a hard error in one
                continue  # (root, epoch) group must not drop the others
        return results

    def _maybe_defer(self, indexed_attestation, is_from_block: bool) -> bool:
        """Queue a gossip attestation from the store's current slot — or
        ahead of it, when the store lags the wall clock between ticks —
        for the tick that clears it, instead of rejecting it as "from
        the future" (fork_choice.rs queued_attestations): its committee
        saw the head this slot, and the next slot's proposer-boost
        re-org decision needs that weight. Upstream gossip validation
        already bounds data.slot by the wall clock, so the queue depth
        is one slot's traffic (plus the cap). Structural validation runs
        NOW (with `is_from_block=True`, which skips exactly the two
        gossip recency rules — one satisfied for any queueable slot, the
        other the reason we defer), so the queue only ever holds votes
        that will count. Returns True if the attestation was consumed
        (queued or cap-shed)."""
        if is_from_block:
            return False
        data = indexed_attestation.data
        if int(data.slot) < self.store.current_slot:
            return False
        self._validate_on_attestation(data, is_from_block=True)
        if len(self._deferred_attestations) >= _MAX_DEFERRED_ATTESTATIONS:
            _DEFERRED_ATTESTATIONS.inc(outcome="dropped")
            return True
        self._deferred_attestations.append(indexed_attestation)
        _DEFERRED_ATTESTATIONS.inc(outcome="deferred")
        return True

    def _validate_on_attestation(self, data, is_from_block: bool):
        # Recency applies to gossip only; attestations carried in blocks may
        # be arbitrarily old when syncing (spec validate_on_attestation).
        if not is_from_block:
            current_epoch = compute_epoch_at_slot(
                self.store.current_slot, self.E
            )
            if data.target.epoch not in (
                current_epoch,
                max(0, current_epoch - 1),
            ):
                raise InvalidAttestation(
                    f"target epoch {data.target.epoch} not current/previous"
                )
        if data.target.epoch != compute_epoch_at_slot(data.slot, self.E):
            raise InvalidAttestation("target epoch does not match slot")
        if not self.proto.contains_block(data.target.root):
            raise InvalidAttestation("unknown target root")
        if not self.proto.contains_block(data.beacon_block_root):
            raise InvalidAttestation("unknown head block")
        head_slot = self.proto.block_slot(data.beacon_block_root)
        if head_slot is not None and head_slot > data.slot:
            raise InvalidAttestation("attestation to a future block")
        # FFG/LMD consistency: the target must be the checkpoint block of the
        # head block's chain at target.epoch (spec validate_on_attestation;
        # fork_choice.rs target-root ancestor check).
        target_slot = compute_start_slot_at_epoch(data.target.epoch, self.E)
        checkpoint_block = self.proto.proto_array.ancestor_at_slot(
            data.beacon_block_root, target_slot
        )
        if checkpoint_block is None:
            raise UnknownAncestor(
                "head block's chain does not reach the target epoch in the "
                "proto-array (pre-finalization or pruned ancestor)"
            )
        if checkpoint_block != data.target.root:
            raise InvalidAttestation(
                "attestation target is inconsistent with the head block's "
                "chain at the target epoch"
            )
        if not is_from_block and self.store.current_slot < data.slot + 1:
            raise InvalidAttestation("attestation from the future")

    def on_equivocation(self, validator_indices):
        self.store.equivocating_indices.update(validator_indices)

    # ------------------------------------------------------------------ head

    def get_head(self, current_slot: int | None = None) -> bytes:
        """Recompute and return the canonical head root (fork_choice.rs:468)."""
        if current_slot is not None:
            self.on_tick(current_slot)
        if self._justified_balances_stale and self.state_provider is not None:
            jcp = self.store.justified_checkpoint
            balance_state = self.state_provider(jcp.root)
            if balance_state is not None:
                self._justified_balances = _active_balances(
                    balance_state, self.E, at_epoch=jcp.epoch
                )
                self._justified_balances_stale = False
        boost_amount = 0
        if self.store.proposer_boost_root != b"\x00" * 32:
            total = _total_balance(self._justified_balances)
            committee_weight = total // self.E.SLOTS_PER_EPOCH
            boost_amount = (
                committee_weight * self.spec.proposer_score_boost // 100
            )
        return self.proto.get_head(
            justified_checkpoint_root=self.store.justified_checkpoint.root,
            justified_epoch=self.store.justified_checkpoint.epoch,
            finalized_epoch=self.store.finalized_checkpoint.epoch,
            justified_state_balances=self._justified_balances,
            proposer_boost_root=self.store.proposer_boost_root,
            proposer_boost_amount=boost_amount,
            equivocating_indices=self.store.equivocating_indices,
            finalized_root=self.store.finalized_checkpoint.root,
        )

    def contains_block(self, root: bytes) -> bool:
        return self.proto.contains_block(root)

    def get_proposer_head(
        self, slot: int, head_root: bytes, head_late: bool
    ) -> bytes:
        """Spec `get_proposer_head` (proposer boost re-org): the root the
        proposer of `slot` should build on — the head's PARENT when the
        head is a weak, late, non-finality-risking, single-slot block the
        boosted re-org block would beat; otherwise the head itself.

        `head_late` is supplied by the caller (BlockTimesCache observed
        milestone vs the attestation deadline) — lateness is an
        observation-time property the fork-choice store never sees.
        Weights are read as left by the last `get_head` pass; callers run
        this right after a head recompute (every import triggers one), so
        they are at most one pending-attestation batch stale."""
        if not head_late:
            return head_root
        epoch = compute_epoch_at_slot(slot, self.E)
        max_epochs = self.spec.reorg_max_epochs_since_finalization
        if epoch - self.store.finalized_checkpoint.epoch > max_epochs:
            return head_root
        total = _total_balance(self._justified_balances)
        committee_weight = total // self.E.SLOTS_PER_EPOCH
        parent = self.proto.proto_array.get_proposer_head(
            slot,
            head_root,
            committee_weight,
            self.spec.reorg_head_weight_threshold,
            self.spec.reorg_parent_weight_threshold,
            self.E.SLOTS_PER_EPOCH,
        )
        return parent if parent is not None else head_root


def _total_balance(balances) -> int:
    return int(np.asarray(balances, dtype=np.uint64).sum(dtype=np.uint64))


def _active_balances(state, E, at_epoch: int | None = None):
    """Effective balances of active validators as a [n] uint64 array —
    one vectorized mask over the resident registry columns when the state
    carries them (the per-validator list comprehension was a 1M-element
    Python sweep on every justified-checkpoint change)."""
    from ..state_processing.accessors import _fresh_columns

    epoch = get_current_epoch(state, E) if at_epoch is None else at_epoch
    cols = _fresh_columns(state)
    if cols is not None:
        return np.where(
            cols.active_mask(epoch), cols.effective_balance, np.uint64(0)
        )
    return np.fromiter(
        (
            v.effective_balance
            if v.activation_epoch <= epoch < v.exit_epoch
            else 0
            for v in state.validators
        ),
        dtype=np.uint64,
        count=len(state.validators),
    )
