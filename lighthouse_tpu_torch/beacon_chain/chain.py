"""BeaconChain: the chain orchestrator.

Mirrors beacon_node/beacon_chain/src/beacon_chain.rs: the block import
pipeline (typestate progression GossipVerified → SignatureVerified →
fully-imported, block_verification.rs:21-45), attestation processing into
fork choice + op pool, canonical-head recomputation (canonical_head.rs:473),
block production (produce_block_on_state, beacon_chain.rs:4720), snapshot
cache, and finalization-driven pruning/migration (migrate.rs).

Counterpart of lighthouse_tpu/beacon_chain/chain.py. Its signature
batches (the block's bulk verify, the gossip attestation batches, a
segment's one batch) go through crypto.bls on the backend the default
device selects: `cuda` on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..fork_choice import ForkChoice
from ..state_processing import (
    BlockProcessingError,
    BlockSignatureStrategy,
    ConsensusContext,
    per_block_processing,
    per_slot_processing,
)
from ..state_processing import signature_sets as sigsets
from ..state_processing.accessors import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_beacon_proposer_index,
    get_current_epoch,
)
from ..store import HotColdDB
from ..store.migrator import BackgroundMigrator
from ..types.chain_spec import ChainSpec
from ..utils.slot_clock import SlotClock
from ..utils.tracing import span
from .attestation_verification import (
    AttestationError,
    AttestationVerifier,
    ObservedCache,
)
from .op_pool import OperationPool


class BlobsUnavailableError(ValueError):
    """Raised when a commitment-carrying block awaits its sidecars — an
    expected ordering race, distinct from genuine invalidity (gossip
    handlers must not penalize the forwarder for it)."""


class BlockError(ValueError):
    pass


class BeaconChainError(RuntimeError):
    pass


@dataclass
class GossipVerifiedBlock:
    """Typestate stage 1: header/proposer-signature checked
    (block_verification.rs:770-1027). Carries the advanced pre-state so the
    import stage doesn't recompute it (snapshot-cache handoff)."""

    signed_block: object
    block_root: bytes
    pre_state: object = None


@dataclass
class ChainSegmentResult:
    imported: int
    error: BlockError | None = None


class BeaconChain:
    def __init__(
        self,
        store: HotColdDB,
        genesis_state,
        spec: ChainSpec,
        E,
        slot_clock: SlotClock,
        execution_layer=None,
        kzg=None,
    ):
        from ..types.containers import build_types

        self.spec = spec
        self.E = E
        # Engine-API client (execution_layer/src/lib.rs); None = pre-merge /
        # consensus-only chain (payload checks fall back to the accept-all
        # NoOpExecutionEngine).
        self.execution_layer = execution_layer
        # Deneb data availability (data_availability_checker.rs): blocks
        # carrying blob commitments import only once their sidecars are
        # KZG-verified. kzg=None chains reject commitment-carrying blocks.
        from .data_availability import DataAvailabilityChecker

        self.data_availability_checker = DataAvailabilityChecker(kzg, E)
        self.types = build_types(E)
        self.store = store
        self.store.types = self.types
        self.slot_clock = slot_clock
        self.op_pool = OperationPool(spec, E)
        from .sync_pool import SyncCommitteeMessagePool

        self.sync_message_pool = SyncCommitteeMessagePool(E)
        self.observed_attesters = ObservedCache()
        self.observed_aggregators = ObservedCache()
        self.observed_block_producers = ObservedCache()
        self.attestation_verifier = AttestationVerifier(self)
        # auxiliary subsystems (SURVEY §5): SSE events, per-validator
        # monitoring, latency attribution, next-slot pre-advance, and the
        # blacklist fork_revert maintains
        from .block_times_cache import BlockTimesCache
        from .events import ServerSentEventHandler
        from .state_advance import StateAdvanceCache
        from .validator_monitor import ValidatorMonitor

        self.event_handler = ServerSentEventHandler()
        self.validator_monitor = ValidatorMonitor(E)
        self.block_times_cache = BlockTimesCache(
            slot_clock=slot_clock, seconds_per_slot=spec.seconds_per_slot
        )
        self.state_advance_cache = StateAdvanceCache()
        self.invalid_block_roots: set[bytes] = set()
        self._last_finalized_epoch_seen = 0
        # per-chain reorg accounting: the process-global counter can't
        # attribute a reorg to ONE node when a testnet fleet shares the
        # process, and /lighthouse/health's chain block (and the scenario
        # oracle's max-reorg-depth invariant) need exactly that attribution
        self.reorgs_total = 0
        self.max_reorg_depth = 0
        # prepare_beacon_proposer registrations: validator index → fee
        # recipient, consulted when building payload attributes
        self.proposer_preparations: dict[int, bytes] = {}
        # attached by SlasherService (slasher/service feeds off the
        # chain's verified objects); None = no slasher running
        self.slasher_service = None
        # attached by StateAdvanceTimer (state_advance.py) so the network
        # slot tick can drive the pre-advance; None = no timer running
        self.state_advance_timer = None
        # gossip reader threads, the VC, and sync all mutate the chain
        # concurrently; imports serialize on a loud-failure lock
        # (timeout_rw_lock.rs — starvation raises instead of deadlocking)
        from ..utils.timeout_lock import TimeoutRwLock

        self.import_lock = TimeoutRwLock("chain_import", timeout=30.0)

        # tree-states: registry-scale uint64 lists become persistent
        # (structurally-shared, block-hash-cached) for the whole chain
        # lineage — copies/upgrades preserve the type (milhouse analog)
        _make_persistent(genesis_state)

        genesis_root = _genesis_block_root(genesis_state, self.types)
        self.genesis_block_root = genesis_root
        self.genesis_validators_root = genesis_state.genesis_validators_root

        # snapshot cache: block_root -> post-state (the reference's
        # snapshot/state caches; bounded by pruning at finality)
        self._states: dict[bytes, object] = {genesis_root: genesis_state}
        self._blocks_by_root: dict[bytes, object] = {}
        self.head_root = genesis_root

        self.fork_choice = ForkChoice.from_anchor(
            genesis_root, genesis_state, spec, E
        )
        # Justified balances come from the actual justified state: snapshot
        # cache fast path, then the store / block-replay fallback — so the
        # tick-path checkpoint promotion can always materialize the justified
        # state instead of keeping stale weights.
        self.fork_choice.state_provider = self._justified_state_provider
        genesis_state_root = genesis_state.hash_tree_root()
        # the anchor block is synthetic for genesis boots (never stored),
        # so replay's base search needs this root→state mapping pinned
        self.genesis_state_root = bytes(genesis_state_root)
        store.put_state(genesis_state_root, genesis_state)
        # restart anchor: boot stamps the (genesis or checkpoint) anchor;
        # every migration cycle re-points it at the newest finalized
        store.set_anchor_info(
            int(genesis_state.slot), genesis_root, genesis_state_root
        )
        # finality-driven store lifecycle (store/migrator.py): hot→cold
        # migration, fork pruning, restore-point snapshots, DA retention.
        # Attaches itself as self.migrator; the client wires its
        # beacon_processor lane.
        BackgroundMigrator(self)

    @classmethod
    def from_checkpoint(
        cls,
        store: HotColdDB,
        anchor_state,
        anchor_block,
        spec: ChainSpec,
        E,
        slot_clock: SlotClock,
        wss_checkpoint: bytes | None = None,
        **kwargs,
    ) -> "BeaconChain":
        """Checkpoint (weak-subjectivity) start: anchor on a finalized
        state+block instead of genesis (ClientGenesis::WeakSubjSszBytes,
        beacon_node/src/config.rs:510-561). History before the anchor
        arrives later via backfill sync. `wss_checkpoint` pins the expected
        anchor block root (--wss-checkpoint verification)."""
        anchor_root = anchor_block.message.hash_tree_root()
        if wss_checkpoint is not None and anchor_root != wss_checkpoint:
            raise BeaconChainError(
                f"checkpoint mismatch: anchor {anchor_root.hex()} != "
                f"trusted {wss_checkpoint.hex()}"
            )
        if anchor_block.message.state_root != anchor_state.hash_tree_root():
            raise BeaconChainError("anchor block does not commit to anchor state")
        chain = cls(
            store=store,
            genesis_state=anchor_state,
            spec=spec,
            E=E,
            slot_clock=slot_clock,
            **kwargs,
        )
        chain._blocks_by_root[anchor_root] = anchor_block
        store.put_block(anchor_root, anchor_block)
        return chain

    @classmethod
    def from_store(
        cls,
        store: HotColdDB,
        spec: ChainSpec,
        E,
        slot_clock: SlotClock,
        **kwargs,
    ) -> "BeaconChain":
        """Restart from a persistent KV store (the kill→restart verb):
        re-anchor on the persisted watermark's finalized block+state, then
        re-import the surviving hot blocks oldest-first — signatures
        skipped, they were verified at first import — to rebuild fork
        choice and the snapshot cache. Range-sync/backfill watermarks live
        in the same store, so sync resumes where it stopped instead of
        re-downloading."""
        from ..types.containers import build_types

        if store.types is None:
            store.types = build_types(E)
        info = store.get_anchor_info()
        if info is None:
            raise BeaconChainError(
                "store has no anchor watermark — not a restartable layout"
            )
        anchor_slot, block_root, state_root = info
        anchor_block = store.get_block(block_root)
        anchor_state = store.get_state(state_root)
        if anchor_state is None:
            raise BeaconChainError(
                f"anchor {block_root.hex()[:8]} (slot {anchor_slot}) not "
                "retrievable from store"
            )
        if anchor_block is None:
            # a node killed before its first finality still restarts: the
            # genesis anchor's block is synthetic (derived from the state,
            # never stored), so boot the genesis way instead
            if anchor_slot != 0:
                raise BeaconChainError(
                    f"anchor block {block_root.hex()[:8]} (slot "
                    f"{anchor_slot}) not retrievable from store"
                )
            chain = cls(
                store=store,
                genesis_state=anchor_state,
                spec=spec,
                E=E,
                slot_clock=slot_clock,
                **kwargs,
            )
            anchor_block_slot = 0
        else:
            chain = cls.from_checkpoint(
                store, anchor_state, anchor_block, spec, E, slot_clock,
                **kwargs,
            )
            anchor_block_slot = int(anchor_block.message.slot)
        # parents must enter fork choice before children; parent-unknown
        # failures are tolerated (hot leftovers of forks whose ancestors
        # already migrated or were pruned)
        pending = [
            (root, blk)
            for root, blk in store.hot_blocks()
            if blk.message.slot > anchor_block_slot
        ]
        pending.sort(key=lambda e: int(e[1].message.slot))
        skip = {root for root, _ in pending}
        for _root, blk in pending:
            try:
                chain.process_block(blk, segment_verified_roots=skip)
            except (BlockError, BlobsUnavailableError):
                continue
        return chain

    @property
    def anchor_slot(self) -> int:
        """Slot of the chain's anchor (0 for genesis starts)."""
        anchor = self._blocks_by_root.get(self.genesis_block_root)
        if anchor is None:
            return 0
        return anchor.message.slot

    # ------------------------------------------------------------------ head

    @property
    def head_state(self):
        return self._states[self.head_root]

    def head_block(self):
        return self._blocks_by_root.get(self.head_root)

    def recompute_head(self):
        """canonical_head.rs:473 recompute_head_at_current_slot.

        If the new head's state fell out of the snapshot cache, reload it
        from the store instead of silently keeping the stale head."""
        new_head = self.fork_choice.get_head(self.slot_clock.now())
        if new_head != self.head_root:
            if new_head not in self._states:
                state = self._load_state_for_block(new_head)
                if state is None:
                    raise BeaconChainError(
                        f"fork choice head {new_head.hex()} has no state in "
                        "cache or store"
                    )
                self._states[new_head] = state
            old_head = self.head_root
            self.head_root = new_head
            # a pre-advance keyed off the old head can never be consumed
            # now; an entry keyed off the NEW head (re-org back, or the
            # advance raced the import) stays
            self.state_advance_cache.invalidate(new_head)
            self._register_head_events(old_head, new_head)
        self._register_finality_event()
        return self.head_root

    def _register_head_events(self, old_head: bytes, new_head: bytes):
        """SSE head + chain_reorg emission (canonical_head.rs's
        `detect_reorg` → events.rs). A reorg is a head move whose new head
        does not descend from the old head; depth = old head slot minus
        the common-ancestor slot."""
        state = self._states[new_head]
        self.block_times_cache.set_became_head(
            new_head, state.slot, time.monotonic()
        )
        # the head block already commits to its state root — never re-hash
        # the state just to fill the event
        head_block = self._blocks_by_root.get(new_head)
        state_root = (
            bytes(head_block.message.state_root)
            if head_block is not None
            else state.hash_tree_root()
        )
        self.event_handler.register_head(new_head, state.slot, state_root)
        old_block = self._blocks_by_root.get(old_head)
        if old_block is None:
            return
        # walk new head's ancestry down to the old head's slot
        r = new_head
        while True:
            blk = self._blocks_by_root.get(r)
            if blk is None or blk.message.slot <= old_block.message.slot:
                break
            r = bytes(blk.message.parent_root)
        if r != old_head:
            # old head is not an ancestor → reorg; find the common ancestor
            ancestors = set()
            a = old_head
            while a in self._blocks_by_root:
                ancestors.add(a)
                a = bytes(self._blocks_by_root[a].message.parent_root)
            b = new_head
            while b in self._blocks_by_root and b not in ancestors:
                b = bytes(self._blocks_by_root[b].message.parent_root)
            common_slot = (
                self._blocks_by_root[b].message.slot
                if b in self._blocks_by_root
                else self.anchor_slot
            )
            depth = old_block.message.slot - common_slot
            from ..metrics import inc_counter

            inc_counter("beacon_chain_reorgs_total")
            self.reorgs_total += 1
            self.max_reorg_depth = max(self.max_reorg_depth, int(depth))
            self.event_handler.register_reorg(
                old_head, new_head, state.slot, depth
            )

    def _register_finality_event(self):
        fin = self.finalized_checkpoint
        if fin.epoch > self._last_finalized_epoch_seen:
            self._last_finalized_epoch_seen = fin.epoch
            self.event_handler.register_finalized(fin)

    def state_for_block_root(self, block_root: bytes):
        """Post-state of a block: snapshot cache, then store / replay —
        the one cache-or-load combinator (API routes, justified-balance
        provider, and the light-client server all use it)."""
        state = self._states.get(bytes(block_root))
        if state is not None:
            return state
        return self._load_state_for_block(bytes(block_root))

    def _justified_state_provider(self, block_root: bytes):
        return self.state_for_block_root(block_root)

    def _load_state_for_block(self, block_root: bytes):
        """Fetch a block's post-state: hot/cold store by advertised state
        root, falling back to replaying blocks from the nearest ancestor
        whose state survives (the reference's BlockReplayer,
        state_processing/src/block_replayer.rs)."""
        signed = self._signed_block(block_root)
        if signed is None:
            return None
        state = self.store.get_state(signed.message.state_root)
        if state is None:
            if signed.message.slot < self.store.split_slot:
                # pre-split: restore-point snapshot + replay, memoized in
                # the migrator's bounded LRU (store/src/reconstruct.rs)
                state = self.migrator.reconstruct_state(block_root)
            else:
                state = self._replay_state(block_root)
        if state is not None:
            # SSZ deserialization yields plain lists — restore the
            # tree-states persistence for the lineage built from here
            _make_persistent(state)
        return state

    def _signed_block(self, block_root: bytes):
        blk = self._blocks_by_root.get(block_root)
        if blk is not None:
            return blk
        return self.store.get_block(block_root)

    def _replay_state(self, block_root: bytes):
        """Walk ancestors to the nearest retrievable state, then re-apply
        the intervening blocks (signatures already verified at first import;
        the state-root check re-anchors every replayed block)."""
        from ..state_processing.per_block import (
            BlockSignatureStrategy,
            per_block_processing,
        )

        chain = []
        r = block_root
        base = None
        while True:
            if r in self._states:
                base = self._states[r].copy()
                break
            signed = self._signed_block(r)
            if signed is None:
                # the anchor/genesis block is synthetic — no stored block
                # maps its root to a state root, but the boot pinned the
                # state itself (migration keeps a cold copy: slot 0 is
                # always a restore point)
                if r == self.genesis_block_root:
                    st = self.store.get_state(self.genesis_state_root)
                    if st is not None:
                        base = st.copy()
                        break
                return None
            st = self.store.get_state(signed.message.state_root)
            if st is not None:
                base = st.copy()
                break
            chain.append(signed)
            parent = signed.message.parent_root
            if parent == r:
                return None
            r = parent
        for signed in reversed(chain):
            block = signed.message
            while base.slot < block.slot:
                per_slot_processing(base, self.spec, self.E)
            per_block_processing(
                base,
                signed,
                self.spec,
                self.E,
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
                verify_block_root=True,
            )
        return base

    @property
    def finalized_checkpoint(self):
        return self.fork_choice.store.finalized_checkpoint

    @property
    def justified_checkpoint(self):
        return self.fork_choice.store.justified_checkpoint

    # ------------------------------------------------------------------ states

    def state_for_attestation_epoch(self, target_epoch: int):
        """A state whose committee caches cover `target_epoch` (shuffling
        cache role). Advances a copy of the head state if it lags."""
        state = self.head_state
        cur = get_current_epoch(state, self.E)
        if target_epoch <= cur + 1 and target_epoch >= max(0, cur - 1):
            return state
        if target_epoch > cur + 1:
            state = state.copy()
            target_slot = compute_start_slot_at_epoch(target_epoch, self.E)
            while state.slot < target_slot:
                per_slot_processing(state, self.spec, self.E)
            return state
        raise AttestationError(f"target epoch {target_epoch} too old for head")

    def state_at_block_root(self, block_root: bytes):
        return self._states.get(block_root)

    def _indexed_from(self, state, attestation, indices):
        return self.types.IndexedAttestation(
            attesting_indices=indices,
            data=attestation.data,
            signature=attestation.signature,
        )

    # ------------------------------------------------------------------ import

    def verify_block_for_gossip(self, signed_block) -> GossipVerifiedBlock:
        """Stage 1: structural + proposer-signature verification
        (GossipVerifiedBlock::new)."""
        block = signed_block.message
        block_root = block.hash_tree_root()
        current_slot = self.slot_clock.now()
        if block.slot > current_slot:
            raise BlockError(f"future block (slot {block.slot} > {current_slot})")
        if self.fork_choice.contains_block(block_root):
            raise BlockError("block already known")
        # first observation milestone: the gossip hop is where block
        # lateness originates, so stamp before any verification work
        self.block_times_cache.set_observed(
            block_root, block.slot, time.monotonic()
        )
        if not self.fork_choice.contains_block(block.parent_root):
            raise BlockError("parent unknown")
        finalized_slot = compute_start_slot_at_epoch(
            self.finalized_checkpoint.epoch, self.E
        )
        if block.slot <= finalized_slot:
            raise BlockError("block is prior to finalization")
        if self.observed_block_producers.is_known(block.slot, block.proposer_index):
            raise BlockError("proposer already produced a block at this slot")
        parent_state = self._pre_state_for(block)
        if not sigsets.block_proposal_signature_set(
            parent_state, signed_block, block_root, self.spec, self.E
        ).verify():
            raise BlockError("invalid proposer signature")
        self.observed_block_producers.observe(block.slot, block.proposer_index)
        self.block_times_cache.set_gossip_verified(
            block_root, block.slot, time.monotonic()
        )
        return GossipVerifiedBlock(
            signed_block=signed_block, block_root=block_root, pre_state=parent_state
        )

    def _pre_state_for(self, block):
        """Parent post-state advanced to the block's slot (the
        cheap_state_advance / catchup_state path)."""
        parent_state = self._states.get(block.parent_root)
        if parent_state is None:
            raise BlockError(f"no state for parent {block.parent_root.hex()[:16]}")
        # state_advance_timer fast path: the next-slot state was pre-built
        # (`get` hands out a CoW copy and keeps the entry — the proposer
        # and the import of its own block both hit one pre-advance)
        advanced = self.state_advance_cache.get(block.parent_root, block.slot)
        state = advanced if advanced is not None else parent_state.copy()
        while state.slot < block.slot:
            per_slot_processing(state, self.spec, self.E)
        return state

    def process_block(
        self,
        block_input,
        segment_verified_roots=None,
        precomputed_post_state=None,
    ) -> bytes:
        """Full import (beacon_chain.rs:3035 process_block → :3362
        import_block): state transition with bulk signature verification,
        store write, fork-choice registration (block + its attestations),
        head recompute. `segment_verified_roots` marks blocks whose
        signatures were already covered by a segment-wide batch;
        `precomputed_post_state` is the root-checked post-state from the
        segment replay (skips the second transition)."""
        from ..metrics import inc_counter, start_timer

        with self.import_lock.acquire_write():
            with start_timer("beacon_block_import_seconds"), span(
                "block_import"
            ):
                root = self._process_block_inner(
                    block_input,
                    segment_verified_roots or (),
                    precomputed_post_state,
                )
        inc_counter("beacon_blocks_imported_total")
        return root

    def _process_block_inner(
        self, block_input, segment_verified_roots=(), precomputed_post_state=None
    ) -> bytes:
        pre_state = None
        if isinstance(block_input, GossipVerifiedBlock):
            signed_block = block_input.signed_block
            block_root = block_input.block_root
            proposal_verified = True  # checked in verify_block_for_gossip
            pre_state = block_input.pre_state
        else:
            signed_block = block_input
            block_root = signed_block.message.hash_tree_root()
            proposal_verified = False
        block = signed_block.message

        if block_root in self.invalid_block_roots:
            raise BlockError("block was reverted as invalid (blacklisted)")
        if self.fork_choice.contains_block(block_root):
            return block_root  # idempotent
        if not self.fork_choice.contains_block(block.parent_root):
            raise BlockError("parent unknown")
        current_slot = self.slot_clock.now()
        if block.slot > current_slot:
            raise BlockError(
                f"future block: slot {block.slot} > clock {current_slot}"
            )
        # only plausibly-importable blocks enter the times cache — garbage
        # slots would poison its min-slot eviction
        self.block_times_cache.set_observed(
            block_root, block.slot, time.monotonic()
        )

        # Deneb availability gate (beacon_chain.rs → data_availability_checker):
        # commitment-carrying blocks need all sidecars KZG-verified first.
        commitments = getattr(block.body, "blob_kzg_commitments", None)
        imported_blobs = None
        imported_columns = None
        if commitments and not self.block_within_da_window(
            block.slot, current_slot
        ):
            # outside the retention window peers have pruned the sidecars;
            # the spec imports such blocks without the DA gate
            commitments = None
        if commitments:
            from .data_availability import (
                AvailabilityCheckError,
                MissingComponentsError,
            )

            try:
                avail = self.data_availability_checker.put_block(
                    block_root, signed_block, slot=current_slot
                )
            except MissingComponentsError as e:
                # IGNORE class: nothing proven invalid, the block is
                # staged — this forwarder must not be penalized
                raise BlobsUnavailableError(f"data availability: {e}") from e
            except AvailabilityCheckError as e:
                raise BlockError(f"data availability: {e}") from e
            if not avail.available:
                raise BlobsUnavailableError(
                    "blobs unavailable: feed sidecars via "
                    "process_blob_sidecars / process_data_column_sidecars"
                )
            imported_blobs = avail.blobs
            imported_columns = avail.columns

        def _milestone(name, _root=block_root, _slot=block.slot):
            self.block_times_cache.stamp(name, _root, _slot, time.monotonic())

        ctxt = ConsensusContext(block.slot)
        if (
            precomputed_post_state is not None
            and block_root in segment_verified_roots
        ):
            # segment path: signatures batch-verified, transition already
            # run (state root checked) and EL notified during the replay —
            # both pipeline milestones are behind us, stamp them now
            state = precomputed_post_state
            _milestone("signature_verified")
            _milestone("payload_verified")
        else:
            state = (
                pre_state if pre_state is not None else self._pre_state_for(block)
            )
            strategy = (
                BlockSignatureStrategy.NO_VERIFICATION
                if block_root in segment_verified_roots
                else BlockSignatureStrategy.VERIFY_BULK
            )
            try:
                with span("state_transition", slot=int(block.slot)):
                    per_block_processing(
                        state,
                        signed_block,
                        self.spec,
                        self.E,
                        strategy=strategy,
                        ctxt=ctxt,
                        block_root=block_root,
                        proposal_already_verified=proposal_verified,
                        execution_engine=self.execution_layer,
                        milestones=_milestone,
                    )
            except BlockProcessingError as e:
                raise BlockError(f"invalid block: {e}") from e

        # import_block: store + fork choice + head
        is_timely = (
            block.slot == current_slot
            and not self.slot_clock.is_past_attestation_deadline(block.slot)
        )
        with span("fork_choice_on_block"):
            self.fork_choice.on_block(
                current_slot, block, block_root, state, is_timely=is_timely
            )
        for att in block.body.attestations:
            try:
                indexed = ctxt.get_indexed_attestation(state, att, self.E)
            except Exception:
                continue  # unindexable in this context
            if self.slasher_service is not None:
                try:
                    self.slasher_service.observe_indexed_attestation(indexed)
                except Exception:  # noqa: BLE001 — slasher faults must not
                    pass  # cost fork choice its attestation weight
            try:
                self.fork_choice.on_attestation(indexed, is_from_block=True)
            except Exception:
                continue  # fork-choice-irrelevant attestations are skipped

        self.store.put_block(block_root, signed_block)
        self.store.put_state(block.state_root, state)
        if imported_blobs:
            # verified sidecars persist with the block so the node can
            # serve BlobSidecarsByRange/Root for the DA window
            self.store.put_blob_sidecars(block_root, imported_blobs)
        if imported_columns:
            # column route: persist the verified (or reconstructed-to-full)
            # column set for DataColumnsByRange/Root serving
            self.store.put_data_column_sidecars(block_root, imported_columns)
        self._states[block_root] = state
        self._blocks_by_root[block_root] = signed_block
        self.block_times_cache.set_imported(
            block_root, block.slot, time.monotonic()
        )
        self.event_handler.register_block(block_root, block.slot)
        if self.slasher_service is not None:
            self.slasher_service.observe_block(signed_block)
        self.validator_monitor.process_block(
            block, block.proposer_index, state, self.spec
        )
        # summarize epoch N only once N+1 has fully completed — attestations
        # from N's last slots are legitimately included early in N+1 (the
        # reference delays its per-epoch summaries a full epoch for this)
        completed_epoch = get_current_epoch(state, self.E) - 2
        if completed_epoch >= 0:
            self.validator_monitor.process_epoch_rollover(completed_epoch)

        self.recompute_head()
        self.op_pool.prune(self.head_state)
        if commitments:
            self.data_availability_checker.pop(block_root)
        # finality advance → migration cycle: queued on the MIGRATE_STORE
        # lane when a processor is wired, else inline under the import
        # write lock this path already holds
        self.migrator.on_finality()
        return block_root

    def process_chain_segment(self, blocks) -> ChainSegmentResult:
        """Range-sync import (beacon_chain.rs:2750): ONE bulk signature
        batch across every signature in every block of the segment
        (signature_verify_chain_segment, block_verification.rs:568), then
        sequential signature-free imports. A failed batch rejects the
        whole segment before anything touches fork choice."""
        blocks = list(blocks)
        verified_roots: set[bytes] = set()
        post_states: dict[bytes, object] = {}
        if len(blocks) > 1:
            try:
                verified_roots, post_states = (
                    self._signature_verify_chain_segment(blocks)
                )
            except BlockError as e:
                return ChainSegmentResult(imported=0, error=e)
        imported = 0
        for signed_block in blocks:
            try:
                root = signed_block.message.hash_tree_root()
                self.process_block(
                    signed_block,
                    segment_verified_roots=verified_roots,
                    precomputed_post_state=post_states.get(root),
                )
                imported += 1
            except BlockError as e:
                return ChainSegmentResult(imported=imported, error=e)
        return ChainSegmentResult(imported=imported)

    def _signature_verify_chain_segment(self, blocks) -> set[bytes]:
        """Collect every signature set across the segment against the
        correct per-block pre-states and verify them as ONE batch. The
        committee/proposer states are obtained by replaying the segment
        with NO_VERIFICATION (randao mixes from earlier segment blocks
        seed later blocks' committees, so slot-advance alone is not
        enough across epoch boundaries). The replayed post-states are kept
        and handed to the import loop, so each block's transition (and EL
        notify) runs exactly once. Returns (verified roots, post-states)."""
        from ..crypto import bls
        from ..state_processing.per_block import BlockSignatureVerifier

        first_parent = bytes(blocks[0].message.parent_root)
        # chain-state reads (fork choice, snapshot cache, store) race with
        # concurrent imports pruning at finality — hold the read lock
        with self.import_lock.acquire_read():
            if not self.fork_choice.contains_block(first_parent):
                raise BlockError("parent unknown")
            parent_state = self._states.get(
                first_parent
            ) or self._load_state_for_block(first_parent)
            if parent_state is None:
                raise BlockError("no state for segment parent")
            state = parent_state.copy()
        sets = []
        roots = set()
        post_states: dict[bytes, object] = {}
        for signed in blocks:
            block = signed.message
            if bytes(block.parent_root) not in roots | {first_parent}:
                raise BlockError("segment blocks are not a chain")
            while state.slot < block.slot:
                per_slot_processing(state, self.spec, self.E)
            block_root = block.hash_tree_root()
            ctxt = ConsensusContext(block.slot)
            verifier = BlockSignatureVerifier(state, self.spec, self.E)
            try:
                verifier.include_all_signatures(signed, block_root, ctxt)
            except (BlockProcessingError, IndexError, KeyError, ValueError) as e:
                raise BlockError(f"segment signature collection: {e}") from e
            sets.extend(verifier.sets)
            try:
                per_block_processing(
                    state,
                    signed,
                    self.spec,
                    self.E,
                    strategy=BlockSignatureStrategy.NO_VERIFICATION,
                    ctxt=ctxt,
                    execution_engine=self.execution_layer,
                )
            except BlockProcessingError as e:
                raise BlockError(f"invalid segment block: {e}") from e
            roots.add(block_root)
            post_states[block_root] = state.copy()
        if sets and not bls.verify_signature_sets(sets):
            raise BlockError("segment bulk signature verification failed")
        return roots, post_states

    # finality pruning/migration moved to store/migrator.py
    # (BackgroundMigrator._migrate_cycle), extended with restore-point
    # snapshots and availability-window accounting

    # ------------------------------------------------------------------ gossip attestations

    def process_attestation(self, attestation):
        """Verify a gossip attestation, feed fork choice + op pool."""
        verified = self.attestation_verifier.verify_unaggregated(attestation)
        with self.import_lock.acquire_write():
            self.apply_attestation_to_fork_choice(verified.indexed_attestation)
            self.op_pool.insert_attestation(attestation)
        self.event_handler.register_attestation(attestation)
        return verified

    def prepare_proposers(self, preparations: dict[int, bytes]):
        """prepare_beacon_proposer (http_api + preparation_service.rs):
        register fee recipients for upcoming proposals."""
        for vi, recipient in preparations.items():
            recipient = bytes(recipient)
            if len(recipient) != 20:
                raise ValueError(
                    f"fee recipient must be 20 bytes, got {len(recipient)}"
                )
            self.proposer_preparations[int(vi)] = recipient

    def _check_operation(self, process_fn, op, kind: str):
        """Gossip-time validation for pool-bound operations: run the spec
        processing (signatures included) against a throwaway copy of the
        head state — an op that can't apply there must not enter the pool,
        or the node would pack it and propose an invalid block
        (gossip_methods.rs verify_* before re-publish + pool insert)."""
        trial = self.head_state.copy()
        try:
            process_fn(trial, op, self.spec, self.E, verify_signatures=True)
        except BlockProcessingError as e:
            raise BlockError(f"invalid gossip {kind}: {e}") from e

    def process_voluntary_exit(self, signed_exit):
        from ..state_processing.per_block import process_voluntary_exit

        self._check_operation(process_voluntary_exit, signed_exit, "exit")
        with self.import_lock.acquire_write():
            self.op_pool.insert_voluntary_exit(signed_exit)

    def process_proposer_slashing(self, slashing):
        from ..state_processing.per_block import process_proposer_slashing

        self._check_operation(
            process_proposer_slashing, slashing, "proposer slashing"
        )
        with self.import_lock.acquire_write():
            self.op_pool.insert_proposer_slashing(slashing)

    def process_attester_slashing(self, slashing):
        from ..state_processing.per_block import process_attester_slashing

        self._check_operation(
            process_attester_slashing, slashing, "attester slashing"
        )
        with self.import_lock.acquire_write():
            self.op_pool.insert_attester_slashing(slashing)

    def da_window_slots(self) -> int:
        return (
            getattr(self.spec, "min_epochs_for_blob_sidecars_requests", 4096)
            * self.E.SLOTS_PER_EPOCH
        )

    def block_within_da_window(self, block_slot: int, current_slot: int) -> bool:
        """deneb fork-choice: blob availability is only required inside
        the sidecar retention window."""
        return int(block_slot) >= int(current_slot) - self.da_window_slots()

    def get_aggregated_attestation(self, data):
        """Pool aggregate for an AttestationData (the
        /eth/v1/validator/aggregate_attestation surface)."""
        return self.op_pool.get_aggregate(data.hash_tree_root())

    def process_sync_committee_message(self, message):
        """Verify a gossip SyncCommitteeMessage against the current sync
        committee and pool it for the next block's SyncAggregate."""
        from .sync_pool import verify_sync_committee_message

        positions = verify_sync_committee_message(self, message)
        with self.import_lock.acquire_write():
            for pos in positions:
                self.sync_message_pool.insert(
                    int(message.slot),
                    bytes(message.beacon_block_root),
                    pos,
                    bytes(message.signature),
                )
            self.sync_message_pool.prune(self.slot_clock.now())
        return positions

    def process_blob_sidecars(
        self, block_root: bytes, sidecars: list, verify_header_signature=True
    ):
        """KZG-verify and stage blob sidecars for a block (gossip/RPC blobs
        path → data_availability_checker.put_blobs). On the gossip path
        the sidecar header's proposer signature is verified first —
        without it anyone could flood the pending dict with
        self-consistent KZG data under fabricated headers. Sync passes
        verify_header_signature=False: its blocks may be ahead of our
        head (unknown proposers / later forks) and the segment batch
        verifies the block signatures itself."""
        from .data_availability import (
            AvailabilityCheckError,
            MissingComponentsError,
        )

        self._verify_sidecar_headers(sidecars, verify_header_signature, "blob")
        try:
            return self.data_availability_checker.put_blobs(
                block_root, sidecars, slot=self.slot_clock.now()
            )
        except MissingComponentsError as e:
            # IGNORE class (spec): nothing proven invalid — the forwarder
            # must not be penalized for locally missing prerequisites
            raise BlobsUnavailableError(f"blob sidecars pending: {e}") from e
        except AvailabilityCheckError as e:
            raise BlockError(f"blob sidecars rejected: {e}") from e

    def _verify_sidecar_headers(
        self, sidecars: list, verify_header_signature: bool, kind: str
    ) -> None:
        """Gossip-path proposer-signature gate shared by blob and column
        sidecars — without it anyone could flood the pending dict with
        self-consistent KZG data under fabricated headers."""
        if not verify_header_signature:
            return
        for sc in sidecars:
            header = getattr(sc, "signed_block_header", None)
            if header is None:
                continue
            try:
                ok = sigsets.block_header_signature_set(
                    self.head_state, header, self.spec, self.E
                ).verify()
            except (IndexError, KeyError, ValueError) as e:
                raise BlockError(f"{kind} sidecar header malformed: {e}") from e
            if not ok:
                raise BlockError(f"{kind} sidecar header signature invalid")

    def process_data_column_sidecars(
        self, block_root: bytes, sidecars: list, verify_header_signature=True
    ):
        """KZG-verify and stage data-column sidecars for a block (PeerDAS
        gossip/RPC columns path → data_availability_checker.put_columns).
        Error taxonomy mirrors process_blob_sidecars: proven-invalid cells
        raise BlockError (gossip REJECT); locally missing prerequisites
        raise BlobsUnavailableError (gossip IGNORE)."""
        from .data_availability import (
            AvailabilityCheckError,
            MissingComponentsError,
        )

        self._verify_sidecar_headers(sidecars, verify_header_signature, "column")
        try:
            return self.data_availability_checker.put_columns(
                block_root, sidecars, slot=self.slot_clock.now()
            )
        except MissingComponentsError as e:
            raise BlobsUnavailableError(f"data columns pending: {e}") from e
        except AvailabilityCheckError as e:
            raise BlockError(f"data column sidecars rejected: {e}") from e

    def process_segment_blob_sidecars(self, by_root: dict) -> dict:
        """Segment-wide blob KZG coalescing (range sync): ONE
        verify_blob_kzg_proof_batch RLC across every sidecar of every
        block in the segment, instead of one pairing batch per block. On
        failure the per-BLOCK groups are bisected so the offending block
        is attributed exactly (log2(blocks) extra batch calls, only on the
        failure path). Returns {block_root: None | AvailabilityCheckError};
        clean groups are staged in the DA checker pre-verified."""
        from .data_availability import (
            AvailabilityCheckError,
            InvalidComponentsError,
        )

        results: dict = {}
        groups = []
        for root, scs in by_root.items():
            try:
                # structural + binding checks now; KZG deferred to the
                # segment-wide batch below
                self.data_availability_checker.verify_blob_sidecars(
                    scs, root, skip_kzg=True
                )
                groups.append((root, list(scs)))
            except AvailabilityCheckError as e:
                results[root] = e
        bad_roots = self._bisect_segment_kzg(groups)
        now = self.slot_clock.now()
        for root, scs in groups:
            if root in bad_roots:
                results[root] = InvalidComponentsError(
                    "blob KZG batch verification failed"
                )
                continue
            try:
                self.data_availability_checker.put_blobs(
                    root, scs, slot=now, pre_verified=True
                )
                results[root] = None
            except AvailabilityCheckError as e:
                results[root] = e
        return results

    def _bisect_segment_kzg(self, groups: list) -> set:
        """Roots whose sidecars fail KZG, found by batch-then-bisect: the
        whole segment is one RLC when clean (the common case); a failing
        batch splits on block boundaries until each failure is pinned."""
        kzg = self.data_availability_checker.kzg
        if not groups or kzg is None:
            return set()

        def batch_ok(gs) -> bool:
            blobs, commitments, proofs = [], [], []
            for _root, scs in gs:
                for sc in scs:
                    blobs.append(bytes(sc.blob))
                    commitments.append(bytes(sc.kzg_commitment))
                    proofs.append(bytes(sc.kzg_proof))
            return kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs)

        def bisect(gs) -> set:
            if not gs or batch_ok(gs):
                return set()
            if len(gs) == 1:
                return {gs[0][0]}
            mid = len(gs) // 2
            return bisect(gs[:mid]) | bisect(gs[mid:])

        return bisect(groups)

    def process_attestation_batch(self, attestations) -> list:
        # root span of the gossip-attestation hot path (OBSERVABILITY.md
        # taxonomy): verification + fork-choice application as one trace
        with span("attestation_batch", n=len(attestations)):
            results = self.attestation_verifier.batch_verify_unaggregated(
                attestations
            )
            with self.import_lock.acquire_write():
                accepted = [
                    (att, res)
                    for att, res in zip(attestations, results)
                    if not isinstance(res, Exception)
                ]
                if accepted:
                    if self.slasher_service is not None:
                        # one call for the drained batch: the columnar
                        # slasher consumes its queue as one array program
                        self.slasher_service.observe_indexed_attestations(
                            [res.indexed_attestation for _a, res in accepted]
                        )
                    # one vectorized vote write per (head root, target
                    # epoch) group instead of a per-validator dict walk;
                    # fork-choice rejection of individual attestations is
                    # non-fatal, exactly like the old per-item try/except
                    try:
                        self.fork_choice.on_attestation_batch(
                            [res.indexed_attestation for _a, res in accepted]
                        )
                    except Exception:
                        pass  # unviable targets are skipped, not fatal
                    for att, _res in accepted:
                        self.op_pool.insert_attestation(att)
        return results

    def process_aggregate(self, signed_aggregate):
        verified = self.attestation_verifier.verify_aggregated(signed_aggregate)
        with self.import_lock.acquire_write():
            self.apply_attestation_to_fork_choice(verified.indexed_attestation)
            self.op_pool.insert_attestation(
                signed_aggregate.message.aggregate
            )
        return verified

    def apply_attestation_to_fork_choice(self, indexed):
        if self.slasher_service is not None:
            self.slasher_service.observe_indexed_attestation(indexed)
        try:
            self.fork_choice.on_attestation(indexed, is_from_block=False)
        except Exception:
            pass  # gossip attestations may be for unviable targets

    # ------------------------------------------------------------------ production

    def get_proposer_head(self, slot: int) -> bytes:
        """The root the proposer of `slot` should build on: the head, or
        the head's PARENT when the head is a weak, late, single-slot
        block the boosted re-org block would beat (spec
        `get_proposer_head`). Fork choice owns the weight/structure
        conditions; this layer supplies the observation-time ones —
        whether the head arrived past the attestation deadline
        (BlockTimesCache `observed` milestone; a locally-produced head
        has no gossip observation and is never re-orged), and whether
        the proposal itself is early enough in the slot to win its own
        boost (the reference's re-org cutoff, half the deadline)."""
        head_root = self.head_root
        if (
            self.slot_clock.now() == slot
            and self.slot_clock.seconds_into_slot()
            > self.slot_clock.attestation_deadline_offset / 2
        ):
            return head_root
        times = self.block_times_cache.get(head_root)
        observed = (
            times.slot_offsets.get("observed") if times is not None else None
        )
        head_late = (
            observed is not None
            and observed > self.slot_clock.attestation_deadline_offset
        )
        if head_late:
            # A late head usually means its slot's committee attested to
            # the PARENT — same-slot gossip votes that sat in the
            # fork-choice deferral queue until this slot's tick. Refresh
            # (tick + drain + head recompute) so the re-org decision
            # reads post-drain weights; the timely path skips the
            # recompute and stays cheap.
            self.recompute_head()
            if self.head_root != head_root:
                # the drained votes already re-orged the head on their
                # own — build on the new head, no boost gamble needed
                return self.head_root
        return self.fork_choice.get_proposer_head(slot, head_root, head_late)

    def produce_block_on_state(
        self,
        slot: int,
        randao_reveal: bytes,
        graffiti: bytes = b"\x00" * 32,
        sync_aggregate_fn=None,
    ):
        """Unsigned block for `slot` (beacon_chain.rs:4137,4720): picks
        the build target via `get_proposer_head` (head, or its parent on
        a late-block re-org), consumes the state_advance pre-built
        snapshot when one matches, packs the op pool, computes the state
        root. Fork-aware: builds the block variant the advanced state
        requires (sync aggregate from `sync_aggregate_fn(state)` or
        empty, payload with the expected withdrawals sweep).

        Stages ride the `block_production` trace root — `advance`
        (target choice + snapshot/advance), `pack` (op-pool), `assemble`
        (payload + state root). If an enclosing block_production root is
        already open (the VC wraps produce+sign in one trace), the
        stages nest under it instead of minting a second root.
        Returns (block, post_state)."""
        import contextlib

        from ..types.chain_spec import ForkName
        from ..utils.tracing import current_span

        enclosing = current_span()
        root_cm = (
            contextlib.nullcontext()
            if enclosing is not None
            and enclosing.root_name == "block_production"
            else span("block_production", slot=int(slot))
        )
        with root_cm:
            with span("advance"):
                parent_root = self.get_proposer_head(slot)
                # state_advance_timer fast path: the next-slot state was
                # pre-built off this exact target (CoW copy, entry kept
                # for the import of our own block)
                state = self.state_advance_cache.get(parent_root, slot)
                if state is None:
                    base = self._states.get(parent_root)
                    if base is None:
                        # re-org target without a cached state — build on
                        # the head rather than fail the proposal
                        parent_root = self.head_root
                        base = self.head_state
                    state = base.copy()
                while state.slot < slot:
                    per_slot_processing(state, self.spec, self.E)
            fork = self.types.fork_of_state(state)
            tf = self.types.types_for_fork(fork)
            with span("pack"):
                proposer = get_beacon_proposer_index(state, self.E)
                attestations = self.op_pool.get_attestations_for_block(state)
                proposer_slashings, attester_slashings, exits = (
                    self.op_pool.get_slashings_and_exits(state)
                )
                body_kwargs = dict(
                    randao_reveal=randao_reveal,
                    eth1_data=state.eth1_data,
                    graffiti=graffiti,
                    proposer_slashings=proposer_slashings,
                    attester_slashings=attester_slashings,
                    attestations=attestations,
                    voluntary_exits=exits,
                )
                if fork >= ForkName.ALTAIR:
                    if sync_aggregate_fn is not None:
                        body_kwargs["sync_aggregate"] = sync_aggregate_fn(
                            state
                        )
                    elif self.sync_message_pool is not None:
                        # messages signed at slot-1 over the build target
                        # pack into this block (altair/validator.md
                        # inclusion rule)
                        body_kwargs["sync_aggregate"] = (
                            self.sync_message_pool.aggregate_for(
                                self.types, self.E, slot - 1, parent_root
                            )
                        )
            with span("assemble"):
                if fork >= ForkName.BELLATRIX:
                    payload = self._produce_payload(
                        state, fork, tf, parent_root
                    )
                    body_kwargs["execution_payload"] = payload
                block = tf.BeaconBlock(
                    slot=slot,
                    proposer_index=proposer,
                    parent_root=parent_root,
                    state_root=b"\x00" * 32,
                    body=tf.BeaconBlockBody(**body_kwargs),
                )
                post = state.copy()
                ctxt = ConsensusContext(slot)
                ctxt.set_proposer_index(proposer)
                per_block_processing(
                    post,
                    tf.SignedBeaconBlock(message=block),
                    self.spec,
                    self.E,
                    strategy=BlockSignatureStrategy.NO_VERIFICATION,
                    ctxt=ctxt,
                    verify_block_root=False,
                )
                block.state_root = post.hash_tree_root()
        return block, post

    def _produce_payload(self, state, fork, tf, parent_beacon_block_root=None):
        """Execution payload for block production (beacon_chain.rs get
        execution payload → execution_layer get_payload, lib.rs:807).

        Pre-merge with no execution layer: the default (execution-disabled)
        payload — no withdrawals advertised since process_execution_payload
        never runs on it. With an execution layer: a real payload built on
        the head, carrying the expected withdrawals sweep for Capella+."""
        from ..execution_layer import PayloadAttributes
        from ..state_processing.bellatrix import (
            compute_timestamp_at_slot,
            is_merge_transition_complete,
        )
        from ..state_processing.accessors import get_randao_mix
        from ..types.chain_spec import ForkName

        merged = is_merge_transition_complete(state)
        if self.execution_layer is None:
            if merged:
                raise BlockError(
                    "post-merge payload production requires an execution "
                    "layer (get_payload) — wire chain.execution_layer"
                )
            return tf.ExecutionPayload()

        withdrawals = []
        if fork >= ForkName.ELECTRA:
            from ..state_processing.electra import get_expected_withdrawals_electra

            withdrawals, _ = get_expected_withdrawals_electra(
                state, self.spec, self.E
            )
        elif fork >= ForkName.CAPELLA:
            from ..state_processing.capella import get_expected_withdrawals

            withdrawals = get_expected_withdrawals(state, self.E)
        attributes = PayloadAttributes(
            timestamp=compute_timestamp_at_slot(state, self.spec, self.E),
            prev_randao=get_randao_mix(
                state, get_current_epoch(state, self.E), self.E
            ),
            withdrawals=withdrawals,
            suggested_fee_recipient=self.proposer_preparations.get(
                get_beacon_proposer_index(state, self.E), b"\x00" * 20
            ),
            # EIP-4788: Deneb+ execution headers commit to the parent
            # beacon block root, so the payload needs it for the hash
            parent_beacon_block_root=parent_beacon_block_root,
        )
        # Post-merge (and Capella+, whose spec asserts the parent link
        # unconditionally): build exactly on the state's execution header.
        # Bellatrix pre-merge: None = let the EL choose the terminal block.
        if merged or fork >= ForkName.CAPELLA:
            parent_hash = state.latest_execution_payload_header.block_hash
        else:
            parent_hash = None
        return self.execution_layer.get_payload(parent_hash, attributes, fork)


def _make_persistent(state):
    """Swap registry-scale list fields to persistent (structurally-shared)
    lists in place — the tree-states backbone (beacon_state.rs:34,371)."""
    from ..ssz.persistent import (
        PersistentByteList,
        PersistentContainerList,
        PersistentList,
    )

    for fname in ("balances", "inactivity_scores"):
        v = getattr(state, fname, None)
        if isinstance(v, list):
            object.__setattr__(state, fname, PersistentList(v))
    for fname in (
        "previous_epoch_participation",
        "current_epoch_participation",
    ):
        v = getattr(state, fname, None)
        if isinstance(v, bytearray):
            object.__setattr__(state, fname, PersistentByteList(v))
    v = getattr(state, "validators", None)
    if isinstance(v, list):
        object.__setattr__(state, "validators", PersistentContainerList(v))


def empty_sync_aggregate(types, E):
    """No-participation sync aggregate: all-zero bits + the G2 infinity
    signature (required by eth_fast_aggregate_verify's empty rule)."""
    from ..crypto import bls

    return types.SyncAggregate(
        sync_committee_bits=[False] * E.SYNC_COMMITTEE_SIZE,
        sync_committee_signature=bls.INFINITY_SIGNATURE,
    )


def _genesis_block_root(genesis_state, types) -> bytes:
    """Root of the implicit genesis block (header over the genesis state)."""
    header = genesis_state.latest_block_header
    filled = types.BeaconBlockHeader(
        slot=header.slot,
        proposer_index=header.proposer_index,
        parent_root=header.parent_root,
        state_root=genesis_state.hash_tree_root(),
        body_root=header.body_root,
    )
    return filled.hash_tree_root()
