"""BeaconChainHarness: the full-chain test rig.

Mirrors beacon_node/beacon_chain/src/test_utils.rs:610: MemoryStore,
ManualSlotClock, deterministic interop keypairs, helpers to produce signed
blocks/attestations and drive the chain through epochs — the primary dev
rig for everything above the state transition.
"""

from __future__ import annotations

from ..crypto import bls
from ..state_processing import interop_genesis_state
from ..state_processing.accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_block_root_at_slot,
    get_current_epoch,
    get_domain,
)
from ..store import HotColdDB, MemoryStore
from ..types.chain_spec import ChainSpec, Domain, compute_signing_root
from ..utils.slot_clock import ManualSlotClock
from .chain import BeaconChain

HARNESS_GENESIS_TIME = 1_600_000_000


class BeaconChainHarness:
    def __init__(
        self,
        spec: ChainSpec,
        E,
        validator_count: int = 64,
        store: HotColdDB | None = None,
        execution_layer=None,
        mock_execution_layer: bool = False,
        genesis_modifier=None,
    ):
        self.spec = spec
        self.E = E
        self.keypairs = bls.interop_keypairs(validator_count)
        genesis_state = interop_genesis_state(
            self.keypairs, HARNESS_GENESIS_TIME, b"\x42" * 32, spec, E
        )
        if genesis_modifier is not None:
            # pre-chain genesis customization (credentials, balances, …);
            # roots are computed after, so the modified state IS genesis.
            genesis_modifier(genesis_state)
        self.slot_clock = ManualSlotClock(
            genesis_time=HARNESS_GENESIS_TIME,
            seconds_per_slot=spec.seconds_per_slot,
        )
        if mock_execution_layer and execution_layer is None:
            from ..execution_layer import MockExecutionLayer
            from ..types.containers import build_types

            execution_layer = MockExecutionLayer(build_types(E), E)
        self.chain = BeaconChain(
            store=store if store is not None else HotColdDB(MemoryStore()),
            genesis_state=genesis_state,
            spec=spec,
            E=E,
            slot_clock=self.slot_clock,
            execution_layer=execution_layer,
        )

    # -- signing ------------------------------------------------------------

    def _sign(self, validator_index: int, root: bytes) -> bytes:
        return self.keypairs[validator_index].sk.sign(root).to_bytes()

    def sign_block(self, block, state=None):
        """`state` must share the block's fork (pass the advanced proposer
        state at fork-boundary slots — the domain draws on state.fork)."""
        state = state if state is not None else self.chain.head_state
        t = self.chain.types
        fork = t.fork_of_block(block)
        domain = get_domain(
            state,
            Domain.BEACON_PROPOSER,
            compute_epoch_at_slot(block.slot, self.E),
            self.spec,
            self.E,
        )
        root = compute_signing_root(block.hash_tree_root(), domain)
        return t.types_for_fork(fork).SignedBeaconBlock(
            message=block, signature=self._sign(block.proposer_index, root)
        )

    def randao_reveal(self, proposer_index: int, slot: int, state=None) -> bytes:
        state = state if state is not None else self.chain.head_state
        epoch = compute_epoch_at_slot(slot, self.E)
        domain = get_domain(state, Domain.RANDAO, epoch, self.spec, self.E)
        root = compute_signing_root(
            epoch.to_bytes(8, "little").ljust(32, b"\x00"), domain
        )
        return self._sign(proposer_index, root)

    def make_sync_aggregate(self, state, slot: int, parent_root: bytes):
        """Full-participation sync aggregate: every committee member we hold
        keys for signs the previous slot's block root
        (altair/validator.md sync committee duties)."""
        from ..crypto import bls
        from .chain import empty_sync_aggregate

        t = self.chain.types
        committee = list(state.current_sync_committee.pubkeys)
        by_pubkey = {
            kp.pk.to_bytes(): i for i, kp in enumerate(self.keypairs)
        }
        previous_slot = max(slot, 1) - 1
        domain = get_domain(
            state,
            Domain.SYNC_COMMITTEE,
            compute_epoch_at_slot(previous_slot, self.E),
            self.spec,
            self.E,
        )
        message = compute_signing_root(parent_root, domain)
        bits, sigs = [], []
        for pk in committee:
            vi = by_pubkey.get(bytes(pk))
            if vi is None:
                bits.append(False)
                continue
            bits.append(True)
            sigs.append(self.keypairs[vi].sk.sign(message))
        if not sigs:
            return empty_sync_aggregate(t, self.E)
        aggregate = bls.AggregateSignature.from_signatures(sigs).to_signature()
        return t.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=aggregate.to_bytes(),
        )

    # -- attestations -------------------------------------------------------

    def make_attestations(self, slot: int, head_root: bytes) -> list:
        """Signed aggregate attestations from every committee at `slot`
        voting for `head_root`."""
        chain = self.chain
        E = self.E
        t = chain.types
        state = chain.state_for_attestation_epoch(compute_epoch_at_slot(slot, E))
        if state.slot < slot:
            state = state.copy()
            from ..state_processing import per_slot_processing

            while state.slot < slot:
                per_slot_processing(state, self.spec, E)
        epoch = compute_epoch_at_slot(slot, E)
        cc = committee_cache_at(state, epoch, E)
        epoch_start = compute_start_slot_at_epoch(epoch, E)
        target_root = (
            head_root
            if epoch_start == slot or state.slot <= epoch_start
            else get_block_root_at_slot(state, epoch_start, E)
        )
        source = (
            state.current_justified_checkpoint
            if epoch == get_current_epoch(state, E)
            else state.previous_justified_checkpoint
        )
        domain = get_domain(state, Domain.BEACON_ATTESTER, epoch, self.spec, E)
        out = []
        for index in range(cc.committees_per_slot):
            committee = cc.committee(slot, index)
            data = t.AttestationData(
                slot=slot,
                index=index,
                beacon_block_root=head_root,
                source=source,
                target=t.Checkpoint(epoch=epoch, root=target_root),
            )
            signing_root = compute_signing_root(data.hash_tree_root(), domain)
            agg = bls.AggregateSignature.from_signatures(
                [self.keypairs[v].sk.sign(signing_root) for v in committee]
            )
            out.append(
                t.Attestation(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=agg.to_signature().to_bytes(),
                )
            )
        return out

    def make_unaggregated_attestations(self, slot: int, head_root: bytes) -> list:
        """One single-bit attestation per committee member (gossip shape)."""
        full = self.make_attestations(slot, head_root)
        chain = self.chain
        t = chain.types
        state = chain.state_for_attestation_epoch(
            compute_epoch_at_slot(slot, self.E)
        )
        cc = committee_cache_at(state, compute_epoch_at_slot(slot, self.E), self.E)
        domain = get_domain(
            state,
            Domain.BEACON_ATTESTER,
            compute_epoch_at_slot(slot, self.E),
            self.spec,
            self.E,
        )
        out = []
        for agg in full:
            committee = cc.committee(slot, agg.data.index)
            signing_root = compute_signing_root(
                agg.data.hash_tree_root(), domain
            )
            for pos, vi in enumerate(committee):
                bits = [False] * len(committee)
                bits[pos] = True
                out.append(
                    t.Attestation(
                        aggregation_bits=bits,
                        data=agg.data,
                        signature=self._sign(vi, signing_root),
                    )
                )
        return out

    # -- driving ------------------------------------------------------------

    def add_block_at_slot(self, slot: int):
        """Produce, sign and import a block at `slot` on the head."""
        self.slot_clock.set_slot(slot)
        state = self.chain.head_state
        proposer_state = state.copy()
        from ..state_processing import per_slot_processing

        while proposer_state.slot < slot:
            per_slot_processing(proposer_state, self.spec, self.E)
        from ..state_processing.accessors import get_beacon_proposer_index

        proposer = get_beacon_proposer_index(proposer_state, self.E)
        parent_root = self.chain.head_root
        block, _post = self.chain.produce_block_on_state(
            slot,
            self.randao_reveal(proposer, slot, proposer_state),
            sync_aggregate_fn=lambda st: self.make_sync_aggregate(
                st, slot, parent_root
            ),
        )
        signed = self.sign_block(block, proposer_state)
        root = self.chain.process_block(signed)
        return root, signed

    def attest_to_head(self, slot: int):
        """Submit gossip attestations for the current head at `slot`."""
        self.slot_clock.set_slot(max(self.slot_clock.now(), slot))
        atts = self.make_unaggregated_attestations(slot, self.chain.head_root)
        return self.chain.process_attestation_batch(atts)

    def extend_chain(self, num_slots: int, attest: bool = True):
        """One block per slot, attesting to each new head — the
        add_attested_blocks_at_slots analog."""
        roots = []
        for _ in range(num_slots):
            slot = self.chain.head_state.slot + 1
            root, _ = self.add_block_at_slot(slot)
            roots.append(root)
            if attest:
                self.attest_to_head(slot)
        return roots

    @property
    def finalized_epoch(self) -> int:
        return self.chain.finalized_checkpoint.epoch

    @property
    def justified_epoch(self) -> int:
        return self.chain.justified_checkpoint.epoch
