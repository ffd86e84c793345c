"""Chain-driving harness: interop genesis + block production/import.

Counterpart of lighthouse_tpu/testing/harness.py, copied.

The state-transition core of the reference's `BeaconChainHarness`
(beacon_node/beacon_chain/src/test_utils.rs:610): deterministic interop
keys, produce fully-attested blocks, apply them through the real
per-slot/per-block transition. The full BeaconChain wrapper (fork choice +
store) builds on this.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import bls
from ..state_processing import (
    BlockSignatureStrategy,
    ConsensusContext,
    get_beacon_proposer_index,
    interop_genesis_state,
    per_block_processing,
    per_slot_processing,
)
from ..state_processing.accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    get_beacon_committee,
    get_block_root_at_slot,
    get_current_epoch,
    get_domain,
)
from ..types.chain_spec import ChainSpec, Domain, compute_signing_root

HARNESS_GENESIS_TIME = 1_600_000_000
DEFAULT_ETH1_BLOCK_HASH = b"\x42" * 32


@dataclass
class SignedBlockAndState:
    block: object
    state: object
    root: bytes


class StateHarness:
    """Drives the bare state-transition (no store / fork choice): the
    minimum end-to-end slice of SURVEY.md §7."""

    def __init__(self, spec: ChainSpec, E, validator_count: int = 64):
        self.spec = spec
        self.E = E
        self.keypairs = bls.interop_keypairs(validator_count)
        self.state = interop_genesis_state(
            self.keypairs,
            HARNESS_GENESIS_TIME,
            DEFAULT_ETH1_BLOCK_HASH,
            spec,
            E,
        )
        self.genesis_state = self.state.copy()

    # -- signing helpers ----------------------------------------------------

    def _sign(self, validator_index: int, signing_root: bytes) -> bytes:
        return self.keypairs[validator_index].sk.sign(signing_root).to_bytes()

    def sign_block(self, block, proposer_index: int):
        t = self._types()
        domain = get_domain(
            self.state,
            Domain.BEACON_PROPOSER,
            compute_epoch_at_slot(block.slot, self.E),
            self.spec,
            self.E,
        )
        root = compute_signing_root(block.hash_tree_root(), domain)
        tf = t.types_for_fork(t.fork_of_block(block))
        return tf.SignedBeaconBlock(
            message=block, signature=self._sign(proposer_index, root)
        )

    def _randao_reveal(self, state, proposer_index: int, slot: int) -> bytes:
        epoch = compute_epoch_at_slot(slot, self.E)
        domain = get_domain(state, Domain.RANDAO, epoch, self.spec, self.E)
        root = compute_signing_root(
            epoch.to_bytes(8, "little").ljust(32, b"\x00"), domain
        )
        return self._sign(proposer_index, root)

    def _types(self):
        from ..types.containers import build_types

        return build_types(self.E)

    # -- attestations -------------------------------------------------------

    def produce_attestations(self, state, slot: int, head_root: bytes) -> list:
        """Fully-signed attestations from every committee of `slot` against
        the given head (state must be at `slot`)."""
        t = self._types()
        E = self.E
        epoch = compute_epoch_at_slot(slot, E)
        cc = committee_cache_at(state, epoch, E)
        target_root = (
            head_root
            if compute_start_slot_at_epoch(epoch, E) == slot
            else get_block_root_at_slot(
                state, compute_start_slot_at_epoch(epoch, E), E
            )
        )
        source = (
            state.current_justified_checkpoint
            if epoch == get_current_epoch(state, E)
            else state.previous_justified_checkpoint
        )
        domain = get_domain(state, Domain.BEACON_ATTESTER, epoch, self.spec, E)
        attestations = []
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
            attestations.append(
                t.Attestation(
                    aggregation_bits=[True] * len(committee),
                    data=data,
                    signature=agg.to_signature().to_bytes(),
                )
            )
        return attestations

    # -- block production / import ------------------------------------------

    def produce_block(self, slot: int, attestations: list) -> SignedBlockAndState:
        """Build, state-root-fill, and sign a block on the current head
        state; returns the post-state too (state not mutated)."""
        t = self._types()
        state = self.state.copy()
        while state.slot < slot:
            per_slot_processing(state, self.spec, self.E)
        # fork-aware container family (superstruct map_fork analog)
        tf = t.types_for_fork(t.fork_of_state(state))
        proposer = get_beacon_proposer_index(state, self.E)
        parent_root = state.latest_block_header.hash_tree_root()
        # latest_block_header.state_root was filled by process_slot
        body_kwargs = dict(
            randao_reveal=self._randao_reveal(state, proposer, slot),
            eth1_data=state.eth1_data,
            attestations=attestations,
        )
        if hasattr(tf.BeaconBlockBody, "_fields") and "sync_aggregate" in (
            tf.BeaconBlockBody._fields
        ):
            from ..beacon_chain.chain import empty_sync_aggregate

            body_kwargs["sync_aggregate"] = empty_sync_aggregate(t, self.E)
        body = tf.BeaconBlockBody(**body_kwargs)
        block = tf.BeaconBlock(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=b"\x00" * 32,
            body=body,
        )
        # Fill in the state root by dry-running the transition.
        post = state.copy()
        ctxt = ConsensusContext(slot)
        ctxt.set_proposer_index(proposer)
        signed_for_root = tf.SignedBeaconBlock(message=block)
        per_block_processing(
            post,
            signed_for_root,
            self.spec,
            self.E,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            ctxt=ctxt,
            verify_block_root=False,
        )
        block.state_root = post.hash_tree_root()
        signed = self.sign_block(block, proposer)
        return SignedBlockAndState(
            block=signed, state=post, root=block.hash_tree_root()
        )


    def process_block(
        self,
        signed_block,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ):
        """Import a signed block (full transition incl. state-root check).
        Applies to a copy and commits only on success, so a failed import
        leaves the harness untouched (test_utils.rs applies to clones)."""
        state = self.state.copy()
        while state.slot < signed_block.message.slot:
            per_slot_processing(state, self.spec, self.E)
        per_block_processing(
            state, signed_block, self.spec, self.E, strategy=strategy
        )
        self.state = state
        return signed_block.message.hash_tree_root()

    def head_block_root(self) -> bytes:
        """Root of the head block. latest_block_header.state_root is zeroed
        until the next process_slot, so fill it from the live state."""
        header = self.state.latest_block_header
        if header.state_root == b"\x00" * 32:
            t = self._types()
            header = t.BeaconBlockHeader(
                slot=header.slot,
                proposer_index=header.proposer_index,
                parent_root=header.parent_root,
                state_root=self.state.hash_tree_root(),
                body_root=header.body_root,
            )
        return header.hash_tree_root()

    def extend_chain(
        self,
        num_slots: int,
        attest: bool = True,
        strategy: BlockSignatureStrategy = BlockSignatureStrategy.VERIFY_BULK,
    ) -> list[bytes]:
        """Produce+import a block per slot, attesting at full participation
        (the add_attested_blocks_at_slots analog). Returns block roots."""
        roots = []
        for _ in range(num_slots):
            slot = self.state.slot + 1
            attestations = []
            if attest and self.state.slot >= 1:
                # attest to the head block at the previous slot
                attestations = self.produce_attestations(
                    self.state.copy(), self.state.slot, self.head_block_root()
                )
            produced = self.produce_block(slot, attestations)
            self.process_block(produced.block, strategy=strategy)
            roots.append(produced.root)
        return roots

    @property
    def finalized_epoch(self) -> int:
        return self.state.finalized_checkpoint.epoch

    @property
    def justified_epoch(self) -> int:
        return self.state.current_justified_checkpoint.epoch
