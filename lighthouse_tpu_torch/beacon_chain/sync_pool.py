"""Naive aggregation pool for sync-committee messages.

The beacon_chain naive_aggregation_pool / sync-contribution side: gossip
`SyncCommitteeMessage`s are verified against the state's current sync
committee, pooled per (slot, beacon_block_root), and aggregated into the
`SyncAggregate` that block production includes for the previous slot
(altair/validator.md: a message signed at slot s over the head root is
packed into the block at s+1)."""

from __future__ import annotations

from ..crypto import bls
from ..metrics import inc_counter
from ..state_processing.accessors import compute_epoch_at_slot, get_domain
from ..types.chain_spec import Domain, compute_signing_root


class SyncMessageError(ValueError):
    pass


class SyncCommitteeMessagePool:
    """(slot, block_root) -> {committee_position: signature_bytes}."""

    RETAIN_SLOTS = 4

    def __init__(self, E):
        self.E = E
        self._msgs: dict[tuple[int, bytes], dict[int, bytes]] = {}

    def insert(self, slot: int, block_root: bytes, position: int, signature: bytes):
        key = (int(slot), bytes(block_root))
        self._msgs.setdefault(key, {})[int(position)] = bytes(signature)

    def prune(self, current_slot: int):
        cutoff = current_slot - self.RETAIN_SLOTS
        for key in [k for k in self._msgs if k[0] < cutoff]:
            self._msgs.pop(key)

    def aggregate_for(self, types, E, slot: int, block_root: bytes):
        """SyncAggregate over the pooled messages for (slot, root);
        empty-participation aggregate (infinity sig) when none pooled."""
        from .chain import empty_sync_aggregate

        by_pos = self._msgs.get((int(slot), bytes(block_root)))
        if not by_pos:
            return empty_sync_aggregate(types, E)
        bits = [False] * E.SYNC_COMMITTEE_SIZE
        sigs = []
        # snapshot: gossip threads insert under the chain's write lock
        # while block production reads here — list() is atomic under the
        # GIL, sorted iteration over a live dict is not
        for pos, sig in sorted(list(by_pos.items())):
            if 0 <= pos < E.SYNC_COMMITTEE_SIZE:
                bits[pos] = True
                sigs.append(bls.Signature(sig))
        aggregate = bls.AggregateSignature.from_signatures(sigs).to_signature()
        return types.SyncAggregate(
            sync_committee_bits=bits,
            sync_committee_signature=aggregate.to_bytes(),
        )


def verify_sync_committee_message(chain, message) -> list[int]:
    """Gossip verification (sync_committee_verification.rs shape): the
    validator must be in the current sync committee; the signature must
    verify over (block_root, DOMAIN_SYNC_COMMITTEE @ epoch(slot)).
    Returns the validator's committee positions (a validator can occupy
    several)."""
    now = chain.slot_clock.now()
    if not (now - 1 <= int(message.slot) <= now + 1):
        # gossip condition: message.slot must be the current slot (±1 for
        # clock disparity) — future-slot messages would otherwise pool
        # unboundedly (prune only drops past slots)
        raise SyncMessageError(
            f"sync message slot {message.slot} outside tolerance of {now}"
        )
    state = chain.head_state
    committee = getattr(state, "current_sync_committee", None)
    if committee is None:
        raise SyncMessageError("pre-Altair chain: no sync committees")
    vi = int(message.validator_index)
    if vi >= len(state.validators):
        raise SyncMessageError("unknown validator index")
    pubkey = bytes(state.validators[vi].pubkey)
    positions = [
        i for i, pk in enumerate(committee.pubkeys) if bytes(pk) == pubkey
    ]
    if not positions:
        raise SyncMessageError("validator not in current sync committee")
    domain = get_domain(
        state,
        Domain.SYNC_COMMITTEE,
        compute_epoch_at_slot(int(message.slot), chain.E),
        chain.spec,
        chain.E,
    )
    signing_root = compute_signing_root(bytes(message.beacon_block_root), domain)
    if not bls.Signature(bytes(message.signature)).verify(
        bls.PublicKey(pubkey), signing_root
    ):
        raise SyncMessageError("invalid sync committee message signature")
    inc_counter("sync_committee_messages_verified_total")
    return positions
