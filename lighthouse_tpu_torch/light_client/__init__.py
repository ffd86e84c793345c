"""Altair sync-committee light client.

The reference carries light-client types in consensus/types
(light_client_{header,bootstrap,update,finality_update,optimistic_update}
.rs) and serves them over RPC/HTTP. This module implements the full
protocol surface: containers, server-side producers (bootstrap + updates
with real Merkle branches out of the state), and the client-side store
with `process_light_client_update` validation per the altair light-client
spec — sync-committee signature check included."""

# NOTE: no `from __future__ import annotations` — the SSZ container
# metaclass resolves stringified annotations against the MODULE namespace,
# and the light-client containers are built inside a function (their field
# types must stay live objects).

import functools
from dataclasses import dataclass

from ..crypto import bls
from ..ssz.core import Bytes32, Container, Vector, uint64
from ..ssz.merkle_proof import (
    compute_merkle_proof,
    verify_merkle_proof,
)
from ..state_processing.accessors import (
    compute_epoch_at_slot,
    get_domain,
)
from ..types.chain_spec import Domain, compute_signing_root

# branch depths: altair..deneb BeaconState has ≤32 fields → field-tree
# depth 5; Electra widens the state past 32 fields (37 here) → depth 6
# (the spec's *_GINDEX_ELECTRA revisions). The finality branch adds one
# level for Checkpoint.root (2-field container → depth 1).
NEXT_SYNC_COMMITTEE_DEPTH = 5
FINALITY_DEPTH = 6  # state field (5) + checkpoint.root (1)
NEXT_SYNC_COMMITTEE_DEPTH_ELECTRA = 6
FINALITY_DEPTH_ELECTRA = 7


def _state_depth(state_cls) -> int:
    """Field-tree depth of a state class (5 for ≤32 fields, 6 to 64)."""
    n = len(state_cls._fields)
    if n <= 32:
        return NEXT_SYNC_COMMITTEE_DEPTH
    if n <= 64:
        return NEXT_SYNC_COMMITTEE_DEPTH_ELECTRA
    raise LightClientError(
        f"{state_cls.__name__} has {n} fields; light-client branches cover "
        "up to 64-field states"
    )

MIN_SYNC_COMMITTEE_PARTICIPANTS = 1


class LightClientError(ValueError):
    pass


def build_light_client_types(E, electra: bool = False):
    """Light-client container family for preset `E`. Electra's widened
    state deepens the branch vectors (the spec ships distinct Electra
    light-client structures with *_GINDEX_ELECTRA depths)."""
    return _build_light_client_types_cached(E, bool(electra))


@functools.lru_cache(maxsize=None)
def _build_light_client_types_cached(E, electra: bool):
    from ..types.containers import build_types

    t = build_types(E)
    sc_depth = (
        NEXT_SYNC_COMMITTEE_DEPTH_ELECTRA if electra else NEXT_SYNC_COMMITTEE_DEPTH
    )
    fin_depth = FINALITY_DEPTH_ELECTRA if electra else FINALITY_DEPTH

    class LightClientHeader(Container):
        beacon: t.BeaconBlockHeader

    class LightClientBootstrap(Container):
        header: LightClientHeader
        current_sync_committee: t.SyncCommittee
        current_sync_committee_branch: Vector[Bytes32, sc_depth]

    class LightClientUpdate(Container):
        attested_header: LightClientHeader
        next_sync_committee: t.SyncCommittee
        next_sync_committee_branch: Vector[Bytes32, sc_depth]
        finalized_header: LightClientHeader
        finality_branch: Vector[Bytes32, fin_depth]
        sync_aggregate: t.SyncAggregate
        signature_slot: uint64

    from types import SimpleNamespace

    return SimpleNamespace(
        LightClientHeader=LightClientHeader,
        LightClientBootstrap=LightClientBootstrap,
        LightClientUpdate=LightClientUpdate,
        base=t,
        sc_depth=sc_depth,
        fin_depth=fin_depth,
        electra=electra,
    )


# ---------------------------------------------------------------------------
# Server side: producing bootstraps/updates from states
# ---------------------------------------------------------------------------


def _state_field_branch(state, field_name: str) -> list[bytes]:
    cls = type(state)
    depth = _state_depth(cls)  # 5 altair..deneb, 6 electra (spec gindices)
    fields = list(cls._fields.items())
    chunks = [ft.hash_tree_root_of(getattr(state, f)) for f, ft in fields]
    index = [f for f, _ in fields].index(field_name)
    return compute_merkle_proof(chunks, index, limit=1 << depth)


def _block_header_of(state, lt):
    header = state.latest_block_header
    filled = lt.base.BeaconBlockHeader(
        slot=header.slot,
        proposer_index=header.proposer_index,
        parent_root=header.parent_root,
        state_root=state.hash_tree_root()
        if header.state_root == b"\x00" * 32
        else header.state_root,
        body_root=header.body_root,
    )
    return lt.LightClientHeader(beacon=filled)


def create_bootstrap(state, E):
    """LightClientBootstrap anchored at `state` (served for a finalized
    checkpoint root). Electra states get the deeper-branch family."""
    lt = build_light_client_types(
        E, electra=_state_depth(type(state)) > NEXT_SYNC_COMMITTEE_DEPTH
    )
    return lt.LightClientBootstrap(
        header=_block_header_of(state, lt),
        current_sync_committee=state.current_sync_committee,
        current_sync_committee_branch=_state_field_branch(
            state, "current_sync_committee"
        ),
    )


def create_update(attested_state, finalized_state, sync_aggregate, signature_slot, E):
    """LightClientUpdate proving next_sync_committee + finality from the
    attested state, signed by `sync_aggregate` at `signature_slot`."""
    lt = build_light_client_types(
        E,
        electra=_state_depth(type(attested_state)) > NEXT_SYNC_COMMITTEE_DEPTH,
    )
    # finality branch: checkpoint.root within the state tree (shared helper
    # picks the fork's depth and computes the chunks once)
    state_branch = _state_field_branch(attested_state, "finalized_checkpoint")
    cp = attested_state.finalized_checkpoint
    # within Checkpoint (2 fields): root is index 1; sibling = epoch chunk
    epoch_chunk = int(cp.epoch).to_bytes(32, "little")
    finality_branch = [epoch_chunk] + state_branch

    if bytes(cp.root) == b"\x00" * 32:
        # pre-finality (spec: non-finality updates carry an EMPTY header;
        # the branch then proves the zero root)
        finalized_header = lt.LightClientHeader()
    else:
        finalized_header = _block_header_of(finalized_state, lt)

    return lt.LightClientUpdate(
        attested_header=_block_header_of(attested_state, lt),
        next_sync_committee=attested_state.next_sync_committee,
        next_sync_committee_branch=_state_field_branch(
            attested_state, "next_sync_committee"
        ),
        finalized_header=finalized_header,
        finality_branch=finality_branch,
        sync_aggregate=sync_aggregate,
        signature_slot=signature_slot,
    )


# ---------------------------------------------------------------------------
# Client side: the light-client store + update processing
# ---------------------------------------------------------------------------


@dataclass
class LightClientStore:
    finalized_header: object
    current_sync_committee: object
    next_sync_committee: object | None = None
    optimistic_header: object = None


def initialize_light_client_store(trusted_block_root: bytes, bootstrap, E):
    """Validate the bootstrap against a trusted root (spec
    initialize_light_client_store)."""
    if bootstrap.header.beacon.hash_tree_root() != trusted_block_root:
        raise LightClientError("bootstrap header does not match trusted root")
    sc_root = type(bootstrap.current_sync_committee).hash_tree_root_of(
        bootstrap.current_sync_committee
    )
    # NOTE: verified against the header's STATE root via the field branch.
    # The branch's own length carries the fork's depth (5 altair..deneb,
    # 6 electra — field indices are stable because Electra appends fields).
    ok = verify_merkle_proof(
        sc_root,
        list(bootstrap.current_sync_committee_branch),
        len(bootstrap.current_sync_committee_branch),
        _bootstrap_sc_index(bootstrap, E),
        bytes(bootstrap.header.beacon.state_root),
    )
    if not ok:
        raise LightClientError("invalid current_sync_committee branch")
    return LightClientStore(
        finalized_header=bootstrap.header,
        current_sync_committee=bootstrap.current_sync_committee,
        optimistic_header=bootstrap.header,
    )


def _bootstrap_sc_index(bootstrap, E) -> int:
    # field index of current_sync_committee in the altair+ state layout
    from ..types.containers import build_types

    t = build_types(E)
    return list(t.BeaconStateAltair._fields).index("current_sync_committee")


def process_light_client_update(
    store: LightClientStore, update, current_slot: int, spec, E,
    genesis_validators_root: bytes,
):
    """Spec process_light_client_update (validation + apply), condensed to
    the always-finalized update flow this server produces."""
    att = update.attested_header.beacon
    fin = update.finalized_header.beacon
    if not (
        current_slot >= update.signature_slot > att.slot >= fin.slot
    ):
        raise LightClientError("update slots out of order")

    # finality proof: finalized header root ∈ attested state. An EMPTY
    # finalized header (pre-finality update) proves the zero root.
    is_finality_update = fin != type(fin)()
    fin_root = fin.hash_tree_root() if is_finality_update else b"\x00" * 32
    from ..types.containers import build_types

    t = build_types(E)
    fin_field_index = list(t.BeaconStateAltair._fields).index(
        "finalized_checkpoint"
    )
    # gindex: checkpoint.root (bit 0 = 1) then the field path; depth from
    # the branch length (6 altair..deneb, 7 electra)
    index = 1 | (fin_field_index << 1)
    if not verify_merkle_proof(
        fin_root,
        list(update.finality_branch),
        len(update.finality_branch),
        index,
        bytes(att.state_root),
    ):
        raise LightClientError("invalid finality branch")

    # next-sync-committee proof
    sc_root = type(update.next_sync_committee).hash_tree_root_of(
        update.next_sync_committee
    )
    nsc_index = list(t.BeaconStateAltair._fields).index("next_sync_committee")
    if not verify_merkle_proof(
        sc_root,
        list(update.next_sync_committee_branch),
        len(update.next_sync_committee_branch),
        nsc_index,
        bytes(att.state_root),
    ):
        raise LightClientError("invalid next_sync_committee branch")

    # sync-committee signature over the attested header. The signing
    # committee is selected by the SIGNATURE slot's period: the store's
    # current committee for its own period, the stored next committee when
    # the signature crosses into the following period (spec
    # validate_light_client_update committee selection).
    agg = update.sync_aggregate
    bits = list(agg.sync_committee_bits)
    if sum(bits) < MIN_SYNC_COMMITTEE_PARTICIPANTS:
        raise LightClientError("insufficient sync participation")
    store_period = _period(store.finalized_header.beacon.slot, E)
    signature_period = _period(max(update.signature_slot - 1, 0), E)
    if signature_period == store_period:
        committee = store.current_sync_committee
    elif signature_period == store_period + 1 and store.next_sync_committee is not None:
        committee = store.next_sync_committee
    else:
        raise LightClientError(
            f"signature period {signature_period} not covered by the store "
            f"(store period {store_period})"
        )
    pubkeys = [
        bls.PublicKey(bytes(pk))
        for pk, bit in zip(committee.pubkeys, bits)
        if bit
    ]
    epoch = compute_epoch_at_slot(max(update.signature_slot - 1, 0), E)
    domain = spec.compute_domain_from_parts(
        Domain.SYNC_COMMITTEE,
        spec.fork_version_at_epoch(epoch),
        genesis_validators_root,
    )
    signing_root = compute_signing_root(att.hash_tree_root(), domain)
    if not bls.get_backend().fake:
        aggsig = bls.AggregateSignature()
        aggsig._point = bls.Signature(
            bytes(agg.sync_committee_signature)
        ).point()
        aggsig._empty = False
        if not aggsig.fast_aggregate_verify(pubkeys, signing_root):
            raise LightClientError("invalid sync committee signature")

    # apply (spec apply_light_client_update, finalized flow): finality only
    # advances on a 2/3 supermajority — this IS the light client's security
    # model; a lone compromised key must never move the finalized head
    supermajority = 3 * sum(bits) >= 2 * len(bits)
    if (
        supermajority
        and is_finality_update
        and fin.slot > store.finalized_header.beacon.slot
    ):
        # period computed from the PRE-update finalized header — after the
        # reassignment both sides would be the new slot and rotation would
        # never fire
        period_old = _period(store.finalized_header.beacon.slot, E)
        period_new = _period(fin.slot, E)
        store.finalized_header = update.finalized_header
        store.optimistic_header = update.attested_header
        if store.next_sync_committee is None:
            store.next_sync_committee = update.next_sync_committee
        elif period_new > period_old:
            # rollover: the stored next committee becomes current
            store.current_sync_committee = store.next_sync_committee
            store.next_sync_committee = update.next_sync_committee
    return store


def _period(slot: int, E) -> int:
    return slot // (E.SLOTS_PER_EPOCH * E.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
