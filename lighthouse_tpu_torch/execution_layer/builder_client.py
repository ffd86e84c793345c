"""External block-builder (MEV relay) client seam.

Mirrors beacon_node/builder_client (228 LoC): the builder API surface —
register validators, fetch a payload header bid, submit a signed blinded
block for the full payload — plus an in-process MockBuilder that wraps the
execution layer and takes a configurable bid cut, so the
local-vs-builder payload selection logic is testable without HTTP."""

from __future__ import annotations

from dataclasses import dataclass

from ..metrics import inc_counter


@dataclass
class BuilderBid:
    header: object  # ExecutionPayloadHeader*
    value_wei: int
    pubkey: bytes


class BuilderClient:
    """The builder API (builder-specs): implementations speak HTTP to a
    relay; MockBuilder implements the same calls in-process."""

    def register_validators(self, registrations: list) -> None:
        raise NotImplementedError

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes) -> BuilderBid | None:
        raise NotImplementedError

    def submit_blinded_block(self, signed_blinded_block) -> object:
        """Returns the full ExecutionPayload matching the bid header."""
        raise NotImplementedError


class MockBuilder(BuilderClient):
    """Builds real payloads via the (mock) execution layer and bids a fixed
    value (mock_builder.rs analog)."""

    def __init__(self, execution_layer, types, E, bid_wei: int = 10**18):
        self.el = execution_layer
        self.types = types
        self.E = E
        self.bid_wei = bid_wei
        self.registered: dict[bytes, object] = {}
        self._payloads: dict[bytes, object] = {}

    def register_validators(self, registrations: list) -> None:
        for reg in registrations:
            self.registered[bytes(reg.pubkey)] = reg

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes, attributes=None) -> BuilderBid | None:
        if bytes(pubkey) not in self.registered:
            return None
        from . import PayloadAttributes
        from ..types.chain_spec import ForkName

        attrs = attributes or PayloadAttributes(
            timestamp=slot * 12, prev_randao=b"\x00" * 32
        )
        payload = self.el.get_payload(parent_hash, attrs, ForkName.CAPELLA)
        header_cls = self.types.ExecutionPayloadHeaderCapella
        fields = {}
        for fname in header_cls._fields:
            if fname == "transactions_root":
                fields[fname] = type(payload)._fields["transactions"].hash_tree_root_of(
                    payload.transactions
                )
            elif fname == "withdrawals_root":
                fields[fname] = type(payload)._fields["withdrawals"].hash_tree_root_of(
                    payload.withdrawals
                )
            else:
                fields[fname] = getattr(payload, fname)
        header = header_cls(**fields)
        self._payloads[bytes(payload.block_hash)] = payload
        inc_counter("builder_bids_served_total")
        return BuilderBid(header=header, value_wei=self.bid_wei, pubkey=pubkey)

    def submit_blinded_block(self, signed_blinded_block) -> object:
        block_hash = bytes(
            signed_blinded_block.message.body.execution_payload_header.block_hash
        )
        payload = self._payloads.get(block_hash)
        if payload is None:
            raise RuntimeError("unknown payload for blinded block")
        inc_counter("builder_blocks_unblinded_total")
        return payload


@dataclass
class ValidatorRegistration:
    pubkey: bytes
    fee_recipient: bytes = b"\x00" * 20
    gas_limit: int = 30_000_000
    timestamp: int = 0
