"""p2p wire messages + topic/digest helpers.

Mirrors lighthouse_network's RPC method types (src/rpc/methods.rs) and
gossip topic naming (src/types topic modules): SSZ containers for
Status/Ping/Metadata/BlocksByRange/BlocksByRoot, fork-digest computation,
and the /eth2/<digest>/<name>/ssz_snappy topic strings."""

from __future__ import annotations

import hashlib

from ..ssz.core import Bytes4, Bytes32, Container, List, uint64
from ..types.chain_spec import ChainSpec

# plain SSZ containers (p2p-interface.md)


class StatusMessage(Container):
    fork_digest: Bytes4
    finalized_root: Bytes32
    finalized_epoch: uint64
    head_root: Bytes32
    head_slot: uint64


class Ping(Container):
    data: uint64


class MetadataMessage(Container):
    seq_number: uint64
    attnets: uint64  # bitfield64 packed


class GoodbyeReason(Container):
    reason: uint64


class BlocksByRangeRequest(Container):
    start_slot: uint64
    count: uint64
    step: uint64


class BlocksByRootRequest(Container):
    roots: List[Bytes32, 1024]


class BlobsByRangeRequest(Container):
    """BlobSidecarsByRange (deneb/p2p-interface.md)."""

    start_slot: uint64
    count: uint64


class BlobIdentifier(Container):
    block_root: Bytes32
    index: uint64


class BlobsByRootRequest(Container):
    blob_ids: List[BlobIdentifier, 1024]


class DataColumnsByRangeRequest(Container):
    """DataColumnSidecarsByRange (EIP-7594 p2p): a slot range plus the
    requester's wanted column indices (custody set or sampling targets)."""

    start_slot: uint64
    count: uint64
    columns: List[uint64, 128]


class DataColumnsByRootRequest(Container):
    """DataColumnSidecarsByRoot: identifiers reuse DataColumnIdentifier's
    (block_root, index) shape via BlobIdentifier — same SSZ layout."""

    column_ids: List[BlobIdentifier, 1024]


GOODBYE_CLIENT_SHUTDOWN = 1
GOODBYE_IRRELEVANT_NETWORK = 2
GOODBYE_FAULT = 3
GOODBYE_BANNED = 250


def compute_fork_digest(spec: ChainSpec, current_version: bytes, genesis_validators_root: bytes) -> bytes:
    """compute_fork_digest: first 4 bytes of the fork data root."""
    return spec.compute_fork_data_root(current_version, genesis_validators_root)[:4]


def gossip_topic(fork_digest: bytes, name: str) -> str:
    return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"


def message_id(message_domain: bytes, uncompressed: bytes) -> bytes:
    """Gossip message-id (p2p spec: SHA256(domain + data)[:20])."""
    return hashlib.sha256(message_domain + uncompressed).digest()[:20]


# RPC protocol ids (rpc/protocol.rs)
PROTO_STATUS = "/eth2/beacon_chain/req/status/1/ssz_snappy"
PROTO_GOODBYE = "/eth2/beacon_chain/req/goodbye/1/ssz_snappy"
PROTO_PING = "/eth2/beacon_chain/req/ping/1/ssz_snappy"
PROTO_METADATA = "/eth2/beacon_chain/req/metadata/2/ssz_snappy"
PROTO_BLOCKS_BY_RANGE = "/eth2/beacon_chain/req/beacon_blocks_by_range/2/ssz_snappy"
PROTO_BLOCKS_BY_ROOT = "/eth2/beacon_chain/req/beacon_blocks_by_root/2/ssz_snappy"
PROTO_BLOBS_BY_RANGE = (
    "/eth2/beacon_chain/req/blob_sidecars_by_range/1/ssz_snappy"
)
PROTO_BLOBS_BY_ROOT = "/eth2/beacon_chain/req/blob_sidecars_by_root/1/ssz_snappy"
PROTO_DATA_COLUMNS_BY_RANGE = (
    "/eth2/beacon_chain/req/data_column_sidecars_by_range/1/ssz_snappy"
)
PROTO_DATA_COLUMNS_BY_ROOT = (
    "/eth2/beacon_chain/req/data_column_sidecars_by_root/1/ssz_snappy"
)
PROTO_GOSSIP = "/lighthouse_tpu/gossip/1"  # persistent pub/sub stream
PROTO_MUX = "/lighthouse_tpu/mux/1"  # yamux-style multiplexed connection

TOPIC_BEACON_BLOCK = "beacon_block"
ATTESTATION_SUBNET_COUNT = 64
TOPIC_BEACON_ATTESTATION = "beacon_attestation_0"  # subnet-0 (back compat)


def attestation_subnet_topic_name(subnet_id: int) -> str:
    return f"beacon_attestation_{int(subnet_id)}"


def compute_subnet_for_attestation(
    committees_per_slot: int, slot: int, committee_index: int, E
) -> int:
    """validator.md compute_subnet_for_attestation."""
    slots_since_epoch_start = int(slot) % E.SLOTS_PER_EPOCH
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (
        committees_since_epoch_start + int(committee_index)
    ) % ATTESTATION_SUBNET_COUNT
TOPIC_AGGREGATE = "beacon_aggregate_and_proof"
TOPIC_VOLUNTARY_EXIT = "voluntary_exit"
TOPIC_PROPOSER_SLASHING = "proposer_slashing"
TOPIC_ATTESTER_SLASHING = "attester_slashing"
TOPIC_SYNC_COMMITTEE = "sync_committee_0"
TOPIC_BLOB_SIDECAR = "blob_sidecar_0"
TOPIC_DATA_COLUMN_SIDECAR = "data_column_sidecar_0"  # subnet-0 (back compat)


def data_column_subnet_topic_name(subnet_id: int) -> str:
    return f"data_column_sidecar_{int(subnet_id)}"
