"""Gossipsub v1.1 control-frame wire encoding.

The reference vendors libp2p gossipsub whose RPC is protobuf
(gossipsub/src/protocol.rs, rpc_proto); this stack is SSZ end-to-end, so
control frames are SSZ containers behind a 1-byte frame tag — the same
IHAVE/IWANT/GRAFT/PRUNE/SUBSCRIBE vocabulary (v1.1 adds PRUNE backoff +
peer-exchange records) carried over the persistent gossip stream that
previously carried only naive topic-framed publishes.

Frame layout: `<tag u8><ssz body>`. Message ids are the 20-byte spec
gossip message-id (SHA256(domain + data)[:20], network/messages.py), so
IHAVE/IWANT lists pack as fixed Bytes20 vectors. Golden encodings are
pinned in tests/test_gossipsub_frames.py.
"""

from __future__ import annotations

from ...ssz.core import (
    ByteList,
    ByteVector,
    Container,
    DeserializationError,
    List,
    boolean,
    uint16,
    uint64,
)

Bytes20 = ByteVector[20]

#: frame tags (the u8 envelope discriminant)
TAG_PUBLISH = 0
TAG_SUBSCRIBE = 1
TAG_GRAFT = 2
TAG_PRUNE = 3
TAG_IHAVE = 4
TAG_IWANT = 5

MAX_TOPIC_LEN = 256
MAX_MESSAGE_IDS = 5000  # libp2p default max_ihave_length
MAX_PX_PEERS = 16
MAX_GOSSIP_DATA = 1 << 22  # matches rpc.MAX_PAYLOAD


class PublishFrame(Container):
    """A full message: eager push to mesh peers, or an IWANT response."""

    topic: ByteList[MAX_TOPIC_LEN]
    data: ByteList[MAX_GOSSIP_DATA]


class SubscriptionFrame(Container):
    """SUBSCRIBE/UNSUBSCRIBE announcement (subscribe=False leaves)."""

    subscribe: boolean
    topic: ByteList[MAX_TOPIC_LEN]


class GraftFrame(Container):
    """GRAFT: add me to your mesh for this topic."""

    topic: ByteList[MAX_TOPIC_LEN]


class PeerRecord(Container):
    """v1.1 peer-exchange record carried on PRUNE: enough for the pruned
    peer to dial a replacement (signed ENRs in the reference; here the
    noise peer id plus the host/port the record-holder dialed)."""

    peer_id: ByteList[96]
    host: ByteList[64]
    port: uint16


class PruneFrame(Container):
    """PRUNE: removal from the mesh, with v1.1 backoff (heartbeats the
    pruned peer must wait before re-GRAFTing) and peer-exchange records."""

    topic: ByteList[MAX_TOPIC_LEN]
    backoff: uint64
    px: List[PeerRecord, MAX_PX_PEERS]


class IHaveFrame(Container):
    """Lazy gossip: message ids seen recently on a topic."""

    topic: ByteList[MAX_TOPIC_LEN]
    message_ids: List[Bytes20, MAX_MESSAGE_IDS]


class IWantFrame(Container):
    """Pull request for full messages advertised via IHAVE."""

    message_ids: List[Bytes20, MAX_MESSAGE_IDS]


_FRAME_TYPES = {
    TAG_PUBLISH: PublishFrame,
    TAG_SUBSCRIBE: SubscriptionFrame,
    TAG_GRAFT: GraftFrame,
    TAG_PRUNE: PruneFrame,
    TAG_IHAVE: IHaveFrame,
    TAG_IWANT: IWantFrame,
}
_TAG_OF = {cls: tag for tag, cls in _FRAME_TYPES.items()}


class FrameError(ValueError):
    pass


def encode_frame(frame) -> bytes:
    tag = _TAG_OF.get(type(frame))
    if tag is None:
        raise FrameError(f"not a gossipsub frame: {type(frame).__name__}")
    return bytes([tag]) + frame.serialize()


def decode_frame(data: bytes):
    if not data:
        raise FrameError("empty frame")
    cls = _FRAME_TYPES.get(data[0])
    if cls is None:
        raise FrameError(f"unknown frame tag {data[0]}")
    try:
        return cls.deserialize(data[1:])
    except (DeserializationError, ValueError, IndexError) as e:
        raise FrameError(f"bad {cls.__name__}: {e}") from e
