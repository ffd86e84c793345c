"""Gossipsub v1.1 control-mesh subsystem (libp2p wire-compat milestone 1).

The reference vendors libp2p gossipsub (17k LoC) and tunes it via
gossipsub_scoring_parameters.rs; this package is that layer's shape on
the host transport: SSZ-framed control messages (frames), a rolling
message cache (mcache), the v1.1 peer-score engine (score, params), and
the mesh/gossip behaviour itself (behaviour). NetworkService's
GossipRouter owns one GossipsubBehaviour and bridges it to sockets,
handlers, and the PeerManager.
"""

from .behaviour import (
    DEFERRED,
    GossipsubBehaviour,
    GossipsubConfig,
    _short_topic as short_topic,
)
from .frames import (
    FrameError,
    GraftFrame,
    IHaveFrame,
    IWantFrame,
    PeerRecord,
    PruneFrame,
    PublishFrame,
    SubscriptionFrame,
    decode_frame,
    encode_frame,
)
from .mcache import MessageCache
from .params import beacon_score_params, beacon_score_thresholds
from .score import (
    PeerScore,
    PeerScoreParams,
    PeerScoreThresholds,
    TopicScoreParams,
)

__all__ = [
    "DEFERRED",
    "FrameError",
    "GossipsubBehaviour",
    "GossipsubConfig",
    "GraftFrame",
    "IHaveFrame",
    "IWantFrame",
    "MessageCache",
    "PeerRecord",
    "PeerScore",
    "PeerScoreParams",
    "PeerScoreThresholds",
    "PruneFrame",
    "PublishFrame",
    "SubscriptionFrame",
    "TopicScoreParams",
    "beacon_score_params",
    "beacon_score_thresholds",
    "decode_frame",
    "encode_frame",
    "short_topic",
]
