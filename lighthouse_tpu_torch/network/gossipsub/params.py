"""Beacon-chain scoring parameters (gossipsub_scoring_parameters.rs analog).

The reference derives per-topic weights from spec constants (expected
message rates per slot/epoch); this sizes the same *structure* to the
simulator's scale: beacon_block carries the most weight, aggregates half,
and the 64 attestation subnets split one block-equivalent between them —
so no single subnet can mint (or cost) as much score as block gossip.
Invalid messages are weighted so that a handful of garbage frames on any
topic outweighs all achievable positive score (the paper's "penalties
dominate" design rule), while the PeerManager's ban threshold (4 invalid
reports) still fires before the default graylist for plain flooding —
banning is the outer defense, graylisting the mesh-local one.
"""

from __future__ import annotations

from .score import PeerScoreParams, PeerScoreThresholds, TopicScoreParams

#: mesh delivery deficit stays disabled (weight 0) by default: at
#: simulator node counts a quiet-but-honest peer would otherwise bleed
#: score during empty slots. The engine supports it; opt in per-topic.


def _topic_family(weight: float, first_cap: float) -> TopicScoreParams:
    return TopicScoreParams(
        topic_weight=weight,
        time_in_mesh_weight=0.02,
        time_in_mesh_cap=300.0,
        first_message_deliveries_weight=1.0,
        first_message_deliveries_decay=0.9,
        first_message_deliveries_cap=first_cap,
        mesh_message_deliveries_weight=0.0,
        invalid_message_deliveries_weight=-2.0,
        invalid_message_deliveries_decay=0.99,
    )


def beacon_score_params(
    block_topic: str,
    aggregate_topic: str,
    attestation_topics: dict[int, str] | None = None,
    extra_topics: list[str] | None = None,
) -> PeerScoreParams:
    """Parameter set for the beacon topic families, keyed by the node's
    actual fork-digest topic strings."""
    topics: dict[str, TopicScoreParams] = {
        block_topic: _topic_family(weight=1.0, first_cap=100.0),
        aggregate_topic: _topic_family(weight=0.5, first_cap=200.0),
    }
    for topic in (attestation_topics or {}).values():
        # 64 subnets share one block-equivalent of weight
        topics[topic] = _topic_family(weight=1.0 / 64.0, first_cap=300.0)
    for topic in extra_topics or []:
        topics[topic] = _topic_family(weight=0.25, first_cap=50.0)
    return PeerScoreParams(
        topics=topics,
        default_topic=_topic_family(weight=0.25, first_cap=50.0),
        topic_score_cap=100.0,
        behaviour_penalty_weight=-5.0,
        behaviour_penalty_decay=0.9,
    )


def beacon_score_thresholds() -> PeerScoreThresholds:
    return PeerScoreThresholds(
        gossip_threshold=-40.0,
        publish_threshold=-60.0,
        graylist_threshold=-80.0,
        accept_px_threshold=10.0,
        opportunistic_graft_threshold=1.0,
    )
