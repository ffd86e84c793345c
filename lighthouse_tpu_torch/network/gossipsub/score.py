"""Gossipsub v1.1 peer scoring engine.

The parameter families of the reference's vendored peer_score.rs and the
GossipSub paper (Vyzovitis et al. §4): per-topic P1 time-in-mesh,
P2 first-message-deliveries, P3 mesh-message-delivery deficit,
P4 invalid-message penalty — combined under per-topic weights and a
positive-contribution cap — plus the global P7 behaviour penalty
(backoff violations, broken IWANT promises). P5 (app-specific) is an
optional callback; P6 (IP colocation) has no analog on a host-local
transport. Counters decay once per heartbeat via `refresh()`, which is
also the time base for P1 and the P3 activation window, so scoring unit
tests are fully deterministic — no wall clock anywhere.

Score thresholds (the v1.1 gating points) live in `PeerScoreThresholds`:
gossip emission, self-publish flood, graylisting, peer-exchange
acceptance, and opportunistic grafting all check against them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TopicScoreParams:
    """One topic's parameter family (TopicScoreParams in peer_score)."""

    topic_weight: float = 1.0
    # P1: time in mesh (units: heartbeats, capped)
    time_in_mesh_weight: float = 0.02
    time_in_mesh_cap: float = 300.0
    # P2: first message deliveries (decaying counter, capped)
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_decay: float = 0.9
    first_message_deliveries_cap: float = 100.0
    # P3: mesh message delivery deficit — squared shortfall below the
    # threshold, active only after `activation` heartbeats in the mesh
    # (weight <= 0; 0 disables)
    mesh_message_deliveries_weight: float = 0.0
    mesh_message_deliveries_decay: float = 0.9
    mesh_message_deliveries_cap: float = 100.0
    mesh_message_deliveries_threshold: float = 4.0
    mesh_message_deliveries_activation: int = 8
    # P4: invalid messages — squared decaying counter (weight <= 0)
    invalid_message_deliveries_weight: float = -2.0
    invalid_message_deliveries_decay: float = 0.99


@dataclass
class PeerScoreParams:
    topics: dict[str, TopicScoreParams] = field(default_factory=dict)
    #: fallback family for topics without an explicit entry
    default_topic: TopicScoreParams = field(default_factory=TopicScoreParams)
    #: cap on the summed POSITIVE topic contributions (negatives always count)
    topic_score_cap: float = 100.0
    # P7: behaviour penalty (squared decaying counter beyond a grace threshold)
    behaviour_penalty_weight: float = -5.0
    behaviour_penalty_decay: float = 0.9
    behaviour_penalty_threshold: float = 0.0
    #: decayed counters below this snap to 0 (decay_to_zero)
    decay_to_zero: float = 0.01
    #: optional P5 hook: peer_id -> float, added with weight 1
    app_specific: object | None = None

    def for_topic(self, topic: str) -> TopicScoreParams:
        return self.topics.get(topic, self.default_topic)


@dataclass
class PeerScoreThresholds:
    """v1.1 gating thresholds (PeerScoreThresholds in the reference)."""

    gossip_threshold: float = -40.0  # below: no IHAVE to/from the peer
    publish_threshold: float = -60.0  # below: excluded from flood publish
    graylist_threshold: float = -80.0  # below: all frames ignored
    accept_px_threshold: float = 10.0  # PX only from peers above this
    opportunistic_graft_threshold: float = 1.0  # graft when mesh median below


class _TopicStats:
    __slots__ = (
        "in_mesh",
        "mesh_time",
        "first_message_deliveries",
        "mesh_message_deliveries",
        "invalid_message_deliveries",
    )

    def __init__(self):
        self.in_mesh = False
        self.mesh_time = 0  # heartbeats since graft
        self.first_message_deliveries = 0.0
        self.mesh_message_deliveries = 0.0
        self.invalid_message_deliveries = 0.0


class _PeerStats:
    __slots__ = ("topics", "behaviour_penalty")

    def __init__(self):
        self.topics: dict[str, _TopicStats] = {}
        self.behaviour_penalty = 0.0

    def topic(self, t: str) -> _TopicStats:
        s = self.topics.get(t)
        if s is None:
            s = self.topics[t] = _TopicStats()
        return s


class PeerScore:
    """Per-peer score state + the weighted-sum evaluation."""

    def __init__(self, params: PeerScoreParams | None = None):
        self.params = params or PeerScoreParams()
        self._peers: dict[str, _PeerStats] = {}

    # -- membership ------------------------------------------------------

    def add_peer(self, peer_id: str):
        self._peers.setdefault(peer_id, _PeerStats())

    def remove_peer(self, peer_id: str):
        self._peers.pop(peer_id, None)

    def known(self, peer_id: str) -> bool:
        return peer_id in self._peers

    # -- event observations ---------------------------------------------

    def graft(self, peer_id: str, topic: str):
        s = self._peers.setdefault(peer_id, _PeerStats()).topic(topic)
        s.in_mesh = True
        s.mesh_time = 0

    def prune(self, peer_id: str, topic: str):
        p = self._peers.get(peer_id)
        if p is not None:
            s = p.topic(topic)
            s.in_mesh = False
            s.mesh_time = 0

    def first_delivery(self, peer_id: str, topic: str):
        """Peer was the first to deliver a valid message (P2; counts for
        P3 too when the peer is a mesh member)."""
        p = self._peers.get(peer_id)
        if p is None:
            return
        tp = self.params.for_topic(topic)
        s = p.topic(topic)
        s.first_message_deliveries = min(
            tp.first_message_deliveries_cap, s.first_message_deliveries + 1
        )
        if s.in_mesh:
            s.mesh_message_deliveries = min(
                tp.mesh_message_deliveries_cap, s.mesh_message_deliveries + 1
            )

    def duplicate_delivery(self, peer_id: str, topic: str):
        """A (timely) duplicate from a mesh member still counts toward its
        mesh delivery quota (P3) — eager push doing its job."""
        p = self._peers.get(peer_id)
        if p is None:
            return
        s = p.topic(topic)
        if s.in_mesh:
            tp = self.params.for_topic(topic)
            s.mesh_message_deliveries = min(
                tp.mesh_message_deliveries_cap, s.mesh_message_deliveries + 1
            )

    def invalid_message(self, peer_id: str, topic: str):
        p = self._peers.get(peer_id)
        if p is not None:
            p.topic(topic).invalid_message_deliveries += 1

    def behaviour_penalty(self, peer_id: str, count: float = 1.0):
        """P7: backoff-violating GRAFTs, broken IWANT promises."""
        p = self._peers.get(peer_id)
        if p is not None:
            p.behaviour_penalty += count

    # -- evaluation ------------------------------------------------------

    def score(self, peer_id: str) -> float:
        p = self._peers.get(peer_id)
        if p is None:
            return 0.0
        params = self.params
        positive_topics = 0.0
        negative_topics = 0.0
        for topic, s in p.topics.items():
            tp = params.for_topic(topic)
            t_score = 0.0
            if s.in_mesh:
                t_score += tp.time_in_mesh_weight * min(
                    float(s.mesh_time), tp.time_in_mesh_cap
                )
            t_score += (
                tp.first_message_deliveries_weight * s.first_message_deliveries
            )
            if (
                tp.mesh_message_deliveries_weight < 0
                and s.in_mesh
                and s.mesh_time >= tp.mesh_message_deliveries_activation
                and s.mesh_message_deliveries
                < tp.mesh_message_deliveries_threshold
            ):
                deficit = (
                    tp.mesh_message_deliveries_threshold
                    - s.mesh_message_deliveries
                )
                t_score += tp.mesh_message_deliveries_weight * deficit * deficit
            t_score += tp.invalid_message_deliveries_weight * (
                s.invalid_message_deliveries * s.invalid_message_deliveries
            )
            weighted = tp.topic_weight * t_score
            if weighted > 0:
                positive_topics += weighted
            else:
                negative_topics += weighted
        total = min(positive_topics, params.topic_score_cap) + negative_topics
        excess = p.behaviour_penalty - params.behaviour_penalty_threshold
        if excess > 0:
            total += params.behaviour_penalty_weight * excess * excess
        if params.app_specific is not None:
            total += params.app_specific(peer_id)
        return total

    def scores(self) -> dict[str, float]:
        return {pid: self.score(pid) for pid in self._peers}

    # -- decay / time base ----------------------------------------------

    def refresh(self):
        """Once per heartbeat: decay counters, advance time-in-mesh."""
        params = self.params
        zero = params.decay_to_zero
        for p in self._peers.values():
            for topic, s in p.topics.items():
                tp = params.for_topic(topic)
                s.first_message_deliveries *= tp.first_message_deliveries_decay
                if s.first_message_deliveries < zero:
                    s.first_message_deliveries = 0.0
                s.mesh_message_deliveries *= tp.mesh_message_deliveries_decay
                if s.mesh_message_deliveries < zero:
                    s.mesh_message_deliveries = 0.0
                s.invalid_message_deliveries *= (
                    tp.invalid_message_deliveries_decay
                )
                if s.invalid_message_deliveries < zero:
                    s.invalid_message_deliveries = 0.0
                if s.in_mesh:
                    s.mesh_time += 1
            p.behaviour_penalty *= params.behaviour_penalty_decay
            if p.behaviour_penalty < zero:
                p.behaviour_penalty = 0.0
