"""GossipsubBehaviour: mesh maintenance, lazy gossip, score-gated control.

The behaviour.rs analog sized to this stack: a per-topic mesh (D/D_lo/D_hi
bounds enforced by a heartbeat that GRAFTs under-filled and PRUNEs
over-filled meshes, v1.1 PRUNE backoff + peer exchange), lazy gossip
(IHAVE over the mcache gossip window to D_lazy non-mesh peers, IWANT
pull with promise tracking), and the PeerScore engine gating every
decision: graylisted peers are ignored wholesale, negative-score peers
are never grafted and get pruned, gossip flows only to/from peers above
the gossip threshold, and PX records are accepted only from peers above
the PX threshold. Opportunistic grafting (behaviour.rs heartbeat tail)
re-seeds a mesh whose median score has sagged.

Transport-agnostic: the owner supplies `send(peer_id, frame_bytes)`,
`deliver(topic, data, origin) -> bool | DEFERRED` (app validation; False =
invalid; the `DEFERRED` sentinel means the owner queued validation and
will report the outcome later via `complete_validation` — nothing is
forwarded, scored, or cached until then), and a message-id function. All outgoing frames are computed under the
state lock but SENT after it is released (socket sends serialize on
per-peer locks upstream; holding the mesh lock across them would wedge
every reader thread on one stalled peer). The heartbeat is caller-driven:
pass ticks from a timer thread (NetworkService) or call `heartbeat()`
directly in tests — no wall clock in mesh logic.

Known, accepted ordering race: frames from two threads (e.g. graft_now on
a duty thread vs a concurrent heartbeat prune) may reach a peer in the
opposite order of the local state changes. The resulting asymmetry is
self-correcting within one exchange — the stale GRAFT lands inside the
backoff our PRUNE just set, so the peer refuses it and both sides settle
unmeshed — and serializing sends under the state lock would let one
stalled socket wedge every reader thread, which is the worse trade.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from ...metrics import REGISTRY, inc_counter, set_distribution, set_gauge
from ...utils.logging import get_logger
from . import frames as F
from .mcache import MessageCache
from .score import PeerScore, PeerScoreParams, PeerScoreThresholds

log = get_logger("gossipsub")

# Mesh observability (the reference's gossipsub_mesh_peers family):
# per-topic mesh-size gauges are updated every heartbeat; the fixed
# topic kinds are registered eagerly at zero so dashboards (and
# conftest) see the series before the first mesh forms — subnet topics
# (beacon_attestation_<n>, …) appear on their first heartbeat.
for _kind in (
    "beacon_block",
    "beacon_aggregate_and_proof",
    "voluntary_exit",
    "proposer_slashing",
    "attester_slashing",
):
    set_gauge("gossipsub_mesh_peers", 0, topic=_kind)

#: peer-score distribution as a HISTOGRAM: every peer's score observed
#: once per heartbeat. The min/p50/max gauges (set_distribution below)
#: churn with mesh membership; the cumulative buckets don't forget, so
#: rate() over them gives the score distribution over a time window —
#: the signal the event-driven-node work needs to see a slow graylist
#: slide. Buckets track the v1.1 thresholds (-80 graylist / -60 publish
#: / -40 gossip) plus a positive-score ladder.
_PEER_SCORE_HIST = REGISTRY.histogram(
    "gossipsub_peer_score_distribution",
    "per-peer gossipsub score, observed once per heartbeat per peer",
    buckets=(-80.0, -60.0, -40.0, -20.0, -10.0, -5.0, -1.0, 0.0,
             1.0, 5.0, 10.0, 20.0, 50.0, 100.0),
)


@dataclass
class GossipsubConfig:
    """Mesh geometry + heartbeat policy (config.rs defaults)."""

    d: int = 6  # mesh target degree
    d_lo: int = 4  # graft below
    d_hi: int = 12  # prune above
    d_lazy: int = 6  # IHAVE fan-out per topic per heartbeat
    d_score: int = 3  # peers retained by score when pruning an oversized mesh
    history_length: int = 5  # mcache windows kept
    gossip_window: int = 3  # mcache windows advertised in IHAVE
    prune_backoff: int = 16  # heartbeats before a pruned peer may re-GRAFT
    iwant_promise_ticks: int = 3  # heartbeats before an IWANT counts broken
    gossip_retransmission: int = 3  # times one message answers IWANTs
    max_iwant_per_ihave: int = 500
    max_ihave_messages: int = 10  # IHAVE frames honored per peer per heartbeat
    max_ihave_ids: int = 5000  # advertised ids honored per peer per heartbeat
    max_backoff_factor: int = 4  # clamp on remote PRUNE backoff (x our own)
    opportunistic_graft_ticks: int = 8
    opportunistic_graft_peers: int = 2
    flood_publish: bool = True  # self-publish to all peers above publish thr.
    seen_cap: int = 1 << 16


def _short_topic(topic: str) -> str:
    parts = topic.split("/")
    return parts[-2] if len(parts) >= 2 else topic


#: returned by a `deliver` callback that queued validation instead of
#: running it inline (the event-driven gossip path): the behaviour parks
#: the message — no forward, no score, no mcache — until the owner calls
#: `complete_validation` with the real outcome
DEFERRED = object()


class GossipsubBehaviour:
    def __init__(
        self,
        send,
        deliver,
        mid_fn,
        px_provider=None,
        params: PeerScoreParams | None = None,
        thresholds: PeerScoreThresholds | None = None,
        config: GossipsubConfig | None = None,
        seed: int | None = None,
    ):
        self._send = send
        self._deliver = deliver
        self._mid = mid_fn
        self._px_provider = px_provider
        self.config = config or GossipsubConfig()
        self.thresholds = thresholds or PeerScoreThresholds()
        self.score = PeerScore(params)
        self.mcache = MessageCache(
            self.config.history_length, self.config.gossip_window
        )
        self._lock = threading.RLock()
        self._rng = random.Random(seed)
        self.ticks = 0
        self.peers: set[str] = set()
        self.peer_topics: dict[str, set[str]] = {}
        self.subscriptions: set[str] = set()
        self.mesh: dict[str, set[str]] = {}
        #: (topic, peer) -> tick until which GRAFT is refused
        self.backoff: dict[tuple[str, str], int] = {}
        self._seen: dict[bytes, int] = {}
        #: mid -> (peer, deadline tick) for outstanding IWANTs
        self._promises: dict[bytes, tuple[str, int]] = {}
        #: peer -> [ihave frames, advertised ids] this heartbeat (reset
        #: each tick: the libp2p max_ihave_messages/-length budgets)
        self._ihave_budget: dict[str, list[int]] = {}
        #: drained by the owner for dialing (v1.1 PX)
        self._px_candidates: list[tuple[str, str, int]] = []

    # -- helpers ---------------------------------------------------------

    def _flush(self, out: list[tuple[str, bytes]]):
        """Send computed frames AFTER the state lock is released."""
        for peer_id, payload in out:
            self._send(peer_id, payload)

    def _first_sight(self, mid: bytes) -> bool:
        if mid in self._seen:
            return False
        self._seen[mid] = self.ticks
        while len(self._seen) > self.config.seen_cap:
            self._seen.pop(next(iter(self._seen)))
        return True

    def _subscribed_peers(self, topic: str) -> list[str]:
        return [
            p for p in self.peers if topic in self.peer_topics.get(p, ())
        ]

    def _make_prune(self, topic: str, peer_id: str, px: bool) -> bytes:
        records = []
        if px and self._px_provider is not None:
            if self.score.score(peer_id) >= 0:
                for pid, host, port in self._px_provider(topic, peer_id)[
                    : F.MAX_PX_PEERS
                ]:
                    records.append(
                        F.PeerRecord(
                            peer_id=pid.encode()[:96],
                            host=host.encode()[:64],
                            port=port,
                        )
                    )
        inc_counter("gossipsub_prunes_sent_total")
        return F.encode_frame(
            F.PruneFrame(
                topic=topic.encode(),
                backoff=self.config.prune_backoff,
                px=records,
            )
        )

    def _do_prune(
        self, topic: str, peer_id: str, out: list, px: bool = True
    ):
        self.mesh.get(topic, set()).discard(peer_id)
        self.score.prune(peer_id, topic)
        self.backoff[(topic, peer_id)] = self.ticks + self.config.prune_backoff
        out.append((peer_id, self._make_prune(topic, peer_id, px)))

    def _do_graft(self, topic: str, peer_id: str, out: list):
        self.mesh.setdefault(topic, set()).add(peer_id)
        self.score.graft(peer_id, topic)
        inc_counter("gossipsub_grafts_sent_total")
        out.append(
            (peer_id, F.encode_frame(F.GraftFrame(topic=topic.encode())))
        )

    # -- membership ------------------------------------------------------

    def add_peer(self, peer_id: str):
        """A gossip link came up: track the peer and announce our topics."""
        with self._lock:
            self.peers.add(peer_id)
            self.peer_topics.setdefault(peer_id, set())
            self.score.add_peer(peer_id)
            out = [
                (
                    peer_id,
                    F.encode_frame(
                        F.SubscriptionFrame(subscribe=True, topic=t.encode())
                    ),
                )
                for t in sorted(self.subscriptions)
            ]
        self._flush(out)

    def remove_peer(self, peer_id: str):
        with self._lock:
            self.peers.discard(peer_id)
            self.peer_topics.pop(peer_id, None)
            for members in self.mesh.values():
                members.discard(peer_id)
            self.score.remove_peer(peer_id)
            self._ihave_budget.pop(peer_id, None)
            # a departed peer's backoff entries must not leak: cheap peer
            # ids would otherwise grow the table without bound
            for key in [k for k in self.backoff if k[1] == peer_id]:
                del self.backoff[key]

    def subscribe(self, topic: str):
        with self._lock:
            if topic in self.subscriptions:
                return
            self.subscriptions.add(topic)
            self.mesh.setdefault(topic, set())
            out = [
                (
                    p,
                    F.encode_frame(
                        F.SubscriptionFrame(subscribe=True, topic=topic.encode())
                    ),
                )
                for p in self.peers
            ]
        self._flush(out)

    def unsubscribe(self, topic: str):
        with self._lock:
            if topic not in self.subscriptions:
                return
            self.subscriptions.discard(topic)
            out = []
            for p in list(self.mesh.get(topic, ())):
                self._do_prune(topic, p, out, px=True)
            self.mesh.pop(topic, None)
            out.extend(
                (
                    p,
                    F.encode_frame(
                        F.SubscriptionFrame(
                            subscribe=False, topic=topic.encode()
                        )
                    ),
                )
                for p in self.peers
            )
        self._flush(out)

    # -- publishing ------------------------------------------------------

    def publish(self, topic: str, data: bytes):
        """Local publish: eager-push to the mesh (flood_publish widens to
        every subscribed peer above the publish threshold — the reference
        default for our own messages: robustness over bandwidth)."""
        mid = self._mid(data)
        with self._lock:
            if not self._first_sight(mid):
                return
            self.mcache.put(mid, topic, data)
            if self.config.flood_publish:
                targets = [
                    p
                    for p in self._subscribed_peers(topic)
                    if self.score.score(p) >= self.thresholds.publish_threshold
                ]
            else:
                targets = list(self.mesh.get(topic, ()))
                if not targets:
                    subscribed = self._subscribed_peers(topic)
                    targets = self._rng.sample(
                        subscribed, min(self.config.d, len(subscribed))
                    )
            payload = F.encode_frame(
                F.PublishFrame(topic=topic.encode(), data=data)
            )
            out = [(p, payload) for p in targets]
        inc_counter("gossip_messages_total", topic=_short_topic(topic))
        self._flush(out)

    # -- inbound frames --------------------------------------------------

    def handle_frame(self, peer_id: str, frame):
        """Dispatch one decoded control/publish frame from a peer."""
        if isinstance(frame, F.PublishFrame):
            self._handle_publish(
                peer_id, bytes(frame.topic).decode(), bytes(frame.data)
            )
        elif isinstance(frame, F.SubscriptionFrame):
            self._handle_subscription(
                peer_id, bool(frame.subscribe), bytes(frame.topic).decode()
            )
        elif isinstance(frame, F.GraftFrame):
            self._handle_graft(peer_id, bytes(frame.topic).decode())
        elif isinstance(frame, F.PruneFrame):
            self._handle_prune(peer_id, frame)
        elif isinstance(frame, F.IHaveFrame):
            self._handle_ihave(
                peer_id,
                bytes(frame.topic).decode(),
                [bytes(m) for m in frame.message_ids],
            )
        elif isinstance(frame, F.IWantFrame):
            self._handle_iwant(peer_id, [bytes(m) for m in frame.message_ids])

    def _graylisted(self, peer_id: str) -> bool:
        return self.score.score(peer_id) < self.thresholds.graylist_threshold

    def _handle_publish(self, peer_id: str, topic: str, data: bytes):
        mid = self._mid(data)
        with self._lock:
            if self._graylisted(peer_id):
                inc_counter("gossipsub_graylist_dropped_total")
                return
            if topic not in self.subscriptions:
                # real gossipsub drops publishes for unsubscribed topics:
                # caching or P2-crediting them would let junk topics farm
                # score and fill the mcache with 4 MiB frames
                inc_counter("gossipsub_unsubscribed_dropped_total")
                return
            if not self._first_sight(mid):
                self.score.duplicate_delivery(peer_id, topic)
                return
            self._promises.pop(mid, None)
        # validation runs OUTSIDE the lock: chain import is slow and must
        # not serialize the whole mesh behind one message
        valid = self._deliver(topic, data, peer_id)
        if valid is DEFERRED:
            # validation queued (beacon_processor lane): the relay and
            # score decisions wait for complete_validation — the reader
            # thread returns to its socket immediately
            return
        self._finish_validation(topic, data, peer_id, mid, bool(valid))

    def complete_validation(
        self, topic: str, data: bytes, origin: str, valid: bool
    ):
        """Deferred-validation outcome for a message whose `deliver`
        returned DEFERRED: applies exactly the post-validation steps the
        inline path would have — invalid → P4 penalty; valid → mcache,
        P2 credit, eager forward to the mesh (minus the origin). Safe if
        the origin disconnected meanwhile (score ops no-op)."""
        self._finish_validation(topic, data, origin, None, valid)

    def _finish_validation(
        self, topic: str, data: bytes, peer_id: str, mid: bytes | None,
        valid: bool,
    ):
        if valid and mid is None:
            # deferred path: the receive-time mid wasn't carried through
            # the queue hop; recompute only on Accept (the reject path
            # never needs it) and outside the mesh lock
            mid = self._mid(data)
        with self._lock:
            if not valid:
                self.score.invalid_message(peer_id, topic)
                return
            # only validated messages enter the mcache: IWANT must never
            # serve (and IHAVE never advertise) data we rejected
            self.mcache.put(mid, topic, data)
            self.score.first_delivery(peer_id, topic)
            # eager forward: mesh peers only (the gossipsub split); before
            # the first heartbeat forms a mesh, fall back to every
            # subscribed peer so bootstrap relaying is never silent
            members = self.mesh.get(topic) or set(self._subscribed_peers(topic))
            payload = F.encode_frame(
                F.PublishFrame(topic=topic.encode(), data=data)
            )
            out = [(p, payload) for p in members if p != peer_id]
        inc_counter("gossip_messages_total", topic=_short_topic(topic))
        self._flush(out)

    #: cap on tracked subscriptions per peer: a junk-topic flood must not
    #: grow per-peer state (and score() iteration cost) without bound
    MAX_PEER_TOPICS = 1024

    def _handle_subscription(self, peer_id: str, subscribe: bool, topic: str):
        with self._lock:
            if peer_id not in self.peers:
                return  # in-flight frame racing a disconnect: no ghosts
            topics = self.peer_topics.setdefault(peer_id, set())
            if subscribe:
                if len(topics) < self.MAX_PEER_TOPICS:
                    topics.add(topic)
            else:
                topics.discard(topic)
                self.mesh.get(topic, set()).discard(peer_id)
                if topic in self.subscriptions:
                    self.score.prune(peer_id, topic)

    def _handle_graft(self, peer_id: str, topic: str):
        with self._lock:
            if peer_id not in self.peers or self._graylisted(peer_id):
                return
            out: list[tuple[str, bytes]] = []
            if topic not in self.subscriptions:
                # refuse without tracking the topic: junk-topic GRAFTs
                # must not create per-peer state
                out.append((peer_id, self._make_prune(topic, peer_id, px=False)))
            else:
                # a GRAFT on one of our topics implies the peer subscribes
                self.peer_topics.setdefault(peer_id, set()).add(topic)
                if self.backoff.get((topic, peer_id), 0) > self.ticks:
                    # v1.1: grafting through backoff is a protocol violation
                    self.score.behaviour_penalty(peer_id)
                    self._do_prune(topic, peer_id, out, px=False)
                elif self.score.score(peer_id) < 0:
                    self._do_prune(topic, peer_id, out, px=False)
                elif peer_id in self.mesh.setdefault(topic, set()):
                    # duplicate GRAFT: membership unchanged, and crucially
                    # the P1/P3 mesh_time clock is NOT reset — re-GRAFTing
                    # must not dodge the delivery-deficit activation
                    pass
                elif len(self.mesh[topic]) >= self.config.d_hi:
                    self._do_prune(topic, peer_id, out, px=True)
                else:
                    self.mesh[topic].add(peer_id)
                    self.score.graft(peer_id, topic)
                    inc_counter("gossipsub_grafts_received_total")
        self._flush(out)

    def _handle_prune(self, peer_id: str, frame: F.PruneFrame):
        topic = bytes(frame.topic).decode()
        with self._lock:
            if peer_id not in self.peers or self._graylisted(peer_id):
                return
            if topic not in self.subscriptions:
                return  # junk-topic PRUNEs must not create backoff/score state
            self.mesh.get(topic, set()).discard(peer_id)
            self.score.prune(peer_id, topic)
            # clamp the remote-supplied backoff: an unclamped uint64 would
            # be a permanent entry the heartbeat cleanup can never expire
            backoff = min(
                int(frame.backoff) or self.config.prune_backoff,
                self.config.prune_backoff * self.config.max_backoff_factor,
            )
            self.backoff[(topic, peer_id)] = self.ticks + backoff
            inc_counter("gossipsub_prunes_received_total")
            if (
                len(frame.px)
                and self.score.score(peer_id)
                >= self.thresholds.accept_px_threshold
            ):
                for rec in frame.px:
                    self._px_candidates.append(
                        (
                            bytes(rec.peer_id).decode(errors="replace"),
                            bytes(rec.host).decode(errors="replace"),
                            int(rec.port),
                        )
                    )

    def _handle_ihave(self, peer_id: str, topic: str, mids: list[bytes]):
        with self._lock:
            inc_counter("gossipsub_ihave_received_total")
            if self.score.score(peer_id) < self.thresholds.gossip_threshold:
                return
            if topic not in self.subscriptions:
                return
            # per-peer per-heartbeat budget (libp2p max_ihave_messages /
            # max_ihave_length): without it one peer could grow _promises
            # and elicit IWANT replies proportionally to its send rate
            budget = self._ihave_budget.setdefault(peer_id, [0, 0])
            budget[0] += 1
            if budget[0] > self.config.max_ihave_messages:
                return
            id_room = self.config.max_ihave_ids - budget[1]
            if id_room <= 0:
                return
            mids = mids[: min(self.config.max_iwant_per_ihave, id_room)]
            budget[1] += len(mids)
            wanted = [
                m
                for m in mids
                if m not in self._seen and m not in self._promises
            ]
            if not wanted:
                return
            deadline = self.ticks + self.config.iwant_promise_ticks
            for m in wanted:
                self._promises[m] = (peer_id, deadline)
            inc_counter("gossipsub_iwant_sent_total", amount=len(wanted))
            out = [
                (peer_id, F.encode_frame(F.IWantFrame(message_ids=wanted)))
            ]
        self._flush(out)

    def _handle_iwant(self, peer_id: str, mids: list[bytes]):
        with self._lock:
            inc_counter("gossipsub_iwant_received_total")
            if self.score.score(peer_id) < self.thresholds.gossip_threshold:
                return
            out = []
            served = 0
            for m in mids:
                entry = self.mcache.get_for_iwant(
                    m, peer_id, self.config.gossip_retransmission
                )
                if entry is None:
                    continue
                topic, data = entry
                out.append(
                    (
                        peer_id,
                        F.encode_frame(
                            F.PublishFrame(topic=topic.encode(), data=data)
                        ),
                    )
                )
                served += 1
            if served:
                inc_counter("gossipsub_iwant_served_total", amount=served)
        self._flush(out)

    # -- heartbeat -------------------------------------------------------

    def heartbeat(self):
        """One mesh-maintenance round; call at a fixed cadence."""
        cfg = self.config
        with self._lock:
            self.ticks += 1
            self.score.refresh()
            self._ihave_budget.clear()
            for key in [k for k, t in self.backoff.items() if t <= self.ticks]:
                del self.backoff[key]
            out: list[tuple[str, bytes]] = []
            scores = {p: self.score.score(p) for p in self.peers}
            for topic in self.subscriptions:
                members = self.mesh.setdefault(topic, set())
                # evict: gone, unsubscribed, or negative-score members
                for p in list(members):
                    if p not in self.peers or topic not in self.peer_topics.get(
                        p, ()
                    ):
                        members.discard(p)
                        self.score.prune(p, topic)
                    elif scores[p] < 0:
                        self._do_prune(topic, p, out, px=False)
                candidates = [
                    p
                    for p in self._subscribed_peers(topic)
                    if p not in members
                    and scores[p] >= 0
                    and self.backoff.get((topic, p), 0) <= self.ticks
                ]
                if len(members) < cfg.d_lo and candidates:
                    self._rng.shuffle(candidates)
                    for p in candidates[: cfg.d - len(members)]:
                        self._do_graft(topic, p, out)
                elif len(members) > cfg.d_hi:
                    # score-aware pruning: keep the best d_score outright,
                    # fill the rest of D at random (v1.1 §3.3)
                    ranked = sorted(
                        members, key=lambda p: scores[p], reverse=True
                    )
                    keep = ranked[: cfg.d_score]
                    rest = ranked[cfg.d_score :]
                    self._rng.shuffle(rest)
                    keep += rest[: cfg.d - len(keep)]
                    for p in set(members) - set(keep):
                        self._do_prune(topic, p, out, px=True)
                elif (
                    self.ticks % cfg.opportunistic_graft_ticks == 0
                    and len(members) >= 2
                ):
                    ranked = sorted(scores[p] for p in members)
                    median = ranked[len(ranked) // 2]
                    if median < self.thresholds.opportunistic_graft_threshold:
                        uppers = [
                            p
                            for p in candidates
                            if scores[p] > max(median, 0.0)
                        ]
                        self._rng.shuffle(uppers)
                        for p in uppers[: cfg.opportunistic_graft_peers]:
                            self._do_graft(topic, p, out)
            # lazy gossip: IHAVE the gossip window to non-mesh peers
            for topic in self.mcache.topics_in_gossip_window():
                if topic not in self.subscriptions:
                    continue
                mids = self.mcache.gossip_ids(topic)
                if not mids:
                    continue
                members = self.mesh.get(topic, set())
                lazy = [
                    p
                    for p in self._subscribed_peers(topic)
                    if p not in members
                    and scores[p] >= self.thresholds.gossip_threshold
                ]
                self._rng.shuffle(lazy)
                payload = F.encode_frame(
                    F.IHaveFrame(
                        topic=topic.encode(),
                        message_ids=mids[: F.MAX_MESSAGE_IDS],
                    )
                )
                out.extend((p, payload) for p in lazy[: cfg.d_lazy])
            # broken IWANT promises -> behaviour penalty
            for mid in [
                m for m, (_, dl) in self._promises.items() if dl <= self.ticks
            ]:
                peer_id, _ = self._promises.pop(mid)
                if mid not in self._seen:
                    self.score.behaviour_penalty(peer_id)
                    inc_counter("gossipsub_broken_promises_total")
            self.mcache.shift()
            for topic, members in self.mesh.items():
                if members or topic in self.subscriptions:
                    set_gauge(
                        "gossipsub_mesh_peers",
                        len(members),
                        topic=_short_topic(topic),
                    )
            if scores:
                set_distribution("gossipsub_peer_score", scores.values())
                for v in scores.values():
                    _PEER_SCORE_HIST.observe(v)
        self._flush(out)

    # -- owner accessors -------------------------------------------------

    def mesh_peers(self, topic: str) -> set[str]:
        with self._lock:
            return set(self.mesh.get(topic, ()))

    def peer_score(self, peer_id: str) -> float:
        with self._lock:
            return self.score.score(peer_id)

    def graft_now(self, topic: str):
        """Eagerly fill one topic's mesh (duty subnets shouldn't wait for
        the next heartbeat). Requires a prior subscribe(): silently
        adding the subscription here would skip the SUBSCRIBE broadcast
        and leave us invisible to the topic's flood/gossip emitters."""
        cfg = self.config
        with self._lock:
            if topic not in self.subscriptions:
                return
            members = self.mesh.setdefault(topic, set())
            out: list[tuple[str, bytes]] = []
            candidates = [
                p
                for p in self._subscribed_peers(topic)
                if p not in members
                and self.score.score(p) >= 0
                and self.backoff.get((topic, p), 0) <= self.ticks
            ]
            self._rng.shuffle(candidates)
            for p in candidates[: cfg.d - len(members)]:
                self._do_graft(topic, p, out)
        self._flush(out)

    def take_px_candidates(self) -> list[tuple[str, str, int]]:
        with self._lock:
            out, self._px_candidates = self._px_candidates, []
            return out

    def seen(self, mid: bytes) -> bool:
        with self._lock:
            return mid in self._seen
