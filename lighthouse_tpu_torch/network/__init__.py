"""Host-side p2p networking: gossip, req/resp RPC, peers, sync.

The distributed half of the node (SURVEY §2.10). The reference's stack is
libp2p (gossipsub + eth2 RPC + discv5) with noise/yamux transports; this
implementation keeps the same protocol SURFACE — fork-digest gossip topics
with spec message-ids, SSZ-snappy RPC methods, Status handshakes, peer
scoring/banning, range sync — on the host network (ICI/DCN carry only
device collectives; p2p always stays on the host CPU). Transport security
is the real libp2p Noise XX handshake (network/noise.py) when a
NoiseTransport is supplied: streams are then encrypted and the peer's
ed25519 identity is verified and used for identity-level bans. Gossip now
runs a real gossipsub v1.1 control mesh (network/gossipsub/): per-topic
D-regular meshes with heartbeat GRAFT/PRUNE maintenance, IHAVE/IWANT lazy
gossip over an mcache, and peer scoring gating every mesh decision.
Remaining wire-compat gaps vs mainnet libp2p: multistream-select/yamux
muxing, protobuf gossipsub RPC (frames here are SSZ behind a tag byte),
and discv5 packet crypto (discovery uses its own UDP record protocol).

Components: `NetworkService` (service/mod.rs analog) owning the server +
peer set, `GossipRouter` (socket/handler bridge around
gossipsub.GossipsubBehaviour), `PeerManager` (scoring/banning,
peer_manager/peerdb/score.rs), and the sync engine (network/sync/:
multi-peer range sync, resumable backfill, unknown-root block lookups —
sync/manager.rs + range_sync/ + backfill_sync/ + block_lookups/)."""

from __future__ import annotations

import queue
import socket
import threading
import time
from dataclasses import dataclass, field

from ..beacon_processor import (
    BATCHED_WORK_TYPES,
    BeaconProcessor,
    ReprocessQueue,
    WorkEvent,
    WorkType,
)
from ..metrics import REGISTRY, inc_counter, set_gauge
from ..utils.logging import get_logger
from . import messages as M
from .gossipsub import (
    DEFERRED,
    FrameError,
    GossipsubBehaviour,
    beacon_score_params,
    beacon_score_thresholds,
    decode_frame,
    short_topic as _short_topic,
)
from .rpc import (
    RpcClient,
    RpcError,
    RpcServer,
    _read_exact,
    _recv_block,
    _send_block,
    _send_protocol,
)

log = get_logger("lighthouse_tpu_torch.network")

# peer scoring (peerdb/score.rs shape)
# (the sync engine imports these lazily at call time — network.sync is
# imported below, after the constants it needs exist)
SCORE_INVALID_MESSAGE = -10.0
SCORE_TIMELY_MESSAGE = 0.5
# failed/timed-out RPC (PeerAction::MidToleranceError class): mild — an
# unresponsive peer drifts down instead of staying pristine while honest
# peers absorb implication penalties
SCORE_RPC_FAILURE = -1.0
BAN_THRESHOLD = -40.0
MAX_SCORE = 100.0
BAN_DURATION = 3600.0  # bans expire (peerdb's ban period); entry then drops
_GOSSIP_IO_TIMEOUT = 30.0  # bounds send stalls AND idle reader probes

# gossip outcome accounting (reference Accept/Ignore/Reject semantics):
# rejects downscore the forwarder; ignores and internal errors never do
REGISTRY.counter(
    "gossip_internal_error_total",
    "gossip handlers that failed on OUR side (store fault, bug) — "
    "logged and not relayed, but the forwarding peer is NOT penalized",
).inc(0)
REGISTRY.counter(
    "gossip_ignored_total",
    "gossip messages neither relayed nor penalized (unknown root/parent, "
    "ordering races, reprocess parking)",
).inc(0)
REGISTRY.counter(
    "gossip_relay_dropped_total",
    "accepted messages whose mesh relay was shed (relay queue full) — "
    "processed locally, not re-forwarded",
).inc(0)


class GossipIgnore(Exception):
    """A gossip message we can't act on through no fault of the forwarder
    (reference Ignore): unknown root/parent being recovered, work parked
    in the reprocess queue. Not relayed, not penalized."""


@dataclass
class _GossipWork:
    """One decoded gossip message riding a beacon_processor lane: enough
    context for the queued handler to complete the deferred relay /
    downscore decision when validation finishes."""

    topic: str
    item: object
    data: bytes
    origin: str


@dataclass
class _QueuedTopic:
    """Registration record for a queue-routed gossip topic."""

    work_type: WorkType
    decode: object  # data -> item (reader thread; cheap, reject-on-raise)
    process: object  # item -> None (worker thread; raises to classify)
    #: optional whole-drained-batch processor for batched WorkTypes:
    #: items -> list[Exception | None] (one outcome per item, in order)
    process_batch: object = None


@dataclass
class Peer:
    host: str
    port: int
    client: RpcClient
    status: M.StatusMessage | None = None
    score: float = 0.0
    banned: bool = False
    banned_at: float = 0.0
    gossip_sock: socket.socket | None = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    # Noise-authenticated libp2p-style identity (None on plain TCP).
    # Bans recorded against this id survive address changes — a banned
    # node redialing from a new port keeps its cryptographic identity.
    noise_peer_id: str | None = None

    @property
    def peer_id(self) -> str:
        return f"{self.host}:{self.port}"


class PeerManager:
    def __init__(self):
        self._peers: dict[str, Peer] = {}
        # noise identity -> ban timestamp: identity-level bans (used when
        # the transport authenticates peers; address bans alone can be
        # dodged by redialing from a fresh port)
        self._banned_ids: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, peer: Peer) -> bool:
        """Register a peer. Refused (False) when the peer id is banned —
        redialing must not mint a fresh unbanned identity (peerdb keeps
        banned peers listed for exactly this reason). A reconnect of a
        known peer inherits its score (reconnecting must not launder a
        bad score back to 0) and releases the stale socket."""
        stale_sock = None
        with self._lock:
            if peer.noise_peer_id is not None:
                banned_at = self._banned_ids.get(peer.noise_peer_id)
                if banned_at is not None:
                    if time.monotonic() - banned_at < BAN_DURATION:
                        return False
                    self._banned_ids.pop(peer.noise_peer_id, None)
            existing = self._peers.get(peer.peer_id)
            if existing is not None:
                if existing.banned:
                    if time.monotonic() - existing.banned_at < BAN_DURATION:
                        return False
                    # expired ban: the identity starts fresh
                    self._peers.pop(peer.peer_id)
                    existing = None
            if existing is not None:
                peer.score = existing.score
                with existing.lock:
                    stale_sock = existing.gossip_sock
                    existing.gossip_sock = None
            self._peers[peer.peer_id] = peer
            n = self._gauge_count()
        if stale_sock is not None:
            try:
                stale_sock.close()
            except OSError:
                pass
        set_gauge("network_peers", n)
        return True

    def is_banned(self, peer_id: str) -> bool:
        with self._lock:
            p = self._peers.get(peer_id)
            if p is None or not p.banned:
                return False
            if time.monotonic() - p.banned_at >= BAN_DURATION:
                # ban served: drop the dead entry entirely (bounds the
                # table — banned identities don't accumulate forever)
                self._peers.pop(peer_id, None)
                return False
            return True

    def _gauge_count(self) -> int:
        """Connected (non-banned) peers — call under self._lock."""
        return sum(1 for p in self._peers.values() if not p.banned)

    def remove(self, peer_id: str):
        """Drop a disconnected peer. Banned entries are kept — a ban must
        survive the connection teardown that usually follows it (peerdb's
        ban list outlives the session)."""
        with self._lock:
            p = self._peers.get(peer_id)
            if p is not None and not p.banned:
                self._peers.pop(peer_id)
            n = self._gauge_count()
        set_gauge("network_peers", n)

    def peers(self) -> list[Peer]:
        with self._lock:
            return [p for p in self._peers.values() if not p.banned]

    def get(self, peer_id: str) -> Peer | None:
        """A connected, non-banned peer by id (None otherwise)."""
        with self._lock:
            p = self._peers.get(peer_id)
            return None if p is None or p.banned else p

    def report(self, peer_id: str, delta: float) -> Peer | None:
        """Score adjustment; banning at threshold (score.rs behavior). A
        fresh ban also severs the live connection — the reference
        disconnects banned peers, not just future redials."""
        newly_banned = None
        with self._lock:
            p = self._peers.get(peer_id)
            if p is None:
                return None
            p.score = min(MAX_SCORE, p.score + delta)
            if p.score <= BAN_THRESHOLD and not p.banned:
                p.banned = True
                p.banned_at = time.monotonic()
                if p.noise_peer_id is not None:
                    self._banned_ids[p.noise_peer_id] = p.banned_at
                newly_banned = p
                inc_counter("network_peers_banned_total")
            n = self._gauge_count()
        if newly_banned is not None:
            set_gauge("network_peers", n)
            # close outside the manager lock (peer.lock orders with publish)
            with newly_banned.lock:
                if newly_banned.gossip_sock is not None:
                    try:
                        newly_banned.gossip_sock.close()
                    except OSError:
                        pass
                    newly_banned.gossip_sock = None
        return p


class GossipRouter:
    """Socket/handler bridge around a gossipsub v1.1 control mesh.

    The flood-publish stand-in graduated (network/gossipsub/): the
    behaviour owns mesh membership, the mcache, scoring and dedup; this
    router supplies its transport (peer sockets via the PeerManager), its
    validation, and its peer-exchange records.

    Validation is QUEUE-ROUTED (the event-driven-node refactor): a topic
    registered via `subscribe_queued` runs only a thin decode step on the
    socket reader thread — the chain-touching process step rides its own
    beacon_processor WorkType lane, so reader threads never block on
    state transitions, priority ordering (blocks before attestations)
    holds under storm, and full queues shed load through the processor's
    drop-counted backpressure instead of stalling sockets. The
    validate-then-forward contract survives: `_deliver` returns the
    gossipsub DEFERRED sentinel and the queued handler reports the
    outcome via `behaviour.complete_validation`, which performs exactly
    the relay/score steps the inline path would have. Outcomes follow the
    reference Accept/Ignore/Reject split — only Rejects (the chain's
    ValueError validation family) cost the forwarder score; internal faults are
    logged and counted (`gossip_internal_error_total`) without penalizing
    an innocent peer. Plain `subscribe` keeps the inline contract for
    relay-only/auxiliary topics."""

    def __init__(
        self,
        service: "NetworkService",
        params=None,
        thresholds=None,
        config=None,
    ):
        self.service = service
        self._handlers: dict[str, object] = {}
        self._queued: dict[str, _QueuedTopic] = {}
        #: one runner object per WorkType (NOT per topic): the processor
        #: coalesces batched kinds by handler identity, so all 64
        #: attestation subnets must share one runner to share one batch
        self._runners: dict[WorkType, object] = {}
        # deferred-Accept relays ride their own thread: the mesh forward
        # is a blocking socket send (peer.lock, 30 s I/O timeout) and
        # must not wedge the beacon_processor's scarce workers behind one
        # stalled peer — a full relay queue sheds the FORWARD only
        # (counted; the message was already processed locally)
        self._relay_q: queue.Queue = queue.Queue(maxsize=1024)
        self._relay_stop = threading.Event()
        self._relay_thread = threading.Thread(
            target=self._relay_loop,
            daemon=True,
            name=f"gossip-relay-{service.port}",
        )
        self._relay_thread.start()
        domain = service.spec.message_domain_valid_snappy
        self.behaviour = GossipsubBehaviour(
            send=self._send_frame,
            deliver=self._deliver,
            mid_fn=lambda data: M.message_id(domain, data),
            px_provider=self._px_records,
            params=params,
            thresholds=thresholds,
            config=config,
        )

    def subscribe(self, topic: str, handler):
        """Inline-validated subscription (legacy contract): handler runs
        on the reader thread; raising rejects. Chain-touching handlers
        belong on `subscribe_queued` (the queue-discipline lint rule
        enforces this — handlers here must not call chain.process_*)."""
        self._handlers[topic] = handler
        self.behaviour.subscribe(topic)

    def subscribe_queued(
        self,
        topic: str,
        work_type: WorkType,
        decode,
        process=None,
        process_batch=None,
    ):
        """Queue-routed subscription: `decode` runs inline on the reader
        thread (raise = reject + downscore); the decoded item is submitted
        on `work_type`'s lane and `process` (or `process_batch` for the
        coalescing kinds) runs on a worker, classifying its outcome by
        exception: clean return = Accept (relay + credit), GossipIgnore =
        Ignore, ValueError (the chain's validation family) = Reject
        (downscore), anything else = internal error (counted, never the
        peer's fault)."""
        self._queued[topic] = _QueuedTopic(
            work_type=work_type,
            decode=decode,
            process=process,
            process_batch=process_batch,
        )
        self.behaviour.subscribe(topic)

    def publish(self, topic: str, data: bytes):
        """Local publish: into the mcache and out via the mesh."""
        self.behaviour.publish(topic, data)

    def ensure_mesh(self, topic: str):
        """Eagerly fill a topic's mesh (duty-subnet joins shouldn't wait
        for the next heartbeat)."""
        self.behaviour.graft_now(topic)

    def heartbeat(self):
        """One behaviour heartbeat + dial any peer-exchange candidates."""
        self.behaviour.heartbeat()
        self._dial_px()

    def mesh_peers(self, topic: str) -> set[str]:
        return self.behaviour.mesh_peers(topic)

    # -- behaviour plumbing ----------------------------------------------

    def on_frame(self, peer_id: str, raw: bytes):
        """One length-delimited gossip block from a peer's reader."""
        try:
            frame = decode_frame(raw)
        except FrameError:
            self.service.peers.report(peer_id, SCORE_INVALID_MESSAGE)
            inc_counter("gossip_invalid_total")
            return
        self.behaviour.handle_frame(peer_id, frame)

    def _deliver(self, topic: str, data: bytes, origin: str):
        """Validate-then-forward (gossipsub accept/reject semantics): a
        message our handler rejects is NOT relayed, so invalid data never
        costs downstream peers score — and the rejection feeds both the
        gossipsub score (graylisting) and the PeerManager (banning).

        Queue-routed topics decode here (thin, reader-thread) and defer
        the chain-touching validation to the beacon_processor: the relay
        decision returns DEFERRED and lands later via the queued
        handler's outcome. A full lane sheds the message (drop-counted by
        `submit`) — neither relayed nor penalized, never a stalled
        socket."""
        q = self._queued.get(topic)
        if q is not None:
            try:
                item = q.decode(data)
            except Exception:  # noqa: BLE001 — undecodable gossip: reject
                self.service.peers.report(origin, SCORE_INVALID_MESSAGE)
                inc_counter("gossip_invalid_total")
                return False
            self.service.processor.submit(
                q.work_type,
                _GossipWork(topic=topic, item=item, data=data, origin=origin),
                self._runner_for(q.work_type),
            )
            return DEFERRED
        handler = self._handlers.get(topic)
        if handler is None:
            return True  # relay-only topic: forwardable, nothing local
        try:
            handler(data)
        except Exception:  # noqa: BLE001 — invalid gossip: reject
            self.service.peers.report(origin, SCORE_INVALID_MESSAGE)
            inc_counter("gossip_invalid_total")
            return False
        self.service.peers.report(origin, SCORE_TIMELY_MESSAGE)
        return True

    # -- queued validation (worker side) ---------------------------------

    def _runner_for(self, work_type: WorkType):
        runner = self._runners.get(work_type)
        if runner is None:
            runner = (
                self._run_queued_batch
                if work_type in BATCHED_WORK_TYPES
                else self._run_queued_single
            )
            self._runners[work_type] = runner
        return runner

    def _run_queued_single(self, work: _GossipWork):
        entry = self._queued[work.topic]
        self._complete(work, self._classify(entry.process, work.item))

    def _run_queued_batch(self, works: list):
        """One drained batch of a coalescing kind: group by registration
        (all attestation subnets share one) and hand `process_batch` the
        whole item list — that is what turns a storm of per-message
        verifications into one RLC signature batch."""
        groups: dict[int, tuple[_QueuedTopic, list]] = {}
        for w in works:
            entry = self._queued[w.topic]
            fn = entry.process_batch or entry.process
            # group by the UNDERLYING function: distinct bound-method
            # objects wrapping the same method must coalesce
            key = id(getattr(fn, "__func__", fn))
            groups.setdefault(key, (entry, []))[1].append(w)
        for entry, ws in groups.values():
            if entry.process_batch is None:
                for w in ws:
                    self._complete(w, self._classify(entry.process, w.item))
                continue
            try:
                outcomes = entry.process_batch([w.item for w in ws])
                if len(outcomes) != len(ws):
                    # a short/long outcome list would leave tail messages
                    # with NO relay/score decision — the silent-drop class
                    # this pipeline is built to eliminate
                    raise RuntimeError(
                        f"process_batch returned {len(outcomes)} outcomes "
                        f"for {len(ws)} items"
                    )
            except Exception as e:  # noqa: BLE001 — whole-batch fault
                outcomes = [e] * len(ws)
            for w, err in zip(ws, outcomes):
                self._complete(w, err)

    @staticmethod
    def _classify(process, item):
        """Run one process step, returning its outcome exception (None =
        Accept). Workers never see these raise — classification is the
        router's, not the processor's error counter's."""
        try:
            process(item)
            return None
        except Exception as e:  # noqa: BLE001 — classified by _complete
            return e

    def _complete(self, work: _GossipWork, err):
        """Deferred relay/score decision (reference Accept/Ignore/Reject):
        clean = relay + credit; Ignore = drop quietly; Reject (a chain
        ValueError) = penalize origin, never relay; anything else
        is an INTERNAL error — our store/bug, not the peer's message — so
        it is logged and counted but costs the origin nothing."""
        if err is None:
            self.service.peers.report(work.origin, SCORE_TIMELY_MESSAGE)
            try:
                self._relay_q.put_nowait((work.topic, work.data, work.origin))
            except queue.Full:
                inc_counter("gossip_relay_dropped_total")
        elif isinstance(err, GossipIgnore):
            inc_counter("gossip_ignored_total")
        elif isinstance(err, ValueError):
            self.behaviour.complete_validation(
                work.topic, work.data, work.origin, False
            )
            self.service.peers.report(work.origin, SCORE_INVALID_MESSAGE)
            inc_counter("gossip_invalid_total")
        else:
            inc_counter("gossip_internal_error_total")
            log.warning(
                "gossip handler internal error",
                topic=_short_topic(work.topic),
                error=f"{type(err).__name__}: {str(err)[:200]}",
            )

    def _relay_loop(self):
        """Deferred-Accept completions: mcache entry, P2 credit, and the
        eager mesh forward (`behaviour.complete_validation`) — serialized
        off the worker pool so socket stalls cost relay latency, not
        validation throughput."""
        while not self._relay_stop.is_set():
            try:
                item = self._relay_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            topic, data, origin = item
            try:
                self.behaviour.complete_validation(topic, data, origin, True)
            except Exception as e:  # noqa: BLE001 — relay must outlive faults
                log.warning("gossip relay failed", error=str(e)[:200])

    def stop(self):
        """Stop the relay thread (joined — NetworkService.stop's
        zero-thread-leak audit covers it). Event-first: a full queue or a
        relay mid-send must not block the caller."""
        self._relay_stop.set()
        try:
            self._relay_q.put_nowait(None)
        except queue.Full:
            pass
        self._relay_thread.join(timeout=2)

    def _send_frame(self, peer_id: str, payload: bytes):
        """Every outbound gossip frame (data AND control: GRAFT/PRUNE/
        IHAVE) crosses the service's egress seam first — the fault plane
        the testnet harness scripts partitions/eclipses/late-delivery
        through. None = the edge is dark (frame dropped); >0 = delivered
        that many seconds late on a timer thread (the caller — relay
        thread, heartbeat — must never sleep for an injected delay)."""
        delay = self.service.egress_delay(peer_id)
        if delay is None:
            return
        if delay > 0:
            t = threading.Timer(delay, self._send_frame_now, args=(peer_id, payload))
            t.daemon = True
            t.start()
            return
        self._send_frame_now(peer_id, payload)

    def _send_frame_now(self, peer_id: str, payload: bytes):
        peer = self.service.peers.get(peer_id)
        if peer is None:
            return
        try:
            with peer.lock:
                if peer.gossip_sock is None:
                    return
                _send_block(peer.gossip_sock, payload)
        except OSError:
            self.service._drop_peer(peer)

    def _px_records(self, topic: str, exclude: str) -> list[tuple[str, str, int]]:
        """Peer-exchange records for a PRUNE: the topic's other mesh
        members, addressed as we dialed them."""
        out = []
        for pid in self.behaviour.mesh.get(topic, ()):
            if pid == exclude:
                continue
            peer = self.service.peers.get(pid)
            if peer is not None:
                out.append((peer.noise_peer_id or pid, peer.host, peer.port))
        return out

    _PX_DIAL_MAX_PEERS = 8

    def _dial_px(self):
        """Dial peer-exchange candidates on their own short-lived thread:
        connect() is a synchronous TCP+handshake and one dead PX record
        must not stall the heartbeat cadence (mesh repair, IHAVE
        emission) for a connect timeout."""
        candidates = self.behaviour.take_px_candidates()
        if not candidates:
            return
        threading.Thread(
            target=self._dial_px_worker,
            args=(candidates,),
            daemon=True,
            name=f"gossip-px-dial-{self.service.port}",
        ).start()

    def _dial_px_worker(self, candidates):
        svc = self.service
        for _pid, host, port in candidates:
            if svc._stopping:
                return
            have = {(p.host, p.port) for p in svc.peers.peers()}
            if len(have) >= self._PX_DIAL_MAX_PEERS:
                return
            if (host, port) in have or port == svc.port:
                continue
            try:
                svc.connect(host, port)
            except Exception:  # noqa: BLE001 — dead PX record; move on
                continue


# the sync engine lives in its own package (network/sync/); imported here
# AFTER the score constants it references at call time
from .sync import SyncConfig, SyncManager, SyncService  # noqa: E402


class NetworkService:
    """service/mod.rs analog: owns the listener, peers, gossip router and
    sync manager, and bridges gossip to the beacon chain (the network
    crate's Router + NetworkBeaconProcessor roles in one place)."""

    #: gossipsub heartbeat cadence (config.rs heartbeat_interval is 0.7s;
    #: shorter here — simulator slots are fast). 0/None disables the
    #: timer thread (tests drive `gossip.heartbeat()` by hand).
    HEARTBEAT_INTERVAL = 0.3

    def __init__(
        self,
        chain,
        host: str = "127.0.0.1",
        port: int = 0,
        bootnodes=None,
        transport=None,
        heartbeat_interval: float | None = HEARTBEAT_INTERVAL,
        gossip_params=None,
        gossip_thresholds=None,
        gossip_config=None,
        sync_config=None,
        processor_workers: int = 2,
        sync_service_interval: float | None = None,
        node_id: bytes | None = None,
    ):
        self.chain = chain
        self.spec = chain.spec
        # transport security seam: None = plain TCP; a NoiseTransport
        # (network/noise.py) secures every stream with the libp2p Noise XX
        # handshake, as the reference's transport builder does
        self.transport = transport
        self.peers = PeerManager()
        # the node's prioritized work-queue scheduler: sync segments and
        # backfill windows queue here (CHAIN_SEGMENT / BACKFILL_SYNC), and
        # unknown-block work parks in the reprocess queue until its block
        # lands (the NetworkBeaconProcessor wiring)
        self.processor = BeaconProcessor(
            num_workers=processor_workers, name="network_beacon_processor"
        )
        self.reprocess = ReprocessQueue()
        self.sync = SyncManager(self, config=sync_config)
        # autonomous catch-up (sync/manager.rs main-loop role): started in
        # start() when an interval is configured — the node path enables
        # it so range sync no longer waits for a caller. 0/None disables,
        # same convention as heartbeat_interval (a 0-second poll would be
        # a busy loop, not "continuous")
        self.sync_service = (
            SyncService(self.sync, interval=sync_service_interval)
            if sync_service_interval
            else None
        )
        self.metadata_seq = 1
        self.server = RpcServer(self, host, port)
        self.port = self.server.port
        self.heartbeat_interval = heartbeat_interval
        self._hb_thread = None
        self._stopping = False
        self._stop_event = threading.Event()
        #: last slot the heartbeat tick saw: reprocess slot drains/expiry
        #: fire once per slot edge
        self._last_tick_slot = -1
        # discv5 analog: advertise our record, bootstrap from bootnodes
        # (None → discovery disabled, as with the reference's --disable-discovery)
        self.discovery = None
        if bootnodes is not None:
            from .discovery import DiscoveryService

            self.discovery = DiscoveryService(
                tcp_port=self.port,
                fork_digest=self.fork_digest(),
                host=host,
                bootnodes=list(bootnodes),
            )

        # PeerDAS custody + sampling duty (das/): custody columns derive
        # from a stable node id — supplied by the scenario/fleet layer, or
        # defaulted from the listen port (deterministic per node). The DA
        # checker learns the custody set so its column route can complete.
        import hashlib as _hashlib

        from ..das import SamplingEngine
        from ..das.custody import column_subnet as _column_subnet

        self._column_subnet = _column_subnet
        if node_id is None:
            node_id = _hashlib.sha256(
                b"lighthouse-tpu-node" + self.port.to_bytes(8, "little")
            ).digest()
        self.node_id = bytes(node_id)
        self.sampling = SamplingEngine(self.node_id, chain.E)
        chain.data_availability_checker.set_custody(self.sampling.custody)
        #: roots whose sampling verdict has already been recorded (the
        #: slot-tick retry must not re-query peers for a settled root)
        self._sampled_roots: set = set()

        digest = self.fork_digest()
        self.topic_block = M.gossip_topic(digest, M.TOPIC_BEACON_BLOCK)
        # one topic per attestation subnet; a full node stays subscribed
        # to all of them (it relays every subnet, as the reference's
        # default subscribe-all-subnets simulator config does), while the
        # SubnetService tracks duty subnets for ENR advertisement and
        # eager mesh joins
        self.attestation_topics = {
            i: M.gossip_topic(digest, M.attestation_subnet_topic_name(i))
            for i in range(M.ATTESTATION_SUBNET_COUNT)
        }
        self.topic_att = self.attestation_topics[0]
        self.topic_aggregate = M.gossip_topic(digest, M.TOPIC_AGGREGATE)
        self.topic_exit = M.gossip_topic(digest, M.TOPIC_VOLUNTARY_EXIT)
        self.topic_proposer_slashing = M.gossip_topic(
            digest, M.TOPIC_PROPOSER_SLASHING
        )
        self.topic_attester_slashing = M.gossip_topic(
            digest, M.TOPIC_ATTESTER_SLASHING
        )
        self.topic_sync_committee = M.gossip_topic(
            digest, M.TOPIC_SYNC_COMMITTEE
        )
        self.topic_blob_sidecar = M.gossip_topic(digest, M.TOPIC_BLOB_SIDECAR)
        # one topic per data-column subnet (peerdas p2p): a full node
        # subscribes to all of them — it relays every column and its
        # custody subset is always fed — while custody tracking stays the
        # SamplingEngine's concern
        self.data_column_topics = {
            i: M.gossip_topic(digest, M.data_column_subnet_topic_name(i))
            for i in range(chain.E.DATA_COLUMN_SIDECAR_SUBNET_COUNT)
        }
        # scoring parameters are keyed by the node's actual topic strings,
        # so the router is built only once the topics exist
        # (gossipsub_scoring_parameters.rs shape)
        if gossip_params is None:
            gossip_params = beacon_score_params(
                self.topic_block,
                self.topic_aggregate,
                self.attestation_topics,
                extra_topics=[
                    self.topic_exit,
                    self.topic_proposer_slashing,
                    self.topic_attester_slashing,
                    self.topic_sync_committee,
                    self.topic_blob_sidecar,
                    *self.data_column_topics.values(),
                ],
            )
        if gossip_thresholds is None:
            gossip_thresholds = beacon_score_thresholds()
        self.gossip = GossipRouter(
            self,
            params=gossip_params,
            thresholds=gossip_thresholds,
            config=gossip_config,
        )
        # every gossip kind is queue-routed: thin decode on the reader
        # thread, chain work on its own prioritized WorkType lane
        # (network_beacon_processor/gossip_methods.rs shape)
        self.gossip.subscribe_queued(
            self.topic_block,
            WorkType.GOSSIP_BLOCK,
            self._decode_gossip_block,
            self._process_gossip_block,
        )
        # NOTE: each subnet registration mints a fresh bound-method
        # object; the batch runner groups by the UNDERLYING function
        # (`__func__`), so all 64 subnets still coalesce into one
        # process_attestation_batch call per drained batch
        for topic in self.attestation_topics.values():
            self.gossip.subscribe_queued(
                topic,
                WorkType.GOSSIP_ATTESTATION,
                self._decode_gossip_attestation,
                process_batch=self._process_gossip_attestation_batch,
            )
        self.gossip.subscribe_queued(
            self.topic_aggregate,
            WorkType.GOSSIP_AGGREGATE,
            self._decode_gossip_aggregate,
            self._process_gossip_aggregate,
        )
        self.gossip.subscribe_queued(
            self.topic_exit,
            WorkType.GOSSIP_VOLUNTARY_EXIT,
            self._decode_gossip_exit,
            self._process_gossip_exit,
        )
        self.gossip.subscribe_queued(
            self.topic_proposer_slashing,
            WorkType.GOSSIP_PROPOSER_SLASHING,
            self._decode_gossip_proposer_slashing,
            self._process_gossip_proposer_slashing,
        )
        self.gossip.subscribe_queued(
            self.topic_attester_slashing,
            WorkType.GOSSIP_ATTESTER_SLASHING,
            self._decode_gossip_attester_slashing,
            self._process_gossip_attester_slashing,
        )
        self.gossip.subscribe_queued(
            self.topic_sync_committee,
            WorkType.GOSSIP_SYNC_COMMITTEE,
            self._decode_gossip_sync_committee,
            self._process_gossip_sync_committee,
        )
        self.gossip.subscribe_queued(
            self.topic_blob_sidecar,
            WorkType.GOSSIP_BLOB_SIDECAR,
            self._decode_gossip_blob_sidecar,
            self._process_gossip_blob_sidecar,
        )
        # all column subnets share one lane and one underlying handler
        # function, same as the attestation subnets above
        for topic in self.data_column_topics.values():
            self.gossip.subscribe_queued(
                topic,
                WorkType.GOSSIP_DATA_COLUMN_SIDECAR,
                self._decode_gossip_data_column_sidecar,
                self._process_gossip_data_column_sidecar,
            )

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        self.server.start()
        if self.discovery is not None:
            self.discovery.start()
        if self.heartbeat_interval:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                daemon=True,
                name=f"gossip-heartbeat-{self.port}",
            )
            self._hb_thread.start()
        if self.sync_service is not None:
            self.sync_service.start()
        return self

    def _heartbeat_loop(self):
        while not self._stopping:
            self._stop_event.wait(self.heartbeat_interval)
            if self._stopping:
                break
            try:
                self.gossip.heartbeat()
            except Exception as e:  # noqa: BLE001 — heartbeat must outlive faults
                log.warning("gossip heartbeat failed", error=str(e)[:200])
            try:
                self.slot_tick()
            except Exception as e:  # noqa: BLE001 — ditto
                log.warning("slot tick failed", error=str(e)[:200])

    def slot_tick(self):
        """Once per slot edge (heartbeat-driven; tests call directly):
        re-fire reprocess work held for the new slot and expire held
        unknown-block work whose block never came — the bound that stops
        the ReprocessQueue leaking under storm. Idempotent within a slot."""
        slot = int(self.chain.slot_clock.now())
        if slot == self._last_tick_slot:
            return
        self._last_tick_slot = slot
        self.reprocess.slot_started(slot, self.processor)
        self.reprocess.expire(slot)
        # per-slot PeerDAS sampling duty: retry staged blocks still
        # lacking a positive verdict (das/sampling.py)
        self._sample_pending()
        # slasher epoch detection rides its own lowest-priority processor
        # lane (WorkType.SLASHER_PROCESS) — queued here, never run on this
        # heartbeat thread; the service's epoch claim keeps this and the
        # client slot timer from double-processing
        if self.chain.slasher_service is not None:
            self.chain.slasher_service.on_slot(slot, processor=self.processor)
        # next-slot state pre-advance rides its own low-priority lane
        # (WorkType.STATE_ADVANCE) — queued here, never run on this
        # heartbeat thread; the timer's slot claim keeps this and the
        # client slot timer from double-advancing
        if self.chain.state_advance_timer is not None:
            self.chain.state_advance_timer.on_slot_tick(
                slot, processor=self.processor
            )

    def discover_and_connect(self, max_peers: int = 8) -> int:
        """One discovery round → dial every new connectable record
        (discovery.rs find_peers → peer_manager dial flow)."""
        if self.discovery is None:
            return 0
        self.discovery.maintain()  # evict stale records before querying
        connected = 0
        have = {(p.host, p.port) for p in self.peers.peers()}
        local_id = self.discovery.local_enr.node_id
        for enr in self.discovery.discover():
            if connected >= max_peers:
                break
            addr = (enr.ip, enr.tcp_port)
            if addr in have or enr.node_id == local_id:
                continue
            try:
                self.connect(*addr)  # refuses banned peers before dialing
            except Exception:  # noqa: BLE001 — dead record; discovery moves on
                continue
            have.add(addr)
            connected += 1
        return connected

    def stop(self):
        """Graceful teardown, audited for thread leaks: the sync-service
        loop, the heartbeat/slot-tick thread, the RPC server, and the
        processor's manager+workers are all JOINED; queued processor work
        is abandoned with a counter, and held reprocess work is cleared
        the same way — nothing dropped silently, nothing left running."""
        self._stopping = True
        self._stop_event.set()
        if self.sync_service is not None:
            self.sync_service.stop()
        self.sync.stop()
        # the heartbeat/slot-tick thread joins BEFORE the processor shuts
        # down: an in-flight slot_tick re-submits drained reprocess work,
        # which must not land in a dead processor's queues (it would sit
        # there uncounted — the silent drop this audit exists to prevent)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
            self._hb_thread = None
        self.gossip.stop()
        if self.discovery is not None:
            self.discovery.stop()
        for p in self.peers.peers():
            try:
                p.client.goodbye(M.GOODBYE_CLIENT_SHUTDOWN)
            except Exception:  # noqa: BLE001
                pass
            self._drop_peer(p)
        self.server.stop()
        self.processor.shutdown()
        self.reprocess.clear()

    # -- fault-plane seam --------------------------------------------------------

    def egress_delay(self, peer_id: str) -> float | None:
        """Gossip egress policy for one outbound frame to `peer_id`:
        0.0 = send now (production behavior), a positive value = deliver
        that late, None = drop (the edge is dark). The testnet fault
        plane (testing/testnet.py) overrides this to script partitions,
        eclipses, and late-delivery regimes over otherwise-real nodes."""
        return 0.0

    # -- identity / status ------------------------------------------------------

    def fork_digest(self) -> bytes:
        st = self.chain.head_state
        return M.compute_fork_digest(
            self.spec, st.fork.current_version, st.genesis_validators_root
        )

    def local_status(self) -> M.StatusMessage:
        chain = self.chain
        fin = chain.finalized_checkpoint
        return M.StatusMessage(
            fork_digest=self.fork_digest(),
            finalized_root=fin.root,
            finalized_epoch=fin.epoch,
            head_root=chain.head_root,
            head_slot=chain.head_state.slot,
        )

    # -- peer connection --------------------------------------------------------

    def connect(self, host: str, port: int) -> Peer:
        """Dial a peer: Status handshake (irrelevant-network check), then a
        persistent gossip stream."""
        if self.peers.is_banned(f"{host}:{port}"):
            raise RpcError("peer is banned")
        client = RpcClient(host, port, transport=self.transport, mux=True)
        try:
            status = client.status(self.local_status())
            if bytes(status.fork_digest) != self.fork_digest():
                client.goodbye(M.GOODBYE_IRRELEVANT_NETWORK)
                raise RpcError("peer on a different fork digest")
        except BaseException:
            # the muxed connection (+ reader thread) must not outlive a
            # failed dial
            client.close()
            raise
        peer = Peer(host=host, port=port, client=client, status=status)
        try:
            # the gossip stream rides the SAME muxed connection as the RPC
            # substreams — one TCP (+ one noise handshake) per direction
            gossip_sock = client._open(M.PROTO_GOSSIP)
            peer.noise_peer_id = getattr(gossip_sock, "remote_peer_id", None)
            peer.gossip_sock = gossip_sock
            # bounded I/O: a stalled remote must not wedge publish (sendall
            # holds peer.lock); the reader probes idle timeouts harmlessly
            peer.gossip_sock.settimeout(_GOSSIP_IO_TIMEOUT)
            # announce our listening port so the peer can identify us
            # (_open already negotiated the gossip protocol on the stream)
            _send_block(peer.gossip_sock, self.port.to_bytes(4, "little"))
        except BaseException:
            client.close()
            raise
        if not self.peers.add(peer):
            # refusal cleanup must not mask the refusal: close/goodbye are
            # best-effort against a peer that may already be gone
            try:
                peer.gossip_sock.close()
                client.goodbye(M.GOODBYE_BANNED)
            except (OSError, RpcError):
                pass
            client.close()
            raise RpcError("peer is banned")
        # register with the behaviour (and announce our subscriptions)
        # BEFORE the reader starts: the remote's SUBSCRIBE frames arrive
        # immediately and would be dropped for an unknown peer
        self.gossip.behaviour.add_peer(peer.peer_id)
        # a fresh peer may be the way out of a capped sync backoff or a
        # negatively-cached lookup root (partition heal): wake the loop
        # instead of sleeping it out, and void the "nobody had it" verdicts
        self.sync.lookups.peer_connected()
        if self.sync_service is not None:
            self.sync_service.on_peer_connected()
        t = threading.Thread(
            target=self._gossip_reader,
            args=(peer.gossip_sock, peer.peer_id),
            daemon=True,
            name=f"gossip-{peer.peer_id}",
        )
        t.start()
        return peer

    def _drop_peer(self, peer: Peer):
        with peer.lock:  # publish checks/uses the socket under this lock
            if peer.gossip_sock is not None:
                try:
                    peer.gossip_sock.close()
                except OSError:
                    pass
                peer.gossip_sock = None
        try:
            peer.client.close()  # tear down the muxed RPC connection
        except OSError:
            pass
        self.gossip.behaviour.remove_peer(peer.peer_id)
        self.peers.remove(peer.peer_id)

    # -- gossip plumbing --------------------------------------------------------

    def _handle_gossip_stream(self, sock):
        """Server side of an inbound gossip stream: register the dialer as
        a peer (by its announced listen port) and read messages forever."""
        listen_port = int.from_bytes(_recv_block(sock), "little")
        host = sock.getpeername()[0]
        peer = Peer(
            host=host,
            port=listen_port,
            client=RpcClient(
                host, listen_port, transport=self.transport, mux=True
            ),
            gossip_sock=sock,
            noise_peer_id=getattr(sock, "remote_peer_id", None),
        )
        if not self.peers.add(peer):
            try:
                sock.close()
            except OSError:
                pass
            return
        self.gossip.behaviour.add_peer(peer.peer_id)
        self.sync.lookups.peer_connected()
        if self.sync_service is not None:
            self.sync_service.on_peer_connected()
        self._gossip_reader(sock, peer.peer_id)

    def _gossip_reader(self, sock, peer_id: str):
        sock.settimeout(_GOSSIP_IO_TIMEOUT)
        while not self._stopping:
            # idle-safe probe: a timeout BEFORE a frame starts just retries;
            # a timeout mid-frame (stalled sender) is a real failure
            try:
                first = sock.recv(1)
            except TimeoutError:
                continue
            except OSError:
                break
            if not first:
                break
            try:
                framed = _recv_block(sock, first_byte=first)
            except (RpcError, OSError):
                break
            if self.peers.is_banned(peer_id):
                break  # ban landed while this frame was in flight
            self.gossip.on_frame(peer_id, framed)

    # -- chain bridging (network_beacon_processor/gossip_methods.rs) ------------

    def decode_block(self, data: bytes):
        try:
            return self.chain.types.decode_by_fork("SignedBeaconBlock", data)
        except ValueError as e:
            raise RpcError(str(e)) from e

    # decode steps run INLINE on the socket reader (cheap SSZ work only;
    # raising rejects + downscores); process steps run on beacon_processor
    # workers and classify via GossipIgnore / ValueError / internal error.

    def _decode_gossip_block(self, data: bytes):
        import time as _time

        signed = self.decode_block(data)
        # observation milestone at the earliest point we can name the
        # block: even if the import detours through the queue or a parent
        # lookup, the eventual BlockTimes keeps the true gossip arrival.
        # Clock-clamped: a hostile far-future slot must not enter the
        # cache (it would never be min-slot-evicted nor finality-pruned)
        slot = int(signed.message.slot)
        if slot <= self.chain.slot_clock.now() + 1:
            self.chain.block_times_cache.set_observed(
                signed.message.hash_tree_root(), slot, _time.monotonic()
            )
        return signed

    def _process_gossip_block(self, signed):
        from ..beacon_chain.chain import BlobsUnavailableError, BlockError

        try:
            root = self.chain.process_block(signed)
        except BlobsUnavailableError:
            # expected ordering race, not peer fault: the block is staged
            # in the DA checker and plausibly valid — relay it (the
            # completing sidecar's handler imports it here later)
            log.info("block waiting on sidecars", slot=signed.message.slot)
            return
        except BlockError as e:
            if "parent unknown" in str(e):
                # not the forwarder's fault either: WE are missing the
                # ancestry — recover it via a parent lookup instead of
                # downscoring (sync/block_lookups parent-chain path)
                log.info(
                    "gossip block has unknown parent; starting lookup",
                    slot=signed.message.slot,
                )
                self.sync.on_unknown_parent_block(signed)
                raise GossipIgnore("unknown parent") from e
            raise  # BlockError(ValueError): genuine invalidity → reject
        # release work parked under this root (attestations that arrived
        # before the block, the usual out-of-order gossip case) — without
        # this, only lookup-recovered blocks would ever drain the queue
        self.reprocess.block_imported(root, self.processor)
        log.info(
            "gossip block imported",
            slot=signed.message.slot,
            root=root.hex()[:12],
        )

    def _decode_gossip_attestation(self, data: bytes):
        return self.chain.types.Attestation.deserialize(data)

    def _process_gossip_attestation_batch(self, atts: list) -> list:
        """A whole drained GOSSIP_ATTESTATION batch in ONE RLC signature
        verification — the coalescing that makes the attestation lane
        survive a flood. Returns one outcome per item (None = accept)."""
        results = self.chain.process_attestation_batch(atts)
        out = []
        for att, res in zip(atts, results):
            if not isinstance(res, Exception):
                out.append(None)
            elif "unknown beacon block root" in str(res):
                out.append(self._park_unknown_root_attestation(att))
            elif "outside propagation window" in str(res):
                out.append(self._park_early_attestation(att, res))
            else:
                out.append(res)
        return out

    #: clock-disparity tolerance for EARLY gossip (the reference's
    #: MAXIMUM_GOSSIP_CLOCK_DISPARITY role, in slots): work this far
    #: ahead parks until its slot starts; further is a hostile timestamp
    EARLY_ATTESTATION_SLOT_TOLERANCE = 2

    def _park_early_attestation(self, att, err):
        """Propagation-window violations are IGNORE, never Reject (the
        gossip spec's ATTESTATION_PROPAGATION_SLOT_RANGE semantics —
        lateness is congestion, not malice, and penalizing it graylists
        honest mesh peers exactly when the network is struggling). The
        near-future case (peer clock slightly ahead) additionally parks
        until its slot starts — the slot tick re-fires it through
        `_reprocess_attestation`. Hostile far-future timestamps are
        ignored WITHOUT parking (they must not occupy the queue)."""
        slot = int(att.data.slot)
        now = int(self.chain.slot_clock.now())
        if now < slot <= now + self.EARLY_ATTESTATION_SLOT_TOLERANCE:
            self.reprocess.hold_for_slot(
                slot,
                WorkEvent(
                    WorkType.UNKNOWN_BLOCK_ATTESTATION,
                    att,
                    self._reprocess_attestation,
                ),
            )
            return GossipIgnore("early attestation held for its slot")
        return GossipIgnore(str(err))

    def _park_unknown_root_attestation(self, att):
        """Hold the attestation until its block lands (the
        work_reprocessing_queue path, now capped + slot-stamped) and go
        find the block; a cap refusal is load shed, still an Ignore."""
        root = bytes(att.data.beacon_block_root)
        held = self.reprocess.hold_for_block(
            root,
            WorkEvent(
                WorkType.UNKNOWN_BLOCK_ATTESTATION,
                att,
                self._reprocess_attestation,
            ),
            slot=int(att.data.slot),
        )
        if held:
            self.sync.on_unknown_block_root(root)
        return GossipIgnore("unknown beacon block root")

    def _reprocess_attestation(self, att):
        """Reprocess-queue re-fire: the unknown block imported, so the held
        attestation gets its real verification pass now. Its verdict (an
        AttestationError: it became a duplicate while held, or left its
        window) drops it, as the gossip path's verdicts drop theirs; only
        an exception that escapes verification is an internal error, which
        the worker counts in beacon_processor_errors_total. (The JAX
        package raises the verdict too, so a fleet's zero-internal-error
        invariant failed on a routine duplicate after a heal.)"""
        self.chain.process_attestation_batch([att])

    def _decode_gossip_aggregate(self, data: bytes):
        return self.chain.types.SignedAggregateAndProof.deserialize(data)

    def _process_gossip_aggregate(self, agg):
        """Aggregates get the same unknown-root parking attestations
        have: an aggregate that beats its block by one hop is parked, not
        an error charged to an innocent forwarder."""
        from ..beacon_chain.attestation_verification import AttestationError

        try:
            self.chain.process_aggregate(agg)
        except AttestationError as e:
            if "outside propagation window" in str(e):
                # window violations are IGNORE, same as attestations
                raise GossipIgnore(str(e)) from e
            if "unknown beacon block root" not in str(e):
                raise
            data = agg.message.aggregate.data
            root = bytes(data.beacon_block_root)
            held = self.reprocess.hold_for_block(
                root,
                WorkEvent(
                    WorkType.UNKNOWN_BLOCK_AGGREGATE,
                    agg,
                    self._reprocess_aggregate,
                ),
                slot=int(data.slot),
            )
            if held:
                self.sync.on_unknown_block_root(root)
            raise GossipIgnore("unknown beacon block root") from e

    def _reprocess_aggregate(self, agg):
        """As _reprocess_attestation: a verdict drops the held aggregate."""
        from ..beacon_chain.attestation_verification import AttestationError

        try:
            self.chain.process_aggregate(agg)
        except AttestationError:
            pass

    # exits/slashings are spec-verified (signatures included) against the
    # head state before pooling — an unverifiable op would otherwise be
    # packed into our own proposal (gossip_methods.rs); the process steps
    # are thin late-binding wrappers over the chain methods (a ValueError
    # from the spec check classifies as a reject).

    def _decode_gossip_exit(self, data: bytes):
        return self.chain.types.SignedVoluntaryExit.deserialize(data)

    def _process_gossip_exit(self, exit_):
        self.chain.process_voluntary_exit(exit_)

    def _decode_gossip_proposer_slashing(self, data: bytes):
        return self.chain.types.ProposerSlashing.deserialize(data)

    def _process_gossip_proposer_slashing(self, slashing):
        self.chain.process_proposer_slashing(slashing)

    def _decode_gossip_attester_slashing(self, data: bytes):
        return self.chain.types.AttesterSlashing.deserialize(data)

    def _process_gossip_attester_slashing(self, slashing):
        self.chain.process_attester_slashing(slashing)

    def _decode_gossip_sync_committee(self, data: bytes):
        return self.chain.types.SyncCommitteeMessage.deserialize(data)

    def _process_gossip_sync_committee(self, msg):
        self.chain.process_sync_committee_message(msg)

    def _decode_gossip_blob_sidecar(self, data: bytes):
        return self.chain.types.BlobSidecar.deserialize(data)

    def _process_gossip_blob_sidecar(self, sc):
        """KZG-verify and stage a gossiped sidecar; when this sidecar
        completes a staged block's set, import that block NOW — its own
        gossip arrived earlier, failed the DA gate, and is dedup'd by the
        seen-cache, so nothing else will retry it. An unknown PARENT for
        the completed block starts a lookup instead of downscoring the
        sidecar's forwarder (it did nothing wrong)."""
        block_root = sc.signed_block_header.message.hash_tree_root()
        avail = self.chain.process_blob_sidecars(block_root, [sc])
        self._import_completed_block(block_root, avail)

    def _import_completed_block(self, block_root: bytes, avail):
        """Import a block whose DA components just became complete (blob
        and column sidecar handlers + the sampling verdict path). An
        unknown PARENT starts a lookup; any other import failure is
        Ignore, never a penalty — the component's forwarder could not
        have known (the component itself verified), and the block's own
        gossip path penalizes whoever forwarded an invalid block."""
        from ..beacon_chain.chain import BlockError

        if not avail.available or self.chain.fork_choice.contains_block(
            block_root
        ):
            return
        try:
            self.chain.process_block(avail.block)
        except BlockError as e:
            if "parent unknown" in str(e):
                log.info(
                    "completed block has unknown parent; starting lookup",
                    root=block_root.hex()[:12],
                )
                self.sync.on_unknown_parent_block(avail.block)
                raise GossipIgnore("unknown parent") from e
            log.info(
                "completed block failed import",
                root=block_root.hex()[:12],
                error=str(e)[:120],
            )
            raise GossipIgnore(str(e)) from e
        self.reprocess.block_imported(block_root, self.processor)

    def _decode_gossip_data_column_sidecar(self, data: bytes):
        return self.chain.types.DataColumnSidecar.deserialize(data)

    def _process_gossip_data_column_sidecar(self, sc):
        """Verify (header binding + batched cell KZG) and stage a gossiped
        data column; then run the sampling duty for its block if still
        unsettled — a column arriving means its block is circulating, so
        peers plausibly hold the sample columns by now. Availability may
        complete here via any column route (custody+sampling or >=50%
        reconstruction) and imports the staged block exactly as a
        completing blob does."""
        from ..beacon_chain.chain import BlobsUnavailableError

        block_root = sc.signed_block_header.message.hash_tree_root()
        try:
            avail = self.chain.process_data_column_sidecars(block_root, [sc])
        except BlobsUnavailableError as e:
            # IGNORE class: locally missing prerequisites (e.g. no KZG
            # engine) — never the forwarder's fault
            raise GossipIgnore(str(e)) from e
        self._maybe_sample(block_root)
        if not avail.available:
            avail = self.chain.data_availability_checker.check_availability(
                block_root
            )
        self._import_completed_block(block_root, avail)

    # -- PeerDAS sampling duty (das/sampling.py) --------------------------------

    def _maybe_sample(self, block_root: bytes):
        """One sampling attempt per root: query the engine's selected
        non-custody columns from peers (DataColumnSidecarsByRoot), stage
        whatever verified, and record the verdict with the DA checker."""
        checker = self.chain.data_availability_checker
        if (
            block_root in self._sampled_roots
            or not checker.sampling_pending(block_root)
        ):
            return
        self._sampled_roots.add(block_root)
        have = set(checker.staged_columns(block_root))
        ok, fetched = self.sampling.sample(
            block_root, have, lambda col: self._fetch_column(block_root, col)
        )
        if fetched:
            try:
                self.chain.process_data_column_sidecars(
                    block_root, fetched, verify_header_signature=False
                )
            except ValueError:
                # a peer served a non-verifying sample: counts as a miss
                ok = False
        checker.set_sampling_result(
            block_root, ok, slot=self.chain.slot_clock.now()
        )

    def _fetch_column(self, block_root: bytes, column: int):
        """First peer that serves (and roots) the requested column wins."""
        ident = M.BlobIdentifier(block_root=block_root, index=int(column))
        decode = self.chain.types.DataColumnSidecar.deserialize
        for peer in self.peers.peers():
            try:
                scs = peer.client.data_column_sidecars_by_root([ident], decode)
            except (RpcError, OSError, ValueError):
                continue
            for sc in scs:
                if (
                    int(sc.index) == int(column)
                    and sc.signed_block_header.message.hash_tree_root()
                    == block_root
                ):
                    return sc
        return None

    def _sample_pending(self):
        """Slot-tick retry: staged blocks without a positive sampling
        verdict (their columns raced ahead of the block, no peer held the
        samples yet, or an earlier attempt missed) get one fresh attempt
        per slot edge."""
        checker = self.chain.data_availability_checker
        for root in checker.pending_roots():
            if not checker.staged_columns(root):
                continue  # no column traffic for this block: blob route
            self._sampled_roots.discard(root)  # one fresh attempt per edge
            try:
                self._maybe_sample(root)
                self._import_completed_block(
                    root, checker.check_availability(root)
                )
            except (ValueError, GossipIgnore):
                # AvailabilityCheckError / ignorable import outcome:
                # nothing to relay or penalize on a timer tick
                continue
        # settled roots that left the pending dict no longer need their
        # dedup marker (bound the set across a long run)
        self._sampled_roots &= set(checker.pending_roots(with_block=False))

    # -- publishing -------------------------------------------------------------

    def publish_block(self, signed_block):
        self.gossip.publish(self.topic_block, signed_block.serialize())

    def publish_attestation(self, attestation):
        """Publish on the attestation's own subnet topic
        (compute_subnet_for_attestation over the committee layout)."""
        t = self.chain.types
        data = attestation.data
        try:
            from ..state_processing.accessors import committee_cache_at

            cc = committee_cache_at(
                self.chain.head_state, data.target.epoch, self.chain.E
            )
            subnet = M.compute_subnet_for_attestation(
                cc.committees_per_slot, data.slot, data.index, self.chain.E
            )
        except Exception:  # noqa: BLE001 — unknown epoch: default subnet
            subnet = 0
        self.gossip.publish(
            self.attestation_topics[subnet],
            t.Attestation.serialize_value(attestation),
        )

    def publish_aggregate(self, signed_aggregate):
        self.gossip.publish(self.topic_aggregate, signed_aggregate.serialize())

    def publish_voluntary_exit(self, signed_exit):
        self.gossip.publish(self.topic_exit, signed_exit.serialize())

    def publish_proposer_slashing(self, slashing):
        self.gossip.publish(self.topic_proposer_slashing, slashing.serialize())

    def publish_attester_slashing(self, slashing):
        self.gossip.publish(self.topic_attester_slashing, slashing.serialize())

    def publish_sync_committee_message(self, message):
        self.gossip.publish(self.topic_sync_committee, message.serialize())

    def publish_blob_sidecar(self, sidecar):
        self.gossip.publish(self.topic_blob_sidecar, sidecar.serialize())

    def publish_data_column_sidecar(self, sidecar):
        """Publish a column on its own subnet topic (column j rides
        subnet j % DATA_COLUMN_SIDECAR_SUBNET_COUNT)."""
        subnet = self._column_subnet(sidecar.index, self.chain.E)
        self.gossip.publish(self.data_column_topics[subnet], sidecar.serialize())

    # -- RPC server data providers ----------------------------------------------

    def blocks_by_range(self, start_slot: int, count: int):
        return [signed for _root, signed in self._blocks_by_range_with_roots(
            start_slot, count
        )]

    def _blocks_by_range_with_roots(self, start_slot: int, count: int):
        """Canonical chain walk from head backwards (store-backed); each
        block's root comes free from the walk — never re-hashed."""
        chain = self.chain
        root = chain.head_root
        wanted = range(int(start_slot), int(start_slot) + int(count))
        found = {}
        while root and root != b"\x00" * 32:
            signed = chain._blocks_by_root.get(root) or chain.store.get_block(root)
            if signed is None:
                break
            slot = signed.message.slot
            if slot < int(start_slot):
                break
            if slot in wanted:
                found[slot] = (bytes(root), signed)
            root = signed.message.parent_root
        return [found[slot] for slot in sorted(found)]

    def blocks_by_root(self, roots: list):
        out = []
        for root in roots:
            signed = self.chain._blocks_by_root.get(bytes(root)) or (
                self.chain.store.get_block(bytes(root))
            )
            if signed is not None:
                out.append(signed)
        return out

    def blob_sidecars_by_range(self, start_slot: int, count: int):
        """Sidecars for canonical blocks in [start, start+count) in
        (slot, index) order (deneb/p2p BlobSidecarsByRange)."""
        out = []
        for root, _signed in self._blocks_by_range_with_roots(start_slot, count):
            out.extend(self.chain.store.get_blob_sidecars(root))
        return out

    def blob_sidecars_by_root(self, blob_ids: list):
        out = []
        by_root: dict[bytes, list] = {}
        for bid in blob_ids:
            root = bytes(bid.block_root)
            if root not in by_root:
                by_root[root] = self.chain.store.get_blob_sidecars(root)
            for sc in by_root[root]:
                if int(sc.index) == int(bid.index):
                    out.append(sc)
        return out

    def data_column_sidecars_by_range(
        self, start_slot: int, count: int, columns: list
    ):
        """Column sidecars for canonical blocks in [start, start+count),
        filtered to the requested column indices (peerdas p2p
        DataColumnSidecarsByRange)."""
        wanted = {int(c) for c in columns}
        out = []
        for root, _signed in self._blocks_by_range_with_roots(start_slot, count):
            for sc in self._columns_for_root(root):
                if not wanted or int(sc.index) in wanted:
                    out.append(sc)
        return out

    def data_column_sidecars_by_root(self, column_ids: list):
        out = []
        by_root: dict[bytes, list] = {}
        for cid in column_ids:
            root = bytes(cid.block_root)
            if root not in by_root:
                by_root[root] = self._columns_for_root(root)
            for sc in by_root[root]:
                if int(sc.index) == int(cid.index):
                    out.append(sc)
        return out

    def _columns_for_root(self, root: bytes) -> list:
        """Persisted columns for imported blocks; staged (verified but
        not-yet-imported) columns otherwise — sampling peers must be able
        to serve within the block's own slot, before import lands."""
        stored = self.chain.store.get_data_column_sidecars(root)
        if stored:
            return stored
        staged = self.chain.data_availability_checker.staged_columns(root)
        return [staged[j] for j in sorted(staged)]
