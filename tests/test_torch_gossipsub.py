"""The port's gossipsub mesh held to the JAX package's.

Both packages' `GossipsubBehaviour` (the core of the network's
GossipRouter: mesh, mcache, IHAVE/IWANT, peer exchange, scores) get the
same seeded random and one scripted run: peers joining and leaving,
subscriptions, local and remote publishes (valid, invalid and deferred
to the beacon processor), GRAFT, PRUNE with peer records, IHAVE and IWANT
frames and heartbeats. After each heartbeat the mesh, the frames sent
(as bytes, in order), the scores, the backoffs and the peer-exchange
candidates must be equal."""

import hashlib
import random

import pytest

from lighthouse_tpu.network import gossipsub as J
from lighthouse_tpu.network.gossipsub import behaviour as Jb
from lighthouse_tpu_torch.network import gossipsub as P
from lighthouse_tpu_torch.network.gossipsub import behaviour as Pb

TOPICS = [f"/eth2/0a0b0c0d/{name}/ssz_snappy" for name in ("beacon_block", "beacon_aggregate_and_proof", "beacon_attestation_3")]


def _mid(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:20]


class _Node:
    def __init__(self, G, B, seed: int, cfg: dict):
        self.G, self.B = G, B
        self.sent: list[tuple[str, bytes]] = []
        self.delivered: list[tuple[str, bytes, str]] = []
        self.verdicts = random.Random(seed + 1)
        self.deferred: list[tuple[str, bytes, str]] = []
        params = G.beacon_score_params(TOPICS[0], TOPICS[1], {3: TOPICS[2]})
        self.b = G.GossipsubBehaviour(
            send=lambda pid, raw: self.sent.append((pid, bytes(raw))),
            deliver=self._deliver,
            mid_fn=_mid,
            px_provider=lambda topic, exclude: [
                (p, "10.0.0.%d" % (i + 1), 9000 + i) for i, p in enumerate(sorted(self.b.mesh.get(topic, ()))) if p != exclude
            ],
            params=params,
            thresholds=G.beacon_score_thresholds(),
            config=G.GossipsubConfig(**cfg),
            seed=seed,
        )

    def _deliver(self, topic, data, origin):
        self.delivered.append((topic, data, origin))
        r = self.verdicts.random()
        if r < 0.15:
            return False
        if r < 0.35:
            self.deferred.append((topic, data, origin))
            return self.B.DEFERRED
        return True

    def snapshot(self) -> dict:
        b = self.b
        return {
            "mesh": {t: sorted(p) for t, p in sorted(b.mesh.items())},
            "sent": list(self.sent),
            "delivered": list(self.delivered),
            "scores": {p: round(b.peer_score(p), 12) for p in sorted(b.peers)},
            "backoff": sorted(b.backoff.items()),
            "px": b.take_px_candidates(),
            "peer_topics": {p: sorted(t) for p, t in sorted(b.peer_topics.items())},
            "mcache": len(b.mcache),
            "ticks": b.ticks,
        }


def _run(G, B, seed: int, cfg: dict) -> list:
    node = _Node(G, B, seed, cfg)
    F = G  # the frame classes are exported by the package
    rng = random.Random(seed)
    peers = [f"peer{i}" for i in range(14)]
    live: list[str] = []
    known_mids: list[bytes] = []
    node.b.subscribe(TOPICS[0])
    node.b.subscribe(TOPICS[2])
    out = []
    for step in range(700):
        op = rng.random()
        topic = rng.choice(TOPICS)
        if op < 0.08 or not live:
            p = rng.choice(peers)
            if p not in live:
                node.b.add_peer(p)
                live.append(p)
                for t in TOPICS:
                    if rng.random() < 0.8:
                        node.b.handle_frame(p, F.SubscriptionFrame(subscribe=True, topic=t.encode()))
        elif op < 0.1:
            p = rng.choice(live)
            node.b.remove_peer(p)
            live.remove(p)
        elif op < 0.3:
            data = rng.getrandbits(64 * 8).to_bytes(64, "big") if rng.random() < 0.8 or not known_mids else b"dup"
            known_mids.append(_mid(data))
            node.b.handle_frame(rng.choice(live), F.PublishFrame(topic=topic.encode(), data=data))
        elif op < 0.36:
            data = b"local" + rng.getrandbits(64).to_bytes(8, "big")
            known_mids.append(_mid(data))
            node.b.publish(topic, data)
        elif op < 0.42 and node.deferred:
            t, data, origin = node.deferred.pop(rng.randrange(len(node.deferred)))
            node.b.complete_validation(t, data, origin, rng.random() < 0.8)
        elif op < 0.48:
            node.b.handle_frame(rng.choice(live), F.GraftFrame(topic=topic.encode()))
        elif op < 0.52:
            px = [F.PeerRecord(peer_id=rng.choice(peers).encode(), host=b"10.1.1.1", port=rng.randint(1, 65535)) for _ in range(rng.randint(0, 3))]
            node.b.handle_frame(rng.choice(live), F.PruneFrame(topic=topic.encode(), backoff=rng.randint(0, 40), px=px))
        elif op < 0.6:
            mids = [rng.choice(known_mids) if known_mids and rng.random() < 0.5 else rng.getrandbits(160).to_bytes(20, "big") for _ in range(rng.randint(1, 6))]
            node.b.handle_frame(rng.choice(live), F.IHaveFrame(topic=topic.encode(), message_ids=mids))
        elif op < 0.66 and known_mids:
            mids = [rng.choice(known_mids) for _ in range(rng.randint(1, 4))]
            node.b.handle_frame(rng.choice(live), F.IWantFrame(message_ids=mids))
        elif op < 0.68:
            node.b.handle_frame(rng.choice(live), F.SubscriptionFrame(subscribe=rng.random() < 0.5, topic=topic.encode()))
        elif op < 0.7:
            (node.b.subscribe if rng.random() < 0.7 else node.b.unsubscribe)(topic)
        elif op < 0.72:
            node.b.graft_now(topic)
        elif op < 0.85:
            node.b.heartbeat()
            out.append(node.snapshot())
            node.sent.clear()
            node.delivered.clear()
    node.b.heartbeat()
    out.append(node.snapshot())
    return out


CONFIGS = {
    "default": {},
    "small_mesh": {"d": 3, "d_lo": 2, "d_hi": 4, "d_lazy": 2, "d_score": 1, "prune_backoff": 4},
    "no_flood": {"flood_publish": False, "gossip_retransmission": 1, "max_ihave_messages": 2},
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mesh_frames_and_scores_equal_after_each_heartbeat(config, seed):
    jax_run = _run(J, Jb, seed, CONFIGS[config])
    port_run = _run(P, Pb, seed, CONFIGS[config])
    assert len(port_run) == len(jax_run) > 10
    for i, (p, j) in enumerate(zip(port_run, jax_run)):
        assert p == j, f"heartbeat {i}"
    # the run exercised what it claims to hold equal
    frames = [J.decode_frame(raw) for snap in jax_run for _, raw in snap["sent"]]
    kinds = {type(f).__name__ for f in frames}
    assert {"PublishFrame", "GraftFrame", "PruneFrame", "IHaveFrame", "IWantFrame", "SubscriptionFrame"} <= kinds
    assert any(s < 0 for snap in jax_run for s in snap["scores"].values())


def _px_run(G, B) -> list:
    """A peer earns score with first deliveries on the block topic, then
    prunes us with peer records: both packages take the same candidates
    (and none from a peer under the accept-PX threshold)."""
    node = _Node(G, B, 7, {})
    node.verdicts = random.Random(0)
    node.b.subscribe(TOPICS[0])
    for p in ("good", "poor"):
        node.b.add_peer(p)
        node.b.handle_frame(p, G.SubscriptionFrame(subscribe=True, topic=TOPICS[0].encode()))
    node.b.heartbeat()
    for i in range(30):
        node.b.handle_frame("good", G.PublishFrame(topic=TOPICS[0].encode(), data=b"m%d" % i))
    out = [node.snapshot()]
    for who in ("good", "poor"):
        px = [G.PeerRecord(peer_id=b"%s-rec%d" % (who.encode(), i), host=b"10.2.2.2", port=7000 + i) for i in range(3)]
        node.b.handle_frame(who, G.PruneFrame(topic=TOPICS[0].encode(), backoff=8, px=px))
        node.b.heartbeat()
        out.append(node.snapshot())
    return out


def test_peer_exchange_candidates_equal():
    jax_run, port_run = _px_run(J, Jb), _px_run(P, Pb)
    assert port_run == jax_run
    assert [len(s["px"]) for s in jax_run] == [0, 3, 0]


def test_package_exports_equal():
    assert sorted(P.__all__) == sorted(J.__all__)
    assert vars(P.GossipsubConfig()) == vars(J.GossipsubConfig())
