"""The port's network wire layer held to the JAX package's.

The same seeded inputs go through both packages: gossip topics, fork
digests, message ids and attestation subnets; every gossipsub frame kind;
the message cache's windows; peer scores over one scripted event list;
the RPC rate limiter on an injected clock; the multiplexer's frames; and
the RPC codec (varints, ssz_snappy blocks, request containers). Bytes and
decisions must be equal."""

import random
import socket
import threading

import numpy as np
import pytest

from lighthouse_tpu.network import messages as JM
from lighthouse_tpu.network import mux as Jmux
from lighthouse_tpu.network import rate_limiter as Jrl
from lighthouse_tpu.network import rpc as Jrpc
from lighthouse_tpu.network.gossipsub import frames as JF
from lighthouse_tpu.network.gossipsub import mcache as Jmc
from lighthouse_tpu.network.gossipsub import params as Jparams
from lighthouse_tpu.network.gossipsub import score as Jscore
from lighthouse_tpu.types.chain_spec import mainnet_spec as j_mainnet_spec
from lighthouse_tpu.types.chain_spec import minimal_spec as j_minimal_spec
from lighthouse_tpu.types.eth_spec import MainnetEthSpec as JE
from lighthouse_tpu_torch.network import messages as PM
from lighthouse_tpu_torch.network import mux as Pmux
from lighthouse_tpu_torch.network import rate_limiter as Prl
from lighthouse_tpu_torch.network import rpc as Prpc
from lighthouse_tpu_torch.network.gossipsub import frames as PF
from lighthouse_tpu_torch.network.gossipsub import mcache as Pmc
from lighthouse_tpu_torch.network.gossipsub import params as Pparams
from lighthouse_tpu_torch.network.gossipsub import score as Pscore
from lighthouse_tpu_torch.types.chain_spec import mainnet_spec as p_mainnet_spec
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as p_minimal_spec
from lighthouse_tpu_torch.types.eth_spec import MainnetEthSpec as PE

SPECS = {"minimal": (j_minimal_spec, p_minimal_spec), "mainnet": (j_mainnet_spec, p_mainnet_spec)}


# -- topics, fork digests, message ids, subnets --------------------------------


@pytest.mark.parametrize("preset", sorted(SPECS))
def test_fork_digests_topics_and_message_ids_equal(preset):
    j_spec, p_spec = (f() for f in SPECS[preset])
    rng = np.random.default_rng(11)
    for _ in range(16):
        version, gvr = rng.bytes(4), rng.bytes(32)
        digest = JM.compute_fork_digest(j_spec, version, gvr)
        assert PM.compute_fork_digest(p_spec, version, gvr) == digest
        for name in (
            JM.TOPIC_BEACON_BLOCK,
            JM.TOPIC_AGGREGATE,
            JM.TOPIC_BLOB_SIDECAR,
            JM.attestation_subnet_topic_name(int(rng.integers(64))),
            JM.data_column_subnet_topic_name(int(rng.integers(128))),
        ):
            assert PM.gossip_topic(digest, name) == JM.gossip_topic(digest, name)
    for domain in (j_spec.message_domain_valid_snappy, b"\x00\x00\x00\x00", rng.bytes(4)):
        for n in (0, 1, 95, 4096):
            data = rng.bytes(n)
            assert PM.message_id(domain, data) == JM.message_id(domain, data)
    assert p_spec.message_domain_valid_snappy == j_spec.message_domain_valid_snappy


def test_protocol_ids_and_topic_names_equal():
    names = [n for n in dir(JM) if n.startswith(("PROTO_", "TOPIC_", "GOODBYE_")) or n.endswith("_COUNT")]
    assert names
    for n in names:
        assert getattr(PM, n) == getattr(JM, n), n
    for i in range(64):
        assert PM.attestation_subnet_topic_name(i) == JM.attestation_subnet_topic_name(i)
    for i in range(128):
        assert PM.data_column_subnet_topic_name(i) == JM.data_column_subnet_topic_name(i)


def test_attestation_subnets_equal():
    rng = random.Random(5)
    for _ in range(500):
        cps, slot, index = rng.randint(1, 64), rng.randint(0, 10**7), rng.randint(0, 63)
        assert PM.compute_subnet_for_attestation(cps, slot, index, PE) == JM.compute_subnet_for_attestation(
            cps, slot, index, JE
        )


# -- gossipsub frames -----------------------------------------------------------


def _frames(F, rng: random.Random) -> dict:
    def b(n):
        return bytes(rng.getrandbits(8) for _ in range(n))

    topic = b"/eth2/" + b(4).hex().encode() + b"/beacon_block/ssz_snappy"
    return {
        "publish": F.PublishFrame(topic=topic, data=b(rng.randint(0, 3000))),
        "subscribe": F.SubscriptionFrame(subscribe=bool(rng.getrandbits(1)), topic=topic),
        "graft": F.GraftFrame(topic=topic),
        "prune": F.PruneFrame(
            topic=topic,
            backoff=rng.randint(0, 1 << 40),
            px=[F.PeerRecord(peer_id=b(rng.randint(1, 90)), host=b"127.0.0.1", port=rng.randint(1, 65535)) for _ in range(rng.randint(0, 16))],
        ),
        "ihave": F.IHaveFrame(topic=topic, message_ids=[b(20) for _ in range(rng.randint(0, 300))]),
        "iwant": F.IWantFrame(message_ids=[b(20) for _ in range(rng.randint(1, 300))]),
    }


@pytest.mark.parametrize("kind", ["publish", "subscribe", "graft", "prune", "ihave", "iwant"])
def test_gossipsub_frames_equal(kind):
    for seed in range(8):
        jf = _frames(JF, random.Random(seed))[kind]
        pf = _frames(PF, random.Random(seed))[kind]
        enc = JF.encode_frame(jf)
        assert PF.encode_frame(pf) == enc
        # each package decodes the other's bytes to the same frame
        assert PF.encode_frame(PF.decode_frame(enc)) == enc
        assert JF.encode_frame(JF.decode_frame(PF.encode_frame(pf))) == enc


@pytest.mark.parametrize("raw", [b"", b"\x09", b"\x00\x01", b"\x03" + b"\xff" * 40, b"\x05\x04\x00\x00\x00\x01"])
def test_gossipsub_frame_refusals_equal(raw):
    outcomes = []
    for F in (JF, PF):
        try:
            outcomes.append(("ok", F.encode_frame(F.decode_frame(raw))))
        except F.FrameError as e:
            outcomes.append(("error", type(e).__name__))
    assert outcomes[0] == outcomes[1]


# -- the message cache ----------------------------------------------------------


def _mcache_script(Mc, seed: int) -> list:
    rng = random.Random(seed)
    cache = Mc.MessageCache(history_length=5, gossip_window=3)
    topics = ["a", "b", "c"]
    mids = []
    out = []
    for _ in range(400):
        op = rng.random()
        if op < 0.5:
            mid = rng.getrandbits(160).to_bytes(20, "big")
            if mids and rng.random() < 0.1:
                mid = rng.choice(mids)  # a repeat put
            mids.append(mid)
            cache.put(mid, rng.choice(topics), mid[:7])
        elif op < 0.6:
            cache.shift()
        elif op < 0.75 and mids:
            out.append(("get", cache.get(rng.choice(mids))))
        elif op < 0.9 and mids:
            out.append(("iwant", cache.get_for_iwant(rng.choice(mids), rng.choice("xyz"), 3)))
        else:
            out.append(("ids", {t: cache.gossip_ids(t) for t in topics}, sorted(cache.topics_in_gossip_window()), len(cache)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mcache_windows_equal(seed):
    assert _mcache_script(Pmc, seed) == _mcache_script(Jmc, seed)


# -- peer scores ------------------------------------------------------------------


def _score_script(Score, Params, seed: int) -> list:
    rng = random.Random(seed)
    att = {i: f"/eth2/00000000/beacon_attestation_{i}/ssz_snappy" for i in range(64)}
    block, agg = "/eth2/00000000/beacon_block/ssz_snappy", "/eth2/00000000/beacon_aggregate_and_proof/ssz_snappy"
    extra = ["/eth2/00000000/voluntary_exit/ssz_snappy"]
    score = Score.PeerScore(Params.beacon_score_params(block, agg, att, extra_topics=extra))
    peers = [f"127.0.0.1:{9000 + i}" for i in range(6)]
    topics = [block, agg, att[0], att[17], extra[0], "/eth2/00000000/unknown/ssz_snappy"]
    for p in peers:
        score.add_peer(p)
    out = []
    for _ in range(600):
        p, t, op = rng.choice(peers), rng.choice(topics), rng.random()
        if op < 0.1:
            score.graft(p, t)
        elif op < 0.15:
            score.prune(p, t)
        elif op < 0.55:
            score.first_delivery(p, t)
        elif op < 0.7:
            score.duplicate_delivery(p, t)
        elif op < 0.75:
            score.invalid_message(p, t)
        elif op < 0.78:
            score.behaviour_penalty(p, rng.choice([1.0, 2.0, 0.5]))
        elif op < 0.85:
            score.refresh()
        elif op < 0.86:
            score.remove_peer(p)
            score.add_peer(p)
        else:
            out.append(score.scores())
    out.append(score.scores())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peer_scores_equal_over_one_event_list(seed):
    assert _score_script(Pscore, Pparams, seed) == _score_script(Jscore, Jparams, seed)


def test_score_thresholds_equal():
    assert vars(Pparams.beacon_score_thresholds()) == vars(Jparams.beacon_score_thresholds())


# -- the rate limiter ---------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _limiter_script(Rl, M, seed: int) -> list:
    rng = random.Random(seed)
    clock = _Clock()
    rl = Rl.RateLimiter(clock=clock)
    protos = [M.PROTO_STATUS, M.PROTO_PING, M.PROTO_BLOCKS_BY_RANGE, M.PROTO_BLOCKS_BY_ROOT, M.PROTO_BLOBS_BY_RANGE, "/other"]
    out = []
    for _ in range(3000):
        clock.t += rng.choice([0.0, 0.0, 0.01, 0.3, 2.0, 40.0])
        peer, proto = rng.choice(["a", "b", "c"]), rng.choice(protos)
        cost = rng.choice([1, 1, 4, 64, 128, 1024, 2000])
        out.append(rl.allow(peer, proto, cost))
    out.append(sorted((k, round(v[0], 9)) for k, v in rl._buckets.items()))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_rate_limiter_decisions_equal_on_an_injected_clock(seed):
    assert _limiter_script(Prl, PM, seed) == _limiter_script(Jrl, JM, seed)
    assert {k: (q.max_tokens, q.replenish_all_every) for k, q in Prl.DEFAULT_QUOTAS.items()} == {
        k: (q.max_tokens, q.replenish_all_every) for k, q in Jrl.DEFAULT_QUOTAS.items()
    }


# -- the multiplexer ------------------------------------------------------------------


def _read_all(sock, out: bytearray):
    """Read until EOF or a second of silence (the writer's reader thread
    keeps its end open after close)."""
    sock.settimeout(1.0)
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except TimeoutError:
            return
        if not chunk:
            return
        out += chunk


def _mux_bytes(Mux) -> bytes:
    """The bytes one MuxedConnection writes for a scripted session."""
    sa, sb = socket.socketpair()
    raw = bytearray()
    reader = threading.Thread(target=_read_all, args=(sb, raw), daemon=True)
    reader.start()
    conn = Mux.MuxedConnection(sa, initiator=True)
    try:
        streams = [conn.open_stream() for _ in range(3)]
        rng = random.Random(3)
        for i in range(6):
            streams[i % 3].sendall(bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 3000))))
        streams[2].sendall(b"Z" * 150_000)  # spans frames
        streams[0].shutdown(socket.SHUT_WR)
        conn.send_frame(streams[1].stream_id, Mux.FLAG_RST, b"")
    finally:
        conn.close()
        reader.join(timeout=10)
        sb.close()
    return bytes(raw)


def test_mux_frames_equal():
    got = _mux_bytes(Pmux)
    assert got and got == _mux_bytes(Jmux)


@pytest.mark.parametrize("initiator", ["port", "jax"])
def test_mux_streams_across_packages(initiator):
    sa, sb = socket.socketpair()
    first, second = (Pmux, Jmux) if initiator == "port" else (Jmux, Pmux)
    client = first.MuxedConnection(sa, initiator=True)
    server = second.MuxedConnection(sb, initiator=False)
    try:
        streams = [client.open_stream() for _ in range(4)]
        for i, s in enumerate(streams):
            s.sendall(bytes([i]) * (70_000 + i))
        for i in range(4):
            srv = server.accept(timeout=5)
            data = bytearray()
            while len(data) < 70_000 + (srv.stream_id // 2):
                data += srv.recv(1 << 16)
            k = srv.stream_id // 2
            assert bytes(data) == bytes([k]) * (70_000 + k)
            srv.sendall(b"ack%d" % k)
            assert streams[k].recv(16) == b"ack%d" % k
    finally:
        client.close()
        server.close()


# -- the RPC codec ----------------------------------------------------------------------


class _Sink:
    def __init__(self, data: bytes = b""):
        self.sent = bytearray()
        self._data = bytearray(data)

    def sendall(self, data):
        self.sent += data

    def recv(self, n):
        out, self._data = bytes(self._data[:n]), self._data[n:]
        return out


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 16384, 1 << 21])
def test_rpc_blocks_and_varints_equal(n):
    rng = np.random.default_rng(n)
    assert Prpc._write_varint(n) == Jrpc._write_varint(n)
    # compressible and incompressible payloads of n bytes
    for data in (rng.bytes(n), bytes(n), (b"beacon" * (n // 6 + 1))[:n]):
        j, p = _Sink(), _Sink()
        Jrpc._send_block(j, data)
        Prpc._send_block(p, data)
        assert bytes(p.sent) == bytes(j.sent)
        assert Prpc._recv_block(_Sink(bytes(j.sent))) == data
        assert Jrpc._recv_block(_Sink(bytes(p.sent))) == data
    for proto in (PM.PROTO_STATUS, PM.PROTO_BLOCKS_BY_RANGE, PM.PROTO_GOSSIP):
        j, p = _Sink(), _Sink()
        Jrpc._send_protocol(j, proto)
        Prpc._send_protocol(p, proto)
        assert bytes(p.sent) == bytes(j.sent)
        assert Prpc._recv_protocol(_Sink(bytes(j.sent))) == proto


@pytest.mark.parametrize("raw", [b"\xff" * 6, Jrpc._write_varint((1 << 22) + 1) + b"\0" * 8, b"\x05\x03\x00\x00\x00abc", b""])
def test_rpc_codec_refusals_equal(raw):
    outcomes = []
    for R in (Jrpc, Prpc):
        try:
            outcomes.append(("ok", R._recv_block(_Sink(raw))))
        except Exception as e:  # noqa: BLE001 — the refusal's kind is compared
            outcomes.append(("error", type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


def test_rpc_request_containers_equal():
    rng = np.random.default_rng(4)
    for _ in range(8):
        status = dict(
            fork_digest=rng.bytes(4), finalized_root=rng.bytes(32), finalized_epoch=int(rng.integers(1 << 40)),
            head_root=rng.bytes(32), head_slot=int(rng.integers(1 << 40)),
        )
        assert PM.StatusMessage(**status).serialize() == JM.StatusMessage(**status).serialize()
        rng_req = dict(start_slot=int(rng.integers(1 << 30)), count=int(rng.integers(1024)), step=1)
        assert PM.BlocksByRangeRequest(**rng_req).serialize() == JM.BlocksByRangeRequest(**rng_req).serialize()
        roots = [rng.bytes(32) for _ in range(int(rng.integers(0, 40)))]
        assert PM.BlocksByRootRequest(roots=roots).serialize() == JM.BlocksByRootRequest(roots=roots).serialize()
        ids = [(rng.bytes(32), int(rng.integers(6))) for _ in range(int(rng.integers(0, 12)))]
        jb = JM.BlobsByRootRequest(blob_ids=[JM.BlobIdentifier(block_root=r, index=i) for r, i in ids])
        pb = PM.BlobsByRootRequest(blob_ids=[PM.BlobIdentifier(block_root=r, index=i) for r, i in ids])
        assert pb.serialize() == jb.serialize()
        cols = dict(start_slot=int(rng.integers(1 << 30)), count=int(rng.integers(64)), columns=sorted(set(int(c) for c in rng.integers(0, 128, 9))))
        assert PM.DataColumnsByRangeRequest(**cols).serialize() == JM.DataColumnsByRangeRequest(**cols).serialize()
        md = dict(seq_number=int(rng.integers(1 << 40)), attnets=int(rng.integers(1 << 62)))
        assert PM.MetadataMessage(**md).serialize() == JM.MetadataMessage(**md).serialize()
