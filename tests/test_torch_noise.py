"""The port's Noise transport held to the JAX package's.

A port and a JAX endpoint run the Noise XX handshake both ways over a
socket pair and exchange frames; identities from one seed give equal keys
and peer ids; a tampered frame and a wrong identity signature are refused
by either side; a port node and a JAX node run the RPC and gossip stack
over Noise. The port imports `cryptography` only when a Noise identity or
cipher is built (tests/test_torch_isolation.py)."""

import socket
import struct
import threading
import time
from dataclasses import replace

import pytest

pytest.importorskip("cryptography")

from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.network import NetworkService as JNetworkService
from lighthouse_tpu.network import noise as Jn
from lighthouse_tpu.types.chain_spec import minimal_spec as j_minimal_spec
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JE
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.harness import BeaconChainHarness as PHarness
from lighthouse_tpu_torch.crypto import bls as pbls
from lighthouse_tpu_torch.network import NetworkService as PNetworkService
from lighthouse_tpu_torch.network import noise as Pn
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as p_minimal_spec
from lighthouse_tpu_torch.types.eth_spec import MinimalEthSpec as PE

SIDES = {"jax": Jn, "port": Pn}


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device(), jbls.backend_name(), pbls.backend_setting()
    set_default_device("cpu")
    yield
    set_default_device(prev[0])
    jbls.set_backend(prev[1])
    pbls.set_backend(prev[2])


def _handshake(initiator: str, responder: str, seed_a=b"alice", seed_b=b"bob"):
    sa, sb = socket.socketpair()
    ia = SIDES[initiator].NoiseIdentity.from_seed(seed_a)
    ib = SIDES[responder].NoiseIdentity.from_seed(seed_b)
    out = {}

    def respond():
        try:
            out["srv"] = SIDES[responder].secure_inbound(sb, ib)
        except Exception as e:  # noqa: BLE001 — raised in the test thread below
            out["err"] = e

    t = threading.Thread(target=respond)
    t.start()
    try:
        client = SIDES[initiator].secure_outbound(sa, ia)
    finally:
        t.join(timeout=10)
    if "err" in out:
        raise out["err"]
    return client, out["srv"], ia, ib


@pytest.mark.parametrize("seed", [b"", b"a", b"node-7" * 20])
def test_identities_from_one_seed_are_equal(seed):
    j, p = Jn.NoiseIdentity.from_seed(seed), Pn.NoiseIdentity.from_seed(seed)
    assert p.identity_pub_bytes() == j.identity_pub_bytes()
    assert p.static_pub_bytes() == j.static_pub_bytes()
    assert p.peer_id() == j.peer_id()
    assert p.handshake_payload() == j.handshake_payload()
    assert Pn.peer_id_of_identity_pub(j.identity_pub_bytes()) == j.peer_id()


@pytest.mark.parametrize("initiator,responder", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_handshake_and_frames_across_packages(initiator, responder):
    client, server, ia, ib = _handshake(initiator, responder)
    assert client.remote_peer_id == ib.peer_id() and server.remote_peer_id == ia.peer_id()
    assert client.remote_identity == ib.identity_pub_bytes()
    big = bytes(range(256)) * 1500  # 384 KB: many 64 KB frames
    sender = threading.Thread(target=client.sendall, args=(big,))
    sender.start()
    got = bytearray()
    while len(got) < len(big):
        chunk = server.recv(1 << 16)
        assert chunk
        got += chunk
    sender.join(timeout=10)
    assert bytes(got) == big
    for i in range(10):
        msg = bytes([i]) * (i * 97 + 1)
        server.sendall(msg)
        assert client.recv(len(msg) + 8) == msg
    client.close()
    server.close()


@pytest.mark.parametrize("receiver", ["jax", "port"])
def test_tampered_frame_refused(receiver):
    sender = "port" if receiver == "jax" else "jax"
    client, server, _, _ = _handshake(sender, receiver)
    ct = bytearray(client._send.encrypt(b"", b"attack payload"))
    ct[3] ^= 0x01
    client._sock.sendall(struct.pack(">H", len(ct)) + bytes(ct))
    with pytest.raises(SIDES[receiver].NoiseError):
        server.recv(1024)


@pytest.mark.parametrize("verifier", ["jax", "port"])
def test_wrong_identity_signature_refused(verifier):
    """A responder whose payload signs another static key fails the
    initiator's check in both packages."""
    liar = "port" if verifier == "jax" else "jax"
    sa, sb = socket.socketpair()
    ia = SIDES[verifier].NoiseIdentity.from_seed(b"good")
    ib = SIDES[liar].NoiseIdentity.from_seed(b"evil")
    other = SIDES[liar].NoiseIdentity.from_seed(b"other")
    ib.handshake_payload = other.handshake_payload

    def respond():
        try:
            SIDES[liar].secure_inbound(sb, ib)
        except Exception:  # noqa: BLE001 — the initiator's refusal closes the socket
            pass

    t = threading.Thread(target=respond, daemon=True)
    t.start()
    with pytest.raises(SIDES[verifier].NoiseError):
        SIDES[verifier].secure_outbound(sa, ia)
    sa.close()
    t.join(timeout=5)


def test_nodes_of_both_packages_over_noise():
    """A JAX node serves a port node over Noise: Status, blocks by range
    and a gossip block, with the peer ids the identities give."""
    jbls.set_backend("fake_crypto")
    pbls.set_backend("fake_crypto")
    a = JHarness(replace(j_minimal_spec(), altair_fork_epoch=0), JE, validator_count=16)
    a.extend_chain(4)
    b = PHarness(replace(p_minimal_spec(), altair_fork_epoch=0), PE, validator_count=16)
    na = JNetworkService(a.chain, transport=Jn.NoiseTransport(Jn.NoiseIdentity.from_seed(b"A"))).start()
    nb = PNetworkService(b.chain, transport=Pn.NoiseTransport(Pn.NoiseIdentity.from_seed(b"B"))).start()
    try:
        b.slot_clock.set_slot(a.chain.head_state.slot)
        peer = nb.connect("127.0.0.1", na.port)
        assert peer.noise_peer_id == Jn.NoiseIdentity.from_seed(b"A").peer_id()
        assert nb.sync.sync_with(peer) == 4
        assert b.chain.head_root == a.chain.head_root
        slot = a.chain.head_state.slot + 1
        a.slot_clock.set_slot(slot)
        b.slot_clock.set_slot(slot)
        time.sleep(0.3)
        root, signed = a.add_block_at_slot(slot)
        na.publish_block(signed)
        deadline = time.time() + 10
        while time.time() < deadline and b.chain.head_root != root:
            time.sleep(0.05)
        assert b.chain.head_root == root
    finally:
        nb.stop()
        na.stop()
