"""Noise transport security for the p2p stack.

The reference secures every libp2p connection with the Noise XX handshake
(lighthouse_network's transport builder layers noise below yamux;
libp2p-noise spec: Noise_XX_25519_ChaChaPoly_SHA256 with an ed25519
identity payload). This module implements that handshake on the
`cryptography` primitives — X25519 ephemeral/static keys, ChaCha20-
Poly1305 AEAD, SHA-256 HKDF per the Noise spec — and the libp2p payload
convention: each side proves its ed25519 identity by signing
"noise-libp2p-static-key:" || static_pubkey and shipping the (protobuf)
NoiseHandshakePayload inside the encrypted handshake messages.

Wire format follows the libp2p noise spec: every message (handshake and
transport) is a 2-byte big-endian length followed by the Noise message;
transport plaintext is capped so ciphertext+tag fits a frame.

`NoiseSocket` wraps a connected TCP socket with the recv/sendall subset
the RPC/gossip framing uses, so the layers above (rpc.py, the gossip
router) run unchanged over an encrypted, mutually-authenticated link.
"""

from __future__ import annotations

import functools
import hashlib
import hmac
import os
import socket
import struct
import threading
from types import SimpleNamespace

# `cryptography` is an optional dependency, imported at first use: the
# node runs plaintext transports without it, and a process that never
# builds a NoiseIdentity or a CipherState never loads it.
@functools.cache
def _crypto() -> SimpleNamespace:
    """The `cryptography` primitives; a clear ImportError when the package
    is missing."""
    try:
        from cryptography import exceptions
        from cryptography.hazmat.primitives.asymmetric import ed25519, x25519
        from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    except ImportError as e:
        raise ImportError(
            "the noise transport requires the optional 'cryptography' "
            "package (X25519/Ed25519/ChaCha20-Poly1305 primitives); "
            "run with noise disabled where it is not installed"
        ) from e
    return SimpleNamespace(
        InvalidSignature=exceptions.InvalidSignature,
        InvalidTag=exceptions.InvalidTag,
        Ed25519PrivateKey=ed25519.Ed25519PrivateKey,
        Ed25519PublicKey=ed25519.Ed25519PublicKey,
        X25519PrivateKey=x25519.X25519PrivateKey,
        X25519PublicKey=x25519.X25519PublicKey,
        ChaCha20Poly1305=ChaCha20Poly1305,
    )


PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"  # exactly 32 bytes
SIG_PREFIX = b"noise-libp2p-static-key:"
MAX_FRAME = 65535
MAX_PLAINTEXT = MAX_FRAME - 16  # poly1305 tag
KEY_TYPE_ED25519 = 1


class NoiseError(OSError):
    """Raised on handshake/decryption failures. Subclasses OSError so the
    stream layers above treat a security failure like a dead connection
    (drop the peer) without special-casing."""


# -- minimal protobuf (tag-length-value, bytes fields only) -------------------


def _pb_bytes(field: int, data: bytes) -> bytes:
    out = bytearray()
    out.append((field << 3) | 2)  # wire type 2 = length-delimited
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | 0x80 if n else b)
        if not n:
            break
    out += data
    return bytes(out)


def _pb_varint_field(field: int, value: int) -> bytes:
    out = bytearray()
    out.append(field << 3)  # wire type 0
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | 0x80 if value else b)
        if not value:
            break
    return bytes(out)


def _pb_parse(data: bytes) -> dict[int, bytes | int]:
    """Parse one message level; later duplicate fields win."""
    out: dict[int, bytes | int] = {}
    pos = 0
    while pos < len(data):
        tag = data[pos]
        field, wt = tag >> 3, tag & 7
        pos += 1
        if wt == 0:
            v = 0
            shift = 0
            while True:
                if pos >= len(data):
                    raise NoiseError("truncated varint")
                b = data[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            out[field] = v
        elif wt == 2:
            n = 0
            shift = 0
            while True:
                if pos >= len(data):
                    raise NoiseError("truncated length")
                b = data[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            if pos + n > len(data):
                raise NoiseError("truncated field")
            out[field] = data[pos:pos + n]
            pos += n
        else:
            raise NoiseError(f"unsupported wire type {wt}")
    return out


# -- identity -----------------------------------------------------------------


class NoiseIdentity:
    """A node's ed25519 identity key (libp2p identity) plus the X25519
    static key it certifies for Noise."""

    def __init__(self, identity_key: Ed25519PrivateKey | None = None):
        self.identity = identity_key or _crypto().Ed25519PrivateKey.generate()
        self.static = _crypto().X25519PrivateKey.generate()

    @classmethod
    def from_seed(cls, seed: bytes) -> "NoiseIdentity":
        ident = _crypto().Ed25519PrivateKey.from_private_bytes(
            hashlib.sha256(b"id" + seed).digest()
        )
        self = cls(ident)
        self.static = _crypto().X25519PrivateKey.from_private_bytes(
            hashlib.sha256(b"st" + seed).digest()
        )
        return self

    def identity_pub_bytes(self) -> bytes:
        return self.identity.public_key().public_bytes_raw()

    def static_pub_bytes(self) -> bytes:
        return self.static.public_key().public_bytes_raw()

    def peer_id(self) -> str:
        """libp2p-style peer id: identity multihash (0x00, len) over the
        protobuf PublicKey message, hex-rendered."""
        pk_msg = _pb_varint_field(1, KEY_TYPE_ED25519) + _pb_bytes(
            2, self.identity_pub_bytes()
        )
        return (bytes([0x00, len(pk_msg)]) + pk_msg).hex()

    def handshake_payload(self) -> bytes:
        """NoiseHandshakePayload{identity_key, identity_sig}."""
        pk_msg = _pb_varint_field(1, KEY_TYPE_ED25519) + _pb_bytes(
            2, self.identity_pub_bytes()
        )
        sig = self.identity.sign(SIG_PREFIX + self.static_pub_bytes())
        return _pb_bytes(1, pk_msg) + _pb_bytes(2, sig)


def peer_id_of_identity_pub(pub: bytes) -> str:
    pk_msg = _pb_varint_field(1, KEY_TYPE_ED25519) + _pb_bytes(2, pub)
    return (bytes([0x00, len(pk_msg)]) + pk_msg).hex()


def _verify_payload(payload: bytes, remote_static: bytes) -> bytes:
    """Check the libp2p identity signature; returns the ed25519 pubkey."""
    fields = _pb_parse(payload)
    pk_msg = fields.get(1)
    sig = fields.get(2)
    if not isinstance(pk_msg, bytes) or not isinstance(sig, bytes):
        raise NoiseError("handshake payload missing identity fields")
    pk_fields = _pb_parse(pk_msg)
    if pk_fields.get(1) != KEY_TYPE_ED25519:
        raise NoiseError("unsupported identity key type")
    pub_raw = pk_fields.get(2)
    if not isinstance(pub_raw, bytes) or len(pub_raw) != 32:
        raise NoiseError("bad identity key")
    try:
        _crypto().Ed25519PublicKey.from_public_bytes(pub_raw).verify(
            sig, SIG_PREFIX + remote_static
        )
    except _crypto().InvalidSignature:
        raise NoiseError("identity signature verification failed")
    return pub_raw


# -- Noise symmetric/cipher state ---------------------------------------------


def _hkdf(ck: bytes, ikm: bytes, n: int) -> list[bytes]:
    temp = hmac.new(ck, ikm, hashlib.sha256).digest()
    outs = []
    prev = b""
    for i in range(1, n + 1):
        prev = hmac.new(temp, prev + bytes([i]), hashlib.sha256).digest()
        outs.append(prev)
    return outs


class CipherState:
    def __init__(self, key: bytes | None = None):
        self.key = key
        # the key is fixed for this state's lifetime — build the AEAD once,
        # not per frame
        self._aead = _crypto().ChaCha20Poly1305(key) if key is not None else None
        self.nonce = 0

    def _n(self) -> bytes:
        return b"\x00\x00\x00\x00" + struct.pack("<Q", self.nonce)

    def encrypt(self, ad: bytes, plaintext: bytes) -> bytes:
        if self._aead is None:
            return plaintext
        ct = self._aead.encrypt(self._n(), plaintext, ad)
        self.nonce += 1
        return ct

    def decrypt(self, ad: bytes, ciphertext: bytes) -> bytes:
        if self._aead is None:
            return ciphertext
        try:
            pt = self._aead.decrypt(self._n(), ciphertext, ad)
        except _crypto().InvalidTag:
            raise NoiseError("AEAD authentication failed")
        self.nonce += 1
        return pt


class SymmetricState:
    def __init__(self):
        self.h = PROTOCOL_NAME  # len == 32 → used directly per Noise spec
        self.ck = PROTOCOL_NAME
        self.cipher = CipherState()
        self.mix_hash(b"")  # empty prologue

    def mix_hash(self, data: bytes):
        self.h = hashlib.sha256(self.h + data).digest()

    def mix_key(self, ikm: bytes):
        self.ck, temp_k = _hkdf(self.ck, ikm, 2)
        self.cipher = CipherState(temp_k)

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        ct = self.cipher.encrypt(self.h, plaintext)
        self.mix_hash(ct)
        return ct

    def decrypt_and_hash(self, ciphertext: bytes) -> bytes:
        pt = self.cipher.decrypt(self.h, ciphertext)
        self.mix_hash(ciphertext)
        return pt

    def split(self) -> tuple[CipherState, CipherState]:
        k1, k2 = _hkdf(self.ck, b"", 2)
        return CipherState(k1), CipherState(k2)


# -- framing ------------------------------------------------------------------


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise NoiseError("connection closed during noise exchange")
        buf += chunk
    return bytes(buf)


def _send_frame(sock, data: bytes):
    if len(data) > MAX_FRAME:
        raise NoiseError("noise frame too large")
    sock.sendall(struct.pack(">H", len(data)) + data)


def _recv_frame(sock) -> bytes:
    (n,) = struct.unpack(">H", _read_exact(sock, 2))
    return _read_exact(sock, n)


# -- handshake ----------------------------------------------------------------


def _dh(priv: X25519PrivateKey, pub_raw: bytes) -> bytes:
    return priv.exchange(_crypto().X25519PublicKey.from_public_bytes(pub_raw))


def _handshake(sock, identity: NoiseIdentity, initiator: bool):
    """Run Noise XX. Returns (send_cipher, recv_cipher, remote_identity_pub).

    XX message pattern:
        -> e
        <- e, ee, s, es   (+ responder payload)
        -> s, se          (+ initiator payload)
    """
    ss = SymmetricState()
    e = _crypto().X25519PrivateKey.generate()
    e_pub = e.public_key().public_bytes_raw()
    s_pub = identity.static_pub_bytes()

    if initiator:
        # -> e
        ss.mix_hash(e_pub)
        ss.mix_hash(b"")  # empty payload
        _send_frame(sock, e_pub)
        # <- e, ee, s, es
        msg = _recv_frame(sock)
        if len(msg) < 32 + 48:
            raise NoiseError("short handshake message 2")
        re_pub = msg[:32]
        ss.mix_hash(re_pub)
        ss.mix_key(_dh(e, re_pub))  # ee
        rs_ct = msg[32:32 + 48]
        rs_pub = ss.decrypt_and_hash(rs_ct)  # s
        ss.mix_key(_dh(e, rs_pub))  # es (initiator: DH(e, rs))
        remote_payload = ss.decrypt_and_hash(msg[32 + 48:])
        remote_identity = _verify_payload(remote_payload, rs_pub)
        # -> s, se
        out = ss.encrypt_and_hash(s_pub)
        ss.mix_key(_dh(identity.static, re_pub))  # se (initiator: DH(s, re))
        out += ss.encrypt_and_hash(identity.handshake_payload())
        _send_frame(sock, out)
        c_send, c_recv = ss.split()  # initiator sends with k1
    else:
        # -> e
        msg = _recv_frame(sock)
        if len(msg) < 32:
            raise NoiseError("short handshake message 1")
        re_pub = msg[:32]
        ss.mix_hash(re_pub)
        ss.decrypt_and_hash(msg[32:])  # empty payload
        # <- e, ee, s, es
        ss.mix_hash(e_pub)
        ss.mix_key(_dh(e, re_pub))  # ee
        out = e_pub + ss.encrypt_and_hash(s_pub)
        ss.mix_key(_dh(identity.static, re_pub))  # es (responder: DH(s, re))
        out += ss.encrypt_and_hash(identity.handshake_payload())
        _send_frame(sock, out)
        # -> s, se
        msg3 = _recv_frame(sock)
        if len(msg3) < 48:
            raise NoiseError("short handshake message 3")
        rs_pub = ss.decrypt_and_hash(msg3[:48])  # s
        ss.mix_key(_dh(e, rs_pub))  # se (responder: DH(e, rs))
        remote_payload = ss.decrypt_and_hash(msg3[48:])
        remote_identity = _verify_payload(remote_payload, rs_pub)
        c_recv, c_send = ss.split()  # responder receives with k1
    return c_send, c_recv, remote_identity


# -- secured socket -----------------------------------------------------------


class NoiseSocket:
    """Socket façade over an established Noise session. Implements the
    subset the RPC/gossip framing uses (recv, sendall, settimeout,
    shutdown, close, context manager)."""

    def __init__(self, sock: socket.socket, send_cs: CipherState,
                 recv_cs: CipherState, remote_identity: bytes):
        self._sock = sock
        self._send = send_cs
        self._recv = recv_cs
        self.remote_identity = remote_identity
        self.remote_peer_id = peer_id_of_identity_pub(remote_identity)
        self._buf = bytearray()
        self._eof = False
        self._send_lock = threading.Lock()
        # resumable frame-read state: a timeout mid-frame must not lose
        # the bytes already consumed (the gossip reader probes idle
        # streams with short timeouts and retries)
        self._hdr = bytearray()
        self._frame = bytearray()
        self._need: int | None = None

    # -- write ----------------------------------------------------------
    def sendall(self, data: bytes):
        data = bytes(data)
        with self._send_lock:
            for i in range(0, len(data), MAX_PLAINTEXT):
                chunk = data[i:i + MAX_PLAINTEXT]
                _send_frame(self._sock, self._send.encrypt(b"", chunk))
            if not data:
                # preserve "sendall of empty bytes is a no-op" semantics
                pass

    # -- read -----------------------------------------------------------
    def _read_frame(self):
        """Read one frame into the plaintext buffer. Partial progress is
        kept on timeout so a retried recv() resumes mid-frame."""
        while self._need is None:
            chunk = self._sock.recv(2 - len(self._hdr))
            if not chunk:
                self._eof = True
                return
            self._hdr += chunk
            if len(self._hdr) == 2:
                (self._need,) = struct.unpack(">H", self._hdr)
                self._hdr.clear()
        while len(self._frame) < self._need:
            chunk = self._sock.recv(self._need - len(self._frame))
            if not chunk:
                self._eof = True  # torn frame: treat as close
                return
            self._frame += chunk
        frame = bytes(self._frame)
        self._frame.clear()
        self._need = None
        self._buf += self._recv.decrypt(b"", frame)

    def recv(self, n: int) -> bytes:
        if not self._buf and not self._eof:
            try:
                self._read_frame()
            except NoiseError:
                self._eof = True
                raise
        if not self._buf:
            return b""
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    # -- plumbing --------------------------------------------------------
    def settimeout(self, t):
        self._sock.settimeout(t)

    def shutdown(self, how):
        self._sock.shutdown(how)

    def close(self):
        self._sock.close()

    def fileno(self):
        return self._sock.fileno()

    def getpeername(self):
        return self._sock.getpeername()

    def getsockname(self):
        return self._sock.getsockname()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def secure_outbound(sock: socket.socket,
                    identity: NoiseIdentity) -> NoiseSocket:
    send_cs, recv_cs, remote = _handshake(sock, identity, initiator=True)
    return NoiseSocket(sock, send_cs, recv_cs, remote)


def secure_inbound(sock: socket.socket,
                   identity: NoiseIdentity) -> NoiseSocket:
    send_cs, recv_cs, remote = _handshake(sock, identity, initiator=False)
    return NoiseSocket(sock, send_cs, recv_cs, remote)


# -- transport seam -----------------------------------------------------------


class PlainTransport:
    """No-op transport (the default): raw TCP."""

    def wrap_outbound(self, sock):
        return sock

    def wrap_inbound(self, sock):
        return sock


class NoiseTransport:
    """Secures every connection with Noise XX under this node's identity."""

    def __init__(self, identity: NoiseIdentity | None = None):
        self.identity = identity or NoiseIdentity()

    def wrap_outbound(self, sock):
        return secure_outbound(sock, self.identity)

    def wrap_inbound(self, sock):
        return secure_inbound(sock, self.identity)
