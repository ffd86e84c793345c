"""Req/resp RPC over TCP with SSZ-snappy payloads.

Mirrors lighthouse_network's rpc stack (src/rpc/{methods,protocol,codec}):
each stream opens with a length-prefixed protocol id (the multistream
negotiation, collapsed to its essential byte exchange), the request is one
varint-length-prefixed ssz_snappy payload, and responses are chunks of
`<result byte><varint len><ssz_snappy payload>` — result 0 = success,
1 = invalid request, 2 = server error (p2p-interface.md resp encoding).
Transport security (noise) and muxing (yamux) sit below this layer in the
reference; here each stream is one TCP connection on the host network."""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time

from ..metrics import REGISTRY, inc_counter
from ..utils.snappy import compress, decompress
from . import messages as M

RESP_SUCCESS = 0
RESP_INVALID_REQUEST = 1
RESP_SERVER_ERROR = 2
RESP_RATE_LIMITED = 3  # p2p-interface ResourceUnavailable-class refusal

MAX_PAYLOAD = 1 << 22  # 4 MiB cap (gossip_max_size class bound)
MAX_REQUEST_BLOCKS = 1024
MAX_REQUEST_BLOB_SIDECARS = 768  # deneb p2p: 128 blocks × 6 blobs
MAX_REQUEST_DATA_COLUMN_SIDECARS = 16384  # peerdas p2p: 128 blocks × 128 cols

#: protocol id → short method name for per-method latency metrics (the
#: `proto.split("/")[-3]` component the request counters already use)
_RPC_METHODS = {
    proto: proto.split("/")[-3]
    for proto in (
        M.PROTO_STATUS,
        M.PROTO_PING,
        M.PROTO_METADATA,
        M.PROTO_GOODBYE,
        M.PROTO_BLOCKS_BY_RANGE,
        M.PROTO_BLOCKS_BY_ROOT,
        M.PROTO_BLOBS_BY_RANGE,
        M.PROTO_BLOBS_BY_ROOT,
        M.PROTO_DATA_COLUMNS_BY_RANGE,
        M.PROTO_DATA_COLUMNS_BY_ROOT,
    )
}
#: request-latency buckets: local-loopback pings are sub-ms, a clamped
#: 1024-block ByRange stream can take seconds
_RPC_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0,
)
# Per-method request-latency histograms, eagerly registered (conftest
# asserts the series): server side measures decode→response-complete,
# client side measures dial/substream-open→last-chunk — the number the
# sync engine's peer selection would want to rank on.
_SERVER_SECONDS = {
    proto: REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the protocol table
        f"rpc_server_request_seconds_{method}",
        f"server-side request handling wall time: {method}",
        buckets=_RPC_LATENCY_BUCKETS,
    )
    for proto, method in _RPC_METHODS.items()
}
_CLIENT_SECONDS = {
    proto: REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the protocol table
        f"rpc_client_request_seconds_{method}",
        f"client-side request round-trip wall time: {method}",
        buckets=_RPC_LATENCY_BUCKETS,
    )
    for proto, method in _RPC_METHODS.items()
}


class _TimedClientRequest:
    """Observe dial→last-chunk wall time into the per-method client
    histogram on exit (failures and refusals included — they are the
    latency the caller experienced)."""

    __slots__ = ("_proto", "_t0")

    def __init__(self, proto: str):
        self._proto = proto

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        hist = _CLIENT_SECONDS.get(self._proto)
        if hist is not None:
            hist.observe(time.perf_counter() - self._t0)
        return False


class RpcError(RuntimeError):
    pass


# -- framing ------------------------------------------------------------------


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(sock, first_byte: bytes | None = None) -> int:
    out = 0
    shift = 0
    while True:
        if first_byte is not None:
            b = first_byte[0]
            first_byte = None
        else:
            b = _read_exact(sock, 1)[0]
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out
        shift += 7
        if shift > 35:
            raise RpcError("varint too long")


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise RpcError("connection closed")
        buf += chunk
    return bytes(buf)


def _send_block(sock, data: bytes):
    """ssz_snappy payload: <varint uncompressed-len><compressed-len u32>
    <snappy frames>. The spec relies on stream framing for the compressed
    boundary; over raw TCP an explicit length prefix carries it."""
    if len(data) > MAX_PAYLOAD:
        raise RpcError("payload too large")
    comp = compress(data)
    sock.sendall(_write_varint(len(data)) + struct.pack("<I", len(comp)) + comp)


def _recv_block(sock, first_byte: bytes | None = None) -> bytes:
    expected = _read_varint(sock, first_byte)
    if expected > MAX_PAYLOAD:
        raise RpcError("payload too large")
    comp_len = struct.unpack("<I", _read_exact(sock, 4))[0]
    if comp_len > MAX_PAYLOAD * 2:
        raise RpcError("compressed payload too large")
    data = decompress(_read_exact(sock, comp_len))
    if len(data) != expected:
        raise RpcError("length prefix mismatch")
    return data


def _send_protocol(sock, proto: str):
    raw = proto.encode()
    sock.sendall(bytes([len(raw)]) + raw)


def _recv_protocol(sock) -> str:
    n = _read_exact(sock, 1)[0]
    return _read_exact(sock, n).decode()


# -- server --------------------------------------------------------------------


class RpcServer:
    """Serves the req/resp protocols for one beacon node; gossip streams
    are handed off to the network service's subscriber loop."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 rate_limiter=None):
        from .rate_limiter import RateLimiter

        self.node = node  # NetworkService
        # per-peer, per-protocol token buckets (rpc/rate_limiter.rs)
        self.rate_limiter = rate_limiter or RateLimiter()

        rpc = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    sock = self.request
                    transport = getattr(rpc.node, "transport", None)
                    if transport is not None:
                        # bound the handshake; streams set their own
                        # timeouts afterwards
                        sock.settimeout(10.0)
                        sock = transport.wrap_inbound(sock)
                        sock.settimeout(None)
                    proto = _recv_protocol(sock)
                    if proto == M.PROTO_MUX:
                        rpc._serve_mux(sock)
                        return
                    rpc._dispatch_stream(proto, sock)
                except (RpcError, OSError):
                    # NoiseError subclasses OSError: security failures
                    # drop the stream like any dead connection
                    pass

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="rpc_server"
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    # -- request dispatch -------------------------------------------------------

    def _dispatch_stream(self, proto: str, sock):
        """One protocol stream → its handler (shared between dedicated
        sockets and mux substreams, so new protocols work over both)."""
        if proto == M.PROTO_GOSSIP:
            self.node._handle_gossip_stream(sock)
            return
        self._handle_rpc(proto, sock)

    def _serve_mux(self, sock):
        """Serve many RPC substreams over one connection (the yamux
        layer, network/mux.py). Each inbound stream opens with its own
        protocol id and is handled exactly like a dedicated socket."""
        from .mux import MuxedConnection

        rpc = self

        def on_stream(stream):
            try:
                rpc._dispatch_stream(_recv_protocol(stream), stream)
            except (RpcError, OSError):
                pass
            finally:
                stream.close()

        conn = MuxedConnection(sock, initiator=False, on_stream=on_stream)
        conn._reader.join()  # handler thread lives as long as the conn

    def _peer_key(self, sock) -> str:
        """Bucket key: the noise-authenticated identity when the stream is
        secured, else the remote host (ports rotate per request stream)."""
        noise_id = getattr(sock, "remote_peer_id", None)
        if noise_id is not None:
            return noise_id
        try:
            return sock.getpeername()[0]
        except OSError:
            return "?"

    def _limited(self, sock, proto: str, cost: float) -> bool:
        """True (and the refusal already sent) when over quota."""
        if self.rate_limiter.allow(self._peer_key(sock), proto, cost):
            return False
        inc_counter("rpc_rate_limited_total", protocol=proto.split("/")[-3])
        self._respond(sock, RESP_RATE_LIMITED, b"rate limited")
        return True

    def _handle_rpc(self, proto: str, sock):
        hist = _SERVER_SECONDS.get(proto)
        if hist is None:
            self._handle_rpc_inner(proto, sock)
            return
        t0 = time.perf_counter()
        try:
            self._handle_rpc_inner(proto, sock)
        finally:
            # rate-limited and failed requests are observed too: the
            # latency a peer EXPERIENCES includes our refusals
            hist.observe(time.perf_counter() - t0)

    def _handle_rpc_inner(self, proto: str, sock):
        inc_counter("rpc_requests_total", protocol=proto.split("/")[-3])
        node = self.node
        if proto == M.PROTO_STATUS:
            _req = M.StatusMessage.deserialize(_recv_block(sock))
            if self._limited(sock, proto, 1):
                return
            self._respond(sock, RESP_SUCCESS, node.local_status().serialize())
        elif proto == M.PROTO_PING:
            _req = M.Ping.deserialize(_recv_block(sock))
            if self._limited(sock, proto, 1):
                return
            self._respond(
                sock, RESP_SUCCESS, M.Ping(data=node.metadata_seq).serialize()
            )
        elif proto == M.PROTO_METADATA:
            if self._limited(sock, proto, 1):
                return
            self._respond(
                sock,
                RESP_SUCCESS,
                M.MetadataMessage(
                    seq_number=node.metadata_seq, attnets=0
                ).serialize(),
            )
        elif proto == M.PROTO_GOODBYE:
            _req = M.GoodbyeReason.deserialize(_recv_block(sock))
            if self._limited(sock, proto, 1):
                return
            self._respond(sock, RESP_SUCCESS, M.GoodbyeReason(reason=0).serialize())
        elif proto == M.PROTO_BLOCKS_BY_RANGE:
            req = M.BlocksByRangeRequest.deserialize(_recv_block(sock))
            if req.step != 1:
                self._respond(sock, RESP_INVALID_REQUEST, b"")
                return
            # server-side cap: a hostile count is CLAMPED (the spec lets
            # servers respond with fewer blocks), so one request can never
            # stream the whole store — and the rate-limiter cost is priced
            # on the clamped work actually asked for
            count = min(int(req.count), MAX_REQUEST_BLOCKS)
            if self._limited(sock, proto, count):
                return
            self._stream(sock, node.blocks_by_range, req.start_slot, count)
        elif proto == M.PROTO_BLOCKS_BY_ROOT:
            req = M.BlocksByRootRequest.deserialize(_recv_block(sock))
            roots = list(req.roots)[:MAX_REQUEST_BLOCKS]
            if self._limited(sock, proto, max(1, len(roots))):
                return
            self._stream(sock, node.blocks_by_root, roots)
        elif proto == M.PROTO_BLOBS_BY_RANGE:
            req = M.BlobsByRangeRequest.deserialize(_recv_block(sock))
            # blob responses are ~128KiB each — the spec bounds this
            # protocol by sidecar count (MAX_REQUEST_BLOB_SIDECARS), not
            # block count; clamp the block count to what fits the cap
            max_blobs = node.chain.E.MAX_BLOBS_PER_BLOCK
            count = min(int(req.count), MAX_REQUEST_BLOB_SIDECARS // max_blobs)
            if self._limited(sock, proto, count * max_blobs):
                return
            self._stream(sock, node.blob_sidecars_by_range, req.start_slot, count)
        elif proto == M.PROTO_BLOBS_BY_ROOT:
            req = M.BlobsByRootRequest.deserialize(_recv_block(sock))
            blob_ids = list(req.blob_ids)[:MAX_REQUEST_BLOB_SIDECARS]
            if self._limited(sock, proto, max(1, len(blob_ids))):
                return
            self._stream(sock, node.blob_sidecars_by_root, blob_ids)
        elif proto == M.PROTO_DATA_COLUMNS_BY_RANGE:
            req = M.DataColumnsByRangeRequest.deserialize(_recv_block(sock))
            # column responses are bounded by sidecar count, not block
            # count: clamp the slot span so count × wanted-columns fits
            # the cap (the spec lets servers respond with fewer)
            columns = sorted({int(c) for c in req.columns})
            n_cols = max(1, len(columns))
            count = min(
                int(req.count), MAX_REQUEST_DATA_COLUMN_SIDECARS // n_cols
            )
            if self._limited(sock, proto, count * n_cols):
                return
            self._stream(
                sock,
                node.data_column_sidecars_by_range,
                req.start_slot,
                count,
                columns,
            )
        elif proto == M.PROTO_DATA_COLUMNS_BY_ROOT:
            req = M.DataColumnsByRootRequest.deserialize(_recv_block(sock))
            column_ids = list(req.column_ids)[:MAX_REQUEST_DATA_COLUMN_SIDECARS]
            if self._limited(sock, proto, max(1, len(column_ids))):
                return
            self._stream(sock, node.data_column_sidecars_by_root, column_ids)
        else:
            self._respond(sock, RESP_INVALID_REQUEST, b"")

    def _stream(self, sock, provider, *args):
        """Stream a provider's chunks. A provider fault becomes ONE
        explicit SERVER_ERROR chunk instead of a silently-dying stream —
        syncing clients must see the difference between "peer has nothing
        here" (clean end-of-stream) and "peer failed mid-request" (retry
        on another peer)."""
        try:
            items = provider(*args)
        except Exception:  # noqa: BLE001 — provider fault, not stream fault
            inc_counter("rpc_server_errors_total")
            self._respond(sock, RESP_SERVER_ERROR, b"")
            return
        for item in items:
            self._respond(sock, RESP_SUCCESS, item.serialize())
        sock.shutdown(socket.SHUT_WR)

    @staticmethod
    def _respond(sock, result: int, payload: bytes):
        sock.sendall(bytes([result]))
        _send_block(sock, payload)


# -- client --------------------------------------------------------------------


class RpcClient:
    """One-shot request streams to a peer (rpc/outbound.rs analog)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 transport=None, mux: bool = False):
        self.addr = (host, port)
        self.timeout = timeout
        self.transport = transport  # None = plain TCP
        # mux=True: one persistent (noise-handshaked once) connection
        # carries every request as a substream — the yamux shape. False:
        # one TCP connection per request stream.
        self.mux = mux
        self._mux_conn = None
        self._mux_lock = threading.Lock()

    def _dial(self):
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        if self.transport is not None:
            try:
                sock = self.transport.wrap_outbound(sock)
            except Exception:
                sock.close()
                raise
        return sock

    def _open(self, proto: str):
        if self.mux:
            from .mux import MuxedConnection

            with self._mux_lock:
                if self._mux_conn is None or not self._mux_conn.alive:
                    sock = self._dial()
                    _send_protocol(sock, M.PROTO_MUX)
                    # the conn replaces the dial timeout with its own IO
                    # timeout: sends stay bounded, idle reads just retry
                    self._mux_conn = MuxedConnection(sock, initiator=True)
                stream = self._mux_conn.open_stream()
            stream.settimeout(self.timeout)
            _send_protocol(stream, proto)
            return stream
        sock = self._dial()
        _send_protocol(sock, proto)
        return sock

    def close(self):
        with self._mux_lock:
            if self._mux_conn is not None:
                self._mux_conn.close()
                self._mux_conn = None

    def _request_one(self, proto: str, payload: bytes) -> bytes:
        with _TimedClientRequest(proto), self._open(proto) as sock:
            _send_block(sock, payload)
            result = _read_exact(sock, 1)[0]
            data = _recv_block(sock)
            if result != RESP_SUCCESS:
                raise RpcError(f"{proto}: error response {result}: {data!r}")
            return data

    def status(self, local: M.StatusMessage) -> M.StatusMessage:
        return M.StatusMessage.deserialize(
            self._request_one(M.PROTO_STATUS, local.serialize())
        )

    def ping(self, seq: int) -> int:
        resp = M.Ping.deserialize(
            self._request_one(M.PROTO_PING, M.Ping(data=seq).serialize())
        )
        return int(resp.data)

    def metadata(self) -> M.MetadataMessage:
        with _TimedClientRequest(M.PROTO_METADATA), self._open(
            M.PROTO_METADATA
        ) as sock:
            # metadata has no request body
            result = _read_exact(sock, 1)[0]
            data = _recv_block(sock)
            if result != RESP_SUCCESS:
                raise RpcError("metadata error")
            return M.MetadataMessage.deserialize(data)

    def goodbye(self, reason: int):
        try:
            self._request_one(
                M.PROTO_GOODBYE, M.GoodbyeReason(reason=reason).serialize()
            )
        except (RpcError, OSError):
            pass

    def _stream_blocks(self, proto: str, payload: bytes, decode_block):
        out = []
        with _TimedClientRequest(proto), self._open(proto) as sock:
            _send_block(sock, payload)
            while True:
                try:
                    result_b = sock.recv(1)
                except OSError:
                    break
                if not result_b:
                    break
                result = result_b[0]
                data = _recv_block(sock)
                if result != RESP_SUCCESS:
                    raise RpcError(f"{proto}: chunk error {result}")
                out.append(decode_block(data))
        return out

    def blocks_by_range(self, start_slot: int, count: int, decode_block):
        req = M.BlocksByRangeRequest(start_slot=start_slot, count=count, step=1)
        return self._stream_blocks(
            M.PROTO_BLOCKS_BY_RANGE, req.serialize(), decode_block
        )

    def blocks_by_root(self, roots: list, decode_block):
        req = M.BlocksByRootRequest(roots=roots)
        return self._stream_blocks(
            M.PROTO_BLOCKS_BY_ROOT, req.serialize(), decode_block
        )

    def blob_sidecars_by_range(self, start_slot: int, count: int, decode_sidecar):
        req = M.BlobsByRangeRequest(start_slot=start_slot, count=count)
        return self._stream_blocks(
            M.PROTO_BLOBS_BY_RANGE, req.serialize(), decode_sidecar
        )

    def blob_sidecars_by_root(self, blob_ids: list, decode_sidecar):
        req = M.BlobsByRootRequest(blob_ids=blob_ids)
        return self._stream_blocks(
            M.PROTO_BLOBS_BY_ROOT, req.serialize(), decode_sidecar
        )

    def data_column_sidecars_by_range(
        self, start_slot: int, count: int, columns: list, decode_sidecar
    ):
        req = M.DataColumnsByRangeRequest(
            start_slot=start_slot, count=count, columns=list(columns)
        )
        return self._stream_blocks(
            M.PROTO_DATA_COLUMNS_BY_RANGE, req.serialize(), decode_sidecar
        )

    def data_column_sidecars_by_root(self, column_ids: list, decode_sidecar):
        req = M.DataColumnsByRootRequest(column_ids=column_ids)
        return self._stream_blocks(
            M.PROTO_DATA_COLUMNS_BY_ROOT, req.serialize(), decode_sidecar
        )
