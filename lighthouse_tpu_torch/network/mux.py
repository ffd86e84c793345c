"""Stream multiplexing over one (optionally Noise-secured) connection.

The reference muxes every RPC substream over a single transport
connection per peer (libp2p yamux below the eth2 RPC,
lighthouse_network's transport builder). This is the same shape on a
deliberately small frame protocol:

    frame := [u32 stream_id BE][u8 flags][u32 length BE][payload]
    flags:  SYN=1 (open), FIN=2 (half-close), RST=4 (abort)

The initiator allocates odd stream ids, the responder even ones (yamux's
convention). Flow control leans on TCP/Noise backpressure rather than
yamux's explicit windows — at beacon-RPC message sizes (≤4 MiB, framed
in ≤64 KiB chunks) the kernel buffer does the job; this is the one
documented divergence from yamux proper.

`MuxStream` exposes the same socket subset the RPC framing uses
(recv/sendall/settimeout/shutdown/close, plus getpeername and the noise
`remote_peer_id` passthrough), so the protocol layer runs unchanged
whether it sits on a raw socket, a NoiseSocket, or a muxed stream of
either."""

from __future__ import annotations

import struct
import threading
from collections import deque

FLAG_SYN = 1
FLAG_FIN = 2
FLAG_RST = 4

_HDR = struct.Struct(">IBI")
MAX_FRAME_PAYLOAD = 1 << 16


class MuxError(OSError):
    pass


# Underlying-socket timeout: bounds SEND stalls (a peer that stops
# reading cannot wedge publish/RPC forever — the blocked sendall raises
# and the connection is dropped). The reader treats the same timeout as
# an idle no-op and keeps waiting.
_IO_TIMEOUT = 30.0
# Concurrent-substream cap per connection: SYN floods cost the attacker a
# connection, not our thread table.
MAX_STREAMS_PER_CONN = 256
# Per-stream receive-buffer cap: the reader drains the socket eagerly, so
# TCP backpressure alone cannot bound a slow consumer's buffer — a stream
# whose unread bytes exceed this is reset instead of growing without
# limit (2× the biggest legal payload).
MAX_STREAM_BUFFER = 8 << 20


class MuxStream:
    def __init__(self, conn: "MuxedConnection", stream_id: int):
        self._conn = conn
        self.stream_id = stream_id
        self._buf = deque()
        self._buffered = 0  # unread bytes queued in _buf
        self._cond = threading.Condition()
        self._eof = False
        self._reset = False
        self._sent_fin = False
        self._timeout: float | None = None

    # -- receive ---------------------------------------------------------
    def _feed(self, data: bytes) -> bool:
        """Queue received plaintext. False = buffer cap exceeded (the
        connection resets the stream instead of buffering unboundedly)."""
        with self._cond:
            if self._buffered + len(data) > MAX_STREAM_BUFFER:
                return False
            self._buf.append(data)
            self._buffered += len(data)
            self._cond.notify_all()
        return True

    def _feed_eof(self, reset: bool = False):
        with self._cond:
            self._eof = True
            self._reset = self._reset or reset
            self._cond.notify_all()

    def recv(self, n: int) -> bytes:
        with self._cond:
            while not self._buf:
                if self._reset:
                    raise MuxError(f"stream {self.stream_id} reset by peer")
                if self._eof:
                    return b""
                if not self._cond.wait(self._timeout):
                    raise TimeoutError("mux stream read timed out")
            chunk = self._buf[0]
            if len(chunk) <= n:
                self._buf.popleft()
                self._buffered -= len(chunk)
                return chunk
            self._buf[0] = chunk[n:]
            self._buffered -= n
            return chunk[:n]

    # -- send ------------------------------------------------------------
    def sendall(self, data: bytes):
        data = bytes(data)
        for i in range(0, len(data), MAX_FRAME_PAYLOAD):
            self._conn.send_frame(
                self.stream_id, 0, data[i:i + MAX_FRAME_PAYLOAD]
            )

    # -- lifecycle -------------------------------------------------------
    def shutdown(self, how):
        # SHUT_WR semantics: signal end-of-stream to the reader side —
        # the RPC server uses this to delimit streamed responses
        self._send_fin()

    def close(self):
        self._send_fin()
        self._conn._forget(self.stream_id)

    def _send_fin(self):
        if not self._sent_fin:
            self._sent_fin = True
            try:
                self._conn.send_frame(self.stream_id, FLAG_FIN, b"")
            except OSError:
                pass  # connection already gone

    # -- plumbing --------------------------------------------------------
    def settimeout(self, t):
        self._timeout = t

    def getpeername(self):
        return self._conn.getpeername()

    @property
    def remote_peer_id(self):
        # noise identity of the UNDERLYING connection (None on plain TCP)
        return getattr(self._conn._sock, "remote_peer_id", None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MuxedConnection:
    """One shared connection carrying many logical streams."""

    def __init__(self, sock, initiator: bool, on_stream=None,
                 accept_inbound: bool | None = None):
        # bound send stalls; the reader retries on the same timeout
        try:
            sock.settimeout(_IO_TIMEOUT)
        except OSError:
            pass
        self._sock = sock
        self._initiator = initiator
        self._next_id = 1 if initiator else 2
        self._streams: dict[int, MuxStream] = {}
        self._accept_q: deque[MuxStream] = deque()
        self._accept_cond = threading.Condition()
        self._send_lock = threading.Lock()
        self._id_lock = threading.Lock()
        self._dead = False
        self._on_stream = on_stream  # server callback: fn(stream)
        # whether unsolicited inbound SYNs are accepted at all: a purely
        # outbound (RPC-client) connection RSTs them instead of queueing
        # streams nobody will ever consume
        self._accept_inbound = (
            accept_inbound
            if accept_inbound is not None
            else (on_stream is not None or not initiator)
        )
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="mux-reader"
        )
        self._reader.start()

    # -- outbound --------------------------------------------------------
    def open_stream(self) -> MuxStream:
        if self._dead:
            raise MuxError("mux connection is closed")
        with self._id_lock:
            sid = self._next_id
            self._next_id += 2
        stream = MuxStream(self, sid)
        self._streams[sid] = stream
        self.send_frame(sid, FLAG_SYN, b"")
        return stream

    def send_frame(self, sid: int, flags: int, payload: bytes):
        if self._dead:
            raise MuxError("mux connection is closed")
        with self._send_lock:
            try:
                self._sock.sendall(_HDR.pack(sid, flags, len(payload)) + payload)
            except OSError:
                self._kill()
                raise

    # -- inbound ---------------------------------------------------------
    def accept(self, timeout: float | None = None) -> MuxStream | None:
        with self._accept_cond:
            while not self._accept_q:
                if self._dead:
                    return None
                if not self._accept_cond.wait(timeout):
                    return None
            return self._accept_q.popleft()

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except TimeoutError:
                continue  # idle is fine; partial progress is preserved
            if not chunk:
                raise MuxError("mux connection closed")
            buf += chunk
        return bytes(buf)

    def _read_loop(self):
        try:
            while True:
                sid, flags, length = _HDR.unpack(self._read_exact(_HDR.size))
                if length > MAX_FRAME_PAYLOAD:
                    # protocol violation: an attacker-claimed length must
                    # not drive the allocation
                    raise MuxError(f"oversized mux frame ({length} bytes)")
                payload = self._read_exact(length) if length else b""
                if flags & FLAG_SYN and sid not in self._streams:
                    if (
                        not self._accept_inbound
                        or len(self._streams) >= MAX_STREAMS_PER_CONN
                    ):
                        # unsolicited (client conn) or flooding: refuse
                        try:
                            self.send_frame(sid, FLAG_RST, b"")
                        except OSError:
                            pass
                        continue
                    stream = MuxStream(self, sid)
                    self._streams[sid] = stream
                    if self._on_stream is not None:
                        threading.Thread(
                            target=self._on_stream,
                            args=(stream,),
                            daemon=True,
                            name=f"mux-stream-{sid}",
                        ).start()
                    else:
                        with self._accept_cond:
                            self._accept_q.append(stream)
                            self._accept_cond.notify()
                stream = self._streams.get(sid)
                if stream is None:
                    continue  # frame for a stream we already forgot
                if payload and not stream._feed(payload):
                    # slow consumer past the buffer cap: reset the stream
                    stream._feed_eof(reset=True)
                    self._forget(sid)
                    try:
                        self.send_frame(sid, FLAG_RST, b"")
                    except OSError:
                        pass
                    continue
                if flags & FLAG_RST:
                    stream._feed_eof(reset=True)
                elif flags & FLAG_FIN:
                    stream._feed_eof()
        except (OSError, struct.error):
            pass
        finally:
            self._kill()

    # -- teardown --------------------------------------------------------
    def _forget(self, sid: int):
        self._streams.pop(sid, None)

    def _kill(self):
        self._dead = True
        for stream in list(self._streams.values()):
            stream._feed_eof(reset=False)
        with self._accept_cond:
            self._accept_cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self):
        self._kill()

    @property
    def alive(self) -> bool:
        return not self._dead

    def getpeername(self):
        return self._sock.getpeername()
