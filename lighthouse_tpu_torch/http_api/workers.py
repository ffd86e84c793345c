"""Multi-process Beacon API read replicas.

The serving tier behind `HttpApiServer(workers=N)`: N worker processes
forked from the WARM parent — resident `RegistryColumns`, block indexes,
tree-hash caches and the primed response cache all arrive via
copy-on-write, so a replica costs page tables, not memory — each running
its own `ThreadingHTTPServer` accept loop over ONE listening socket
bound and inherited pre-fork (the kernel load-balances accepts across
the processes, the same discipline nginx/gunicorn pre-fork tiers use).

Correctness across processes is a generation guard, not a cache flush:
a worker's chain is a frozen fork-time snapshot, so invalidating its
response cache cannot make it fresh — it would just recompute stale
bodies. The parent fans every head/block/finalized event over a
non-blocking pipe (with periodic generation heartbeats covering any
dropped write); a worker serves the read-tier routes locally only while
`last seen generation == fork generation` and FORWARDS everything else —
mutations, operator routes, SSE streams, and all reads once stale — to
the parent's private full server, which is always fresh. A supervisor
thread respawns dead workers and rotates stale cohorts off the warm
parent, restoring local serving a fraction of a second after each head
change; serving is correct at every instant in between because
forwarding, not rotation, is what guards freshness.

Observability is shared-nothing: each worker periodically writes an
atomic snapshot of its registry DELTA since fork (`exposition_delta` —
the CoW registry copy starts at the parent's totals) and the parent's
/metrics merges them with `merge_expositions`.

Fork-safety: `spawn_serving_worker` is a fork entry point held to
host_pool's rule for task functions (no locks, metrics or torch on the
pre-fork path; the sanctioned post-fork reset runs first).

The card: the parent holds a CUDA context, which a forked child cannot
use. The post-fork reset marks the child (`device.mark_forked_worker`),
so any kernel dispatch there raises `ForkedWorkerDispatch` before it
touches the card or computes on the CPU; the worker then forwards the
request to the parent, which runs it on the card, counted as
`api_worker_requests_forwarded_total{why="kernel"}`.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import socket
import tempfile
import threading
import time
import weakref
from http.server import ThreadingHTTPServer
from urllib.parse import urlparse

from ..beacon_chain.events import TOPIC_BLOCK, TOPIC_FINALIZED, TOPIC_HEAD
from ..device import ForkedWorkerDispatch, mark_forked_worker
from ..metrics import (
    REGISTRY,
    exposition_delta,
    merge_expositions,
    reset_locks_after_fork,
)
from . import _Handler

_PROCESSES = REGISTRY.gauge(
    "api_worker_processes", "live API serving worker processes"
)
_PROCESSES.set(0)
_RESPAWNS = REGISTRY.counter(
    "api_worker_respawns_total", "worker replacements per cause"
)
for _r in ("death", "head_refresh"):
    _RESPAWNS.inc(0, reason=_r)
_FANNED = REGISTRY.counter(
    "api_worker_events_fanned_total", "invalidation events fanned to workers"
)
for _t in (TOPIC_HEAD, TOPIC_BLOCK, TOPIC_FINALIZED):
    _FANNED.inc(0, topic=_t)
_FAN_DROPS = REGISTRY.counter(
    "api_worker_fan_drops_total",
    "pipe writes dropped fanning events (heartbeats re-sync the generation)",
)
_FAN_DROPS.inc(0)
_FORWARDED = REGISTRY.counter(
    "api_worker_requests_forwarded_total", "worker requests proxied to the parent"
)
for _w in ("stale", "proxy_route", "kernel"):
    _FORWARDED.inc(0, why=_w)

#: GET prefixes a worker may answer from its fork-time snapshot while
#: generation-fresh. Everything else — POSTs, validator/op-pool routes
#: (they read live mutable state no event invalidates), /metrics,
#: /lighthouse/*, node status, and SSE — always forwards to the parent.
_LOCAL_GET_PREFIXES = (
    "/eth/v1/beacon/genesis",
    "/eth/v1/beacon/states/",
    "/eth/v1/beacon/headers",
    "/eth/v2/beacon/blocks/",
    "/eth/v1/beacon/blob_sidecars/",
    "/eth/v1/beacon/light_client/",
    "/eth/v2/debug/beacon/states/",
    "/eth/v1/config/",
    "/eth/v1/node/health",
)

#: POSIX guarantees pipe writes up to PIPE_BUF (4096 on Linux) are atomic
#: even with O_NONBLOCK — larger fan payloads would interleave, so they
#: are dropped (counted) and the generation heartbeat re-syncs staleness
_PIPE_MSG_MAX = 4000

#: pools with live workers in this process — /lighthouse/health reads
#: per-worker RSS through this, and freshly forked children close every
#: OTHER server's inherited fds through it (fleet hygiene)
_LIVE_POOLS: "weakref.WeakSet[ApiWorkerPool]" = weakref.WeakSet()


def live_worker_info() -> list[dict]:
    """[{name, pid}] for every active serving worker in this process."""
    out = []
    for pool in list(_LIVE_POOLS):
        try:
            out.extend(pool.worker_info())
        except Exception:  # noqa: BLE001 — a pool mid-teardown is not news
            continue
    return out


def _update_process_gauge():
    total = 0
    for pool in list(_LIVE_POOLS):
        total += len(pool._workers)
    _PROCESSES.set(total)


def bind_public_socket(port: int) -> socket.socket:
    """Bind+listen the tier's public socket in the parent, BEFORE any
    fork, so every worker inherits the same accept queue."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.listen(128)
    return s


# -- fork entry ----------------------------------------------------------

_LOCK_T = type(threading.Lock())
_RLOCK_T = type(threading.RLock())
_NESTED_ATTRS = ("store", "db", "_db", "kv", "_kv", "hot", "cold", "hot_db", "cold_db")


def _fresh_locks(obj, depth: int = 2, _seen=None):
    """Replace inherited lock/condition objects on `obj` (recursing into
    store-layer attributes) with fresh ones. Only legal in a just-forked
    child, where exactly one thread exists so reassignment cannot race —
    the parent thread that held the lock does not exist here."""
    if obj is None or depth < 0:
        return
    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return
    _seen.add(id(obj))
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for k, v in list(d.items()):
        if isinstance(v, _LOCK_T):
            d[k] = threading.Lock()
        elif isinstance(v, _RLOCK_T):
            d[k] = threading.RLock()
        elif isinstance(v, threading.Condition):
            d[k] = threading.Condition()
        elif depth and k in _NESTED_ATTRS:
            _fresh_locks(v, depth - 1, _seen)


def _reinit_forked_child(ctx):
    """The sanctioned post-fork reset (host_pool's discipline, applied to
    a serving child): record that this process is a forked worker (no
    kernel dispatch from here on), name the process for the profiler's
    thread-KIND folding, refresh every lock a vanished parent thread might
    hold, drop inherited fds belonging to other servers, and capture the
    metrics baseline that turns this child's CoW registry into delta
    snapshots."""
    mark_forked_worker()
    name = f"http_api-w{ctx.index}"
    try:
        with open("/proc/self/comm", "w") as f:
            f.write(name[:15])
    except OSError:
        pass  # non-Linux: thread names still carry the worker identity
    threading.current_thread().name = name

    reset_locks_after_fork()
    from ..metrics.profiler import PROFILER

    _fresh_locks(PROFILER, 0)
    try:
        from ..metrics.trace_collector import COLLECTOR

        _fresh_locks(COLLECTOR, 0)
    except Exception:  # noqa: BLE001
        pass

    api = ctx.api
    chain = api.chain
    chain.event_handler.reinit_after_fork()
    _fresh_locks(api.response_cache, 0)
    _fresh_locks(api.block_index, 0)
    _fresh_locks(chain)
    _fresh_locks(getattr(chain, "store", None))

    for fd in ctx.close_fds:
        try:
            os.close(fd)
        except OSError:
            pass

    ctx.baseline = REGISTRY.expose()


def spawn_serving_worker(entry, ctx) -> int:
    """Fork one API serving worker from the warm parent.

    `entry(ctx)` runs in the child after `_reinit_forked_child`. Like
    host_pool task functions, the entry must not touch locks, metrics, or
    torch on its pre-fork path."""
    pid = os.fork()
    if pid:
        return pid
    code = 1
    try:
        _reinit_forked_child(ctx)
        entry(ctx)
        code = 0
    except BaseException:  # noqa: BLE001 — never unwind into inherited frames
        pass
    finally:
        os._exit(code)


def _serving_worker_main(ctx):
    """Forked serving-worker entrypoint: delegate straight to the runtime
    object — nothing here runs before the sanctioned post-fork reset."""
    _WorkerRuntime(ctx).run()


class _WorkerContext:
    """Everything a serving worker needs, assembled pre-fork."""

    __slots__ = (
        "api",
        "sock",
        "pipe_rfd",
        "index",
        "parent_port",
        "fork_generation",
        "snap_dir",
        "snapshot_interval",
        "drain_grace",
        "close_fds",
        "baseline",
    )


# -- worker side ---------------------------------------------------------


class _WorkerHTTPServer(ThreadingHTTPServer):
    """Per-worker accept loop over the shared pre-fork socket.

    The listening socket is non-blocking: when the kernel wakes several
    workers for one connection, the losers' accept raises BlockingIOError,
    which socketserver's noblock path already swallows."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, sock, handler_cls, runtime):
        super().__init__(sock.getsockname(), handler_cls, bind_and_activate=False)
        self.socket.close()  # replace the fresh unbound socket
        self.socket = sock
        self._runtime = runtime

    def process_request(self, request, client_address):
        # ThreadingMixIn with two changes: request threads carry the
        # worker's name (profiler folding), and in-flight accounting
        # lets retire/stop drain instead of cutting connections
        t = threading.Thread(
            target=self._request_thread,
            args=(request, client_address),
            daemon=True,
            name=self._runtime.name,
        )
        t.start()

    def _request_thread(self, request, client_address):
        rt = self._runtime
        rt.inflight_inc()
        try:
            self.finish_request(request, client_address)
        except Exception:  # noqa: BLE001
            self.handle_error(request, client_address)
        finally:
            try:
                self.shutdown_request(request)
            except Exception:  # noqa: BLE001
                pass
            rt.inflight_dec()

    def handle_error(self, request, client_address):
        pass  # request-level faults surface as 5xx bodies, not stderr spew


class _WorkerHandler(_Handler):
    """Read-replica request policy over the full `_Handler` route table:
    serve the read tier locally while generation-fresh, forward the rest
    (and everything once stale) to the always-fresh parent, and forward a
    local read whose answer would dispatch a kernel (the parent runs it on
    the card)."""

    runtime: "_WorkerRuntime" = None

    def send_response(self, code, message=None):
        super().send_response(code, message)
        if not getattr(self, "_proxied", False):
            self.send_header("X-Api-Served-By", self.runtime.name)

    def do_GET(self):
        path = urlparse(self.path).path
        if path.startswith(_LOCAL_GET_PREFIXES):
            if self.runtime.is_fresh():
                try:
                    super().do_GET()
                except ForkedWorkerDispatch:
                    # raised before any byte of the answer was written
                    self._forward("kernel")
            else:
                self._forward("stale")
            return
        self._forward("proxy_route")

    def do_POST(self):
        self._forward("proxy_route")

    def _forward(self, why: str):
        _FORWARDED.inc(why=why)
        self._proxied = True
        rt = self.runtime
        body = None
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length:
            body = self.rfile.read(length)
        conn = http.client.HTTPConnection("127.0.0.1", rt.parent_port, timeout=60)
        responded = False
        try:
            # the why rides to the parent: stale forwards are the demand
            # signal that makes rotation worth a fork (pull-based — see
            # ApiWorkerPool.note_stale_forward)
            headers = {"X-Api-Forward-Why": why}
            for h in ("Accept", "Content-Type"):
                v = self.headers.get(h)
                if v:
                    headers[h] = v
            conn.request(self.command, self.path, body=body, headers=headers)
            resp = conn.getresponse()
            self.send_response(resp.status)
            responded = True
            self.send_header("X-Api-Served-By", "parent")
            self.send_header("X-Api-Forwarded-By", rt.name)
            for h in ("Content-Type", "Eth-Consensus-Version", "Cache-Control"):
                v = resp.getheader(h)
                if v:
                    self.send_header(h, v)
            length_hdr = resp.getheader("Content-Length")
            if length_hdr is not None:
                self.send_header("Content-Length", length_hdr)
            else:
                self.close_connection = True
            self.end_headers()
            if length_hdr is not None:
                remaining = int(length_hdr)
                while remaining > 0:
                    chunk = resp.read(min(65536, remaining))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)
            else:
                # unframed stream (the SSE relay): the worker is a dumb
                # byte pipe — the real fan-out tier lives in the parent —
                # pumped until upstream EOF or this worker is retired
                if conn.sock is not None:
                    conn.sock.settimeout(0.25)
                while True:
                    try:
                        chunk = resp.read1(65536)
                    except socket.timeout:
                        if rt.retiring or rt.hard_stop:
                            break
                        continue
                    except (OSError, ValueError):
                        break
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # downstream client went away mid-relay
        except Exception as e:  # noqa: BLE001 — upstream trouble becomes a 502
            if not responded:
                try:
                    self._send_json(
                        {"code": 502, "message": f"parent unavailable: {e}"}, 502
                    )
                except Exception:  # noqa: BLE001
                    pass
        finally:
            conn.close()


class _WorkerRuntime:
    """Per-process state of one read replica: the serving loop, the pipe
    reader applying fanned invalidation + the generation guard, and the
    metrics snapshot writer."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.name = f"http_api-w{ctx.index}"
        self.parent_port = ctx.parent_port
        self.fork_generation = ctx.fork_generation
        self.last_generation = ctx.fork_generation
        self.retiring = False
        self.hard_stop = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._server = None
        self.snap_path = os.path.join(
            ctx.snap_dir, f"w{ctx.index}-{os.getpid()}.prom"
        )

    def is_fresh(self) -> bool:
        """True while no invalidation event postdates this worker's fork —
        the cross-process analog of the response cache's generation check:
        a frozen chain snapshot may only serve bodies for the head it was
        forked at."""
        return self.last_generation == self.fork_generation

    def inflight_inc(self):
        with self._inflight_lock:
            self._inflight += 1

    def inflight_dec(self):
        with self._inflight_lock:
            self._inflight -= 1

    def run(self):
        ctx = self.ctx
        handler = type(
            "BoundWorkerHandler",
            (_WorkerHandler,),
            {"api": ctx.api, "runtime": self},
        )
        ctx.sock.setblocking(False)
        self._server = srv = _WorkerHTTPServer(ctx.sock, handler, self)
        threading.Thread(
            target=self._pipe_loop, daemon=True, name=f"{self.name}-events"
        ).start()
        threading.Thread(
            target=self._snapshot_loop, daemon=True, name=f"{self.name}-metrics"
        ).start()
        try:
            srv.serve_forever(poll_interval=0.1)
        finally:
            grace = 0.5 if self.hard_stop else ctx.drain_grace
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline:
                with self._inflight_lock:
                    if self._inflight == 0:
                        break
                time.sleep(0.02)
            self._dump_snapshot()

    def _shutdown_server(self):
        srv = self._server
        if srv is not None:
            try:
                srv.shutdown()
            except Exception:  # noqa: BLE001
                pass

    def _pipe_loop(self):
        ev = self.ctx.api.chain.event_handler
        try:
            f = os.fdopen(self.ctx.pipe_rfd, "rb")
        except OSError:
            self.hard_stop = True
            self._shutdown_server()
            return
        with f:
            for line in f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                kind = msg.get("kind")
                if kind in ("event", "gen"):
                    gen = int(msg.get("generation", 0))
                    if gen > self.last_generation:
                        self.last_generation = gen
                    if kind == "event":
                        # republish locally: the per-worker response cache
                        # invalidates through the exact listeners the
                        # parent's does
                        try:
                            ev._publish(msg["topic"], msg["data"])
                        except Exception:  # noqa: BLE001
                            pass
                elif kind == "retire":
                    self.retiring = True
                    self._shutdown_server()
                elif kind == "shutdown":
                    self.hard_stop = True
                    self._shutdown_server()
                    return
        # EOF: the parent is gone — nothing left to serve for
        self.hard_stop = True
        self._shutdown_server()

    def _snapshot_loop(self):
        while not (self.hard_stop or self.retiring):
            time.sleep(self.ctx.snapshot_interval)
            self._dump_snapshot()

    def _dump_snapshot(self):
        """Atomically publish this worker's registry delta since fork;
        the parent's /metrics merge sums it with every other process."""
        try:
            text = exposition_delta(REGISTRY.expose(), self.ctx.baseline)
            tmp = f"{self.snap_path}.tmp"
            with open(tmp, "w") as f:
                f.write(f"# worker {self.name} pid {os.getpid()}\n")
                f.write(text)
            os.replace(tmp, self.snap_path)
        except OSError:
            pass


# -- parent side ---------------------------------------------------------


class _Worker:
    __slots__ = ("pid", "wfd", "gen", "index", "snap_path", "spawned_at")


class ApiWorkerPool:
    """Parent-side supervisor of the read-replica tier.

    Listens on the chain's event handler (synchronously, like the
    response cache) and fans head/block/finalized events to workers over
    non-blocking pipes; a monitor thread heartbeats the generation,
    reaps + respawns dead workers (counted reason="death") and rotates
    stale cohorts off the warm parent (reason="head_refresh", coalesced
    by `respawn_min_interval` — correctness never depends on rotation,
    only scale-out does)."""

    def __init__(
        self,
        api,
        sock,
        workers: int,
        parent_port: int,
        *,
        respawn_min_interval: float = 0.5,
        heartbeat_interval: float = 0.25,
        snapshot_interval: float = 0.25,
        drain_grace: float = 2.0,
    ):
        self.api = api
        self.sock = sock
        self.size = max(1, int(workers))
        self.parent_port = parent_port
        self.respawn_min_interval = respawn_min_interval
        self.heartbeat_interval = heartbeat_interval
        self.snapshot_interval = snapshot_interval
        self.drain_grace = drain_grace
        self.snap_dir = tempfile.mkdtemp(prefix="lighthouse-api-workers-")
        self._glock = threading.Lock()
        self._generation = 0
        self._workers: dict[int, _Worker] = {}
        self._retiring: list[tuple[_Worker, float]] = []
        self._retired_acc = ""
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._monitor: threading.Thread | None = None
        self._last_rotate = 0.0
        self._stale_forwards = 0

    # -- lifecycle -------------------------------------------------------

    def start(self):
        ev = self.api.chain.event_handler
        ev.add_listener(
            (TOPIC_HEAD, TOPIC_BLOCK, TOPIC_FINALIZED), self._on_chain_event
        )
        _LIVE_POOLS.add(self)
        with self._glock:
            for k in range(self.size):
                self._spawn_locked(k)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="http_api-supervisor"
        )
        self._monitor.start()
        _update_process_gauge()
        return self

    def _spawn_locked(self, k: int) -> _Worker:
        rfd, wfd = os.pipe()
        os.set_blocking(wfd, False)
        # fds the CHILD must not keep open: its own pipe write end, its
        # siblings' pipes, and every other live server's listening socket
        # and pipes in this process (testnet fleets share one process)
        close_fds = [wfd] + [w.wfd for w in self._workers.values()]
        for pool in list(_LIVE_POOLS):
            if pool is self:
                continue
            try:
                close_fds.append(pool.sock.fileno())
                close_fds.extend(w.wfd for w in pool._workers.values())
            except Exception:  # noqa: BLE001 — pool mid-teardown
                continue
        ctx = _WorkerContext()
        ctx.api = self.api
        ctx.sock = self.sock
        ctx.pipe_rfd = rfd
        ctx.index = k
        ctx.parent_port = self.parent_port
        ctx.fork_generation = self._generation
        ctx.snap_dir = self.snap_dir
        ctx.snapshot_interval = self.snapshot_interval
        ctx.drain_grace = self.drain_grace
        ctx.close_fds = close_fds
        pid = spawn_serving_worker(_serving_worker_main, ctx)
        os.close(rfd)
        w = _Worker()
        w.pid = pid
        w.wfd = wfd
        w.gen = ctx.fork_generation
        w.index = k
        w.snap_path = os.path.join(self.snap_dir, f"w{k}-{pid}.prom")
        w.spawned_at = time.monotonic()
        self._workers[k] = w
        return w

    def stop(self, timeout: float = 5.0):
        try:
            self.api.chain.event_handler.remove_listener(self._on_chain_event)
        except Exception:  # noqa: BLE001
            pass
        self._stop_evt.set()
        self._wake.set()
        m = self._monitor
        if m is not None:
            m.join(timeout=2.0)
            self._monitor = None
        payload = (json.dumps({"kind": "shutdown"}) + "\n").encode()
        with self._glock:
            victims = list(self._workers.values()) + [w for w, _ in self._retiring]
            self._workers.clear()
            self._retiring = []
        for w in victims:
            self._send(w, payload)
            try:
                os.close(w.wfd)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        pending = {w.pid for w in victims}
        while pending and time.monotonic() < deadline:
            for pid in list(pending):
                try:
                    p, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    p = pid
                if p:
                    pending.discard(pid)
            if pending:
                time.sleep(0.02)
        for pid in pending:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
            try:
                os.waitpid(pid, 0)
            except (ChildProcessError, OSError):
                pass
        _LIVE_POOLS.discard(self)
        _update_process_gauge()
        shutil.rmtree(self.snap_dir, ignore_errors=True)

    # -- event fan-out ---------------------------------------------------

    def _on_chain_event(self, topic, data):
        with self._glock:
            self._generation += 1
            gen = self._generation
            targets = list(self._workers.values())
        _FANNED.inc(topic=topic)
        payload = (
            json.dumps(
                {"kind": "event", "topic": topic, "data": data, "generation": gen}
            )
            + "\n"
        ).encode()
        for w in targets:
            self._send(w, payload)
        self._wake.set()

    def note_stale_forward(self):
        """Parent-side demand signal: a replica just forwarded a read
        because it was generation-stale. Rotation is PULL-based — the
        re-fork only pays off when reads are actually arriving. With no
        API traffic, stale replicas simply keep forwarding (correctness
        never depends on rotation); without this gate a busy chain would
        re-fork every replica on every head move — a testnet soak
        measured a 15x finalization-rate collapse paying that fork tax
        for an API nobody was querying."""
        self._stale_forwards += 1
        self._wake.set()

    def _send(self, w: _Worker, payload: bytes):
        if len(payload) > _PIPE_MSG_MAX:
            _FAN_DROPS.inc()
            return
        try:
            os.write(w.wfd, payload)
        except (BlockingIOError, BrokenPipeError, OSError):
            _FAN_DROPS.inc()

    # -- supervision -----------------------------------------------------

    def _monitor_loop(self):
        last_beat = 0.0
        while not self._stop_evt.is_set():
            self._wake.wait(0.05)
            self._wake.clear()
            if self._stop_evt.is_set():
                return
            self._reap()
            self._rotate_if_stale()
            now = time.monotonic()
            if now - last_beat >= self.heartbeat_interval:
                last_beat = now
                with self._glock:
                    gen = self._generation
                    targets = list(self._workers.values())
                payload = (
                    json.dumps({"kind": "gen", "generation": gen}) + "\n"
                ).encode()
                for w in targets:
                    self._send(w, payload)

    def _reap(self):
        with self._glock:
            active = list(self._workers.items())
        respawned = 0
        for k, w in active:
            try:
                pid, _ = os.waitpid(w.pid, os.WNOHANG)
            except ChildProcessError:
                pid = w.pid
            if pid == 0:
                continue
            # died underneath us: fold its last metrics delta, respawn
            self._fold_snapshot(w)
            with self._glock:
                if self._workers.get(k) is w:
                    del self._workers[k]
                    try:
                        os.close(w.wfd)
                    except OSError:
                        pass
                    self._spawn_locked(k)
            _RESPAWNS.inc(reason="death")
            respawned += 1
        with self._glock:
            retiring = list(self._retiring)
        for item in retiring:
            w, kill_at = item
            try:
                pid, _ = os.waitpid(w.pid, os.WNOHANG)
            except ChildProcessError:
                pid = w.pid
            if pid:
                self._fold_snapshot(w)
                try:
                    os.close(w.wfd)
                except OSError:
                    pass
                with self._glock:
                    if item in self._retiring:
                        self._retiring.remove(item)
            elif time.monotonic() > kill_at:
                try:
                    os.kill(w.pid, signal.SIGKILL)
                except OSError:
                    pass
        if respawned:
            _update_process_gauge()

    def _rotate_if_stale(self):
        """Replace workers forked before the current generation with fresh
        forks off the (always-fresh) parent. Coalesced (a burst of events
        causes ONE rotation) and demand-driven (no rotation until a stale
        forward has actually reached the parent — note_stale_forward);
        forwarding keeps every response correct while a stale cohort
        drains, and forever if no rotation ever fires."""
        if not self._stale_forwards:
            return
        now = time.monotonic()
        if now - self._last_rotate < self.respawn_min_interval:
            return
        retire_payload = (json.dumps({"kind": "retire"}) + "\n").encode()
        rotated = 0
        with self._glock:
            stale = [
                (k, w) for k, w in self._workers.items() if w.gen < self._generation
            ]
            self._stale_forwards = 0  # demand consumed by this scan
            for k, w in stale:
                del self._workers[k]
                self._spawn_locked(k)
                self._send(w, retire_payload)
                self._retiring.append(
                    (w, now + self.drain_grace + 3.0)
                )
                rotated += 1
        if rotated:
            self._last_rotate = now
            _RESPAWNS.inc(float(rotated), reason="head_refresh")
            _update_process_gauge()

    # -- observability ---------------------------------------------------

    def worker_info(self) -> list[dict]:
        with self._glock:
            return [
                {"name": f"http_api-w{w.index}", "pid": w.pid}
                for _, w in sorted(self._workers.items())
            ]

    def _fold_snapshot(self, w: _Worker):
        """Preserve a departing worker's counter deltas so merged totals
        stay monotonic across respawns."""
        try:
            with open(w.snap_path) as f:
                text = f.read()
            os.unlink(w.snap_path)
        except OSError:
            return
        with self._glock:
            self._retired_acc = (
                merge_expositions([self._retired_acc, text])
                if self._retired_acc
                else text
            )

    def merged_metrics(self) -> str:
        """One scrape body for the whole tier: the parent's live registry
        first (gauges are first-wins), then every worker's delta snapshot
        and the folded deltas of departed workers (counters sum)."""
        texts = [REGISTRY.expose()]
        with self._glock:
            if self._retired_acc:
                texts.append(self._retired_acc)
            paths = [w.snap_path for w in self._workers.values()]
        for p in paths:
            try:
                with open(p) as f:
                    texts.append(f.read())
            except OSError:
                continue
        return merge_expositions(texts)
