"""Per-route response caches for the Beacon API serving tier.

Entries are final rendered bodies keyed on `(route, resolved root,
normalized query)` — a response derived from an immutable state (or from
the block set as of a given head) never goes stale under its own key, so
correctness comes from the KEY and the head-change invalidation exists to
bound memory: the fork-choice head event (the same one the SSE handler
streams) evicts every entry not keyed to the new head. A byte budget
(`LIGHTHOUSE_TPU_API_CACHE_BYTES`, default 64 MiB) LRU-evicts beyond
that; single bodies larger than the whole budget are served uncached.

Metered by `api_cache_{hits,misses,evictions}_total{route}` (eagerly
registered — conftest asserts the series)."""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from ..metrics import REGISTRY
from .columnar import API_ROUTES

_DEFAULT_BUDGET = 64 * 1024 * 1024

_HITS = REGISTRY.counter(
    "api_cache_hits_total", "API response-cache hits, by route"
)
_MISSES = REGISTRY.counter(
    "api_cache_misses_total", "API response-cache misses, by route"
)
_EVICTIONS = REGISTRY.counter(
    "api_cache_evictions_total",
    "API response-cache evictions (head change + byte-budget LRU), by route",
)
for _route in API_ROUTES:
    _HITS.inc(0, route=_route)
    _MISSES.inc(0, route=_route)
    _EVICTIONS.inc(0, route=_route)


class ResponseCache:
    """Bounded LRU of rendered response bodies (see module docstring)."""

    def __init__(self, max_bytes: int | None = None):
        if max_bytes is None:
            max_bytes = int(
                os.environ.get(
                    "LIGHTHOUSE_TPU_API_CACHE_BYTES", str(_DEFAULT_BUDGET)
                )
            )
        self.max_bytes = max_bytes
        # (route, root, qnorm) -> (body, content_type)
        self._entries: OrderedDict[tuple, tuple[bytes, str]] = OrderedDict()
        self._bytes = 0
        # bumped on EVERY invalidation: a builder snapshots it before
        # assembling and puts conditionally, so a body built before a
        # concurrent eviction can never be re-cached as fresh
        self._generation = 0
        self._lock = threading.Lock()

    @property
    def generation(self) -> int:
        return self._generation

    # -- read/write ------------------------------------------------------

    def get(self, route: str, root: bytes, qnorm: str):
        key = (route, root, qnorm)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                _HITS.inc(route=route)
                return entry
        _MISSES.inc(route=route)
        return None

    def put(self, route: str, root: bytes, qnorm: str, body: bytes,
            content_type: str, if_generation: int | None = None):
        if len(body) > self.max_bytes:
            return  # larger than the whole budget: serve uncached
        key = (route, root, qnorm)
        with self._lock:
            if if_generation is not None and if_generation != self._generation:
                return  # an invalidation raced the build: serve uncached
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[key] = (body, content_type)
            self._bytes += len(body)
            while self._bytes > self.max_bytes and self._entries:
                (r, _, _), (b, _) = self._entries.popitem(last=False)
                self._bytes -= len(b)
                _EVICTIONS.inc(route=r)

    # -- invalidation ----------------------------------------------------

    def on_head_change(self, keep_roots):
        """Fork-choice head moved: entries keyed to roots outside
        `keep_roots` (the new head + the genesis/finalized roots, which
        stay both valid and hot) are dead weight — drop them (counted
        per route)."""
        keep = set(keep_roots)
        with self._lock:
            self._generation += 1
            stale = [k for k in self._entries if k[1] not in keep]
            for k in stale:
                body, _ = self._entries.pop(k)
                self._bytes -= len(body)
                _EVICTIONS.inc(route=k[0])

    def evict_route(self, route: str):
        """Drop every entry of one route — the block event uses this for
        `/headers` (a fork block changes the listing without moving the
        head, so head-keying alone would serve a stale list)."""
        with self._lock:
            self._generation += 1
            stale = [k for k in self._entries if k[0] == route]
            for k in stale:
                body, _ = self._entries.pop(k)
                self._bytes -= len(body)
                _EVICTIONS.inc(route=route)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)
