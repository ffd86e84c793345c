"""Per-peer, per-protocol RPC rate limiting.

Mirrors lighthouse_network's rpc rate limiter (src/rpc/rate_limiter.rs):
every (peer, protocol) pair owns a token bucket refilled continuously
against a protocol-specific `Quota`; a request's cost is the amount of
work it asks for (blocks / blob sidecars requested; 1 for unit protocols
like Status or Ping). Over-quota requests are answered with a dedicated
RATE_LIMITED response code and the stream ends — the caller can retry
after backing off, exactly like the reference's self-limited peers.

Buckets for peers idle longer than a full refill are pruned so the table
stays bounded by active peers, not by every address ever seen.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from . import messages as M


@dataclass(frozen=True)
class Quota:
    """`max_tokens` of work allowed per `replenish_all_every` seconds."""

    max_tokens: float
    replenish_all_every: float

    @property
    def rate(self) -> float:
        return self.max_tokens / self.replenish_all_every


# Protocol quotas, shaped like the reference's defaults: bulk protocols
# are bounded by their spec maxima per ~10s window. Unit-protocol quotas
# are more generous than the reference's (which keys buckets by libp2p
# peer id): without a noise identity the bucket key collapses to the
# remote host, so several co-hosted nodes legitimately share one bucket.
DEFAULT_QUOTAS: dict[str, Quota] = {
    M.PROTO_STATUS: Quota(64, 15.0),
    M.PROTO_GOODBYE: Quota(16, 10.0),
    M.PROTO_PING: Quota(64, 10.0),
    M.PROTO_METADATA: Quota(64, 5.0),
    M.PROTO_BLOCKS_BY_RANGE: Quota(1024, 10.0),
    M.PROTO_BLOCKS_BY_ROOT: Quota(128, 10.0),
    M.PROTO_BLOBS_BY_RANGE: Quota(768, 10.0),
    M.PROTO_BLOBS_BY_ROOT: Quota(128, 10.0),
}


class RateLimiter:
    def __init__(self, quotas: dict[str, Quota] | None = None, clock=None):
        self.quotas = DEFAULT_QUOTAS if quotas is None else quotas
        self._clock = clock or time.monotonic
        # (peer, protocol) -> [tokens, last_refill]
        self._buckets: dict[tuple[str, str], list[float]] = {}
        self._lock = threading.Lock()
        self._ops_since_prune = 0

    def allow(self, peer: str, protocol: str, cost: float = 1.0) -> bool:
        """Deduct `cost` tokens if the bucket has them; False = limited.
        A cost larger than the bucket capacity can never be served and is
        always refused (the request itself is over-sized)."""
        quota = self.quotas.get(protocol)
        if quota is None:
            return True
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get((peer, protocol))
            if bucket is None:
                bucket = [quota.max_tokens, now]
                self._buckets[(peer, protocol)] = bucket
            tokens, last = bucket
            tokens = min(quota.max_tokens, tokens + (now - last) * quota.rate)
            bucket[1] = now
            if cost > tokens:
                bucket[0] = tokens
                return False
            bucket[0] = tokens - cost
            self._ops_since_prune += 1
            if self._ops_since_prune >= 1024:
                self._ops_since_prune = 0
                self._prune_locked(now)
            return True

    def _prune_locked(self, now: float):
        dead = [
            key
            for key, (_, last) in self._buckets.items()
            if now - last > 2 * self.quotas[key[1]].replenish_all_every
        ]
        for key in dead:
            del self._buckets[key]
