"""Single-block and parent-chain lookups (sync/block_lookups/).

Gossip regularly references roots the chain doesn't have yet: a block
whose parent got lost, an attestation for a head we haven't imported.
Instead of downscoring the forwarder (it did nothing wrong) the node
recovers: walk the unknown ancestry via `blocks_by_root` — capped depth,
rotated peers, de-duplicated in-flight roots — then import the recovered
chain oldest-first through the beacon_processor and release every piece
of held work (unknown-block attestations in the reprocess queue) the
moment its block lands.
"""

from __future__ import annotations

import threading
import time

from ...beacon_processor import WorkType
from ...metrics import inc_counter
from ...utils.logging import get_logger
from ...utils.tracing import span
from ..rpc import RpcError

log = get_logger("lighthouse_tpu_torch.sync.lookups")

#: a root NOBODY in the pool had is not retried for this long — an
#: unknown-root gossip flood would otherwise re-trigger a whole-pool
#: blocks_by_root sweep per spam message (the rotation now spans every
#: connected peer, so the negative cache is what bounds amplification)
LOOKUP_NEGATIVE_TTL_S = 3.0
_NEGATIVE_CACHE_MAX = 4096


class BlockLookups:
    def __init__(self, service, ctx, config):
        self.service = service
        self.ctx = ctx
        self.cfg = config
        self._lock = threading.Lock()
        #: roots with a lookup thread live — gossip floods the same
        #: unknown root from many peers; only the first spawns work
        self._inflight: set[bytes] = set()
        #: root -> monotonic stamp of its last FAILED lookup (bounded;
        #: entries expire after LOOKUP_NEGATIVE_TTL_S)
        self._recent_failures: dict[bytes, float] = {}
        self._stopping = False

    def stop(self):
        self._stopping = True

    def peer_connected(self):
        """A fresh peer voids every negative-cache entry: "nobody had
        it" was a verdict on the OLD pool (same principle as the sync
        service's backoff reset — a reconnect/heal is a new chance)."""
        with self._lock:
            self._recent_failures.clear()

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    # -- entry points ------------------------------------------------------

    def search_block(self, block_root: bytes) -> bool:
        """Recover a root referenced by gossip (attestation/aggregate) that
        fork choice doesn't know. Returns False when already known or
        already in flight."""
        return self._spawn(bytes(block_root), None, kind="single")

    def search_parent(self, signed_block) -> bool:
        """Recover the ancestry of a gossip block whose parent is unknown,
        then import the block itself."""
        root = signed_block.message.hash_tree_root()
        return self._spawn(bytes(root), signed_block, kind="parent")

    def _spawn(self, root: bytes, block, kind: str) -> bool:
        chain = self.service.chain
        if self._stopping or chain.fork_choice.contains_block(root):
            return False
        with self._lock:
            if root in self._inflight:
                return False
            failed_at = self._recent_failures.get(root)
            if failed_at is not None:
                if time.monotonic() - failed_at < LOOKUP_NEGATIVE_TTL_S:
                    return False  # the whole pool just said no — back off
                del self._recent_failures[root]
            self._inflight.add(root)
        inc_counter("sync_lookups_started_total", kind=kind)
        threading.Thread(
            target=self._worker,
            args=(root, block, kind),
            daemon=True,
            name=f"sync-lookup-{root.hex()[:8]}",
        ).start()
        return True

    # -- the walk ----------------------------------------------------------

    def _worker(self, root: bytes, block, kind: str):
        try:
            with span("sync_block_lookup", kind=kind, root=root.hex()[:12]):
                ok = self._run(root, block)
        except Exception as e:  # noqa: BLE001 — lookups must not kill readers
            log.warning("block lookup crashed", error=str(e)[:200])
            ok = False
        finally:
            with self._lock:
                self._inflight.discard(root)
                if not ok:
                    now = time.monotonic()
                    if len(self._recent_failures) >= _NEGATIVE_CACHE_MAX:
                        # drop expired entries first; if a burst of
                        # distinct roots is all still fresh, evict oldest
                        # (insertion order) — the table stays bounded
                        self._recent_failures = {
                            r: t
                            for r, t in self._recent_failures.items()
                            if now - t < LOOKUP_NEGATIVE_TTL_S
                        }
                        while len(self._recent_failures) >= _NEGATIVE_CACHE_MAX:
                            self._recent_failures.pop(
                                next(iter(self._recent_failures))
                            )
                    self._recent_failures[root] = now
        if ok:
            inc_counter("sync_lookups_completed_total")
        else:
            inc_counter("sync_lookups_failed_total")

    def _run(self, target_root: bytes, block) -> bool:
        chain = self.service.chain
        # newest-first ancestor collection: the gossip block (if we hold
        # it), then blocks_by_root fetches walking parent links until a
        # known ancestor (or the depth cap — a chain that long belongs to
        # range sync, not lookups)
        newest_first = []
        if block is not None:
            newest_first.append(block)
            cursor = bytes(block.message.parent_root)
        else:
            cursor = target_root
        while not chain.fork_choice.contains_block(cursor):
            if self._stopping:
                return False
            if len(newest_first) >= self.cfg.lookup_max_depth:
                log.info(
                    "parent lookup exceeded depth cap",
                    root=target_root.hex()[:12],
                    depth=len(newest_first),
                )
                return False
            got = self._fetch_root(cursor)
            if got is None:
                return False
            newest_first.append(got)
            cursor = bytes(got.message.parent_root)
        if not newest_first:
            # raced: gossip (or range sync) imported it while we spawned —
            # still release anything parked under it, or held attestations
            # leak forever
            self._drain_held(target_root)
            return True
        return self._import_chain(list(reversed(newest_first)))

    def _drain_held(self, root: bytes):
        drained = self.service.reprocess.block_imported(
            root, self.service.processor
        )
        if drained:
            inc_counter("sync_lookup_reprocess_drained_total", amount=drained)
        return drained

    def _fetch_root(self, root: bytes):
        """One ancestor by root, rotating across alive peers (shared
        ranking: score then idleness); a peer that answers with a
        DIFFERENT block than asked is lying and pays for it.

        The rotation bound is the whole connected pool, not the retry
        budget: an honest "I don't have it" (empty response) is cheap,
        and after a partition heal the peers holding a competing fork's
        blocks may all rank BELOW same-side peers — a fixed 3-attempt cap
        kept asking the half that couldn't answer and the fleet never
        converged."""
        from .. import SCORE_INVALID_MESSAGE

        pool = self.service.peers.peers()
        attempts = max(self.cfg.lookup_max_attempts, len(pool))
        tried: set[str] = set()
        for _ in range(attempts):
            peer = self.ctx.select_peer(pool, exclude=tried)
            if peer is None:
                return None
            tried.add(peer.peer_id)
            try:
                got = self.ctx.blocks_by_root(peer, [root])
            except (RpcError, OSError):
                continue
            if not got:
                continue  # peer doesn't have it; try another
            if got[0].message.hash_tree_root() != root:
                self.service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
                continue
            return got[0]
        return None

    def _import_chain(self, blocks) -> bool:
        """Import the recovered chain oldest-first on the processor's
        RPC_BLOCK lane, then drain held work for every imported root —
        attestations parked in the reprocess queue re-fire the moment
        their block exists."""
        from ...beacon_chain.chain import BlockError, ChainSegmentResult

        service = self.service
        chain = service.chain
        done = threading.Event()
        outcome = {}

        def handler(items):
            try:
                try:
                    result = chain.process_chain_segment(items)
                except Exception as e:  # noqa: BLE001
                    result = ChainSegmentResult(imported=0, error=BlockError(str(e)))
                outcome["result"] = result
                for signed in items:
                    r = signed.message.hash_tree_root()
                    if not chain.fork_choice.contains_block(r):
                        break
                    self._drain_held(r)
            finally:
                done.set()

        if not service.processor.submit(WorkType.RPC_BLOCK, blocks, handler):
            handler(blocks)
        if not done.wait(timeout=30.0):
            return False
        result = outcome.get("result")
        return result is not None and result.error is None
