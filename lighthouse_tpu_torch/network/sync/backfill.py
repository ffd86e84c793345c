"""Resumable backfill sync (sync/backfill_sync/mod.rs).

After a checkpoint start the chain's history before the anchor is filled
BACKWARD: each window's blocks are hash-chain-linked to the running
expected root, proposer signatures are verified in one RLC batch (the
anchor registry is append-only, so every historic proposer resolves in
it), and the linked span is stored via the beacon_processor's
BACKFILL_SYNC queue — history is cold data and must not outrank live
gossip work.

Resumability: the (oldest stored slot, expected parent root) watermark is
persisted in the store's metadata column after every committed window, so
a restarted node resumes where it stopped instead of re-downloading the
whole span. Peer faults: RPC failures retry with exponential backoff on a
rotated peer; a non-empty window with ZERO chain-linked blocks is
garbage/fork spam and costs the serving peer a full invalid-message
downscore before the window is retried elsewhere (spam used to be free —
the old inline loop just gave up)."""

from __future__ import annotations

import struct
import threading
import time

from ...beacon_processor import WorkType
from ...metrics import inc_counter
from ...utils.logging import get_logger
from ...utils.tracing import span
from ..rpc import RpcError

log = get_logger("lighthouse_tpu_torch.sync.backfill")

WATERMARK_KEY = b"sync/backfill_watermark"


class BackfillSync:
    def __init__(self, service, ctx, config):
        self.service = service
        self.ctx = ctx
        self.cfg = config

    # -- watermark ---------------------------------------------------------

    def watermark(self):
        """(oldest_slot, expected_parent_root) persisted after the last
        committed window, or None before the first."""
        raw = self.service.chain.store.get_meta(WATERMARK_KEY)
        if raw is None or len(raw) != 40:
            return None
        (slot,) = struct.unpack("<Q", raw[:8])
        return int(slot), raw[8:]

    def _save_watermark(self, oldest_slot: int, expected_root: bytes):
        self.service.chain.store.put_meta(
            WATERMARK_KEY, struct.pack("<Q", int(oldest_slot)) + bytes(expected_root)
        )

    # -- the backward walk -------------------------------------------------

    def run(self, peers, verify_signatures: bool = True, max_batches=None) -> int:
        """Walk history backward from the watermark (or the anchor) toward
        genesis. Returns the number of blocks stored this run."""
        chain = self.service.chain
        anchor_root = chain.genesis_block_root
        anchor = chain._blocks_by_root.get(anchor_root) or chain.store.get_block(
            anchor_root
        )
        if anchor is None or anchor.message.slot == 0:
            return 0  # genesis start: nothing to backfill
        wm = self.watermark()
        if wm is not None:
            oldest_slot, expected_root = wm
        else:
            oldest_slot = int(anchor.message.slot)
            expected_root = bytes(anchor.message.parent_root)
        from . import SYNC_STATE_BACKFILL, set_sync_state

        set_sync_state(SYNC_STATE_BACKFILL)
        batch_size = self.cfg.epochs_per_batch * chain.E.SLOTS_PER_EPOCH
        stored = 0
        windows = 0
        try:
            while oldest_slot > 0:
                if max_batches is not None and windows >= max_batches:
                    break
                if self.service._stopping:
                    break
                start = max(0, oldest_slot - batch_size)
                count = oldest_slot - start
                linked = self._fetch_linked_window(
                    peers, start, count, expected_root, verify_signatures
                )
                if linked is None:
                    break  # every peer failed/spammed this window: give up
                if not linked:
                    if start == 0:
                        break  # bottom of history: only genesis remains
                    # a whole window of skipped slots (non-finality gap):
                    # step past it — the expected root is still the next
                    # older block's, it just lives further down. The step
                    # is NOT persisted: an empty response is
                    # unauthenticated, and watermarking past history a
                    # lying peer merely withheld would wedge the walk
                    # forever. A restart re-walks the gap from the last
                    # committed window (cheap: empty responses).
                    windows += 1
                    oldest_slot = start
                    continue
                windows += 1
                new_oldest = int(linked[-1][1].message.slot)
                new_expected = bytes(linked[-1][1].message.parent_root)
                if not self._commit_window(linked, new_oldest, new_expected):
                    break
                stored += len(linked)
                oldest_slot = new_oldest
                expected_root = new_expected
        finally:
            from . import SYNC_STATE_SYNCED, SYNC_STATE_STALLED

            set_sync_state(
                SYNC_STATE_SYNCED if oldest_slot <= 1 else SYNC_STATE_STALLED
            )
        inc_counter("backfill_blocks_stored_total", amount=stored)
        return stored

    def _fetch_linked_window(
        self, peers, start, count, expected_root, verify_signatures
    ):
        """Download [start, start+count) and extract the chain-linked,
        signature-verified suffix ending at `expected_root`. Retries with
        backoff across rotated peers. Returns the linked list, [] for a
        legitimately empty window (all slots skipped / peer has no older
        history), or None when every peer failed or spammed the window."""
        from .. import SCORE_INVALID_MESSAGE

        failed_peers: set[str] = set()
        for attempt in range(self.cfg.max_download_attempts):
            peer = self.ctx.select_peer(peers, exclude=failed_peers)
            if peer is None:
                return None
            inc_counter("sync_batch_downloads_total", chain="backfill")
            try:
                with span("sync_backfill_batch", start=start, peer=peer.peer_id):
                    blocks = self.ctx.blocks_by_range(peer, start, count)
            except (RpcError, OSError) as e:
                log.info(
                    "backfill download failed",
                    peer=peer.peer_id,
                    error=str(e)[:120],
                )
                inc_counter("sync_batch_retries_total", chain="backfill")
                failed_peers.add(peer.peer_id)
                time.sleep(
                    min(
                        self.cfg.backoff_max_s,
                        self.cfg.backoff_base_s * (2**attempt),
                    )
                )
                continue
            if not blocks:
                return []  # legitimately empty window (caller steps past)
            # walk backward collecting the chain-linked subset (peers may
            # interleave fork blocks; those simply don't match)
            linked = []
            exp = expected_root
            for signed in reversed(blocks):
                root = signed.message.hash_tree_root()
                if root != exp:
                    continue
                linked.append((root, signed))
                exp = bytes(signed.message.parent_root)
            if not linked:
                # non-empty window, zero linked blocks: garbage or fork
                # spam — penalize BEFORE rotating away (this used to be
                # free for the peer)
                self.service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
                inc_counter("sync_batch_failures_total", chain="backfill")
                failed_peers.add(peer.peer_id)
                continue
            if verify_signatures and not verify_backfill_signatures(
                [s for _, s in linked], self.service.chain
            ):
                self.service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
                inc_counter("sync_batch_failures_total", chain="backfill")
                failed_peers.add(peer.peer_id)
                continue
            return linked
        return None

    def _commit_window(self, linked, new_oldest, new_expected) -> bool:
        """Store the window + advance the watermark through the
        BACKFILL_SYNC queue (lowest priority: history must not preempt
        live work). Falls back inline when the queue is saturated."""
        chain = self.service.chain
        done = threading.Event()

        def handler(items):
            # store only: backfilled history is cold data served from the
            # store (the hot block map would pin pre-anchor slots forever)
            for root, signed in items:
                chain.store.put_block(root, signed)
            self._save_watermark(new_oldest, new_expected)
            done.set()

        if not self.service.processor.submit(
            WorkType.BACKFILL_SYNC, linked, handler
        ):
            handler(linked)
            return True
        return done.wait(timeout=30.0)


def verify_backfill_signatures(blocks, chain) -> bool:
    """One RLC batch over backfilled proposer signatures. The anchor
    state's registry is append-only, so every historic proposer index
    resolves in it; domains come from the fork schedule, not a state."""
    from ...crypto import bls
    from ...types.chain_spec import Domain, compute_signing_root

    state = chain.head_state
    spec = chain.spec
    sets = []
    for signed in blocks:
        m = signed.message
        if m.proposer_index >= len(state.validators):
            return False
        pubkey = bls.PublicKey(bytes(state.validators[m.proposer_index].pubkey))
        epoch = m.slot // chain.E.SLOTS_PER_EPOCH
        domain = spec.compute_domain_from_parts(
            Domain.BEACON_PROPOSER,
            spec.fork_version_at_epoch(epoch),
            bytes(state.genesis_validators_root),
        )
        root = compute_signing_root(m.hash_tree_root(), domain)
        sets.append(
            bls.SignatureSet.single(
                bls.Signature(bytes(signed.signature)), pubkey, root
            )
        )
    return bls.get_backend().verify_signature_sets(sets)
