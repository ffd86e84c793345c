"""Sync-side view of the network (sync/network_context.rs).

Owns what every sync component would otherwise reimplement: request id
allocation (for log/span correlation), per-peer in-flight accounting (the
download scheduler prefers idle peers), and block/blob-sidecar coupling
for commitment-carrying batches (block_sidecar_coupling.rs — a range
batch is not importable until its sidecars are staged in the DA checker).
"""

from __future__ import annotations

import threading

from ...metrics import inc_counter
from ...utils.tracing import span
from .. import messages as M


class SyncNetworkContext:
    def __init__(self, service):
        self.service = service
        self._lock = threading.Lock()
        self._next_id = 0
        self._inflight: dict[str, int] = {}

    # -- request ids / in-flight accounting --------------------------------

    def next_request_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def inflight(self, peer_id: str) -> int:
        with self._lock:
            return self._inflight.get(peer_id, 0)

    def _begin(self, peer_id: str) -> int:
        with self._lock:
            self._next_id += 1
            self._inflight[peer_id] = self._inflight.get(peer_id, 0) + 1
            return self._next_id

    def _end(self, peer_id: str):
        with self._lock:
            n = self._inflight.get(peer_id, 0) - 1
            if n <= 0:
                self._inflight.pop(peer_id, None)
            else:
                self._inflight[peer_id] = n

    # -- peer selection ----------------------------------------------------

    def select_peer(self, peers, exclude=frozenset(), strikes=None):
        """ONE ranking policy for every sync engine: among alive peers not
        in `exclude`, pick fewest `strikes` (per-request-context failure
        counts), then highest score, then fewest requests in flight.
        Returns None when no candidate survives."""
        strikes = strikes or {}
        best = None
        best_key = None
        for p in peers:
            if p.peer_id in exclude:
                continue
            live = self.service.peers.get(p.peer_id)
            if live is None:
                continue  # banned or dropped
            key = (
                strikes.get(p.peer_id, 0),
                -live.score,
                self.inflight(p.peer_id),
            )
            if best_key is None or key < best_key:
                best = p
                best_key = key
        return best

    # -- requests ----------------------------------------------------------

    def blocks_by_range(self, peer, start_slot: int, count: int) -> list:
        req_id = self._begin(peer.peer_id)
        inc_counter("sync_rpc_requests_total", method="blocks_by_range")
        try:
            with span("sync_rpc_blocks_by_range", req_id=req_id, peer=peer.peer_id):
                return peer.client.blocks_by_range(
                    int(start_slot), int(count), self.service.decode_block
                )
        finally:
            self._end(peer.peer_id)

    def blocks_by_root(self, peer, roots: list) -> list:
        req_id = self._begin(peer.peer_id)
        inc_counter("sync_rpc_requests_total", method="blocks_by_root")
        try:
            with span("sync_rpc_blocks_by_root", req_id=req_id, peer=peer.peer_id):
                return peer.client.blocks_by_root(
                    list(roots), self.service.decode_block
                )
        finally:
            self._end(peer.peer_id)

    # -- block / blob-sidecar coupling -------------------------------------

    def couple_blob_sidecars(self, peer, blocks):
        """Stage the sidecars of commitment-carrying range blocks in the DA
        checker before the segment imports (block_sidecar_coupling.rs).
        A bad sidecar penalizes the peer and leaves the affected block to
        fail its DA gate during the segment import, which reports the
        batch outcome through the normal processing-failure path."""
        from .. import SCORE_INVALID_MESSAGE

        chain = self.service.chain
        wanted = []
        now = chain.slot_clock.now()
        for signed in blocks:
            commitments = getattr(signed.message.body, "blob_kzg_commitments", None)
            if not commitments:
                continue
            if not chain.block_within_da_window(signed.message.slot, now):
                continue  # peers have pruned these; import skips the gate
            root = signed.message.hash_tree_root()
            for i in range(len(commitments)):
                wanted.append(M.BlobIdentifier(block_root=root, index=i))
        if not wanted:
            return
        t = chain.types
        req_id = self._begin(peer.peer_id)
        inc_counter("sync_rpc_requests_total", method="blob_sidecars_by_root")
        try:
            with span("sync_rpc_blobs_by_root", req_id=req_id, peer=peer.peer_id):
                sidecars = peer.client.blob_sidecars_by_root(
                    wanted, t.BlobSidecar.deserialize
                )
        finally:
            self._end(peer.peer_id)
        by_root: dict[bytes, list] = {}
        for sc in sidecars:
            r = sc.signed_block_header.message.hash_tree_root()
            by_root.setdefault(r, []).append(sc)
        # segment-wide coalesced KZG: one RLC batch across every block's
        # sidecars (bisected per block only on failure) instead of one
        # pairing batch per block — proven-invalid groups penalize the
        # peer; merely-missing components don't (IGNORE class)
        from ...beacon_chain.data_availability import InvalidComponentsError

        try:
            results = chain.process_segment_blob_sidecars(by_root)
        except Exception:  # noqa: BLE001 — unexpected: penalize, move on
            self.service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
            return
        if any(isinstance(e, InvalidComponentsError) for e in results.values()):
            self.service.peers.report(peer.peer_id, SCORE_INVALID_MESSAGE)
