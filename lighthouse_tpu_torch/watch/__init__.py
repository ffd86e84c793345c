"""Off-node analytics service (the `watch` crate analog).

An updater polls a beacon node over the HTTP API and records canonical
slots, proposers, and finality progress into sqlite (the reference uses
postgres/diesel); query helpers compute the per-proposer block counts,
missed-slot lists, and participation the reference's REST server exposes
(watch/src/{updater,database,server})."""

from __future__ import annotations

import sqlite3
import threading

from ..eth2 import BeaconNodeHttpClient
from ..utils.http_server import JsonHttpServer, JsonRequestHandler
from .blockprint import classify_block


class WatchDB:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS canonical_slots ("
            "slot INTEGER PRIMARY KEY, root BLOB, proposer INTEGER, "
            "skipped INTEGER NOT NULL DEFAULT 0)"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS finality ("
            "checked_at_slot INTEGER PRIMARY KEY, "
            "justified_epoch INTEGER, finalized_epoch INTEGER)"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS gaps ("
            "lo INTEGER, hi INTEGER)"
        )
        # block-packing + participation analytics (watch's block_packing /
        # suboptimal_attestations tables)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS block_packing ("
            "slot INTEGER PRIMARY KEY, attestation_count INTEGER, "
            "attester_votes INTEGER, sync_bits INTEGER, sync_size INTEGER)"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS suboptimal_attestations ("
            "att_slot INTEGER, included_at INTEGER, delay INTEGER, "
            "PRIMARY KEY (att_slot, included_at))"
        )
        # blockprint (client-fingerprint) per proposal (watch/src/blockprint)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS blockprint ("
            "slot INTEGER PRIMARY KEY, best_guess TEXT, el_guess TEXT, "
            "graffiti TEXT)"
        )
        # per-block proposer rewards (watch's block_rewards table)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS block_rewards ("
            "slot INTEGER PRIMARY KEY, proposer INTEGER, total INTEGER, "
            "attestations INTEGER, sync_aggregate INTEGER)"
        )
        self._conn.commit()

    def record_gap(self, lo: int, hi: int):
        """History the node could not serve — these slots stay unrecorded
        and queries over them are knowingly incomplete."""
        with self._lock:
            self._conn.execute("INSERT INTO gaps VALUES (?, ?)", (lo, hi))
            self._conn.commit()

    def gaps(self) -> list[tuple[int, int]]:
        with self._lock:
            return self._conn.execute(
                "SELECT lo, hi FROM gaps ORDER BY lo"
            ).fetchall()

    def record_slot(self, slot: int, root: bytes | None, proposer: int | None):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO canonical_slots VALUES (?, ?, ?, ?)",
                (slot, root, proposer, 1 if root is None else 0),
            )
            self._conn.commit()

    def record_finality(self, at_slot: int, justified: int, finalized: int):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO finality VALUES (?, ?, ?)",
                (at_slot, justified, finalized),
            )
            self._conn.commit()

    # -- queries (server.rs routes) -------------------------------------------

    def proposer_counts(self) -> dict[int, int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT proposer, COUNT(*) FROM canonical_slots "
                "WHERE skipped = 0 GROUP BY proposer"
            ).fetchall()
        return {p: c for p, c in rows}

    def missed_slots(self) -> list[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT slot FROM canonical_slots WHERE skipped = 1 "
                "ORDER BY slot"
            ).fetchall()
        return [r[0] for r in rows]

    def latest_finality(self) -> tuple[int, int] | None:
        with self._lock:
            return self._conn.execute(
                "SELECT justified_epoch, finalized_epoch FROM finality "
                "ORDER BY checked_at_slot DESC LIMIT 1"
            ).fetchone()

    def highest_slot(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(slot) FROM canonical_slots"
            ).fetchone()
        return row[0] if row[0] is not None else -1

    def record_packing(
        self, slot: int, att_count: int, attester_votes: int,
        sync_bits: int, sync_size: int, suboptimal_rows=(),
    ):
        """One transaction per block: the packing row plus its suboptimal
        attestations (idempotent — re-walked boundary blocks replace
        rather than duplicate)."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO block_packing VALUES (?, ?, ?, ?, ?)",
                (slot, att_count, attester_votes, sync_bits, sync_size),
            )
            self._conn.executemany(
                "INSERT OR REPLACE INTO suboptimal_attestations "
                "VALUES (?, ?, ?)",
                list(suboptimal_rows),
            )
            self._conn.commit()

    def packing_stats(self) -> dict:
        """Aggregate block-packing view (server.rs block_packing route).
        Returns the suboptimal count from the SAME locked snapshot so the
        REST response is internally consistent vs a concurrent updater."""
        with self._lock:
            sub = self._conn.execute(
                "SELECT COUNT(*) FROM suboptimal_attestations"
            ).fetchone()[0]
            row = self._conn.execute(
            "SELECT COUNT(*), AVG(attestation_count), AVG(attester_votes), "
            "AVG(CAST(sync_bits AS REAL) / NULLIF(sync_size, 0)) "
                "FROM block_packing"
            ).fetchone()
        return {
            "blocks": row[0],
            "avg_attestations": row[1] or 0.0,
            "avg_attester_votes": row[2] or 0.0,
            "avg_sync_participation": row[3] or 0.0,
            "suboptimal_attestations": sub,
        }

    def has_block_between(self, lo: int, hi: int) -> bool:
        """Any recorded canonical block at a slot in (lo, hi) exclusive —
        re-walks consult this for history outside the fresh walk."""
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM canonical_slots WHERE skipped = 0 "
                "AND slot > ? AND slot < ? LIMIT 1",
                (lo, hi),
            ).fetchone()
        return row is not None

    def record_blockprint(self, slot: int, print_: dict):
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO blockprint VALUES (?, ?, ?, ?)",
                (
                    slot,
                    print_["best_guess"],
                    print_.get("el_guess"),
                    print_.get("graffiti", ""),
                ),
            )
            self._conn.commit()

    def blockprint_for_slot(self, slot: int) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT best_guess, el_guess, graffiti FROM blockprint "
                "WHERE slot = ?",
                (slot,),
            ).fetchone()
        if row is None:
            return None
        return {"best_guess": row[0], "el_guess": row[1], "graffiti": row[2]}

    def blockprint_shares(self) -> dict[str, int]:
        """Proposal counts per guessed client (the blockprint aggregate)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT best_guess, COUNT(*) FROM blockprint GROUP BY best_guess"
            ).fetchall()
        return {guess: count for guess, count in rows}

    def record_block_rewards(self, slot: int, rewards: dict):
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO block_rewards VALUES (?, ?, ?, ?, ?)",
                (
                    slot,
                    int(rewards["proposer_index"]),
                    int(rewards["total"]),
                    int(rewards["attestations"]),
                    int(rewards["sync_aggregate"]),
                ),
            )
            self._conn.commit()

    def has_block_rewards(self, slot: int) -> bool:
        with self._lock:
            return (
                self._conn.execute(
                    "SELECT 1 FROM block_rewards WHERE slot = ?", (slot,)
                ).fetchone()
                is not None
            )

    def rewards_stats(self) -> dict:
        """Aggregate proposer-reward analytics (watch's rewards queries)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*), COALESCE(SUM(total), 0), "
                "COALESCE(AVG(total), 0) FROM block_rewards"
            ).fetchone()
            per_proposer = self._conn.execute(
                "SELECT proposer, SUM(total) FROM block_rewards "
                "GROUP BY proposer"
            ).fetchall()
        return {
            "blocks": row[0],
            "total_gwei": int(row[1]),
            "mean_gwei": round(row[2], 1),
            "per_proposer": {str(p): int(t) for p, t in per_proposer},
        }

    def suboptimal_attestation_count(self) -> int:
        with self._lock:
            return self._conn.execute(
                "SELECT COUNT(*) FROM suboptimal_attestations"
            ).fetchone()[0]


class WatchUpdater:
    """Polls the node and fills the DB (updater.rs)."""

    def __init__(self, client: BeaconNodeHttpClient, db: WatchDB, types):
        self.client = client
        self.db = db
        self.types = types
        # rewards fetches that failed transiently: slot -> block root,
        # retried on every update (a permanent 4xx drops the entry)
        self._rewards_retry: dict[int, bytes] = {}

    def update(self) -> int:
        """Walk new canonical slots up to the node's head; returns how many
        slots were recorded."""
        syncing = self.client.get_syncing()
        head_slot = int(syncing["head_slot"])
        # slot 0 is genesis, not a proposal
        start = max(self.db.highest_slot() + 1, 1)
        if start > head_slot:
            return 0
        # walk the canonical chain backward from head to `start`
        blocks_by_slot: dict[int, tuple] = {}
        packing_jobs: list = []
        data = self.client.get_block_ssz("head")
        signed = self.types.decode_by_fork("SignedBeaconBlock", data)
        walk_complete = False
        while True:
            slot = int(signed.message.slot)
            blocks_by_slot[slot] = (
                signed.message.hash_tree_root(),
                int(signed.message.proposer_index),
            )
            packing_jobs.append(signed)
            parent = bytes(signed.message.parent_root)
            if slot <= max(start, 1) or parent == b"\x00" * 32:
                walk_complete = True
                break
            try:
                data = self.client.get_block_ssz("0x" + parent.hex())
            except Exception:  # noqa: BLE001 — history beyond the hot cache
                break
            signed = self.types.decode_by_fork("SignedBeaconBlock", data)

        # A slot with no block is only PROVABLY skipped when the walk
        # reached below it — an incomplete walk must leave a hole, never
        # record real proposals as missed (rows are write-once).
        certainty_floor = start if walk_complete else min(blocks_by_slot)
        if certainty_floor > start:
            # the hole is permanent (rows advance past it); record it so
            # queries are explicitly known-incomplete instead of silently so
            self.db.record_gap(start, certainty_floor - 1)
        recorded = 0
        for slot in range(start, head_slot + 1):
            ent = blocks_by_slot.get(slot)
            if ent is not None:
                self.db.record_slot(slot, ent[0], ent[1])
            elif slot >= certainty_floor:
                self.db.record_slot(slot, None, None)  # skipped slot
            else:
                continue  # hole: history unavailable, leave unrecorded
            recorded += 1
        for signed in packing_jobs:
            self._record_packing(signed, blocks_by_slot)
            slot = int(signed.message.slot)
            if self.db.blockprint_for_slot(slot) is None:
                self.db.record_blockprint(slot, classify_block(signed))
            if not self.db.has_block_rewards(slot):
                # root already computed during the walk — no re-merkleize
                self._fetch_rewards(slot, blocks_by_slot[slot][0])
        for slot, root in list(self._rewards_retry.items()):
            if self.db.has_block_rewards(slot):
                self._rewards_retry.pop(slot, None)
            else:
                self._fetch_rewards(slot, root)
        fin = self.client.get_finality_checkpoints("head")
        self.db.record_finality(
            head_slot,
            int(fin["current_justified"]["epoch"]),
            int(fin["finalized"]["epoch"]),
        )
        return recorded

    def _fetch_rewards(self, slot: int, root: bytes):
        """Pull per-block rewards from the node. Permanent refusals (4xx:
        pre-Altair block or parent state beyond the node's window) are
        dropped; transient failures are queued for retry on the next
        update so no silent permanent hole forms."""
        import urllib.error

        try:
            self.db.record_block_rewards(
                slot, self.client.get_block_rewards("0x" + root.hex())
            )
            self._rewards_retry.pop(slot, None)
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500:
                self._rewards_retry.pop(slot, None)  # permanent: give up
            else:
                self._rewards_retry[slot] = root
        except Exception:  # noqa: BLE001 — analytics must not wedge updates
            self._rewards_retry[slot] = root

    def _record_packing(self, signed, blocks_by_slot):
        """Per-block packing + suboptimal-attestation analytics
        (updater's block_packing / attestation passes). An attestation is
        suboptimal only when an EARLIER canonical block could have carried
        it — skipped slots between its slot and its inclusion don't count
        against it."""
        m = signed.message
        body = m.body
        att_count = len(body.attestations)
        votes = sum(sum(a.aggregation_bits) for a in body.attestations)
        agg = getattr(body, "sync_aggregate", None)
        sync_bits = sum(agg.sync_committee_bits) if agg is not None else 0
        sync_size = len(agg.sync_committee_bits) if agg is not None else 0
        suboptimal = [
            (int(a.data.slot), int(m.slot), int(m.slot) - int(a.data.slot))
            for a in body.attestations
            if int(m.slot) - int(a.data.slot) > 1
            and (
                any(
                    s in blocks_by_slot
                    for s in range(int(a.data.slot) + 1, int(m.slot))
                )
                # slots below the fresh walk live in the DB from earlier
                # runs — without this, re-walked boundary blocks would
                # REPLACE correct rows with false "optimal"
                or self.db.has_block_between(int(a.data.slot), int(m.slot))
            )
        ]
        self.db.record_packing(
            int(m.slot), att_count, votes, sync_bits, sync_size,
            suboptimal_rows=suboptimal,
        )


class WatchServer(JsonHttpServer):
    """REST surface over the DB (watch/src/server): /v1/slots/missed,
    /v1/proposers, /v1/finality, /v1/packing, /v1/gaps."""

    def __init__(self, db: WatchDB, port: int = 0):
        watch_db = db

        class _Handler(JsonRequestHandler):
            def do_GET(self):
                routes = {
                    "/v1/slots/missed": lambda: watch_db.missed_slots(),
                    "/v1/proposers": lambda: {
                        str(k): v for k, v in watch_db.proposer_counts().items()
                    },
                    "/v1/finality": lambda: watch_db.latest_finality(),
                    "/v1/packing": lambda: watch_db.packing_stats(),
                    "/v1/gaps": lambda: watch_db.gaps(),
                    "/v1/blockprint": lambda: watch_db.blockprint_shares(),
                    "/v1/rewards": lambda: watch_db.rewards_stats(),
                }
                fn = routes.get(self.route)
                if fn is None:
                    return self.send_json({"error": "not found"}, 404)
                try:
                    return self.send_json(fn())
                except Exception as e:  # noqa: BLE001 — 500, not a reset
                    return self.send_json({"error": str(e)}, 500)

        super().__init__(_Handler, port=port, name="watch-server")
