"""EIP-3076 slashing protection database.

Mirrors validator_client/slashing_protection (src/lib.rs:14-25): a sqlite
DB guarding every block proposal and attestation signature against double
proposals, double votes, and surround votes, plus interchange-format
(version 5) import/export. The same-data re-sign is permitted (idempotent
signing), matching the reference's behavior."""

from __future__ import annotations

import json
import sqlite3
import threading

SLASHING_PROTECTION_FILENAME = "slashing_protection.sqlite"
INTERCHANGE_VERSION = "5"


class NotSafe(Exception):
    """Signing refused: would violate a slashing condition."""


class SlashingDatabase:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        c = self._conn
        c.execute(
            "CREATE TABLE IF NOT EXISTS validators ("
            "id INTEGER PRIMARY KEY, pubkey BLOB UNIQUE NOT NULL)"
        )
        c.execute(
            "CREATE TABLE IF NOT EXISTS signed_blocks ("
            "validator_id INTEGER NOT NULL, slot INTEGER NOT NULL, "
            "signing_root BLOB, UNIQUE (validator_id, slot))"
        )
        c.execute(
            "CREATE TABLE IF NOT EXISTS signed_attestations ("
            "validator_id INTEGER NOT NULL, source_epoch INTEGER NOT NULL, "
            "target_epoch INTEGER NOT NULL, signing_root BLOB, "
            "UNIQUE (validator_id, target_epoch))"
        )
        c.commit()

    # -- registration ---------------------------------------------------------

    def register_validator(self, pubkey: bytes) -> int:
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO validators (pubkey) VALUES (?)",
                (bytes(pubkey),),
            )
            self._conn.commit()
        return self._validator_id(pubkey)

    def _validator_id(self, pubkey: bytes) -> int:
        row = self._conn.execute(
            "SELECT id FROM validators WHERE pubkey = ?", (bytes(pubkey),)
        ).fetchone()
        if row is None:
            raise NotSafe(f"unregistered validator {bytes(pubkey).hex()[:16]}")
        return row[0]

    # -- block proposals ------------------------------------------------------

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ):
        with self._lock:
            vid = self._validator_id(pubkey)
            row = self._conn.execute(
                "SELECT signing_root FROM signed_blocks "
                "WHERE validator_id = ? AND slot = ?",
                (vid, slot),
            ).fetchone()
            if row is not None:
                if row[0] == bytes(signing_root):
                    return  # idempotent re-sign
                raise NotSafe(f"double block proposal at slot {slot}")
            row = self._conn.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE validator_id = ?",
                (vid,),
            ).fetchone()
            if row[0] is not None and slot <= row[0]:
                raise NotSafe(
                    f"block slot {slot} <= min safe slot {row[0] + 1}"
                )
            self._conn.execute(
                "INSERT INTO signed_blocks VALUES (?, ?, ?)",
                (vid, slot, bytes(signing_root)),
            )
            self._conn.commit()

    # -- attestations ---------------------------------------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int, signing_root: bytes
    ):
        if source_epoch > target_epoch:
            raise NotSafe("attestation source > target")
        with self._lock:
            vid = self._validator_id(pubkey)
            # double vote
            row = self._conn.execute(
                "SELECT signing_root FROM signed_attestations "
                "WHERE validator_id = ? AND target_epoch = ?",
                (vid, target_epoch),
            ).fetchone()
            if row is not None:
                if row[0] == bytes(signing_root):
                    return
                raise NotSafe(f"double vote at target {target_epoch}")
            # new surrounds an existing vote
            row = self._conn.execute(
                "SELECT source_epoch, target_epoch FROM signed_attestations "
                "WHERE validator_id = ? AND source_epoch > ? AND target_epoch < ?",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if row is not None:
                raise NotSafe(f"surrounds existing vote {row}")
            # existing vote surrounds the new one
            row = self._conn.execute(
                "SELECT source_epoch, target_epoch FROM signed_attestations "
                "WHERE validator_id = ? AND source_epoch < ? AND target_epoch > ?",
                (vid, source_epoch, target_epoch),
            ).fetchone()
            if row is not None:
                raise NotSafe(f"surrounded by existing vote {row}")
            # monotonic lower bounds (interchange minimality)
            row = self._conn.execute(
                "SELECT MAX(target_epoch) FROM signed_attestations "
                "WHERE validator_id = ?",
                (vid,),
            ).fetchone()
            if row[0] is not None and target_epoch <= row[0]:
                raise NotSafe(
                    f"target {target_epoch} <= min safe target {row[0] + 1}"
                )
            self._conn.execute(
                "INSERT INTO signed_attestations VALUES (?, ?, ?, ?)",
                (vid, source_epoch, target_epoch, bytes(signing_root)),
            )
            self._conn.commit()

    # -- batched attestations (one transaction per slot) ----------------------

    def _insert_attestation_rows(self, rows):
        """Batch-insert seam, separated from the decision loop so the
        crash-point test can interrupt between staging and commit."""
        self._conn.executemany(
            "INSERT INTO signed_attestations VALUES (?, ?, ?, ?)", rows
        )

    def check_and_insert_attestations_batch(self, entries) -> list:
        """EIP-3076 checks for a whole slot's worth of attestations with
        ONE transaction instead of one commit per key.

        `entries` is [(pubkey, source_epoch, target_epoch, signing_root)].
        Returns a per-entry status list — None (safe to sign: fresh insert
        or idempotent same-root re-sign) or a NotSafe instance refusing
        ONLY that entry — equal to what sequential per-key
        `check_and_insert_attestation` calls in entry order would produce:
        an accepted entry is visible to later entries of the same batch
        exactly as its sequential commit would have been. History is
        preloaded in one whole-table pass (no per-key SELECTs, no IN-list
        size limits — the DB holds only this VC's keys), decisions run in
        Python against the preloaded view plus staged inserts, and
        accepted rows land in one transaction: any exception mid-batch
        rolls the DB back to the pre-batch watermark."""
        entries = list(entries)
        statuses: list = [None] * len(entries)
        with self._lock:
            vids = {
                pk: vid
                for pk, vid in self._conn.execute(
                    "SELECT pubkey, id FROM validators"
                )
            }
            batch_vids = set()
            for pubkey, _s, _t, _root in entries:
                vid = vids.get(bytes(pubkey))
                if vid is not None:
                    batch_vids.add(vid)
            # vid -> (target -> root, [(source, target)], max_target)
            by_target: dict[int, dict] = {}
            spans: dict[int, list] = {}
            max_target: dict[int, int] = {}
            for vid, s, t, root in self._conn.execute(
                "SELECT validator_id, source_epoch, target_epoch, "
                "signing_root FROM signed_attestations"
            ):
                if vid not in batch_vids:
                    continue
                by_target.setdefault(vid, {})[t] = root
                spans.setdefault(vid, []).append((s, t))
                if t > max_target.get(vid, -1):
                    max_target[vid] = t
            rows = []
            for i, (pubkey, source, target, signing_root) in enumerate(
                entries
            ):
                if source > target:
                    statuses[i] = NotSafe("attestation source > target")
                    continue
                vid = vids.get(bytes(pubkey))
                if vid is None:
                    statuses[i] = NotSafe(
                        f"unregistered validator {bytes(pubkey).hex()[:16]}"
                    )
                    continue
                root = bytes(signing_root)
                seen = by_target.setdefault(vid, {})
                prev = seen.get(target)
                if prev is not None:
                    if prev != root:
                        statuses[i] = NotSafe(
                            f"double vote at target {target}"
                        )
                    continue  # same root: idempotent, nothing to insert
                surrounding = next(
                    (
                        st
                        for st in spans.get(vid, ())
                        if source < st[0] and st[1] < target
                    ),
                    None,
                )
                if surrounding is not None:
                    statuses[i] = NotSafe(
                        f"surrounds existing vote {surrounding}"
                    )
                    continue
                surrounded = next(
                    (
                        st
                        for st in spans.get(vid, ())
                        if st[0] < source and target < st[1]
                    ),
                    None,
                )
                if surrounded is not None:
                    statuses[i] = NotSafe(
                        f"surrounded by existing vote {surrounded}"
                    )
                    continue
                bound = max_target.get(vid)
                if bound is not None and target <= bound:
                    statuses[i] = NotSafe(
                        f"target {target} <= min safe target {bound + 1}"
                    )
                    continue
                seen[target] = root
                spans.setdefault(vid, []).append((source, target))
                if target > max_target.get(vid, -1):
                    max_target[vid] = target
                rows.append((vid, source, target, root))
            try:
                if rows:
                    self._insert_attestation_rows(rows)
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
        return statuses

    # -- interchange (EIP-3076 JSON) ------------------------------------------

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        data = []
        for vid, pubkey in self._conn.execute(
            "SELECT id, pubkey FROM validators"
        ).fetchall():
            blocks = [
                {
                    "slot": str(slot),
                    **(
                        {"signing_root": "0x" + root.hex()}
                        if root is not None
                        else {}
                    ),
                }
                for slot, root in self._conn.execute(
                    "SELECT slot, signing_root FROM signed_blocks "
                    "WHERE validator_id = ? ORDER BY slot",
                    (vid,),
                ).fetchall()
            ]
            atts = [
                {
                    "source_epoch": str(s),
                    "target_epoch": str(t),
                    **(
                        {"signing_root": "0x" + root.hex()}
                        if root is not None
                        else {}
                    ),
                }
                for s, t, root in self._conn.execute(
                    "SELECT source_epoch, target_epoch, signing_root FROM "
                    "signed_attestations WHERE validator_id = ? "
                    "ORDER BY target_epoch",
                    (vid,),
                ).fetchall()
            ]
            data.append(
                {
                    "pubkey": "0x" + pubkey.hex(),
                    "signed_blocks": blocks,
                    "signed_attestations": atts,
                }
            )
        return {
            "metadata": {
                "interchange_format_version": INTERCHANGE_VERSION,
                "genesis_validators_root": "0x" + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, doc: dict | str, genesis_validators_root: bytes):
        if isinstance(doc, str):
            doc = json.loads(doc)
        meta = doc["metadata"]
        if meta["interchange_format_version"] != INTERCHANGE_VERSION:
            raise NotSafe(
                f"interchange version {meta['interchange_format_version']} unsupported"
            )
        gvr = meta["genesis_validators_root"].removeprefix("0x")
        if gvr != genesis_validators_root.hex():
            raise NotSafe("interchange genesis_validators_root mismatch")
        with self._lock:
            for entry in doc["data"]:
                pubkey = bytes.fromhex(entry["pubkey"].removeprefix("0x"))
                self._conn.execute(
                    "INSERT OR IGNORE INTO validators (pubkey) VALUES (?)",
                    (pubkey,),
                )
                vid = self._conn.execute(
                    "SELECT id FROM validators WHERE pubkey = ?", (pubkey,)
                ).fetchone()[0]
                for b in entry.get("signed_blocks", []):
                    root = b.get("signing_root")
                    self._conn.execute(
                        "INSERT OR REPLACE INTO signed_blocks VALUES (?, ?, ?)",
                        (
                            vid,
                            int(b["slot"]),
                            bytes.fromhex(root.removeprefix("0x"))
                            if root
                            else None,
                        ),
                    )
                for a in entry.get("signed_attestations", []):
                    root = a.get("signing_root")
                    self._conn.execute(
                        "INSERT OR REPLACE INTO signed_attestations "
                        "VALUES (?, ?, ?, ?)",
                        (
                            vid,
                            int(a["source_epoch"]),
                            int(a["target_epoch"]),
                            bytes.fromhex(root.removeprefix("0x"))
                            if root
                            else None,
                        ),
                    )
            self._conn.commit()

    def close(self):
        self._conn.close()
