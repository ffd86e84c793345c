"""Chunked min/max-span arrays for surround detection (slasher/src/array.rs).

The reference keeps two epoch-indexed distance arrays per validator on
disk, tiled as `chunk_size x validator_chunk_size` chunks, and answers
"does any recorded attestation surround / get surrounded by (s, t)?" with
two array lookups instead of a record scan. This module is that structure
rebuilt in the house columnar style:

  * RESIDENT representation: one full-validator-width ``uint16`` array
    per epoch chunk (``CHUNK_EPOCHS`` columns), so a whole block's
    attesting-index array gathers and updates in single fancy-indexed
    numpy ops — the same validator-axis layout as ``RegistryColumns``.
  * PERSISTED representation: reference-style tiles of
    ``VALIDATOR_CHUNK x CHUNK_EPOCHS`` uint16 (little-endian), keyed
    ``epoch_chunk (8B BE) || validator_chunk (8B BE)`` in the
    ``SLASHER_MIN_SPAN`` / ``SLASHER_MAX_SPAN`` KV columns. Exact dirty
    tracking at tile granularity: only tiles whose rows changed are
    rewritten in the cycle's atomic batch.

Encoding (distances are ``target - epoch``, clamped to ``DISTANCE_CAP``):

  * ``min_span[v, e]`` = min distance over v's records with source > e
    (default ``0xFFFF`` = no such record). A new vote (s2, t2)
    SURROUNDS a recorded one iff ``min_span[v, s2] < t2 - s2``.
  * ``max_span[v, e]`` = max distance over v's records with source < e
    (default ``0`` = no such record). A new vote is SURROUNDED by a
    recorded one iff ``max_span[v, s2] > t2 - s2``.

Updates walk the affected epoch window with per-validator short-circuit
(the reference's early termination): improvements to min spans are
contiguous downward from ``source - 1`` — if epoch e does not improve,
no epoch below it can — and symmetrically upward for max spans, so a
steady-state vote touches one chunk, not the history.

The spans are a NO-FALSE-NEGATIVE filter, not the oracle: windows are
depth-capped at ``UPDATE_WINDOW`` epochs and values clamp at
``DISTANCE_CAP``, and every case the arrays cannot answer exactly is
routed to the caller's exact record scan instead — via the per-validator
``overflow`` flag (pathological records: inverted/far-future/oversized
spans) and the ``min_source``/``max_source`` coarse columns (a query
whose epoch sits deeper than ``UPDATE_WINDOW`` from some recorded
source). Honest traffic never trips either guard.
"""

from __future__ import annotations

import numpy as np

#: epochs per chunk (the reference's default chunk_size)
CHUNK_EPOCHS = 16
#: validators per persisted tile (the reference's validator_chunk_size)
VALIDATOR_CHUNK = 256
#: "no attestation with source > e recorded" (min side)
MIN_SPAN_DEFAULT = 0xFFFF
#: "no attestation with source < e recorded" (max side)
MAX_SPAN_DEFAULT = 0
#: distances clamp here; a query distance at/over it routes to the scan
DISTANCE_CAP = 0xFFFE
#: span-update window depth per record (epochs below source for min
#: spans, above source for max spans). Queries deeper than this from a
#: recorded source are routed to the exact scan by the coarse columns,
#: so the cap bounds per-record work without losing detections.
UPDATE_WINDOW = 128
#: sources beyond current_epoch + slack are nonsense-future: their
#: validators are overflow-flagged (exact scan) instead of letting a
#: hostile source epoch materialize arbitrary far chunks
FUTURE_SLACK = 2
#: resident columns never grow past this many validator rows (~67M —
#: far beyond any realistic registry): a hostile attestation carrying a
#: huge validator index must not allocate terabytes; its validators are
#: overflow-flagged (exact scan, correctness preserved) instead
RESIDENT_ROWS_CAP = 1 << 26

_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

#: meta keys (shorter than the 16-byte tile keys, so they never collide)
_FLOOR_KEY = b"meta:floor"
_OVERFLOW_KEY = b"meta:overflow"
#: record-set fingerprint (count + order-independent checksum) written by
#: the columnar engine alongside its tiles: on reload, a mismatch against
#: the actual record rows means the tiles are STALE — another engine (the
#: scalar reference never touches span columns) recorded attestations in
#: between — and the spans must be rebuilt from the records
RECORDS_META_KEY = b"meta:records"


def _tile_key(ec: int, vc: int) -> bytes:
    return ec.to_bytes(8, "big") + vc.to_bytes(8, "big")


class SpanStore:
    """Resident chunked min/max-span arrays with tile persistence."""

    def __init__(self, kv=None, history_length: int = 4096):
        self._kv = kv
        self.history_length = int(history_length)
        self.floor = 0
        self._rows = 0  # validator capacity, always a multiple of VALIDATOR_CHUNK
        # side -> {epoch_chunk -> (rows, CHUNK_EPOCHS) uint16 array}
        self._chunks: dict[str, dict[int, np.ndarray]] = {"min": {}, "max": {}}
        # side -> {epoch_chunk -> bool mask over validator_chunk ids}
        self._dirty: dict[str, dict[int, np.ndarray]] = {"min": {}, "max": {}}
        # side -> {epoch_chunk -> set(validator_chunk ids present in KV)}
        self._kv_index: dict[str, dict[int, set[int]]] = {"min": {}, "max": {}}
        # coarse per-validator columns: query-time guards for records whose
        # contribution lies beyond a capped update window
        self._min_source = np.zeros(0, dtype=np.uint64)  # default u64::MAX
        self._max_source = np.zeros(0, dtype=np.uint64)  # default 0
        # validators whose span state is incomplete (pathological records):
        # the filter always routes them to the exact scan
        self._overflow: set[int] = set()
        self._overflow_arr = np.zeros(0, dtype=np.int64)  # sorted cache
        self._overflow_dirty = False
        self._floor_dirty = False
        if kv is not None:
            self._load_index()

    # -- persistence index / load ---------------------------------------------

    def _columns(self):
        from ..store.kv import DBColumn

        return {"min": DBColumn.SLASHER_MIN_SPAN, "max": DBColumn.SLASHER_MAX_SPAN}

    def _load_index(self):
        cols = self._columns()
        for side, col in cols.items():
            for key in self._kv.keys(col):
                if len(key) != 16:
                    continue  # meta key
                ec = int.from_bytes(key[:8], "big")
                vc = int.from_bytes(key[8:16], "big")
                self._kv_index[side].setdefault(ec, set()).add(vc)
        raw = self._kv.get(cols["min"], _FLOOR_KEY)
        if raw is not None:
            self.floor = int.from_bytes(raw, "big")
        raw = self._kv.get(cols["min"], _OVERFLOW_KEY)
        if raw is not None and len(raw):
            arr = np.frombuffer(raw, dtype=">u8").astype(np.int64)
            self._overflow = set(arr.tolist())
            self._overflow_arr = np.sort(arr)

    @property
    def has_tiles(self) -> bool:
        """Any persisted span state? False for a DB written by the scalar
        engine — the caller rebuilds spans from the reloaded records."""
        return bool(self._kv_index["min"]) or bool(self._kv_index["max"])

    def read_records_meta(self) -> bytes | None:
        if self._kv is None:
            return None
        return self._kv.get(self._columns()["min"], RECORDS_META_KEY)

    # -- capacity ---------------------------------------------------------------

    def ensure_rows(self, n: int):
        """Grow every resident structure to hold validator indices < n."""
        if n <= self._rows:
            return
        V = VALIDATOR_CHUNK
        new_rows = -(-int(n) // V) * V  # round up to a tile boundary
        for side in ("min", "max"):
            default = MIN_SPAN_DEFAULT if side == "min" else MAX_SPAN_DEFAULT
            for ec, arr in self._chunks[side].items():
                grown = np.full((new_rows, CHUNK_EPOCHS), default, dtype=np.uint16)
                grown[: arr.shape[0]] = arr
                self._chunks[side][ec] = grown
        for name, default in (("_min_source", _U64_MAX), ("_max_source", 0)):
            old = getattr(self, name)
            grown = np.full(new_rows, default, dtype=np.uint64)
            grown[: old.size] = old
            setattr(self, name, grown)
        self._rows = new_rows

    # -- chunk materialization ---------------------------------------------------

    def _materialize(self, side: str, ec: int) -> np.ndarray:
        arr = self._chunks[side].get(ec)
        if arr is not None:
            return arr
        default = MIN_SPAN_DEFAULT if side == "min" else MAX_SPAN_DEFAULT
        tiles = self._kv_index[side].get(ec, ())
        top = (max(tiles) + 1) * VALIDATOR_CHUNK if tiles else VALIDATOR_CHUNK
        self.ensure_rows(top)
        arr = np.full((self._rows, CHUNK_EPOCHS), default, dtype=np.uint16)
        if tiles:
            col = self._columns()[side]
            for vc in tiles:
                raw = self._kv.get(col, _tile_key(ec, vc))
                if raw is None:
                    continue
                tile = np.frombuffer(raw, dtype="<u2").reshape(-1, CHUNK_EPOCHS)
                arr[vc * VALIDATOR_CHUNK : vc * VALIDATOR_CHUNK + tile.shape[0]] = tile
        self._chunks[side][ec] = arr
        return arr

    # -- gathers (query side) ----------------------------------------------------

    def _gather(self, side: str, validators: np.ndarray, epoch: int) -> np.ndarray:
        default = MIN_SPAN_DEFAULT if side == "min" else MAX_SPAN_DEFAULT
        out = np.full(validators.shape, default, dtype=np.uint16)
        ec = epoch // CHUNK_EPOCHS
        if ec not in self._chunks[side] and ec not in self._kv_index[side]:
            return out  # never written: defaults are exact
        arr = self._materialize(side, ec)
        in_range = validators < arr.shape[0]
        out[in_range] = arr[validators[in_range], epoch % CHUNK_EPOCHS]
        return out

    def gather_min(self, validators: np.ndarray, epoch: int) -> np.ndarray:
        return self._gather("min", validators, epoch)

    def gather_max(self, validators: np.ndarray, epoch: int) -> np.ndarray:
        return self._gather("max", validators, epoch)

    def scan_guard_mask(self, validators: np.ndarray, epoch: int) -> np.ndarray:
        """True where the spans CANNOT answer exactly for this validator at
        this query epoch and the caller must run its exact record scan:
        overflow-flagged validators, plus validators with a recorded
        source more than UPDATE_WINDOW epochs on either side of the query
        epoch (their span contribution was window-capped away)."""
        guard = np.zeros(validators.shape, dtype=bool)
        if self._overflow_arr.size:
            guard |= np.isin(validators, self._overflow_arr)
        m = validators < self._max_source.size
        if m.any():
            vs = validators[m]
            sub = self._max_source[vs] > np.uint64(epoch + UPDATE_WINDOW)
            lo = epoch - UPDATE_WINDOW
            if lo > 0:
                sub |= self._min_source[vs] < np.uint64(lo)
            guard[m] |= sub
        return guard

    # -- updates (record side) ---------------------------------------------------

    def _split_resident(self, validators: np.ndarray):
        """(in-cap validators, out-of-cap validators) — the latter are
        overflow-flagged (exact scan forever) instead of growing the
        resident columns to a hostile index."""
        if not validators.size or int(validators.max()) < RESIDENT_ROWS_CAP:
            return validators, None
        big = validators >= RESIDENT_ROWS_CAP
        self.mark_overflow(validators[big])
        return validators[~big], validators[big]

    def seed_sources(self, validators: np.ndarray, sources: np.ndarray):
        """Fold reloaded record sources into the coarse guard columns
        (restart path: min/max source are rebuilt from records, not
        persisted). Duplicate validator rows are allowed."""
        if validators.size == 0:
            return
        if int(validators.max()) >= RESIDENT_ROWS_CAP:
            keep = validators < RESIDENT_ROWS_CAP
            self.mark_overflow(validators[~keep])
            validators, sources = validators[keep], sources[keep]
            if not validators.size:
                return
        self.ensure_rows(int(validators.max()) + 1)
        np.minimum.at(self._min_source, validators, sources.astype(np.uint64))
        np.maximum.at(self._max_source, validators, sources.astype(np.uint64))

    def mark_overflow(self, validators: np.ndarray):
        before = len(self._overflow)
        self._overflow.update(int(v) for v in validators.tolist())
        if len(self._overflow) != before:
            self._overflow_arr = np.array(sorted(self._overflow), dtype=np.int64)
            self._overflow_dirty = True

    def _mark_dirty(self, side: str, ec: int, changed_rows: np.ndarray):
        if self._kv is None:
            return
        # boolean scatter over validator-chunk ids: O(rows), no sort —
        # this runs once per improved column of every update walk
        nvc = max(1, self._rows // VALIDATOR_CHUNK)
        d = self._dirty[side].get(ec)
        if d is None or d.size < nvc:
            nd = np.zeros(nvc, dtype=bool)
            if d is not None:
                nd[: d.size] = d
            self._dirty[side][ec] = d = nd
        d[changed_rows // VALIDATOR_CHUNK] = True

    def record(self, validators: np.ndarray, source: int, target: int, current_epoch: int):
        """Fold one recorded attestation (source, target) for `validators`
        into the span arrays and coarse columns. Pathological shapes are
        overflow-flagged instead of written."""
        if validators.size == 0:
            return
        validators, _big = self._split_resident(validators)
        if validators.size == 0:
            return
        self.ensure_rows(int(validators.max()) + 1)
        # coarse guard columns, changed rows only: honest traffic's
        # sources advance monotonically, so min_source scatters ~zero
        # rows after the first epoch — skip the 1M-row writeback
        src = np.uint64(source)
        cur = self._min_source[validators]
        m = src < cur
        if m.any():
            self._min_source[validators[m]] = src
        cur = self._max_source[validators]
        m = src > cur
        if m.any():
            self._max_source[validators[m]] = src
        if (
            target < source
            or source > current_epoch + FUTURE_SLACK
            or target - source >= DISTANCE_CAP
        ):
            self.mark_overflow(validators)
            return
        self._update_min(validators, source, target)
        self._update_max(validators, source, target)

    def _walk(self, side: str, validators: np.ndarray, epochs, target: int):
        """Column-wise early-terminated window walk: per epoch (in walk
        order), gather the active rows, write only the improvements, and
        keep walking only the validators that improved — improvements
        are CONTIGUOUS along the walk direction (if an epoch does not
        improve for a validator, no later-walked epoch can), so the
        steady-state vote touches one or two columns, not the window."""
        better = np.less if side == "min" else np.greater
        active = validators
        arr = None
        arr_ec = None
        for e in epochs:
            ec = e // CHUNK_EPOCHS
            if ec != arr_ec:
                arr = self._materialize(side, ec)
                arr_ec = ec
            cand = np.uint16(min(target - e, DISTANCE_CAP))
            col = e % CHUNK_EPOCHS
            block = arr[active, col]
            imp = better(cand, block)
            if not imp.any():
                return
            changed = active[imp]
            arr[changed, col] = cand
            self._mark_dirty(side, ec, changed)
            active = changed

    def _update_min(self, validators: np.ndarray, source: int, target: int):
        hi = source - 1
        lo = max(0, self.floor, source - UPDATE_WINDOW)
        if hi < lo:
            return
        self._walk("min", validators, range(hi, lo - 1, -1), target)

    def _update_max(self, validators: np.ndarray, source: int, target: int):
        # entries below the prune floor are never queried (the caller's
        # floor guard scans instead), so never re-materialize them
        lo = max(source + 1, self.floor)
        hi = min(target - 1, source + UPDATE_WINDOW)
        if target - 1 > source + UPDATE_WINDOW:
            # window-capped: deeper contribution lost — exact scan forever
            self.mark_overflow(validators)
        if hi < lo:
            return
        self._walk("max", validators, range(lo, hi + 1), target)

    # -- pruning / flush ---------------------------------------------------------

    def prune(self, floor: int) -> list:
        """Drop chunks entirely below `floor`; returns the KV delete ops."""
        ops = []
        if floor <= self.floor:
            return ops
        self.floor = floor
        self._floor_dirty = True
        limit_ec = floor // CHUNK_EPOCHS
        cols = self._columns() if self._kv is not None else None
        for side in ("min", "max"):
            for ec in [ec for ec in self._chunks[side] if ec < limit_ec]:
                del self._chunks[side][ec]
                self._dirty[side].pop(ec, None)
            if cols is None:
                continue
            for ec in [ec for ec in self._kv_index[side] if ec < limit_ec]:
                for vc in self._kv_index[side].pop(ec):
                    ops.append(("delete", cols[side], _tile_key(ec, vc)))
        return ops

    def flush_ops(self) -> list:
        """Dirty tiles (+ floor/overflow meta) as KV put ops; clears the
        dirty sets. One call per process_queued cycle."""
        if self._kv is None:
            for side in ("min", "max"):
                self._dirty[side].clear()
            return []
        ops = []
        cols = self._columns()
        V = VALIDATOR_CHUNK
        for side in ("min", "max"):
            col = cols[side]
            for ec, dirty_mask in self._dirty[side].items():
                arr = self._chunks[side].get(ec)
                if arr is None:
                    continue
                index = self._kv_index[side].setdefault(ec, set())
                for vc in np.flatnonzero(dirty_mask).tolist():
                    tile = np.ascontiguousarray(arr[vc * V : vc * V + V])
                    ops.append(
                        ("put", col, _tile_key(ec, vc), tile.astype("<u2").tobytes())
                    )
                    index.add(vc)
            self._dirty[side].clear()
        if self._floor_dirty:
            ops.append(
                ("put", cols["min"], _FLOOR_KEY, self.floor.to_bytes(8, "big"))
            )
            self._floor_dirty = False
        if self._overflow_dirty:
            ops.append(
                (
                    "put",
                    cols["min"],
                    _OVERFLOW_KEY,
                    self._overflow_arr.astype(">u8").tobytes(),
                )
            )
            self._overflow_dirty = False
        return ops
