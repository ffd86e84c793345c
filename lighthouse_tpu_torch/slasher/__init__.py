"""Slashing detection engine (columnar min/max-span subsystem).

Mirrors the reference's dedicated `slasher` crate: attestations and block
headers are queued as they arrive (the service feeds gossip in), then
`process_queued(current_epoch)` runs batched detection — double votes,
surround votes in both directions, double proposals — emitting
ready-to-pool `AttesterSlashing` / `ProposerSlashing` containers.

Two engines behind one factory:

  * `columnar.ColumnarSlasher` (default) — the reference's chunked
    min/max-span arrays rebuilt as resident uint16 numpy columns on the
    validator axis (`spans.py`), detecting a whole cycle's attestations
    as array programs; detection history and dirty span tiles persist
    through the KV columns (`SLASHER_*` incl. the `SLASHER_MIN_SPAN` /
    `SLASHER_MAX_SPAN` tile pair) in one atomic batch per cycle.
  * `reference.ReferenceSlasher` — the retained scalar per-validator
    dict engine: differential oracle and bench control
    (`LIGHTHOUSE_TPU_COLUMNAR_SLASHER=0` selects it node-wide).

History is bounded to `history_length` epochs and pruned as the epoch
advances, exactly as the reference's chunked arrays bound their window.
"""

from __future__ import annotations

import os

from ..metrics import REGISTRY
from .reference import (  # noqa: F401 — canonical config + record shapes
    DEFAULT_HISTORY_LENGTH,
    SlasherConfig,
)

#: kill switch: "0" routes every `Slasher(...)` construction to the
#: retained scalar engine (differential control / emergency fallback)
COLUMNAR_SLASHER_ENV = "LIGHTHOUSE_TPU_COLUMNAR_SLASHER"


def columnar_enabled() -> bool:
    return os.environ.get(COLUMNAR_SLASHER_ENV, "1") != "0"


def Slasher(E, config: SlasherConfig | None = None, store=None):
    """Engine factory — the columnar subsystem unless the kill switch
    selects the retained scalar reference."""
    if columnar_enabled():
        from .columnar import ColumnarSlasher

        return ColumnarSlasher(E, config, store)
    from .reference import ReferenceSlasher

    return ReferenceSlasher(E, config, store)


# -- eager metric registration (conftest-asserted) ---------------------------
# Every slasher_* series must exist at zero: the slasher_ingest bench reads
# counter deltas, and dashboards scrape the trace-stage histograms eagerly.
_FOUND_ATT = REGISTRY.counter(
    "slasher_attester_slashings_found",
    "attester slashings detected by process_queued",
)
_FOUND_ATT.inc(0)
_FOUND_BLK = REGISTRY.counter(
    "slasher_proposer_slashings_found",
    "proposer slashings detected by process_queued",
)
_FOUND_BLK.inc(0)
_POOLED = REGISTRY.counter(
    "slasher_slashings_found_total",
    "detected slashings successfully handed to the op pool, by kind",
)
for _kind in ("attester", "proposer"):
    _POOLED.inc(0, kind=_kind)
_CYCLES = REGISTRY.counter(
    "slasher_process_cycles_total",
    "process_queued cycles run, by engine",
)
for _engine in ("columnar", "reference"):
    _CYCLES.inc(0, engine=_engine)
_PROCESSED = REGISTRY.counter(
    "slasher_attestations_processed_total",
    "queued indexed attestations consumed by process_queued",
)
_PROCESSED.inc(0)
_EXACT_SCANS = REGISTRY.counter(
    "slasher_exact_scans_total",
    "per-validator exact record scans (span-filter positives + "
    "intra-cycle-conflicted validators); ~0 under honest traffic",
)
_EXACT_SCANS.inc(0)
_TILES = REGISTRY.counter(
    "slasher_span_tiles_flushed_total",
    "dirty min/max-span tiles written to the KV store",
)
_TILES.inc(0)
_REBUILDS = REGISTRY.counter(
    "slasher_span_rebuilds_total",
    "span-array rebuilds from reloaded records (scalar-DB migration)",
)
_REBUILDS.inc(0)
# the slasher_process trace root's stage histograms (span names are the
# flat per-name histograms; the root itself is in the trace taxonomy)
for _span_name in (
    "trace_span_seconds_slasher_process",
    "trace_span_seconds_span_gather",
    "trace_span_seconds_span_compare",
    "trace_span_seconds_span_update",
    "trace_span_seconds_persist",
):
    # lint: allow(metric-hygiene) -- eager registration of a fixed set
    REGISTRY.histogram(_span_name, "slasher stage span")
