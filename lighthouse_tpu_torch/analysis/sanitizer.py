"""Runtime CoW / overflow / stale-read sanitizer for the tree-states
protocol (`LIGHTHOUSE_TPU_SANITIZE=1`).

Counterpart of lighthouse_tpu/analysis/sanitizer.py, copied.

The tree-states machinery (ssz/persistent.py CoW blocks, the resident
RegistryColumns mirror, the zero-copy committee/epoch array views) keeps
its invariants by convention; this module makes the conventions
machine-checked at runtime, the way a training stack runs under ASan/TSan
before a big job:

* **Write-guarded buffers** (rule ``cow-write``): with the sanitizer on,
  `PersistentList.load_array` / `PersistentByteList.load_array` return
  read-only `GuardedArray` views — an escaped view that something later
  writes raises `SanitizerError` at the write site (and counts), instead
  of silently diverging the list from its committed hash/column
  baselines. Sanctioned writers (`store_array`, `write_participation`,
  `RegistryColumns._write_col`) never write through these views, so they
  need no re-enable; `writable_window` exists for code that must briefly
  unfreeze a buffer it owns.

* **No-wraparound sweeps** (rule ``u64-wrap``): the vectorized helpers in
  `utils/safe_arith` prove every uint64 lane exact (overflow, underflow,
  divide-back multiplication checks) and route failures here.

* **Stale-read audit** (rule ``stale-read``): RegistryColumns records its
  source lists at refresh time; reading a column property while the
  source's ``columns`` dirty channel still holds undrained dirt means the
  reader skipped `refresh()` and is consuming a stale mirror.

Independent of the sanitize flag, the zero-copy read views
(`CommitteeCache.committee_array` slices, `EpochArrays` column views,
`RegistryColumns` properties) are frozen with ``setflags(write=False)``
in ALL modes — those writes were silent state corruption, and the freeze
is free.

Every violation increments ``sanitizer_violations_total{rule=...}``
(eagerly registered in the port's metrics registry; nothing in the port
reads it yet) and raises
`SanitizerError`.
"""

from __future__ import annotations

import os

import numpy as np

from ..metrics import REGISTRY

ENV_VAR = "LIGHTHOUSE_TPU_SANITIZE"

RULES = ("cow-write", "u64-wrap", "stale-read")

_VIOLATIONS = REGISTRY.counter(
    "sanitizer_violations_total",
    "runtime sanitizer violations, by rule (LIGHTHOUSE_TPU_SANITIZE=1)",
)
for _rule in RULES:
    _VIOLATIONS.inc(0, rule=_rule)


class SanitizerError(AssertionError):
    """A tree-states invariant was violated at runtime (sanitize mode)."""


def enabled() -> bool:
    """Live read (tests toggle the env var mid-process); every guard is
    off the hot path, so the lookup cost never shows in a sweep."""
    return os.environ.get(ENV_VAR) == "1"


def record_violation(rule: str, detail: str = "") -> str:
    _VIOLATIONS.inc(rule=rule)
    return f"sanitizer[{rule}]: {detail}"


def violation(rule: str, detail: str = ""):
    """Record and raise — the one exit every runtime check uses."""
    raise SanitizerError(record_violation(rule, detail))


# ---------------------------------------------------------------------------
# Guarded arrays (the cow-write rule)
# ---------------------------------------------------------------------------


class GuardedArray(np.ndarray):
    """An ndarray whose read-only views report writes as counted
    sanitizer violations instead of a bare numpy ValueError, and which
    refuses the `setflags(write=True)` escape hatch. Writable descendants
    (copies, ufunc results) behave exactly like ndarray."""

    def __setitem__(self, key, value):
        if not self.flags.writeable:
            violation(
                "cow-write",
                "write to a read-only tree-states view (load_array / "
                "column view); route through store_array-class writers",
            )
        super().__setitem__(key, value)

    def setflags(self, write=None, align=None, uic=None):
        if write and not self.flags.writeable:
            violation(
                "cow-write",
                "setflags(write=True) on a guarded tree-states view",
            )
        super().setflags(write=write, align=align, uic=uic)


def guard(arr: np.ndarray) -> np.ndarray:
    """A read-only guarded view of `arr` when the sanitizer is on;
    `arr` unchanged otherwise. The base array stays writable for its
    owner — only the handed-out view is frozen."""
    if not enabled():
        return arr
    view = arr.view(GuardedArray)
    np.ndarray.setflags(view, write=False)
    return view


def freeze_view(arr: np.ndarray) -> np.ndarray:
    """A read-only plain view of `arr` — the ALL-modes freeze for
    zero-copy read surfaces (committee slices, column properties). Slices
    of the result inherit read-only. Costs one view object."""
    view = arr[...] if isinstance(arr, np.ndarray) else np.asarray(arr)[...]
    view.setflags(write=False)
    return view


class writable_window:
    """Temporarily re-enable writes on a frozen buffer the caller owns —
    the guarded re-enable for store_array-class entry points that must
    mutate a frozen base in place (`EpochArrays.write_snapshot_rows` /
    `refresh_rows` over the frozen legacy snapshot columns). Always
    re-freezes on exit, including on exception."""

    __slots__ = ("_arr", "_was")

    def __init__(self, arr: np.ndarray):
        self._arr = arr

    def __enter__(self):
        self._was = self._arr.flags.writeable
        np.ndarray.setflags(self._arr, write=True)
        return self._arr

    def __exit__(self, *exc):
        np.ndarray.setflags(self._arr, write=self._was)
        return False


# ---------------------------------------------------------------------------
# Stale-read audit (RegistryColumns hook)
# ---------------------------------------------------------------------------


def audit_column_read(field: str, source) -> None:
    """Called by RegistryColumns property getters under sanitize with the
    recorded source list: undrained dirt in the source's columns channel
    means the resident mirror is stale for this field."""
    if source is None:
        return
    from ..state_processing.registry_columns import COLUMNS_CHANNEL

    ch = source._channels.get(COLUMNS_CHANNEL)
    if ch is not None and (ch.dirty or ch.dirty_all):
        violation(
            "stale-read",
            f"column {field!r} read while its source list holds "
            f"undrained dirt — refresh() the columns first",
        )
