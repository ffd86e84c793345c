"""Runtime copy-on-write guard for the tree-states protocol
(`LIGHTHOUSE_TPU_SANITIZE=1`).

Counterpart of lighthouse_tpu/analysis/sanitizer.py, cut to the rule the
SSZ layer uses (``cow-write``): with the sanitizer on,
`PersistentList.load_array` / `PersistentByteList.load_array` return
read-only `GuardedArray` views, so an escaped view that something later
writes raises `SanitizerError` at the write site (and counts), instead of
silently diverging the list from its committed hash baselines.

Every violation increments ``VIOLATIONS[rule]`` and raises
`SanitizerError`.
"""

from __future__ import annotations

import os

import numpy as np

ENV_VAR = "LIGHTHOUSE_TPU_SANITIZE"

RULES = ("cow-write",)

VIOLATIONS = {rule: 0 for rule in RULES}


class SanitizerError(AssertionError):
    """A tree-states invariant was violated at runtime (sanitize mode)."""


def enabled() -> bool:
    """Live read (tests toggle the env var mid-process); every guard is
    off the hot path, so the lookup cost never shows in a sweep."""
    return os.environ.get(ENV_VAR) == "1"


def violation(rule: str, detail: str = ""):
    """Record and raise — the one exit every runtime check uses."""
    VIOLATIONS[rule] += 1
    raise SanitizerError(f"sanitizer[{rule}]: {detail}")


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
