"""Field-wise container diffing for consensus debugging.

The common/compare_fields derive analog: when two states that should be
identical differ (e.g. a produced block's state root vs the verifier's),
`compare_fields` pinpoints WHICH fields diverge — recursing into nested
containers and reporting list index ranges — instead of leaving you with
two opaque 32-byte roots."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FieldDiff:
    path: str
    a: object
    b: object

    def __repr__(self):
        fmt = lambda v: (  # noqa: E731
            "0x" + v.hex()[:16] + "…" if isinstance(v, (bytes, bytearray)) and len(v) > 8
            else repr(v)
        )
        return f"{self.path}: {fmt(self.a)} != {fmt(self.b)}"


def _is_container(v) -> bool:
    return hasattr(v, "_fields") and hasattr(type(v), "hash_tree_root_of")


def compare_fields(a, b, path: str = "", max_diffs: int = 64) -> list[FieldDiff]:
    """Structural diff of two SSZ containers (or lists thereof). Returns
    up to `max_diffs` leaf-level differences with dotted/indexed paths."""
    diffs: list[FieldDiff] = []
    _walk(a, b, path or type(a).__name__, diffs, max_diffs)
    return diffs


def _walk(a, b, path, diffs, max_diffs):
    if len(diffs) >= max_diffs:
        return
    if _is_container(a) and _is_container(b) and type(a) is type(b):
        for fname in a._fields:
            _walk(
                getattr(a, fname),
                getattr(b, fname),
                f"{path}.{fname}",
                diffs,
                max_diffs,
            )
        return
    _plist_names = (
        "PersistentList",
        "PersistentContainerList",
        "PersistentByteList",
    )
    a_listy = isinstance(a, (list, tuple)) or type(a).__name__ in _plist_names
    b_listy = isinstance(b, (list, tuple)) or type(b).__name__ in _plist_names
    if a_listy and b_listy:
        if len(a) != len(b):
            diffs.append(FieldDiff(f"{path}.len", len(a), len(b)))
        for i, (x, y) in enumerate(zip(a, b)):
            if len(diffs) >= max_diffs:
                return
            if _is_container(x):
                _walk(x, y, f"{path}[{i}]", diffs, max_diffs)
            elif x != y:
                diffs.append(FieldDiff(f"{path}[{i}]", x, y))
        return
    if isinstance(a, (bytes, bytearray)) and isinstance(b, (bytes, bytearray)):
        if bytes(a) != bytes(b):
            diffs.append(FieldDiff(path, bytes(a), bytes(b)))
        return
    if a != b:
        diffs.append(FieldDiff(path, a, b))
