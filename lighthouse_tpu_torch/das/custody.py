"""Node-id-derived custody column assignment (EIP-7594 get_custody_columns).

Deterministic and peer-computable: any node can derive any other node's
custody set from its node id alone, which is what makes column serving
enforceable — a peer advertising custody of column 17 either serves it
or gets downscored. The derivation is a counter-mode hash walk (spec
shape) rather than a modular range, so adjacent node ids don't custody
adjacent columns.
"""

from __future__ import annotations

import hashlib

from ..utils.safe_arith import safe_add


def custody_columns(node_id: bytes, custody_count: int, columns: int) -> tuple:
    """The sorted custody set for `node_id`: walk sha256(node_id || i)
    until `custody_count` distinct columns accumulate."""
    want = min(custody_count, columns)
    out: list[int] = []
    i = 0
    while len(out) < want:
        h = hashlib.sha256(bytes(node_id) + i.to_bytes(8, "little")).digest()
        col = int.from_bytes(h[:8], "little") % columns
        if col not in out:
            out.append(col)
        i = safe_add(i, 1)
    return tuple(sorted(out))


def column_subnet(index: int, E) -> int:
    """Gossip subnet for a column: j % DATA_COLUMN_SIDECAR_SUBNET_COUNT."""
    return int(index) % E.DATA_COLUMN_SIDECAR_SUBNET_COUNT
