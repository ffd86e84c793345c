"""RLP encoding + the ordered Merkle-Patricia trie root.

The execution layer's block hash commits to RLP structures: the header
itself is an RLP list, and the transactions/withdrawals roots are
Merkle-Patricia trie roots over rlp(index) -> item maps (yellow-paper
trie, as the reference computes via `triehash::ordered_trie_root` in
execution_layer/src/block_hash.rs). Implemented here from the yellow
paper: hex-prefix encoding, leaf/extension/branch nodes, keccak node
refs with the <32-byte inline rule."""

from __future__ import annotations

from .keccak import keccak256


def encode_int(n: int) -> bytes:
    """Minimal big-endian integer (RLP scalar form; 0 → empty string)."""
    if n == 0:
        return b""
    return n.to_bytes((n.bit_length() + 7) // 8, "big")


def encode(item) -> bytes:
    """RLP-encode bytes, ints (as scalars), or (nested) lists thereof."""
    if isinstance(item, int):
        item = encode_int(item)
    if isinstance(item, (bytes, bytearray, memoryview)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len_prefix(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        body = b"".join(encode(x) for x in item)
        return _len_prefix(len(body), 0xC0) + body
    raise TypeError(f"cannot RLP-encode {type(item).__name__}")


def _len_prefix(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    n_bytes = encode_int(n)
    return bytes([offset + 55 + len(n_bytes)]) + n_bytes


def decode(data: bytes):
    """Inverse of encode (bytes stay bytes; scalars are NOT re-intified)."""
    item, rest = _decode_one(bytes(data))
    if rest:
        raise ValueError("trailing RLP bytes")
    return item


def _decode_one(data: bytes):
    if not data:
        raise ValueError("empty RLP input")
    b0 = data[0]
    if b0 < 0x80:
        return data[:1], data[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        if len(data) < 1 + n:
            raise ValueError("truncated RLP string")
        return data[1:1 + n], data[1 + n:]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(data[1:1 + ln], "big")
        start = 1 + ln
        if len(data) < start + n:
            raise ValueError("truncated RLP string")
        return data[start:start + n], data[start + n:]
    if b0 < 0xF8:
        n = b0 - 0xC0
        body, rest = data[1:1 + n], data[1 + n:]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(data[1:1 + ln], "big")
        start = 1 + ln
        body, rest = data[start:start + n], data[start + n:]
    if len(body) < n:
        raise ValueError("truncated RLP list")
    items = []
    while body:
        item, body = _decode_one(body)
        items.append(item)
    return items, rest


# -- Merkle-Patricia trie root ------------------------------------------------


def _hp(nibbles: list[int], leaf: bool) -> bytes:
    """Hex-prefix encoding (yellow paper appendix C)."""
    flag = 0x20 if leaf else 0x00
    if len(nibbles) % 2:
        first = bytes([flag | 0x10 | nibbles[0]])
        rest = nibbles[1:]
    else:
        first = bytes([flag])
        rest = nibbles
    return first + bytes(
        (rest[i] << 4) | rest[i + 1] for i in range(0, len(rest), 2)
    )


def _node_ref(node) -> bytes | list:
    """Nodes whose RLP is ≥32 bytes are referenced by keccak hash; shorter
    ones are inlined (yellow paper c(J, i))."""
    enc = encode(node)
    if len(enc) >= 32:
        return keccak256(enc)
    return node


def _build(pairs: list[tuple[list[int], bytes]], depth: int):
    """Structural node for `pairs` (nibble-key, value), all sharing the
    first `depth` nibbles. Returns an RLP-able node (never a hash ref)."""
    if not pairs:
        return b""
    if len(pairs) == 1:
        nibbles, value = pairs[0]
        return [_hp(nibbles[depth:], leaf=True), value]
    # longest common prefix beyond `depth`
    first = pairs[0][0]
    common = 0
    while all(
        len(k) > depth + common
        and k[depth + common] == first[depth + common]
        for k, _ in pairs
    ):
        common += 1
    if common > 0:
        child = _build(pairs, depth + common)
        return [_hp(first[depth:depth + common], leaf=False), _node_ref(child)]
    # branch node: bucket by next nibble; a key ending here fills slot 16
    branch: list = [b""] * 17
    buckets: dict[int, list] = {}
    for k, v in pairs:
        if len(k) == depth:
            branch[16] = v
        else:
            buckets.setdefault(k[depth], []).append((k, v))
    for nib, bucket in buckets.items():
        branch[nib] = _node_ref(_build(bucket, depth + 1))
    return branch


def trie_root(items: dict[bytes, bytes]) -> bytes:
    """Root of the Merkle-Patricia trie mapping keys → values."""
    if not items:
        return keccak256(encode(b""))
    pairs = [
        ([n for byte in key for n in (byte >> 4, byte & 0xF)], value)
        for key, value in sorted(items.items())
    ]
    return keccak256(encode(_build(pairs, 0)))


def ordered_trie_root(values: list[bytes]) -> bytes:
    """Trie root of the list [rlp(0)→v0, rlp(1)→v1, …] — the form used by
    transactions/withdrawals/receipts roots."""
    return trie_root({encode(i): bytes(v) for i, v in enumerate(values)})
