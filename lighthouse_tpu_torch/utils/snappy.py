"""Pure-Python snappy decompression (raw blocks + framing format).

Counterpart of lighthouse_tpu/utils/snappy.py, copied.

The consensus-spec-tests vectors are `.ssz_snappy` (snappy FRAME format);
no snappy library ships in this environment, so the ef-test runner carries
its own decoder. Format per google/snappy: format_description.txt (raw) and
framing_format.txt (frames). Decompression only — goldens we generate
ourselves are stored uncompressed."""

from __future__ import annotations

import struct


class SnappyError(ValueError):
    pass


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def decompress_raw(data: bytes) -> bytes:
    """Raw snappy block: varint uncompressed length + literal/copy tags."""
    expected, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("bad copy offset")
        # overlapping copies are allowed and byte-by-byte semantics apply
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != expected:
        raise SnappyError(f"length mismatch: {len(out)} != {expected}")
    return bytes(out)


_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"


def decompress_frames(data: bytes) -> bytes:
    """Snappy framing format (what .ssz_snappy files use)."""
    if not data.startswith(_STREAM_ID):
        # some producers emit raw blocks; fall back
        return decompress_raw(data)
    pos = len(_STREAM_ID)
    out = bytearray()
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise SnappyError("truncated chunk header")
        chunk_type = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + length > n:
            raise SnappyError("truncated chunk")
        body = data[pos : pos + length]
        pos += length
        if chunk_type == 0x00:  # compressed data (4-byte CRC + block)
            out += decompress_raw(body[4:])
        elif chunk_type == 0x01:  # uncompressed data (4-byte CRC + data)
            out += body[4:]
        elif chunk_type == 0xFF:  # stream identifier (repeated)
            continue
        elif 0x80 <= chunk_type <= 0xFD:  # skippable padding
            continue
        else:
            raise SnappyError(f"unskippable chunk type {chunk_type:#x}")
    return bytes(out)


def decompress(data: bytes) -> bytes:
    return decompress_frames(data)


# ---------------------------------------------------------------------------
# Compression (framing format, uncompressed chunks)
# ---------------------------------------------------------------------------
#
# Literal/uncompressed output is VALID snappy — any conformant decoder
# accepts it. The p2p layer needs wire-correct framing (SSZ-snappy RPC and
# gossip payloads), not ratio; chunks carry the required masked CRC32C.

_CRC32C_TABLE = None


def _crc32c_table():
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def compress(data: bytes) -> bytes:
    """Snappy framing format with uncompressed data chunks (max 65536
    payload bytes per chunk per the framing spec)."""
    out = bytearray(_STREAM_ID)
    view = memoryview(data)
    pos = 0
    if not data:
        # zero-length payload: emit one empty uncompressed chunk so the
        # stream still decodes to b""
        crc = _masked_crc(b"")
        out += b"\x01" + (4).to_bytes(3, "little") + crc.to_bytes(4, "little")
        return bytes(out)
    while pos < len(data):
        chunk = bytes(view[pos : pos + 65536])
        pos += len(chunk)
        crc = _masked_crc(chunk)
        out += (
            b"\x01"
            + (len(chunk) + 4).to_bytes(3, "little")
            + crc.to_bytes(4, "little")
            + chunk
        )
    return bytes(out)
