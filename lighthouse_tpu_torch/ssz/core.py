"""SSZ type system: serialization + hash-tree-root.

Re-implements the capability surface of the reference's `ethereum_ssz` /
`ethereum_ssz_derive` / `ssz_types` / `tree_hash` crates (SURVEY.md §2.8):
offset-based variable-size encoding, strict deserialization, and spec
Merkleization for every SSZ type class.

Types are Python classes used as descriptors; values are plain Python objects
(int, bool, bytes, list, Container instances). Parametrized types are created
with indexing and cached: `List[uint64, 2**40]`, `Vector[Bytes32, 8192]`,
`Bitlist[2048]`.

Containers are declared with annotations:

    class Checkpoint(Container):
        epoch: uint64
        root: Bytes32
"""

from __future__ import annotations

from .merkle import (
    BYTES_PER_CHUNK,
    merkleize,
    mix_in_length,
    mix_in_selector,
    pack_bytes,
)
from .persistent import PersistentByteList, PersistentContainerList, PersistentList

BYTES_PER_LENGTH_OFFSET = 4


class DeserializationError(ValueError):
    pass


class SSZType:
    """Base for all SSZ type descriptors. Subclasses implement the class-level
    protocol: is_fixed_size / fixed_size / serialize_value / deserialize /
    hash_tree_root_of / default / chunk_count."""

    @classmethod
    def is_fixed_size(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def fixed_size(cls) -> int:
        raise NotImplementedError

    @classmethod
    def serialize_value(cls, value) -> bytes:
        raise NotImplementedError

    @classmethod
    def deserialize(cls, data: bytes):
        raise NotImplementedError

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError

    @classmethod
    def coerce(cls, value):
        """Validate/normalize a value for this type (used by Container setters)."""
        return value


# ---------------------------------------------------------------------------
# Basic types
# ---------------------------------------------------------------------------


class _UIntMeta(type):
    def __repr__(cls):
        return cls.__name__


class _UInt(SSZType, metaclass=_UIntMeta):
    BITS: int = 0

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return cls.BITS // 8

    @classmethod
    def serialize_value(cls, value) -> bytes:
        return int(value).to_bytes(cls.BITS // 8, "little")

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) != cls.BITS // 8:
            raise DeserializationError(f"{cls.__name__}: bad length {len(data)}")
        return int.from_bytes(data, "little")

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        return int(value).to_bytes(cls.BITS // 8, "little").ljust(32, b"\x00")

    @classmethod
    def default(cls):
        return 0

    @classmethod
    def coerce(cls, value):
        v = int(value)
        if not 0 <= v < (1 << cls.BITS):
            raise ValueError(f"{cls.__name__} out of range: {v}")
        return v

    @classmethod
    def chunk_count(cls):
        return 1


class uint8(_UInt):
    BITS = 8


class uint16(_UInt):
    BITS = 16


class uint32(_UInt):
    BITS = 32


class uint64(_UInt):
    BITS = 64


class uint128(_UInt):
    BITS = 128


class uint256(_UInt):
    BITS = 256


class boolean(SSZType):
    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return 1

    @classmethod
    def serialize_value(cls, value) -> bytes:
        return b"\x01" if value else b"\x00"

    @classmethod
    def deserialize(cls, data: bytes):
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise DeserializationError(f"boolean: invalid byte {data!r}")

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        return (b"\x01" if value else b"\x00") + b"\x00" * 31

    @classmethod
    def default(cls):
        return False

    @classmethod
    def coerce(cls, value):
        return bool(value)

    @classmethod
    def chunk_count(cls):
        return 1


def _is_basic(t) -> bool:
    return isinstance(t, type) and issubclass(t, (_UInt, boolean))


# ---------------------------------------------------------------------------
# Parametrized type construction (cached)
# ---------------------------------------------------------------------------

_param_cache: dict = {}


def _cached(factory):
    def class_getitem(cls, params):
        key = (cls, params)
        if key not in _param_cache:
            _param_cache[key] = factory(cls, params)
        return _param_cache[key]

    return classmethod(class_getitem)


# ---------------------------------------------------------------------------
# ByteVector / ByteList  (bytes-valued fast paths for Vector[uint8]/List[uint8])
# ---------------------------------------------------------------------------


class ByteVector(SSZType):
    LENGTH: int = 0

    def _make(cls, length):
        return type(f"ByteVector{length}", (ByteVector,), {"LENGTH": length})

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return cls.LENGTH

    @classmethod
    def serialize_value(cls, value) -> bytes:
        if len(value) != cls.LENGTH:
            raise ValueError(f"ByteVector[{cls.LENGTH}]: got {len(value)} bytes")
        return bytes(value)

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) != cls.LENGTH:
            raise DeserializationError(f"ByteVector[{cls.LENGTH}]: got {len(data)}")
        return bytes(data)

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        return merkleize(pack_bytes(bytes(value)))

    @classmethod
    def default(cls):
        return b"\x00" * cls.LENGTH

    @classmethod
    def coerce(cls, value):
        b = bytes(value)
        if len(b) != cls.LENGTH:
            raise ValueError(f"ByteVector[{cls.LENGTH}]: got {len(b)} bytes")
        return b

    @classmethod
    def chunk_count(cls):
        return (cls.LENGTH + 31) // 32


Bytes4 = ByteVector[4]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


class ByteList(SSZType):
    LIMIT: int = 0

    def _make(cls, limit):
        return type(f"ByteList{limit}", (ByteList,), {"LIMIT": limit})

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def serialize_value(cls, value) -> bytes:
        if len(value) > cls.LIMIT:
            raise ValueError(f"ByteList[{cls.LIMIT}]: got {len(value)} bytes")
        return bytes(value)

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) > cls.LIMIT:
            raise DeserializationError(f"ByteList[{cls.LIMIT}]: got {len(data)}")
        return bytes(data)

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        limit_chunks = (cls.LIMIT + 31) // 32
        root = merkleize(pack_bytes(bytes(value)), limit=limit_chunks)
        return mix_in_length(root, len(value))

    @classmethod
    def default(cls):
        return b""

    @classmethod
    def coerce(cls, value):
        b = bytes(value)
        if len(b) > cls.LIMIT:
            raise ValueError(f"ByteList[{cls.LIMIT}]: got {len(b)} bytes")
        return b

    @classmethod
    def chunk_count(cls):
        return (cls.LIMIT + 31) // 32


class ParticipationList(ByteList):
    """`List[ParticipationFlags]` (uint8) with a MUTABLE bytearray runtime
    representation: altair participation flags are updated per attesting
    index in place (process_attestation), and the epoch sweep reads them
    zero-copy via numpy frombuffer. Wire format identical to List[uint8].

    Tree-states nodes swap the bytearray for a PersistentByteList
    (chain._make_persistent): structurally-shared blocks with dirty-index
    channels, so per-block participation writes reach the hash caches and
    the resident registry columns as exact deltas."""

    def _make(cls, limit):
        return type(
            f"ParticipationList{limit}", (ParticipationList,), {"LIMIT": limit}
        )

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) > cls.LIMIT:
            raise DeserializationError(f"ParticipationList: got {len(data)}")
        return bytearray(data)

    @classmethod
    def default(cls):
        return bytearray()

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        if isinstance(value, PersistentByteList):
            # structural-sharing fast path: block-memoized subtree roots
            root = value.hash_tree_root(cls.chunk_count())
            return mix_in_length(root, len(value))
        return super().hash_tree_root_of(value)

    @classmethod
    def coerce(cls, value):
        if isinstance(value, PersistentByteList):
            # already element-validated; share blocks but never alias the
            # caller's object (no CoW barrier without the copy())
            if len(value) > cls.LIMIT:
                raise ValueError(
                    f"ParticipationList: got {len(value)} bytes"
                )
            return value.copy()
        b = bytearray(value)
        if len(b) > cls.LIMIT:
            raise ValueError(f"ParticipationList: got {len(b)} bytes")
        return b


# ---------------------------------------------------------------------------
# Vector / List
# ---------------------------------------------------------------------------


def _serialize_homogeneous(elem_t, values) -> bytes:
    if elem_t.is_fixed_size():
        return b"".join(elem_t.serialize_value(v) for v in values)
    parts = [elem_t.serialize_value(v) for v in values]
    offset = BYTES_PER_LENGTH_OFFSET * len(parts)
    out = []
    for p in parts:
        out.append(offset.to_bytes(4, "little"))
        offset += len(p)
    return b"".join(out) + b"".join(parts)


def _deserialize_homogeneous(elem_t, data: bytes, count: int | None):
    """Deserialize a sequence; count=None means 'as many as the data holds'."""
    if elem_t.is_fixed_size():
        size = elem_t.fixed_size()
        if count is not None:
            if len(data) != size * count:
                raise DeserializationError(
                    f"expected {count} x {size} bytes, got {len(data)}"
                )
        elif len(data) % size:
            raise DeserializationError(f"length {len(data)} not a multiple of {size}")
        return [elem_t.deserialize(data[i : i + size]) for i in range(0, len(data), size)]

    # Variable-size elements: offset table.
    if not data:
        if count:
            raise DeserializationError("expected elements, got empty data")
        return []
    if len(data) < 4:
        raise DeserializationError("truncated offset table")
    first = int.from_bytes(data[:4], "little")
    if first % 4 or first == 0 or first > len(data):
        raise DeserializationError(f"bad first offset {first}")
    n = first // 4
    if count is not None and n != count:
        raise DeserializationError(f"expected {count} elements, offsets imply {n}")
    offsets = [int.from_bytes(data[i * 4 : i * 4 + 4], "little") for i in range(n)]
    offsets.append(len(data))
    values = []
    for i in range(n):
        if offsets[i] > offsets[i + 1] or offsets[i] > len(data):
            raise DeserializationError("offsets not monotonic")
        values.append(elem_t.deserialize(data[offsets[i] : offsets[i + 1]]))
    return values


def _chunks_of(elem_t, values) -> list[bytes]:
    if _is_basic(elem_t):
        return pack_bytes(b"".join(elem_t.serialize_value(v) for v in values))
    return [elem_t.hash_tree_root_of(v) for v in values]


class Vector(SSZType):
    ELEM: type = None
    LENGTH: int = 0

    def _make(cls, params):
        elem_t, length = params
        if elem_t is uint8:
            return ByteVector[length]
        return type(
            f"Vector[{elem_t.__name__},{length}]",
            (Vector,),
            {"ELEM": elem_t, "LENGTH": length},
        )

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return cls.ELEM.is_fixed_size()

    @classmethod
    def fixed_size(cls):
        return cls.ELEM.fixed_size() * cls.LENGTH

    @classmethod
    def serialize_value(cls, value) -> bytes:
        if len(value) != cls.LENGTH:
            raise ValueError(f"Vector length {len(value)} != {cls.LENGTH}")
        return _serialize_homogeneous(cls.ELEM, value)

    @classmethod
    def deserialize(cls, data: bytes):
        return _deserialize_homogeneous(cls.ELEM, data, cls.LENGTH)

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        return merkleize(_chunks_of(cls.ELEM, value), limit=cls.chunk_count())

    @classmethod
    def default(cls):
        return [cls.ELEM.default() for _ in range(cls.LENGTH)]

    @classmethod
    def coerce(cls, value):
        vals = [cls.ELEM.coerce(v) for v in value]
        if len(vals) != cls.LENGTH:
            raise ValueError(f"Vector length {len(vals)} != {cls.LENGTH}")
        return vals

    @classmethod
    def chunk_count(cls):
        if _is_basic(cls.ELEM):
            return (cls.LENGTH * cls.ELEM.fixed_size() + 31) // 32
        return cls.LENGTH


class List(SSZType):
    ELEM: type = None
    LIMIT: int = 0

    def _make(cls, params):
        elem_t, limit = params
        if elem_t is uint8:
            return ByteList[limit]
        return type(
            f"List[{elem_t.__name__},{limit}]",
            (List,),
            {"ELEM": elem_t, "LIMIT": limit},
        )

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def serialize_value(cls, value) -> bytes:
        if len(value) > cls.LIMIT:
            raise ValueError(f"List limit {cls.LIMIT} exceeded: {len(value)}")
        return _serialize_homogeneous(cls.ELEM, value)

    @classmethod
    def deserialize(cls, data: bytes):
        values = _deserialize_homogeneous(cls.ELEM, data, None)
        if len(values) > cls.LIMIT:
            raise DeserializationError(f"List[{cls.LIMIT}]: {len(values)} elements")
        return values

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        if isinstance(value, (PersistentList, PersistentContainerList)):
            # structural-sharing fast path: block-memoized subtree roots
            root = value.hash_tree_root(cls.chunk_count())
        else:
            root = merkleize(_chunks_of(cls.ELEM, value), limit=cls.chunk_count())
        return mix_in_length(root, len(value))

    @classmethod
    def default(cls):
        return []

    @classmethod
    def coerce(cls, value):
        if isinstance(value, PersistentList):
            # already element-validated; share blocks but never alias the
            # caller's object (plain-list coerce copies for the same reason
            # — without copy() there is no CoW barrier between the two)
            if cls.ELEM is not uint64:
                raise ValueError("PersistentList fields must be uint64 lists")
            if len(value) > cls.LIMIT:
                raise ValueError(
                    f"List limit {cls.LIMIT} exceeded: {len(value)}"
                )
            return value.copy()
        if isinstance(value, PersistentContainerList):
            if value.elem_t is not None and value.elem_t is not cls.ELEM:
                raise ValueError(
                    f"PersistentContainerList of {value.elem_t.__name__} "
                    f"assigned to List[{cls.ELEM.__name__}]"
                )
            if len(value) > cls.LIMIT:
                raise ValueError(
                    f"List limit {cls.LIMIT} exceeded: {len(value)}"
                )
            return value.copy()
        vals = [cls.ELEM.coerce(v) for v in value]
        if len(vals) > cls.LIMIT:
            raise ValueError(f"List limit {cls.LIMIT} exceeded: {len(vals)}")
        return vals

    @classmethod
    def chunk_count(cls):
        if _is_basic(cls.ELEM):
            return (cls.LIMIT * cls.ELEM.fixed_size() + 31) // 32
        return cls.LIMIT


# ---------------------------------------------------------------------------
# Bitvector / Bitlist
# ---------------------------------------------------------------------------


def _bits_to_bytes(bits) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i >> 3] |= 1 << (i & 7)
    return bytes(out)


def _bytes_to_bits(data: bytes, count: int) -> list[bool]:
    return [bool((data[i >> 3] >> (i & 7)) & 1) for i in range(count)]


class Bitvector(SSZType):
    LENGTH: int = 0

    def _make(cls, length):
        assert length > 0
        return type(f"Bitvector{length}", (Bitvector,), {"LENGTH": length})

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return (cls.LENGTH + 7) // 8

    @classmethod
    def serialize_value(cls, value) -> bytes:
        if len(value) != cls.LENGTH:
            raise ValueError(f"Bitvector length {len(value)} != {cls.LENGTH}")
        return _bits_to_bytes(value)

    @classmethod
    def deserialize(cls, data: bytes):
        if len(data) != cls.fixed_size():
            raise DeserializationError("bitvector length mismatch")
        # Excess bits in the final byte must be zero.
        if cls.LENGTH % 8 and data[-1] >> (cls.LENGTH % 8):
            raise DeserializationError("bitvector has excess bits set")
        return _bytes_to_bits(data, cls.LENGTH)

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        return merkleize(pack_bytes(_bits_to_bytes(value)), limit=cls.chunk_count())

    @classmethod
    def default(cls):
        return [False] * cls.LENGTH

    @classmethod
    def coerce(cls, value):
        vals = [bool(v) for v in value]
        if len(vals) != cls.LENGTH:
            raise ValueError(f"Bitvector length {len(vals)} != {cls.LENGTH}")
        return vals

    @classmethod
    def chunk_count(cls):
        return (cls.LENGTH + 255) // 256


class Bitlist(SSZType):
    LIMIT: int = 0

    def _make(cls, limit):
        return type(f"Bitlist{limit}", (Bitlist,), {"LIMIT": limit})

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def serialize_value(cls, value) -> bytes:
        if len(value) > cls.LIMIT:
            raise ValueError(f"Bitlist limit {cls.LIMIT} exceeded: {len(value)}")
        # Delimiter bit marks the length.
        data = bytearray(_bits_to_bytes(list(value) + [True]))
        return bytes(data)

    @classmethod
    def deserialize(cls, data: bytes):
        if not data:
            raise DeserializationError("bitlist: empty data")
        if data[-1] == 0:
            raise DeserializationError("bitlist: missing delimiter bit")
        last = data[-1]
        delim = last.bit_length() - 1
        length = (len(data) - 1) * 8 + delim
        if length > cls.LIMIT:
            raise DeserializationError(f"bitlist length {length} > limit {cls.LIMIT}")
        return _bytes_to_bits(data, length)

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        root = merkleize(pack_bytes(_bits_to_bytes(value)), limit=cls.chunk_count())
        return mix_in_length(root, len(value))

    @classmethod
    def default(cls):
        return []

    @classmethod
    def coerce(cls, value):
        vals = [bool(v) for v in value]
        if len(vals) > cls.LIMIT:
            raise ValueError(f"Bitlist limit {cls.LIMIT} exceeded")
        return vals

    @classmethod
    def chunk_count(cls):
        return (cls.LIMIT + 255) // 256


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------


class Union(SSZType):
    OPTIONS: tuple = ()

    def _make(cls, options):
        if not isinstance(options, tuple):
            options = (options,)
        # SSZ spec: None is only allowed as option 0, and then at least one
        # other option must follow.
        if any(o is None for o in options[1:]) or (options[0] is None and len(options) < 2):
            raise TypeError(f"invalid Union options {options!r}")
        return type(f"Union{options!r}", (Union,), {"OPTIONS": options})

    __class_getitem__ = _cached(_make)
    del _make

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def serialize_value(cls, value) -> bytes:
        selector, inner = value
        opt = cls.OPTIONS[selector]
        if opt is None:
            return bytes([selector])
        return bytes([selector]) + opt.serialize_value(inner)

    @classmethod
    def deserialize(cls, data: bytes):
        if not data:
            raise DeserializationError("union: empty")
        selector = data[0]
        if selector >= len(cls.OPTIONS):
            raise DeserializationError(f"union: bad selector {selector}")
        opt = cls.OPTIONS[selector]
        if opt is None:
            if len(data) != 1:
                raise DeserializationError("union: None with payload")
            return (selector, None)
        return (selector, opt.deserialize(data[1:]))

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        selector, inner = value
        opt = cls.OPTIONS[selector]
        root = b"\x00" * 32 if opt is None else opt.hash_tree_root_of(inner)
        return mix_in_selector(root, selector)

    @classmethod
    def default(cls):
        opt = cls.OPTIONS[0]
        return (0, None if opt is None else opt.default())


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: dict[str, type] = {}
        for base in reversed(cls.__mro__):
            anns = base.__dict__.get("__annotations__", {})
            module = __import__("sys").modules.get(base.__module__)
            for fname, ftype in anns.items():
                if isinstance(ftype, str):
                    # `from __future__ import annotations` stringifies types;
                    # resolve against the defining module (SSZ fields cannot
                    # be forward references — the type must exist already).
                    try:
                        ftype = eval(ftype, vars(module) if module else {})  # noqa: S307
                    except NameError as e:
                        raise TypeError(
                            f"{name}.{fname}: cannot resolve annotation "
                            f"{anns[fname]!r} (SSZ fields cannot be forward refs)"
                        ) from e
                if isinstance(ftype, type) and issubclass(ftype, SSZType):
                    fields[fname] = ftype
        cls._fields = fields
        return cls


class FrozenElementError(AttributeError):
    """Raised on direct field writes to a container element that is
    structurally shared inside a PersistentContainerList — the milhouse
    `&mut`-discipline analog (consensus/types/src/beacon_state.rs:34):
    a missed copy-on-write would silently corrupt every state copy
    sharing the element's block, so the write raises instead."""


class Container(SSZType, metaclass=_ContainerMeta):
    _fields: dict[str, type] = {}

    def __init__(self, **kwargs):
        for fname, ftype in self._fields.items():
            if fname in kwargs:
                object.__setattr__(self, fname, ftype.coerce(kwargs.pop(fname)))
            else:
                object.__setattr__(self, fname, ftype.default())
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unknown fields {list(kwargs)}")

    def __setattr__(self, name, value):
        ftype = self._fields.get(name)
        if ftype is not None:
            if "_frozen" in self.__dict__:
                raise FrozenElementError(
                    f"{type(self).__name__}.{name}: this element is shared "
                    f"inside a PersistentContainerList (structural sharing "
                    f"across state copies); use lst.mutate(i) to get a "
                    f"write-safe clone"
                )
            value = ftype.coerce(value)
            # field mutation invalidates this container's memoized root
            # (cached_tree_hash: the per-validator root memo)
            self.__dict__.pop("_thc_root", None)
        object.__setattr__(self, name, value)

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f) for f in self._fields)

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._fields)
        return f"{type(self).__name__}({inner})"

    def copy(self):
        """Deep copy (containers/lists copied; bytes/ints shared — immutable).
        Tree-hash memos carry over: field values are equal by construction,
        and the state-level cache deep-copies its numpy layers."""
        out = type(self).__new__(type(self))
        for fname, ftype in self._fields.items():
            out.__dict__[fname] = _deep_copy(ftype, getattr(self, fname))
        memo = self.__dict__.get("_thc_root")
        if memo is not None:
            out.__dict__["_thc_root"] = memo
        cache = self.__dict__.get("_thc_cache")
        if cache is not None:
            out.__dict__["_thc_cache"] = cache.copy()
        # resident registry columns (state_processing/registry_columns):
        # carried across copies with per-column copy-on-write, exactly
        # like the tree-hash layers — a copy shares every array until
        # one side writes
        cols = self.__dict__.get("_registry_columns")
        if cols is not None:
            out.__dict__["_registry_columns"] = cols.copy()
        return out

    # -- SSZType protocol ---------------------------------------------------

    @classmethod
    def is_fixed_size(cls):
        return all(t.is_fixed_size() for t in cls._fields.values())

    @classmethod
    def fixed_size(cls):
        return sum(t.fixed_size() for t in cls._fields.values())

    @classmethod
    def serialize_value(cls, value) -> bytes:
        fixed_parts = []
        var_parts = []
        for fname, ftype in cls._fields.items():
            v = getattr(value, fname)
            if ftype.is_fixed_size():
                fixed_parts.append(ftype.serialize_value(v))
                var_parts.append(None)
            else:
                fixed_parts.append(None)
                var_parts.append(ftype.serialize_value(v))
        fixed_len = sum(
            len(p) if p is not None else BYTES_PER_LENGTH_OFFSET for p in fixed_parts
        )
        offset = fixed_len
        out = []
        for fp, vp in zip(fixed_parts, var_parts):
            if fp is not None:
                out.append(fp)
            else:
                out.append(offset.to_bytes(4, "little"))
                offset += len(vp)
        for vp in var_parts:
            if vp is not None:
                out.append(vp)
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes):
        kwargs = {}
        var_fields = []  # (name, type, offset)
        pos = 0
        for fname, ftype in cls._fields.items():
            if ftype.is_fixed_size():
                size = ftype.fixed_size()
                if pos + size > len(data):
                    raise DeserializationError(f"{cls.__name__}: truncated at {fname}")
                kwargs[fname] = ftype.deserialize(data[pos : pos + size])
                pos += size
            else:
                if pos + 4 > len(data):
                    raise DeserializationError(f"{cls.__name__}: truncated offset")
                var_fields.append((fname, ftype, int.from_bytes(data[pos : pos + 4], "little")))
                pos += 4
        if var_fields:
            if var_fields[0][2] != pos:
                raise DeserializationError(
                    f"{cls.__name__}: first offset {var_fields[0][2]} != fixed size {pos}"
                )
            bounds = [off for _, _, off in var_fields] + [len(data)]
            for i, (fname, ftype, off) in enumerate(var_fields):
                if off > bounds[i + 1] or off > len(data):
                    raise DeserializationError(f"{cls.__name__}: bad offsets")
                kwargs[fname] = ftype.deserialize(data[off : bounds[i + 1]])
        elif pos != len(data):
            raise DeserializationError(
                f"{cls.__name__}: {len(data) - pos} trailing bytes"
            )
        obj = cls.__new__(cls)
        for fname, ftype in cls._fields.items():
            object.__setattr__(obj, fname, kwargs[fname])
        return obj

    @classmethod
    def hash_tree_root_of(cls, value) -> bytes:
        chunks = [t.hash_tree_root_of(getattr(value, f)) for f, t in cls._fields.items()]
        return merkleize(chunks)

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def coerce(cls, value):
        if not isinstance(value, cls):
            raise TypeError(f"expected {cls.__name__}, got {type(value).__name__}")
        return value

    @classmethod
    def chunk_count(cls):
        return len(cls._fields)

    # -- conveniences -------------------------------------------------------

    def serialize(self) -> bytes:
        return type(self).serialize_value(self)

    def hash_tree_root(self) -> bytes:
        return type(self).hash_tree_root_of(self)


def _deep_copy(ftype, value):
    if isinstance(value, Container):
        return value.copy()
    if isinstance(
        value, (PersistentList, PersistentContainerList, PersistentByteList)
    ):
        return value.copy()  # O(#blocks) structural share
    if isinstance(value, bytearray):
        return bytearray(value)
    if isinstance(value, list):
        elem_t = getattr(ftype, "ELEM", None)
        if elem_t is not None and not _is_basic(elem_t) and not issubclass(
            elem_t, (ByteVector, ByteList)
        ):
            return [_deep_copy(elem_t, v) for v in value]
        return list(value)
    return value


# ---------------------------------------------------------------------------
# Free-function API
# ---------------------------------------------------------------------------


def serialize(ssz_type: type, value=None) -> bytes:
    if value is None and isinstance(ssz_type, Container):
        return ssz_type.serialize()
    return ssz_type.serialize_value(value)


def deserialize(ssz_type: type, data: bytes):
    return ssz_type.deserialize(data)


def hash_tree_root(ssz_type_or_value, value=None) -> bytes:
    if value is None and isinstance(ssz_type_or_value, Container):
        return ssz_type_or_value.hash_tree_root()
    return ssz_type_or_value.hash_tree_root_of(value)
