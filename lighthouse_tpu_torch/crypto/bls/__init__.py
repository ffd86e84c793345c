"""BLS signature layer with a pluggable backend seam.

Mirrors the reference's backend-generic `crypto/bls` crate
(crypto/bls/src/lib.rs:84-139): the same type family (SecretKey, PublicKey,
Signature, AggregateSignature, SignatureSet) works over any backend; the
reference selects backends at compile time via cargo features
(blst / fake_crypto), we select at runtime via `set_backend`; until it
is called the backend follows the default device (lighthouse_tpu_torch
.device): `cuda` on a `cuda` device, `host` on the CPU.

Backends:
  "host"        — pure-Python BLS12-381 (the blst analog; the CPU
                  device's default)
  "cuda"        — host ops + verify_signature_sets on the card
                  (ops/bls381_verify over the hand-written CUDA kernels;
                  the `cuda` device's default)
  "fake_crypto" — always-valid no-op crypto for spec-logic tests
                  (crypto/bls/src/impls/fake_crypto.rs equivalent)

Counterpart of lighthouse_tpu/crypto/bls. The host backend shards its
batch-verify and batch-sign work units across the host fork pool
(parallel/host_pool; inline at pool size 1), as the reference does; the
`cuda` backend replaces the reference's `tpu` backend and has no
fallback.

The eth2 scheme is min-pubkey-size: pubkeys in G1 (48 B), signatures in G2
(96 B), proof-of-possession ciphersuite DST (impls/blst.rs:13). Messages are
always 32-byte signing roots (consensus/types/src/signing_data.rs:22-35).
"""

from __future__ import annotations

import os
import secrets
import threading
from collections import OrderedDict
from dataclasses import dataclass

from ...device import default_device
from ...metrics import REGISTRY, inc_counter
from ...utils.tracing import span
from ..bls12_381 import (
    DST_G2_POP,
    FQ,
    FQ2,
    G1_GEN,
    R,
    FixedBaseTable,
    fixed_base_window,
    fixed_base_worthwhile,
    g1_from_bytes,
    g1_gen_mul,
    g1_in_subgroup,
    g1_to_bytes,
    batch_to_affine,
    g2_affine_to_bytes,
    g2_from_bytes,
    g2_in_subgroup,
    g2_to_bytes,
    hash_to_g2,
    inf,
    is_inf,
    msm,
    P,
    pairing_check,
    pt_add,
    pt_mul,
    pt_neg,
    to_affine,
)
from ..bls12_381 import fields as _F
from ..bls12_381.pairing import final_exponentiation, miller_product

PUBLIC_KEY_BYTES_LEN = 48
SIGNATURE_BYTES_LEN = 96
SECRET_KEY_BYTES_LEN = 32
# Bits of randomness per batch-verify scalar (impls/blst.rs:14 RAND_BITS).
RAND_BITS = 64

# The ONE device-lane chunk default, kept from the reference: the `cuda`
# backend verifies in chunks of this many sets (LIGHTHOUSE_TPU_BLS_CHUNK
# overrides it, as in the reference).
DEFAULT_DEVICE_CHUNK = 32

_R_MONT = 1 << 384  # the card's Montgomery radix (ops/bls381.py)

INFINITY_PUBLIC_KEY = bytes([0xC0]) + bytes(47)
INFINITY_SIGNATURE = bytes([0xC0]) + bytes(95)


class BlsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Verification caches
# ---------------------------------------------------------------------------
# Block import re-sees the same material constantly: validator pubkeys recur
# every block (the reference keeps them decompressed in
# beacon_chain/src/validator_pubkey_cache.rs), the same attestation message
# recurs across sets/retries, and a signature revalidated on a retry repeats
# its subgroup check. Two bounded LRUs cover all of it:
#   * bytes → point decompression caches for PublicKey/Signature, each entry
#     carrying a "validated" flag so subgroup checks run once per encoding;
#   * an LRU for hash_to_g2(msg, dst).
# Hit/miss counters are exported through the metrics registry
# (bls_cache_{hits,misses}_total{cache=...}).


class LruCache:
    """Minimal locked bounded LRU — the one get/insert/evict implementation
    behind every verification cache (and signature_sets' pubkey object
    cache), so the locking discipline lives in exactly one place."""

    __slots__ = ("maxsize", "_entries", "_lock")

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
            return value

    def setdefault(self, key, value):
        """Insert-if-absent; returns the resident value either way."""
        with self._lock:
            current = self._entries.get(key)
            if current is not None:
                self._entries.move_to_end(key)
                return current
            self._entries[key] = value
            if len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return value

    def clear(self):
        with self._lock:
            self._entries.clear()


class _DecompressionCache:
    """Bounded bytes→point LRU with a subgroup-validated flag."""

    __slots__ = ("name", "_lru")

    def __init__(self, name: str, maxsize: int):
        self.name = name
        self._lru = LruCache(maxsize)

    @property
    def maxsize(self) -> int:
        return self._lru.maxsize

    def point(self, data: bytes, decompress):
        entry = self._lru.get(data)
        if entry is not None:
            inc_counter("bls_cache_hits_total", cache=self.name)
            return entry[0]
        inc_counter("bls_cache_misses_total", cache=self.name)
        point = decompress(data)  # may raise ValueError; nothing cached
        return self._lru.setdefault(data, [point, False])[0]

    def validate(self, data: bytes, point, checker) -> bool:
        """True iff `point` passes `checker`, remembering success so the
        check runs once per encoding."""
        entry = self._lru.get(data)
        if entry is not None and entry[1]:
            inc_counter("bls_cache_hits_total", cache=self.name + "_validated")
            return True
        inc_counter("bls_cache_misses_total", cache=self.name + "_validated")
        ok = checker(point)
        if ok:
            # entry[1] is a plain flag flip: benign if two threads race it
            self._lru.setdefault(data, [point, True])[1] = True
        return ok

    def put(self, data: bytes, point):
        """Keep a point decompressed elsewhere (the host pool's workers)."""
        self._lru.setdefault(data, [point, False])

    def has(self, data: bytes) -> bool:
        return self._lru.get(data) is not None

    def clear(self):
        self._lru.clear()


# Pubkey capacity follows the reference's ValidatorPubkeyCache, which keeps
# EVERY validator's decompressed key resident (validator_pubkey_cache.rs:17):
# default 2^20 covers a mainnet-scale registry, and the registry sweeps once
# per epoch so a smaller bound would thrash decompression + subgroup checks.
# Signatures are transient (per-block/gossip), so a small LRU suffices.
_PK_CACHE = _DecompressionCache(
    "pubkey", int(os.environ.get("LIGHTHOUSE_TPU_BLS_PK_CACHE", str(1 << 20)))
)
_SIG_CACHE = _DecompressionCache(
    "signature", int(os.environ.get("LIGHTHOUSE_TPU_BLS_SIG_CACHE", "8192"))
)

_H2G_CACHE = LruCache(int(os.environ.get("LIGHTHOUSE_TPU_BLS_H2G_CACHE", "2048")))


def hash_to_g2_cached(message: bytes, dst: bytes = DST_G2_POP):
    """`hash_to_g2` behind a bounded LRU — the same signing root recurs
    across signature sets, retries and the signing path."""
    key = (message, dst)
    point = _H2G_CACHE.get(key)
    if point is not None:
        inc_counter("bls_cache_hits_total", cache="hash_to_g2")
        return point
    inc_counter("bls_cache_misses_total", cache="hash_to_g2")
    return _H2G_CACHE.setdefault(key, hash_to_g2(message, dst))


# Register every counter label eagerly so the exposition (and the bench's
# cache report) shows zeros instead of omitting the series.
for _c in (
    "pubkey", "pubkey_validated", "signature", "signature_validated",
    "hash_to_g2",
):
    REGISTRY.counter("bls_cache_hits_total").inc(0.0, cache=_c)
    REGISTRY.counter("bls_cache_misses_total").inc(0.0, cache=_c)
del _c

# Batch-verify path counter: `msm` is the host backend's Pippenger path.
# Eager registration so a report shows zero instead of omitting the series.
# bls_pool_tasks_total is registered here too (parallel/host_pool also
# registers it) because the pool import is lazy.
REGISTRY.counter(
    "bls_batch_verify_total", "batch verifications by algorithm path"
).inc(0.0, path="msm")
for _m in ("inline", "fork"):
    REGISTRY.counter("bls_pool_tasks_total").inc(0.0, mode=_m)
del _m
# Batch-signing strategy counter (the VC duty pipeline's signing stage):
# `fixed_base` counts signatures served by a per-message window table,
# `per_key` the small-group pt_mul fallback inside the same worker seam.
for _p in ("fixed_base", "per_key"):
    REGISTRY.counter(
        "bls_sign_batch_total", "batch signatures by scalar-mul strategy"
    ).inc(0.0, path=_p)
del _p


def cache_stats() -> dict:
    """{cache: {"hits": n, "misses": n}} snapshot for bench/metrics report."""
    hits = REGISTRY.counter("bls_cache_hits_total").values()
    misses = REGISTRY.counter("bls_cache_misses_total").values()
    out = {}
    for key in set(hits) | set(misses):
        name = dict(key).get("cache")
        if name:
            out[name] = {
                "hits": hits.get(key, 0.0),
                "misses": misses.get(key, 0.0),
            }
    return out


# ---------------------------------------------------------------------------
# Type family (generic over backend, like the reference's define_mod! output)
# ---------------------------------------------------------------------------


class PublicKey:
    """G1 point, 48-byte compressed. Decompression is lazy and cached —
    the decompressed form is what the validator-pubkey cache keeps resident
    (beacon_chain/src/validator_pubkey_cache.rs:17 analog)."""

    __slots__ = ("_bytes", "_point", "_limbs")

    def __init__(self, data: bytes, point=None):
        if len(data) != PUBLIC_KEY_BYTES_LEN:
            raise BlsError(f"pubkey must be {PUBLIC_KEY_BYTES_LEN} bytes")
        self._bytes = bytes(data)
        self._point = point
        self._limbs = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        pk = cls(data)
        if not _active().fake:
            pk.point()  # force decompression => validity check
        return pk

    @classmethod
    def from_point(cls, point) -> "PublicKey":
        return cls(g1_to_bytes(point), point)

    def to_bytes(self) -> bytes:
        return self._bytes

    def point(self):
        if self._point is None:
            if self._bytes == INFINITY_PUBLIC_KEY:
                raise BlsError("pubkey is the point at infinity")
            self._point = _PK_CACHE.point(self._bytes, g1_from_bytes)
        return self._point

    def limbs(self) -> bytes:
        """The decompressed point's affine x and y as the card's Montgomery
        limbs (2 x 12 little-endian u32, R = 2^384), computed once per key:
        the staging form of ops/bls381_verify, kept beside the point."""
        if self._limbs is None:
            x, y, z = self.point()
            if z != 1:
                x, y = to_affine(FQ, (x, y, z))
            self._limbs = (x * _R_MONT % P).to_bytes(48, "little") + (
                y * _R_MONT % P
            ).to_bytes(48, "little")
        return self._limbs

    def validate(self) -> bool:
        """KeyValidate: decompresses, rejects infinity, checks subgroup.
        The subgroup check is deduplicated through the decompression cache's
        validated flag — one check per encoding, not per call."""
        if _active().fake:
            return True
        try:
            pt = self.point()
        except (BlsError, ValueError):
            return False
        return _PK_CACHE.validate(self._bytes, pt, g1_in_subgroup)

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self._bytes == other._bytes

    def __hash__(self):
        return hash(self._bytes)

    def __repr__(self):
        return f"PublicKey(0x{self._bytes.hex()[:16]}…)"


class Signature:
    """G2 point, 96-byte compressed."""

    __slots__ = ("_bytes", "_point")

    def __init__(self, data: bytes, point=None):
        if len(data) != SIGNATURE_BYTES_LEN:
            raise BlsError(f"signature must be {SIGNATURE_BYTES_LEN} bytes")
        self._bytes = bytes(data)
        self._point = point

    empty = classmethod(lambda cls: cls(INFINITY_SIGNATURE))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(data)

    @classmethod
    def from_point(cls, point) -> "Signature":
        return cls(g2_to_bytes(point), point)

    def to_bytes(self) -> bytes:
        return self._bytes

    def is_infinity(self) -> bool:
        return self._bytes == INFINITY_SIGNATURE

    def point(self):
        if self._point is None:
            self._point = _SIG_CACHE.point(self._bytes, g2_from_bytes)
        return self._point

    def subgroup_check(self) -> bool:
        """G2 subgroup membership, deduplicated via the decompression
        cache's validated flag (a retried signature re-checks for free)."""
        try:
            pt = self.point()
        except (BlsError, ValueError):
            return False
        return _SIG_CACHE.validate(self._bytes, pt, g2_in_subgroup)

    def verify(self, pubkey: PublicKey, message: bytes) -> bool:
        return _active().verify(self, pubkey, message)

    def __eq__(self, other):
        return isinstance(other, Signature) and self._bytes == other._bytes

    def __hash__(self):
        return hash(self._bytes)

    def __repr__(self):
        return f"Signature(0x{self._bytes.hex()[:16]}…)"


class SecretKey:
    """Scalar in [1, r). Never leaves the host (SURVEY.md §7 step 2)."""

    __slots__ = ("_scalar",)

    def __init__(self, scalar: int):
        if not 1 <= scalar < R:
            raise BlsError("secret key out of range")
        self._scalar = scalar

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(secrets.randbelow(R - 1) + 1)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_BYTES_LEN:
            raise BlsError("secret key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    def to_bytes(self) -> bytes:
        return self._scalar.to_bytes(32, "big")

    @property
    def scalar(self) -> int:
        return self._scalar

    def public_key(self) -> PublicKey:
        if _active().fake:
            return PublicKey(_fake_pubkey_bytes(self._scalar))
        # fixed-base window table: ≤64 additions instead of a 256-bit ladder
        return PublicKey.from_point(g1_gen_mul(self._scalar))

    def sign(self, message: bytes) -> Signature:
        return _active().sign(self, message)


@dataclass
class Keypair:
    sk: SecretKey
    pk: PublicKey

    @classmethod
    def random(cls) -> "Keypair":
        sk = SecretKey.random()
        return cls(sk=sk, pk=sk.public_key())


class AggregateSignature:
    """Running aggregate of G2 signatures
    (generic_aggregate_signature.rs equivalent)."""

    __slots__ = ("_point", "_empty")

    def __init__(self):
        self._point = inf(FQ2)
        self._empty = True

    @classmethod
    def from_signatures(cls, sigs) -> "AggregateSignature":
        agg = cls()
        for s in sigs:
            agg.add_assign(s)
        return agg

    def add_assign(self, sig: Signature):
        if _active().fake:
            self._empty = False
            return
        self._point = pt_add(FQ2, self._point, sig.point())
        self._empty = False

    def to_signature(self) -> Signature:
        if _active().fake:
            return Signature(INFINITY_SIGNATURE)
        if self._empty:
            return Signature(INFINITY_SIGNATURE)
        return Signature.from_point(self._point)

    def fast_aggregate_verify(self, pubkeys, message: bytes) -> bool:
        return self.to_signature().verify(aggregate_pubkeys(pubkeys), message)


def aggregate_pubkeys(pubkeys) -> PublicKey:
    if _active().fake:
        return pubkeys[0] if pubkeys else PublicKey(INFINITY_PUBLIC_KEY)
    acc = inf(FQ)
    for pk in pubkeys:
        acc = pt_add(FQ, acc, pk.point())
    return PublicKey.from_point(acc)


@dataclass
class SignatureSet:
    """(signature, pubkeys-to-aggregate, 32-byte message) triple — one unit
    of batch verification (crypto/bls/src/generic_signature_set.rs:61-121)."""

    signature: Signature
    pubkeys: list
    message: bytes

    @classmethod
    def single(cls, signature, pubkey, message) -> "SignatureSet":
        return cls(signature=signature, pubkeys=[pubkey], message=message)

    def verify(self) -> bool:
        return self.signature.verify(aggregate_pubkeys(self.pubkeys), self.message)


# ---------------------------------------------------------------------------
# Batch-verify work units
# ---------------------------------------------------------------------------
# These run in parallel/host_pool workers AND inline when the pool degrades
# (size <= 1), so both modes execute the identical code. Fork-safety rule
# (see host_pool's module docstring): lock-free pure Python only — the
# caches are plain per-process dicts, never the locked LRUs above, no
# metrics/logging, and no torch, because a forked child inherits parent
# locks as-held and a CUDA context does not survive fork.
# (pairing.miller_product, the fourth sharding unit, follows the same rule.)
# Invalid input raises BlsError/ValueError; the caller maps ANY worker
# exception to verification failure.

_WORKER_CACHE_CAP = 8192
_W_SIG: dict = {}   # sig bytes -> subgroup-checked G2 point (on the twist)
_W_PK: dict = {}    # pubkey bytes -> G1 point (decompressed, NOT subgroup-checked)
_W_AGG: dict = {}   # tuple of pubkey bytes -> aggregated G1 point
_W_H2G: dict = {}   # (message, dst) -> G2 point


def _cache_put(cache: dict, key, value):
    if len(cache) >= _WORKER_CACHE_CAP:
        cache.clear()
    cache[key] = value
    return value


def _prep_chunk(chunk):
    """[(sig_bytes, pk_bytes_tuple), ...] → [(sig_pt, agg_pk_pt), ...].

    Decompression + the signature subgroup check + committee aggregation —
    the per-set work that is independent across sets. Pubkeys are
    decompressed and infinity-rejected but
    NOT subgroup-checked here (KeyValidate runs where keys enter the system,
    mirroring the reference's deserialize/validate split)."""
    out = []
    for sig_bytes, pk_tuple in chunk:
        sig_pt = _W_SIG.get(sig_bytes)
        if sig_pt is None:
            pt = g2_from_bytes(sig_bytes)
            if not g2_in_subgroup(pt):
                raise BlsError("signature failed the G2 subgroup check")
            sig_pt = _cache_put(_W_SIG, sig_bytes, pt)
        agg_pk = _W_AGG.get(pk_tuple)
        if agg_pk is None:
            acc = inf(FQ)
            for pk_bytes in pk_tuple:
                p = _W_PK.get(pk_bytes)
                if p is None:
                    if pk_bytes == INFINITY_PUBLIC_KEY:
                        raise BlsError("pubkey is the point at infinity")
                    p = _cache_put(_W_PK, pk_bytes, g1_from_bytes(pk_bytes))
                acc = pt_add(FQ, acc, p)
            agg_pk = _cache_put(_W_AGG, pk_tuple, acc)
        out.append((sig_pt, agg_pk))
    return out


def _decompress_g2_chunk(encodings):
    """[96-byte signature, ...] → [G2 point or None (no valid encoding)]."""
    out = []
    for data in encodings:
        try:
            out.append(g2_from_bytes(data))
        except ValueError:
            out.append(None)
    return out


def _hash_g2_chunk(messages):
    """[32-byte message, ...] → [G2 point, ...] (POP ciphersuite DST)."""
    out = []
    for m in messages:
        key = (m, DST_G2_POP)
        pt = _W_H2G.get(key)
        if pt is None:
            pt = _cache_put(_W_H2G, key, hash_to_g2(m, DST_G2_POP))
        out.append(pt)
    return out


def _msm_chunk(tasks):
    """[("g1"|"g2", points, scalars), ...] → [Jacobian sum, ...]. MSMs are
    sums, so a big one shards as slices whose results the caller adds."""
    return [
        msm(FQ2 if grp == "g2" else FQ, pts, ss) for grp, pts, ss in tasks
    ]


# Fixed-base signing tables are LARGE (a w=10 table holds ~14k G2 points),
# so their worker cache is bounded by count, not the shared byte cap: one
# slot's distinct attestation roots fit, an epoch's worth rotates through.
_W_FBT_CAP = 8
_W_FBT: dict = {}   # (message, dst, window) -> FixedBaseTable over G2


def _worker_h2g(message: bytes, dst: bytes):
    key = (message, dst)
    pt = _W_H2G.get(key)
    if pt is None:
        pt = _cache_put(_W_H2G, key, hash_to_g2(message, dst))
    return pt


def _sign_chunk(task):
    """(message, dst, window, scalars) → [96-byte compressed signature].

    The batch-signing sharding unit: per-scalar `pt_mul` (window None —
    small groups) or the shared fixed-base table (large groups) against
    the message's hash-to-G2 point. Both produce the exact point the
    serial `_HostBackend.sign` produces, so the compressed bytes are
    bit-identical to per-key signing."""
    message, dst, window, scalars = task
    h = _worker_h2g(message, dst)
    if window is None:
        pts = [pt_mul(FQ2, h, s) for s in scalars]
    else:
        key = (message, dst, window)
        tbl = _W_FBT.get(key)
        if tbl is None:
            if len(_W_FBT) >= _W_FBT_CAP:
                _W_FBT.clear()
            tbl = FixedBaseTable(FQ2, h, window)
            _W_FBT[key] = tbl
        pts = [tbl.mul(s) for s in scalars]
    # ONE Montgomery batch inversion normalizes the whole chunk for
    # serialization instead of one field inversion per signature —
    # identical affine points, identical compressed bytes
    return [g2_affine_to_bytes(aff) for aff in batch_to_affine(FQ2, pts)]


def _clear_worker_caches():
    """Parent-side test hook (forked workers keep their own copies)."""
    for c in (_W_SIG, _W_PK, _W_AGG, _W_H2G, _W_FBT):
        c.clear()


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class _HostBackend:
    """Pure-Python BLS12-381 (the blst-analog production path)."""

    name = "host"
    fake = False

    def sign(self, sk: SecretKey, message: bytes) -> Signature:
        h = hash_to_g2_cached(message)
        return Signature.from_point(pt_mul(FQ2, h, sk.scalar))

    def sign_batch(self, secret_keys, messages) -> list:
        """Sign messages[i] with secret_keys[i], grouped by distinct
        message and sharded across the fork pool.

        The win is algorithmic, not just amortization: every group shares
        one hash-to-G2 point, and groups large enough to pay for it run
        through a per-message fixed-base window table
        (bls12_381/fixed_base.py) — ~26 additions per signature instead of
        a full wNAF ladder. Small groups keep per-scalar `pt_mul` inside
        the same worker seam. Output signatures are BIT-IDENTICAL to
        per-key `sign` (same group element, same canonical compression);
        tests/test_torch_host_pool.py holds them to `sign` at pool sizes
        0, 1 and 4."""
        from ...parallel import host_pool  # lazy, like verify_signature_sets

        if len(secret_keys) != len(messages):
            raise BlsError("sign_batch length mismatch")
        if not secret_keys:
            return []
        groups: dict[bytes, list[int]] = {}
        for i, m in enumerate(messages):
            groups.setdefault(bytes(m), []).append(i)
        pool = host_pool.get_pool()
        tasks: list = []
        task_idxs: list = []
        for message, idxs in groups.items():
            shards = (
                pool.size
                if pool.size > 1 and len(idxs) >= 2 * pool.size
                else 1
            )
            for chunk in host_pool.shard(idxs, shards):
                m = len(chunk)
                window = (
                    fixed_base_window(m) if fixed_base_worthwhile(m) else None
                )
                inc_counter(
                    "bls_sign_batch_total",
                    amount=m,
                    path="fixed_base" if window is not None else "per_key",
                )
                tasks.append(
                    (
                        message,
                        DST_G2_POP,
                        window,
                        [secret_keys[i].scalar for i in chunk],
                    )
                )
                task_idxs.append(chunk)
        out: list = [None] * len(secret_keys)
        with span("bls_sign_batch", sigs=len(secret_keys), groups=len(groups)):
            for chunk, sig_bytes in zip(
                task_idxs, pool.map(_sign_chunk, tasks)
            ):
                for i, b in zip(chunk, sig_bytes):
                    out[i] = Signature(b)
        return out

    def verify(self, sig: Signature, pubkey: PublicKey, message: bytes) -> bool:
        try:
            if sig.is_infinity():
                return False
            sig_pt = sig.point()
            pk_pt = pubkey.point()
        except (BlsError, ValueError):
            return False
        # subgroup checks deduplicated through the validated flags — a
        # pubkey that already passed PublicKey.validate() is not re-checked
        if not sig.subgroup_check() or not pubkey.validate():
            return False
        if is_inf(FQ, pk_pt):
            return False
        h = hash_to_g2_cached(message)
        # e(pk, H(m)) · e(-g1, sig) == 1
        return pairing_check([(pk_pt, h), (pt_neg(FQ, G1_GEN), sig_pt)])

    def verify_signature_sets(self, sets, rng=None) -> bool:
        """Random-linear-combination batch verification — the Pippenger MSM
        + fork-pool fast path (the role of blst's Pippenger + rayon in the
        reference's block_signature_verifier.rs).

        The check is the standard RLC product with per-set 64-bit random
        scalars rᵢ:

            e(-g1, Σ rᵢ·sigᵢ) · ∏ᵢ e(aggpkᵢ, H(mᵢ))^rᵢ == 1

        computed as few multi-pairing pairs as the batch's structure allows.
        Pairing bilinearity lets the ∏ᵢ term be factored along EITHER side:

          * by message  — ∏_m e(Σ_{mᵢ=m} rᵢ·aggpkᵢ, H(m)): one G1 MSM per
            distinct message (attestation batches: one message/committee);
          * by pubkeys  — ∏_P e(P, Σ_{aggpkᵢ=P} rᵢ·H(mᵢ)): one G2 MSM per
            distinct committee (gossip batches: one committee, many roots —
            this is what makes a 1024-set batch cost 2 pairings, not 1025).

        Whichever grouping yields fewer pairs wins; both are exact identities
        so the soundness argument is unchanged. Σ rᵢ·sigᵢ is always ONE G2
        MSM. Decompression + subgroup checks, hash-to-G2, the MSMs and the
        pairs' Miller loops shard across parallel/host_pool (inline when the
        pool degrades); the final exponentiation runs once in the parent.
        Any worker exception is a verification failure, never a hang."""
        from ...parallel import host_pool  # lazy: no pool for single verifies

        sets = list(sets)
        if not sets:
            return False
        rand = rng if rng is not None else secrets.SystemRandom()
        inc_counter("bls_batch_verify_total", path="msm")
        pool = host_pool.get_pool()
        items = []
        for s in sets:
            if s.signature.is_infinity() or not s.pubkeys:
                return False
            r = 0
            while r == 0:
                r = rand.getrandbits(RAND_BITS)
            items.append(
                (
                    s.signature.to_bytes(),
                    tuple(pk.to_bytes() for pk in s.pubkeys),
                    s.message,
                    r,
                )
            )
        try:
            try:
                with span("bls_rlc_accumulate", sets=len(items)):
                    prepped = [
                        p
                        for chunk in pool.map(
                            _prep_chunk,
                            host_pool.shard(
                                [(sig, pks) for sig, pks, _, _ in items],
                                pool.size,
                            ),
                        )
                        for p in chunk
                    ]
            except ValueError:
                # malformed encodings / failed subgroup checks (BlsError is
                # a ValueError) — a silent reject.
                # Scoped to the prep stage: downstream stages operate on
                # validated points, so THEIR ValueErrors are internal bugs
                # and fall through to the logged handler below.
                return False
            messages = list(dict.fromkeys(m for _, _, m, _ in items))
            with span("bls_hash_to_g2", messages=len(messages)):
                h2g = dict(
                    zip(
                        messages,
                        (
                            pt
                            for chunk in pool.map(
                                _hash_g2_chunk,
                                host_pool.shard(messages, pool.size),
                            )
                            for pt in chunk
                        ),
                    )
                )
            with span("bls_msm_g2", sets=len(items)):
                rs = [r for _, _, _, r in items]
                sig_pts = [sig_pt for sig_pt, _ in prepped]
                # Σ rᵢ·sigᵢ: one G2 MSM, sharded as per-worker slice sums
                agg_sig = inf(FQ2)
                for part in pool.map(
                    _msm_chunk,
                    [
                        [("g2", [sig_pts[i] for i in idxs], [rs[i] for i in idxs])]
                        for idxs in host_pool.shard(range(len(items)), pool.size)
                    ],
                ):
                    agg_sig = pt_add(FQ2, agg_sig, part[0])
                by_msg: dict[bytes, list] = {}
                by_pk: dict[tuple, list] = {}
                for i, (_, pk_tuple, message, _) in enumerate(items):
                    by_msg.setdefault(message, []).append(i)
                    by_pk.setdefault(pk_tuple, []).append(i)
                if len(by_pk) < len(by_msg):
                    group_tasks = [
                        ("g2", [h2g[items[i][2]] for i in idxs], [rs[i] for i in idxs])
                        for idxs in by_pk.values()
                    ]
                    g1_sides = [prepped[idxs[0]][1] for idxs in by_pk.values()]
                    results = [
                        r
                        for chunk in pool.map(
                            _msm_chunk, host_pool.shard(group_tasks, pool.size)
                        )
                        for r in chunk
                    ]
                    pairs = list(zip(g1_sides, results))
                else:
                    group_tasks = [
                        ("g1", [prepped[i][1] for i in idxs], [rs[i] for i in idxs])
                        for idxs in by_msg.values()
                    ]
                    g2_sides = [h2g[m] for m in by_msg]
                    results = [
                        r
                        for chunk in pool.map(
                            _msm_chunk, host_pool.shard(group_tasks, pool.size)
                        )
                        for r in chunk
                    ]
                    pairs = list(zip(results, g2_sides))
            pairs.insert(0, (pt_neg(FQ, G1_GEN), agg_sig))
            with span("bls_pairing", pairs=len(pairs)):
                with span(
                    "bls_parallel_pairing", pairs=len(pairs), pool=pool.size
                ):
                    f = _F.F12_ONE
                    for part in pool.map(
                        miller_product, host_pool.shard(pairs, pool.size)
                    ):
                        f = _F.f12_mul(f, part)
                    return _F.f12_is_one(final_exponentiation(f))
        except Exception as e:  # noqa: BLE001 — fail closed, never hang
            from ...utils.logging import get_logger

            get_logger("lighthouse_tpu_torch.bls").warning(
                "batch verification error -> treating batch as invalid",
                error=str(e)[:200],
                sets=len(sets),
            )
            return False


def _fake_pubkey_bytes(scalar: int) -> bytes:
    import hashlib

    d = hashlib.sha256(b"fake_pk" + scalar.to_bytes(32, "big")).digest()
    return bytes([0xAA]) + d + d[:15]


class _FakeBackend:
    """fake_crypto: deterministic dummy bytes, verification always succeeds
    (crypto/bls/src/impls/fake_crypto.rs equivalent — lets spec-logic tests
    run without pairing cost)."""

    name = "fake_crypto"
    fake = True

    def sign(self, sk: SecretKey, message: bytes) -> Signature:
        import hashlib

        d = hashlib.sha256(
            b"fake_sig" + sk.scalar.to_bytes(32, "big") + message
        ).digest()
        return Signature(d + d + d)

    def sign_batch(self, secret_keys, messages) -> list:
        """Per-key fake signing — deterministic bytes identical to the
        per-key path, so the VC batch/oracle differential holds under
        fake_crypto too."""
        if len(secret_keys) != len(messages):
            raise BlsError("sign_batch length mismatch")
        return [
            self.sign(sk, m) for sk, m in zip(secret_keys, messages)
        ]

    def verify(self, sig, pubkey, message) -> bool:
        return True

    def verify_signature_sets(self, sets, rng=None) -> bool:
        return True


class _CudaBackend(_HostBackend):
    """Host ops with the whole batch verification on the card
    (ops/bls381_verify over the hand-written CUDA kernels): subgroup checks,
    committee aggregation, RLC ladders, SSWU hash-to-G2 and the
    multi-pairing. Batches are verified in chunks of DEFAULT_DEVICE_CHUNK
    sets (LIGHTHOUSE_TPU_BLS_CHUNK overrides it, as in the reference's
    `tpu` backend). Unlike that backend it has no fallback: a failed build
    or launch raises, and with the device `cuda` and no card the first
    dispatch raises."""

    name = "cuda"

    def verify_signature_sets(self, sets, rng=None) -> bool:
        from ...ops.bls381_verify import verify_signature_sets_device_full

        sets = list(sets)
        if not sets:
            return False
        chunk = int(
            os.environ.get("LIGHTHOUSE_TPU_BLS_CHUNK", str(DEFAULT_DEVICE_CHUNK))
        ) or len(sets)
        staged = 0 if len(sets) >= POOL_DECOMPRESS_MIN else len(sets)
        for i in range(0, len(sets), chunk):
            if i >= staged:
                staged = i + _decompress_on_pool(sets[i:i + POOL_DECOMPRESS_SETS])
            if not verify_signature_sets_device_full(sets[i:i + chunk], rng):
                return False
        return True


#: a batch of at least this many sets has its signatures decompressed on
#: the host pool, POOL_DECOMPRESS_SETS at a time, before the card's chunks
#: stage them (one host G2 square root a signature otherwise, in series)
POOL_DECOMPRESS_MIN = 256
POOL_DECOMPRESS_SETS = 2048


def _decompress_on_pool(sets) -> int:
    """Decompress the signatures of `sets` that the signature cache does not
    hold on the host pool's workers and keep them in the cache, where the
    card's staging finds them. An encoding that does not decompress is left
    out: the staging meets it and refuses its chunk as before. Returns the
    number of sets covered."""
    from ...device import resolve_device
    from ...parallel import host_pool

    resolve_device()  # a forked API worker forwards the request: no pool here
    todo = list(
        dict.fromkeys(
            s.signature.to_bytes()
            for s in sets
            if s.signature._point is None
            and not s.signature.is_infinity()
            and not _SIG_CACHE.has(s.signature.to_bytes())
        )
    )
    pool = host_pool.get_pool()
    if pool.size > 1 and len(todo) >= POOL_DECOMPRESS_MIN // 2:
        shards = host_pool.shard(todo, pool.size)
        for shard, points in zip(shards, pool.map(_decompress_g2_chunk, shards)):
            for data, point in zip(shard, points):
                if point is not None:
                    _SIG_CACHE.put(data, point)
    return len(sets)


_BACKENDS = {
    "host": _HostBackend(),
    "fake_crypto": _FakeBackend(),
    "cuda": _CudaBackend(),
}

# None: follow the default device (`cuda` on a `cuda` device, `host` on
# the CPU); a name given to set_backend wins until set_backend(None).
_backend = None


def _active():
    if _backend is not None:
        return _backend
    return _BACKENDS["cuda" if default_device().type == "cuda" else "host"]


def set_backend(name: str | None):
    """Pin the backend by name, or with None let it follow the default
    device again."""
    global _backend
    _backend = None if name is None else _BACKENDS[name]


def backend_setting() -> str | None:
    """The name given to set_backend, or None while the backend follows
    the device (what a caller saves to restore it)."""
    return None if _backend is None else _backend.name


def get_backend():
    return _active()


def backend_name() -> str:
    return _active().name


def verify_signature_sets(sets, rng=None) -> bool:
    """Module-level entry used by state_processing's BlockSignatureVerifier
    and the attestation batch path (the reference's bls::verify_signature_sets,
    lib.rs / impls/blst.rs:35)."""
    return _active().verify_signature_sets(sets, rng)


def sign_batch(secret_keys, messages) -> list:
    """Module-level batch signing (the validator client's `vc_sign_batch`
    stage): signatures for (secret_keys[i], messages[i]) in submission
    order, grouped by distinct message behind the backend seam."""
    return _active().sign_batch(secret_keys, messages)


# ---------------------------------------------------------------------------
# Interop keypairs (common/eth2_interop_keypairs — spec deterministic keys)
# ---------------------------------------------------------------------------

import hashlib as _hashlib


def interop_secret_key(index: int) -> SecretKey:
    """sk = int_le(sha256(le32(index))) % r — matches the reference's
    eth2_interop_keypairs (validated against its specs/ golden vectors)."""
    preimage = index.to_bytes(32, "little")
    scalar = int.from_bytes(_hashlib.sha256(preimage).digest(), "little") % R
    return SecretKey(scalar)


def interop_keypairs(count: int) -> list:
    """Deterministic validator keypairs for interop genesis
    (genesis/src/interop.rs:31 consumers)."""
    out = []
    for i in range(count):
        sk = interop_secret_key(i)
        out.append(Keypair(sk=sk, pk=sk.public_key()))
    return out
