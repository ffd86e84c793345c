"""Zero-copy columnar response assembly for the read-heavy Beacon API
routes.

The reference serves `/states/{id}/validators` and friends for operator
dashboards and staking fleets at millions of validators; a per-request
walk over 1M `Validator` Python objects is the anti-pattern that block
processing already avoids. The resident `RegistryColumns` arrays
already hold every field these responses need, so this module builds the
JSON (and SSZ, where the route defines it) **directly from the columns**:

  * batched int→decimal-string conversion (`ndarray.astype('U20')` — one
    C pass per uint64 column, no per-row `str()`),
  * one hex pass over the whole gathered pubkey byte matrix
    (`bytes.hex(sep, -width)` + a single split — no per-row `.hex()`),
  * spec validator statuses computed vectorized over the epoch columns
    (`np.select` over the pending/active/exited/withdrawal families),
  * row text minted by one C-level `str.format` map per chunk — **no
    per-validator Python object materialization anywhere on the path**
    (counted in `api_columnar_assembly_total{route}`; the retained
    per-object renderers in `__init__.py` are the differential oracle).

Filters and pagination are slice-gathers: `id=`/`status=` normalize once
into an int64 index array (pubkeys through the columns' pubkey→index
map), `limit=`/`offset=` slice it — a paginated request over a 1M
registry touches only its page's rows.

Every byte produced here is identical to `json.dumps(oracle, separators
=(",", ":"))` of the per-object renderers — asserted by the differential
tests.
"""

from __future__ import annotations

import threading

import numpy as np

from ..metrics import REGISTRY
from ..types.chain_spec import FAR_FUTURE_EPOCH

# -- eager metric registration (conftest asserts these series exist) --------

API_ROUTES = ("validators", "validator_balances", "committees", "headers")

_ASSEMBLED = REGISTRY.counter(
    "api_columnar_assembly_total",
    "API responses assembled zero-copy from the resident columns, by route",
)
for _route in API_ROUTES:
    _ASSEMBLED.inc(0, route=_route)

# child spans of the api_request root (OBSERVABILITY.md "API serving
# tier"); registered at import so the series exist at zero
for _stage in ("cache_lookup", "assemble", "serialize"):
    REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the stage tuple above
        f"trace_span_seconds_{_stage}",
        f"span duration: {_stage}",
    )


def count_assembled(route: str):
    _ASSEMBLED.inc(route=route)


# ---------------------------------------------------------------------------
# Spec validator statuses
# ---------------------------------------------------------------------------

#: beacon-API ValidatorStatus values, indexed by the codes
#: `status_codes` produces (the four spec families in order)
STATUSES = (
    "pending_initialized",
    "pending_queued",
    "active_ongoing",
    "active_exiting",
    "active_slashed",
    "exited_unslashed",
    "exited_slashed",
    "withdrawal_possible",
    "withdrawal_done",
)

#: family name → the codes it matches (the beacon-API spec lets `status=`
#: name either an exact status or its family)
STATUS_FAMILIES = {
    "pending": (0, 1),
    "active": (2, 3, 4),
    "exited": (5, 6),
    "withdrawal": (7, 8),
}

def validator_status(
    activation_eligibility_epoch: int,
    activation_epoch: int,
    exit_epoch: int,
    withdrawable_epoch: int,
    slashed: bool,
    balance: int,
    current_epoch: int,
) -> str:
    """Spec status of one validator (scalar twin of `status_codes` — the
    per-object oracle renderers use this; the differential suite pins the
    two against each other)."""
    if activation_epoch > current_epoch:
        if activation_eligibility_epoch == FAR_FUTURE_EPOCH:
            return "pending_initialized"
        return "pending_queued"
    if current_epoch < exit_epoch:
        if exit_epoch == FAR_FUTURE_EPOCH:
            return "active_ongoing"
        return "active_slashed" if slashed else "active_exiting"
    if current_epoch < withdrawable_epoch:
        return "exited_slashed" if slashed else "exited_unslashed"
    return "withdrawal_possible" if balance > 0 else "withdrawal_done"


def status_codes(
    activation_eligibility_epoch: np.ndarray,
    activation_epoch: np.ndarray,
    exit_epoch: np.ndarray,
    withdrawable_epoch: np.ndarray,
    slashed: np.ndarray,
    balances: np.ndarray,
    current_epoch: int,
) -> np.ndarray:
    """Vectorized `validator_status` over whole columns → uint8 codes
    into `STATUSES`."""
    cur = np.uint64(current_epoch)
    far = np.uint64(FAR_FUTURE_EPOCH)
    pending = activation_epoch > cur
    active = ~pending & (cur < exit_epoch)
    exited = ~pending & (exit_epoch <= cur) & (cur < withdrawable_epoch)
    withdrawal = ~pending & (withdrawable_epoch <= cur)
    slashed = slashed.astype(bool)
    conds = [
        pending & (activation_eligibility_epoch == far),
        pending,
        active & (exit_epoch == far),
        active & ~slashed,
        active & slashed,
        exited & ~slashed,
        exited & slashed,
        withdrawal & (balances > np.uint64(0)),
        withdrawal,
    ]
    return np.select(conds, np.arange(9, dtype=np.uint8), default=2)


# ---------------------------------------------------------------------------
# Filter / pagination normalization
# ---------------------------------------------------------------------------


class QueryError(ValueError):
    """Malformed query parameter (rendered as a 400 by the HTTP layer)."""


def _parse_pubkey(s: str) -> bytes:
    raw = s[2:] if s.startswith("0x") else s
    try:
        pk = bytes.fromhex(raw)
    except ValueError as e:
        raise QueryError(f"malformed validator id {s!r}") from e
    if len(pk) != 48:
        raise QueryError(f"validator pubkey must be 48 bytes: {s!r}")
    return pk


def normalize_ids(ids, pubkey_resolver, n: int) -> np.ndarray:
    """Spec ValidatorId list (index | 0x-pubkey, strings or ints) → a
    sorted unique int64 index array. `pubkey_resolver(bytes) -> int|None`
    maps pubkeys (the columns' pubkey→index map, or an oracle scan).
    Out-of-range indices and unknown pubkeys are dropped (spec: missing
    validators are omitted); malformed ids raise QueryError.

    This is the fix for the seed's `i not in indices` bug: the request's
    STRING ids never matched int indices, and membership was O(n·k) —
    here ids normalize once into an index set and every route gathers."""
    out = set()
    for v in ids:
        if isinstance(v, int):
            if 0 <= v < n:
                out.add(v)
            continue
        s = str(v)
        if s.isdigit():
            i = int(s)
            if i < n:
                out.add(i)
            continue
        idx = pubkey_resolver(_parse_pubkey(s.lower()))
        if idx is not None and idx < n:
            out.add(int(idx))
    return np.array(sorted(out), dtype=np.int64)


def normalize_statuses(statuses) -> frozenset:
    """`status=` values (exact statuses or families) → frozenset of
    status codes."""
    codes: set[int] = set()
    for s in statuses:
        s = str(s).lower()
        if s in STATUS_FAMILIES:
            codes.update(STATUS_FAMILIES[s])
        elif s in STATUSES:
            codes.add(STATUSES.index(s))
        else:
            raise QueryError(f"unknown validator status {s!r}")
    return frozenset(codes)


def parse_pagination(query: dict) -> tuple[int | None, int]:
    """`limit=`/`offset=` (bounded-page extension params, documented in
    OBSERVABILITY.md) → (limit or None, offset). Non-numeric or negative
    values raise QueryError; limit=0 is a valid empty page."""
    out = []
    for name, default in (("limit", None), ("offset", 0)):
        raw = query.get(name)
        if raw is None:
            out.append(default)
            continue
        if isinstance(raw, (list, tuple)):
            raw = raw[0]
        try:
            v = int(raw)
        except (TypeError, ValueError) as e:
            raise QueryError(f"bad {name} {raw!r}") from e
        if v < 0:
            raise QueryError(f"{name} must be non-negative")
        out.append(v)
    return out[0], out[1]


def select_rows(
    n: int,
    id_idx: np.ndarray | None,
    status_filter: frozenset | None,
    codes: np.ndarray | None,
    limit: int | None,
    offset: int,
) -> np.ndarray | None:
    """Combine the normalized filters into the final row-index gather
    (None = the whole table, no gather needed). A paginated request
    without filters is a pure slice — never a full-table scan."""
    if id_idx is None and status_filter is None:
        if limit is None and offset == 0:
            return None
        stop = n if limit is None else min(n, offset + limit)
        return np.arange(min(offset, n), stop, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64) if id_idx is None else id_idx
    if status_filter is not None:
        keep = np.isin(codes[idx], np.array(sorted(status_filter), dtype=np.uint8))
        idx = idx[keep]
    if offset or limit is not None:
        stop = idx.size if limit is None else offset + limit
        idx = idx[offset:stop]
    return idx


# ---------------------------------------------------------------------------
# Row assembly (bytes end to end)
# ---------------------------------------------------------------------------
#
# A row is emitted as SEVEN bytes pieces flattened into one `b"".join`:
#
#   ","  +  '{"index":"<i>","balance":"'  +  <bal>  +  SEG1  +  <pkhex>
#        +  '","withdrawal_credentials":"0x<wchex>'  +  SEG3
#
# where SEG1/SEG3 are shared per (status, eff-balance, slashed, 4 epochs)
# COMBO — one np.unique over a packed [m, 6]-u64 key groups the
# low-cardinality fields so 6 of the 8 per-row conversions become two
# object-pointer gathers. The remaining per-row costs: one `b"%d"`
# balance render, and pointer gathers from three RESIDENT piece caches —
# the index piece list (pure f(i), process-global) and the pubkey /
# withdrawal-credential hex lists (one hexlify pass per column
# residency, keyed on (array identity, mutation stamp), NOT per
# request). The leading "," of the first row is dropped by an islice,
# so the whole body is ONE join — no trailing-comma slice copy of a
# 400 MB response.

_ENVELOPE_TAIL = b'],"execution_optimistic":false,"finalized":false}'

_STATUS_BYTES = tuple(s.encode() for s in STATUSES)

#: process-global index piece cache: entry i is
#: b'{"index":"<i>","balance":"' — registries only grow, and rows 0..n
#: are prefix-stable, so one list serves every table size up to its len
_IDX_PIECES: list[bytes] = []

#: two concurrent cold requests racing the extend would interleave their
#: appends and permanently corrupt the index→piece positions; the lock
#: makes the grow single-flight (readers of the already-built prefix
#: never block — list reads are atomic)
_IDX_LOCK = threading.Lock()

#: per-column hex piece caches: name -> ((id, stamp, rows), base ref,
#: pieces). Single-slot per column name; the base ref keeps the keyed
#: array's id from being reused while the entry lives.
_HEX_PIECES: dict[str, tuple[tuple, object, list]] = {}


def _index_pieces(n: int) -> list[bytes]:
    if len(_IDX_PIECES) < n:
        with _IDX_LOCK:
            if len(_IDX_PIECES) < n:
                _IDX_PIECES.extend(
                    b'{"index":"%d","balance":"' % i
                    for i in range(len(_IDX_PIECES), n)
                )
    return _IDX_PIECES


def _hex_pieces(name: str, mat: np.ndarray, stamp: int, prefix: bytes) -> list:
    """Per-row `prefix + hex(row)` pieces for a whole [n, w] byte column:
    ONE hexlify pass per column residency (cached on identity+stamp)."""
    import binascii

    base = mat.base if mat.base is not None else mat
    key = (id(base), stamp, int(mat.shape[0]))
    ent = _HEX_PIECES.get(name)
    if ent is not None and ent[0] == key:
        return ent[2]
    big = binascii.hexlify(np.ascontiguousarray(mat).tobytes())
    w = int(mat.shape[1]) * 2
    pieces = [prefix + big[i * w : (i + 1) * w] for i in range(mat.shape[0])]
    _HEX_PIECES[name] = (key, base, pieces)
    return pieces


def _gather(pieces: list, idx) -> list:
    if idx is None:
        return pieces
    return [pieces[i] for i in idx.tolist()]


def _join_rows(flat_zip, m: int) -> bytes:
    """b'{"data":[' + rows + envelope, as ONE join (islice drops the
    first row's leading comma)."""
    from itertools import chain, islice

    if m == 0:
        return b'{"data":[' + _ENVELOPE_TAIL
    return b"".join(
        chain(
            (b'{"data":[',),
            islice(chain.from_iterable(flat_zip), 1, None),
            (_ENVELOPE_TAIL,),
        )
    )


def _balance_pieces(balances: np.ndarray, sel) -> list:
    return list(map(b"%d".__mod__, balances[sel].tolist()))


def assemble_validators(cols, balances: np.ndarray, idx, current_epoch: int,
                        codes: np.ndarray | None) -> bytes:
    """The `/states/{id}/validators` response body, straight from the
    columns. `idx` is the gather index array (None = full table);
    `codes` reuses the full-table status codes when the filter pass
    already computed them."""
    from itertools import repeat

    from ..utils.tracing import span

    n = int(balances.shape[0])
    sel = slice(None) if idx is None else idx
    m = n if idx is None else int(idx.size)
    with span("assemble", route="validators"):
        eb = cols.effective_balance[sel]
        aee = cols.activation_eligibility_epoch[sel]
        ae = cols.activation_epoch[sel]
        ee = cols.exit_epoch[sel]
        we = cols.withdrawable_epoch[sel]
        slashed = cols.slashed[sel]
        bal = balances[sel]
        if codes is None:
            codes_g = status_codes(aee, ae, ee, we, slashed, bal, current_epoch)
        else:
            codes_g = codes[sel]
        # combo key: 5 u64 fields + (status code, slashed) packed — rows
        # sharing it share both constant row segments
        key = np.empty((m, 6), dtype="<u8")
        key[:, 0] = eb
        key[:, 1] = aee
        key[:, 2] = ae
        key[:, 3] = ee
        key[:, 4] = we
        key[:, 5] = codes_g.astype(np.uint64) * 2 + slashed.astype(np.uint64)
        uniq, first, inv = np.unique(
            key.view(np.dtype((np.void, 48))).ravel(),
            return_index=True,
            return_inverse=True,
        )
        del uniq
        seg1_pool = np.empty(first.size, dtype=object)
        seg3_pool = np.empty(first.size, dtype=object)
        for j, r in enumerate(first.tolist()):
            seg1_pool[j] = (
                b'","status":"'
                + _STATUS_BYTES[int(codes_g[r])]
                + b'","validator":{"pubkey":"0x'
            )
            seg3_pool[j] = (
                b'","effective_balance":"%d","slashed":%s,'
                b'"activation_eligibility_epoch":"%d",'
                b'"activation_epoch":"%d","exit_epoch":"%d",'
                b'"withdrawable_epoch":"%d"}}'
                % (
                    int(eb[r]),
                    b"true" if slashed[r] else b"false",
                    int(aee[r]),
                    int(ae[r]),
                    int(ee[r]),
                    int(we[r]),
                )
            )
        seg1 = seg1_pool[inv].tolist()
        seg3 = seg3_pool[inv].tolist()
        idx_pieces = _gather(_index_pieces(n), idx)
        bal_pieces = list(map(b"%d".__mod__, bal.tolist()))
        pk_pieces = _gather(
            _hex_pieces(
                "pubkey", cols.pubkeys, cols.column_stamp("pubkey"), b""
            ),
            idx,
        )
        wc_pieces = _gather(
            _hex_pieces(
                "withdrawal_credentials",
                cols.withdrawal_credentials,
                cols.column_stamp("withdrawal_credentials"),
                b'","withdrawal_credentials":"0x',
            ),
            idx,
        )
    with span("serialize", route="validators"):
        return _join_rows(
            zip(
                repeat(b","),
                idx_pieces,
                bal_pieces,
                seg1,
                pk_pieces,
                wc_pieces,
                seg3,
            ),
            m,
        )


def assemble_balances(balances: np.ndarray, idx) -> bytes:
    """The `/states/{id}/validator_balances` JSON body (reuses the index
    piece cache; a row is 4 joined pieces)."""
    from itertools import repeat

    from ..utils.tracing import span

    n = int(balances.shape[0])
    m = n if idx is None else int(idx.size)
    with span("assemble", route="validator_balances"):
        idx_pieces = _gather(_index_pieces(n), idx)
        bal_pieces = _balance_pieces(balances, slice(None) if idx is None else idx)
    with span("serialize", route="validator_balances"):
        return _join_rows(
            zip(repeat(b","), idx_pieces, bal_pieces, repeat(b'"}')),
            m,
        )


def balances_ssz(balances: np.ndarray, idx) -> bytes:
    """SSZ variant of `/validator_balances` (`Accept:
    application/octet-stream`): List[(index u64, balance u64)] — fixed
    16-byte rows, so the whole body is one interleave + tobytes with no
    per-row Python at all (the zero-copy floor of this serving tier)."""
    n = balances.shape[0]
    if idx is None:
        index_col = np.arange(n, dtype="<u8")
        bal_col = balances
    else:
        index_col = idx.astype("<u8")
        bal_col = balances[idx]
    out = np.empty((index_col.size, 2), dtype="<u8")
    out[:, 0] = index_col
    out[:, 1] = bal_col
    return out.tobytes()


def assemble_committees(cc, start_slot: int) -> str:
    """The `/states/{id}/committees` JSON body: every committee is a
    zero-copy slice of the epoch's shuffled permutation; member lists
    convert via one C-level astype per committee instead of a per-member
    `str()`."""
    rows: list[str] = []
    for slot in range(start_slot, start_slot + cc.slots_per_epoch):
        for index in range(cc.committees_per_slot):
            members = cc.committee_array(slot, index)
            vals = (
                '["' + '","'.join(members.astype("U20").tolist()) + '"]'
                if members.size
                else "[]"
            )
            rows.append(
                f'{{"index":"{index}","slot":"{slot}","validators":{vals}}}'
            )
    return '{"data":[' + ",".join(rows) + "]}"
