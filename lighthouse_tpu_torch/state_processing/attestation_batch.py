"""Columnar attestation pipeline: vectorized block-op processing.

Counterpart of lighthouse_tpu/state_processing/attestation_batch.py, copied.

The reference batches this seam in `per_block_processing`
(consensus/state_processing/src/per_block_processing.rs:100): a block's
128 attestations are verified and applied against the same participation
lists, and the per-attester work is pure data movement. This module is
that seam as an array program over the resident registry columns
(state_processing/registry_columns):

  * every attestation is validated first (same checks, same error
    strings, same effective order as the scalar loop) — a rejected block
    raises before ANY state write;
  * attester index sets are gathers from the CommitteeCache's numpy
    permutation (`committee_array` — no Python-list committees), shared
    with indexed-attestation assembly so signature sets, fork-choice
    `on_attestation` and the slasher feed reuse the same arrays via the
    ConsensusContext memo;
  * the apply phase groups attestations by target epoch and folds each
    group with segment ops over the concatenated (validator, flag-mask,
    attestation-position) rows: one stable argsort, `bitwise_or.reduceat`
    for the combined flag set per attester, and `minimum.reduceat` per
    flag for FIRST-OCCURRENCE attribution — duplicate attesters across
    attestations resolve in block order exactly as the scalar loop does
    (the first attestation to set a flag earns its proposer reward; a
    blind OR would misattribute the per-attestation floor division);
  * the proposer-reward numerator is a vectorized dot of
    effective-balance increments (straight from the columns) with
    newly-set flag weights, floored per attestation like the spec;
  * participation writes land through `RegistryColumns.write_participation`
    with the exact scatter indices, so the tree-hash cache's sparse
    `update_rows` path re-roots a block's flags as a handful of chunk
    paths (the same contract balances follow).

The scalar loop is retained verbatim as `process_attestations_reference`
(altair.process_attestation_altair per attestation): small batches and
the `LIGHTHOUSE_TPU_BATCH_ATTESTATIONS=0` kill switch run it, and
tests/test_torch_state_transition.py holds both paths to the JAX package
on one mainnet-preset block.
"""

from __future__ import annotations

import os

import numpy as np

from ..metrics import REGISTRY
from ..utils.tracing import span
from .accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    get_current_epoch,
    get_previous_epoch,
    increase_balance,
)
from .altair import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    WEIGHT_DENOMINATOR,
    get_attestation_participation_flag_indices,
    get_base_reward_per_increment,
    process_attestation_altair,
)

# --- eager metric registration (the series exist at zero from import) ------

_BATCH_TOTAL = REGISTRY.counter(
    "attestation_batch_total",
    "block attestation batches processed, by path",
)
for _path in ("columnar", "scalar", "scalar_small"):
    _BATCH_TOTAL.inc(0, path=_path)
REGISTRY.histogram(
    "trace_span_seconds_attestation_apply",
    "span duration: attestation_apply",
)

_BIG = np.int64(1 << 62)  # first-occurrence sentinel (no attestation)

# Below this many total aggregation bits per block, the scalar loop IS
# the faster program: the vectorized fold carries ~0.2 ms of fixed numpy
# setup (argsort/reduceat/refresh round-trips) that a couple of
# two-member minimal-preset committees never amortize — the same
# calibrated-dispatch discipline as utils/sha256_batch.hash_rows. Any
# mainnet-shaped block (128 atts × ~450 attesters ≈ 57k rows) is three
# orders of magnitude past it. Counted as path="scalar_small", distinct
# from the kill switch's path="scalar" (the perf_smoke guard asserts the
# latter stays zero on the happy path).
_SMALL_BATCH_ROWS = 256


def batch_enabled() -> bool:
    """LIGHTHOUSE_TPU_BATCH_ATTESTATIONS=0 kills the columnar pipeline
    process-wide; the scalar reference loop runs instead (the oracle the
    differential suite and the bench control exercise)."""
    return os.environ.get("LIGHTHOUSE_TPU_BATCH_ATTESTATIONS") != "0"


def process_attestations_reference(
    state, attestations, spec, E, verify_signatures: bool, ctxt, fork
):
    """The retained scalar path: one `process_attestation_altair` per
    attestation (per-validator Python flag loop inside). Keep it boring —
    it is the differential oracle."""
    for att in attestations:
        process_attestation_altair(
            state, att, spec, E, verify_signatures, ctxt, fork
        )


def process_attestations(
    state, attestations, spec, E, verify_signatures: bool, ctxt, fork
):
    """Validate and apply ALL of a block's attestations (altair→electra)."""
    if not attestations:
        return
    if not batch_enabled():
        _BATCH_TOTAL.inc(path="scalar")
        process_attestations_reference(
            state, attestations, spec, E, verify_signatures, ctxt, fork
        )
        return
    if sum(len(a.aggregation_bits) for a in attestations) < _SMALL_BATCH_ROWS:
        _BATCH_TOTAL.inc(path="scalar_small")
        process_attestations_reference(
            state, attestations, spec, E, verify_signatures, ctxt, fork
        )
        return
    with span("attestation_apply", attestations=len(attestations)):
        _process_attestations_columnar(
            state, attestations, spec, E, verify_signatures, ctxt, fork
        )
    _BATCH_TOTAL.inc(path="columnar")


# ---------------------------------------------------------------------------
# Validation (no state writes — a raise leaves the state untouched)
# ---------------------------------------------------------------------------


def _validate_and_plan(
    state, attestations, spec, E, verify_signatures: bool, ctxt, fork
):
    """Per-attestation spec checks (identical conditions and error strings
    to the scalar loop), returning (picked_indices, flag_mask,
    target_is_current) plan rows in block order. Assembles/reuses the
    ConsensusContext's indexed attestations from the same arrays."""
    from ..types.chain_spec import ForkName
    from ..types.containers import build_types
    from . import signature_sets as sigsets
    from .per_block import BlockProcessingError

    t = build_types(E)
    current = get_current_epoch(state, E)
    previous = get_previous_epoch(state, E)
    plan = []
    for att in attestations:
        data = att.data
        if data.target.epoch not in (previous, current):
            raise BlockProcessingError("attestation: target epoch out of range")
        if data.target.epoch != compute_epoch_at_slot(data.slot, E):
            raise BlockProcessingError("attestation: target/slot mismatch")
        if state.slot < data.slot + E.MIN_ATTESTATION_INCLUSION_DELAY:
            raise BlockProcessingError("attestation: too early")
        if fork < ForkName.DENEB and state.slot > data.slot + E.SLOTS_PER_EPOCH:
            # EIP-7045 (Deneb) removed the one-epoch inclusion upper bound.
            raise BlockProcessingError("attestation: inclusion window")
        cc = committee_cache_at(state, data.target.epoch, E)
        if data.index >= cc.committees_per_slot:
            raise BlockProcessingError(
                "attestation: committee index out of range"
            )
        committee = cc.committee_array(data.slot, data.index)
        if len(att.aggregation_bits) != committee.size:
            raise BlockProcessingError("attestation: bitfield length mismatch")

        inclusion_delay = state.slot - data.slot
        # raises "attestation: source checkpoint mismatch" on a bad source
        flag_indices = get_attestation_participation_flag_indices(
            state, data, inclusion_delay, E, fork
        )
        flag_mask = 0
        for f in flag_indices:
            flag_mask |= 1 << f

        mask = np.asarray(att.aggregation_bits, dtype=bool)
        picked = np.sort(committee[mask])
        # is_valid_indexed_attestation without signatures: indices must be
        # non-empty; sortedness/uniqueness/bounds hold by construction
        # (the committee is a slice of the registry permutation)
        if picked.size == 0:
            raise BlockProcessingError(
                "attestation: invalid indexed attestation"
            )
        indexed = ctxt.peek_indexed_attestation(att)
        if indexed is None:
            # deserialize-style construction: every field is already in
            # coerced form (registry-permutation ints, the attestation's
            # own coerced containers/bytes), so the per-element coerce of
            # the List[uint64] field machinery is pure overhead here
            # (~half the batch pipeline's wall time at 128 attestations)
            cls = t.IndexedAttestation
            indexed = cls.__new__(cls)
            d = indexed.__dict__
            d["attesting_indices"] = picked.tolist()
            d["data"] = data
            d["signature"] = att.signature
            ctxt.set_indexed_attestation(att, indexed)
        if verify_signatures and not sigsets.indexed_attestation_signature_set(
            state, indexed, spec, E
        ).verify():
            raise BlockProcessingError(
                "attestation: invalid indexed attestation"
            )
        plan.append((picked, flag_mask, data.target.epoch == current))
    return plan


# ---------------------------------------------------------------------------
# Apply (grouped segment fold + scatter-OR + proposer-reward dot)
# ---------------------------------------------------------------------------


class _ParticipationTarget:
    """One epoch's participation flags behind a uniform array interface:
    resident column (writeback through the columns' exact-dirty store),
    persistent list without columns (load/modify/store diff), or the
    plain-bytearray in-place view."""

    def __init__(self, state, field: str, cols):
        from ..ssz.persistent import PersistentByteList

        self.state = state
        self.field = field
        self.cols = cols
        self._lst = getattr(state, field)
        if cols is not None:
            cols.refresh(state)
            self.read = getattr(cols, field)
            self._mode = "columns"
        elif isinstance(self._lst, PersistentByteList):
            self.read = self._lst.load_array()
            self._mode = "plist"
        else:  # plain bytearray: a writable zero-copy view
            self.read = np.frombuffer(self._lst, dtype=np.uint8)
            self._mode = "bytearray"

    def commit(self, uniq: np.ndarray, new_vals: np.ndarray, changed: np.ndarray):
        if changed.size == 0:
            return
        if self._mode == "columns":
            new = self.read.copy()
            new[uniq] = new_vals
            self.cols.write_participation(self.state, self.field, new, changed)
        elif self._mode == "plist":
            # never write the load_array view itself: it is a guarded
            # read surface — stage into a copy and commit via store_array
            new = self.read.copy()
            new[uniq] = new_vals
            self._lst.store_array(new, changed)
            self.read = new
        else:
            # lint: allow(cow-aliasing) -- plain-bytearray frombuffer view: the sanctioned in-place representation (no CoW sharing)
            self.read[uniq] = new_vals  # writes through into the bytearray


def _effective_balance_increments(state, cols, uniq: np.ndarray, E) -> np.ndarray:
    """[m] uint64 effective-balance increments for the given validator
    rows — straight from the resident column when attached."""
    if cols is not None:
        eb = cols.effective_balance[uniq]
    else:
        vs = state.validators
        eb = np.fromiter(
            (vs[int(i)].effective_balance for i in uniq),
            dtype=np.uint64,
            count=int(uniq.size),
        )
    return eb // np.uint64(E.EFFECTIVE_BALANCE_INCREMENT)


def _process_attestations_columnar(
    state, attestations, spec, E, verify_signatures: bool, ctxt, fork
):
    from .registry_columns import registry_columns_for

    cols = registry_columns_for(state)
    plan = _validate_and_plan(
        state, attestations, spec, E, verify_signatures, ctxt, fork
    )

    base_reward_per_increment = get_base_reward_per_increment(state, E)
    denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
        * WEIGHT_DENOMINATOR
        // PROPOSER_WEIGHT
    )
    proposer_reward = 0

    for is_current, field in (
        (False, "previous_epoch_participation"),
        (True, "current_epoch_participation"),
    ):
        group = [
            (picked, mask)
            for picked, mask, cur in plan
            if cur is is_current and picked.size
        ]
        if not group:
            continue
        target = _ParticipationTarget(state, field, cols)
        numerators = _apply_group(
            target, group, state, cols, base_reward_per_increment, E
        )
        # per-attestation floor division, exactly like the scalar loop
        # (sum-then-divide would round differently)
        proposer_reward += sum(n // denominator for n in numerators)

    increase_balance(state, ctxt.get_proposer_index(state, E), proposer_reward)


def _apply_group(
    target: _ParticipationTarget,
    group,
    state,
    cols,
    base_reward_per_increment: int,
    E,
) -> list[int]:
    """Fold one target-epoch group: combined scatter-OR into the
    participation array plus first-occurrence proposer-reward attribution.
    Returns the per-attestation reward numerators (Python ints)."""
    part = target.read
    lens = [p.size for p, _ in group]
    cat_idx = np.concatenate([p for p, _ in group])
    cat_att = np.repeat(np.arange(len(group), dtype=np.int64), lens)
    cat_mask = np.repeat(
        np.array([m for _, m in group], dtype=np.uint8), lens
    )
    # stable sort: ties (duplicate attesters) stay in block order, so
    # reduceat segments see occurrences oldest-attestation-first
    order = np.argsort(cat_idx, kind="stable")
    sidx = cat_idx[order]
    satt = cat_att[order]
    smask = cat_mask[order]
    seg = np.flatnonzero(np.r_[True, sidx[1:] != sidx[:-1]])
    uniq = sidx[seg]
    combined = np.bitwise_or.reduceat(smask, seg)
    old = part[uniq]
    newbits = combined & ~old

    ebi = _effective_balance_increments(state, cols, uniq, E)
    # u64-exactness guard (mirrors altair._REWARD_RANGE_DOC): worst-case
    # accumulated numerator per attestation is rows·max_ebi·brpi·Σweights;
    # fall back to exact per-row Python ints if it could overflow (never
    # on real parameters — needs absurd base rewards at tiny scale)
    max_ebi = int(ebi.max(initial=0))
    rows = int(cat_idx.size)
    vector_safe = (
        max_ebi * base_reward_per_increment * sum(PARTICIPATION_FLAG_WEIGHTS)
        * max(rows, 1)
    ) < (1 << 63)

    numerators = np.zeros(len(group), dtype=np.uint64)
    exact_numerators = [0] * len(group)
    for f, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        bit = np.uint8(1 << f)
        has = (smask & bit) != 0
        sel = (newbits & bit) != 0
        if not sel.any():
            continue
        # first attestation (block order) carrying flag f per attester
        first = np.minimum.reduceat(np.where(has, satt, _BIG), seg)
        if vector_safe:
            contrib = ebi[sel] * np.uint64(base_reward_per_increment * weight)
            np.add.at(numerators, first[sel], contrib)
        else:
            for pos, inc in zip(first[sel].tolist(), ebi[sel].tolist()):
                exact_numerators[pos] += (
                    inc * base_reward_per_increment * weight
                )

    new_vals = old | combined
    changed = uniq[newbits != 0]
    target.commit(uniq, new_vals, changed)
    if vector_safe:
        return [int(n) for n in numerators.tolist()]
    return exact_numerators
