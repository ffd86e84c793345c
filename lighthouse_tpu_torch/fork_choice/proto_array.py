"""Array-program proto-array fork choice DAG.

Counterpart of lighthouse_tpu/fork_choice/proto_array.py, copied.

Mirrors consensus/proto_array (proto_array.rs, proto_array_fork_choice.rs)
— a flat array of nodes in insertion order (parents before children),
vote tracking with lazy deltas, one backwards pass to apply score changes,
O(1) head lookup, pruning at finalization — but stores BOTH axes columnar:

  * the node axis as parallel numpy arrays (parent index, weight,
    justified/finalized epochs, unrealized epochs, best-child,
    best-descendant, execution status) with capacity-doubling growth —
    the layout `proto_array.rs` keeps deliberately flat so score
    application is a single linear pass;
  * the validator axis as resident vote columns
    (`current_root_index`/`next_root_index` uint32, `next_epoch` uint64)
    over an append-only root-interning table whose `rid -> node index`
    map survives pruning (pruned roots resolve to the -1 sentinel, never
    a stale index) — replacing the per-validator
    `dict[int, VoteTracker]` the scalar oracle still walks.

A round's score deltas are ONE gather + `np.add.at` scatter-add over the
old/new balance arrays (equivocating validators masked), accumulated as
separate add/subtract columns so the weight update stays in the
`safe_arith` u64 register: underflow (a negative node weight) is an
ALWAYS-ON explicit check raising ProtoArrayError before any write, and
the `add_u64`/`sub_u64` lanes additionally prove no u64 wrap under
LIGHTHOUSE_TPU_SANITIZE=1 (overflow is unreachable at realistic total
stake — ~2^55 Gwei — but the sanitizer pins the invariant). The backwards
weight roll and the best-child/best-descendant refresh stay sequential
over the (small) node axis — children after parents by construction —
while every per-validator step is an array program.

Batch vote ingestion (`process_attestation_batch`) consumes the
columnar attesting-index arrays: a drained GOSSIP_ATTESTATION batch
updates votes in one vectorized write instead of ~16k dict operations.

The pre-columnar scalar walk is retained verbatim in
`proto_array_reference.py` (the differential oracle, per the established
reference-module pattern); tests/test_torch_fork_choice.py holds the two
to the same heads.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from ..metrics import REGISTRY
from ..utils.safe_arith import add_u64, sub_u64
from ..utils.tracing import span

_ZERO_ROOT = b"\x00" * 32


class ExecutionStatus(Enum):
    """Execution-layer view of a block's payload (proto_array.rs
    ExecutionStatus): irrelevant pre-merge, optimistic until the EL verdict."""

    IRRELEVANT = "irrelevant"
    OPTIMISTIC = "optimistic"
    VALID = "valid"
    INVALID = "invalid"


#: numpy uint8 codes for the execution-status column
_ES_CODE = {
    ExecutionStatus.IRRELEVANT: 0,
    ExecutionStatus.OPTIMISTIC: 1,
    ExecutionStatus.VALID: 2,
    ExecutionStatus.INVALID: 3,
}
_ES_FROM_CODE = {v: k for k, v in _ES_CODE.items()}
_ES_INVALID = _ES_CODE[ExecutionStatus.INVALID]
_ES_OPTIMISTIC = _ES_CODE[ExecutionStatus.OPTIMISTIC]
_ES_VALID = _ES_CODE[ExecutionStatus.VALID]


class ProtoArrayError(ValueError):
    pass


_VOTES_APPLIED = REGISTRY.counter(
    "fork_choice_votes_applied_total",
    "latest-message vote updates accepted into the proto-array columns, "
    "by ingestion path",
)
for _path in ("batch", "single"):
    _VOTES_APPLIED.inc(0, path=_path)

# the get_head trace-root + child-stage histograms exist at zero from
# import (the same pattern as the epoch stages)
for _span_name in (
    "trace_span_seconds_fork_choice_get_head",
    "trace_span_seconds_delta_compute",
    "trace_span_seconds_weight_roll",
    "trace_span_seconds_best_child",
):
    REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the literal tuple above
        _span_name,
        "span duration: fork-choice get_head stage",
    )


def _update_best(parent_i, child_i, viable, weights, bc, bd, roots):
    """`_maybe_update_best_child_and_descendant` (proto_array.rs) over
    indexable column storage (-1 sentinel for None). `viable`, `weights`,
    `bc`, `bd` may be numpy arrays or plain lists — the batched refresh
    pass hands in lists for speed, the incremental on_block path hands in
    the arrays themselves."""

    def leads_to_viable(i):
        d = bd[i]
        return bool(viable[d]) if d >= 0 else bool(viable[i])

    def set_best(c):
        bc[parent_i] = c
        d = bd[c]
        bd[parent_i] = d if d >= 0 else c

    child_leads_to_viable = leads_to_viable(child_i)
    best = bc[parent_i]
    if best == child_i:
        if not child_leads_to_viable:
            bc[parent_i] = -1
            bd[parent_i] = -1
        else:
            set_best(child_i)
    elif best < 0:
        if child_leads_to_viable:
            set_best(child_i)
    else:
        best_viable = leads_to_viable(best)
        if child_leads_to_viable and not best_viable:
            set_best(child_i)
        elif child_leads_to_viable and (
            weights[child_i] > weights[best]
            or (
                weights[child_i] == weights[best]
                and roots[child_i] > roots[best]
            )
        ):
            # tie-break on higher root lexicographically (matches the
            # reference's deterministic tie-break)
            set_best(child_i)


class _LazyViable:
    """Per-index viability without materializing the whole mask — the
    incremental (single parent/child) update path."""

    __slots__ = ("pa",)

    def __init__(self, pa: "ProtoArray"):
        self.pa = pa

    def __getitem__(self, i):
        return self.pa._viable_index(int(i))


class ProtoArray:
    def __init__(self, justified_epoch: int, finalized_epoch: int):
        self.indices: dict[bytes, int] = {}
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        #: the store's finalized checkpoint root: a node descending from it
        #: is viable whatever finalized epoch its own state records (spec
        #: filter_block_tree's correct_finalized)
        self.finalized_root: bytes | None = None
        self.prune_threshold = 256
        # Previous proposer boost, subtracted on the next score pass
        # (the reference stores this as previous_proposer_boost).
        self._prev_boost_root: bytes = _ZERO_ROOT
        self._prev_boost_amount: int = 0
        # -- node-axis columns (parallel arrays, [cap], first _n live) --
        self._n = 0
        cap = 64
        self._roots: list[bytes] = []
        self._state_roots: list[bytes] = []
        self._slots = np.zeros(cap, dtype=np.int64)
        self._parents = np.full(cap, -1, dtype=np.int64)
        self._je = np.zeros(cap, dtype=np.int64)
        self._fe = np.zeros(cap, dtype=np.int64)
        # unrealized checkpoints: -1 encodes "not set" (falls back to the
        # realized epoch in the viability filter)
        self._uje = np.full(cap, -1, dtype=np.int64)
        self._ufe = np.full(cap, -1, dtype=np.int64)
        self._weights = np.zeros(cap, dtype=np.uint64)
        self._best_child = np.full(cap, -1, dtype=np.int64)
        self._best_desc = np.full(cap, -1, dtype=np.int64)
        self._exec = np.zeros(cap, dtype=np.uint8)
        # -- vote-root interning (validator columns point at rids, not
        # node indexes: rids are stable across pruning; the rid->node map
        # is re-shifted on prune with -1 for dropped roots, and rids no
        # longer referenced by any vote column or live node are compacted
        # away through the registered owner — without that, a long-lived
        # node would leak one entry per root ever voted for) --
        self._root_ids: dict[bytes, int] = {_ZERO_ROOT: 0}
        self._n_rids = 1
        self._rid_to_node = np.full(64, -1, dtype=np.int64)
        #: the ProtoArrayForkChoice owning the validator vote columns;
        #: prune asks it which rids are live and hands it the rid remap
        self._vote_columns = None

    def __len__(self) -> int:
        return self._n

    # ------------------------------------------------------------------ insert

    def _grow_nodes(self):
        cap = max(64, 2 * len(self._slots))
        for name in (
            "_slots",
            "_parents",
            "_je",
            "_fe",
            "_uje",
            "_ufe",
            "_weights",
            "_best_child",
            "_best_desc",
            "_exec",
        ):
            old = getattr(self, name)
            fill = -1 if old.dtype == np.int64 and name != "_slots" else 0
            new = np.full(cap, fill, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)

    def on_block(
        self,
        slot: int,
        root: bytes,
        parent_root: bytes | None,
        state_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
        unrealized_justified_epoch: int | None = None,
        unrealized_finalized_epoch: int | None = None,
        execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT,
    ):
        if root in self.indices:
            return
        parent = self.indices.get(parent_root) if parent_root is not None else None
        index = self._n
        if index >= len(self._slots):
            self._grow_nodes()
        self._roots.append(root)
        self._state_roots.append(state_root)
        self._slots[index] = slot
        self._parents[index] = -1 if parent is None else parent
        self._je[index] = justified_epoch
        self._fe[index] = finalized_epoch
        self._uje[index] = (
            -1 if unrealized_justified_epoch is None else unrealized_justified_epoch
        )
        self._ufe[index] = (
            -1 if unrealized_finalized_epoch is None else unrealized_finalized_epoch
        )
        self._weights[index] = 0
        self._best_child[index] = -1
        self._best_desc[index] = -1
        self._exec[index] = _ES_CODE[execution_status]
        self._n = index + 1
        self.indices[root] = index
        # a root voted for before its block arrived (or re-added after a
        # prune) must resolve to the live node again
        rid = self._root_ids.get(root)
        if rid is not None:
            self._rid_to_node[rid] = index
        if parent is not None:
            _update_best(
                parent,
                index,
                _LazyViable(self),
                self._weights,
                self._best_child,
                self._best_desc,
                self._roots,
            )

    # ------------------------------------------------------- vote interning

    def vote_root_id(self, root: bytes) -> int:
        """Intern a vote target root: a stable uint32 id for the validator
        columns. Ids never move; the id->node map is refreshed on prune
        and on (re-)insertion of the root's block."""
        rid = self._root_ids.get(root)
        if rid is None:
            rid = self._n_rids
            if rid >= len(self._rid_to_node):
                new = np.full(2 * len(self._rid_to_node), -1, dtype=np.int64)
                new[: self._n_rids] = self._rid_to_node[: self._n_rids]
                self._rid_to_node = new
            self._root_ids[root] = rid
            self._rid_to_node[rid] = self.indices.get(root, -1)
            self._n_rids = rid + 1
        return rid

    # ------------------------------------------------------------------ scores

    def apply_score_changes(
        self,
        deltas: list[int],
        justified_epoch: int,
        finalized_epoch: int,
        proposer_boost_root: bytes = _ZERO_ROOT,
        proposer_boost_amount: int = 0,
    ):
        """Scalar-compat entry (signed per-node deltas): split into the
        add/subtract columns and run the array pass."""
        if len(deltas) != self._n:
            raise ProtoArrayError("delta length mismatch")
        d = np.asarray(deltas, dtype=np.int64)
        pos = np.where(d > 0, d, 0).astype(np.uint64)
        neg = np.where(d < 0, -d, 0).astype(np.uint64)
        self.apply_score_changes_arrays(
            pos,
            neg,
            justified_epoch,
            finalized_epoch,
            proposer_boost_root,
            proposer_boost_amount,
        )

    def apply_score_changes_arrays(
        self,
        pos: np.ndarray,
        neg: np.ndarray,
        justified_epoch: int,
        finalized_epoch: int,
        proposer_boost_root: bytes = _ZERO_ROOT,
        proposer_boost_amount: int = 0,
    ):
        """One backwards pass over the node columns: roll child deltas
        into parents (children after parents in insertion order, so the
        roll is a single linear sweep), apply them to the weight column
        through the checked u64 helpers, refresh best_child /
        best_descendant (proto_array.rs apply_score_changes). `pos`/`neg`
        are uint64 add/subtract accumulators, [n] each; both are consumed
        (mutated) by this call."""
        n = self._n
        if len(pos) != n or len(neg) != n:
            raise ProtoArrayError("delta length mismatch")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        # Proposer boost is transient: undo last pass's boost, apply this
        # pass's (the reference's previous_proposer_boost bookkeeping).
        if self._prev_boost_amount:
            pi = self.indices.get(self._prev_boost_root)
            if pi is not None:
                neg[pi] = add_u64(neg[pi], self._prev_boost_amount)
        if proposer_boost_amount:
            bi = self.indices.get(proposer_boost_root)
            if bi is not None:
                pos[bi] = add_u64(pos[bi], proposer_boost_amount)
        self._prev_boost_root = proposer_boost_root
        self._prev_boost_amount = proposer_boost_amount

        with span("weight_roll"):
            # subtree accumulation over python ints (no intermediate wrap
            # regardless of magnitude), then ONE checked u64 column update:
            # weight' = (weight + pos) - neg, with underflow = the scalar
            # oracle's "negative node weight" error, checked explicitly
            pos_l = pos.tolist()
            neg_l = neg.tolist()
            parents = self._parents[:n].tolist()
            for i in range(n - 1, 0, -1):
                p = parents[i]
                if p >= 0:
                    pos_l[p] += pos_l[i]
                    neg_l[p] += neg_l[i]
            pos_t = np.asarray(pos_l, dtype=np.uint64)
            neg_t = np.asarray(neg_l, dtype=np.uint64)
            total = add_u64(self._weights[:n], pos_t)
            if bool((total < neg_t).any()):
                raise ProtoArrayError("negative node weight")
            self._weights[:n] = sub_u64(total, neg_t)

        with span("best_child"):
            self._refresh_best_children()

    # ------------------------------------------------------------------ head

    def _viability_mask(self) -> np.ndarray:
        """Vectorized node_is_viable_for_head over all live nodes: the
        (unrealized-or-realized) checkpoints must agree with the store's,
        and the payload must not be invalid. A node whose finalized epoch
        is below the store's is still viable when it descends from the
        store's finalized root (a block on a non-genesis anchor)."""
        n = self._n
        uje = self._uje[:n]
        ufe = self._ufe[:n]
        j = np.where(uje >= 0, uje, self._je[:n])
        f = np.where(ufe >= 0, ufe, self._fe[:n])
        ok_j = (j >= self.justified_epoch) | (self.justified_epoch == 0)
        ok_f = (f >= self.finalized_epoch) | (self.finalized_epoch == 0)
        if not ok_f.all():
            ok_f = ok_f | self._finalized_descendants()
        return (self._exec[:n] != _ES_INVALID) & ok_j & ok_f

    def _finalized_descendants(self) -> np.ndarray:
        """Which live nodes are the finalized root or descend from it
        (parents precede their children in the node axis)."""
        n = self._n
        out = np.zeros(n, dtype=bool)
        fi = self.indices.get(self.finalized_root) if self.finalized_root is not None else None
        if fi is None:
            return out
        out[fi] = True
        parents = self._parents[:n].tolist()
        for i in range(fi + 1, n):
            p = parents[i]
            if p >= 0 and out[p]:
                out[i] = True
        return out

    def _descends_from_finalized(self, i: int) -> bool:
        fi = self.indices.get(self.finalized_root) if self.finalized_root is not None else None
        if fi is None:
            return False
        while i > fi:
            i = int(self._parents[i])
        return i == fi

    def _viable_index(self, i: int) -> bool:
        if self._exec[i] == _ES_INVALID:
            return False
        uje = int(self._uje[i])
        ufe = int(self._ufe[i])
        j = uje if uje >= 0 else int(self._je[i])
        f = ufe if ufe >= 0 else int(self._fe[i])
        correct_justified = j >= self.justified_epoch or self.justified_epoch == 0
        correct_finalized = (
            f >= self.finalized_epoch
            or self.finalized_epoch == 0
            or self._descends_from_finalized(i)
        )
        return correct_justified and correct_finalized

    def _refresh_best_children(self):
        """Backwards best-child/best-descendant pass. Viability is ONE
        vectorized mask; the walk itself is sequential over the (small)
        node axis — a child's best_descendant must already reflect this
        pass when its parent is visited, which backwards insertion order
        guarantees."""
        n = self._n
        if n <= 1:
            return
        viable = self._viability_mask().tolist()
        parents = self._parents[:n].tolist()
        weights = self._weights[:n].tolist()
        bc = self._best_child[:n].tolist()
        bd = self._best_desc[:n].tolist()
        roots = self._roots
        for i in range(n - 1, 0, -1):
            p = parents[i]
            if p >= 0:
                _update_best(p, i, viable, weights, bc, bd, roots)
        self._best_child[:n] = bc
        self._best_desc[:n] = bd

    def node_is_viable_for_head_at(self, index: int) -> bool:
        """Index-addressed viability (the scalar oracle's
        node_is_viable_for_head took a ProtoNode)."""
        return self._viable_index(index)

    def find_head(self, justified_root: bytes) -> bytes:
        ji = self.indices.get(justified_root)
        if ji is None:
            raise ProtoArrayError(f"justified root {justified_root.hex()} unknown")
        bd = int(self._best_desc[ji])
        best = bd if bd >= 0 else ji
        if not self._viable_index(best):
            raise ProtoArrayError("best node is not viable for head")
        return self._roots[best]

    def get_proposer_head(
        self,
        slot: int,
        head_root: bytes,
        committee_weight: int,
        head_threshold_pct: int,
        parent_threshold_pct: int,
        slots_per_epoch: int,
    ) -> bytes | None:
        """The structural/weight half of spec `get_proposer_head`
        (proto_array_fork_choice.rs `proposer_head_info`): the parent
        root to build on instead of `head_root`, or None to keep the
        head. The caller (ForkChoice/chain layer) owns the remaining
        conditions — head lateness, finalization distance, and
        proposing-on-time — because they live outside the array.

        Weights must be fresh from the last `get_head` pass; this method
        deliberately does NOT rerun it (the boost bookkeeping in
        apply_score_changes is stateful). If the last pass applied a
        proposer boost to the head, it is backed out here so the head is
        judged on attestation weight alone."""
        hi = self.indices.get(head_root)
        if hi is None:
            return None
        pi = int(self._parents[hi])
        if pi < 0:
            return None
        head_slot = int(self._slots[hi])
        parent_slot = int(self._slots[pi])
        # single-slot re-org only: head is its parent's immediate
        # successor and we propose the very next slot — deeper re-orgs
        # risk splitting the vote
        if parent_slot + 1 != head_slot or head_slot + 1 != int(slot):
            return None
        # shuffling stability: a re-org across an epoch boundary changes
        # the proposer shuffling the rest of the network computed
        if int(slot) % int(slots_per_epoch) == 0:
            return None
        # FFG competitiveness: the parent's chain must justify the same
        # epoch the head's does, or the re-org block could lose the FFG
        # race it would otherwise have won through the head
        uje = self._uje
        je = self._je
        head_j = int(uje[hi]) if int(uje[hi]) >= 0 else int(je[hi])
        parent_j = int(uje[pi]) if int(uje[pi]) >= 0 else int(je[pi])
        if head_j != parent_j:
            return None
        head_weight = int(self._weights[hi])
        if self._prev_boost_root == head_root:
            # saturating: Python ints don't wrap, but the boost may
            # exceed the attestation weight of a genuinely weak head
            head_weight = max(0, head_weight - int(self._prev_boost_amount))
        parent_weight = int(self._weights[pi])
        cw = int(committee_weight)
        head_weak = head_weight < cw * int(head_threshold_pct) // 100
        parent_strong = parent_weight > cw * int(parent_threshold_pct) // 100
        if not (head_weak and parent_strong):
            return None
        return self._roots[pi]

    # ------------------------------------------------------------------ misc

    def block_slot_at(self, index: int) -> int:
        return int(self._slots[index])

    def execution_status_of(self, root: bytes) -> ExecutionStatus | None:
        i = self.indices.get(root)
        return _ES_FROM_CODE[int(self._exec[i])] if i is not None else None

    def ancestor_at_slot(self, root: bytes, slot: int) -> bytes | None:
        """Spec get_ancestor: the block in `root`'s chain at or before `slot`
        (walks parents; returns None if root is unknown or the walk leaves
        the array)."""
        i = self.indices.get(root)
        if i is None:
            return None
        slots = self._slots
        parents = self._parents
        while i >= 0:
            if slots[i] <= slot:
                return self._roots[i]
            i = int(parents[i])
        return None

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        ai = self.indices.get(ancestor_root)
        di = self.indices.get(descendant_root)
        if ai is None or di is None:
            return False
        slots = self._slots
        parents = self._parents
        a_slot = slots[ai]
        i = di
        while i >= 0 and slots[i] >= a_slot:
            if i == ai:
                return True
            i = int(parents[i])
        return False

    def propagate_execution_payload_validity(self, root: bytes):
        """Mark a block and all its ancestors VALID (an EL VALID verdict
        implies all ancestors valid)."""
        i = self.indices.get(root)
        while i is not None and i >= 0:
            if self._exec[i] in (_ES_OPTIMISTIC, _ES_VALID):
                self._exec[i] = _ES_VALID
            i = int(self._parents[i])

    def invalidate_block(self, root: bytes):
        """Mark a block and all its descendants INVALID
        (on_invalid_execution_payload): one forward descendant-mask pass
        (children after parents), then a full best-child refresh."""
        start = self.indices.get(root)
        if start is None:
            return
        n = self._n
        parents = self._parents[:n].tolist()
        bad = np.zeros(n, dtype=bool)
        bad[start] = True
        for i in range(start + 1, n):
            p = parents[i]
            if p >= 0 and bad[p]:
                bad[i] = True
        self._exec[:n][bad] = _ES_INVALID
        self._refresh_best_children()

    def maybe_prune(self, finalized_root: bytes):
        """Drop nodes before the finalized root (maybe_prune in
        proto_array.rs); keeps indices dense. The remap is one vectorized
        index shift per pointer column (gather through a remap table, -1
        sentinel for dropped targets) — including the vote-root map, so
        votes referencing pruned roots resolve to the sentinel, never a
        stale index."""
        fi = self.indices.get(finalized_root)
        if fi is None or fi < self.prune_threshold:
            return
        n = self._n
        # descendant mask: one forward pass (children after parents)
        parents_l = self._parents[:n].tolist()
        desc = np.zeros(n, dtype=bool)
        desc[fi] = True
        for i in range(fi + 1, n):
            p = parents_l[i]
            if p >= 0 and desc[p]:
                desc[i] = True
        keep = np.nonzero(desc)[0]
        k = keep.size
        remap = np.full(n, -1, dtype=np.int64)
        remap[keep] = np.arange(k, dtype=np.int64)

        def _shift(col: np.ndarray) -> np.ndarray:
            old = col[keep]
            # fancy-index through the remap table; -1 rows read remap[-1]
            # (garbage) and are overwritten by the sentinel mask
            shifted = remap[old]
            return np.where(old >= 0, shifted, -1)

        self._parents[:k] = _shift(self._parents[:n])
        self._best_child[:k] = _shift(self._best_child[:n])
        self._best_desc[:k] = _shift(self._best_desc[:n])
        for name in ("_slots", "_je", "_fe", "_uje", "_ufe", "_weights", "_exec"):
            col = getattr(self, name)
            col[:k] = col[keep]
        keep_l = keep.tolist()
        self._roots = [self._roots[i] for i in keep_l]
        self._state_roots = [self._state_roots[i] for i in keep_l]
        self.indices = {r: i for i, r in enumerate(self._roots)}
        self._n = k
        # vote-root map: pruned roots resolve to -1 from here on
        m = self._n_rids
        old_map = self._rid_to_node[:m]
        shifted = remap[np.where(old_map >= 0, old_map, 0)]
        new_map = np.where(old_map >= 0, shifted, -1)
        owner = self._vote_columns
        if owner is None:
            self._rid_to_node[:m] = new_map
            return
        # compact the intern table: keep rid 0 (zero root), every rid a
        # vote column still references, and every rid whose root survived
        # the prune; everything else is unreachable — drop it and re-shift
        # the columns through the rid remap (vectorized, like the node
        # pointer columns above)
        live = owner._live_rid_mask(m)
        live[0] = True
        live |= new_map >= 0
        if bool(live.all()):
            self._rid_to_node[:m] = new_map
            return
        kept = int(np.count_nonzero(live))
        rid_remap = np.zeros(m, dtype=np.int64)  # dead rids -> 0, unreferenced
        rid_remap[live] = np.arange(kept, dtype=np.int64)
        self._rid_to_node[:kept] = new_map[live]
        self._n_rids = kept
        self._root_ids = {
            root: int(rid_remap[rid])
            for root, rid in self._root_ids.items()
            if live[rid]
        }
        owner._remap_rids(rid_remap)


def _sized_u64(arr: np.ndarray, m: int) -> np.ndarray:
    """`arr` truncated or zero-padded to m rows (the scalar oracle's
    `x[vi] if vi < len(x) else 0` bound, vectorized)."""
    if len(arr) == m:
        return arr
    if len(arr) > m:
        return arr[:m]
    out = np.zeros(m, dtype=np.uint64)
    out[: len(arr)] = arr
    return out


class ProtoArrayForkChoice:
    """Proto-array + resident vote columns + balance-weighted deltas
    (proto_array_fork_choice.rs), fully columnar: see the module
    docstring. The scalar oracle lives in `proto_array_reference`."""

    def __init__(
        self,
        finalized_root: bytes,
        finalized_slot: int,
        finalized_state_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
    ):
        self.proto_array = ProtoArray(justified_epoch, finalized_epoch)
        self.proto_array.finalized_root = finalized_root
        # validator-axis vote columns; length = allocated capacity, a row
        # of (0, 0, 0) is "never voted" (rid 0 = the zero root)
        self._cur_rid = np.zeros(0, dtype=np.uint32)
        self._next_rid = np.zeros(0, dtype=np.uint32)
        self._next_epoch = np.zeros(0, dtype=np.uint64)
        # balances applied on the LAST score pass, held as a uint64 array
        # (copied only when the caller hands over a genuinely new vector —
        # the scalar oracle re-copied the full list on every get_head)
        self._balances = np.zeros(0, dtype=np.uint64)
        # prune-time rid compaction asks these columns what is live
        self.proto_array._vote_columns = self
        self.proto_array.on_block(
            slot=finalized_slot,
            root=finalized_root,
            parent_root=None,
            state_root=finalized_state_root,
            justified_epoch=justified_epoch,
            finalized_epoch=finalized_epoch,
        )

    # ------------------------------------------------------------------ votes

    @property
    def balances(self) -> np.ndarray:
        return self._balances

    def _grow_validators(self, m: int):
        cur = len(self._cur_rid)
        if m <= cur:
            return
        cap = max(64, cur)
        while cap < m:
            cap *= 2
        for name in ("_cur_rid", "_next_rid", "_next_epoch"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            new[:cur] = old
            setattr(self, name, new)

    def _live_rid_mask(self, m: int) -> np.ndarray:
        """[m] bool: rids some validator's current/next vote references
        (never-voted rows reference rid 0, which stays live anyway)."""
        mask = np.zeros(m, dtype=bool)
        mask[self._cur_rid] = True
        mask[self._next_rid] = True
        return mask

    def _remap_rids(self, rid_remap: np.ndarray):
        """Prune-time rid compaction: shift both vote columns through the
        remap table (every referenced rid is live by construction, so the
        gather is exact; dead slots map to 0 and are never read)."""
        self._cur_rid = rid_remap[self._cur_rid].astype(np.uint32)
        self._next_rid = rid_remap[self._next_rid].astype(np.uint32)

    def process_attestation(
        self, validator_index: int, block_root: bytes, target_epoch: int
    ):
        """Single-vote ingestion (the aggregate / block path)."""
        self._grow_validators(validator_index + 1)
        rid = self.proto_array.vote_root_id(block_root)
        vi = validator_index
        # Accept strictly-newer votes, or the first vote ever (epoch-0
        # attestations must land on a fresh default tracker).
        is_default = (
            self._cur_rid[vi] == 0
            and self._next_rid[vi] == 0
            and self._next_epoch[vi] == 0
        )
        if target_epoch > self._next_epoch[vi] or is_default:
            self._next_rid[vi] = rid
            self._next_epoch[vi] = target_epoch
            _VOTES_APPLIED.inc(path="single")

    def process_attestation_batch(
        self, validator_indices, block_root: bytes, target_epoch: int
    ):
        """Batch vote ingestion: one vectorized accept-mask + write for a
        whole attesting-index array (the drained-gossip-batch entry; the
        columnar `attesting_indices_array` is the natural input)."""
        v = np.asarray(validator_indices, dtype=np.int64)
        if v.size == 0:
            return
        self._grow_validators(int(v.max()) + 1)
        rid = self.proto_array.vote_root_id(block_root)
        is_default = (
            (self._cur_rid[v] == 0)
            & (self._next_rid[v] == 0)
            & (self._next_epoch[v] == 0)
        )
        accept = (np.uint64(target_epoch) > self._next_epoch[v]) | is_default
        tv = v[accept]
        if tv.size:
            self._next_rid[tv] = rid
            self._next_epoch[tv] = target_epoch
            _VOTES_APPLIED.inc(int(tv.size), path="batch")

    # ------------------------------------------------------------------ blocks

    def on_block(self, **kwargs):
        self.proto_array.on_block(**kwargs)

    def contains_block(self, root: bytes) -> bool:
        return root in self.proto_array.indices

    def block_slot(self, root: bytes) -> int | None:
        i = self.proto_array.indices.get(root)
        return self.proto_array.block_slot_at(i) if i is not None else None

    # ------------------------------------------------------------------ deltas

    def _compute_deltas(self, new_balances, equivocating: set[int]):
        """A round's score deltas as two uint64 scatter-add columns
        (add / subtract, so the weight update stays checked u64): gather
        each changed vote's old/new node index through the rid map, ONE
        `np.add.at` per side. Equivocating validators only ever subtract
        (their old vote is removed forever and the columns reset to the
        zero root), exactly the scalar oracle's semantics — including
        skipping unchanged votes even when balances moved."""
        pa = self.proto_array
        n = pa._n
        pos = np.zeros(n, dtype=np.uint64)
        neg = np.zeros(n, dtype=np.uint64)
        m = len(self._cur_rid)
        nb = np.asarray(new_balances, dtype=np.uint64)
        if m:
            cur = self._cur_rid
            nxt = self._next_rid
            changed = cur != nxt
            eq = None
            if equivocating:
                eq = np.fromiter(
                    equivocating, dtype=np.int64, count=len(equivocating)
                )
                eq = eq[eq < m]
            old_b = _sized_u64(self._balances, m)
            new_b = _sized_u64(nb, m)
            rid_map = pa._rid_to_node
            if eq is not None and eq.size:
                eq_mask = np.zeros(m, dtype=bool)
                eq_mask[eq] = True
                sub_i = np.nonzero(changed | eq_mask)[0]
                add_i = np.nonzero(changed & ~eq_mask)[0]
            else:
                sub_i = np.nonzero(changed)[0]
                add_i = sub_i
            if sub_i.size:
                cn = rid_map[cur[sub_i]]
                valid = cn >= 0
                np.add.at(neg, cn[valid], old_b[sub_i[valid]])
            if add_i.size:
                nn = rid_map[nxt[add_i]]
                valid = nn >= 0
                np.add.at(pos, nn[valid], new_b[add_i[valid]])
                # mark applied — a pruned next_root must not leave the old
                # subtraction repeating on every later pass
                self._cur_rid[add_i] = nxt[add_i]
            if eq is not None and eq.size:
                self._cur_rid[eq] = 0
                self._next_rid[eq] = 0
        self._balances = nb
        return pos, neg

    # ------------------------------------------------------------------ head

    def get_head(
        self,
        justified_checkpoint_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
        justified_state_balances,
        proposer_boost_root: bytes = _ZERO_ROOT,
        proposer_boost_amount: int = 0,
        equivocating_indices: set[int] | None = None,
        finalized_root: bytes | None = None,
    ) -> bytes:
        if finalized_root is not None:
            self.proto_array.finalized_root = finalized_root
        with span("fork_choice_get_head", nodes=self.proto_array._n):
            with span("delta_compute"):
                pos, neg = self._compute_deltas(
                    justified_state_balances, equivocating_indices or set()
                )
            self.proto_array.apply_score_changes_arrays(
                pos,
                neg,
                justified_epoch,
                finalized_epoch,
                proposer_boost_root,
                proposer_boost_amount,
            )
            return self.proto_array.find_head(justified_checkpoint_root)
