# lint: allow-file(safe-arith) -- retained scalar oracle, kept verbatim as
# the differential baseline for the columnar rewrite
"""Scalar proto-array fork choice — the retained differential oracle.

Counterpart of lighthouse_tpu/fork_choice/proto_array_reference.py, copied.

This is the pre-columnar implementation of `proto_array.py`, kept
verbatim (per the established reference-module pattern:
`pairing_reference`, `epoch_reference`, `process_attestations_reference`)
as the differential oracle the columnar rewrite is held to
(tests/test_torch_fork_choice.py: the same heads on every scenario).

It walks Python `ProtoNode` objects and a per-validator
`dict[int, VoteTracker]` on every `get_head` — exactly the scalar cost
shape the columnar module replaces. Do not optimize this file.
"""

from __future__ import annotations

from dataclasses import dataclass

from .proto_array import ExecutionStatus, ProtoArrayError


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int | None  # index into ProtoArray.nodes
    state_root: bytes
    justified_epoch: int
    finalized_epoch: int
    # Unrealized checkpoints ("pull-up tips", modern fork choice)
    unrealized_justified_epoch: int | None = None
    unrealized_finalized_epoch: int | None = None
    weight: int = 0
    best_child: int | None = None
    best_descendant: int | None = None
    execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT


@dataclass
class VoteTracker:
    """Latest attestation message per validator (vote_tracker in
    proto_array_fork_choice.rs)."""

    current_root: bytes = b"\x00" * 32
    next_root: bytes = b"\x00" * 32
    next_epoch: int = 0


class ProtoArrayReference:
    def __init__(self, justified_epoch: int, finalized_epoch: int):
        self.nodes: list[ProtoNode] = []
        self.indices: dict[bytes, int] = {}
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        self.finalized_root: bytes | None = None
        self.prune_threshold = 256
        # Previous proposer boost, subtracted on the next score pass
        # (the reference stores this as previous_proposer_boost).
        self._prev_boost_root: bytes = b"\x00" * 32
        self._prev_boost_amount: int = 0

    # ------------------------------------------------------------------ insert

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
        node = ProtoNode(
            slot=slot,
            root=root,
            parent=parent,
            state_root=state_root,
            justified_epoch=justified_epoch,
            finalized_epoch=finalized_epoch,
            unrealized_justified_epoch=unrealized_justified_epoch,
            unrealized_finalized_epoch=unrealized_finalized_epoch,
        )
        index = len(self.nodes)
        self.nodes.append(node)
        self.indices[root] = index
        if parent is not None:
            self._maybe_update_best_child_and_descendant(parent, index)

    # ------------------------------------------------------------------ scores

    def apply_score_changes(
        self,
        deltas: list[int],
        justified_epoch: int,
        finalized_epoch: int,
        proposer_boost_root: bytes = b"\x00" * 32,
        proposer_boost_amount: int = 0,
    ):
        """One backwards pass: add deltas, roll child weight into parent,
        refresh best_child/best_descendant (proto_array.rs
        apply_score_changes)."""
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("delta length mismatch")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        # Proposer boost is transient: undo last pass's boost, apply this
        # pass's (the reference's previous_proposer_boost bookkeeping).
        if self._prev_boost_amount:
            pi = self.indices.get(self._prev_boost_root)
            if pi is not None:
                deltas[pi] -= self._prev_boost_amount
        if proposer_boost_amount:
            bi = self.indices.get(proposer_boost_root)
            if bi is not None:
                deltas[bi] += proposer_boost_amount
        self._prev_boost_root = proposer_boost_root
        self._prev_boost_amount = proposer_boost_amount

        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            delta = deltas[i]
            node.weight += delta
            if node.weight < 0:
                raise ProtoArrayError("negative node weight")
            if node.parent is not None:
                deltas[node.parent] += delta
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child_and_descendant(node.parent, i)

    # ------------------------------------------------------------------ head

    def node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """Viability filter (node_is_viable_for_head in proto_array.rs):
        the node's (unrealized-or-realized) checkpoints must agree with the
        store's, and its payload must not be invalid."""
        if node.execution_status == ExecutionStatus.INVALID:
            return False
        j = (
            node.unrealized_justified_epoch
            if node.unrealized_justified_epoch is not None
            else node.justified_epoch
        )
        f = (
            node.unrealized_finalized_epoch
            if node.unrealized_finalized_epoch is not None
            else node.finalized_epoch
        )
        correct_justified = j >= self.justified_epoch or self.justified_epoch == 0
        correct_finalized = (
            f >= self.finalized_epoch
            or self.finalized_epoch == 0
            or self._descends_from_finalized(node)
        )
        return correct_justified and correct_finalized

    def _descends_from_finalized(self, node: ProtoNode) -> bool:
        """Whether `node` is the store's finalized root or descends from it."""
        fi = self.indices.get(self.finalized_root) if self.finalized_root is not None else None
        i = self.indices.get(node.root)
        while fi is not None and i is not None and i > fi:
            i = self.nodes[i].parent
        return fi is not None and i == fi

    def _leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self.node_is_viable_for_head(self.nodes[node.best_descendant])
        return self.node_is_viable_for_head(node)

    def _maybe_update_best_child_and_descendant(self, parent_i: int, child_i: int):
        parent = self.nodes[parent_i]
        child = self.nodes[child_i]
        child_leads_to_viable = self._leads_to_viable_head(child)

        if parent.best_child == child_i:
            if not child_leads_to_viable:
                parent.best_child = None
                parent.best_descendant = None
            else:
                self._set_best(parent, child_i)
        elif parent.best_child is None:
            if child_leads_to_viable:
                self._set_best(parent, child_i)
        else:
            best = self.nodes[parent.best_child]
            best_viable = self._leads_to_viable_head(best)
            if child_leads_to_viable and not best_viable:
                self._set_best(parent, child_i)
            elif child_leads_to_viable and (
                child.weight > best.weight
                or (child.weight == best.weight and child.root > best.root)
            ):
                # tie-break on higher root lexicographically (matches the
                # reference's deterministic tie-break)
                self._set_best(parent, child_i)

    def _set_best(self, parent: ProtoNode, child_i: int):
        child = self.nodes[child_i]
        parent.best_child = child_i
        parent.best_descendant = (
            child.best_descendant if child.best_descendant is not None else child_i
        )

    def find_head(self, justified_root: bytes) -> bytes:
        ji = self.indices.get(justified_root)
        if ji is None:
            raise ProtoArrayError(f"justified root {justified_root.hex()} unknown")
        node = self.nodes[ji]
        best = (
            self.nodes[node.best_descendant]
            if node.best_descendant is not None
            else node
        )
        if not self.node_is_viable_for_head(best):
            raise ProtoArrayError("best node is not viable for head")
        return best.root

    def get_proposer_head(
        self,
        slot: int,
        head_root: bytes,
        committee_weight: int,
        head_threshold_pct: int,
        parent_threshold_pct: int,
        slots_per_epoch: int,
    ) -> bytes | None:
        """Scalar oracle for ProtoArray.get_proposer_head: one node at a
        time over ProtoNode objects, no column reads. Same contract —
        the parent root to build on, or None to keep the head; the
        caller owns lateness/finalization/on-time conditions."""
        hi = self.indices.get(head_root)
        if hi is None:
            return None
        head = self.nodes[hi]
        if head.parent is None:
            return None
        parent = self.nodes[head.parent]
        if parent.slot + 1 != head.slot or head.slot + 1 != slot:
            return None
        if slot % slots_per_epoch == 0:
            return None
        head_j = (
            head.unrealized_justified_epoch
            if head.unrealized_justified_epoch is not None
            else head.justified_epoch
        )
        parent_j = (
            parent.unrealized_justified_epoch
            if parent.unrealized_justified_epoch is not None
            else parent.justified_epoch
        )
        if head_j != parent_j:
            return None
        head_weight = head.weight
        if self._prev_boost_root == head_root:
            head_weight = max(0, head_weight - self._prev_boost_amount)
        head_weak = head_weight < committee_weight * head_threshold_pct // 100
        parent_strong = (
            parent.weight > committee_weight * parent_threshold_pct // 100
        )
        if not (head_weak and parent_strong):
            return None
        return parent.root

    # ------------------------------------------------------------------ misc

    def ancestor_at_slot(self, root: bytes, slot: int) -> bytes | None:
        """Spec get_ancestor: the block in `root`'s chain at or before `slot`
        (walks parents; returns None if root is unknown or the walk leaves
        the array)."""
        i = self.indices.get(root)
        while i is not None:
            node = self.nodes[i]
            if node.slot <= slot:
                return node.root
            i = node.parent
        return None

    def is_descendant(self, ancestor_root: bytes, descendant_root: bytes) -> bool:
        ai = self.indices.get(ancestor_root)
        di = self.indices.get(descendant_root)
        if ai is None or di is None:
            return False
        a_slot = self.nodes[ai].slot
        i = di
        while i is not None and self.nodes[i].slot >= a_slot:
            if i == ai:
                return True
            i = self.nodes[i].parent
        return False

    def propagate_execution_payload_validity(self, root: bytes):
        """Mark a block and all its ancestors VALID (an EL VALID verdict
        implies all ancestors valid)."""
        i = self.indices.get(root)
        while i is not None:
            node = self.nodes[i]
            if node.execution_status in (
                ExecutionStatus.OPTIMISTIC,
                ExecutionStatus.VALID,
            ):
                node.execution_status = ExecutionStatus.VALID
            i = node.parent

    def invalidate_block(self, root: bytes):
        """Mark a block and all its descendants INVALID
        (on_invalid_execution_payload)."""
        start = self.indices.get(root)
        if start is None:
            return
        bad = {start}
        self.nodes[start].execution_status = ExecutionStatus.INVALID
        for i in range(start + 1, len(self.nodes)):
            if self.nodes[i].parent in bad:
                bad.add(i)
                self.nodes[i].execution_status = ExecutionStatus.INVALID
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child_and_descendant(node.parent, i)

    def maybe_prune(self, finalized_root: bytes):
        """Drop nodes before the finalized root (maybe_prune in
        proto_array.rs); keeps indices dense."""
        fi = self.indices.get(finalized_root)
        if fi is None or fi < self.prune_threshold:
            return
        keep = [
            i
            for i in range(len(self.nodes))
            if i >= fi
            and (
                self.nodes[i].root == finalized_root
                or self.is_descendant(finalized_root, self.nodes[i].root)
            )
        ]
        remap = {old: new for new, old in enumerate(keep)}
        new_nodes = []
        for old in keep:
            n = self.nodes[old]
            n.parent = remap.get(n.parent) if n.parent is not None else None
            n.best_child = remap.get(n.best_child) if n.best_child is not None else None
            n.best_descendant = (
                remap.get(n.best_descendant) if n.best_descendant is not None else None
            )
            new_nodes.append(n)
        self.nodes = new_nodes
        self.indices = {n.root: i for i, n in enumerate(self.nodes)}


class ProtoArrayForkChoiceReference:
    """Scalar proto-array + vote tracking + balance-weighted deltas
    (proto_array_fork_choice.rs) — the per-validator dict walk the
    columnar `ProtoArrayForkChoice` replaced."""

    def __init__(
        self,
        finalized_root: bytes,
        finalized_slot: int,
        finalized_state_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
    ):
        self.proto_array = ProtoArrayReference(justified_epoch, finalized_epoch)
        self.proto_array.finalized_root = finalized_root
        self.votes: dict[int, VoteTracker] = {}
        self.balances: list[int] = []
        self.proto_array.on_block(
            slot=finalized_slot,
            root=finalized_root,
            parent_root=None,
            state_root=finalized_state_root,
            justified_epoch=justified_epoch,
            finalized_epoch=finalized_epoch,
        )

    def process_attestation(
        self, validator_index: int, block_root: bytes, target_epoch: int
    ):
        vote = self.votes.setdefault(validator_index, VoteTracker())
        # Accept strictly-newer votes, or the first vote ever (epoch-0
        # attestations must land on a fresh default tracker).
        is_default = (
            vote.current_root == b"\x00" * 32
            and vote.next_root == b"\x00" * 32
            and vote.next_epoch == 0
        )
        if target_epoch > vote.next_epoch or is_default:
            vote.next_root = block_root
            vote.next_epoch = target_epoch

    def on_block(self, **kwargs):
        self.proto_array.on_block(**kwargs)

    def contains_block(self, root: bytes) -> bool:
        return root in self.proto_array.indices

    def block_slot(self, root: bytes) -> int | None:
        i = self.proto_array.indices.get(root)
        return self.proto_array.nodes[i].slot if i is not None else None

    def _compute_deltas(self, new_balances: list[int], equivocating: set[int]):
        deltas = [0] * len(self.proto_array.nodes)
        idx = self.proto_array.indices
        for vi, vote in self.votes.items():
            if vote.current_root == vote.next_root and vi not in equivocating:
                continue
            old_balance = self.balances[vi] if vi < len(self.balances) else 0
            new_balance = new_balances[vi] if vi < len(new_balances) else 0
            if vi in equivocating:
                # equivocating validators: remove their old vote forever
                ci = idx.get(vote.current_root)
                if ci is not None:
                    deltas[ci] -= old_balance
                vote.current_root = b"\x00" * 32
                vote.next_root = b"\x00" * 32
                continue
            ci = idx.get(vote.current_root)
            if ci is not None:
                deltas[ci] -= old_balance
            ni = idx.get(vote.next_root)
            if ni is not None:
                deltas[ni] += new_balance
            # Always mark applied — a pruned next_root must not leave the
            # old subtraction repeating on every later pass.
            vote.current_root = vote.next_root
        self.balances = list(new_balances)
        return deltas

    def get_head(
        self,
        justified_checkpoint_root: bytes,
        justified_epoch: int,
        finalized_epoch: int,
        justified_state_balances: list[int],
        proposer_boost_root: bytes = b"\x00" * 32,
        proposer_boost_amount: int = 0,
        equivocating_indices: set[int] | None = None,
        finalized_root: bytes | None = None,
    ) -> bytes:
        if finalized_root is not None:
            self.proto_array.finalized_root = finalized_root
        deltas = self._compute_deltas(
            justified_state_balances, equivocating_indices or set()
        )
        self.proto_array.apply_score_changes(
            deltas,
            justified_epoch,
            finalized_epoch,
            proposer_boost_root,
            proposer_boost_amount,
        )
        return self.proto_array.find_head(justified_checkpoint_root)
