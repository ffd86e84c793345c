"""Data-availability checker: Deneb blobs + PeerDAS data columns.

Counterpart of lighthouse_tpu/beacon_chain/data_availability.py, copied.
Its `kzg` is the port's crypto.kzg.Kzg, whose engine runs the K8, K9 and
K4 kernels on the card by default.

Mirrors beacon_node/beacon_chain/src/data_availability_checker.rs: a block
with blob KZG commitments may only be imported once its data is provably
available. Pending components are held per block root until the block
imports (the overflow-LRU analog is a plain dict pruned at finalization —
single-process scope).

Two availability routes (the PeerDAS transition shape):
  * **full blobs** — every commitment has a matching KZG-verified
    BlobSidecar (the pre-PeerDAS path, unchanged);
  * **columns** — KZG-verified `DataColumnSidecar`s: all of this node's
    CUSTODY columns present AND the per-slot sampling verdict positive
    (`set_sampling_result`), OR >=50% of all columns present, in which
    case `das.recover_matrix` reconstructs the full matrix and the block
    is promoted to full availability with a complete rebuilt column set
    (reconstruction needs no re-verification: >=50% verified columns pin
    a unique degree-<n polynomial per blob row).

Error taxonomy (gossip downscoring depends on it):
  * `MissingComponentsError` — components absent or locally unverifiable;
    spec IGNORE class. NEVER attributable to a forwarder: a block whose
    sidecars haven't arrived, an unconfigured KZG engine. Forwarders must
    not be penalized for these.
  * `InvalidComponentsError` — proven-invalid data; spec REJECT class:
    failed KZG proof, broken inclusion proof, header not rooting to the
    claimed block, commitment mismatch in freshly delivered sidecars.
Both subclass `AvailabilityCheckError` so pre-taxonomy callers keep
working. A commitment mismatch discovered for PREVIOUSLY staged sidecars
(at `put_block` time) drops the poisoned indices and reports unavailable
— the block forwarder is innocent of a third party's earlier poisoning.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class AvailabilityCheckError(ValueError):
    pass


class MissingComponentsError(AvailabilityCheckError):
    """IGNORE class: not proven invalid — never penalize a forwarder."""


class InvalidComponentsError(AvailabilityCheckError):
    """REJECT class: proven invalid — attributable to the forwarder."""


@dataclass
class PendingComponents:
    block: object | None = None
    blobs: dict[int, object] = field(default_factory=dict)
    columns: dict[int, object] = field(default_factory=dict)
    #: per-slot sampling verdict (None until the SamplingEngine reports)
    sampling_ok: bool | None = None
    inserted_at_slot: int = 0


@dataclass
class Availability:
    """Import decision: available (block + verified blobs and/or columns)
    or pending more components."""

    available: bool
    block: object | None = None
    blobs: list | None = None
    #: column sidecars to persist when availability came via the column
    #: route (full set after reconstruction; custody subset otherwise)
    columns: list | None = None


class DataAvailabilityChecker:
    #: staged component sets are bounded (each can hold MAX_BLOBS × 128KiB;
    #: a flood of unique roots must not grow memory without bound)
    MAX_PENDING = 64

    def __init__(self, kzg, E, custody=None):
        self.kzg = kzg
        self.E = E
        #: this node's custody column set (None → column route requires
        #: the >=50% reconstruction threshold; set by the network layer
        #: from the node id via das.custody_columns)
        self.custody_columns = tuple(custody) if custody is not None else None
        self._pending: dict[bytes, PendingComponents] = {}
        #: finalization watermark (prune_before): components for slots
        #: behind it are refused, so an in-flight sampling fetch racing the
        #: finality prune cannot resurrect a pruned entry
        self._finalized_slot = 0

    def set_custody(self, columns) -> None:
        self.custody_columns = tuple(columns)

    def _bounded_entry(self, block_root: bytes) -> PendingComponents:
        pend = self._pending.get(block_root)
        if pend is None:
            if len(self._pending) >= self.MAX_PENDING:
                # evict blob-only entries first: an entry holding a staged
                # BLOCK is one sidecar away from import and gossip dedup
                # means nobody will re-send that block
                blockless = [
                    r for r, p in self._pending.items() if p.block is None
                ]
                pool = blockless or list(self._pending)
                oldest = min(
                    pool, key=lambda r: self._pending[r].inserted_at_slot
                )
                self._pending.pop(oldest)
            pend = PendingComponents()
            self._pending[block_root] = pend
        return pend

    # -- sidecar verification -------------------------------------------------

    def verify_blob_sidecars(
        self, sidecars: list, block_root: bytes, skip_kzg: bool = False
    ) -> None:
        """KZG-batch-verify sidecars for one block (gossip + RPC path).
        `skip_kzg=True` keeps the structural/binding checks but trusts the
        proofs — the chain's segment path batch-verifies a whole segment's
        blobs in one RLC upstream."""
        if not sidecars:
            return
        if self.kzg is None:
            raise MissingComponentsError("no KZG engine configured")
        blobs, commitments, proofs = [], [], []
        for sc in sidecars:
            if int(sc.index) >= self.E.MAX_BLOBS_PER_BLOCK:
                raise InvalidComponentsError(
                    f"blob index {sc.index} out of range"
                )
            header = getattr(sc, "signed_block_header", None)
            if header is not None:
                if header.message.hash_tree_root() != block_root:
                    raise InvalidComponentsError(
                        "sidecar header does not root to this block"
                    )
                if getattr(sc, "kzg_commitment_inclusion_proof", None):
                    from ..ssz.merkle_proof import verify_blob_inclusion_proof

                    if not verify_blob_inclusion_proof(sc, self.E):
                        raise InvalidComponentsError(
                            f"blob {sc.index}: invalid commitment inclusion proof"
                        )
            blobs.append(bytes(sc.blob))
            commitments.append(bytes(sc.kzg_commitment))
            proofs.append(bytes(sc.kzg_proof))
        if skip_kzg:
            return
        if not self.kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs):
            raise InvalidComponentsError("blob KZG batch verification failed")

    def verify_column_sidecars(self, sidecars: list, block_root: bytes) -> None:
        """Structural + batched-KZG gate for data columns (das.sidecar):
        header binding first (a third party must not poison another
        block's pending set), then one RLC over every cell."""
        if not sidecars:
            return
        if self.kzg is None:
            raise MissingComponentsError("no KZG engine configured")
        for sc in sidecars:
            header = getattr(sc, "signed_block_header", None)
            if header is not None and header.message.hash_tree_root() != block_root:
                raise InvalidComponentsError(
                    "column sidecar header does not root to this block"
                )
        from ..das import verify_data_column_sidecars

        try:
            verify_data_column_sidecars(sidecars, self.kzg, self.E)
        except ValueError as e:
            raise InvalidComponentsError(f"data columns rejected: {e}") from e

    # -- component accumulation -----------------------------------------------

    def _behind_finality(self, sidecars: list) -> bool:
        """True when the sidecars' bound header slot is behind the finality
        watermark — nothing at such a slot can ever import, so staging it
        would only resurrect entries the finality prune already dropped."""
        for sc in sidecars:
            header = getattr(sc, "signed_block_header", None)
            if header is not None:
                return int(header.message.slot) < self._finalized_slot
        return False

    def put_blobs(
        self,
        block_root: bytes,
        sidecars: list,
        slot: int = 0,
        pre_verified: bool = False,
    ) -> Availability:
        self.verify_blob_sidecars(sidecars, block_root, skip_kzg=pre_verified)
        if self._behind_finality(sidecars):
            return Availability(available=False)
        pend = self._bounded_entry(block_root)
        pend.inserted_at_slot = max(pend.inserted_at_slot, slot)
        new_indices = set()
        for sc in sidecars:
            pend.blobs[int(sc.index)] = sc
            new_indices.add(int(sc.index))
        return self.check_availability(block_root, new_indices=new_indices)

    def put_columns(
        self, block_root: bytes, sidecars: list, slot: int = 0
    ) -> Availability:
        self.verify_column_sidecars(sidecars, block_root)
        if self._behind_finality(sidecars):
            return Availability(available=False)
        pend = self._bounded_entry(block_root)
        pend.inserted_at_slot = max(pend.inserted_at_slot, slot)
        for sc in sidecars:
            pend.columns[int(sc.index)] = sc
        return self.check_availability(block_root)

    def put_block(self, block_root: bytes, signed_block, slot: int = 0) -> Availability:
        blk_slot = getattr(signed_block.message, "slot", None)
        if blk_slot is not None and int(blk_slot) < self._finalized_slot:
            return Availability(available=False)
        pend = self._bounded_entry(block_root)
        pend.inserted_at_slot = max(pend.inserted_at_slot, slot)
        pend.block = signed_block
        return self.check_availability(block_root)

    def set_sampling_result(self, block_root: bytes, ok: bool, slot: int = 0) -> Availability:
        """Record the SamplingEngine's verdict for a block (network layer).
        A verdict alone never creates an entry: with no staged block or
        columns there is nothing it could complete, and creating one would
        resurrect roots the finality prune dropped mid-sample."""
        if block_root not in self._pending:
            return Availability(available=False)
        pend = self._bounded_entry(block_root)
        pend.inserted_at_slot = max(pend.inserted_at_slot, slot)
        pend.sampling_ok = bool(ok)
        return self.check_availability(block_root)

    def _required_commitments(self, signed_block) -> list:
        return list(
            getattr(signed_block.message.body, "blob_kzg_commitments", []) or []
        )

    def check_availability(
        self, block_root: bytes, new_indices: set | None = None
    ) -> Availability:
        """Non-destructive: the entry stays pending until `pop` after a
        successful import (so a failed import or early completion never
        strands components). `new_indices` marks blob indices delivered by
        the CURRENT caller: a commitment mismatch there is attributable
        (REJECT); a mismatch in previously staged indices just drops the
        poisoned data (the current caller is innocent)."""
        pend = self._pending.get(block_root)
        if pend is None or pend.block is None:
            return Availability(available=False)
        commitments = self._required_commitments(pend.block)
        mismatched = [
            i
            for i, c in enumerate(commitments)
            if i in pend.blobs
            and bytes(pend.blobs[i].kzg_commitment) != bytes(c)
        ]
        if mismatched:
            # drop poisoned indices so honest re-sends can complete the set
            for i in mismatched:
                del pend.blobs[i]
            blamable = sorted(set(mismatched) & (new_indices or set()))
            if blamable:
                raise InvalidComponentsError(
                    f"blob commitments at {blamable} do not match the block"
                )
        if len(pend.blobs) >= len(commitments) and all(
            i in pend.blobs for i in range(len(commitments))
        ):
            blobs = [pend.blobs[i] for i in range(len(commitments))]
            return Availability(available=True, block=pend.block, blobs=blobs)
        return self._check_column_availability(block_root, pend, commitments)

    def _check_column_availability(
        self, block_root: bytes, pend: PendingComponents, commitments: list
    ) -> Availability:
        """The PeerDAS route: custody-plus-sampling, or >=50% columns
        promoted to full availability through reconstruction."""
        if not commitments or not pend.columns:
            return Availability(available=False)
        columns = self.E.NUMBER_OF_COLUMNS
        have = set(pend.columns)
        if len(have) >= columns:
            full = [pend.columns[j] for j in range(columns)]
            return Availability(available=True, block=pend.block, columns=full)
        if len(have) * 2 >= columns:
            from ..das import ErasureError, recover_matrix

            try:
                matrix = recover_matrix(list(pend.columns.values()), self.E)
            except (ErasureError, ValueError) as e:
                # verified columns that don't cohere means staged state is
                # poisoned beyond attribution: not provably anyone's fault
                raise MissingComponentsError(
                    f"column reconstruction failed: {e}"
                ) from e
            full = self._rebuild_columns(pend, matrix)
            for sc in full:
                pend.columns[int(sc.index)] = sc
            return Availability(available=True, block=pend.block, columns=full)
        custody = self.custody_columns
        if (
            custody
            and pend.sampling_ok
            and all(j in have for j in custody)
        ):
            staged = [pend.columns[j] for j in sorted(have)]
            return Availability(
                available=True, block=pend.block, columns=staged
            )
        return Availability(available=False)

    def _rebuild_columns(self, pend: PendingComponents, matrix: dict) -> list:
        """Full sidecar set from a reconstructed cell matrix: recompute
        every cell proof from the recovered blobs (shared header/
        commitments/inclusion proof come from any staged sidecar)."""
        from ..das import blobs_from_matrix, build_data_column_sidecars

        blobs = blobs_from_matrix(matrix, self.E)
        return build_data_column_sidecars(pend.block, blobs, self.kzg, self.E)

    def pop(self, block_root: bytes) -> None:
        """Forget a block's components after successful import."""
        self._pending.pop(block_root, None)

    def has_pending(self, block_root: bytes) -> bool:
        return block_root in self._pending

    def pending_roots(self, with_block: bool = True) -> list:
        """Roots still awaiting components (the network layer's sampling
        retry walks these each slot tick). `with_block` filters to entries
        whose block is staged — the only ones a verdict can complete."""
        return [
            r
            for r, p in self._pending.items()
            if not with_block or p.block is not None
        ]

    def sampling_pending(self, block_root: bytes) -> bool:
        """True while no POSITIVE sampling verdict is recorded: a failed
        verdict stays retryable (the network re-samples at slot edges —
        an early miss may be propagation lag, not withholding)."""
        pend = self._pending.get(block_root)
        return pend is not None and not pend.sampling_ok

    def staged_columns(self, block_root: bytes) -> dict:
        """Verified columns staged for a block (network serving + the
        sampling engine's local short-circuit)."""
        pend = self._pending.get(block_root)
        return dict(pend.columns) if pend is not None else {}

    def prune_before(self, slot: int) -> None:
        """Drop pending components staged before `slot` (finalization-driven
        — nothing older than the finalized slot can still import). Entries
        holding a block prune by the BLOCK's slot: activity timestamps keep
        advancing while sampling retries a withheld block, but no block
        older than the finalized slot can ever import, retries or not."""
        self._finalized_slot = max(self._finalized_slot, int(slot))
        for r, pend in list(self._pending.items()):
            blk_slot = (
                getattr(pend.block.message, "slot", None)
                if pend.block is not None
                else None
            )
            at = (
                int(blk_slot)
                if blk_slot is not None
                else pend.inserted_at_slot
            )
            if at < slot:
                del self._pending[r]
