"""Validator client: duties, attestation + block production, signing.

Mirrors validator_client/src/lib.rs:91-98 — a `ValidatorStore` holding
signing methods behind slashing protection, a `DutiesService` polling the
beacon node for proposer/attester duties, per-slot `AttestationService`
and `BlockService`, and doppelganger liveness gating. The beacon-node
seam here is the in-process `BeaconChain` (the reference talks HTTP via
common/eth2; the service logic is transport-agnostic and the HTTP client
slots into `BeaconNodeInterface`).

At industrial key counts (100k keys per VC process) the per-key duty
cycle is rebuilt as batch programs, traced under one `vc_duty_cycle`
root per slot with fetch/assemble/protect/sign/publish stage spans:

- duties: ONE paginated bulk fetch per epoch over the BN's
  `attester_duties` surface (served by the epoch duty table) instead of
  N per-key committee walks;
- signing roots: assembled as an array program over
  `sha256_batch.hash_messages`, grouped by distinct message — a
  committee's attesters share one `AttestationData`, so `hash_to_g2`
  is paid once per distinct root downstream;
- BLS: `bls.sign_batch` shards scalars across the host fork pool with a
  fixed-base window table per distinct message (per-key `pt_mul` only
  inside workers, results reassembled in submission order);
- slashing protection: ONE transaction per slot
  (`check_and_insert_attestations_batch`) with per-entry decisions
  equal to the sequential per-key calls.

The per-key path is retained verbatim as the differential oracle —
`LIGHTHOUSE_TPU_VC_BATCH=0` drops the whole pipeline back to it, and
tests/test_vc_batch.py asserts bit-identical signatures, identical
slashing-DB end state, and identical refusals between the two."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..crypto import bls
from ..metrics import REGISTRY, inc_counter
from ..state_processing.accessors import (
    committee_cache_at,
    compute_epoch_at_slot,
    get_beacon_proposer_index,
    get_domain,
)
from ..types.chain_spec import Domain, compute_signing_root
from ..utils.sha256_batch import hash_messages
from ..utils.tracing import span
from .slashing_protection import NotSafe, SlashingDatabase


def _batch_enabled() -> bool:
    """Batch duty-pipeline kill switch, read at call time so operators
    (and the differential tests) can flip LIGHTHOUSE_TPU_VC_BATCH=0
    mid-process and fall back to the per-key oracle path."""
    return os.environ.get("LIGHTHOUSE_TPU_VC_BATCH", "1") != "0"


def _columns(state):
    """The state's refreshed resident registry columns, or None when the
    state isn't in the tree-states representation (callers keep their
    O(n) registry-scan fallback)."""
    from ..state_processing.registry_columns import registry_columns_for

    cols = registry_columns_for(state)
    if cols is None or not cols.try_refresh(state):
        return None
    return cols


class SigningMethod:
    """signing_method.rs:80-95 — LocalKeystore here; a Web3Signer client
    implements the same `sign` seam."""

    def sign(self, signing_root: bytes) -> bytes:
        raise NotImplementedError


class LocalKeystoreSigner(SigningMethod):
    def __init__(self, secret_key: bls.SecretKey):
        self.sk = secret_key

    def sign(self, signing_root: bytes) -> bytes:
        return self.sk.sign(signing_root).to_bytes()


@dataclass
class Duty:
    validator_index: int
    slot: int
    committee_index: int
    committee_position: int
    committee_size: int


class ValidatorStore:
    """Keys + slashing protection (validator_store.rs analog)."""

    def __init__(self, slashing_db: SlashingDatabase | None = None):
        self.slashing_db = slashing_db or SlashingDatabase()
        self._signers: dict[bytes, SigningMethod] = {}
        self._indices: dict[bytes, int] = {}

    def add_validator(self, pubkey: bytes, signer: SigningMethod):
        self._signers[bytes(pubkey)] = signer
        self.slashing_db.register_validator(pubkey)

    def pubkeys(self):
        return list(self._signers)

    def remove_validator(self, pubkey: bytes) -> bool:
        """Detach a signer (keymanager DELETE). The slashing-protection
        history for the key is retained intentionally — it must survive
        into the interchange export the operator migrates with."""
        return self._signers.pop(bytes(pubkey), None) is not None

    def signer_for(self, pubkey: bytes) -> SigningMethod | None:
        return self._signers.get(bytes(pubkey))

    def sign_block(self, pubkey: bytes, block, state, spec, E):
        domain = get_domain(
            state,
            Domain.BEACON_PROPOSER,
            compute_epoch_at_slot(block.slot, E),
            spec,
            E,
        )
        root = compute_signing_root(block.hash_tree_root(), domain)
        self.slashing_db.check_and_insert_block_proposal(
            pubkey, block.slot, root
        )
        return self._signers[bytes(pubkey)].sign(root)

    def sign_attestation(self, pubkey: bytes, data, state, spec, E):
        domain = get_domain(
            state, Domain.BEACON_ATTESTER, data.target.epoch, spec, E
        )
        root = compute_signing_root(data.hash_tree_root(), domain)
        self.slashing_db.check_and_insert_attestation(
            pubkey, data.source.epoch, data.target.epoch, root
        )
        return self._signers[bytes(pubkey)].sign(root)

    def sign_roots_batch(self, pubkeys, roots) -> list[bytes]:
        """Sign many (pubkey, signing_root) pairs in one shot. Local
        keystore scalars go through `bls.sign_batch` (grouped by distinct
        message there — fixed-base window table per group, sharded over
        the host fork pool); signers without a resident secret key (the
        Web3Signer shape) fall back to their per-key `sign` seam. Output
        order == input order, bytes identical to per-key signing."""
        out: list = [None] * len(pubkeys)
        sks, sk_pos = [], []
        for i, pk in enumerate(pubkeys):
            signer = self._signers[bytes(pk)]
            sk = getattr(signer, "sk", None)
            if sk is None:
                out[i] = signer.sign(roots[i])
            else:
                sks.append(sk)
                sk_pos.append(i)
        if sks:
            sigs = bls.sign_batch(sks, [roots[i] for i in sk_pos])
            for i, sig in zip(sk_pos, sigs):
                out[i] = sig.to_bytes()
        return out

    def sign_attestations_batch(self, requests, state, spec, E) -> list:
        """Batch counterpart of N `sign_attestation` calls: same per-key
        decisions, same signature bytes, amortized costs. `requests` is
        [(pubkey, AttestationData)]; the result aligns with it — raw
        signature bytes, or the NotSafe the per-key path would raise.

        Grouping is by AttestationData object identity: the batch attest
        phase builds ONE data per committee, so hash_tree_root and the
        domain are paid per committee, not per key. Signing roots for the
        distinct messages are one [g, 64] `hash_messages` array program,
        and slashing-protection writes land as ONE transaction
        (`check_and_insert_attestations_batch`) instead of one sqlite
        commit per key."""
        if not requests:
            return []
        group_of: dict[int, int] = {}  # id(data) -> ordinal
        datas: list = []
        for _pk, data in requests:
            if id(data) not in group_of:
                group_of[id(data)] = len(datas)
                datas.append(data)
        domains: dict[int, bytes] = {}
        for data in datas:
            te = int(data.target.epoch)
            if te not in domains:
                domains[te] = bytes(
                    get_domain(state, Domain.BEACON_ATTESTER, te, spec, E)
                )
        pairs = np.frombuffer(
            b"".join(
                bytes(data.hash_tree_root()) + domains[int(data.target.epoch)]
                for data in datas
            ),
            dtype=np.uint8,
        ).reshape(len(datas), 64)
        group_roots = [bytes(r) for r in hash_messages(pairs)]
        roots = [group_roots[group_of[id(data)]] for _pk, data in requests]
        with span("vc_protect", entries=len(requests)):
            statuses = self.slashing_db.check_and_insert_attestations_batch(
                [
                    (pk, int(data.source.epoch), int(data.target.epoch), root)
                    for (pk, data), root in zip(requests, roots)
                ]
            )
        safe = [i for i, st in enumerate(statuses) if st is None]
        with span("vc_sign_batch", sigs=len(safe), groups=len(datas)):
            sigs = self.sign_roots_batch(
                [requests[i][0] for i in safe], [roots[i] for i in safe]
            )
        out: list = list(statuses)
        for i, sig in zip(safe, sigs):
            out[i] = sig
        return out

    def sign_randao(self, pubkey: bytes, epoch: int, state, spec, E):
        domain = get_domain(state, Domain.RANDAO, epoch, spec, E)
        root = compute_signing_root(
            epoch.to_bytes(8, "little").ljust(32, b"\x00"), domain
        )
        return self._signers[bytes(pubkey)].sign(root)

    def sign_selection_proof(self, pubkey: bytes, slot: int, state, spec, E):
        """DOMAIN_SELECTION_PROOF over the slot — the signing root comes
        from the verifier's own recipe (signature_sets) so they can't
        diverge."""
        from ..state_processing.signature_sets import (
            selection_proof_signing_root,
        )

        root = selection_proof_signing_root(state, slot, spec, E)
        return self._signers[bytes(pubkey)].sign(root)

    def sign_aggregate_and_proof(self, pubkey: bytes, agg_and_proof, state, spec, E):
        domain = get_domain(
            state,
            Domain.AGGREGATE_AND_PROOF,
            compute_epoch_at_slot(agg_and_proof.aggregate.data.slot, E),
            spec,
            E,
        )
        root = compute_signing_root(agg_and_proof.hash_tree_root(), domain)
        return self._signers[bytes(pubkey)].sign(root)

    def sign_sync_committee_message(
        self, pubkey: bytes, slot: int, block_root: bytes, state, spec, E
    ):
        """altair/validator.md: sign the head root under
        DOMAIN_SYNC_COMMITTEE of the slot's epoch (no slashing conditions
        apply to sync messages — no slashing-db entry)."""
        domain = get_domain(
            state, Domain.SYNC_COMMITTEE, compute_epoch_at_slot(slot, E), spec, E
        )
        root = compute_signing_root(bytes(block_root), domain)
        return self._signers[bytes(pubkey)].sign(root)


class BeaconNodeInterface:
    """What the services need from a BN (common/eth2 client surface)."""

    def head_state(self):
        raise NotImplementedError

    def publish_block(self, signed_block):
        raise NotImplementedError

    def publish_attestations(self, attestations):
        raise NotImplementedError

    def produce_block(self, slot: int, randao_reveal: bytes):
        raise NotImplementedError

    def publish_sync_committee_messages(self, messages):
        raise NotImplementedError

    def prepare_proposers(self, preparations: dict[int, bytes]):
        raise NotImplementedError

    def get_aggregate(self, data):
        raise NotImplementedError

    def publish_aggregates(self, signed_aggregates):
        raise NotImplementedError

    def attester_duties(self, epoch: int, indices) -> list:
        """Bulk duties for `indices` at `epoch` (the Beacon API's POST
        /eth/v1/validator/duties/attester/{epoch}). OPTIONAL: transports
        without it raise, and DutiesService falls back to its local
        committee scan."""
        raise NotImplementedError


class LocalBeaconNode(BeaconNodeInterface):
    """In-process BN (the HTTP client's stand-in for tests/sim)."""

    def __init__(self, chain):
        self.chain = chain

    def head_state(self):
        return self.chain.head_state

    def head_root(self):
        return self.chain.head_root

    def publish_block(self, signed_block):
        return self.chain.process_block(signed_block)

    def publish_attestations(self, attestations):
        return self.chain.process_attestation_batch(attestations)

    def produce_block(self, slot: int, randao_reveal: bytes):
        block, _post = self.chain.produce_block_on_state(slot, randao_reveal)
        return block

    def publish_sync_committee_messages(self, messages):
        for msg in messages:
            self.chain.process_sync_committee_message(msg)

    def prepare_proposers(self, preparations: dict[int, bytes]):
        self.chain.prepare_proposers(preparations)

    def get_aggregate(self, data):
        return self.chain.get_aggregated_attestation(data)

    def publish_aggregates(self, signed_aggregates):
        """Per-item: one rejected aggregate (e.g. the aggregator-seen
        dedup) must not drop the valid ones behind it."""
        out = []
        for agg in signed_aggregates:
            try:
                out.append(self.chain.process_aggregate(agg))
            except Exception as e:  # noqa: BLE001
                out.append(e)
        return out

    def attester_duties(self, epoch: int, indices) -> list:
        """Bulk duties via the epoch duty table (inverse shuffling +
        searchsorted over committee starts) — the same table the Beacon
        API tier's paginated duties route resolves through, so the
        in-process and HTTP transports return identical assignments."""
        from ..state_processing.accessors import epoch_duty_table

        st = self.chain.head_state
        table = epoch_duty_table(st, int(epoch), self.chain.E)
        req = [int(i) for i in indices]
        found, slots, cidx, pos, size = table.lookup(req)
        hit = [i for i, f in zip(req, found) if f]
        return [
            Duty(
                validator_index=vi,
                slot=int(s),
                committee_index=int(c),
                committee_position=int(p),
                committee_size=int(n),
            )
            for vi, s, c, p, n in zip(hit, slots, cidx, pos, size)
        ]


class GossipingBeaconNode(LocalBeaconNode):
    """LocalBeaconNode that ALSO broadcasts published objects over the
    node's gossip network — the production publish semantics
    (http_api/src/publish_blocks.rs: import locally, then broadcast).
    ClientBuilder wires this when the node has networking; the simulator
    adds its offline seam on top."""

    def __init__(self, chain, network):
        super().__init__(chain)
        self.network = network

    def publish_block(self, signed_block):
        root = super().publish_block(signed_block)
        self.network.publish_block(signed_block)
        return root

    def publish_attestations(self, attestations):
        results = super().publish_attestations(attestations)
        for att in attestations:
            self.network.publish_attestation(att)
        return results

    def publish_sync_committee_messages(self, messages):
        super().publish_sync_committee_messages(messages)
        for msg in messages:
            self.network.publish_sync_committee_message(msg)

    def publish_aggregates(self, signed_aggregates):
        results = super().publish_aggregates(signed_aggregates)
        for agg, res in zip(signed_aggregates, results):
            if not isinstance(res, Exception):
                self.network.publish_aggregate(agg)
        return results


class DutiesService:
    """Polls the BN state for this store's duties (duties_service.rs)."""

    def __init__(self, store: ValidatorStore, node: BeaconNodeInterface, spec, E):
        self.store = store
        self.node = node
        self.spec = spec
        self.E = E
        # duty cache per (epoch, dependent root) — recomputed only on reorg
        # or epoch change (the reference polls once per epoch the same way)
        self._duty_cache: dict = {}

    def _our_indices(self, state) -> dict[int, bytes]:
        """index -> pubkey for every managed key: one `pubkey_index()`
        dict probe per key against the state's resident registry columns;
        column-less states keep the O(n) registry scan."""
        cols = _columns(state)
        if cols is None:
            return self._our_indices_scan(state)
        idx = cols.pubkey_index()
        ours = {}
        for pk in self.store.pubkeys():
            i = idx.get(pk)
            if i is not None:
                ours[i] = pk
        return ours

    def _our_indices_scan(self, state) -> dict[int, bytes]:
        # retained oracle path for states without resident columns
        ours = {}
        managed = set(self.store.pubkeys())
        for i, v in enumerate(state.validators):
            pk = bytes(v.pubkey)
            if pk in managed:
                ours[i] = pk
        return ours

    def attester_duties(self, epoch: int) -> list[Duty]:
        # cache key BEFORE any state fetch: head_state() over HTTP pulls the
        # whole SSZ state — exactly the cost the cache exists to avoid.
        # Keyed by epoch: committee shuffling is seeded lookahead epochs
        # back, so within an epoch the assignment is head-independent
        # (cross-epoch reorgs would need dependent-root tracking — the
        # reference's duties_service reorg hook).
        key = epoch
        cached = self._duty_cache.get(key)
        if cached is not None:
            return cached
        state = self.node.head_state()
        ours = self._our_indices(state)
        duties = None
        if _batch_enabled():
            duties = self._attester_duties_bulk(epoch, ours)
        if duties is None:
            duties = self._attester_duties_scan(state, epoch, ours)
        self._duty_cache[key] = duties
        if len(self._duty_cache) > 4:
            self._duty_cache.pop(next(iter(self._duty_cache)))
        return duties

    def _attester_duties_bulk(self, epoch: int, ours) -> list[Duty] | None:
        """ONE paginated bulk-duties fetch per epoch over the BN's
        `attester_duties` surface, or None when the transport lacks it.
        Pages bound each request body at 100k keys; the result re-sorts
        to the scan path's (slot, committee, position) order so the two
        paths return identical lists."""
        fetch = getattr(self.node, "attester_duties", None)
        if fetch is None:
            return None  # transport has no bulk surface (e.g. raw HTTP)
        indices = sorted(ours)
        page = int(os.environ.get("LIGHTHOUSE_TPU_VC_DUTIES_PAGE", "32768"))
        duties: list[Duty] = []
        try:
            for s in range(0, len(indices), page):
                duties.extend(fetch(epoch, indices[s : s + page]))
        except NotImplementedError:
            return None
        duties.sort(
            key=lambda d: (d.slot, d.committee_index, d.committee_position)
        )
        return duties

    def _attester_duties_scan(self, state, epoch: int, ours) -> list[Duty]:
        # retained oracle path: the per-committee walk over the local
        # committee cache (bulk path must return exactly this list)
        from ..state_processing.accessors import compute_start_slot_at_epoch
        from ..utils.safe_arith import safe_add

        cc = committee_cache_at(state, epoch, self.E)
        start = compute_start_slot_at_epoch(epoch, self.E)
        duties = []
        for slot in range(start, safe_add(start, self.E.SLOTS_PER_EPOCH)):
            for committee_index in range(cc.committees_per_slot):
                committee = cc.committee(slot, committee_index)
                for pos, vi in enumerate(committee):
                    if vi in ours:
                        duties.append(
                            Duty(
                                validator_index=vi,
                                slot=slot,
                                committee_index=committee_index,
                                committee_position=pos,
                                committee_size=len(committee),
                            )
                        )
        return duties

    def proposer_duty_at(self, slot: int):
        """(validator_index, pubkey) when a managed key proposes at slot."""
        from ..state_processing import per_slot_processing

        state = self.node.head_state().copy()
        while state.slot < slot:
            per_slot_processing(state, self.spec, self.E)
        proposer = get_beacon_proposer_index(state, self.E)
        ours = self._our_indices(state)
        if proposer in ours:
            return proposer, ours[proposer], state
        return None


class AttestationService:
    """Signs and publishes this store's attestations for a slot
    (attestation_service.rs)."""

    def __init__(self, duties: DutiesService, store: ValidatorStore, node, spec, E):
        self.duties = duties
        self.store = store
        self.node = node
        self.spec = spec
        self.E = E
        self._last_attested: tuple = (None, None, None)

    def _attestation_data(self, state, slot: int, head_root: bytes, committee_index: int):
        """The duty's AttestationData (validator.md) — one recipe shared
        by the attest phase and the aggregation phase so the aggregator
        looks up exactly the data root it attested (or would have)."""
        from ..state_processing.accessors import (
            compute_start_slot_at_epoch,
            get_block_root_at_slot,
        )
        from ..types.containers import build_types

        t = build_types(self.E)
        epoch = compute_epoch_at_slot(slot, self.E)
        target_slot = compute_start_slot_at_epoch(epoch, self.E)
        target_root = (
            head_root
            if target_slot >= slot
            else get_block_root_at_slot(state, target_slot, self.E)
        )
        return t.AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=head_root,
            source=state.current_justified_checkpoint,
            target=t.Checkpoint(epoch=epoch, root=target_root),
        )

    def attest(self, slot: int, head_root: bytes) -> list:
        """One slot's attestation duty for every managed key. The batch
        pipeline (default) runs the slot as array/batch programs under a
        `vc_duty_cycle` trace root; LIGHTHOUSE_TPU_VC_BATCH=0 drops to
        the retained per-key oracle path."""
        if not _batch_enabled():
            return self._attest_per_key(slot, head_root)
        return self._attest_batch(slot, head_root)

    def _attest_per_key(self, slot: int, head_root: bytes) -> list:
        from ..state_processing import per_slot_processing
        from ..types.containers import build_types

        t = build_types(self.E)
        state = self.node.head_state().copy()
        while state.slot < slot:
            per_slot_processing(state, self.spec, self.E)
        epoch = compute_epoch_at_slot(slot, self.E)
        out = []
        for duty in self.duties.attester_duties(epoch):
            if duty.slot != slot:
                continue
            pk = None
            v = state.validators[duty.validator_index]
            pk = bytes(v.pubkey)
            data = self._attestation_data(
                state, slot, head_root, duty.committee_index
            )
            try:
                sig = self.store.sign_attestation(pk, data, state, self.spec, self.E)
            except NotSafe:
                inc_counter("vc_slashing_protection_refusals_total")
                continue
            bits = [False] * duty.committee_size
            bits[duty.committee_position] = True
            out.append(
                t.Attestation(
                    aggregation_bits=bits, data=data, signature=sig
                )
            )
        if out:
            self.node.publish_attestations(out)
            inc_counter("vc_attestations_published_total", amount=len(out))
        self._last_attested = (slot, state, bytes(head_root))
        return out

    def _attest_batch(self, slot: int, head_root: bytes) -> list:
        """The per-key loop above, restructured as one batch program:
        fetch duties once, assemble ONE AttestationData per committee,
        run slashing protection as one transaction, sign through the
        grouped batch signer, publish in duty order. Output list, refusal
        set, counters, and slashing-DB end state are identical to
        `_attest_per_key` (asserted differentially)."""
        from ..state_processing import per_slot_processing
        from ..types.containers import build_types

        t = build_types(self.E)
        with span("vc_duty_cycle", slot=int(slot), kind="attest"):
            with span("vc_fetch"):
                state = self.node.head_state().copy()
                while state.slot < slot:
                    per_slot_processing(state, self.spec, self.E)
                epoch = compute_epoch_at_slot(slot, self.E)
                duties = [
                    d
                    for d in self.duties.attester_duties(epoch)
                    if d.slot == slot
                ]
            if not duties:
                self._last_attested = (slot, state, bytes(head_root))
                return []
            with span("vc_assemble", duties=len(duties)):
                data_by_committee: dict = {}
                requests = []
                for duty in duties:
                    data = data_by_committee.get(duty.committee_index)
                    if data is None:
                        data = self._attestation_data(
                            state, slot, head_root, duty.committee_index
                        )
                        data_by_committee[duty.committee_index] = data
                    pk = bytes(state.validators[duty.validator_index].pubkey)
                    requests.append((pk, data))
            results = self.store.sign_attestations_batch(
                requests, state, self.spec, self.E
            )
            out = []
            refused = 0
            with span("vc_publish"):
                for duty, (_pk, data), res in zip(duties, requests, results):
                    if isinstance(res, NotSafe):
                        refused += 1
                        continue
                    bits = [False] * duty.committee_size
                    bits[duty.committee_position] = True
                    out.append(
                        t.Attestation(
                            aggregation_bits=bits, data=data, signature=res
                        )
                    )
                if out:
                    self.node.publish_attestations(out)
                    inc_counter(
                        "vc_attestations_published_total", amount=len(out)
                    )
            if refused:
                inc_counter(
                    "vc_slashing_protection_refusals_total", amount=refused
                )
        self._last_attested = (slot, state, bytes(head_root))
        return out

    def aggregate_if_selected(self, slot: int) -> list:
        """Second phase of the attestation duty (validator.md 2/3-slot
        mark): each managed attester computes its selection proof; those
        selected as aggregators fetch the pool's best aggregate for their
        committee and publish a SignedAggregateAndProof
        (attestation_service.rs aggregate production)."""
        if not _batch_enabled():
            return self._aggregate_per_key(slot)
        return self._aggregate_batch(slot)

    def _aggregate_per_key(self, slot: int) -> list:
        from ..beacon_chain.attestation_verification import is_aggregator
        from ..types.containers import build_types

        last_slot, state, head_root = self._last_attested
        if last_slot != slot or state is None:
            return []
        t = build_types(self.E)
        published = []
        for duty in self.duties.attester_duties(
            compute_epoch_at_slot(slot, self.E)
        ):
            if duty.slot != slot:
                continue
            pk = bytes(state.validators[duty.validator_index].pubkey)
            proof = self.store.sign_selection_proof(
                pk, slot, state, self.spec, self.E
            )
            if not is_aggregator(duty.committee_size, proof, self.E):
                continue
            # rebuild the duty's data directly — aggregation duty holds
            # even when our own attest was refused (e.g. slashing db)
            data = self._attestation_data(
                state, slot, head_root, duty.committee_index
            )
            agg = self.node.get_aggregate(data)
            if agg is None:
                continue
            aap = t.AggregateAndProof(
                aggregator_index=duty.validator_index,
                aggregate=agg,
                selection_proof=proof,
            )
            sig = self.store.sign_aggregate_and_proof(
                pk, aap, state, self.spec, self.E
            )
            published.append(
                t.SignedAggregateAndProof(message=aap, signature=sig)
            )
        if published:
            results = self.node.publish_aggregates(published)
            accepted = (
                sum(1 for r in results if not isinstance(r, Exception))
                if isinstance(results, list)
                else len(published)  # batch-status transports
            )
            inc_counter("vc_aggregates_published_total", amount=accepted)
        return published

    def _aggregate_batch(self, slot: int) -> list:
        """Batch selection proofs: every proof this slot signs the SAME
        root (a function of the slot alone), so one fixed-base table
        covers the whole fleet. The few selected aggregators then follow
        the per-key aggregate fetch/sign/publish tail unchanged."""
        from ..beacon_chain.attestation_verification import is_aggregator
        from ..state_processing.signature_sets import (
            selection_proof_signing_root,
        )
        from ..types.containers import build_types

        last_slot, state, head_root = self._last_attested
        if last_slot != slot or state is None:
            return []
        t = build_types(self.E)
        duties = [
            d
            for d in self.duties.attester_duties(
                compute_epoch_at_slot(slot, self.E)
            )
            if d.slot == slot
        ]
        if not duties:
            return []
        published = []
        with span("vc_duty_cycle", slot=int(slot), kind="aggregate"):
            root = selection_proof_signing_root(
                state, slot, self.spec, self.E
            )
            pks = [
                bytes(state.validators[d.validator_index].pubkey)
                for d in duties
            ]
            with span("vc_sign_batch", sigs=len(pks), groups=1):
                proofs = self.store.sign_roots_batch(pks, [root] * len(pks))
            with span("vc_publish"):
                for duty, pk, proof in zip(duties, pks, proofs):
                    if not is_aggregator(duty.committee_size, proof, self.E):
                        continue
                    data = self._attestation_data(
                        state, slot, head_root, duty.committee_index
                    )
                    agg = self.node.get_aggregate(data)
                    if agg is None:
                        continue
                    aap = t.AggregateAndProof(
                        aggregator_index=duty.validator_index,
                        aggregate=agg,
                        selection_proof=proof,
                    )
                    sig = self.store.sign_aggregate_and_proof(
                        pk, aap, state, self.spec, self.E
                    )
                    published.append(
                        t.SignedAggregateAndProof(message=aap, signature=sig)
                    )
                if published:
                    results = self.node.publish_aggregates(published)
                    accepted = (
                        sum(
                            1
                            for r in results
                            if not isinstance(r, Exception)
                        )
                        if isinstance(results, list)
                        else len(published)  # batch-status transports
                    )
                    inc_counter(
                        "vc_aggregates_published_total", amount=accepted
                    )
        return published


class BlockService:
    """Produces, signs, and publishes blocks for managed proposers
    (block_service.rs)."""

    def __init__(self, duties: DutiesService, store: ValidatorStore, node, spec, E):
        self.duties = duties
        self.store = store
        self.node = node
        self.spec = spec
        self.E = E

    def propose_if_due(self, slot: int):
        # the genesis block is slot 0's (block_service.rs: no block is
        # produced at the genesis slot); a clock that starts at genesis
        # ticks slot 0 first
        if slot == 0:
            return None
        duty = self.duties.proposer_duty_at(slot)
        if duty is None:
            return None
        from ..utils.tracing import span

        _proposer_index, pubkey, advanced_state = duty
        epoch = compute_epoch_at_slot(slot, self.E)
        # one block_production trace covers randao + produce + sign; the
        # chain's advance/pack/assemble stages nest under it. The publish
        # stays OUTSIDE: the resulting import is its own trace root.
        with span("block_production", slot=int(slot)):
            randao = self.store.sign_randao(
                pubkey, epoch, advanced_state, self.spec, self.E
            )
            block = self.node.produce_block(slot, randao)
            try:
                with span("sign"):
                    sig = self.store.sign_block(
                        pubkey, block, advanced_state, self.spec, self.E
                    )
            except NotSafe:
                inc_counter("vc_slashing_protection_refusals_total")
                return None
        from ..types.containers import build_types

        t = build_types(self.E)
        tf = t.types_for_fork(t.fork_of_block(block))
        signed = tf.SignedBeaconBlock(message=block, signature=sig)
        root = self.node.publish_block(signed)
        inc_counter("vc_blocks_published_total")
        return root


class SyncCommitteeService:
    """Signs and publishes sync-committee messages for managed keys in
    the current sync committee (sync_committee_service.rs)."""

    def __init__(self, store: ValidatorStore, node, spec, E):
        self.store = store
        self.node = node
        self.spec = spec
        self.E = E
        # sync-committee membership changes once per period and the
        # registry scan costs a full state fetch over HTTP — cache both
        # per epoch (duties_service epoch-cache rationale)
        self._cache_epoch: int | None = None
        self._members: list[tuple[int, bytes]] = []
        self._domain_state = None

    def _refresh(self, epoch: int):
        if epoch == self._cache_epoch:
            return
        state = self.node.head_state()
        self._cache_epoch = epoch
        self._domain_state = state
        self._members = []
        committee = getattr(state, "current_sync_committee", None)
        if committee is None:
            return  # phase0: no sync committees yet
        managed = set(self.store.pubkeys())
        cols = _columns(state) if _batch_enabled() else None
        if cols is not None:
            # one dict probe per managed key; duplicate pubkeys resolve
            # to the FIRST index (pubkey_index semantics — real
            # registries are duplicate-free, deposits top up in place)
            idx = cols.pubkey_index()
            by_pubkey = {pk: idx[pk] for pk in managed if pk in idx}
        else:
            by_pubkey = {}
            for i, v in enumerate(state.validators):
                pk = bytes(v.pubkey)
                if pk in managed:
                    by_pubkey[pk] = i
        seen = set()
        for pk in committee.pubkeys:
            pk = bytes(pk)
            vi = by_pubkey.get(pk)
            if vi is None or vi in seen:
                continue  # one message per validator even with N positions
            seen.add(vi)
            self._members.append((vi, pk))

    def sign_messages(self, slot: int, head_root: bytes) -> list:
        if not _batch_enabled():
            return self._sign_messages_per_key(slot, head_root)
        return self._sign_messages_batch(slot, head_root)

    def _sign_messages_per_key(self, slot: int, head_root: bytes) -> list:
        from ..types.containers import build_types

        t = build_types(self.E)
        self._refresh(compute_epoch_at_slot(slot, self.E))
        out = []
        for vi, pk in self._members:
            sig = self.store.sign_sync_committee_message(
                pk, slot, head_root, self._domain_state, self.spec, self.E
            )
            out.append(
                t.SyncCommitteeMessage(
                    slot=slot,
                    beacon_block_root=head_root,
                    validator_index=vi,
                    signature=sig,
                )
            )
        if out:
            self.node.publish_sync_committee_messages(out)
            inc_counter(
                "vc_sync_committee_messages_published_total", amount=len(out)
            )
        return out

    def _sign_messages_batch(self, slot: int, head_root: bytes) -> list:
        """Every member signs the SAME head root under the same domain —
        one signing root, one message group, one fixed-base table inside
        `bls.sign_batch` (the many-keys-one-message shape the batch
        signer exists for)."""
        from ..types.containers import build_types

        t = build_types(self.E)
        self._refresh(compute_epoch_at_slot(slot, self.E))
        if not self._members:
            return []
        out = []
        with span("vc_duty_cycle", slot=int(slot), kind="sync"):
            domain = get_domain(
                self._domain_state,
                Domain.SYNC_COMMITTEE,
                compute_epoch_at_slot(slot, self.E),
                self.spec,
                self.E,
            )
            root = compute_signing_root(bytes(head_root), domain)
            pks = [pk for _vi, pk in self._members]
            with span("vc_sign_batch", sigs=len(pks), groups=1):
                sigs = self.store.sign_roots_batch(pks, [root] * len(pks))
            with span("vc_publish"):
                for (vi, _pk), sig in zip(self._members, sigs):
                    out.append(
                        t.SyncCommitteeMessage(
                            slot=slot,
                            beacon_block_root=head_root,
                            validator_index=vi,
                            signature=sig,
                        )
                    )
                self.node.publish_sync_committee_messages(out)
                inc_counter(
                    "vc_sync_committee_messages_published_total",
                    amount=len(out),
                )
        return out


class PreparationService:
    """Registers fee recipients for managed validators ahead of their
    proposals (preparation_service.rs; prepare_beacon_proposer API)."""

    def __init__(self, store: ValidatorStore, node, fee_recipient: bytes = b"\x00" * 20):
        self.store = store
        self.node = node
        self.default_fee_recipient = bytes(fee_recipient)
        self.per_validator: dict[bytes, bytes] = {}
        self._registered_epoch = -1

    def set_fee_recipient(self, pubkey: bytes, recipient: bytes):
        self.per_validator[bytes(pubkey)] = bytes(recipient)
        # any recipient change re-registers with the BN at the next tick
        self._registered_epoch = -1

    def prepare(self, epoch: int):
        """Once per epoch: push {validator_index: fee_recipient}."""
        if epoch == self._registered_epoch:
            return
        state = self.node.head_state()
        managed = set(self.store.pubkeys())
        prep = {}
        cols = _columns(state) if _batch_enabled() else None
        if cols is not None:
            idx = cols.pubkey_index()
            for pk in managed:
                i = idx.get(pk)
                if i is not None:
                    prep[i] = self.per_validator.get(
                        pk, self.default_fee_recipient
                    )
        else:
            for i, v in enumerate(state.validators):
                pk = bytes(v.pubkey)
                if pk in managed:
                    prep[i] = self.per_validator.get(
                        pk, self.default_fee_recipient
                    )
        if prep:
            self.node.prepare_proposers(prep)
        # epoch recorded even when empty: the registry scan costs a full
        # state fetch and must stay once-per-epoch
        self._registered_epoch = epoch


class DoppelgangerService:
    """Liveness gate: refuse signing for N epochs while watching for our
    keys attesting elsewhere (doppelganger_service.rs, simplified to the
    in-process observation surface)."""

    def __init__(self, chain, store: ValidatorStore, epochs_to_check: int = 2):
        self.chain = chain
        self.store = store
        self.epochs_to_check = epochs_to_check
        self._start_epoch: int | None = None

    def begin(self, current_epoch: int):
        self._start_epoch = current_epoch

    def signing_enabled(self, current_epoch: int) -> bool:
        if self._start_epoch is None:
            return True
        return current_epoch >= self._start_epoch + self.epochs_to_check


class ValidatorClient:
    """ProductionValidatorClient analog: wires the services and drives them
    per slot (lib.rs:91-98)."""

    def __init__(
        self,
        chain,
        keypairs,
        spec,
        E,
        slashing_db=None,
        node=None,
        fee_recipient: bytes = b"\x00" * 20,
    ):
        self.chain = chain  # None when running over a remote node interface
        self.spec = spec
        self.E = E
        self.node = node if node is not None else LocalBeaconNode(chain)
        self.store = ValidatorStore(slashing_db)
        for kp in keypairs:
            self.store.add_validator(kp.pk.to_bytes(), LocalKeystoreSigner(kp.sk))
        self.duties_service = DutiesService(self.store, self.node, spec, E)
        self.attestation_service = AttestationService(
            self.duties_service, self.store, self.node, spec, E
        )
        self.block_service = BlockService(
            self.duties_service, self.store, self.node, spec, E
        )
        self.sync_committee_service = SyncCommitteeService(
            self.store, self.node, spec, E
        )
        self.preparation_service = PreparationService(
            self.store, self.node, fee_recipient
        )
        self.doppelganger = DoppelgangerService(chain, self.store)

    def on_slot(self, slot: int):
        """One slot of VC work in duty order: prepare (epoch-cadence),
        propose (if due), attest, then sync-committee messages over the
        resulting head (lib.rs:91-98 service set)."""
        epoch = compute_epoch_at_slot(slot, self.E)
        if not self.doppelganger.signing_enabled(epoch):
            return None
        self.preparation_service.prepare(epoch)
        root = self.block_service.propose_if_due(slot)
        head = self.node.head_root()
        self.attestation_service.attest(slot, head)
        self.attestation_service.aggregate_if_selected(slot)
        self.sync_committee_service.sign_messages(slot, head)
        return root


# Eager registration: dashboards and the conftest needle guard expect
# the VC series at zero before any duty runs (state_advance.py pattern).
for _name, _help in (
    ("vc_attestations_published_total", "attestations published by the VC"),
    ("vc_blocks_published_total", "blocks published by the VC"),
    ("vc_aggregates_published_total", "aggregates accepted on publish"),
    (
        "vc_sync_committee_messages_published_total",
        "sync-committee messages published by the VC",
    ),
    (
        "vc_slashing_protection_refusals_total",
        "signings refused by slashing protection",
    ),
):
    REGISTRY.counter(
        # lint: allow(metric-hygiene) -- bounded by the literal tuple above
        _name,
        _help,
    ).inc(0)
for _span_name in (
    "trace_span_seconds_vc_duty_cycle",
    "trace_span_seconds_vc_fetch",
    "trace_span_seconds_vc_assemble",
    "trace_span_seconds_vc_protect",
    "trace_span_seconds_vc_sign_batch",
    "trace_span_seconds_vc_publish",
):
    REGISTRY.histogram(
        # lint: allow(metric-hygiene) -- bounded by the literal tuple above
        _span_name,
        "span duration: VC duty-cycle stage",
    )
