"""Local golden-vector generation for the ef-test runner.

The image cannot download `consensus-spec-tests` (zero egress), so this
module manufactures a vector set in the same directory layout from the
harness: valid cases record pre/operation/post, invalid cases record
pre/operation with no post (the runner then requires a rejection). The
goldens pin CURRENT behavior — regressions in any covered family make
`run_all` fail — and the layout/codecs are identical to the official
vectors, so a mounted real vector tree runs through the same handlers.
"""

from __future__ import annotations

import pathlib
from dataclasses import replace

import yaml

from ..crypto import bls
from ..state_processing import interop_genesis_state, per_slot_processing
from ..state_processing.shuffle import shuffle_list
from ..types.chain_spec import ForkName as _FN, minimal_spec
from ..types.containers import build_types
from ..types.eth_spec import MinimalEthSpec as E

_GENESIS_TIME = 1_600_000_000


def _write(case_dir: pathlib.Path, name: str, data):
    case_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(data, (bytes, bytearray)):
        (case_dir / f"{name}.ssz").write_bytes(bytes(data))
    else:
        with open(case_dir / f"{name}.yaml", "w") as f:
            yaml.safe_dump(data, f)


def _altair_harness(validators=16):
    from .harness import StateHarness

    spec = replace(minimal_spec(), altair_fork_epoch=0)
    return StateHarness(spec, E, validator_count=validators), spec


def generate_goldens(root: str | pathlib.Path, seed: int = 7) -> int:
    """Build the local vector tree under `root/tests/minimal/...`. Returns
    the number of cases written. The BLS backend setting the caller had
    (pinned, or following the device) is restored on return: the JAX
    package's version leaves `fake_crypto` pinned."""
    saved = bls.backend_setting()
    try:
        return _generate_goldens(root, seed)
    finally:
        bls.set_backend(saved)


def _generate_goldens(root: str | pathlib.Path, seed: int) -> int:
    bls.set_backend("fake_crypto")
    root = pathlib.Path(root)
    base = root / "tests" / "minimal" / "altair"
    t = build_types(E)
    count = 0

    h, spec = _altair_harness()
    # advance into epoch 1 with real blocks so states carry participation
    h.extend_chain(E.SLOTS_PER_EPOCH + 2)
    state = h.state

    # --- operations/attestation ------------------------------------------
    atts = h.produce_attestations(state.copy(), state.slot, h.head_block_root())
    att = atts[0]
    pre = state.copy()
    per_slot_processing(pre, spec, E)  # satisfy MIN_ATTESTATION_INCLUSION_DELAY
    suite = base / "operations" / "attestation" / "pyspec_tests"
    from ..state_processing.altair import process_attestation_altair
    from ..state_processing.per_block import ConsensusContext
    from ..types.chain_spec import ForkName

    post = pre.copy()
    process_attestation_altair(
        post, att, spec, E, False, ConsensusContext(post.slot), ForkName.ALTAIR
    )
    _write(suite / "valid_0", "pre", pre.serialize())
    _write(suite / "valid_0", "attestation", t.Attestation.serialize_value(att))
    _write(suite / "valid_0", "post", post.serialize())
    count += 1

    bad = t.Attestation.deserialize(t.Attestation.serialize_value(att))
    bad.data.target.epoch += 3  # future target: must be rejected
    _write(suite / "invalid_target_0", "pre", pre.serialize())
    _write(
        suite / "invalid_target_0", "attestation", t.Attestation.serialize_value(bad)
    )
    count += 1

    # --- sanity/slots -----------------------------------------------------
    suite = base / "sanity" / "slots" / "pyspec_tests"
    pre = state.copy()
    post = pre.copy()
    for _ in range(3):
        per_slot_processing(post, spec, E)
    _write(suite / "slots_3", "pre", pre.serialize())
    _write(suite / "slots_3", "slots", 3)
    _write(suite / "slots_3", "post", post.serialize())
    count += 1

    # --- sanity/blocks ----------------------------------------------------
    suite = base / "sanity" / "blocks" / "pyspec_tests"
    h2, spec2 = _altair_harness(8)
    pre = h2.state.copy()
    blocks = []
    for _ in range(2):
        produced = h2.produce_block(h2.state.slot + 1, [])
        h2.process_block(produced.block)
        blocks.append(produced.block)
    case = suite / "two_blocks"
    _write(case, "pre", pre.serialize())
    for i, b in enumerate(blocks):
        _write(case, f"blocks_{i}", b.serialize())
    _write(case, "post", h2.state.serialize())
    _write(case, "meta", {"blocks_count": len(blocks)})
    count += 1

    # --- epoch_processing -------------------------------------------------
    from ..state_processing import altair as A
    from ..state_processing import per_epoch as PE

    epoch_subs = {
        "justification_and_finalization": lambda st: (
            A.process_justification_and_finalization_altair(st, E)
        ),
        "inactivity_updates": lambda st: A.process_inactivity_updates(st, spec, E),
        "registry_updates": lambda st: PE.process_registry_updates(st, spec, E),
        "effective_balance_updates": lambda st: (
            PE.process_effective_balance_updates(st, E)
        ),
        "slashings": lambda st: A.process_slashings_altair(st, E, _FN.ALTAIR),
    }
    # a state at an epoch boundary with some balance skew
    eb_state = state.copy()
    while (eb_state.slot + 1) % E.SLOTS_PER_EPOCH != 0:
        per_slot_processing(eb_state, spec, E)
    eb_state.balances[0] = 20_000_000_000
    eb_state.balances[1] = 33_000_000_000
    for sub, fn in epoch_subs.items():
        suite = base / "epoch_processing" / sub / "pyspec_tests"
        pre = eb_state.copy()
        post = pre.copy()
        fn(post)
        _write(suite / "case_0", "pre", pre.serialize())
        _write(suite / "case_0", "post", post.serialize())
        count += 1

    # --- shuffling --------------------------------------------------------
    suite = base / "shuffling" / "core" / "shuffle"
    seed_bytes = bytes(range(32))
    for n in (2, 7, 32):
        mapping = shuffle_list(list(range(n)), seed_bytes, E.SHUFFLE_ROUND_COUNT)
        _write(
            suite / f"shuffle_{n}",
            "mapping",
            {
                "seed": "0x" + seed_bytes.hex(),
                "count": n,
                "mapping": mapping,
            },
        )
        count += 1

    # --- ssz_static -------------------------------------------------------
    import random as _r

    rng = _r.Random(seed)
    samples = {
        "Checkpoint": t.Checkpoint(epoch=5, root=bytes(rng.randbytes(32))),
        "Fork": t.Fork(
            previous_version=b"\x00\x00\x00\x01",
            current_version=b"\x01\x00\x00\x01",
            epoch=9,
        ),
        "Validator": state.validators[0],
        "AttestationData": att.data,
        "BeaconBlockHeader": state.latest_block_header,
        "SyncAggregate": t.SyncAggregate(
            sync_committee_bits=[True, False] * (E.SYNC_COMMITTEE_SIZE // 2),
            sync_committee_signature=bytes(96),
        ),
    }
    for name, value in samples.items():
        typ = getattr(t, name)
        suite = base / "ssz_static" / name / "ssz_random"
        _write(suite / "case_0", "serialized", typ.serialize_value(value))
        _write(
            suite / "case_0",
            "roots",
            {"root": "0x" + typ.hash_tree_root_of(value).hex()},
        )
        count += 1

    # --- fork (altair upgrade) -------------------------------------------
    suite = base / "fork" / "fork" / "pyspec_tests"
    spec_pre = minimal_spec()
    kps = bls.interop_keypairs(8)
    phase0_state = interop_genesis_state(kps, _GENESIS_TIME, b"\x42" * 32, spec_pre, E)
    spec_fork = replace(minimal_spec(), altair_fork_epoch=0)
    from ..state_processing.upgrades import upgrade_to_altair

    post = phase0_state.copy()
    upgrade_to_altair(post, spec_fork, E)
    case = suite / "fork_base"
    _write(case, "pre", phase0_state.serialize())
    _write(case, "post", post.serialize())
    _write(case, "meta", {"fork": "altair"})
    count += 1

    # --- transition/core (altair → bellatrix mid-run) ----------------------
    from ..beacon_chain.harness import BeaconChainHarness

    tspec = replace(
        minimal_spec(), altair_fork_epoch=0, bellatrix_fork_epoch=1
    )
    th = BeaconChainHarness(tspec, E, validator_count=8)
    t_pre = th.chain.head_state.copy()  # altair genesis
    th.extend_chain(E.SLOTS_PER_EPOCH + 2, attest=False)
    t_blocks = sorted(
        th.chain._blocks_by_root.values(), key=lambda s: s.message.slot
    )
    case = (
        root / "tests" / "minimal" / "bellatrix" / "transition" / "core"
        / "pyspec_tests" / "altair_to_bellatrix"
    )
    _write(case, "pre", t_pre.serialize())
    for i, signed in enumerate(t_blocks):
        _write(case, f"blocks_{i}", signed.serialize())
    _write(case, "post", th.chain.head_state.serialize())
    # last pre-fork block: the final altair-epoch slot (fork at epoch 1)
    fork_block = sum(
        1 for s in t_blocks if s.message.slot < E.SLOTS_PER_EPOCH
    ) - 1
    _write(
        case,
        "meta",
        {
            "post_fork": "bellatrix",
            "fork_epoch": 1,
            "fork_block": fork_block,
            "blocks_count": len(t_blocks),
        },
    )
    count += 1

    # --- bls (real crypto; fork-agnostic: tests/general/phase0/bls) -------
    bls.set_backend("host")
    try:
        bls_base = root / "tests" / "general" / "phase0" / "bls"
        kps = bls.interop_keypairs(4)
        msg = bytes(range(32))
        sig = kps[0].sk.sign(msg)
        _write(
            bls_base / "verify" / "small" / "verify_valid",
            "data",
            {
                "input": {
                    "pubkey": "0x" + kps[0].pk.to_bytes().hex(),
                    "message": "0x" + msg.hex(),
                    "signature": "0x" + sig.to_bytes().hex(),
                },
                "output": True,
            },
        )
        _write(
            bls_base / "verify" / "small" / "verify_wrong_key",
            "data",
            {
                "input": {
                    "pubkey": "0x" + kps[1].pk.to_bytes().hex(),
                    "message": "0x" + msg.hex(),
                    "signature": "0x" + sig.to_bytes().hex(),
                },
                "output": False,
            },
        )
        count += 2

        sigs = [kp.sk.sign(msg) for kp in kps[:3]]
        agg = bls.AggregateSignature.from_signatures(sigs).to_signature()
        _write(
            bls_base / "aggregate" / "small" / "aggregate_3",
            "data",
            {
                "input": ["0x" + s.to_bytes().hex() for s in sigs],
                "output": "0x" + agg.to_bytes().hex(),
            },
        )
        _write(
            bls_base / "fast_aggregate_verify" / "small" / "fav_valid",
            "data",
            {
                "input": {
                    "pubkeys": ["0x" + kp.pk.to_bytes().hex() for kp in kps[:3]],
                    "message": "0x" + msg.hex(),
                    "signature": "0x" + agg.to_bytes().hex(),
                },
                "output": True,
            },
        )
        msgs = [bytes([i]) * 32 for i in range(3)]
        persig = [kp.sk.sign(m) for kp, m in zip(kps[:3], msgs)]
        _write(
            bls_base / "batch_verify" / "small" / "batch_valid",
            "data",
            {
                "input": {
                    "pubkeys": ["0x" + kp.pk.to_bytes().hex() for kp in kps[:3]],
                    "messages": ["0x" + m.hex() for m in msgs],
                    "signatures": ["0x" + s.to_bytes().hex() for s in persig],
                },
                "output": True,
            },
        )
        bad = list(persig)
        bad[1] = persig[2]
        _write(
            bls_base / "batch_verify" / "small" / "batch_invalid",
            "data",
            {
                "input": {
                    "pubkeys": ["0x" + kp.pk.to_bytes().hex() for kp in kps[:3]],
                    "messages": ["0x" + m.hex() for m in msgs],
                    "signatures": ["0x" + s.to_bytes().hex() for s in bad],
                },
                "output": False,
            },
        )
        _write(
            bls_base / "sign" / "small" / "sign_case_0",
            "data",
            {
                "input": {
                    "privkey": "0x" + kps[0].sk.to_bytes().hex(),
                    "message": "0x" + msg.hex(),
                },
                "output": "0x" + sig.to_bytes().hex(),
            },
        )
        count += 4
    finally:
        bls.set_backend("fake_crypto")

    count += _generate_fork_choice_goldens(base)
    return count


def _generate_fork_choice_goldens(base: pathlib.Path) -> int:
    """fork_choice/* cases: a finalizing chain, an LMD reorg, and an
    invalid future block. The expected `checks` values come from replaying
    the steps against a live ForkChoice with the handler's exact
    semantics (ticks are absolute seconds; timely = first third of the
    slot)."""
    from ..fork_choice.fork_choice import ForkChoice
    from ..state_processing import (
        BlockSignatureStrategy,
        per_block_processing,
    )
    from ..state_processing.accessors import get_indexed_attestation

    t = build_types(E)

    class Replay:
        """Mirror of the ef-test ForkChoiceHandler step semantics."""

        def __init__(self, anchor_state, anchor_block, spec):
            from .ef_tests import anchor_root_of

            self.spec = spec
            self.root = anchor_root_of(anchor_state, t)
            self.fc = ForkChoice.from_anchor(
                self.root, anchor_state, spec, E
            )
            self.states = {self.root: anchor_state}
            self.genesis_time = int(anchor_state.genesis_time)
            self.slot = int(anchor_state.slot)
            self.last_tick = (
                self.genesis_time + self.slot * spec.seconds_per_slot
            )
            self.steps = []

        def tick_at(self, tick: int):
            self.last_tick = tick
            self.slot = max(
                self.slot,
                (tick - self.genesis_time) // self.spec.seconds_per_slot,
            )
            self.fc.on_tick(self.slot)
            self.steps.append({"tick": tick})

        def tick_for_slot(self, slot: int):
            self.tick_at(self.genesis_time + slot * self.spec.seconds_per_slot)

        def block(self, case_dir, signed, name):
            block = signed.message
            post = self.states[bytes(block.parent_root)].copy()
            while post.slot < block.slot:
                per_slot_processing(post, self.spec, E)
            per_block_processing(
                post, signed, self.spec, E,
                strategy=BlockSignatureStrategy.NO_VERIFICATION,
            )
            from .ef_tests import block_is_timely

            root = block.hash_tree_root()
            timely = block_is_timely(
                block.slot, self.slot, self.last_tick, self.genesis_time,
                self.spec.seconds_per_slot,
            )
            self.fc.on_block(self.slot, block, root, post, is_timely=timely)
            self.states[root] = post
            _write(case_dir, name, signed.serialize())
            self.steps.append({"block": name})
            return root

        def attestation(self, case_dir, att, name):
            st = self.states[bytes(att.data.beacon_block_root)].copy()
            while st.slot < int(att.data.slot):
                per_slot_processing(st, self.spec, E)
            self.fc.on_attestation(get_indexed_attestation(st, att, E))
            _write(case_dir, name, t.Attestation.serialize_value(att))
            self.steps.append({"attestation": name})

        def checks(self):
            head = self.fc.get_head(self.slot)
            self.steps.append(
                {
                    "checks": {
                        "head": {
                            "slot": int(self.states[head].slot),
                            "root": "0x" + head.hex(),
                        },
                        "justified_checkpoint": {
                            "epoch": int(self.fc.store.justified_checkpoint.epoch),
                            "root": "0x"
                            + self.fc.store.justified_checkpoint.root.hex(),
                        },
                        "finalized_checkpoint": {
                            "epoch": int(self.fc.store.finalized_checkpoint.epoch),
                            "root": "0x"
                            + self.fc.store.finalized_checkpoint.root.hex(),
                        },
                    }
                }
            )

    def anchor_of(h):
        """Anchor block mirroring the genesis latest_block_header."""
        state = h.genesis_state.copy()
        tf = t.types_for_fork(t.fork_of_state(state))
        return state, tf.BeaconBlock(state_root=state.hash_tree_root())

    suite = base / "fork_choice" / "on_block" / "pyspec_tests"
    count = 0

    # --- chain_finalizes: 2.5 epochs of attested blocks ------------------
    h, spec = _altair_harness(16)
    anchor_state, anchor_block = anchor_of(h)
    case = suite / "chain_finalizes"
    _write(case, "anchor_state", anchor_state.serialize())
    _write(case, "anchor_block", anchor_block.serialize())
    rp = Replay(anchor_state.copy(), anchor_block, spec)
    pending = []
    for i, slot in enumerate(range(1, 5 * E.SLOTS_PER_EPOCH + 1)):
        rp.tick_for_slot(slot)
        produced = h.produce_block(slot, pending)
        h.process_block(
            produced.block, strategy=BlockSignatureStrategy.NO_VERIFICATION
        )
        rp.block(case, produced.block, f"block_{i}")
        pending = h.produce_attestations(
            h.state.copy(), slot, h.head_block_root()
        )
    rp.checks()
    assert rp.fc.store.finalized_checkpoint.epoch >= 1, "scenario must finalize"
    _write(case, "steps", rp.steps)
    count += 1

    # --- lmd_reorg: two siblings, votes pick the head ---------------------
    h, spec = _altair_harness(16)
    anchor_state, anchor_block = anchor_of(h)
    case = suite / "lmd_reorg"
    _write(case, "anchor_state", anchor_state.serialize())
    _write(case, "anchor_block", anchor_block.serialize())
    rp = Replay(anchor_state.copy(), anchor_block, spec)
    a = h.produce_block(1, [])
    # a competing sibling: same parent, different graffiti
    h2, _ = _altair_harness(16)
    sib = h2.produce_block(1, [])
    sib.block.message.body.graffiti = b"\x55" * 32
    sib.block.message.state_root = b"\x00" * 32
    # re-fill the sibling's state root through the harness signer path
    post = h2.state.copy()
    from ..state_processing.per_block import ConsensusContext

    while post.slot < 1:
        per_slot_processing(post, spec, E)
    ctxt = ConsensusContext(1)
    ctxt.set_proposer_index(int(sib.block.message.proposer_index))
    tf2 = t.types_for_fork(t.fork_of_state(post))
    per_block_processing(
        post, tf2.SignedBeaconBlock(message=sib.block.message), spec, E,
        strategy=BlockSignatureStrategy.NO_VERIFICATION, ctxt=ctxt,
        verify_block_root=False,
    )
    sib.block.message.state_root = post.hash_tree_root()
    signed_sib = h2.sign_block(sib.block.message, int(sib.block.message.proposer_index))
    # non-timely arrivals (mid-slot tick): no proposer boost — pure LMD
    # weight decides
    rp.tick_at(
        rp.genesis_time
        + spec.seconds_per_slot
        + spec.seconds_per_slot // 2
    )
    root_a = rp.block(case, a.block, "block_a")
    root_b = rp.block(case, signed_sib, "block_b")
    # everyone votes the sibling at slot 2; votes become usable one slot
    # later (spec: attestation.slot + 1 <= current_slot)
    rp.tick_for_slot(2)
    h2.process_block(
        signed_sib, strategy=BlockSignatureStrategy.NO_VERIFICATION
    )
    votes = h2.produce_attestations(h2.state.copy(), 2, root_b)
    rp.tick_for_slot(3)
    for j, att in enumerate(votes):
        rp.attestation(case, att, f"att_{j}")
    rp.checks()
    head = rp.fc.get_head(rp.slot)
    assert head == root_b, "votes must reorg the head to the sibling"
    _write(case, "steps", rp.steps)
    count += 1

    # --- invalid_future_block: slot beyond the current tick ---------------
    h, spec = _altair_harness(8)
    anchor_state, anchor_block = anchor_of(h)
    case = suite / "invalid_future_block"
    _write(case, "anchor_state", anchor_state.serialize())
    _write(case, "anchor_block", anchor_block.serialize())
    rp = Replay(anchor_state.copy(), anchor_block, spec)
    rp.tick_for_slot(1)
    future = h.produce_block(5, [])  # tick still at slot 1
    _write(case, "block_future", future.block.serialize())
    rp.steps.append({"block": "block_future", "valid": False})
    _write(case, "steps", rp.steps)
    count += 1

    return count
