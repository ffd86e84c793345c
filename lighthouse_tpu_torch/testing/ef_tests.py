"""ef-test-style conformance runner.

Counterpart of lighthouse_tpu/testing/ef_tests.py, copied.

Mirrors testing/ef_tests/src/handler.rs:10-50: handlers walk the official
`consensus-spec-tests` directory layout

    <root>/tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>/

and execute each case against this implementation. Vectors may be the real
`.ssz_snappy` files (decoded by the bundled pure-Python snappy) or plain
`.ssz`/`.yaml` goldens. The image has no network access, so
`generate_goldens` produces a local vector set from the harness — pinning
current behavior so regressions in any covered family fail the runner —
and `run_all` + `check_all_files_accessed` (the Makefile:152 analog)
verify that no vector file is silently skipped.

Families covered: operations (attestation, attester_slashing,
block_header, deposit, proposer_slashing, voluntary_exit, sync_aggregate,
withdrawals, bls_to_execution_change), sanity (slots, blocks),
epoch_processing (all altair stages), shuffling, ssz_static, bls (verify,
aggregate, fast_aggregate_verify, batch_verify, sign), and fork upgrades.
"""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass, replace

import yaml

from ..crypto import bls
from ..state_processing import per_slot_processing
from ..state_processing.per_block import ConsensusContext
from ..types.chain_spec import ForkName, mainnet_spec, minimal_spec
from ..types.containers import build_types
from ..types.eth_spec import MainnetEthSpec, MinimalEthSpec
from .snappy import decompress


class CaseFailure(AssertionError):
    pass


@dataclass
class Context:
    config: str
    fork: ForkName
    spec: object
    E: object
    types: object
    tf: object  # fork-specific namespace


def _spec_for(config: str, fork: ForkName):
    base = minimal_spec() if config == "minimal" else mainnet_spec()
    order = [
        ForkName.ALTAIR,
        ForkName.BELLATRIX,
        ForkName.CAPELLA,
        ForkName.DENEB,
        ForkName.ELECTRA,
    ]
    kw = {}
    for f in order:
        key = f"{f.value}_fork_epoch"
        kw[key] = 0 if order.index(f) <= (order.index(fork) if fork in order else -1) else None
    return replace(base, **kw)


def make_context(config: str, fork_name: str) -> Context:
    fork = ForkName(fork_name)
    E = MinimalEthSpec if config == "minimal" else MainnetEthSpec
    types = build_types(E)
    return Context(
        config=config,
        fork=fork,
        spec=_spec_for(config, fork),
        E=E,
        types=types,
        tf=types.types_for_fork(fork),
    )


class Case:
    """One test-case directory; tracks which files were read."""

    def __init__(self, path: pathlib.Path, accessed: set):
        self.path = path
        self._accessed = accessed

    def _find(self, stem: str):
        for ext in (".ssz_snappy", ".ssz", ".yaml"):
            p = self.path / f"{stem}{ext}"
            if p.exists():
                return p
        return None

    def has(self, stem: str) -> bool:
        return self._find(stem) is not None

    def ssz_bytes(self, stem: str) -> bytes:
        p = self._find(stem)
        if p is None:
            raise CaseFailure(f"{self.path}: missing {stem}")
        self._accessed.add(str(p))
        raw = p.read_bytes()
        if p.suffix == ".ssz_snappy":
            return decompress(raw)
        return raw

    def yaml(self, stem: str):
        p = self.path / f"{stem}.yaml"
        if not p.exists():
            raise CaseFailure(f"{self.path}: missing {stem}.yaml")
        self._accessed.add(str(p))
        with open(p) as f:
            return yaml.safe_load(f)

    def maybe_yaml(self, stem: str):
        p = self.path / f"{stem}.yaml"
        if not p.exists():
            return None
        return self.yaml(stem)


def _verify_sigs() -> bool:
    return not bls.get_backend().fake


# ---------------------------------------------------------------------------
# Handlers (handler.rs Handler trait analog)
# ---------------------------------------------------------------------------


class Handler:
    runner: str
    handler: str

    def run(self, case: Case, ctx: Context):
        raise NotImplementedError


def _expect_post(case: Case, ctx: Context, state, mutate):
    """Run `mutate(state)`; if `post` exists it must match, else the
    mutation must raise (invalid case)."""
    if case.has("post"):
        mutate(state)
        post = type(state).deserialize(case.ssz_bytes("post"))
        if state.hash_tree_root() != post.hash_tree_root():
            raise CaseFailure(f"{case.path}: post-state root mismatch")
    else:
        try:
            mutate(state)
        except Exception:
            return
        raise CaseFailure(f"{case.path}: invalid case was accepted")


class OperationsHandler(Handler):
    runner = "operations"

    # handler name -> (input stem, ssz type attr on tf, apply fn name)
    OPS = {
        "attestation": "attestation",
        "attester_slashing": "attester_slashing",
        "block_header": "block",
        "deposit": "deposit",
        "proposer_slashing": "proposer_slashing",
        "voluntary_exit": "voluntary_exit",
        "sync_aggregate": "sync_aggregate",
        "withdrawals": "execution_payload",
        "bls_to_execution_change": "address_change",
    }

    def __init__(self, name: str):
        self.handler = name
        self.stem = self.OPS[name]

    def _input_type(self, ctx: Context):
        t, tf = ctx.types, ctx.tf
        return {
            "attestation": t.Attestation,
            "attester_slashing": t.AttesterSlashing,
            "block_header": tf.BeaconBlock,
            "deposit": t.Deposit,
            "proposer_slashing": t.ProposerSlashing,
            "voluntary_exit": t.SignedVoluntaryExit,
            "sync_aggregate": t.SyncAggregate,
            "withdrawals": tf.ExecutionPayload,
            "bls_to_execution_change": t.SignedBLSToExecutionChange,
        }[self.handler]

    def run(self, case: Case, ctx: Context):
        from ..state_processing import altair as A
        from ..state_processing import capella as C
        from ..state_processing import per_block as PB

        state = ctx.tf.BeaconState.deserialize(case.ssz_bytes("pre"))
        op = self._input_type(ctx).deserialize(case.ssz_bytes(self.stem))
        verify = _verify_sigs()

        def mutate(st):
            if self.handler == "attestation":
                if ctx.fork >= ForkName.ALTAIR:
                    A.process_attestation_altair(
                        st, op, ctx.spec, ctx.E,
                        verify, ConsensusContext(st.slot), ctx.fork,
                    )
                else:
                    PB.process_attestation(
                        st, op, ctx.spec, ctx.E, verify, ConsensusContext(st.slot)
                    )
            elif self.handler == "attester_slashing":
                PB.process_attester_slashing(st, op, ctx.spec, ctx.E, verify)
            elif self.handler == "proposer_slashing":
                PB.process_proposer_slashing(st, op, ctx.spec, ctx.E, verify)
            elif self.handler == "block_header":
                PB.process_block_header(st, op, ConsensusContext(op.slot), ctx.E)
            elif self.handler == "deposit":
                PB.process_deposit(st, op, ctx.spec, ctx.E)
            elif self.handler == "voluntary_exit":
                PB.process_voluntary_exit(st, op, ctx.spec, ctx.E, verify)
            elif self.handler == "sync_aggregate":
                A.process_sync_aggregate(
                    st, op, ctx.spec, ctx.E, verify, ConsensusContext(st.slot)
                )
            elif self.handler == "withdrawals":
                C.process_withdrawals(st, op, ctx.E, spec=ctx.spec)
            elif self.handler == "bls_to_execution_change":
                C.process_bls_to_execution_change(st, op, ctx.spec, ctx.E, verify)

        _expect_post(case, ctx, state, mutate)


class SanitySlotsHandler(Handler):
    runner = "sanity"
    handler = "slots"

    def run(self, case: Case, ctx: Context):
        state = ctx.tf.BeaconState.deserialize(case.ssz_bytes("pre"))
        n_slots = case.yaml("slots")

        def mutate(st):
            for _ in range(int(n_slots)):
                per_slot_processing(st, ctx.spec, ctx.E)

        _expect_post(case, ctx, state, mutate)


class SanityBlocksHandler(Handler):
    runner = "sanity"
    handler = "blocks"

    def run(self, case: Case, ctx: Context):
        from ..state_processing import (
            BlockSignatureStrategy,
            per_block_processing,
        )

        meta = case.maybe_yaml("meta") or {}
        count = int(meta.get("blocks_count", 1))
        state = ctx.tf.BeaconState.deserialize(case.ssz_bytes("pre"))
        blocks = [
            ctx.tf.SignedBeaconBlock.deserialize(case.ssz_bytes(f"blocks_{i}"))
            for i in range(count)
        ]
        strategy = (
            BlockSignatureStrategy.VERIFY_BULK
            if _verify_sigs()
            else BlockSignatureStrategy.NO_VERIFICATION
        )

        def mutate(st):
            for signed in blocks:
                while st.slot < signed.message.slot:
                    per_slot_processing(st, ctx.spec, ctx.E)
                per_block_processing(
                    st, signed, ctx.spec, ctx.E, strategy=strategy
                )

        _expect_post(case, ctx, state, mutate)


class EpochProcessingHandler(Handler):
    runner = "epoch_processing"

    def __init__(self, sub: str):
        self.handler = sub

    def run(self, case: Case, ctx: Context):
        from ..state_processing import altair as A
        from ..state_processing import per_epoch as PE

        state = ctx.tf.BeaconState.deserialize(case.ssz_bytes("pre"))
        sub = self.handler

        def mutate(st):
            if sub == "justification_and_finalization":
                if ctx.fork >= ForkName.ALTAIR:
                    A.process_justification_and_finalization_altair(st, ctx.E)
                else:
                    PE.process_justification_and_finalization(st, ctx.E)
            elif sub == "inactivity_updates":
                A.process_inactivity_updates(st, ctx.spec, ctx.E)
            elif sub == "rewards_and_penalties":
                A.process_rewards_and_penalties_altair(
                    st, ctx.spec, ctx.E, ctx.fork
                )
            elif sub == "registry_updates":
                PE.process_registry_updates(st, ctx.spec, ctx.E)
            elif sub == "slashings":
                A.process_slashings_altair(st, ctx.E, ctx.fork)
            elif sub == "effective_balance_updates":
                if ctx.fork >= ForkName.ELECTRA:
                    from ..state_processing import electra as EL

                    EL.process_effective_balance_updates_electra(
                        st, ctx.spec, ctx.E
                    )
                else:
                    PE.process_effective_balance_updates(st, ctx.E)
            elif sub == "participation_flag_updates":
                A.process_participation_flag_updates(st, ctx.E)
            elif sub == "eth1_data_reset":
                PE.process_eth1_data_reset(st, ctx.E)
            elif sub == "randao_mixes_reset":
                PE.process_randao_mixes_reset(st, ctx.E)
            elif sub == "slashings_reset":
                PE.process_slashings_reset(st, ctx.E)
            else:
                raise CaseFailure(f"unknown epoch_processing handler {sub}")

        _expect_post(case, ctx, state, mutate)


class ShufflingHandler(Handler):
    runner = "shuffling"
    handler = "core"

    def run(self, case: Case, ctx: Context):
        from ..state_processing.shuffle import compute_shuffled_index, shuffle_list

        data = case.yaml("mapping")
        seed = bytes.fromhex(str(data["seed"]).removeprefix("0x"))
        count = int(data["count"])
        mapping = [int(x) for x in data["mapping"]]
        rounds = ctx.E.SHUFFLE_ROUND_COUNT
        got = shuffle_list(list(range(count)), seed, rounds)
        if got != mapping:
            raise CaseFailure(f"{case.path}: whole-list shuffle mismatch")
        for i in range(count):
            if mapping[i] != compute_shuffled_index(i, count, seed, rounds):
                raise CaseFailure(f"{case.path}: per-index shuffle mismatch at {i}")


class SszStaticHandler(Handler):
    runner = "ssz_static"

    def __init__(self, type_name: str):
        self.handler = type_name

    def run(self, case: Case, ctx: Context):
        t = getattr(ctx.tf, self.handler, None) or getattr(
            ctx.types, self.handler, None
        )
        if t is None:
            raise CaseFailure(f"unknown ssz type {self.handler}")
        serialized = case.ssz_bytes("serialized")
        roots = case.yaml("roots")
        value = t.deserialize(serialized)
        if t.serialize_value(value) != serialized:
            raise CaseFailure(f"{case.path}: reserialization mismatch")
        want = bytes.fromhex(str(roots["root"]).removeprefix("0x"))
        if t.hash_tree_root_of(value) != want:
            raise CaseFailure(f"{case.path}: hash_tree_root mismatch")


class BlsHandler(Handler):
    runner = "bls"

    def __init__(self, kind: str):
        self.handler = kind

    def run(self, case: Case, ctx: Context):
        data = case.yaml("data")
        inp, out = data["input"], data["output"]
        hx = lambda s: bytes.fromhex(str(s).removeprefix("0x"))
        kind = self.handler
        try:
            if kind == "verify":
                got = bls.Signature(hx(inp["signature"])).verify(
                    bls.PublicKey(hx(inp["pubkey"])), hx(inp["message"])
                )
            elif kind == "aggregate":
                sigs = [bls.Signature(hx(s)) for s in inp]
                if not sigs:
                    got = None
                else:
                    got = (
                        bls.AggregateSignature.from_signatures(sigs)
                        .to_signature()
                        .to_bytes()
                    )
            elif kind == "fast_aggregate_verify":
                agg = bls.AggregateSignature()
                agg._point = bls.Signature(hx(inp["signature"])).point()
                agg._empty = False
                got = agg.fast_aggregate_verify(
                    [bls.PublicKey(hx(p)) for p in inp["pubkeys"]],
                    hx(inp["message"]),
                )
            elif kind == "sign":
                got = (
                    bls.SecretKey.from_bytes(hx(inp["privkey"]))
                    .sign(hx(inp["message"]))
                    .to_bytes()
                )
            elif kind == "batch_verify":
                sets = [
                    bls.SignatureSet.single(
                        bls.Signature(hx(s)), bls.PublicKey(hx(p)), hx(m)
                    )
                    for p, m, s in zip(
                        inp["pubkeys"], inp["messages"], inp["signatures"]
                    )
                ]
                got = bls.get_backend().verify_signature_sets(sets)
            else:
                raise CaseFailure(f"unknown bls handler {kind}")
        except (bls.BlsError, ValueError):
            got = False if out is not None and isinstance(out, bool) else None
        want = out
        if isinstance(want, str):
            want = hx(want)
        if got != want:
            raise CaseFailure(f"{case.path}: bls {kind}: {got!r} != {want!r}")


class ForkUpgradeHandler(Handler):
    runner = "fork"
    handler = "fork"

    def run(self, case: Case, ctx: Context):
        meta = case.yaml("meta")
        post_fork = ForkName(meta["fork"])
        pre_ctx_fork = {
            ForkName.ALTAIR: ForkName.PHASE0,
            ForkName.BELLATRIX: ForkName.ALTAIR,
            ForkName.CAPELLA: ForkName.BELLATRIX,
            ForkName.DENEB: ForkName.CAPELLA,
            ForkName.ELECTRA: ForkName.DENEB,
        }[post_fork]
        pre_tf = ctx.types.types_for_fork(pre_ctx_fork)
        state = pre_tf.BeaconState.deserialize(case.ssz_bytes("pre"))
        from ..state_processing.upgrades import UPGRADES

        spec = _spec_for(ctx.config, post_fork)

        def mutate(st):
            UPGRADES[post_fork](st, spec, ctx.E)

        if case.has("post"):
            mutate(state)
            post = ctx.types.types_for_fork(post_fork).BeaconState.deserialize(
                case.ssz_bytes("post")
            )
            if state.hash_tree_root() != post.hash_tree_root():
                raise CaseFailure(f"{case.path}: fork post mismatch")
        else:
            raise CaseFailure(f"{case.path}: fork cases need post")


class TransitionHandler(Handler):
    """transition/core (cases/transition.rs): blocks cross a fork
    boundary — the pre state and early blocks are the PREVIOUS fork's
    types, the fork activates at meta.fork_epoch mid-run, late blocks are
    the case fork's types."""

    runner = "transition"
    handler = "core"

    PRE_FORK = {
        ForkName.ALTAIR: ForkName.PHASE0,
        ForkName.BELLATRIX: ForkName.ALTAIR,
        ForkName.CAPELLA: ForkName.BELLATRIX,
        ForkName.DENEB: ForkName.CAPELLA,
        ForkName.ELECTRA: ForkName.DENEB,
    }

    def run(self, case: Case, ctx: Context):
        import dataclasses

        from ..state_processing import (
            BlockSignatureStrategy,
            per_block_processing,
        )

        meta = case.yaml("meta")
        fork_epoch = int(meta["fork_epoch"])
        count = int(meta["blocks_count"])
        # fork_block: index of the last pre-fork block (None = all post)
        fork_block = meta.get("fork_block")
        post_fork = ctx.fork
        pre_fork = self.PRE_FORK[post_fork]
        pre_tf = ctx.types.types_for_fork(pre_fork)
        post_tf = ctx.tf
        spec = dataclasses.replace(
            _spec_for(ctx.config, pre_fork),
            **{f"{post_fork.name.lower()}_fork_epoch": fork_epoch},
        )
        state = pre_tf.BeaconState.deserialize(case.ssz_bytes("pre"))
        blocks = []
        for i in range(count):
            tf = (
                pre_tf
                if fork_block is not None and i <= int(fork_block)
                else post_tf
            )
            blocks.append(
                tf.SignedBeaconBlock.deserialize(case.ssz_bytes(f"blocks_{i}"))
            )
        strategy = (
            BlockSignatureStrategy.VERIFY_BULK
            if _verify_sigs()
            else BlockSignatureStrategy.NO_VERIFICATION
        )

        def mutate(st):
            for signed in blocks:
                while st.slot < signed.message.slot:
                    per_slot_processing(st, spec, ctx.E)
                per_block_processing(st, signed, spec, ctx.E, strategy=strategy)

        _expect_post(case, ctx, state, mutate)


def anchor_root_of(anchor_state, types) -> bytes:
    """Anchor root: the state's latest_block_header with its state root
    filled — identical to hash_tree_root(anchor_block) on canonical
    vectors, and correct for fork-at-genesis states whose header was
    carried through the phase0 upgrade path. Shared by the handler and
    the golden generator so the two cannot diverge."""
    hdr = anchor_state.latest_block_header
    return types.BeaconBlockHeader(
        slot=hdr.slot,
        proposer_index=hdr.proposer_index,
        parent_root=hdr.parent_root,
        state_root=anchor_state.hash_tree_root()
        if bytes(hdr.state_root) == b"\x00" * 32
        else hdr.state_root,
        body_root=hdr.body_root,
    ).hash_tree_root()


def block_is_timely(block_slot: int, current_slot: int, last_tick: int,
                    genesis_time: int, seconds_per_slot: int) -> bool:
    """Proposer-boost timeliness: the block's slot is current and the
    last tick lands in the first third of it."""
    return (
        int(block_slot) == current_slot
        and ((last_tick - genesis_time) % seconds_per_slot) * 3
        < seconds_per_slot
    )


class ForkChoiceHandler(Handler):
    """fork_choice/* (handler.rs ForkChoiceHandler, cases/fork_choice.rs):
    drive a ForkChoice store from an anchor with tick/block/attestation
    steps and assert the head/checkpoint expectations after each `checks`
    step. Ticks are seconds since the Unix epoch (the spec's store.time);
    a block is timely when its tick lands in the first third of its slot
    (proposer boost)."""

    runner = "fork_choice"

    def __init__(self, handler: str):
        self.handler = handler

    def run(self, case: Case, ctx: Context):
        from ..fork_choice.fork_choice import ForkChoice, ForkChoiceError
        from ..state_processing import (
            BlockSignatureStrategy,
            per_block_processing,
        )
        from ..state_processing.accessors import get_indexed_attestation

        anchor_state = ctx.tf.BeaconState.deserialize(
            case.ssz_bytes("anchor_state")
        )
        case.ssz_bytes("anchor_block")  # present per format; root from state
        anchor_root = anchor_root_of(anchor_state, ctx.types)
        fc = ForkChoice.from_anchor(anchor_root, anchor_state, ctx.spec, ctx.E)
        states = {anchor_root: anchor_state}
        genesis_time = int(anchor_state.genesis_time)
        spb = ctx.spec.seconds_per_slot
        current_slot = int(anchor_state.slot)
        last_tick = genesis_time + current_slot * spb
        strategy = (
            BlockSignatureStrategy.VERIFY_BULK
            if _verify_sigs()
            else BlockSignatureStrategy.NO_VERIFICATION
        )

        for step in case.yaml("steps"):
            if "tick" in step:
                last_tick = int(step["tick"])
                current_slot = max(
                    current_slot, (last_tick - genesis_time) // spb
                )
                fc.on_tick(current_slot)
            elif "block" in step:
                signed = ctx.tf.SignedBeaconBlock.deserialize(
                    case.ssz_bytes(step["block"])
                )
                block = signed.message
                valid = step.get("valid", True)
                try:
                    parent = states.get(bytes(block.parent_root))
                    if parent is None:
                        raise ForkChoiceError("unknown parent")
                    post = parent.copy()
                    while post.slot < block.slot:
                        per_slot_processing(post, ctx.spec, ctx.E)
                    per_block_processing(
                        post, signed, ctx.spec, ctx.E, strategy=strategy
                    )
                    root = block.hash_tree_root()
                    timely = block_is_timely(
                        block.slot, current_slot, last_tick, genesis_time, spb
                    )
                    fc.on_block(
                        current_slot, block, root, post, is_timely=timely
                    )
                except Exception as e:  # noqa: BLE001 — judged by `valid`
                    if valid:
                        raise CaseFailure(
                            f"{case.path}: valid block rejected: {e}"
                        ) from e
                    continue
                if not valid:
                    raise CaseFailure(
                        f"{case.path}: invalid block {step['block']} accepted"
                    )
                states[root] = post
            elif "attestation" in step:
                valid = step.get("valid", True)
                try:
                    att = ctx.types.Attestation.deserialize(
                        case.ssz_bytes(step["attestation"])
                    )
                    src = states.get(bytes(att.data.beacon_block_root))
                    if src is None:
                        raise ForkChoiceError("attestation for unknown block")
                    st = src.copy()
                    while st.slot < int(att.data.slot):
                        per_slot_processing(st, ctx.spec, ctx.E)
                    fc.on_attestation(get_indexed_attestation(st, att, ctx.E))
                except Exception as e:  # noqa: BLE001 — judged by `valid`
                    if valid:
                        raise CaseFailure(
                            f"{case.path}: valid attestation rejected: {e}"
                        ) from e
                    continue
                if not valid:
                    raise CaseFailure(
                        f"{case.path}: invalid attestation accepted"
                    )
            elif "attester_slashing" in step:
                slashing = ctx.types.AttesterSlashing.deserialize(
                    case.ssz_bytes(step["attester_slashing"])
                )
                both = set(
                    int(i) for i in slashing.attestation_1.attesting_indices
                ) & set(int(i) for i in slashing.attestation_2.attesting_indices)
                fc.on_equivocation(sorted(both))
            elif "checks" in step:
                checks = step["checks"]
                head = fc.get_head(current_slot)
                if "head" in checks:
                    want = checks["head"]
                    if head.hex() != want["root"].removeprefix("0x"):
                        raise CaseFailure(
                            f"{case.path}: head {head.hex()[:12]} != "
                            f"{want['root'][:14]}"
                        )
                    got_slot = int(states[head].slot)
                    if int(want["slot"]) != got_slot:
                        raise CaseFailure(
                            f"{case.path}: head slot {got_slot} != {want['slot']}"
                        )
                for key, cp in (
                    ("justified_checkpoint", fc.store.justified_checkpoint),
                    ("finalized_checkpoint", fc.store.finalized_checkpoint),
                ):
                    if key in checks:
                        want = checks[key]
                        if (
                            int(want["epoch"]) != cp.epoch
                            or want["root"].removeprefix("0x") != cp.root.hex()
                        ):
                            raise CaseFailure(
                                f"{case.path}: {key} ({cp.epoch}, "
                                f"{cp.root.hex()[:12]}) != {want}"
                            )
                if "proposer_boost_root" in checks:
                    want = checks["proposer_boost_root"].removeprefix("0x")
                    got = fc.store.proposer_boost_root.hex()
                    if want != got:
                        raise CaseFailure(
                            f"{case.path}: proposer_boost_root {got[:12]} != "
                            f"{want[:12]}"
                        )
            else:
                raise CaseFailure(f"{case.path}: unknown step {step}")


# ---------------------------------------------------------------------------
# The walker
# ---------------------------------------------------------------------------


def _handler_for(runner: str, handler: str) -> Handler | None:
    if runner == "operations" and handler in OperationsHandler.OPS:
        return OperationsHandler(handler)
    if runner == "sanity" and handler == "slots":
        return SanitySlotsHandler()
    if runner == "sanity" and handler == "blocks":
        return SanityBlocksHandler()
    if runner == "epoch_processing":
        return EpochProcessingHandler(handler)
    if runner == "shuffling":
        return ShufflingHandler()
    if runner == "ssz_static":
        return SszStaticHandler(handler)
    if runner == "bls":
        return BlsHandler(handler)
    if runner == "fork":
        return ForkUpgradeHandler()
    if runner == "transition" and handler == "core":
        return TransitionHandler()
    if runner == "fork_choice":
        return ForkChoiceHandler(handler)
    return None


@dataclass
class Report:
    passed: int = 0
    failed: int = 0
    skipped: int = 0
    failures: list = None

    def __post_init__(self):
        if self.failures is None:
            self.failures = []


def run_all(root: str | os.PathLike, config: str | None = None) -> Report:
    """Walk `<root>/tests/...` and run every recognized case."""
    root = pathlib.Path(root)
    tests_dir = root / "tests"
    report = Report()
    accessed: set[str] = set()
    for config_dir in sorted(tests_dir.iterdir()):
        if config is not None and config_dir.name != config:
            continue
        for fork_dir in sorted(p for p in config_dir.iterdir() if p.is_dir()):
            if fork_dir.name == "bls":  # bls vectors are fork-agnostic: tests/<config>/bls
                continue
            for runner_dir in sorted(p for p in fork_dir.iterdir() if p.is_dir()):
                for handler_dir in sorted(
                    p for p in runner_dir.iterdir() if p.is_dir()
                ):
                    h = _handler_for(runner_dir.name, handler_dir.name)
                    ctx = make_context(config_dir.name, fork_dir.name)
                    for suite_dir in sorted(
                        p for p in handler_dir.iterdir() if p.is_dir()
                    ):
                        for case_dir in sorted(
                            p for p in suite_dir.iterdir() if p.is_dir()
                        ):
                            if h is None:
                                report.skipped += 1
                                continue
                            case = Case(case_dir, accessed)
                            try:
                                h.run(case, ctx)
                                report.passed += 1
                            except Exception as e:  # noqa: BLE001
                                report.failed += 1
                                report.failures.append(f"{case_dir}: {e}")
    report.accessed = accessed
    return report


def check_all_files_accessed(root: str | os.PathLike, accessed: set) -> list[str]:
    """Every vector file under root must have been read by some handler
    (testing/ef_tests check_all_files_accessed.py analog)."""
    missed = []
    for dirpath, _dirs, files in os.walk(pathlib.Path(root) / "tests"):
        for f in files:
            p = str(pathlib.Path(dirpath) / f)
            if p not in accessed:
                missed.append(p)
    return missed
