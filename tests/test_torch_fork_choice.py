"""Fork choice of lighthouse_tpu_torch (fork_choice/) against
lighthouse_tpu's, on the 18 scenarios of tests/test_fork_choice.py: vote
weighting, reorgs, viability, proposer boost, equivocation, execution
invalidation, pruning, the ForkChoice wrapper's attestation validation and
its same-slot deferral queue. Each scenario runs once on the JAX package
and once on the port, and returns what it observed (heads, verdicts,
queue lengths, vote columns, metric deltas); the two must be equal. On the
port every proto-array call also goes to the scalar
`proto_array_reference`, which must give the same head at every
`get_head`. Tolerance: exact equality."""

from types import SimpleNamespace

import pytest

import lighthouse_tpu.fork_choice as jax_fc
import lighthouse_tpu.fork_choice.fork_choice as jax_fc_mod
import lighthouse_tpu_torch.fork_choice as port_fc
import lighthouse_tpu_torch.fork_choice.fork_choice as port_fc_mod
from lighthouse_tpu.metrics import REGISTRY as JAX_REGISTRY
from lighthouse_tpu.types.chain_spec import minimal_spec as jax_minimal_spec
from lighthouse_tpu.types.containers import build_types as jax_build_types
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JE
from lighthouse_tpu_torch.metrics import REGISTRY as PORT_REGISTRY
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as port_minimal_spec
from lighthouse_tpu_torch.types.containers import build_types as port_build_types
from lighthouse_tpu_torch.types.eth_spec import MinimalEthSpec as PE

R = lambda i: bytes([i]) * 32  # noqa: E731


class _MirrorArray:
    """The columnar ProtoArray, with the calls that change the tree also
    made on the reference's, and `is_descendant` asked of both."""

    def __init__(self, col, ref):
        object.__setattr__(self, "_col", col)
        object.__setattr__(self, "_ref", ref)

    def __getattr__(self, name):
        return getattr(self._col, name)

    def __setattr__(self, name, value):
        setattr(self._col, name, value)
        setattr(self._ref, name, value)

    def invalidate_block(self, root):
        self._col.invalidate_block(root)
        self._ref.invalidate_block(root)

    def maybe_prune(self, root):
        self._col.maybe_prune(root)
        self._ref.maybe_prune(root)

    def is_descendant(self, a, b):
        got = self._col.is_descendant(a, b)
        assert got == self._ref.is_descendant(a, b)
        return got


class Mirror:
    """The port's columnar ProtoArrayForkChoice fed in step with its scalar
    reference: blocks and votes go to both, and every head must agree."""

    def __init__(self, **kw):
        self.col = port_fc.ProtoArrayForkChoice(**kw)
        self.ref = port_fc.ProtoArrayForkChoiceReference(**kw)
        self.proto_array = _MirrorArray(self.col.proto_array, self.ref.proto_array)

    def __getattr__(self, name):
        return getattr(self.col, name)

    def on_block(self, **kw):
        self.col.on_block(**kw)
        self.ref.on_block(**kw)

    def process_attestation(self, vi, root, epoch):
        self.col.process_attestation(vi, root, epoch)
        self.ref.process_attestation(vi, root, epoch)

    def process_attestation_batch(self, vis, root, epoch):
        self.col.process_attestation_batch(vis, root, epoch)
        for vi in vis:
            self.ref.process_attestation(int(vi), root, epoch)

    def contains_block(self, root):
        got = self.col.contains_block(root)
        assert got == self.ref.contains_block(root)
        return got

    def get_head(self, *args, **kw):
        head = self.col.get_head(*args, **kw)
        assert head == self.ref.get_head(*args, **kw), "columnar and reference heads differ"
        return head


JAX = SimpleNamespace(
    ProtoArrayForkChoice=jax_fc.ProtoArrayForkChoice, fc=jax_fc, mod=jax_fc_mod, REGISTRY=JAX_REGISTRY,
    T=jax_build_types(JE), E=JE, spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    ProtoArrayForkChoice=Mirror, fc=port_fc, mod=port_fc_mod, REGISTRY=PORT_REGISTRY,
    T=port_build_types(PE), E=PE, spec=port_minimal_spec,
)


def make_fc(ns, justified_epoch=0, finalized_epoch=0):
    return ns.ProtoArrayForkChoice(
        finalized_root=R(0),
        finalized_slot=0,
        finalized_state_root=R(100),
        justified_epoch=justified_epoch,
        finalized_epoch=finalized_epoch,
    )


def add_block(fc, slot, root, parent, je=0, fe=0):
    fc.on_block(slot=slot, root=root, parent_root=parent, state_root=root, justified_epoch=je, finalized_epoch=fe)


def head(fc, balances, boost_root=b"\x00" * 32, boost=0, **kw):
    args = dict(justified_checkpoint_root=R(0), justified_epoch=0, finalized_epoch=0)
    args.update(kw)
    return fc.get_head(
        **args, justified_state_balances=balances, proposer_boost_root=boost_root, proposer_boost_amount=boost
    )


# ---------------------------------------------------------------------------
# Proto-array scenarios: each returns the heads it saw
# ---------------------------------------------------------------------------


def single_chain_head(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 2, R(2), R(1))
    return [head(fc, [1, 1])]


def votes_decide_fork(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 1, R(2), R(0))
    for vi, root in ((0, R(1)), (1, R(1)), (2, R(2))):
        fc.process_attestation(vi, root, 1)
    out = [head(fc, [10, 10, 10])]
    fc.process_attestation(0, R(2), 2)
    fc.process_attestation(1, R(2), 2)
    return out + [head(fc, [10, 10, 10])]


def balance_weighting(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 1, R(2), R(0))
    for vi, root in ((0, R(1)), (1, R(2)), (2, R(2))):
        fc.process_attestation(vi, root, 1)
    return [head(fc, [100, 10, 10])]


def tie_break_deterministic(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 1, R(2), R(0))
    return [head(fc, [])]


def proposer_boost_flips_head(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 1, R(2), R(0))
    fc.process_attestation(0, R(1), 1)
    return [head(fc, [10]), head(fc, [10], boost_root=R(2), boost=50), head(fc, [10])]


def viability_filter_justification(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0), je=0)
    add_block(fc, 2, R(2), R(1), je=1)
    add_block(fc, 2, R(3), R(1), je=0)
    fc.process_attestation(0, R(3), 1)
    return [fc.get_head(justified_checkpoint_root=R(0), justified_epoch=1, finalized_epoch=0, justified_state_balances=[10])]


def equivocation_removes_weight(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 1, R(2), R(0))
    fc.process_attestation(0, R(1), 1)
    fc.process_attestation(1, R(2), 1)
    out = [head(fc, [100, 10])]
    out.append(
        fc.get_head(
            justified_checkpoint_root=R(0), justified_epoch=0, finalized_epoch=0,
            justified_state_balances=[100, 10], equivocating_indices={0},
        )
    )
    return out + [head(fc, [100, 10])]


def execution_invalidation(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 2, R(2), R(1))
    add_block(fc, 3, R(3), R(2))
    fc.process_attestation(0, R(3), 1)
    out = [head(fc, [10])]
    fc.proto_array.invalidate_block(R(2))
    return out + [head(fc, [10])]


def is_descendant(ns):
    fc = make_fc(ns)
    add_block(fc, 1, R(1), R(0))
    add_block(fc, 2, R(2), R(1))
    add_block(fc, 1, R(3), R(0))
    pa = fc.proto_array
    return [pa.is_descendant(a, b) for a, b in ((R(0), R(2)), (R(1), R(2)), (R(3), R(2)), (R(2), R(1)))]


def prune(ns):
    fc = make_fc(ns)
    fc.proto_array.prune_threshold = 0
    for i in range(1, 6):
        add_block(fc, i, R(i), R(i - 1))
    fc.process_attestation(0, R(5), 1)
    out = [head(fc, [10])]
    fc.proto_array.maybe_prune(R(3))
    out += [fc.contains_block(R(i)) for i in (1, 2, 3)]
    return out + [head(fc, [10], justified_checkpoint_root=R(3))]


# ---------------------------------------------------------------------------
# ForkChoice wrapper scenarios: verdicts, queues, vote columns, metrics
# ---------------------------------------------------------------------------


def make_wrapper(ns, current_slot=0):
    cp = ns.fc.Checkpoint(epoch=0, root=R(0))
    store = ns.fc.ForkChoiceStore(
        current_slot=current_slot,
        justified_checkpoint=cp,
        finalized_checkpoint=cp,
        unrealized_justified_checkpoint=cp,
        unrealized_finalized_checkpoint=cp,
    )
    return ns.fc.ForkChoice(store, make_fc(ns), ns.spec(), ns.E)


def _attestation(ns, slot, head_root, target_epoch, target_root, indices=(0,)):
    T = ns.T
    return T.IndexedAttestation(
        attesting_indices=list(indices),
        data=T.AttestationData(
            slot=slot,
            index=0,
            beacon_block_root=head_root,
            source=T.Checkpoint(epoch=0, root=R(0)),
            target=T.Checkpoint(epoch=target_epoch, root=target_root),
        ),
        signature=b"\x00" * 96,
    )


def _verdict(fc, att):
    try:
        fc.on_attestation(att)
    except Exception as e:  # noqa: BLE001 - the verdict is what is compared
        return type(e).__name__
    return "accepted"


def _deferred(ns, outcome):
    return ns.REGISTRY.counter("fork_choice_deferred_attestations_total").value(outcome=outcome)


def _rid(fc, vi):
    """The validator's next vote as a block root (rids are per package)."""
    rid = int(fc.proto._next_rid[vi])
    return next(r for r in (R(i) for i in range(10)) if fc.proto.proto_array.vote_root_id(r) == rid)


def _wrapper_head(fc):
    return head(fc.proto, [10] * 4)


def on_attestation_target_chain_consistency(ns):
    fc = make_wrapper(ns, current_slot=ns.E.SLOTS_PER_EPOCH + 2)
    add_block(fc.proto, 1, R(1), R(0))
    e1 = ns.E.SLOTS_PER_EPOCH
    add_block(fc.proto, e1, R(2), R(1))
    add_block(fc.proto, e1 + 1, R(3), R(0))
    slot = e1 + 1
    out = [
        _verdict(fc, _attestation(ns, slot, R(2), 1, R(2))),
        _verdict(fc, _attestation(ns, slot, R(3), 1, R(2))),
        _verdict(fc, _attestation(ns, slot, R(3), 1, R(0), indices=(1,))),
    ]
    assert out == ["accepted", "InvalidAttestation", "accepted"]
    return out + [_wrapper_head(fc)]


def on_tick_promotes_unrealized_checkpoints(ns):
    fc = make_wrapper(ns, current_slot=3)
    fc.store.unrealized_justified_checkpoint = ns.fc.Checkpoint(epoch=1, root=R(1))
    fc.store.unrealized_finalized_checkpoint = ns.fc.Checkpoint(epoch=0, root=R(0))
    add_block(fc.proto, 1, R(1), R(0))
    fc.on_tick(ns.E.SLOTS_PER_EPOCH)
    cp = fc.store.justified_checkpoint
    assert (cp.epoch, cp.root) == (1, R(1))
    return [cp.epoch, cp.root, _wrapper_head(fc)]


def _deferral_wrapper(ns):
    fc = make_wrapper(ns, current_slot=2)
    add_block(fc.proto, 1, R(1), R(0))
    add_block(fc.proto, 2, R(2), R(1))
    return fc


def same_slot_gossip_attestation_defers_until_tick(ns):
    fc = _deferral_wrapper(ns)
    d0, a0 = _deferred(ns, "deferred"), _deferred(ns, "applied")
    fc.on_attestation(_attestation(ns, 2, R(2), 0, R(0)))
    out = [len(fc._deferred_attestations), _deferred(ns, "deferred") - d0, int(fc.proto._next_rid.size)]
    fc.on_tick(3)
    out += [len(fc._deferred_attestations), _deferred(ns, "applied") - a0, _rid(fc, 0)]
    assert out == [1, 1, 0, 0, 1, R(2)]
    return out + [_wrapper_head(fc)]


def store_lagging_gossip_attestation_defers_until_its_tick(ns):
    fc = _deferral_wrapper(ns)
    fc.on_attestation(_attestation(ns, 3, R(2), 0, R(0)))
    out = [len(fc._deferred_attestations)]
    fc.on_tick(3)
    out.append(len(fc._deferred_attestations))
    fc.on_tick(4)
    out += [len(fc._deferred_attestations), _rid(fc, 0)]
    assert out == [1, 1, 0, R(2)]
    return out + [_wrapper_head(fc)]


def deferred_attestation_structurally_validated_at_enqueue(ns):
    fc = _deferral_wrapper(ns)
    out = [_verdict(fc, _attestation(ns, 2, R(9), 0, R(0))), len(fc._deferred_attestations)]
    assert out == ["InvalidAttestation", 0]
    return out


def past_slot_gossip_attestation_applies_immediately(ns):
    fc = _deferral_wrapper(ns)
    fc.on_attestation(_attestation(ns, 1, R(1), 0, R(0)))
    out = [len(fc._deferred_attestations), _rid(fc, 0)]
    assert out == [0, R(1)]
    return out + [_wrapper_head(fc)]


def deferral_queue_cap_sheds(ns):
    mp = pytest.MonkeyPatch()
    mp.setattr(ns.mod, "_MAX_DEFERRED_ATTESTATIONS", 2)
    try:
        fc = _deferral_wrapper(ns)
        x0 = _deferred(ns, "dropped")
        for vi in range(3):
            fc.on_attestation(_attestation(ns, 2, R(2), 0, R(0), indices=(vi,)))
        out = [len(fc._deferred_attestations), _deferred(ns, "dropped") - x0]
    finally:
        mp.undo()
    assert out == [2, 1]
    return out


def batch_path_defers_same_slot_votes_too(ns):
    fc = _deferral_wrapper(ns)
    results = fc.on_attestation_batch(
        [
            _attestation(ns, 2, R(2), 0, R(0), indices=(0, 1)),
            _attestation(ns, 1, R(1), 0, R(0), indices=(2,)),
        ]
    )
    out = [results, len(fc._deferred_attestations), _rid(fc, 2)]
    fc.on_tick(3)
    out += [_rid(fc, 0), _rid(fc, 1)]
    assert out == [[None, None], 1, R(1), R(2), R(2)]
    return out + [_wrapper_head(fc)]


SCENARIOS = [
    single_chain_head, votes_decide_fork, balance_weighting, tie_break_deterministic, proposer_boost_flips_head,
    viability_filter_justification, equivocation_removes_weight, execution_invalidation, is_descendant, prune,
    on_attestation_target_chain_consistency, on_tick_promotes_unrealized_checkpoints,
    same_slot_gossip_attestation_defers_until_tick, store_lagging_gossip_attestation_defers_until_its_tick,
    deferred_attestation_structurally_validated_at_enqueue, past_slot_gossip_attestation_applies_immediately,
    deferral_queue_cap_sheds, batch_path_defers_same_slot_votes_too,
]
# the heads the JAX package's own tests expect
EXPECTED = {
    "single_chain_head": [R(2)],
    "votes_decide_fork": [R(1), R(2)],
    "balance_weighting": [R(1)],
    "tie_break_deterministic": [R(2)],
    "proposer_boost_flips_head": [R(1), R(2), R(1)],
    "viability_filter_justification": [R(2)],
    "equivocation_removes_weight": [R(1), R(2), R(2)],
    "execution_invalidation": [R(3), R(1)],
    "is_descendant": [True, True, False, False],
    "prune": [R(5), False, False, True, R(5)],
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_fork_choice_scenario_equals_jax(scenario):
    jax_seen = scenario(JAX)
    port_seen = scenario(PORT)
    assert port_seen == jax_seen
    if scenario.__name__ in EXPECTED:
        assert port_seen == EXPECTED[scenario.__name__]
