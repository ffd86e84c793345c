"""Gossip attestations through the node's queued gossip handlers.

A node on all attestation subnets: a ``BeaconChain`` anchored on the seeded
state (its latest block header the head) behind a ``NetworkService`` with its
default beacon processor. Each payload is the SSZ an attestation arrives as
on its subnet's ``beacon_attestation_{subnet}`` topic; the benchmark hands it
to the gossip router's delivery step (``GossipRouter._deliver``: the decode,
then the ``GOSSIP_ATTESTATION`` lane, the processor's batches and
``BeaconChain.process_attestation_batch``), with no socket and no mesh. The
loop is closed: it keeps `queued_batches` batches' worth of attestations
delivered and not yet given a verdict. A verdict is the router's
accept/ignore/reject decision (``GossipRouter._complete``), recorded here.

The window's traffic is all valid, as users send it. Once the window has
closed and its verdicts are in, `forged_after_window` attestations of
validators that have not attested yet, each signed over another block root,
go through the same router and chain.

``correct``, checked after that: every verdict against the pool's own
construction (accept, unless forged); the verdicts of every forged
attestation and of a seeded sample of the rest against the reference's
(committees by the specs' shuffle, the signing root, a pure-Python BLS
verify), which vouches for the construction; every delivered attestation
answered; what the chain did with the accepted ones, once its clock has
moved to the next slot: every validator's latest message in fork choice
(the head and the epoch for each accepted attester, none for any other),
and each committee's aggregate in the op pool (its bits every accepted
member, its signature their sum, worked out again from the keys); the head
the chain anchored on against the reference's root of the anchor state.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark.harness import Check, Outcome
from benchmark.inputs.attestations import draw_keys, make_pool, parse_attestation
from benchmark.inputs.state import anchored_chain, build_state
from benchmark.reference import beacon
from benchmark.reference.bls import MessagePoints, verify
from benchmark.reference.bls12_381.curve import FQ2, R, batch_to_affine, g2_affine_to_bytes, pt_mul
from benchmark.reference.state_root import StateRooter

ORIGIN = "benchmark-peer"


class Verdicts:
    """The router's outcome of each payload, as it completes them."""

    def __init__(self, index_of: dict):
        self.index_of = index_of
        self.err: dict = {}
        self.at: dict = {}
        self.cv = threading.Condition()

    def hook(self, router) -> None:
        complete = router._complete

        def recorded(work, err):
            complete(work, err)
            k = self.index_of[work.data]
            with self.cv:
                self.err[k] = err
                self.at[k] = time.monotonic()
                self.cv.notify_all()

        router._complete = recorded

    def count(self) -> int:
        return len(self.err)


def _deliver(router, topics: dict, pool, k: int) -> None:
    router._deliver(topics[int(pool.subnet[k])], pool.payloads[k], ORIGIN)


def _batches_hook(ctx, chain, batches: list) -> None:
    """Record each batch the chain is handed: attestations and distinct
    (slot, committee) messages, and in a traced run its host range."""
    inner = chain.process_attestation_batch

    def recorded(atts):
        batches.append((len(atts), len({(int(a.data.slot), int(a.data.index)) for a in atts})))
        with ctx.label("attestation_batch"):
            return inner(atts)

    chain.process_attestation_batch = recorded


def run(ctx, program=None) -> Outcome:
    """`program`, where given, is called with the chain before the window
    (the benchmark's tests plant faults through it)."""
    import torch

    from lighthouse_tpu_torch.network import NetworkService
    from lighthouse_tpu_torch.types import MainnetEthSpec, build_types

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    preset, net = cfg["preset"], cfg["network"]
    n = cfg["validators"]
    rng = np.random.default_rng([ctx.seed, 3])
    raw = build_state(preset, cfg["fork"], n, ctx.seed, slot_in_epoch=0)
    slot = raw.f["slot"]
    committees = beacon.slot_committees(raw.f, preset, slot)
    keys = draw_keys(raw.f, committees, rng)

    chain = anchored_chain(raw, build_types(MainnetEthSpec))
    head = bytes(chain.head_root)
    total = sum(len(c) for c in committees)
    warm = tr["warmup_attestations"]
    forged_at = sorted(rng.choice(np.arange(warm, total), tr["forged_after_window"], replace=False).tolist())
    pool = make_pool(raw.f, preset, keys, slot, head, raw.f["current_justified_checkpoint"], rng, forged_at,
                     net["ATTESTATION_SUBNET_COUNT"])
    index_of = {p: k for k, p in enumerate(pool.payloads)}
    # the window's arrivals: every valid attestation after the warm-up, in order
    stream = [k for k in range(warm, total) if not pool.forged[k]]

    service = NetworkService(chain, port=0)
    # its RPC listener serves 127.0.0.1 and no peer dials it; started so that
    # the service's own stop() tears everything down
    service.server.start()
    try:
        router = service.gossip
        topics = service.attestation_topics
        verdicts = Verdicts(index_of)
        verdicts.hook(router)
        batches: list = []
        _batches_hook(ctx, chain, batches)
        if program is not None:
            program(chain)
        target = tr["queued_batches"] * net["MAX_GOSSIP_ATTESTATION_BATCH_SIZE"]

        def settle(upto: int, timeout: float) -> None:
            end = time.monotonic() + timeout
            with verdicts.cv:
                while verdicts.count() < upto and time.monotonic() < end:
                    verdicts.cv.wait(0.05)

        for k in range(warm):
            _deliver(router, topics, pool, k)
        settle(warm, tr["answer_wait_s"])
        torch.cuda.synchronize()
        ctx.setup_done()

        sent = 0  # of the stream
        first_batch = len(batches)
        with ctx.window():
            start = time.monotonic()
            deadline = start + ctx.seconds
            while sent < len(stream) and time.monotonic() < deadline:
                with verdicts.cv:
                    while warm + sent - verdicts.count() >= target and time.monotonic() < deadline:
                        verdicts.cv.wait(0.05)
                    room = target - (warm + sent - verdicts.count())
                with ctx.label("deliver"):
                    for _ in range(max(0, min(room, len(stream) - sent))):
                        _deliver(router, topics, pool, stream[sent])
                        sent += 1
            settle(warm + sent, tr["answer_wait_s"])
        window_batches = batches[first_batch:]
        window = stream[:sent]
        answered = [k for k in window if k in verdicts.err]
        end = max(verdicts.at[k] for k in answered)
        # the forged attestations, after the window, through the same path
        for k in forged_at:
            _deliver(router, topics, pool, k)
        settle(warm + sent + len(forged_at), tr["answer_wait_s"])
        ctx.read_memory()
        delivered = list(range(warm)) + window + forged_at
        chain.slot_clock.set_slot(slot + 1)
        chain.fork_choice.on_tick(slot + 1)
        votes = latest_messages(chain, n)
        aggregates = {c: chain.op_pool.get_aggregate(root) for c, root in enumerate(pool.data_roots)}
    finally:
        service.stop()
    window_s = end - start
    failed = sum(1 for k in answered if _internal(verdicts.err[k]))
    unanswered = sum(1 for k in delivered if k not in verdicts.err)
    # every verdict against the pool's construction: accept unless forged
    off_pool = sum(int((verdicts.err[k] is None) == bool(pool.forged[k])) for k in delivered if k in verdicts.err)
    voters = [k for k in delivered if not pool.forged[k]]

    # the reference
    rooter = StateRooter("cuda" if torch.cuda.is_available() else "cpu")
    raw_root = rooter.root(raw)
    anchor = beacon.block_header_root(raw.f["latest_block_header"], raw_root)
    sample_rng = np.random.default_rng([ctx.seed, 4])
    pick = sorted(set(sample_rng.choice(answered, min(len(answered), tr["reference_sample"]), replace=False).tolist())
                  | {k for k in forged_at if k in verdicts.err})
    ref = Reference(raw.f, preset, committees, slot, anchor, net)
    differing = sum(int(ref.accepts(pool.payloads[k]) != (verdicts.err[k] is None)) for k in pick)
    votes_differing = ref.votes_differing(votes, pool.validator[voters], n)
    aggregates_differing = ref.aggregates_differing(aggregates, pool, voters, keys)
    del chain, service, aggregates
    ctx.free_device()
    return Outcome(
        attempted=len(window),
        failed=failed + unanswered,
        e2e={"att_per_s": len(answered) / window_s},
        checks=[
            Check("verdicts_differing", differing, 0),
            Check("verdicts_off_pool", off_pool, 0),
            Check("unanswered", unanswered, 0),
            Check("votes_differing", votes_differing, 0),
            Check("aggregates_differing", aggregates_differing, 0),
            Check("anchor_root_differing", int(anchor != head), 0),
        ],
        work={"attestations": len(answered), "window_s": window_s, "batches": window_batches,
              "sampled": len(pick), "forged_after_window": len(forged_at)},
    )


def latest_messages(chain, n: int) -> tuple:
    """Each validator's latest message in the chain's fork choice, as the
    vote columns of its proto-array hold it: (root per validator, None where
    it never voted; target epoch per validator)."""
    fc = chain.fork_choice.proto
    rid = np.zeros(n, dtype=np.int64)
    epoch = np.zeros(n, dtype=np.uint64)
    m = min(n, len(fc._next_rid))
    rid[:m] = fc._next_rid[:m]
    epoch[:m] = fc._next_epoch[:m]
    root_of = {int(r): bytes(root) for root, r in fc.proto_array._root_ids.items()}
    return rid, epoch, root_of


def _internal(err) -> bool:
    """An outcome that is neither an accept nor a verdict on the message:
    an internal error of the node."""
    return err is not None and not isinstance(err, ValueError) and type(err).__name__ != "GossipIgnore"


class Reference:
    """The verdict the specs give a gossip attestation at this slot: one bit
    of a committee of the slot, the head as its block and target, inside
    the propagation window, signed by that member over its data."""

    def __init__(self, f: dict, preset: dict, committees: list, slot: int, head: bytes, net: dict):
        self.f, self.preset, self.committees, self.slot, self.head = f, preset, committees, slot, head
        self.window = net["ATTESTATION_PROPAGATION_SLOT_RANGE"]
        self.h_of = MessagePoints()
        self.seen: set = set()

    def accepts(self, payload: bytes) -> bool:
        a = parse_attestation(payload)
        spe = self.preset["SLOTS_PER_EPOCH"]
        epoch = a["slot"] // spe
        if not (a["slot"] <= self.slot <= a["slot"] + self.window) or a["target"][0] != epoch:
            return False
        if a["root"] != self.head or a["slot"] != self.slot or a["index"] >= len(self.committees):
            return False
        members = self.committees[a["index"]]
        if a["size"] != len(members) or len(a["bits"]) != 1:
            return False
        v = int(members[a["bits"][0]])
        if v in self.seen:
            return False
        root = beacon.attestation_data_root(a["slot"], a["index"], a["root"], a["source"], a["target"])
        msg = beacon.signing_root(root, beacon.attester_domain(self.f, self.preset, epoch))
        ok = verify(self.f["pubkey"][v].tobytes(), msg, a["signature"], self.h_of)
        if ok:
            self.seen.add(v)
        return ok

    def votes_differing(self, votes: tuple, voters: np.ndarray, n: int) -> int:
        """Validators whose latest message is not what the specs' on_attestation
        leaves: (the head, this epoch) for each accepted attester, none for
        every other validator."""
        rid, epoch, root_of = votes
        want = np.zeros(n, dtype=bool)
        want[voters] = True
        rids = np.unique(rid)
        on_head = np.isin(rid, [r for r in rids.tolist() if r != 0 and root_of.get(r) == self.head])
        epoch_now = self.slot // self.preset["SLOTS_PER_EPOCH"]
        right = np.where(want, on_head & (epoch == epoch_now), (rid == 0) & (epoch == 0))
        return int(n - right.sum())

    def aggregates_differing(self, aggregates: dict, pool, voters: list, keys) -> int:
        """Committees whose aggregate in the op pool is not the one their
        accepted members make: its bits exactly theirs, its signature the sum
        of theirs, sum_j (a + j b) H(m) = (|S| a + b sum_j j) H(m), worked
        out from the committee's keys."""
        members: dict = {}
        for k in voters:
            members.setdefault(int(pool.committee[k]), []).append(int(pool.position[k]))
        wrong = 0
        for c, agg in aggregates.items():
            js = sorted(members.get(c, []))
            if agg is None:
                wrong += int(bool(js))
                continue
            bits = [i for i, b in enumerate(agg.aggregation_bits) if b]
            if bits != js or len(agg.aggregation_bits) != len(self.committees[c]):
                wrong += 1
                continue
            k = (len(js) * keys.a[c] + keys.b[c] * sum(js)) % R
            point = pt_mul(FQ2, self.h_of(pool.messages[c]), k)
            wrong += int(g2_affine_to_bytes(batch_to_affine(FQ2, [point])[0]) != bytes(agg.signature))
        return wrong
