"""The port's `cuda` BLS backend (K6 over K2/K4/K5), run on CPU tensors
through its plain versions, against the JAX package's `host` backend: the
same signature sets (from the same bytes) and the same random.Random give
the same verdict. Also the port's signature-set constructors against the
JAX package's on the same seeded state, and the verifier's stage values
against the host oracle. Tolerance: exact equality (verdicts, bytes,
points).
"""

import os
import random

import numpy as np
import pytest
import torch

import lighthouse_tpu_torch
from chip_smoke import bls_sign, bls_twist_point_outside_subgroup, build_deneb_state
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.crypto.bls12_381 import (
    FQ,
    FQ2,
    g1_gen_mul,
    g1_to_bytes,
    g2_affine_to_bytes,
    g2_to_bytes,
    hash_to_g2,
    inf,
    msm,
    pt_add,
    to_affine,
)
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops.bls381_verify import verify_signature_sets_device_full


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    """Plain versions on the CPU: thousands of small integer ops, run on one
    intra-op thread (several test workers share the cores). The JAX host
    backend runs its work units inline (pool size 1, the port's host
    behaviour) rather than forking a process that holds JAX's threads."""
    prev_dev, prev_threads = lighthouse_tpu_torch.default_device(), torch.get_num_threads()
    prev_pool = os.environ.get("LIGHTHOUSE_TPU_HOST_POOL")
    lighthouse_tpu_torch.set_default_device("cpu")
    torch.set_num_threads(1)
    os.environ["LIGHTHOUSE_TPU_HOST_POOL"] = "1"
    yield
    if prev_pool is None:
        os.environ.pop("LIGHTHOUSE_TPU_HOST_POOL", None)
    else:
        os.environ["LIGHTHOUSE_TPU_HOST_POOL"] = prev_pool
    torch.set_num_threads(prev_threads)
    lighthouse_tpu_torch.set_default_device(prev_dev)


# Keys and signatures from the oracle's functions, not through either
# package's process-wide BLS backend (other tests switch it).
SKS = [jax_bls.interop_secret_key(i).scalar for i in range(8)]
PKS = [g1_to_bytes(g1_gen_mul(sk)) for sk in SKS]
MSGS = [bytes([m]) * 32 for m in range(4)]


def _signed(signers: list[int], msg: bytes) -> bytes:
    """Aggregate signature of `signers` (repeats allowed) over `msg`."""
    return bls_sign(sum(SKS[i] for i in signers), msg)


def _batch(n: int, same_message: bool = False) -> list[tuple]:
    """n sets (signature bytes, pubkey bytes, message): committees of 1-3
    signers, one with a repeated signer, messages that repeat."""
    out = []
    for j in range(n):
        signers = [j % 8, (j + 3) % 8, (j + 3) % 8] if j == 1 else [j % 8, (5 * j + 1) % 8][: 1 + j % 2]
        msg = MSGS[0] if same_message else MSGS[j % 3]
        out.append((_signed(signers, msg), [PKS[i] for i in signers], msg))
    return out


def _verdicts(raw: list[tuple], seed: int = 5) -> tuple[bool, bool]:
    """(port cuda backend on the CPU, JAX host backend), same Random."""
    port_sets = [bls.SignatureSet(bls.Signature(s), [bls.PublicKey(p) for p in pks], m) for s, pks, m in raw]
    jax_sets = [jax_bls.SignatureSet(jax_bls.Signature(s), [jax_bls.PublicKey(p) for p in pks], m) for s, pks, m in raw]
    prev = bls.backend_setting()
    try:
        bls.set_backend("cuda")
        got = bls.verify_signature_sets(port_sets, random.Random(seed))
    finally:
        bls.set_backend(prev)
    want = jax_bls._BACKENDS["host"].verify_signature_sets(jax_sets, random.Random(seed))
    return got, want


def _with_sig(raw, i, sig):
    out = list(raw)
    out[i] = (sig, raw[i][1], raw[i][2])
    return out


@pytest.mark.parametrize(
    "case",
    ["valid_3", "one_bad_signature", "outside_subgroup", "infinity", "empty_pubkeys", "repeated_messages"],
)
def test_cuda_backend_verdict_equals_jax_host(case):
    raw = _batch(3, same_message=case == "repeated_messages")
    expected = case in ("valid_3", "repeated_messages")
    if case == "one_bad_signature":
        raw = _with_sig(raw, 1, raw[2][0])
    elif case == "outside_subgroup":
        x, y = bls_twist_point_outside_subgroup(np.random.default_rng(31))
        raw = _with_sig(raw, 1, g2_affine_to_bytes((x, y)))
    elif case == "infinity":
        raw = _with_sig(raw, 2, bls.INFINITY_SIGNATURE)
    elif case == "empty_pubkeys":
        raw[0] = (raw[0][0], [], raw[0][2])
    got, want = _verdicts(raw)
    assert got is want is expected


def test_batch_of_8_verdict_and_stage_values():
    """Eight sets in one chunk: the verdict equals the JAX host backend's,
    and the stage values equal the host oracle with the same scalars:
    each H(m) in compressed bytes, sum r_i sig_i and each message's
    sum r_i aggpk_i as affine points."""
    raw = _batch(8)
    got, want = _verdicts(raw, seed=9)
    assert got is want is True
    sets = [bls.SignatureSet(bls.Signature(s), [bls.PublicKey(p) for p in pks], m) for s, pks, m in raw]
    stages: list = []
    assert verify_signature_sets_device_full(sets, random.Random(9), stages=stages)
    (st,) = stages
    for m, hm in zip(st["messages"], st["hm"]):
        v = K2.fq_from_limbs(hm)
        assert g2_affine_to_bytes(((v[0], v[1]), (v[2], v[3]))) == g2_to_bytes(hash_to_g2(m))
    sig_sum = to_affine(FQ2, msm(FQ2, [s.signature.point() for s in sets], st["scalars"]))
    v = K2.fq_from_limbs(st["agg_sig"])
    assert ((v[0], v[1]), (v[2], v[3])) == sig_sum
    for m, got_pk in zip(st["messages"], st["msg_pk"]):
        idx = [i for i, s in enumerate(sets) if s.message == m]
        aggs = []
        for i in idx:
            acc = inf(FQ)
            for pk in sets[i].pubkeys:
                acc = pt_add(FQ, acc, pk.point())
            aggs.append(acc)
        assert tuple(K2.fq_from_limbs(got_pk)) == to_affine(FQ, msm(FQ, aggs, [st["scalars"][i] for i in idx]))
    # the scalars are the JAX backends' draws: getrandbits per set, redrawn
    # while 0
    rand = random.Random(9)
    want = []
    for _ in sets:
        r = 0
        while r == 0:
            r = rand.getrandbits(jax_bls.RAND_BITS)
        want.append(r)
    assert st["scalars"] == want


def test_cuda_backend_raises_without_a_card():
    """With the device `cuda` and no card, the cuda backend raises; it
    never falls back to the host or the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    raw = _batch(2)
    sets = [bls.SignatureSet(bls.Signature(s), [bls.PublicKey(p) for p in pks], m) for s, pks, m in raw]
    lighthouse_tpu_torch.set_default_device("cuda")
    prev = bls.backend_setting()
    try:
        bls.set_backend("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            bls.verify_signature_sets(sets, random.Random(1))
    finally:
        bls.set_backend(prev)
        lighthouse_tpu_torch.set_default_device("cpu")


# ---------------------------------------------------------------------------
# Signature-set constructors on the same seeded state in both packages
# ---------------------------------------------------------------------------


def _objects(types, E, state, rng: np.random.Generator) -> dict:
    """The same consensus objects in either package's types (from one
    numpy seed)."""
    T = types.types_for_fork("deneb")
    slot = int(state.slot)
    n = len(state.validators)
    cp = types.Checkpoint(epoch=slot // E.SLOTS_PER_EPOCH - 1, root=rng.bytes(32))
    data = types.AttestationData(slot=slot - 1, index=3, beacon_block_root=rng.bytes(32), source=cp, target=cp)
    block = T.BeaconBlock(
        slot=slot,
        proposer_index=int(rng.integers(0, n)),
        parent_root=rng.bytes(32),
        state_root=rng.bytes(32),
        body=T.BeaconBlockBody(randao_reveal=rng.bytes(96), graffiti=rng.bytes(32)),
    )
    bits = (rng.random(E.SYNC_COMMITTEE_SIZE) < 0.9).tolist()
    return {
        "signed_block": T.SignedBeaconBlock(message=block, signature=rng.bytes(96)),
        "header": types.SignedBeaconBlockHeader(
            message=types.BeaconBlockHeader(
                slot=slot, proposer_index=7, parent_root=rng.bytes(32), state_root=rng.bytes(32), body_root=rng.bytes(32)
            ),
            signature=rng.bytes(96),
        ),
        "indexed": types.IndexedAttestation(
            attesting_indices=sorted(rng.choice(n, 5, replace=False).tolist()), data=data, signature=rng.bytes(96)
        ),
        "exit": types.SignedVoluntaryExit(
            message=types.VoluntaryExit(epoch=slot // E.SLOTS_PER_EPOCH, validator_index=11), signature=rng.bytes(96)
        ),
        "aggregate": types.SignedAggregateAndProof(
            message=types.AggregateAndProof(
                aggregator_index=13,
                aggregate=types.Attestation(
                    aggregation_bits=[True, False, True], data=data, signature=rng.bytes(96)
                ),
                selection_proof=rng.bytes(96),
            ),
            signature=rng.bytes(96),
        ),
        "sync": types.SyncAggregate(sync_committee_bits=bits, sync_committee_signature=rng.bytes(96)),
        "deposit": types.DepositData(
            pubkey=rng.bytes(48), withdrawal_credentials=rng.bytes(32), amount=32 * 10**9, signature=rng.bytes(96)
        ),
    }


def _sets(pkg, types, E, state, spec, objs) -> list:
    ss = pkg["signature_sets"]
    block = objs["signed_block"].message
    sets = [
        ss.block_proposal_signature_set(state, objs["signed_block"], None, spec, E),
        ss.randao_signature_set(state, block, spec, E),
        ss.block_header_signature_set(state, objs["header"], spec, E),
        ss.indexed_attestation_signature_set(state, objs["indexed"], spec, E),
        ss.exit_signature_set(state, objs["exit"], spec, E),
        ss.selection_proof_signature_set(state, 17, int(state.slot), objs["aggregate"].message.selection_proof, spec, E),
        ss.aggregate_and_proof_signature_set(state, objs["aggregate"], spec, E),
        pkg["altair"].sync_aggregate_signature_set(state, objs["sync"], int(state.slot), spec, E),
    ]
    return [(s.signature.to_bytes(), [p.to_bytes() for p in s.pubkeys], s.message) for s in sets] + [
        ss.deposit_signature_message(objs["deposit"], spec, E)
    ]


def test_signature_set_constructors_equal_jax():
    from lighthouse_tpu.state_processing import altair as jax_altair
    from lighthouse_tpu.state_processing import signature_sets as jax_ss
    from lighthouse_tpu.types import MinimalEthSpec as JE
    from lighthouse_tpu.types import build_types as jax_build
    from lighthouse_tpu.types.chain_spec import minimal_spec as jax_spec
    from lighthouse_tpu_torch.state_processing import altair
    from lighthouse_tpu_torch.state_processing import signature_sets
    from lighthouse_tpu_torch.types import MinimalEthSpec as PE
    from lighthouse_tpu_torch.types import build_types
    from lighthouse_tpu_torch.types.chain_spec import minimal_spec

    out = []
    for pkg, types, E, spec in (
        ({"signature_sets": jax_ss, "altair": jax_altair}, jax_build(JE), JE, jax_spec()),
        ({"signature_sets": signature_sets, "altair": altair}, build_types(PE), PE, minimal_spec()),
    ):
        state = build_deneb_state(types, E, 256, seed=32)
        objs = _objects(types, E, state, np.random.default_rng(33))
        out.append(_sets(pkg, types, E, state, spec, objs))
    assert out[0] == out[1]
    assert len(out[1]) == 9 and all(len(s[1]) > 0 for s in out[1][:8])
