"""The benchmark's references agree with the program at minimal sizes on the
CPU: state roots, committees, signing roots and payloads, BLS verdicts,
KZG verdicts and inclusion proofs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lighthouse_tpu_torch as L
from benchmark import harness as H
from benchmark.inputs import attestations as A
from benchmark.inputs import blobs as B
from benchmark.reference.inclusion import verify_inclusion
from benchmark.inputs import state as S
from benchmark.reference import beacon
from benchmark.reference.bls import verify as ref_verify
from benchmark.reference.kzg import Verifier
from benchmark.reference.state_root import StateRooter

SEED = 2**31 + 4242


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    torch.set_num_threads(1)
    L.set_default_device("cpu")
    yield


@pytest.fixture(scope="module")
def types_():
    from lighthouse_tpu_torch.types import MainnetEthSpec, build_types

    return build_types(MainnetEthSpec)


def _cfg(name):
    return H.load_json(H.BENCH_DIR / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["mainnet_deneb_1m", "mainnet_electra_1m"])
def test_state_root_and_writes_agree(name, types_):
    from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent

    cfg = _cfg(name)
    tr = H.load_json(H.BENCH_DIR / "traffic" / "state_root.json")
    raw = S.build_state(cfg["preset"], cfg["fork"], 2048, SEED, slot_in_epoch=None, pending=cfg.get("pending"),
                        compounding_share=cfg.get("compounding_share", 0.0))
    state = S.to_program(raw, types_)
    _make_persistent(state)
    rooter = StateRooter("cpu")
    assert bytes(state.hash_tree_root()) == rooter.root(raw)
    rng = np.random.default_rng(SEED)
    for _ in range(2):
        w = S.draw_writes(raw.f["slot"], raw.n, raw.preset, tr, raw.fork, rng)
        S.apply_raw(raw, w)
        S.apply_program(state, w, types_, raw.preset)
        assert bytes(state.hash_tree_root()) == rooter.root(raw)


@pytest.fixture(scope="module")
def gossip(types_):
    """A 4,096-validator Deneb state, its slot's committees, keys and a pool
    of attestations with one forged."""
    cfg = _cfg("mainnet_deneb_1m")
    raw = S.build_state(cfg["preset"], "deneb", 4096, SEED, slot_in_epoch=0)
    com = beacon.slot_committees(raw.f, cfg["preset"], raw.f["slot"])
    rng = np.random.default_rng(SEED)
    keys = A.draw_keys(raw.f, com, rng)
    state = S.to_program(raw, types_)
    head = b"\x42" * 32
    pool = A.make_pool(raw.f, cfg["preset"], keys, raw.f["slot"], head, raw.f["current_justified_checkpoint"], rng, [1], 64)
    return cfg, raw, com, state, pool, head


def test_committees_agree(gossip):
    from lighthouse_tpu_torch.state_processing.accessors import committee_cache_at
    from lighthouse_tpu_torch.types import MainnetEthSpec

    cfg, raw, com, state, _, _ = gossip
    slot = raw.f["slot"]
    cc = committee_cache_at(state, slot // 32, MainnetEthSpec)
    assert cc.committees_per_slot == len(com)
    for c, members in enumerate(com):
        assert [int(v) for v in cc.committee(slot, c)] == members.tolist()


def test_payloads_and_signing_roots_agree(gossip, types_):
    from lighthouse_tpu_torch.state_processing.accessors import get_domain
    from lighthouse_tpu_torch.types import MainnetEthSpec
    from lighthouse_tpu_torch.types.chain_spec import Domain, compute_signing_root, mainnet_spec

    cfg, raw, com, state, pool, head = gossip
    att = types_.Attestation.deserialize(pool.payloads[0])
    ref = A.parse_attestation(pool.payloads[0])
    assert att.serialize() == pool.payloads[0]
    assert [i for i, b in enumerate(att.aggregation_bits) if b] == ref["bits"] and len(att.aggregation_bits) == ref["size"]
    data_root = beacon.attestation_data_root(ref["slot"], ref["index"], ref["root"], ref["source"], ref["target"])
    assert bytes(att.data.hash_tree_root()) == data_root
    epoch = ref["slot"] // 32
    domain = get_domain(state, Domain.BEACON_ATTESTER, epoch, mainnet_spec(), MainnetEthSpec)
    assert bytes(domain) == beacon.attester_domain(raw.f, cfg["preset"], epoch)
    assert bytes(compute_signing_root(data_root, domain)) == pool.messages[ref["index"]]


def test_bls_verdicts_agree(gossip):
    from lighthouse_tpu_torch.crypto import bls

    cfg, raw, com, state, pool, head = gossip
    for k in (0, 1):  # a sound attestation and the forged one
        a = A.parse_attestation(pool.payloads[k])
        v = int(com[a["index"]][a["bits"][0]])
        pk = raw.f["pubkey"][v].tobytes()
        msg = pool.messages[a["index"]]
        want = bls.Signature.from_bytes(a["signature"]).verify(bls.PublicKey.from_bytes(pk), msg)
        assert ref_verify(pk, msg, a["signature"]) is bool(want) is (not pool.forged[k])


@pytest.fixture(scope="module")
def ceremony_blob():
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup

    path = TrustedSetup.CEREMONY_SEARCH_PATHS[0]
    kzg = Kzg(TrustedSetup.from_json(path), device=False)
    blob = B.blob_bytes(np.random.default_rng(SEED), 1, 4096)[0]
    commitment = kzg.blob_to_kzg_commitment(blob)
    proof = kzg.compute_blob_kzg_proof(blob, commitment)
    return path, kzg, blob, commitment, proof


def test_kzg_verdicts_agree(ceremony_blob):
    path, kzg, blob, commitment, proof = ceremony_blob
    ref = Verifier(path)
    assert ref.verify(blob, commitment, proof) and kzg.verify_blob_kzg_proof(blob, commitment, proof)
    other = bytearray(blob)
    other[-1] ^= 1
    assert not ref.verify(bytes(other), commitment, proof)
    assert not kzg.verify_blob_kzg_proof(bytes(other), commitment, proof)


def test_inclusion_proofs_agree(types_):
    from lighthouse_tpu_torch.ssz.merkle_proof import verify_blob_inclusion_proof
    from lighthouse_tpu_torch.types import MainnetEthSpec

    preset = _cfg("mainnet_deneb_1m")["preset"]
    rng = np.random.default_rng(SEED)
    commitments = [rng.bytes(48) for _ in range(4)]
    blk = B.make_block(9, 3, rng.bytes(32), rng.bytes(32), [rng.bytes(32) for _ in range(11)], commitments, [0, 1, 2, 3], preset)
    hdr = types_.SignedBeaconBlockHeader(message=types_.BeaconBlockHeader(**blk.header), signature=B.G2_INFINITY)
    assert bytes(hdr.message.hash_tree_root()) == blk.root
    for i, c in enumerate(commitments):
        sc = types_.BlobSidecar(index=i, blob=b"\x00" * 131072, kzg_commitment=c, kzg_proof=b"\xc0" + b"\x00" * 47,
                                signed_block_header=hdr, kzg_commitment_inclusion_proof=blk.proofs[i])
        assert verify_blob_inclusion_proof(sc, MainnetEthSpec)
        assert verify_inclusion(c, blk.proofs[i], i, blk.header["body_root"], preset)
