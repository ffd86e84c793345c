"""Each mix's generator gives the same inputs for the same seed, and others
for another, at tiny sizes."""

from __future__ import annotations

import numpy as np

from benchmark import harness as H
from benchmark.drivers import blob_segments
from benchmark.inputs import attestations as A
from benchmark.inputs import blobs as B
from benchmark.reference.inclusion import verify_inclusion
from benchmark.inputs import state as S
from benchmark.reference import beacon

SEED = 2**31 + 12345


def _cfg(name):
    return H.load_json(H.BENCH_DIR / "configs" / f"{name}.json")


def _same(v, w) -> bool:
    if isinstance(v, np.ndarray):
        return np.array_equal(v, w)
    if isinstance(v, (tuple, list)):
        return len(v) == len(w) and all(_same(x, y) for x, y in zip(v, w))
    return v == w


def _same_state(a: S.RawState, b: S.RawState) -> bool:
    return all(_same(v, b.f[k]) for k, v in a.f.items())


def test_state_and_writes_repeat():
    cfg = _cfg("mainnet_electra_1m")
    tr = H.load_json(H.BENCH_DIR / "traffic" / "state_root.json")
    a = S.build_state(cfg["preset"], "electra", 512, SEED, slot_in_epoch=None, pending=cfg["pending"], compounding_share=0.05)
    b = S.build_state(cfg["preset"], "electra", 512, SEED, slot_in_epoch=None, pending=cfg["pending"], compounding_share=0.05)
    c = S.build_state(cfg["preset"], "electra", 512, SEED + 1, slot_in_epoch=None, pending=cfg["pending"], compounding_share=0.05)
    assert _same_state(a, b) and not _same_state(a, c)
    wa = S.draw_writes(a.f["slot"], 512, a.preset, tr, "electra", np.random.default_rng([SEED, 1]))
    wb = S.draw_writes(a.f["slot"], 512, a.preset, tr, "electra", np.random.default_rng([SEED, 1]))
    assert np.array_equal(wa.part_idx, wb.part_idx) and wa.block_root == wb.block_root
    assert wa.part_idx.size == 512 // tr["participation_divisor"] and np.unique(wa.part_idx).size == wa.part_idx.size
    S.apply_raw(a, wa)
    S.apply_raw(b, wb)
    assert _same_state(a, b)
    assert len(a.f["pending_balance_deposits"]) == cfg["pending"]["pending_balance_deposits"]


def test_attestation_pool_repeats():
    cfg = _cfg("mainnet_deneb_1m")
    pools = []
    for seed in (SEED, SEED, SEED + 1):
        raw = S.build_state(cfg["preset"], "deneb", 4096, seed, slot_in_epoch=0)
        com = beacon.slot_committees(raw.f, cfg["preset"], raw.f["slot"])
        rng = np.random.default_rng([seed, 3])
        keys = A.draw_keys(raw.f, com, rng)
        pools.append(A.make_pool(raw.f, cfg["preset"], keys, raw.f["slot"], b"\x11" * 32,
                                 raw.f["current_justified_checkpoint"], rng, [3], 64))
    assert pools[0].payloads == pools[1].payloads and pools[0].payloads != pools[2].payloads
    p = pools[0]
    assert len(set(p.validator.tolist())) == len(p.payloads) and p.forged.sum() == 1
    assert A.parse_attestation(p.payloads[0])["bits"] and len(p.payloads[0]) > 228


def test_segment_sizes_are_fixed_and_order_seeded():
    tr = H.load_json(H.BENCH_DIR / "traffic" / "blob_sync.json")
    a = blob_segments.segment_counts(tr, np.random.default_rng(SEED))
    b = blob_segments.segment_counts(tr, np.random.default_rng(SEED))
    c = blob_segments.segment_counts(tr, np.random.default_rng(SEED + 1))
    assert a == b and a != c and sorted(a) == sorted(c)
    assert len(a) == 64 and sum(a) == 192 and max(a) <= 6
    assert B.blob_bytes(np.random.default_rng(SEED), 2, 4) == B.blob_bytes(np.random.default_rng(SEED), 2, 4)


def test_inclusion_proofs_verify():
    preset = _cfg("mainnet_deneb_1m")["preset"]
    rng = np.random.default_rng(SEED)
    commitments = [rng.bytes(48) for _ in range(3)]
    blk = B.make_block(5, 1, b"\x00" * 32, b"\x01" * 32, [rng.bytes(32) for _ in range(11)], commitments, [0, 1, 2], preset)
    for i, c in enumerate(commitments):
        assert verify_inclusion(c, blk.proofs[i], i, blk.header["body_root"], preset)
    assert not verify_inclusion(commitments[0], blk.proofs[0], 1, blk.header["body_root"], preset)
