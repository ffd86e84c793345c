"""Range sync's blob route: a segment's sidecars through
``BeaconChain.process_segment_blob_sidecars``.

The chain is anchored on a state of the configuration's preset and fork whose
registry is cut to `blob_route_anchor_validators` (the route reads nothing of
it). Each segment's sidecars go in as one call, by block root, as range sync
hands over a batch of blocks; the window runs segments back to back, each
timed by the benchmark's clock. The window's segments are all valid, as
users send them. Once it has closed, `forged_segments_after_window` more
segments go through the same chain and call, each with one block whose blob
carries the proof of another blob: the call must name that block and no
other.

``correct``: every block's verdict against the pool's construction (valid,
unless forged), and the verdicts of every forged block and of a seeded
sample of the others against the reference's (each sidecar's inclusion
proof and header binding by ``hashlib``, its KZG proof by the specs'
pure-Python verify), which vouches for the construction; every block
answered.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Check, Outcome
from benchmark.inputs.blobs import G2_INFINITY, blob_bytes, make_block
from benchmark.reference.inclusion import verify_inclusion
from benchmark.inputs.state import anchored_chain, build_state
from benchmark.reference.kzg import Verifier


def segment_counts(traffic: dict, rng: np.random.Generator) -> list[int]:
    """Blob counts of one segment's blocks: the traffic's fixed list of
    (count, blocks) in a seeded order."""
    counts = [c for c, k in traffic["blob_counts"] for _ in range(k)]
    return [counts[i] for i in rng.permutation(len(counts))]


def run(ctx, program=None) -> Outcome:
    """`program`, where given, is called with the chain before the window
    (the benchmark's tests plant faults through it)."""
    import torch

    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
    from lighthouse_tpu_torch.types import MainnetEthSpec, build_types

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    preset = cfg["preset"]
    n_fe = preset["FIELD_ELEMENTS_PER_BLOB"]
    rng = np.random.default_rng([ctx.seed, 5])
    setup_path = TrustedSetup.CEREMONY_SEARCH_PATHS[0]
    kzg = Kzg(TrustedSetup.from_json(setup_path))

    per_segment = sum(c * k for c, k in tr["blob_counts"])
    warm_segments = tr["warmup_segments"]
    window_end = warm_segments + max(1, -(-int(ctx.seconds * tr["pool_blobs_per_s"]) // per_segment))
    segments = window_end + tr["forged_segments_after_window"]
    blobs = blob_bytes(rng, segments * per_segment, n_fe)
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]

    anchor_n = cfg["blob_route_anchor_validators"]
    raw = build_state(preset, cfg["fork"], anchor_n, ctx.seed, slot_in_epoch=0)
    types = build_types(MainnetEthSpec)
    chain = anchored_chain(raw, types, kzg)
    slot = raw.f["slot"]

    # the blocks, segment by segment, and one forged block in each segment
    # after the window
    plan = []
    parent = bytes(chain.head_root)
    nxt = 0
    for s in range(segments):
        blocks = []
        for c in segment_counts(tr, rng):
            slot += 1
            others = [rng.bytes(32) for _ in range(11)]
            ids = list(range(nxt, nxt + c))
            nxt += c
            b = make_block(slot, int(rng.integers(0, anchor_n)), parent, rng.bytes(32), others,
                           [commitments[i] for i in ids], ids, preset)
            parent = b.root
            blocks.append(b)
        plan.append(blocks)
    forged = {}
    for s in range(window_end, segments):
        b = plan[s][int(rng.choice([i for i, b in enumerate(plan[s]) if b.blob_ids]))]
        forged[b.root] = b.blob_ids[int(rng.integers(0, len(b.blob_ids)))]
    chain.slot_clock.set_slot(slot)

    def sidecars(b) -> list:
        hdr = types.SignedBeaconBlockHeader(message=types.BeaconBlockHeader(**b.header), signature=G2_INFINITY)
        out = []
        for i, k in enumerate(b.blob_ids):
            proof = proofs[(k + 1) % len(proofs)] if forged.get(b.root) == k else proofs[k]
            out.append(types.BlobSidecar(index=i, blob=blobs[k], kzg_commitment=commitments[k], kzg_proof=proof,
                                         signed_block_header=hdr, kzg_commitment_inclusion_proof=b.proofs[i]))
        return out

    by_root = [{b.root: sidecars(b) for b in blocks if b.blob_ids} for blocks in plan]
    if program is not None:
        program(chain)
    results = {}
    for s in range(warm_segments):
        results.update(chain.process_segment_blob_sidecars(by_root[s]))
    torch.cuda.synchronize()
    ctx.setup_done()

    done = []  # (segment, blobs, seconds)
    with ctx.window():
        start = time.monotonic()
        deadline = start + ctx.seconds
        for s in range(warm_segments, window_end):
            t = time.monotonic()
            with ctx.label("segment"):
                results.update(chain.process_segment_blob_sidecars(by_root[s]))
            done.append((s, sum(len(v) for v in by_root[s].values()), time.monotonic() - t))
            if time.monotonic() >= deadline:
                break
        end = time.monotonic()
    # the forged segments, after the window, through the same call
    for s in range(window_end, segments):
        results.update(chain.process_segment_blob_sidecars(by_root[s]))
    ctx.read_memory()
    window_s = end - start
    n_blobs = sum(d[1] for d in done)
    handed = list(range(warm_segments)) + [s for s, _, _ in done] + list(range(window_end, segments))
    blocks = [(s, b) for s in handed for b in plan[s] if b.blob_ids]
    unanswered = sum(1 for _, b in blocks if b.root not in results)
    # every verdict against the pool's construction: valid unless forged
    off_pool = sum(int((results[b.root] is None) == (b.root in forged)) for _, b in blocks if b.root in results)

    # the reference: every forged block and a seeded sample of the window's
    verifier = Verifier(setup_path, n_fe)
    window_blocks = [(s, b) for s, _, _ in done for b in plan[s] if b.blob_ids]
    sample_rng = np.random.default_rng([ctx.seed, 6])
    pick = set(sample_rng.choice(len(window_blocks), min(len(window_blocks), tr["reference_blocks"]), replace=False).tolist())
    checked = [sb for i, sb in enumerate(window_blocks) if i in pick] + [sb for sb in blocks if sb[1].root in forged]
    differing = 0
    for s, b in checked:
        ok = all(
            verify_inclusion(sc.kzg_commitment, list(sc.kzg_commitment_inclusion_proof), i, b.header["body_root"], preset)
            and verifier.verify(bytes(sc.blob), bytes(sc.kzg_commitment), bytes(sc.kzg_proof))
            for i, sc in enumerate(by_root[s][b.root])
        )
        if b.root in results and ok != (results[b.root] is None):
            differing += 1
    del chain, kzg
    ctx.free_device()
    return Outcome(
        attempted=n_blobs,
        failed=unanswered,
        e2e={"blobs_per_s": n_blobs / window_s},
        checks=[Check("block_verdicts_differing", differing, 0), Check("block_verdicts_off_pool", off_pool, 0),
                Check("blocks_unanswered", unanswered, 0)],
        work={"segments": [(nb, sec) for _, nb, sec in done], "blobs": n_blobs, "window_s": window_s,
              "blocks_checked": len(checked), "n": n_fe},
    )
