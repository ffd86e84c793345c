"""Each cell's run, with the look for a card skipped and the timed path
broken underneath, comes out not correct; the sound path comes out correct.

The faults each cell can have: an answer altered where it is produced (a
root, a verdict), a step that returns its state unchanged (a stale root),
half of a batch left out (verdicts for half the items, roots for half the
blocks). The sizes are tiny and every kernel runs its plain version on the
CPU. The blob cell's commitments and proofs come from a setup whose secret
is known, so they cost a scalar each here; the verification under test is
the program's.
"""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import lighthouse_tpu_torch as L
from benchmark import harness as H
from benchmark.reference.bls12_381.curve import FQ, FQ2, G1_GEN, G2_GEN, R, g1_to_bytes, g2_to_bytes, pt_mul
from benchmark.reference.kzg import Verifier, bit_reversal_permutation

SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def cpu_only(monkeypatch):
    monkeypatch.setenv("LIGHTHOUSE_TPU_HOST_POOL", "1")
    torch.set_num_threads(1)
    L.set_default_device("cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    yield
    H.stop_program_processes()
    from lighthouse_tpu_torch.crypto import bls

    bls.set_backend(None)


def _ctx(cell_name: str, traffic_changes: dict, seconds: float, config_changes: dict | None = None):
    cell = H.load_cell(cell_name)
    cell.traffic = dict(cell.traffic, **traffic_changes)
    cell.config = dict(cell.config, **(config_changes or {}))
    return H.Ctx(types.SimpleNamespace(seed=SEED, seconds=seconds, trace=0), cell, 0.0)


def _correct(out: H.Outcome) -> bool:
    return all(c.ok for c in out.checks)


# ---------------------------------------------------------------------------
# electra_1m.state_root
# ---------------------------------------------------------------------------


def _state_run(**faults) -> H.Outcome:
    from benchmark.drivers import state_writes

    ctx = _ctx("electra_1m.state_root", {"warmup_steps": 2, "max_steps_per_s": 4}, 1.0, {"validators": 2048})
    return state_writes.run(ctx, **faults)


def test_state_root_sound():
    out = _state_run()
    assert _correct(out) and out.attempted >= 1


def test_state_root_answer_altered():
    assert not _correct(_state_run(root_of=lambda s: bytes(32 - len(b"x")) + b"x"))


def test_state_root_state_unchanged():
    first = []

    def stale(s):
        if not first:
            first.append(bytes(s.hash_tree_root()))
        return first[0]

    assert not _correct(_state_run(root_of=stale))


def test_state_root_control_loses_a_write():
    """The control: the step's participation writes never reach the state
    (the root no longer commits to every field)."""
    from benchmark.inputs import state as S

    def lossy(state, w, types_, preset):
        S.apply_program(state, dataclasses.replace(w, part_idx=w.part_idx[:0], part_xor=w.part_xor[:0]), types_, preset)

    assert not _correct(_state_run(apply=lossy))


# ---------------------------------------------------------------------------
# deneb_1m.gossip_att
# ---------------------------------------------------------------------------


def _gossip_run(program=None) -> H.Outcome:
    from benchmark.drivers import gossip_attestations

    ctx = _ctx("deneb_1m.gossip_att", {"warmup_attestations": 8, "forged_after_window": 2,
                                        "queued_batches": 1, "reference_sample": 6}, 2.0, {"validators": 8192})
    return gossip_attestations.run(ctx, program)


def _patch_batch(fn):
    def program(chain):
        inner = chain.process_attestation_batch
        chain.process_attestation_batch = lambda atts: fn(inner, atts)

    return program


def test_gossip_sound():
    out = _gossip_run()
    assert _correct(out) and out.attempted >= 8


def test_gossip_answer_altered():
    """Every verdict turned into an accept where the chain produces it."""
    assert not _correct(_gossip_run(_patch_batch(lambda inner, atts: [object() for _ in inner(atts)])))


def test_gossip_half_the_batch_left_out():
    assert not _correct(_gossip_run(_patch_batch(lambda inner, atts: inner(atts[: len(atts) // 2]))))


def test_gossip_votes_not_counted():
    """Right verdicts, but fork choice never takes the accepted votes."""

    def program(chain):
        chain.fork_choice.on_attestation_batch = lambda atts, is_from_block=False: [None] * len(atts)

    assert not _correct(_gossip_run(program))


def test_gossip_op_pool_left_out():
    """Right verdicts, but the op pool never holds the accepted attestations."""

    def program(chain):
        chain.op_pool.insert_attestation = lambda att: None

    assert not _correct(_gossip_run(program))


def test_gossip_control_fake_crypto():
    """The control: the program's own fake_crypto backend, which accepts
    every signature."""
    from lighthouse_tpu_torch.crypto import bls

    assert not _correct(_gossip_run(lambda chain: bls.set_backend("fake_crypto")))


# ---------------------------------------------------------------------------
# deneb_1m.blob_sync
# ---------------------------------------------------------------------------

TAU = 0x1234567890ABCDEF1234567890ABCDEF % R


@pytest.fixture(scope="module")
def known_tau_setup(tmp_path_factory):
    """A setup file in the ceremony's format over the 4,096-point domain
    whose secret is TAU."""
    n = 4096
    w = pow(7, (R - 1) // n, R)
    natural = [pow(w, i, R) for i in range(n)]
    tn1 = (pow(TAU, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)
    lag = [wi * tn1 % R * pow((TAU - wi) % R, R - 2, R) % R * n_inv % R for wi in natural]
    data = {
        "g1_lagrange": ["0x" + g1_to_bytes(pt_mul(FQ, G1_GEN, s)).hex() for s in lag],
        "g2_monomial": ["0x" + g2_to_bytes(G2_GEN).hex(), "0x" + g2_to_bytes(pt_mul(FQ2, G2_GEN, TAU)).hex()],
    }
    path = tmp_path_factory.mktemp("setup") / "known_tau_setup.json"
    path.write_text(json.dumps(data))
    return str(path)


def _known_tau_kzg(monkeypatch, path):
    """Commitments and proofs by the known secret: [p(tau)]G1 and
    [(p(tau) - p(z)) / (tau - z)]G1."""
    from lighthouse_tpu_torch.crypto.kzg import Kzg

    ref = Verifier(path)

    def commit(self, blob):
        return g1_to_bytes(pt_mul(FQ, G1_GEN, ref.evaluate(blob, TAU)))

    def prove(self, blob, commitment):
        z = ref.challenge(blob, commitment)
        q = (ref.evaluate(blob, TAU) - ref.evaluate(blob, z)) * pow((TAU - z) % R, R - 2, R) % R
        return g1_to_bytes(pt_mul(FQ, G1_GEN, q))

    monkeypatch.setattr(Kzg, "blob_to_kzg_commitment", commit)
    monkeypatch.setattr(Kzg, "compute_blob_kzg_proof", prove)


def _blob_run(monkeypatch, path, program=None) -> H.Outcome:
    from lighthouse_tpu_torch.crypto.kzg import TrustedSetup

    from benchmark.drivers import blob_segments

    _known_tau_kzg(monkeypatch, path)
    monkeypatch.setattr(TrustedSetup, "CEREMONY_SEARCH_PATHS", (path,))
    ctx = _ctx("deneb_1m.blob_sync", {"blob_counts": [[0, 1], [1, 2]], "pool_blobs_per_s": 2, "reference_blocks": 2}, 0.5,
               {"blob_route_anchor_validators": 256})
    return blob_segments.run(ctx, program)


def _patch_segment(fn):
    def program(chain):
        inner = chain.process_segment_blob_sidecars
        chain.process_segment_blob_sidecars = lambda by_root: fn(inner, by_root)

    return program


def test_known_tau_setup_is_sound(known_tau_setup):
    """The setup's proofs verify under the reference, and a wrong one does not."""
    ref = Verifier(known_tau_setup)
    blob = b"".join(int(x).to_bytes(32, "big") for x in np.arange(4096) * 3 + 1)
    c = g1_to_bytes(pt_mul(FQ, G1_GEN, ref.evaluate(blob, TAU)))
    z = ref.challenge(blob, c)
    q = (ref.evaluate(blob, TAU) - ref.evaluate(blob, z)) * pow((TAU - z) % R, R - 2, R) % R
    assert ref.verify(blob, c, g1_to_bytes(pt_mul(FQ, G1_GEN, q)))
    assert not ref.verify(blob, c, g1_to_bytes(pt_mul(FQ, G1_GEN, q + 1)))
    assert bit_reversal_permutation([0, 1, 2, 3]) == [0, 2, 1, 3]


def test_blob_sound_and_faults(monkeypatch, known_tau_setup):
    """One set-up cost a case: the sound route, an answer altered (every
    block accepted), half of the blocks left without a verdict, and the
    control, a KZG batch check that skips its pairing."""
    assert _correct(_blob_run(monkeypatch, known_tau_setup))
    assert not _correct(_blob_run(monkeypatch, known_tau_setup,
                                  _patch_segment(lambda inner, by_root: {r: None for r in inner(by_root)})))
    assert not _correct(_blob_run(monkeypatch, known_tau_setup, _patch_segment(
        lambda inner, by_root: dict(list(inner(by_root).items())[: len(by_root) // 2]))))

    def control(chain):
        chain.data_availability_checker.kzg.verify_blob_kzg_proof_batch = lambda *a: True

    assert not _correct(_blob_run(monkeypatch, known_tau_setup, control))
