"""Each cell's control on the card, at the cell's own size, on three seeds:
the comparison that decides ``correct`` has to refuse it.

The cells state no precision, so each control breaks one guarantee its
configuration states: the gossip cell runs the program's own
``fake_crypto`` BLS backend (every signature accepted); the blob cell's KZG
batch check skips its pairing (every proof accepted); the state-root cell
loses each step's participation writes before they reach the state (the root
no longer commits to every field). A short window at the cell's own load.

    python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_control.py -m gpu -s
"""

from __future__ import annotations

import dataclasses
import json
import time
import types

import pytest

from benchmark import harness as H

SEEDS = (3_000_000_019, 3_000_000_037, 3_000_000_049)
WINDOW_S = 10.0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield
    H.stop_program_processes()


def _state_control(driver, ctx):
    from benchmark.inputs import state as S

    def lossy(state, w, types_, preset):
        S.apply_program(state, dataclasses.replace(w, part_idx=w.part_idx[:0], part_xor=w.part_xor[:0]), types_, preset)

    return driver.run(ctx, apply=lossy)


def _gossip_control(driver, ctx):
    from lighthouse_tpu_torch.crypto import bls

    try:
        return driver.run(ctx, lambda chain: bls.set_backend("fake_crypto"))
    finally:
        bls.set_backend(None)


def _blob_control(driver, ctx):
    def skip_pairing(chain):
        chain.data_availability_checker.kzg.verify_blob_kzg_proof_batch = lambda *a: True

    return driver.run(ctx, skip_pairing)


CONTROLS = {
    "electra_1m.state_root": _state_control,
    "deneb_1m.gossip_att": _gossip_control,
    "deneb_1m.blob_sync": _blob_control,
}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell_name", sorted(CONTROLS))
def test_control_is_refused(card, cell_name, seed):
    cell = H.load_cell(cell_name)
    ctx = H.Ctx(types.SimpleNamespace(seed=seed, seconds=WINDOW_S, trace=0), cell, time.monotonic())
    out = CONTROLS[cell_name](H.driver_of(cell), ctx)
    readings = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    print(json.dumps({"control": cell_name, "seed": seed, "attempted": out.attempted, "checks": readings}), flush=True)
    assert not all(c.ok for c in out.checks)
