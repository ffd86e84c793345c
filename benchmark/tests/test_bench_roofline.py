"""The least-work arithmetic against counts made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import roofline as R
from benchmark.inputs.state import Writes


def test_path_nodes_by_hand():
    # one leaf of 8: 3 nodes; leaves 0 and 1 share every node; 0 and 7 share the root
    assert R.path_nodes([5], 3) == 3
    assert R.path_nodes([0, 1], 3) == 3
    assert R.path_nodes([0, 7], 3) == 5
    assert R.path_nodes(range(8), 3) == 7


def test_list_and_tree_rows_by_hand():
    # 4 chunks under a limit of 16: 2 levels of path, 2 zero folds, the mix-in
    assert R.list_path_rows([2], 4, 16) == 2 + 2 + 1
    assert R.full_tree_rows(5) == 3 + 2 + 1
    assert R.full_tree_rows(1) == 0


def test_bls_batch_by_hand():
    # one set, one message: the subgroup check, two 64-bit ladders of 63
    # doublings and 31.5 mixed additions, no sums, one hash, two Miller
    # loops, the squarings and one final exponentiation
    fq = 1166 + (63 * 16 + 31.5 * 29) + (63 * 7 + 31.5 * 11) + 4403 + 2 * 1780 + 62 * 36 + 7182
    assert R.bls_batch_seconds(1, 1) == pytest.approx(fq * R.FQ_MUL_OPS / R.INT32_MUL_PER_S)
    assert R.bls_batch_seconds(64, 40) > R.bls_batch_seconds(64, 1) > R.bls_batch_seconds(32, 1)
    assert R.bls_batch_seconds(0, 0) == 0.0


def test_kzg_batch_by_hand():
    # what K8 and K4 compute of one blob on 4 points: the tree of 9
    # products, 2 squarings for z^4, 4 to finish, 3 of the batch inverse and
    # its one inversion; every byte read; the two-pair pairing
    n = 4
    fr = 3 * n - 3 + 2 + 4 + 3
    fq = 2 * 1780 + 62 * 36 + 7182
    muls = fq * R.FQ_MUL_OPS + fr * R.FR_MUL_OPS
    ops = 255 * 32
    want = max(muls / R.INT32_MUL_PER_S, (muls + ops) / R.INT32_OPS_PER_S, 32 * n / R.HBM_BYTES_PER_S)
    assert R.kzg_batch_seconds(1, n) == pytest.approx(want)
    assert R.kzg_batch_seconds(192) > R.kzg_batch_seconds(6) > 0


def test_state_write_rows_by_hand():
    preset = {"SLOTS_PER_EPOCH": 32, "SLOTS_PER_HISTORICAL_ROOT": 8, "EPOCHS_PER_HISTORICAL_VECTOR": 4}
    w = Writes(slot=33, balance_idx=np.array([0]), balance_add=np.array([1], np.uint64), slashed_idx=np.array([0]),
               part_idx=np.array([0]), part_xor=np.array([1], np.uint8), block_root=b"", state_root=b"", randao=b"")
    named = dict(slot=2, block_roots=5, state_roots=6, validators=11, balances=12, randao_mixes=13,
                 current_epoch_participation=16)
    fields = {f"f{i}": i for i in range(28) if i not in named.values()} | named  # Deneb's 28 fields
    n = 64
    rows = R.state_write_rows(w, n, "deneb", preset, {}, fields)
    balances = 4 + (38 - 4) + 1  # 16 chunks: 4 levels, folds to 2^38, mix-in
    validators = 3 + 6 + (40 - 6) + 1  # the record's 3, 64 leaves, folds to 2^40, mix-in
    participation = 1 + (35 - 1) + 1  # 2 chunks
    roots = 2 * 3 + 2  # one leaf of 8 twice, one of 4
    top = R.path_nodes([2, 5, 6, 11, 12, 13, 16], 5)
    assert rows == balances + validators + participation + roots + top
