"""lighthouse_tpu_torch kernels on a CUDA card, against their plain
PyTorch versions on the same card and against hashlib: byte-identical.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one. This file imports no JAX, so it also runs where JAX is not
installed (see README.md, "The PyTorch/CUDA port", for the command).
"""

import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import block_update, build_deneb_state, host_state_root
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.ops import sha256 as k
from lighthouse_tpu_torch.types import MinimalEthSpec, build_types

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = default_device()
    set_default_device("cuda")
    yield torch.device("cuda")
    set_default_device(prev)


def _hashlib_rows(rows: np.ndarray) -> np.ndarray:
    return np.stack(
        [np.frombuffer(hashlib.sha256(r.tobytes()).digest(), np.uint8) for r in rows]
    )


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 65_539])
def test_kernel_matches_plain_and_hashlib(cuda, n):
    rows_np = np.random.default_rng(n).integers(0, 256, (n, 64), dtype=np.uint8)
    rows = torch.from_numpy(rows_np).to(cuda)
    before = k.COUNTS["launches"]
    got = k.sha256_pairs(rows)
    torch.cuda.synchronize()
    assert k.COUNTS["launches"] == before + 1
    assert torch.equal(got, k.sha256_rows_plain(rows))
    sample = np.arange(0, n, max(1, n // 512))
    assert np.array_equal(got.cpu().numpy()[sample], _hashlib_rows(rows_np[sample]))


def test_merkle_tree_levels_matches_plain(cuda):
    leaves = np.random.default_rng(3).integers(0, 256, (1 << 14, 32), dtype=np.uint8)
    got = k.merkle_tree_levels(leaves)
    want = k.merkle_tree_levels(leaves, device="cpu")
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_state_root_on_card_equals_host_lanes(cuda):
    E = MinimalEthSpec
    state = build_deneb_state(build_types(E), E, 4096, seed=4)
    _make_persistent(state)
    before = k.COUNTS["launches"]
    root = state.hash_tree_root()
    assert k.COUNTS["launches"] > before
    assert root == host_state_root(state)
    block_update(state, E, np.random.default_rng(1))
    root = state.hash_tree_root()
    assert root == host_state_root(state)
