"""lighthouse_tpu_torch.ops.sha256 (plain PyTorch version on the CPU)
against lighthouse_tpu.ops.sha256 and hashlib: byte-identical, no
tolerance. The kernel itself runs only on a card: tests/test_torch_gpu.py."""

import hashlib
import re

import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import sha256 as jax_sha
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.ops import sha256 as port_sha
from lighthouse_tpu_torch.utils import sha256_batch as port_batch


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device()
    set_default_device("cpu")
    yield
    set_default_device(prev)


def _words_to_rows(words) -> np.ndarray:
    """JAX layout ([n, k] big-endian u32 words) -> the port's bytes."""
    w = np.asarray(words, dtype=np.uint32)
    return w.astype(">u4").view(np.uint8).reshape(w.shape[0], -1)


def _hashlib_rows(rows: np.ndarray) -> np.ndarray:
    return np.stack(
        [np.frombuffer(hashlib.sha256(r.tobytes()).digest(), np.uint8) for r in rows]
    )


@pytest.mark.parametrize("n", [33, 2048])
def test_sha256_pairs_plain_matches_jax_and_hashlib(n):
    rows = np.random.default_rng(n).integers(0, 256, (n, 64), dtype=np.uint8)
    got = port_sha.sha256_pairs(torch.from_numpy(rows)).numpy()
    words = rows.view(">u4").astype(np.uint32).reshape(n, 16)
    want_jax = _words_to_rows(jax_sha.sha256_pairs(words))
    assert np.array_equal(got, want_jax)
    assert np.array_equal(got, _hashlib_rows(rows))
    assert np.array_equal(got, port_batch.hash_rows_numpy(rows))


def test_merkle_tree_levels_matches_jax_level_by_level():
    leaves = np.random.default_rng(12).integers(0, 256, (1 << 12, 32), dtype=np.uint8)
    got = port_sha.merkle_tree_levels(leaves)
    want = jax_sha.merkle_tree_levels(leaves.view(">u4").astype(np.uint32))
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert np.array_equal(g, _words_to_rows(w))
    assert np.array_equal(
        port_sha.merkleize_device(leaves), _words_to_rows(jax_sha.merkleize_device(
            leaves.view(">u4").astype(np.uint32)
        )[None])[0]
    )


def test_device_hash_rows_ragged_matches_jax():
    n = 2045  # JAX pads to 2048; the port takes any n
    rows = np.random.default_rng(5).integers(0, 256, (n, 64), dtype=np.uint8)
    got = port_sha.device_hash_rows(rows)
    assert got.shape == (n, 32)
    assert np.array_equal(got, jax_sha.device_hash_rows(rows))
    assert port_sha.device_hash_rows(rows[:0]).shape == (0, 32)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049])
def test_hash_rows_dispatch_matches_hashlib(n):
    """Below _BATCH_MIN the hashlib loop, from it the kernel's plain
    version on the CPU device: the same bytes either side."""
    rows = np.random.default_rng(n).integers(0, 256, (n, 64), dtype=np.uint8)
    before = dict(port_sha.COUNTS)
    assert np.array_equal(port_batch.hash_rows(rows), _hashlib_rows(rows))
    assert port_sha.COUNTS == before  # no kernel launch on the CPU


def test_read_only_input_is_accepted():
    rows = np.random.default_rng(9).integers(0, 256, (2048, 64), dtype=np.uint8)
    rows.setflags(write=False)
    assert np.array_equal(port_sha.device_hash_rows(rows), _hashlib_rows(rows))


def test_wrapper_checks_shape_dtype_contiguity():
    with pytest.raises(ValueError):
        port_sha.sha256_pairs(torch.zeros((4, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        port_sha.sha256_pairs(torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        port_sha.sha256_pairs(torch.zeros((64, 4), dtype=torch.uint8).t())
    with pytest.raises(ValueError):
        port_sha.merkle_tree_levels(np.zeros((3, 32), dtype=np.uint8))


def test_launch_refuses_cpu_tensors():
    """The one launch site takes CUDA tensors only: nothing reaches the
    kernel from the CPU, and nothing falls back to the plain version."""
    src = torch.zeros((8, 64), dtype=torch.uint8)
    dst = torch.zeros((8, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_sha._launch(src, dst)


def _c_table(src: str, name: str) -> list[int]:
    body = re.search(name + r"\[64\] = \{(.*?)\};", src, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x[0-9a-f]{8}", body)]


def test_cuda_source_constants_match_host_tables():
    """The kernel's K and padding-block K+W tables and its IV are the host
    lanes' (they live in csrc/sha256.cuh, which sha256.cu includes)."""
    src = port_sha.SOURCE.read_text()
    assert '#include "sha256.cuh"' in src
    src += (port_sha.SOURCE.parent / "sha256.cuh").read_text()
    assert _c_table(src, "kK") == [int(k) for k in port_batch._K]
    assert _c_table(src, "kKWPad") == [int(k) for k in port_batch._KW_PAD]
    iv = [int(x, 16) for x in re.findall(r"0x[0-9a-f]{8}", src.split("uint32_t iv[8] =")[1][:200])]
    assert iv == [int(v) for v in port_batch._IV]


def test_ptxas_usage_parse():
    log = (
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
        "ptxas info    : Function properties for k\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 38 registers, 368 bytes cmem[0]\n"
    )
    assert port_sha.ptxas_usage(log) == {
        "registers": 38,
        "spill_store_bytes": 0,
        "spill_load_bytes": 0,
    }
