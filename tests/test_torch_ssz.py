"""lighthouse_tpu_torch.ssz against lighthouse_tpu.ssz on the same seeded
inputs: merkleize on both sides of the 2048-chunk kernel threshold, SSZ
List/Vector/Container roots and bytes, and the three tiers of the cached
tree. Roots and bytes must be byte-identical."""

import numpy as np
import pytest

import lighthouse_tpu.ssz as jax_ssz
import lighthouse_tpu.ssz.cached_tree_hash as jax_cth
import lighthouse_tpu_torch.ssz as port_ssz
import lighthouse_tpu_torch.ssz.cached_tree_hash as port_cth
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.utils.sha256_batch import hash_rows_hashlib


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device()
    set_default_device("cpu")
    yield
    set_default_device(prev)


def _hashlib_root(leaves: np.ndarray, limit: int) -> bytes:
    """Independent fold: pad to the limit's power of two with zero subtrees."""
    from lighthouse_tpu_torch.utils.hash import ZERO_HASHES, hash32_concat

    depth = (limit - 1).bit_length()
    m = 1 << (leaves.shape[0] - 1).bit_length()
    level = np.zeros((m, 32), np.uint8)
    level[: leaves.shape[0]] = leaves
    while level.shape[0] > 1:
        level = hash_rows_hashlib(level.reshape(-1, 64))
    root = level[0].tobytes()
    for d in range((m - 1).bit_length(), depth):
        root = hash32_concat(root, ZERO_HASHES[d])
    return root


@pytest.mark.parametrize("limit", [None, 1 << 20])
@pytest.mark.parametrize("n", [2047, 2048, 4096])
def test_merkleize_matches_jax(n, limit):
    data = np.random.default_rng(n).integers(0, 256, n * 32, dtype=np.uint8).tobytes()
    got = port_ssz.merkleize(data, limit)
    assert got == jax_ssz.merkleize(data, limit)
    assert got == _hashlib_root(
        np.frombuffer(data, np.uint8).reshape(n, 32), limit or n
    )


def _types(ssz):
    class Inner(ssz.Container):
        index: ssz.uint64
        root: ssz.Bytes32
        flag: ssz.boolean

    class Outer(ssz.Container):
        roots: ssz.List[ssz.Bytes32, 1 << 16]
        values: ssz.List[ssz.uint64, 1 << 20]
        slashings: ssz.Vector[ssz.uint64, 8192]
        bits: ssz.Bitlist[4096]
        inners: ssz.List[Inner, 1024]
        pubkey: ssz.Bytes48

    return Inner, Outer


def _outer_kwargs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        roots=[rng.bytes(32) for _ in range(3000)],  # 3000 chunks: kernel path
        values=rng.integers(0, 2**63, 10_000, dtype=np.uint64).tolist(),  # 2500 chunks
        slashings=rng.integers(0, 2**40, 8192, dtype=np.uint64).tolist(),  # 2048 chunks
        bits=(rng.random(3001) < 0.5).tolist(),
        inners=[
            dict(index=i, root=rng.bytes(32), flag=bool(i & 1)) for i in range(40)
        ],
        pubkey=rng.bytes(48),
    )


def _build(types, kw):
    Inner, Outer = types
    kw = dict(kw)
    kw["inners"] = [Inner(**x) for x in kw["inners"]]
    return Outer(**kw)


def test_list_vector_container_roots_and_bytes_match_jax():
    kw = _outer_kwargs(21)
    port_t, jax_t = _types(port_ssz), _types(jax_ssz)
    p, j = _build(port_t, kw), _build(jax_t, kw)
    data = j.serialize()
    assert p.serialize() == data
    assert p.hash_tree_root() == j.hash_tree_root()
    for fname in ("roots", "values", "slashings", "bits", "inners"):
        ptype, jtype = port_t[1]._fields[fname], jax_t[1]._fields[fname]
        assert ptype.hash_tree_root_of(getattr(p, fname)) == jtype.hash_tree_root_of(
            getattr(j, fname)
        ), fname
    back = port_t[1].deserialize(data)
    assert back == p
    assert back.hash_tree_root() == j.hash_tree_root()
    assert jax_t[1].deserialize(p.serialize()) == j


def test_cached_tree_tiers_match_jax():
    """Rebuild, sparse rows, full diff (with a lift batch past 2048 rows)
    and a mass-churn rebuild: the same mutations in both packages."""
    rng = np.random.default_rng(77)
    limit = 1 << 20
    n = 8192
    leaves = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    pc, jc = port_cth.TreeHashCache(limit), jax_cth.TreeHashCache(limit)

    def check(p_root, j_root):
        assert p_root == j_root
        assert p_root == _hashlib_root(leaves, limit)

    before = port_cth.stats()
    check(pc.update(leaves), jc.update(leaves))  # tier 3: first build

    idx = np.sort(rng.choice(n, 5, replace=False))
    rows = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    leaves[idx] = rows
    check(pc.update_rows(idx, rows, n), jc.update_rows(idx, rows, n))  # tier 1

    leaves[rng.choice(n, 3000, replace=False)] ^= 0xFF  # tier 2, lift > 2048 rows
    check(pc.update(leaves), jc.update(leaves))

    leaves[rng.choice(n, 6000, replace=False)] ^= 0x5A  # > half dirty: tier 3
    check(pc.update(leaves), jc.update(leaves))

    grown = np.vstack([leaves, rng.integers(0, 256, (100, 32), dtype=np.uint8)])
    leaves = grown  # pow2 growth: rebuild
    check(pc.update(leaves), jc.update(leaves))

    after = port_cth.stats()
    assert after["sparse_updates"] - before["sparse_updates"] == 1
    assert after["rebuilds"] - before["rebuilds"] == 3


def test_cached_tree_copy_is_independent():
    rng = np.random.default_rng(3)
    leaves = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
    a = port_cth.TreeHashCache(4096)
    root = a.update(leaves)
    b = a.copy()
    changed = leaves.copy()
    changed[17] ^= 1
    assert b.update(changed) == _hashlib_root(changed, 4096)
    assert a.root_only() == root
