"""The port's store (store/{kv,hot_cold,native,migrator,__init__}.py and
the native engine `store/_native/lsm_store.cc`) against the JAX package on
the same seeded inputs.

Both packages' BeaconChainHarness (minimal preset, 64 interop validators,
`fake_crypto`, the CPU device) write their genesis state, blocks and
post-states through a HotColdDB over each backend (memory, sqlite, the
native LSM engine); seeded blob sidecars and data columns are added; every
key and value of every column, hot and cold, must be byte-equal, and every
state read back must root as written. Over 5 epochs the migrator must
move and delete the same keys at finality. The port's native library is
built from its own copy of the source into lighthouse_tpu_torch/build/.
Tolerance: exact equality of bytes and keys."""

import random
from pathlib import Path
from types import SimpleNamespace

import pytest

from lighthouse_tpu.beacon_chain import harness as jax_harness
from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.store import DBColumn as JaxDBColumn
from lighthouse_tpu.store import HotColdDB as JaxHotColdDB
from lighthouse_tpu.store import MemoryStore as JaxMemoryStore
from lighthouse_tpu.store import SqliteStore as JaxSqliteStore
from lighthouse_tpu.store import native as jax_native
from lighthouse_tpu.types import MinimalEthSpec as JaxE
from lighthouse_tpu.types import minimal_spec as jax_minimal_spec
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain import harness as port_harness
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.store import DBColumn as PortDBColumn
from lighthouse_tpu_torch.store import HotColdDB as PortHotColdDB
from lighthouse_tpu_torch.store import MemoryStore as PortMemoryStore
from lighthouse_tpu_torch.store import SqliteStore as PortSqliteStore
from lighthouse_tpu_torch.store import native as port_native
from lighthouse_tpu_torch.types import MinimalEthSpec as PortE
from lighthouse_tpu_torch.types import minimal_spec as port_minimal_spec

PKG = Path(port_native.__file__).resolve().parent.parent

JAX = SimpleNamespace(
    name="jax", harness=jax_harness, DBColumn=JaxDBColumn, HotColdDB=JaxHotColdDB, MemoryStore=JaxMemoryStore,
    SqliteStore=JaxSqliteStore, native=jax_native, E=JaxE, spec=jax_minimal_spec,
)
PORT = SimpleNamespace(
    name="port", harness=port_harness, DBColumn=PortDBColumn, HotColdDB=PortHotColdDB, MemoryStore=PortMemoryStore,
    SqliteStore=PortSqliteStore, native=port_native, E=PortE, spec=port_minimal_spec,
)
BACKENDS = ("memory", "sqlite", "native")


@pytest.fixture(autouse=True)
def fake_crypto_on_the_cpu():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    jax_bls.set_backend("fake_crypto")
    port_bls.set_backend("fake_crypto")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


def _kv(side, backend, path: Path):
    if backend == "memory":
        return side.MemoryStore()
    if backend == "sqlite":
        return side.SqliteStore(str(path) + ".db")
    return side.native.NativeStore(str(path))


def _store(side, backend, tmp_path):
    where = tmp_path / side.name / backend
    where.mkdir(parents=True)
    return side.HotColdDB(_kv(side, backend, where / "hot"), cold=_kv(side, backend, where / "cold"))


def _dump(store, DBColumn) -> dict:
    """Every (key, value) of every column, hot and cold."""
    return {
        f"{where}/{col.name}": sorted((bytes(k), bytes(kv.get(col, k))) for k in kv.keys(col))
        for where, kv in (("hot", store.hot), ("cold", store.cold))
        for col in DBColumn
    }


def _sidecars(types, E, slot: int, n: int):
    rng = random.Random(slot)
    header = types.SignedBeaconBlockHeader(
        message=types.BeaconBlockHeader(
            slot=slot, proposer_index=rng.randrange(64), parent_root=rng.randbytes(32),
            state_root=rng.randbytes(32), body_root=rng.randbytes(32),
        ),
        signature=rng.randbytes(96),
    )
    return [
        types.BlobSidecar(
            index=i, blob=rng.randbytes(32 * E.FIELD_ELEMENTS_PER_BLOB), kzg_commitment=rng.randbytes(48),
            kzg_proof=rng.randbytes(48), signed_block_header=header,
            kzg_commitment_inclusion_proof=[rng.randbytes(32) for _ in range(E.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH)],
        )
        for i in range(n)
    ]


def _written(side, backend, tmp_path, slots: int):
    """A harness over `backend` driven `slots` slots, with two blocks'
    blob sidecars added; the store's bytes and each state's root read back."""
    store = _store(side, backend, tmp_path)
    h = side.harness.BeaconChainHarness(side.spec(), side.E, validator_count=64, store=store)
    roots = h.extend_chain(slots)
    for root in roots[-2:]:
        store.put_blob_sidecars(root, _sidecars(h.chain.types, side.E, int(h.chain._blocks_by_root[root].message.slot), 2))
    states = {
        bytes(k): bytes(store.get_state(k).hash_tree_root())
        for k in store.hot.keys(side.DBColumn.BEACON_STATE)
    }
    blobs = [[sc.serialize() for sc in store.get_blob_sidecars(r)] for r in roots[-2:]]
    return store, _dump(store, side.DBColumn), states, blobs


@pytest.mark.parametrize("backend", BACKENDS)
def test_hot_cold_bytes_equal(backend, tmp_path):
    out = {}
    for side in (JAX, PORT):
        store, dump, states, blobs = _written(side, backend, tmp_path, 4)
        assert all(k == v for k, v in states.items())  # each state roots to its key
        out[side.name] = (dump, states, blobs)
        for kv in (store.hot, store.cold):
            if hasattr(kv, "close"):
                kv.close()
    assert out["port"] == out["jax"]
    dump = out["port"][0]
    assert dump["hot/BEACON_BLOCK"] and dump["hot/BEACON_STATE"] and dump["hot/BLOB_SIDECARS"]


def _migration(side, backend, tmp_path):
    """Keys of the store before and after finality reaches epoch 3: what
    the migrator moved to cold and deleted from hot."""
    store = _store(side, backend, tmp_path)
    h = side.harness.BeaconChainHarness(side.spec(), side.E, validator_count=64, store=store)
    h.extend_chain(8 * 3)
    before = _dump(store, side.DBColumn)
    h.extend_chain(8 * 2)
    after = _dump(store, side.DBColumn)
    keys = lambda d: {c: {k for k, _ in rows} for c, rows in d.items()}  # noqa: E731
    kb, ka = keys(before), keys(after)
    out = (
        h.finalized_epoch,
        int(store.split_slot),
        {c: sorted(kb[c] - ka[c]) for c in kb},
        {c: sorted(ka[c] - kb[c]) for c in kb},
    )
    for kv in (store.hot, store.cold):
        if hasattr(kv, "close"):
            kv.close()
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_migrator_deletes_the_same_keys_at_finality(backend, tmp_path):
    jax_out = _migration(JAX, backend, tmp_path)
    port_out = _migration(PORT, backend, tmp_path)
    assert port_out == jax_out
    finalized, split, deleted, added = port_out
    assert finalized >= 3 and split == finalized * 8
    assert deleted["hot/BEACON_STATE"] and added["cold/BEACON_BLOCK"]


def test_native_library_is_the_ports_own_build(tmp_path):
    """The port builds its copy of lsm_store.cc into its build directory,
    keyed by the source's hash, and loads that library, never the JAX
    package's."""
    s = port_native.NativeStore(str(tmp_path / "db"))
    s.put(PortDBColumn.BEACON_META, b"k", b"v")
    assert s.get(PortDBColumn.BEACON_META, b"k") == b"v"
    s.close()
    loaded = Path(port_native._lib._name).resolve()
    assert loaded == port_native.library_path().resolve()
    assert loaded.parent == PKG / "build"
    assert port_native._SRC == PKG / "store" / "_native" / "lsm_store.cc"
    jax_pkg = Path(jax_native.__file__).resolve().parent
    assert jax_pkg not in loaded.parents
    assert port_native._SRC.read_bytes() == (jax_pkg / "_native" / "lsm_store.cc").read_bytes()
