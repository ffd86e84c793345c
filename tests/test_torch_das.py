"""The port's data availability (beacon_chain/data_availability.py, das/)
against the JAX package on the same seeded blobs: column sidecars,
reconstruction, custody and sampling, the DA checker's blob, column,
reconstruction and custody-plus-sampling routes, its error taxonomy and
its finality watermark (the cases of tests/test_das.py), run through both
packages side by side.

Scenario-sized spec (the JAX package's DasTestnetEthSpec: 64 field
elements over 16 columns on the minimal preset), so each case is host Fr
math in test time. Both sides use their host KZG engine (device=False,
the JAX package's bigint engine); the blob route also runs once on the
port's CPU device engine, the plain versions of the K8, K9 and K4 kernels.
Tolerance: exact equality of bytes, matrices and verdicts.
"""

import random
from types import SimpleNamespace

import pytest
import torch

from lighthouse_tpu import das as jax_das
from lighthouse_tpu.beacon_chain import data_availability as jax_da
from lighthouse_tpu.crypto import kzg as jax_kzg
from lighthouse_tpu.types.containers import build_types as jax_build_types
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JaxMinimalEthSpec
from lighthouse_tpu_torch import das as port_das
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain import data_availability as port_da
from lighthouse_tpu_torch.crypto import kzg as port_kzg
from lighthouse_tpu_torch.metrics import REGISTRY as PORT_REGISTRY
from lighthouse_tpu_torch.types import MinimalEthSpec, build_types

FE = 64
COLS = 16
HALF = COLS // 2
R = port_kzg.FR_MODULUS


def _das_spec(base):
    class DasEthSpec(base):
        FIELD_ELEMENTS_PER_BLOB = FE
        NUMBER_OF_COLUMNS = COLS
        DATA_COLUMN_SIDECAR_SUBNET_COUNT = 8
        CUSTODY_REQUIREMENT = 2
        SAMPLES_PER_SLOT = 3

    return DasEthSpec


def _blob(seed: int) -> bytes:
    rng = random.Random(seed)
    return b"".join(rng.randrange(R).to_bytes(32, "big") for _ in range(FE))


BLOBS = [_blob(11), _blob(12)]


def _side(das, da, kzg_mod, build, base):
    E = _das_spec(base)
    T = build(E)
    kzg = kzg_mod.Kzg(kzg_mod.TrustedSetup.insecure_dev(FE), device=False)
    body = T.BeaconBlockBodyDeneb(blob_kzg_commitments=[kzg.blob_to_kzg_commitment(b) for b in BLOBS])
    signed = T.SignedBeaconBlockDeneb(message=T.BeaconBlockDeneb(slot=5, proposer_index=3, body=body), signature=b"\x00" * 96)
    return SimpleNamespace(
        das=das, da=da, kzg_mod=kzg_mod, E=E, T=T, kzg=kzg, signed=signed,
        root=signed.message.hash_tree_root(),
        sidecars=das.build_data_column_sidecars(signed, BLOBS, kzg, E),
    )


@pytest.fixture(scope="module")
def sides():
    return (
        _side(jax_das, jax_da, jax_kzg, jax_build_types, JaxMinimalEthSpec),
        _side(port_das, port_da, port_kzg, build_types, MinimalEthSpec),
    )


def _both(sides, fn):
    """fn(side) on the JAX side and the port's; the two results equal."""
    jax_out, port_out = fn(sides[0]), fn(sides[1])
    assert port_out == jax_out
    return port_out


def _ser(sidecars) -> list[bytes]:
    return [sc.serialize() for sc in sidecars]


def test_column_sidecars_byte_equal(sides):
    out = _both(sides, lambda s: (s.root, _ser(s.sidecars)))
    assert len(out[1]) == COLS
    for s in sides:
        s.das.verify_data_column_sidecars(s.sidecars, s.kzg, s.E)


@pytest.mark.parametrize("seed", [21, 22])
def test_recover_matrix_equal(sides, seed):
    keep = random.Random(seed).sample(range(COLS), HALF)
    matrix = _both(sides, lambda s: s.das.recover_matrix([s.sidecars[c] for c in keep], s.E))
    assert [matrix[int(sc.index)] for sc in sides[1].sidecars] == [[bytes(c) for c in sc.column] for sc in sides[1].sidecars]
    assert _both(sides, lambda s: s.das.blobs_from_matrix(matrix, s.E)) == BLOBS


def test_recover_below_threshold_raises_in_both(sides):
    for s in sides:
        with pytest.raises(s.das.ErasureError):
            s.das.recover_matrix(s.sidecars[: HALF - 1], s.E)


def test_cells_and_proofs_on_the_honest_path_equal():
    """A setup whose tau is not the dev one takes compute_cells_and_proofs'
    honest path (one compute_kzg_proof per cell) in both packages."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, G1_GEN, G2_GEN, pt_mul

    n, cols, tau = 16, 8, 0x1234567
    roots = port_kzg._bit_reverse_permute([pow(port_kzg._root_of_unity(n), i, R) for i in range(n)])
    lag = [w * (pow(tau, n, R) - 1) * pow(n * (tau - w), R - 2, R) % R for w in roots]
    g1, g2 = [pt_mul(FQ, G1_GEN, v) for v in lag], [G2_GEN, pt_mul(FQ2, G2_GEN, tau)]
    blob = _blob(13)[: 32 * n]
    out = [
        m.compute_cells_and_proofs(blob, k.Kzg(k.TrustedSetup(g1, g2, n), device=False), cols)
        for m, k in ((jax_das, jax_kzg), (port_das, port_kzg))
    ]
    assert out[0] == out[1]
    cells, proofs, commitment = out[1]
    items = [(commitment, j, cells[j], proofs[j]) for j in range(cols)]
    assert port_das.verify_cell_kzg_proof_batch(items, port_kzg.Kzg(port_kzg.TrustedSetup(g1, g2, n), device=False))


def test_batched_cell_verdicts_equal_with_a_tamper(sides):
    def verdicts(s):
        items = [it for sc in s.sidecars[:4] for it in s.das.sidecar_cells(sc)]
        bad = list(items)
        c, j, cell, proof = bad[3]
        bad[3] = (c, j, cell, bad[4][3])
        return (
            s.das.verify_cell_kzg_proof_batch(items, s.kzg),
            s.das.verify_cell_kzg_proof_batch(bad, s.kzg),
            [s.das.verify_cell_kzg_proof(*it, s.kzg) for it in bad[2:6]],
        )

    assert _both(sides, verdicts) == (True, False, [True, False, True, True])


def test_custody_and_sampling_equal(sides):
    def picks(s):
        eng = s.das.SamplingEngine(b"\x07" * 32, s.E)
        return (
            s.das.custody_columns(b"\x01" * 32, s.E.CUSTODY_REQUIREMENT, COLS),
            [s.das.column_subnet(j, s.E) for j in range(COLS)],
            eng.custody,
            eng.select_samples(s.root),
            eng.sample(s.root, have=set(), fetch=lambda col: None if col % 3 == 0 else col)[0],
        )

    _both(sides, picks)


def _checker(s, custody=None, kzg="engine"):
    return s.da.DataAvailabilityChecker(s.kzg if kzg == "engine" else kzg, s.E, custody=custody)


def _routes(s):
    """The DA checker's routes on one side; returns what each decided."""
    out = {}
    chk = _checker(s)
    out["full_pending"] = chk.put_block(s.root, s.signed, slot=5).available
    full = chk.put_columns(s.root, list(s.sidecars), slot=5)
    out["full"] = (full.available, _ser(full.columns))
    chk.pop(s.root)
    out["popped"] = chk.has_pending(s.root)

    chk = _checker(s)
    chk.put_block(s.root, s.signed, slot=5)
    keep = random.Random(31).sample(range(COLS), HALF)
    rec = chk.put_columns(s.root, [s.sidecars[c] for c in keep], slot=5)
    out["reconstruction"] = (rec.available, _ser(rec.columns))

    custody = s.das.custody_columns(b"\x09" * 32, s.E.CUSTODY_REQUIREMENT, COLS)
    chk = _checker(s, custody=custody)
    chk.put_block(s.root, s.signed, slot=5)
    staged = chk.put_columns(s.root, [s.sidecars[c] for c in custody], slot=5).available
    pending = chk.sampling_pending(s.root)
    sampled = chk.set_sampling_result(s.root, True, slot=5)
    out["custody_sampling"] = (staged, pending, sampled.available, _ser(sampled.columns), chk.sampling_pending(s.root))

    chk = _checker(s)
    chk.put_block(s.root, s.signed, slot=5)
    below = chk.put_columns(s.root, s.sidecars[: HALF - 1], slot=5).available
    out["sub_threshold"] = (below, chk.set_sampling_result(s.root, True, slot=5).available)
    return out


def test_da_checker_column_routes_equal(sides):
    out = _both(sides, _routes)
    assert out["full"][0] and out["reconstruction"][0] and out["custody_sampling"][2]
    assert out["reconstruction"][1] == _ser(sides[1].sidecars)
    assert out["sub_threshold"] == (False, False)


def _blob_sidecars(s, kzg):
    commitments = [bytes(c) for c in s.signed.message.body.blob_kzg_commitments]
    return [
        SimpleNamespace(index=i, blob=b, kzg_commitment=c, kzg_proof=kzg.compute_blob_kzg_proof(b, c))
        for i, (b, c) in enumerate(zip(BLOBS, commitments))
    ]


def _taxonomy(s):
    """The blob route and each error class, as the class names raised."""
    scs = _blob_sidecars(s, s.kzg)
    out = {}
    chk = _checker(s)
    chk.put_block(s.root, s.signed, slot=5)
    got = chk.put_blobs(s.root, scs, slot=5)
    out["blob_route"] = (got.available, [bytes(b.kzg_proof) for b in got.blobs])

    def raised(fn):
        try:
            fn()
        except s.da.AvailabilityCheckError as e:
            return type(e).__name__
        return None

    bad = [SimpleNamespace(**vars(sc)) for sc in scs]
    bad[1].kzg_proof = scs[0].kzg_proof
    out["bad_proof"] = raised(lambda: _checker(s).put_blobs(s.root, bad, slot=5))
    out["no_engine"] = raised(lambda: _checker(s, kzg=None).put_blobs(s.root, scs, slot=5))
    out["wrong_header"] = raised(lambda: _checker(s).put_columns(b"\x00" * 32, s.sidecars[:1], slot=5))
    oob = SimpleNamespace(**vars(scs[0]))
    oob.index = s.E.MAX_BLOBS_PER_BLOCK
    out["index_out_of_range"] = raised(lambda: _checker(s).put_blobs(s.root, [oob], slot=5))
    # a commitment that does not match the block, freshly delivered
    other = SimpleNamespace(**vars(scs[1]))
    other.index = 0
    chk = _checker(s)
    chk.put_block(s.root, s.signed, slot=5)
    out["mismatch"] = raised(lambda: chk.put_blobs(s.root, [other], slot=5))
    out["classes"] = [
        issubclass(s.da.MissingComponentsError, s.da.AvailabilityCheckError),
        issubclass(s.da.InvalidComponentsError, s.da.AvailabilityCheckError),
        issubclass(s.da.AvailabilityCheckError, ValueError),
    ]
    return out


def test_blob_route_and_taxonomy_equal(sides):
    out = _both(sides, _taxonomy)
    assert out["blob_route"][0] is True
    assert out["bad_proof"] == out["wrong_header"] == out["index_out_of_range"] == out["mismatch"] == "InvalidComponentsError"
    assert out["no_engine"] == "MissingComponentsError"
    assert out["classes"] == [True, True, True]


def test_blob_route_on_the_cpu_device_engine(sides):
    """The port's blob route with the CPU device engine (the K8, K9 and K4
    plain versions): available, with proofs byte-equal to the JAX host
    engine's; a swapped proof refused as InvalidComponentsError."""
    jax_side, s = sides
    prev_dev, prev_threads = default_device(), torch.get_num_threads()
    set_default_device("cpu")
    torch.set_num_threads(1)
    try:
        dev = port_kzg.Kzg(port_kzg.TrustedSetup.insecure_dev(FE))
        scs = _blob_sidecars(jax_side, jax_side.kzg)
        assert bytes(scs[0].kzg_proof) == dev.compute_blob_kzg_proof(BLOBS[0], bytes(scs[0].kzg_commitment))
        chk = port_da.DataAvailabilityChecker(dev, s.E)
        chk.put_block(s.root, s.signed, slot=5)
        assert chk.put_blobs(s.root, scs, slot=5).available is True
        bad = [SimpleNamespace(**vars(sc)) for sc in scs]
        bad[0].kzg_proof, bad[1].kzg_proof = scs[1].kzg_proof, scs[0].kzg_proof
        with pytest.raises(port_da.InvalidComponentsError):
            port_da.DataAvailabilityChecker(dev, s.E).put_blobs(s.root, bad, slot=5)
    finally:
        torch.set_num_threads(prev_threads)
        set_default_device(prev_dev)


def _watermark(s):
    chk = _checker(s)
    chk.prune_before(100)
    out = [
        chk.put_block(s.root, s.signed, slot=200).available,
        chk.has_pending(s.root),
        chk.put_columns(s.root, s.sidecars[:2], slot=200).available,
        chk.has_pending(s.root),
        chk.set_sampling_result(b"\x42" * 32, True, slot=200).available,
        chk.has_pending(b"\x42" * 32),
    ]
    chk = _checker(s)
    chk.put_block(s.root, s.signed, slot=50)
    other = b"\x33" * 32
    chk._pending[other] = type(chk._pending[s.root])()
    chk._pending[other].inserted_at_slot = 3
    chk.prune_before(4)
    out += [chk.has_pending(s.root), chk.has_pending(other)]
    chk.prune_before(6)
    out += [chk.has_pending(s.root), chk.pending_roots()]
    return out


def test_finality_watermark_and_prune_equal(sides):
    assert _both(sides, _watermark) == [False, False, False, False, False, False, True, False, False, []]


def test_reconstruction_counted_in_the_port_metrics(sides):
    s = sides[1]
    counter = PORT_REGISTRY.counter("das_reconstructions_total")
    before = counter.value()
    s.das.recover_matrix([s.sidecars[c] for c in range(HALF, COLS)], s.E)
    assert counter.value() == before + 1
