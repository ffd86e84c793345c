"""The port's fixed-base MSM (ops/msm.py, K9: `g1_msm_table`, the table
T[w][i] = 2^(8w) * P_i, and `g1_msm_fixed`, one set of 255 buckets over
every table entry) against the JAX package's host MSMs (crypto/kzg
`_g1_msm`, crypto/bls12_381 `msm`) and host scalar multiplication; its
Pippenger kernel `g1_msm_pippenger` in a `slow` test (its CPU compile
did not finish in 15 minutes, as tests/test_device_kzg.py marks its own).
Inputs come from a numpy seed; the port runs the kernels' plain PyTorch
versions on the CPU device. Tolerance: exact equality of affine field
integers (the packages add in different orders, so Jacobian coordinates
differ) and of the port's own limbs where the arithmetic is the same.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bls_g1_points, kzg_blobs, msm_edge_case
from lighthouse_tpu.crypto import kzg as JK
from lighthouse_tpu.crypto.bls12_381 import FQ as JFQ
from lighthouse_tpu.crypto.bls12_381 import msm as jax_host_msm
from lighthouse_tpu.crypto.bls12_381 import to_affine as jax_to_affine
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto import kzg as PK
from lighthouse_tpu_torch.crypto.bls12_381 import FQ, pt_double, pt_mul, to_affine
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import fr as K8
from lighthouse_tpu_torch.ops import msm as K9

R = PK.FR_MODULUS


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    """Plain versions on the CPU device, on one intra-op thread (several
    test workers share the cores)."""
    prev_dev, prev_threads = default_device(), torch.get_num_threads()
    set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev_threads)
    set_default_device(prev_dev)


def _affine(limbs: torch.Tensor):
    return to_affine(FQ, K2.g1_from_limbs(limbs.numpy()[None])[0])


def _points(rng, n: int) -> list:
    """Seeded points with Z != 1, an infinity among them past n = 4."""
    pts = bls_g1_points(rng, n)
    if n > 4:
        pts[4] = (1, 1, 0)
    return pts


@pytest.mark.parametrize("n, seed", [(1, 1), (5, 2), (12, 3)])
def test_plain_table_entries_equal_host_multiples(n, seed):
    """Every entry T[w][i] equals the host's 2^(8w) * P_i in affine
    coordinates, and is flagged (limbs 0) where it is the infinity."""
    pts = _points(np.random.default_rng(seed), n)
    table = K9.g1_msm_table(torch.from_numpy(K2.g1_to_limbs(pts)))
    assert tuple(table.xy.shape) == (K9.WINDOWS, n, 2, 12) and tuple(table.inf.shape) == (K9.WINDOWS, n)
    xy = table.xy.numpy()
    for i, p in enumerate(pts):
        q = p
        for w in range(K9.WINDOWS):
            want = to_affine(FQ, q)
            assert bool(table.inf[w, i]) == (want is None), (w, i)
            got = tuple(K2.fq_from_limbs(xy[w, i]))
            assert got == ((0, 0) if want is None else want), (w, i)
            for _ in range(K9.WINDOW):
                q = pt_double(FQ, q)
    assert to_affine(FQ, pt_mul(FQ, pts[0], 1 << 248)) == tuple(K2.fq_from_limbs(xy[31, 0]))


@pytest.mark.parametrize("n, seed", [(1, 4), (9, 5), (40, 6)])
def test_plain_fixed_msm_matches_jax_host_msms(n, seed):
    """The table, then the fixed-base MSM, over points with msm_edge_case's
    zero scalars, r - 1, a repeated point with its scalar and a point
    beside its negation (and an infinity), equals the JAX package's two
    host MSMs."""
    rng = np.random.default_rng(seed)
    pts, sc = msm_edge_case(rng, _points(rng, n))
    got = _affine(K9.g1_msm(torch.from_numpy(K2.g1_to_limbs(pts)), K8.as_i32(K8.fr_to_words(sc))))
    assert got == jax_to_affine(JFQ, JK._g1_msm(sc, pts))
    assert got == jax_to_affine(JFQ, jax_host_msm(JFQ, pts, sc))


@pytest.mark.parametrize("case", ["all_equal", "zero", "one_hot"])
def test_plain_fixed_msm_on_skewed_scalars(case):
    """Scalars that pile entries into few buckets: all equal (a bucket
    holds whole windows, past the kernel's 16 collected positions), all
    zero (the infinity), and one nonzero scalar."""
    rng = np.random.default_rng(7)
    n = 40
    pts = _points(rng, n)
    sc = {
        "all_equal": [int.from_bytes(rng.bytes(32), "big") % R] * n,
        "zero": [0] * n,
        "one_hot": [0] * 17 + [R - 1] + [0] * (n - 18),
    }[case]
    table = K9.g1_msm_table(torch.from_numpy(K2.g1_to_limbs(pts)))
    got = K9.g1_msm_fixed(table, K8.as_i32(K8.fr_to_words(sc)))
    want = jax_to_affine(JFQ, jax_host_msm(JFQ, pts, sc))
    assert _affine(got) == want
    if case == "zero":
        assert int(got[2].abs().sum()) == 0


def test_kzg_engine_builds_its_table_once():
    """The port's CPU KZG engine builds the setup's fixed-base table at its
    first MSM, keeps it, and its commitments stay byte-equal to the JAX
    host engine's."""
    n = 16
    dev = PK.Kzg(PK.TrustedSetup.insecure_dev(n))
    jax_k = JK.Kzg(JK.TrustedSetup.insecure_dev(n), device=False)
    assert dev._dev._table is None
    blobs = kzg_blobs(np.random.default_rng(8), 2, n)
    first = dev.blob_to_kzg_commitment(blobs[0])
    table = dev._dev._table
    assert isinstance(table, K9.FixedBaseTable) and tuple(table.xy.shape) == (K9.WINDOWS, n, 2, 12)
    assert [first, dev.blob_to_kzg_commitment(blobs[1])] == [jax_k.blob_to_kzg_commitment(b) for b in blobs]
    assert dev._dev._table is table
    plain = K9.g1_msm_table_plain(dev._dev.points)
    assert torch.equal(table.xy, plain.xy) and torch.equal(table.inf, plain.inf)


@pytest.mark.slow
def test_plain_fixed_msm_matches_jax_pippenger():
    """Against the JAX package's Pippenger kernel on its CPU platform."""
    from lighthouse_tpu.ops.bls381 import g1_points_to_device
    from lighthouse_tpu.ops.msm import g1_msm_pippenger

    rng = np.random.default_rng(9)
    pts, sc = msm_edge_case(rng, bls_g1_points(rng, 8))
    got = _affine(K9.g1_msm(torch.from_numpy(K2.g1_to_limbs(pts)), K8.as_i32(K8.fr_to_words(sc))))
    assert got == jax_to_affine(JFQ, g1_msm_pippenger(sc, g1_points_to_device(pts)))
