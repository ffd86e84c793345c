"""The port's ladder MSM (ops/msm.py `g1_msm_ladder`, the K9 ladder: the
256-bit G1 ladder of ops/bls381.py `scalar_mul_wide` and K2's tree sum)
against the JAX package's `g1_msm_device` on its ladder path
(LIGHTHOUSE_TPU_MSM=ladder, as tests/test_device_kzg.py runs it), the
port's Pippenger and the host bigint oracle. The port runs the kernels'
plain PyTorch versions on the CPU. Tolerance: exact equality of affine
field integers (the two packages' trees add in different orders, so
Jacobian coordinates may differ) and of the port's own limbs where the
arithmetic is the same.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls12_381 import FQ as JFQ
from lighthouse_tpu.crypto.bls12_381 import to_affine as jax_to_affine
from lighthouse_tpu.crypto.kzg import TrustedSetup as JaxSetup
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto.bls12_381 import FQ, pt_mul, to_affine
from lighthouse_tpu_torch.crypto.kzg import FR_MODULUS, TrustedSetup
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import fr as K8
from lighthouse_tpu_torch.ops import msm as K9

R = FR_MODULUS


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    prev_dev, prev_threads = default_device(), torch.get_num_threads()
    set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev_threads)
    set_default_device(prev_dev)


def _affine(limbs: torch.Tensor):
    return to_affine(FQ, K2.g1_from_limbs(limbs.numpy())[0])


def test_ladder_msm_equals_jax_ladder_and_pippenger(monkeypatch):
    from lighthouse_tpu.ops.bls381 import g1_points_to_device
    from lighthouse_tpu.ops.msm import g1_msm_device

    setup = TrustedSetup.insecure_dev(16)
    pts = setup.g1_lagrange[:8]
    rng = np.random.default_rng(5)
    scalars = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(8)]
    scalars[3] = 0  # a zero lane must not poison the sum

    monkeypatch.setenv("LIGHTHOUSE_TPU_MSM", "ladder")
    jax_pts = JaxSetup.insecure_dev(16).g1_lagrange[:8]
    want = jax_to_affine(JFQ, g1_msm_device(scalars, g1_points_to_device(jax_pts)))

    pts_t = torch.from_numpy(K2.g1_to_limbs(pts))
    sc_t = K8.as_i32(K8.fr_to_words(scalars))
    got = K9.g1_msm_ladder(pts_t, sc_t)
    assert _affine(got) == want
    assert _affine(K9.g1_msm(pts_t, sc_t)) == want


def test_wide_ladder_edge_scalars_equal_host():
    """[k]P per lane for k = 0, 1, r - 1, r - 2, 2^255 mod r and seeded
    values, on points with Z != 1, against the host's pt_mul."""
    from chip_smoke import bls_g1_points

    rng = np.random.default_rng(6)
    scalars = [0, 1, R - 1, R - 2, (1 << 255) % R] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(3)]
    pts = bls_g1_points(rng, len(scalars))
    got = K2.scalar_mul_wide(torch.from_numpy(K2.g1_to_limbs(pts)), K8.as_i32(K8.fr_to_words(scalars)))
    for row, p, k in zip(got, pts, scalars):
        assert _affine(row) == to_affine(FQ, pt_mul(FQ, p, k)), k
