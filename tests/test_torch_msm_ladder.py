"""The port's ladder MSM (ops/msm.py `g1_msm_ladder`, the K9 ladder: the
256-bit G1 ladder of ops/bls381.py `scalar_mul_wide` and K2's tree sum)
and K11's 64-bit chain (`scalar_mul_wide64`, the same signed-window
chain over 17 windows) against the JAX package's `g1_msm_device` on its
ladder path
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


def test_wide_chain_equals_host_and_jax_ladder():
    """The signed-window chain (`scalar_mul_wide_plain`,
    the kernels' steps) at 8 lanes, chip_smoke.wide_edge_scalars on points
    with Z != 1 (0, 1, r - 1, r - 2, 2^255 mod r and the recodings'
    carries into their top digits), against the host's pt_mul and the
    JAX package's 256-bit ladder (`batch_g1_scalar_mul`, the per-point
    step of its `g1_msm_ladder`), in affine integers (None at infinity)."""
    from chip_smoke import bls_g1_points, wide_edge_scalars
    from lighthouse_tpu.ops.bls381 import batch_g1_scalar_mul, g1_points_from_device, g1_points_to_device, scalars_to_bits

    scalars = wide_edge_scalars()
    pts = bls_g1_points(np.random.default_rng(7), len(scalars))
    got = K2.scalar_mul_wide_plain(torch.from_numpy(K2.g1_to_limbs(pts)), K8.as_i32(K8.fr_to_words(scalars)))
    rows = [to_affine(FQ, row) for row in K2.g1_from_limbs(got.numpy())]
    jax_rows = g1_points_from_device(batch_g1_scalar_mul(*g1_points_to_device(pts), scalars_to_bits(scalars, 256)))
    assert rows == [to_affine(FQ, pt_mul(FQ, p, k)) for p, k in zip(pts, scalars)]
    assert rows == [jax_to_affine(JFQ, row) for row in jax_rows]
    assert rows[1] is None and K2.g1_from_limbs(got[1].numpy())[0] == (1, 1, 0)


# K11's 64-bit chain: the recoding's and the unsigned read's edges
WIDE64_EDGE_SCALARS = [0, 1, 15, 16, 2**63 - 1, 2**63, 2**64 - 1]


def test_wide64_chain_equals_host_and_jax_ladder():
    """K11's 64-bit signed-window chain (`scalar_mul_wide64_plain`, the
    kernel's steps over 17 windows) at 12 lanes: the scalars 0, 1, 15, 16,
    2^63 - 1, 2^63 and 2^64 - 1 (the last two arrive as negative int64)
    and seeded draws, on points with Z != 1 and an infinity input, against
    the host's pt_mul and the JAX package's 64-bit RLC ladder
    (`batch_g1_scalar_mul` over 64 bits, the per-point step of its
    `sharded_rlc_g1_fn`), in affine integers (None at infinity); the
    wrapper on a CPU tensor gives the plain chain's limbs."""
    from chip_smoke import bls_g1_points, bls_scalars
    from lighthouse_tpu.ops.bls381 import batch_g1_scalar_mul, g1_points_from_device, g1_points_to_device, scalars_to_bits
    from lighthouse_tpu_torch.crypto.bls12_381 import inf

    rng = np.random.default_rng(9)
    scalars = WIDE64_EDGE_SCALARS + bls_scalars(rng, 5)
    pts = bls_g1_points(rng, len(scalars))
    pts[8] = inf(FQ)
    p = torch.from_numpy(K2.g1_to_limbs(pts))
    k = K2.scalars_to_tensor(scalars)
    assert bool((k[5:7] < 0).all())
    got = K2.scalar_mul_wide64_plain(p, k)
    assert torch.equal(K2.scalar_mul_wide64(p, k), got)
    rows = [to_affine(FQ, row) for row in K2.g1_from_limbs(got.numpy())]
    jax_rows = g1_points_from_device(batch_g1_scalar_mul(*g1_points_to_device(pts), scalars_to_bits(scalars, 64)))
    assert rows == [to_affine(FQ, pt_mul(FQ, q, s)) for q, s in zip(pts, scalars)]
    assert rows == [jax_to_affine(JFQ, row) for row in jax_rows]
    assert rows[0] is None and rows[8] is None
    assert K2.g1_from_limbs(got[[0, 8]].numpy()) == [(1, 1, 0)] * 2


@pytest.mark.parametrize("case", ["edge", "seeded", "edge64", "seeded64"])
def test_wide_digits_recode_the_scalar(case):
    """The Booth digits of `wide_digits` (the kernel's `wide_digit`):
    signed digits of 4 bits, |d| <= 8, that sum back to the scalar and
    equal the recoding of its integer bit by bit. K9's 256-bit words, 65
    digits: chip_smoke.wide_edge_scalars and 64 seeded scalars below r;
    K11's 64-bit draws as `u64_words` of int64 bit patterns, 17 digits:
    WIDE64_EDGE_SCALARS and 64 seeded draws."""
    from chip_smoke import bls_scalars, fr_scalars, wide_edge_scalars

    rng = np.random.default_rng(8)
    if case.endswith("64"):
        bits = 64
        scalars = WIDE64_EDGE_SCALARS if case == "edge64" else bls_scalars(rng, 64)
        dig = K2.wide_digits(K2.u64_words(K2.scalars_to_tensor(scalars)))
    else:
        bits = 256
        scalars = wide_edge_scalars() if case == "edge" else fr_scalars(rng, 64)
        dig = K2.wide_digits(K8.as_i32(K8.fr_to_words(scalars)))
    w = K2.WIDE_WINDOW
    assert dig.shape == (len(scalars), bits // w + 1)
    assert int(dig.abs().max()) <= 1 << (w - 1)

    def bit(k, j):
        return (k >> j) & 1 if j >= 0 else 0

    for row, k in zip(dig.tolist(), scalars):
        assert sum(d << (i * w) for i, d in enumerate(row)) == k
        assert row == [
            sum(bit(k, i * w + j) << j for j in range(w - 1)) + bit(k, i * w - 1) - (bit(k, i * w + w - 1) << (w - 1))
            for i in range(bits // w + 1)
        ]
