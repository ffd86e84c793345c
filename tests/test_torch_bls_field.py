"""The port's BLS12-381 field, tower and point arithmetic (K2, K3) against
the JAX package: its host oracle (lighthouse_tpu.crypto.bls12_381) and, for
Montgomery multiplication and the G1 Jacobian add, its jitted device
functions (lighthouse_tpu.ops.bls381). Inputs come from a numpy seed; the
port runs its plain PyTorch versions on the CPU. Tolerance: exact equality
of integers (limbs decode to the same field elements, points compare
equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import bls_g1_points, bls_g2_points, bls_scalars
from lighthouse_tpu.crypto.bls12_381 import FQ, FQ2, inf, is_inf, pt_add, pt_eq, pt_mul, pt_neg, to_affine
from lighthouse_tpu.crypto.bls12_381 import fields as HF
from lighthouse_tpu.crypto.bls12_381.fields import P
from lighthouse_tpu.ops import bls381 as jax_bls
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import bls381_tower as K3

R_MOD_P = (1 << 384) % P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions on the CPU: thousands of small integer ops, run on one
    intra-op thread (several test workers share the cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
# the JAX package's carry-cascade regression values (long 0xFF runs) and
# operands whose sums carry through every limb
CASCADE = [((1 << 380) - 1) % P, P - 1, ((255 << 376) + 255) % P, (1 << 381) - P, P // 2 + 1]
EDGE = [0, 1, P - 1, R_MOD_P] + CASCADE


def _ints(rng: np.random.Generator, n: int) -> list[int]:
    return [v % P for v in bls_scalars(rng, n, 384)]


def _t(values) -> torch.Tensor:
    return torch.from_numpy(K2.fq_to_limbs(values))


def _dec(t: torch.Tensor) -> list[int]:
    return K2.fq_from_limbs(t.numpy())


def test_fq_ops_match_oracle():
    rng = np.random.default_rng(1)
    a = EDGE * len(EDGE) + _ints(rng, 40)
    b = [y for y in EDGE for _ in EDGE] + _ints(rng, 40)
    ta, tb = _t(a), _t(b)
    assert _dec(K2.mont_mul(ta, tb)) == [x * y % P for x, y in zip(a, b)]
    assert _dec(K2.mod_add(ta, tb)) == [(x + y) % P for x, y in zip(a, b)]
    assert _dec(K2.mod_sub(ta, tb)) == [(x - y) % P for x, y in zip(a, b)]
    inv_in = EDGE + _ints(rng, 4)
    assert _dec(K2.fq_inv(_t(inv_in))) == [pow(x, P - 2, P) for x in inv_in]


def test_carry_cascade_regression():
    """The JAX package's regression: multiplying long 0xFF runs by 1."""
    got = K2.mont_mul(_t(CASCADE), _t([1] * len(CASCADE)))
    assert _dec(got) == CASCADE


def test_limbs_from_jax_is_the_ports_encoding():
    rng = np.random.default_rng(2)
    vals = EDGE + _ints(rng, 16)
    jax_limbs = jax_bls.fq_to_device(vals)
    port = K2.limbs_from_jax(jax_limbs)
    assert np.array_equal(port, K2.fq_to_limbs(vals))
    assert np.array_equal(K2.limbs_to_jax(port), jax_limbs)
    assert K2.fq_from_limbs(port) == vals


def test_mont_mul_matches_jax():
    rng = np.random.default_rng(3)
    a, b = EDGE[:6] + _ints(rng, 2), CASCADE[:4] + _ints(rng, 4)
    ja, jb = jax_bls.fq_to_device(a), jax_bls.fq_to_device(b)
    want = np.asarray(jax_bls.mont_mul(jnp.asarray(ja), jnp.asarray(jb)))
    got = K2.mont_mul(torch.from_numpy(K2.limbs_from_jax(ja)), torch.from_numpy(K2.limbs_from_jax(jb)))
    assert np.array_equal(got.numpy(), K2.limbs_from_jax(want))


def test_g1_pt_add_matches_jax():
    """Jacobian G1 add, lane for lane with the JAX function: a general sum,
    a doubling (P == P), an infinity operand, and P + (-P) (both give Z = 0;
    the port's infinity is the canonical (1, 1, 0))."""
    rng = np.random.default_rng(4)
    p1, p2 = bls_g1_points(rng, 2)
    lhs = [p1, p2, inf(FQ), p1]
    rhs = [p2, p2, p1, pt_neg(FQ, p1)]
    jl, jr = jax_bls.g1_points_to_device(lhs), jax_bls.g1_points_to_device(rhs)
    want = np.stack([K2.limbs_from_jax(np.asarray(c)) for c in jax_bls.pt_add(jax_bls.DevFq, jl, jr)], 1)
    got = K2.pack32(
        K2.pt_add(K2.Fq1, K2.unpack16(torch.from_numpy(K2.g1_to_limbs(lhs)), 1), K2.unpack16(torch.from_numpy(K2.g1_to_limbs(rhs)), 1)),
        1,
    ).numpy()
    assert np.array_equal(got[:3], want[:3])
    assert not got[3, 2].any() and not want[3, 2].any()
    assert K2.g1_from_limbs(got[3:]) == [inf(FQ)]


def _f2(vals):
    return torch.from_numpy(K2.fq_to_limbs([v for c in vals for v in c]).reshape(-1, 2, 12))


def _dec2(t):
    v = _dec(t)
    return [(v[i], v[i + 1]) for i in range(0, len(v), 2)]


def _f12(vals):
    flat = [v for f in vals for six in f for c in six for v in c]
    return torch.from_numpy(K2.fq_to_limbs(flat).reshape(-1, 2, 3, 2, 12))


def _dec12(t):
    v = _dec(t)
    out = []
    for i in range(0, len(v), 12):
        w = v[i : i + 12]
        out.append(tuple(tuple((w[6 * a + 2 * c], w[6 * a + 2 * c + 1]) for c in range(3)) for a in range(2)))
    return out


def _rand_f2(rng, n):
    v = _ints(rng, 2 * n)
    return [(v[2 * i], v[2 * i + 1]) for i in range(n)]


def _rand_f12(rng, n):
    return [tuple(tuple(_rand_f2(rng, 3)) for _ in range(2)) for _ in range(n)]


def test_fq2_ops_match_oracle():
    rng = np.random.default_rng(5)
    a = [(0, 0), (1, 0), (0, P - 1), (P - 1, P - 1), (CASCADE[0], CASCADE[2])] + _rand_f2(rng, 5)
    b = [(P - 1, 1), (R_MOD_P, 0), (CASCADE[1], CASCADE[0]), (0, 0), (1, 1)] + _rand_f2(rng, 5)
    ta, tb = _f2(a), _f2(b)
    assert _dec2(K3.f2_mul(ta, tb)) == [HF.f2_mul(x, y) for x, y in zip(a, b)]
    assert _dec2(K3.f2_sqr(ta)) == [HF.f2_sqr(x) for x in a]
    assert _dec2(K3.f2_mul_xi(ta)) == [HF.f2_mul_xi(x) for x in a]
    assert _dec2(K3.f2_inv(ta)) == [HF.f2_inv(x) for x in a]


def test_fq12_ops_match_oracle():
    rng = np.random.default_rng(6)
    a, b = _rand_f12(rng, 2), _rand_f12(rng, 2)
    ta, tb = _f12(a), _f12(b)
    assert _dec12(K3.f12_mul(ta, tb)) == [HF.f12_mul(x, y) for x, y in zip(a, b)]
    assert _dec12(K3.f12_sqr(ta)) == [HF.f12_sqr(x) for x in a]
    assert _dec12(K3.f12_inv(ta)) == [HF.f12_inv(x) for x in a]
    assert _dec12(K3.f12_frob(ta)) == [HF.f12_frob(x) for x in a]
    assert _dec12(K3.f12_conj(ta)) == [HF.f12_conj(x) for x in a]
    assert _dec12(K3.f12_frob2(ta)) == [HF.f12_frob_n(x, 2) for x in a]
    # cyclotomic squaring on an element of the cyclotomic subgroup
    t = HF.f12_mul(HF.f12_conj(a[0]), HF.f12_inv(a[0]))
    t = HF.f12_mul(HF.f12_frob_n(t, 2), t)
    assert _dec12(K3.f12_cyclotomic_sqr(_f12([t]))) == [HF.f12_cyclotomic_sqr(t)]
    assert _dec12(K3.f12_pow_bits(_f12([t]), 0xD201)) == [HF.f12_pow(t, 0xD201)]
    # the sparse line product of the Miller loop
    c0, c4, c5 = _rand_f2(rng, 3)
    got = K2.to32(K3.f12_mul_by_045_16(K2.to16(ta[:1]), K2.to16(_f2([c0])[0]), K2.to16(_f2([c4])[0]), K2.to16(_f2([c5])[0])))
    assert _dec12(got) == [HF.f12_mul_by_045(a[0], c0, c4, c5)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_matches_oracle(group):
    rng = np.random.default_rng(7)
    F = FQ if group == "g1" else FQ2
    pts = (bls_g1_points if group == "g1" else bls_g2_points)(rng, 4) + [inf(F)]
    ks = [1, 2**64 - 1, 0] + bls_scalars(rng, 2)
    to_limbs = K2.g1_to_limbs if group == "g1" else K2.g2_to_limbs
    from_limbs = K2.g1_from_limbs if group == "g1" else K2.g2_from_limbs
    got = K2.scalar_mul(group, torch.from_numpy(to_limbs(pts)), K2.scalars_to_tensor(ks))
    for g, p, k in zip(from_limbs(got.numpy()), pts, ks):
        assert pt_eq(F, g, pt_mul(F, p, k))
    assert is_inf(F, from_limbs(got.numpy())[2])


@pytest.mark.parametrize("affine", [False, True])
def test_g2_ladder_edge_scalars_match_oracle(affine):
    """The G2 ladder's plain version (whose coordinates its warp-team kernel
    equals limb for limb) at the edge scalars 0, 1, 2, 2^63 and 2^64 - 1,
    on Jacobian points with Z != 1 and on the same points with Z = 1 (the
    kernel's mixed addition), against the host oracle's pt_mul, as affine
    points."""
    rng = np.random.default_rng(9)
    pts = bls_g2_points(rng, 5)
    if affine:
        pts = [(*to_affine(FQ2, p), FQ2.one) for p in pts]
    assert all((p[2] == FQ2.one) == affine for p in pts)
    ks = [0, 1, 2, 2**63, 2**64 - 1]
    got = K2.g2_from_limbs(K2.scalar_mul("g2", torch.from_numpy(K2.g2_to_limbs(pts)), K2.scalars_to_tensor(ks)).numpy())
    for g, p, k in zip(got, pts, ks):
        want = pt_mul(FQ2, p, k)
        assert to_affine(FQ2, g) == to_affine(FQ2, want)
        assert is_inf(FQ2, g) == (k == 0)


@pytest.mark.parametrize("affine", [False, True])
def test_g1_ladder_edge_scalars_match_oracle(affine):
    """The G1 ladder's plain version (whose coordinates its warp-team kernel
    equals limb for limb) at the edge scalars 0, 1, 2, 2^63 and 2^64 - 1,
    on Jacobian points with Z != 1 and on the same points with Z = 1, and
    on an infinity input, against the host oracle's pt_mul, as affine
    points."""
    rng = np.random.default_rng(10)
    pts = bls_g1_points(rng, 5)
    if affine:
        pts = [(*to_affine(FQ, p), FQ.one) for p in pts]
    assert all((p[2] == FQ.one) == affine for p in pts)
    pts.append(inf(FQ))
    ks = [0, 1, 2, 2**63, 2**64 - 1, 2**64 - 1]
    got = K2.g1_from_limbs(K2.scalar_mul("g1", torch.from_numpy(K2.g1_to_limbs(pts)), K2.scalars_to_tensor(ks)).numpy())
    for g, p, k in zip(got, pts, ks):
        want = pt_mul(FQ, p, k)
        assert to_affine(FQ, g) == to_affine(FQ, want)
        assert is_inf(FQ, g) == (k == 0 or is_inf(FQ, p))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_segment_sum_and_affine_match_oracle(group):
    """Rows with a repeated point, a point and its negation, and infinity
    in a row."""
    rng = np.random.default_rng(8)
    F = FQ if group == "g1" else FQ2
    p = (bls_g1_points if group == "g1" else bls_g2_points)(rng, 5)
    rows = [
        [p[0], p[0], p[0], p[1]],
        [p[2], pt_neg(F, p[2]), inf(F), p[3]],
        [p[4], inf(F), inf(F), inf(F)],
        [inf(F)] * 4,
    ]
    to_limbs = K2.g1_to_limbs if group == "g1" else K2.g2_to_limbs
    from_limbs = K2.g1_from_limbs if group == "g1" else K2.g2_from_limbs
    grid = torch.from_numpy(to_limbs([q for r in rows for q in r]))
    grid = grid.reshape(4, 4, *grid.shape[1:]).contiguous()
    sums = K2.segment_sum(group, grid)
    want = []
    for r in rows:
        acc = inf(F)
        for q in r:
            acc = pt_add(F, acc, q)
        want.append(acc)
    got = from_limbs(sums.numpy())
    assert all(pt_eq(F, g, w) for g, w in zip(got, want))
    aff = K2.to_affine(group, sums).numpy()
    affine = [to_affine(F, w) for w in want]
    for row, w in zip(aff, affine):
        v = K2.fq_from_limbs(row)
        if w is None:
            assert not row.any()
        elif group == "g1":
            assert tuple(v) == w
        else:
            assert ((v[0], v[1]), (v[2], v[3])) == w
