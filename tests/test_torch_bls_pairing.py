"""The port's pairing, subgroup check, cofactor clearing (K4) and hash-to-G2
(K5) against the JAX package's host oracle (lighthouse_tpu.crypto.bls12_381).
Inputs come from a numpy seed; the port runs its plain PyTorch versions on
the CPU. Tolerance: exact equality (Fq12 values, points, compressed bytes,
verdicts).
"""

import importlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    bls_g1_points,
    bls_g2_points,
    bls_twist_point_of_order,
    bls_twist_point_outside_subgroup,
    htc_edge_field_elements,
    htc_gx1_is_square,
)
from lighthouse_tpu.crypto.bls12_381 import (
    FQ,
    FQ2,
    G1_GEN,
    g2_clear_cofactor,
    g2_in_subgroup,
    g2_to_bytes,
    hash_to_g2,
    pt_mul,
    pt_neg,
    to_affine,
)
from lighthouse_tpu.crypto.bls12_381 import fields as HF
from lighthouse_tpu.crypto.bls12_381.fields import R
from lighthouse_tpu.crypto.bls12_381.curve import from_affine
from lighthouse_tpu.crypto.bls12_381.curve import pt_add as host_pt_add
from lighthouse_tpu.crypto.bls12_381.hash_to_curve import (
    DST_G2_POP,
    _isogeny_to_e2,
    hash_to_field_fq2,
    map_to_curve_sswu,
)
from lighthouse_tpu_torch.crypto.bls12_381 import g2_affine_to_bytes
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import bls381_htc as K5
from lighthouse_tpu_torch.ops import bls381_pairing as K4

host_pairing = importlib.import_module("lighthouse_tpu.crypto.bls12_381.pairing")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions on the CPU: thousands of small integer ops, run on one
    intra-op thread (several test workers share the cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _g1_aff(points) -> torch.Tensor:
    return torch.from_numpy(K2.fq_to_limbs([v for p in points for v in to_affine(FQ, p)]).reshape(-1, 2, 12))


def _g2_aff(affs) -> torch.Tensor:
    return torch.from_numpy(K2.fq_to_limbs([v for a in affs for c in a for v in c]).reshape(-1, 2, 2, 12))


def _dec12(t) -> list:
    v = K2.fq_from_limbs(t.numpy())
    out = []
    for i in range(0, len(v), 12):
        w = v[i : i + 12]
        out.append(tuple(tuple((w[6 * a + 2 * c], w[6 * a + 2 * c + 1]) for c in range(3)) for a in range(2)))
    return out


def test_miller_loop_and_pairing_equal_the_oracle():
    """The Miller loop is the oracle's, so even its Fq12 output is equal.

    GT convention: the port's final exponentiation is the standard one,
    f^((p^12 - 1)/r), so its pairing value equals the host oracle's
    `pairing` exactly. The JAX device kernel (final_exp_cubed) returns the
    cube of that value; both conventions give the same answer to every
    `== 1` check, since gcd(3, r) = 1."""
    rng = np.random.default_rng(21)
    p = bls_g1_points(rng, 2)
    q = bls_g2_points(rng, 2)
    pt, qt = _g1_aff(p), _g2_aff([to_affine(FQ2, x) for x in q])
    ml = _dec12(K4.miller_loop_plain(pt, qt))
    assert ml == [host_pairing.miller_loop(to_affine(FQ2, b), to_affine(FQ, a)) for a, b in zip(p, q)]
    gt = _dec12(K4.pairing_plain(pt, qt))
    want = [host_pairing.pairing(a, b) for a, b in zip(p, q)]
    assert gt == want
    assert all(HF.f12_pow(g, R) == HF.F12_ONE for g in gt)
    cubed = [HF.f12_mul(HF.f12_mul(g, g), g) for g in gt]  # the JAX kernel's value
    assert cubed != gt and all(HF.f12_is_one(c) == HF.f12_is_one(g) for c, g in zip(cubed, gt))


def test_multi_pairing_check_true_and_false():
    """e(aG1, Q) e(bG1, Q) e(-(a+b)G1, Q) == 1; with b changed it is not;
    an infinity pair contributes 1."""
    rng = np.random.default_rng(22)
    (q,) = bls_g2_points(rng, 1)
    qa = to_affine(FQ2, q)
    a, b = 1234567, 7654321
    good = [pt_mul(FQ, G1_GEN, a), pt_mul(FQ, G1_GEN, b), pt_neg(FQ, pt_mul(FQ, G1_GEN, a + b))]
    qt = _g2_aff([qa] * 3)
    no = torch.zeros(3, dtype=torch.bool)
    assert K4.multi_pairing_check(_g1_aff(good), no, qt, no)
    bad = good[:1] + [pt_mul(FQ, G1_GEN, b + 1)] + good[2:]
    f_bad = K4.multi_pairing(_g1_aff(bad), no, qt, no)
    assert not bool(K4.f12_is_one(f_bad))
    assert _dec12(f_bad.unsqueeze(0)) == [host_pairing.multi_pairing(list(zip(bad, [q] * 3)))]
    # pair 1 masked out: e(aG1, Q) e(-(a+b)G1, Q) != 1, but masking pair 1 of
    # [aG1, X, -aG1] gives 1 whatever X is
    masked = [good[0], bad[1], pt_neg(FQ, good[0])]
    assert K4.multi_pairing_check(_g1_aff(masked), torch.tensor([False, True, False]), qt, no)


def test_g2_subgroup_check():
    """Points of G2, twist points outside it, twist points of order 13 and
    23 (the |x|-ladder meets infinity on them) and a q_inf lane, against
    the host oracle's g2_in_subgroup."""
    rng = np.random.default_rng(23)
    inside = [to_affine(FQ2, x) for x in bls_g2_points(rng, 2)]
    outside = [bls_twist_point_outside_subgroup(rng) for _ in range(2)]
    small = [bls_twist_point_of_order(rng, 13), bls_twist_point_of_order(rng, 23)]
    pts = inside + outside + [inside[0]] + small
    q = _g2_aff(pts)
    q_inf = torch.tensor([False, False, False, False, True, False, False])
    got = K4.g2_subgroup_check(q, q_inf).tolist()
    assert got == [True, True, False, False, True, False, False]
    assert got == [bool(i) or g2_in_subgroup(from_affine(FQ2, a)) for a, i in zip(pts, q_inf.tolist())]


def test_g2_clear_cofactor_matches_oracle():
    rng = np.random.default_rng(24)
    x, y = bls_twist_point_outside_subgroup(rng)
    pt = (x, y, HF.F2_ONE)
    got = K4.g2_clear_cofactor_plain(torch.from_numpy(K2.g2_to_limbs([pt])))
    got_aff = to_affine(FQ2, K2.g2_from_limbs(got.numpy())[0])
    assert got_aff == to_affine(FQ2, g2_clear_cofactor(pt))


def test_hash_to_g2_matches_oracle():
    msgs = [b"abc", bytes(np.random.default_rng(25).integers(0, 256, 32, dtype=np.uint8))]
    u = K5.messages_to_field(msgs)
    want_u = [hash_to_field_fq2(m, 2, DST_G2_POP) for m in msgs]
    assert K2.fq_from_limbs(u) == [v for pair in want_u for f in pair for v in f]
    got = K5.hash_to_g2(torch.from_numpy(u))
    aff = K2.to_affine("g2", got).numpy()
    for row, m in zip(aff, msgs):
        v = K2.fq_from_limbs(row)
        assert g2_affine_to_bytes(((v[0], v[1]), (v[2], v[3]))) == g2_to_bytes(hash_to_g2(m))


def _affine_pairs(jac16) -> list:
    """Plain-version Jacobian Fq2 coordinates (16-bit limbs) -> affine
    ((x0, x1), (y0, y1)) ints."""
    aff = K2.to_affine("g2", K2.pack32(jac16, 2)).numpy()
    return [((v[0], v[1]), (v[2], v[3])) for v in (K2.fq_from_limbs(row) for row in aff)]


def test_hash_to_g2_edge_lanes_match_oracle():
    """K5's plain version (inversion-free maps, the sum on E', one
    projective isogeny) on field elements with u0 = u1 = 0 (RFC 9380's
    tv2 = 0 exception), u whose g(x1) is not a square, and u1 = u0 (the
    sum on E' doubles): each map equal
    to the host oracle's map_to_curve_sswu, its isogeny image to
    _isogeny_to_e2, and H(m) as affine bytes to the oracle's isogenies,
    sum and cofactor clearing."""
    u, lanes = htc_edge_field_elements(np.random.default_rng(26), 4)
    vals = K2.fq_from_limbs(u)
    us = [(vals[2 * i], vals[2 * i + 1]) for i in range(len(vals) // 2)]  # u0, u1 of message 0, then 1, ...
    assert us[0] == us[1] == (0, 0) and not htc_gx1_is_square(us[2])
    assert any(htc_gx1_is_square(x) for x in us) and lanes["non_square"]
    flat = K2.to16(torch.from_numpy(u).reshape(-1, 2, 12))
    maps = K5.map_to_curve_sswu16(flat)
    want_maps = [map_to_curve_sswu(x) for x in us]
    assert _affine_pairs(maps) == want_maps
    assert _affine_pairs(K5.isogeny_to_e2_16(*maps)) == [_isogeny_to_e2(*p) for p in want_maps]
    got = _affine_pairs(K5.hash_to_g2_16(K2.to16(torch.from_numpy(u))))
    for i, (x, y) in enumerate(got):
        q0, q1 = (from_affine(FQ2, _isogeny_to_e2(*want_maps[2 * i + j])) for j in range(2))
        assert g2_affine_to_bytes((x, y)) == g2_to_bytes(g2_clear_cofactor(host_pt_add(FQ2, q0, q1)))


@pytest.mark.slow
def test_hash_to_g2_plain_matches_jax_device():
    """K5's plain version against the JAX package's hash_to_g2_device as
    affine bytes, on the edge lanes above (XLA's CPU compile of the JAX
    kernel takes minutes, as in tests/test_device_pairing.py)."""
    import jax.numpy as jnp

    from lighthouse_tpu.ops import bls381_htc as jax_htc
    from lighthouse_tpu.ops.bls381 import g2_points_from_device

    u, _ = htc_edge_field_elements(np.random.default_rng(27), 3)
    want = g2_points_from_device(jax_htc.hash_to_g2_device(jnp.asarray(K2.limbs_to_jax(u))))
    got = _affine_pairs(K5.hash_to_g2_16(K2.to16(torch.from_numpy(u))))
    assert [g2_affine_to_bytes(g) for g in got] == [g2_to_bytes(w) for w in want]
