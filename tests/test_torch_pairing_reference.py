"""The port's slow pairing oracle (`crypto/bls12_381/pairing_reference.py`)
held to the JAX package's, and the port's fast pairing held to both, on
seeded points: Miller loops, final exponentiations, pairings (infinity
included), multi-pairings and pairing checks."""

import importlib
import random

import pytest

from lighthouse_tpu.crypto.bls12_381 import pairing_reference as j_ref
from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, G1_GEN, G2_GEN, R, inf, pt_mul, pt_neg, to_affine
from lighthouse_tpu_torch.crypto.bls12_381 import fields as F
from lighthouse_tpu_torch.crypto.bls12_381 import pairing_reference as p_ref

p_fast = importlib.import_module("lighthouse_tpu_torch.crypto.bls12_381.pairing")

SEEDS = [0, 1, 2]


def _points(seed):
    rng = random.Random(seed)
    return pt_mul(FQ, G1_GEN, rng.randrange(1, R)), pt_mul(FQ2, G2_GEN, rng.randrange(1, R))


@pytest.mark.parametrize("seed", SEEDS)
def test_miller_loop_equal(seed):
    p, q = _points(seed)
    # the oracle's loop runs on the untwisted Q and the embedded P
    q12, p12 = p_ref.untwist(to_affine(FQ2, q)), p_ref.embed_g1(to_affine(FQ, p))
    got = p_ref.miller_loop(q12, p12)
    assert got == j_ref.miller_loop(q12, p12)
    assert p_ref.final_exponentiation(got) == p_fast.pairing(p, q)


@pytest.mark.parametrize("seed", SEEDS)
def test_final_exponentiation_equal_and_the_fast_one_with_them(seed):
    p, q = _points(seed)
    m = p_fast.miller_loop(to_affine(FQ2, q), to_affine(FQ, p))
    want = j_ref.final_exponentiation(m)
    assert p_ref.final_exponentiation(m) == want
    assert p_fast.final_exponentiation(m) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_pairing_equal_and_the_fast_one_with_them(seed):
    p, q = _points(seed)
    want = j_ref.pairing(p, q)
    assert p_ref.pairing(p, q) == want
    assert p_fast.pairing(p, q) == want


def test_pairing_at_infinity():
    for p, q in ((inf(FQ), G2_GEN), (G1_GEN, inf(FQ2))):
        assert p_ref.pairing(p, q) == j_ref.pairing(p, q) == p_fast.pairing(p, q) == F.F12_ONE


def test_untwist_and_embed_equal():
    p, q = _points(3)
    assert p_ref.untwist(to_affine(FQ2, q)) == j_ref.untwist(to_affine(FQ2, q))
    assert p_ref.embed_g1(to_affine(FQ, p)) == j_ref.embed_g1(to_affine(FQ, p))


def test_bilinearity_under_both_oracles():
    rng = random.Random(4)
    a, b = rng.randrange(2, 2**32), rng.randrange(2, 2**32)
    lhs = (pt_mul(FQ, G1_GEN, a), pt_mul(FQ2, G2_GEN, b))
    rhs = (pt_mul(FQ, G1_GEN, a * b % R), G2_GEN)
    for ref in (p_ref, j_ref):
        assert ref.pairing(*lhs) == ref.pairing(*rhs)


def test_multi_pairing_and_checks_equal():
    rng = random.Random(5)
    pairs = [_points(6), (G1_GEN, G2_GEN)]
    want = j_ref.multi_pairing(pairs)
    assert p_ref.multi_pairing(pairs) == want == p_fast.multi_pairing(pairs)
    a = rng.randrange(2, 2**32)
    good = [(pt_mul(FQ, G1_GEN, a), G2_GEN), (pt_neg(FQ, G1_GEN), pt_mul(FQ2, G2_GEN, a))]
    bad = [(pt_mul(FQ, G1_GEN, a + 1), G2_GEN), good[1]]
    assert p_ref.pairing_check(good) and j_ref.pairing_check(good) and p_fast.pairing_check(good)
    assert not p_ref.pairing_check(bad) and not j_ref.pairing_check(bad) and not p_fast.pairing_check(bad)
