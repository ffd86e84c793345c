"""``verify_blob_kzg_proof`` of the Deneb specs (polynomial-commitments.md)
in pure Python: the Fiat-Shamir challenge, the barycentric evaluation over
the bit-reversed roots of unity, and the pairing check against the trusted
setup's [tau]G2. Points go through the benchmark's frozen BLS12-381."""

from __future__ import annotations

import hashlib
import json

from .bls12_381.curve import FQ, FQ2, G1_GEN, G2_GEN, g1_from_bytes, g1_in_subgroup, g2_from_bytes, pt_add, pt_mul, pt_neg
from .bls12_381.fields import R
from .bls12_381.pairing import pairing_check

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
PRIMITIVE_ROOT_OF_UNITY = 7


def bit_reversal_permutation(xs: list) -> list:
    n = len(xs)
    bits = n.bit_length() - 1
    return [xs[int(format(i, f"0{bits}b")[::-1], 2)] for i in range(n)]


class Verifier:
    """The specs' blob proof verification over an n-point domain."""

    def __init__(self, setup_path: str, n: int = 4096):
        with open(setup_path) as f:
            data = json.load(f)
        self.n = n
        self.tau_g2 = g2_from_bytes(bytes.fromhex(data["g2_monomial"][1].removeprefix("0x")))
        w = pow(PRIMITIVE_ROOT_OF_UNITY, (R - 1) // n, R)
        self.roots = bit_reversal_permutation([pow(w, i, R) for i in range(n)])
        self.inv_width = pow(n, R - 2, R)

    def challenge(self, blob: bytes, commitment: bytes) -> int:
        data = FIAT_SHAMIR_PROTOCOL_DOMAIN + self.n.to_bytes(16, "big") + blob + commitment
        return int.from_bytes(hashlib.sha256(data).digest(), "big") % R

    def evaluate(self, blob: bytes, z: int) -> int:
        poly = [int.from_bytes(blob[32 * i : 32 * i + 32], "big") for i in range(self.n)]
        if any(p >= R for p in poly):
            raise ValueError("blob element out of range")
        if z in self.roots:
            return poly[self.roots.index(z)]
        dens = [(z - w) % R for w in self.roots]
        prefix, acc = [], 1
        for d in dens:
            acc = acc * d % R
            prefix.append(acc)
        inv = pow(acc, R - 2, R)
        total = 0
        for i in range(self.n - 1, -1, -1):
            inv_d = inv * prefix[i - 1] % R if i else inv
            inv = inv * dens[i] % R
            total += poly[i] * self.roots[i] % R * inv_d
        return total % R * (pow(z, self.n, R) - 1) % R * self.inv_width % R

    def verify(self, blob: bytes, commitment: bytes, proof: bytes) -> bool:
        try:
            c = g1_from_bytes(commitment)
            p = g1_from_bytes(proof)
        except ValueError:
            return False
        if not (g1_in_subgroup(c) and g1_in_subgroup(p)):
            return False
        try:
            z = self.challenge(blob, commitment)
            y = self.evaluate(blob, z)
        except ValueError:
            return False
        c_minus_y = pt_add(FQ, c, pt_neg(FQ, pt_mul(FQ, G1_GEN, y)))
        x_minus_z = pt_add(FQ2, self.tau_g2, pt_neg(FQ2, pt_mul(FQ2, G2_GEN, z)))
        return pairing_check([(c_minus_y, pt_neg(FQ2, G2_GEN)), (p, x_minus_z)])
