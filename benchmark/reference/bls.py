"""A BLS signature verdict in pure Python (the benchmark's frozen BLS12-381):
``e(pk, H(m)) == e(G1, sig)`` with the signature in G2, as the consensus
specs' ``bls.Verify`` (the IETF ciphersuite BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_)."""

from __future__ import annotations

from .bls12_381.curve import FQ, G1_GEN, g1_from_bytes, g2_from_bytes, g2_in_subgroup, pt_neg
from .bls12_381.hash_to_curve import DST_G2_POP, hash_to_g2
from .bls12_381.pairing import pairing_check


class MessagePoints:
    """H(m) of each message, computed once."""

    def __init__(self):
        self._h: dict = {}

    def __call__(self, message: bytes):
        p = self._h.get(message)
        if p is None:
            p = self._h[message] = hash_to_g2(message, DST_G2_POP)
        return p


def verify(pubkey: bytes, message: bytes, signature: bytes, h_of=None) -> bool:
    """The verdict on one signature; a malformed encoding is a refusal."""
    try:
        pk = g1_from_bytes(pubkey)
        sig = g2_from_bytes(signature)
    except ValueError:
        return False
    if not g2_in_subgroup(sig):
        return False
    hm = (h_of or MessagePoints())(message)
    return pairing_check([(pt_neg(FQ, pk), hm), (G1_GEN, sig)])
