"""One slot's unaggregated gossip attestations, made by the benchmark.

Every member of every committee of the slot attests once, with one bit set,
for the head. Keys are drawn per committee as an arithmetic progression
sk_j = a + j b (mod r) in committee order, so that the public keys and the
signatures over the committee's one message are running sums of a point
(pk_j = pk_{j-1} + [b]G1, sig_j = sig_{j-1} + [b]H(m)); a verifier sees
uniform group elements either way. All of it runs on the benchmark's own
pure-Python BLS12-381, nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..reference import beacon
from ..reference.bls12_381.curve import FQ, FQ2, G1_GEN, R, batch_to_affine, g2_affine_to_bytes, pt_add, pt_mul
from ..reference.bls12_381.fields import P
from ..reference.bls12_381.hash_to_curve import DST_G2_POP, hash_to_g2

_COMPRESSED, _Y_SIGN = 1 << 7, 1 << 5


def g1_affine_to_bytes(aff) -> bytes:
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED | (_Y_SIGN if y > (P - 1) // 2 else 0)
    return bytes(out)


def _progression(k, base, a: int, b: int, count: int) -> list:
    """[a + j b] base for j < count, as running sums (Jacobian)."""
    pts = [pt_mul(k, base, a)]
    step = pt_mul(k, base, b)
    for _ in range(count - 1):
        pts.append(pt_add(k, pts[-1], step))
    return pts


@dataclass
class Keys:
    """Per committee: its members, a and b."""

    committees: list
    a: list
    b: list


def draw_keys(f: dict, committees: list, rng: np.random.Generator) -> Keys:
    """Draw each committee's keys and write the members' public keys into
    the registry `f["pubkey"]`."""
    a, b = [], []
    for members in committees:
        ka = int.from_bytes(rng.bytes(32), "big") % R or 1
        kb = int.from_bytes(rng.bytes(32), "big") % R or 1
        pts = batch_to_affine(FQ, _progression(FQ, G1_GEN, ka, kb, len(members)))
        f["pubkey"][members] = np.frombuffer(b"".join(g1_affine_to_bytes(p) for p in pts), np.uint8).reshape(-1, 48)
        a.append(ka)
        b.append(kb)
    return Keys(committees, a, b)


def attestation_ssz(slot: int, index: int, root: bytes, source: tuple, target: tuple, size: int, pos: int, sig: bytes) -> bytes:
    """SSZ of an Attestation: the offset of its bitlist, its data, its
    signature, then the bitlist (one bit at `pos` of `size`, and the length
    bit)."""
    bits = bytearray(size // 8 + 1)
    bits[pos // 8] |= 1 << (pos % 8)
    bits[size // 8] |= 1 << (size % 8)
    data = (
        slot.to_bytes(8, "little") + index.to_bytes(8, "little") + root
        + source[0].to_bytes(8, "little") + source[1] + target[0].to_bytes(8, "little") + target[1]
    )
    return (4 + len(data) + 96).to_bytes(4, "little") + data + sig + bytes(bits)


def parse_attestation(payload: bytes) -> dict:
    """The fields of an Attestation's SSZ (the reference's own decoding)."""
    off = int.from_bytes(payload[:4], "little")
    d = payload[4:132]
    bits = payload[off:]
    last = bits[-1].bit_length() - 1
    size = (len(bits) - 1) * 8 + last
    set_bits = [i for i in range(size) if bits[i // 8] >> (i % 8) & 1]
    return {
        "slot": int.from_bytes(d[0:8], "little"),
        "index": int.from_bytes(d[8:16], "little"),
        "root": d[16:48],
        "source": (int.from_bytes(d[48:56], "little"), d[56:88]),
        "target": (int.from_bytes(d[88:96], "little"), d[96:128]),
        "signature": payload[132:228],
        "size": size,
        "bits": set_bits,
    }


@dataclass
class Pool:
    """Payloads in arrival order with what each one is."""

    payloads: list
    subnet: np.ndarray
    committee: np.ndarray
    validator: np.ndarray
    position: np.ndarray  # the attester's place in its committee: its bit
    forged: np.ndarray  # signed over another message: the verifier must refuse it
    messages: list  # the signing root of each committee
    data_roots: list  # the AttestationData root of each committee


def make_pool(f: dict, preset: dict, keys: Keys, slot: int, head_root: bytes, source: tuple,
              rng: np.random.Generator, forged_at: list[int], subnets: int) -> Pool:
    """Sign every member's attestation, order them by a seeded permutation
    (arrivals interleave across the subnets), and sign the ones at
    `forged_at` (arrival positions) over another block root."""
    epoch = slot // preset["SLOTS_PER_EPOCH"]
    target = (epoch, head_root)
    domain = beacon.attester_domain(f, preset, epoch)
    cps = len(keys.committees)
    per_slot = cps * (slot % preset["SLOTS_PER_EPOCH"])
    entries = []
    messages, data_roots = [], []
    for c, members in enumerate(keys.committees):
        data_roots.append(beacon.attestation_data_root(slot, c, head_root, source, target))
        msg = beacon.signing_root(data_roots[-1], domain)
        messages.append(msg)
        sigs = batch_to_affine(FQ2, _progression(FQ2, hash_to_g2(msg, DST_G2_POP), keys.a[c], keys.b[c], len(members)))
        for j, v in enumerate(members.tolist()):
            entries.append((c, j, v, g2_affine_to_bytes(sigs[j])))
    order = rng.permutation(len(entries))
    other = beacon.sha(b"another block root" + head_root)
    payloads, subnet, committee, validator, position = [], [], [], [], []
    forged = np.zeros(len(entries), dtype=bool)
    forged[forged_at] = True
    for pos, k in enumerate(order.tolist()):
        c, j, v, sig = entries[k]
        size = len(keys.committees[c])
        if forged[pos]:
            m = beacon.signing_root(beacon.attestation_data_root(slot, c, other, source, target), domain)
            sk = (keys.a[c] + j * keys.b[c]) % R
            sig = g2_affine_to_bytes(batch_to_affine(FQ2, [pt_mul(FQ2, hash_to_g2(m, DST_G2_POP), sk)])[0])
        payloads.append(attestation_ssz(slot, c, head_root, source, target, size, j, sig))
        subnet.append((per_slot + c) % subnets)
        committee.append(c)
        validator.append(v)
        position.append(j)
    return Pool(payloads, np.array(subnet), np.array(committee), np.array(validator), np.array(position), forged,
                messages, data_roots)
