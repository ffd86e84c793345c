"""BLS batch signature verification on the card (K6).

Counterpart of lighthouse_tpu/ops/bls381_verify.py
(``verify_signature_sets_device_full``, :216): the random-linear-
combination batch check

    e(-G1, sum r_i sig_i) * prod_m e(sum_{i: msg_i = m} r_i aggpk_i, H(m)) == 1

as host orchestration of the K2, K4 and K5 kernels, in the JAX function's
seven stages:

  1. G2 subgroup checks on the signatures   (K4 g2_subgroup_check)
  2. per-set pubkey sums over the padded committee axis (K2 segment sum)
  3. 64-bit RLC ladders on G1 and G2         (K2 scalar_mul)
  4. sum r_i sig_i                           (K2 segment sum)
  5. per-message gather and sum              (torch gather, K2 segment sum)
  6. H(m) and Jacobian -> affine             (K5 hash_to_g2, K2 to_affine)
  7. the multi-pairing check                 (K4 multi_pairing)

with the JAX function's early ``False`` on an infinity signature, an empty
pubkey list or a point that fails to decompress, its per-message grouping,
and its scalar draws (``rng.getrandbits(RAND_BITS)`` per set, redrawn while
0), so the same ``random.Random`` draws the same scalars in both packages.

The host's jobs: decompression (cached on the PublicKey/Signature
wrappers, the pubkeys' Montgomery limbs too), the scalar draws, grouping,
and expand_message_xmd. The tensors live on ``device`` (the default device
unless given): on the card every stage is a kernel launch, on the CPU each
kernel's plain version runs. There is no fallback: a failed build or launch
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls12_381 import FQ, G1_GEN, pt_neg, to_affine
from ..crypto.bls12_381.fields import P
from ..device import resolve_device
from . import bls381 as K2
from . import bls381_htc as K5
from . import bls381_pairing as K4
from .bls381 import NLIMB, R_MONT

_ONE_LIMBS = K2.fq_to_limbs([1])[0]
_NEG_G1 = to_affine(FQ, pt_neg(FQ, G1_GEN))


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _affine_int(pt):
    """Host Jacobian int point -> affine (x, y), or None for infinity."""
    x, y, z = pt
    if isinstance(z, tuple):
        if z == (0, 0):
            return None
        if z == (1, 0):
            return (x, y)
        from ..crypto.bls12_381 import FQ2

        return to_affine(FQ2, (x, y, z))
    if z == 0:
        return None
    return (x, y) if z == 1 else to_affine(FQ, (x, y, z))


def _mont_bytes(values) -> bytes:
    return b"".join((v * R_MONT % P).to_bytes(48, "little") for v in values)


def _limbs(buf: bytes, *shape) -> np.ndarray:
    return np.frombuffer(buf, dtype="<u4").astype(np.int64).reshape(*shape, NLIMB)


def _inf_mask(pts: torch.Tensor) -> torch.Tensor:
    """[n, 3, ...] Jacobian -> [n] bool, z == 0."""
    return (pts[:, 2] == 0).flatten(1).all(-1)


def verify_signature_sets_device_full(sets, rng=None, device=None, stages=None) -> bool:
    """Batch verification of signature sets (signature, pubkeys, message)
    with every group and field operation on `device`. Returns True iff
    every signature is valid (w.h.p.). If `stages` is a list, the chunk's
    intermediate values are appended to it as a dict (scalars, messages and
    the affine limbs of sum r_i sig_i, of each message's sum r_i aggpk_i and
    of each H(m))."""
    import secrets as _secrets

    from ..crypto import bls
    from ..metrics import inc_counter

    sets = list(sets)
    if not sets:
        return False
    inc_counter("bls_device_batches_total")
    inc_counter("bls_device_sets_total", len(sets))
    rand = rng if rng is not None else _secrets.SystemRandom()
    dev = resolve_device(device)

    sig_affs, pk_rows, scalars, messages = [], [], [], []
    for s in sets:
        try:
            if s.signature.is_infinity():
                return False
            sig_aff = _affine_int(s.signature.point())
            pk_limbs = [pk.limbs() for pk in s.pubkeys]
        except (bls.BlsError, ValueError):
            return False
        if sig_aff is None or not pk_limbs:
            return False
        r = 0
        while r == 0:
            r = rand.getrandbits(bls.RAND_BITS)
        sig_affs.append(sig_aff)
        pk_rows.append(pk_limbs)
        scalars.append(r)
        messages.append(s.message)
    n = len(sets)

    # --- 1. G2 subgroup checks on all signatures ---
    sig_aff_t = torch.from_numpy(
        _limbs(_mont_bytes(v for (x, y) in sig_affs for v in (*x, *y)), n, 2, 2)
    ).to(dev)
    no_inf = torch.zeros(n, dtype=torch.bool, device=dev)
    if not bool(K4.g2_subgroup_check(sig_aff_t, no_inf).all()):
        return False

    # --- 2. per-set pubkey sums over the padded committee axis ---
    kmax = _pow2(max(len(r) for r in pk_rows))
    grid = np.zeros((n, kmax, 3, NLIMB), dtype=np.int64)
    for i, row in enumerate(pk_rows):
        grid[i, : len(row), :2] = _limbs(b"".join(row), len(row), 2)
        grid[i, : len(row), 2] = _ONE_LIMBS
    agg_pk = K2.segment_sum("g1", torch.from_numpy(grid).to(dev))

    # --- 3. RLC ladders ---
    k = K2.scalars_to_tensor(scalars).to(dev)
    s_pk = K2.scalar_mul("g1", agg_pk, k)
    sig_jac = torch.empty((n, 3, 2, NLIMB), dtype=torch.int64, device=dev)
    sig_jac[:, :2] = sig_aff_t
    sig_jac[:, 2] = 0
    sig_jac[:, 2, 0] = torch.from_numpy(_ONE_LIMBS).to(dev)
    s_sig = K2.scalar_mul("g2", sig_jac, k)

    # --- 4. sum r_i sig_i ---
    nb = _pow2(n)
    pad = torch.zeros((1, nb, 3, 2, NLIMB), dtype=torch.int64, device=dev)
    pad[0, :n] = s_sig
    agg_sig = K2.segment_sum("g2", pad)

    # --- 5. per-message gather and sum ---
    groups: dict[bytes, list[int]] = {}
    for i, m in enumerate(messages):
        groups.setdefault(m, []).append(i)
    msgs = list(groups)
    gmax = _pow2(max(len(v) for v in groups.values()))
    idx = np.full((len(msgs), gmax), n, dtype=np.int64)  # row n: an infinity
    for gi, m in enumerate(msgs):
        idx[gi, : len(groups[m])] = groups[m]
    s_pk_pad = torch.cat((s_pk, torch.zeros_like(s_pk[:1])), 0)
    msg_pk = K2.segment_sum("g1", s_pk_pad[torch.from_numpy(idx).to(dev)])

    # --- 6. H(m) and affine forms ---
    u = torch.from_numpy(K5.messages_to_field(msgs)).to(dev)
    hm = K5.hash_to_g2(u)
    pk_aff = K2.to_affine("g1", msg_pk)
    q_jac = torch.cat((agg_sig, hm), 0)
    q_aff = K2.to_affine("g2", q_jac)

    # --- 7. the multi-pairing: (-G1, sum r_i sig_i) and (msg_pk_m, H(m)) ---
    neg_g1 = torch.from_numpy(_limbs(_mont_bytes(_NEG_G1), 1, 2)).to(dev)
    p_aff = torch.cat((neg_g1, pk_aff), 0)
    p_inf = torch.cat((torch.zeros(1, dtype=torch.bool, device=dev), _inf_mask(msg_pk)), 0)
    ok = K4.multi_pairing_check(p_aff, p_inf, q_aff, _inf_mask(q_jac))
    if stages is not None:
        stages.append(
            {
                "scalars": scalars,
                "messages": msgs,
                "agg_sig": q_aff[0].cpu().numpy(),
                "msg_pk": pk_aff.cpu().numpy(),
                "hm": q_aff[1:].cpu().numpy(),
            }
        )
    return ok
