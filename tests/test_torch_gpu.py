"""lighthouse_tpu_torch kernels on a CUDA card, against their plain
PyTorch versions on the same card and against hashlib or the host BLS
oracle: byte-identical, limb-identical, verdict-identical.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips
without one. This file imports no JAX, so it also runs where JAX is not
installed (see README.md, "The PyTorch/CUDA port", for the command).
"""

import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    block_update,
    bls_g1_point_of_order,
    bls_g1_points,
    bls_g2_points,
    bls_scalars,
    bls_segment_rows,
    bls_twist_point_of_order,
    bls_twist_point_outside_subgroup,
    build_deneb_state,
    epoch_sweep_inputs,
    host_state_root,
)
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.beacon_chain.chain import _make_persistent
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import bls381_htc as K5
from lighthouse_tpu_torch.ops import bls381_pairing as K4
from lighthouse_tpu_torch.ops import epoch_sweep as K7
from lighthouse_tpu_torch.ops import sha256 as k
from lighthouse_tpu_torch.types import MinimalEthSpec, build_types

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = default_device()
    set_default_device("cuda")
    yield torch.device("cuda")
    set_default_device(prev)


def _hashlib_rows(rows: np.ndarray) -> np.ndarray:
    return np.stack(
        [np.frombuffer(hashlib.sha256(r.tobytes()).digest(), np.uint8) for r in rows]
    )


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 65_539])
def test_kernel_matches_plain_and_hashlib(cuda, n):
    rows_np = np.random.default_rng(n).integers(0, 256, (n, 64), dtype=np.uint8)
    rows = torch.from_numpy(rows_np).to(cuda)
    before = k.COUNTS["launches"]
    got = k.sha256_pairs(rows)
    torch.cuda.synchronize()
    assert k.COUNTS["launches"] == before + 1
    assert torch.equal(got, k.sha256_rows_plain(rows))
    sample = np.arange(0, n, max(1, n // 512))
    assert np.array_equal(got.cpu().numpy()[sample], _hashlib_rows(rows_np[sample]))


def test_merkle_tree_levels_matches_plain(cuda):
    leaves = np.random.default_rng(3).integers(0, 256, (1 << 14, 32), dtype=np.uint8)
    got = k.merkle_tree_levels(leaves)
    want = k.merkle_tree_levels(leaves, device="cpu")
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_state_root_on_card_equals_host_lanes(cuda):
    E = MinimalEthSpec
    state = build_deneb_state(build_types(E), E, 4096, seed=4)
    _make_persistent(state)
    before = k.COUNTS["launches"]
    root = state.hash_tree_root()
    assert k.COUNTS["launches"] > before
    assert root == host_state_root(state)
    block_update(state, E, np.random.default_rng(1))
    root = state.hash_tree_root()
    assert root == host_state_root(state)


# ---------------------------------------------------------------------------
# BLS kernels (K2, K4, K5) against their plain versions on the card
# ---------------------------------------------------------------------------


def _g1(points, dev):
    return torch.from_numpy(K2.g1_to_limbs(points)).to(dev)


def _g2(points, dev):
    return torch.from_numpy(K2.g2_to_limbs(points)).to(dev)


def _launched(counts, name, fn, launches=1):
    before = counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert counts[name] == before + launches
    return out


def _segment_passes(group, k):
    """The kernel launches of a segment sum over k points: a pass cuts a
    segment into sub-segments of up to 128 (G1) or 8 (G2) points, and the
    next pass sums their roots."""
    span, passes = {"g1": 128, "g2": 8}[group], 1
    while k > span:
        k, passes = k // span, passes + 1
    return passes


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_scalar_mul_matches_plain(cuda, group):
    rng = np.random.default_rng(11)
    pts = (_g1 if group == "g1" else _g2)((bls_g1_points if group == "g1" else bls_g2_points)(rng, 5), cuda)
    k = K2.scalars_to_tensor(bls_scalars(rng, 4) + [2**64 - 1]).to(cuda)
    got = _launched(K2.COUNTS, f"{group}_scalar_mul", lambda: K2.scalar_mul(group, pts, k))
    assert torch.equal(got, K2.scalar_mul_plain(group, pts, k))


@pytest.mark.parametrize("affine", [False, True])
def test_bls_g2_ladder_edge_scalars_match_plain(cuda, affine):
    """The warp-team G2 ladder at the edge scalars 0, 1, 2, 2^63 and
    2^64 - 1 and 27 random ones, on Jacobian points (Z != 1) or affine
    ones (Z = 1, the mixed addition), limb-equal to its plain version."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ2, to_affine

    rng = np.random.default_rng(13)
    pts = bls_g2_points(rng, 32)
    if affine:
        pts = [(*to_affine(FQ2, p), FQ2.one) for p in pts]
    k = K2.scalars_to_tensor([0, 1, 2, 2**63, 2**64 - 1] + bls_scalars(rng, 27)).to(cuda)
    pts = _g2(pts, cuda)
    got = _launched(K2.COUNTS, "g2_scalar_mul", lambda: K2.scalar_mul("g2", pts, k))
    assert torch.equal(got, K2.scalar_mul_plain("g2", pts, k))


@pytest.mark.parametrize("affine", [False, True])
def test_bls_g1_ladder_edge_scalars_match_plain(cuda, affine):
    """The warp-team G1 ladder at the edge scalars 0, 1, 2, 2^63 and
    2^64 - 1 and 27 random ones, on Jacobian points (Z != 1) or affine
    ones (Z = 1), with an infinity input in the last lane and a point of
    order 3 (the team addition's P == Q, P == -Q and infinity cases) in
    the one before, limb-equal to its plain version."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, inf, to_affine

    rng = np.random.default_rng(15)
    pts = bls_g1_points(rng, 30)
    if affine:
        pts = [(*to_affine(FQ, p), 1) for p in pts]
    pts += [bls_g1_point_of_order(rng, 3), inf(FQ)]
    k = K2.scalars_to_tensor([0, 1, 2, 2**63, 2**64 - 1] + bls_scalars(rng, 27)).to(cuda)
    pts = _g1(pts, cuda)
    got = _launched(K2.COUNTS, "g1_scalar_mul", lambda: K2.scalar_mul("g1", pts, k))
    assert torch.equal(got, K2.scalar_mul_plain("g1", pts, k))


@pytest.mark.parametrize("layout", [None, "team", "thread"])
@pytest.mark.parametrize("n", [1, 33, 4096])
def test_bls_g1_ladder_lanes_match_plain(cuda, n, layout):
    """The G1 ladder at 1, 33 and 4,096 lanes (K11's shape) in the layout
    the kernel picks by lane count and in each forced one, limb-equal to
    its plain version."""
    rng = np.random.default_rng(16)
    pts = _g1(bls_g1_points(rng, min(n, 33)), cuda)
    pts = pts.repeat(-(-n // pts.shape[0]), 1, 1)[:n].contiguous()
    k = K2.scalars_to_tensor(bls_scalars(rng, n)).to(cuda)
    got = _launched(K2.COUNTS, "g1_scalar_mul", lambda: K2.scalar_mul("g1", pts, k, layout=layout))
    assert torch.equal(got, K2.scalar_mul_plain("g1", pts, k))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_segment_sum_and_affine_match_plain(cuda, group):
    """Rows with a repeated point, a point and its negation, and infinity
    pads, so the add meets P == Q, P == -Q and Z = 0."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, inf, pt_neg

    rng = np.random.default_rng(12)
    F = FQ if group == "g1" else FQ2
    p = (bls_g1_points if group == "g1" else bls_g2_points)(rng, 6)
    rows = [
        [p[0], p[0], p[1], p[2], inf(F), inf(F), inf(F), inf(F)],
        [p[3], pt_neg(F, p[3]), p[4], p[4], p[4], p[5], inf(F), inf(F)],
        [inf(F)] * 8,
    ]
    pts = (_g1 if group == "g1" else _g2)([q for r in rows for q in r], cuda)
    pts = pts.reshape(3, 8, *pts.shape[1:]).contiguous()
    got = _launched(K2.COUNTS, f"{group}_segment_sum", lambda: K2.segment_sum(group, pts))
    assert torch.equal(got, K2.segment_sum_plain(group, pts))
    aff = _launched(K2.COUNTS, f"{group}_to_affine", lambda: K2.to_affine(group, got))
    assert torch.equal(aff, K2.to_affine_plain(group, got))


@pytest.mark.parametrize(
    "group, case, n, k, pads",
    [
        ("g1", "edge", 0, 128, 8),
        ("g1", "edge", 0, 512, 24),
        ("g1", "affine", 3, 8, 2),
        ("g1", "jacobian", 2, 1, 0),
        ("g1", "jacobian", 2, 2, 0),
        # the verifier's pubkey rows; K11's and the ladder MSM's one row
        ("g1", "affine", 32, 512, 24),
        ("g1", "jacobian", 1, 4096, 0),
        ("g2", "edge", 0, 32, 5),
        ("g2", "jacobian", 1, 32, 5),
        ("g2", "jacobian", 1, 128, 3),
    ],
)
def test_bls_segment_sum_cases_match_plain(cuda, group, case, n, k, pads):
    """The segment sums' blocks, teams, affine first level and passes
    over the blocks' roots (the host-shim test's cases, and the main
    path's shapes), limb-equal to their plain version."""
    pts = torch.from_numpy(bls_segment_rows(np.random.default_rng(24), group, case, n, k, pads)).to(cuda)
    got = _launched(
        K2.COUNTS, f"{group}_segment_sum", lambda: K2.segment_sum(group, pts), _segment_passes(group, pts.shape[1])
    )
    assert torch.equal(got, K2.segment_sum_plain(group, pts))


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("n", [1, 32, 33, 64, 65, 130, 4096])
def test_bls_to_affine_lanes_match_plain(cuda, group, n):
    """The batch conversion (one inversion a block of 64 lanes) at 1 to
    4,096 lanes: Jacobian points (Z != 1), an affine one (Z = 1) in lane
    1, infinity lanes at the first, middle and last lane (past n = 64 the
    last lies past the last full block), and past 128 lanes a whole block
    of infinities; limb-equal to the plain version, infinities (0, 0)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, inf, to_affine

    F = FQ if group == "g1" else FQ2
    rng = np.random.default_rng(17)
    pts = (bls_g1_points if group == "g1" else bls_g2_points)(rng, min(n, 33))
    pts = (pts * -(-n // len(pts)))[:n]
    infinity = set()
    if n > 1:
        pts[1] = (*to_affine(F, pts[1]), F.one)
        infinity = {0, n // 2, n - 1} | (set(range(64, 128)) if n > 128 else set())
    for j in infinity:
        pts[j] = inf(F)
    p = (_g1 if group == "g1" else _g2)(pts, cuda)
    got = _launched(K2.COUNTS, f"{group}_to_affine", lambda: K2.to_affine(group, p))
    assert torch.equal(got, K2.to_affine_plain(group, p))
    for j in infinity:
        assert not bool(got[j].any()), f"infinity lane {j} is not (0, 0)"


def test_bls_subgroup_check_matches_plain(cuda):
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ2, to_affine

    rng = np.random.default_rng(13)
    affs = [to_affine(FQ2, q) for q in bls_g2_points(rng, 3)] + [bls_twist_point_outside_subgroup(rng)]
    q = torch.from_numpy(K2.fq_to_limbs([v for a in affs for c in a for v in c]).reshape(-1, 2, 2, 12)).to(cuda)
    q_inf = torch.tensor([False, False, True, False], device=cuda)
    ok = _launched(K4.COUNTS, "g2_subgroup_check", lambda: K4.g2_subgroup_check(q, q_inf))
    assert ok.tolist() == [True, True, True, False]
    assert torch.equal(ok, K4.g2_subgroup_check_plain(q, q_inf))


def test_bls_subgroup_check_edge_points_match_plain(cuda):
    """The warp-team subgroup check at 33 points: points of G2, points of
    the twist outside it, twist points of order 13 and 23 (the |x|-ladder
    meets infinity on them) and a q_inf lane, verdict-equal to its plain
    version and to the host oracle."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ2, g2_in_subgroup, to_affine

    rng = np.random.default_rng(17)
    affs = [to_affine(FQ2, q) for q in bls_g2_points(rng, 33)]
    outside = {4: bls_twist_point_outside_subgroup(rng), 11: bls_twist_point_outside_subgroup(rng)}
    outside.update({17: bls_twist_point_of_order(rng, 13), 29: bls_twist_point_of_order(rng, 23)})
    outside[32] = bls_twist_point_of_order(rng, 13)
    for i, a in outside.items():
        affs[i] = a
    q = torch.from_numpy(K2.fq_to_limbs([v for a in affs for c in a for v in c]).reshape(-1, 2, 2, 12)).to(cuda)
    q_inf = torch.zeros(33, dtype=torch.bool, device=cuda)
    q_inf[21] = True
    ok = _launched(K4.COUNTS, "g2_subgroup_check", lambda: K4.g2_subgroup_check(q, q_inf))
    assert torch.equal(ok, K4.g2_subgroup_check_plain(q, q_inf))
    want = [i == 21 or g2_in_subgroup((*a, FQ2.one)) for i, a in enumerate(affs)]
    assert ok.tolist() == want
    assert want == [i not in outside for i in range(33)]


@pytest.mark.parametrize("m, infinity", [(1, ()), (2, ()), (3, (2,)), (33, (5,)), (65, (0, 64)), (4, "all")])
def test_bls_multi_pairing_matches_plain(cuda, m, infinity):
    """One Miller-loop team per pair over as many blocks as the pairs need
    (65: 17 blocks), the tree over the pairs and the final exponentiation,
    limb-equal to the plain version; infinity pairs are the identity."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, to_affine

    rng = np.random.default_rng(14 + m)
    p = [to_affine(FQ, x) for x in bls_g1_points(rng, m)]
    q = [to_affine(FQ2, x) for x in bls_g2_points(rng, m)]
    pt = torch.from_numpy(K2.fq_to_limbs([v for a in p for v in a]).reshape(m, 2, 12)).to(cuda)
    qt = torch.from_numpy(K2.fq_to_limbs([v for a in q for c in a for v in c]).reshape(m, 2, 2, 12)).to(cuda)
    p_inf = torch.zeros(m, dtype=torch.bool, device=cuda)
    q_inf = torch.zeros(m, dtype=torch.bool, device=cuda)
    if infinity == "all":
        p_inf[:] = True
    else:
        p_inf[list(infinity)] = True
    got = _launched(K4.COUNTS, "multi_pairing", lambda: K4.multi_pairing(pt, p_inf, qt, q_inf))
    assert torch.equal(got, K4.multi_pairing_plain(pt, p_inf, qt, q_inf))
    if infinity == "all":
        assert K4.f12_is_one(got)


def test_bls_hash_to_g2_matches_plain(cuda):
    u = torch.from_numpy(K5.messages_to_field([b"abc", bytes(32), bytes(range(32))])).to(cuda)
    got = _launched(K5.COUNTS, "hash_to_g2", lambda: K5.hash_to_g2(u))
    assert torch.equal(got, K5.hash_to_g2_plain(u))


def test_bls_hash_to_g2_edge_lanes_match_plain(cuda):
    """u0 = u1 = 0 (the tv2 = 0 exception), u whose g(x1) is not a square
    and u1 = u0 (the E' doubling), among 32 messages: the kernel
    limb-equal to its plain version."""
    from chip_smoke import htc_edge_field_elements

    u_np, lanes = htc_edge_field_elements(np.random.default_rng(31), 32)
    assert lanes["non_square"]
    u = torch.from_numpy(u_np).to(cuda)
    got = _launched(K5.COUNTS, "hash_to_g2", lambda: K5.hash_to_g2(u))
    assert torch.equal(got, K5.hash_to_g2_plain(u))


@pytest.mark.parametrize("valid", [True, False])
def test_bls_cuda_backend_verdict(cuda, valid):
    import random

    from lighthouse_tpu_torch.crypto import bls

    sks = [bls.interop_secret_key(i) for i in range(10)]
    pks = [sk.public_key() for sk in sks]
    sets = []
    for j in range(8):
        msg = bytes([j % 3]) * 32
        signers = [j, j + 1, (j * 3) % 10]
        sig = bls.AggregateSignature.from_signatures([sks[i].sign(msg) for i in signers]).to_signature()
        sets.append(bls.SignatureSet(sig, [pks[i] for i in signers], msg))
    if not valid:
        sets[5] = bls.SignatureSet(sets[4].signature, sets[5].pubkeys, sets[5].message)
    prev = bls.backend_name()
    try:
        bls.set_backend("cuda")
        before = dict(K4.COUNTS)
        got = bls.verify_signature_sets(sets, random.Random(7))
        assert K4.COUNTS["multi_pairing"] == before["multi_pairing"] + 1
    finally:
        bls.set_backend(prev)
    assert got is valid
    assert bls._BACKENDS["host"].verify_signature_sets(sets, random.Random(7)) is valid


@pytest.mark.parametrize("n", [1, 255, 4096, 65_537, 3_500_000])
@pytest.mark.parametrize("leak", [False, True])
def test_epoch_sweep_matches_plain(cuda, n, leak):
    """The epoch-sweep kernel bit-exact with its plain version on the card,
    with the edge rows of `epoch_sweep_inputs` (FAR_FUTURE_EPOCH epochs,
    slashed validators withdrawable ahead, penalties above the balance,
    effective_balance * score of 2^63 and more); at 3.5 M validators the
    tiles pass what shared memory keeps (~3.3 M on 132 SMs) and their tails
    are read again from device memory."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(n + leak), max(n, 128), leak)
    cols = {k: v[:n] for k, v in cols.items()}
    args = K7.sweep_tensors(cols, scalars, cuda)
    before = K7.COUNTS["launches"]
    got = K7.epoch_sweep(*args)
    torch.cuda.synchronize()
    assert K7.COUNTS["launches"] == before + 1
    want = K7.epoch_sweep_plain(*args)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)
    host = K7.epoch_sweep_arrays(cols, scalars)
    for h, g in zip(host, got):
        assert np.array_equal(h, g.cpu().numpy().view(np.uint64))
    grid, _, tile, keep = K7.launch_plan(args[0].device, n)
    assert grid * tile >= n and (keep < tile) == (n == 3_500_000)


@pytest.mark.parametrize("keep", [0, 1, 100])
def test_epoch_sweep_re_read_past_a_forced_keep_matches_plain(cuda, keep):
    """The cooperative kernel keeping only `keep` validators a tile (the
    rest read again in its second phase) at 65,537 validators."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(keep), 65_537, False)
    args = K7.sweep_tensors(cols, scalars, cuda)
    plan = K7._shaped_plan(args[0].device, 65_537, K7.THREADS, K7.BLOCKS_PER_SM, keep)
    assert plan[3] == keep < plan[2]
    got = K7._launch(dict(zip(K7.COLUMNS, args[:8])), args[8], plan)
    for g, w in zip(got, K7.epoch_sweep_plain(*args)):
        assert torch.equal(g, w)


def test_replaced_two_pass_sweep_matches_plain(cuda):
    """The two-kernel sweep the cooperative kernel replaced, kept for
    chip_smoke.py's comparison, on the edge rows at 65,537 validators."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(5), 65_537, True)
    args = K7.sweep_tensors(cols, scalars, cuda)
    before = dict(K7.COUNTS)
    got = K7.epoch_sweep_two_pass(*args)
    assert K7.COUNTS == {**before, "two_pass": before["two_pass"] + 1}
    for g, w in zip(got, K7.epoch_sweep_plain(*args)):
        assert torch.equal(g, w)


def test_epoch_sweep_refuses_a_grid_beyond_one_wave(cuda):
    """A cooperative grid the card cannot hold at once is refused and
    raises; nothing falls back, and the next sweep runs."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(6), 4096, False)
    args = K7.sweep_tensors(cols, scalars, cuda)
    sms = torch.cuda.get_device_properties(args[0].device).multi_processor_count
    before = K7.COUNTS["launches"]
    with pytest.raises(RuntimeError, match="epoch_sweep launch failed"):
        K7._launch(dict(zip(K7.COLUMNS, args[:8])), args[8], (64 * sms, 1024, 32, 0))
    assert K7.COUNTS["launches"] == before
    got = K7.epoch_sweep(*args)
    for g, w in zip(got, K7.epoch_sweep_plain(*args)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# KZG kernels (K8, K9) against their plain versions on the card
# ---------------------------------------------------------------------------


def _domain(n):
    from lighthouse_tpu_torch.crypto.kzg import _bit_reverse_permute, _root_of_unity
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R

    w = _root_of_unity(n)
    return _bit_reverse_permute([pow(w, i, R) for i in range(n)])


@pytest.mark.parametrize("m, n", [(3, 256), (6, 4096)])
def test_kzg_barycentric_matches_plain_and_host(cuda, m, n):
    from chip_smoke import fr_scalars, kzg_blobs
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R
    from lighthouse_tpu_torch.ops import fr as K8

    rng = np.random.default_rng(m)
    roots = _domain(n)
    words = np.stack([K8.words_from_bytes(b, n) for b in kzg_blobs(rng, m, n)])
    zs = fr_scalars(rng, m)
    args = [K8.as_i32(a).to(cuda) for a in (words, K8.mont_limbs(roots), K8.fr_to_words(zs))]
    got = _launched(K8.COUNTS, "barycentric_eval", lambda: K8.barycentric_eval(*args))
    assert torch.equal(got, K8.barycentric_eval_plain(*args))
    p = K8.fr_from_words(words[0])
    z = zs[0]
    want = sum(pi * w * pow(z - w, R - 2, R) for pi, w in zip(p, roots)) % R
    want = want * (pow(z, n, R) - 1) * pow(n, R - 2, R) % R
    assert K8.fr_from_words(got.cpu().numpy())[0] == want


@pytest.mark.parametrize("m, on_domain", [(1, None), (6, 2)])
def test_kzg_barycentric_one_blob_and_domain_point(cuda, m, on_domain):
    """A proof's one blob, and six blobs with one z on the domain (y = 0
    there, the others untouched): the kernel equal to its plain version and
    to the host formula."""
    from chip_smoke import fr_scalars, kzg_blobs
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R
    from lighthouse_tpu_torch.ops import fr as K8

    n = 4096
    rng = np.random.default_rng(40 + m)
    roots = _domain(n)
    words = np.stack([K8.words_from_bytes(b, n) for b in kzg_blobs(rng, m, n)])
    zs = fr_scalars(rng, m)
    if on_domain is not None:
        zs[on_domain] = roots[77]
    args = [K8.as_i32(a).to(cuda) for a in (words, K8.mont_limbs(roots), K8.fr_to_words(zs))]
    got = _launched(K8.COUNTS, "barycentric_eval", lambda: K8.barycentric_eval(*args))
    assert torch.equal(got, K8.barycentric_eval_plain(*args))
    ys = K8.fr_from_words(got.cpu().numpy())
    for j in range(m):
        if j == on_domain:
            assert ys[j] == 0
        elif j in (0, m - 1):
            p = K8.fr_from_words(words[j])
            want = sum(pi * w * pow(zs[j] - w, R - 2, R) for pi, w in zip(p, roots)) % R
            assert ys[j] == want * (pow(zs[j], n, R) - 1) * pow(n, R - 2, R) % R


@pytest.mark.parametrize("on_domain", [False, True])
def test_kzg_quotient_matches_plain_and_host(cuda, on_domain):
    from chip_smoke import fr_scalars, kzg_blobs
    from lighthouse_tpu_torch.crypto.bls12_381.fields import R
    from lighthouse_tpu_torch.ops import fr as K8

    n = 4096
    rng = np.random.default_rng(20 + on_domain)
    roots = _domain(n)
    words = K8.words_from_bytes(kzg_blobs(rng, 1, n)[0], n)
    z = roots[77] if on_domain else fr_scalars(rng, 1)[0]
    y = fr_scalars(rng, 1)[0]
    zy = K8.as_i32(K8.fr_to_words([z, y])).to(cuda)
    args = (K8.as_i32(words).to(cuda), K8.as_i32(K8.mont_limbs(roots)).to(cuda), zy[0], zy[1])
    got = _launched(K8.COUNTS, "quotient", lambda: K8.quotient(*args))
    assert torch.equal(got, K8.quotient_plain(*args))
    q = K8.fr_from_words(got.cpu().numpy())
    p = K8.fr_from_words(words)
    for i in (0, 1, 77, n - 1):
        assert q[i] == (0 if roots[i] == z else (p[i] - y) * pow(roots[i] - z, R - 2, R) % R)


@pytest.mark.parametrize("hit", [0, 127, 128, 2049, 4095])
def test_kzg_quotient_hit_lane_in_each_block(cuda, hit):
    """z on the domain at a block's first or last lane, or inside a block
    (blocks of 128 lanes, one batch inversion each): that lane 0, every
    other lane, its block's too, equal to the plain version."""
    from chip_smoke import fr_scalars, kzg_blobs
    from lighthouse_tpu_torch.ops import fr as K8

    n = 4096
    rng = np.random.default_rng(30 + hit)
    roots = _domain(n)
    words = K8.words_from_bytes(kzg_blobs(rng, 1, n)[0], n)
    zy = K8.as_i32(K8.fr_to_words([roots[hit], fr_scalars(rng, 1)[0]])).to(cuda)
    args = (K8.as_i32(words).to(cuda), K8.as_i32(K8.mont_limbs(roots)).to(cuda), zy[0], zy[1])
    got = _launched(K8.COUNTS, "quotient", lambda: K8.quotient(*args))
    assert torch.equal(got, K8.quotient_plain(*args))
    assert (got != 0).any(-1).nonzero().flatten().tolist() == [i for i in range(n) if i != hit]


@pytest.mark.parametrize("n", [1, 37, 300])
def test_msm_matches_plain_and_host(cuda, n):
    """g1_msm (the table kernel, then the fixed-base MSM) limb-equal to its
    plain version and equal to the host MSM, with msm_edge_case's zero
    scalars, r - 1, a repeated and a negated point; the table equal to the
    plain table; all-equal scalars (every entry of a window in one
    bucket) and zero scalars."""
    from chip_smoke import msm_edge_case
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, msm, pt_eq
    from lighthouse_tpu_torch.ops import fr as K8
    from lighthouse_tpu_torch.ops import msm as K9

    rng = np.random.default_rng(30 + n)
    pts, sc = msm_edge_case(rng, bls_g1_points(rng, n))
    pt = _g1(pts, cuda)
    s = K8.as_i32(K8.fr_to_words(sc)).to(cuda)
    got = _launched(K9.COUNTS, "msm", lambda: K9.g1_msm(pt, s))
    assert torch.equal(got, K9.g1_msm_plain(pt, s))
    assert pt_eq(FQ, K2.g1_from_limbs(got.cpu().numpy())[0], msm(FQ, pts, sc))
    table = _launched(K9.COUNTS, "msm_table", lambda: K9.g1_msm_table(pt))
    plain = K9.g1_msm_table_plain(pt)
    assert torch.equal(table.xy, plain.xy) and torch.equal(table.inf, plain.inf)
    same = K8.as_i32(K8.fr_to_words([sc[-1] or 5] * n)).to(cuda)
    got = _launched(K9.COUNTS, "msm", lambda: K9.g1_msm_fixed(table, same))
    assert torch.equal(got, K9.g1_msm_fixed_plain(plain, same))
    zero = _launched(K9.COUNTS, "msm", lambda: K9.g1_msm_fixed(table, torch.zeros_like(s)))
    assert int(zero[2].abs().sum()) == 0  # infinity


def test_msm_over_the_resident_table_of_the_dev_setup(cuda):
    """The KZG engine's resident table over the 64-point dev setup: built
    once at the first MSM, equal to the plain table, and every commitment
    through it equal to the host engine's."""
    from chip_smoke import kzg_blobs
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
    from lighthouse_tpu_torch.ops import msm as K9

    setup = TrustedSetup.insecure_dev(64)
    kzg, host = Kzg(setup), Kzg(setup, device=False)
    blobs = kzg_blobs(np.random.default_rng(41), 3, 64)
    before = dict(K9.COUNTS)
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    assert K9.COUNTS["msm_table"] == before["msm_table"] + 1
    assert K9.COUNTS["msm"] == before["msm"] + 3
    assert commitments == [host.blob_to_kzg_commitment(b) for b in blobs]
    plain = K9.g1_msm_table_plain(kzg._dev.points)
    assert torch.equal(kzg._dev.table.xy, plain.xy) and torch.equal(kzg._dev.table.inf, plain.inf)


def test_kzg_six_blobs_on_the_ceremony_setup(cuda):
    """Six mainnet-size blobs committed, proven and batch-verified on the
    card against the mainnet ceremony's setup; a swapped proof refused."""
    from chip_smoke import ceremony_kzg, kzg_blobs
    from lighthouse_tpu_torch.ops import fr as K8
    from lighthouse_tpu_torch.ops import msm as K9

    kzg = ceremony_kzg()
    blobs = kzg_blobs(np.random.default_rng(40), 6)
    before = (K8.COUNTS["barycentric_eval"], K8.COUNTS["quotient"], K9.COUNTS["msm"], K9.COUNTS["msm_table"])
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
    assert kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs) is True
    after = (K8.COUNTS["barycentric_eval"], K8.COUNTS["quotient"], K9.COUNTS["msm"], K9.COUNTS["msm_table"])
    assert [a - b for a, b in zip(after, before)] == [7, 6, 12, 1]
    swapped = proofs[1:2] + proofs[:1] + proofs[2:]
    assert kzg.verify_blob_kzg_proof_batch(blobs, commitments, swapped) is False


# ---------------------------------------------------------------------------
# The multi-device step: K10, the K9 ladder, K11 (one rank; two cards)
# ---------------------------------------------------------------------------


def test_merkle_subtree_roots_match_plain_and_hashlib(cuda):
    """Runs of 2^1, 2^5, 2^9 and 2^12 of 2^12 leaves, a launch each."""
    from lighthouse_tpu_torch.ops import merkle_sharded as K10

    leaves_np = np.random.default_rng(50).integers(0, 256, (1 << 12, 32), dtype=np.uint8)
    leaves = torch.from_numpy(leaves_np).to(cuda)
    for levels in (1, 5, 9, 12):
        got = _launched(K10.COUNTS, "merkle_subtree_roots", lambda: K10.merkle_subtree_roots(leaves, levels))
        assert torch.equal(got, K10.merkle_subtree_roots_plain(leaves, levels))
    fold = leaves_np
    while fold.shape[0] > 1:
        fold = _hashlib_rows(fold.reshape(-1, 64))
    assert K10.subtree_root(leaves)[0].cpu().numpy().tobytes() == fold[0].tobytes()


@pytest.mark.parametrize("depth", range(1, 21))
def test_merkle_subtree_root_at_every_size(cuda, depth):
    """K10's root of 2^1 .. 2^20 leaves in one launch (from 2^11 leaves
    the run's last block reduces its blocks' roots), equal to its plain
    version and to a hashlib fold; twice, so that a launch after another
    finds the run's count at 0 again."""
    from lighthouse_tpu_torch.ops import merkle_sharded as K10

    leaves_np = np.random.default_rng(80 + depth).integers(0, 256, (1 << depth, 32), dtype=np.uint8)
    leaves = torch.from_numpy(leaves_np).to(cuda)
    for _ in range(2):
        got = _launched(K10.COUNTS, "merkle_subtree_roots", lambda: K10.subtree_root(leaves))
        assert torch.equal(got, K10.merkle_subtree_roots_plain(leaves, depth))
    fold = leaves_np
    while fold.shape[0] > 1:
        fold = _hashlib_rows(fold.reshape(-1, 64))
    assert got[0].cpu().numpy().tobytes() == fold[0].tobytes()


@pytest.mark.parametrize("n", [1, 33, 4096])
def test_wide64_chain_matches_plain_and_host(cuda, n):
    """K11's 64-bit chain at 1, 33 and 4,096 lanes (chip_smoke's
    rlc_chain_edge_case: the scalars 0, 1, 15, 16, 2^63 - 1, 2^63 and
    2^64 - 1, an affine point, an infinity and a point of order 3),
    limb-equal to its plain version and, on up to 37 lanes, to the host's
    pt_mul."""
    from chip_smoke import rlc_chain_edge_case
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, pt_eq, pt_mul

    pts, sc = rlc_chain_edge_case(np.random.default_rng(64 + n), n)
    pt = _g1(pts, cuda)
    k = K2.scalars_to_tensor(sc).to(cuda)
    got = _launched(K2.COUNTS, "g1_scalar_mul_wide64", lambda: K2.scalar_mul_wide64(pt, k))
    assert torch.equal(got, K2.scalar_mul_wide64_plain(pt, k))
    for row, p, s in zip(K2.g1_from_limbs(got[:37].cpu().numpy()), pts, sc):
        assert pt_eq(FQ, row, pt_mul(FQ, p, s))


@pytest.mark.parametrize("n", [1, 37, 300])
def test_wide_ladder_and_ladder_msm_match_plain_and_host(cuda, n):
    from chip_smoke import msm_edge_case
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, msm, pt_eq, pt_mul
    from lighthouse_tpu_torch.ops import fr as K8
    from lighthouse_tpu_torch.ops import msm as K9

    rng = np.random.default_rng(60 + n)
    pts, sc = msm_edge_case(rng, bls_g1_points(rng, n))
    pt = _g1(pts, cuda)
    s = K8.as_i32(K8.fr_to_words(sc)).to(cuda)
    got = _launched(K2.COUNTS, "g1_scalar_mul_wide", lambda: K2.scalar_mul_wide(pt, s))
    assert torch.equal(got, K2.scalar_mul_wide_plain(pt, s))
    for row, p, k in zip(K2.g1_from_limbs(got.cpu().numpy()), pts, sc):
        assert pt_eq(FQ, row, pt_mul(FQ, p, k))
    total = K9.g1_msm_ladder(pt, s)
    assert torch.equal(total, K9.g1_msm_ladder_plain(pt, s))
    assert pt_eq(FQ, K2.g1_from_limbs(total.cpu().numpy())[0], msm(FQ, pts, sc))


@pytest.mark.parametrize("layout", ["thread", "team"])
def test_wide_ladder_layouts_match_plain(cuda, layout):
    """The 256-bit ladder on 45 lanes (the last block part full), on its
    4-lane teams through the wrapper and on the thread layout kept for
    chip_smoke's comparison (bls_g1_scalar_mul_wide_layout): the edge
    scalars of chip_smoke.wide_edge_scalars, an infinity point and a
    point of order 3 among seeded ones, equal to the plain chain and to
    the host's pt_mul."""
    from chip_smoke import fr_scalars, wide_edge_scalars
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, inf, pt_eq, pt_mul
    from lighthouse_tpu_torch.ops import fr as K8

    rng = np.random.default_rng(62)
    pts = bls_g1_points(rng, 45)
    sc = wide_edge_scalars() + fr_scalars(rng, 37)
    pts[9] = inf(FQ)
    pts[10], sc[10] = bls_g1_point_of_order(rng, 3), 3
    pt = _g1(pts, cuda)
    s = K8.as_i32(K8.fr_to_words(sc)).to(cuda)
    if layout == "team":
        got = _launched(K2.COUNTS, "g1_scalar_mul_wide", lambda: K2.scalar_mul_wide(pt, s))
    else:
        got = torch.empty_like(pt)
        K2.LIB.launch("bls_g1_scalar_mul_wide_layout", pt.data_ptr(), s.data_ptr(), got.data_ptr(), 45, 0, device=cuda)
    assert torch.equal(got, K2.scalar_mul_wide_plain(pt, s))
    for row, p, k in zip(K2.g1_from_limbs(got.cpu().numpy()), pts, sc):
        assert pt_eq(FQ, row, pt_mul(FQ, p, k))


def test_msm_table_walk_matches_plain(cuda):
    """K9's table on 37 points (an infinity among them): the doubling walk
    limb-equal to its plain version, and the table after K2's conversion
    equal to the plain one."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, inf
    from lighthouse_tpu_torch.ops import msm as K9

    pts = bls_g1_points(np.random.default_rng(63), 37)
    pts[20] = inf(FQ)
    pt = _g1(pts, cuda)
    jac, flags = _launched(K9.COUNTS, "msm_table", lambda: K9.g1_msm_table_walk(pt))
    want_jac, want_inf = K9.g1_msm_table_walk_plain(pt)
    assert torch.equal(jac, want_jac) and torch.equal(flags, want_inf)
    table = K9.g1_msm_table(pt)
    plain = K9.g1_msm_table_plain(pt)
    assert torch.equal(table.xy, plain.xy) and torch.equal(table.inf, plain.inf)
    assert bool(flags[:, 20].all()) and int(flags.sum()) == K9.WINDOWS


def test_sharded_rlc_g1_on_a_one_rank_nccl_group(cuda, tmp_path):
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, inf, pt_add, pt_eq, pt_mul
    from lighthouse_tpu_torch.ops import bls381_sharded as K11
    from lighthouse_tpu_torch.parallel.mesh import batch_mesh, close_mesh

    rng = np.random.default_rng(70)
    pts = bls_g1_points(rng, 131)
    scalars = bls_scalars(rng, 131)
    mesh = batch_mesh(0, 1, str(tmp_path / "store"), device="cuda")
    try:
        pt = _g1(pts, mesh.device)
        k = K2.scalars_to_tensor(scalars).to(mesh.device)
        before = dict(K2.COUNTS)
        got = K11.sharded_rlc_g1(pt, k, mesh)
        torch.cuda.synchronize()
        assert K2.COUNTS["g1_scalar_mul_wide64"] == before["g1_scalar_mul_wide64"] + 1
        # the shard's 131 terms padded to 256 (two passes), then one rank's sum
        assert K2.COUNTS["g1_segment_sum"] == before["g1_segment_sum"] + 3
        assert torch.equal(got, K11.fold_plain(K11.local_sum_plain(pt, k)))
    finally:
        close_mesh(mesh)
    want = inf(FQ)
    for p, s in zip(pts, scalars):
        want = pt_add(FQ, want, pt_mul(FQ, p, s))
    assert pt_eq(FQ, K2.g1_from_limbs(got.cpu().numpy())[0], want)


def test_dryrun_multichip_on_two_cards(cuda):
    from lighthouse_tpu_torch.entry import dryrun_multichip

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    dryrun_multichip(2, device="cuda", timeout=600)
