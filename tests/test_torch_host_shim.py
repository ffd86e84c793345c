"""K2's warp-team G1 ladder, K2's batch conversions to affine, K2's
segment sums, K4's warp-team subgroup check, K9's 256-bit ladder (its
signed-window chain on its teams and on the thread layout), K11's 64-bit
chain (the same teams over 17 windows), K9's table (the doubling walk,
then K2's conversion to affine) and K10's subtree kernel (thread
subtrees, warp shuffles, the last block of a run), built as host C++
through the shim of lighthouse_tpu_torch.analysis.host_shim (a block's
threads as std::threads, __syncwarp and __syncthreads as barriers,
__shfl_down_sync through a slot a thread, the blocks one after another),
against their plain PyTorch versions on the CPU: limb for limb (the
ladders, the conversions, the sums), byte for byte (the table, the
Merkle roots, also against hashlib), verdict for verdict (the check).
This runs the kernels' own team and block code, branches and barriers on
the CPU; the card's run is tests/test_torch_gpu.py's. Skips only where
there is no g++.
"""

import concurrent.futures
import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import (
    bls_g1_point_of_order,
    bls_g1_points,
    bls_g2_points,
    bls_scalars,
    bls_segment_rows,
    bls_twist_point_of_order,
    bls_twist_point_outside_subgroup,
    fr_scalars,
    wide_edge_scalars,
)
from lighthouse_tpu_torch.analysis import host_shim
from lighthouse_tpu_torch.crypto.bls12_381 import FQ, FQ2, inf, to_affine
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import bls381_pairing as K4
from lighthouse_tpu_torch.ops import fr as K8
from lighthouse_tpu_torch.ops import merkle_sharded as K10
from lighthouse_tpu_torch.ops import msm as K9


@pytest.fixture(scope="module")
def shim_libs(tmp_path_factory):
    if host_shim.gxx() is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("host_shim")
    sources = {"g": "bls381_g.cu", "pairing": "bls381_pairing.cu", "msm": "msm.cu", "merkle": "merkle_subtree.cu"}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda s: host_shim.build(s, out), sources.values())))
    return {
        "g": host_shim.load(built["g"], K2.LIB.functions),
        "pairing": host_shim.load(built["pairing"], K4.LIB.functions),
        "msm": host_shim.load(built["msm"], K9.LIB.functions),
        "merkle": host_shim.load(built["merkle"], K10.LIB.functions),
    }


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_g1_team_ladder_matches_plain(shim_libs):
    """8 lanes: the edge scalars 0, 1, 2, 2^63 and 2^64 - 1 on Jacobian
    points (Z != 1), a random scalar on an affine point (Z = 1), on an
    infinity input and on a point of order 3 (the team addition's P == Q,
    P == -Q and infinity cases)."""
    rng = np.random.default_rng(21)
    pts = bls_g1_points(rng, 6)
    pts[5] = (*to_affine(FQ, pts[5]), 1)
    pts += [inf(FQ), bls_g1_point_of_order(rng, 3)]
    ks = [0, 1, 2, 2**63, 2**64 - 1] + bls_scalars(rng, 3)
    p = torch.from_numpy(K2.g1_to_limbs(pts))
    k = K2.scalars_to_tensor(ks)
    want = K2.scalar_mul_plain("g1", p, k)
    for team in (1, 0):
        out = torch.zeros_like(p)
        lib = shim_libs["g"]
        assert host_shim.call(lib.bls_g1_scalar_mul_layout, p.data_ptr(), k.data_ptr(), out.data_ptr(), len(ks), team, None) == 0
        assert torch.equal(out, want), f"layout team={team}"


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize(
    "n, infinity",
    [
        (1, ()),
        # one block: infinity lanes at its first, middle and last lane
        (33, (0, 16, 32)),
        # three blocks of 64 lanes, the second all infinity, the third
        # two lanes long
        (130, (0, *range(64, 128))),
    ],
)
def test_to_affine_batch_inversion_matches_plain(shim_libs, group, n, infinity):
    """The batch conversion (one inversion a block of 64 lanes) on
    Jacobian points (Z != 1), with infinity lanes (Z = 0: 1 in the
    block's products, (0, 0) out) and, past one lane, an affine point
    (Z = 1), limb-equal to to_affine_plain's lane-by-lane inverses."""
    F = FQ if group == "g1" else FQ2
    rng = np.random.default_rng(23)
    pts = (bls_g1_points if group == "g1" else bls_g2_points)(rng, min(n, 8))
    pts = (pts * n)[:n]
    if n > 1:
        pts[1] = (*to_affine(F, pts[1]), F.one)
    for j in infinity:
        pts[j] = inf(F)
    p = torch.from_numpy((K2.g1_to_limbs if group == "g1" else K2.g2_to_limbs)(pts))
    out = torch.full((n, 2, *p.shape[2:]), -1, dtype=torch.int64)
    fn = getattr(shim_libs["g"], f"bls_{group}_to_affine")
    assert host_shim.call(fn, p.data_ptr(), out.data_ptr(), n, None) == 0
    assert torch.equal(out, K2.to_affine_plain(group, p))
    for j in infinity:
        assert not out[j].any(), f"infinity lane {j} is not (0, 0)"


def test_g2_team_subgroup_check_matches_plain(shim_libs):
    """6 points: two in G2, one outside it, twist points of order 13 and
    23 (the |x|-ladder meets infinity on them), and a q_inf lane."""
    rng = np.random.default_rng(22)
    affs = [to_affine(FQ2, q) for q in bls_g2_points(rng, 2)]
    affs += [bls_twist_point_outside_subgroup(rng), bls_twist_point_of_order(rng, 13), bls_twist_point_of_order(rng, 23)]
    affs += [(FQ2.one, FQ2.one)]
    q = torch.from_numpy(K2.fq_to_limbs([v for a in affs for c in a for v in c]).reshape(-1, 2, 2, 12))
    q_inf = torch.tensor([False] * 5 + [True])
    ok = torch.zeros(6, dtype=torch.bool)
    lib = shim_libs["pairing"]
    assert host_shim.call(lib.bls_g2_subgroup_check, q.data_ptr(), q_inf.data_ptr(), ok.data_ptr(), 6, None) == 0
    assert ok.tolist() == [True, True, False, False, False, True]
    assert torch.equal(ok, K4.g2_subgroup_check_plain(q, q_inf))


@pytest.mark.parametrize(
    "group, case, n, k, pads",
    [
        # k = 128: the first level on threads (affine, mixed and general
        # additions, a doubling, P + (-P), pads), then six team levels
        ("g1", "edge", 0, 128, 8),
        # short segments: every level on teams; k = 1 and 2
        ("g1", "affine", 3, 8, 2),
        ("g1", "jacobian", 2, 1, 0),
        ("g1", "jacobian", 2, 2, 0),
        # a pubkey row as the verifier stages it, long enough to split into
        # four blocks of 128 and a second pass over their roots
        ("g1", "affine", 1, 512, 24),
        # G2 (sub-segments of 8, so [n, 32] takes two passes): the edge
        # rows, the verifier's row (nb = _pow2(n) with the last lanes
        # padded), and three passes over 128 points
        ("g2", "edge", 0, 32, 5),
        ("g2", "jacobian", 1, 32, 5),
        ("g2", "jacobian", 1, 128, 3),
    ],
)
def test_segment_sum_matches_plain(shim_libs, group, case, n, k, pads):
    """The segment sums (sub-segments a block, a thread or a team an
    addition, the affine first level, a second pass over the blocks'
    roots) limb-equal to segment_sum_plain's tree, in every case of
    pt_add (chip_smoke.bls_segment_rows). The scratch is the plan's
    size, one sentinel point past it left as it was; the plan's passes
    are the blocks' spans' (G1 128 points, G2 8)."""
    pts = torch.from_numpy(bls_segment_rows(np.random.default_rng(24), group, case, n, k, pads))
    rows = pts.shape[0]
    passes, scratch = K2.segment_sum_plan(shim_libs["g"], group, rows, k)
    span, want = {"g1": 128, "g2": 8}[group], 1
    while k > span:
        k, want = k // span, want + 1
    assert passes == want
    out = torch.full((rows, *pts.shape[2:]), -1, dtype=torch.int64)
    buf = torch.full((scratch + 1, *pts.shape[2:]), -7, dtype=torch.int64)
    fn = getattr(shim_libs["g"], f"bls_{group}_segment_sum")
    assert host_shim.call(fn, pts.data_ptr(), buf.data_ptr(), out.data_ptr(), rows, pts.shape[1], None) == 0
    assert torch.equal(out, K2.segment_sum_plain(group, pts))
    assert buf[scratch].eq(-7).all()


def _wide_lanes():
    """40 lanes: wide_edge_scalars on Jacobian points (Z != 1); an affine
    point (Z = 1); an infinity point under a seeded scalar, 1 and 0; a
    point of order 3 under 3 (its table's 3P and the chain's P == -Q give
    infinities), 4, 2^251 and a seeded scalar (P == Q and P == -Q meet in
    the additions); seeded scalars on the rest."""
    rng = np.random.default_rng(25)
    n = 40
    pts = bls_g1_points(rng, n)
    sc = wide_edge_scalars() + fr_scalars(rng, n - 8)
    pts[8] = (*to_affine(FQ, pts[8]), 1)
    for j, k in zip((9, 10, 11), (sc[9], 1, 0)):
        pts[j], sc[j] = inf(FQ), k
    p3 = bls_g1_point_of_order(rng, 3)
    for j, k in zip((12, 13, 14, 15), (3, 4, 1 << 251, sc[15])):
        pts[j], sc[j] = p3, k
    return torch.from_numpy(K2.g1_to_limbs(pts)), K8.as_i32(K8.fr_to_words(sc))


@pytest.fixture(scope="module")
def wide_plain():
    pts, words = _wide_lanes()
    return pts, words, K2.scalar_mul_wide_plain(pts, words)


@pytest.mark.parametrize("layout", ["thread", "team"])
def test_wide_ladder_matches_plain(shim_libs, wide_plain, layout):
    """K9's 256-bit ladder, the signed-window chain (Booth digits of 4 bits
    from the words, a table of 1 P .. 8 P, 4 doublings and one signed
    addition a window) on its 4-lane teams (bls_g1_scalar_mul_wide: their
    own masks, 8 a block, the last block part full) and on the thread
    layout kept for comparison (bls_g1_scalar_mul_wide_layout, blocks of
    32), limb-equal to the plain chain at the edge lanes of _wide_lanes;
    every infinity out canonical."""
    pts, words, want = wide_plain
    lib = shim_libs["g"]
    out = torch.full_like(pts, -1)
    args = (pts.data_ptr(), words.data_ptr(), out.data_ptr(), pts.shape[0])
    if layout == "team":
        assert host_shim.call(lib.bls_g1_scalar_mul_wide, *args, None) == 0
    else:
        assert host_shim.call(lib.bls_g1_scalar_mul_wide_layout, *args, 0, None) == 0
    assert torch.equal(out, want)
    infinity = ~out[:, 2].any(-1)
    assert infinity[[1, 9, 10, 11, 12]].all()  # k = 0, an infinity point, 3 P3
    assert torch.equal(out[infinity], torch.from_numpy(K2.g1_to_limbs([inf(FQ)] * int(infinity.sum()))))


@pytest.mark.parametrize("n", [9, 17])
def test_msm_table_walk_and_affine_match_plain(shim_libs, n):
    """K9's table on 9 and 17 points (two and three blocks of 8 teams, the
    last part full): the doubling walk on 4-lane teams (Jacobian
    2^(8w) P_i and the infinity flags) limb-equal to its plain version,
    then K2's batch conversion to affine over its 32n entries, byte-equal
    to g1_msm_table_plain; an infinity point, an affine point (Z = 1) and
    a point of order 3 among them."""
    rng = np.random.default_rng(26)
    pts = bls_g1_points(rng, n)
    pts[2] = inf(FQ)
    pts[5] = (*to_affine(FQ, pts[5]), 1)
    pts[7] = bls_g1_point_of_order(rng, 3)
    p = torch.from_numpy(K2.g1_to_limbs(pts))
    jac = torch.full((K9.WINDOWS, n, 3, 12), -1, dtype=torch.int64)
    flags = torch.zeros((K9.WINDOWS, n), dtype=torch.bool)
    walk = shim_libs["msm"].msm_g1_table_walk
    assert host_shim.call(walk, p.data_ptr(), jac.data_ptr(), flags.data_ptr(), n, None) == 0
    want_jac, want_inf = K9.g1_msm_table_walk_plain(p)
    assert torch.equal(jac, want_jac) and torch.equal(flags, want_inf)
    xy = torch.full((K9.WINDOWS * n, 2, 12), -1, dtype=torch.int64)
    assert host_shim.call(shim_libs["g"].bls_g1_to_affine, jac.data_ptr(), xy.data_ptr(), K9.WINDOWS * n, None) == 0
    want = K9.g1_msm_table_plain(p)
    assert torch.equal(xy.view(K9.WINDOWS, n, 2, 12), want.xy)
    assert torch.equal(flags, want.inf)
    assert flags[:, 2].all() and flags.sum() == K9.WINDOWS


def test_wide64_chain_matches_plain(shim_libs):
    """K11's 64-bit chain (bls_g1_scalar_mul_wide64: [n] int64 draws read
    unsigned, 17 windows, K9's 4-lane teams, 8 a block) on 45 lanes (the
    last block part full): the scalars 0, 1, 15, 16, 2^63 - 1, 2^63 and
    2^64 - 1 on Jacobian points (Z != 1), an affine point (Z = 1), an
    infinity point under a seeded draw, a point of order 3 under 3, 4 and
    2^63 + 1 (its table's 3 P and the chain's P == Q, P == -Q), seeded draws
    on the rest; limb-equal to the plain chain, every infinity out
    canonical."""
    rng = np.random.default_rng(27)
    n = 45
    pts = bls_g1_points(rng, n)
    sc = [0, 1, 15, 16, 2**63 - 1, 2**63, 2**64 - 1] + bls_scalars(rng, n - 7)
    pts[7] = (*to_affine(FQ, pts[7]), 1)
    pts[8] = inf(FQ)
    p3 = bls_g1_point_of_order(rng, 3)
    for j, k in zip((9, 10, 11), (3, 4, 2**63 + 1)):
        pts[j], sc[j] = p3, k
    p = torch.from_numpy(K2.g1_to_limbs(pts))
    k = K2.scalars_to_tensor(sc)
    out = torch.full_like(p, -1)
    lib = shim_libs["g"]
    assert host_shim.call(lib.bls_g1_scalar_mul_wide64, p.data_ptr(), k.data_ptr(), out.data_ptr(), n, None) == 0
    assert torch.equal(out, K2.scalar_mul_wide64_plain(p, k))
    infinity = ~out[:, 2].any(-1)
    assert infinity[[0, 8, 9]].all()  # k = 0, an infinity point, 3 P3
    assert torch.equal(out[infinity], torch.from_numpy(K2.g1_to_limbs([inf(FQ)] * int(infinity.sum()))))


def _hashlib_root(leaves: np.ndarray) -> bytes:
    nodes = [row.tobytes() for row in leaves]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest() for i in range(0, len(nodes), 2)]
    return nodes[0]


def _merkle_launch(lib, leaves: np.ndarray, levels: int, leaf: int, threads: int) -> np.ndarray:
    """K10's launcher over runs of 2^levels leaves with this plan: the
    block roots' scratch at its size with a sentinel row past it, the run
    counts left as garbage (the launcher zeroes them)."""
    m = leaves.shape[0]
    runs = m >> levels
    blocks_per_run = (1 << (levels - leaf)) // threads
    out = np.full((runs, 32), 0xEE, dtype=np.uint8)
    roots = np.full((runs * blocks_per_run + 1, 32), 0x5A, dtype=np.uint8)
    counters = np.full(runs, 7, dtype=np.uint32)
    args = (leaves.ctypes.data, out.ctypes.data, roots.ctypes.data, counters.ctypes.data, m, levels, leaf, threads, None)
    assert host_shim.call(lib.merkle_subtree_roots, *args) == 0
    assert (roots[-1] == 0x5A).all(), "a block root past the scratch"
    return out


@pytest.mark.parametrize("depth", range(1, 13))
def test_merkle_subtree_roots_match_plain_and_hashlib(shim_libs, depth):
    """K10's kernel on 2^1 .. 2^12 leaves with the wrapper's plan
    (merkle_sharded.subtree_plan: at these depths a pair a thread, up to
    256 threads a block; from 2^10 the last of 2, 4 or 8 blocks reduces
    their roots): one root, byte-equal to the plain version and to a
    hashlib fold."""
    leaves = np.random.default_rng(30 + depth).integers(0, 256, (1 << depth, 32), dtype=np.uint8)
    got = _merkle_launch(shim_libs["merkle"], leaves, depth, *K10.subtree_plan(depth))
    want = K10.merkle_subtree_roots_plain(torch.from_numpy(leaves), depth).numpy()
    assert np.array_equal(got, want)
    assert got[0].tobytes() == _hashlib_root(leaves)


@pytest.mark.parametrize(
    "levels, leaf, threads",
    [
        # a thread's 16 leaves (four groups of four, the binary counter's
        # merges), 8 blocks a run; the last block 4 roots a thread
        (12, 4, 8),
        (12, 4, 64),
        # 8 and 4 leaves a thread; the last block 2, 16 and 1 roots a thread
        (12, 3, 16),
        (12, 2, 8),
        (12, 2, 32),
        # blocks narrower than a warp, one block a run: runs side by side
        (6, 4, 4),
        (7, 3, 16),
        (8, 4, 4),
        # the last block of 64 threads over 64 roots: its levels in shared
        # memory, then warp 0; 2 runs of 2^12
        (12, 1, 64),
        (13, 1, 64),
        # the wrapper's 512 threads a block, four levels in shared memory
        (13, 1, 512),
    ],
)
def test_merkle_subtree_plans_match_plain(shim_libs, levels, leaf, threads):
    """Other plans than the wrapper's, on 2^13 leaves (one run or several),
    to reach each path of the kernel: the thread subtrees of 4, 8 and 16
    nodes, the last block's own subtrees of block roots, warps of fewer
    than 32 threads, levels in shared memory. Each run's root byte-equal
    to the plain version and to hashlib."""
    leaves = np.random.default_rng(40 + levels).integers(0, 256, (1 << 13, 32), dtype=np.uint8)
    got = _merkle_launch(shim_libs["merkle"], leaves, levels, leaf, threads)
    want = K10.merkle_subtree_roots_plain(torch.from_numpy(leaves), levels).numpy()
    assert np.array_equal(got, want)
    assert got[-1].tobytes() == _hashlib_root(leaves[-(1 << levels) :])


def test_merkle_subtree_refuses_plans_it_cannot_run(shim_libs):
    """cudaErrorInvalidValue (1), and no launch, for a plan outside the
    kernel: no leaf level or more than 4, more levels a thread than a run
    has, threads not a power of two or above 512 or above the run's,
    more than 16 block roots a thread for the last block, more than 30
    levels, nodes not whole runs."""
    lib = shim_libs["merkle"]
    leaves = np.zeros((1 << 13, 32), dtype=np.uint8)
    for nodes, levels, leaf, threads in [
        (8192, 12, 0, 8),
        (8192, 12, 5, 8),
        (8192, 2, 3, 1),
        (8192, 12, 2, 3),
        (8192, 12, 2, 1024),
        (8192, 12, 3, 1024),
        (8192, 12, 4, 1),
        (1 << 25, 25, 4, 256),
        (1 << 31, 31, 4, 512),
        (8192 - 16, 12, 2, 8),
    ]:
        assert lib.merkle_subtree_roots(leaves.ctypes.data, None, None, None, nodes, levels, leaf, threads, None) == 1


def test_replaced_merkle_levels_kernel_matches_plain(shim_libs):
    """The kernel K10's replaced (merkle_subtree_levels, kept for
    chip_smoke.py's comparison: 9 levels a launch in shared memory) on
    2^12 leaves in runs of 2^9 and 2^3, byte-equal to the plain version."""
    leaves = np.random.default_rng(50).integers(0, 256, (1 << 12, 32), dtype=np.uint8)
    for levels in (9, 3):
        out = np.zeros((leaves.shape[0] >> levels, 32), dtype=np.uint8)
        lib = shim_libs["merkle"]
        assert host_shim.call(lib.merkle_subtree_levels, leaves.ctypes.data, out.ctypes.data, 1 << 12, levels, None) == 0
        assert np.array_equal(out, K10.merkle_subtree_roots_plain(torch.from_numpy(leaves), levels).numpy())
