"""K7's cooperative sweep (csrc/epoch_sweep.cu `epoch_sweep`) and the
sweep it replaced (`epoch_sweep_two_pass`), built as host C++ through the
shim of lighthouse_tpu_torch.analysis.host_shim and held byte for byte to
`epoch_sweep_plain` on the CPU. A cooperative launch runs every thread of
its grid at once, each block with its own shared memory, and the grid
barrier is one std::barrier of them all: so this runs the kernel's two
phases, its per-block partial sums, its grid barrier, its shared-memory
keep and the re-read past it, and its multiply-high reciprocals, on the
card's branches. Tolerance: exact equality of u64 bit patterns. Skips only
where there is no g++. No test starts more than 512 threads.
"""

import numpy as np
import pytest
import torch

from chip_smoke import epoch_sweep_inputs
from lighthouse_tpu_torch.analysis import host_shim
from lighthouse_tpu_torch.ops import epoch_sweep as k7

FAR = 2**64 - 1
SENTINEL = -0x5A5A5A5A5A5A5A5B  # a bit pattern no output or partial sum takes here


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if host_shim.gxx() is None:
        pytest.skip("needs g++")
    so = host_shim.build("epoch_sweep.cu", tmp_path_factory.mktemp("host_shim_k7"))
    return host_shim.load(so, k7.LIB.functions)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cooperative(lib, args: tuple, grid: int, threads: int, tile: int, keep: int) -> tuple:
    """The launcher on CPU tensors, its partials and outputs filled with a
    sentinel first: (rc, new_balances, new_scores)."""
    n = args[0].shape[0]
    partials = torch.full((3 * max(grid, 1),), SENTINEL, dtype=torch.int64)
    out = [torch.full((n,), SENTINEL, dtype=torch.int64) for _ in range(2)]
    rc = host_shim.call(
        lib.epoch_sweep, *(t.data_ptr() for t in args), partials.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), n, grid, threads, tile, keep, None,
    )
    return rc, *out


def _assert_equal_to_plain(got: tuple, args: tuple) -> None:
    rc, balances, scores = got
    assert rc == 0
    want = k7.epoch_sweep_plain(*args)
    assert torch.equal(balances, want[0]), "new balances differ"
    assert torch.equal(scores, want[1]), "new scores differ"


@pytest.mark.parametrize("leak", [False, True])
@pytest.mark.parametrize(
    "n, max_grid, threads, keep",
    [
        # four blocks of 64 threads, tiles of 96: the last holds 12
        (300, 4, 64, None),
        # one validator, one warp
        (1, 1, 32, None),
        # 40 of each tile kept, the rest re-read (a tile is 96: a thread's
        # batch runs across the keep's edge)
        (300, 4, 64, 40),
        # nothing kept; eight blocks of 64 threads, 512 threads at once
        (1000, 8, 64, 0),
        # the keep ends mid-warp, on a partial last tile
        (1000, 8, 64, 77),
    ],
)
def test_cooperative_sweep_matches_plain(lib, leak, n, max_grid, threads, keep):
    """The edge rows of `epoch_sweep_inputs` (FAR_FUTURE_EPOCH epochs,
    slashed validators withdrawable ahead and behind, penalties above the
    balance, effective_balance * score of 2^63 and more), out of the leak
    and in it, through `sweep_plan`'s tiles."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(n + 7 * leak), max(n, 128), leak)
    cols = {k: v[:n] for k, v in cols.items()}
    args = k7.sweep_tensors(cols, scalars, "cpu")
    grid, tile, kept = k7.sweep_plan(n, max_grid, threads, 1 << 20, keep)
    assert grid == max_grid and grid * tile >= n and n - (grid - 1) * tile < tile
    _assert_equal_to_plain(_cooperative(lib, args, grid, threads, tile, kept), args)


def _divisor_inputs(d: int) -> tuple:
    """64 active validators whose divisions meet the reciprocals' edges at
    divisor d: the increment and the inactivity denominator are d, the
    reward denominator total_active_increments * 64 the multiple of 64
    nearest below d (64 at least; it cannot be odd). Effective balances 0,
    d - 1, d, 2^64 - 1, 2d - 1 (and 2d, mod 2^64) and random words; with a
    score of 1, no bias and no recovery, each eligible validator that
    missed the target divides its own effective balance by d again."""
    rng = np.random.default_rng(d % (1 << 32))
    n = 64
    eb = rng.integers(0, FAR, n, dtype=np.uint64, endpoint=True)
    edges = [0, d - 1, d, FAR, (2 * d - 1) % 2**64, (2 * d) % 2**64]
    eb[: len(edges)] = edges
    eb[32 : 32 + len(edges)] = edges
    flags = np.zeros(n, np.uint8)
    flags[32:] = rng.integers(0, 8, 32).astype(np.uint8)
    flags[32 : 32 + len(edges)] = 7
    cols = {
        "effective_balance": eb,
        "slashed": np.zeros(n, np.bool_),
        "activation_epoch": np.zeros(n, np.uint64),
        "exit_epoch": np.full(n, FAR, np.uint64),
        "withdrawable_epoch": np.full(n, FAR, np.uint64),
        "prev_flags": flags,
        "scores": np.ones(n, np.uint64),
        "balances": rng.integers(0, FAR, n, dtype=np.uint64, endpoint=True),
    }
    tai = max(1, d >> 6)
    scalars = np.array([10, 11, 3, tai, 0, 0, 0, d, d], np.uint64)
    return cols, scalars


@pytest.mark.parametrize("d", [1, 2, 3, 2**26, 10**9, 2**63, 2**63 + 1, 2**64 - 1])
def test_cooperative_sweep_divisor_edges(lib, d):
    """Granlund-Montgomery's reciprocals exact at the divisors 1, 2, 3,
    2^26, 10^9, 2^63, 2^63 + 1 and 2^64 - 1, on numerators 0, d - 1, d and
    2^64 - 1 where the inputs carry them, and on random words: two blocks
    of 32 threads."""
    cols, scalars = _divisor_inputs(d)
    args = k7.sweep_tensors(cols, scalars, "cpu")
    grid, tile, keep = k7.sweep_plan(64, 2, 32, 1 << 20)
    _assert_equal_to_plain(_cooperative(lib, args, grid, threads=32, tile=tile, keep=keep), args)


@pytest.mark.parametrize("leak", [False, True])
def test_replaced_two_pass_sweep_matches_plain(lib, leak):
    """The replaced sweep (a memset, a reduction with atomics, the
    elementwise pass) on the edge rows, over 300 validators."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(11 + leak), 300, leak)
    args = k7.sweep_tensors(cols, scalars, "cpu")
    sums = torch.full((3,), SENTINEL, dtype=torch.int64)
    out = [torch.full((300,), SENTINEL, dtype=torch.int64) for _ in range(2)]
    rc = host_shim.call(
        lib.epoch_sweep_two_pass, *(t.data_ptr() for t in args), sums.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), 300, None,
    )
    _assert_equal_to_plain((rc, *out), args)


@pytest.mark.parametrize(
    "grid, threads, tile, keep",
    [
        (2, 64, 128, 0),  # 256 validators cannot cover 300
        (4, 64, 96, 97),  # keeps more than its tile
        (4, 48, 96, 96),  # not a whole number of warps
        (4, 2048, 96, 96),  # more threads than a block may have
        (0, 64, 96, 96),  # no block
    ],
)
def test_cooperative_sweep_refuses_shapes_it_cannot_run(lib, grid, threads, tile, keep):
    """A shape that does not cover n, or a block the card cannot run, is
    refused (cudaErrorInvalidValue) before anything runs."""
    cols, scalars = epoch_sweep_inputs(np.random.default_rng(2), 300, False)
    rc, balances, scores = _cooperative(lib, k7.sweep_tensors(cols, scalars, "cpu"), grid, threads, tile, keep)
    assert rc == 1
    assert bool((balances == SENTINEL).all()) and bool((scores == SENTINEL).all())


@pytest.mark.parametrize("n", [0, 1, 31, 33, 4097, 1 << 20, 3_500_000])
@pytest.mark.parametrize("max_grid, threads", [(132, 1024), (264, 512), (528, 256)])
def test_sweep_plan_covers_every_validator(n, max_grid, threads):
    """`sweep_plan`'s tiles cover n with at most one wave of blocks, start
    on TILE_ALIGN validators, and keep no more than a tile or the cap."""
    cap = 12_743
    grid, tile, keep = k7.sweep_plan(n, max_grid, threads, cap)
    assert 1 <= grid <= max_grid and grid * tile >= n
    assert tile % k7.TILE_ALIGN == 0 and (grid - 1) * tile < max(n, 1)
    assert keep == min(tile, cap)
    assert k7.sweep_plan(n, max_grid, threads, cap, keep=5)[2] == min(tile, 5)


def test_shared_declarations_rewritten_per_declarator():
    """The shim's rewrite of shared declarations: one reference a
    declarator (alignment dropped: the shim's storage is 64-byte aligned),
    and the dynamic buffer as a pointer."""
    src = (
        "  __shared__ fr sn[A], sd[A][2], one;\n"
        "  __shared__ __align__(16) unsigned char dig[B];\n"
        "  extern __shared__ __align__(16) unsigned char kept[];\n"
        "  // __shared__ in a comment stays\n"
    )
    got = host_shim.rewrite_shared(src).splitlines()
    assert got[0] == (
        "  auto& sn = shim_shared<fr[A]>(0); auto& sd = shim_shared<fr[A][2]>(1);"
        " auto& one = shim_shared<fr>(2);"
    )
    assert got[1] == "  auto& dig = shim_shared<unsigned char[B]>(3);"
    assert got[2] == "  unsigned char* kept = reinterpret_cast<unsigned char*>(shim_dynamic_shared());"
    assert got[3] == "  // __shared__ in a comment stays"
