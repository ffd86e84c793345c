"""The Altair epoch sweep: flag rewards and penalties, inactivity-score
updates and inactivity penalties in one pass over the registry's columns.

Counterpart of lighthouse_tpu/ops/epoch_sweep.py. Its kernel,
``csrc/epoch_sweep.cu``, replaces that module's jitted ``epoch_sweep``
(line 39 there): the same function, bit for bit, on the same inputs. It is
bound by bytes (66 per validator); the source's header derives that. A
sweep is one cooperative launch of one wave of blocks (`launch_plan`): the
sums, a grid barrier, then the updates, with what the second phase needs
of the first kept in shared memory.

Every u64 quantity is held in an int64 tensor as its bit pattern (torch
has too few uint64 operations). The kernel computes in native unsigned 64
bits; the plain PyTorch version ``epoch_sweep_plain`` repeats its
arithmetic on the bit patterns: additions, subtractions and products wrap
mod 2^64 as int64's do, comparisons flip the sign bit, and division is an
unsigned floor division (``_udiv``), so an epoch of 2^64 - 1
(FAR_FUTURE_EPOCH) or a product of 2^63 or more behaves as in uint64.
Unlike the JAX module, nothing here changes process-wide settings.

Dispatch is by the tensors' device: CUDA tensors go to the kernel (built
with nvcc at first use into ``lighthouse_tpu_torch/build/``), CPU tensors
to the plain version. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import warnings

import numpy as np
import torch

from ..device import resolve_device
from .cuda_build import CudaLibrary

# Altair participation flag weights (TIMELY_SOURCE/TARGET/HEAD)
PARTICIPATION_FLAG_WEIGHTS = (14, 26, 14)
WEIGHT_DENOMINATOR = 64
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

# The [9] scalars, in order (see state_processing/altair.py
# `_device_rewards_and_inactivity`).
SCALARS = (
    "prev_epoch",
    "curr_epoch",
    "base_reward_per_increment",
    "total_active_increments",
    "in_leak",
    "score_bias",
    "score_recovery",
    "inactivity_denom",
    "effective_balance_increment",
)

LIB = CudaLibrary(
    "epoch_sweep.cu",
    {
        "epoch_sweep": ("p",) * 12 + ("i64", "i32", "i32", "i64", "i64", "p"),
        "epoch_sweep_limits": ("i32", "i64", "p"),
        "epoch_sweep_two_pass": ("p",) * 12 + ("i64", "p"),
    },
)

# Kernel launches, counted where each launches and nowhere else: the
# sweep's cooperative kernel (one a sweep), and the replaced two-kernel
# sweep (`epoch_sweep_two_pass`, run only to compare).
COUNTS = {"launches": 0, "two_pass": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# The cooperative launch's shape: THREADS a block, BLOCKS_PER_SM blocks an
# SM, tiles starting on TILE_ALIGN validators. A kept validator takes
# KEPT_BYTES of dynamic shared memory (its effective balance and a byte of
# bits); SHARED_RESERVED is the shared memory the card reserves a block.
THREADS = 512
BLOCKS_PER_SM = 2
TILE_ALIGN = 32
KEPT_BYTES = 9
SHARED_RESERVED = 1024


# The [n] columns, in the kernel's argument order, and their numpy types.
COLUMNS = (
    "effective_balance",
    "slashed",
    "activation_epoch",
    "exit_epoch",
    "withdrawable_epoch",
    "prev_flags",
    "scores",
    "balances",
)
_NP_DTYPES = {k: np.uint64 for k in COLUMNS}
_NP_DTYPES.update(slashed=np.bool_, prev_flags=np.uint8)
_SIGN = -(1 << 63)
_MASK63 = (1 << 63) - 1
_MASK64 = (1 << 64) - 1


_DTYPES = {k: torch.int64 for k in COLUMNS}
_DTYPES.update(slashed=torch.bool, prev_flags=torch.uint8)


def _check(cols: dict, scalars: torch.Tensor) -> int:
    n = cols["effective_balance"].shape[0]
    dev = cols["effective_balance"].device
    for name, dtype in _DTYPES.items():
        t = cols[name]
        if t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name}: expected [{n}] {dtype}, got {list(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous tensors on one device ({dev})")
    if scalars.dtype != torch.int64 or scalars.shape != (len(SCALARS),) or scalars.device != dev:
        raise ValueError(f"scalars: expected [{len(SCALARS)}] int64 on {dev}")
    return n


# ---------------------------------------------------------------------------
# The plain PyTorch version (the kernel's arithmetic on int64 bit patterns)
# ---------------------------------------------------------------------------


def _i64(v: int) -> int:
    """The int64 bit pattern of a u64 value."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """a < b as u64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _umax(a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(_ult(a, b), b, a)


def _umin(a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(_ult(b, a), b, a)


def _udiv(x: torch.Tensor, d: int) -> torch.Tensor:
    """floor(x / d) as u64, x a tensor of u64 bit patterns, d a u64 int > 0."""
    d &= _MASK64
    if d == 0:
        raise ZeroDivisionError("epoch sweep: division by zero")
    if d >> 63:  # d >= 2^63: the quotient is 0 or 1
        return (~_ult(x, _i64(d))).to(torch.int64)
    h = (x >> 1) & _MASK63  # x / 2, as a nonnegative int64
    q1 = torch.div(h, d, rounding_mode="floor")
    r = ((h - q1 * d) << 1) | (x & 1)  # x - 2*q1*d, in [0, 2d): wraps only as u64
    return (q1 << 1) + (~_ult(r, d)).to(torch.int64)


def epoch_sweep_plain(
    effective_balance, slashed, activation_epoch, exit_epoch, withdrawable_epoch,
    prev_flags, scores, balances, scalars,
):
    """The sweep in plain PyTorch on the inputs' own device: int64 tensors
    of u64 bit patterns (bool `slashed`, uint8 `prev_flags`), [9] int64
    scalars. Returns (new_balances, new_scores)."""
    cols = dict(zip(COLUMNS, (
        effective_balance, slashed, activation_epoch, exit_epoch, withdrawable_epoch,
        prev_flags, scores, balances,
    )))
    _check(cols, scalars)
    s = dict(zip(SCALARS, (v & _MASK64 for v in scalars.tolist())))
    prev = _i64(s["prev_epoch"])
    in_leak = s["in_leak"] != 0
    inc = s["effective_balance_increment"]
    eb = effective_balance

    active = ~_ult(prev, activation_epoch) & _ult(torch.full_like(eb, prev), exit_epoch)
    eligible = active | (slashed & _ult(torch.full_like(eb, _i64(s["prev_epoch"] + 1)), withdrawable_epoch))
    base_rewards = _udiv(eb, inc) * _i64(s["base_reward_per_increment"])
    reward_denom = (s["total_active_increments"] * WEIGHT_DENOMINATOR) & _MASK64

    zero = torch.zeros_like(eb)
    rewards = torch.zeros_like(eb)
    penalties = torch.zeros_like(eb)
    participating = []
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        part = (((prev_flags >> flag_index) & 1) == 1) & ~slashed & active
        participating.append(part)
        total = int(torch.where(part, eb, zero).sum()) & _MASK64
        upb_increments = max(total, inc) // inc
        if not in_leak:
            numer = base_rewards * weight * _i64(upb_increments)
            rewards = rewards + torch.where(eligible & part, _udiv(numer, reward_denom), zero)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            missed = eligible & ~part
            penalties = penalties + torch.where(
                missed, _udiv(base_rewards * weight, WEIGHT_DENOMINATOR), zero
            )

    target = participating[TIMELY_TARGET_FLAG_INDEX]
    new_scores = scores - torch.where(eligible & target, _umin(scores, 1), zero)
    new_scores = new_scores + torch.where(eligible & ~target, _i64(s["score_bias"]), 0)
    if not in_leak:
        recovery = _i64(s["score_recovery"])
        new_scores = new_scores - torch.where(eligible, _umin(new_scores, recovery), zero)
    inactive = eligible & ~target
    penalties = penalties + torch.where(
        inactive, _udiv(eb * new_scores, s["inactivity_denom"]), zero
    )

    new_balances = balances + rewards
    new_balances = _umax(new_balances, penalties) - penalties
    return new_balances, new_scores


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def sweep_plan(n: int, max_grid: int, threads: int, keep_cap: int, keep: int | None = None) -> tuple:
    """(grid, tile, keep) of the cooperative sweep over n validators: at
    most `max_grid` blocks (the card's one wave), no more than n needs at
    `threads` a block, each a tile of validators starting on TILE_ALIGN,
    the first `keep` of each tile kept in shared memory (at most
    `keep_cap`, or `keep` where given, to force the re-read)."""
    grid = max(1, min(max_grid, -(-n // threads)))
    tile = -(-(-(-n // grid)) // TILE_ALIGN) * TILE_ALIGN
    grid = max(1, -(-n // max(tile, 1)))  # no block left without validators
    return grid, tile, min(tile, keep_cap if keep is None else keep)


def _limits(dev: torch.device, threads: int, shared: int) -> tuple:
    """(blocks an SM holds, static shared bytes, shared bytes a block may
    have, an SM's) for the kernel at `threads` and `shared` kept bytes."""
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(dev):
        err = LIB.load().epoch_sweep_limits(threads, shared, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"epoch_sweep_limits failed with CUDA error {err}")
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _shaped_plan(dev: torch.device, n: int, threads: int, blocks_per_sm: int, keep: int | None = None) -> tuple:
    """(grid, threads, tile, keep) of the cooperative sweep over n
    validators on `dev`: one wave of `blocks_per_sm` blocks of `threads`
    an SM (fewer where the card holds fewer), each keeping as many
    validators as its share of the SM's shared memory holds, or `keep`."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, static, optin, per_sm = _limits(dev, threads, 0)
    for bps in range(blocks_per_sm, 0, -1):
        budget = min(optin, per_sm // bps - SHARED_RESERVED) - static
        grid, tile, k = sweep_plan(n, sms * bps, threads, budget // KEPT_BYTES, keep)
        if grid <= sms * _limits(dev, threads, KEPT_BYTES * k)[0]:
            return grid, threads, tile, k
    raise RuntimeError(f"epoch sweep: no block of {threads} threads fits an SM")


def launch_plan(dev: torch.device, n: int) -> tuple:
    """(grid, threads, tile, keep) of the sweep's launch over n validators
    on `dev`: BLOCKS_PER_SM blocks of THREADS an SM, in one wave."""
    return _shaped_plan(dev, n, THREADS, BLOCKS_PER_SM)


def _launch(cols: dict, scalars: torch.Tensor, plan: tuple | None = None):
    """The one launch site of the sweep's kernel: one cooperative launch
    on the card, shaped by `launch_plan`, or by `plan` ((grid, threads,
    tile, keep), from `_shaped_plan`) where a comparison gives one."""
    n = _check(cols, scalars)
    dev = cols["effective_balance"].device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    grid, threads, tile, keep = plan or launch_plan(dev, n)
    # one allocation: the two results, then the [grid][3] partial sums
    out = torch.empty(2 * n + 3 * grid, dtype=torch.int64, device=dev)
    new_balances, new_scores, partials = out[:n], out[n : 2 * n], out[2 * n :]
    LIB.launch(
        "epoch_sweep",
        *(cols[k].data_ptr() for k in COLUMNS),
        scalars.data_ptr(), partials.data_ptr(), new_balances.data_ptr(), new_scores.data_ptr(),
        n, grid, threads, tile, keep,
        device=dev,
    )
    COUNTS["launches"] += 1
    return new_balances, new_scores


def epoch_sweep_two_pass(
    effective_balance, slashed, activation_epoch, exit_epoch, withdrawable_epoch,
    prev_flags, scores, balances, scalars,
):
    """The replaced sweep on CUDA tensors (a memset, a reduction with
    atomics, an elementwise pass that reads the columns again), kept to
    compare with the cooperative kernel. Returns (new_balances, new_scores)."""
    cols = dict(zip(COLUMNS, (
        effective_balance, slashed, activation_epoch, exit_epoch, withdrawable_epoch,
        prev_flags, scores, balances,
    )))
    n = _check(cols, scalars)
    dev = effective_balance.device
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
    sums = torch.empty(3, dtype=torch.int64, device=dev)
    new_balances = torch.empty(n, dtype=torch.int64, device=dev)
    new_scores = torch.empty(n, dtype=torch.int64, device=dev)
    LIB.launch(
        "epoch_sweep_two_pass",
        *(cols[k].data_ptr() for k in COLUMNS),
        scalars.data_ptr(), sums.data_ptr(), new_balances.data_ptr(), new_scores.data_ptr(), n,
        device=dev,
    )
    COUNTS["two_pass"] += 1
    return new_balances, new_scores


def epoch_sweep(
    effective_balance, slashed, activation_epoch, exit_epoch, withdrawable_epoch,
    prev_flags, scores, balances, scalars,
):
    """The sweep on the tensors' device (the kernel on CUDA tensors, the
    plain version on CPU tensors). Types as `epoch_sweep_plain`; returns
    (new_balances, new_scores)."""
    args = (
        effective_balance, slashed, activation_epoch, exit_epoch, withdrawable_epoch,
        prev_flags, scores, balances,
    )
    if effective_balance.device.type == "cpu":
        return epoch_sweep_plain(*args, scalars)
    return _launch(dict(zip(COLUMNS, args)), scalars)


def _to_device(arr: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    """One host-to-device copy of a numpy column (u64 columns as their
    int64 bit patterns). The frozen registry columns are read in place,
    with no host copy first: the tensor aliases the array, and neither the
    copy to the card nor the plain version writes it."""
    arr = np.ascontiguousarray(arr, dtype=dtype)
    if dtype == np.uint64:
        arr = arr.view(np.int64)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(arr).to(dev)


def sweep_tensors(columns: dict, scalars: np.ndarray, device=None) -> tuple:
    """The sweep's arguments on `device` (or the default one) from numpy
    `columns` (COLUMNS: [n] uint64, bool `slashed`, uint8 `prev_flags`) and
    [9] uint64 `scalars`: each copied there once."""
    dev = resolve_device(device)
    return tuple(_to_device(columns[k], _NP_DTYPES[k], dev) for k in COLUMNS) + (
        _to_device(scalars, np.uint64, dev),
    )


def sweep_results(out: tuple) -> tuple:
    """The sweep's (new_balances, new_scores) tensors as [n] uint64 numpy
    arrays: each copied to the host once."""
    return tuple(t.cpu().numpy().view(np.uint64) for t in out)


def epoch_sweep_arrays(columns: dict, scalars: np.ndarray, device=None):
    """The sweep over numpy columns on `device` or the default one, in
    three steps: the columns go there once (`sweep_tensors`), the sweep
    (`epoch_sweep`), and the two results come back once (`sweep_results`).
    Returns (new_balances, new_scores) as [n] uint64 arrays."""
    return sweep_results(epoch_sweep(*sweep_tensors(columns, scalars, device)))
