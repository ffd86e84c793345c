"""Host Pippenger (bucketed) multi-scalar multiplication for G1 and G2.

Computes Σ [sᵢ]·Pᵢ over any `curve.FieldOps` group in windows of c bits:
per window, points fall into buckets by digit, each bucket is summed with
ONE addition per member, and the running-sum trick recovers Σ d·bucket_d
without any scalar multiplications. Cost is roughly

    ceil(bits/c) · (n + 2^(c−1)) additions  +  bits doublings

against n·(bits/(w+1) + bits) for n independent wNAF ladders — the same
asymptotic blst's Pippenger path gives the reference's batch verifier
(blst's `p1s_mult_pippenger` under `verify_multiple_aggregate_signatures`).
For the RLC batch-verify shape (n = 1024, 64-bit scalars) that is ~10k
group ops instead of ~80k.

Two standard refinements, both differentially fuzzed against the wNAF
oracle (`msm_naive`) in tests/test_msm.py:

* **signed digits**: window digits are recoded into [−2^(c−1), 2^(c−1)]
  with carry propagation, so only 2^(c−1) buckets per window are needed
  (negative digits add the negated point — negation is free in Jacobian
  coordinates);
* **sparse buckets**: buckets live in a dict, so windows where few digits
  land (small n, clustered scalars) skip the empty-bucket walk's additions
  (`pt_add` with an infinity operand is an O(1) early return).

This module is the host seam a future Pallas MSM kernel slots behind: the
entry point is shape-agnostic (`points`/`scalars` lists, any FieldOps), and
`parallel/host_pool` shards it by splitting the sum Σ [sᵢ]Pᵢ into per-worker
slices that the caller adds back together.
"""

from __future__ import annotations

from .curve import FieldOps, inf, is_inf, pt_add, pt_double, pt_mul, pt_neg


def window_size(n: int, bits: int) -> int:
    """Pick the window width c minimizing the Pippenger addition count
    ceil(bits/c)·(n + 2^(c−1)) for n points of `bits`-bit scalars."""
    best_c, best_cost = 1, None
    for c in range(1, 17):
        cost = -(-bits // c) * (n + (1 << (c - 1)))
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def _signed_digits(s: int, c: int) -> list:
    """Base-2^c digits of s recoded into [−2^(c−1), 2^(c−1)], LSB first.
    The carry keeps Σ dᵢ·2^(ci) == s exactly."""
    half, full = 1 << (c - 1), 1 << c
    digits = []
    while s:
        d = s & (full - 1)
        if d > half:
            d -= full
        digits.append(d)
        s = (s - d) >> c
    return digits


def msm_naive(k: FieldOps, points, scalars):
    """Σ [sᵢ]·Pᵢ as n independent wNAF ladders — the pre-Pippenger cost
    model and the differential oracle the bucketed path is fuzzed against."""
    acc = inf(k)
    for p, s in zip(points, scalars, strict=True):
        acc = pt_add(k, acc, pt_mul(k, p, s))
    return acc


def msm(k: FieldOps, points, scalars, window: int | None = None):
    """Σ [sᵢ]·Pᵢ via signed-digit bucketed Pippenger.

    Accepts Jacobian points (infinity included), any-sign any-size integer
    scalars, and duplicate points; returns a Jacobian point. `window`
    overrides the size heuristic (tests sweep it). Batches too small for
    bucketing to pay for itself fall through to the wNAF oracle.
    """
    pts, ss = [], []
    for p, s in zip(points, scalars, strict=True):
        if s == 0 or is_inf(k, p):
            continue
        if s < 0:
            p, s = pt_neg(k, p), -s
        pts.append(p)
        ss.append(s)
    if not pts:
        return inf(k)
    if window is None and len(pts) < 8:
        return msm_naive(k, pts, ss)

    bits = max(s.bit_length() for s in ss)
    c = window if window is not None else window_size(len(pts), bits)
    digit_rows = [_signed_digits(s, c) for s in ss]
    n_windows = max(len(row) for row in digit_rows)

    result = inf(k)
    for w in range(n_windows - 1, -1, -1):
        if not is_inf(k, result):
            for _ in range(c):
                result = pt_double(k, result)
        buckets: dict = {}
        for row, p in zip(digit_rows, pts):
            if w >= len(row) or not row[w]:
                continue
            d = row[w]
            q = p if d > 0 else pt_neg(k, p)
            idx = abs(d)
            cur = buckets.get(idx)
            buckets[idx] = q if cur is None else pt_add(k, cur, q)
        if not buckets:
            continue
        # running-sum trick: Σ_d d·bucket_d with 2·|range| additions
        acc = inf(k)
        total = inf(k)
        for idx in range(max(buckets), 0, -1):
            b = buckets.get(idx)
            if b is not None:
                acc = pt_add(k, acc, b)
            total = pt_add(k, total, acc)
        result = pt_add(k, result, total)
    return result
