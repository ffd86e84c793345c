"""Fixed-base windowed scalar multiplication for a reused point.

The signing analog of `curve.g1_gen_mul`'s generator table, generalized to
ANY base point and window width: when many scalars multiply the SAME point
(a committee's attesters all sign one `AttestationData`, so they share one
`hash_to_g2` root), a one-time table of window multiples turns every
subsequent 255-bit ladder into ~`ceil(256/w)` additions with ZERO doublings
— the doublings are paid once, inside the table build's doubling chain.

Costs, in group additions (doublings ≈ additions here):

    build:    rows · (2^(w−1) − 1)  additions  +  rows · w  doublings
    per mul:  ~rows · (1 − 2^−w)   additions          (rows = ⌈257/w⌉ + 1)

versus ~bits/(win+1) additions + bits doublings (~300 group ops) for one
generic `pt_mul` wNAF ladder. `fixed_base_window` picks w from the expected
multiplication count by minimizing the summed cost — at a 3k-strong
committee it lands around w=10 (≈26 additions per signature, ~6× under the
generic ladder); at a handful of scalars it degrades gracefully toward
small windows. Scalar digits reuse `msm._signed_digits` (signed base-2^w
recoding), so only 2^(w−1) entries per row are stored: negative digits add
the negated table point, which is free in Jacobian coordinates.

Results are the exact same group elements `pt_mul` yields (differentially
fuzzed in tests/test_vc_batch.py), so compressed encodings downstream are
bit-identical — the property the VC batch-signing oracle asserts.
"""

from __future__ import annotations

from .curve import FieldOps, batch_inv, inf, is_inf, pt_double, to_affine
from .msm import _signed_digits


def _pt_add_mixed(k: FieldOps, p1, aff):
    """Jacobian `p1` + affine `(x2, y2)` (implicit z2 == 1): the generic
    `pt_add` with every z2 term folded away — 11 field mul/sqr against
    its 16. Same doubled r/v scaling, so the group element (and thus the
    compressed encoding downstream) is identical."""
    x2, y2 = aff
    x1, y1, z1 = p1
    if k.is_zero(z1):
        return (x2, y2, k.one)
    z1z1 = k.sqr(z1)
    u2 = k.mul(x2, z1z1)
    s2 = k.mul(y2, k.mul(z1z1, z1))
    if x1 == u2:
        if y1 == s2:
            return pt_double(k, p1)
        return inf(k)
    h = k.sub(u2, x1)
    i = k.sqr(k.add(h, h))
    j = k.mul(h, i)
    r = k.sub(s2, y1)
    r = k.add(r, r)
    v = k.mul(x1, i)
    x3 = k.sub(k.sub(k.sqr(r), j), k.add(v, v))
    s1j = k.mul(y1, j)
    y3 = k.sub(k.mul(r, k.sub(v, x3)), k.add(s1j, s1j))
    z3 = k.mul(z1, h)
    z3 = k.add(z3, z3)
    return (x3, y3, z3)

# Generic-ladder cost in additions-equivalents (255 doublings + ~51 wNAF
# additions) that the window chooser weighs the table build against.
_GENERIC_LADDER_OPS = 306


def fixed_base_window(expected_muls: int, bits: int = 256) -> int:
    """Window width minimizing build+use additions for `expected_muls`
    multiplications of `bits`-bit scalars against one base."""
    m = max(1, int(expected_muls))
    best_w, best_cost = 2, None
    for w in range(2, 14):
        rows = (bits + 1) // w + 2
        build = rows * ((1 << (w - 1)) - 1) + rows * w
        per_mul = rows * (1.0 - 0.5**w)
        cost = build + m * per_mul
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


class FixedBaseTable:
    """Precomputed window multiples of one base point.

    `tbl[i][j] == (j+1) · 2^(w·i) · base` for j in [0, 2^(w−1)) — exactly
    the rows signed base-2^w digits index. Rows are built along one
    doubling chain (the `_build_gen_table` shape), so the whole table
    costs `rows` short addition runs plus `rows·w` doublings — then the
    whole table is normalized to AFFINE in one Montgomery batch
    inversion, so every `mul` addition is a mixed add (z2 == 1, ~11
    field mul/sqr vs the generic add's 16). The batch inversion is one
    `k.inv` total; at thousands of muls per table the mixed-add saving
    repays it thousands of times over.
    """

    __slots__ = ("k", "window", "_tbl", "_inf_base")

    def __init__(self, k: FieldOps, base, window: int, bits: int = 256):
        if window < 2:
            raise ValueError("fixed-base window must be >= 2")
        self.k = k
        self.window = window
        self._inf_base = is_inf(k, base)
        if self._inf_base:
            self._tbl = None
            return
        half = 1 << (window - 1)
        # +2 rows: one for the top partial window, one for the signed
        # recoding's final carry (digit d == half pushes a carry up)
        rows = (bits + 1) // window + 2
        tbl = []
        chain = base
        for _ in range(rows):
            # one inversion normalizes the row's chain point; every row
            # entry then lands via a MIXED add (11 field ops vs the
            # generic add's 16) — the chain point (j·2^(w·i)·base) can be
            # infinity only for an out-of-subgroup base; fall back to an
            # all-None row there (`mul` treats None digits as no-ops,
            # exactly what adding infinity would have done)
            ca = to_affine(k, chain)
            if ca is None:
                tbl.append([None] * half)
            else:
                row = [(ca[0], ca[1], k.one)]
                for _ in range(half - 1):
                    row.append(_pt_add_mixed(k, row[-1], ca))
                tbl.append(row)
            for _ in range(window):
                chain = pt_double(k, chain)
        # normalize every entry to affine with ONE batch inversion. For
        # a prime-order base no entry is infinity ((j+1)·2^(w·i) < r).
        flat = [pt for row in tbl for pt in row]
        nz = [
            i
            for i, pt in enumerate(flat)
            if pt is not None and not k.is_zero(pt[2])
        ]
        invs = batch_inv(k, [flat[i][2] for i in nz])
        aff = [None] * len(flat)
        for i, zi in zip(nz, invs):
            x, y, _z = flat[i]
            zi2 = k.sqr(zi)
            aff[i] = (k.mul(x, zi2), k.mul(y, k.mul(zi2, zi)))
        self._tbl = [
            aff[r * half : (r + 1) * half] for r in range(rows)
        ]

    def mul(self, n: int):
        """[n]·base — table lookups + mixed additions only, no doublings."""
        k = self.k
        if n < 0:
            raise ValueError("fixed-base scalar must be non-negative")
        acc = inf(k)
        if n == 0 or self._inf_base:
            return acc
        tbl = self._tbl
        for i, d in enumerate(_signed_digits(n, self.window)):
            if d == 0:
                continue
            e = tbl[i][d - 1] if d > 0 else tbl[i][-d - 1]
            if e is None:
                continue
            if d < 0:
                e = (e[0], k.neg(e[1]))
            acc = _pt_add_mixed(k, acc, e)
        return acc


def fixed_base_worthwhile(expected_muls: int, bits: int = 256) -> bool:
    """True when build+use under the chosen window beats independent
    generic ladders — the batch signer's per-group strategy switch."""
    m = max(1, int(expected_muls))
    w = fixed_base_window(m, bits)
    rows = (bits + 1) // w + 2
    build = rows * ((1 << (w - 1)) - 1) + rows * w
    return build + m * rows * (1.0 - 0.5**w) < m * _GENERIC_LADDER_OPS
