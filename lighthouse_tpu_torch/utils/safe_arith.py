"""Checked / saturating uint64 arithmetic for state quantities.

The reference dedicates a whole crate to this (`consensus/safe_arith`):
every balance/epoch computation in `state_processing` routes through
`safe_add`/`safe_sub`/... so an overflow is a typed error at the site of
the bug, not a corrupted state root three stages later. This module is
that crate for the Python reproduction (counterpart of
lighthouse_tpu/utils/safe_arith.py, copied), in two registers:

* **Scalar helpers** (`safe_add`, `safe_sub`, `safe_mul`, `safe_div`,
  `saturating_add`, `saturating_sub`): plain-int u64 arithmetic with an
  explicit range check. Python ints never wrap, but an out-of-range
  intermediate silently flows until `PersistentList._coerce` (or SSZ
  serialization) rejects it far from the bug — these helpers raise
  `ArithError` *at the arithmetic site* instead. Always on: the check is
  one comparison.

* **Vectorized helpers** (`add_u64`, `sub_u64_saturating`, `mul_u64`,
  `div_u64`): numpy uint64 array ops — the epoch-sweep register, where
  wraparound IS silent. In normal mode they are the plain numpy
  expression (one extra function call per whole-registry sweep); under
  `LIGHTHOUSE_TPU_SANITIZE=1` each one proves no lane wrapped (overflow
  by `result < a`, multiplication by exact divide-back, division by a
  zero-divisor scan) and raises `ArithError` through the sanitizer's
  `u64-wrap` violation counter on the first wrapped lane.

Raw `+ - * //` on recognized uint64 state quantities inside
`state_processing/` goes through these helpers (the JAX package's linter
rule `safe-arith` enforces it there).
"""

from __future__ import annotations

U64_MAX = (1 << 64) - 1


class ArithError(ArithmeticError):
    """A checked uint64 operation overflowed, underflowed, or divided
    by zero."""


# ---------------------------------------------------------------------------
# Scalar (Python int) helpers — always checked
# ---------------------------------------------------------------------------


def _check_u64(value: int, op: str, a, b) -> int:
    if not 0 <= value <= U64_MAX:
        raise ArithError(f"u64 {op} out of range: {a} {op} {b} = {value}")
    return value


def safe_add(a: int, b: int) -> int:
    """a + b, raising ArithError past 2**64-1."""
    return _check_u64(int(a) + int(b), "+", a, b)


def safe_sub(a: int, b: int) -> int:
    """a - b, raising ArithError below zero."""
    return _check_u64(int(a) - int(b), "-", a, b)


def safe_mul(a: int, b: int) -> int:
    """a * b, raising ArithError past 2**64-1."""
    return _check_u64(int(a) * int(b), "*", a, b)


def safe_div(a: int, b: int) -> int:
    """a // b, raising ArithError on a zero divisor (the one way integer
    floor division aborts a state transition)."""
    b = int(b)
    if b == 0:
        raise ArithError(f"u64 division by zero: {a} // 0")
    return int(a) // b


def saturating_add(a: int, b: int) -> int:
    """a + b clamped to 2**64-1 (spec saturating_add)."""
    return min(int(a) + int(b), U64_MAX)


def saturating_sub(a: int, b: int) -> int:
    """a - b clamped to zero (the `max(0, a - b)` every balance decrease
    uses, named for what it is)."""
    a, b = int(a), int(b)
    return a - b if a > b else 0


# ---------------------------------------------------------------------------
# Vectorized (numpy uint64) helpers — checked under LIGHTHOUSE_TPU_SANITIZE=1
# ---------------------------------------------------------------------------


def _sanitize_enabled() -> bool:
    from ..analysis.sanitizer import enabled

    return enabled()


def _wrap_violation(op: str, detail: str):
    from ..analysis.sanitizer import violation

    violation("u64-wrap", f"vectorized u64 {op} wrapped: {detail}")


def add_u64(a, b):
    """Elementwise a + b over uint64 arrays/scalars. Sanitize mode proves
    no lane wrapped (a + b < a ⟺ overflow in modular u64)."""
    import numpy as np

    a = np.asarray(a, dtype=np.uint64)
    res = a + np.asarray(b, dtype=np.uint64)
    if _sanitize_enabled():
        wrapped = res < a
        if wrapped.any():
            i = int(np.argmax(wrapped))
            _wrap_violation("add", f"lane {i}")
    return res


def sub_u64_saturating(a, b):
    """Elementwise max(a - b, 0) over uint64 — the epoch sweeps' penalty
    application. Never wraps by construction, in every mode."""
    import numpy as np

    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return np.maximum(a, b) - b


def sub_u64(a, b):
    """Elementwise a - b over uint64. Sanitize mode proves no lane went
    below zero (b > a ⟺ wraparound)."""
    import numpy as np

    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if _sanitize_enabled():
        wrapped = b > a
        if wrapped.any():
            i = int(np.argmax(wrapped))
            _wrap_violation("sub", f"lane {i}")
    return a - b


def mul_u64(a, b):
    """Elementwise a * b over uint64. Sanitize mode proves exactness by
    integer divide-back (res // a == b wherever a != 0 — exact in u64,
    unlike a float bound)."""
    import numpy as np

    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    res = a * b
    if _sanitize_enabled():
        nz = a != 0
        wrapped = nz & (res // np.where(nz, a, np.uint64(1)) != b)
        if wrapped.any():
            i = int(np.argmax(wrapped))
            _wrap_violation("mul", f"lane {i}")
    return res


def div_u64(a, b):
    """Elementwise a // b over uint64. Sanitize mode scans for zero
    divisors first (numpy would emit a warning and produce 0)."""
    import numpy as np

    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if _sanitize_enabled() and not np.all(b):
        i = int(np.argmin(b != 0)) if b.ndim else 0
        _wrap_violation("div", f"zero divisor at lane {i}")
    return a // b
