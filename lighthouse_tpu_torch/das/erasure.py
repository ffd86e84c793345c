"""Erasure coding for PeerDAS data columns: pure Fr polynomial math.

A blob is p's evaluations over the size-n bit-reversed root-of-unity
domain (crypto/kzg layout). Extension re-evaluates the SAME degree-<n
polynomial over the doubled domain: the even points of the 2n-domain are
exactly the n-domain, and bit-reversal maps them onto the FIRST half of
the extended vector — so `extend_evals(blob)[:n] == blob` and the second
half is pure parity. Cells slice the extended vector into
NUMBER_OF_COLUMNS contiguous (bit-reversed-order) runs; each run is a
multiplicative coset of the order-(2n/columns) subgroup in natural
order, which is what makes recovery cheap: the vanishing polynomial of
any set of missing COLUMNS is a product of binomials (x^fe − a_i), never
a dense degree-4096 interpolation.

`recover_extended` is the c-kzg `recover_cells_and_kzg_proofs` shape:
  Z := vanishing poly of the missing positions (sparse, via the coset
       structure); (p·Z) recovered on-domain from the known evals (Z is
       zero exactly where evals are unknown); the quotient (p·Z)/Z is
       formed on a SHIFTED coset where Z has no roots; un-shifting gives
       p's coefficients, re-evaluating gives the full extended vector —
       bit-identical to the original for any >=50% column subset.

Everything here is host bigint Fr math riding `crypto/kzg.fft_fr`; no
group operations, no metrics, no locks — safe to call from fork-pool
workers.
"""

from __future__ import annotations

from functools import lru_cache

from ..crypto.bls12_381.fields import R as FR_MOD
from ..crypto.kzg import _bit_reverse_permute, _root_of_unity, fft_fr


class ErasureError(ValueError):
    pass


#: coset shift for the quotient domain: the primitive root mod r — its
#: order is r-1, so s^(2n) != 1 and the shifted domain avoids every root
#: of unity where Z could vanish
_SHIFT = 7


def _rev_bits(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


@lru_cache(maxsize=8)
def ext_roots_brp(n2: int) -> tuple:
    """The doubled domain in bit-reversed order (cell j's points are the
    contiguous slice [j*fe, (j+1)*fe))."""
    w2 = _root_of_unity(n2)
    natural = [pow(w2, i, FR_MOD) for i in range(n2)]
    return tuple(_bit_reverse_permute(natural))


def extend_evals(evals_brp: list[int]) -> list[int]:
    """n bit-reversed evals -> 2n bit-reversed evals of the same
    polynomial over the doubled domain; the first n entries are the
    input, bit-exact."""
    n = len(evals_brp)
    if n & (n - 1):
        raise ErasureError("blob length must be a power of two")
    coeffs = fft_fr(_bit_reverse_permute(list(evals_brp)), inverse=True)
    ext_natural = fft_fr(coeffs + [0] * n)
    return _bit_reverse_permute(ext_natural)


def cells_from_extended(ext_brp: list[int], columns: int) -> list[list[int]]:
    """Slice the extended vector into `columns` cells (bit-reversed
    contiguous runs — natural-order cosets)."""
    n2 = len(ext_brp)
    if n2 % columns:
        raise ErasureError("columns must divide the extended length")
    fe = n2 // columns
    return [ext_brp[j * fe : (j + 1) * fe] for j in range(columns)]


def column_natural_positions(column: int, columns: int, n2: int) -> list[int]:
    """Natural-order domain indices covered by one column: the stride-
    `columns` progression offset by rev(column) — a multiplicative coset."""
    bits = (columns - 1).bit_length()
    off = _rev_bits(column, bits)
    return [m * columns + off for m in range(n2 // columns)]


def _batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one modexp for the whole list."""
    prefix = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        if x == 0:
            raise ErasureError("batch inversion of zero")
        prefix[i + 1] = prefix[i] * x % FR_MOD
    inv_all = pow(prefix[-1], FR_MOD - 2, FR_MOD)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % FR_MOD
        inv_all = inv_all * xs[i] % FR_MOD
    return out


def _vanishing_coeffs(missing: list[int], columns: int, n2: int) -> list[int]:
    """Coefficients (length n2, degree fe*|missing|) of the polynomial
    vanishing on every missing column's coset: prod (x^fe - a_i) with
    a_i = w2^(fe * rev(column)) — a dense product only in y = x^fe."""
    fe = n2 // columns
    bits = (columns - 1).bit_length()
    w2 = _root_of_unity(n2)
    # product of binomials (y - a_i), built iteratively in y
    zy = [1]
    for col in missing:
        a = pow(w2, fe * _rev_bits(col, bits), FR_MOD)
        nxt = [0] * (len(zy) + 1)
        for k, c in enumerate(zy):
            nxt[k + 1] = (nxt[k + 1] + c) % FR_MOD
            nxt[k] = (nxt[k] - c * a) % FR_MOD
        zy = nxt
    coeffs = [0] * n2
    for k, c in enumerate(zy):
        coeffs[k * fe] = c
    return coeffs


def recover_extended(known: dict[int, list[int]], columns: int) -> list[int]:
    """Reconstruct the full 2n bit-reversed extended vector from any
    >=50% subset of columns. `known` maps column index -> that column's
    fe Fr values (bit-reversed slice order). Raises ErasureError if the
    subset is insufficient or the data is not consistent with one
    degree-<n polynomial."""
    if not known:
        raise ErasureError("no columns supplied")
    fe = len(next(iter(known.values())))
    n2 = fe * columns
    half = n2 // 2
    for col, vals in known.items():
        if not 0 <= col < columns or len(vals) != fe:
            raise ErasureError(f"malformed column {col}")
    if len(known) * fe < half:
        raise ErasureError(
            f"need >= {columns // 2} columns to recover, have {len(known)}"
        )
    missing = [c for c in range(columns) if c not in known]
    ext = [0] * n2
    for col, vals in known.items():
        for k, pos in enumerate(column_natural_positions(col, columns, n2)):
            ext[pos] = vals[_rev_pos_in_cell(k, fe)]
    if not missing:
        return _bit_reverse_permute(ext)
    z_coeffs = _vanishing_coeffs(missing, columns, n2)
    z_evals = fft_fr(z_coeffs)
    ez = [e * z % FR_MOD for e, z in zip(ext, z_evals)]
    # (p*Z) has degree < n + n2/2 <= n2: the on-domain products determine
    # it exactly, no wraparound
    ez_coeffs = fft_fr(ez, inverse=True)
    s_pows = [1] * n2
    for k in range(1, n2):
        s_pows[k] = s_pows[k - 1] * _SHIFT % FR_MOD
    pz_coset = fft_fr([c * s % FR_MOD for c, s in zip(ez_coeffs, s_pows)])
    z_coset = fft_fr([c * s % FR_MOD for c, s in zip(z_coeffs, s_pows)])
    z_inv = _batch_inv(z_coset)
    q_coset = [a * b % FR_MOD for a, b in zip(pz_coset, z_inv)]
    q_scaled = fft_fr(q_coset, inverse=True)
    s_inv = pow(_SHIFT, FR_MOD - 2, FR_MOD)
    si_pows = [1] * n2
    for k in range(1, n2):
        si_pows[k] = si_pows[k - 1] * s_inv % FR_MOD
    p_coeffs = [c * s % FR_MOD for c, s in zip(q_scaled, si_pows)]
    if any(p_coeffs[half:]):
        raise ErasureError(
            "recovered polynomial exceeds the blob degree — the supplied "
            "columns are not one blob's erasure coding"
        )
    return _bit_reverse_permute(fft_fr(p_coeffs))


def _rev_pos_in_cell(k: int, fe: int) -> int:
    """Natural position m within a coset maps to bit-reversed offset
    rev(m) inside the cell slice (cells are contiguous in brp order)."""
    return _rev_bits(k, (fe - 1).bit_length())
