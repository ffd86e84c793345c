"""BLS12-381 scalar field Fr and the KZG evaluation kernels (K8).

Counterpart of lighthouse_tpu/ops/fr.py. Its kernels, ``csrc/kzg_fr.cu``
over the Fr arithmetic of ``csrc/fr.cuh`` and ``csrc/mont_cs.cuh``,
replace the JAX package's ``barycentric_eval_batch`` (:156), p_j(z_j) for
a batch of blobs in evaluation form, and ``quotient_batch`` (:189), the
opening quotient (p_i - y) / (w_i - z); the field operations ``fr_mul/add/sub/inv``
(:78-102) are device code inside them, with no launch of their own (as
K3), and their plain versions are here.

Layout. Fr is 8 little-endian 32-bit limbs in Montgomery form with
R = 2^256 (the JAX package's R; JAX holds 32 8-bit limbs). At the kernels'
edges values are canonical: a blob's 32-byte big-endian field elements as
8 32-bit words, most significant first (``words_from_bytes`` only
reinterprets the bytes), and the results leave in the same form. The
domain is resident in Montgomery limbs (``mont_limbs``). Tensors hold the
32-bit words and limbs in int32 (bit patterns).

Dispatch is by the tensor's device: a CUDA tensor goes to the kernel
(built with nvcc at first use), a CPU tensor to the plain PyTorch version
(``*_plain``). A failed build or launch raises.

The plain versions work on 16 16-bit limbs in int64 with the generic
convolution and carry of ops/bls381.py. The barycentric one follows its
kernel's method (a fraction and a plain sum per blob, one inverse per
blob); the quotient's inverts per lane with Fermat's a^(r-2), where its
kernel takes one batch inversion per block of lanes: the outputs are
canonical field elements, so both give the same words.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls12_381.fields import R as FR_MOD
from .bls381 import _carry, _conv
from .cuda_build import CudaLibrary

NLIMB_FR = 8
R_MONT_FR = 1 << 256
_W = 16  # 16-bit limbs of the plain versions
_M16 = 0xFFFF
_U32 = 0xFFFFFFFF
# threads of a barycentric block (csrc/kzg_fr.cu BARY_THREADS): the
# kernel's scratch holds an (N, D, S0) triple per block, at most
# ceil(n / 256) blocks a blob
BARY_THREADS = 256
# Lanes of the plain barycentric version per step on the card (bounds its
# temporaries: a product of L lanes holds L * 16 * 32 int64).
_PLAIN_LANES = 1 << 16

# Kernel launches, counted where each kernel launches and nowhere else;
# the barycentric ones also by the number of blobs a launch covers.
COUNTS = {"barycentric_eval": 0, "quotient": 0}
BARYCENTRIC_BY_BLOBS: dict[int, int] = {}

LIB = CudaLibrary(
    "kzg_fr.cu",
    {
        "kzg_barycentric": ("p", "p", "p", "p", "p", "i64", "i32", "p"),
        "kzg_quotient": ("p", "p", "p", "p", "p", "i64", "p"),
    },
)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    BARYCENTRIC_BY_BLOBS.clear()


# ---------------------------------------------------------------------------
# Host <-> words and limbs
# ---------------------------------------------------------------------------

_MOD_WORDS = np.frombuffer(FR_MOD.to_bytes(32, "big"), ">u4").astype(np.uint32)


def words_from_bytes(data: bytes, count: int) -> np.ndarray:
    """`count` 32-byte big-endian elements -> [count, 8] uint32 words, most
    significant first (the bytes reinterpreted, nothing reduced)."""
    return np.frombuffer(data, ">u4", count=8 * count).astype(np.uint32).reshape(count, 8)


def canonical(words: np.ndarray) -> np.ndarray:
    """Per element ([..., 8] words): is it below r? Compared at the first
    word that differs from r's."""
    diff = words != _MOD_WORDS
    first = diff.argmax(axis=-1)
    w = np.take_along_axis(words, first[..., None], -1)[..., 0]
    return diff.any(axis=-1) & (w < _MOD_WORDS[first])


def fr_to_words(values) -> np.ndarray:
    """Ints in [0, r) -> [n, 8] uint32 canonical words."""
    buf = b"".join(int(v).to_bytes(32, "big") for v in values)
    return words_from_bytes(buf, len(buf) // 32)


def fr_from_words(arr) -> list[int]:
    """[..., 8] canonical words (any integer dtype holding 32-bit
    patterns) -> ints."""
    raw = np.ascontiguousarray(np.asarray(arr).reshape(-1, 8).astype(np.uint32)).astype(">u4").tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "big") for i in range(len(raw) // 32)]


def mont_limbs(values) -> np.ndarray:
    """Ints -> [n, 8] uint32 Montgomery limbs, least significant first."""
    buf = b"".join((v * R_MONT_FR % FR_MOD).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, "<u4").astype(np.uint32).reshape(-1, 8)


def limbs_to_ints(arr) -> list[int]:
    """[..., 8] Montgomery limbs -> the field ints they represent."""
    raw = np.ascontiguousarray(np.asarray(arr).reshape(-1, 8).astype(np.uint32)).astype("<u4").tobytes()
    rinv = pow(R_MONT_FR, -1, FR_MOD)
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") * rinv % FR_MOD for i in range(len(raw) // 32)]


def as_i32(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> an int32 tensor of the same bit patterns (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# The plain versions' field core: [..., 16] int64 16-bit limbs
# ---------------------------------------------------------------------------


def _limbs16(v: int) -> list[int]:
    return [(v >> (16 * i)) & _M16 for i in range(_W)]


_CONSTS: dict = {}


def consts(dev: torch.device) -> dict:
    """Constant 16-bit limb tensors on `dev` (built once per device)."""
    k = _CONSTS.get(dev)
    if k is None:
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa: E731
        rr = [_M16] * _W
        rr[0] += 1  # 2^256 as limbs of at least 0xFFFF: a - b + rr >= 0 limb by limb
        k = {
            "r": t(_limbs16(FR_MOD)),
            "nprime": t(_limbs16((-pow(FR_MOD, -1, R_MONT_FR)) % R_MONT_FR)),
            "rbar": t(_limbs16(R_MONT_FR - FR_MOD)),
            "pow2": t(rr),
            "one": t(_limbs16(R_MONT_FR % FR_MOD)),
            "r2": t(_limbs16(R_MONT_FR * R_MONT_FR % FR_MOD)),
            "unit": t(_limbs16(1)),
        }
        _CONSTS[dev] = k
    return k


def _cond_sub(u: torch.Tensor) -> torch.Tensor:
    """Exact limbs of a value in [0, 2r) -> its residue in [0, r)."""
    w = _carry(u + consts(u.device)["rbar"], _W + 1, 1 << 17)
    return torch.where(w[..., _W:] > 0, w[..., :_W], u)


def _pick(v: torch.Tensor, bound: int) -> torch.Tensor:
    """v = stack(x, x - r + 2^256) of limbs below `bound`, for x in
    [0, 2r): x mod r, both carried in one pass."""
    w = _carry(v, _W + 1, bound)
    return torch.where(w[1, ..., _W:] > 0, w[1, ..., :_W], w[0, ..., :_W])


def fr_mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod r of reduced inputs."""
    k = consts(a.device)
    t = _conv(a, b, 2 * _W - 1)  # coefficients < 16 * 2^32
    # m = -t/r mod R; any m of that residue below 2^256 (1 + 2^-16) will do
    m = _carry(_conv(t[..., :_W], k["nprime"], _W), _W, 16 * 16 * 2**50, exact=False)
    s = _carry(t + _conv(m, k["r"], 2 * _W - 1), 2 * _W, 2**40)
    return _cond_sub(s[..., _W:])  # (t + m r)/R < 1.91 r


def fr_add16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return _pick(torch.stack((s, s + consts(s.device)["rbar"])), 1 << 18)


def fr_sub16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + r if a < b else a - b."""
    k = consts(a.device)
    d = a - b + k["pow2"]  # a - b + 2^256
    return _pick(torch.stack((d + k["r"], d)), 3 << 16)


def fr_inv16(a: torch.Tensor) -> torch.Tensor:
    """a^(r-2) from the top bit of r - 2, as the JAX package's fr_inv; 0 -> 0."""
    acc = a
    for bit in bin(FR_MOD - 2)[3:]:
        acc = fr_mul16(acc, acc)
        if bit == "1":
            acc = fr_mul16(acc, a)
    return acc


def to16(x: torch.Tensor) -> torch.Tensor:
    """[..., 8] 32-bit limbs (int64) -> [..., 16] 16-bit limbs."""
    return torch.stack((x & _M16, x >> 16), dim=-1).flatten(-2)


def to32(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0::2] | (x[..., 1::2] << 16)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & _U32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def words_to_mont16(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] canonical big-endian words (int32) -> [..., 16] Montgomery
    16-bit limbs: fr_ld_be, then a product by R^2 (the kernels' z)."""
    return fr_mul16(to16(_u32(words).flip(-1)), consts(words.device)["r2"])


def mont16_to_words(a: torch.Tensor) -> torch.Tensor:
    """[..., 16] Montgomery limbs -> [..., 8] canonical words (int32): a
    product by 1, then fr_st_be."""
    return _i32(to32(fr_mul16(a, consts(a.device)["unit"].expand_as(a))).flip(-1))


# Public plain Fr ops on [..., 8] Montgomery limbs in int64 (the JAX
# module's names)


def fr_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(fr_mul16(to16(a), to16(b)))


def fr_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(fr_add16(to16(a), to16(b)))


def fr_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(fr_sub16(to16(a), to16(b)))


def fr_inv(a: torch.Tensor) -> torch.Tensor:
    return to32(fr_inv16(to16(a)))


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def _frac_tree16(num: torch.Tensor, den: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum over axis 1 of the fractions num / den ([m, n, 16] each, n a
    power of two) as one fraction: a/b + c/d = (ad + cb) / bd."""
    while num.shape[1] > 1:
        h = num.shape[1] // 2
        a, c, b, d = num[:, :h], num[:, h:], den[:, :h], den[:, h:]
        num = fr_add16(fr_mul16(a, d), fr_mul16(c, b))
        den = fr_mul16(b, d)
    return num[:, 0], den[:, 0]


def _sum_tree16(v: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of [m, n, 16] (n a power of two)."""
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = fr_add16(v[:, :h], v[:, h:])
    return v[:, 0]


def _r_over_n16(n: int, dev: torch.device) -> torch.Tensor:
    """The plain integer R / n mod r: a Montgomery product by it turns
    (S / R) (z^n - 1) into y = S (z^n - 1) / n, canonical."""
    return torch.tensor(_limbs16(R_MONT_FR * pow(n, -1, FR_MOD) % FR_MOD), dtype=torch.int64, device=dev)


def barycentric_eval_plain(evals: torch.Tensor, roots: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """evals [m, n, 8] canonical words, roots [n, 8] Montgomery limbs, zs
    [m, 8] canonical words (int32) -> ys [m, 8] canonical words.

    The kernel's method: S = sum p_i w_i / (z - w_i) = z S1 - S0 with
    S1 = sum p_i / (z - w_i) kept as one fraction N/D per blob and
    S0 = sum p_i (the canonical p_i read as Montgomery values, so both
    carry a 1/R); one Fermat inverse of D per blob (0 -> 0: a z on the
    domain gives y = 0), then (z N D^-1 - S0) (z^n - 1) times the plain
    R / n."""
    m, n = evals.shape[0], evals.shape[1]
    dev = evals.device
    k = consts(dev)
    w = to16(_u32(roots))
    z = words_to_mont16(zs)
    step = max(1, _PLAIN_LANES // n)
    nums, dens, sums = [], [], []
    for j in range(0, m, step):
        p = to16(_u32(evals[j : j + step]).flip(-1))
        num, den = _frac_tree16(p, fr_sub16(z[j : j + step, None], w))
        nums.append(num)
        dens.append(den)
        sums.append(_sum_tree16(p))
    if not nums:
        return torch.zeros((0, NLIMB_FR), dtype=torch.int32, device=dev)
    num, den, s0 = torch.cat(nums), torch.cat(dens), torch.cat(sums)
    zn = z
    for _ in range(n.bit_length() - 1):
        zn = fr_mul16(zn, zn)
    s = fr_sub16(fr_mul16(fr_mul16(num, fr_inv16(den)), z), s0)
    y = fr_mul16(s, fr_sub16(zn, k["one"].expand_as(zn)))
    y = fr_mul16(y, _r_over_n16(n, dev).expand_as(y))
    return _i32(to32(y).flip(-1))


def quotient_plain(evals: torch.Tensor, roots: torch.Tensor, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """evals [n, 8] canonical words, roots [n, 8] Montgomery limbs, z and y
    [8] canonical words -> q [n, 8] canonical words, 0 where w_i == z."""
    p = words_to_mont16(evals)
    w = to16(_u32(roots))
    d = fr_sub16(w, words_to_mont16(z).expand_as(w))
    num = fr_sub16(p, words_to_mont16(y).expand_as(p))
    return mont16_to_words(fr_mul16(num, fr_inv16(d)))


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, shape: tuple, name: str) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {list(shape)} int32, got {list(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _cuda_ok(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: need one CUDA device")
    return dev


def barycentric_eval(evals: torch.Tensor, roots: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """y_j = p_j(z_j) = (z_j^n - 1) n^-1 sum_i p_ji w_i / (z_j - w_i).

    evals [m, n, 8] canonical words, roots [n, 8] Montgomery limbs (the
    bit-reversed domain), zs [m, 8] canonical words, all int32; n a power
    of two. A z_j on the domain gives y_j = 0 (the caller answers those
    on the host). Returns ys [m, 8] canonical words."""
    if evals.dim() != 3:
        raise ValueError(f"evals: expected [m, n, 8], got {list(evals.shape)}")
    m, n = evals.shape[0], evals.shape[1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"domain size {n} is not a power of two")
    _check(evals, (m, n, NLIMB_FR), "evals")
    _check(roots, (n, NLIMB_FR), "roots")
    _check(zs, (m, NLIMB_FR), "zs")
    if evals.device.type == "cpu":
        return barycentric_eval_plain(evals, roots, zs)
    dev = _cuda_ok(evals, roots, zs)
    nblk = -(-n // BARY_THREADS)
    partial = torch.empty((max(m, 1), 3 * nblk, NLIMB_FR), dtype=torch.int32, device=dev)
    ys = torch.empty((m, NLIMB_FR), dtype=torch.int32, device=dev)
    if m:
        LIB.launch(
            "kzg_barycentric", evals.data_ptr(), roots.data_ptr(), zs.data_ptr(), partial.data_ptr(),
            ys.data_ptr(), m, n.bit_length() - 1, device=dev,
        )
        COUNTS["barycentric_eval"] += 1
        BARYCENTRIC_BY_BLOBS[m] = BARYCENTRIC_BY_BLOBS.get(m, 0) + 1
    return ys


def quotient(evals: torch.Tensor, roots: torch.Tensor, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """q_i = (p_i - y) / (w_i - z) over the domain, 0 where w_i == z.

    evals [n, 8] canonical words, roots [n, 8] Montgomery limbs, z and y
    [8] canonical words, all int32; any n and any distinct roots (the
    kernel inverts once per block of 128 lanes, not through z^n - 1).
    Returns q [n, 8] canonical words."""
    n = evals.shape[0]
    _check(evals, (n, NLIMB_FR), "evals")
    _check(roots, (n, NLIMB_FR), "roots")
    _check(z, (NLIMB_FR,), "z")
    _check(y, (NLIMB_FR,), "y")
    if evals.device.type == "cpu":
        return quotient_plain(evals, roots, z, y)
    dev = _cuda_ok(evals, roots, z, y)
    q = torch.empty_like(evals)
    if n:
        LIB.launch("kzg_quotient", evals.data_ptr(), roots.data_ptr(), z.data_ptr(), y.data_ptr(), q.data_ptr(), n, device=dev)
        COUNTS["quotient"] += 1
    return q

