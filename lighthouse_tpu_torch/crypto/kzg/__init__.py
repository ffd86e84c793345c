"""KZG polynomial commitments for Deneb blobs (EIP-4844).

Counterpart of lighthouse_tpu/crypto/kzg (which mirrors
crypto/kzg/src/lib.rs, a wrapper over c-kzg): `blob_to_kzg_commitment`,
`compute_kzg_proof`, `compute_blob_kzg_proof`, `verify_kzg_proof`,
`verify_blob_kzg_proof`, `verify_blob_kzg_proof_batch`, plus
trusted-setup loading.

Everything is in **evaluation form** over the bit-reversed roots-of-unity
domain, exactly like c-kzg: a blob IS the vector of p(w_i) evaluations, the
commitment is one MSM against the Lagrange-basis setup points, openings use
the barycentric formula, and quotients are computed pointwise on the domain
(no FFT on the hot path). A radix-2 NTT over Fr is provided for
monomial↔evaluation conversions (`fft_fr`).

Trusted setup: the standard JSON format loads via `TrustedSetup.from_json`.
The mainnet ceremony output ships beside this file as `trusted_setup.json`
(byte-identical to the JAX package's copy and to the reference's
common/eth2_network_config/built_in_network_configs/trusted_setup.json —
the published output of the public EIP-4844 KZG ceremony, a constants
table that must be bit-exact to be correct) and `TrustedSetup.default()`
loads it; set `LIGHTHOUSE_TPU_TRUSTED_SETUP` to override. Tests and the dev
chain use `TrustedSetup.insecure_dev(n)` — a deterministic tau (NOT secret,
never for production) that yields a fully functional scheme. Generated
setups are disk-cached under lighthouse_tpu_torch/build/ (uncompressed
affine ints; instant reload).

Engines. `Kzg(setup, device=None)` runs its engine on
`device.default_device()`: on the card the K8 kernels (ops/fr.py: the
barycentric evaluation and the opening quotient), the K9 Pippenger MSM
(ops/msm.py) and the K4 multi-pairing (ops/bls381_pairing.py); on the
`cpu` device the same calls run those kernels' plain versions. With the
device `cuda` and no card, construction raises. `device=False` keeps the
JAX package's host bigint engine (the oracle). There is no fallback from
the card to the host: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

from ..bls12_381 import FQ, FQ2, G1_GEN, G2_GEN, inf, is_inf, pt_add, pt_mul, to_affine
from ..bls12_381.curve import (
    from_affine,
    g1_from_bytes,
    g1_to_bytes,
    g2_from_bytes,
    pt_neg,
)
from ..bls12_381.fields import R as FR_MODULUS
from ..bls12_381.pairing import pairing_check

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = FIELD_ELEMENTS_PER_BLOB * BYTES_PER_FIELD_ELEMENT
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48

# 7 is the smallest primitive root mod r; the 2^32 two-adic subgroup
# generator is 7^((r-1)/2^32).
_PRIMITIVE_ROOT = 7
_TWO_ADICITY = 32

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"


class KzgError(ValueError):
    pass


def _root_of_unity(order: int) -> int:
    assert order & (order - 1) == 0 and order <= (1 << _TWO_ADICITY)
    g = pow(_PRIMITIVE_ROOT, (FR_MODULUS - 1) >> _TWO_ADICITY, FR_MODULUS)
    return pow(g, (1 << _TWO_ADICITY) // order, FR_MODULUS)


def _bit_reverse_permute(xs: list) -> list:
    n = len(xs)
    bits = (n - 1).bit_length()
    return [xs[int(bin(i)[2:].zfill(bits)[::-1], 2)] for i in range(n)]


def fft_fr(coeffs: list[int], inverse: bool = False) -> list[int]:
    """Radix-2 NTT over Fr (monomial ↔ evaluation form on the natural-order
    domain). Used for setup conversion and testing; the blob hot path stays
    in evaluation form."""
    n = len(coeffs)
    assert n & (n - 1) == 0
    w = _root_of_unity(n)
    if inverse:
        w = pow(w, FR_MODULUS - 2, FR_MODULUS)
    a = _bit_reverse_permute(list(coeffs))
    size = 2
    while size <= n:
        step = pow(w, n // size, FR_MODULUS)
        for start in range(0, n, size):
            wk = 1
            for k in range(size // 2):
                lo = a[start + k]
                hi = a[start + k + size // 2] * wk % FR_MODULUS
                a[start + k] = (lo + hi) % FR_MODULUS
                a[start + k + size // 2] = (lo - hi) % FR_MODULUS
                wk = wk * step % FR_MODULUS
        size *= 2
    if inverse:
        n_inv = pow(n, FR_MODULUS - 2, FR_MODULUS)
        a = [x * n_inv % FR_MODULUS for x in a]
    return a


# ---------------------------------------------------------------------------
# Trusted setup
# ---------------------------------------------------------------------------

# the port's git-ignored build directory (ops/cuda_build.BUILD_DIR)
_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"


class TrustedSetup:
    """Lagrange-basis G1 points (bit-reversed domain order, like c-kzg) +
    monomial G2 points [1, tau]·G2 (only tau·G2 is needed for verification).
    """

    def __init__(self, g1_lagrange: list, g2_monomial: list, n: int):
        if len(g1_lagrange) != n or len(g2_monomial) < 2:
            raise KzgError("trusted setup: wrong point counts")
        self.n = n
        self.g1_lagrange = g1_lagrange  # Jacobian host points
        self.g2_monomial = g2_monomial
        # bit-reversed evaluation domain (c-kzg layout)
        w = _root_of_unity(n)
        natural = [pow(w, i, FR_MODULUS) for i in range(n)]
        self.roots_brp = _bit_reverse_permute(natural)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "TrustedSetup":
        """Standard trusted_setup.json: hex g1_lagrange (48B compressed) +
        g2_monomial (96B compressed).

        The file lists the Lagrange points in natural domain order; the
        spec's blob_to_kzg_commitment (and c-kzg on load) takes them
        bit-reversed, the order of `roots_brp`, so they are bit-reversed
        here. The JAX package's loader keeps the file's order, and so its
        ceremony commitments and proofs do not verify (a test states the
        divergence)."""
        with open(path) as f:
            data = json.load(f)
        g1 = _bit_reverse_permute([
            g1_from_bytes(bytes.fromhex(h.removeprefix("0x")))
            for h in data["g1_lagrange"]
        ])
        g2 = [
            g2_from_bytes(bytes.fromhex(h.removeprefix("0x")))
            for h in data["g2_monomial"][:2]
        ]
        return cls(g1, g2, len(g1))

    @classmethod
    def insecure_dev(cls, n: int = FIELD_ELEMENTS_PER_BLOB) -> "TrustedSetup":
        """Deterministic dev setup with a KNOWN tau — full functionality,
        zero security. Disk-cached (affine ints) for instant reload."""
        cache = _CACHE_DIR / f"kzg_dev_setup_{n}.json"
        if cache.exists():
            try:
                with open(cache) as f:
                    raw = json.load(f)
                g1 = [from_affine(FQ, (x, y)) for x, y in raw["g1"]]
                g2 = [
                    from_affine(FQ2, ((a, b), (c, d)))
                    for (a, b, c, d) in raw["g2"]
                ]
                return cls(g1, g2, n)
            except Exception:
                pass
        tau = (
            int.from_bytes(hashlib.sha256(b"lighthouse-tpu dev tau").digest(), "big")
            % FR_MODULUS
        )
        w = _root_of_unity(n)
        natural = [pow(w, i, FR_MODULUS) for i in range(n)]
        # L_i(tau) = w_i·(tau^n - 1) / (n·(tau - w_i))
        tn1 = (pow(tau, n, FR_MODULUS) - 1) % FR_MODULUS
        n_inv = pow(n, FR_MODULUS - 2, FR_MODULUS)
        lag_at_tau = [
            wi * tn1 % FR_MODULUS
            * pow((tau - wi) % FR_MODULUS, FR_MODULUS - 2, FR_MODULUS)
            % FR_MODULUS
            * n_inv
            % FR_MODULUS
            for wi in natural
        ]
        lag_brp = _bit_reverse_permute(lag_at_tau)
        g1 = [pt_mul(FQ, G1_GEN, s) for s in lag_brp]
        g2 = [G2_GEN, pt_mul(FQ2, G2_GEN, tau)]
        try:
            _CACHE_DIR.mkdir(exist_ok=True)
            with open(cache, "w") as f:
                json.dump(
                    {
                        "g1": [list(to_affine(FQ, p)) for p in g1],
                        "g2": [
                            [c for pair in to_affine(FQ2, p) for c in pair]
                            for p in g2
                        ],
                    },
                    f,
                )
        except OSError:
            pass
        return cls(g1, g2, n)

    #: the packaged public KZG ceremony output (ethereum/kzg-ceremony —
    #: pure spec data, byte-identical across every consensus client)
    CEREMONY_SEARCH_PATHS = (
        os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "trusted_setup.json"
        ),
    )

    @classmethod
    def default(cls) -> "TrustedSetup":
        """Resolution order: LIGHTHOUSE_TPU_TRUSTED_SETUP env var, the
        packaged mainnet ceremony file, then (loudly) the insecure dev
        setup — never silently, since the choice is consensus-critical."""
        from ...utils.logging import get_logger

        log = get_logger("kzg")
        path = os.environ.get("LIGHTHOUSE_TPU_TRUSTED_SETUP")
        if path:
            log.info("trusted setup from env", path=path)
            return cls.from_json(path)
        for candidate in cls.CEREMONY_SEARCH_PATHS:
            if os.path.exists(candidate):
                try:
                    setup = cls.from_json(candidate)
                except (OSError, KzgError, ValueError) as e:
                    log.warning(
                        "malformed trusted setup; skipping",
                        path=candidate,
                        error=repr(e),
                    )
                    continue
                log.info("trusted setup: mainnet ceremony", path=candidate)
                return setup
        log.warning(
            "NO ceremony file found — using the INSECURE dev setup "
            "(fine for tests, never for mainnet)"
        )
        return cls.insecure_dev()


# ---------------------------------------------------------------------------
# Field-element / blob plumbing
# ---------------------------------------------------------------------------


def _fr_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= FR_MODULUS:
        raise KzgError("field element >= BLS modulus")
    return v


def _fr_to_bytes(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _blob_to_evals(blob: bytes, n: int) -> list[int]:
    if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob must be {n * 32} bytes")
    return [
        _fr_from_bytes(blob[i * 32 : (i + 1) * 32]) for i in range(n)
    ]


def _blobs_to_words(blobs: list[bytes], n: int) -> np.ndarray:
    """The device engine's `_blob_to_evals`: blobs -> [m, n, 8] canonical
    32-bit words, one reinterpretation of the bytes for the whole batch,
    every element checked < r at once (KzgError as `_fr_from_bytes`)."""
    from ...ops.fr import canonical, words_from_bytes

    for blob in blobs:
        if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
            raise KzgError(f"blob must be {n * 32} bytes")
    words = words_from_bytes(b"".join(bytes(b) for b in blobs), len(blobs) * n)
    if not canonical(words).all():
        raise KzgError("field element >= BLS modulus")
    return words.reshape(len(blobs), n, 8)


def _g1_msm(scalars: list[int], points: list, window: int = 8) -> tuple:
    """Host Pippenger bucket MSM (Σ s_i·P_i): ~n + 2^c point-adds per
    255/c windows instead of n full double-and-add ladders — the same
    algorithm blst uses for commitment-scale MSMs."""
    pairs = [(s, p) for s, p in zip(scalars, points) if s != 0]
    if not pairs:
        return inf(FQ)
    if len(pairs) <= 4:
        acc = inf(FQ)
        for s, p in pairs:
            acc = pt_add(FQ, acc, pt_mul(FQ, p, s))
        return acc
    nbits = 255
    nwin = (nbits + window - 1) // window
    total = inf(FQ)
    for w in range(nwin - 1, -1, -1):
        if not is_inf(FQ, total):
            for _ in range(window):
                from ..bls12_381.curve import pt_double

                total = pt_double(FQ, total)
        buckets = [None] * (1 << window)
        shift = w * window
        mask = (1 << window) - 1
        for s, p in pairs:
            b = (s >> shift) & mask
            if b:
                buckets[b] = p if buckets[b] is None else pt_add(FQ, buckets[b], p)
        # Σ j·B_j via the running-sum trick
        running = inf(FQ)
        win_sum = inf(FQ)
        for b in range(len(buckets) - 1, 0, -1):
            if buckets[b] is not None:
                running = pt_add(FQ, running, buckets[b])
            win_sum = pt_add(FQ, win_sum, running)
        total = pt_add(FQ, total, win_sum)
    return total


# ---------------------------------------------------------------------------
# The device engine (K8, K9, K4)
# ---------------------------------------------------------------------------


class _DeviceKzg:
    """Per-setup device residency: the Lagrange points, their fixed-base
    MSM table and the bit-reversed domain live on `dev` across calls. On a
    CUDA device the calls launch the kernels of ops/{fr,msm,bls381_pairing};
    on the CPU device they run the kernels' plain versions."""

    def __init__(self, setup: TrustedSetup, dev):
        self.setup = setup
        self.dev = dev
        self._points = None
        self._table = None
        self._roots = None
        self.log_n = (setup.n - 1).bit_length()
        if (1 << self.log_n) != setup.n:
            raise KzgError("device KZG requires a power-of-two domain")

    @property
    def points(self):
        """[n, 3, 12] Jacobian limbs of the Lagrange points."""
        if self._points is None:
            import torch

            from ...ops.bls381 import g1_to_limbs

            self._points = torch.from_numpy(g1_to_limbs(self.setup.g1_lagrange)).to(self.dev)
        return self._points

    @property
    def table(self):
        """The fixed-base MSM table of the Lagrange points (ops/msm
        ``FixedBaseTable``: 2^(8w) L_i for the 32 windows, affine; 24 MiB
        at n = 4096), built at the engine's first MSM and kept."""
        if self._table is None:
            from ...ops.msm import g1_msm_table

            self._table = g1_msm_table(self.points)
        return self._table

    @property
    def roots(self):
        """[n, 8] Montgomery limbs of the bit-reversed domain."""
        if self._roots is None:
            from ...ops.fr import as_i32, mont_limbs

            self._roots = as_i32(mont_limbs(self.setup.roots_brp)).to(self.dev)
        return self._roots

    def to_device(self, words: np.ndarray):
        from ...ops.fr import as_i32

        return as_i32(words).to(self.dev)

    def evaluate_batch(self, words: np.ndarray, zs: list[int]) -> list[int]:
        """[p_j(z_j)] for blobs as [m, n, 8] words — callers guarantee no
        z hits a domain point. Exactly m rows launch: no padding."""
        from ...ops.fr import barycentric_eval, fr_from_words, fr_to_words

        ys = barycentric_eval(self.to_device(words), self.roots, self.to_device(fr_to_words(zs)))
        return fr_from_words(ys.cpu().numpy())

    def msm(self, scalars) -> tuple:
        """Σ s_i·L_i for scalars as [n, 8] canonical words (numpy, or a
        tensor already on the device) -> host Jacobian point."""
        from ...ops.bls381 import g1_from_limbs
        from ...ops.msm import g1_msm_fixed

        if isinstance(scalars, np.ndarray):
            scalars = self.to_device(scalars)
        pt = g1_from_limbs(g1_msm_fixed(self.table, scalars).cpu().numpy())[0]
        return inf(FQ) if pt[2] == 0 else pt

    def quotient(self, words: np.ndarray, z: int, y: int):
        """(p_i - y)/(w_i - z) as [n, 8] canonical words on the device; the
        lane where w_i == z is 0 (the caller fills it)."""
        from ...ops.fr import fr_to_words, quotient

        zy = self.to_device(fr_to_words([z, y]))
        return quotient(self.to_device(words), self.roots, zy[0], zy[1])

    def pairing_check(self, pairs) -> bool:
        """∏ e(Pᵢ, Qᵢ) == 1 with the Miller loops + final exp on device.
        pairs: host (G1 Jacobian, G2 Jacobian) tuples."""
        import torch

        from ...ops.bls381 import fq_to_limbs
        from ...ops.bls381_pairing import multi_pairing_check

        g1_aff = [to_affine(FQ, p) for p, _ in pairs]
        g2_aff = [to_affine(FQ2, q) for _, q in pairs]
        p = fq_to_limbs([v for a in g1_aff for v in (a or (0, 0))]).reshape(-1, 2, 12)
        q = fq_to_limbs([v for a in g2_aff for c in (a or ((0, 0), (0, 0))) for v in c]).reshape(-1, 2, 2, 12)
        t = lambda a: torch.from_numpy(a).to(self.dev)  # noqa: E731
        p_inf = torch.tensor([a is None for a in g1_aff], device=self.dev)
        q_inf = torch.tensor([a is None for a in g2_aff], device=self.dev)
        return multi_pairing_check(t(p), p_inf, t(q), q_inf)


# ---------------------------------------------------------------------------
# The Kzg engine (crypto/kzg/src/lib.rs:35 `Kzg` analog)
# ---------------------------------------------------------------------------


class Kzg:
    def __init__(self, setup: TrustedSetup | None = None, device=None):
        """`device`: None (or True) for `device.default_device()`, a device
        name, or False for the host bigint engine. With the device `cuda`
        and no card, raises RuntimeError."""
        self.setup = setup if setup is not None else TrustedSetup.default()
        self._dev: _DeviceKzg | None = None
        self._root_pos: dict | None = None
        if device is not False:
            from ...device import resolve_device

            self._dev = _DeviceKzg(self.setup, resolve_device(None if device is True else device))

    def _root_index(self) -> dict:
        if self._root_pos is None:
            self._root_pos = {w: i for i, w in enumerate(self.setup.roots_brp)}
        return self._root_pos

    def _pairing_check(self, pairs) -> bool:
        if self._dev is not None:
            return self._dev.pairing_check(pairs)
        return pairing_check(pairs)

    # -- commitments ----------------------------------------------------------

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        if self._dev is not None:
            return g1_to_bytes(self._dev.msm(_blobs_to_words([blob], self.setup.n)[0]))
        evals = _blob_to_evals(blob, self.setup.n)
        return g1_to_bytes(_g1_msm(evals, self.setup.g1_lagrange))

    # -- openings -------------------------------------------------------------

    def _evaluate(self, evals: list[int], z: int) -> int:
        """p(z) by the barycentric formula on the bit-reversed domain."""
        return self._evaluate_many([evals], [z])[0]

    def _evaluate_many(self, evals_lists: list[list[int]], zs: list[int]) -> list[int]:
        """Batch p_j(z_j) on the host engine. Domain hits are answered
        directly."""
        roots = self.setup.roots_brp
        root_pos = {w: i for i, w in enumerate(roots)}
        out: list[int | None] = []
        for j, z in enumerate(zs):
            hit = root_pos.get(z)
            out.append(evals_lists[j][hit] if hit is not None else self._evaluate_host(evals_lists[j], z))
        return out

    def _evaluate_words(self, words: np.ndarray, zs: list[int]) -> list[int]:
        """Batch p_j(z_j) on the device engine, blobs as [m, n, 8] words:
        one barycentric launch for every z off the domain; domain hits are
        answered directly, as on the host."""
        root_pos = self._root_index()
        out: list[int | None] = []
        pending: list[int] = []
        for j, z in enumerate(zs):
            hit = root_pos.get(z)
            if hit is None:
                out.append(None)
                pending.append(j)
            else:
                out.append(int.from_bytes(words[j, hit].astype(">u4").tobytes(), "big"))
        if pending:
            ys = self._dev.evaluate_batch(words[pending], [zs[j] for j in pending])
            for j, y in zip(pending, ys):
                out[j] = y
        return out

    def _evaluate_host(self, evals: list[int], z: int) -> int:
        n = self.setup.n
        roots = self.setup.roots_brp
        # p(z) = (z^n - 1)/n · Σ p_i·w_i/(z - w_i)
        total = 0
        for p_i, w_i in zip(evals, roots):
            total = (
                total
                + p_i * w_i % FR_MODULUS
                * pow((z - w_i) % FR_MODULUS, FR_MODULUS - 2, FR_MODULUS)
            ) % FR_MODULUS
        zn1 = (pow(z, n, FR_MODULUS) - 1) % FR_MODULUS
        n_inv = pow(n, FR_MODULUS - 2, FR_MODULUS)
        return total * zn1 % FR_MODULUS * n_inv % FR_MODULUS

    def compute_kzg_proof(self, blob: bytes, z_bytes: bytes) -> tuple[bytes, bytes]:
        """KZG opening proof for p(z): returns (proof, y). Quotient
        q(X) = (p(X) - y)/(X - z) computed pointwise on the domain, with the
        c-kzg special-case when z hits a domain point."""
        if self._dev is not None:
            return self._compute_kzg_proof_device(blob, z_bytes)
        evals = _blob_to_evals(blob, self.setup.n)
        z = _fr_from_bytes(z_bytes)
        y = self._evaluate(evals, z)
        roots = self.setup.roots_brp
        n = self.setup.n
        hit = next((i for i, w in enumerate(roots) if w == z), None)
        q = [0] * n
        for i, w_i in enumerate(roots):
            if w_i == z:
                continue
            q[i] = (
                (evals[i] - y)
                * pow((w_i - z) % FR_MODULUS, FR_MODULUS - 2, FR_MODULUS)
                % FR_MODULUS
            )
        if hit is not None:
            # q_hit = Σ_{j≠hit} (p_j - y)·w_j / (w_hit·(w_hit - w_j))
            w_h = roots[hit]
            acc = 0
            for j, w_j in enumerate(roots):
                if j == hit:
                    continue
                num = (evals[j] - y) * w_j % FR_MODULUS
                den = w_h * ((w_h - w_j) % FR_MODULUS) % FR_MODULUS
                acc = (acc + num * pow(den, FR_MODULUS - 2, FR_MODULUS)) % FR_MODULUS
            q[hit] = acc
        proof = _g1_msm(q, self.setup.g1_lagrange)
        return g1_to_bytes(proof), _fr_to_bytes(y)

    def _compute_kzg_proof_device(self, blob: bytes, z_bytes: bytes) -> tuple[bytes, bytes]:
        """The device engine's opening: y by the barycentric kernel (or
        read off the blob at a domain point), the quotient kernel's lanes,
        the hit lane filled on the host, then the MSM of the quotient,
        which never leaves the card unless a lane needs filling."""
        from ...ops.fr import fr_from_words, fr_to_words

        words = _blobs_to_words([blob], self.setup.n)
        z = _fr_from_bytes(z_bytes)
        y = self._evaluate_words(words, [z])[0]
        q = self._dev.quotient(words[0], z, y)
        hit = self._root_index().get(z)
        if hit is not None:
            # q_hit = Σ_{j≠hit} (p_j - y)·w_j / (w_hit·(w_hit - w_j)), the
            # host formula's sum, with each (p_j - y)/(w_hit - w_j) read
            # off the kernel's lane j as -q_j: one inversion, not n
            roots = self.setup.roots_brp
            acc = 0
            for q_j, w_j in zip(fr_from_words(q.cpu().numpy()), roots):
                acc = (acc + q_j * w_j) % FR_MODULUS  # lane hit is 0
            w_h = roots[hit]
            q_hit = (-acc) * pow(w_h, FR_MODULUS - 2, FR_MODULUS) % FR_MODULUS
            q[hit] = self._dev.to_device(fr_to_words([q_hit]))[0]
        return g1_to_bytes(self._dev.msm(q)), _fr_to_bytes(y)

    def verify_kzg_proof(
        self, commitment: bytes, z_bytes: bytes, y_bytes: bytes, proof: bytes
    ) -> bool:
        """e(C - [y], -G2)·e(π, [tau - z]G2) == 1."""
        z = _fr_from_bytes(z_bytes)
        y = _fr_from_bytes(y_bytes)
        c_pt = g1_from_bytes(commitment)
        pi = g1_from_bytes(proof)
        c_minus_y = pt_add(FQ, c_pt, pt_neg(FQ, pt_mul(FQ, G1_GEN, y)))
        tau_minus_z = pt_add(
            FQ2,
            self.setup.g2_monomial[1],
            pt_neg(FQ2, pt_mul(FQ2, G2_GEN, z)),
        )
        pairs = [(pt_neg(FQ, c_minus_y), G2_GEN), (pi, tau_minus_z)]
        return self._pairing_check(pairs)

    # -- blob proofs (EIP-4844 fiat-shamir) ------------------------------------

    def _blob_challenge(self, blob: bytes, commitment: bytes) -> bytes:
        """EIP-4844 compute_challenge: hash_to_bls_field(DOMAIN ||
        int_to_bytes16(FIELD_ELEMENTS_PER_BLOB) || blob || commitment) —
        byte-exact with c-kzg for production-size setups."""
        h = hashlib.sha256(
            FIAT_SHAMIR_PROTOCOL_DOMAIN
            + self.setup.n.to_bytes(16, "big")
            + blob
            + commitment
        ).digest()
        return (_int_from_hash(h) % FR_MODULUS).to_bytes(32, "big")

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        z = self._blob_challenge(blob, commitment)
        proof, _y = self.compute_kzg_proof(blob, z)
        return proof

    def _evaluate_blobs(self, blobs: list[bytes], zs: list[int]) -> list[int]:
        """p_j(z_j) for whole blobs on this Kzg's engine."""
        if self._dev is not None:
            return self._evaluate_words(_blobs_to_words(blobs, self.setup.n), zs)
        return self._evaluate_many([_blob_to_evals(b, self.setup.n) for b in blobs], zs)

    def verify_blob_kzg_proof(
        self, blob: bytes, commitment: bytes, proof: bytes
    ) -> bool:
        z = self._blob_challenge(blob, commitment)
        y = self._evaluate_blobs([blob], [_fr_from_bytes(z)])[0]
        return self.verify_kzg_proof(commitment, z, _fr_to_bytes(y), proof)

    def verify_blob_kzg_proof_batch(
        self, blobs: list[bytes], commitments: list[bytes], proofs: list[bytes]
    ) -> bool:
        """RLC batch (crypto/kzg/src/lib.rs:81-107; c-kzg
        verify_blob_kzg_proof_batch): one combined pairing check
        e(Σ rᵢ(Cᵢ - [yᵢ] + zᵢ·πᵢ), -G2) · e(Σ rᵢ·πᵢ, [tau]G2) == 1."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("batch length mismatch")
        if not blobs:
            return True
        if len(blobs) == 1:
            return self.verify_blob_kzg_proof(blobs[0], commitments[0], proofs[0])
        zs, c_pts, pi_pts = [], [], []
        for blob, commitment, proof in zip(blobs, commitments, proofs):
            z = self._blob_challenge(blob, commitment)
            zs.append(_fr_from_bytes(z))
            c_pts.append(g1_from_bytes(commitment))
            pi_pts.append(g1_from_bytes(proof))
        # all evaluations in one barycentric launch on the device engine
        ys = self._evaluate_blobs(blobs, zs)
        # spec verify_kzg_proof_batch: one r from the transcript, scalars are
        # its powers (polynomial-commitments.md; c-kzg byte-exact layout)
        data = (
            RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
            + self.setup.n.to_bytes(8, "big")
            + len(blobs).to_bytes(8, "big")
        )
        for c, z, y, p in zip(commitments, zs, ys, proofs):
            data += bytes(c) + _fr_to_bytes(z) + _fr_to_bytes(y) + bytes(p)
        r = _int_from_hash(hashlib.sha256(data).digest()) % FR_MODULUS
        rs = [pow(r, i, FR_MODULUS) for i in range(len(blobs))]

        lhs = inf(FQ)
        rhs = inf(FQ)
        for r, z, y, c_pt, pi in zip(rs, zs, ys, c_pts, pi_pts):
            term = pt_add(FQ, c_pt, pt_neg(FQ, pt_mul(FQ, G1_GEN, y)))
            term = pt_add(FQ, term, pt_mul(FQ, pi, z))
            lhs = pt_add(FQ, lhs, pt_mul(FQ, term, r))
            rhs = pt_add(FQ, rhs, pt_mul(FQ, pi, r))
        pairs = [(pt_neg(FQ, lhs), G2_GEN), (rhs, self.setup.g2_monomial[1])]
        return self._pairing_check(pairs)


def _int_from_hash(h: bytes) -> int:
    return int.from_bytes(h, "big")
