"""The port's KZG (crypto/kzg, K8 ops/fr.py, K9 ops/msm.py) against the JAX
package: its jitted Fr kernels (`barycentric_eval_batch`,
`quotient_batch`, run on the CPU at a 16-point domain), its host KZG
engine (the bigint oracle) and its host MSMs. Inputs come from a numpy or
Python seed; the port runs its kernels' plain PyTorch versions on the CPU
device. Tolerance: exact equality of integers and bytes throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bls_g1_points, fr_scalars, kzg_blobs, msm_edge_case
from lighthouse_tpu.crypto import kzg as JK
from lighthouse_tpu.crypto.bls12_381 import FQ as JFQ
from lighthouse_tpu.crypto.bls12_381 import msm as jax_host_msm
from lighthouse_tpu.crypto.bls12_381 import pt_eq as jax_pt_eq
from lighthouse_tpu.ops import fr as jax_fr
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto import kzg as PK
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import fr as K8
from lighthouse_tpu_torch.ops import msm as K9

R = PK.FR_MODULUS
N = 16
EDGE = [0, 1, R - 1, 2, R - 2, (1 << 256) % R, (1 << 255) % R]


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    """Plain versions on the CPU device, on one intra-op thread (several
    test workers share the cores)."""
    prev_dev, prev_threads = default_device(), torch.get_num_threads()
    set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev_threads)
    set_default_device(prev_dev)


def _mont(values) -> torch.Tensor:
    return torch.from_numpy(K8.mont_limbs(values).astype(np.int64))


def _blobs(seed: int, m: int, n: int = N) -> list[bytes]:
    return kzg_blobs(np.random.default_rng(seed), m, n)


def test_fr_ops_match_python_integers():
    a = EDGE * len(EDGE) + fr_scalars(np.random.default_rng(1), 30)
    b = [y for y in EDGE for _ in EDGE] + fr_scalars(np.random.default_rng(2), 30)
    ta, tb = _mont(a), _mont(b)
    assert K8.limbs_to_ints(K8.fr_mul(ta, tb)) == [x * y % R for x, y in zip(a, b)]
    assert K8.limbs_to_ints(K8.fr_add(ta, tb)) == [(x + y) % R for x, y in zip(a, b)]
    assert K8.limbs_to_ints(K8.fr_sub(ta, tb)) == [(x - y) % R for x, y in zip(a, b)]
    assert K8.limbs_to_ints(K8.fr_inv(_mont(EDGE))) == [pow(x, R - 2, R) for x in EDGE]


def test_words_round_trip_and_canonical_check():
    vals = EDGE + [R, R + 1, (1 << 256) - 1]
    words = K8.words_from_bytes(b"".join(v.to_bytes(32, "big") for v in vals), len(vals))
    assert K8.fr_from_words(words) == vals
    assert K8.canonical(words).tolist() == [True] * len(EDGE) + [False] * 3


def _domain(n: int) -> list[int]:
    return JK._bit_reverse_permute([pow(JK._root_of_unity(n), i, R) for i in range(n)])


def test_barycentric_and_quotient_match_jax_kernels():
    """K8's plain versions against the JAX package's barycentric_eval_batch
    and quotient_batch, its host _evaluate_host and the quotient formula;
    the quotient with z off the domain and on it (lane 0 there)."""
    m = 3
    roots = _domain(N)
    blobs = _blobs(3, m)
    words = np.stack([K8.words_from_bytes(b, N) for b in blobs])
    evals = [K8.fr_from_words(w) for w in words]
    zs = fr_scalars(np.random.default_rng(4), m)
    got = K8.fr_from_words(
        K8.barycentric_eval(K8.as_i32(words), K8.as_i32(K8.mont_limbs(roots)), K8.as_i32(K8.fr_to_words(zs))).numpy()
    )
    ev_j = jnp.asarray(np.stack([jax_fr.fr_to_device(e) for e in evals]))
    want = jax_fr.fr_from_device(
        jax_fr.barycentric_eval_batch(ev_j, jnp.asarray(jax_fr.fr_to_device(roots)), jnp.asarray(jax_fr.fr_to_device(zs)), 4)
    )
    host = JK.Kzg(JK.TrustedSetup.insecure_dev(N), device=False)
    assert got == want == [host._evaluate_host(e, z) for e, z in zip(evals, zs)]

    y = fr_scalars(np.random.default_rng(5), 1)[0]
    for z in (zs[0], roots[0], roots[9]):
        zy = K8.as_i32(K8.fr_to_words([z, y]))
        q = K8.fr_from_words(K8.quotient(K8.as_i32(words[0]), K8.as_i32(K8.mont_limbs(roots)), zy[0], zy[1]).numpy())
        jq = jax_fr.fr_from_device(
            jax_fr.quotient_batch(
                jnp.asarray(jax_fr.fr_to_device(evals[0])),
                jnp.asarray(jax_fr.fr_to_device(roots)),
                jnp.asarray(jax_fr.fr_to_device([z]))[0],
                jnp.asarray(jax_fr.fr_to_device([y]))[0],
            )
        )
        formula = [0 if w == z else (p - y) * pow(w - z, R - 2, R) % R for p, w in zip(evals[0], roots)]
        assert q == jq == formula


@pytest.mark.parametrize("m, on_domain", [(1, None), (3, 1)])
def test_barycentric_one_blob_and_domain_point_match_jax(m, on_domain):
    """The barycentric plain version (one fraction and one inverse per
    blob) at a proof's one blob, and in a batch where one blob's z is a
    domain point beside off-domain blobs: y = 0 there, as the JAX kernel
    gives (its Fermat inverse of 0 is 0 and z^n - 1 = 0), and the other
    blobs equal to JAX and to the host's _evaluate_host."""
    roots = _domain(N)
    words = np.stack([K8.words_from_bytes(b, N) for b in _blobs(10 + m, m)])
    evals = [K8.fr_from_words(w) for w in words]
    zs = fr_scalars(np.random.default_rng(11 + m), m)
    if on_domain is not None:
        zs[on_domain] = roots[5]
    got = K8.fr_from_words(
        K8.barycentric_eval(K8.as_i32(words), K8.as_i32(K8.mont_limbs(roots)), K8.as_i32(K8.fr_to_words(zs))).numpy()
    )
    ev_j = jnp.asarray(np.stack([jax_fr.fr_to_device(e) for e in evals]))
    want = jax_fr.fr_from_device(
        jax_fr.barycentric_eval_batch(ev_j, jnp.asarray(jax_fr.fr_to_device(roots)), jnp.asarray(jax_fr.fr_to_device(zs)), 4)
    )
    assert got == want
    host = JK.Kzg(JK.TrustedSetup.insecure_dev(N), device=False)
    for j in range(m):
        assert got[j] == (0 if j == on_domain else host._evaluate_host(evals[j], zs[j]))


def test_plain_pippenger_matches_host_msms():
    """K9's plain versions (the table's steps, then the fixed-base MSM's)
    against the JAX package's host MSMs (crypto/kzg _g1_msm and
    crypto/bls12_381 msm), over 40 points
    with zero scalars, r - 1, a repeated point with its scalar and a point
    beside its negation."""
    rng = np.random.default_rng(6)
    pts, sc = msm_edge_case(rng, bls_g1_points(rng, 40))
    got = K2.g1_from_limbs(K9.g1_msm(torch.from_numpy(K2.g1_to_limbs(pts)), K8.as_i32(K8.fr_to_words(sc))).numpy())[0]
    assert jax_pt_eq(JFQ, got, JK._g1_msm(sc, pts))
    assert jax_pt_eq(JFQ, got, jax_host_msm(JFQ, pts, sc))


@pytest.fixture(scope="module")
def engines():
    """(port on the CPU device, port host engine, JAX host engine) over
    the same 16-point dev setup."""
    return (
        PK.Kzg(PK.TrustedSetup.insecure_dev(N)),
        PK.Kzg(PK.TrustedSetup.insecure_dev(N), device=False),
        JK.Kzg(JK.TrustedSetup.insecure_dev(N), device=False),
    )


def test_kzg_cpu_engine_matches_jax_host(engines):
    """Commitments, proofs and y byte-equal to the JAX host engine (z off
    the domain by Fiat-Shamir, and z on a domain point); batch verdicts
    equal, a swapped proof inside a batch refused by both."""
    dev, host, jax_k = engines
    blobs = _blobs(7, 2)
    commitments = [dev.blob_to_kzg_commitment(b) for b in blobs]
    assert commitments == [jax_k.blob_to_kzg_commitment(b) for b in blobs]
    assert commitments == [host.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [dev.compute_blob_kzg_proof(blobs[0], commitments[0]), jax_k.compute_blob_kzg_proof(blobs[1], commitments[1])]
    assert proofs[0] == jax_k.compute_blob_kzg_proof(blobs[0], commitments[0])
    z = dev.setup.roots_brp[5].to_bytes(32, "big")
    assert dev.compute_kzg_proof(blobs[1], z) == jax_k.compute_kzg_proof(blobs[1], z) == host.compute_kzg_proof(blobs[1], z)
    swapped = proofs[::-1]
    for k in engines:
        assert k.verify_blob_kzg_proof_batch(blobs, commitments, proofs) is True
    assert jax_k.verify_blob_kzg_proof_batch(blobs, commitments, swapped) is False
    assert host.verify_blob_kzg_proof_batch(blobs, commitments, swapped) is False
    assert dev.verify_blob_kzg_proof_batch(blobs, commitments, swapped) is False


def test_non_canonical_element_raises_kzg_error(engines):
    blob = bytearray(_blobs(8, 1)[0])
    blob[32 * 3 : 32 * 4] = R.to_bytes(32, "big")
    commitment = engines[2].blob_to_kzg_commitment(_blobs(8, 1)[0])
    for k in engines:
        with pytest.raises(Exception) as exc:
            k.blob_to_kzg_commitment(bytes(blob))
        assert type(exc.value).__name__ == "KzgError"
        with pytest.raises(Exception) as exc:
            k.verify_blob_kzg_proof_batch([bytes(blob), bytes(blob)], [commitment] * 2, [commitment] * 2)
        assert type(exc.value).__name__ == "KzgError"


def test_trusted_setup_file_byte_equal_to_jax_copy():
    port = PK.TrustedSetup.CEREMONY_SEARCH_PATHS[0]
    jax_path = JK.TrustedSetup.CEREMONY_SEARCH_PATHS[0]
    with open(port, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_ceremony_setup_follows_the_spec_where_jax_does_not():
    """The ceremony file lists the Lagrange points in natural order; the
    spec (blob_to_kzg_commitment) uses them bit-reversed. The port's loader
    bit-reverses them, the JAX package's does not (a recorded reference
    defect): with the port's order the polynomial p(X) = X, whose
    evaluations are the domain itself, commits to [tau]G1, which the
    pairing confirms against the setup's [tau]G2; with the JAX order it
    does not."""
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, G1_GEN, G2_GEN, msm, pairing_check, pt_neg

    port = PK.TrustedSetup.from_json(PK.TrustedSetup.CEREMONY_SEARCH_PATHS[0])
    jax_setup = JK.TrustedSetup.from_json(JK.TrustedSetup.CEREMONY_SEARCH_PATHS[0])
    assert port.g1_lagrange == PK._bit_reverse_permute(jax_setup.g1_lagrange)
    assert port.roots_brp == jax_setup.roots_brp

    def commits_to_tau(points) -> bool:
        c = msm(FQ, points, port.roots_brp)
        return pairing_check([(c, G2_GEN), (pt_neg(FQ, G1_GEN), port.g2_monomial[1])])

    assert commits_to_tau(port.g1_lagrange) is True
    assert commits_to_tau(jax_setup.g1_lagrange) is False


def test_insecure_dev_setup_cached_in_the_port_build_dir(tmp_path, monkeypatch):
    """The dev setup's disk cache is the port's git-ignored build
    directory, not the JAX package's .jax_cache; a reload from it gives
    the same points as a fresh build and as the JAX package."""
    assert PK._CACHE_DIR.parts[-2:] == ("lighthouse_tpu_torch", "build")
    monkeypatch.setattr(PK, "_CACHE_DIR", tmp_path)
    a = PK.TrustedSetup.insecure_dev(4)
    assert (tmp_path / "kzg_dev_setup_4.json").exists()
    b = PK.TrustedSetup.insecure_dev(4)
    from lighthouse_tpu_torch.crypto.bls12_381 import FQ, to_affine

    affine = lambda s: [to_affine(FQ, p) for p in s.g1_lagrange]  # noqa: E731
    assert affine(a) == affine(b) == affine(JK.TrustedSetup.insecure_dev(4))


def test_random_blob_round_trip_host_engines_agree():
    """The port's host engine (device=False) is the JAX host engine: a
    seeded batch of 3 blobs gives byte-equal commitments and proofs."""
    rng = random.Random(9)
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "big") for _ in range(N)) for _ in range(3)]
    port = PK.Kzg(PK.TrustedSetup.insecure_dev(N), device=False)
    ref = JK.Kzg(JK.TrustedSetup.insecure_dev(N), device=False)
    for b in blobs:
        c = port.blob_to_kzg_commitment(b)
        assert c == ref.blob_to_kzg_commitment(b)
        assert port.compute_blob_kzg_proof(b, c) == ref.compute_blob_kzg_proof(b, c)
