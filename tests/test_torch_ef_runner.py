"""The conformance runner of lighthouse_tpu_torch (testing/ef_tests.py)
against lighthouse_tpu's, on the CPU device: both run over the local
golden vectors the JAX package generates (testing/golden_gen.py: the
operations, sanity, epoch_processing, shuffling, ssz_static, fork,
transition, bls and fork_choice families), the port's with its own state
transition, fork choice and BLS backends. The port must pass every case,
skip none, pass as many as the JAX runner, read every vector file, and
fail a case whose post-state was altered. The port's snappy decoder must
equal the JAX package's on seeded frames. Tolerance: exact equality of
counts, bytes and verdicts."""

import shutil

import numpy as np
import pytest

from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.testing import ef_tests as jax_ef
from lighthouse_tpu.testing import snappy as jax_snappy
from lighthouse_tpu.testing.golden_gen import generate_goldens
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.testing import ef_tests as port_ef
from lighthouse_tpu_torch.testing import snappy as port_snappy

# the families the goldens hold, each of which must run in the port
FAMILIES = ("operations", "sanity", "epoch_processing", "shuffling", "ssz_static", "fork", "transition", "bls", "fork_choice")


@pytest.fixture(autouse=True)
def cpu_device_and_backends():
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    yield
    set_default_device(prev[0])
    jax_bls.set_backend(prev[1])
    port_bls.set_backend(prev[2])


@pytest.fixture(scope="module")
def vectors(tmp_path_factory):
    prev = jax_bls.backend_name()
    root = tmp_path_factory.mktemp("efvectors")
    try:
        assert generate_goldens(root) >= 20
    finally:
        jax_bls.set_backend(prev)
    return root


def _run(ef, bls, backend: str, root, config: str):
    bls.set_backend(backend)
    return ef.run_all(root, config=config)


@pytest.fixture(scope="module")
def reports(vectors):
    """Both runners on both configurations: `minimal` under fake_crypto,
    `general` (the BLS vectors) under the host backends."""
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    try:
        return {
            (pkg, config): _run(ef, bls, "fake_crypto" if config == "minimal" else "host", vectors, config)
            for pkg, ef, bls in (("jax", jax_ef, jax_bls), ("port", port_ef, port_bls))
            for config in ("minimal", "general")
        }
    finally:
        set_default_device(prev[0])
        jax_bls.set_backend(prev[1])
        port_bls.set_backend(prev[2])


@pytest.mark.parametrize("config", ["minimal", "general"])
def test_port_runner_passes_every_case_the_jax_runner_passes(reports, config):
    port, jax = reports[("port", config)], reports[("jax", config)]
    assert port.failed == 0, port.failures[:5]
    assert port.skipped == 0
    assert jax.failed == 0 and jax.skipped == 0
    assert port.passed == jax.passed >= (18 if config == "minimal" else 6)
    assert port.accessed == jax.accessed


def test_every_family_runs_in_the_port(reports, vectors):
    accessed = reports[("port", "minimal")].accessed | reports[("port", "general")].accessed
    runners = {p.split("/tests/")[1].split("/")[2] for p in accessed}
    assert set(FAMILIES) <= runners
    # the fork-choice family's steps reached the port's ForkChoice
    assert any("/fork_choice/on_block/" in p and p.endswith("steps.yaml") for p in accessed)


def test_no_vector_file_goes_unread(reports, vectors):
    accessed = reports[("port", "minimal")].accessed | reports[("port", "general")].accessed
    assert port_ef.check_all_files_accessed(vectors, accessed) == []
    assert jax_ef.check_all_files_accessed(vectors, accessed) == []


@pytest.mark.parametrize(
    "glob",
    [
        "epoch_processing/*/pyspec_tests/*/post.ssz",
        "sanity/blocks/pyspec_tests/*/post.ssz",
        "operations/attestation/pyspec_tests/*/post.ssz",
        "fork/fork/pyspec_tests/*/post.ssz",
    ],
)
def test_flipped_post_byte_fails_both_runners(vectors, tmp_path, glob):
    """One byte of one `post` flipped: both runners fail exactly that case."""
    broken = tmp_path / "broken"
    shutil.copytree(vectors, broken)
    post = sorted(broken.rglob(glob))[0]
    data = bytearray(post.read_bytes())
    data[100] ^= 0xFF
    post.write_bytes(bytes(data))
    for ef, bls in ((jax_ef, jax_bls), (port_ef, port_bls)):
        report = _run(ef, bls, "fake_crypto", broken, "minimal")
        assert report.failed == 1, report.failures
        assert str(post.parent) in report.failures[0]


# ---------------------------------------------------------------------------
# Snappy: seeded raw blocks and frames through both decoders
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _raw_block(rng: np.random.Generator) -> bytes:
    """A seeded raw snappy block: literals of every length encoding (1 to 4
    extra length bytes among them) and copies of every kind, overlapping
    ones included."""
    out, body = bytearray(), bytearray()
    for _ in range(int(rng.integers(4, 40))):
        if not out or rng.random() < 0.4:
            n = int(rng.choice([1, 5, 60, 61, 300, 70_000]) if rng.random() < 0.5 else rng.integers(1, 200))
            lit = rng.bytes(n)
            if n <= 60:
                body.append((n - 1) << 2)
            else:
                extra = ((n - 1).bit_length() + 7) // 8
                body.append((59 + extra) << 2)
                body += (n - 1).to_bytes(extra, "little")
            body += lit
            out += lit
            continue
        kind = int(rng.integers(1, 4))
        if kind == 1:
            length, offset = int(rng.integers(4, 12)), int(rng.integers(1, min(len(out), 2047) + 1))
            body += bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF])
        else:
            reach = len(out) if kind == 3 else min(len(out), 65_535)
            length, offset = int(rng.integers(1, 65)), int(rng.integers(1, reach + 1))
            body.append(kind | ((length - 1) << 2))
            body += offset.to_bytes(2 if kind == 2 else 4, "little")
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    return _varint(len(out)) + bytes(body)


def _frames(rng: np.random.Generator, blocks: list[bytes]) -> bytes:
    stream = bytearray(b"\xff\x06\x00\x00sNaPpY")
    for block in blocks:
        if rng.random() < 0.3:
            pad = rng.bytes(int(rng.integers(0, 9)))
            stream += bytes([int(rng.integers(0x80, 0xFE))]) + len(pad).to_bytes(3, "little") + pad
        stream += b"\x00" + (len(block) + 4).to_bytes(3, "little") + rng.bytes(4) + block
    return bytes(stream)


def _decode(mod, fn: str, data: bytes):
    try:
        return getattr(mod, fn)(data)
    except mod.SnappyError as e:
        return ("error", str(e))


@pytest.mark.parametrize("seed", range(6))
def test_snappy_decoder_equals_jax(seed):
    rng = np.random.default_rng(seed)
    blocks = [_raw_block(rng) for _ in range(3)]
    payload = b"".join(jax_snappy.decompress_raw(b) for b in blocks)
    frames = _frames(rng, blocks)
    framed_plain = port_snappy.compress(payload)
    cases = [("decompress_raw", b) for b in blocks] + [("decompress", frames), ("decompress", framed_plain)]
    # truncations and one flipped byte: each decoder's verdict the same
    for data in (frames, blocks[0]):
        cut = int(rng.integers(1, len(data)))
        flipped = bytearray(data)
        flipped[int(rng.integers(0, len(data)))] ^= 0xFF
        fn = "decompress" if data is frames else "decompress_raw"
        cases += [(fn, data[:cut]), (fn, bytes(flipped))]
    for fn, data in cases:
        assert _decode(port_snappy, fn, data) == _decode(jax_snappy, fn, data)
    assert port_snappy.decompress(frames) == payload == port_snappy.decompress(framed_plain)
    assert framed_plain == jax_snappy.compress(payload)
