"""The port's golden-vector generator (testing/golden_gen.py) against
lighthouse_tpu's, on the CPU device: the port's `generate_goldens` writes
a tree byte-equal to the JAX package's, file for file; the port's
conformance runner passes every case of the port's own tree; and the
port restores the caller's BLS backend setting, where the JAX package's
leaves `fake_crypto` pinned (ROADMAP §3, a reference defect). Tolerance:
exact equality of file names, bytes, counts and settings."""

import pytest

from lighthouse_tpu.crypto import bls as jax_bls
from lighthouse_tpu.testing import golden_gen as jax_golden
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.testing import ef_tests as port_ef
from lighthouse_tpu_torch.testing import golden_gen as port_golden

FAMILIES = ("operations", "sanity", "epoch_processing", "shuffling", "ssz_static", "fork", "transition", "bls", "fork_choice")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    prev = default_device(), jax_bls.backend_name(), port_bls.backend_setting()
    set_default_device("cpu")
    try:
        jax_bls.set_backend("host")
        jax_root = tmp_path_factory.mktemp("jax_goldens")
        jax_count = jax_golden.generate_goldens(jax_root)
        jax_after = jax_bls.backend_name()
        port_bls.set_backend(None)  # following the device
        port_root = tmp_path_factory.mktemp("port_goldens")
        port_count = port_golden.generate_goldens(port_root)
        port_after = port_bls.backend_setting()
    finally:
        set_default_device(prev[0])
        jax_bls.set_backend(prev[1])
        port_bls.set_backend(prev[2])
    return {
        "jax": (jax_root, jax_count),
        "port": (port_root, port_count),
        "jax_backend_after": jax_after,
        "port_setting_after": port_after,
    }


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_case_counts_equal(trees):
    assert trees["port"][1] == trees["jax"][1] >= 20


def test_same_file_names(trees):
    port, jax = _files(trees["port"][0]), _files(trees["jax"][0])
    assert sorted(port) == sorted(jax)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_tree_byte_equal(trees, family):
    port = {k: v for k, v in _files(trees["port"][0]).items() if f"/{family}/" in k}
    jax = {k: v for k, v in _files(trees["jax"][0]).items() if f"/{family}/" in k}
    assert port, f"no {family} vectors"
    assert port.keys() == jax.keys()
    differing = [k for k in port if port[k] != jax[k]]
    assert not differing, differing[:5]


@pytest.mark.parametrize("config", ["minimal", "general"])
def test_port_runner_passes_the_port_tree(trees, config):
    prev = default_device(), port_bls.backend_setting()
    set_default_device("cpu")
    try:
        port_bls.set_backend("fake_crypto" if config == "minimal" else "host")
        report = port_ef.run_all(trees["port"][0], config=config)
    finally:
        set_default_device(prev[0])
        port_bls.set_backend(prev[1])
    assert report.failed == 0, report.failures[:5]
    assert report.skipped == 0
    assert report.passed >= (18 if config == "minimal" else 6)


def test_backend_setting_restored_where_the_jax_package_pins_fake_crypto(trees):
    assert trees["port_setting_after"] is None
    assert trees["jax_backend_after"] == "fake_crypto"


@pytest.mark.parametrize("setting", ["host", "fake_crypto"])
def test_pinned_setting_restored_on_error(monkeypatch, tmp_path, setting):
    """A failure inside the generator restores the caller's setting too."""
    prev = port_bls.backend_setting()

    def fail(root, seed):
        port_bls.set_backend("fake_crypto" if setting == "host" else "host")
        raise RuntimeError("stop")

    monkeypatch.setattr(port_golden, "_generate_goldens", fail)
    try:
        port_bls.set_backend(setting)
        with pytest.raises(RuntimeError, match="stop"):
            port_golden.generate_goldens(tmp_path)
        assert port_bls.backend_setting() == setting
    finally:
        port_bls.set_backend(prev)
