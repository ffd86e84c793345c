"""lighthouse_tpu_torch stands alone: it imports neither JAX nor
lighthouse_tpu, and with the default device `cuda` a kernel dispatch
either runs the kernel on a card or raises; it never runs on the CPU
silently."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lighthouse_tpu_torch
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.ops import sha256 as port_sha
from lighthouse_tpu_torch.utils.sha256_batch import hash_rows

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "lighthouse_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lighthouse_tpu")


def _modules() -> list[str]:
    return [
        m.name
        for m in pkgutil.walk_packages(lighthouse_tpu_torch.__path__, "lighthouse_tpu_torch.")
    ]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_or_reference_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): _imports(f) & set(FORBIDDEN) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_default_cuda_dispatch_never_runs_on_the_cpu():
    prev = default_device()
    set_default_device("cuda")
    rows = np.random.default_rng(0).integers(0, 256, (4096, 64), dtype=np.uint8)
    try:
        before = port_sha.COUNTS["launches"]
        if torch.cuda.is_available():
            hash_rows(rows)
            assert port_sha.COUNTS["launches"] == before + 1
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                hash_rows(rows)
            with pytest.raises(RuntimeError, match="cuda"):
                port_sha.merkle_tree_levels(rows.reshape(-1, 32)[:4096])
            assert port_sha.COUNTS["launches"] == before
        # below the thresholds the host loop runs on any device
        assert hash_rows(rows[:8]).shape == (8, 32)
    finally:
        set_default_device(prev)


def test_default_cuda_epoch_sweep_never_runs_on_the_cpu():
    from chip_smoke import epoch_sweep_inputs
    from lighthouse_tpu_torch.ops import epoch_sweep as k7

    cols, scalars = epoch_sweep_inputs(np.random.default_rng(1), 256, False)
    prev = default_device()
    set_default_device("cuda")
    try:
        before = k7.COUNTS["launches"]
        if torch.cuda.is_available():
            k7.epoch_sweep_arrays(cols, scalars)
            assert k7.COUNTS["launches"] == before + 1
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                k7.epoch_sweep_arrays(cols, scalars)
            assert k7.COUNTS["launches"] == before
    finally:
        set_default_device(prev)


def test_unknown_device_is_refused():
    with pytest.raises(ValueError):
        set_default_device("meta")


def test_default_cuda_kzg_never_runs_on_the_cpu():
    """A Kzg on the default device `cuda` runs on a card or raises at
    construction; the host bigint engine is only had by asking for it."""
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
    from lighthouse_tpu_torch.ops import fr as k8
    from lighthouse_tpu_torch.ops import msm as k9

    setup = TrustedSetup.insecure_dev(4)
    prev = default_device()
    set_default_device("cuda")
    try:
        if torch.cuda.is_available():
            assert Kzg(setup)._dev.dev.type == "cuda"
        else:
            before = (dict(k8.COUNTS), dict(k9.COUNTS))
            with pytest.raises(RuntimeError, match="cuda"):
                Kzg(setup)
            with pytest.raises(RuntimeError, match="cuda"):
                Kzg(setup, device="cuda")
            assert (k8.COUNTS, k9.COUNTS) == before
        assert Kzg(setup, device=False)._dev is None
        assert Kzg(setup, device="cpu")._dev.dev.type == "cpu"
    finally:
        set_default_device(prev)
