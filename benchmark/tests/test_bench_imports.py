"""Nothing the benchmark runs loads JAX or the JAX package, judged by each
module's whole top-level name (the port's own name begins with the JAX
package's), and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from benchmark import harness as H


def test_whole_names_decide(monkeypatch):
    monkeypatch.setitem(sys.modules, "lighthouse_tpu_torch_fake_probe", sys)
    assert "lighthouse_tpu_torch_fake_probe" not in H.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.fake_probe", sys)
    monkeypatch.setitem(sys.modules, "lighthouse_tpu.fake_probe", sys)
    assert {"jax.fake_probe", "lighthouse_tpu.fake_probe"} <= set(H.forbidden_loaded())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module of the benchmark and every program module a driver
    imports, loaded in a fresh interpreter."""
    code = textwrap.dedent(
        f"""
        import sys, pathlib
        sys.path.insert(0, {str(H.ROOT)!r})
        from benchmark import harness as H
        H.load_module
        for sub in ("drivers", "metrics"):
            for p in sorted((H.BENCH_DIR / sub).glob("*.py")):
                H.load_module(p, "probe_" + p.stem.replace(".", "_"))
        import benchmark.reference.kzg, benchmark.reference.bls, benchmark.reference.state_root
        from lighthouse_tpu_torch.beacon_chain.chain import BeaconChain
        from lighthouse_tpu_torch.network import NetworkService
        from lighthouse_tpu_torch.crypto.kzg import Kzg
        from lighthouse_tpu_torch.store import HotColdDB, MemoryStore
        from lighthouse_tpu_torch.types.chain_spec import mainnet_spec
        from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock
        H.program_counters()
        print("loaded:" + ",".join(H.forbidden_loaded()))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_sources_name_no_forbidden_package():
    for path in H.BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in H.FORBIDDEN_MODULES, (path, name)
        if "tests" in path.relative_to(H.BENCH_DIR).parts:
            continue
        text = path.read_text()
        assert "bench.py" not in text.replace("benchmark", "") and ".bench_cache" not in text
        assert "BENCH_r0" not in text and "MULTICHIP_r0" not in text


def test_the_reference_imports_nothing_of_the_program():
    for path in (H.BENCH_DIR / "reference").rglob("*.py"):
        for name in _imports(path):
            assert not name.startswith("lighthouse_tpu"), (path, name)
