"""The port's lint (`lighthouse_tpu_torch.analysis`) held to the JAX package's.

Every fixture of the JAX package's linter suite (`tests/test_static_analysis.py`)
runs through both linters: each source its test hands the JAX linter, at a
path under `lighthouse_tpu/`, goes through the port's linter at the same path
under `lighthouse_tpu_torch/` (and `lighthouse_tpu.` imports as
`lighthouse_tpu_torch.` ones), files on disk as they are, and both report the
same violations, rule and line. The suppression syntax is the same. The one
divergence is the fork-safety vocabulary: the port's names torch and its
kernel dispatch (a CUDA context does not survive `fork`) where the JAX
package's names jax; its tests state it. The whole-package gate runs the
port's CLI over the port."""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest
import test_static_analysis as J

import lighthouse_tpu.analysis.lint as j_lint
import lighthouse_tpu_torch.analysis as p_analysis
import lighthouse_tpu_torch.analysis.lint as p_lint

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lighthouse_tpu_torch"

# these read the JAX package's own tree; the port's counterparts are below
OWN_TREE = {"test_package_is_lint_clean", "test_cli_entrypoint", "test_fork_safety_audit_of_real_pool_workers"}
FIXTURES = sorted(n for n, f in vars(J).items() if n.startswith("test_") and inspect.isfunction(f) and n not in OWN_TREE)


def _port_path(path: str) -> str:
    return re.sub(r"(^|/)lighthouse_tpu/", r"\1lighthouse_tpu_torch/", path.replace("\\", "/"))


def _port_source(source: str) -> str:
    return re.sub(r"\blighthouse_tpu\.", "lighthouse_tpu_torch.", source)


def _found(violations, with_file=False):
    return [(v.rule, v.line) + ((Path(v.path).name,) if with_file else ()) for v in violations]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_gives_the_same_violations(name, monkeypatch, tmp_path, capsys):
    calls = []

    def lint_source(source, path):
        calls.append(("source", source, path))
        return j_lint.lint_source(source, path)

    def lint_paths(paths):
        calls.append(("paths", list(paths)))
        return j_lint.lint_paths(paths)

    def main(argv=None):
        calls.append(("main", list(argv)))
        return j_lint.main(argv)

    for attr, fn in (("lint_source", lint_source), ("lint_paths", lint_paths), ("main", main)):
        monkeypatch.setattr(J, attr, fn)
    fixture = getattr(J, name)
    fixture(**{p: {"tmp_path": tmp_path, "capsys": capsys}[p] for p in inspect.signature(fixture).parameters})
    assert calls, f"{name} called no linter"
    for call in calls:
        if call[0] == "source":
            _, source, path = call
            assert _found(p_lint.lint_source(_port_source(source), _port_path(path))) == _found(j_lint.lint_source(source, path)), call
        elif call[0] == "paths":
            assert _found(p_lint.lint_paths(call[1]), True) == _found(j_lint.lint_paths(call[1]), True), call
        else:
            capsys.readouterr()
            rc = j_lint.main(call[1])
            out = capsys.readouterr().out
            assert (p_lint.main(call[1]), capsys.readouterr().out) == (rc, out), call


WORKER = "def _worker(task):\n    return {body}\ndef run(pool, tasks):\n    return pool.map(_worker, tasks)\n"


@pytest.mark.parametrize(
    "body, jax_fires, port_fires",
    [
        ("torch.zeros(task).sum().item()", False, True),
        ("resolve_device('cpu')", False, True),
        ("CudaLibrary('k').load()", False, True),
        ("jnp.sum(task)", True, False),
        ("jax.device_get(task)", True, False),
        ("sum(task) * 2", False, False),
    ],
    ids=["torch", "resolve_device", "cuda_library", "jnp", "jax", "pure"],
)
def test_fork_safety_vocabulary_names_torch_where_jax_names_jax(body, jax_fires, port_fires):
    """The divergence: a forked child that touches torch or the kernel
    dispatch inherits a CUDA context it cannot use (the port's hazard); jax
    in a forked child is the JAX package's."""
    src = WORKER.format(body=body)
    assert (_found(j_lint.lint_source(src, "lighthouse_tpu/network/_fixture.py")) != []) == jax_fires
    got = p_lint.lint_source(src, "lighthouse_tpu_torch/network/_fixture.py")
    assert (_found(got) != []) == port_fires
    if port_fires:
        assert [v.rule for v in got] == ["fork-safety"] and "CUDA context does not survive fork" in got[0].message


def test_a_cpu_use_of_torch_in_a_worker_takes_a_suppression_with_its_reason():
    src = WORKER.format(body="torch.zeros(task).sum().item()").replace(
        "    return pool.map(", "    # lint: allow(fork-safety) -- torch on the CPU only, no CUDA context\n    return pool.map("
    )
    assert p_lint.lint_source(src, "lighthouse_tpu_torch/network/_fixture.py") == []


def test_rule_messages_name_the_port_paths():
    src = "def f(state, i):\n    return state.balances[i] + 1\n"
    (v,) = p_lint.lint_source(src, "lighthouse_tpu_torch/state_processing/_fixture.py")
    assert "lighthouse_tpu_torch/utils/safe_arith" in v.message
    # scopes follow the port's package: a JAX-package path is out of the das/ scope
    das = "def f(sidecar):\n    return sidecar.index + 1\n"
    assert _found(p_lint.lint_source(das, "lighthouse_tpu_torch/das/_fixture.py")) == [("safe-arith", 2)]
    assert p_lint.lint_source(das, "lighthouse_tpu/das/_fixture.py") == []


def test_the_analysis_package_exports_the_lint():
    assert p_analysis.RULES == j_lint.RULES
    for name in ("RULES", "Violation", "lint_paths", "lint_source", "main"):
        assert getattr(p_analysis, name) is getattr(p_lint, name)


def test_audit_of_the_ports_fork_pool_and_serving_workers():
    """Every callable the port submits to the host pool or forks as an API
    serving worker stays clear of torch, metrics, logging, spans and locks."""
    targets = [PORT / "crypto" / "bls" / "__init__.py", PORT / "parallel" / "host_pool.py", PORT / "http_api" / "workers.py", PORT / "das" / "proofs.py"]
    violations = [v for v in p_lint.lint_paths(targets) if v.rule == "fork-safety"]
    assert violations == [], "\n".join(v.render() for v in violations)


def test_cli_over_the_port_exits_0():
    """The whole-package gate: `python -m lighthouse_tpu_torch.analysis
    lighthouse_tpu_torch` exits 0, so a new unsuppressed violation anywhere
    in the port fails the suite."""
    r = subprocess.run([sys.executable, "-m", "lighthouse_tpu_torch.analysis", "lighthouse_tpu_torch"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    r = subprocess.run([sys.executable, "-m", "lighthouse_tpu_torch.analysis", "--list-rules", "lighthouse_tpu_torch"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and set(r.stdout.split()) == set(j_lint.RULES)
