"""lighthouse_tpu_torch stands alone: it imports neither JAX nor
lighthouse_tpu, and with the default device `cuda` a kernel dispatch
either runs the kernel on a card or raises; it never runs on the CPU
silently."""

import ast
import json
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


def test_card_paths_load_no_yaml():
    """The card's machine may have no `yaml`: what chip_smoke.py, the card
    tests and the package's entry points import must not load it (only
    types/network_config.py and testing/ef_tests.py, CPU-side, do)."""
    code = (
        "import sys\n"
        "import chip_smoke, lighthouse_tpu_torch\n"
        "import lighthouse_tpu_torch.types, lighthouse_tpu_torch.state_processing\n"
        "import lighthouse_tpu_torch.fork_choice, lighthouse_tpu_torch.testing.harness\n"
        "import lighthouse_tpu_torch.testing.snappy\n"
        "import lighthouse_tpu_torch.http_api.workers, lighthouse_tpu_torch.eth2\n"
        "import lighthouse_tpu_torch.beacon_chain.checkpoint_sync, lighthouse_tpu_torch.light_client\n"
        "import lighthouse_tpu_torch.beacon_chain.rewards, lighthouse_tpu_torch.metrics.server\n"
        "import lighthouse_tpu_torch.validator_client.http_api, lighthouse_tpu_torch.validator_client.beacon_node_fallback\n"
        "import lighthouse_tpu_torch.execution_layer.http, lighthouse_tpu_torch.execution_layer.watchdog\n"
        "import lighthouse_tpu_torch.crypto.keystore, lighthouse_tpu_torch.crypto.wallet\n"
        "import lighthouse_tpu_torch.network, lighthouse_tpu_torch.client, lighthouse_tpu_torch.cli\n"
        "import lighthouse_tpu_torch.validator_manager\n"
        "sys.exit(1 if 'yaml' in sys.modules else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    gpu_tests = ROOT / "tests" / "test_torch_gpu.py"
    assert "yaml" not in _imports(gpu_tests) and "ef_tests" not in gpu_tests.read_text()


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


# the chain layer: the store, the slot clock, the mock execution layer,
# the beacon processor and beacon_chain/
CHAIN_MODULES = (
    "utils/slot_clock.py", "utils/timeout_lock.py", "utils/keccak.py", "utils/rlp.py",
    "beacon_processor/__init__.py", "store/kv.py", "store/hot_cold.py", "store/native.py",
    "store/__init__.py", "store/migrator.py", "execution_layer/__init__.py", "execution_layer/mock.py",
    "execution_layer/block_hash.py", "beacon_chain/attestation_verification.py", "beacon_chain/op_pool.py",
    "beacon_chain/sync_pool.py", "beacon_chain/block_times_cache.py", "beacon_chain/events.py",
    "beacon_chain/validator_monitor.py", "beacon_chain/state_advance.py", "beacon_chain/chain.py",
    "beacon_chain/harness.py", "beacon_chain/__init__.py",
)


@pytest.mark.parametrize("path", CHAIN_MODULES)
def test_chain_module_imports_neither_jax_nor_the_reference(path):
    assert FORBIDDEN and not _imports(PKG / path) & set(FORBIDDEN)


def test_importing_the_chain_modules_loads_no_jax_or_yaml():
    mods = ["lighthouse_tpu_torch." + p[: -len(".py")].replace("/", ".").removesuffix(".__init__") for p in CHAIN_MODULES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('yaml',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the layer above the chain: the Beacon API, its workers and client, the
# light client, rewards, checkpoint sync and the helpers they import
API_MODULES = (
    "utils/http_server.py", "utils/task_executor.py", "utils/compare_fields.py",
    "metrics/server.py", "metrics/system_health.py", "metrics/profiler.py",
    "beacon_chain/timer.py", "beacon_chain/fork_revert.py", "beacon_chain/rewards.py",
    "light_client/__init__.py", "http_api/columnar.py", "http_api/response_cache.py",
    "http_api/block_index.py", "http_api/__init__.py", "http_api/workers.py",
    "eth2/__init__.py", "beacon_chain/checkpoint_sync.py",
)


@pytest.mark.parametrize("path", API_MODULES)
def test_api_module_loads_no_jax_reference_or_yaml(path):
    """Each module, imported alone in a fresh interpreter, brings in
    neither JAX, nor the JAX package, nor `yaml`."""
    assert not _imports(PKG / path) & set(FORBIDDEN)
    mod = "lighthouse_tpu_torch." + path[: -len(".py")].replace("/", ".").removesuffix(".__init__")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('yaml',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the validator client and its keys, the engine API over HTTP, the
# monitoring push; and the golden-vector generator (which writes YAML)
VC_MODULES = (
    "execution_layer/auth.py", "execution_layer/http.py", "execution_layer/builder_client.py",
    "execution_layer/watchdog.py", "crypto/aes.py", "crypto/bip39_words.py", "crypto/bip39.py",
    "crypto/key_derivation.py", "crypto/keystore.py", "crypto/wallet.py",
    "validator_client/slashing_protection.py", "validator_client/__init__.py",
    "validator_client/beacon_node_fallback.py", "validator_client/http_api.py", "metrics/monitoring.py",
    "testing/golden_gen.py",
)


@pytest.mark.parametrize("path", VC_MODULES)
def test_vc_module_loads_no_jax_or_reference(path):
    """Each module, imported alone in a fresh interpreter, brings in
    neither JAX nor the JAX package; none but the golden generator
    brings in `yaml`."""
    assert not _imports(PKG / path) & set(FORBIDDEN)
    mod = "lighthouse_tpu_torch." + path[: -len(".py")].replace("/", ".").removesuffix(".__init__")
    banned = FORBIDDEN if path == "testing/golden_gen.py" else FORBIDDEN + ("yaml",)
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the node: the network stack, the client builder, the CLI
NODE_MODULES = (
    "network/messages.py", "network/gossipsub/params.py", "network/gossipsub/score.py",
    "network/gossipsub/mcache.py", "network/gossipsub/frames.py", "network/gossipsub/behaviour.py",
    "network/gossipsub/__init__.py", "network/rate_limiter.py", "network/mux.py", "network/noise.py",
    "network/rpc.py", "network/discovery.py", "network/subnet_service.py", "network/sync/batch.py",
    "network/sync/network_context.py", "network/sync/block_lookups.py", "network/sync/range_sync.py",
    "network/sync/backfill.py", "network/sync/service.py", "network/sync/__init__.py",
    "network/__init__.py", "client/__init__.py", "validator_manager.py", "cli.py", "__main__.py",
)


@pytest.fixture(scope="module")
def node_module_loads() -> dict:
    """What each node module brings into a fresh interpreter, by module:
    imported one after another, each one's new entries in sys.modules
    (a module the first one loaded shows only under that one; together
    they are all the node loads)."""
    mods = ["lighthouse_tpu_torch." + p[: -len(".py")].replace("/", ".").removesuffix(".__init__") for p in NODE_MODULES]
    code = (
        "import importlib, json, sys\n"
        "import lighthouse_tpu_torch\n"
        "out = {}\n"
        f"for m in {mods!r}:\n"
        "    before = set(sys.modules)\n"
        "    importlib.import_module(m)\n"
        "    out[m] = sorted(set(sys.modules) - before)\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(zip(NODE_MODULES, json.loads(proc.stdout.splitlines()[-1]).values()))


@pytest.mark.parametrize("path", NODE_MODULES)
def test_node_module_loads_no_jax_reference_yaml_or_cryptography(path, node_module_loads):
    """No module of the node brings in JAX, the JAX package, `yaml`, or
    `cryptography` (Noise imports it when a transport is built)."""
    assert not _imports(PKG / path) & set(FORBIDDEN)
    loaded = node_module_loads[path]
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN + ("yaml", "cryptography")], loaded


def test_cryptography_loads_only_when_a_noise_transport_is_built():
    """chip_smoke.py and the node load no `cryptography` until a Noise
    transport is built; building one loads it where it is installed."""
    pytest.importorskip("cryptography")
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import lighthouse_tpu_torch.network, lighthouse_tpu_torch.network.noise, lighthouse_tpu_torch.client\n"
        "import lighthouse_tpu_torch.cli, lighthouse_tpu_torch.validator_manager\n"
        "assert 'cryptography' not in sys.modules\n"
        "from lighthouse_tpu_torch.network.noise import NoiseTransport\n"
        "NoiseTransport()\n"
        "sys.exit(0 if 'cryptography' in sys.modules else 1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the adversarial fleet: N nodes through ClientBuilder, the fault plane, the oracle
FLEET_MODULES = ("testing/testnet.py",)


@pytest.mark.parametrize("path", FLEET_MODULES)
def test_fleet_module_loads_no_jax_reference_or_yaml(path):
    """The fleet imports neither JAX nor the JAX package, and loading it
    (with the client, the network and the API it boots) brings in neither,
    nor `yaml`: chip_smoke.py's fleet process imports it on the card."""
    assert not _imports(PKG / path) & set(FORBIDDEN)
    mod = "lighthouse_tpu_torch." + path[: -len(".py")].replace("/", ".")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('yaml',)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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


def test_cuda_process_group_without_a_card_raises(tmp_path):
    """A `cuda` mesh is an NCCL group on cards or nothing: without a card
    it raises before any group exists, and no gloo group stands in."""
    import torch.distributed as dist

    from lighthouse_tpu_torch.parallel.mesh import batch_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py runs the NCCL group")
    with pytest.raises(RuntimeError, match="cuda"):
        batch_mesh(0, 1, str(tmp_path / "store"), device="cuda")
    assert not dist.is_initialized()
