"""The port's client builder and CLI held to the JAX package's.

`ClientBuilder` with no backend named leaves the BLS backend following
the device; two port clients sync over the network; every offline
subcommand (interop-keys, pretty-ssz, state-root, block-root, skip-slots,
transition-blocks, db, vm, am) prints the same in both packages, the port
run with `--device cpu`; and the two stated divergences: the port's `bn`
starts its interop genesis at the current time, so its chain advances
where the JAX package's stays at slot 0, and `bn` on the default `cuda`
device exits at once on a machine with no card."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from dataclasses import replace

import pytest

from lighthouse_tpu.cli import main as j_main
from lighthouse_tpu.crypto import bls as j_bls
from lighthouse_tpu.state_processing import interop_genesis_state as j_genesis
from lighthouse_tpu.types.chain_spec import minimal_spec as j_minimal_spec
from lighthouse_tpu.types.eth_spec import MinimalEthSpec as JE
from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch import validator_manager as p_vm
from lighthouse_tpu_torch.cli import main as p_main
from lighthouse_tpu_torch.client import ClientBuilder, ClientConfig
from lighthouse_tpu_torch.crypto import bls as p_bls
from lighthouse_tpu_torch.types.chain_spec import minimal_spec as p_minimal_spec
from lighthouse_tpu_torch.types.eth_spec import MinimalEthSpec as PE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_device():
    prev = default_device(), j_bls.backend_name(), p_bls.backend_setting()
    set_default_device("cpu")
    yield
    set_default_device(prev[0])
    j_bls.set_backend(prev[1])
    p_bls.set_backend(prev[2])


def _both(capsys, argv: list, port_argv: list | None = None) -> tuple:
    """(JAX output, port output) of one subcommand; the port's with
    --device cpu after the subcommand's own arguments."""
    assert j_main(argv) == 0
    j_out = capsys.readouterr().out
    assert p_main((port_argv or argv) + ["--device", "cpu"]) == 0
    p_out = capsys.readouterr().out
    return j_out, p_out


# -- the client builder ----------------------------------------------------------


def test_client_builder_with_no_backend_named_follows_the_device():
    p_bls.set_backend(None)
    cfg = ClientConfig(spec=replace(p_minimal_spec(), altair_fork_epoch=0), E=PE, validator_count=8, network_port=None, http_port=None)
    assert cfg.bls_backend is None
    c = ClientBuilder(cfg).build()
    try:
        assert p_bls.backend_setting() is None
        assert p_bls.backend_name() == "host"  # the CPU device's
    finally:
        c.stop()
    p_bls.set_backend(None)
    ClientBuilder(replace(cfg, bls_backend="fake_crypto")).build().stop()
    assert p_bls.backend_setting() == "fake_crypto"


def test_two_port_clients_sync_over_the_network():
    def cfg(**kw):
        base = dict(
            spec=replace(p_minimal_spec(), altair_fork_epoch=0), E=PE, validator_count=16, manual_slot_clock=True,
            bls_backend="fake_crypto", http_port=None, sync_service_interval=None,
        )
        return ClientConfig(**(base | kw))

    a = ClientBuilder(cfg(validate=True)).build().start()
    b = ClientBuilder(cfg()).build().start()
    try:
        for slot in range(1, 9):
            a.on_slot(slot)
        b.slot_clock.set_slot(8)
        peer = b.network.connect("127.0.0.1", a.network.port)
        assert b.network.sync.sync_with(peer) == 8
        assert b.chain.head_root == a.chain.head_root
    finally:
        a.stop()
        b.stop()


def test_validator_manager_restores_the_backend_setting():
    """Key management pins `host` for its curve work and puts back the
    caller's setting: None (following the device) stays None."""
    p_bls.set_backend(None)
    p_vm.load_signers("/nonexistent-dir", "pw")
    assert p_bls.backend_setting() is None
    p_bls.set_backend("fake_crypto")
    p_vm.load_signers("/nonexistent-dir", "pw")
    assert p_bls.backend_setting() == "fake_crypto"


# -- offline subcommands, output for output --------------------------------------


@pytest.fixture()
def chain_files(tmp_path):
    """A minimal genesis state and a signed block 1 on it (made by the JAX
    harness under fake_crypto), as SSZ files."""
    from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness

    j_bls.set_backend("fake_crypto")
    spec = replace(j_minimal_spec(), altair_fork_epoch=0)
    st = j_genesis(j_bls.interop_keypairs(8), 1_600_000_000, b"\x42" * 32, spec, JE)
    (tmp_path / "state.ssz").write_bytes(st.serialize())
    h = BeaconChainHarness(spec, JE, validator_count=8)
    pre = h.chain.head_state.serialize()
    _, signed = h.add_block_at_slot(1)
    (tmp_path / "pre.ssz").write_bytes(pre)
    (tmp_path / "block.ssz").write_bytes(signed.serialize())
    j_bls.set_backend("host")
    return tmp_path


def test_interop_keys_equal(capsys):
    j_out, p_out = _both(capsys, ["interop-keys", "3"])
    assert p_out == j_out and "a99a76ed7796f7be22d5b7e8" in j_out


@pytest.mark.parametrize("cmd", ["pretty-ssz-state", "pretty-ssz-block", "state-root", "block-root"])
def test_decode_and_root_commands_equal(cmd, chain_files, capsys):
    argv = {
        "pretty-ssz-state": ["pretty-ssz", "state", str(chain_files / "state.ssz")],
        "pretty-ssz-block": ["pretty-ssz", "block", str(chain_files / "block.ssz")],
        "state-root": ["state-root", str(chain_files / "state.ssz")],
        "block-root": ["block-root", str(chain_files / "block.ssz")],
    }[cmd]
    j_out, p_out = _both(capsys, ["--spec", "minimal", *argv])
    assert p_out == j_out and j_out.strip()


def test_skip_slots_equal(chain_files, capsys):
    j_file, p_file = chain_files / "j.ssz", chain_files / "p.ssz"
    j_out, p_out = _both(
        capsys,
        ["--spec", "minimal", "skip-slots", str(chain_files / "state.ssz"), "9", "--output", str(j_file)],
        ["--spec", "minimal", "skip-slots", str(chain_files / "state.ssz"), "9", "--output", str(p_file)],
    )
    assert p_out.replace(str(p_file), "OUT") == j_out.replace(str(j_file), "OUT")
    assert p_file.read_bytes() == j_file.read_bytes()


@pytest.mark.parametrize("verify", [True, False], ids=["verified", "no_verification"])
def test_transition_blocks_equal(verify, chain_files, capsys):
    j_bls.set_backend("fake_crypto")
    p_bls.set_backend("fake_crypto")
    flags = [] if verify else ["--no-signature-verification"]
    j_file, p_file = chain_files / "jpost.ssz", chain_files / "ppost.ssz"
    base = ["--spec", "minimal", "transition-blocks", str(chain_files / "pre.ssz"), str(chain_files / "block.ssz"), *flags]
    j_out, p_out = _both(capsys, base + ["--output", str(j_file)], base + ["--output", str(p_file)])

    def root(out):  # the time taken differs; the post root must not
        return re.search(r"post root (0x[0-9a-f]{64})", out).group(1)

    assert root(p_out) == root(j_out)
    assert p_file.read_bytes() == j_file.read_bytes()


def test_db_commands_equal(tmp_path, capsys):
    from lighthouse_tpu.store import HotColdDB
    from lighthouse_tpu.store.kv import SqliteStore
    from lighthouse_tpu.types.containers import build_types

    path = str(tmp_path / "db.sqlite")
    HotColdDB(SqliteStore(path), types=build_types(JE)).hot.close()
    for sub in ("version", "inspect"):
        j_out, p_out = _both(capsys, ["db", sub, path, "--db-backend", "sqlite"])
        assert p_out == j_out
    assert json.loads(j_out)["beacon_block"] == 0


def test_vm_commands_equal(tmp_path, capsys):
    outs = {}
    for name, main in (("jax", j_main), ("port", p_main)):
        d = tmp_path / name
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(["--spec", "minimal", "vm", "create", str(d), "--count", "2", "--seed", "07" * 32, "--password", "pw", "--fast-kdf", *extra]) == 0
        created = capsys.readouterr().out.replace(str(d), "DIR")
        assert main(["vm", "list", str(d), *extra]) == 0
        listed = capsys.readouterr().out
        outs[name] = (created, listed, (d / "deposit_data.json").read_text())
    assert outs["port"] == outs["jax"]
    # each package imports a keystore the other wrote
    for name, main, src in (("jax", j_main, "port"), ("port", p_main, "jax")):
        ks = next((tmp_path / src).glob("keystore-*.json"))
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(["vm", "import", str(tmp_path / f"imported-{name}"), "--keystore", str(ks), "--password", "pw", *extra]) == 0
        outs[f"import-{name}"] = json.loads(capsys.readouterr().out)["imported"]
    assert outs["import-port"] in outs["jax"][1] and outs["import-jax"] in outs["port"][1]


def test_am_wallet_commands_equal(tmp_path, capsys):
    uuid = re.compile(r'"uuid": "[0-9a-f-]{36}"')
    outs = {}
    for name, main in (("jax", j_main), ("port", p_main)):
        d = str(tmp_path / name)
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(["am", "wallet-create", "--dir", d, "--name", "w1", "--password", "pw", "--seed", "11" * 32, "--fast-kdf", *extra]) == 0
        created = uuid.sub('"uuid": U', capsys.readouterr().out)
        assert main(["am", "wallet-list", "--dir", d, *extra]) == 0
        listed = uuid.sub('"uuid": U', capsys.readouterr().out)
        outs[name] = (created, listed)
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["jax"][1].replace("U", '"U"'))[0]["name"] == "w1"


def test_am_exit_equal(tmp_path, capsys):
    """A voluntary exit signed from a keystore and POSTed to each
    package's own node over its Beacon API: the same answer, the exit in
    each pool."""
    from lighthouse_tpu.beacon_chain.harness import BeaconChainHarness as JHarness
    from lighthouse_tpu.crypto.keystore import Keystore
    from lighthouse_tpu.http_api import HttpApiServer as JHttpApiServer
    from lighthouse_tpu_torch.beacon_chain.harness import BeaconChainHarness as PHarness
    from lighthouse_tpu_torch.http_api import HttpApiServer as PHttpApiServer

    j_bls.set_backend("host")
    p_bls.set_backend("host")
    outs = {}
    for name, Harness, Server, spec_fn, E, main in (
        ("jax", JHarness, JHttpApiServer, j_minimal_spec, JE, j_main),
        ("port", PHarness, PHttpApiServer, p_minimal_spec, PE, p_main),
    ):
        h = Harness(replace(spec_fn(), altair_fork_epoch=0, shard_committee_period=0), E, validator_count=8)
        h.extend_chain(1)
        srv = Server(h.chain).start()
        try:
            kp = h.keypairs[3]
            ks = Keystore.encrypt(kp.sk.scalar.to_bytes(32, "big"), "pw", pubkey=kp.pk.to_bytes(), _fast_kdf=True)
            path = tmp_path / f"v3-{name}.json"
            path.write_text(ks.to_json())
            extra = ["--device", "cpu"] if name == "port" else []
            argv = ["--spec", "minimal", "am", "exit", "--keystore", str(path), "--password", "pw", "--validator-index", "3", "--epoch", "0"]
            assert main(argv + ["--beacon-url", f"http://127.0.0.1:{srv.port}", *extra]) == 0
            outs[name] = (capsys.readouterr().out, bytes(h.chain.op_pool._voluntary_exits[3].signature))
        finally:
            srv.stop()
    assert outs["port"] == outs["jax"]


# -- bn: the port's genesis at start time, and no card on the cuda device ---------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bn(package: str, extra: list) -> tuple:
    port = _free_port()
    cmd = [
        sys.executable, "-m", package, "--spec", "minimal", "bn", "--fake-crypto", "--validate",
        "--seconds-per-slot", "1", "--run-for", "8", "--http-port", str(port), "--network-port", "0", "--kzg", "none", *extra,
    ]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return port, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _head_slot(port: int) -> int | None:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/eth/v1/beacon/headers/head", timeout=2) as r:
            return int(json.loads(r.read())["data"]["header"]["message"]["slot"])
    except OSError:
        return None


def test_bn_genesis_at_start_time_where_the_jax_bn_stays_at_slot_0():
    """The JAX package's `bn` builds its interop genesis at 1_600_000_000
    and runs the system clock, so its VC asks for a block millions of
    slots past genesis and no block is ever made; the port's starts the
    genesis at the current time and proposes every slot."""
    runs = {"port": _bn("lighthouse_tpu_torch", ["--device", "cpu"]), "jax": _bn("lighthouse_tpu", [])}
    heads = {name: [] for name in runs}
    try:
        deadline = time.time() + 90
        while time.time() < deadline and any(p.poll() is None for _, p in runs.values()):
            for name, (port, proc) in runs.items():
                if proc.poll() is None and (slot := _head_slot(port)) is not None:
                    heads[name].append(slot)
            time.sleep(0.5)
        errs = {name: proc.communicate(timeout=60)[1] for name, (_, proc) in runs.items()}
    finally:
        for _, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    proposed = {name: len(re.findall(r"slot processed \[slot=\d+, head=\w+, proposed=True", err)) for name, err in errs.items()}
    assert runs["port"][1].returncode == 0, errs["port"][-2000:]
    assert "beacon node up" in errs["port"] and "bls_backend=fake_crypto" in errs["port"]
    assert max(heads["port"]) >= 4 and proposed["port"] >= 4, (heads["port"], proposed)
    # the JAX node came up and never processed a slot: its VC is still
    # advancing a state towards the clock's slot when the run ends (its API
    # answers little while it does; any answer it gave reads slot 0)
    assert "beacon node up" in errs["jax"] and proposed["jax"] == 0 and "slot processed" not in errs["jax"]
    assert set(heads["jax"]) <= {0}, heads["jax"]


def test_bn_on_the_cuda_device_without_a_card_exits_at_once():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the node would start")
    port, proc = _bn("lighthouse_tpu_torch", [])
    _, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in err and "Traceback" not in err
    assert "beacon node up" not in err


def test_no_block_at_the_genesis_slot_where_the_jax_vc_raises():
    """A clock that starts at genesis ticks slot 0 first. The JAX
    package's VC tries to propose there and the block processing error
    leaves its on_slot (in `bn`, the slot timer's thread); the port's
    produces no block at the genesis slot, as the reference client's
    block service does, and goes on to slot 1."""
    from lighthouse_tpu.client import ClientBuilder as JClientBuilder
    from lighthouse_tpu.client import ClientConfig as JClientConfig
    from lighthouse_tpu.state_processing.per_block import BlockProcessingError

    clients = {}
    for name, Builder, Config, spec_fn, E in (
        ("jax", JClientBuilder, JClientConfig, j_minimal_spec, JE),
        ("port", ClientBuilder, ClientConfig, p_minimal_spec, PE),
    ):
        cfg = Config(
            spec=replace(spec_fn(), altair_fork_epoch=0), E=E, validator_count=16, validate=True,
            manual_slot_clock=True, bls_backend="fake_crypto", http_port=None, network_port=None,
        )
        clients[name] = Builder(cfg).build()
    try:
        with pytest.raises(BlockProcessingError):
            clients["jax"].on_slot(0)
        clients["port"].on_slot(0)
        assert clients["port"].chain.head_state.slot == 0
        clients["port"].on_slot(1)
        assert clients["port"].chain.head_state.slot == 1
    finally:
        for c in clients.values():
            c.stop()
