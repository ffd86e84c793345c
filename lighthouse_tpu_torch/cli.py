"""The umbrella CLI.

Mirrors the `lighthouse` binary (lighthouse/src/main.rs:72,433-476):
subcommands for the beacon node, the validator client, the database
manager (database_manager/src/lib.rs), account tooling, and the lcli-style
dev utilities (lcli/src/main.rs:624-657 — pretty-ssz, state-root,
block-root, skip-slots, transition-blocks). Spec selection mainnet /
minimal / gnosis via --spec (main.rs:445-449).

Entry point: `python -m lighthouse_tpu_torch <subcommand> …`. Kernels run
on `--device` (default `cuda`); `--device cpu` runs their plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_spec(name: str):
    from .types.chain_spec import mainnet_spec, minimal_spec
    from .types.eth_spec import GnosisEthSpec, MainnetEthSpec, MinimalEthSpec

    specs = {
        "mainnet": (mainnet_spec, MainnetEthSpec),
        "minimal": (minimal_spec, MinimalEthSpec),
        "gnosis": (mainnet_spec, GnosisEthSpec),
    }
    spec_fn, E = specs[name]
    return spec_fn(), E


def _state_type_for(data: bytes, E):
    from .types.containers import build_types

    try:
        return build_types(E).decode_by_fork("BeaconState", data)
    except ValueError as e:
        raise SystemExit(f"error: {e}")


def _block_type_for(data: bytes, E):
    from .types.containers import build_types

    try:
        return build_types(E).decode_by_fork("SignedBeaconBlock", data)
    except ValueError as e:
        raise SystemExit(f"error: {e}")


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------


def cmd_beacon_node(args):
    """Run a beacon node assembled by ClientBuilder (the builder.rs:109-787
    analog): store → genesis (interop or checkpoint state) → chain → mock
    EL → network service → HTTP API → state-advance timer → optional VC /
    slasher. The dev chain self-validates with interop keys; production
    networking peers over --network-port. An interop genesis on the
    system clock starts now: a fixed past genesis time would put the
    clock millions of slots ahead of any state the node could build."""
    import time

    from .client import ClientBuilder, ClientConfig
    from .crypto import bls
    from .device import resolve_device
    from .utils.logging import get_logger

    log = get_logger("lighthouse_tpu_torch.bn")
    try:
        resolve_device()
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    spec, E = _load_spec(args.spec)
    from dataclasses import replace

    spec = replace(spec, altair_fork_epoch=0, seconds_per_slot=args.seconds_per_slot)
    backend = "fake_crypto" if args.fake_crypto else args.bls_backend
    checkpoint_state = None
    if args.checkpoint_state:
        checkpoint_state = _state_type_for(
            open(args.checkpoint_state, "rb").read(), E
        )
    cfg = ClientConfig(
        spec=spec,
        E=E,
        db_path=args.db_path,
        db_backend=args.db_backend,
        http_port=args.http_port,
        network_port=args.network_port,
        noise=args.noise,
        validator_count=args.validators,
        validate=args.validate and checkpoint_state is None,
        manual_slot_clock=False,
        genesis_state=checkpoint_state,
        checkpoint_sync_url=args.checkpoint_sync_url,
        slasher=args.slasher,
        bls_backend=backend,
        kzg=args.kzg,
        # only a fresh interop genesis reads it: a checkpoint or a resumed
        # store brings its own genesis time
        genesis_time=int(time.time()),
    )
    client = ClientBuilder(cfg).build().start()
    log.info(
        "beacon node up",
        http_port=client.http_server.port if client.http_server else None,
        network_port=client.network.port if client.network else None,
        validators=args.validators,
        bls_backend=bls.backend_name(),
    )
    deadline = time.time() + args.run_for if args.run_for else None
    try:
        while deadline is None or time.time() < deadline:
            time.sleep(min(1.0, spec.seconds_per_slot / 4))
    except KeyboardInterrupt:
        pass
    finally:
        client.stop()
    return 0


def cmd_pretty_ssz(args):
    """lcli pretty-ssz: decode an SSZ file and dump JSON-ish fields."""
    _spec, E = _load_spec(args.spec)
    data = open(args.file, "rb").read()
    if args.type == "state":
        obj = _state_type_for(data, E)
    elif args.type == "block":
        obj = _block_type_for(data, E)
    else:
        raise SystemExit(f"unknown type {args.type}")

    def render(v):
        if isinstance(v, (bytes, bytearray)):
            return "0x" + bytes(v).hex()
        if isinstance(v, list):
            return f"[{len(v)} items]"
        if hasattr(v, "_fields"):
            return {f: render(getattr(v, f)) for f in v._fields}
        return v

    print(json.dumps({f: render(getattr(obj, f)) for f in obj._fields}, indent=2))
    return 0


def cmd_state_root(args):
    _spec, E = _load_spec(args.spec)
    st = _state_type_for(open(args.file, "rb").read(), E)
    print("0x" + st.hash_tree_root().hex())
    return 0


def cmd_block_root(args):
    _spec, E = _load_spec(args.spec)
    b = _block_type_for(open(args.file, "rb").read(), E)
    print("0x" + b.message.hash_tree_root().hex())
    return 0


def cmd_skip_slots(args):
    """lcli skip-slots: advance a state N slots and write it back."""
    from .state_processing import per_slot_processing

    spec, E = _load_spec(args.spec)
    st = _state_type_for(open(args.file, "rb").read(), E)
    for _ in range(args.slots):
        per_slot_processing(st, spec, E)
    out = args.output or args.file
    with open(out, "wb") as f:
        f.write(st.serialize())
    print(f"state advanced to slot {st.slot} -> {out}")
    return 0


def cmd_transition_blocks(args):
    """lcli transition-blocks: apply a block to a pre-state (the state
    transition profiling driver)."""
    import time

    from .state_processing import (
        BlockSignatureStrategy,
        per_block_processing,
        per_slot_processing,
    )

    spec, E = _load_spec(args.spec)
    st = _state_type_for(open(args.pre_state, "rb").read(), E)
    block = _block_type_for(open(args.block, "rb").read(), E)
    t0 = time.perf_counter()
    while st.slot < block.message.slot:
        per_slot_processing(st, spec, E)
    per_block_processing(
        st,
        block,
        spec,
        E,
        strategy=BlockSignatureStrategy.NO_VERIFICATION
        if args.no_signature_verification
        else BlockSignatureStrategy.VERIFY_BULK,
    )
    dt = time.perf_counter() - t0
    print(f"transition OK in {dt*1000:.1f} ms; post root 0x{st.hash_tree_root().hex()}")
    if args.output:
        with open(args.output, "wb") as f:
            f.write(st.serialize())
    return 0


def cmd_db(args):
    """database_manager: version / inspect / migrate."""
    from .store import open_item_store
    from .store.hot_cold import CURRENT_SCHEMA_VERSION, SCHEMA_VERSION_KEY
    from .store.kv import DBColumn

    store = open_item_store(args.path, getattr(args, "db_backend", "auto"))
    try:
        if args.db_cmd == "version":
            raw = store.get(DBColumn.BEACON_META, SCHEMA_VERSION_KEY)
            found = int.from_bytes(raw, "little") if raw else None
            print(
                json.dumps(
                    {
                        "on_disk": found,
                        "supported": CURRENT_SCHEMA_VERSION,
                        "compatible": found == CURRENT_SCHEMA_VERSION,
                    }
                )
            )
        elif args.db_cmd == "inspect":
            out = {}
            for col in DBColumn:
                keys = store.keys(col)
                out[col.name.lower()] = len(keys)
            print(json.dumps(out, indent=2))
        elif args.db_cmd == "migrate":
            raw = store.get(DBColumn.BEACON_META, SCHEMA_VERSION_KEY)
            found = int.from_bytes(raw, "little") if raw else None
            if found == CURRENT_SCHEMA_VERSION:
                print("already at current schema")
            elif found == 1:
                # v1→v2: prepend the slot prefix to BLOB_SIDECARS values
                # (slot read from the first sidecar's header)
                from .types.containers import build_types

                _spec, E_ = _load_spec(args.spec)
                t = build_types(E_)
                migrated = 0
                for root in store.keys(DBColumn.BLOB_SIDECARS):
                    data = store.get(DBColumn.BLOB_SIDECARS, root)
                    n = int.from_bytes(data[:4], "little")
                    sc = t.BlobSidecar.deserialize(data[4 : 4 + n])
                    slot = int(sc.signed_block_header.message.slot)
                    store.put(
                        DBColumn.BLOB_SIDECARS,
                        root,
                        slot.to_bytes(8, "little") + data,
                    )
                    migrated += 1
                store.put(
                    DBColumn.BEACON_META,
                    SCHEMA_VERSION_KEY,
                    CURRENT_SCHEMA_VERSION.to_bytes(8, "little"),
                )
                print(f"migrated v1 -> v2 ({migrated} blob entries)")
            else:
                raise SystemExit(
                    f"no migration path from v{found} — re-sync required"
                )
        return 0
    finally:
        store.close()


def cmd_vm(args):
    """validator_manager / account_manager: create / list / import."""
    from . import validator_manager as VM

    if args.vm_cmd == "create":
        spec, E = _load_spec(args.spec)
        records = VM.create_validators(
            bytes.fromhex(args.seed.removeprefix("0x")),
            args.count,
            args.dir,
            args.password,
            spec=spec,
            E=E,
            fast_kdf=args.fast_kdf,
        )
        print(json.dumps({"created": len(records), "dir": args.dir}))
    elif args.vm_cmd == "list":
        print(json.dumps(VM.list_validators(args.dir), indent=2))
    elif args.vm_cmd == "import":
        pk = VM.import_keystore(args.keystore, args.password, args.dir)
        print(json.dumps({"imported": pk.hex()}))
    return 0


def cmd_interop_keys(args):
    """Print deterministic interop keypairs (eth2_interop_keypairs)."""
    from .crypto import bls

    bls.set_backend("host")
    for i, kp in enumerate(bls.interop_keypairs(args.count)):
        print(f"{i}: pk=0x{kp.pk.to_bytes().hex()}")
    return 0


# ---------------------------------------------------------------------------


def cmd_am(args):
    """account_manager: wallet lifecycle + voluntary exits.

    Mirrors the reference account_manager CLI (wallet new/list, validator
    exit): EIP-2386 HD wallets on disk; exits are signed locally with the
    validator keystore and submitted to a beacon node's pool over the
    Beacon API (SSZ)."""
    import json
    import pathlib

    from .crypto import bls
    from .crypto.keystore import Keystore
    from .crypto.wallet import Wallet

    if args.am_cmd == "wallet-create":
        mnemonic = None
        if args.seed:
            w = Wallet.create(
                args.name,
                args.password,
                seed=bytes.fromhex(args.seed),
                _fast_kdf=args.fast_kdf,
            )
        else:
            # account_manager wallet create: fresh BIP-39 mnemonic, shown
            # exactly once (create.rs)
            w, mnemonic = Wallet.create_with_mnemonic(
                args.name, args.password, _fast_kdf=args.fast_kdf
            )
        out = pathlib.Path(args.dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{w.doc['uuid']}.json").write_text(w.to_json())
        print(json.dumps({"uuid": w.doc["uuid"], "name": w.name}))
        if mnemonic is not None:
            print(
                "RECOVERY MNEMONIC (shown once, store it safely):\n"
                f"{mnemonic}",
                file=sys.stderr,
            )
        return 0
    if args.am_cmd == "wallet-recover":
        w = Wallet.recover(
            args.name,
            args.password,
            args.mnemonic or input("mnemonic: "),
            _fast_kdf=args.fast_kdf,
        )
        out = pathlib.Path(args.dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{w.doc['uuid']}.json").write_text(w.to_json())
        print(json.dumps({"uuid": w.doc["uuid"], "name": w.name}))
        return 0
    if args.am_cmd == "wallet-list":
        out = []
        for p in sorted(pathlib.Path(args.dir).glob("*.json")):
            doc = json.loads(p.read_text())
            if doc.get("type") == "hierarchical deterministic":
                out.append(
                    {
                        "name": doc.get("name"),
                        "uuid": doc.get("uuid"),
                        "nextaccount": doc.get("nextaccount"),
                    }
                )
        print(json.dumps(out, indent=2))
        return 0
    if args.am_cmd == "exit":
        from urllib.request import Request, urlopen

        from .types.chain_spec import Domain, compute_signing_root
        from .types.containers import build_types

        _spec, E = _load_spec(args.spec)
        t = build_types(E)
        ks = Keystore.from_json(pathlib.Path(args.keystore).read_text())
        sk = bls.SecretKey(int.from_bytes(ks.decrypt(args.password), "big"))

        from urllib.error import HTTPError

        base = args.beacon_url.rstrip("/")
        genesis = json.loads(
            urlopen(f"{base}/eth/v1/beacon/genesis", timeout=10).read()
        )["data"]
        fork = json.loads(
            urlopen(f"{base}/eth/v1/beacon/states/head/fork", timeout=10).read()
        )["data"]
        cfg = json.loads(
            urlopen(f"{base}/eth/v1/config/spec", timeout=10).read()
        )["data"]
        gvr = bytes.fromhex(
            genesis["genesis_validators_root"].removeprefix("0x")
        )
        # EIP-7044: Deneb+ nodes verify exits over the CAPELLA fork domain
        # forever; pre-Deneb the domain follows the exit's own epoch
        # (previous_version when it predates the head fork) — mirror
        # exit_signature_set exactly or the node rejects the signature
        deneb_epoch = int(cfg.get("DENEB_FORK_EPOCH", 1 << 62))
        head = json.loads(
            urlopen(f"{base}/eth/v1/beacon/headers/head", timeout=10).read()
        )["data"]
        head_epoch = int(head["header"]["message"]["slot"]) // E.SLOTS_PER_EPOCH
        if head_epoch >= deneb_epoch and "CAPELLA_FORK_VERSION" in cfg:
            fork_version = bytes.fromhex(
                cfg["CAPELLA_FORK_VERSION"].removeprefix("0x")
            )
        elif args.epoch < int(fork["epoch"]):
            fork_version = bytes.fromhex(
                fork["previous_version"].removeprefix("0x")
            )
        else:
            fork_version = bytes.fromhex(
                fork["current_version"].removeprefix("0x")
            )
        exit_msg = t.VoluntaryExit(
            epoch=args.epoch, validator_index=args.validator_index
        )
        domain = _spec.compute_domain_from_parts(
            Domain.VOLUNTARY_EXIT, fork_version, gvr
        )
        root = compute_signing_root(exit_msg.hash_tree_root(), domain)
        signed = t.SignedVoluntaryExit(
            message=exit_msg, signature=sk.sign(root).to_bytes()
        )
        req = Request(
            f"{base}/eth/v1/beacon/pool/voluntary_exits",
            data=signed.serialize(),
            headers={"Content-Type": "application/octet-stream"},
        )
        try:
            resp = json.loads(urlopen(req, timeout=10).read())
        except HTTPError as e:
            # rejection replies are 4xx with a JSON body explaining why
            body = e.read()
            try:
                print(json.dumps(json.loads(body)))
            except ValueError:
                print(body.decode(errors="replace"))
            return 1
        print(json.dumps(resp))
        return 0 if resp.get("code") == 200 else 1
    raise SystemExit(f"unknown am command {args.am_cmd}")


def cmd_boot_node(args):
    """Standalone discovery bootstrap server (the boot_node crate,
    boot_node/src/lib.rs:1): runs the discv5-analog UDP discovery stack
    with no chain attached; beacon nodes seed their --bootnodes with its
    printed record."""
    import json
    import time

    from .network.discovery import BootNode

    boot = BootNode(host=args.listen_address).start()
    print(json.dumps(boot.enr().to_dict()))
    deadline = time.time() + args.run_for if args.run_for else None
    try:
        while deadline is None or time.time() < deadline:
            time.sleep(1.0)
            boot.discovery.maintain()
    except KeyboardInterrupt:
        pass
    finally:
        boot.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    # every subcommand takes --device: main() sets it before anything is
    # built, so a state or block past the size thresholds runs its kernels
    # there (cpu: their plain versions)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the kernels run (default cuda; cpu = plain versions)",
    )
    p = argparse.ArgumentParser(
        prog="lighthouse-tpu", description=__doc__.splitlines()[0]
    )
    p.add_argument(
        "--spec",
        choices=["mainnet", "minimal", "gnosis"],
        default="mainnet",
        help="preset (main.rs:445-449)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    bn = sub.add_parser(
        "bn", parents=[device], help="run a beacon node (ClientBuilder-assembled)"
    )
    bn.add_argument("--validators", type=int, default=16)
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--network-port", type=int, default=0, help="0 = ephemeral")
    bn.add_argument("--noise", action="store_true", help="Noise-XX p2p streams")
    bn.add_argument("--seconds-per-slot", type=int, default=12)
    bn.add_argument("--validate", action="store_true", help="run an in-process VC")
    bn.add_argument(
        "--bls-backend",
        choices=["host", "cuda", "fake_crypto"],
        default=None,
        help="crypto backend seam (crypto/bls/src/lib.rs:84-139); unset, "
        "it follows --device (cuda on the card, host with --device cpu)",
    )
    bn.add_argument(
        "--fake-crypto", action="store_true",
        help="shorthand for --bls-backend fake_crypto",
    )
    bn.add_argument("--db-path", default=None, help="persist chain data here")
    bn.add_argument(
        "--db-backend", choices=["auto", "native", "sqlite"], default="auto"
    )
    bn.add_argument(
        "--checkpoint-state", default=None,
        help="SSZ BeaconState file to boot from (checkpoint sync)",
    )
    bn.add_argument(
        "--checkpoint-sync-url", default=None,
        help="peer Beacon API URL to fetch+verify a finalized checkpoint "
        "from (an already-populated --db-path resumes instead)",
    )
    bn.add_argument("--slasher", action="store_true")
    bn.add_argument(
        "--kzg",
        choices=["none", "default", "dev"],
        default="default",
        help="blob DA engine: default = packaged mainnet ceremony setup, "
        "its kernels on --device (crypto/kzg/src/lib.rs:35)",
    )
    bn.add_argument("--run-for", type=float, default=None, help="seconds then exit")
    bn.set_defaults(fn=cmd_beacon_node)

    am = sub.add_parser(
        "am", parents=[device], help="account manager (wallets, exits)"
    )
    am.add_argument(
        "am_cmd", choices=["wallet-create", "wallet-recover", "wallet-list", "exit"]
    )
    am.add_argument("--dir", default=".")
    am.add_argument("--name", default="wallet")
    am.add_argument(
        "--mnemonic", default=None, help="BIP-39 phrase for wallet-recover"
    )
    am.add_argument("--password", default="")
    am.add_argument("--seed", default=None, help="hex seed (random if unset)")
    am.add_argument("--fast-kdf", action="store_true")
    am.add_argument("--keystore")
    am.add_argument("--validator-index", type=int, default=0)
    am.add_argument("--epoch", type=int, default=0)
    am.add_argument("--beacon-url", default="http://127.0.0.1:5052")
    am.set_defaults(fn=cmd_am)

    boot = sub.add_parser(
        "boot-node", parents=[device], help="standalone discovery bootstrap"
    )
    boot.add_argument("--listen-address", default="127.0.0.1")
    boot.add_argument("--run-for", type=float, default=None)
    boot.set_defaults(fn=cmd_boot_node)

    pretty = sub.add_parser(
        "pretty-ssz", parents=[device], help="decode an SSZ file"
    )
    pretty.add_argument("type", choices=["state", "block"])
    pretty.add_argument("file")
    pretty.set_defaults(fn=cmd_pretty_ssz)

    sr = sub.add_parser(
        "state-root", parents=[device], help="hash_tree_root of a state file"
    )
    sr.add_argument("file")
    sr.set_defaults(fn=cmd_state_root)

    br = sub.add_parser(
        "block-root", parents=[device], help="root of a signed-block file"
    )
    br.add_argument("file")
    br.set_defaults(fn=cmd_block_root)

    sk = sub.add_parser(
        "skip-slots", parents=[device], help="advance a state N slots"
    )
    sk.add_argument("file")
    sk.add_argument("slots", type=int)
    sk.add_argument("--output")
    sk.set_defaults(fn=cmd_skip_slots)

    tb = sub.add_parser(
        "transition-blocks", parents=[device], help="apply a block to a state"
    )
    tb.add_argument("pre_state")
    tb.add_argument("block")
    tb.add_argument("--output")
    tb.add_argument("--no-signature-verification", action="store_true")
    tb.set_defaults(fn=cmd_transition_blocks)

    db = sub.add_parser("db", parents=[device], help="database manager")
    db.add_argument("db_cmd", choices=["version", "inspect", "migrate"])
    db.add_argument("path")
    db.add_argument(
        "--db-backend",
        choices=["auto", "native", "sqlite"],
        default="auto",
        help="storage engine (native = the C++ LSM store)",
    )
    db.set_defaults(fn=cmd_db)

    ik = sub.add_parser(
        "interop-keys", parents=[device], help="deterministic test keypairs"
    )
    ik.add_argument("count", type=int)
    ik.set_defaults(fn=cmd_interop_keys)

    vm = sub.add_parser("vm", parents=[device], help="validator manager")
    vm.add_argument("vm_cmd", choices=["create", "list", "import"])
    vm.add_argument("dir")
    vm.add_argument("--count", type=int, default=1)
    vm.add_argument("--seed", default="42" * 32)
    vm.add_argument("--password", default="")
    vm.add_argument("--keystore")
    vm.add_argument("--fast-kdf", action="store_true", help="test-grade KDF cost")
    vm.set_defaults(fn=cmd_vm)

    return p


def main(argv=None) -> int:
    from .device import set_default_device

    args = build_parser().parse_args(argv)
    set_default_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
