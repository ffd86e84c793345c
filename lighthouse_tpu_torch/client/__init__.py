"""Node assembly: ClientBuilder + the running Client.

Mirrors beacon_node/client (src/builder.rs:109-787): a staged builder
wiring store → genesis → chain → execution layer → network → HTTP API →
slot timer → validator client, producing a `Client` whose lifecycle the
CLI (or tests) drive. Genesis options mirror `ClientGenesis`
(src/config.rs:21-41): interop keys, a provided state (checkpoint sync),
or resume-from-store."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..beacon_chain.chain import BeaconChain
from ..beacon_chain.timer import SlotTimer
from ..crypto import bls
from ..metrics import set_gauge
from ..state_processing import interop_genesis_state
from ..store import HotColdDB, MemoryStore, open_hot_cold
from ..utils.logging import get_logger
from ..utils.slot_clock import ManualSlotClock, SystemTimeSlotClock
from ..utils.task_executor import ShutdownSignal, TaskExecutor

log = get_logger("lighthouse_tpu_torch.client")


@dataclass
class ClientConfig:
    spec: object = None
    E: object = None
    db_path: str | None = None  # None = MemoryStore
    db_backend: str = "auto"  # auto | native (C++ LSM) | sqlite
    http_port: int | None = 0  # None = disabled
    http_workers: int = 0  # 0 = single-process server; N = forked read replicas
    network_port: int | None = 0  # None = disabled
    noise: bool = False  # secure p2p streams with Noise XX
    noise_seed: bytes | None = None  # deterministic identity (tests)
    validator_count: int = 16  # interop genesis size
    validate: bool = False  # run an in-process VC over the interop keys
    mock_execution_layer: bool = True
    manual_slot_clock: bool = True  # tests drive slots by hand
    genesis_state: object = None  # checkpoint-sync style provided state
    # boot from a peer's finalized checkpoint over its Beacon API
    # (beacon_chain/checkpoint_sync.py). A populated db_path store wins:
    # a restart resumes from its own anchor instead of re-fetching.
    checkpoint_sync_url: str | None = None
    genesis_time: int = 1_600_000_000
    slasher: bool = False  # run the in-process slashing detector
    # BLS backend the node runs with (crypto/bls/src/lib.rs:84-139 seam):
    # host | cuda | fake_crypto, or None: no set_backend call, so the
    # backend follows the default device (cuda on a card, host after
    # set_default_device("cpu")), as the epoch sweep and the KZG engine do.
    bls_backend: str | None = None
    # KZG engine for blob availability (crypto/kzg/src/lib.rs:35):
    # "none" = no blobs accepted, "default" = packaged mainnet ceremony,
    # "dev" = insecure dev setup (tests/devnets). Its kernels run on the
    # default device.
    kzg: str = "none"
    # autonomous sync service poll cadence (network/sync/service.py):
    # the node watches peer Statuses and catches itself up — no caller
    # ever invokes sync_to_head. None disables (tests drive sync by hand).
    sync_service_interval: float | None = 0.5
    # fleet seams (testing/testnet.py boots N nodes through this builder):
    # `keypairs` supplies the interop keypair set explicitly so every node
    # in a fleet derives the IDENTICAL genesis; `vc_keypairs` is the
    # disjoint share THIS node's VC signs with (default: all of them —
    # the single-node behavior). `network_cls`/`network_kwargs` swap in a
    # NetworkService subclass (the scenario fault plane) and pass extra
    # service knobs (heartbeat cadence, sync config) without the builder
    # growing a field per knob.
    keypairs: list | None = None
    vc_keypairs: list | None = None
    network_cls: type | None = None
    network_kwargs: dict = field(default_factory=dict)


class Client:
    def __init__(self):
        self.chain: BeaconChain | None = None
        self.network = None
        self.http_server = None
        self.timer: SlotTimer | None = None
        self.vc = None
        self.slot_clock = None
        self.executor = TaskExecutor(ShutdownSignal())
        self.keypairs = []
        self.state_advance = None

    def start(self):
        if self.network is not None:
            self.network.start()
        if self.http_server is not None:
            self.http_server.start()
        if self.timer is not None and not isinstance(
            self.slot_clock, ManualSlotClock
        ):
            self.timer.start()
        return self

    def on_slot(self, slot: int):
        """Per-slot tick (timer-driven, or manual in tests/simulator)."""
        if isinstance(self.slot_clock, ManualSlotClock):
            self.slot_clock.set_slot(slot)
        if self.vc is not None:
            proposed = self.vc.on_slot(slot)
            log.info(
                "slot processed",
                slot=slot,
                head=self.chain.head_root.hex()[:12],
                proposed=bool(proposed),
                finalized_epoch=int(
                    self.chain.head_state.finalized_checkpoint.epoch
                ),
            )
        if self.state_advance is not None:
            # pre-build next slot's state off the (possibly new) head —
            # on the network's STATE_ADVANCE lane when the node networks
            # (the epoch transition never runs on this timer thread);
            # inline on network-less nodes. The timer's slot claim dedups
            # against the network slot tick firing for the same slot.
            self.state_advance.on_slot_tick(
                slot,
                processor=(
                    self.network.processor
                    if self.network is not None
                    else None
                ),
            )
        if self.chain.slasher_service is not None:
            # detection rides the network's SLASHER_PROCESS lane when the
            # node networks (lowest priority, worker thread); inline only
            # on network-less nodes. The service's epoch claim dedups
            # against the network slot tick firing for the same epoch.
            processor = (
                self.network.processor if self.network is not None else None
            )
            self.chain.slasher_service.on_slot(slot, processor=processor)
        set_gauge("beacon_head_slot", self.chain.head_state.slot)

    def stop(self):
        if self.timer is not None:
            self.timer.stop()
        if self.network is not None:
            self.network.stop()
        if self.http_server is not None:
            self.http_server.stop()
        self.executor.shutdown_signal.trigger("client stop")


class ClientBuilder:
    """builder.rs staged construction, collapsed to the pieces this node
    has (disk_store :1043 → beacon_chain :158 → network :644 → http :703 →
    build :787)."""

    def __init__(self, config: ClientConfig):
        self.config = config
        self.client = Client()

    def build(self) -> Client:
        cfg = self.config
        c = self.client
        # crypto backend: the node-level seam selection (the reference picks
        # its backend at compile time, lib.rs:84-139; here it's runtime).
        # Unnamed, it follows the default device.
        if cfg.bls_backend is not None:
            bls.set_backend(cfg.bls_backend)
        # store: disk-backed nodes get a persistent cold side too (the
        # single-store open left cold as a process-lifetime MemoryStore,
        # so migrated history evaporated on restart)
        resume_anchor = None
        if cfg.db_path:
            store = open_hot_cold(cfg.db_path, cfg.db_backend)
            resume_anchor = store.get_anchor_info()
        else:
            store = HotColdDB(MemoryStore())
        # genesis source, in priority order: an already-populated store
        # (restart), a peer checkpoint URL (join), a provided state, or
        # interop keys. Restart/join anchor states carry the network's
        # genesis_time, which is what the slot clock must run on.
        checkpoint = None
        genesis_state = None
        if resume_anchor is not None:
            from ..types.containers import build_types

            store.types = build_types(cfg.E)
            anchor_state = store.get_state(resume_anchor[2])
            if anchor_state is None:
                raise ValueError(
                    f"store at {cfg.db_path} has an anchor watermark but "
                    "no retrievable anchor state"
                )
            clock_genesis_time = anchor_state.genesis_time
            c.keypairs = (
                list(cfg.keypairs)
                if cfg.keypairs is not None
                else bls.interop_keypairs(cfg.validator_count)
            )
        elif cfg.checkpoint_sync_url:
            from ..beacon_chain.checkpoint_sync import (
                fetch_finalized_checkpoint,
            )

            checkpoint = fetch_finalized_checkpoint(
                cfg.checkpoint_sync_url, cfg.E
            )
            clock_genesis_time = checkpoint.state.genesis_time
            c.keypairs = (
                list(cfg.keypairs)
                if cfg.keypairs is not None
                else bls.interop_keypairs(cfg.validator_count)
            )
        elif cfg.genesis_state is not None:
            # provided (checkpoint-style) state: interop keys would not
            # match its registry — signers must be wired explicitly
            if cfg.validate:
                raise ValueError(
                    "validate=True with a provided genesis_state: wire a "
                    "ValidatorClient with that network's keys instead"
                )
            genesis_state = cfg.genesis_state
            clock_genesis_time = genesis_state.genesis_time
        else:
            c.keypairs = (
                list(cfg.keypairs)
                if cfg.keypairs is not None
                else bls.interop_keypairs(cfg.validator_count)
            )
            genesis_state = interop_genesis_state(
                c.keypairs, cfg.genesis_time, b"\x42" * 32, cfg.spec, cfg.E
            )
            clock_genesis_time = genesis_state.genesis_time
        # clocks
        if cfg.manual_slot_clock:
            c.slot_clock = ManualSlotClock(
                genesis_time=clock_genesis_time,
                seconds_per_slot=cfg.spec.seconds_per_slot,
            )
        else:
            c.slot_clock = SystemTimeSlotClock(
                genesis_time=clock_genesis_time,
                seconds_per_slot=cfg.spec.seconds_per_slot,
            )
        # execution layer
        execution_layer = None
        if cfg.mock_execution_layer:
            from ..execution_layer import MockExecutionLayer
            from ..types.containers import build_types

            execution_layer = MockExecutionLayer(build_types(cfg.E), cfg.E)
        # kzg engine (blob DA) on the default device
        kzg = None
        if cfg.kzg != "none":
            from ..crypto.kzg import Kzg, TrustedSetup

            setup = (
                # sized to the preset so tiny-blob test specs (testnet DAS
                # scenarios) get a matching dev domain; the default preset
                # keeps the standard 4096
                TrustedSetup.insecure_dev(cfg.E.FIELD_ELEMENTS_PER_BLOB)
                if cfg.kzg == "dev"
                else TrustedSetup.default()
            )
            kzg = Kzg(setup)
        # chain: restart resumes from the store's anchor watermark +
        # surviving hot blocks; join anchors on the verified peer
        # checkpoint; otherwise a fresh genesis boot
        if resume_anchor is not None:
            c.chain = BeaconChain.from_store(
                store,
                cfg.spec,
                cfg.E,
                c.slot_clock,
                execution_layer=execution_layer,
                kzg=kzg,
            )
        elif checkpoint is not None:
            c.chain = BeaconChain.from_checkpoint(
                store,
                checkpoint.state,
                checkpoint.block,
                cfg.spec,
                cfg.E,
                c.slot_clock,
                wss_checkpoint=checkpoint.block_root,
                execution_layer=execution_layer,
                kzg=kzg,
            )
            from ..metrics import inc_counter

            inc_counter("checkpoint_sync_boots_total")
            set_gauge(
                "checkpoint_sync_anchor_slot",
                int(checkpoint.block.message.slot),
            )
        else:
            c.chain = BeaconChain(
                store=store,
                genesis_state=genesis_state,
                spec=cfg.spec,
                E=cfg.E,
                slot_clock=c.slot_clock,
                execution_layer=execution_layer,
                kzg=kzg,
            )
        # network
        if cfg.network_port is not None:
            from ..network import NetworkService

            transport = None
            if cfg.noise:
                from ..network.noise import NoiseIdentity, NoiseTransport

                identity = (
                    NoiseIdentity.from_seed(cfg.noise_seed)
                    if cfg.noise_seed is not None
                    else NoiseIdentity()
                )
                transport = NoiseTransport(identity)
            net_cls = cfg.network_cls if cfg.network_cls is not None else NetworkService
            c.network = net_cls(
                c.chain,
                port=cfg.network_port,
                transport=transport,
                sync_service_interval=cfg.sync_service_interval,
                **cfg.network_kwargs,
            )
            # migration cycles ride the network's MIGRATE_STORE lane
            # (lowest priority) instead of running inline on import paths
            c.chain.migrator.processor = c.network.processor
        # http (identity/peers routes read the network when present)
        if cfg.http_port is not None:
            from ..http_api import HttpApiServer

            c.http_server = HttpApiServer(
                c.chain,
                port=cfg.http_port,
                network=c.network,
                workers=cfg.http_workers,
            )
        # validator client (publishes over gossip when the node networks)
        if cfg.validate:
            from ..validator_client import GossipingBeaconNode, ValidatorClient

            node = (
                GossipingBeaconNode(c.chain, c.network)
                if c.network is not None
                else None
            )
            vc_keys = (
                cfg.vc_keypairs if cfg.vc_keypairs is not None else c.keypairs
            )
            c.vc = ValidatorClient(
                c.chain, vc_keys, cfg.spec, cfg.E, node=node
            )
        # slasher (slasher/service feeds off the chain's verified objects)
        if cfg.slasher:
            from ..slasher.service import SlasherService

            SlasherService(c.chain)  # attaches itself as chain.slasher_service
        # timer + next-slot pre-advance (state_advance_timer.rs)
        from ..beacon_chain.state_advance import StateAdvanceTimer

        c.state_advance = StateAdvanceTimer(c.chain)
        c.timer = SlotTimer(c.slot_clock, c.on_slot, executor=c.executor)
        log.info(
            "client built",
            validators=cfg.validator_count,
            http=bool(c.http_server),
            network=bool(c.network),
        )
        return c
