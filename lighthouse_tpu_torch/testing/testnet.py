"""Adversarial in-process testnet fleet: scripted fault regimes over N
real nodes, with chain-health invariants as the oracle.

The adversarial many-node scenario fleet: `Testnet` boots
N full nodes through the production `ClientBuilder` — real gossipsub
v1.1 mesh, real RPC over loopback sockets, real beacon_processor lanes,
the autonomous SyncService, optional slasher, and a per-node Beacon API
server — all sharing one interop genesis, with validator duties split
across per-node VCs exactly as testing/simulator does for its two-node
sims.

On top of that sits a programmable **fault plane** (`FaultPlane`), the
generalization of testing/sync_faults.py from one lying peer to a whole
topology: every node's `TestnetNetworkService` consults the shared plane
on every outbound gossip frame (the NetworkService.egress_delay seam)
and on every dial, so a scenario can

  * `partition` the fleet into halves that build competing forks, then
    `heal` and watch proto-array reorg everyone onto one head;
  * `eclipse` a victim behind liar peers (gossip dark, Status handshake
    alive and lying) and assert it recovers once honest peers return;
  * `delay` edges past the attestation propagation window;
  * `flood` gossip lanes from attacker nodes (no VC, pure spam);
  * make a proposer `equivocate`, which must surface through the
    slasher's SLASHER_PROCESS lane as exactly one ProposerSlashing;
  * make a blob proposer `withhold_columns`: its node suppresses a
    fraction of the data-column sidecars at publish AND refuses to serve
    them over the column RPCs — the PeerDAS data-withholding attack.
    Below 50% kept, honest nodes must refuse the head (sampling fails,
    reconstruction impossible) while the chain finalizes past it; at
    >=50% kept, reconstruction promotes the staged columns to full
    availability and the block imports fleet-wide.

The **oracle** (`ChainHealthOracle`) asserts invariants from each node's
/lighthouse/health `chain` block — participation rate, head lag vs the
clock, max reorg depth, finality advancement, post-heal single-head
convergence — plus the process-wide zero-internal-error counters. One
HTTP GET per node; no raw metric-series scraping.

Every scenario takes an explicit RNG seed; a failing run logs it and
`LIGHTHOUSE_TPU_SCENARIO_SEED` replays the exact topology/fault draw.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from urllib.request import urlopen

from ..client import Client, ClientBuilder, ClientConfig
from ..crypto import bls
from ..metrics import REGISTRY, inc_counter
from ..network import NetworkService
from ..network import messages as M
from ..network.rpc import RpcError
from ..network.sync import SyncConfig
from ..state_processing import per_slot_processing
from ..state_processing.accessors import (
    compute_epoch_at_slot,
    get_beacon_proposer_index,
    get_domain,
)
from ..types.chain_spec import Domain, compute_signing_root
from ..types.eth_spec import MinimalEthSpec
from ..utils.logging import get_logger

log = get_logger("lighthouse_tpu_torch.testnet")

TESTNET_GENESIS_TIME = 1_600_000_000

FAULT_KINDS = (
    "partition",
    "heal",
    "eclipse",
    "delay",
    "flood",
    "equivocation",
    "withhold",
    # storage-lifecycle verbs (disk-backed fleets): process death with
    # the KV store kept, rebuild-from-store, checkpoint-boot into the
    # live fleet
    "kill",
    "restart",
    "join",
)
# eager registration: the scenario_smoke tier-1 run and dashboards read
# these series before the first fault is ever injected
for _kind in FAULT_KINDS:
    REGISTRY.counter(
        "testnet_fault_injections_total",
        "scripted fault-plane verbs applied by the scenario harness",
    ).inc(0, kind=_kind)
REGISTRY.counter(
    "testnet_gossip_frames_dropped_total",
    "outbound gossip frames the fault plane turned dark (partition/"
    "eclipse edges)",
).inc(0)
REGISTRY.counter(
    "testnet_gossip_frames_delayed_total",
    "outbound gossip frames the fault plane delivered late",
).inc(0)
for _result in ("pass", "fail"):
    REGISTRY.counter(
        "scenario_invariant_checks_total",
        "ChainHealthOracle invariant evaluations, by outcome",
    ).inc(0, result=_result)


class ScenarioFailure(AssertionError):
    """An invariant the oracle (or a scenario assertion) failed — the
    message always carries the scenario's seed for exact replay."""


def scenario_seed(default: int) -> int:
    """The scenario's RNG seed: LIGHTHOUSE_TPU_SCENARIO_SEED overrides
    the scripted default so a failing run replays exactly."""
    env = os.environ.get("LIGHTHOUSE_TPU_SCENARIO_SEED")
    return int(env) if env else int(default)


# ---------------------------------------------------------------------------
# fault plane


class FaultPlane:
    """The shared programmable network shim. Nodes register their listen
    address; scenarios script directed edge state; every node's
    TestnetNetworkService queries it on each outbound gossip frame and
    each dial. Three edge states compose:

      * blocked — fully dark: gossip dropped, dials refused, existing
        connections severed by the harness (a partition's cross edges);
      * muted   — gossip dropped but the connection (and its Status
        RPC) stays up: the eclipse liar's edge, silence plus lies;
      * delayed — frames delivered N seconds late on a timer thread.

    `status_extra` inflates a node's advertised Status head_slot (the
    sync_faults stale/lying-Status fault, now per-node)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._node_by_addr: dict[tuple[str, int], str] = {}
        self._blocked: set[tuple[str, str]] = set()
        self._muted: set[tuple[str, str]] = set()
        self._delays: dict[tuple[str, str], float] = {}
        self._lies: dict[str, int] = {}
        self._withheld: dict[str, frozenset[int]] = {}

    # -- registry ---------------------------------------------------------

    def register(self, node_id: str, host: str, port: int):
        with self._lock:
            self._node_by_addr[(host, int(port))] = node_id

    def node_for(self, host: str, port: int) -> str | None:
        with self._lock:
            return self._node_by_addr.get((host, int(port)))

    # -- queries (hot path: every outbound frame) -------------------------

    def edge(self, src: str, dst: str) -> float | None:
        """Gossip egress policy src→dst: None = drop, else delay secs."""
        with self._lock:
            pair = (src, dst)
            if pair in self._blocked or pair in self._muted:
                return None
            return self._delays.get(pair, 0.0)

    def dial_allowed(self, src: str, dst: str) -> bool:
        with self._lock:
            return (src, dst) not in self._blocked

    def status_extra(self, node_id: str) -> int:
        with self._lock:
            return self._lies.get(node_id, 0)

    def withheld_columns(self, node_id: str) -> frozenset[int]:
        """Column indices `node_id` is scripted to withhold (empty set =
        honest). Consulted on every column publish and column-RPC serve."""
        with self._lock:
            return self._withheld.get(node_id, frozenset())

    # -- verbs ------------------------------------------------------------

    def block_pair(self, a: str, b: str):
        with self._lock:
            self._blocked.add((a, b))
            self._blocked.add((b, a))

    def partition(self, *groups):
        """Nodes in different groups can no longer exchange anything."""
        for i, ga in enumerate(groups):
            for gb in groups[i + 1 :]:
                for a in ga:
                    for b in gb:
                        self.block_pair(a, b)

    def mute(self, src: str, dst: str):
        with self._lock:
            self._muted.add((src, dst))

    def delay(self, src: str, dst: str, seconds: float, symmetric: bool = True):
        with self._lock:
            self._delays[(src, dst)] = float(seconds)
            if symmetric:
                self._delays[(dst, src)] = float(seconds)

    def lie_status(self, node_id: str, extra_head_slots: int):
        with self._lock:
            if extra_head_slots:
                self._lies[node_id] = int(extra_head_slots)
            else:
                self._lies.pop(node_id, None)

    def withhold_columns(
        self,
        node_id: str,
        fraction: float,
        total_columns: int,
        rng: random.Random | None = None,
    ) -> tuple[int, ...]:
        """Script `node_id` to withhold `fraction` of the data-column
        index space: a seeded draw when `rng` is given (scenario replay
        rides the scenario seed), the top indices otherwise. Returns the
        withheld set; fraction 0 clears it."""
        total = int(total_columns)
        k = min(total, round(float(fraction) * total))
        if rng is not None:
            withheld = frozenset(rng.sample(range(total), k))
        else:
            withheld = frozenset(range(total - k, total))
        with self._lock:
            if withheld:
                self._withheld[node_id] = withheld
            else:
                self._withheld.pop(node_id, None)
        return tuple(sorted(withheld))

    def heal(self):
        """Clear every scripted fault (the registry survives)."""
        with self._lock:
            self._blocked.clear()
            self._muted.clear()
            self._delays.clear()
            self._lies.clear()
            self._withheld.clear()

    # -- topology ---------------------------------------------------------

    def components(self, node_ids: list[str]) -> list[set[str]]:
        """Connected components of `node_ids` under the CURRENT plane:
        an undirected edge is usable iff neither direction is blocked or
        muted. The settle loop only waits for head convergence within a
        component — partitioned halves are not expected to agree."""
        with self._lock:
            blocked = self._blocked | self._muted
        usable = lambda a, b: (a, b) not in blocked and (b, a) not in blocked
        remaining = set(node_ids)
        out = []
        while remaining:
            seed_node = remaining.pop()
            comp = {seed_node}
            frontier = [seed_node]
            while frontier:
                cur = frontier.pop()
                for other in list(remaining):
                    if usable(cur, other):
                        remaining.discard(other)
                        comp.add(other)
                        frontier.append(other)
            out.append(comp)
        return out


class TestnetNetworkService(NetworkService):
    """A real NetworkService whose egress and dials cross the fault
    plane, and whose advertised Status can lie (the sync_faults
    stale-status fault generalized to a fleet verb)."""

    def __init__(self, chain, *, plane: FaultPlane, node_id: str, **kwargs):
        self.plane = plane
        # the plane keys edges by the fleet NAME; NetworkService.node_id
        # is the 32-byte custody-derivation id, so the name maps to bytes
        # deterministically (same name -> same custody columns on replay)
        self.plane_id = node_id
        kwargs.setdefault(
            "node_id", hashlib.sha256(b"testnet:" + node_id.encode()).digest()
        )
        super().__init__(chain, **kwargs)

    def _peer_node(self, peer_id: str) -> str | None:
        host, _, port = peer_id.rpartition(":")
        try:
            return self.plane.node_for(host, int(port))
        except ValueError:
            return None

    def egress_delay(self, peer_id: str) -> float | None:
        dst = self._peer_node(peer_id)
        if dst is None:
            return 0.0  # unregistered peer (e.g. mid-registration): pass
        d = self.plane.edge(self.plane_id, dst)
        if d is None:
            inc_counter("testnet_gossip_frames_dropped_total")
        elif d > 0:
            inc_counter("testnet_gossip_frames_delayed_total")
        return d

    def connect(self, host: str, port: int):
        dst = self.plane.node_for(host, port)
        if dst is not None and not self.plane.dial_allowed(self.plane_id, dst):
            raise RpcError(
                f"fault plane: edge {self.plane_id} -> {dst} is dark"
            )
        return super().connect(host, port)

    # -- PeerDAS withholding (the DAS scenario's proposer-side fault): the
    # withheld indices never leave this node, on EITHER protocol surface —
    # suppressed at gossip publish and filtered from the column-RPC
    # provider (which backs both ByRange and ByRoot serving)

    def publish_data_column_sidecar(self, sidecar):
        if int(sidecar.index) in self.plane.withheld_columns(self.plane_id):
            inc_counter("testnet_gossip_frames_dropped_total")
            return
        super().publish_data_column_sidecar(sidecar)

    def _columns_for_root(self, root: bytes) -> list:
        cols = super()._columns_for_root(root)
        withheld = self.plane.withheld_columns(self.plane_id)
        if not withheld:
            return cols
        return [sc for sc in cols if int(sc.index) not in withheld]

    def local_status(self) -> M.StatusMessage:
        st = super().local_status()
        extra = self.plane.status_extra(self.plane_id)
        if not extra:
            return st
        return M.StatusMessage(
            fork_digest=st.fork_digest,
            finalized_root=st.finalized_root,
            finalized_epoch=st.finalized_epoch,
            head_root=st.head_root,
            head_slot=int(st.head_slot) + extra,
        )


# ---------------------------------------------------------------------------
# the fleet


@dataclass
class TestnetNode:
    name: str
    client: Client
    is_attacker: bool = False
    # kill() flips this and restart() flips it back; the node object (and
    # its index in Testnet.nodes, which _mesh_edges refers to) is stable
    # across the whole kill→restart cycle — only `client` is replaced
    alive: bool = True

    @property
    def chain(self):
        return self.client.chain

    @property
    def network(self):
        return self.client.network

    @property
    def vc(self):
        return self.client.vc

    @property
    def health_url(self) -> str:
        return f"http://127.0.0.1:{self.client.http_server.port}/lighthouse/health"


#: sync tuning for scenario runs: test-speed backoffs, and a parent-walk
#: depth that covers a whole partitioned epoch so post-heal gossip blocks
#: can pull the competing fork in via lookups
def scenario_sync_config(E) -> SyncConfig:
    return SyncConfig(
        backoff_base_s=0.02,
        backoff_max_s=0.25,
        batch_timeout_s=5.0,
        chain_timeout_s=30.0,
        lookup_max_depth=4 * E.SLOTS_PER_EPOCH,
    )


@dataclass
class Testnet:
    __test__ = False  # "Test" prefix: not a pytest collection target

    spec: object
    E: object
    plane: FaultPlane
    seed: int
    rng: random.Random
    kzg: str = "none"
    api_workers: int = 0  # forked API read replicas per full node
    # disk-backed fleet root: node N's hot store lives at
    # {db_dir}/{name}, its cold store beside it at {name}.cold — the
    # prerequisite for the kill/restart/join lifecycle verbs
    db_dir: str | None = None
    db_backend: str = "sqlite"
    keypairs: list = field(default_factory=list)
    nodes: list[TestnetNode] = field(default_factory=list)
    attackers: list[TestnetNode] = field(default_factory=list)
    _boot_kwargs: dict = field(default_factory=dict)
    _flood_stop: threading.Event = field(default_factory=threading.Event)
    _flood_threads: list = field(default_factory=list)
    flood_sent: int = 0

    # -- boot -------------------------------------------------------------

    @classmethod
    def create(
        cls,
        spec,
        E,
        node_count: int = 3,
        validator_count: int = 24,
        *,
        seed: int = 0,
        slasher_nodes: set[int] = frozenset(),
        attacker_count: int = 0,
        bls_backend: str = "fake_crypto",
        heartbeat_interval: float = 0.05,
        sync_service_interval: float | None = 0.1,
        full_mesh_max: int = 12,
        kzg: str = "none",
        api_workers: int = 0,
        db_dir: str | None = None,
        db_backend: str = "sqlite",
    ) -> "Testnet":
        """Boot `node_count` full nodes (ClientBuilder each: chain +
        fault-planed network + Beacon API + VC over a disjoint key share)
        plus `attacker_count` VC-less attacker nodes, and wire the mesh:
        full mesh up to `full_mesh_max` nodes, ring + seeded random
        chords beyond (50 nodes must not open 1225×2 sockets)."""
        seed = scenario_seed(seed)
        rng = random.Random(seed)
        keypairs = bls.interop_keypairs(validator_count)
        plane = FaultPlane()
        net = cls(
            spec=spec, E=E, plane=plane, seed=seed, rng=rng, kzg=kzg,
            api_workers=api_workers, keypairs=keypairs,
            db_dir=db_dir, db_backend=db_backend,
        )
        share = validator_count // node_count
        for i in range(node_count):
            lo = i * share
            hi = validator_count if i == node_count - 1 else lo + share
            net._boot_node(
                f"node{i}",
                vc_keypairs=keypairs[lo:hi],
                slasher=(i in slasher_nodes),
                bls_backend=bls_backend,
                heartbeat_interval=heartbeat_interval,
                sync_service_interval=sync_service_interval,
            )
        for i in range(attacker_count):
            net._boot_node(
                f"attacker{i}",
                vc_keypairs=[],
                slasher=False,
                bls_backend=bls_backend,
                heartbeat_interval=heartbeat_interval,
                sync_service_interval=None,  # attackers never self-sync
                attacker=True,
            )
        net._wire_mesh(full_mesh_max)
        time.sleep(0.2)  # let inbound-peer registration settle
        return net

    def _boot_node(
        self,
        name: str,
        *,
        vc_keypairs,
        slasher: bool,
        bls_backend: str,
        heartbeat_interval: float,
        sync_service_interval: float | None,
        attacker: bool = False,
        checkpoint_sync_url: str | None = None,
    ) -> TestnetNode:
        # remembered verbatim so restart() can rebuild the same node
        # (only `client` changes — the TestnetNode and its mesh index
        # stay stable)
        self._boot_kwargs[name] = dict(
            vc_keypairs=vc_keypairs,
            slasher=slasher,
            bls_backend=bls_backend,
            heartbeat_interval=heartbeat_interval,
            sync_service_interval=sync_service_interval,
            attacker=attacker,
        )
        client = self._build_client(
            name, checkpoint_sync_url=checkpoint_sync_url,
            **self._boot_kwargs[name],
        )
        node = TestnetNode(name, client, is_attacker=attacker)
        (self.attackers if attacker else self.nodes).append(node)
        return node

    def _build_client(
        self,
        name: str,
        *,
        vc_keypairs,
        slasher: bool,
        bls_backend: str,
        heartbeat_interval: float,
        sync_service_interval: float | None,
        attacker: bool = False,
        checkpoint_sync_url: str | None = None,
    ) -> Client:
        cfg = ClientConfig(
            spec=self.spec,
            E=self.E,
            db_path=(
                os.path.join(self.db_dir, name)
                if self.db_dir is not None
                else None
            ),
            db_backend=self.db_backend,
            validator_count=len(self.keypairs),
            keypairs=self.keypairs,
            vc_keypairs=vc_keypairs,
            validate=not attacker,
            slasher=slasher,
            bls_backend=bls_backend,
            kzg=self.kzg,
            http_port=0,
            # attackers keep the plain single-process server: the replica
            # tier exists to scale honest serving, not scripted mischief
            http_workers=0 if attacker else self.api_workers,
            network_port=0,
            manual_slot_clock=True,
            genesis_time=TESTNET_GENESIS_TIME,
            sync_service_interval=sync_service_interval,
            checkpoint_sync_url=checkpoint_sync_url,
            network_cls=TestnetNetworkService,
            network_kwargs=dict(
                plane=self.plane,
                node_id=name,
                heartbeat_interval=heartbeat_interval,
                sync_config=scenario_sync_config(self.E),
            ),
        )
        client = ClientBuilder(cfg).build().start()
        if client.network.sync_service is not None:
            # scenario time constants: react to a heal within a slot or
            # two instead of the production 5 s status refresh
            client.network.sync_service.status_poll_interval = 1.0
        self.plane.register(name, "127.0.0.1", client.network.port)
        return client

    def _wire_mesh(self, full_mesh_max: int):
        fleet = self.nodes
        if len(fleet) <= full_mesh_max:
            edges = [
                (i, j) for i in range(len(fleet)) for j in range(i)
            ]
        else:
            # ring + 2 seeded chords per node: connected, low-degree
            n = len(fleet)
            edges = {(i, (i + 1) % n) for i in range(n)}
            for i in range(n):
                for _ in range(2):
                    j = self.rng.randrange(n)
                    if j != i:
                        edges.add((max(i, j), min(i, j)))
            edges = sorted({(max(a, b), min(a, b)) for a, b in edges})
        self._mesh_edges = edges
        for i, j in edges:
            fleet[i].network.connect("127.0.0.1", fleet[j].network.port)
        # attackers each dial one seeded fleet node
        for att in self.attackers:
            target = self.rng.choice(fleet)
            att.network.connect("127.0.0.1", target.network.port)

    # -- driving ----------------------------------------------------------

    def node(self, name: str) -> TestnetNode:
        for n in self.nodes + self.attackers:
            if n.name == name:
                return n
        raise KeyError(name)

    @property
    def live_nodes(self) -> list[TestnetNode]:
        return [n for n in self.nodes if n.alive]

    def set_slot(self, slot: int):
        for n in self.nodes + self.attackers:
            if n.alive:
                n.client.slot_clock.set_slot(slot)

    def run_slot(self, slot: int, propose: bool = True):
        """One slot in protocol order across the fleet: tick every clock,
        whichever VC holds the proposal proposes, gossip settles, then
        every VC attests + aggregates (the reference VC's 0s / slot/3
        intra-slot schedule, event-driven instead of timed)."""
        self.set_slot(slot)
        if propose:
            for n in self.live_nodes:
                try:
                    n.vc.block_service.propose_if_due(slot)
                except Exception as e:  # noqa: BLE001 — a partitioned/eclipsed
                    # proposer missing its duty is scenario-normal
                    log.info("proposal missed", node=n.name, error=str(e)[:120])
        self.settle()
        for n in self.live_nodes:
            try:
                head = n.chain.head_root
                n.vc.attestation_service.attest(slot, head)
                n.vc.attestation_service.aggregate_if_selected(slot)
            except Exception as e:  # noqa: BLE001
                log.info("attestation missed", node=n.name, error=str(e)[:120])
        self.settle()

    def run_until_slot(self, end_slot: int, start_slot: int):
        for slot in range(start_slot, end_slot + 1):
            self.run_slot(slot)

    def settle(self, timeout: float = 5.0):
        """Wait for gossip convergence WITHIN each fault-plane component:
        all fleet heads in a component equal (partitioned halves converge
        separately; an eclipsed victim is a singleton and never blocks)."""
        comps = self.plane.components([n.name for n in self.live_nodes])
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done = True
            for comp in comps:
                heads = {self.node(nm).chain.head_root for nm in comp}
                if len(heads) > 1:
                    done = False
                    break
            if done:
                return
            time.sleep(0.02)

    def wait_for(self, predicate, timeout: float = 20.0, what: str = "condition"):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return
            time.sleep(0.05)
        raise ScenarioFailure(
            f"[seed={self.seed}] timed out waiting for {what}"
        )

    # -- fault verbs -------------------------------------------------------

    def partition(self, *groups):
        """Split the fleet: nodes in different groups go fully dark to
        each other (frames dropped, dials refused, live connections
        severed)."""
        inc_counter("testnet_fault_injections_total", kind="partition")
        self.plane.partition(*[list(g) for g in groups])
        self._enforce_disconnects()
        log.info("partition applied", seed=self.seed, groups=[list(g) for g in groups])

    def heal(self):
        """Clear every fault and re-dial the original mesh; sleeping sync
        backoffs wake via the peer-connected hook."""
        inc_counter("testnet_fault_injections_total", kind="heal")
        self.plane.heal()
        self._flood_stop.set()
        self._reconnect_mesh()
        log.info("fault plane healed", seed=self.seed)

    # -- storage lifecycle verbs (disk-backed fleets) ----------------------

    def kill(self, name: str) -> TestnetNode:
        """Hard-stop a node: every thread and socket goes away and the
        store handles close, but the on-disk KV stores (hot + cold)
        survive — the process-death half of the kill→restart cycle."""
        if self.db_dir is None:
            raise ScenarioFailure(
                "kill/restart need a disk-backed fleet (Testnet.create "
                "db_dir=...)"
            )
        node = self.node(name)
        inc_counter("testnet_fault_injections_total", kind="kill")
        node.client.stop()
        try:
            # a dead process holds no file handles; WAL contents persist
            node.chain.store.hot.close()
            node.chain.store.cold.close()
        except Exception as e:  # noqa: BLE001 — already-closed is fine
            log.info("store close on kill", node=name, error=str(e)[:120])
        node.alive = False
        log.info("node killed", node=name, seed=self.seed)
        return node

    def restart(self, name: str) -> TestnetNode:
        """Rebuild a killed node from its kept KV store through the
        production ClientBuilder resume path: the anchor watermark picks
        the finalized state, surviving hot blocks re-import to rebuild
        fork choice, and the persistent backfill watermark means sync
        resumes where it stopped. The TestnetNode object (and its
        _mesh_edges index) is reused — only `client` is replaced."""
        node = self.node(name)
        if node.alive:
            raise ScenarioFailure(f"[seed={self.seed}] {name} is alive")
        inc_counter("testnet_fault_injections_total", kind="restart")
        node.client = self._build_client(name, **self._boot_kwargs[name])
        node.alive = True
        live = [n for n in self.live_nodes if n.name != name]
        if live:
            # rejoin fleet time before re-dialing: Status handshakes
            # compare heads against the clock
            node.client.slot_clock.set_slot(
                max(int(n.client.slot_clock.now()) for n in live)
            )
        self._reconnect_mesh()
        log.info("node restarted", node=name, seed=self.seed)
        return node

    def join(
        self,
        name: str,
        *,
        checkpoint_from: str,
        vc_keypairs=None,
        mesh_degree: int = 3,
    ) -> TestnetNode:
        """Boot a brand-new node into the LIVE fleet by checkpoint sync:
        it fetches + verifies `checkpoint_from`'s finalized state over
        that node's Beacon API, anchors there, wires into the mesh, and
        serves the head forward while backfill fills history backward."""
        inc_counter("testnet_fault_injections_total", kind="join")
        peer = self.node(checkpoint_from)
        url = f"http://127.0.0.1:{peer.client.http_server.port}"
        base = dict(self._boot_kwargs[checkpoint_from])
        base.update(
            vc_keypairs=list(vc_keypairs) if vc_keypairs else [],
            slasher=False,
        )
        node = self._boot_node(name, checkpoint_sync_url=url, **base)
        node.client.slot_clock.set_slot(int(peer.client.slot_clock.now()))
        # wire into the live mesh: the joiner's index is last, so every
        # new edge keeps the (higher, lower) orientation _mesh_edges uses
        idx = self.nodes.index(node)
        targets = [
            i for i, n in enumerate(self.nodes) if n.alive and i != idx
        ]
        if len(targets) > mesh_degree:
            targets = sorted(self.rng.sample(targets, mesh_degree))
        for j in targets:
            self._mesh_edges.append((idx, j))
            node.network.connect("127.0.0.1", self.nodes[j].network.port)
        log.info(
            "node joined via checkpoint sync",
            node=name, source=checkpoint_from,
            anchor_slot=int(node.chain.anchor_slot), seed=self.seed,
        )
        return node

    def eclipse(self, victim: str, liars: list[str], lie_extra_slots: int = 64):
        """Eclipse `victim`: dark to every honest fleet node; `liars`
        (attacker nodes) keep their connection to the victim up but mute
        gossip toward it and advertise a head `lie_extra_slots` ahead —
        the victim sees only silence and lies. The liars ALSO go dark to
        the honest fleet: their chains freeze at eclipse start, so the
        victim cannot quietly range-sync the real chain through the
        attackers' RPC (that leak made early drafts of this scenario a
        slow relay, not an eclipse)."""
        inc_counter("testnet_fault_injections_total", kind="eclipse")
        for n in self.nodes:
            if n.name != victim and n.name not in liars:
                self.plane.block_pair(victim, n.name)
                for liar in liars:
                    self.plane.block_pair(liar, n.name)
        for liar in liars:
            self.plane.mute(liar, victim)
            self.plane.lie_status(liar, lie_extra_slots)
            # liars must actually be connected to the victim
            liar_node = self.node(liar)
            victim_port = self.node(victim).network.port
            if not self._connected(liar_node, victim_port):
                liar_node.network.connect("127.0.0.1", victim_port)
        self._enforce_disconnects()
        log.info("eclipse applied", victim=victim, liars=liars, seed=self.seed)

    def delay_edges_of(self, name: str, seconds: float):
        """Deliver every gossip frame to/from `name` late (the
        late-block/late-attestation regime)."""
        inc_counter("testnet_fault_injections_total", kind="delay")
        for n in self.nodes:
            if n.name != name:
                self.plane.delay(name, n.name, seconds)

    def start_flood(self, rate_sleep: float = 0.001):
        """Attacker nodes flood decodable unknown-root attestations (the
        worst honest-looking spam) into their fleet targets' gossip
        lanes until heal()/stop_flood()."""
        inc_counter("testnet_fault_injections_total", kind="flood")
        self._flood_stop.clear()

        def flood_loop(att: TestnetNode, lane: int):
            t = att.chain.types
            E = self.E
            sent = 0
            garbage = [bytes([0x70 + lane]) * 31 + bytes([j]) for j in range(8)]
            while not self._flood_stop.is_set():
                slot = int(att.client.slot_clock.now())
                root = garbage[sent % len(garbage)]
                att_obj = t.Attestation(
                    aggregation_bits=[True],
                    data=t.AttestationData(
                        slot=slot,
                        index=0,
                        beacon_block_root=root,
                        source=t.Checkpoint(epoch=0, root=b"\x00" * 32),
                        target=t.Checkpoint(
                            epoch=slot // E.SLOTS_PER_EPOCH, root=root
                        ),
                    ),
                    signature=(lane * (1 << 40) + sent).to_bytes(8, "little")
                    + bytes(88),
                )
                att.network.gossip.publish(
                    att.network.topic_att, t.Attestation.serialize_value(att_obj)
                )
                sent += 1
                self.flood_sent += 1
                time.sleep(rate_sleep)

        self._flood_threads = [
            threading.Thread(
                target=flood_loop, args=(att, lane), daemon=True,
                name=f"testnet-flood-{att.name}",
            )
            for lane, att in enumerate(self.attackers)
        ]
        for th in self._flood_threads:
            th.start()

    def stop_flood(self):
        self._flood_stop.set()
        for th in self._flood_threads:
            th.join(timeout=5)
        self._flood_threads = []

    def equivocate(self, slot: int, node_name: str | None = None) -> int:
        """Make `slot`'s proposer (computed on `node_name`'s head) sign
        TWO competing blocks and publish both — the double proposal the
        slasher must turn into exactly one ProposerSlashing. Returns the
        proposer's validator index. Call with the clock at `slot` and
        INSTEAD of the slot's normal proposal (run_slot(propose=False))."""
        inc_counter("testnet_fault_injections_total", kind="equivocation")
        node = self.node(node_name) if node_name else self.nodes[0]
        chain = node.chain
        st = chain.head_state.copy()
        while st.slot < slot:
            per_slot_processing(st, self.spec, self.E)
        proposer = get_beacon_proposer_index(st, self.E)
        sk = self.keypairs[proposer].sk
        epoch = compute_epoch_at_slot(slot, self.E)
        randao_domain = get_domain(st, Domain.RANDAO, epoch, self.spec, self.E)
        randao = sk.sign(
            compute_signing_root(
                epoch.to_bytes(8, "little").ljust(32, b"\x00"), randao_domain
            )
        ).to_bytes()
        # produce BOTH before importing either: the second must be a
        # competing sibling, not a child of the first
        b1, _ = chain.produce_block_on_state(slot, randao, graffiti=b"\x11" * 32)
        b2, _ = chain.produce_block_on_state(slot, randao, graffiti=b"\x22" * 32)
        t = chain.types
        prop_domain = get_domain(
            st, Domain.BEACON_PROPOSER, epoch, self.spec, self.E
        )
        signed = []
        for blk in (b1, b2):
            sig = sk.sign(
                compute_signing_root(blk.hash_tree_root(), prop_domain)
            ).to_bytes()
            tf = t.types_for_fork(t.fork_of_block(blk))
            signed.append(tf.SignedBeaconBlock(message=blk, signature=sig))
        for s in signed:
            chain.process_block(s)
            node.network.publish_block(s)
        log.info(
            "proposer equivocated", slot=slot, proposer=proposer,
            node=node.name, seed=self.seed,
        )
        return proposer

    def withhold_columns(self, node_name: str, fraction: float) -> tuple:
        """Script `node_name` to withhold a seeded `fraction` of the
        data-column index space: suppressed at gossip publish and filtered
        from its column-RPC serving (the PeerDAS withholding attack).
        Returns the withheld column indices. heal() clears it."""
        inc_counter("testnet_fault_injections_total", kind="withhold")
        withheld = self.plane.withhold_columns(
            node_name, fraction, int(self.E.NUMBER_OF_COLUMNS), rng=self.rng
        )
        log.info(
            "column withholding applied", node=node_name,
            fraction=fraction, withheld=list(withheld), seed=self.seed,
        )
        return withheld

    def propose_blob_block(
        self, slot: int, node_name: str | None = None, n_blobs: int = 2
    ) -> tuple[bytes, list]:
        """Craft and publish `slot`'s proposal CARRYING blob commitments.
        Block production has no blob source, so — like `equivocate`
        hand-signs its double proposal — the DAS scenarios build the
        sidecar-backed proposal by hand on `node_name`: produce the slot's
        block, graft `n_blobs` seeded blob commitments into its body,
        re-sign with the duty key, import locally via the full-column
        route (which persists the column set for RPC serving), then
        publish the block and its column sidecars — minus whatever the
        fault plane says this node withholds. Returns
        (block_root, column_sidecars). Call with the clock at `slot` and
        INSTEAD of the slot's normal proposal (run_slot(propose=False))."""
        from ..crypto.kzg import FR_MODULUS
        from ..das import build_data_column_sidecars

        node = self.node(node_name) if node_name else self.nodes[0]
        chain = node.chain
        kzg = chain.data_availability_checker.kzg
        if kzg is None:
            raise ScenarioFailure(
                f"[seed={self.seed}] propose_blob_block needs "
                "Testnet.create(..., kzg='dev')"
            )
        E = self.E
        st = chain.head_state.copy()
        while st.slot < slot:
            per_slot_processing(st, self.spec, E)
        proposer = get_beacon_proposer_index(st, E)
        sk = self.keypairs[proposer].sk
        epoch = compute_epoch_at_slot(slot, E)
        randao_domain = get_domain(st, Domain.RANDAO, epoch, self.spec, E)
        randao = sk.sign(
            compute_signing_root(
                epoch.to_bytes(8, "little").ljust(32, b"\x00"), randao_domain
            )
        ).to_bytes()
        blk, _post = chain.produce_block_on_state(slot, randao)
        blobs = [
            b"".join(
                self.rng.randrange(FR_MODULUS).to_bytes(32, "big")
                for _ in range(E.FIELD_ELEMENTS_PER_BLOB)
            )
            for _ in range(n_blobs)
        ]
        blk.body.blob_kzg_commitments = [
            kzg.blob_to_kzg_commitment(b) for b in blobs
        ]
        # the grafted commitments change the body root, which the header
        # transition writes into state — recompute the state root the way
        # produce_block_on_state does
        from ..state_processing import (
            BlockSignatureStrategy,
            ConsensusContext,
            per_block_processing,
        )

        post = st.copy()
        ctxt = ConsensusContext(slot)
        ctxt.set_proposer_index(proposer)
        t = chain.types
        tf = t.types_for_fork(t.fork_of_block(blk))
        per_block_processing(
            post,
            tf.SignedBeaconBlock(message=blk),
            self.spec,
            E,
            strategy=BlockSignatureStrategy.NO_VERIFICATION,
            ctxt=ctxt,
            verify_block_root=False,
        )
        blk.state_root = post.hash_tree_root()
        prop_domain = get_domain(
            st, Domain.BEACON_PROPOSER, epoch, self.spec, E
        )
        sig = sk.sign(
            compute_signing_root(blk.hash_tree_root(), prop_domain)
        ).to_bytes()
        signed = tf.SignedBeaconBlock(message=blk, signature=sig)
        root = blk.hash_tree_root()
        sidecars = build_data_column_sidecars(signed, blobs, kzg, E)
        chain.process_data_column_sidecars(root, sidecars)
        chain.process_block(signed)
        node.network.publish_block(signed)
        for sc in sidecars:
            node.network.publish_data_column_sidecar(sc)
        log.info(
            "blob block proposed", slot=slot, node=node.name,
            root=root.hex()[:12], blobs=n_blobs, seed=self.seed,
        )
        return root, sidecars

    # -- plane enforcement -------------------------------------------------

    @staticmethod
    def _connected(node: TestnetNode, port: int) -> bool:
        pid = f"127.0.0.1:{port}"
        return any(p.peer_id == pid for p in node.network.peers.peers())

    def _enforce_disconnects(self):
        """Sever live connections whose edge just went dark — a
        partition is connectivity loss, not polite silence."""
        everyone = [n for n in self.nodes + self.attackers if n.alive]
        for a in everyone:
            for b in everyone:
                if a is b or self.plane.dial_allowed(a.name, b.name):
                    continue
                pid = f"127.0.0.1:{b.network.port}"
                peer = a.network.peers.get(pid)
                if peer is not None:
                    a.network._drop_peer(peer)

    def _reconnect_mesh(self):
        for i, j in self._mesh_edges:
            a, b = self.nodes[i], self.nodes[j]
            if not (a.alive and b.alive):
                continue
            for attempt in range(3):
                if self._connected(a, b.network.port):
                    break
                try:
                    a.network.connect("127.0.0.1", b.network.port)
                    break
                except (RpcError, OSError) as e:
                    # e.g. a still-draining Status rate-limit bucket —
                    # refill and retry before declaring the edge dead
                    if attempt == 2:
                        log.warning(
                            "mesh re-dial failed", edge=(a.name, b.name),
                            error=str(e)[:120],
                        )
                    else:
                        time.sleep(0.3)

    # -- teardown ----------------------------------------------------------

    def shutdown(self):
        self.stop_flood()
        for n in self.nodes + self.attackers:
            try:
                n.client.stop()
            except Exception as e:  # noqa: BLE001 — teardown must finish
                log.warning("node stop failed", node=n.name, error=str(e)[:120])


# ---------------------------------------------------------------------------
# the oracle


#: process-wide counters that must stay FLAT across a scenario: any
#: increase means a node hit an internal fault (our bug, not the
#: adversary's traffic) — the scenarios' strictest invariant
INTERNAL_ERROR_SERIES = (
    "gossip_internal_error_total",
    "beacon_processor_errors_total",
)


class ChainHealthOracle:
    """Asserts chain-health invariants from each node's
    /lighthouse/health `chain` block (one HTTP GET per node — the PR's
    single-endpoint contract), plus the process-wide internal-error
    counters snapshotted at construction."""

    def __init__(self, net: Testnet):
        self.net = net
        self._error_base = self._error_counts()

    @staticmethod
    def _error_counts() -> dict[str, float]:
        out = {}
        for name in INTERNAL_ERROR_SERIES:
            # lint: allow(metric-hygiene) -- reading the fixed module-constant series above, not minting new ones
            out[name] = sum(REGISTRY.counter(name).values().values())
        return out

    def health(self, node: TestnetNode) -> dict:
        with urlopen(node.health_url, timeout=10) as resp:
            return json.loads(resp.read())["data"]

    def chain_block(self, node: TestnetNode) -> dict:
        data = self.health(node)
        if "chain" not in data:
            raise ScenarioFailure(
                f"[seed={self.net.seed}] {node.name}: /lighthouse/health "
                "has no chain block"
            )
        return data["chain"]

    def check(
        self,
        nodes: list[TestnetNode] | None = None,
        *,
        max_head_lag: int | None = None,
        min_participation: float | None = None,
        min_finalized_epoch: int | None = None,
        max_finalized_distance: int | None = None,
        max_reorg_depth: int | None = None,
        max_rss_bytes: int | None = None,
        max_hot_store_bytes: int | None = None,
        require_single_head: bool = False,
        zero_internal_errors: bool = True,
        what: str = "invariants",
    ) -> list[dict]:
        """Evaluate the requested invariant set over `nodes` (default:
        the whole fleet); raises ScenarioFailure listing every violation
        with the scenario seed. Returns the per-node chain blocks so
        scenarios can report them."""
        nodes = nodes if nodes is not None else self.net.live_nodes
        failures = []
        blocks = []
        heads = set()
        for node in nodes:
            data = self.health(node)
            if "chain" not in data:
                raise ScenarioFailure(
                    f"[seed={self.net.seed}] {node.name}: /lighthouse/health "
                    "has no chain block"
                )
            c = data["chain"]
            blocks.append(c)
            if max_rss_bytes is not None:
                # the whole serving tier, not just the calling process:
                # forked API workers report under system.api_workers
                tier = data["rss_bytes"] + data["system"].get(
                    "api_workers", {}
                ).get("rss_total_bytes", 0)
                if tier > max_rss_bytes:
                    failures.append(
                        f"{node.name}: serving-tier RSS {tier} > "
                        f"{max_rss_bytes} (process {data['rss_bytes']}, "
                        f"workers {tier - data['rss_bytes']})"
                    )
            if max_hot_store_bytes is not None:
                # the bounded-store invariant: with the migrator running,
                # the hot side holds only unfinalized data — a hot store
                # past the budget means migration stalled or stopped
                hot = data.get("store", {}).get("hot", {}).get(
                    "total_bytes", 0
                )
                if hot > max_hot_store_bytes:
                    failures.append(
                        f"{node.name}: hot store {hot} bytes > "
                        f"{max_hot_store_bytes} (split_slot "
                        f"{data.get('store', {}).get('split_slot')})"
                    )
            heads.add(c["head_root"])
            if max_head_lag is not None and c["head_lag_slots"] > max_head_lag:
                failures.append(
                    f"{node.name}: head lag {c['head_lag_slots']} > "
                    f"{max_head_lag} (head {c['head_slot']}, clock "
                    f"{c['clock_slot']})"
                )
            part = c["participation_prev_epoch"]
            if min_participation is not None and (
                part is None or part < min_participation
            ):
                failures.append(
                    f"{node.name}: participation {part} < {min_participation}"
                )
            if (
                min_finalized_epoch is not None
                and c["finalized_epoch"] < min_finalized_epoch
            ):
                failures.append(
                    f"{node.name}: finalized epoch {c['finalized_epoch']} < "
                    f"{min_finalized_epoch}"
                )
            if (
                max_finalized_distance is not None
                and c["finalized_distance_epochs"] > max_finalized_distance
            ):
                failures.append(
                    f"{node.name}: finality distance "
                    f"{c['finalized_distance_epochs']} > {max_finalized_distance}"
                )
            if (
                max_reorg_depth is not None
                and c["max_reorg_depth"] > max_reorg_depth
            ):
                failures.append(
                    f"{node.name}: reorg depth {c['max_reorg_depth']} > "
                    f"{max_reorg_depth}"
                )
        if require_single_head and len(heads) != 1:
            failures.append(f"heads diverged: {sorted(heads)}")
        if zero_internal_errors:
            now = self._error_counts()
            for name, base in self._error_base.items():
                if now[name] > base:
                    failures.append(
                        f"internal errors: {name} rose {base} -> {now[name]}"
                    )
        if failures:
            inc_counter("scenario_invariant_checks_total", result="fail")
            msg = "; ".join(failures)
            log.error(
                "oracle check failed — replay with "
                f"LIGHTHOUSE_TPU_SCENARIO_SEED={self.net.seed}",
                what=what,
            )
            raise ScenarioFailure(f"[seed={self.net.seed}] {what}: {msg}")
        inc_counter("scenario_invariant_checks_total", result="pass")
        return blocks


# ---------------------------------------------------------------------------
# scripted scenarios (the tests drive these; chip_smoke.py's fleet phase
# drives the smoke, equivocation and column-withholding ones on the card)


def _finalized_epochs(net: Testnet) -> list[int]:
    return [int(n.chain.finalized_checkpoint.epoch) for n in net.nodes]


def run_smoke_scenario(
    spec, E, *, seed: int = 101, bls_backend: str = "fake_crypto"
) -> dict:
    """Tier-1 scenario_smoke: 3 nodes run healthy for 2 epochs (single
    head, finality moving), take a short partition that forks the fleet,
    heal, and converge with finality advancing — the whole tentpole
    contract at the smallest shape that still exercises it. `bls_backend`
    is every node's (the JAX package's runners always use fake_crypto)."""
    net = Testnet.create(
        spec, E, node_count=3, validator_count=24, seed=seed,
        bls_backend=bls_backend,
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(2 * S, start_slot=1)
        oracle.check(
            max_head_lag=1,
            min_participation=0.9,
            min_finalized_epoch=0,
            require_single_head=True,
            what="healthy baseline",
        )
        fin_before = max(_finalized_epochs(net))
        # seeded split: one node alone vs the majority pair
        lone = net.rng.choice(net.nodes).name
        rest = [n.name for n in net.nodes if n.name != lone]
        net.partition([lone], rest)
        net.run_until_slot(2 * S + S // 2, start_slot=2 * S + 1)
        net.heal()
        recovery = _run_to_convergence(net, oracle, start_slot=2 * S + S // 2 + 1)
        oracle.check(
            require_single_head=True,
            min_finalized_epoch=fin_before + 1,
            max_reorg_depth=S,
            what="post-heal convergence",
        )
        return {"seed": net.seed, **recovery}
    finally:
        net.shutdown()


def _run_to_convergence(
    net: Testnet,
    oracle: ChainHealthOracle,
    start_slot: int,
    max_epochs: int = 6,
    min_finalized_advance: int = 1,
    min_finalized_epoch: int = 0,
) -> dict:
    """Post-heal driver: keep running slots until every node shares one
    head AND finality advanced `min_finalized_advance` past the heal
    point (and past the absolute `min_finalized_epoch` floor, for
    scenarios that must finalize BEYOND a specific slot — e.g. so
    finality pruning provably covers a withheld block's epoch).
    Returns recovery timings."""
    E = net.E
    S = E.SLOTS_PER_EPOCH
    fin_at_heal = max(_finalized_epochs(net))
    fin_target = max(fin_at_heal + min_finalized_advance, min_finalized_epoch)
    t0 = time.perf_counter()
    converged_at = None
    slot = start_slot
    for slot in range(start_slot, start_slot + max_epochs * S):
        net.run_slot(slot)
        heads = {n.chain.head_root for n in net.nodes}
        if len(heads) == 1 and converged_at is None:
            converged_at = time.perf_counter() - t0
        if len(heads) == 1 and min(_finalized_epochs(net)) >= fin_target:
            return {
                "recovery_slots": slot - start_slot + 1,
                "head_convergence_s": round(converged_at, 3),
                "recovery_to_finality_s": round(time.perf_counter() - t0, 3),
            }
    raise ScenarioFailure(
        f"[seed={net.seed}] fleet did not re-converge within "
        f"{max_epochs} epochs of heal (heads="
        f"{ {n.name: n.chain.head_root.hex()[:8] for n in net.nodes} }, "
        f"finalized={_finalized_epochs(net)}, fin_at_heal={fin_at_heal})"
    )


def run_churn_soak_scenario(
    spec,
    E,
    *,
    seed: int = 0,
    node_count: int = 5,
    churn_rounds: int = 3,
    max_rss_bytes: int | None = None,
) -> dict:
    """Wall-clock-compressed fleet churn soak on a disk-backed testnet:
    every round one node (~20% of the default fleet) is killed with its
    KV store kept, the fleet runs an epoch without it, and it restarts
    from disk and catches back up — while the oracle asserts finality
    never stalls, heads reconverge, hot-store size stays bounded (the
    migrator keeps moving finalized data cold through the churn), and the
    serving tier's RSS stays under budget. Returns the soak's numbers."""
    import shutil
    import tempfile

    db_dir = tempfile.mkdtemp(prefix="lighthouse_tpu_torch_churn_")
    net = Testnet.create(
        spec,
        E,
        node_count=node_count,
        validator_count=4 * node_count,
        seed=seed,
        db_dir=db_dir,
    )
    S = E.SLOTS_PER_EPOCH
    t0 = time.perf_counter()
    try:
        oracle = ChainHealthOracle(net)

        def hot_bytes() -> int:
            return max(
                oracle.health(n)
                .get("store", {})
                .get("hot", {})
                .get("total_bytes", 0)
                for n in net.live_nodes
            )

        def fin_min() -> int:
            return min(
                int(n.chain.finalized_checkpoint.epoch)
                for n in net.live_nodes
            )

        def run_until_finality(start: int, target: int, what: str) -> int:
            """Drive slots until every live node finalizes >= target AND
            shares one head (bounded by 6 epochs — finality takes ~4
            epochs of runway from a standing start)."""
            slot = start
            for slot in range(start, start + 6 * S):
                net.run_slot(slot)
                heads = {n.chain.head_root for n in net.live_nodes}
                if len(heads) == 1 and fin_min() >= target:
                    return slot
            raise ScenarioFailure(
                f"[seed={net.seed}] {what}: finality stalled at "
                f"{fin_min()} (target {target}) by slot {slot}"
            )

        slot = run_until_finality(1, 1, "churn warmup")
        oracle.check(
            min_participation=0.9,
            require_single_head=True,
            min_finalized_epoch=1,
            what="churn baseline",
        )
        # the post-finality hot footprint: with the migrator on, churn
        # must not grow it past a small multiple of this
        baseline_hot = hot_bytes()
        hot_sizes = [baseline_hot]
        for round_i in range(churn_rounds):
            victim = net.rng.choice(net.live_nodes).name
            fin_before = fin_min()
            net.kill(victim)
            # one epoch without the victim: 80% of stake keeps attesting
            net.run_until_slot(slot + S, start_slot=slot + 1)
            slot += S
            net.restart(victim)
            net.settle(timeout=10.0)
            # drive until the restarted node is back on the single head
            # and finality moved past the pre-kill point
            slot = run_until_finality(
                slot + 1, fin_before + 1, f"churn round {round_i}"
            )
            oracle.check(
                require_single_head=True,
                min_finalized_epoch=fin_before + 1,
                max_hot_store_bytes=4 * max(baseline_hot, 1),
                max_rss_bytes=max_rss_bytes,
                what=f"churn round {round_i} ({victim})",
            )
            hot_sizes.append(hot_bytes())
        wall_s = time.perf_counter() - t0
        fin_final = fin_min()
        return {
            "seed": net.seed,
            "wall_s": round(wall_s, 3),
            "churn_rounds": churn_rounds,
            "finalized_epoch_min": fin_final,
            "finalized_slots_per_wall_s": round(fin_final * S / wall_s, 3),
            "hot_store_bytes": hot_sizes,
            "hot_store_growth": round(
                hot_sizes[-1] / max(baseline_hot, 1), 3
            ),
        }
    finally:
        net.shutdown()
        shutil.rmtree(db_dir, ignore_errors=True)


def run_partition_heal_scenario(
    spec,
    E,
    *,
    node_count: int = 6,
    validator_count: int = 36,
    seed: int = 1,
    partition_epochs: int = 1,
) -> dict:
    """Halves build competing forks, heal, converge to ONE head with
    finality advancing — the proto-array reorg regime at fleet scale."""
    net = Testnet.create(
        spec, E, node_count=node_count, validator_count=validator_count, seed=seed
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(2 * S, start_slot=1)
        oracle.check(
            require_single_head=True,
            min_participation=0.9,
            min_finalized_epoch=0,
            what="healthy baseline",
        )
        fin_before = max(_finalized_epochs(net))
        # seeded uneven split: majority side keeps > half the validators
        names = [n.name for n in net.nodes]
        net.rng.shuffle(names)
        cut = node_count // 2 + 1
        side_a, side_b = names[:cut], names[cut:]
        net.partition(side_a, side_b)
        part_start = 2 * S + 1
        net.run_until_slot(2 * S + partition_epochs * S, start_slot=part_start)
        heads_a = {net.node(nm).chain.head_root for nm in side_a}
        heads_b = {net.node(nm).chain.head_root for nm in side_b}
        if heads_a & heads_b:
            raise ScenarioFailure(
                f"[seed={net.seed}] partition built no competing forks "
                f"(halves share a head) — the scenario proved nothing"
            )
        net.heal()
        recovery = _run_to_convergence(
            net, oracle, start_slot=2 * S + partition_epochs * S + 1
        )
        blocks = oracle.check(
            require_single_head=True,
            min_finalized_epoch=fin_before + 1,
            max_reorg_depth=(partition_epochs + 1) * S,
            what="post-heal convergence",
        )
        return {
            "seed": net.seed,
            "sides": [side_a, side_b],
            "max_reorg_depth": max(c["max_reorg_depth"] for c in blocks),
            **recovery,
        }
    finally:
        net.shutdown()


def run_eclipse_scenario(
    spec,
    E,
    *,
    node_count: int = 4,
    validator_count: int = 32,
    seed: int = 2,
    eclipse_epochs: int = 3,
) -> dict:
    """A victim is eclipsed behind lying attacker peers: the honest fleet
    keeps finalizing, the victim falls behind (lag grows, its sync runs
    fail against the liars), and once honest peers are re-admitted it
    recovers to the fleet head."""
    net = Testnet.create(
        spec,
        E,
        node_count=node_count,
        validator_count=validator_count,
        seed=seed,
        attacker_count=2,
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(S, start_slot=1)
        oracle.check(require_single_head=True, what="healthy baseline")
        victim = net.rng.choice(net.nodes).name
        honest = [n for n in net.nodes if n.name != victim]
        net.eclipse(victim, [a.name for a in net.attackers])
        # run the eclipse until honest finality MOVES (capped): at 3/4
        # participation, justification timing rides the attestation
        # inclusion tail, so a fixed end slot flakes by an epoch
        end = S + eclipse_epochs * S
        net.run_until_slot(end, start_slot=S + 1)
        while end < S + (eclipse_epochs + 3) * S and not all(
            int(n.chain.finalized_checkpoint.epoch) >= 1
            for n in net.nodes
            if n.name != victim
        ):
            end += 1
            net.run_slot(end)
        vic = net.node(victim)
        # the victim is dark: strictly behind the honest fleet, and on
        # its OWN fork (it keeps self-proposing with its key share, so
        # head-slot lag alone would be a weak isolation proof)
        honest_head_slot = max(int(n.chain.head_state.slot) for n in honest)
        victim_gap = honest_head_slot - int(vic.chain.head_state.slot)
        if victim_gap <= 0:
            raise ScenarioFailure(
                f"[seed={net.seed}] eclipse leaked: victim kept pace "
                f"(gap={victim_gap})"
            )
        if vic.chain.head_root in {n.chain.head_root for n in honest}:
            raise ScenarioFailure(
                f"[seed={net.seed}] eclipse leaked: victim shares the "
                "honest head"
            )
        # at 3/4 participation justification needs the full inclusion
        # tail, so finality trails the boundary by an extra epoch — the
        # invariant is that it MOVES, not that it is prompt
        oracle.check(
            nodes=honest,
            require_single_head=True,
            min_finalized_epoch=1,
            what="honest fleet under eclipse",
        )
        failed_runs_during = REGISTRY.counter("sync_service_runs_total").value(
            result="failed"
        )
        net.heal()
        # keep the chain moving while the victim catches up
        recovery = _run_to_convergence(net, oracle, start_slot=end + 1)
        oracle.check(
            require_single_head=True,
            max_head_lag=1,
            what="victim recovered",
        )
        return {
            "seed": net.seed,
            "victim": victim,
            "victim_gap_slots": victim_gap,
            "sync_failed_runs_during_eclipse": failed_runs_during,
            **recovery,
        }
    finally:
        net.shutdown()


def run_late_delivery_scenario(
    spec,
    E,
    *,
    node_count: int = 4,
    validator_count: int = 32,
    seed: int = 3,
    delay_s: float = 0.35,
    delayed_epochs: int = 1,
) -> dict:
    """Every gossip frame to/from one node arrives `delay_s` late while
    the fleet paces slots faster than that: blocks and attestations land
    outside their propagation windows, are IGNOREd/parked — never
    internal errors — and the fleet re-converges once the delay lifts."""
    net = Testnet.create(
        spec, E, node_count=node_count, validator_count=validator_count, seed=seed
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(S, start_slot=1)
        oracle.check(require_single_head=True, what="healthy baseline")
        ignored_before = REGISTRY.counter("gossip_ignored_total").value()
        laggard = net.rng.choice(net.nodes).name
        net.delay_edges_of(laggard, delay_s)
        end = S + delayed_epochs * S
        for slot in range(S + 1, end + 1):
            net.set_slot(slot)
            for n in net.nodes:
                try:
                    n.vc.block_service.propose_if_due(slot)
                except Exception:  # noqa: BLE001 — scenario-normal misses
                    pass
            # pace faster than the injected delay: no settle barrier, so
            # the laggard's frames genuinely arrive in later slots
            time.sleep(min(delay_s / 3, 0.1))
            for n in net.nodes:
                try:
                    n.vc.attestation_service.attest(slot, n.chain.head_root)
                except Exception:  # noqa: BLE001
                    pass
        net.heal()
        recovery = _run_to_convergence(net, oracle, start_slot=end + 1)
        oracle.check(
            require_single_head=True,
            max_head_lag=1,
            what="post-delay convergence",
        )
        ignored_delta = (
            REGISTRY.counter("gossip_ignored_total").value() - ignored_before
        )
        return {
            "seed": net.seed,
            "laggard": laggard,
            "gossip_ignored_delta": ignored_delta,
            **recovery,
        }
    finally:
        net.shutdown()


def run_gossip_flood_scenario(
    spec,
    E,
    *,
    node_count: int = 4,
    validator_count: int = 32,
    seed: int = 4,
    flood_epochs: int = 3,
) -> dict:
    """Attacker nodes sustain an unknown-root attestation flood into the
    fleet's gossip lanes while duties keep running: the chain must keep
    finalizing, the excess must shed through counted drops (reprocess
    caps, processor backpressure) — never internal errors, never a hang."""
    net = Testnet.create(
        spec,
        E,
        node_count=node_count,
        validator_count=validator_count,
        seed=seed,
        attacker_count=2,
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(S, start_slot=1)
        oracle.check(require_single_head=True, what="healthy baseline")
        shed_before = _flood_shed_counters()
        net.start_flood()
        # half an epoch of margin past the last boundary: finality lands
        # fin(N-2) entering epoch N on this chain's justification cadence
        end = S + flood_epochs * S + S // 2
        net.run_until_slot(end, start_slot=S + 1)
        net.stop_flood()
        blocks = oracle.check(
            require_single_head=True,
            min_finalized_epoch=flood_epochs - 2,
            min_participation=0.8,
            what="fleet under flood",
        )
        shed_delta = {
            k: v - shed_before[k] for k, v in _flood_shed_counters().items()
        }
        if net.flood_sent and not any(shed_delta.values()):
            # nothing held/dropped/ignored — the flood never landed
            raise ScenarioFailure(
                f"[seed={net.seed}] flood sent {net.flood_sent} messages "
                f"but no shed counter moved: {shed_delta}"
            )
        recovery = _run_to_convergence(net, oracle, start_slot=end + 1)
        return {
            "seed": net.seed,
            "flood_sent": net.flood_sent,
            "shed": shed_delta,
            "finalized": [c["finalized_epoch"] for c in blocks],
            **recovery,
        }
    finally:
        net.shutdown()


def _flood_shed_counters() -> dict[str, float]:
    return {
        "gossip_ignored_total": REGISTRY.counter("gossip_ignored_total").value(),
        "reprocess_held_total": REGISTRY.counter("reprocess_held_total").value(),
        "dropped_gossip_attestation": REGISTRY.counter(
            "beacon_processor_dropped_total"
        ).value(kind="gossip_attestation"),
    }


def run_equivocation_scenario(
    spec,
    E,
    *,
    node_count: int = 3,
    validator_count: int = 24,
    seed: int = 5,
    bls_backend: str = "fake_crypto",
) -> dict:
    """A proposer signs two competing blocks; both ride gossip to an
    OBSERVER node running the slasher, whose SLASHER_PROCESS lane must
    emit exactly ONE ProposerSlashing into its op pool — the end-to-end
    gossip → detection → emission contract. `bls_backend` is every
    node's (the JAX package's runners always use fake_crypto)."""
    net = Testnet.create(
        spec,
        E,
        node_count=node_count,
        validator_count=validator_count,
        seed=seed,
        slasher_nodes={1},  # observer only: proves gossip delivery
        bls_backend=bls_backend,
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        observer = net.nodes[1]
        found_before = REGISTRY.counter("slasher_slashings_found_total").value(
            kind="proposer"
        )
        cycles_before = _slasher_cycles()
        net.run_until_slot(S, start_slot=1)
        # seeded equivocation slot inside epoch 1, proposed from node0
        eq_slot = S + 1 + net.rng.randrange(S - 1)
        for slot in range(S + 1, 2 * S + 1):
            if slot == eq_slot:
                net.set_slot(slot)
                proposer = net.equivocate(slot, node_name="node0")
                net.run_slot(slot, propose=False)
            else:
                net.run_slot(slot)
        # both blocks must have reached the observer via gossip
        net.wait_for(
            lambda: sum(
                1
                for b in observer.chain._blocks_by_root.values()
                if int(b.message.slot) == eq_slot
            )
            >= 2,
            what="observer imported both equivocating blocks",
        )
        # cross the epoch edge: the slasher claims+processes epoch 1 on
        # its SLASHER_PROCESS lane at the first tick of epoch 2
        net.run_until_slot(3 * S, start_slot=2 * S + 1)
        net.wait_for(
            lambda: REGISTRY.counter("slasher_slashings_found_total").value(
                kind="proposer"
            )
            >= found_before + 1,
            what="proposer slashing emitted",
        )
        # exactly one — the dedup contract, across another full epoch of
        # cycles re-seeing the same header pair
        net.run_until_slot(4 * S, start_slot=3 * S + 1)
        found_delta = (
            REGISTRY.counter("slasher_slashings_found_total").value(
                kind="proposer"
            )
            - found_before
        )
        if found_delta != 1:
            raise ScenarioFailure(
                f"[seed={net.seed}] expected exactly 1 proposer slashing, "
                f"got {found_delta}"
            )
        # the emission either still sits in the observer's op pool, or a
        # proposal already packed it and the validator is slashed on
        # chain (the pool prunes included ops) — both complete the loop
        pooled = proposer in observer.chain.op_pool._proposer_slashings
        on_chain = bool(observer.chain.head_state.validators[proposer].slashed)
        if not (pooled or on_chain):
            raise ScenarioFailure(
                f"[seed={net.seed}] proposer {proposer}'s slashing neither "
                "pooled on the observer nor included on chain"
            )
        lane_cycles = _slasher_cycles() - cycles_before
        if lane_cycles <= 0:
            raise ScenarioFailure(
                f"[seed={net.seed}] no SLASHER_PROCESS cycles ran"
            )
        oracle.check(require_single_head=True, what="fleet after equivocation")
        return {
            "seed": net.seed,
            "equivocation_slot": eq_slot,
            "proposer": proposer,
            "slashings_emitted": found_delta,
            "slasher_cycles": lane_cycles,
        }
    finally:
        net.shutdown()


def _slasher_cycles() -> float:
    c = REGISTRY.counter("slasher_process_cycles_total")
    return c.value(engine="columnar") + c.value(engine="reference")


class DasTestnetEthSpec(MinimalEthSpec):
    """Scenario-sized PeerDAS preset: tiny blobs over a 16-column matrix
    so a whole fleet verifies, samples, and reconstructs within a slot's
    scenario pacing. The refusal/recovery arithmetic still holds exactly:
    custody 2 + samples 3 against 16 columns means a sub-50% kept set can
    NEVER satisfy custody+sampling (kept \\ custody < samples whenever
    custody fits in 4 kept columns), and >=8 kept columns always
    reconstructs."""

    FIELD_ELEMENTS_PER_BLOB = 64
    NUMBER_OF_COLUMNS = 16
    DATA_COLUMN_SIDECAR_SUBNET_COUNT = 8
    CUSTODY_REQUIREMENT = 2
    SAMPLES_PER_SLOT = 3


def run_column_withholding_scenario(
    spec,
    E,
    *,
    node_count: int = 3,
    validator_count: int = 24,
    seed: int = 6,
    withhold_fraction: float = 0.75,
    recover_fraction: float = 0.375,
    bls_backend: str = "fake_crypto",
    kzg: str = "dev",
) -> dict:
    """The PeerDAS data-withholding regime, both sides of the 50% line.

    An adversary node proposes blob-carrying blocks but withholds a
    fraction of the column sidecars (suppressed at publish, refused over
    RPC). Regime 1 (`withhold_fraction` > 50%): honest nodes must REFUSE
    the head — custody+sampling cannot complete and reconstruction is
    impossible — while the chain keeps finalizing past the orphan.
    Regime 2 (`recover_fraction` < 50% withheld): the kept majority
    reconstructs the full matrix (das_reconstructions_total rises) and
    the block imports fleet-wide. `spec` must be Deneb-from-genesis and
    `E` a DAS-sized preset (DasTestnetEthSpec). `bls_backend` and `kzg` are
    every node's (the JAX package's runners always use fake_crypto and the
    dev setup)."""
    net = Testnet.create(
        spec,
        E,
        node_count=node_count,
        validator_count=validator_count,
        seed=seed,
        bls_backend=bls_backend,
        kzg=kzg,
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(S, start_slot=1)
        oracle.check(require_single_head=True, what="healthy baseline")
        adversary = net.nodes[0].name
        honest = [n for n in net.nodes if n.name != adversary]
        counters = lambda: {  # noqa: E731 — three snapshots of one shape
            "reconstructions": REGISTRY.counter(
                "das_reconstructions_total"
            ).value(),
            "sampling_failures": REGISTRY.counter(
                "das_sampling_results_total"
            ).value(verdict="failure"),
            "cells_batched": REGISTRY.counter(
                "das_cells_verified_total"
            ).value(path="batched"),
        }
        fin_before = max(_finalized_epochs(net))

        # -- regime 1: sub-50% kept -> the fleet refuses the head
        base = counters()
        withheld = net.withhold_columns(adversary, withhold_fraction)
        wh_slot = S + 1
        net.set_slot(wh_slot)
        withheld_root, _ = net.propose_blob_block(wh_slot, node_name=adversary)
        net.run_slot(wh_slot, propose=False)
        # a couple more slots: slot-edge sampling retries must keep
        # failing, and the honest chain must keep proposing past the hole
        net.run_until_slot(wh_slot + 2, start_slot=wh_slot + 1)
        if not net.node(adversary).chain.fork_choice.contains_block(
            withheld_root
        ):
            raise ScenarioFailure(
                f"[seed={net.seed}] adversary refused its own blob block — "
                "harness bug, nothing was tested"
            )
        for n in honest:
            if n.chain.fork_choice.contains_block(withheld_root):
                raise ScenarioFailure(
                    f"[seed={net.seed}] {n.name} imported the withheld head "
                    f"(withheld={list(withheld)})"
                )
        mid = counters()
        if mid["sampling_failures"] <= base["sampling_failures"]:
            raise ScenarioFailure(
                f"[seed={net.seed}] no sampling failure recorded against "
                "the withholding proposer"
            )
        if mid["reconstructions"] != base["reconstructions"]:
            raise ScenarioFailure(
                f"[seed={net.seed}] reconstruction fired below the 50% "
                "threshold"
            )
        # finality pruning only provably drops the withheld block once the
        # finalized slot is PAST wh_slot: drive to (wh_epoch + 1) at least
        wh_epoch = wh_slot // S
        refusal_recovery = _run_to_convergence(
            net,
            oracle,
            start_slot=wh_slot + 3,
            min_finalized_epoch=wh_epoch + 1,
        )
        oracle.check(
            require_single_head=True,
            min_finalized_epoch=max(fin_before + 1, wh_epoch + 1),
            what="chain finalized past the withheld head",
        )
        for n in honest:
            if n.chain.data_availability_checker.has_pending(withheld_root):
                raise ScenarioFailure(
                    f"[seed={net.seed}] {n.name} still stages the orphaned "
                    "withheld block after finality pruning"
                )

        # -- regime 2: >=50% kept -> reconstruction promotes, fleet imports
        net.heal()
        fin_mid = max(_finalized_epochs(net))
        net.withhold_columns(adversary, recover_fraction)
        rec_slot = int(net.nodes[0].client.slot_clock.now()) + 1
        net.set_slot(rec_slot)
        recovered_root, _ = net.propose_blob_block(
            rec_slot, node_name=adversary
        )
        net.run_slot(rec_slot, propose=False)
        net.wait_for(
            lambda: all(
                n.chain.fork_choice.contains_block(recovered_root)
                for n in net.nodes
            ),
            what="fleet-wide import of the >=50% column set via reconstruction",
        )
        post = counters()
        if post["reconstructions"] <= mid["reconstructions"]:
            raise ScenarioFailure(
                f"[seed={net.seed}] no reconstruction promoted the kept "
                "column majority"
            )
        if post["cells_batched"] <= base["cells_batched"]:
            raise ScenarioFailure(
                f"[seed={net.seed}] no cells rode the batched verification "
                "lane"
            )
        net.heal()
        recovery = _run_to_convergence(net, oracle, start_slot=rec_slot + 1)
        oracle.check(
            require_single_head=True,
            min_finalized_epoch=fin_mid + 1,
            what="post-recovery convergence",
        )
        return {
            "seed": net.seed,
            "adversary": adversary,
            "withheld_refusal": list(withheld),
            "sampling_failures": mid["sampling_failures"]
            - base["sampling_failures"],
            "reconstructions": post["reconstructions"]
            - mid["reconstructions"],
            "refusal_recovery_slots": refusal_recovery["recovery_slots"],
            **recovery,
        }
    finally:
        net.shutdown()


def _is_ancestor(chain, root: bytes, head: bytes) -> bool:
    """Walk `head`'s parent links in the chain's block store."""
    cur = bytes(head)
    root = bytes(root)
    while cur in chain._blocks_by_root:
        if cur == root:
            return True
        cur = bytes(chain._blocks_by_root[cur].message.parent_root)
    return cur == root


def run_late_proposer_scenario(
    spec,
    E,
    *,
    node_count: int = 4,
    validator_count: int = 32,
    seed: int = 8,
) -> dict:
    """A proposer withholds its block past the attestation deadline: the
    slot's committee, having seen nothing, attests to the PARENT; the
    block limps in with no proposer boost; and the NEXT slot's proposer —
    observing a weak, late, single-slot head over a strong parent (spec
    `get_proposer_head`) — builds on the parent, orphaning the late
    block while the fleet single-heads and finality keeps advancing.
    The parent votes reach every node as same-slot gossip, so the
    fork-choice deferral queue (not the op pool) is what carries them
    into the re-org decision."""
    from ..fork_choice.fork_choice import _total_balance
    from ..state_processing import per_slot_processing
    from ..state_processing.accessors import get_beacon_proposer_index

    net = Testnet.create(
        spec, E, node_count=node_count, validator_count=validator_count, seed=seed
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(S, start_slot=1)
        oracle.check(require_single_head=True, what="healthy baseline")

        # a locally-produced head is never re-orged (no gossip
        # observation), so the late slot's proposer and the NEXT slot's
        # proposer must sit on different nodes; keys are dealt in
        # contiguous shares, so the owner is index // share
        share = validator_count // node_count

        def proposer_node(slot: int) -> int:
            st = net.nodes[0].chain.head_state.copy()
            while st.slot < slot:
                per_slot_processing(st, spec, E)
            return min(get_beacon_proposer_index(st, E) // share, node_count - 1)

        # the regime needs a clean launch pad: one converged head AT the
        # slot before the late one (a straggler block or missed proposal
        # makes the single-slot re-org premise ragged), with the late and
        # re-org proposers on different nodes
        late_slot = S + 1
        while True:
            net.settle()
            heads = {n.chain.head_root for n in net.nodes}
            if (
                len(heads) == 1
                and int(net.nodes[0].chain.head_state.slot) == late_slot - 1
                and proposer_node(late_slot) != proposer_node(late_slot + 1)
            ):
                break
            if late_slot > 4 * S:
                raise ScenarioFailure(
                    f"[seed={net.seed}] no usable late slot found by "
                    f"{late_slot} (heads={len(heads)})"
                )
            net.run_slot(late_slot)
            late_slot += 1
        parent = net.nodes[0].chain.head_root
        deadline = net.nodes[0].client.slot_clock.attestation_deadline_offset
        deferred_before = REGISTRY.counter(
            "fork_choice_deferred_attestations_total"
        ).value(outcome="applied")

        # the late slot, in wall-clock order: attesters fire at the
        # deadline with no block in sight (head vote = parent) ...
        net.set_slot(late_slot)
        for n in net.nodes:
            try:
                n.vc.attestation_service.attest(late_slot, n.chain.head_root)
                n.vc.attestation_service.aggregate_if_selected(late_slot)
            except Exception as e:  # noqa: BLE001 — scenario-normal misses
                log.info("attestation missed", node=n.name, error=str(e)[:120])
        net.settle()
        # ... then the block limps in past the deadline on every clock:
        # observed offsets land late, timeliness (and the boost) is lost
        for n in net.nodes + net.attackers:
            n.client.slot_clock.set_seconds_into_slot(deadline + 1.0)
        late_root = None
        for n in net.nodes:
            try:
                r = n.vc.block_service.propose_if_due(late_slot)
                late_root = r if r is not None else late_root
            except Exception as e:  # noqa: BLE001
                log.info("proposal missed", node=n.name, error=str(e)[:120])
        if late_root is None:
            raise ScenarioFailure(
                f"[seed={net.seed}] no block proposed at the late slot"
            )
        # settle() keys on head EQUALITY, which already holds while the
        # late block is still in flight (every head == parent): wait for
        # the adoption itself
        net.wait_for(
            lambda: all(n.chain.head_root == late_root for n in net.nodes),
            what="late block adopted fleet-wide",
        )

        # next slot, early enough to win the boost: the proposer re-orgs
        for n in net.nodes + net.attackers:
            n.client.slot_clock.set_seconds_into_slot(0.0)
        net.set_slot(late_slot + 1)

        # the parent votes ride gossip through each node's processor
        # lanes into the deferral queue — wait until a recompute (tick +
        # drain, exactly what the proposer's decision path runs) shows
        # the parent past the re-org strength threshold on EVERY node,
        # or the decision races the very votes that justify it
        def _parent_votes_drained() -> bool:
            for n in net.nodes:
                n.chain.recompute_head()
                fc = n.chain.fork_choice
                pa = fc.proto.proto_array
                pi = pa.indices.get(parent)
                if pi is None:
                    return False
                cw = _total_balance(fc._justified_balances) // S
                needed = cw * n.chain.spec.reorg_parent_weight_threshold // 100
                if int(pa._weights[pi]) <= needed:
                    return False
            return True

        net.wait_for(
            _parent_votes_drained,
            what="parent votes drained into fork-choice weights",
        )
        reorg_root = None
        for n in net.nodes:
            try:
                r = n.vc.block_service.propose_if_due(late_slot + 1)
                reorg_root = r if r is not None else reorg_root
            except Exception as e:  # noqa: BLE001
                log.info("proposal missed", node=n.name, error=str(e)[:120])
        if reorg_root is None:
            raise ScenarioFailure(
                f"[seed={net.seed}] no block proposed at the re-org slot"
            )
        net.wait_for(
            lambda: all(
                reorg_root in n.chain._blocks_by_root for n in net.nodes
            ),
            what="re-org block imported fleet-wide",
        )
        reorg_block = net.nodes[0].chain._blocks_by_root[reorg_root].message
        if bytes(reorg_block.parent_root) != bytes(parent):
            raise ScenarioFailure(
                f"[seed={net.seed}] re-org block built on "
                f"{bytes(reorg_block.parent_root).hex()[:8]}, not the "
                f"parent {bytes(parent).hex()[:8]} — late head survived"
            )
        for n in net.nodes:
            try:
                n.vc.attestation_service.attest(
                    late_slot + 1, n.chain.head_root
                )
                n.vc.attestation_service.aggregate_if_selected(late_slot + 1)
            except Exception as e:  # noqa: BLE001
                log.info("attestation missed", node=n.name, error=str(e)[:120])
        net.settle()
        heads = {n.chain.head_root for n in net.nodes}
        if heads != {reorg_root}:
            raise ScenarioFailure(
                f"[seed={net.seed}] fleet did not converge on the re-org "
                f"block (heads={sorted(h.hex()[:8] for h in heads)})"
            )
        deferred_applied = (
            REGISTRY.counter("fork_choice_deferred_attestations_total").value(
                outcome="applied"
            )
            - deferred_before
        )
        if deferred_applied <= 0:
            raise ScenarioFailure(
                f"[seed={net.seed}] no deferred attestations were applied "
                "— the parent votes never reached fork choice"
            )

        # the chain keeps finalizing over the depth-1 re-org
        recovery = _run_to_convergence(net, oracle, start_slot=late_slot + 2)
        blocks = oracle.check(
            require_single_head=True,
            min_finalized_epoch=1,
            max_reorg_depth=1,
            what="post-reorg health",
        )
        for n in net.nodes:
            if _is_ancestor(n.chain, late_root, n.chain.head_root):
                raise ScenarioFailure(
                    f"[seed={net.seed}] {n.name}: orphaned late block "
                    "re-entered the canonical chain"
                )
        return {
            "seed": net.seed,
            "late_slot": late_slot,
            "deferred_applied": deferred_applied,
            "finalized": [c["finalized_epoch"] for c in blocks],
            **recovery,
        }
    finally:
        net.shutdown()


def run_production_under_flood_scenario(
    spec,
    E,
    *,
    node_count: int = 4,
    validator_count: int = 32,
    seed: int = 9,
    flood_epochs: int = 3,
    max_mean_production_s: float = 1.0,
) -> dict:
    """Attacker nodes flood the gossip lanes while proposals keep
    coming due: every slot's block must still be produced and published
    (the STATE_ADVANCE lane and block_production pipeline share workers
    with the flood's shed queues), the `block_production` trace root
    must keep a bounded mean, and the chain must single-head and
    finalize through it."""
    net = Testnet.create(
        spec,
        E,
        node_count=node_count,
        validator_count=validator_count,
        seed=seed,
        attacker_count=2,
    )
    try:
        oracle = ChainHealthOracle(net)
        S = E.SLOTS_PER_EPOCH
        net.run_until_slot(S, start_slot=1)
        oracle.check(require_single_head=True, what="healthy baseline")
        hist = REGISTRY.histogram("trace_span_seconds_block_production")
        _, _, count_before, sum_before = hist.snapshot()
        published_before = REGISTRY.counter("vc_blocks_published_total").value()
        shed_before = _flood_shed_counters()
        net.start_flood()
        end = S + flood_epochs * S + S // 2
        net.run_until_slot(end, start_slot=S + 1)
        net.stop_flood()
        _, _, count_after, sum_after = hist.snapshot()
        published = (
            REGISTRY.counter("vc_blocks_published_total").value()
            - published_before
        )
        produced = count_after - count_before
        flood_slots = end - S
        if published < flood_slots * 0.9:
            raise ScenarioFailure(
                f"[seed={net.seed}] only {published:.0f}/{flood_slots} "
                "proposals published under flood"
            )
        mean_s = (sum_after - sum_before) / max(produced, 1)
        if mean_s > max_mean_production_s:
            raise ScenarioFailure(
                f"[seed={net.seed}] mean block production "
                f"{mean_s * 1000:.0f} ms under flood exceeds "
                f"{max_mean_production_s * 1000:.0f} ms"
            )
        shed_delta = {
            k: v - shed_before[k] for k, v in _flood_shed_counters().items()
        }
        if net.flood_sent and not any(shed_delta.values()):
            raise ScenarioFailure(
                f"[seed={net.seed}] flood sent {net.flood_sent} messages "
                f"but no shed counter moved: {shed_delta}"
            )
        blocks = oracle.check(
            require_single_head=True,
            min_finalized_epoch=flood_epochs - 2,
            min_participation=0.8,
            what="fleet producing under flood",
        )
        recovery = _run_to_convergence(net, oracle, start_slot=end + 1)
        return {
            "seed": net.seed,
            "flood_sent": net.flood_sent,
            "blocks_published": published,
            "mean_production_ms": round(mean_s * 1000, 2),
            "shed": shed_delta,
            "finalized": [c["finalized_epoch"] for c in blocks],
            **recovery,
        }
    finally:
        net.shutdown()
