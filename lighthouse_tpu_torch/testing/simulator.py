"""In-process multi-node simulator.

Mirrors testing/simulator (src/main.rs:1-12, basic_sim.rs, fallback_sim.rs)
and testing/node_test_rig's `LocalNetwork`: N full beacon nodes — each a
real `BeaconChain` + `NetworkService` over localhost sockets — plus
validator clients holding disjoint shares of the interop keys, driven
slot-by-slot on `MinimalEthSpec`. Checks assert liveness and finality
(simulator/src/checks.rs); the fallback scenario kills a beacon node
mid-run and requires VCs with `BeaconNodeFallback` to keep the chain
finalizing via the surviving node (fallback_sim.rs:129-212).

Everything is threads in one process — no real cluster, exactly as the
reference runs tokio tasks in one process.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..beacon_chain.chain import BeaconChain
from ..crypto import bls
from ..network import NetworkService
from ..state_processing import interop_genesis_state
from ..store import HotColdDB, MemoryStore
from ..utils.slot_clock import ManualSlotClock
from ..validator_client import GossipingBeaconNode, ValidatorClient
from ..validator_client.beacon_node_fallback import AllNodesFailed, BeaconNodeFallback

SIM_GENESIS_TIME = 1_600_000_000


class NodeOffline(RuntimeError):
    pass


class NetworkedBeaconNode(GossipingBeaconNode):
    """The product GossipingBeaconNode (import locally, broadcast to
    peers) plus a kill switch: offline nodes raise on every call — the
    dead-BN seam fallback_sim exercises."""

    def __init__(self, chain, network: NetworkService):
        super().__init__(chain, network)
        self.offline = False

    def _check(self):
        if self.offline:
            raise NodeOffline("beacon node is offline")

    def head_state(self):
        self._check()
        return super().head_state()

    def head_root(self):
        self._check()
        return super().head_root()

    def produce_block(self, slot: int, randao_reveal: bytes):
        self._check()
        return super().produce_block(slot, randao_reveal)

    def publish_block(self, signed_block):
        self._check()
        return super().publish_block(signed_block)

    def publish_attestations(self, attestations):
        self._check()
        return super().publish_attestations(attestations)

    def publish_sync_committee_messages(self, messages):
        self._check()
        return super().publish_sync_committee_messages(messages)

    def publish_aggregates(self, signed_aggregates):
        self._check()
        return super().publish_aggregates(signed_aggregates)

    def get_aggregate(self, data):
        self._check()
        return super().get_aggregate(data)

    def prepare_proposers(self, preparations):
        self._check()
        return super().prepare_proposers(preparations)


@dataclass
class SimNode:
    name: str
    chain: BeaconChain
    network: NetworkService
    interface: NetworkedBeaconNode
    vc: ValidatorClient | None = None

    def kill(self):
        """Take the BN offline (fallback_sim's disconnected node)."""
        self.interface.offline = True
        self.network.stop()


@dataclass
class LocalNetwork:
    spec: object
    E: object
    nodes: list[SimNode] = field(default_factory=list)
    keypairs: list = field(default_factory=list)
    slot_clocks: list[ManualSlotClock] = field(default_factory=list)

    @classmethod
    def create(
        cls,
        spec,
        E,
        node_count: int = 2,
        validator_count: int = 32,
        vc_fallback: bool = False,
    ) -> "LocalNetwork":
        """Build node_count fully-wired nodes over identical interop
        genesis, connect them pairwise, and split the keys across VCs.

        vc_fallback=True gives every VC a `BeaconNodeFallback` preferring
        its own node with every other node as backup (fallback_sim's
        `--beacon-nodes` list)."""
        keypairs = bls.interop_keypairs(validator_count)
        net = cls(spec=spec, E=E, keypairs=keypairs)
        genesis = interop_genesis_state(
            keypairs, SIM_GENESIS_TIME, b"\x42" * 32, spec, E
        )
        for i in range(node_count):
            clock = ManualSlotClock(
                genesis_time=SIM_GENESIS_TIME,
                seconds_per_slot=spec.seconds_per_slot,
            )
            chain = BeaconChain(
                store=HotColdDB(MemoryStore()),
                genesis_state=genesis.copy(),
                spec=spec,
                E=E,
                slot_clock=clock,
            )
            network = NetworkService(chain).start()
            iface = NetworkedBeaconNode(chain, network)
            net.nodes.append(SimNode(f"node{i}", chain, network, iface))
            net.slot_clocks.append(clock)
        # full mesh: every node dials every earlier node
        for i, a in enumerate(net.nodes):
            for b in net.nodes[:i]:
                a.network.connect("127.0.0.1", b.network.port)
        time.sleep(0.2)  # let inbound-peer registration settle
        # disjoint key shares per VC
        share = len(keypairs) // node_count
        for i, node in enumerate(net.nodes):
            keys = keypairs[i * share : (i + 1) * share]
            if i == node_count - 1:
                keys = keypairs[i * share :]
            if vc_fallback:
                order = [node.interface] + [
                    n.interface for n in net.nodes if n is not node
                ]
                bn = BeaconNodeFallback(order, recheck_interval=0.05)
            else:
                bn = node.interface
            node.vc = ValidatorClient(
                chain=node.chain, keypairs=keys, spec=spec, E=E, node=bn
            )
        return net

    # -- driving ---------------------------------------------------------

    def set_slot(self, slot: int):
        for clock in self.slot_clocks:
            clock.set_slot(slot)

    def run_slot(self, slot: int):
        """One wall-clock slot, in protocol order: tick every clock, the
        slot's proposer (whichever VC holds it) proposes, gossip settles so
        every node sees the new head, then all VCs attest — the reference
        VC's intra-slot schedule (propose at 0s, attest at slot/3)."""
        self.set_slot(slot)
        vcs = [n.vc for n in self.nodes if n.vc is not None]
        for vc in vcs:
            try:
                vc.block_service.propose_if_due(slot)
            except (NodeOffline, AllNodesFailed):
                pass  # VC's BN(s) down — the duty is simply missed
        self._settle(slot)
        for vc in vcs:
            try:
                head = vc.node.head_root()
                vc.attestation_service.attest(slot, head)
            except (NodeOffline, AllNodesFailed):
                pass
        self._settle(slot)

    def _settle(self, slot: int, timeout: float = 5.0):
        """Wait for gossip to converge: every live node's head reaches the
        max head slot seen across live nodes (checks.rs epoch_delay
        analog, event-driven instead of fixed sleeps)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = [n for n in self.nodes if not n.interface.offline]
            heads = {n.chain.head_root for n in live}
            if len(heads) <= 1:
                return
            time.sleep(0.02)

    def run_until_slot(self, end_slot: int, start_slot: int = 1):
        for slot in range(start_slot, end_slot + 1):
            self.run_slot(slot)

    # -- checks (simulator/src/checks.rs) --------------------------------

    def live_nodes(self) -> list[SimNode]:
        return [n for n in self.nodes if not n.interface.offline]

    def check_all_heads_equal(self):
        heads = {n.chain.head_root for n in self.live_nodes()}
        if len(heads) != 1:
            raise AssertionError(f"heads diverged: {sorted(h.hex()[:12] for h in heads)}")

    def check_finalized_epoch(self, min_epoch: int):
        for n in self.live_nodes():
            got = n.chain.finalized_checkpoint.epoch
            if got < min_epoch:
                raise AssertionError(
                    f"{n.name} finalized epoch {got} < required {min_epoch}"
                )

    def shutdown(self):
        for n in self.nodes:
            if not n.interface.offline:
                n.network.stop()


def run_basic_sim(spec, E, node_count: int = 2, epochs: int = 4,
                  validator_count: int = 32) -> LocalNetwork:
    """basic_sim.rs: all nodes + VCs run from genesis; assert the chain
    finalizes and all heads agree."""
    net = LocalNetwork.create(spec, E, node_count, validator_count)
    try:
        net.run_until_slot(epochs * E.SLOTS_PER_EPOCH)
        net.check_all_heads_equal()
        net.check_finalized_epoch(epochs - 3)
    except BaseException:
        net.shutdown()
        raise
    return net


def run_fallback_sim(spec, E, epochs: int = 5, kill_at_epoch: int = 2,
                     validator_count: int = 32) -> LocalNetwork:
    """fallback_sim.rs:129-212: two nodes, VCs configured with fallback;
    kill node1's BN mid-run — its VC must fail over to node0 and the chain
    must still finalize past the kill point."""
    net = LocalNetwork.create(spec, E, 2, validator_count, vc_fallback=True)
    try:
        kill_slot = kill_at_epoch * E.SLOTS_PER_EPOCH
        net.run_until_slot(kill_slot)
        net.nodes[1].kill()
        net.run_until_slot(epochs * E.SLOTS_PER_EPOCH, start_slot=kill_slot + 1)
        net.check_finalized_epoch(epochs - 3)
    except BaseException:
        net.shutdown()
        raise
    return net
