"""UDP peer discovery + standalone boot node.

The discv5 analog (lighthouse_network/src/discovery/ and the boot_node
crate): every node runs a UDP discovery service advertising an ENR-like
record (node id, addresses, fork digest, sequence number); peers are found
by querying known nodes with FINDNODE and connecting over TCP to the
returned records. `BootNode` is the boot_node/src/lib.rs:1 analog — the
same discovery stack run standalone with no beacon chain attached, seeded
into other nodes' bootnode lists.

Like the rest of the p2p stack this is protocol-shaped, not
discv5-wire-compatible (no session crypto); the behavior surface —
records, liveness pings, subnet-predicate node lookup, table eviction —
matches the reference's discovery layer.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field

from ..utils.logging import get_logger

log = get_logger("discovery")

_MAX_PACKET = 4096
_NODES_PER_RESPONSE = 16


@dataclass
class Enr:
    """Ethereum Node Record analog (discv5 ENR): identity + endpoints +
    the eth2 fork-digest field used for network membership filtering."""

    node_id: str
    ip: str
    udp_port: int
    tcp_port: int
    fork_digest: str  # hex; "" for chain-less boot nodes
    seq: int = 1
    #: attnets-style subnet advertisement (discovery subnet predicates)
    subnets: list[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "node_id": self.node_id,
            "ip": self.ip,
            "udp_port": self.udp_port,
            "tcp_port": self.tcp_port,
            "fork_digest": self.fork_digest,
            "seq": self.seq,
            "subnets": self.subnets,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Enr":
        return cls(
            node_id=str(d["node_id"]),
            ip=str(d["ip"]),
            udp_port=int(d["udp_port"]),
            tcp_port=int(d["tcp_port"]),
            fork_digest=str(d.get("fork_digest", "")),
            seq=int(d.get("seq", 1)),
            subnets=[int(s) for s in d.get("subnets", [])],
        )


def _new_node_id() -> str:
    return os.urandom(16).hex()


class DiscoveryService:
    """One node's discovery endpoint: answers PING and FINDNODE, keeps a
    table of known records, and can query bootnodes/peers for more."""

    #: records unseen for this long are evicted on maintenance
    RECORD_TTL = 300.0

    def __init__(
        self,
        tcp_port: int = 0,
        fork_digest: bytes | None = None,
        host: str = "127.0.0.1",
        bootnodes: list[Enr] | None = None,
    ):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, 0))
        self._sock.settimeout(0.2)
        self.udp_port = self._sock.getsockname()[1]
        self.local_enr = Enr(
            node_id=_new_node_id(),
            ip=host,
            udp_port=self.udp_port,
            tcp_port=tcp_port,
            fork_digest=fork_digest.hex() if fork_digest else "",
        )
        self.table: dict[str, Enr] = {}
        self._last_seen: dict[str, float] = {}
        self.bootnodes = list(bootnodes or [])
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "DiscoveryService":
        self._thread = threading.Thread(
            target=self._serve, daemon=True, name=f"discovery-{self.udp_port}"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._sock.close()

    # -- record table ----------------------------------------------------

    def add_record(self, enr: Enr):
        if enr.node_id == self.local_enr.node_id:
            return
        with self._lock:
            known = self.table.get(enr.node_id)
            if known is None or enr.seq >= known.seq:
                self.table[enr.node_id] = enr
            self._last_seen[enr.node_id] = time.monotonic()

    def records(self, subnet: int | None = None) -> list[Enr]:
        with self._lock:
            out = list(self.table.values())
        if subnet is not None:
            out = [e for e in out if subnet in e.subnets]
        return out

    def maintain(self):
        """Evict stale records (table maintenance tick)."""
        cutoff = time.monotonic() - self.RECORD_TTL
        with self._lock:
            for nid, seen in list(self._last_seen.items()):
                if seen < cutoff:
                    self.table.pop(nid, None)
                    self._last_seen.pop(nid, None)

    def update_subnets(self, subnets: list[int]):
        """Re-advertise with new attnets (subnet service ENR updates bump
        the sequence number so peers take the fresher record)."""
        self.local_enr.subnets = sorted(set(subnets))
        self.local_enr.seq += 1

    # -- wire ------------------------------------------------------------

    def _send(self, msg: dict, addr):
        try:
            self._sock.sendto(json.dumps(msg).encode(), addr)
        except OSError:
            pass

    def _serve(self):
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(_MAX_PACKET)
            except socket.timeout:
                continue
            except OSError:
                break
            # the port is unauthenticated: NOTHING a remote sends may kill
            # the serve thread — malformed packets are dropped wholesale
            try:
                msg = json.loads(data.decode())
                kind = msg["kind"]
                if kind == "ping":
                    self.add_record(Enr.from_dict(msg["enr"]))
                    self._send(
                        {"kind": "pong", "enr": self.local_enr.to_dict()}, addr
                    )
                elif kind == "findnode":
                    self.add_record(Enr.from_dict(msg["enr"]))
                    subnet = msg.get("subnet")
                    found = self.records(
                        subnet if subnet is None else int(subnet)
                    )
                    # never hand a querier its own record back
                    qid = msg["enr"].get("node_id")
                    found = [e for e in found if e.node_id != qid]
                    self._send(
                        {
                            "kind": "nodes",
                            "enr": self.local_enr.to_dict(),
                            "nodes": [
                                e.to_dict() for e in found[:_NODES_PER_RESPONSE]
                            ],
                        },
                        addr,
                    )
            except Exception:  # noqa: BLE001
                continue

    def _request(self, target: Enr, msg: dict, timeout: float = 1.0) -> dict | None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.settimeout(timeout)
        try:
            sock.sendto(json.dumps(msg).encode(), (target.ip, target.udp_port))
            data, _ = sock.recvfrom(_MAX_PACKET)
            return json.loads(data.decode())
        except (OSError, ValueError):
            return None
        finally:
            sock.close()

    # -- queries ---------------------------------------------------------

    def ping(self, target: Enr) -> bool:
        resp = self._request(
            target, {"kind": "ping", "enr": self.local_enr.to_dict()}
        )
        if resp is None or resp.get("kind") != "pong":
            return False
        self.add_record(Enr.from_dict(resp["enr"]))
        return True

    def find_nodes(self, target: Enr, subnet: int | None = None) -> list[Enr]:
        msg = {"kind": "findnode", "enr": self.local_enr.to_dict()}
        if subnet is not None:
            msg["subnet"] = subnet
        resp = self._request(target, msg)
        if resp is None or resp.get("kind") != "nodes":
            return []
        self.add_record(Enr.from_dict(resp["enr"]))
        out = []
        for d in resp.get("nodes", []):
            enr = Enr.from_dict(d)
            self.add_record(enr)
            out.append(enr)
        return out

    def discover(self, subnet: int | None = None) -> list[Enr]:
        """One discovery round: query bootnodes + known records; return
        connectable records on our fork digest (discovery.rs's
        find_peers → dial candidates flow)."""
        seen_ids = set()
        targets = []
        for t in self.bootnodes + self.records():
            # bootnodes reappear in the table after the first round; dedup
            # so each target is queried once (and a dead one eats only one
            # UDP timeout per round)
            if t.node_id in seen_ids:
                continue
            seen_ids.add(t.node_id)
            targets.append(t)
        for t in targets:
            self.find_nodes(t, subnet)
        digest = self.local_enr.fork_digest
        return [
            e
            for e in self.records(subnet)
            if e.tcp_port and (not digest or not e.fork_digest or e.fork_digest == digest)
        ]


class BootNode:
    """boot_node crate analog: discovery with no chain behind it. Other
    nodes seed `discovery.bootnodes` with `boot.enr()` and bootstrap the
    mesh from it."""

    def __init__(self, host: str = "127.0.0.1"):
        self.discovery = DiscoveryService(tcp_port=0, host=host)

    def start(self) -> "BootNode":
        self.discovery.start()
        log.info(
            "boot node listening",
            udp_port=self.discovery.udp_port,
            node_id=self.discovery.local_enr.node_id[:8],
        )
        return self

    def enr(self) -> Enr:
        return self.discovery.local_enr

    def stop(self):
        self.discovery.stop()
