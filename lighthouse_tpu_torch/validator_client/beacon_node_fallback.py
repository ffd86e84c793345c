"""Multi-beacon-node failover for the validator client.

Mirrors validator_client/src/beacon_node_fallback.rs: an ordered list of
candidate beacon nodes, each tracked with a health state; every VC request
runs `first_success` over the candidates — try the healthiest first, mark
a candidate offline on error and move to the next, and periodically
re-check offline candidates so they can recover.

The reference polls `/eth/v1/node/health` + sync status to rank
candidates (beacon_node_fallback.rs `CandidateBeaconNode::refresh_health`);
here health is an explicit probe seam (`check_health`) so both in-process
chains and HTTP clients plug in.
"""

from __future__ import annotations

import time
from enum import Enum

from ..metrics import inc_counter
from ..utils.logging import get_logger

log = get_logger("vc.fallback")


class CandidateHealth(Enum):
    ONLINE = "online"
    OFFLINE = "offline"
    UNKNOWN = "unknown"


class AllNodesFailed(RuntimeError):
    """Every candidate errored for this request (fallback exhausted)."""

    def __init__(self, errors):
        self.errors = errors
        super().__init__(
            "all beacon node candidates failed: "
            + "; ".join(f"{name}: {err}" for name, err in errors)
        )


class CandidateBeaconNode:
    """One candidate: a BeaconNodeInterface + health bookkeeping."""

    def __init__(self, name: str, node):
        self.name = name
        self.node = node
        self.health = CandidateHealth.UNKNOWN
        self.last_check: float = 0.0

    def check_health(self) -> bool:
        """Probe the node (head_state reachability = the health endpoint)."""
        try:
            self.node.head_root()
            self.health = CandidateHealth.ONLINE
        except Exception:
            self.health = CandidateHealth.OFFLINE
        self.last_check = time.monotonic()
        return self.health is CandidateHealth.ONLINE


class BeaconNodeFallback:
    """An ordered candidate set implementing the BeaconNodeInterface
    surface via first-success iteration (beacon_node_fallback.rs
    `first_success`). User-declared order is preference order, as in the
    reference's `--beacon-nodes` flag."""

    #: seconds between re-probes of an OFFLINE candidate
    RECHECK_INTERVAL = 1.0

    def __init__(self, nodes, recheck_interval: float | None = None):
        if not nodes:
            raise ValueError("need at least one beacon node candidate")
        self.candidates = [
            n if isinstance(n, CandidateBeaconNode) else CandidateBeaconNode(f"bn{i}", n)
            for i, n in enumerate(nodes)
        ]
        if recheck_interval is not None:
            self.RECHECK_INTERVAL = recheck_interval

    def _usable(self):
        """Candidates to try, in declaration (preference) order. Offline
        candidates whose recheck interval elapsed are re-probed first, so a
        recovered primary regains its preferred position — the reference's
        periodic `refresh_health` poll, done lazily at request time."""
        now = time.monotonic()
        out = []
        for c in self.candidates:
            if (
                c.health is CandidateHealth.OFFLINE
                and now - c.last_check >= self.RECHECK_INTERVAL
            ):
                c.check_health()
            if c.health in (CandidateHealth.ONLINE, CandidateHealth.UNKNOWN):
                out.append(c)
        return out

    def first_success(self, method: str, *args, **kwargs):
        errors = []
        for cand in self._usable():
            try:
                result = getattr(cand.node, method)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — any node error → next
                cand.health = CandidateHealth.OFFLINE
                cand.last_check = time.monotonic()
                errors.append((cand.name, repr(e)))
                inc_counter("vc_beacon_node_errors_total")
                log.warning(
                    "beacon node candidate failed; trying next",
                    candidate=cand.name,
                    method=method,
                    error=repr(e),
                )
                continue
            cand.health = CandidateHealth.ONLINE
            return result
        inc_counter("vc_all_beacon_nodes_failed_total")
        raise AllNodesFailed(errors)

    # -- BeaconNodeInterface surface ------------------------------------

    def head_state(self):
        return self.first_success("head_state")

    def head_root(self):
        return self.first_success("head_root")

    def publish_block(self, signed_block):
        return self.first_success("publish_block", signed_block)

    def publish_attestations(self, attestations):
        return self.first_success("publish_attestations", attestations)

    def produce_block(self, slot: int, randao_reveal: bytes):
        return self.first_success("produce_block", slot, randao_reveal)

    def publish_sync_committee_messages(self, messages):
        return self.first_success("publish_sync_committee_messages", messages)

    def prepare_proposers(self, preparations):
        return self.first_success("prepare_proposers", preparations)

    def get_aggregate(self, data):
        return self.first_success("get_aggregate", data)

    def publish_aggregates(self, signed_aggregates):
        return self.first_success("publish_aggregates", signed_aggregates)

    def attester_duties(self, epoch: int, indices):
        """Bulk duties through the first candidate that serves them. A
        transport without the bulk surface (HttpBeaconNode) is no fault of
        its node: when no candidate has it, raise NotImplementedError so
        DutiesService takes its committee scan, with every candidate's
        health left as it was. (The JAX package's fallback tries the
        missing method on each candidate, marks them all offline and
        raises AllNodesFailed.)"""
        if not any(hasattr(c.node, "attester_duties") for c in self.candidates):
            raise NotImplementedError("no beacon node candidate serves bulk attester duties")
        return self.first_success("attester_duties", epoch, indices)
