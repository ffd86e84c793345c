"""Attestation subnet service.

The network/src/subnet_service/ analog: tracks which attestation subnets
this node's validators need (from their duties), keeps a rolling set of
per-epoch duty subnets plus the node's persistent random subnets, and
advertises the union in the discovery record's attnets field so peers
searching a subnet can find us (discovery's subnet predicates)."""

from __future__ import annotations

import random

from ..state_processing.accessors import committee_cache_at
from ..utils.logging import get_logger
from . import messages as M

log = get_logger("subnet_service")

#: spec SUBNETS_PER_NODE — persistent random subnets every node backbones
SUBNETS_PER_NODE = 2


class AttestationSubnetService:
    def __init__(self, network, node_id_seed: int | None = None):
        self.network = network
        rng = random.Random(node_id_seed)
        self.persistent_subnets = sorted(
            rng.sample(range(M.ATTESTATION_SUBNET_COUNT), SUBNETS_PER_NODE)
        )
        #: epoch -> duty subnets
        self._duty_subnets: dict[int, set[int]] = {}

    def subnets_for_duties(self, duties, epoch: int) -> set[int]:
        """Subnets this epoch's attester duties land on."""
        chain = self.network.chain
        cc = committee_cache_at(chain.head_state, epoch, chain.E)
        return {
            M.compute_subnet_for_attestation(
                cc.committees_per_slot, d.slot, d.committee_index, chain.E
            )
            for d in duties
        }

    def register_duties(self, duties, epoch: int):
        """Record duty subnets, refresh the ENR advertisement, and join
        the gossipsub mesh for each duty subnet NOW — an attestation due
        this epoch can't wait for the next heartbeat to find mesh peers
        (the reference's subscribe-ahead on duty subnets)."""
        subnets = self.subnets_for_duties(duties, epoch)
        self._duty_subnets[epoch] = subnets
        # keep a 2-epoch window (current + next, as the reference does)
        for e in [e for e in self._duty_subnets if e < epoch - 1]:
            del self._duty_subnets[e]
        self._advertise()
        router = getattr(self.network, "gossip", None)
        if router is not None:
            for subnet in sorted(subnets | set(self.persistent_subnets)):
                router.ensure_mesh(self.network.attestation_topics[subnet])
        return subnets

    def active_subnets(self) -> list[int]:
        out = set(self.persistent_subnets)
        for subs in self._duty_subnets.values():
            out |= subs
        return sorted(out)

    def _advertise(self):
        disc = self.network.discovery
        if disc is not None:
            disc.update_subnets(self.active_subnets())
            log.info(
                "advertising attnets",
                subnets=self.active_subnets(),
                seq=disc.local_enr.seq,
            )
