"""Rolling message cache (gossipsub mcache.rs analog).

Holds full messages for `history_length` heartbeat windows; the most
recent `gossip_window` windows feed IHAVE emission, while IWANT can be
answered from anywhere in the history. `shift()` runs once per heartbeat
and drops the oldest window's entries.
"""

from __future__ import annotations


class MessageCache:
    def __init__(self, history_length: int = 5, gossip_window: int = 3):
        if not 0 < gossip_window <= history_length:
            raise ValueError("gossip_window must be in (0, history_length]")
        self.history_length = history_length
        self.gossip_window = gossip_window
        #: newest window first; each window is a list of (mid, topic)
        self._windows: list[list[tuple[bytes, str]]] = [[]]
        self._msgs: dict[bytes, tuple[str, bytes]] = {}
        #: (mid -> peer -> serves): IWANT anti-spam counted PER REQUESTER
        #: (libp2p gossip_retransmission) — a global count would refuse
        #: honest requesters once d_lazy > the cap, and their broken
        #: promises would then penalize US
        self._transmits: dict[bytes, dict[str, int]] = {}

    def put(self, mid: bytes, topic: str, data: bytes):
        if mid in self._msgs:
            return
        self._msgs[mid] = (topic, data)
        self._transmits[mid] = {}
        self._windows[0].append((mid, topic))

    def get(self, mid: bytes) -> tuple[str, bytes] | None:
        return self._msgs.get(mid)

    def get_for_iwant(
        self, mid: bytes, peer_id: str, limit: int
    ) -> tuple[str, bytes] | None:
        """Fetch for an IWANT response, counting the retransmission; None
        once THIS requester has been served `limit` times."""
        entry = self._msgs.get(mid)
        if entry is None:
            return None
        counts = self._transmits[mid]
        if counts.get(peer_id, 0) >= limit:
            return None
        counts[peer_id] = counts.get(peer_id, 0) + 1
        return entry

    def gossip_ids(self, topic: str) -> list[bytes]:
        """Message ids in the gossip window for one topic (IHAVE payload)."""
        out = []
        for window in self._windows[: self.gossip_window]:
            out.extend(mid for mid, t in window if t == topic)
        return out

    def topics_in_gossip_window(self) -> set[str]:
        return {
            t for window in self._windows[: self.gossip_window] for _, t in window
        }

    def shift(self):
        """Heartbeat rotation: age every window, drop the oldest."""
        self._windows.insert(0, [])
        while len(self._windows) > self.history_length:
            for mid, _topic in self._windows.pop():
                self._msgs.pop(mid, None)
                self._transmits.pop(mid, None)

    def __len__(self) -> int:
        return len(self._msgs)
