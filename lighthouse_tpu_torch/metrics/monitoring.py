"""Remote monitoring push service.

The common/monitoring_api analog (src/{lib,gather}.rs): periodically
gathers process + system + chain health into the remote-monitoring JSON
shape (`beaconnode`/`validator` process records) and POSTs it to a
configured endpoint. The HTTP send is a seam (`sender`) so tests — and
this zero-egress image — capture payloads instead of dialing out."""

from __future__ import annotations

import json
import threading
import time
import urllib.request

from ..utils.logging import get_logger
from .system_health import system_health

log = get_logger("monitoring")

VERSION = 1
CLIENT_NAME = "lighthouse_tpu"


def default_sender(endpoint: str, payload: bytes):
    req = urllib.request.Request(
        endpoint, data=payload, headers={"Content-Type": "application/json"}
    )
    urllib.request.urlopen(req, timeout=10).read()


class MonitoringService:
    """gather + push loop (monitoring_api/src/lib.rs)."""

    def __init__(
        self,
        endpoint: str,
        chain=None,
        validator_store=None,
        update_period_s: float = 60.0,
        sender=default_sender,
    ):
        self.endpoint = endpoint
        self.chain = chain
        self.validator_store = validator_store
        self.update_period_s = update_period_s
        self.sender = sender
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- gather (gather.rs) ---------------------------------------------

    def gather(self) -> list[dict]:
        h = system_health()
        now_ms = int(time.time() * 1000)
        common = {
            "version": VERSION,
            "timestamp": now_ms,
            "client_name": CLIENT_NAME,
            "cpu_cores": h.cpu_cores,
            "memory_node_bytes_total": h.total_memory_bytes,
            "memory_node_bytes_free": h.free_memory_bytes,
            "disk_node_bytes_total": h.disk_bytes_total,
            "disk_node_bytes_free": h.disk_bytes_free,
            "network_node_bytes_total_transmit": h.network_bytes_sent,
            "network_node_bytes_total_receive": h.network_bytes_received,
            "misc_os": "lin",
        }
        records = []
        if self.chain is not None:
            records.append(
                {
                    **common,
                    "process": "beaconnode",
                    "sync_beacon_head_slot": int(self.chain.head_state.slot),
                    "sync_eth2_synced": True,
                }
            )
        if self.validator_store is not None:
            records.append(
                {
                    **common,
                    "process": "validator",
                    "validator_total": len(self.validator_store.pubkeys()),
                    "validator_active": len(self.validator_store.pubkeys()),
                }
            )
        if not records:
            records.append({**common, "process": "system"})
        return records

    def send(self):
        payload = json.dumps(self.gather()).encode()
        try:
            self.sender(self.endpoint, payload)
        except Exception as e:  # noqa: BLE001 — monitoring must never kill the node
            log.warning("monitoring push failed", error=repr(e))

    # -- service loop ----------------------------------------------------

    def start(self) -> "MonitoringService":
        def loop():
            while not self._stop.wait(self.update_period_s):
                self.send()

        self._thread = threading.Thread(target=loop, daemon=True, name="monitoring")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
