"""Host health stats: CPU, memory, disk, network.

The common/system_health analog (src/lib.rs): a snapshot struct consumed
by the monitoring push API and exposed as gauges for the metrics server.
Reads /proc directly (Linux-only in this image; every field degrades to 0
where a source is missing, as the reference's sysinfo does on unsupported
platforms)."""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import asdict, dataclass

from . import PROCESS_START_EPOCH, PROCESS_START_MONOTONIC, set_gauge


@dataclass
class SystemHealth:
    total_memory_bytes: int
    free_memory_bytes: int
    used_memory_bytes: int
    sys_loadavg_1: float
    sys_loadavg_5: float
    sys_loadavg_15: float
    cpu_cores: int
    disk_bytes_total: int
    disk_bytes_free: int
    network_bytes_sent: int
    network_bytes_received: int
    observed_at: float

    def to_dict(self) -> dict:
        return asdict(self)


def _meminfo() -> tuple[int, int]:
    total = free = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    free = int(line.split()[1]) * 1024
    except OSError:
        pass
    return total, free


def _net_counters() -> tuple[int, int]:
    sent = recv = 0
    try:
        with open("/proc/net/dev") as f:
            for line in f.readlines()[2:]:
                iface, _, rest = line.partition(":")
                if iface.strip() == "lo":
                    continue
                cols = rest.split()
                recv += int(cols[0])
                sent += int(cols[8])
    except (OSError, IndexError, ValueError):
        pass
    return sent, recv


def system_health(path: str = "/") -> SystemHealth:
    total, free = _meminfo()
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:
        load1 = load5 = load15 = 0.0
    try:
        du = shutil.disk_usage(path)
        disk_total, disk_free = du.total, du.free
    except OSError:
        disk_total = disk_free = 0
    sent, recv = _net_counters()
    return SystemHealth(
        total_memory_bytes=total,
        free_memory_bytes=free,
        used_memory_bytes=max(0, total - free),
        sys_loadavg_1=load1,
        sys_loadavg_5=load5,
        sys_loadavg_15=load15,
        cpu_cores=os.cpu_count() or 0,
        disk_bytes_total=disk_total,
        disk_bytes_free=disk_free,
        network_bytes_sent=sent,
        network_bytes_received=recv,
        observed_at=time.time(),
    )


def _proc_status_kb(field: str, pid: int | None = None) -> int:
    """One `VmXXX:` row of /proc/<pid>/status in kB (0 where missing);
    pid=None reads the calling process."""
    path = f"/proc/{pid}/status" if pid is not None else "/proc/self/status"
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass
    return 0


def _proc_self_status_kb(field: str) -> int:
    return _proc_status_kb(field)


def _api_workers_block() -> dict | None:
    """RSS of the forked API serving workers, aggregated for the
    `system` block: VmRSS alone reports only the calling process, but the
    serving tier's footprint is parent + every replica, and the testnet
    ChainHealthOracle's bounded-RSS invariant must see all of it. CoW
    keeps per-worker RSS far below a full copy; divergence here is the
    early-warning signal that shared pages are being dirtied."""
    try:
        from ..http_api.workers import live_worker_info
    except Exception:  # noqa: BLE001 — keep health serving if the tier is absent
        return None
    info = live_worker_info()
    if not info:
        return None
    for w in info:
        w["rss_bytes"] = _proc_status_kb("VmRSS", w["pid"]) * 1024
    return {
        "count": len(info),
        "rss_total_bytes": sum(w["rss_bytes"] for w in info),
        "workers": info,
    }


def chain_health(chain) -> dict:
    """The `chain` block of /lighthouse/health: one node's chain vitals
    read off ITS OWN BeaconChain — head slot + lag vs the wall clock,
    finality position, last-epoch participation, and per-chain reorg
    accounting. This is deliberately NOT derived from the process-global
    registry: an in-process testnet fleet shares one registry, and the
    scenario oracle (testing/testnet.py ChainHealthOracle) needs each
    node's answer individually — one health GET per node replaces
    scraping and attributing raw metric series."""
    from ..state_processing.accessors import compute_epoch_at_slot

    head = chain.head_state
    head_slot = int(head.slot)
    clock_slot = int(chain.slot_clock.now())
    fin = chain.finalized_checkpoint
    current_epoch = compute_epoch_at_slot(max(head_slot, clock_slot), chain.E)
    return {
        "head_slot": head_slot,
        "head_root": "0x" + chain.head_root.hex(),
        "clock_slot": clock_slot,
        "head_lag_slots": max(0, clock_slot - head_slot),
        "finalized_epoch": int(fin.epoch),
        "finalized_root": "0x" + bytes(fin.root).hex(),
        "finalized_distance_epochs": max(0, current_epoch - int(fin.epoch)),
        "justified_epoch": int(chain.justified_checkpoint.epoch),
        "participation_prev_epoch": _participation_rate(chain, head),
        "reorgs_total": int(chain.reorgs_total),
        "max_reorg_depth": int(chain.max_reorg_depth),
    }


def store_health(chain) -> dict:
    """The `store` block of /lighthouse/health: per-side (hot/cold),
    per-column key/byte counts plus the split and anchor watermarks,
    straight off the node's own HotColdDB. The churn-soak oracle asserts
    bounded hot-store size from these numbers — with the migrator off the
    hot side grows linearly, with it on the slope flattens at finality."""
    return chain.store.column_stats()


def _participation_rate(chain, state) -> float | None:
    """Fraction of previous-epoch active (unslashed) validators whose
    participation flags carry TIMELY_TARGET — the liveness number the
    chain finalizes on (2/3 of stake; per-validator here, close enough
    for a health read). None pre-altair (no participation flags)."""
    flags = getattr(state, "previous_epoch_participation", None)
    if flags is None:
        return None
    from ..state_processing.accessors import get_current_epoch
    from ..state_processing.altair import TIMELY_TARGET_FLAG_INDEX, has_flag
    from ..state_processing.registry_columns import registry_columns_for

    prev_epoch = max(0, get_current_epoch(state, chain.E) - 1)
    cols = registry_columns_for(state)
    if cols is not None:
        part = cols.previous_epoch_participation
        if part is not None:
            import numpy as np

            active = cols.active_mask(prev_epoch) & ~cols.slashed.astype(bool)
            n = int(active.sum())
            if n == 0:
                return None
            hit = (part[active] >> TIMELY_TARGET_FLAG_INDEX) & 1
            return round(float(np.count_nonzero(hit)) / n, 4)
    from ..state_processing.accessors import is_active_validator

    n = hit = 0
    for i, v in enumerate(state.validators):
        if v.slashed or not is_active_validator(v, prev_epoch):
            continue
        n += 1
        if has_flag(int(flags[i]), TIMELY_TARGET_FLAG_INDEX):
            hit += 1
    return round(hit / n, 4) if n else None


def process_health(chain=None) -> dict:
    """The /lighthouse/health body (the reference's /lighthouse/ui/health
    analog): process vitals plus node state read back out of the
    process-global registry's gauges — uptime, RSS/peak RSS, GC
    generation counts, live threads, sync state, worker-busy ratio, and
    the trace-collector ring size. With a `chain` (the Beacon API serves
    one; the standalone MetricsServer may not have one), the body gains
    the per-node `chain` block."""
    import gc

    from . import REGISTRY
    from .profiler import PROFILER

    workers = REGISTRY.gauge("beacon_processor_workers_total").value()
    busy = REGISTRY.gauge("beacon_processor_workers_busy").value()
    return {
        **({"chain": chain_health(chain)} if chain is not None else {}),
        **({"store": store_health(chain)} if chain is not None else {}),
        "uptime_seconds": round(time.monotonic() - PROCESS_START_MONOTONIC, 3),
        "started_at_unix": int(PROCESS_START_EPOCH),
        "rss_bytes": _proc_self_status_kb("VmRSS") * 1024,
        "peak_rss_bytes": _proc_self_status_kb("VmHWM") * 1024,
        "gc": {
            "counts": list(gc.get_count()),
            "collections": [s.get("collections", 0) for s in gc.get_stats()],
        },
        "threads": threading.active_count(),
        "sync_state": REGISTRY.gauge("sync_state").value(),
        "workers_total": workers,
        "workers_busy": busy,
        "worker_busy_ratio": (busy / workers) if workers else 0.0,
        "trace_ring_size": REGISTRY.gauge("trace_collector_ring_size").value(),
        "profiler": {
            "running": PROFILER.running,
            "samples": PROFILER.samples_total,
        },
        "system": {
            **system_health().to_dict(),
            **(
                {"api_workers": aw}
                if (aw := _api_workers_block()) is not None
                else {}
            ),
        },
    }


def observe_system_health(registry=None):
    """Publish the snapshot as gauges (scrape-time refresh) into
    `registry` (default: the process-global one)."""
    h = system_health()
    if registry is None:
        setter = set_gauge
    else:
        # lint: allow(metric-hygiene) -- forwarding shim; every call below passes a literal
        setter = lambda name, v: registry.gauge(name).set(v)  # noqa: E731
    setter("system_total_memory_bytes", h.total_memory_bytes)
    setter("system_free_memory_bytes", h.free_memory_bytes)
    setter("system_loadavg_1", h.sys_loadavg_1)
    setter("system_cpu_cores", h.cpu_cores)
    setter("system_disk_bytes_total", h.disk_bytes_total)
    setter("system_disk_bytes_free", h.disk_bytes_free)
    setter("system_network_bytes_sent", h.network_bytes_sent)
    setter("system_network_bytes_received", h.network_bytes_received)
    return h
