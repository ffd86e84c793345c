"""Prometheus-style metrics registry.

The `common/lighthouse_metrics` analog (src/lib.rs:1-18): a process-global
registry of counters/gauges/histograms with `start_timer` helpers, consumed
by the http_metrics server's text exposition. Collectors are created lazily
on first use (the reference's lazy_static pattern) so any subsystem can
record without setup ordering."""
# lint: allow-file(metric-hygiene) -- the registry helpers themselves take
# the metric name as a parameter; call SITES are where hygiene is enforced

from __future__ import annotations

import threading
import time
from collections import defaultdict

#: process birth anchors for /lighthouse/health uptime — captured HERE
#: because this module is imported at node assembly, while system_health
#: is imported lazily on the first scrape (its import time would read as
#: a near-zero uptime)
PROCESS_START_MONOTONIC = time.monotonic()
PROCESS_START_EPOCH = time.time()

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)


class Counter:
    __slots__ = ("name", "help", "_values", "_lock")

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def values(self) -> dict:
        """Snapshot of every labelled series: {(sorted label items): value}.
        Used by bench/cache reports to enumerate series without knowing the
        label sets in advance."""
        with self._lock:
            return dict(self._values)

    def expose(self) -> list[str]:
        # snapshot under the lock: a concurrent inc() introducing a new
        # label set mid-scrape would otherwise raise "dictionary changed
        # size during iteration" (Histogram.expose already snapshots)
        with self._lock:
            items = sorted(self._values.items())
        out = [f"# TYPE {self.name} counter"]
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_num(v)}")
        return out


class Gauge:
    __slots__ = ("name", "help", "_values", "_lock")

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels):
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def expose(self) -> list[str]:
        with self._lock:  # see Counter.expose: snapshot vs concurrent set()
            items = sorted(self._values.items())
        out = [f"# TYPE {self.name} gauge"]
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_num(v)}")
        return out


class Histogram:
    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_total", "_lock")

    def __init__(self, name: str, help_text: str = "", buckets=_DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        with self._lock:
            self._sum += value
            self._total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def start_timer(self) -> "_Timer":
        return _Timer(self)

    @property
    def count(self) -> int:
        return self._total

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> tuple[tuple, list[int], int, float]:
        """(buckets, per-bucket counts, total, sum) under the lock — the
        raw material for approximate percentiles (bench queue-wait
        breakdowns) and delta-based reporting."""
        with self._lock:
            return self.buckets, list(self._counts), self._total, self._sum

    def expose(self) -> list[str]:
        with self._lock:  # consistent snapshot vs concurrent observe()
            counts = list(self._counts)
            total = self._total
            sum_ = self._sum
        out = [f"# TYPE {self.name} histogram"]
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f'{self.name}_bucket{{le="{_fmt_num(b)}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {_fmt_num(sum_)}")
        out.append(f"{self.name}_count {total}")
        return out


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._hist.observe(dt)
        return dt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


class Registry:
    def __init__(self):
        self._collectors: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_text: str, **kw):
        with self._lock:
            c = self._collectors.get(name)
            if c is None:
                c = cls(name, help_text, **kw)
                self._collectors[name] = c
            elif not isinstance(c, cls):
                raise TypeError(f"metric {name} already registered as {type(c).__name__}")
            return c

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_text, buckets=buckets)

    def expose(self) -> str:
        """Prometheus text exposition (http_metrics /metrics body)."""
        with self._lock:  # snapshot vs a concurrent first-use registration
            collectors = [self._collectors[n] for n in sorted(self._collectors)]
        lines = []
        for c in collectors:
            lines.extend(c.expose())
        return "\n".join(lines) + "\n"


# process-global default registry (lighthouse_metrics lazy_static analog)
REGISTRY = Registry()


def inc_counter(name: str, amount: float = 1.0, **labels):
    REGISTRY.counter(name).inc(amount, **labels)


def set_gauge(name: str, value: float, **labels):
    REGISTRY.gauge(name).set(value, **labels)


def observe(name: str, value: float):
    REGISTRY.histogram(name).observe(value)


def set_distribution(name: str, values, **labels):
    """Expose a small population as min/p50/max gauges (one `q` label) —
    for distributions whose membership churns (gossipsub peer scores),
    where a histogram's cumulative buckets would never forget old peers."""
    vs = sorted(values)
    if not vs:
        return
    g = REGISTRY.gauge(name)
    g.set(vs[0], q="min", **labels)
    g.set(vs[len(vs) // 2], q="p50", **labels)
    g.set(vs[-1], q="max", **labels)


def start_timer(name: str) -> _Timer:
    return REGISTRY.histogram(name).start_timer()


# -- multi-process serving tier ------------------------------------------
#
# Forked API serving workers inherit this module's global REGISTRY as a
# copy-on-write snapshot. Two consequences the helpers below absorb:
#   1. inherited locks may be held by a parent thread that does not exist
#      in the child → reset_locks_after_fork()
#   2. the child's counters START at the parent's fork-time totals, so a
#      naive sum across processes double-counts everything pre-fork →
#      workers publish exposition_delta() snapshots and the scraping
#      process stitches them with merge_expositions().


def reset_locks_after_fork():
    """Refresh registry/collector locks in a freshly forked child.

    Safe only where host_pool's discipline already puts us: the child has
    exactly one thread, so plain reassignment cannot race anything."""
    REGISTRY._lock = threading.Lock()
    for c in list(REGISTRY._collectors.values()):
        c._lock = threading.Lock()


def _parse_exposition(text: str):
    """Parse a text exposition into ({collector: type}, {series line key:
    (collector, value)}, first-seen key order).

    The series key is the full left-hand side (`name{labels}`), which is
    exactly the identity Prometheus uses, so merging on it is lossless."""
    types: dict[str, str] = {}
    series: dict[str, tuple[str, float]] = {}
    order: list[str] = []
    current = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                current = parts[2]
                types[current] = parts[3]
            continue
        key, _, raw = line.rpartition(" ")
        if not key:
            continue
        try:
            v = float(raw)
        except ValueError:
            continue
        name = key.split("{", 1)[0]
        coll = current if current and name.startswith(current) else name
        if key not in series:
            order.append(key)
        series[key] = (coll, v)
    return types, series, order


def merge_expositions(texts) -> str:
    """Merge per-process text expositions into one scrape body.

    Counters and histogram series SUM across processes (cumulative bucket
    counts stay valid under addition); gauges keep the FIRST source that
    exposes a given series — callers list the live/primary process first
    so point-in-time values aren't summed into nonsense. Output groups
    each collector under a single # TYPE line, collectors sorted by name
    (Registry.expose parity) and series in first-seen order."""
    types: dict[str, str] = {}
    merged: dict[str, float] = {}
    order: dict[str, list[str]] = {}
    for text in texts:
        t, series, keys = _parse_exposition(text)
        for name, typ in t.items():
            types.setdefault(name, typ)
        for key in keys:
            coll, v = series[key]
            typ = types.get(coll, "gauge")
            if key not in merged:
                merged[key] = v
                order.setdefault(coll, []).append(key)
            elif typ in ("counter", "histogram"):
                merged[key] += v
            # gauge already present: first source wins
    lines = []
    for coll in sorted(order):
        if coll in types:
            lines.append(f"# TYPE {coll} {types[coll]}")
        for key in order[coll]:
            lines.append(f"{key} {_fmt_num(merged[key])}")
    return "\n".join(lines) + "\n"


def exposition_delta(current: str, baseline: str) -> str:
    """Rewrite `current` with counter/histogram series reduced by their
    `baseline` values.

    A forked worker captures baseline = REGISTRY.expose() right after the
    fork and publishes only what it accrued since, which is what makes
    merge_expositions' sum correct. Gauges pass through untouched (they
    are point-in-time, and the merge prefers the primary's anyway). A
    series that shrank below its baseline (collector recreated post-fork)
    is kept raw rather than clamped negative."""
    c_types, _, _ = _parse_exposition(current)
    _, b_series, _ = _parse_exposition(baseline)
    out = []
    coll = None
    for line in current.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            parts = s.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                coll = parts[2]
            out.append(line)
            continue
        key, _, raw = s.rpartition(" ")
        if c_types.get(coll) in ("counter", "histogram") and key in b_series:
            try:
                v = float(raw)
            except ValueError:
                out.append(line)
                continue
            base = b_series[key][1]
            nv = v - base if v >= base else v
            out.append(f"{key} {_fmt_num(nv)}")
        else:
            out.append(line)
    return "\n".join(out) + "\n"
