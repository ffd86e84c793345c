"""Continuous in-process stack profiler, attributed to trace spans.

The trace trees (utils/tracing) say which STAGE is slow; this module says
which code INSIDE a stage is slow — the reference leans on external
profilers (perf / py-spy) for that, but in-process attribution works the
same on a one-core host and beside a card. A background sampler thread
walks `sys._current_frames()` at a fixed rate, folds each thread's stack
into collapsed-stack counts, and buckets every sample under the
innermost ACTIVE span of the sampled thread via `utils/tracing`'s
thread→span registry (contextvars are not readable cross-thread; the
beacon_processor additionally adopts the submitting span for each
handler run, so worker-side samples land under `block_import` /
`sync_range_batch` roots instead of "unattributed").

Aggregation is bounded: top-K stacks per trace-root name plus an
"unattributed" bucket, at most `MAX_ROOTS` distinct roots, counts
halved on a periodic decay pass so a long soak converges on recent
behavior instead of growing without bound. Exported three ways:

  * collapsed-stack text (flamegraph.pl format) and speedscope-
    compatible JSON at `/lighthouse/profile[?root=<name>]` on BOTH the
    MetricsServer and the Beacon API (metrics/server.serve_lighthouse_path),
  * `profiler_samples_total{root=...}` / `profiler_overrun_total`
    metrics, eagerly registered,
  * `top_stacks(n)`: the top-N hotspot stacks per root.

Knobs: `LIGHTHOUSE_TPU_PROFILE=1` arms the sampler (OFF by default —
disabled, this module never creates a thread), `LIGHTHOUSE_TPU_PROFILE_HZ`
(default 59 — deliberately off the 50/100 Hz timer multiples so periodic
slot/heartbeat work doesn't alias into phantom hotspots)."""

from __future__ import annotations

import os
import re
import sys
import threading
import time

from . import REGISTRY
from .trace_collector import ROOT_SPAN_NAMES

ENV_ENABLE = "LIGHTHOUSE_TPU_PROFILE"
ENV_HZ = "LIGHTHOUSE_TPU_PROFILE_HZ"
DEFAULT_HZ = 59.0
#: stacks retained per root name after a decay pass
MAX_STACKS_PER_ROOT = 64
#: distinct root buckets (mirrors trace_collector's reservoir-root cap);
#: overflow roots fold into "other"
MAX_ROOTS = 32
#: samples between decay passes (halve counts, drop <1): recent behavior
#: dominates a long soak
DECAY_EVERY = 8192
#: stack depth cap per sample (a runaway recursion must not make one
#: sweep quadratic)
MAX_DEPTH = 128

_SAMPLES = REGISTRY.counter(
    "profiler_samples_total",
    "stack samples taken, by attributed trace-root name",
)
for _name in ROOT_SPAN_NAMES:
    _SAMPLES.inc(0, root=_name)
_SAMPLES.inc(0, root="other")
_SAMPLES.inc(0, root="unattributed")
_OVERRUNS = REGISTRY.counter(
    "profiler_overrun_total",
    "sampling ticks skipped because one sweep overran the interval",
)
_OVERRUNS.inc(0)

_KIND_RE = re.compile(r"[-_]?\d+$")


def _thread_kind(name: str | None) -> str:
    """Collapse a thread name to its KIND: worker/manager pools differ
    only by a trailing index ("network_beacon_processor-w3"), and the
    flamegraph should merge them into one lane."""
    if not name:
        return "thread:?"
    base = _KIND_RE.sub("", name.split(" ")[0])
    return "thread:" + (base or name)


def _hz_from_env() -> float:
    try:
        return float(os.environ.get(ENV_HZ, "") or DEFAULT_HZ)
    except ValueError:
        return DEFAULT_HZ


class StackProfiler:
    def __init__(self, hz: float | None = None,
                 max_stacks_per_root: int = MAX_STACKS_PER_ROOT):
        self.set_hz(hz if hz is not None else _hz_from_env())
        self._max_stacks = max(1, max_stacks_per_root)
        self._lock = threading.Lock()
        #: root name -> {collapsed stack: count} (counts go fractional
        #: only through decay halving)
        self._stacks: dict[str, dict[str, float]] = {}
        #: (code object, lineno) -> rendered frame label (bounded)
        self._label_cache: dict[tuple, str] = {}
        self._samples_since_decay = 0
        self.samples_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def set_hz(self, hz: float):
        """Retune the sampling rate (takes effect at the next tick; the
        arm path re-reads the env knob through this while idle)."""
        self.hz = max(1.0, min(1000.0, hz))
        self.interval = 1.0 / self.hz

    # -- lifecycle -------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "StackProfiler":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="stack-profiler"
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # GIL-starved mid-sweep (e.g. a concurrent kernel build):
                # keep `running` True so a re-arm can't start a SECOND
                # sampler double-counting every stack; it will exit at
                # its next tick and a later start() recovers
                return
        self._thread = None

    def _loop(self):
        me = threading.get_ident()
        next_tick = time.monotonic() + self.interval
        while not self._stop.is_set():
            self.sample_once(skip_ident=me)
            now = time.monotonic()
            if now >= next_tick:
                # the sweep overran its tick: count the misses and
                # resynchronize instead of bursting to catch up
                missed = int((now - next_tick) / self.interval) + 1
                _OVERRUNS.inc(missed)
                next_tick = now + self.interval
            else:
                self._stop.wait(next_tick - now)
                next_tick += self.interval

    # -- sampling --------------------------------------------------------

    def _frame_label(self, frame) -> str:
        co = frame.f_code
        key = (co, frame.f_lineno)
        label = self._label_cache.get(key)
        if label is None:
            fn = co.co_filename
            i = fn.rfind("lighthouse_tpu")
            fn = fn[i:] if i != -1 else os.path.basename(fn)
            label = f"{co.co_name} ({fn}:{frame.f_lineno})"
            if len(self._label_cache) >= 8192:
                self._label_cache.clear()
            self._label_cache[key] = label
        return label

    def sample_once(self, skip_ident: int | None = None) -> int:
        """One sweep over every live thread; returns the number of
        samples recorded. Public so tests can drive sampling
        deterministically without the timer thread."""
        from ..utils.tracing import thread_spans

        spans = thread_spans()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        taken = 0
        try:
            with self._lock:
                for tid, frame in frames.items():
                    if tid == skip_ident:
                        continue
                    span = spans.get(tid)
                    root = span.root_name if span is not None else "unattributed"
                    label = (
                        root
                        if root in ROOT_SPAN_NAMES or root == "unattributed"
                        else "other"
                    )
                    _SAMPLES.inc(root=label)
                    per_root = self._stacks.get(root)
                    if per_root is None:
                        if len(self._stacks) >= MAX_ROOTS:
                            root = "other"
                            per_root = self._stacks.setdefault(root, {})
                        else:
                            per_root = self._stacks[root] = {}
                    chain = []
                    f = frame
                    while f is not None and len(chain) < MAX_DEPTH:
                        chain.append(self._frame_label(f))
                        f = f.f_back
                    chain.append(_thread_kind(names.get(tid)))
                    key = ";".join(reversed(chain))
                    if key not in per_root and len(per_root) >= self._max_stacks * 4:
                        self._prune_locked(per_root)
                    per_root[key] = per_root.get(key, 0) + 1
                    taken += 1
                self.samples_total += taken
                self._samples_since_decay += taken
                if self._samples_since_decay >= DECAY_EVERY:
                    self._decay_locked()
        finally:
            del frames  # drop the foreign frame references promptly
        return taken

    def _prune_locked(self, per_root: dict):
        top = sorted(per_root.items(), key=lambda kv: kv[1], reverse=True)
        per_root.clear()
        per_root.update(top[: self._max_stacks * 2])

    def _decay_locked(self):
        self._samples_since_decay = 0
        for root in list(self._stacks):
            decayed = {
                k: v / 2.0
                for k, v in self._stacks[root].items()
                if v / 2.0 >= 1.0
            }
            if len(decayed) > self._max_stacks:
                top = sorted(
                    decayed.items(), key=lambda kv: kv[1], reverse=True
                )
                decayed = dict(top[: self._max_stacks])
            if decayed:
                self._stacks[root] = decayed
            else:
                del self._stacks[root]

    def clear(self):
        with self._lock:
            self._stacks.clear()
            self._label_cache.clear()
            self.samples_total = 0
            self._samples_since_decay = 0

    # -- exports ---------------------------------------------------------

    def snapshot(self, root: str | None = None) -> dict[str, dict[str, int]]:
        """{root: {collapsed stack: count}} (counts floored to int).
        Stacks are stored under their RAW root name (bounded at
        MAX_ROOTS) while `profiler_samples_total` folds non-taxonomy
        roots into its `other` label — so `root="other"` here returns
        every non-taxonomy root, keeping the metric's aggregate and the
        endpoint's answer consistent."""
        with self._lock:
            if root == "other":
                roots = sorted(
                    r
                    for r in self._stacks
                    if r not in ROOT_SPAN_NAMES and r != "unattributed"
                )
            elif root is not None:
                roots = [root]
            else:
                roots = sorted(self._stacks)
            return {
                r: {k: int(v) for k, v in self._stacks[r].items() if v >= 1}
                for r in roots
                if r in self._stacks
            }

    def collapsed(self, root: str | None = None) -> str:
        """flamegraph.pl collapsed-stack text: `root;thread:<kind>;f1;f2 N`
        per line, hottest first within each root."""
        lines = []
        for r, per_root in self.snapshot(root).items():
            for stack, n in sorted(
                per_root.items(), key=lambda kv: (-kv[1], kv[0])
            ):
                lines.append(f"{r};{stack} {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def speedscope(self, root: str | None = None) -> dict:
        """speedscope file-format JSON, one "sampled" profile per root —
        load at https://www.speedscope.app or with `speedscope <file>`."""
        frames: list[dict] = []
        index: dict[str, int] = {}

        def fidx(name: str) -> int:
            i = index.get(name)
            if i is None:
                i = index[name] = len(frames)
                frames.append({"name": name})
            return i

        profiles = []
        for r, per_root in self.snapshot(root).items():
            samples, weights = [], []
            for stack, n in sorted(per_root.items(), key=lambda kv: -kv[1]):
                samples.append([fidx(r)] + [fidx(p) for p in stack.split(";")])
                weights.append(n)
            profiles.append(
                {
                    "type": "sampled",
                    "name": r,
                    "unit": "none",
                    "startValue": 0,
                    "endValue": float(sum(weights)),
                    "samples": samples,
                    "weights": weights,
                }
            )
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "name": "lighthouse_tpu_torch stack profile",
            "exporter": "lighthouse_tpu_torch.metrics.profiler",
        }

    def top_stacks(self, n: int = 5) -> dict[str, list[dict]]:
        """Top-N hotspot stacks per root."""
        return {
            r: [
                {"stack": k, "samples": v}
                for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]
            ]
            for r, per in self.snapshot().items()
        }


#: process-global sampler (REGISTRY/COLLECTOR analog). Constructed idle:
#: no thread exists until something arms it.
PROFILER = StackProfiler()
_ARM_LOCK = threading.Lock()


def profiler_enabled() -> bool:
    return os.environ.get(ENV_ENABLE) == "1"


def maybe_start_profiler() -> StackProfiler | None:
    """Arm the global sampler iff `LIGHTHOUSE_TPU_PROFILE=1`. Called by
    the long-running entry points (MetricsServer/HttpApiServer start);
    with the flag unset this is a no-op and NO thread is ever created.
    Re-arms the SAME instance (re-reading the hz knob) rather than
    swapping in a fresh one: endpoint threads hold PROFILER references,
    and a swap that aliased `_stacks` across two instances would split
    the lock guarding them. The lock keeps two servers starting
    concurrently from racing the check-then-arm into two samplers."""
    if not profiler_enabled():
        return None
    with _ARM_LOCK:
        if not PROFILER.running:
            PROFILER.set_hz(_hz_from_env())
            PROFILER.start()
        return PROFILER


def stop_profiler(timeout: float = 2.0):
    if PROFILER.running:
        PROFILER.stop(timeout)
