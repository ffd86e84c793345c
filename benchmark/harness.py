"""The benchmark's runner: one cell of ``BENCHMARK.json`` run once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name. The cell names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``); the
traffic names its driver (``drivers/<driver>.py``), which builds the inputs,
warms up, measures for ``--seconds`` and checks the answers against the
reference; each per-layer metric is read by ``metrics/<metric>.py``. A new
cell, configuration, mix or metric is new files and entries, never an edit.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` in a
traced run), then ``checks``: every number compared, with its limit, which
are also the last lines on standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Build and kernel caches live at fixed paths inside the checkout, so only a
# checkout's first run of a cell builds.
CACHE_DIR = ROOT / ".benchmark_cache"
# Top-level module names that no run may hold once its window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lighthouse_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a bad name)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by file path (metric files carry dots in
    their names, so they are not importable by name)."""
    if not path.is_file():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic and the metrics it
    reports, all looked up by name under the checkout `root`."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if cfg_entry is None:
        raise BenchError(f"no configuration named {entry['config']!r}")
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)
    ]
    return Cell(name, entry, config, traffic, e2e, per_layer)


def driver_of(cell: Cell, root: Path = ROOT):
    name = cell.traffic["driver"]
    return load_module(root / "benchmark" / "drivers" / f"{name}.py", f"bench_driver_{name}")


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


# ---------------------------------------------------------------------------
# What a run records
# ---------------------------------------------------------------------------


@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only where every value is at or under its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: the work attempted and failed, its
    end-to-end values, the checks, and what the per-layer readers read."""

    attempted: int
    failed: int
    e2e: dict
    checks: list
    work: dict = field(default_factory=dict)


@dataclass
class Trace:
    """The device's side of a traced window, from the profiler."""

    window_ns: tuple
    kernels: list  # (name, start_ns, dur_ns) of every device activity
    busy_s: float
    window_s: float
    host_ranges: list  # (label, start_ns, end_ns) the benchmark recorded

    def device_seconds(self, start_ns: int | None = None, end_ns: int | None = None, names=None) -> float:
        total = 0
        for name, s, d in self.kernels:
            if names is not None and not any(k in name for k in names):
                continue
            if start_ns is not None and (s + d <= start_ns or s >= end_ns):
                continue
            total += d
        return total / 1e9


class Ctx:
    """The run's clock, its optional profiler, and the program's counters."""

    def __init__(self, args, cell: Cell, t0: float):
        self.args = args
        self.cell = cell
        self.seed = args.seed
        self.seconds = args.seconds
        self.traced = bool(args.trace)
        self.t0 = t0
        self.setup_s: float | None = None
        self.memory_peak_bytes = 0
        self.trace: Trace | None = None
        self.host_ranges: list = []
        self._counters_at_start: dict = {}
        self.counters: dict = {}

    def setup_done(self) -> None:
        """Set-up ends where the first timed step starts."""
        self.setup_s = time.monotonic() - self.t0

    @contextlib.contextmanager
    def label(self, name: str):
        """A host range the traced window's idle gaps are named by."""
        if not self.traced:
            yield
            return
        s = time.time_ns()
        try:
            yield
        finally:
            self.host_ranges.append((name, s, time.time_ns()))

    @contextlib.contextmanager
    def window(self):
        """The measured window: counters read at both ends, and with
        ``--trace 1`` the profiler on from end to end."""
        import torch

        torch.cuda.synchronize()
        self._counters_at_start = program_counters()
        if not self.traced:
            yield
            torch.cuda.synchronize()
            self.counters = counter_delta(self._counters_at_start, program_counters())
            return
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        s = time.time_ns()
        try:
            yield
            torch.cuda.synchronize()
        finally:
            e = time.time_ns()
            prof.__exit__(None, None, None)
        self.counters = counter_delta(self._counters_at_start, program_counters())
        self.trace = read_trace(prof, s, e, self.host_ranges)
        del prof

    def read_memory(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    @staticmethod
    def free_device() -> None:
        import torch

        gc.collect()
        torch.cuda.empty_cache()


def read_trace(prof, start_ns: int, end_ns: int, host_ranges: list) -> Trace:
    """Every device activity of the window (kernels, copies, fills) from the
    profiler's events, and the union of their intervals."""
    kernels = []
    for ev in prof.profiler.kineto_results.events():
        if "CPU" in str(ev.device_type()):
            continue
        s, d = int(ev.start_ns()), int(ev.duration_ns())
        if d <= 0 or s + d < start_ns or s > end_ns:
            continue
        kernels.append((ev.name(), s, d))
    kernels.sort(key=lambda k: k[1])
    busy = 0
    cur_s = cur_e = None
    for _, s, d in kernels:
        s, e = max(s, start_ns), min(s + d, end_ns)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return Trace((start_ns, end_ns), kernels, busy / 1e9, (end_ns - start_ns) / 1e9, list(host_ranges))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host range that the benchmark had open."""
    by_name: dict = {}
    for name, _, d in trace.kernels:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    last = trace.window_ns[0]
    for _, s, d in trace.kernels:
        if s > last:
            gaps.append((last, s))
        last = max(last, s + d)
    if trace.window_ns[1] > last:
        gaps.append((last, trace.window_ns[1]))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for gs, ge in gaps[:top]:
        mid = (gs + ge) // 2
        inner = [r for r in trace.host_ranges if r[1] <= mid <= r[2]]
        label = min(inner, key=lambda r: r[2] - r[1])[0] if inner else "outside the benchmark's calls"
        named.append([label, (ge - gs) / 1e9])
    return {"device_ops": [[k[:120], v / 1e9] for k, v in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# The program's own counters and spans
# ---------------------------------------------------------------------------


def program_counters() -> dict:
    """The program's launch counters, the tree-hash cache's counters and
    its span histograms (count and sum of seconds), flattened by name."""
    from lighthouse_tpu_torch.metrics import REGISTRY
    from lighthouse_tpu_torch.ops import bls381, bls381_htc, bls381_pairing, fr, msm, sha256
    from lighthouse_tpu_torch.ssz import cached_tree_hash

    out: dict = {}
    for mod, prefix in ((sha256, "sha256"), (bls381, "bls381"), (bls381_htc, "bls381_htc"),
                        (bls381_pairing, "bls381_pairing"), (fr, "fr"), (msm, "msm")):
        for k, v in mod.COUNTS.items():
            out[f"{prefix}.{k}"] = v
    for k, v in cached_tree_hash.stats().items():
        out[f"tree_hash.{k}"] = v
    for name, metric in list(REGISTRY._collectors.items()):
        if name.startswith("trace_span_seconds_") and hasattr(metric, "snapshot"):
            _, _, total, seconds = metric.snapshot()
            out[f"span.{name[19:]}.count"] = total
            out[f"span.{name[19:]}.sum"] = seconds
    return out


def counter_delta(a: dict, b: dict) -> dict:
    return {k: v - a.get(k, 0) for k, v in b.items()}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def stop_program_processes() -> None:
    """Shut down the program's host pool, if the run made one, and wait for
    its worker processes to end."""
    import multiprocessing

    from lighthouse_tpu_torch.parallel import host_pool

    pool = host_pool._pool
    if pool is not None and pool._executor is not None:
        pool._executor.shutdown(wait=True, cancel_futures=True)
    host_pool.reset_pool()
    for child in multiprocessing.active_children():
        child.join(timeout=30)


def forbidden_loaded() -> list[str]:
    """Modules whose whole top-level name is one no run may load: `jax` and
    the JAX package, not the port whose name begins like it."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_env() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def require_cards(chips: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    torch.cuda.reset_peak_memory_stats()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "power_limit": power_limit()}


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi reads it: the peaks the shares
    are taken against hold at 700 W."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def result_line(cell: Cell, ctx: Ctx, out: Outcome, device: dict) -> dict:
    checks = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    correct = bool(out.checks) and all(c.ok for c in out.checks)
    if ctx.traced:
        metrics = {}
        run = LayerRun(cell, ctx, out)
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    else:
        metrics = {}
        for m in cell.end_to_end:
            value = ctx.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=ctx.memory_peak_bytes)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.traced:
        line["breakdown"] = breakdown(ctx.trace)
    line["checks"] = checks
    return line


@dataclass
class LayerRun:
    """What a per-layer reader reads: the cell, the window's trace (None
    untraced), the program's counter deltas over the window, and the
    driver's own record of the work."""

    cell: Cell
    ctx: Ctx
    out: Outcome

    @property
    def trace(self) -> Trace | None:
        return self.ctx.trace

    @property
    def counters(self) -> dict:
        return self.ctx.counters

    @property
    def work(self) -> dict:
        return self.out.work


def main(argv, t0: float) -> int:
    args = parse(argv)
    set_cache_env()
    try:
        cell = load_cell(args.workload)
        if cell.entry["chips"] != 1:
            raise BenchError("this harness drives one card a run")
        device = require_cards(cell.entry["chips"])
        driver = driver_of(cell)
        ctx = Ctx(args, cell, t0)
        try:
            out = driver.run(ctx)
        finally:
            stop_program_processes()
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad[:10])}", file=sys.stderr)
        return 3
    line = result_line(cell, ctx, out, device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def idle_pct(trace: Trace | None) -> float | None:
    """100 (1 - busy / window) of a traced window; None untraced."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100 * (1 - trace.busy_s / trace.window_s)
