"""Persistent fork-based host worker pool.

Counterpart of lighthouse_tpu/parallel/host_pool.py, copied; the port's
work units (crypto/bls `_prep_chunk`, `_hash_g2_chunk`, `_msm_chunk`,
`_sign_chunk`, bls12_381 `miller_product`; das/proofs `_prove_shard`,
`_msm_shard`) are pure-Python bigint code. In the port a forked child
never touches torch or CUDA: the parent may hold a CUDA context (a CUDA
context does not survive `fork`), so the work units reference no torch,
no metrics, logging, spans or locks; tests/test_torch_host_pool.py scans
them for it, the counterpart of the JAX lint's fork-safety rule.

The reference shards its block-import crypto across a rayon thread pool
(state_processing/src/per_block_processing/block_signature_verifier.rs);
CPython's GIL makes threads useless for the pure-Python bigint hot path, so
the analog here is a pool of **forked processes**:

* **fork, not spawn** — children inherit the parent's memory at fork time,
  so the bls12_381 module (window tables, curve constants) and the workers'
  plain-dict decompression caches are warm with zero import or pickling
  cost per worker;
* **lazy spawn** — the executor is created on the first sharded `map`, so
  processes that never batch-verify (tests, CLI tools) never fork;
* **persistent** — one module-global pool serves every batch; worker caches
  therefore accumulate across batches exactly like the parent's LRUs;
* **clean degrade** — size ≤ 1 (or a fork-less platform) runs tasks inline
  in the caller, bit-for-bit the same code path the workers run.

Sizing: `LIGHTHOUSE_TPU_HOST_POOL` (0/1 forces inline), defaulting to
`os.cpu_count()`. `get_pool()` re-reads the env var and transparently
replaces the pool when it changes (tests sweep sizes this way).

Fork-safety rule for task functions: a forked child inherits every lock in
whatever state some other parent thread held it at fork time, so task
functions must be lock-free pure Python — no metrics registry, no logging,
plain-dict caches only (see crypto/bls's `_prep_chunk` family). The pool
itself only touches the metrics registry from the parent process: counters
are incremented parent-side, workers return plain data for the parent to
tally. In the port the rule is checked by tests/test_torch_host_pool.py:
every callable submitted to `map` is resolved (one import hop) and its
same-module call graph scanned for metrics/logging/span/torch/lock
references.

Failure surface: a task exception propagates out of `map` (remaining tasks
are cancelled); a dead worker raises `BrokenProcessPool`, after which the
executor is discarded so the next `map` forks a fresh pool. Callers in the
verification path turn either into a verification failure, never a hang.

`bls_pool_tasks_total{mode=inline|fork}` counts every task routed through
the pool (eagerly registered).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool  # noqa: F401 — re-export

from ..metrics import REGISTRY, inc_counter

ENV_VAR = "LIGHTHOUSE_TPU_HOST_POOL"

_HAS_FORK = hasattr(os, "fork")

for _m in ("inline", "fork"):
    REGISTRY.counter(
        "bls_pool_tasks_total", "host-pool tasks by execution mode"
    ).inc(0.0, mode=_m)
del _m


def size_from_env() -> int:
    raw = os.environ.get(ENV_VAR)
    if raw is not None:
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return os.cpu_count() or 1


def _forget_parent_executors():
    """Worker initializer. A forked worker inherits the parent's registry
    of executor wake-ups (`concurrent.futures.process._threads_wakeups`);
    at the worker's exit `_python_exit` takes each one's lock, which a
    parent thread may have held at fork time (an executor still shutting
    down), and the worker hangs. The worker owns none of them: forget
    them."""
    from concurrent.futures import process

    process._threads_wakeups.clear()


class HostPool:
    """Fixed-size fork pool with ordered `map` and inline degrade."""

    def __init__(self, size: int):
        self.size = size
        self._executor: ProcessPoolExecutor | None = None

    @property
    def inline(self) -> bool:
        return self.size <= 1 or not _HAS_FORK

    def map(self, fn, tasks) -> list:
        """Apply `fn` to each task, preserving order. Inline when the pool
        is degraded or there is nothing to parallelize; otherwise sharded
        across the forked workers. Task exceptions propagate; a broken pool
        is discarded before its error propagates (next call respawns)."""
        tasks = list(tasks)
        if not tasks:
            return []
        if self.inline or len(tasks) == 1:
            inc_counter("bls_pool_tasks_total", float(len(tasks)), mode="inline")
            return [fn(t) for t in tasks]
        inc_counter("bls_pool_tasks_total", float(len(tasks)), mode="fork")
        futures = [self._ensure().submit(fn, t) for t in tasks]
        try:
            return [f.result() for f in futures]
        except BrokenProcessPool:
            self.shutdown()  # dead workers; next map() forks a fresh pool
            raise
        except BaseException:
            for f in futures:
                f.cancel()
            raise

    def _ensure(self) -> ProcessPoolExecutor:
        if self._executor is None:
            self._executor = ProcessPoolExecutor(
                max_workers=self.size,
                mp_context=multiprocessing.get_context("fork"),
                initializer=_forget_parent_executors,
            )
        return self._executor

    def shutdown(self):
        ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=False, cancel_futures=True)


_pool: HostPool | None = None


def get_pool() -> HostPool:
    """The process-wide pool, created lazily at the env-configured size and
    replaced (old one shut down) whenever that size changes."""
    global _pool
    size = size_from_env()
    if _pool is None or _pool.size != size:
        if _pool is not None:
            _pool.shutdown()
        _pool = HostPool(size)
    return _pool


def reset_pool():
    """Tear down the global pool (tests; also safest before re-fork)."""
    global _pool
    if _pool is not None:
        _pool.shutdown()
    _pool = None


def shard(items, parts: int) -> list:
    """Split `items` into ≤`parts` contiguous, order-preserving chunks."""
    items = list(items)
    if not items:
        return []
    parts = max(1, min(parts, len(items)))
    step = -(-len(items) // parts)
    return [items[i : i + step] for i in range(0, len(items), step)]
