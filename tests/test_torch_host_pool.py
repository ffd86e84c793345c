"""The port's host fork pool (lighthouse_tpu_torch/parallel/host_pool.py):
the cases of tests/test_host_pool.py against the port's pool and BLS host
backend, the fork-safety rule over the port's work units (with torch in
its vocabulary: a forked child never touches torch or CUDA), and the
das batch cell verification at pool sizes 1 and 4.

Verdicts, signatures, proofs and counts compare exactly.
"""

import ast
import os
import random
from pathlib import Path

import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls12_381 import g2_from_bytes
from lighthouse_tpu_torch.metrics import REGISTRY
from lighthouse_tpu_torch.parallel import host_pool
from lighthouse_tpu_torch.parallel.host_pool import BrokenProcessPool, HostPool

PKG = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch"


@pytest.fixture(autouse=True)
def fresh_pool():
    prev = bls.backend_setting()
    bls.set_backend("host")
    host_pool.reset_pool()
    yield
    host_pool.reset_pool()
    bls.set_backend(prev)


def _square(x):
    return x * x


def _boom(x):
    raise RuntimeError("worker task exploded")


def _exit_hard(x):
    os._exit(13)  # simulate an OOM-killed worker: no exception, no result


def _sets(n, n_msgs=4):
    kps = bls.interop_keypairs(3)
    out = []
    for i in range(n):
        m = bytes([i % n_msgs]) * 32
        kp = kps[i % 3]
        out.append(bls.SignatureSet(kp.sk.sign(m), [kp.pk], m))
    return out


def test_inline_degrade_at_size_leq_one():
    for size in (0, 1):
        p = HostPool(size)
        assert p.inline
        assert p.map(_square, [1, 2, 3]) == [1, 4, 9]
        assert p._executor is None  # never forked


def test_fork_pool_maps_in_order():
    p = HostPool(4)
    try:
        assert p.map(_square, list(range(17))) == [x * x for x in range(17)]
    finally:
        p.shutdown()


def test_results_identical_across_pool_sizes(monkeypatch):
    """Verdicts on a valid and a tampered batch, and batch signatures, are
    the same at pool sizes 0, 1 and 4 (signatures equal per-key `sign`)."""
    sets = _sets(12)
    tampered = list(sets)
    tampered[5] = bls.SignatureSet(sets[4].signature, sets[5].pubkeys, sets[5].message)
    kps = bls.interop_keypairs(3)
    sks = [kps[i % 3].sk for i in range(12)]
    msgs = [bytes([i % 2]) * 32 for i in range(12)]
    want_sigs = [sk.sign(m).to_bytes() for sk, m in zip(sks, msgs)]
    for size in ("0", "1", "4"):
        monkeypatch.setenv(host_pool.ENV_VAR, size)
        host_pool.reset_pool()
        assert bls.verify_signature_sets(sets, random.Random(9)) is True, size
        assert bls.verify_signature_sets(tampered, random.Random(9)) is False, size
        got = [s.to_bytes() for s in bls._BACKENDS["host"].sign_batch(sks, msgs)]
        assert got == want_sigs, size


def test_sign_batch_of_a_vc_slot_equals_sign_at_every_pool_size(monkeypatch):
    """The validator client's shape at 1M validators: one distinct message
    a committee, ~64 a slot. Here 64 messages: 62 signed by one key each
    (per-key ladders) and 2 by 12 keys each (a fixed-base table, sharded
    over the workers at size 4), in an interleaved order; each signature
    equals per-key `sign` at pool sizes 0, 1 and 4."""
    kps = bls.interop_keypairs(24)
    msgs = [bytes([i]) * 32 for i in range(64)]
    pairs = [(kps[i % 24].sk, msgs[i]) for i in range(62)]
    pairs += [(kps[j].sk, msgs[62 + j % 2]) for j in range(24)]
    order = random.Random(18).sample(range(len(pairs)), len(pairs))
    sks = [pairs[i][0] for i in order]
    ms = [pairs[i][1] for i in order]
    want = [sk.sign(m).to_bytes() for sk, m in zip(sks, ms)]
    for size in ("0", "1", "4"):
        monkeypatch.setenv(host_pool.ENV_VAR, size)
        host_pool.reset_pool()
        assert [s.to_bytes() for s in bls.sign_batch(sks, ms)] == want, size


def test_env_resize_replaces_pool(monkeypatch):
    monkeypatch.setenv(host_pool.ENV_VAR, "2")
    p2 = host_pool.get_pool()
    assert p2.size == 2 and host_pool.get_pool() is p2  # stable while env is
    monkeypatch.setenv(host_pool.ENV_VAR, "3")
    p3 = host_pool.get_pool()
    assert p3.size == 3 and p3 is not p2


def test_pool_survives_reuse_across_batches(monkeypatch):
    monkeypatch.setenv(host_pool.ENV_VAR, "2")
    sets = _sets(10)
    assert bls.verify_signature_sets(sets, random.Random(1)) is True
    p = host_pool.get_pool()
    ex = p._executor
    assert ex is not None  # really forked
    assert bls.verify_signature_sets(sets, random.Random(2)) is True
    assert host_pool.get_pool() is p and p._executor is ex  # same workers


def test_worker_exception_propagates_from_map(monkeypatch):
    monkeypatch.setenv(host_pool.ENV_VAR, "2")
    with pytest.raises(RuntimeError, match="worker task exploded"):
        host_pool.get_pool().map(_boom, [1, 2, 3])


def test_worker_exception_is_verification_failure_not_a_hang(monkeypatch):
    monkeypatch.setenv(host_pool.ENV_VAR, "2")
    host_pool.reset_pool()
    sets = _sets(8)
    monkeypatch.setattr(bls, "_prep_chunk", _boom)
    assert bls.verify_signature_sets(sets, random.Random(3)) is False


def test_dead_worker_breaks_pool_then_recovers(monkeypatch):
    monkeypatch.setenv(host_pool.ENV_VAR, "2")
    p = host_pool.get_pool()
    with pytest.raises(BrokenProcessPool):
        p.map(_exit_hard, [1, 2, 3])
    assert p._executor is None  # dead executor discarded, not leaked
    # same pool object forks fresh workers and serves the next batch
    assert p.map(_square, [5, 6]) == [25, 36]
    assert bls.verify_signature_sets(_sets(6), random.Random(4)) is True


def test_pool_task_counter_counts_modes(monkeypatch):
    counter = REGISTRY.counter("bls_pool_tasks_total")
    inline0 = counter.value(mode="inline")
    fork0 = counter.value(mode="fork")
    HostPool(1).map(_square, [1, 2])
    assert counter.value(mode="inline") == inline0 + 2
    p = HostPool(2)
    try:
        p.map(_square, [1, 2, 3])
    finally:
        p.shutdown()
    assert counter.value(mode="fork") == fork0 + 3


def test_shard_preserves_order_and_bounds():
    assert host_pool.shard([], 4) == []
    assert host_pool.shard([1, 2, 3], 1) == [[1, 2, 3]]
    chunks = host_pool.shard(list(range(10)), 3)
    assert len(chunks) <= 3  # contiguous ceil-split
    assert [x for c in chunks for x in c] == list(range(10))
    assert host_pool.shard([1], 8) == [[1]]


# ---------------------------------------------------------------------------
# Fork safety of the port's work units
# ---------------------------------------------------------------------------

# What a forked child must not reach: torch (a CUDA context does not
# survive fork; torch's thread pools hold locks), JAX, the metrics
# registry, tracing spans, logging and locks (inherited as-held).
FORBIDDEN = {
    "torch": "torch",
    "jax": "jax",
    "jnp": "jax",
    "REGISTRY": "the metrics registry",
    "inc_counter": "the metrics registry",
    "set_gauge": "the metrics registry",
    "observe": "the metrics registry",
    "start_timer": "the metrics registry",
    "set_distribution": "the metrics registry",
    "span": "a tracing span",
    "traced": "a tracing span",
    "get_logger": "the logging subsystem",
    "logging": "the logging subsystem",
    "logger": "the logging subsystem",
    "log": "the logging subsystem",
    "threading": "a lock-bearing threading object",
    "Lock": "a lock",
    "RLock": "a lock",
}

# The units the port submits to the pool (crypto/bls, das/proofs).
UNITS = {"_prep_chunk", "_hash_g2_chunk", "_msm_chunk", "_sign_chunk", "miller_product", "_prove_shard", "_msm_shard", "_decompress_g2_chunk"}


def _module(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    imports = {}
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.module is not None and n.level > 0:
            base = path.parent
            for _ in range(n.level - 1):
                base = base.parent
            target = base.joinpath(*n.module.split("."))
            for a in n.names:
                imports[a.asname or a.name] = (target, a.name)
    return funcs, imports


def _resolve(target: Path, name: str):
    for cand in (target.with_suffix(".py"), target / "__init__.py"):
        if cand.exists():
            funcs, imports = _module(cand)
            if name in funcs:
                return cand, funcs[name]
            if name in imports:  # a package re-export: one more hop
                return _resolve(*imports[name])
    return None


def _scan(path: Path, fn: ast.FunctionDef, seen: set) -> list:
    """Forbidden references in `fn` and everything it calls by bare name,
    followed across the port's modules."""
    key = (path, fn.name)
    if key in seen:
        return []
    seen.add(key)
    funcs, imports = _module(path)
    found, callees = [], set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if node.id in FORBIDDEN:
                found.append(f"{path.name}:{node.lineno} {fn.name} -> {node.id} ({FORBIDDEN[node.id]})")
            callees.add(node.id)
        elif isinstance(node, ast.Attribute) and node.attr in ("Lock", "RLock"):
            found.append(f"{path.name}:{node.lineno} {fn.name} -> {node.attr}")
    for name in callees:
        if name in funcs:
            found += _scan(path, funcs[name], seen)
        elif name in imports:
            hit = _resolve(*imports[name])
            if hit is not None:
                found += _scan(hit[0], hit[1], seen)
    return found


def _pool_workers() -> dict:
    """(module path, worker name) -> its FunctionDef, for every first
    argument of a `<...pool...>.map(...)` or `.submit(...)` in the port."""
    out = {}
    for path in sorted(PKG.rglob("*.py")):
        if path.parent.name == "parallel":
            continue  # the pool itself re-submits its parameter
        tree = ast.parse(path.read_text(), str(path))
        funcs, imports = _module(path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args and isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr not in ("map", "submit") or "pool" not in ast.unparse(node.func.value).lower():
                continue
            worker = node.args[0]
            assert isinstance(worker, ast.Name), f"{path.name}:{node.lineno}: a pool worker must be a module-level function"
            if worker.id in funcs:
                out[(path, worker.id)] = funcs[worker.id]
            else:
                hit = _resolve(*imports[worker.id])
                assert hit is not None, f"{path.name}:{node.lineno}: cannot resolve {worker.id}"
                out[(hit[0], hit[1].name)] = hit[1]
    return out


def test_pool_work_units_touch_no_torch_metrics_logging_or_locks():
    workers = _pool_workers()
    assert {name for _, name in workers} == UNITS
    found = []
    for (path, _), fn in workers.items():
        found += _scan(path, fn, set())
    assert not found, "\n".join(found)


def test_fork_safety_scan_sees_torch(tmp_path):
    """The scan flags a unit that reaches torch through a same-module
    helper, so a clean result above means something."""
    path = tmp_path / "m.py"
    path.write_text("import torch\n\n\ndef _helper(x):\n    return torch.zeros(1)\n\n\ndef unit(x):\n    return _helper(x)\n")
    funcs, _ = _module(path)
    found = _scan(path, funcs["unit"], set())
    assert len(found) == 1 and "-> torch" in found[0], found


# ---------------------------------------------------------------------------
# das work units through the pool
# ---------------------------------------------------------------------------


def test_das_cells_and_batch_verdicts_equal_at_pool_sizes_1_and_4(monkeypatch):
    """compute_cells_and_proofs (`_prove_shard` through the pool) and
    verify_cell_kzg_proof_batch (`_msm_shard`, 128 cells: 4 lanes at size
    4) give equal cells, proofs and verdicts at pool sizes 1 and 4."""
    from lighthouse_tpu_torch import das
    from lighthouse_tpu_torch.crypto import kzg as K

    fe, cols = 16, 8
    kzg = K.Kzg(K.TrustedSetup.insecure_dev(fe), device=False)
    rng = random.Random(21)
    blobs = [b"".join(rng.randrange(K.FR_MODULUS).to_bytes(32, "big") for _ in range(fe)) for _ in range(2)]
    results = []
    for size in ("1", "4"):
        monkeypatch.setenv(host_pool.ENV_VAR, size)
        host_pool.reset_pool()
        fork0 = REGISTRY.counter("bls_pool_tasks_total").value(mode="fork")
        out = [das.compute_cells_and_proofs(b, kzg, cols) for b in blobs]
        items = [(c, j, cells[j], proofs[j]) for cells, proofs, c in out for j in range(cols)] * 8
        bad = list(items)
        bad[5] = (*bad[5][:3], bad[6][3])
        verdicts = (das.verify_cell_kzg_proof_batch(items, kzg), das.verify_cell_kzg_proof_batch(bad, kzg))
        forked = REGISTRY.counter("bls_pool_tasks_total").value(mode="fork") - fork0
        results.append((out, verdicts))
        assert (forked > 0) == (size == "4"), (size, forked)
    assert results[0] == results[1]
    assert results[0][1] == (True, False)


def test_cuda_staging_decompresses_a_large_batch_on_the_pool(monkeypatch):
    """The `cuda` backend decompresses the signatures of a batch of at least
    POOL_DECOMPRESS_MIN sets on the pool, POOL_DECOMPRESS_SETS at a time,
    into the signature cache (the points the host decompression gives); an
    encoding that does not decompress is left to the card's staging, which
    refuses its chunk as before."""
    import torch

    monkeypatch.setattr("lighthouse_tpu_torch.device._default", torch.device("cpu"))
    monkeypatch.setenv("LIGHTHOUSE_TPU_HOST_POOL", "2")
    monkeypatch.setattr(bls, "POOL_DECOMPRESS_MIN", 4)
    monkeypatch.setattr(bls, "POOL_DECOMPRESS_SETS", 4)
    host_pool.reset_pool()
    kps = bls.interop_keypairs(6)
    msgs = [bytes([i]) * 32 for i in range(6)]
    sigs = [kp.sk.sign(m).to_bytes() for kp, m in zip(kps, msgs)]
    bad = bytes([0x9F]) + b"\xff" * 95  # a compressed x above the field modulus
    sets = [bls.SignatureSet.single(bls.Signature(s), kp.pk, m) for s, kp, m in zip(sigs + [bad], kps + kps[:1], msgs + msgs[:1])]
    bls._SIG_CACHE.clear()
    staged = []
    monkeypatch.setattr(bls, "_decompress_on_pool", lambda part, real=bls._decompress_on_pool: (staged.append(len(part)), real(part))[1])
    monkeypatch.setattr("lighthouse_tpu_torch.ops.bls381_verify.verify_signature_sets_device_full", lambda chunk, rng=None: True)
    monkeypatch.setenv("LIGHTHOUSE_TPU_BLS_CHUNK", "2")
    assert bls._BACKENDS["cuda"].verify_signature_sets(sets)
    assert staged == [4, 3]
    for s in sigs:
        assert bls._SIG_CACHE.has(s)
        assert bls.Signature(s).point() == g2_from_bytes(s)
    assert not bls._SIG_CACHE.has(bad)
    # a small batch stays off the pool
    staged.clear()
    assert bls._BACKENDS["cuda"].verify_signature_sets(sets[:3])
    assert staged == []
