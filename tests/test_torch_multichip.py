"""The port's multi-device step (lighthouse_tpu_torch/parallel, K10
ops/merkle_sharded.py, K11 ops/bls381_sharded.py, entry.py) on the CPU:
ranks are spawned processes joined by a gloo process group at a file
store, the counterpart of the JAX tests' eight virtual CPU devices
(tests/test_multichip.py). The kernels' plain versions run on each rank.

Oracles: hashlib for Merkle roots, the host bigint BLS12-381 code for
Σ rᵢ·Pᵢ (compared as affine points: the port's tree pairs neighbours where
JAX carries an odd count's last point, so Jacobian limbs differ), and, in
one `slow` test, the JAX package's own sharded functions on eight virtual
devices. Tolerance: exact equality of bytes and field integers.

The rank functions are module-level so that spawned ranks can import
them; this module imports no JAX.
"""

import hashlib
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import default_device, set_default_device
from lighthouse_tpu_torch.crypto.bls12_381 import FQ, G1_GEN, R, inf, pt_add, pt_mul, to_affine
from lighthouse_tpu_torch.entry import dryrun_multichip, run_ranks
from lighthouse_tpu_torch.ops import bls381 as K2
from lighthouse_tpu_torch.ops import merkle_sharded as K10
from lighthouse_tpu_torch.ops.bls381_sharded import sharded_rlc_g1
from lighthouse_tpu_torch.parallel.mesh import shard_batch

ROOT = Path(__file__).resolve().parent.parent
LEAVES_PER_RANK = 16
POINTS_PER_RANK = 3
RANK_TIMEOUT_S = 300.0


def _hashlib_root(leaves: np.ndarray) -> bytes:
    nodes = [row.tobytes() for row in leaves]
    while len(nodes) > 1:
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest() for i in range(0, len(nodes), 2)]
    return nodes[0]


def _leaves(n_ranks: int) -> np.ndarray:
    return np.random.default_rng(3 + n_ranks).integers(0, 256, (n_ranks * LEAVES_PER_RANK, 32), dtype=np.uint8)


def _rlc_inputs(n_ranks: int) -> tuple[list, list[int]]:
    """Seeded G1 points and 64-bit scalars, with an infinity point and a
    zero scalar among them."""
    rng = random.Random(100 + n_ranks)
    n = n_ranks * POINTS_PER_RANK
    pts = [pt_mul(FQ, G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.getrandbits(64) for _ in range(n)]
    pts[1] = inf(FQ)
    scalars[2] = 0
    return pts, scalars


def _host_rlc(pts, scalars):
    acc = inf(FQ)
    for p, s in zip(pts, scalars):
        acc = pt_add(FQ, acc, pt_mul(FQ, p, s))
    return to_affine(FQ, acc)


def _rank_steps(mesh, out_dir: str) -> None:
    """On each rank: the sharded Merkle root of its leaves and the sharded
    RLC sum of its points, saved for the test to check."""
    n = mesh.size
    root = K10.sharded_merkle_root(shard_batch(torch.from_numpy(_leaves(n)), mesh), mesh)
    pts, scalars = _rlc_inputs(n)
    pts_t = shard_batch(torch.from_numpy(K2.g1_to_limbs(pts)), mesh)
    k_t = shard_batch(K2.scalars_to_tensor(scalars), mesh)
    rlc = sharded_rlc_g1(pts_t, k_t, mesh)
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", root=root.numpy(), rlc=rlc.numpy())


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    prev_dev, prev_threads = default_device(), torch.get_num_threads()
    set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev_threads)
    set_default_device(prev_dev)


_RESULTS: dict = {}


def _gloo_results(n_ranks: int, tmp_path_factory) -> list:
    """Every rank's (root bytes, affine sum) from one gloo run at n_ranks
    (run once per rank count for the tests that read it)."""
    if n_ranks not in _RESULTS:
        out = tmp_path_factory.mktemp(f"ranks{n_ranks}")
        run_ranks(_rank_steps, n_ranks, "cpu", args=(str(out),), timeout=RANK_TIMEOUT_S)
        res = []
        for r in range(n_ranks):
            z = np.load(out / f"rank{r}.npz")
            res.append((z["root"].tobytes(), to_affine(FQ, K2.g1_from_limbs(z["rlc"])[0])))
        _RESULTS[n_ranks] = res
    return _RESULTS[n_ranks]


@pytest.mark.parametrize("depth", range(11))
def test_plain_subtree_reduction_equals_hashlib(depth):
    leaves = np.random.default_rng(depth).integers(0, 256, (1 << depth, 32), dtype=np.uint8)
    t = torch.from_numpy(leaves)
    assert K10.subtree_root(t)[0].numpy().tobytes() == _hashlib_root(leaves)
    if depth:
        levels = min(depth, K10.MAX_LEVELS)
        got = K10.merkle_subtree_roots(t, levels)
        want = [_hashlib_root(leaves[i : i + (1 << levels)]) for i in range(0, 1 << depth, 1 << levels)]
        assert [row.numpy().tobytes() for row in got] == want


def test_subtree_launch_refuses_bad_shapes():
    with pytest.raises(ValueError):
        K10.merkle_subtree_roots(torch.zeros((12, 32), dtype=torch.uint8), 3)
    with pytest.raises(ValueError):
        K10.merkle_subtree_roots(torch.zeros((1024, 32), dtype=torch.uint8), 10)
    with pytest.raises(ValueError):
        K10.subtree_root(torch.zeros((6, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K10.build_sharded_merkle(3, 16, "cpu")
    with pytest.raises(ValueError):
        K10.build_sharded_merkle(4, 12, "cpu")


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_sharded_merkle_root_over_gloo(n_ranks, tmp_path_factory):
    leaves = _leaves(n_ranks)
    want = _hashlib_root(leaves)
    assert K10.subtree_root(torch.from_numpy(leaves))[0].numpy().tobytes() == want  # unsharded
    roots = [root for root, _ in _gloo_results(n_ranks, tmp_path_factory)]
    assert roots == [want] * n_ranks


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_sharded_rlc_g1_over_gloo(n_ranks, tmp_path_factory):
    want = _host_rlc(*_rlc_inputs(n_ranks))
    sums = [aff for _, aff in _gloo_results(n_ranks, tmp_path_factory)]
    assert sums == [want] * n_ranks


def test_dryrun_multichip_on_cpu_ranks():
    dryrun_multichip(4, device="cpu", timeout=RANK_TIMEOUT_S)


def test_dryrun_multichip_on_cuda_without_a_card_raises_and_starts_no_rank(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py runs the cuda dry run")
    started = []
    monkeypatch.setattr(torch.multiprocessing, "start_processes", lambda *a, **k: started.append(a))
    set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun_multichip(1)
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun_multichip(2, device="cuda")
    finally:
        set_default_device("cpu")
    assert started == []


# The JAX side of the slow comparison: build_sharded_merkle(8, 16) and
# sharded_rlc_g1_fn on eight virtual CPU devices, as __graft_entry__.py
# provisions them, on inputs read from a JSON file.
_JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[2])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from lighthouse_tpu.crypto.bls12_381 import FQ, to_affine
from lighthouse_tpu.ops.bls381 import g1_points_from_device, g1_points_to_device, scalars_to_bits
from lighthouse_tpu.ops.bls381_sharded import build_sharded_bls
from lighthouse_tpu.ops.merkle_sharded import build_sharded_merkle
from lighthouse_tpu.ops.sha256 import bytes_to_words, words_to_bytes
inp = json.load(open(sys.argv[1]))
mesh, fn, sharding = build_sharded_merkle(8, inp["per_rank"])
leaves = jax.device_put(bytes_to_words(bytes.fromhex(inp["leaves"])), sharding)
root = words_to_bytes(fn(leaves)).hex()
mesh, fn, sharding = build_sharded_bls(8)
xs, ys, zs = (jax.device_put(c, sharding) for c in g1_points_to_device([tuple(p) for p in inp["points"]]))
bits = jax.device_put(np.asarray(scalars_to_bits(inp["scalars"], 64)), sharding)
got = to_affine(FQ, g1_points_from_device(fn(xs, ys, zs, bits))[0])
print(json.dumps({"root": root, "rlc": list(got)}))
"""


@pytest.mark.slow
def test_gloo_results_equal_the_jax_sharded_functions_at_8(tmp_path, tmp_path_factory):
    n = 8
    pts, scalars = _rlc_inputs(n)
    inp = tmp_path / "inputs.json"
    inp.write_text(json.dumps({
        "per_rank": LEAVES_PER_RANK,
        "leaves": _leaves(n).tobytes().hex(),
        "points": [list(p) for p in pts],
        "scalars": scalars,
    }))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(inp), str(ROOT)],
        capture_output=True, text=True, timeout=1800, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_out = json.loads(proc.stdout.strip().splitlines()[-1])
    port = _gloo_results(n, tmp_path_factory)
    assert [root.hex() for root, _ in port] == [jax_out["root"]] * n
    assert [list(aff) for _, aff in port] == [jax_out["rlc"]] * n
