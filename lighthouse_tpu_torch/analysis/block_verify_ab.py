"""The BLS block verify of two checkouts on one card, in turns.

Starts worker processes from each checkout's root (``--procs`` a
checkout, default 2), all at once. Each builds chip_smoke.py's phase-4
state (the 1M-validator mainnet Deneb registry, `phase_main_path`) and
one mainnet block's 131 signature sets (`bls_block`, as phase 5 does),
verifies it once through the `cuda` backend to warm the pubkey caches,
and then waits. The workers then verify in rounds (``--rounds``, default
10), one verify each a round, signatures decompressed anew in each: the
order A1 B1 B2 A2 and reversed in the next round, so that a drift of the
card or the host weighs on both checkouts, and one process's own offset
shows beside the other's. Last, each worker runs one verify under
torch.profiler (chip_smoke._profile_block).

Prints one JSON object: the card's nvidia-smi line; per checkout the
median, first and third quartile of all its verifies' seconds; per round
the difference of the means (B - A) and its median and quartiles; the
pairs (Ai and Bi in one round) and how many B ran faster; per
worker its verifies, median and profiled kernel milliseconds with its
kernels by name (the 20 that take the most).

    python3 -m lighthouse_tpu_torch.analysis.block_verify_ab A_DIR B_DIR [--out DIR] [--seed N] [--rounds R] [--procs P]

A_DIR and B_DIR are checkouts of the repository (a `git archive` of each
commit, unpacked). Each worker's standard error goes to DIR (default
lighthouse_tpu_torch/build/block_verify_ab). Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from ..ops.cuda_build import BUILD_DIR

# A worker: set up, say "ready", then one verify a line of input ("verify"),
# and the profiled verify on "profile"; each answer one "AB {json}" line.
_WORKER = """
import json, random, sys, time
import torch
import chip_smoke as cs
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.types import MainnetEthSpec, build_types
from lighthouse_tpu_torch.types.chain_spec import mainnet_spec

_, state = cs.phase_main_path(cs.N_VALIDATORS, 1, {seed})
sets = cs.bls_block(state, build_types(MainnetEthSpec), MainnetEthSpec, mainnet_spec(), {seed})["sets"]
bls.set_backend("cuda")
if not bls.verify_signature_sets(sets, random.Random({seed})):
    raise AssertionError("the cuda backend rejected the valid block")


def fresh():
    bls._SIG_CACHE.clear()
    return [bls.SignatureSet(bls.Signature(s.signature.to_bytes()), s.pubkeys, s.message) for s in sets]


def say(obj):
    print("AB " + json.dumps(obj), flush=True)


say({{"ready": True}})
for rep, line in enumerate(sys.stdin):
    block = fresh()
    if line.strip() == "profile":
        say({{"profile": cs._profile_block(lambda: bls.verify_signature_sets(block, random.Random({seed})))}})
        break
    t0 = time.perf_counter()
    ok = bls.verify_signature_sets(block, random.Random({seed} + rep))
    torch.cuda.synchronize()
    say({{"verify_s": time.perf_counter() - t0, "ok": ok}})
cs.host_pool.reset_pool()
"""


class Worker:
    def __init__(self, name: str, checkout: Path, log: Path, seed: int):
        self.name = name
        self.err = log.open("w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER.format(seed=seed)],
            cwd=checkout,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self.err,
            text=True,
            bufsize=1,
        )

    def answer(self) -> dict:
        """The worker's next "AB" line (its other output skipped)."""
        for line in self.proc.stdout:
            if line.startswith("AB "):
                return json.loads(line[3:])
        raise RuntimeError(f"worker {self.name} exited {self.proc.wait()}; see its log")

    def ask(self, what: str) -> dict:
        self.proc.stdin.write(what + "\n")
        self.proc.stdin.flush()
        return self.answer()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.err.close()


def _spread(xs: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"n": len(xs), "median": q2, "q1": q1, "q3": q3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--out", type=Path, default=BUILD_DIR / "block_verify_ab")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--procs", type=int, default=2)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    names = [f"a{i + 1}" for i in range(args.procs)] + [f"b{i + 1}" for i in range(args.procs)]
    workers = {
        n: Worker(n, (args.a if n[0] == "a" else args.b).resolve(), args.out / f"{n}.err", args.seed) for n in names
    }
    try:
        for w in workers.values():
            if not w.answer().get("ready"):
                raise RuntimeError(f"worker {w.name} did not start")
        # A1 B1 B2 A2 ..., reversed every other round
        order = []
        for i in range(args.procs):
            pair = [f"a{i + 1}", f"b{i + 1}"]
            order += pair if i % 2 == 0 else pair[::-1]
        times: dict = {n: [] for n in names}
        diffs, wins = [], 0
        for r in range(args.rounds):
            got = {}
            for n in order if r % 2 == 0 else order[::-1]:
                ans = workers[n].ask("verify")
                if not ans["ok"]:
                    raise AssertionError(f"worker {n} rejected the valid block (round {r})")
                got[n] = ans["verify_s"]
                times[n].append(ans["verify_s"])
            mean = {c: statistics.mean(v for n, v in got.items() if n[0] == c) for c in "ab"}
            diffs.append(mean["b"] - mean["a"])
            wins += sum(got[f"b{i + 1}"] < got[f"a{i + 1}"] for i in range(args.procs))
        profiles = {n: w.ask("profile")["profile"] for n, w in workers.items()}
    finally:
        for w in workers.values():
            w.close()
    out = {
        "nvidia_smi": smi,
        "rounds": args.rounds,
        "order": order,
        "by_checkout": {
            c: {"dir": str(args.a if c == "a" else args.b)} | _spread([t for n in names if n[0] == c for t in times[n]])
            for c in "ab"
        },
        "b_minus_a_by_round_s": diffs,
        "b_minus_a_s": _spread(diffs),
        "pairs": args.rounds * args.procs,
        "pairs_b_faster": wins,
        "workers": {
            n: {
                "verify_s": times[n],
                "median_s": statistics.median(times[n]),
                "profiled_kernel_ms": profiles[n]["device_kernel_ms"],
                "profiled_kernels_ms": profiles[n]["kernels_ms"],
            }
            for n in names
        },
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
