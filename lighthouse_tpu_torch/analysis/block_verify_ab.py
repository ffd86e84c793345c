"""The BLS block verify of two checkouts on one card, in turns.

Runs chip_smoke.py's phases 4 and 5 from each checkout's root, each run in
a fresh process: the 1M-validator mainnet Deneb state with one update
(`phase_main_path`), then five verifies of one mainnet block's 131
signature sets through the `cuda` backend, signatures decompressed in
each, and one profiled verify (`phase_bls_main_path`). The runs go A, B,
B, A, so that a drift of the card or the host over the call weighs on
both. Prints one JSON object: the card's nvidia-smi line, per run its
checkout, median verify seconds, the five verifies, the profiled
verify's kernel milliseconds and its kernels by name (the 20 that take
the most), and per checkout the mean of its two medians.

    python3 -m lighthouse_tpu_torch.analysis.block_verify_ab A_DIR B_DIR [--out DIR] [--seed N]

A_DIR and B_DIR are checkouts of the repository (a `git archive` of each
commit, unpacked). Each run's output goes to DIR (default
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

_RUN = """
import chip_smoke as cs
from lighthouse_tpu_torch.types import MainnetEthSpec, build_types

_, state = cs.phase_main_path(cs.N_VALIDATORS, 1, {seed})
cs.phase_bls_main_path(state, build_types(MainnetEthSpec), MainnetEthSpec, {seed})
cs.host_pool.reset_pool()
"""


def run_once(checkout: Path, log: Path, seed: int) -> dict:
    """Phases 4 and 5 from `checkout`'s root; the phase-5 JSON line."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(seed=seed)], cwd=checkout, capture_output=True, text=True, timeout=1800
    )
    log.with_suffix(".txt").write_text(proc.stdout)
    log.with_suffix(".err").write_text(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}; see {log}.err")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{") and '"bls_main_path"' in line:
            return json.loads(line)
    raise RuntimeError(f"{checkout}: no bls_main_path line; see {log}.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--out", type=Path, default=BUILD_DIR / "block_verify_ab")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    runs = []
    for i, (name, checkout) in enumerate((("a", args.a), ("b", args.b), ("b", args.b), ("a", args.a))):
        line = run_once(checkout.resolve(), args.out / f"run{i + 1}_{name}", args.seed)
        runs.append(
            {
                "checkout": name,
                "dir": str(checkout),
                "verify_median_s": line["verify_median_s"],
                "verify_s": line["verify_s"],
                "profiled_kernel_ms": line["profile"]["device_kernel_ms"],
                "profiled_kernels_ms": line["profile"]["kernels_ms"],
            }
        )
    mean = {
        n: statistics.mean(r["verify_median_s"] for r in runs if r["checkout"] == n) for n in ("a", "b")
    }
    print(json.dumps({"nvidia_smi": smi, "runs": runs, "mean_of_medians_s": mean}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
