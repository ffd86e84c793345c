"""K5's SSWU map compiled inline and out of line, on the card.

`map_to_curve_sswu_jac` (csrc/bls381_htc.cu) is inlined into the K5
kernel. This script builds variants of that source as stand-alone
executables: the map inlined, or `__noinline__` at nvcc's default
optimisation and with ptxas at -O0 and -O1, and with -G (no device
optimisation). Each runs the full kernel on `--messages` hashes and a
map-only kernel (a thread per map, no team) on their 2 * messages field
elements, and compares both with the plain PyTorch version
(ops/bls381_htc.py) on the CPU. The out-of-line build at the default
optimisation then runs under compute-sanitizer's memcheck, initcheck,
racecheck and synccheck. Lane 0's field elements are 0 (the tv2 = 0
exception).

    python3 -m lighthouse_tpu_torch.analysis.htc_outline_probe [--out DIR]

Sources, executables and the sanitizer logs go to DIR (default
lighthouse_tpu_torch/build/htc_probe). Prints one JSON object: per
variant the rows equal to the plain version, the kernel's time and
ptxas' usage line; per sanitizer tool its exit code and its ERROR
SUMMARY line. Needs nvcc and one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import bls381_htc as K5
from ..ops.bls381 import pack32, to16
from ..ops.cuda_build import CSRC, nvcc

_MAP = "DEV void map_to_curve_sswu_jac("

_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>

// a thread per field element: u [n, 2, 12] -> [n, 3, 2, 12]
__global__ void map_only_kernel(const long long* u, long long* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp2 uu;
  fp2_ld(uu, u + 24LL * i);
  jac<fp2> q;
  map_to_curve_sswu_jac(q, uu);
  fp2_st(out + 72LL * i, q.x);
  fp2_st(out + 72LL * i + 24, q.y);
  fp2_st(out + 72LL * i + 48, q.z);
}

static void ok(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(e));
    exit(2);
  }
}

// argv: u file ([m, 2, 2, 12] int64), output file (hashes, then maps)
int main(int argc, char** argv) {
  if (argc != 3) return 1;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  const long long m = ftell(f) / (48 * 8);
  fseek(f, 0, SEEK_SET);
  std::vector<long long> u(m * 48), out(m * 72 + 2 * m * 72);
  if (fread(u.data(), 8, u.size(), f) != u.size()) return 1;
  fclose(f);
  long long *du, *dh, *dq;
  ok(cudaMalloc(&du, u.size() * 8), "malloc");
  ok(cudaMalloc(&dh, m * 72 * 8), "malloc");
  ok(cudaMalloc(&dq, 2 * m * 72 * 8), "malloc");
  ok(cudaMemcpy(du, u.data(), u.size() * 8, cudaMemcpyHostToDevice), "copy in");
  ok((cudaError_t)bls_hash_to_g2(du, dh, m, 0), "hash launch");
  ok(cudaDeviceSynchronize(), "hash");
  map_only_kernel<<<(unsigned)((2 * m + 31) / 32), 32>>>(du, dq, (int)(2 * m));
  ok(cudaGetLastError(), "map launch");
  ok(cudaDeviceSynchronize(), "map");
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  bls_hash_to_g2(du, dh, m, 0);
  cudaEventRecord(b);
  ok(cudaEventSynchronize(b), "timed hash");
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  ok(cudaMemcpy(out.data(), dh, m * 72 * 8, cudaMemcpyDeviceToHost), "copy out");
  ok(cudaMemcpy(out.data() + m * 72, dq, 2 * m * 72 * 8, cudaMemcpyDeviceToHost), "copy out");
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 8, out.size(), f);
  fclose(f);
  printf("ms %.6f\n", ms);
  return 0;
}
"""

# name -> (map inlined, extra nvcc flags)
VARIANTS = {
    "inline": (True, []),
    "outline": (False, []),
    "outline_ptxas_O0": (False, ["-Xptxas", "-O0"]),
    "outline_ptxas_O1": (False, ["-Xptxas", "-O1"]),
    "outline_G": (False, ["-G"]),
}
SANITIZER_TOOLS = ("memcheck", "initcheck", "racecheck", "synccheck")


def _source(inline: bool) -> str:
    text = (CSRC / "bls381_htc.cu").read_text()
    if _MAP not in text:
        raise RuntimeError("map_to_curve_sswu_jac's definition not found")
    if not inline:
        text = text.replace(_MAP, "DEVNI void map_to_curve_sswu_jac(")
    return text + _MAIN


def _start_build(out: Path, name: str) -> subprocess.Popen:
    """Start nvcc on variant `name` (all variants build at once)."""
    inline, flags = VARIANTS[name]
    src = out / f"{name}.cu"
    src.write_text(_source(inline))
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
           *flags, "-I", str(CSRC), "-o", str(out / name), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _finish_build(proc: subprocess.Popen) -> dict:
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return {"rc": "timeout", "ptxas": [], "err": "nvcc took over 600 s"}
    usage = [ln.strip() for ln in err.splitlines() if "hash_to_g2_kernel" in ln or "Used" in ln]
    return {"rc": proc.returncode, "ptxas": usage[-3:], "err": err[-2000:] if proc.returncode else ""}


def _field_elements(messages: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = K5.messages_to_field([rng.bytes(32) for _ in range(messages)])
    u[0] = 0
    return np.ascontiguousarray(u)


def _sanitizer() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for p in (home / "bin" / "compute-sanitizer", home / "compute-sanitizer" / "compute-sanitizer"):
        if p.exists():
            return str(p)
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(CSRC.parent / "build" / "htc_probe"))
    ap.add_argument("--messages", type=int, default=32)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    u = _field_elements(args.messages, args.seed)
    u_file = out / "u.bin"
    u_file.write_bytes(u.tobytes())
    ut = torch.from_numpy(u)
    want_hash = K5.hash_to_g2_plain(ut).numpy()
    want_map = pack32(K5.map_to_curve_sswu16(to16(ut.reshape(-1, 2, 12))), 2).numpy()
    m = args.messages

    procs = {name: _start_build(out, name) for name in VARIANTS}
    builds = {name: _finish_build(proc) for name, proc in procs.items()}
    report: dict = {"variants": {}, "sanitizer": {}}
    for name, b in builds.items():
        row = {"build_rc": b["rc"], "ptxas": b["ptxas"]}
        if b["rc"] == 0:
            res = out / f"{name}.out"
            run = subprocess.run([str(out / name), str(u_file), str(res)], capture_output=True, text=True, timeout=300)
            row["run_rc"] = run.returncode
            if run.returncode == 0:
                got = np.fromfile(res, dtype=np.int64)
                h, q = got[: m * 72].reshape(want_hash.shape), got[m * 72 :].reshape(want_map.shape)
                row["hash_rows_equal"] = int((h == want_hash).reshape(m, -1).all(-1).sum())
                row["map_rows_equal"] = int((q == want_map).reshape(2 * m, -1).all(-1).sum())
                row["ms"] = float(re.search(r"ms (\S+)", run.stdout).group(1))
            else:
                row["stderr"] = run.stderr[-1000:]
        else:
            row["err"] = b["err"]
        report["variants"][name] = row
        print(name, json.dumps(row), flush=True)

    tool = _sanitizer()
    if not tool:
        report["sanitizer"] = "compute-sanitizer not found"
    elif builds["outline"]["rc"] == 0:
        for t in SANITIZER_TOOLS:
            res = out / f"outline.{t}.out"
            run = subprocess.run([tool, "--tool", t, str(out / "outline"), str(u_file), str(res)],
                                 capture_output=True, text=True, timeout=600)
            (out / f"sanitizer.{t}.txt").write_text(run.stdout + run.stderr)
            summary = [ln for ln in (run.stdout + run.stderr).splitlines() if "ERROR SUMMARY" in ln or "RACECHECK SUMMARY" in ln]
            row = {"rc": run.returncode, "summary": summary[-2:]}
            if run.returncode == 0 and res.exists():
                got = np.fromfile(res, dtype=np.int64)
                row["hash_rows_equal"] = int((got[: m * 72].reshape(want_hash.shape) == want_hash).reshape(m, -1).all(-1).sum())
            report["sanitizer"][t] = row
            print("sanitizer", t, json.dumps(row), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
