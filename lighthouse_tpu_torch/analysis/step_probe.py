"""What the steps of the warp-team and batch-inversion kernels cost, on the card.

Times, with `clock64` on one warp of one block, the steps that K2's G2
ladder, K4's subgroup check, K5's team rounds (csrc/g2_team.cuh), K2's G1
ladder (csrc/g1_team.cuh), K8's quotient (csrc/kzg_fr.cu) and K2's
conversions to affine (csrc/bls381_g.cu) are made of: an Fq product (out
of line, `fq_mul1`, and inlined, `fq_mulx`: `mont_mul_cs<12>`), an Fq
addition (`fp_add`), a `__syncwarp`, a team round of three Fq2 products
on plain operands, a G2 team doubling, a general and a mixed G2 team
addition, an Fr product (`fr_mulx`), one Fr binary inversion
(`mont_inv_binary<8>`, on one thread, as the kernels run it), a G1 team
doubling and addition, two independent inlined Fq products side by side
(a level of the conversions' prefix and suffix scan) with one product
alone in the same kernel, and one Fq binary inversion (`fp_inv_binary`,
on one thread, as the conversions and K4's final exponentiation run it).
Each is the mean over a loop of dependent repetitions, in SM clock
cycles, read from lane 0. The first twelve share one kernel, unchanged
as steps are added, so that their readings stay comparable from one
version to the next; each step added after them is a kernel of its own,
which changes no other step's code.

    python3 -m lighthouse_tpu_torch.analysis.step_probe [--out DIR]

Builds its probe from the repository's headers with nvcc into DIR
(default lighthouse_tpu_torch/build/step_probe) and prints one JSON
object: the card's nvidia-smi line and the cycles of each step over two
runs. Needs nvcc and one card.

    python3 -m lighthouse_tpu_torch.analysis.step_probe --segment-levels [--n 32]

Times instead what a level of K2's segment sums costs: the launchers
``bls_g1_segment_sum`` and ``bls_g2_segment_sum`` (csrc/bls381_g.cu) at
[n, k] for each power of two k up to one block's span (G1 128 points, G2
8), where one launch sums each row, so going from k to 2k adds one tree
level: for G1 a team level up to k = 64, and from 64 to 128 the first
level on threads (seg_add_first); for G2 a team level. Rows are affine
(Z = 1, as the verifier stages pubkeys) or Jacobian (Z != 1), from
chip_smoke.bls_segment_rows, one seeded row repeated n times. Then the
main path's shapes, which take two passes: G1 [32, 512] with a repeated
first pair in each row (phase 3's rows) and with none (phase 5's
committees), [3, 512], [1, 4096] (K11), G2 [1, 32]. The launches queue
behind a `torch.cuda._sleep`, so CUDA events time the card's work and
not the host's launch rate: each reading is the median over 5 windows of
20 launcher calls, in ms a call. Run from the repository root (it
imports chip_smoke); prints the card's nvidia-smi line and the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import bls381 as K2
from ..ops import fr as K8
from ..ops.cuda_build import BUILD_DIR, CSRC, nvcc

STEPS = (
    "fq_mul1", "fq_mulx", "fp_add", "syncwarp", "team_round3", "team_dbl", "team_add", "team_madd", "fr_mulx",
    "fr_inv_binary", "g1_team_dbl", "g1_team_add", "fq_mulx_pair", "fq_inv_binary", "fq_mulx_alone",
)

_SOURCE = r"""
#include "g1_team.cuh"
#include "kzg_fr.cu"

#define REPS 64
#define TIME(slot, reps, body)                         \
  {                                                    \
    const long long t0 = clock64();                    \
    for (int it = 0; it < reps; it++) { body; }        \
    const long long t1 = clock64();                    \
    if (lane == 0) clk[slot] = (t1 - t0) / (reps);     \
  }

// pts [2, 3, 2, 12]: a Jacobian and an affine G2 point; g1 [2, 3, 12]: two
// Jacobian G1 points; frv [16, 8] Fr Montgomery limbs; clk [12] cycles;
// sink keeps the results live
__global__ void __launch_bounds__(32)
step_probe_kernel(const long long* pts, const long long* g1, const uint32_t* frv, long long* sink, long long* clk) {
  __shared__ fp opa[32], opb[32], prod[32];
  __shared__ fp2 slots[G2_SLOTS];
  __shared__ jac<fp2> pt[3];
  __shared__ fp slots1[G1_SLOTS];
  __shared__ jac<fp> pt1[3];
  const int lane = threadIdx.x;
  const G2Team tm{lane, opa, opb, prod, slots};
  const G1Team tm1{lane, slots1};
  if (lane < 6) fp2_ld(lane % 3 == 0 ? pt[lane / 3].x : lane % 3 == 1 ? pt[lane / 3].y : pt[lane / 3].z,
                       pts + lane * 24);
  if (lane >= 6 && lane < 12) {
    jac<fp>& q = pt1[(lane - 6) / 3];
    fp_ld(lane % 3 == 0 ? q.x : lane % 3 == 1 ? q.y : q.z, g1 + (lane - 6) * 12);
  }
  tm.sync();
  fp a = pt[0].x.c0, b = pt[0].y.c0, c = pt[0].x.c1;
  TIME(0, REPS, fq_mul1(a, a, b));
  TIME(1, REPS, fq_mulx(a, a, b));
  TIME(2, REPS, fp_add(c, c, b));
  TIME(3, REPS, tm.sync());
  TIME(4, REPS, team_round(tm, 3, 0, [&](int q, int i, int j, fp& x, fp& y) {
         x = cpt(pt[0].x, i);
         y = cpt(pt[0].y, j);
       }));
  TIME(5, REPS, team_dbl(tm, pt[2], pt[0], false));
  TIME(6, REPS, team_add(tm, pt[2], pt[0], pt[1], false));
  TIME(7, REPS, team_madd(tm, pt[2], pt[0], pt[1]));
  fr x, y, r3;
  fr_set(x, frv + 8 * (lane % 16));
  fr_set(y, frv + 8 * ((lane + 1) % 16));
  fr_set(r3, FR_R3);
  TIME(8, REPS, fr_mulx(x, x, y));
  fr inv = x;
  // the inversion as the kernels run it: one thread of the warp
  TIME(9, 16, if (lane == 0) {
    fr_set(inv, frv + 8 * it);
    mont_inv_binary<8>(inv.v, inv.v, FR_MOD, FR_NINV, r3.v);
  });
  TIME(10, REPS, team_dbl(tm1, pt1[2], pt1[0]));
  TIME(11, REPS, team_add(tm1, pt1[2], pt1[0], pt1[1]));
  if (lane == 0) sink[0] = (long long)a.v[0] + c.v[0] + x.v[0] + inv.v[0] + pt[2].x.c0.v[0] + pt1[2].x.v[0];
}

// The steps added later, each a kernel of its own, so that they change no
// reading of the kernel above (the earlier versions' yardstick)
// a level of the conversions' scan: two independent products, and one
// product alone in the same kernel beside it
__global__ void __launch_bounds__(32)
step_scan_kernel(const long long* pts, long long* sink, long long* clk) {
  const int lane = threadIdx.x;
  fp a, b, e, g;
  fp_ld(a, pts);
  fp_ld(b, pts + 24);
  fp_ld(e, pts + 36);
  fp_ld(g, pts + 72);
  TIME(14, REPS, fq_mulx(e, e, b));
  TIME(12, REPS, {
    fq_mulx(a, a, b);
    fq_mulx(e, e, g);
  });
  if (lane == 0) sink[1] = (long long)a.v[0] + e.v[0];
}

// the Fq inversion on one thread: the ten nonzero coordinates of pts (the
// affine point's Z is 1 + 0u)
__global__ void __launch_bounds__(32)
step_fq_inv_kernel(const long long* pts, long long* sink, long long* clk) {
  const int lane = threadIdx.x;
  uint32_t acc = 0;
  TIME(13, 10, if (lane == 0) {
    fp f;
    fp_ld(f, pts + 12 * it);
    fp_inv_binary(f, f);
    acc ^= f.v[0];
  });
  if (lane == 0) sink[2] = acc;
}

extern "C" int step_probe(const long long* pts, const long long* g1, const uint32_t* frv, long long* sink,
                          long long* clk) {
  step_probe_kernel<<<1, 32>>>(pts, g1, frv, sink, clk);
  step_scan_kernel<<<1, 32>>>(pts, sink, clk);
  step_fq_inv_kernel<<<1, 32>>>(pts, sink, clk);
  return (int)cudaGetLastError();
}
"""


def build(out: Path) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "step_probe.cu", out / "step_probe.so"
    src.write_text(_SOURCE)
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(so), str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return so


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def time_segment_sum(group: str, pts: torch.Tensor, windows: int = 5, reps: int = 20) -> float:
    """Median card ms of one launcher call (all its passes) of the segment
    sum over `pts`; the output is held to the plain version."""
    n, k = pts.shape[:2]
    lib = K2.LIB.load()
    out = torch.empty((n, *pts.shape[2:]), dtype=torch.int64, device=pts.device)
    _, scratch = K2.segment_sum_plan(lib, group, n, k)
    buf = torch.empty((scratch, *pts.shape[2:]), dtype=torch.int64, device=pts.device)
    args = (pts.data_ptr(), buf.data_ptr(), out.data_ptr(), n, k)
    fn = f"bls_{group}_segment_sum"
    K2.LIB.launch(fn, *args, device=pts.device)
    torch.cuda.synchronize()
    ms = []
    for _ in range(windows):
        torch.cuda._sleep(10_000_000)  # ~5 ms: the host queues the window meanwhile
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            K2.LIB.launch(fn, *args, device=pts.device)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / reps)
    if not torch.equal(out, K2.segment_sum_plain(group, pts)):
        raise AssertionError(f"{fn} at {list(pts.shape[:2])} differs from its plain version")
    return statistics.median(ms)


def segment_levels(n: int) -> dict:
    """The segment sums' times by k up to a block's span, a level each,
    and at the main path's shapes (the module's docstring)."""
    from chip_smoke import bls_segment_rows

    span = {"g1": 128, "g2": 8}  # SEG_G1_SPAN, SEG_G2_SPAN
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    out: dict = {"nvidia_smi": _smi(), "n": n, "by_k": {}, "main_path": {}}
    for group, kind in (("g1", "affine"), ("g1", "jacobian"), ("g2", "jacobian")):
        row = bls_segment_rows(rng, group, kind, 1, span[group])
        ms = {}
        k = 1
        while k <= span[group]:
            pts = torch.from_numpy(np.ascontiguousarray(np.repeat(row[:, :k], n, 0))).to(dev)
            ms[k] = time_segment_sum(group, pts)
            k *= 2
        out["by_k"][f"{group}_{kind}"] = {
            "ms": ms,
            "level_ms": {f"{k // 2}->{k}": ms[k] - ms[k // 2] for k in list(ms)[1:]},
        }
    for group, kind, rows, k in (("g1", "affine", 32, 512), ("g1", "distinct", 32, 512), ("g1", "affine", 3, 512),
                                 ("g1", "jacobian", 1, 4096), ("g2", "jacobian", 1, 32)):
        pts = torch.from_numpy(bls_segment_rows(rng, group, kind, rows, k)).to(dev)
        out["main_path"][f"{group}_{kind}[{rows},{k}]"] = time_segment_sum(group, pts)
    return out


def main(argv=None) -> int:
    from ..crypto.bls12_381 import FQ, FQ2, G1_GEN, G2_GEN, R, pt_add, pt_mul, to_affine

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=BUILD_DIR / "step_probe")
    ap.add_argument("--segment-levels", action="store_true", help="time the segment sums' levels instead")
    ap.add_argument("--n", type=int, default=32, help="--segment-levels: rows a launch (the verifier's chunk: 32)")
    args = ap.parse_args(argv)
    if args.segment_levels:
        print(json.dumps(segment_levels(args.n)), flush=True)
        return 0
    lib = ctypes.CDLL(str(build(args.out)))
    lib.step_probe.argtypes = [ctypes.c_void_p] * 5
    rng = np.random.default_rng(1)
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(18)]
    jac_pt = pt_add(FQ2, pt_mul(FQ2, G2_GEN, ks[0]), G2_GEN)  # Z != 1
    pts = torch.from_numpy(K2.g2_to_limbs([jac_pt, (*to_affine(FQ2, pt_mul(FQ2, G2_GEN, ks[1])), FQ2.one)])).cuda()
    frv = K8.as_i32(K8.mont_limbs(ks[2:])).cuda()
    g1 = torch.from_numpy(K2.g1_to_limbs([pt_add(FQ, pt_mul(FQ, G1_GEN, k), G1_GEN) for k in ks[:2]])).cuda()
    smi = _smi()
    sink = torch.zeros(3, dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(2):
        clk = torch.zeros(len(STEPS), dtype=torch.int64, device="cuda")
        if lib.step_probe(pts.data_ptr(), g1.data_ptr(), frv.data_ptr(), sink.data_ptr(), clk.data_ptr()):
            raise RuntimeError("step_probe launch failed")
        torch.cuda.synchronize()
        runs.append(dict(zip(STEPS, clk.tolist())))
    print(json.dumps({"nvidia_smi": smi, "cycles": runs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
