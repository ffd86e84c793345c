"""Build a CUDA source of ``../csrc`` as host C++ and run its kernels on the CPU.

The kernels' arithmetic is plain C++ outside ``#ifdef __CUDACC__``, but
their team code (``__syncwarp``, ``__shared__`` state, one block of threads
per point) is not. This module makes nvcc's dialect host C++20:

* a shim header, force-included before the source, defines ``__CUDACC__``'s
  qualifiers away (``__device__``, ``__global__``, ``__constant__``,
  ``__launch_bounds__``), ``__align__`` as GCC's ``aligned``,
  ``__forceinline__`` as ``inline``, ``__shared__`` as ``static`` (a
  launch runs its blocks one after another, so one copy serves every
  block), ``threadIdx``/``blockIdx`` as ``thread_local``
  ``dim3``s, ``__syncthreads`` as a ``std::barrier`` of the block's threads
  and ``__syncwarp`` as one of the warp's (32 threads, or the block's last
  ones) or, given a mask of fewer lanes, of those lanes (a team narrower
  than a warp), ``__shfl_down_sync`` as a slot a thread posted and read
  between two such warp barriers, ``__threadfence`` as a
  sequentially consistent fence and ``atomicAdd`` as GCC's
  ``__atomic_fetch_add`` (a launch's blocks run one after another, so the
  last to count itself in is the last block), ``__ffs`` as
  ``__builtin_ffs``, ``uint4``/``make_uint4``, ``__ldcg`` as a plain load,
  ``__funnelshift_r`` and ``__byte_perm`` as their definitions,
  ``cudaMemsetAsync`` as ``memset``, and stubs ``clock64``,
  ``cudaGetLastError`` and ``cudaDeviceSynchronize``; a stub
  ``cuda_runtime.h`` includes nothing;
* each launch ``kernel<T><<<grid, block, ...>>>(args);`` is rewritten to
  ``shim_launch(dim3(grid), dim3(block), [&] { kernel<T>(args); })``, which
  runs each block's threads as ``std::thread``s;
* ``g++ -std=c++20 -pthread -shared -fPIC -D__CUDACC__`` builds the result.

The launchers (``extern "C"``) then take host pointers: numpy buffers or
CPU tensors' ``data_ptr()``, and any value for the stream. What this
shows is that a kernel's code computes its plain version's values, with
the team's branches and barriers as the card runs them; it says nothing
of the card's speed. A data race shows only where the host threads'
timing exposes it: a lane that reads a case late and takes another
branch leaves its warp's barrier short, and the launch hangs (`call`
bounds the wait).

    python3 -m lighthouse_tpu_torch.analysis.host_shim SOURCE OUT_DIR [--opt=-O2]

builds ``csrc/SOURCE`` into ``OUT_DIR/<stem>.so`` and prints its path.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import threading
from pathlib import Path

from ..ops.cuda_build import CSRC

SHIM_H = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline int cudaGetLastError() { return 0; }
static inline int cudaDeviceSynchronize() { return 0; }
static inline int cudaMemsetAsync(void* p, int v, unsigned long long n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
static inline long long clock64() { return 0; }
static inline int __ffs(int x) { return __builtin_ffs(x); }

struct uint4 {
  unsigned x, y, z, w;
};
static inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return uint4{a, b, c, d}; }
static inline uint4 __ldcg(const uint4* p) { return *p; }
static inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
// byte i of the result: byte (s >> 4i) & 7 of the 8 bytes y:x
static inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; i++) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
// a launch runs its blocks one after another: a fence and an atomic order
// the host threads of one block
static inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
static inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
static inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

#define __device__
#define __global__
#define __host__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

// a block's barriers: all its threads, each warp's, and one for each
// (warp, lane mask) that a __syncwarp(mask) names, made at its first use
struct shim_block {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::mutex mu;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<std::barrier<>>> masked;
  unsigned n;
  std::vector<unsigned long long> xchg;  // a __shfl_*_sync's values, a slot a thread
  explicit shim_block(unsigned threads) : all((std::ptrdiff_t)threads), n(threads), xchg(threads) {
    for (unsigned w = 0; w < n; w += 32)
      warps.push_back(std::make_unique<std::barrier<>>((std::ptrdiff_t)(n - w < 32 ? n - w : 32)));
  }
};
inline thread_local shim_block* shim_this_block;
inline thread_local unsigned shim_tid;

static inline void __syncthreads() { shim_this_block->all.arrive_and_wait(); }
static inline void __syncwarp(unsigned mask = 0xffffffffu) {
  const unsigned w = shim_tid / 32, lanes = shim_this_block->n - 32 * w;
  const unsigned live = lanes >= 32 ? 0xffffffffu : (1u << lanes) - 1;
  if ((mask & live) == live) {
    shim_this_block->warps[w]->arrive_and_wait();
    return;
  }
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(shim_this_block->mu);
    auto& slot = shim_this_block->masked[{w, mask}];
    if (!slot) slot = std::make_unique<std::barrier<>>((std::ptrdiff_t)__builtin_popcount(mask & live));
    b = slot.get();
  }
  b->arrive_and_wait();
}

// each lane of `mask` posts v, then reads lane + delta's (its own where
// that lies past its segment of `width` lanes)
template <class T>
static inline T __shfl_down_sync(unsigned mask, T v, unsigned delta, int width = 32) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 64 bits");
  const int lane = shim_tid % 32;
  unsigned long long raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  shim_this_block->xchg[shim_tid] = raw;
  __syncwarp(mask);
  if (lane % width + (int)delta < width) raw = shim_this_block->xchg[shim_tid + delta];
  __syncwarp(mask);
  T r;
  std::memcpy(&r, &raw, sizeof(T));
  return r;
}

// the grid's blocks one after another, each block's threads side by side
template <class F>
void shim_launch(dim3 grid, dim3 block, F&& body) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; bz++)
    for (unsigned by = 0; by < grid.y; by++)
      for (unsigned bx = 0; bx < grid.x; bx++) {
        shim_block blk(n);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; t++)
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            shim_this_block = &blk;
            shim_tid = t;
            body();
          });
        for (auto& th : threads) th.join();
      }
}
"""

_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _top_level_split(text: str) -> list[str]:
    """Split at the commas outside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


def rewrite_launches(src: str) -> str:
    """Each `kernel<<<grid, block, ...>>>(args);` -> a shim_launch call."""

    def sub(m: re.Match) -> str:
        grid, block = _top_level_split(m.group(2))[:2]
        return f"shim_launch(dim3({grid}), dim3({block}), [&] {{ {m.group(1)}({m.group(3)}); }});"

    return _LAUNCH.sub(sub, src)


def gxx() -> str | None:
    """The host C++ compiler, or None where there is none."""
    return shutil.which("g++")


def build(source: str, out_dir: Path, opt: str = "-O1") -> Path:
    """csrc/`source` as host C++ -> out_dir/<stem>.so (raises on a failed
    build). The rewritten source lives beside the headers it includes
    through a -I of csrc/."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = CSRC / source
    (out_dir / "shim.h").write_text(SHIM_H)
    (out_dir / "cuda_runtime.h").write_text("#pragma once\n")
    rewritten = out_dir / f"{src.stem}.shim.cpp"
    rewritten.write_text(rewrite_launches(src.read_text()))
    so = out_dir / f"{src.stem}.so"
    cmd = [
        gxx() or "g++", "-std=c++20", opt, "-pthread", "-shared", "-fPIC", "-w", "-D__CUDACC__",
        "-I", str(out_dir), "-I", str(CSRC), "-include", str(out_dir / "shim.h"),
        "-o", str(so), str(rewritten),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {source} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return so


def load(so: Path, functions: dict[str, tuple[str, ...]]) -> ctypes.CDLL:
    """The built library with its launchers' signatures: `functions` as
    a `CudaLibrary`'s (ops/cuda_build.py), argument kinds "p", "i64" and
    "i32"; every launcher returns an int."""
    kinds = {"p": ctypes.c_void_p, "i64": ctypes.c_longlong, "i32": ctypes.c_int}
    lib = ctypes.CDLL(str(so))
    for fn, args in functions.items():
        getattr(lib, fn).argtypes = [kinds[a] for a in args]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def call(fn, *args, timeout: float = 120.0) -> int:
    """fn(*args) (a launcher of `load`) on a daemon thread; raises
    TimeoutError if it has not returned within `timeout` seconds (a hung
    barrier: its threads are left behind)."""
    box: list = []
    th = threading.Thread(target=lambda: box.append(fn(*args)), daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        raise TimeoutError(f"{fn.__name__} did not return in {timeout} s: a lane left its barrier short")
    return box[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="a file of csrc/, e.g. bls381_g.cu")
    ap.add_argument("out", type=Path)
    ap.add_argument("--opt", default="-O1", help="g++ optimisation, e.g. --opt=-O2")
    args = ap.parse_args(argv)
    print(build(args.source, args.out, args.opt))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
