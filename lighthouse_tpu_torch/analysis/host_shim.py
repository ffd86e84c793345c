"""Build a CUDA source of ``../csrc`` as host C++ and run its kernels on the CPU.

The kernels' arithmetic is plain C++ outside ``#ifdef __CUDACC__``, but
their team code (``__syncwarp``, ``__shared__`` state, one block of threads
per point) is not. This module makes nvcc's dialect host C++20:

* a shim header, force-included before the source, defines ``__CUDACC__``'s
  qualifiers away (``__device__``, ``__global__``, ``__constant__``,
  ``__launch_bounds__``), ``__align__`` as GCC's ``aligned``,
  ``__forceinline__`` as ``inline``, ``threadIdx``/``blockIdx`` as
  ``thread_local`` ``dim3``s, ``__syncthreads`` as a ``std::barrier`` of
  the block's threads and ``__syncwarp`` as one of the warp's (32 threads,
  or the block's last ones) or, given a mask of fewer lanes, of those
  lanes (a team narrower than a warp), ``__shfl_down_sync`` as a slot a
  thread posted and read between two such warp barriers, ``__threadfence``
  as a sequentially consistent fence and ``atomicAdd`` as GCC's
  ``__atomic_fetch_add``, ``__ffs``/``__clzll`` as GCC's builtins,
  ``__umul64hi`` through ``unsigned __int128``, ``uint4``/``make_uint4``,
  ``__ldcg``/``__ldcs``/``__stcs`` as plain loads and stores,
  ``__funnelshift_r`` and ``__byte_perm`` as their definitions,
  ``cudaMemsetAsync`` as ``memset``, and stubs ``clock64``,
  ``cudaGetLastError``, ``cudaDeviceSynchronize`` and ``cudaFuncSetAttribute``;
  a stub ``cuda_runtime.h`` includes nothing, and a stub
  ``cooperative_groups.h`` has ``this_grid().sync()``;
* each ``__shared__`` declaration becomes a reference to storage the shim
  keeps: one copy a declaration for an ordinary launch, whose blocks run
  one after another (as a ``static`` would be), and one a block for a
  cooperative launch, whose blocks run side by side; ``extern __shared__``
  (dynamic shared memory) is a block's own buffer of the launch's size;
* each launch ``kernel<T><<<grid, block, ...>>>(args);`` is rewritten to
  ``shim_launch(dim3(grid), dim3(block), [&] { kernel<T>(args); })``, which
  runs the blocks one after another, each block's threads as
  ``std::thread``s; a ``cudaLaunchKernelEx`` whose attributes ask for a
  cooperative launch runs every thread of the grid at once, and its grid
  barrier is one ``std::barrier`` of them all;
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
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <typeindex>
#include <utility>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
static inline int cudaGetLastError() { return 0; }
static inline int cudaDeviceSynchronize() { return 0; }
// the device's limits and a kernel's occupancy mean nothing here: the
// queries say so, and launchers take their shapes from the caller
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerMultiprocessor = 81, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};
template <class K>
static inline int cudaFuncSetAttribute(K*, cudaFuncAttribute, int) { return 0; }
template <class K>
static inline int cudaFuncGetAttributes(cudaFuncAttributes*, K*) { return cudaErrorNotSupported; }
template <class K>
static inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int, size_t) { return cudaErrorNotSupported; }
static inline int cudaGetDevice(int* device) {
  *device = 0;
  return 0;
}
static inline int cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) { return cudaErrorNotSupported; }
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
template <class T>
static inline T __ldcg(const T* p) { return *p; }
template <class T>
static inline T __ldcs(const T* p) { return *p; }
template <class T>
static inline void __stcs(T* p, T v) { *p = v; }
static inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
static inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
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
#define __shared__ static  // a declaration the rewrite did not reach

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

// shared memory: a __shared__ declaration's storage, zeroed at its first
// use (as a static's), keyed by the declaration and its type
struct shim_chunk {
  alignas(64) unsigned char b[64];
};
typedef std::map<std::pair<int, std::type_index>, std::vector<shim_chunk>> shim_shared_map;

// a block's barriers: all its threads, each warp's, and one for each
// (warp, lane mask) that a __syncwarp(mask) names, made at its first use
struct shim_block {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::mutex mu;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<std::barrier<>>> masked;
  unsigned n;
  std::vector<unsigned long long> xchg;  // a __shfl_*_sync's values, a slot a thread
  shim_shared_map shared;                // its __shared__ storage (cooperative launches)
  std::vector<shim_chunk> dynamic;       // its extern __shared__ buffer
  shim_block(unsigned threads, size_t dynamic_bytes)
      : all((std::ptrdiff_t)threads), n(threads), xchg(threads), dynamic((dynamic_bytes + 63) / 64) {
    for (unsigned w = 0; w < n; w += 32)
      warps.push_back(std::make_unique<std::barrier<>>((std::ptrdiff_t)(n - w < 32 ? n - w : 32)));
  }
};
inline thread_local shim_block* shim_this_block;
inline thread_local unsigned shim_tid;

// a cooperative launch is running: its blocks side by side, each with its
// own shared memory, and one barrier for the grid
inline bool shim_cooperative = false;
inline std::barrier<>* shim_grid_barrier = nullptr;
inline std::mutex shim_shared_mu;
inline shim_shared_map shim_static_shared;  // one copy a declaration: blocks one after another

template <class T>
static inline T& shim_shared(int id) {
  static_assert(std::is_trivially_default_constructible_v<std::remove_all_extents_t<T>>,
                "shared memory of a type with a constructor");
  std::lock_guard<std::mutex> g(shim_cooperative ? shim_this_block->mu : shim_shared_mu);
  shim_shared_map& m = shim_cooperative ? shim_this_block->shared : shim_static_shared;
  std::vector<shim_chunk>& slot = m[{id, std::type_index(typeid(T))}];
  if (slot.empty()) slot.resize((sizeof(T) + 63) / 64);
  return *reinterpret_cast<T*>(slot.data());
}
static inline unsigned char* shim_dynamic_shared() {
  return reinterpret_cast<unsigned char*>(shim_this_block->dynamic.data());
}
static inline void shim_grid_sync() {
  if (!shim_grid_barrier) {
    std::fprintf(stderr, "host shim: a grid barrier outside a cooperative launch\n");
    std::abort();
  }
  shim_grid_barrier->arrive_and_wait();
}

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

static inline dim3 shim_index(unsigned i, dim3 shape) {
  return dim3(i % shape.x, (i / shape.x) % shape.y, i / (shape.x * shape.y));
}

// the grid's blocks one after another, each block's threads side by side
template <class F>
void shim_launch(dim3 grid, dim3 block, F&& body, size_t dynamic_bytes = 0) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x * block.y * block.z;
  for (unsigned b = 0; b < grid.x * grid.y * grid.z; b++) {
    shim_block blk(n, dynamic_bytes);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n; t++)
      threads.emplace_back([&, t] {
        blockIdx = shim_index(b, grid);
        threadIdx = shim_index(t, block);
        shim_this_block = &blk;
        shim_tid = t;
        body();
      });
    for (auto& th : threads) th.join();
  }
}

// every thread of the grid side by side, each block with its own shared
// memory, and one barrier of them all for the grid's
template <class F>
void shim_launch_cooperative(dim3 grid, dim3 block, F&& body, size_t dynamic_bytes) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x * block.y * block.z, blocks = grid.x * grid.y * grid.z;
  std::vector<std::unique_ptr<shim_block>> blk;
  for (unsigned b = 0; b < blocks; b++) blk.push_back(std::make_unique<shim_block>(n, dynamic_bytes));
  std::barrier<> all_grid((std::ptrdiff_t)(blocks * n));
  shim_grid_barrier = &all_grid;
  shim_cooperative = true;
  std::vector<std::thread> threads;
  for (unsigned b = 0; b < blocks; b++)
    for (unsigned t = 0; t < n; t++)
      threads.emplace_back([&, b, t] {
        blockIdx = shim_index(b, grid);
        threadIdx = shim_index(t, block);
        shim_this_block = blk[b].get();
        shim_tid = t;
        body();
      });
  for (auto& th : threads) th.join();
  shim_cooperative = false;
  shim_grid_barrier = nullptr;
}

enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2 };
union cudaLaunchAttributeValue {
  int cooperative;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(E...), A&&... args) {
  bool cooperative = false;
  for (unsigned i = 0; i < cfg->numAttrs; i++)
    cooperative |= cfg->attrs[i].id == cudaLaunchAttributeCooperative && cfg->attrs[i].val.cooperative;
  auto body = [&] { kernel(args...); };
  if (cooperative)
    shim_launch_cooperative(cfg->gridDim, cfg->blockDim, body, cfg->dynamicSmemBytes);
  else
    shim_launch(cfg->gridDim, cfg->blockDim, body, cfg->dynamicSmemBytes);
  return 0;
}
"""

COOPERATIVE_GROUPS_H = r"""
#pragma once
namespace cooperative_groups {
struct grid_group {
  void sync() const { shim_grid_sync(); }
};
inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
"""

_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", re.S)
# a line's `[extern] __shared__ [__align__(n)] TYPE declarators;`
_SHARED = re.compile(r"^([ \t]*)(extern[ \t]+)?__shared__[ \t]+(?:__align__\(\d+\)[ \t]+)?([^;]+);", re.M)
_DECLARATOR = re.compile(r"^(.*?)\s*\b(\w+)\s*((?:\[[^\]]*\])*)$", re.S)


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
        cfg = _top_level_split(m.group(2))
        shared = f", {cfg[2]}" if len(cfg) > 2 else ""
        return f"shim_launch(dim3({cfg[0]}), dim3({cfg[1]}), [&] {{ {m.group(1)}({m.group(3)}); }}{shared});"

    return _LAUNCH.sub(sub, src)


def rewrite_shared(src: str) -> str:
    """Each `__shared__ T a[..], b;` -> references to the shim's storage
    (`auto& a = shim_shared<T[..]>(id);`, an id a declarator), and
    `extern __shared__ T a[];` -> a pointer to the block's dynamic buffer."""
    ids = iter(range(1 << 30))

    def sub(m: re.Match) -> str:
        indent, extern, body = m.group(1), m.group(2), m.group(3)
        parts = _top_level_split(body)
        first = _DECLARATOR.match(parts[0])
        if first is None:
            raise ValueError(f"host shim: cannot read the shared declaration {m.group(0)!r}")
        type_ = first.group(1).strip()
        decls = [(first.group(2), first.group(3))]
        for part in parts[1:]:
            d = _DECLARATOR.match(part)
            if d is None or d.group(1).strip():
                raise ValueError(f"host shim: cannot read the shared declaration {m.group(0)!r}")
            decls.append((d.group(2), d.group(3)))
        if extern:
            (name, _), = decls
            return f"{indent}{type_}* {name} = reinterpret_cast<{type_}*>(shim_dynamic_shared());"
        return indent + " ".join(f"auto& {name} = shim_shared<{type_}{dims}>({next(ids)});" for name, dims in decls)

    return _SHARED.sub(sub, src)


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
    (out_dir / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_H)
    rewritten = out_dir / f"{src.stem}.shim.cpp"
    rewritten.write_text(rewrite_launches(rewrite_shared(src.read_text())))
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
