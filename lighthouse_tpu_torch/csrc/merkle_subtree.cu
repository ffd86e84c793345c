// Merkle subtree roots for Hopper (sm_90a): the per-device step of the
// sharded Merkle root (K10). One launch reduces every run of 2^L sibling
// nodes (L <= 26 with the wrapper's plan) to the root of their subtree.
//
// Replaces lighthouse_tpu/ops/merkle_sharded.py:24-39 (`_sha256_pairs_inline`
// and `_reduce_to_root`, the local subtree and the replicated top fold of
// `sharded_merkle_root_fn` :42); the all-gather between them is NCCL's
// (lighthouse_tpu_torch/ops/merkle_sharded.py).
//
// Bound: the 32-bit integer instruction rate, as K1's (csrc/sha256.cu). The root of M
// leaves needs M - 1 two-to-one hashes of 64-byte messages, each at least
// 2,300 operations (sha256.cu's header); it reads M * 32 bytes and writes
// 32. At M = 2^20 that is 2.4e9 operations against 32 MiB: about 72
// operations per byte, operations-bound (chip_smoke.py: SHA256_MIN_OPS).
//
// Design. A hash's instructions (~2,400, nearly all 32-bit integer: shifts,
// 3-input logic, adds) issue a warp instruction every two cycles on an
// SM's integer lanes whether 32 lanes or 1 are live, so the time is the
// warp instructions issued (lanes idle in a level of few parents cost as
// much as busy ones) plus the levels whose parents are too few to fill
// the card, each about one hash's latency:
//   * A thread hashes a subtree of 2^l nodes (l = leaf_levels <= 4) from
//     registers, a pair at a time, merging as a binary counter: at 2^20
//     leaves 16 leaves a thread, 15 hashes, every lane busy; this is most
//     of the work and runs at the card's integer rate.
//   * A block's thread roots meet in levels of pairs from shared memory
//     onto its first count / 2 threads (whole warps: no idle lane while a
//     level has 32 parents or more), then five levels on warp 0 by
//     __shfl_down_sync: one of 512 threads a block wastes 5 warp hashes
//     of its 8,191.
//   * The run's blocks each store their root and count themselves in with
//     an atomicAdd after __threadfence(); the last one to finish reads the
//     blocks' roots back (through L2) and reduces them with the same two
//     steps, each thread first hashing 2^l' of them alone where there are
//     more roots than threads. The top of the tree thus needs no launch of
//     its own (the counts are zeroed by a memset on the stream before it).
// The plan (l, threads a block) is the caller's: ops/merkle_sharded.py
// takes l = clamp(L - 16, 1, 4) and up to 512 threads, so a run keeps
// ~2^16 threads at work: 2^20 leaves are 128 blocks of 512, one an SM
// (128 registers a thread, 92 bytes spilled). Levels above a thread's
// leaves cannot fill the card, so 20 - l of them are latency, ~3 us each.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, the card's
// time alone) it took 0.194 ms at 2^20 leaves, against 0.256 for the
// kernel it replaced in its three launches (0.215 + 0.030 + 0.011); 256
// threads a block 0.214 (two blocks an SM climb side by side), 8 or 4
// leaves a thread 0.217 and 0.269. A first version, two messages hashed
// side by side in a thread and every level of a warp on shuffles (256
// threads a block), took 0.243: its idle lanes cost a quarter of its warp
// instructions. The tests give other plans to reach every path at small
// L. The compression is csrc/sha256.cuh,
// K1's own; the hash sits at three call sites (the thread's, the shared
// levels', the warp's), each run by every level that needs it.
//
// merkle_subtree_levels is the kernel this one replaced (2^k nodes a
// block, the levels in shared memory, k <= 9 a launch: three launches at
// 2^20 leaves), kept for chip_smoke.py's comparison alone.
//
// Plain C interface, bound with ctypes (lighthouse_tpu_torch/ops/merkle_sharded.py).

#include "sha256.cuh"

namespace {

// a block: 512 threads, one block an SM (at most 128 registers a thread)
constexpr int kMaxThreads = 512;
// the replaced kernel's blocks: 2^(k-1) threads, k <= 9
constexpr int kLevelsThreads = 256;
// the largest subtree one thread hashes alone: 2^kMaxLeafLevels nodes
constexpr int kMaxLeafLevels = 4;

// node j of `in` as 8 big-endian words, read through L2 (the last block
// reads other blocks' roots)
__device__ __forceinline__ void load_node(uint32_t* d, const uint4* in, long long j) {
  const uint4 a = __ldcg(in + 2 * j), b = __ldcg(in + 2 * j + 1);
  d[0] = bswap(a.x);
  d[1] = bswap(a.y);
  d[2] = bswap(a.z);
  d[3] = bswap(a.w);
  d[4] = bswap(b.x);
  d[5] = bswap(b.y);
  d[6] = bswap(b.z);
  d[7] = bswap(b.w);
}

__device__ __forceinline__ void store_node(uint4* out, long long j, const uint32_t* d) {
  out[2 * j] = make_uint4(bswap(d[0]), bswap(d[1]), bswap(d[2]), bswap(d[3]));
  out[2 * j + 1] = make_uint4(bswap(d[4]), bswap(d[5]), bswap(d[6]), bswap(d[7]));
}

// q = the root of the 2^l nodes of `in` from node `base` (0 <= l <= 4): a
// pair at a time, each hash merged with the pending roots (of 2, 4 and 8
// nodes) while the pair's index has low bits set, as a binary counter
__device__ __forceinline__ void thread_root(uint32_t* q, const uint4* in, long long base, int l) {
  if (l == 0) {
    load_node(q, in, base);
    return;
  }
  uint32_t p0[8], p1[8], p2[8], w[16];
  for (int g = 0; g < 1 << (l - 1); ++g) {
    load_node(w, in, base + 2 * g);
    load_node(w + 8, in, base + 2 * g + 1);
    int k = 0;
    for (int m = g;; m >>= 1) {
      sha256_64(q, w);
      if (!(m & 1)) break;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        w[x] = k == 0 ? p0[x] : k == 1 ? p1[x] : p2[x];
        w[8 + x] = q[x];
      }
      ++k;
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (k == 0) p0[x] = q[x];
      if (k == 1) p1[x] = q[x];
      if (k == 2) p2[x] = q[x];
    }
  }
}

// Threads 0 .. count - 1 of the block hold a digest d (count a power of two,
// count <= blockDim.x); leaves their root in thread 0's d. Every thread of
// the block calls it. A level of 32 or more parents takes the pairs from
// shared memory onto threads 0 .. count / 2 - 1 (whole warps); the last
// five levels run on warp 0 alone, by shuffles.
__device__ __forceinline__ void block_root(uint32_t* d, int count, uint32_t (*level)[8]) {
  const int t = threadIdx.x;
  while (count > 32) {
    __syncthreads();  // the level before has been read
    if (t < count) {
#pragma unroll
      for (int x = 0; x < 8; ++x) level[t][x] = d[x];
    }
    __syncthreads();
    count >>= 1;
    if (t < count) {
      uint32_t w[16];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        w[x] = level[2 * t][x];
        w[8 + x] = level[2 * t + 1][x];
      }
      sha256_64(d, w);
    }
  }
  if (t < 32) {
    const unsigned mask = blockDim.x < 32 ? (1u << blockDim.x) - 1 : 0xffffffffu;
    for (int s = 1; s < count; s <<= 1) {
      uint32_t w[16];
#pragma unroll
      for (int x = 0; x < 8; ++x) w[8 + x] = __shfl_down_sync(mask, d[x], s);
      if (t < count && !(t & (2 * s - 1))) {
#pragma unroll
        for (int x = 0; x < 8; ++x) w[x] = d[x];
        sha256_64(d, w);
      }
    }
  }
}

// in: runs of 2^L nodes; a run is blocks_per_run blocks of blockDim.x
// threads, each thread 2^leaf_levels nodes; out: a root a run. roots:
// blocks_per_run nodes a run, counters: one a run, 0 at the launch, both
// unused where blocks_per_run is 1.
__global__ void __launch_bounds__(kMaxThreads, 1)
    merkle_tree_kernel(const uint4* in, uint4* __restrict__ out, uint4* roots, unsigned* counters,
                       int leaf_levels, int blocks_per_run) {
  __shared__ uint32_t level[kMaxThreads][8];
  __shared__ int last;
  const int t = threadIdx.x, threads = blockDim.x;
  const long long b = blockIdx.x, run = b / blocks_per_run;
  const uint4* src = in;
  long long base = (b * threads + t) << leaf_levels;
  int l = leaf_levels, count = threads;
  for (int pass = 0;; ++pass) {
    uint32_t d[8] = {};
    if (t < count) thread_root(d, src, base, l);
    block_root(d, count, level);
    if (pass == 1 || blocks_per_run == 1) {
      if (t == 0) store_node(out, run, d);
      return;
    }
    // the run's last block to finish reduces the blocks' roots
    if (t == 0) {
      store_node(roots, b, d);
      __threadfence();
      last = atomicAdd(counters + run, 1u) == static_cast<unsigned>(blocks_per_run - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    src = roots + 2 * run * blocks_per_run;
    count = blocks_per_run < threads ? blocks_per_run : threads;
    l = 0;
    while ((count << l) < blocks_per_run) ++l;
    base = static_cast<long long>(t) << l;
  }
}

// The kernel merkle_tree_kernel replaced, for comparison: a block of
// T = 2^(k-1) threads (T <= 256) reduces 2T nodes, a thread a bottom
// hash, then every level in shared memory with half the threads before.
// in: blocks * 2T nodes of 32 bytes; out: one 32-byte root per block.
__global__ void __launch_bounds__(kLevelsThreads)
    merkle_levels_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int threads) {
  __shared__ uint32_t level[kLevelsThreads][8];
  const int t = threadIdx.x;
  const long long msg = static_cast<long long>(blockIdx.x) * threads + t;
  uint32_t w[16], st[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = in[msg * 4 + q];
    w[4 * q + 0] = bswap(v.x);
    w[4 * q + 1] = bswap(v.y);
    w[4 * q + 2] = bswap(v.z);
    w[4 * q + 3] = bswap(v.w);
  }
  sha256_64(st, w);
#pragma unroll
  for (int j = 0; j < 8; ++j) level[t][j] = st[j];
  __syncthreads();
  for (int half = threads / 2; half >= 1; half /= 2) {
    if (t < half) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[j] = level[2 * t][j];
        w[8 + j] = level[2 * t + 1][j];
      }
      sha256_64(st, w);
    }
    __syncthreads();
    if (t < half) {
#pragma unroll
      for (int j = 0; j < 8; ++j) level[t][j] = st[j];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[blockIdx.x * 2LL + 0] =
        make_uint4(bswap(level[0][0]), bswap(level[0][1]), bswap(level[0][2]), bswap(level[0][3]));
    out[blockIdx.x * 2LL + 1] =
        make_uint4(bswap(level[0][4]), bswap(level[0][5]), bswap(level[0][6]), bswap(level[0][7]));
  }
}

}  // namespace

// Reduce `nodes` 32-byte nodes at `in` (16-byte aligned) in runs of
// 2^levels (1 <= levels <= 30, nodes a multiple of 2^levels) to
// nodes >> levels roots at `out`, in one launch on `stream`: blocks of
// `threads` threads (a power of two, at most 512 and at most
// 2^(levels - leaf_levels)), each thread 2^leaf_levels nodes
// (1 <= leaf_levels <= 4). Where a run takes more than one block,
// `roots` holds a node for each of its blocks and `counters` an unsigned a
// run, zeroed here on the stream; a run of blocks_per_run blocks needs
// blocks_per_run <= 16 * threads. Returns the memset's error or
// cudaGetLastError() after the launch (0 = cudaSuccess); 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
extern "C" int merkle_subtree_roots(const void* in, void* out, void* roots, void* counters, long long nodes,
                                    int levels, int leaf_levels, int threads, void* stream) {
  if (levels < 1 || levels > 30 || leaf_levels < 1 || leaf_levels > kMaxLeafLevels || leaf_levels > levels ||
      threads < 1 || threads > kMaxThreads || (threads & (threads - 1)) || nodes < 0 || nodes % (1LL << levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_run = 1LL << (levels - leaf_levels);  // threads a run
  if (threads > per_run || per_run / threads > static_cast<long long>(threads) << kMaxLeafLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long runs = nodes >> levels, blocks = runs * (per_run / threads);
  if (blocks > runs) {
    const cudaError_t err = cudaMemsetAsync(counters, 0, runs * sizeof(unsigned), static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) {
    merkle_tree_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), static_cast<uint4*>(roots),
        static_cast<unsigned*>(counters), leaf_levels, static_cast<int>(per_run / threads));
  }
  return static_cast<int>(cudaGetLastError());
}

// The replaced kernel: `levels` levels a launch (1 <= levels <= 9), the
// same runs and roots; chip_smoke.py times its launches one by one.
extern "C" int merkle_subtree_levels(const void* in, void* out, long long nodes, int levels, void* stream) {
  if (levels < 1 || (1 << (levels - 1)) > kLevelsThreads || nodes % (1LL << levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = nodes >> levels;
  if (blocks > 0) {
    const int threads = 1 << (levels - 1);
    merkle_levels_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), threads);
  }
  return static_cast<int>(cudaGetLastError());
}
