// Merkle subtree roots for Hopper (sm_90a): the per-device step of the
// sharded Merkle root (K10). One launch reduces every run of 2^k sibling
// nodes to the root of their subtree.
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
// Design: a block of T = 2^(k-1) threads (T <= 256) reduces 2T nodes. Each
// thread hashes one 64-byte message of the bottom level straight from
// device memory (16-byte vector loads, byte order swapped in registers);
// the digests stay as big-endian words in shared memory (8 KiB at 256
// threads), and every further level halves the threads at work, with a
// barrier between reading the children and writing the parents. No level
// above the bottom goes back to device memory and no level needs a launch
// of its own; the cost is that the upper levels of a block keep few
// threads busy. A shard of 2^20 leaves takes three launches (9, 9 and 2
// levels). The compression is csrc/sha256.cuh, K1's own.
//
// Plain C interface, bound with ctypes (lighthouse_tpu_torch/ops/merkle_sharded.py).

#include "sha256.cuh"

namespace {

constexpr int kMaxThreads = 256;

// in: blocks * 2T nodes of 32 bytes; out: one 32-byte root per block.
__global__ void __launch_bounds__(kMaxThreads)
    merkle_subtree_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int threads) {
  __shared__ uint32_t level[kMaxThreads][8];
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

// Reduce `nodes` 32-byte nodes at `in` (16-byte aligned), `levels` levels
// at a time (1 <= levels <= 9, nodes a multiple of 2^levels), into
// nodes >> levels roots at `out` on `stream`. Returns cudaGetLastError()
// after the launch (0 = cudaSuccess); 1 (cudaErrorInvalidValue) for
// arguments the kernel does not take.
extern "C" int merkle_subtree_roots(const void* in, void* out, long long nodes, int levels, void* stream) {
  if (levels < 1 || (1 << (levels - 1)) > kMaxThreads || nodes % (1LL << levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = nodes >> levels;
  if (blocks > 0) {
    const int threads = 1 << (levels - 1);
    merkle_subtree_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), threads);
  }
  return static_cast<int>(cudaGetLastError());
}
