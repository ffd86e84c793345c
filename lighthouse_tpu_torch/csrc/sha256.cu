// SHA-256 of 64-byte messages for Hopper (sm_90a): the SSZ Merkleization
// kernel. A Merkle parent is SHA-256(left || right) over exactly 64 bytes,
// so one tree level of m parents is m independent two-block hashes: the
// data block, then the constant padding block of a 64-byte message.
//
// Replaces lighthouse_tpu/ops/sha256.py:104-167 (`sha256_pairs`, which
// `merkle_tree_levels`, `merkleize_device` and `device_hash_rows` call).
//
// Bound: 32-bit integer issue, not bytes. A message reads 64 bytes and
// writes 32. The least work SHA-256 of one 64-byte message needs, counted
// in Hopper's 32-bit instructions at their widest (SHF: a rotate or shift;
// LOP3: any 3-input logic function; IADD3: a 3-input add with one immediate
// operand), whatever the code that issues them, is 2,300 operations:
//   a round: Sigma0 and Sigma1 3 SHF + 1 LOP3 each, Ch 1 LOP3, Maj 1 LOP3,
//     4 IADD3 (h+Sigma1+Ch, +K+W, e = d+T1, a = T1+Sigma0+Maj)   =    14
//   128 rounds x 14                                              = 1,792
//   a schedule word: sigma0 and sigma1 3 SHF + 1 LOP3 each, 2 IADD3
//     (the second block's schedule is constant): 48 words x 10   =   480
//   feed-forward: 8 adds after each compression                  =    16
//   byte swaps (PRMT): 16 words in, 8 out                        =    24
//   less round 0 of the first block, whose state is the constant IV:
//     e and a are each W[0] plus a constant, 2 adds instead of 14 =   -12
// chip_smoke.py divides this constant by the card's issue rate for the
// kernel's bound. That is about 24 operations per byte moved, several
// times what the card's integer rate over its memory rate allows, so the
// design spends nothing on memory tricks and keeps every operand in
// registers:
//   - one thread per message, no shared memory, no synchronisation;
//   - the 16-word schedule is a circular buffer in registers, indexed with
//     constants because every round is unrolled;
//   - K and the padding block's precomputed K[t]+W[t] sit in __constant__
//     (every thread reads the same word at the same time: a broadcast);
//   - rotations are funnel shifts, byte order is swapped with __byte_perm
//     on the raw bytes (no host-side word conversion);
//   - loads and stores are 16-byte vectors.
//
// The compression is csrc/sha256.cuh, shared with K10 (merkle_subtree.cu).
// Plain C interface, bound with ctypes (lighthouse_tpu_torch/ops/sha256.py).

#include "sha256.cuh"

namespace {

constexpr int kThreads = 256;

// in: n rows of 64 bytes; out: n rows of 32 bytes. Both 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    sha256_rows_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                       long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = in[i * 4 + q];
    w[4 * q + 0] = bswap(v.x);
    w[4 * q + 1] = bswap(v.y);
    w[4 * q + 2] = bswap(v.z);
    w[4 * q + 3] = bswap(v.w);
  }
  uint32_t st[8];
  sha256_64(st, w);
  out[i * 2 + 0] = make_uint4(bswap(st[0]), bswap(st[1]), bswap(st[2]), bswap(st[3]));
  out[i * 2 + 1] = make_uint4(bswap(st[4]), bswap(st[5]), bswap(st[6]), bswap(st[7]));
}

}  // namespace

// Hash n 64-byte rows at `in` into n 32-byte digests at `out` on `stream`.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int sha256_rows(const void* in, void* out, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    sha256_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
