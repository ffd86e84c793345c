// K9: the G1 multi-scalar multiplication sum_i s_i * P_i of KZG (every
// blob commitment and every opening proof: 4096 Lagrange setup points).
//
// Replaces, in the JAX package (lighthouse_tpu/ops/msm.py):
//   * msm_pippenger_device (:94) with its host digit preparation
//     _host_digit_prep (:48) and g1_msm_pippenger (:159), the Pippenger
//     path g1_msm_device (:186) takes on an accelerator.
// The point arithmetic is pt_add / pt_double of csrc/bls381_field.cuh
// (Jacobian, complete: an infinity operand, P == Q and P == -Q are all
// handled, which matters because distinct points meet in a bucket's sum).
//
// Inputs: the points [n, 3, 12] in the port's Jacobian limb layout
// (ops/bls381.py; the setup's points stay resident on the card), and the
// scalars [n, 8] as canonical 32-bit words, most significant first (as a
// blob's bytes lie, or as the quotient kernel of csrc/kzg_fr.cu writes
// them). The kernel extracts its digits itself: the JAX package sorts
// them on the host (262k Python iterations and an argsort per MSM).
//
// Design (4-bit windows, as the JAX kernel: 64 windows of 15 buckets;
// with 8-bit windows each window's sum over 255 buckets would be a
// 510-addition chain on one thread, and with 4-bit ones it is 30):
//   1. msm_buckets: one thread per (window w, chunk c of 32 points) keeps
//      its 15 buckets in local memory and adds each point of its chunk to
//      the bucket its digit names (zero digits add nothing). The threads
//      of a warp are 32 windows of one chunk: they read the same points
//      and none of them waits on another's digit. Output
//      partial[w][b][c], chunks padded to a power of two with infinities;
//   2. msm_bucket_sums: one block per (w, b) adds the chunks' partial
//      buckets in a tree (pairs (0,1), (2,3), ..., then their sums, as
//      K2's segment sum);
//   3. msm_combine: one thread per window forms sum_j j * B_j with the
//      running-sum trick (B_15, B_15 + B_14, ... summed), then one thread
//      combines the windows from the top by Horner's rule (4 doublings
//      and an addition each). The result is one Jacobian point.
// The plain version (ops/msm.py) takes the same steps in the same order,
// so both give the same Jacobian coordinates.
//
// What bounds it: 32-bit multiplies of the point arithmetic (588 per Fq
// product, bls381_field.cuh). The bound counts Pippenger's least Fq
// products for this run's scalars at the best window c (chip_smoke.py,
// msm_fq_muls):
//   * buckets: the setup points are affine, so each nonzero digit after
//     the first in its bucket is an affine addition. With Montgomery's
//     batch inversion that is 6 products: the slope (y2 - y1) * inv, its
//     square for x3, the product for y3, and 3 per element for the shared
//     inversion. A bucket of k points sums as a tree of ceil(log2 k)
//     rounds, and each round shares one inversion (381 products, a^(p-2))
//     across all buckets of all windows;
//   * running sums: 2^c - 2 steps per window. Each is a mixed addition
//     (11; the bucket sum is affine) and a Jacobian addition (16), or both
//     as affine additions batched across the windows, 2 inversions a step;
//     whichever is fewer;
//   * Horner: c doublings (7) and one Jacobian addition (16) per window
//     but the top one.
// At c = 8 and 4096 seeded scalars that is about 0.96M products, 0.034 ms
// on the card's multipliers; bucket additions are about 77% of it. This
// kernel adds in Jacobian coordinates with no batch inversion, and step
// 3's doublings are one chain of 252 on one thread, while steps 1-2 run
// 4096 + 960 threads: it is bound by the latency of that chain, not by
// the card's multipliers.
#include "bls381_field.cuh"

#define MSM_WINDOW 4
#define MSM_WINDOWS 64
#define MSM_BUCKETS 15
#define MSM_CHUNK 32
#define MSM_P3 36  // limbs of a Jacobian point

// digit w (4 bits, least significant window first) of 8 big-endian words
DEV int msm_digit(const uint32_t* s, int w) { return (int)((s[7 - (w >> 3)] >> (4 * (w & 7))) & 15u); }

// step 1 for one (window, chunk): buckets B[0..14] hold digits 1..15
DEV void msm_chunk_buckets(jac<fp>* B, const long long* pts, const uint32_t* scalars, long long n, int w, long long c) {
  for (int b = 0; b < MSM_BUCKETS; b++) pt_inf(B[b]);
  long long end = (c + 1) * MSM_CHUNK < n ? (c + 1) * MSM_CHUNK : n;
  for (long long i = c * MSM_CHUNK; i < end; i++) {
    int d = msm_digit(scalars + 8 * i, w);
    if (d) {
      jac<fp> p;
      pt_ld(p, pts + i * MSM_P3);
      pt_add(B[d - 1], B[d - 1], p);
    }
  }
}

// step 3a for one window: sum_j j * B_j from its 15 bucket sums [15][36]
DEV void msm_window_sum(jac<fp>& acc, const long long* sums) {
  jac<fp> running, b;
  pt_inf(running);
  pt_inf(acc);
  for (int j = MSM_BUCKETS - 1; j >= 0; j--) {
    pt_ld(b, sums + j * MSM_P3);
    pt_add(running, running, b);
    pt_add(acc, acc, running);
  }
}

// step 3b: Horner over the windows' sums, the top window first
DEV void msm_horner(jac<fp>& acc, const jac<fp>* wsum) {
  pt_inf(acc);
  for (int w = MSM_WINDOWS - 1; w >= 0; w--) {
    for (int k = 0; k < MSM_WINDOW; k++) pt_double(acc, acc);
    pt_add(acc, acc, wsum[w]);
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define LANES_PER_BLOCK 64

// thread t: window t % 64, chunk t / 64; partial [64][15][nc][36]
__global__ void __launch_bounds__(LANES_PER_BLOCK)
msm_buckets_kernel(const long long* pts, const uint32_t* scalars, long long* partial, long long n, int nc) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)MSM_WINDOWS * nc) return;
  const int w = (int)(t % MSM_WINDOWS);
  const long long c = t / MSM_WINDOWS;
  jac<fp> B[MSM_BUCKETS];
  msm_chunk_buckets(B, pts, scalars, n, w, c);
  for (int b = 0; b < MSM_BUCKETS; b++) pt_st(partial + (((long long)w * MSM_BUCKETS + b) * nc + c) * MSM_P3, B[b]);
}

// block s sums segment s of partial ([960][nc][36], nc a power of two)
// into sums [960][36]; buf [960][nc/2][36] is scratch
__global__ void __launch_bounds__(LANES_PER_BLOCK)
msm_bucket_sums_kernel(const long long* partial, long long* buf, long long* sums, int nc) {
  const long long seg = blockIdx.x;
  const long long* in = partial + seg * nc * MSM_P3;
  long long* dst = sums + seg * MSM_P3;
  if (nc == 1) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < MSM_P3; j++) dst[j] = in[j];
    }
    return;
  }
  const int half = nc / 2;
  long long* b = buf + seg * half * MSM_P3;
  for (int t = threadIdx.x; t < half; t += blockDim.x) {
    jac<fp> a, c;
    pt_ld(a, in + 2 * t * MSM_P3);
    pt_ld(c, in + (2 * t + 1) * MSM_P3);
    pt_add(a, a, c);
    pt_st(b + t * MSM_P3, a);
  }
  __syncthreads();
  for (int s = 1; s < half; s *= 2) {
    for (int t = threadIdx.x; 2 * s * t < half; t += blockDim.x) {
      const int i = 2 * s * t;
      jac<fp> a, c;
      pt_ld(a, b + i * MSM_P3);
      pt_ld(c, b + (i + s) * MSM_P3);
      pt_add(a, a, c);
      pt_st(b + i * MSM_P3, a);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < MSM_P3; j++) dst[j] = b[j];
  }
}

// one block of 64 threads: sums [64][15][36] -> out [36]
__global__ void __launch_bounds__(MSM_WINDOWS)
msm_combine_kernel(const long long* sums, long long* out) {
  __shared__ jac<fp> wsum[MSM_WINDOWS];
  jac<fp> acc;
  msm_window_sum(acc, sums + (long long)threadIdx.x * MSM_BUCKETS * MSM_P3);
  wsum[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    msm_horner(acc, wsum);
    pt_st(out, acc);
  }
}

extern "C" {

// nc = a power of two >= ceil(n / 32); partial [64 * 15 * nc * 36],
// buf [64 * 15 * max(nc / 2, 1) * 36], sums [64 * 15 * 36], out [36]
int msm_g1(const long long* pts, const uint32_t* scalars, long long* partial, long long* buf, long long* sums,
           long long* out, long long n, int nc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long lanes = (long long)MSM_WINDOWS * nc;
  msm_buckets_kernel<<<(unsigned)((lanes + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK), LANES_PER_BLOCK, 0, st>>>(
      pts, scalars, partial, n, nc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  msm_bucket_sums_kernel<<<MSM_WINDOWS * MSM_BUCKETS, LANES_PER_BLOCK, 0, st>>>(partial, buf, sums, nc);
  err = (int)cudaGetLastError();
  if (err) return err;
  msm_combine_kernel<<<1, MSM_WINDOWS, 0, st>>>(sums, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
