// K2 launches: batched G1/G2 scalar ladders, per-set segment sums and
// Jacobian -> affine conversion for BLS batch verification.
//
// Replaces, in the JAX package (lighthouse_tpu/ops):
//   * bls381.py:481/487 batch_g1_scalar_mul / batch_g2_scalar_mul (the
//     64-bit random-linear-combination ladders, pt_scalar_mul :368);
//   * bls381.py:492 g1_sum_reduce and bls381_verify.py:66/103/108
//     _tree_reduce_scan / g1_segment_sum / g2_sum_reduce (tree sums over a
//     padded committee axis);
//   * bls381_verify.py:122/138 g1_jac_to_affine / g2_jac_to_affine.
//
// Design: one thread per lane; a lane's points live in registers and local
// memory. The ladders branch on the scalar's bits (they are public: the
// verifier's random scalars), running all 64 bits left to right from the
// canonical infinity. A segment sum is one block per segment, a tree over
// the (power-of-two) padded axis in a global scratch buffer, one level per
// __syncthreads(); the tree pairs (0,1), (2,3), ... and then their sums, as
// the plain version does, so both give the same Jacobian coordinates.
//
// What bounds it: 32-bit multiply-adds. The bound counts the least Fq
// multiplications the function needs, from the cheapest known formulas,
// whatever this kernel does (an Fq2 product is 3 Fq ones, a square 2; a
// power to a fixed e at the floor of any addition chain, ceil(log2 e)):
// a Jacobian doubling (a = 0) is 2M + 5S, 1M + 5S on an affine input; an
// addition 11M + 5S, 7M + 4S with an affine addend. In Fq that is 7, 6,
// 16 and 11; in Fq2 16, 13, 43 and 29.
//   * 64-bit ladder with scalar k on a Jacobian point: (bits(k) - 1)
//     doublings and (popcount(k) - 1) additions; for a 64-bit draw about 63
//     and 31, so G1 63*7 + 31*16 = 937 and G2 63*16 + 31*43 = 2,341.
//   * segment sum over k affine points (the pubkeys): k - 1 mixed
//     additions (11); over k Jacobian points (the G2 sum): k - 1 additions
//     (43).
//   * to affine over n lanes: one batch inversion (Montgomery's trick:
//     an inverse, 381 Fq products for a^(p-2), and 3(n - 1) products), then
//     z^-2, z^-3, x z^-2, y z^-3 per lane: G1 381 + 3(n - 1) + 4n, G2 385
//     (the norm, an Fq inverse, 2 products) + 9(n - 1) + 11n.
// chip_smoke.py (BLS_FQ_MULS) turns these counts into a bound: 588 32-bit
// multiplies per Montgomery multiplication over 64 multiplies per clock
// per SM (CUDA C++ Programming Guide, compute capability 9.0), 132 SMs,
// 1.98 GHz.
#include "bls381_field.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define LANES_PER_BLOCK 64

template <class F>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
scalar_mul_kernel(const long long* pts, const long long* k, long long* out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p3 = 3 * limbs<F>::n;
  jac<F> p, r;
  pt_ld(p, pts + i * p3);
  pt_mul_u64(r, p, (unsigned long long)k[i]);
  pt_st(out + i * p3, r);
}

// pts [n, k, 3, w] (k a power of two), buf [n, k/2, 3, w], out [n, 3, w]
template <class F>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
segment_sum_kernel(const long long* pts, long long* buf, long long* out, int k) {
  const long long p3 = 3 * limbs<F>::n;
  const long long seg = blockIdx.x;
  const long long* in = pts + seg * k * p3;
  long long* dst = out + seg * p3;
  if (k == 1) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < p3; j++) dst[j] = in[j];
    }
    return;
  }
  const int half = k / 2;
  long long* b = buf + seg * half * p3;
  for (int t = threadIdx.x; t < half; t += blockDim.x) {
    jac<F> a, c;
    pt_ld(a, in + 2 * t * p3);
    pt_ld(c, in + (2 * t + 1) * p3);
    pt_add(a, a, c);
    pt_st(b + t * p3, a);
  }
  __syncthreads();
  for (int s = 1; s < half; s *= 2) {
    for (int t = threadIdx.x; 2 * s * t < half; t += blockDim.x) {
      const int i = 2 * s * t;
      jac<F> a, c;
      pt_ld(a, b + i * p3);
      pt_ld(c, b + (i + s) * p3);
      pt_add(a, a, c);
      pt_st(b + i * p3, a);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < p3; j++) dst[j] = b[j];
  }
}

// pts [n, 3, w] -> out [n, 2, w]
template <class F>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
to_affine_kernel(const long long* pts, long long* out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = limbs<F>::n;
  jac<F> p;
  F ax, ay;
  pt_ld(p, pts + i * 3 * w);
  pt_to_affine(ax, ay, p);
  f_st(out + i * 2 * w, ax);
  f_st(out + i * 2 * w + w, ay);
}

static unsigned grid_for(long long n) { return (unsigned)((n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK); }

extern "C" {

int bls_g1_scalar_mul(const long long* pts, const long long* k, long long* out, long long n, void* stream) {
  scalar_mul_kernel<fp><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, k, out, n);
  return (int)cudaGetLastError();
}

int bls_g2_scalar_mul(const long long* pts, const long long* k, long long* out, long long n, void* stream) {
  scalar_mul_kernel<fp2><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, k, out, n);
  return (int)cudaGetLastError();
}

int bls_g1_segment_sum(const long long* pts, long long* buf, long long* out, long long n, int k, void* stream) {
  segment_sum_kernel<fp><<<(unsigned)n, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, buf, out, k);
  return (int)cudaGetLastError();
}

int bls_g2_segment_sum(const long long* pts, long long* buf, long long* out, long long n, int k, void* stream) {
  segment_sum_kernel<fp2><<<(unsigned)n, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, buf, out, k);
  return (int)cudaGetLastError();
}

int bls_g1_to_affine(const long long* pts, long long* out, long long n, void* stream) {
  to_affine_kernel<fp><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, out, n);
  return (int)cudaGetLastError();
}

int bls_g2_to_affine(const long long* pts, long long* out, long long n, void* stream) {
  to_affine_kernel<fp2><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
