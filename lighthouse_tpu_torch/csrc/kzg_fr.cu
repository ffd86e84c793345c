// K8 launches: the barycentric evaluation of blobs in evaluation form and
// the KZG opening quotient, over the bit-reversed 4096-point domain.
//
// Replaces, in the JAX package (lighthouse_tpu/ops/fr.py):
//   * barycentric_eval_batch (:156): y_j = (z_j^n - 1) * n^-1 *
//     sum_i p_ji * w_i / (z_j - w_i) for a batch of m blobs;
//   * quotient_batch (:189): q_i = (p_i - y) * (w_i - z)^-1, 0 where
//     w_i == z (the host fills that lane).
// The field arithmetic is csrc/fr.cuh (K8's fr_mul/add/sub/inv).
//
// Inputs and outputs are canonical: the blobs' 32-byte big-endian field
// elements as 8 32-bit words, most significant first, exactly as the bytes
// lie (the host only reinterprets them). The kernels convert into
// Montgomery form themselves (a product by R^2) and out of it at the end,
// so a quotient leaves the card ready for the MSM's digit extraction
// (csrc/msm.cu). The domain w_i stays resident on the card in Montgomery
// limbs. No padding: a launch covers exactly the m blobs it is given.
//
// Design: one thread per (blob, domain point) computes its term with a
// Fermat inverse, as the JAX kernel does; a block of 256 threads sums its
// terms in shared memory, and a second launch, one thread per blob, adds
// the blocks' partial sums and applies (z^n - 1) * n^-1 (z^n by log2 n
// squarings). The quotient is one thread per lane.
//
// What bounds it: 32-bit multiplies (fr.cuh). The bound counts the least
// Fr multiplications of the function, whatever this kernel does: with
// Montgomery's batch inversion, 3 products per inverted element and one
// inversion (255 products) per batch. Barycentric, m blobs of n points:
// 5 m n + 255 + 14 m (3 for the inversion and 2 for p_i * w_i * inv per
// term; per blob log2 n = 12 squarings for z^n and 2 final products).
// Quotient over n lanes: 4 n + 255. chip_smoke.py (FR_MULS) turns these
// into a bound at 264 32-bit multiplies per Fr product over 64 multiplies
// per clock per SM, 132 SMs, 1.98 GHz. This kernel inverts per lane (255
// squarings and 163 products), about 80 times the batch inversion's work:
// Montgomery's batch inversion is a later optimisation.
#include "fr.cuh"

// one term p_i * w_i / (z - w_i), Montgomery form; z in Montgomery form
DEV void bary_term(fr& t, const uint32_t* p_be, const uint32_t* w_mont, const fr& z) {
  fr p, w, d, inv;
  fr_ld_be(p, p_be);
  fr_to_mont(p, p);
  fr_set(w, w_mont);
  fr_sub(d, z, w);
  fr_inv(inv, d);
  fr_mul(t, p, w);
  fr_mul(t, t, inv);
}

// y = (z^n - 1) * n^-1 * sum(partial), n = 2^log_n; canonical out
DEV void bary_finish_one(uint32_t* y_be, const uint32_t* partial, int nblk, const uint32_t* z_be, int log_n) {
  fr s, t, z, one, ninv;
  fr_zero(s);
  for (int b = 0; b < nblk; b++) {
    fr_set(t, partial + 8 * b);
    fr_add(s, s, t);
  }
  fr_ld_be(z, z_be);
  fr_to_mont(z, z);
  for (int i = 0; i < log_n; i++) fr_mul(z, z, z);
  fr_one(one);
  fr_sub(z, z, one);
  fr_zero(ninv);
  ninv.v[0] = 1u << log_n;
  fr_to_mont(ninv, ninv);
  fr_inv(ninv, ninv);
  fr_mul(s, s, z);
  fr_mul(s, s, ninv);
  fr_from_mont(s, s);
  fr_st_be(y_be, s);
}

// q_i = (p_i - y) / (w_i - z), 0 where w_i == z; y, z in Montgomery form
DEV void quotient_lane(uint32_t* q_be, const uint32_t* p_be, const uint32_t* w_mont, const fr& z, const fr& y) {
  fr p, w, d;
  fr_ld_be(p, p_be);
  fr_to_mont(p, p);
  fr_sub(p, p, y);
  fr_set(w, w_mont);
  fr_sub(d, w, z);
  fr_inv(d, d);
  fr_mul(p, p, d);
  fr_from_mont(p, p);
  fr_st_be(q_be, p);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define BARY_THREADS 256
#define LANES_PER_BLOCK 64

// grid (nblk, m): evals [m, n, 8], roots [n, 8], zs [m, 8] -> partial [m, nblk, 8]
__global__ void __launch_bounds__(BARY_THREADS)
bary_terms_kernel(const uint32_t* evals, const uint32_t* roots, const uint32_t* zs, uint32_t* partial, int n) {
  __shared__ fr s[BARY_THREADS];
  const int j = blockIdx.y;
  const int i = blockIdx.x * BARY_THREADS + threadIdx.x;
  fr t;
  fr_zero(t);
  if (i < n) {
    fr z;
    fr_ld_be(z, zs + 8 * j);
    fr_to_mont(z, z);
    bary_term(t, evals + ((long long)j * n + i) * 8, roots + 8 * i, z);
  }
  s[threadIdx.x] = t;
  __syncthreads();
  for (int h = BARY_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) fr_add(s[threadIdx.x], s[threadIdx.x], s[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    uint32_t* dst = partial + ((long long)j * gridDim.x + blockIdx.x) * 8;
    for (int k = 0; k < 8; k++) dst[k] = s[0].v[k];
  }
}

__global__ void __launch_bounds__(LANES_PER_BLOCK)
bary_finish_kernel(const uint32_t* partial, const uint32_t* zs, uint32_t* ys, long long m, int nblk, int log_n) {
  long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= m) return;
  bary_finish_one(ys + 8 * j, partial + j * nblk * 8, nblk, zs + 8 * j, log_n);
}

__global__ void __launch_bounds__(LANES_PER_BLOCK)
quotient_kernel(const uint32_t* evals, const uint32_t* roots, const uint32_t* z_be, const uint32_t* y_be, uint32_t* q, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr z, y;
  fr_ld_be(z, z_be);
  fr_to_mont(z, z);
  fr_ld_be(y, y_be);
  fr_to_mont(y, y);
  quotient_lane(q + 8 * i, evals + 8 * i, roots + 8 * i, z, y);
}

extern "C" {

// partial must hold m * ceil(n / 256) * 8 words
int kzg_barycentric(const uint32_t* evals, const uint32_t* roots, const uint32_t* zs, uint32_t* partial, uint32_t* ys,
                    long long m, int log_n, void* stream) {
  const int n = 1 << log_n;
  const int nblk = (n + BARY_THREADS - 1) / BARY_THREADS;
  bary_terms_kernel<<<dim3(nblk, (unsigned)m), BARY_THREADS, 0, (cudaStream_t)stream>>>(evals, roots, zs, partial, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bary_finish_kernel<<<(unsigned)((m + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      partial, zs, ys, m, nblk, log_n);
  return (int)cudaGetLastError();
}

int kzg_quotient(const uint32_t* evals, const uint32_t* roots, const uint32_t* z, const uint32_t* y, uint32_t* q,
                 long long n, void* stream) {
  quotient_kernel<<<(unsigned)((n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      evals, roots, z, y, q, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
