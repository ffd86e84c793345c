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
// Montgomery form themselves and out of it at the end, so a quotient
// leaves the card ready for the MSM's digit extraction (csrc/msm.cu). The
// domain w_i stays resident on the card in Montgomery limbs. No padding:
// a launch covers exactly the m blobs it is given.
//
// Barycentric design: one inversion per blob. Since
//   p_i w_i / (z - w_i) = -p_i + z p_i / (z - w_i),
// the sum is S = z S1 - S0 with S1 = sum_i p_i / (z - w_i) and
// S0 = sum_i p_i, so a term needs no product of its own: S1 is kept as a
// fraction N/D, each term p_i / d_i with d_i = z - w_i, and two fractions
// add as a/b + c/d = (ad + cb) / bd: three products, independent of one
// another; S0 is a sum. A thread folds its run of `terms` terms (strided
// by the block, so a warp reads neighbouring elements), a block of 256
// threads folds its threads' (N, D, S0) in a shared-memory tree, and a
// blob is spread over as many blocks as fill the card (terms = 1 up to a
// few blobs, 4 at 192). A second launch, a block per blob, folds the
// blocks' triples (a warp, then its tree), inverts D once
// (mont_inv_binary, mont_cs.cuh: shifts and subtractions, no products)
// while a second warp computes z^n - 1, and finishes y = (z N D^-1 - S0)
// (z^n - 1) n^-1. A blob whose z is on the domain has D = 0; the inverse
// of 0 is 0 and z^n - 1 = 0, so its y is 0, as the per-term kernel and
// the JAX kernel give, and other blobs of the launch are untouched. The
// canonical p_i enter as they are: read as Montgomery values they are
// p_i / R, so N / D and S0 carry a 1/R that the last product, by the
// plain integer R / n, takes out together with n^-1.
// Products are mont_mul_cs (mont_cs.cuh), inlined on registers.
// Longest dependent chain at [1, 4096] (16 blocks, a term a thread): 8 + 5
// tree levels of one fraction add (3 independent products), the inversion
// (~2 * 255 shift-subtract steps), 4 products.
// The quotient is one thread per lane with a Fermat inverse (unchanged).
//
// What bounds it: 32-bit multiplies (fr.cuh). The bound counts the least
// Fr multiplications of the function, from the cheapest known method,
// whatever the kernel does. Barycentric, m blobs of n points, by the
// identity above and the fraction tree: n - 1 fraction adds of 3 products
// (the first term of a tree is p_1 / d_1 as it is; S0 takes additions
// only): 3n - 3 per blob; per blob z^n (log2 n = 12 squarings) and
// y = (z N D^-1 - S0) (z^n - 1) n^-1 (4 products, n^-1 a constant); the
// m inversions of D by Montgomery's batch inversion: 3 products per blob
// and one inversion (255 products at the floor of any addition chain for
// r - 2) per batch: (3n - 3 + 16 + 3) m + 255. Quotient over n lanes:
// 4 n + 255 (batch inversion of the w_i - z, a product each).
// chip_smoke.py (FR_MULS) turns these into a bound at 264 32-bit
// multiplies per Fr product over 64 multiplies per clock per SM, 132 SMs,
// 1.98 GHz.
#include "fr.cuh"
#include "mont_cs.cuh"

// R^3 mod r, mont_inv_binary's last factor
CONSTMEM uint32_t FR_R3[8] = {0x439b73afu, 0xc62c1807u, 0x8cf06990u, 0x1b3e0d18u,
                              0xc7b5f418u, 0x73d13c71u, 0xc8db33e9u, 0x6e2a5bb9u};

DEV void fr_mulx(fr& r, const fr& a, const fr& b) { mont_mul_cs<8>(r.v, a.v, b.v, FR_MOD, FR_NINV); }

// a/b += c/d as (a d + c b) / (b d)
DEV void frac_add(fr& a, fr& b, const fr& c, const fr& d) {
  fr ad, cb;
  fr_mulx(ad, a, d);
  fr_mulx(cb, c, b);
  fr_mulx(b, b, d);
  fr_add(a, ad, cb);
}

// the plain integer R / 2^log_n mod r, the last factor of y
DEV void fr_r_over_n(fr& k, int log_n) {
  fr_set(k, FR_ONE);  // R mod r, read as a plain integer
  while (log_n > 0) {
    const int s = log_n < 31 ? log_n : 31;
    mod_div_pow2<8>(k.v, s, FR_MOD, FR_NINV);
    log_n -= s;
  }
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
#define BARY_FINISH_THREADS 64
#define LANES_PER_BLOCK 64
// threads that fill the card: 132 SMs, 2048 threads each
#define BARY_FILL (132LL * 2048)

// grid (nblk, m); thread t of block b folds terms b * 256 * terms +
// k * 256 + t, k < terms: evals [m, n, 8], roots [n, 8], zs [m, 8] ->
// partial [m, nblk, 3, 8] (N, D, S0 per block)
__global__ void __launch_bounds__(BARY_THREADS)
bary_terms_kernel(const uint32_t* evals, const uint32_t* roots, const uint32_t* zs, uint32_t* partial, int n,
                  int terms) {
  __shared__ fr sn[BARY_THREADS], sd[BARY_THREADS], sp[BARY_THREADS];
  const int j = blockIdx.y, tid = threadIdx.x;
  fr z, r2, num, den, psum;
  fr_ld_be(z, zs + 8 * j);
  fr_set(r2, FR_R2);
  fr_mulx(z, z, r2);
  fr_zero(num);
  fr_one(den);
  fr_zero(psum);
  const long long base = (long long)blockIdx.x * BARY_THREADS * terms + tid;
  for (int k = 0; k < terms; k++) {
    const long long i = base + (long long)k * BARY_THREADS;
    if (i < n) {
      fr p, w, d;
      fr_ld_be(p, evals + ((long long)j * n + i) * 8);  // p / R
      fr_set(w, roots + 8 * i);
      fr_sub(d, z, w);
      fr_add(psum, psum, p);
      if (k == 0) { num = p; den = d; } else frac_add(num, den, p, d);
    }
  }
  sn[tid] = num;
  sd[tid] = den;
  sp[tid] = psum;
  __syncthreads();
  for (int h = BARY_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      fr a = sn[tid], b = sd[tid];
      frac_add(a, b, sn[tid + h], sd[tid + h]);
      sn[tid] = a;
      sd[tid] = b;
      fr_add(sp[tid], sp[tid], sp[tid + h]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    uint32_t* dst = partial + ((long long)j * gridDim.x + blockIdx.x) * 24;
    for (int k = 0; k < 8; k++) {
      dst[k] = sn[0].v[k];
      dst[8 + k] = sd[0].v[k];
      dst[16 + k] = sp[0].v[k];
    }
  }
}

// a block per blob: warp 0 folds the nblk triples and inverts D, warp 1
// computes z, z^n - 1 and R / n meanwhile; ys [m, 8] canonical
__global__ void __launch_bounds__(BARY_FINISH_THREADS)
bary_finish_kernel(const uint32_t* partial, const uint32_t* zs, uint32_t* ys, int nblk, int log_n) {
  __shared__ fr sn[32], sd[32], sp[32], se[3];
  const int j = blockIdx.x, tid = threadIdx.x;
  if (tid < 32) {
    const uint32_t* part = partial + (long long)j * nblk * 24;
    fr num, den, psum;
    fr_zero(num);
    fr_one(den);
    fr_zero(psum);
    for (int b = tid; b < nblk; b += 32) {
      fr a, d, q;
      fr_set(a, part + 24 * b);
      fr_set(d, part + 24 * b + 8);
      fr_set(q, part + 24 * b + 16);
      fr_add(psum, psum, q);
      if (b == tid) { num = a; den = d; } else frac_add(num, den, a, d);
    }
    sn[tid] = num;
    sd[tid] = den;
    sp[tid] = psum;
    __syncwarp();
    for (int h = 16; h > 0; h >>= 1) {
      if (tid < h) {
        fr a = sn[tid], b = sd[tid];
        frac_add(a, b, sn[tid + h], sd[tid + h]);
        sn[tid] = a;
        sd[tid] = b;
        fr_add(sp[tid], sp[tid], sp[tid + h]);
      }
      __syncwarp();
    }
    if (tid == 0) {
      fr inv, r3;
      fr_set(r3, FR_R3);
      mont_inv_binary<8>(inv.v, sd[0].v, FR_MOD, FR_NINV, r3.v);
      sd[0] = inv;
    }
  } else if (tid == 32) {
    fr z, r2, zn, one, k;
    fr_ld_be(z, zs + 8 * j);
    fr_set(r2, FR_R2);
    fr_mulx(z, z, r2);
    zn = z;
    for (int i = 0; i < log_n; i++) fr_mulx(zn, zn, zn);
    fr_one(one);
    fr_sub(se[0], zn, one);
    fr_r_over_n(k, log_n);
    se[1] = k;
    se[2] = z;
  }
  __syncthreads();
  if (tid == 0) {
    fr y;
    fr_mulx(y, sn[0], sd[0]);  // S1 = N / D, with the 1/R of the p_i
    fr_mulx(y, y, se[2]);      // z S1
    fr_sub(y, y, sp[0]);       // - S0: S / R
    fr_mulx(y, y, se[0]);      // (z^n - 1)
    fr_mulx(y, y, se[1]);      // R / n as a plain integer: canonical out
    fr_st_be(ys + 8 * j, y);
  }
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

// partial must hold m * 3 * ceil(n / 256) * 8 words
int kzg_barycentric(const uint32_t* evals, const uint32_t* roots, const uint32_t* zs, uint32_t* partial, uint32_t* ys,
                    long long m, int log_n, void* stream) {
  const int n = 1 << log_n;
  int terms = 1;
  while (terms < 16 && m * n / terms > BARY_FILL) terms *= 2;
  const int nblk = (n + BARY_THREADS * terms - 1) / (BARY_THREADS * terms);
  bary_terms_kernel<<<dim3(nblk, (unsigned)m), BARY_THREADS, 0, (cudaStream_t)stream>>>(evals, roots, zs, partial, n,
                                                                                     terms);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bary_finish_kernel<<<(unsigned)m, BARY_FINISH_THREADS, 0, (cudaStream_t)stream>>>(partial, zs, ys, nblk, log_n);
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
