// K4 launches: the G2 subgroup check and the multi-pairing check of BLS
// batch verification.
//
// Replaces, in the JAX package (lighthouse_tpu/ops/bls381_pairing.py):
//   * :418 g2_subgroup_check_device: psi(Q) == [x]Q with a 64-bit ladder;
//   * :340 multi_pairing_check_device with :211 miller_loop_batch, :325
//     _mask_and_reduce (infinity pairs contribute 1) and :305
//     final_exp_cubed.
// (:440 g2_clear_cofactor_device is a device function in
// bls381_field.cuh, run inside the hash-to-G2 kernel, bls381_htc.cu.)
//
// The Miller loop follows the host oracle (crypto/bls12_381/pairing.py):
// the G2 point stays on the twist in homogeneous projective coordinates and
// each line is a sparse Fq12 element folded in by fp12_mul_by_045. The
// final exponentiation is the oracle's exact one, f^((p^12-1)/r), with
// cyclotomic squarings: the GT convention is the standard exponent (the
// JAX kernel computes its cube; both agree on every check, gcd(3, r) = 1).
//
// Design: one thread per pair runs its Miller loop and stores the Fq12 in
// a scratch buffer; the whole check is one block, so after __syncthreads()
// thread 0 multiplies the pairs' values (skipping infinity pairs) and runs
// the one final exponentiation. The subgroup check is one thread per point.
//
// What bounds it: 32-bit multiply-adds. The bound counts the least Fq
// multiplications the function needs, from the cheapest known way to
// compute it, whatever this kernel does (Fq2 M = 3 Fq, S = 2; Fq6 M = 6
// Fq2 M; Fq12 M = 54, S = 36, a cyclotomic S = 9 Fq2 S = 18; a power to a
// fixed e at the floor of any addition chain: ceil(log2 e) steps, of which
// ceil(log2 popcount(e)) are products):
//   * subgroup check per affine point Q: [|x|]Q is an affine doubling
//     (13), 62 doublings (16) and 5 mixed additions (29); psi(Q) 5 (its
//     x constant is imaginary: 2); comparing it with the Jacobian [x]Q
//     takes Z^2, Z^3 and two products (11): 1,166.
//   * multi-pairing of m affine pairs: one shared accumulator, so the f^2
//     of each of 62 doubling steps (36) is paid once, not per pair; per
//     pair 63 doubling steps (25: 3 M, 6 S and 4 Fq products by x_P, y_P)
//     and 5 addition steps (41: 11 M, 2 S, 4) = 1,780; each of the 68m
//     lines (the first free) a sparse product of 13 Fq2 M = 39. Then one
//     final exponentiation: the easy part 594 (an Fq12 inverse 478: two
//     Fq6 squares, an Fq6 inverse 418 and two Fq6 products; a product, a
//     p^2-Frobenius 8 and a product) and the hard part 6,588 (powers by
//     (x-1)/3, x-1 and three times |x|: 319 steps, 17 of them products;
//     4 products, a p- and a p^2-Frobenius): 7,182. For m = 33: 155,631.
// chip_smoke.py turns these counts into a bound (BLS_FQ_MULS there).
#include "bls381_field.cuh"

#define LANES_PER_BLOCK 64

// Doubling step on the twist (pairing.py _dbl_step): T <- 2T, line at P.
DEV void miller_dbl_step(jac<fp2>& T, fp2& c0, fp2& c4, fp2& c5, const fp& xp, const fp& yp) {
  fp2 a, b, c, e, f3, g, h, i, j, e2, t, b2;
  fp2_mul(a, T.x, T.y); fp2_half(a, a);
  fp2_sqr(b, T.y);
  fp2_sqr(c, T.z);
  fp2_add(t, c, c); fp2_add(t, t, c); fp2_const(b2, BLS_B2); fp2_mul(e, b2, t);
  fp2_add(f3, e, e); fp2_add(f3, f3, e);
  fp2_add(g, b, f3); fp2_half(g, g);
  fp2_add(h, T.y, T.z); fp2_sqr(h, h); fp2_add(t, b, c); fp2_sub(h, h, t);
  fp2_sub(i, e, b);
  fp2_sqr(j, T.x);
  fp2_sqr(e2, e);
  fp2_sub(t, b, f3); fp2_mul(T.x, a, t);
  fp2_sqr(T.y, g); fp2_add(t, e2, e2); fp2_add(t, t, e2); fp2_sub(T.y, T.y, t);
  fp2_mul(T.z, b, h);
  fp2_neg(t, h); fp2_mul_fp(t, t, yp); fp2_mul_xi(c0, t);
  c4 = i;
  fp2_add(t, j, j); fp2_add(t, t, j); fp2_mul_fp(c5, t, xp);
}

// Mixed addition step T <- T + Q, line at P (pairing.py _add_step).
DEV void miller_add_step(jac<fp2>& T, fp2& c0, fp2& c4, fp2& c5,
                         const fp2& xq, const fp2& yq, const fp& xp, const fp& yp) {
  fp2 theta, lam, cc, dd, ee, ff, gg, hh, t, u;
  fp2_mul(t, yq, T.z); fp2_sub(theta, T.y, t);
  fp2_mul(t, xq, T.z); fp2_sub(lam, T.x, t);
  fp2_sqr(cc, theta);
  fp2_sqr(dd, lam);
  fp2_mul(ee, lam, dd);
  fp2_mul(ff, T.z, cc);
  fp2_mul(gg, T.x, dd);
  fp2_add(t, gg, gg); fp2_sub(hh, ee, t); fp2_add(hh, hh, ff);
  fp2_mul(T.x, lam, hh);
  fp2_sub(t, gg, hh); fp2_mul(t, theta, t); fp2_mul(u, ee, T.y); fp2_sub(T.y, t, u);
  fp2_mul(T.z, T.z, ee);
  fp2_mul(t, theta, xq); fp2_mul(u, lam, yq); fp2_sub(t, t, u); fp2_neg(c4, t);
  fp2_neg(t, lam); fp2_mul_fp(t, t, yp); fp2_mul_xi(c0, t);
  fp2_mul_fp(c5, theta, xp);
}

// f_{|x|,Q}(P), conjugated for x < 0 (pairing.py miller_loop)
DEVNI void miller_loop(fp12& f, const fp2& xq, const fp2& yq, const fp& xp, const fp& yp) {
  jac<fp2> T;
  T.x = xq; T.y = yq; fp2_one(T.z);
  fp12_one(f);
  fp2 c0, c4, c5;
  for (int i = 62; i >= 0; i--) {
    fp12_sqr(f, f);
    miller_dbl_step(T, c0, c4, c5, xp, yp);
    fp12_mul_by_045(f, c0, c4, c5);
    if ((BLS_X_ABS >> i) & 1) {
      miller_add_step(T, c0, c4, c5, xq, yq, xp, yp);
      fp12_mul_by_045(f, c0, c4, c5);
    }
  }
  fp12_conj(f, f);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// q [n, 2, 2, 12] affine, q_inf [n] -> ok [n]
__global__ void __launch_bounds__(LANES_PER_BLOCK)
subgroup_check_kernel(const long long* q, const unsigned char* q_inf, unsigned char* ok, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (q_inf[i]) { ok[i] = 1; return; }
  fp2 x, y;
  fp2_ld(x, q + i * 48);
  fp2_ld(y, q + i * 48 + 24);
  ok[i] = g2_in_subgroup(x, y) ? 1 : 0;
}

// p [m, 2, 12], q [m, 2, 2, 12] affine with infinity masks; scratch [m, 12, 12];
// out [12, 12] = final_exponentiation(prod over finite pairs of miller_loop)
__global__ void __launch_bounds__(LANES_PER_BLOCK)
multi_pairing_kernel(const long long* p, const unsigned char* p_inf, const long long* q,
                     const unsigned char* q_inf, long long* scratch, long long* out, int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (p_inf[i] || q_inf[i]) continue;
    fp xp, yp;
    fp2 xq, yq;
    fp_ld(xp, p + i * 24);
    fp_ld(yp, p + i * 24 + 12);
    fp2_ld(xq, q + i * 48);
    fp2_ld(yq, q + i * 48 + 24);
    fp12 f;
    miller_loop(f, xq, yq, xp, yp);
    fp12_st(scratch + i * 144, f);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  fp12 acc, f;
  fp12_one(acc);
  for (int i = 0; i < m; i++) {
    if (p_inf[i] || q_inf[i]) continue;
    fp12_ld(f, scratch + i * 144);
    fp12_mul(acc, acc, f);
  }
  final_exponentiation(f, acc);
  fp12_st(out, f);
}

extern "C" {

int bls_g2_subgroup_check(const long long* q, const unsigned char* q_inf, unsigned char* ok,
                          long long n, void* stream) {
  unsigned grid = (unsigned)((n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK);
  subgroup_check_kernel<<<grid, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(q, q_inf, ok, n);
  return (int)cudaGetLastError();
}

int bls_multi_pairing(const long long* p, const unsigned char* p_inf, const long long* q,
                      const unsigned char* q_inf, long long* scratch, long long* out, int m,
                      void* stream) {
  multi_pairing_kernel<<<1, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(p, p_inf, q, q_inf, scratch, out, m);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
