// K5 launch: RFC 9380 hash-to-G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_) from
// field elements, one thread per message.
//
// Replaces, in the JAX package (lighthouse_tpu/ops/bls381_htc.py), :311
// hash_to_g2_device with :267 map_to_curve_sswu_device (and :169
// f2_sqrt_device, :215 f2_sgn0_device), :295 isogeny_to_e2_device, the
// pair add, and the cofactor clearing of bls381_pairing.py:440. The host
// keeps expand_message_xmd (messages_to_field_device, :329), as in JAX.
//
// Each step follows the host oracle (crypto/bls12_381/hash_to_curve.py and
// fields.py f2_sqrt), branching per lane where the oracle branches: SSWU
// onto the 3-isogenous curve E' with the complex-method Fq2 square root,
// the Velu-derived 3-isogeny to E2, the Jacobian sum of the two points,
// then [h_eff] by Budroni-Pintore (two |x|-ladders and three psi).
//
// What bounds it: 32-bit multiply-adds. The bound counts the least Fq
// multiplications per message from the cheapest known way to compute the
// function, whatever this kernel does (which follows the oracle, with
// inversions): SSWU and the isogeny in Jacobian form need no inversion,
// and a power to a fixed e is counted at the floor of any addition chain,
// ceil(log2 e) steps (379 for (p-3)/4).
//   * per SSWU map (two per message): u^2, tv1^2, tv3^2, tv4^2 (8), g(x)'s
//     numerator and denominator and the radicand g_n * x_d (9), X and Y
//     (6); the root of the radicand by the complex method without an
//     inverse: its norm (2), two Fq powers by (p-3)/4 (758) and 4
//     products: 787. (The non-square branch adds a few products; the
//     count takes the square one. RFC 9380's sqrt_ratio, one Fq2 power of
//     757 steps, would be at least 1,514.)
//   * the sum of the two points on E' (43), then one isogeny, since it is
//     a homomorphism (32 Fq2 products and 3 squares: 102).
//   * cofactor clearing (RFC 9380 G.3): two |x|-ladders on Jacobian points
//     (63 doublings, 16, and 5 additions, 43: 1,223 each), a doubling, 5
//     additions, psi (5) and psi^2 (2): 2,684.
//   4,403 per message (BLS_FQ_MULS in chip_smoke.py).
#include "bls381_field.cuh"

#define LANES_PER_BLOCK 64

// g(x) = x^3 + A x + B on E'
DEV void sswu_gx(fp2& g, const fp2& x) {
  fp2 t, a;
  fp2_sqr(t, x);
  fp2_mul(t, t, x);
  fp2_const(a, BLS_SSWU_A);
  fp2_mul(a, a, x);
  fp2_add(t, t, a);
  fp2_const(a, BLS_SSWU_B);
  fp2_add(g, t, a);
}

// simplified SWU onto E' (hash_to_curve.py map_to_curve_sswu)
DEVNI void map_to_curve_sswu(fp2& x, fp2& y, const fp2& u) {
  fp2 z_u2, tv, x1, gx1, t;
  fp2_sqr(t, u);
  fp2_const(z_u2, BLS_SSWU_Z);
  fp2_mul(z_u2, z_u2, t);
  fp2_sqr(tv, z_u2);
  fp2_add(tv, tv, z_u2);
  if (fp2_is_zero(tv)) {
    fp2_const(x1, BLS_SSWU_B_OVER_ZA);
  } else {
    fp2_inv(t, tv);
    fp2 one;
    fp2_one(one);
    fp2_add(t, one, t);
    fp2_const(x1, BLS_SSWU_MINUS_B_OVER_A);
    fp2_mul(x1, x1, t);
  }
  sswu_gx(gx1, x1);
  if (fp2_sqrt(y, gx1)) {
    x = x1;
  } else {
    fp2 gx2;
    fp2_mul(x, z_u2, x1);
    sswu_gx(gx2, x);
    fp2_sqrt(y, gx2);  // SSWU: gx2 is square whenever gx1 is not
  }
  if (fp2_sgn0(u) != fp2_sgn0(y)) fp2_neg(y, y);
}

// 3-isogeny E' -> E2 (hash_to_curve.py _isogeny_to_e2)
DEVNI void isogeny_to_e2(fp2& px, fp2& py, const fp2& x, const fp2& y) {
  fp2 d, di, di2, di3, t, c;
  fp2_const(c, BLS_SSWU_X0);
  fp2_sub(d, x, c);
  fp2_inv(di, d);
  fp2_sqr(di2, di);
  fp2_mul(di3, di2, di);
  fp2 phx;
  fp2_const(c, BLS_SSWU_T); fp2_mul(t, c, di); fp2_add(phx, x, t);
  fp2_const(c, BLS_SSWU_U); fp2_mul(t, c, di2); fp2_add(phx, phx, t);
  fp2_const(c, BLS_SSWU_INV9); fp2_mul(phx, phx, c);
  fp2 deriv;
  fp2_one(deriv);
  fp2_const(c, BLS_SSWU_T); fp2_mul(t, c, di2); fp2_sub(deriv, deriv, t);
  fp2_const(c, BLS_SSWU_U); fp2_add(c, c, c); fp2_mul(t, c, di3); fp2_sub(deriv, deriv, t);
  fp2_mul(t, y, deriv);
  fp2_const(c, BLS_SSWU_INV27); fp2_mul(t, t, c);
  fp2_neg(py, t);
  px = phx;
}

// u0, u1 (Montgomery Fq2) -> Jacobian point of G2 (hash_to_curve.py hash_to_g2)
DEVNI void hash_to_g2(jac<fp2>& r, const fp2& u0, const fp2& u1) {
  jac<fp2> q0, q1, s;
  fp2 x, y;
  map_to_curve_sswu(x, y, u0);
  isogeny_to_e2(q0.x, q0.y, x, y);
  fp2_one(q0.z);
  map_to_curve_sswu(x, y, u1);
  isogeny_to_e2(q1.x, q1.y, x, y);
  fp2_one(q1.z);
  pt_add(s, q0, q1);
  g2_clear_cofactor(r, s);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// u [m, 2, 2, 12] -> out [m, 3, 2, 12]
__global__ void __launch_bounds__(LANES_PER_BLOCK)
hash_to_g2_kernel(const long long* u, long long* out, long long m) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  fp2 u0, u1;
  fp2_ld(u0, u + i * 48);
  fp2_ld(u1, u + i * 48 + 24);
  jac<fp2> r;
  hash_to_g2(r, u0, u1);
  pt_st(out + i * 72, r);
}

extern "C" int bls_hash_to_g2(const long long* u, long long* out, long long m, void* stream) {
  unsigned grid = (unsigned)((m + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK);
  hash_to_g2_kernel<<<grid, LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(u, out, m);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
