// BLS12-381 base field, tower and curve arithmetic for the port's kernels
// (csrc/bls381_g.cu, csrc/bls381_pairing.cu, csrc/bls381_htc.cu).
//
// Replaces the arithmetic layers of the JAX package's device BLS code:
//   * lighthouse_tpu/ops/bls381.py (K2): mont_mul (:161), mod_add/mod_sub
//     (:188/:193), pt_double/pt_add (:302/:319);
//   * lighthouse_tpu/ops/bls381_tower.py (K3): f2_* (:77-140), fq_inv
//     (:140); its f6_*/f12_* run as team rounds in csrc/bls381_pairing.cu;
//   * the line, cyclotomic and curve helpers of ops/bls381_pairing.py and
//     ops/bls381_htc.py (K5's maps and team rounds are its own, in
//     bls381_htc.cu), written after the host oracle
//     lighthouse_tpu_torch/crypto/bls12_381 (fields.py, curve.py,
//     pairing.py, hash_to_curve.py), so that every function here computes
//     the same field element as its host counterpart.
//
// Representation. Fq is 12 little-endian 32-bit limbs in Montgomery form
// with R = 2^384, the same R as the JAX package: a residue is the same
// integer in both packages (JAX holds it as 48 8-bit limbs). Every value
// is fully reduced into [0, p), so equal field elements have equal limbs,
// and the plain PyTorch versions (ops/bls381*.py) can be held to these
// kernels bit for bit. Tensors carry limbs in int64 (the port's public
// limb layout); loads truncate to 32 bits.
// Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-xi) with xi = 1+u,
// Fq12 = Fq6[w]/(w^2-v): an Fq12 is 12 Fq in the order [w][v][u].
// Points are Jacobian (X, Y, Z), affine (X/Z^2, Y/Z^3), infinity Z = 0.
//
// What bounds it on the card: 32-bit integer multiply-adds. A Montgomery
// multiplication (CIOS) is 2*12*12 + 12 = 300 32x32-bit products, each
// a low and a high half; nothing else here is costly. Integers only: no
// floating point touches a value (consensus determinism).
//
// The code is plain C++ for one thread: a lane's state lives in
// registers and local memory. The one-thread kernels run a thread per
// lane; the team kernels (g1_team.cuh, g2_team.cuh, K4's Fq12 rounds) use
// it for a lane's share of a round. The one Fq inverse, of K4's final
// exponentiation and K2's conversions to affine (which also make K9's
// table affine), is fp_inv_binary (mont_cs.cuh's binary extended Euclid).
// Outside nvcc (no __CUDACC__) the same functions compile as ordinary
// host C++.
#pragma once
#include <stdint.h>

#include "mont_cs.cuh"

#ifdef __CUDACC__
#define DEV __device__ __forceinline__
#define DEVNI __device__ __noinline__
#define CONSTMEM __constant__ const
#define UNROLL _Pragma("unroll")
#else
#define DEV static inline
#define DEVNI static
#define CONSTMEM static const
#define UNROLL
#endif

// ---------------------------------------------------------------------------
// Constants (derived from the host oracle; Montgomery form unless noted)
// ---------------------------------------------------------------------------

// p, -p^-1 mod 2^32
CONSTMEM uint32_t BLS_P[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
#define BLS_NINV 0xfffcfffdu
CONSTMEM uint32_t BLS_ONE[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// exponents (plain integers)
CONSTMEM uint32_t BLS_SQRT_EXP[12] = {0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au};
CONSTMEM uint32_t BLS_B2[2][12] = {{0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u}, {0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u}};
CONSTMEM uint32_t BLS_G6_1[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}};
CONSTMEM uint32_t BLS_G6_2[2][12] = {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}, {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}};
CONSTMEM uint32_t BLS_G12[2][12] = {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu, 0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu}, {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u, 0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}};
CONSTMEM uint32_t BLS_PSI_CX[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}};
CONSTMEM uint32_t BLS_PSI_CY[2][12] = {{0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu}, {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}};
CONSTMEM uint32_t BLS_SSWU_A[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x03135242u, 0xe53a0000u, 0xdef80285u, 0x01080c0fu, 0xe340f6bdu, 0xe7889edbu, 0x26310601u, 0x0b513751u, 0x17c744abu, 0x02d69857u, 0x79ea5467u, 0x1220b4e9u}};
CONSTMEM uint32_t BLS_SSWU_B[2][12] = {{0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu, 0x3db5a66eu, 0x6e1b9440u, 0xa79473bau, 0x75bf3c53u, 0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu}, {0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu, 0x3db5a66eu, 0x6e1b9440u, 0xa79473bau, 0x75bf3c53u, 0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu}};
CONSTMEM uint32_t BLS_SSWU_Z[2][12] = {{0xfff9555cu, 0x87ebffffu, 0xda8ffffau, 0x656fffe5u, 0x45d33ad2u, 0x0fd07493u, 0x066576f4u, 0xd951e663u, 0x41e980d3u, 0xde291a3du, 0x7dfe040du, 0x0815664cu}, {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u}};
CONSTMEM uint32_t BLS_SSWU_X0[2][12] = {{0xffec0014u, 0x97c3ffffu, 0x8fafffefu, 0x304fffb1u, 0xd179b077u, 0x2f715db9u, 0x133064dcu, 0x8bf5b329u, 0xc5bc827bu, 0x9a7b4eb7u, 0x79fa0c29u, 0x184032e5u}, {0x0013aa97u, 0x223b0000u, 0x21a40010u, 0xee5c004du, 0x253745acu, 0x37bf74e7u, 0xe054ade3u, 0xd881985bu, 0x7d8f2a5bu, 0xb0a058feu, 0xbf85da70u, 0x01c0df04u}};
CONSTMEM uint32_t BLS_SSWU_T[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x009d54b8u, 0x11d80000u, 0x0d200081u, 0x72e00269u, 0x29ba2d67u, 0xbdfba739u, 0x02a56f19u, 0xc40cc2dfu, 0xec7952deu, 0x8502c7f3u, 0xfc2ed385u, 0x0e06f825u}};
CONSTMEM uint32_t BLS_SSWU_U[2][12] = {{0x00345521u, 0xee9d0000u, 0x3f7c002au, 0x308400cdu, 0xb5790bd9u, 0xb70ed348u, 0xa763809du, 0x62d6af76u, 0xba96ffe7u, 0xf00a2538u, 0xbc8f935fu, 0x0d58035au}, {0x00345521u, 0xee9d0000u, 0x3f7c002au, 0x308400cdu, 0xb5790bd9u, 0xb70ed348u, 0xa763809du, 0x62d6af76u, 0xba96ffe7u, 0xf00a2538u, 0xbc8f935fu, 0x0d58035au}};
#define BLS_X_ABS 0xd201000000010000ull
#define BLS_M1 0x460055555555aaabull
#define BLS_M2 0xd201000000010001ull

// ---------------------------------------------------------------------------
// Types and limb I/O
// ---------------------------------------------------------------------------

struct fp { uint32_t v[12]; };
struct fp2 { fp c0, c1; };
struct fp6 { fp2 c0, c1, c2; };
struct fp12 { fp6 c0, c1; };
struct g1p { fp x, y, z; };   // Jacobian over Fq
struct g2p { fp2 x, y, z; };  // Jacobian over Fq2 (the twist E')

DEV void fp_ld(fp& a, const long long* s) {
  UNROLL for (int j = 0; j < 12; j++) a.v[j] = (uint32_t)s[j];
}
DEV void fp_st(long long* d, const fp& a) {
  UNROLL for (int j = 0; j < 12; j++) d[j] = (long long)a.v[j];
}
DEV void fp2_ld(fp2& a, const long long* s) { fp_ld(a.c0, s); fp_ld(a.c1, s + 12); }
DEV void fp2_st(long long* d, const fp2& a) { fp_st(d, a.c0); fp_st(d + 12, a.c1); }
DEV void fp_const(fp& a, const uint32_t* c) { UNROLL for (int j = 0; j < 12; j++) a.v[j] = c[j]; }
DEV void fp2_const(fp2& a, const uint32_t (*c)[12]) { fp_const(a.c0, c[0]); fp_const(a.c1, c[1]); }

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

DEV void fp_zero(fp& a) { UNROLL for (int j = 0; j < 12; j++) a.v[j] = 0; }
DEV void fp_one(fp& a) { fp_const(a, BLS_ONE); }
DEV bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
  UNROLL for (int j = 0; j < 12; j++) acc |= a.v[j];
  return acc == 0;
}
DEV bool fp_eq(const fp& a, const fp& b) {
  uint32_t acc = 0;
  UNROLL for (int j = 0; j < 12; j++) acc |= a.v[j] ^ b.v[j];
  return acc == 0;
}

// t in [0, 2p) -> t mod p
DEV void fp_reduce_once(fp& r, const uint32_t* t) {
  uint32_t s[12];
  long long br = 0;
  UNROLL for (int j = 0; j < 12; j++) {
    long long d = (long long)t[j] - (long long)BLS_P[j] + br;
    s[j] = (uint32_t)d;
    br = d >> 32;  // 0 or -1
  }
  bool lt = br < 0;  // t < p
  UNROLL for (int j = 0; j < 12; j++) r.v[j] = lt ? t[j] : s[j];
}

DEV void fp_add(fp& r, const fp& a, const fp& b) {
  uint32_t t[12];
  unsigned long long c = 0;
  UNROLL for (int j = 0; j < 12; j++) {
    c += (unsigned long long)a.v[j] + b.v[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, t);  // a + b < 2p < 2^382: no carry out
}

DEV void fp_sub(fp& r, const fp& a, const fp& b) {
  uint32_t t[12];
  long long br = 0;
  UNROLL for (int j = 0; j < 12; j++) {
    long long d = (long long)a.v[j] - (long long)b.v[j] + br;
    t[j] = (uint32_t)d;
    br = d >> 32;
  }
  if (br < 0) {  // a < b: add p back
    unsigned long long c = 0;
    UNROLL for (int j = 0; j < 12; j++) {
      c += (unsigned long long)t[j] + BLS_P[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  UNROLL for (int j = 0; j < 12; j++) r.v[j] = t[j];
}

DEV void fp_neg(fp& r, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

// a / 2 mod p: (a + p) / 2 for an odd a (a + p < 2^382: no carry out)
DEV void fp_half(fp& r, const fp& a) {
  uint32_t t[12];
  const uint32_t odd = a.v[0] & 1u;
  unsigned long long c = 0;
  UNROLL for (int j = 0; j < 12; j++) {
    c += (unsigned long long)a.v[j] + (odd ? BLS_P[j] : 0u);
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  UNROLL for (int j = 0; j < 11; j++) r.v[j] = (t[j] >> 1) | (t[j + 1] << 31);
  r.v[11] = t[11] >> 1;
}

// Montgomery product a*b*2^-384 mod p (CIOS, 32-bit words).
DEVNI void fp_mul(fp& r, const fp& a, const fp& b) {
  uint32_t t[14];
  UNROLL for (int j = 0; j < 14; j++) t[j] = 0;
  UNROLL for (int i = 0; i < 12; i++) {
    unsigned long long c = 0;
    UNROLL for (int j = 0; j < 12; j++) {
      unsigned long long s = (unsigned long long)t[j] + (unsigned long long)a.v[j] * b.v[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    unsigned long long s = (unsigned long long)t[12] + c;
    t[12] = (uint32_t)s;
    t[13] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * BLS_NINV;
    s = (unsigned long long)t[0] + (unsigned long long)m * BLS_P[0];
    c = s >> 32;
    UNROLL for (int j = 1; j < 12; j++) {
      s = (unsigned long long)t[j] + (unsigned long long)m * BLS_P[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (unsigned long long)t[12] + c;
    t[11] = (uint32_t)s;
    t[12] = t[13] + (uint32_t)(s >> 32);
  }
  fp_reduce_once(r, t);  // 4p < 2^384, so the result is < 2p and t[12] = 0
}

DEV void fp_sqr(fp& r, const fp& a) { fp_mul(r, a, a); }

// Two independent Montgomery products in one call: fp_mul's CIOS loops,
// interleaved, so the two dependent chains overlap (fp_mul is out of
// line: two calls run one after the other).
DEVNI void fp_mul2(fp& r1, const fp& a1, const fp& b1, fp& r2, const fp& a2, const fp& b2) {
  uint32_t t[14], u[14];
  UNROLL for (int j = 0; j < 14; j++) { t[j] = 0; u[j] = 0; }
  UNROLL for (int i = 0; i < 12; i++) {
    unsigned long long c = 0, d = 0;
    UNROLL for (int j = 0; j < 12; j++) {
      unsigned long long s = (unsigned long long)t[j] + (unsigned long long)a1.v[j] * b1.v[i] + c;
      unsigned long long q = (unsigned long long)u[j] + (unsigned long long)a2.v[j] * b2.v[i] + d;
      t[j] = (uint32_t)s; c = s >> 32;
      u[j] = (uint32_t)q; d = q >> 32;
    }
    unsigned long long s = (unsigned long long)t[12] + c, q = (unsigned long long)u[12] + d;
    t[12] = (uint32_t)s; t[13] = (uint32_t)(s >> 32);
    u[12] = (uint32_t)q; u[13] = (uint32_t)(q >> 32);
    const uint32_t m = t[0] * BLS_NINV, mu = u[0] * BLS_NINV;
    s = (unsigned long long)t[0] + (unsigned long long)m * BLS_P[0]; c = s >> 32;
    q = (unsigned long long)u[0] + (unsigned long long)mu * BLS_P[0]; d = q >> 32;
    UNROLL for (int j = 1; j < 12; j++) {
      s = (unsigned long long)t[j] + (unsigned long long)m * BLS_P[j] + c;
      q = (unsigned long long)u[j] + (unsigned long long)mu * BLS_P[j] + d;
      t[j - 1] = (uint32_t)s; c = s >> 32;
      u[j - 1] = (uint32_t)q; d = q >> 32;
    }
    s = (unsigned long long)t[12] + c; q = (unsigned long long)u[12] + d;
    t[11] = (uint32_t)s; t[12] = t[13] + (uint32_t)(s >> 32);
    u[11] = (uint32_t)q; u[12] = u[13] + (uint32_t)(q >> 32);
  }
  fp_reduce_once(r1, t);
  fp_reduce_once(r2, u);
}

// R^3 mod p, mont_inv_binary's last factor
CONSTMEM uint32_t BLS_R3[12] = {0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
                                0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

// a^-1 R for a Montgomery a = a R by the binary extended Euclidean
// algorithm (mont_cs.cuh; variable time: the kernels invert public values),
// 0 -> 0: at most 2 * 381 short steps of shifts and subtractions, against
// Fermat's a^(p-2), 381 squarings and ~190 products in one dependent chain.
// K4's final exponentiation and K2's batch conversion to affine run it.
DEV void fp_inv_binary(fp& r, const fp& a) {
  fp r3;
  fp_const(r3, BLS_R3);
  mont_inv_binary<12>(r.v, a.v, BLS_P, BLS_NINV, r3.v);
}

// ---------------------------------------------------------------------------
// Fq2 (u^2 = -1)
// ---------------------------------------------------------------------------

DEV void fp2_zero(fp2& a) { fp_zero(a.c0); fp_zero(a.c1); }
DEV void fp2_one(fp2& a) { fp_one(a.c0); fp_zero(a.c1); }
DEV bool fp2_is_zero(const fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }
DEV bool fp2_eq(const fp2& a, const fp2& b) { return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1); }
DEV void fp2_add(fp2& r, const fp2& a, const fp2& b) { fp_add(r.c0, a.c0, b.c0); fp_add(r.c1, a.c1, b.c1); }
DEV void fp2_sub(fp2& r, const fp2& a, const fp2& b) { fp_sub(r.c0, a.c0, b.c0); fp_sub(r.c1, a.c1, b.c1); }
DEV void fp2_neg(fp2& r, const fp2& a) { fp_neg(r.c0, a.c0); fp_neg(r.c1, a.c1); }
DEV void fp2_conj(fp2& r, const fp2& a) { r.c0 = a.c0; fp_neg(r.c1, a.c1); }
DEV void fp2_dbl(fp2& r, const fp2& a) { fp2_add(r, a, a); }

DEVNI void fp2_mul(fp2& r, const fp2& a, const fp2& b) {
  fp t0, t1, sa, sb, x;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(x, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(x, x, t0);
  fp_sub(r.c1, x, t1);
}

DEVNI void fp2_sqr(fp2& r, const fp2& a) {
  fp s, d, t;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(t, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_add(r.c1, t, t);
}

// xi * a = (c0 - c1) + (c0 + c1) u
DEV void fp2_mul_xi(fp2& r, const fp2& a) {
  fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

// ---------------------------------------------------------------------------
// Jacobian points over Fq and Fq2 (curve.py pt_double / pt_add)
// ---------------------------------------------------------------------------

DEV void f_add(fp& r, const fp& a, const fp& b) { fp_add(r, a, b); }
DEV void f_add(fp2& r, const fp2& a, const fp2& b) { fp2_add(r, a, b); }
DEV void f_sub(fp& r, const fp& a, const fp& b) { fp_sub(r, a, b); }
DEV void f_sub(fp2& r, const fp2& a, const fp2& b) { fp2_sub(r, a, b); }
DEV void f_mul(fp& r, const fp& a, const fp& b) { fp_mul(r, a, b); }
DEV void f_mul(fp2& r, const fp2& a, const fp2& b) { fp2_mul(r, a, b); }
DEV void f_sqr(fp& r, const fp& a) { fp_sqr(r, a); }
DEV void f_sqr(fp2& r, const fp2& a) { fp2_sqr(r, a); }
DEV bool f_is_zero(const fp& a) { return fp_is_zero(a); }
DEV bool f_is_zero(const fp2& a) { return fp2_is_zero(a); }
DEV bool f_eq(const fp& a, const fp& b) { return fp_eq(a, b); }
DEV bool f_eq(const fp2& a, const fp2& b) { return fp2_eq(a, b); }
DEV void f_one(fp& a) { fp_one(a); }
DEV void f_one(fp2& a) { fp2_one(a); }
DEV void f_zero(fp& a) { fp_zero(a); }
DEV void f_zero(fp2& a) { fp2_zero(a); }
DEV void f_neg(fp& r, const fp& a) { fp_neg(r, a); }
DEV void f_neg(fp2& r, const fp2& a) { fp2_neg(r, a); }

template <class F> struct jac { F x, y, z; };

// The canonical infinity (1, 1, 0), as the host oracle's inf().
template <class F> DEV void pt_inf(jac<F>& p) { f_one(p.x); f_one(p.y); f_zero(p.z); }

// 2P, a = 0 curve formulas (curve.py pt_double). An infinity in (Z = 0)
// gives an infinity out (Z3 = 2YZ = 0).
template <class F> DEVNI void pt_double(jac<F>& r, const jac<F>& p) {
  F a, b, c, d, e, f, t, x3;
  f_sqr(a, p.x);
  f_sqr(b, p.y);
  f_sqr(c, b);
  f_add(t, p.x, b); f_sqr(t, t); f_sub(t, t, a); f_sub(d, t, c); f_add(d, d, d);
  f_add(e, a, a); f_add(e, e, a);
  f_sqr(f, e);
  f_add(t, d, d); f_sub(x3, f, t);
  f_add(c, c, c); f_add(c, c, c); f_add(c, c, c);           // 8C
  f_sub(t, d, x3); f_mul(t, e, t);
  F z3;
  f_add(z3, p.y, p.y); f_mul(r.z, z3, p.z);
  f_sub(r.y, t, c);
  r.x = x3;
}

// P + Q with every case of curve.py pt_add: an infinity operand passes the
// other through, P == Q doubles, P == -Q gives the canonical infinity.
template <class F> DEVNI void pt_add(jac<F>& r, const jac<F>& p, const jac<F>& q) {
  if (f_is_zero(p.z)) { r = q; return; }
  if (f_is_zero(q.z)) { r = p; return; }
  F z1z1, z2z2, u1, u2, s1, s2, t;
  f_sqr(z1z1, p.z);
  f_sqr(z2z2, q.z);
  f_mul(u1, p.x, z2z2);
  f_mul(u2, q.x, z1z1);
  f_mul(t, z2z2, q.z); f_mul(s1, p.y, t);
  f_mul(t, z1z1, p.z); f_mul(s2, q.y, t);
  if (f_eq(u1, u2)) {
    if (f_eq(s1, s2)) pt_double(r, p); else pt_inf(r);
    return;
  }
  F h, i, j, rr, v, x3, y3, z3;
  f_sub(h, u2, u1);
  f_add(i, h, h); f_sqr(i, i);
  f_mul(j, h, i);
  f_sub(rr, s2, s1); f_add(rr, rr, rr);
  f_mul(v, u1, i);
  f_sqr(x3, rr); f_sub(x3, x3, j); f_add(t, v, v); f_sub(x3, x3, t);
  f_sub(t, v, x3); f_mul(y3, rr, t); f_mul(t, s1, j); f_add(t, t, t); f_sub(y3, y3, t);
  f_mul(z3, p.z, q.z); f_mul(z3, z3, h); f_add(z3, z3, z3);
  r.x = x3; r.y = y3; r.z = z3;
}

template <class F> DEV void pt_neg(jac<F>& r, const jac<F>& p) { r.x = p.x; f_neg(r.y, p.y); r.z = p.z; }

// [k]P for a 64-bit k, left to right over all 64 bits from the canonical
// infinity (bits are public: the batch verifier's random scalars).
template <class F> DEVNI void pt_mul_u64(jac<F>& r, const jac<F>& p, unsigned long long k) {
  jac<F> acc;
  pt_inf(acc);
  for (int i = 63; i >= 0; i--) {
    pt_double(acc, acc);
    if ((k >> i) & 1) pt_add(acc, acc, p);
  }
  r = acc;
}

// ---------------------------------------------------------------------------
// Point I/O: G1 coordinates are [12] limbs, G2 coordinates [2][12]; a
// Jacobian point is [3][...] (x, y, z), an affine one [2][...] (x, y)
// ---------------------------------------------------------------------------

DEV void f_ld(fp& a, const long long* s) { fp_ld(a, s); }
DEV void f_ld(fp2& a, const long long* s) { fp2_ld(a, s); }
DEV void f_st(long long* d, const fp& a) { fp_st(d, a); }
DEV void f_st(long long* d, const fp2& a) { fp2_st(d, a); }

// limbs of one coordinate: 12 for Fq, 24 for Fq2
template <class F> struct limbs { static const int n = (int)(sizeof(F) / 4); };

template <class F> DEV void pt_ld(jac<F>& p, const long long* s) {
  const int w = limbs<F>::n;
  f_ld(p.x, s); f_ld(p.y, s + w); f_ld(p.z, s + 2 * w);
}
template <class F> DEV void pt_st(long long* d, const jac<F>& p) {
  const int w = limbs<F>::n;
  f_st(d, p.x); f_st(d + w, p.y); f_st(d + 2 * w, p.z);
}
