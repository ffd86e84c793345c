// BLS12-381 base field, tower and curve arithmetic for the port's kernels
// (csrc/bls381_g.cu, csrc/bls381_pairing.cu, csrc/bls381_htc.cu).
//
// Replaces the arithmetic layers of the JAX package's device BLS code:
//   * lighthouse_tpu/ops/bls381.py (K2): mont_mul (:161), mod_add/mod_sub
//     (:188/:193), pt_double/pt_add (:302/:319);
//   * lighthouse_tpu/ops/bls381_tower.py (K3): f2_*/f6_*/f12_* (:77-347),
//     fq_inv (:140), f12_frob/frob2;
//   * the line, cyclotomic and curve helpers of ops/bls381_pairing.py and
//     ops/bls381_htc.py, written after the host oracle
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
// registers and local memory, and kernels run one thread per lane.
// Outside nvcc (no __CUDACC__) the same functions compile as ordinary
// host C++.
#pragma once
#include <stdint.h>

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
CONSTMEM uint32_t BLS_P_MINUS_2[12] = {0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
CONSTMEM uint32_t BLS_SQRT_EXP[12] = {0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au};
CONSTMEM uint32_t BLS_INV2[12] = {0x00015554u, 0x18040000u, 0x3ab00001u, 0x85500005u, 0x253c276fu, 0x633cb57cu, 0x31ebb502u, 0x6e22d1ecu, 0xf2d14ca2u, 0xd3916126u, 0x1a006596u, 0x17fbb857u};
CONSTMEM uint32_t BLS_B2[2][12] = {{0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u}, {0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au, 0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u}};
CONSTMEM uint32_t BLS_G6_1[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}};
CONSTMEM uint32_t BLS_G6_2[2][12] = {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}, {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}};
CONSTMEM uint32_t BLS_G12[2][12] = {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu, 0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu}, {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u, 0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}};
CONSTMEM uint32_t BLS_PSI_CX[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}};
CONSTMEM uint32_t BLS_PSI_CY[2][12] = {{0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu}, {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}};
CONSTMEM uint32_t BLS_SSWU_A[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x03135242u, 0xe53a0000u, 0xdef80285u, 0x01080c0fu, 0xe340f6bdu, 0xe7889edbu, 0x26310601u, 0x0b513751u, 0x17c744abu, 0x02d69857u, 0x79ea5467u, 0x1220b4e9u}};
CONSTMEM uint32_t BLS_SSWU_B[2][12] = {{0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu, 0x3db5a66eu, 0x6e1b9440u, 0xa79473bau, 0x75bf3c53u, 0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu}, {0x0cf89db2u, 0x22ea0000u, 0x71380aa4u, 0x6ec832dfu, 0x3db5a66eu, 0x6e1b9440u, 0xa79473bau, 0x75bf3c53u, 0x412c0a34u, 0x3dd3a569u, 0x74dc4fd1u, 0x125cdb5eu}};
CONSTMEM uint32_t BLS_SSWU_Z[2][12] = {{0xfff9555cu, 0x87ebffffu, 0xda8ffffau, 0x656fffe5u, 0x45d33ad2u, 0x0fd07493u, 0x066576f4u, 0xd951e663u, 0x41e980d3u, 0xde291a3du, 0x7dfe040du, 0x0815664cu}, {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u}};
CONSTMEM uint32_t BLS_SSWU_MINUS_B_OVER_A[2][12] = {{0x55474fb3u, 0x903c5555u, 0xce451105u, 0x5f98cc95u, 0xefe0fadeu, 0x9f8e582eu, 0xaebbd062u, 0xc68946b6u, 0x0ee6de53u, 0x467a4ad1u, 0x83e23a05u, 0x0e7146f4u}, {0xaab85af8u, 0x29c2aaaau, 0xe30eeefau, 0xbf133368u, 0x06cffb45u, 0xc7a27a72u, 0x44c9425cu, 0x9dee04ceu, 0x3464ce83u, 0x04a15ce5u, 0xb59dac95u, 0x0b8fcaf5u}};
CONSTMEM uint32_t BLS_SSWU_B_OVER_ZA[2][12] = {{0x44414324u, 0xf2d84444u, 0x93a69d00u, 0x2585c283u, 0x5d972c42u, 0x5dd35cd0u, 0x4ea89b53u, 0xfd963b74u, 0x91c1fa91u, 0x07f5d9fdu, 0x3ce062c4u, 0x127db28au}, {0x333b3695u, 0x55743333u, 0x590828fcu, 0xeb72b871u, 0xcb4d5da5u, 0x1c186171u, 0xee956644u, 0x34a33031u, 0x149d16d0u, 0xc971692au, 0xf5de8b82u, 0x168a1e1fu}};
CONSTMEM uint32_t BLS_SSWU_X0[2][12] = {{0xffec0014u, 0x97c3ffffu, 0x8fafffefu, 0x304fffb1u, 0xd179b077u, 0x2f715db9u, 0x133064dcu, 0x8bf5b329u, 0xc5bc827bu, 0x9a7b4eb7u, 0x79fa0c29u, 0x184032e5u}, {0x0013aa97u, 0x223b0000u, 0x21a40010u, 0xee5c004du, 0x253745acu, 0x37bf74e7u, 0xe054ade3u, 0xd881985bu, 0x7d8f2a5bu, 0xb0a058feu, 0xbf85da70u, 0x01c0df04u}};
CONSTMEM uint32_t BLS_SSWU_T[2][12] = {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}, {0x009d54b8u, 0x11d80000u, 0x0d200081u, 0x72e00269u, 0x29ba2d67u, 0xbdfba739u, 0x02a56f19u, 0xc40cc2dfu, 0xec7952deu, 0x8502c7f3u, 0xfc2ed385u, 0x0e06f825u}};
CONSTMEM uint32_t BLS_SSWU_U[2][12] = {{0x00345521u, 0xee9d0000u, 0x3f7c002au, 0x308400cdu, 0xb5790bd9u, 0xb70ed348u, 0xa763809du, 0x62d6af76u, 0xba96ffe7u, 0xf00a2538u, 0xbc8f935fu, 0x0d58035au}, {0x00345521u, 0xee9d0000u, 0x3f7c002au, 0x308400cdu, 0xb5790bd9u, 0xb70ed348u, 0xa763809du, 0x62d6af76u, 0xba96ffe7u, 0xf00a2538u, 0xbc8f935fu, 0x0d58035au}};
CONSTMEM uint32_t BLS_SSWU_INV9[2][12] = {{0x71c725edu, 0x40aac71cu, 0x7a84e38eu, 0x19095555u, 0x8f41abc3u, 0xd817050au, 0xc87f6fb1u, 0xd86485d4u, 0xf885d059u, 0x696eb479u, 0x328002d2u, 0x198e1a74u}, {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}};
CONSTMEM uint32_t BLS_SSWU_INV27[2][12] = {{0xd097b74fu, 0x158e425eu, 0x7e2c4bdau, 0x5dadc71cu, 0x2fc08e96u, 0x9d5d01aeu, 0x982a7a90u, 0x482181f1u, 0x52d74573u, 0x2324e6d3u, 0x10d55646u, 0x0884b37cu}, {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}};
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

// a^e for a plain-integer exponent e of `nbits` bits (12 words).
DEVNI void fp_pow(fp& r, const fp& a, const uint32_t* e, int nbits) {
  fp acc;
  fp_one(acc);
  for (int i = nbits - 1; i >= 0; i--) {
    fp_sqr(acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1) fp_mul(acc, acc, a);
  }
  r = acc;
}

DEV void fp_inv(fp& r, const fp& a) { fp_pow(r, a, BLS_P_MINUS_2, 381); }  // 0 -> 0

// canonical (non-Montgomery) value
DEV void fp_from_mont(fp& r, const fp& a) {
  fp one;
  fp_zero(one);
  one.v[0] = 1;
  fp_mul(r, a, one);
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
DEV void fp2_mul_fp(fp2& r, const fp2& a, const fp& s) { fp_mul(r.c0, a.c0, s); fp_mul(r.c1, a.c1, s); }

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

DEV void fp2_half(fp2& r, const fp2& a) {
  fp h;
  fp_const(h, BLS_INV2);
  fp2_mul_fp(r, a, h);
}

DEVNI void fp2_inv(fp2& r, const fp2& a) {
  fp n, t;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  fp_inv(n, n);
  fp_mul(r.c0, a.c0, n);
  fp_mul(t, a.c1, n);
  fp_neg(r.c1, t);
}

// RFC 9380 sgn0 for m = 2, on canonical values
DEV int fp2_sgn0(const fp2& a) {
  fp c0, c1;
  fp_from_mont(c0, a.c0);
  fp_from_mont(c1, a.c1);
  int s0 = c0.v[0] & 1, z0 = fp_is_zero(c0), s1 = c1.v[0] & 1;
  return s0 | (z0 & s1);
}

// Square root in Fq2 (p = 3 mod 4), the complex method of the host oracle
// (fields.py f2_sqrt). Returns false if `a` is not a square.
DEVNI bool fp2_sqrt(fp2& r, const fp2& a) {
  if (fp2_is_zero(a)) { fp2_zero(r); return true; }
  fp s, t;
  if (fp_is_zero(a.c1)) {
    fp_pow(s, a.c0, BLS_SQRT_EXP, 379);
    fp_sqr(t, s);
    if (fp_eq(t, a.c0)) { r.c0 = s; fp_zero(r.c1); return true; }
    fp nx;
    fp_neg(nx, a.c0);
    fp_pow(s, nx, BLS_SQRT_EXP, 379);
    fp_sqr(t, s);
    if (fp_eq(t, nx)) { fp_zero(r.c0); r.c1 = s; return true; }
    return false;
  }
  fp norm, n;
  fp_sqr(norm, a.c0);
  fp_sqr(t, a.c1);
  fp_add(norm, norm, t);
  fp_pow(n, norm, BLS_SQRT_EXP, 379);
  fp_sqr(t, n);
  if (!fp_eq(t, norm)) return false;
  fp inv2;
  fp_const(inv2, BLS_INV2);
  for (int k = 0; k < 2; k++) {
    fp half;
    if (k == 0) fp_add(half, a.c0, n); else fp_sub(half, a.c0, n);
    fp_mul(half, half, inv2);
    fp_pow(s, half, BLS_SQRT_EXP, 379);
    fp_sqr(t, s);
    if (fp_eq(t, half) && !fp_is_zero(s)) {
      fp2 root;
      fp two_t;
      fp_add(two_t, s, s);
      fp_inv(two_t, two_t);
      root.c0 = s;
      fp_mul(root.c1, a.c1, two_t);
      fp2 sq;
      fp2_sqr(sq, root);
      if (fp2_eq(sq, a)) { r = root; return true; }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// Fq6 (v^3 = xi) and Fq12 (w^2 = v), after fields.py
// ---------------------------------------------------------------------------

DEV void fp6_add(fp6& r, const fp6& a, const fp6& b) {
  fp2_add(r.c0, a.c0, b.c0); fp2_add(r.c1, a.c1, b.c1); fp2_add(r.c2, a.c2, b.c2);
}
DEV void fp6_sub(fp6& r, const fp6& a, const fp6& b) {
  fp2_sub(r.c0, a.c0, b.c0); fp2_sub(r.c1, a.c1, b.c1); fp2_sub(r.c2, a.c2, b.c2);
}
DEV void fp6_neg(fp6& r, const fp6& a) { fp2_neg(r.c0, a.c0); fp2_neg(r.c1, a.c1); fp2_neg(r.c2, a.c2); }
DEV void fp6_mul_by_v(fp6& r, const fp6& a) {
  fp2 t;
  fp2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

DEVNI void fp6_mul(fp6& r, const fp6& a, const fp6& b) {
  fp2 t0, t1, t2, x, y, s;
  fp2_mul(t0, a.c0, b.c0);
  fp2_mul(t1, a.c1, b.c1);
  fp2_mul(t2, a.c2, b.c2);
  fp6 o;
  // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
  fp2_add(x, a.c1, a.c2); fp2_add(y, b.c1, b.c2); fp2_mul(x, x, y);
  fp2_add(s, t1, t2); fp2_sub(x, x, s); fp2_mul_xi(x, x); fp2_add(o.c0, t0, x);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
  fp2_add(x, a.c0, a.c1); fp2_add(y, b.c0, b.c1); fp2_mul(x, x, y);
  fp2_add(s, t0, t1); fp2_sub(x, x, s); fp2_mul_xi(y, t2); fp2_add(o.c1, x, y);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  fp2_add(x, a.c0, a.c2); fp2_add(y, b.c0, b.c2); fp2_mul(x, x, y);
  fp2_add(s, t0, t2); fp2_sub(x, x, s); fp2_add(o.c2, x, t1);
  r = o;
}

DEVNI void fp6_inv(fp6& r, const fp6& a) {
  fp2 c0, c1, c2, t, u;
  fp2_sqr(c0, a.c0); fp2_mul(t, a.c1, a.c2); fp2_mul_xi(t, t); fp2_sub(c0, c0, t);
  fp2_sqr(c1, a.c2); fp2_mul_xi(c1, c1); fp2_mul(t, a.c0, a.c1); fp2_sub(c1, c1, t);
  fp2_sqr(c2, a.c1); fp2_mul(t, a.c0, a.c2); fp2_sub(c2, c2, t);
  fp2 d;
  fp2_mul(t, a.c2, c1); fp2_mul(u, a.c1, c2); fp2_add(t, t, u); fp2_mul_xi(t, t);
  fp2_mul(d, a.c0, c0); fp2_add(d, d, t);
  fp2_inv(d, d);
  fp2_mul(r.c0, c0, d); fp2_mul(r.c1, c1, d); fp2_mul(r.c2, c2, d);
}

DEV void fp12_one(fp12& a) {
  fp2_one(a.c0.c0); fp2_zero(a.c0.c1); fp2_zero(a.c0.c2);
  fp2_zero(a.c1.c0); fp2_zero(a.c1.c1); fp2_zero(a.c1.c2);
}
DEV bool fp12_is_one(const fp12& a) {
  fp12 one;
  fp12_one(one);
  return fp2_eq(a.c0.c0, one.c0.c0) && fp2_is_zero(a.c0.c1) && fp2_is_zero(a.c0.c2) &&
         fp2_is_zero(a.c1.c0) && fp2_is_zero(a.c1.c1) && fp2_is_zero(a.c1.c2);
}
DEV void fp12_conj(fp12& r, const fp12& a) { r.c0 = a.c0; fp6_neg(r.c1, a.c1); }

DEV void fp12_ld(fp12& a, const long long* s) {
  fp2* c[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int k = 0; k < 6; k++) fp2_ld(*c[k], s + 24 * k);
}
DEV void fp12_st(long long* d, const fp12& a) {
  const fp2* c[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int k = 0; k < 6; k++) fp2_st(d + 24 * k, *c[k]);
}

DEVNI void fp12_mul(fp12& r, const fp12& a, const fp12& b) {
  fp6 t0, t1, x, y;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_add(y, b.c0, b.c1);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t0);
  fp6_sub(r.c1, x, t1);
  fp6_mul_by_v(t1, t1);
  fp6_add(r.c0, t0, t1);
}

DEVNI void fp12_sqr(fp12& r, const fp12& a) {
  fp6 t, x, y;
  fp6_mul(t, a.c0, a.c1);
  fp6_add(x, a.c0, a.c1);
  fp6_mul_by_v(y, a.c1);
  fp6_add(y, a.c0, y);
  fp6_mul(x, x, y);
  fp6_sub(x, x, t);
  fp6_mul_by_v(y, t);
  fp6_sub(r.c0, x, y);
  fp6_add(r.c1, t, t);
}

DEVNI void fp12_inv(fp12& r, const fp12& a) {
  fp6 t, u;
  fp6_mul(t, a.c0, a.c0);
  fp6_mul(u, a.c1, a.c1);
  fp6_mul_by_v(u, u);
  fp6_sub(t, t, u);
  fp6_inv(t, t);
  fp6_mul(r.c0, a.c0, t);
  fp6_mul(u, a.c1, t);
  fp6_neg(r.c1, u);
}

DEV void fp6_frob(fp6& r, const fp6& a) {
  fp2 g;
  fp2_conj(r.c0, a.c0);
  fp2_conj(r.c1, a.c1); fp2_const(g, BLS_G6_1); fp2_mul(r.c1, r.c1, g);
  fp2_conj(r.c2, a.c2); fp2_const(g, BLS_G6_2); fp2_mul(r.c2, r.c2, g);
}

DEVNI void fp12_frob(fp12& r, const fp12& a) {
  fp2 g;
  fp6_frob(r.c0, a.c0);
  fp6_frob(r.c1, a.c1);
  fp2_const(g, BLS_G12);
  fp2_mul(r.c1.c0, r.c1.c0, g);
  fp2_mul(r.c1.c1, r.c1.c1, g);
  fp2_mul(r.c1.c2, r.c1.c2, g);
}

// f * (c0 + c4*vw + c5*v^2 w), the sparse Miller-loop line (fields.py
// f12_mul_by_045)
DEV void sparse_l1(fp6& r, const fp2& x0, const fp2& x1, const fp2& x2,
                   const fp2& c4, const fp2& c5, const fp2& c45) {
  fp2 m1, m2, mx, t;
  fp2_mul(m1, x1, c4);
  fp2_mul(m2, x2, c5);
  fp2_add(t, x1, x2);
  fp2_mul(mx, t, c45);
  fp2_sub(mx, mx, m1);
  fp2_sub(mx, mx, m2);
  fp2_mul_xi(r.c0, mx);
  fp2_mul(t, x0, c4); fp2_mul_xi(mx, m2); fp2_add(r.c1, t, mx);
  fp2_mul(t, x0, c5); fp2_add(r.c2, t, m1);
}

DEVNI void fp12_mul_by_045(fp12& f, const fp2& c0, const fp2& c4, const fp2& c5) {
  fp6 ta, tb, al1, bl1;
  fp2_mul(ta.c0, f.c0.c0, c0); fp2_mul(ta.c1, f.c0.c1, c0); fp2_mul(ta.c2, f.c0.c2, c0);
  fp2_mul(tb.c0, f.c1.c0, c0); fp2_mul(tb.c1, f.c1.c1, c0); fp2_mul(tb.c2, f.c1.c2, c0);
  fp2 c45;
  fp2_add(c45, c4, c5);
  sparse_l1(al1, f.c0.c0, f.c0.c1, f.c0.c2, c4, c5, c45);
  sparse_l1(bl1, f.c1.c0, f.c1.c1, f.c1.c2, c4, c5, c45);
  fp6_mul_by_v(bl1, bl1);
  fp6_add(f.c0, ta, bl1);
  fp6_add(f.c1, al1, tb);
}

// (a + b s)^2 in Fq4 = Fq2[s]/(s^2 - xi): (a^2 + xi b^2, 2ab)
DEV void f4_sqr(fp2& r0, fp2& r1, const fp2& a, const fp2& b) {
  fp2 t0, t1, s;
  fp2_sqr(t0, a);
  fp2_sqr(t1, b);
  fp2_add(s, a, b);
  fp2_sqr(s, s);
  fp2_sub(s, s, t0);
  fp2_sub(r1, s, t1);
  fp2_mul_xi(t1, t1);
  fp2_add(r0, t1, t0);
}

// 3t - 2z and 3t + 2z
DEV void cyc_minus(fp2& z, const fp2& t) {
  fp2 d;
  fp2_sub(d, t, z); fp2_add(d, d, d); fp2_add(z, d, t);
}
DEV void cyc_plus(fp2& z, const fp2& t) {
  fp2 d;
  fp2_add(d, t, z); fp2_add(d, d, d); fp2_add(z, d, t);
}

// f^2 for f in the cyclotomic subgroup (Granger-Scott; fields.py
// f12_cyclotomic_sqr). Layout ((z0, z4, z3), (z2, z1, z5)).
DEVNI void fp12_cyc_sqr(fp12& f) {
  fp2 t0, t1, t2, t3;
  fp2& z0 = f.c0.c0; fp2& z4 = f.c0.c1; fp2& z3 = f.c0.c2;
  fp2& z2 = f.c1.c0; fp2& z1 = f.c1.c1; fp2& z5 = f.c1.c2;
  f4_sqr(t0, t1, z0, z1);
  cyc_minus(z0, t0);
  cyc_plus(z1, t1);
  fp2 t0b, t1b;
  f4_sqr(t0b, t1b, z2, z3);
  f4_sqr(t2, t3, z4, z5);
  cyc_minus(z4, t0b);
  cyc_plus(z5, t1b);
  fp2_mul_xi(t0, t3);
  cyc_plus(z2, t0);
  cyc_minus(z3, t2);
}

// f^e, e > 0 a 64-bit exponent, f cyclotomic (fields.py f12_cyclotomic_pow)
DEVNI void fp12_cyc_pow(fp12& r, const fp12& f, unsigned long long e) {
  fp12 res = f;
  int top = 63;
  while (!((e >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    fp12_cyc_sqr(res);
    if ((e >> i) & 1) fp12_mul(res, res, f);
  }
  r = res;
}

// f^((p^12 - 1)/r), exact (pairing.py final_exponentiation)
DEVNI void final_exponentiation(fp12& r, const fp12& f) {
  fp12 t, u, y, y2;
  fp12_conj(t, f);
  fp12_inv(u, f);
  fp12_mul(t, t, u);          // f^(p^6 - 1)
  fp12_frob(u, t);
  fp12_frob(u, u);
  fp12_mul(t, u, t);          // ^(p^2 + 1)
  fp12_cyc_pow(y, t, BLS_M1);
  fp12_conj(y, y);            // t^((x-1)/3)
  fp12_cyc_pow(y, y, BLS_M2);
  fp12_conj(y, y);            // t^((x-1)^2/3)
  fp12_cyc_pow(u, y, BLS_X_ABS);
  fp12_conj(u, u);
  fp12_frob(y2, y);
  fp12_mul(y, u, y2);         // ^(x + p)
  fp12_cyc_pow(y2, y, BLS_X_ABS);
  fp12_cyc_pow(y2, y2, BLS_X_ABS);
  fp12_frob(u, y);
  fp12_frob(u, u);
  fp12_mul(y2, y2, u);
  fp12_conj(u, y);
  fp12_mul(y, y2, u);         // ^(x^2 + p^2 - 1)
  fp12_mul(r, y, t);
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
DEV void f_inv(fp& r, const fp& a) { fp_inv(r, a); }
DEV void f_inv(fp2& r, const fp2& a) { fp2_inv(r, a); }

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

// [|x|]P, left to right from P over the bits of |x| below its top bit
// (the JAX package's _ladder_mul_const schedule)
template <class F> DEVNI void pt_mul_x_abs(jac<F>& r, const jac<F>& p) {
  jac<F> acc = p;
  for (int i = 62; i >= 0; i--) {
    pt_double(acc, acc);
    if ((BLS_X_ABS >> i) & 1) pt_add(acc, acc, p);
  }
  r = acc;
}

// affine (x, y) = (X/Z^2, Y/Z^3); an infinity gives (0, 0)
template <class F> DEVNI void pt_to_affine(F& ax, F& ay, const jac<F>& p) {
  F zi, zi2, t;
  f_inv(zi, p.z);
  f_sqr(zi2, zi);
  f_mul(ax, p.x, zi2);
  f_mul(t, zi2, zi);
  f_mul(ay, p.y, t);
}

// psi on Jacobian twisted coordinates: (cx * conj(X), cy * conj(Y), conj(Z))
DEVNI void g2_psi(jac<fp2>& r, const jac<fp2>& p) {
  fp2 c;
  fp2_conj(r.x, p.x); fp2_const(c, BLS_PSI_CX); fp2_mul(r.x, r.x, c);
  fp2_conj(r.y, p.y); fp2_const(c, BLS_PSI_CY); fp2_mul(r.y, r.y, c);
  fp2_conj(r.z, p.z);
}

// [h_eff]Q = [x^2 - x - 1]Q + [x - 1]psi(Q) + psi^2(2Q) (Budroni-Pintore;
// curve.py g2_clear_cofactor, ladders in place of its wNAF)
DEVNI void g2_clear_cofactor(jac<fp2>& r, const jac<fp2>& q) {
  jac<fp2> a, nq, c1, c2, t;
  pt_mul_x_abs(a, q);
  pt_neg(a, a);                // [x]Q
  pt_neg(nq, q);
  pt_add(c1, a, nq);           // [x - 1]Q
  pt_mul_x_abs(c2, c1);
  pt_neg(c2, c2);              // [x^2 - x]Q
  pt_add(c2, c2, nq);          // [x^2 - x - 1]Q
  g2_psi(t, c1);
  pt_add(c2, c2, t);
  pt_double(t, q);
  g2_psi(t, t);
  g2_psi(t, t);
  pt_add(r, c2, t);
}

// psi(Q) == [x]Q for an affine twist point (infinity counts as a member)
DEVNI bool g2_in_subgroup(const fp2& qx, const fp2& qy) {
  jac<fp2> q, xq, s;
  q.x = qx; q.y = qy; fp2_one(q.z);
  pt_mul_x_abs(xq, q);         // [|x|]Q
  g2_psi(s, q);
  pt_add(s, s, xq);            // psi(Q) + [|x|]Q == psi(Q) - [x]Q
  return fp2_is_zero(s.z);
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
