// BLS12-381 scalar field Fr for the port's KZG kernels (csrc/kzg_fr.cu):
// the layout, loads and stores, additions and subtractions.
//
// Replaces the field layer of the JAX package's lighthouse_tpu/ops/fr.py
// (K8): fr_add (:89) and fr_sub (:94) here; fr_mul (:78) and fr_inv (:102,
// Fermat) are mont_mul_cs<8> and mont_inv_binary<8> (csrc/mont_cs.cuh, a
// column-sum Montgomery product and a binary extended Euclid). Like K3 it
// has no launch of its own: it is device code compiled into the kernels
// that use it. The plain PyTorch versions are in ops/fr.py.
//
// Representation. Fr is 8 little-endian 32-bit limbs in Montgomery form
// with R = 2^256, the JAX package's R (JAX holds a residue as 32 8-bit
// limbs in int32; the integer is the same). Every value is fully reduced
// into [0, r). Since r < 2^255, the sum of two reduced values fits in 8
// limbs. At the kernels' edges values are canonical 32-byte big-endian
// integers, as the blobs carry them, held as 8 32-bit words with the most
// significant word first (fr_ld_be / fr_st_be).
//
// What bounds the kernels: 32-bit multiply-adds. A Montgomery
// multiplication is 2*8*8 limb products (a*b and m*r), each a low and a
// high half, and 8 low halves m = t0 * n': 264 32-bit multiplies. An
// inverse is counted at the floor of any addition chain for a^(r-2), 255
// products.
//
// Plain C++ for one thread outside nvcc (no __CUDACC__), as
// bls381_field.cuh.
#pragma once
#include <stdint.h>

#ifndef DEV
#ifdef __CUDACC__
#define DEV __device__ __forceinline__
#define CONSTMEM __constant__ const
#define UNROLL _Pragma("unroll")
#else
#define DEV static inline
#define CONSTMEM static const
#define UNROLL
#endif
#endif

// r, -r^-1 mod 2^32, R mod r and R^2 mod r
CONSTMEM uint32_t FR_MOD[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
#define FR_NINV 0xffffffffu
CONSTMEM uint32_t FR_ONE[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau, 0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
CONSTMEM uint32_t FR_R2[8] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu, 0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};

struct fr { uint32_t v[8]; };

DEV void fr_zero(fr& a) { UNROLL for (int j = 0; j < 8; j++) a.v[j] = 0; }
DEV void fr_set(fr& a, const uint32_t* c) { UNROLL for (int j = 0; j < 8; j++) a.v[j] = c[j]; }
DEV void fr_one(fr& a) { fr_set(a, FR_ONE); }
DEV bool fr_is_zero(const fr& a) {
  uint32_t acc = 0;
  UNROLL for (int j = 0; j < 8; j++) acc |= a.v[j];
  return acc == 0;
}

// canonical big-endian words (most significant first) <-> limbs
DEV void fr_ld_be(fr& a, const uint32_t* w) { UNROLL for (int j = 0; j < 8; j++) a.v[j] = w[7 - j]; }
DEV void fr_st_be(uint32_t* w, const fr& a) { UNROLL for (int j = 0; j < 8; j++) w[7 - j] = a.v[j]; }

// t in [0, 2r) -> t mod r
DEV void fr_reduce_once(fr& r, const uint32_t* t) {
  uint32_t s[8];
  long long br = 0;
  UNROLL for (int j = 0; j < 8; j++) {
    long long d = (long long)t[j] - (long long)FR_MOD[j] + br;
    s[j] = (uint32_t)d;
    br = d >> 32;  // 0 or -1
  }
  bool lt = br < 0;  // t < r
  UNROLL for (int j = 0; j < 8; j++) r.v[j] = lt ? t[j] : s[j];
}

DEV void fr_add(fr& r, const fr& a, const fr& b) {
  uint32_t t[8];
  unsigned long long c = 0;
  UNROLL for (int j = 0; j < 8; j++) {
    c += (unsigned long long)a.v[j] + b.v[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  fr_reduce_once(r, t);  // a + b < 2r < 2^256: no carry out
}

DEV void fr_sub(fr& r, const fr& a, const fr& b) {
  uint32_t t[8];
  long long br = 0;
  UNROLL for (int j = 0; j < 8; j++) {
    long long d = (long long)a.v[j] - (long long)b.v[j] + br;
    t[j] = (uint32_t)d;
    br = d >> 32;
  }
  if (br < 0) {  // a < b: add r back
    unsigned long long c = 0;
    UNROLL for (int j = 0; j < 8; j++) {
      c += (unsigned long long)t[j] + FR_MOD[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  UNROLL for (int j = 0; j < 8; j++) r.v[j] = t[j];
}
