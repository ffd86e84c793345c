// A Montgomery product for the kernels redesigned for latency: K8's
// barycentric evaluation (kzg_fr.cu) and K5's hash-to-G2 (bls381_htc.cu).
// The shared one-thread products fp_mul (bls381_field.cuh) and fr_mul
// (fr.cuh) stay as they are for the other kernels; moving those to this
// product is later work. Below it, the binary extended Euclidean inverse
// over N limbs, one template for Fr (K8) and Fq (K4's final
// exponentiation).
//
// mont_mul_cs<N> over N 32-bit limbs, inlined, on values in registers.
// The 2N-word product a * b is kept as column sums: each column a 64-bit
// sum of the low and high halves of its limb products, independent of the
// other columns, so a thread's N^2 multiplies overlap instead of waiting
// on a carry from one limb to the next (fp_mul / fr_mul carry limb by
// limb). Montgomery's reduction then runs over the columns: step i takes
// m = col_i * n' mod 2^32, adds m * mod into columns i..i+N and moves
// col_i's carry into col_{i+1}; only that carry and m are serial. A column
// takes at most 4N halves of 32 bits and one carry, so it stays far below
// 2^64. Operands must be reduced (< mod); the result is below 2 mod before
// one conditional subtraction, fully reduced and equal limb for limb to
// fp_mul / fr_mul. Plain C++: the same code runs on the host.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define CS_DEV __device__ __forceinline__
#define CS_UNROLL _Pragma("unroll")
#else
#define CS_DEV static inline
#define CS_UNROLL
#endif

#ifdef __CUDACC__
#define CS_NOINLINE __device__ __noinline__
#else
#define CS_NOINLINE static
#endif

// r = a * b * 2^(-32N) mod `mod`; `ninv` = -mod^-1 mod 2^32. r may alias
// a or b.
template <int N>
CS_DEV void mont_mul_cs(uint32_t* r, const uint32_t* a, const uint32_t* b, const uint32_t* mod, uint32_t ninv) {
  unsigned long long col[2 * N];
  CS_UNROLL for (int k = 0; k < 2 * N; k++) col[k] = 0;
  CS_UNROLL for (int i = 0; i < N; i++) {
    CS_UNROLL for (int j = 0; j < N; j++) {
      const unsigned long long p = (unsigned long long)a[j] * b[i];
      col[i + j] += (uint32_t)p;
      col[i + j + 1] += p >> 32;
    }
  }
  CS_UNROLL for (int i = 0; i < N; i++) {
    const uint32_t m = (uint32_t)col[i] * ninv;
    CS_UNROLL for (int j = 0; j < N; j++) {
      const unsigned long long p = (unsigned long long)m * mod[j];
      col[i + j] += (uint32_t)p;
      col[i + j + 1] += p >> 32;
    }
    col[i + 1] += col[i] >> 32;  // col_i is now 0 mod 2^32
  }
  // (a b + M mod) / 2^(32N) < 2 mod < 2^(32N): words N..2N-1 with carries
  uint32_t t[N], s[N];
  unsigned long long c = 0;
  CS_UNROLL for (int k = 0; k < N; k++) {
    c += col[N + k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  long long br = 0;
  CS_UNROLL for (int j = 0; j < N; j++) {
    const long long d = (long long)t[j] - (long long)mod[j] + br;
    s[j] = (uint32_t)d;
    br = d >> 32;
  }
  CS_UNROLL for (int j = 0; j < N; j++) r[j] = br < 0 ? t[j] : s[j];
}

// ---------------------------------------------------------------------------
// The binary inverse: plain N-limb integers, halvings modulo `mod`
// ---------------------------------------------------------------------------

CS_DEV int cs_ctz32(uint32_t x) {
#ifdef __CUDACC__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

template <int N>
CS_DEV bool limbs_is_one(const uint32_t* a) {
  uint32_t acc = a[0] ^ 1u;
  CS_UNROLL for (int j = 1; j < N; j++) acc |= a[j];
  return acc == 0;
}

template <int N>
CS_DEV bool limbs_ge(const uint32_t* a, const uint32_t* b) {
  for (int j = N - 1; j >= 0; j--)
    if (a[j] != b[j]) return a[j] > b[j];
  return true;
}

// r = a - b, borrow out; r may alias a or b
template <int N>
CS_DEV long long limbs_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  long long br = 0;
  CS_UNROLL for (int j = 0; j < N; j++) {
    const long long d = (long long)a[j] - (long long)b[j] + br;
    r[j] = (uint32_t)d;
    br = d >> 32;
  }
  return br;
}

// a >>= k, 0 < k < 32
template <int N>
CS_DEV void limbs_shr(uint32_t* a, int k) {
  CS_UNROLL for (int j = 0; j < N - 1; j++) a[j] = (a[j] >> k) | (a[j + 1] << (32 - k));
  a[N - 1] >>= k;
}

// r = a - b mod `mod` for a, b < mod
template <int N>
CS_DEV void mod_sub(uint32_t* r, const uint32_t* a, const uint32_t* b, const uint32_t* mod) {
  uint32_t t[N];
  if (limbs_sub<N>(t, a, b) < 0) {
    unsigned long long c = 0;
    CS_UNROLL for (int j = 0; j < N; j++) {
      c += (unsigned long long)t[j] + mod[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  CS_UNROLL for (int j = 0; j < N; j++) r[j] = t[j];
}

// x <- x / 2^k mod `mod`, 0 < k < 32, x < mod < 2^(32N - 1): with
// m = x ninv mod 2^k, x + m mod = 0 mod 2^k (mod ninv = -1 mod 2^32), and
// (x + m mod) / 2^k < 2 mod, so one subtraction reduces it
template <int N>
CS_DEV void mod_div_pow2(uint32_t* x, int k, const uint32_t* mod, uint32_t ninv) {
  const uint32_t m = (x[0] * ninv) & ((1u << k) - 1u);
  uint32_t s[N + 1], t[N], u[N];
  unsigned long long c = 0;
  CS_UNROLL for (int j = 0; j < N; j++) {
    c += (unsigned long long)x[j] + (unsigned long long)m * mod[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  s[N] = (uint32_t)c;
  CS_UNROLL for (int j = 0; j < N; j++) t[j] = (s[j] >> k) | (s[j + 1] << (32 - k));
  const bool lt = limbs_sub<N>(u, t, mod) < 0;
  CS_UNROLL for (int j = 0; j < N; j++) x[j] = lt ? t[j] : u[j];
}

// r = a^-1 R for a Montgomery a = a R (R = 2^(32N)), 0 -> 0, by the binary
// extended Euclidean algorithm (variable time: the kernels invert public
// values). Invariants x1 a R = u, x2 a R = v (mod `mod`); a round strips
// the trailing zeros of u and v, up to 31 bits at a time (a division of
// x1 or x2 by 2^k), and subtracts the smaller from the larger: at most
// 2 log2(mod) short steps of shifts and subtractions, no product. At
// u = 1, x1 = (a R)^-1; one product by `r3` = R^3 mod `mod` gives a^-1 R.
template <int N>
CS_NOINLINE void mont_inv_binary(uint32_t* r, const uint32_t* a, const uint32_t* mod, uint32_t ninv,
                                 const uint32_t* r3) {
  uint32_t nz = 0;
  CS_UNROLL for (int j = 0; j < N; j++) nz |= a[j];
  if (!nz) {
    CS_UNROLL for (int j = 0; j < N; j++) r[j] = 0;
    return;
  }
  uint32_t u[N], v[N], x1[N], x2[N];
  CS_UNROLL for (int j = 0; j < N; j++) {
    u[j] = a[j];
    v[j] = mod[j];
    x1[j] = j == 0;
    x2[j] = 0;
  }
  for (;;) {
    while (!(u[0] & 1u)) {
      const int k = cs_ctz32(u[0] | 0x80000000u);
      limbs_shr<N>(u, k);
      mod_div_pow2<N>(x1, k, mod, ninv);
    }
    while (!(v[0] & 1u)) {
      const int k = cs_ctz32(v[0] | 0x80000000u);
      limbs_shr<N>(v, k);
      mod_div_pow2<N>(x2, k, mod, ninv);
    }
    if (limbs_is_one<N>(u)) break;
    if (limbs_is_one<N>(v)) {
      CS_UNROLL for (int j = 0; j < N; j++) x1[j] = x2[j];
      break;
    }
    if (limbs_ge<N>(u, v)) {
      limbs_sub<N>(u, u, v);
      mod_sub<N>(x1, x1, x2, mod);
    } else {
      limbs_sub<N>(v, v, u);
      mod_sub<N>(x2, x2, x1, mod);
    }
  }
  mont_mul_cs<N>(r, x1, r3, mod, ninv);
}
