// SHA-256 of one 64-byte message as Hopper (sm_90a) device code, shared by
// the SSZ Merkleization kernels: csrc/sha256.cu (K1, one message per
// thread) and csrc/merkle_subtree.cu (K10, a subtree per block), so that
// the two run one compression. The design notes and the bound are in
// sha256.cu's header.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

// K[t] + W[t] for the padding block of a 64-byte message (0x80, zeros,
// bit length 512): the whole schedule of the second compression.
__constant__ uint32_t kKWPad[64] = {
    0xc28a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf374,
    0x649b69c1, 0xf0fe4786, 0x0fe1edc6, 0x240cf254, 0x4fe9346f, 0x6cc984be, 0x61b9411e, 0x16f988fa,
    0xf2c65152, 0xa88e5a6d, 0xb019fc65, 0xb9d99ec7, 0x9a1231c3, 0xe70eeaa0, 0xfdb1232b, 0xc7353eb0,
    0x3069bad5, 0xcb976d5f, 0x5a0f118f, 0xdc1eeefd, 0x0a35b689, 0xde0b7a04, 0x58f4ca9d, 0xe15d5b16,
    0x007f3e86, 0x37088980, 0xa507ea32, 0x6fab9537, 0x17406110, 0x0d8cd6f1, 0xcdaa3b6d, 0xc0bbbe37,
    0x83613bda, 0xdb48a363, 0x0b02e931, 0x6fd15ca7, 0x521afaca, 0x31338431, 0x6ed41a95, 0x6d437890,
    0xc39c91f2, 0x9eccabbd, 0xb5c9a0e6, 0x532fb63c, 0xd2c741c6, 0x07237ea3, 0xa4954b68, 0x4c191d76,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return __funnelshift_r(x, x, n);
}

// Big-endian word <-> the little-endian load of its 4 bytes.
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One compression into st[8]. kPad: the second block of a 64-byte message,
// whose K[t]+W[t] are constants; otherwise w[16] is the data block and is
// overwritten by the schedule.
template <bool kPad>
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t kw;
    if (kPad) {
      kw = kKWPad[t];
    } else {
      if (t >= 16) {
        const uint32_t w15 = w[(t - 15) & 15];
        const uint32_t w2 = w[(t - 2) & 15];
        const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        w[t & 15] += s0 + w[(t - 7) & 15] + s1;
      }
      kw = kK[t] + w[t & 15];
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        (g ^ (e & (f ^ g))) + kw;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) | (c & (a | b)));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// The digest state of one 64-byte message given as 16 big-endian words
// (w is overwritten by the schedule): the data block, then the constant
// padding block.
__device__ __forceinline__ void sha256_64(uint32_t st[8], uint32_t w[16]) {
  const uint32_t iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = iv[j];
  compress<false>(st, w);
  compress<true>(st, w);
}

}  // namespace
