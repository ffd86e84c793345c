// K9: the G1 multi-scalar multiplication sum_i s_i * P_i of KZG (every
// blob commitment and every opening proof: 4096 Lagrange setup points).
//
// Replaces, in the JAX package (lighthouse_tpu/ops/msm.py):
//   * msm_pippenger_device (:94) with its host digit preparation
//     _host_digit_prep (:48) and g1_msm_pippenger (:159), the Pippenger
//     path g1_msm_device (:186) takes on an accelerator.
// The point arithmetic is pt_add / pt_double of csrc/bls381_field.cuh
// (Jacobian, complete) and the mixed addition pt_add_affine (with every
// case: an infinity accumulator, P == Q and P == -Q, which matter because
// distinct table entries meet in a bucket's sum). Steps 1-3 pair their
// independent products into one call (fp_mul2: g1_add, g1_double,
// pt_add_affine), as fp_mul is out of line and a thread's products are
// its chain: on an H100 that shortened step 3's lone chains by about a
// third, while the table's doubling walk ran a little faster unpaired.
//
// A fixed-base MSM. Every MSM of the KZG engine has the same base, the
// setup's points, so the doublings of Pippenger's windows are done once
// per setup, not once per call:
//   0. msm_table (once per base): one thread per point walks its doubling
//      chain and keeps each window's multiple T[w][i] = 2^(8w) * P_i,
//      w < 32; the thread's 32 multiples are made affine with Montgomery's
//      batch inversion (one Fermat inversion a point) and stored as
//      [32][n][2][12] limbs with an infinity flag [32][n] (a Z = 0 entry;
//      its limbs are 0). At n = 4096 the table is 24 MiB, and the KZG
//      engine keeps it on the card (crypto/kzg _DeviceKzg.table).
// Then sum_i s_i P_i = sum_b b * B_b, where B_b sums the table entries
// (w, i) whose digit d_w(s_i) (8 bits, byte w of s_i) is b: one set of
// 255 buckets over all 32n entries, and no Horner chain:
//   1. msm_fixed_buckets: one block per chunk of at most 1024 entries,
//      chunk c < nc holding e = c, c + nc, c + 2 nc, ... (window-major
//      order e = w * n + i; by stride, so every chunk mixes all windows:
//      the top window's digits lie below 116, as scalars lie below r, and
//      consecutive chunks of it would hold about 9 matches a bucket, not
//      4), one thread per bucket b. The block puts the chunk's digits in
//      shared memory (0 for an infinity entry); each thread scans them
//      four at a time and first collects the positions of its matches
//      (about 4 at random scalars, at most 16 before it adds), then the
//      warp adds them in lockstep with mixed additions into a Jacobian
//      accumulator started at infinity, in entry order. (A thread that
//      added inside the scan would make the warp's 32 buckets diverge:
//      about 128 additions in series, not 4.) Output partial[b - 1][c];
//   2. msm_bucket_tree: one block per bucket adds its chunks' partial sums
//      in a tree (pairs (0,1), (2,3), ..., then their sums): B_b;
//   3. msm_bit_sums: block k < 8 sums S_k, the 128 B_b with bit k of b
//      set, in a tree (in increasing b), and doubles it k times; then
//      msm_bits_total adds the eight 2^k S_k in a tree. (One block for all
//      eight trees put ~1,000 additions on one SM: half the MSM's time.)
//      The longest chain on any thread: the thread's matches, 7 + 7 tree
//      levels of Jacobian additions, 7 doublings and 3 additions.
// The plain version (ops/msm.py) takes the same steps in the same order,
// so both give the same Jacobian coordinates; the table's affine limbs
// are canonical, so any correct method gives the same table.
//
// What bounds it: 32-bit multiplies of the point arithmetic (588 per Fq
// product, bls381_field.cuh). chip_smoke.py (msm_fq_muls) counts two least
// works for this run's scalars: Pippenger's at its best window (affine
// bucket additions with batch inversion, running sums, Horner; derived
// there), and the fixed-base one over a resident table: every nonzero
// table digit after the first in its bucket one affine addition (6
// products and a share of a batch inversion), one running sum over the
// 255 buckets (254 mixed and 254 Jacobian additions), no doublings, the
// table's bytes read once. The kernel adds in Jacobian coordinates (11
// products a mixed addition) with no batch inversion: it is bound by the
// latency of its longest chain (a few dozen point operations), not by
// the card's multipliers.
#include "bls381_field.cuh"

#define MSM_WINDOW 8
#define MSM_WINDOWS 32   // 8-bit windows over 256-bit scalars
#define MSM_BUCKETS 255  // digits 1..255
#define MSM_CHUNK 1024   // table entries per block of step 1
#define MSM_MATCHES 16   // positions a thread collects before it adds
#define MSM_P3 36        // limbs of a Jacobian point
#define MSM_A2 24        // limbs of an affine table entry

// digit w (8 bits, least significant window first) of 8 big-endian words
DEV int msm_digit(const uint32_t* s, int w) { return (int)((s[7 - (w >> 2)] >> (8 * (w & 3))) & 255u); }

// the bytes of a equal to those of b: 0xff in each such byte
DEV uint32_t bytes_eq(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vcmpeq4(a, b);
#else
  uint32_t m = 0;
  for (int j = 0; j < 4; j++)
    if (((a >> (8 * j)) & 255u) == ((b >> (8 * j)) & 255u)) m |= 255u << (8 * j);
  return m;
#endif
}

// pt_double of bls381_field.cuh with its products paired (4 rounds, not 7)
DEVNI void g1_double(jac<fp>& r, const jac<fp>& p) {
  fp a, b, c, d, e, f, t, x3, z3;
  fp_mul2(a, p.x, p.x, b, p.y, p.y);
  fp_add(t, p.x, b);
  fp_mul2(c, b, b, t, t, t);
  fp_sub(t, t, a); fp_sub(d, t, c); fp_add(d, d, d);
  fp_add(e, a, a); fp_add(e, e, a);
  fp_add(z3, p.y, p.y);
  fp_mul2(f, e, e, z3, z3, p.z);
  fp_add(t, d, d); fp_sub(x3, f, t);
  fp_add(c, c, c); fp_add(c, c, c); fp_add(c, c, c);  // 8C
  fp_sub(t, d, x3); fp_mul(t, e, t);
  fp_sub(r.y, t, c);
  r.x = x3;
  r.z = z3;
}

// pt_add of bls381_field.cuh (every case) with its products paired
// (8 rounds, not 16)
DEVNI void g1_add(jac<fp>& r, const jac<fp>& p, const jac<fp>& q) {
  if (fp_is_zero(p.z)) { r = q; return; }
  if (fp_is_zero(q.z)) { r = p; return; }
  fp z1z1, z2z2, u1, u2, s1, s2, t, w;
  fp_mul2(z1z1, p.z, p.z, z2z2, q.z, q.z);
  fp_mul2(u1, p.x, z2z2, u2, q.x, z1z1);
  fp_mul2(t, z2z2, q.z, w, z1z1, p.z);
  fp_mul2(s1, p.y, t, s2, q.y, w);
  if (fp_eq(u1, u2)) {
    if (fp_eq(s1, s2)) g1_double(r, p); else pt_inf(r);
    return;
  }
  fp h, i, j, rr, v, x3, y3, z3;
  fp_sub(h, u2, u1);
  fp_add(i, h, h);
  fp_mul2(i, i, i, z3, p.z, q.z);
  fp_sub(rr, s2, s1); fp_add(rr, rr, rr);
  fp_mul2(j, h, i, v, u1, i);
  fp_mul2(x3, rr, rr, z3, z3, h);
  fp_sub(x3, x3, j); fp_add(t, v, v); fp_sub(x3, x3, t);
  fp_sub(t, v, x3);
  fp_mul2(y3, rr, t, t, s1, j);
  fp_add(t, t, t); fp_sub(y3, y3, t);
  fp_add(z3, z3, z3);
  r.x = x3; r.y = y3; r.z = z3;
}

// P + (x2, y2) for a Jacobian P and an affine point (madd-2007-bl), with
// every case of pt_add: an infinity P gives (x2, y2, 1), P == Q doubles,
// P == -Q gives the canonical infinity. Products paired: 6 rounds, not 11.
DEVNI void pt_add_affine(jac<fp>& r, const jac<fp>& p, const fp& x2, const fp& y2) {
  if (fp_is_zero(p.z)) { r.x = x2; r.y = y2; fp_one(r.z); return; }
  fp z1z1, u2, s2, t, h, hh;
  fp_sqr(z1z1, p.z);
  fp_mul2(u2, x2, z1z1, t, p.z, z1z1);
  fp_sub(h, u2, p.x);
  fp_mul2(s2, y2, t, hh, h, h);
  if (fp_eq(p.x, u2)) {
    if (fp_eq(p.y, s2)) g1_double(r, p); else pt_inf(r);
    return;
  }
  fp i, j, rr, v, x3, y3, z3;
  fp_add(i, hh, hh); fp_add(i, i, i);
  fp_sub(rr, s2, p.y); fp_add(rr, rr, rr);
  fp_add(z3, p.z, h);
  fp_mul2(j, h, i, v, p.x, i);
  fp_mul2(x3, rr, rr, z3, z3, z3);
  fp_sub(x3, x3, j); fp_add(t, v, v); fp_sub(x3, x3, t);
  fp_sub(z3, z3, z1z1); fp_sub(z3, z3, hh);
  fp_sub(t, v, x3);
  fp_mul2(y3, rr, t, t, p.y, j);
  fp_add(t, t, t); fp_sub(y3, y3, t);
  r.x = x3; r.y = y3; r.z = z3;
}

// step 0 for point i: T[w][i] for w < 32, affine, flagged at infinity.
// xy [32][n][24] is written twice: Jacobian X, Y first, then affine.
DEV void msm_table_point(long long* xy, unsigned char* inf, const long long* pts, long long n, long long i) {
  jac<fp> acc;
  pt_ld(acc, pts + i * MSM_P3);
  fp z[MSM_WINDOWS], pre[MSM_WINDOWS];
  fp one;
  fp_one(one);
  for (int w = 0; w < MSM_WINDOWS; w++) {
    if (w) {
      for (int k = 0; k < MSM_WINDOW; k++) pt_double(acc, acc);
    }
    long long* e = xy + (w * n + i) * MSM_A2;
    fp_st(e, acc.x);
    fp_st(e + 12, acc.y);
    bool at_inf = fp_is_zero(acc.z);
    inf[w * n + i] = at_inf ? 1 : 0;
    z[w] = at_inf ? one : acc.z;
    if (w) fp_mul(pre[w], pre[w - 1], z[w]); else pre[0] = z[0];
  }
  fp inv, zi, zi2, t, x, y;
  fp_inv(inv, pre[MSM_WINDOWS - 1]);
  for (int w = MSM_WINDOWS - 1; w >= 0; w--) {
    if (w) {
      fp_mul(zi, inv, pre[w - 1]);
      fp_mul(inv, inv, z[w]);
    } else {
      zi = inv;
    }
    long long* e = xy + (w * n + i) * MSM_A2;
    if (inf[w * n + i]) {
      fp_zero(x); fp_zero(y);
    } else {
      fp_ld(x, e); fp_ld(y, e + 12);
      fp_sqr(zi2, zi);
      fp_mul(x, x, zi2);
      fp_mul(t, zi2, zi); fp_mul(y, y, t);
    }
    fp_st(e, x);
    fp_st(e + 12, y);
  }
}

// the idx-th bucket (in increasing order) among the 128 whose bit k is set
DEV int msm_bit_bucket(int k, int idx) {
  const int low = idx & ((1 << k) - 1);
  return ((idx >> k) << (k + 1)) | (1 << k) | low;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define TABLE_THREADS 32
#define TREE_THREADS 64

__global__ void __launch_bounds__(TABLE_THREADS)
msm_table_kernel(const long long* pts, long long* xy, unsigned char* inf, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) msm_table_point(xy, inf, pts, n, i);
}

// block c, thread b - 1: partial[b - 1][c] = the sum of chunk c's entries
// whose digit is b, in entry order
__global__ void __launch_bounds__(256)
msm_fixed_buckets_kernel(const long long* xy, const unsigned char* inf, const uint32_t* scalars,
                         long long* partial, long long n, int nc) {
  __shared__ __align__(16) unsigned char dig[MSM_CHUNK];
  const long long entries = MSM_WINDOWS * n;
  for (int t = threadIdx.x; t < MSM_CHUNK; t += blockDim.x) {
    const long long e = blockIdx.x + (long long)nc * t;
    int d = 0;
    if (e < entries && !inf[e]) d = msm_digit(scalars + 8 * (e % n), (int)(e / n));
    dig[t] = (unsigned char)d;
  }
  __syncthreads();
  const int b = threadIdx.x + 1;
  if (b > MSM_BUCKETS) return;
  const uint32_t* dw = (const uint32_t*)dig;
  const uint32_t bb = 0x01010101u * (uint32_t)b;
  jac<fp> acc;
  pt_inf(acc);
  short pos[MSM_MATCHES];
  int q = 0;
  while (q < MSM_CHUNK / 4) {
    int cnt = 0;
    // collect: stop while 4 more positions still fit
    for (; q < MSM_CHUNK / 4 && cnt <= MSM_MATCHES - 4; q++) {
      const uint32_t m = bytes_eq(dw[q], bb);
      if (m) {
        for (int j = 0; j < 4; j++)
          if ((m >> (8 * j)) & 1u) pos[cnt++] = (short)(4 * q + j);
      }
    }
    // then add, the warp in lockstep
    for (int k = 0; k < cnt; k++) {
      const long long* e = xy + (blockIdx.x + (long long)nc * pos[k]) * MSM_A2;
      fp x2, y2;
      fp_ld(x2, e);
      fp_ld(y2, e + 12);
      pt_add_affine(acc, acc, x2, y2);
    }
  }
  pt_st(partial + ((long long)(b - 1) * nc + blockIdx.x) * MSM_P3, acc);
}

// block s sums segment s of partial ([255][nc][36], nc a power of two)
// into sums [255][36]; buf [255][nc/2][36] is scratch
__global__ void __launch_bounds__(TREE_THREADS)
msm_bucket_tree_kernel(const long long* partial, long long* buf, long long* sums, int nc) {
  const long long seg = blockIdx.x;
  const long long* in = partial + seg * nc * MSM_P3;
  long long* dst = sums + seg * MSM_P3;
  if (nc == 1) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < MSM_P3; j++) dst[j] = in[j];
    }
    return;
  }
  const int half = nc / 2;
  long long* b = buf + seg * half * MSM_P3;
  for (int t = threadIdx.x; t < half; t += blockDim.x) {
    jac<fp> a, c;
    pt_ld(a, in + 2 * t * MSM_P3);
    pt_ld(c, in + (2 * t + 1) * MSM_P3);
    g1_add(a, a, c);
    pt_st(b + t * MSM_P3, a);
  }
  __syncthreads();
  for (int s = 1; s < half; s *= 2) {
    for (int t = threadIdx.x; 2 * s * t < half; t += blockDim.x) {
      const int i = 2 * s * t;
      jac<fp> a, c;
      pt_ld(a, b + i * MSM_P3);
      pt_ld(c, b + (i + s) * MSM_P3);
      g1_add(a, a, c);
      pt_st(b + i * MSM_P3, a);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < MSM_P3; j++) dst[j] = b[j];
  }
}

// block k of 8, 64 threads: S_k, the sum of the 128 buckets with bit k
// set, in a tree, then 2^k S_k by k doublings, into buf[k][0];
// sums [255][36], buf [8][64][36]
__global__ void __launch_bounds__(64)
msm_bit_sums_kernel(const long long* sums, long long* buf) {
  const int k = blockIdx.x, j = threadIdx.x;
  long long* row = buf + (long long)k * 64 * MSM_P3;
  {
    jac<fp> a, c;
    pt_ld(a, sums + (long long)(msm_bit_bucket(k, 2 * j) - 1) * MSM_P3);
    pt_ld(c, sums + (long long)(msm_bit_bucket(k, 2 * j + 1) - 1) * MSM_P3);
    g1_add(a, a, c);
    pt_st(row + j * MSM_P3, a);
  }
  __syncthreads();
  for (int s = 1; s < 64; s *= 2) {
    if (j % (2 * s) == 0) {
      jac<fp> a, c;
      pt_ld(a, row + j * MSM_P3);
      pt_ld(c, row + (j + s) * MSM_P3);
      g1_add(a, a, c);
      pt_st(row + j * MSM_P3, a);
    }
    __syncthreads();
  }
  if (j == 0) {
    jac<fp> a;
    pt_ld(a, row);
    for (int d = 0; d < k; d++) g1_double(a, a);
    pt_st(row, a);
  }
}

// one block of 8 threads: the tree over the eight 2^k S_k -> out [36]
__global__ void __launch_bounds__(MSM_WINDOW)
msm_bits_total_kernel(long long* buf, long long* out) {
  const int t = threadIdx.x;
  for (int s = 1; s < MSM_WINDOW; s *= 2) {
    if (t % (2 * s) == 0) {
      jac<fp> a, c;
      pt_ld(a, buf + (long long)t * 64 * MSM_P3);
      pt_ld(c, buf + (long long)(t + s) * 64 * MSM_P3);
      g1_add(a, a, c);
      pt_st(buf + (long long)t * 64 * MSM_P3, a);
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int q = 0; q < MSM_P3; q++) out[q] = buf[q];
  }
}

extern "C" {

// pts [n][36] Jacobian -> xy [32][n][24] affine, inf [32][n]
int msm_g1_table(const long long* pts, long long* xy, unsigned char* inf, long long n, void* stream) {
  const unsigned grid = (unsigned)((n + TABLE_THREADS - 1) / TABLE_THREADS);
  msm_table_kernel<<<grid, TABLE_THREADS, 0, (cudaStream_t)stream>>>(pts, xy, inf, n);
  return (int)cudaGetLastError();
}

// nc = a power of two >= ceil(32 n / 1024); partial [255 * nc * 36],
// buf [max(255 * max(nc / 2, 1), 8 * 64) * 36], sums [255 * 36], out [36]
int msm_g1_fixed(const long long* xy, const unsigned char* inf, const uint32_t* scalars, long long* partial,
                 long long* buf, long long* sums, long long* out, long long n, int nc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // chunks past the entries scan zero digits: their partial sums are infinities
  msm_fixed_buckets_kernel<<<(unsigned)nc, 256, 0, st>>>(xy, inf, scalars, partial, n, nc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  msm_bucket_tree_kernel<<<MSM_BUCKETS, TREE_THREADS, 0, st>>>(partial, buf, sums, nc);
  err = (int)cudaGetLastError();
  if (err) return err;
  msm_bit_sums_kernel<<<MSM_WINDOW, 64, 0, st>>>(sums, buf);
  err = (int)cudaGetLastError();
  if (err) return err;
  msm_bits_total_kernel<<<1, MSM_WINDOW, 0, st>>>(buf, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
