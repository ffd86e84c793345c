// K2 launches: batched G1/G2 scalar ladders, per-set segment sums and
// Jacobian -> affine conversion for BLS batch verification.
//
// Replaces, in the JAX package (lighthouse_tpu/ops):
//   * bls381.py:481/487 batch_g1_scalar_mul / batch_g2_scalar_mul (the
//     64-bit random-linear-combination ladders, pt_scalar_mul :368);
//   * bls381.py:492 g1_sum_reduce and bls381_verify.py:66/103/108
//     _tree_reduce_scan / g1_segment_sum / g2_sum_reduce (tree sums over a
//     padded committee axis: g1_segment_sum_kernel, g2_segment_sum_kernel);
//   * bls381_verify.py:122/138 g1_jac_to_affine / g2_jac_to_affine (a
//     Fermat inverse a lane there; one batch inversion a block here);
//   * msm.py:172 g1_msm_ladder's per-point ladders (K9 ladder): 256-bit
//     scalars, batch_g1_scalar_mul over NBITS = 256 (the tree sum after
//     them is g1_segment_sum);
//   * bls381_sharded.py:56 sharded_rlc_g1_fn's per-point 64-bit ladders
//     (K11: pt_scalar_mul over the RLC draws' 64 bits).
//
// Design. The G1 and G2 ladders run a warp per lane: 32 lanes are 32
// warps on 32 SMs, and the bit branch is the team's own, so a warp pays an
// addition only on its own scalar's set bits (a warp of 32 one-thread
// ladders diverged on nearly every bit). The G2 ladder runs on
// g2_team.cuh (K5's team code): a round puts up to eight Fq2 products on
// the warp's lanes. The G1 ladder runs on g1_team.cuh: a round puts up to
// five Fq products on lanes, one a lane, each its slot's value, and one
// lane forms each operand sum once between rounds. Both start from P at
// the scalar's top bit, which is what the canonical infinity's doublings
// and first addition give, so their output equals the one-thread ladder's
// (pt_mul_u64) limb for limb, an infinity input's coordinates included:
// (bits(k) - 1) team doublings and (popcount(k) - 1) additions. A G1
// doubling is 3 rounds and an addition 5, about 345 rounds in one chain
// for a 64-bit draw; a G2 doubling 3 rounds and an addition 6, or 5 for an
// affine P (Z = 1, as the verifier's decompressed signatures come:
// team_madd), about 380.
// A warp a lane keeps a few lanes of the SM's multipliers busy in each
// round, so the G1 team layout loses once enough lanes fill the card:
// bls_g1_scalar_mul keeps the team layout up to G1_TEAM_MAX_LANES (768)
// lanes and runs a thread per lane above it (scalar_mul_kernel, all 64
// bits from the canonical infinity, pt_mul_u64). On an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 3, g1_scalar_mul_layouts_ms) the team
// layout took 1.144 ms at 32 lanes, 1.696 at 512, 2.471 at 768, 2.735 at
// 1,024 and 9.523 at 4,096; the thread layout 2.63-2.68 ms at every
// count: the crossover lies between 768 and 1,024 lanes. The verifier's
// chunks (<= 32 lanes) take the team layout; K11's 4,096 lanes run the
// signed-window chain below instead (bls_g1_scalar_mul_wide64), and
// chip_smoke.py times the thread layout beside it.
// The 256-bit G1 ladder (bls_g1_scalar_mul_wide, K9's ladder MSM: 4,096
// lanes) is a signed fixed-window chain. Each scalar is Booth-recoded in
// the kernel, from its words, into 256 / W + 1 = 65 digits of W = 4 bits
// (WIDE_W), |d| <= 8, each digit read from W + 1 bits of the words with
// no carry from digit to digit (wide_digit); a lane builds its table
// 1 P .. 8 P (4 doublings, 3 additions) and then, from its top nonzero
// digit's entry (the uniform chain's first addition to the canonical
// infinity gives it), runs W doublings and one addition of
// sign(d) T[|d| - 1] a window, none for a zero digit (one in 16): for a
// 255-bit scalar about 252 doublings and 60 additions, against 256
// doublings and 256 additions of the bit ladder that it replaces. Every
// infinity out is the canonical (1, 1, 0). No GLV split:
// phi(x, y) = (beta x, y) is [lambda] P only on the r-order subgroup, and
// this function (as the JAX package's batch_g1_scalar_mul) takes any
// curve point. It runs a 4-lane G1 team a lane (g1_wide_team_kernel,
// g1_team.cuh narrowed to 4 lanes with a mask of its own, eight teams a
// warp, 512 warps at 4,096 lanes; the table, accumulator and addend in
// shared memory, 2.4 KB a team), so a doubling is 3 rounds of products on
// lanes, an addition 5. A team round issues a whole warp's product for
// its warp's teams, whose rounds fill at most 4 lanes: 8-lane teams, four
// a warp, issued twice the product streams for the same chains. On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 8, 4,096 lanes)
// 4-lane teams took 2.60 ms at W = 4 and 2.72 at W = 5, 8-lane teams 5.36
// and 5.35, a thread a lane 5.09 and 5.00 (the bit ladder it replaces:
// 13.88). The thread layout (scalar_mul_wide_kernel, blocks of one warp,
// the table in local memory, pt_double / pt_add, the same steps) stays
// for chip_smoke.py's comparison alone (bls_g1_scalar_mul_wide_layout).
// The plain version (pt_mul_words) takes the same steps, so the output
// equals it limb for limb.
// K11's 64-bit draws (bls_g1_scalar_mul_wide64) run the same kernel over
// 64 / W + 1 = 17 windows (g1_wide_team_kernel<2>: the scalar's words are
// a template parameter; the top window holds bit 63 alone), each [n]
// int64 read as an unsigned 64-bit word (half the draws have bit 63 set),
// with no padding on the host: a random draw takes ~62 doublings and ~15
// additions after its top digit, against 63 and ~31 of the bit ladder
// (pt_mul_u64), which ran a thread a lane at 4,096 lanes. On an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 3) it took 0.719 ms at
// 4,096 lanes, the thread layout of the bit ladder 2.64 on the same lanes.
// Its output equals its plain version's (pt_mul_words over u64_words),
// not pt_mul_u64's: the same points in other Jacobian coordinates.
// The conversions to affine (bls_g1_to_affine, bls_g2_to_affine) take
// Montgomery's batch inversion, one block of LANES_PER_BLOCK (64) threads
// per 64 lanes, a lane a thread: the verifier's 32 and 33 lanes are one
// block and one inversion, and larger n runs one inversion a block, the
// blocks side by side (K9's table, msm.cu: 2,048 blocks at 4,096 points). Each lane forms an Fq value d_i: Z_i for G1, the
// norm N(Z_i) = Z_i.c0^2 + Z_i.c1^2 for G2 (Z^-1 = conj(Z) / N(Z); with
// -1 a non-residue, N(Z) = 0 only at Z = 0), so the scan and the inversion
// run in Fq for both groups. An infinity lane (d_i = 0) and each lane past
// n counts as 1 in the products and writes (0, 0) (past n: nothing), as
// the plain version's inverse of 0 is 0: no other lane is spoiled. The
// block's inclusive prefix and suffix products of the d_i are a
// Hillis-Steele scan in shared memory, log2(64) = 6 levels of two
// independent products on mont_mul_cs<12> (K8's quotient, kzg_fr.cu, with
// 12 limbs); one thread inverts the block's product D with fp_inv_binary
// (the binary extended Euclid, no product); lane i then takes
// d_i^-1 = prefix_{i-1} suffix_{i+1} D^-1 and z^-1 = d_i^-1 (G1) or
// conj(Z_i) d_i^-1 (G2, 2 Fq products), then z^-2, x z^-2, z^-3, y z^-3.
// Montgomery factors: the d_i are Montgomery values d_i R, every product
// of two values a R, b R is a b R, and mont_inv_binary returns D^-1 R for
// D R, so each lane's d_i^-1 R, z^-1 and coordinates are Montgomery
// values. Every product leaves a fully reduced value and each inverse is
// unique, so the order of operations changes no limb: the output equals
// the plain version's (ops/bls381.py to_affine_plain) limb for limb.
// A segment sum is the plain version's tree over the (power-of-two)
// padded axis: pairs (0,1), (2,3), ... and then their sums. Its cost is
// latency: a level's additions depend on the level below, and one
// one-thread Jacobian addition took ~72k cycles. So every level gives each
// addition a worker of its own, and the faster the worker the better:
//   * Blocks: each pass cuts every segment into aligned sub-segments of up
//     to SEG_G1_SPAN (128) or SEG_G2_SPAN (8) points, a block each, and
//     the next pass sums their roots (an aligned sub-segment is a subtree
//     of the plain tree, so the limbs stay): [32, 512] is 128 blocks, then
//     32 of 4 roots; [1, 4096] 32 blocks, then one of 32 roots; G2 [1, 32]
//     4 blocks, then one. A block loads its points into shared memory at
//     once (a G1 point 144 bytes, a G2 one 288) and keeps its tree there,
//     one __syncthreads() a level. The time is the levels' latency: at
//     [32, 512] and [3, 512] alike (analysis/step_probe.py --segment-levels).
//   * G1's first level, where a block has more pairs than teams (128
//     points), is a thread an addition, with Z = 1 (Montgomery's one)
//     tested per operand: the verifier stages pubkeys affine, so both are,
//     and the same formula's field elements need 6 products (11 with one
//     affine operand, 16 with none; seg_add_first).
//   * The other levels are a team an addition: G1 on g1_team.cuh's team
//     narrowed to 8 lanes (a step uses 5; four teams a warp, each with a
//     __syncwarp mask of its own, 32 a block of 256 threads, so one block
//     holds a level of 32 additions); G2 on g2_team.cuh's warp team, 4 a
//     block (its shared operands, 6 KB a team, bound the count), with
//     team_madd where the addend is affine.
// Every path computes pt_add's field elements, fully reduced, so the
// output equals the plain version's limb for limb (host-shim and card
// tests hold every case of pt_add).
//
// What bounds it: 32-bit multiply-adds. The bound counts the least Fq
// multiplications the function needs, from the cheapest known formulas,
// whatever this kernel does (an Fq2 product is 3 Fq ones, a square 2; a
// power to a fixed e at the floor of any addition chain, ceil(log2 e);
// an inverse, where the kernel takes the binary extended Euclid, as that
// Euclid's own 32-bit operations on this run's value):
// a Jacobian doubling (a = 0) is 2M + 5S, 1M + 5S on an affine input; an
// addition 11M + 5S, 7M + 4S with an affine addend. In Fq that is 7, 6,
// 16 and 11; in Fq2 16, 13, 43 and 29.
//   * 64-bit ladder with scalar k on a Jacobian point: (bits(k) - 1)
//     doublings and (popcount(k) - 1) additions; for a 64-bit draw about 63
//     and 31, so G1 63*7 + 31*16 = 937 and G2 63*16 + 31*43 = 2,341. On
//     an affine G2 point the first doubling is 13 and every addition a
//     mixed one, 29: 13 + 62*16 + 31*29 = 1,904.
//   * segment sum over a row's live points (Z != 0; pads need nothing),
//     its repeats and cancellations taken as known (chip_smoke
//     _segment_fq_muls): a point and its negation cost nothing; c copies
//     of one point are c times it (doublings, the first an affine one, 6,
//     G2 13, where a copy is affine, then additions); the m distinct
//     values left add up in a chain, the lesser of: two affine points at
//     Z1 = Z2 = 1 (4M + 2S: 6; G2 16), then a mixed addition (11; 29) for
//     each further affine one and a general one (16; 43) for each
//     Jacobian one; or a chain from a Jacobian one, every affine one
//     mixed. A pubkey row of 488 with one repeated pair (phase 3) is an
//     affine doubling and 486 mixed additions, 5,352; 488 distinct keys
//     6 + 486 * 11, the same. The kernel's tree does more: k / 2 affine
//     additions (6 each) and k / 2 - 1 general ones, 11 k - 16 in G1, and
//     a team round keeps at most 5 of 8 lanes multiplying.
//   * to affine over n live lanes (an infinity needs nothing): one batch
//     inversion in Fq (Montgomery's trick: 3(n - 1) products and one
//     inverse of the product D), then z^-1, z^-2, x z^-2, z^-3, y z^-3 per
//     lane: G1 3(n - 1) + 4n; G2 3(n - 1) + 15n (the norm 2, conj(Z) N^-1
//     2, an Fq2 square 2, three Fq2 products 9). The inverse is counted as
//     the binary Euclid does it on this run's D (chip_smoke._binary_inv_ops):
//     a round's shift of u or v by up to 31 bits 12 operations and x / 2^k
//     mod p 25 multiplies and 24 operations, a subtraction round 24
//     operations, and one product by R^3 (no other product: a^(p-2), 381
//     products, would count a chain this kernel does not run). Its
//     multiplies are held to the multiply rate and all its operations to
//     the issue rate, 128 a clock an SM.
//   * 256-bit ladder (bls_g1_scalar_mul_wide): it computes sum s_i P_i
//     with the tree sum after it, the function K9 (csrc/msm.cu)
//     computes, so its bound is K9's least work for the same scalars
//     (chip_smoke.msm_fq_muls): what the per-point chains do beyond it,
//     ~256 doublings and ~64 additions a point, is what the ratio shows.
//     K11's 64-bit chain (bls_g1_scalar_mul_wide64) likewise: Pippenger's
//     least work for its 64-bit scalars (msm_fq_muls(..., bits=64)).
// chip_smoke.py (BLS_FQ_MULS) turns these counts into a bound: 588 32-bit
// multiplies per Montgomery multiplication over 64 multiplies per clock
// per SM (CUDA C++ Programming Guide, compute capability 9.0), 132 SMs,
// 1.98 GHz.
#include "g1_team.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define LANES_PER_BLOCK 64
// bls_g1_scalar_mul's layout: a warp team per lane up to this many lanes,
// a thread per lane above it (measured crossover: see the header)
#define G1_TEAM_MAX_LANES 768

template <class F>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
scalar_mul_kernel(const long long* pts, const long long* k, long long* out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p3 = 3 * limbs<F>::n;
  jac<F> p, r;
  pt_ld(p, pts + i * p3);
  pt_mul_u64(r, p, (unsigned long long)k[i]);
  pt_st(out + i * p3, r);
}

// a warp per lane: pts [n, 3, 2, 12] Jacobian G2, k [n] -> out [n, 3, 2, 12]
__global__ void __launch_bounds__(G2_TEAM)
g2_ladder_kernel(const long long* pts, const long long* k, long long* out) {
  __shared__ fp opa[G2_TEAM], opb[G2_TEAM], prod[G2_TEAM];
  __shared__ fp2 slots[G2_SLOTS];
  __shared__ jac<fp2> pt[2];
  const int lane = threadIdx.x;
  const long long i = blockIdx.x;
  const G2Team tm{lane, opa, opb, prod, slots};
  jac<fp2>&p = pt[0], &acc = pt[1];
  if (lane < 3) fp2_ld(lane == 0 ? p.x : lane == 1 ? p.y : p.z, pts + i * 72 + lane * 24);
  tm.sync();
  const unsigned long long s = (unsigned long long)k[i];
  int top = 63;
  while (top >= 0 && !((s >> top) & 1)) top--;
  if (top < 0) team_inf(tm, acc); else team_copy(tm, acc, p);
  fp2 one;
  fp2_one(one);
  const bool affine = fp2_eq(p.z, one);
  for (int b = top - 1; b >= 0; b--) {
    team_dbl(tm, acc, acc, false);
    if ((s >> b) & 1) {
      if (affine) team_madd(tm, acc, acc, p); else team_add(tm, acc, acc, p, false);
    }
  }
  if (lane < 3) fp2_st(out + i * 72 + lane * 24, lane == 0 ? acc.x : lane == 1 ? acc.y : acc.z);
}

// a warp per lane: pts [n, 3, 12] Jacobian G1, k [n] -> out [n, 3, 12]
__global__ void __launch_bounds__(G1_TEAM)
g1_ladder_kernel(const long long* pts, const long long* k, long long* out) {
  __shared__ fp slots[G1_SLOTS];
  __shared__ jac<fp> pt[2];
  const int lane = threadIdx.x;
  const long long i = blockIdx.x;
  const G1Team tm{lane, slots};
  jac<fp>&p = pt[0], &acc = pt[1];
  if (lane < 3) fp_ld(lane == 0 ? p.x : lane == 1 ? p.y : p.z, pts + i * 36 + lane * 12);
  tm.sync();
  const unsigned long long s = (unsigned long long)k[i];
  int top = 63;
  while (top >= 0 && !((s >> top) & 1)) top--;
  if (top < 0) team_inf(tm, acc); else team_copy(tm, acc, p);
  for (int b = top - 1; b >= 0; b--) {
    team_dbl(tm, acc, acc);
    if ((s >> b) & 1) team_add(tm, acc, acc, p);
  }
  if (lane < 3) fp_st(out + i * 36 + lane * 12, lane == 0 ? acc.x : lane == 1 ? acc.y : acc.z);
}

// ---------------------------------------------------------------------------
// The 256-bit G1 ladder (K9 ladder): signed windows of WIDE_W bits
// ---------------------------------------------------------------------------

// a thread a lane: blocks of one warp spread the 4,096 lanes over 128 SMs
#define WIDE_THREADS 32
// G1 teams of 4 lanes (a step uses lanes 0-3), eight a warp and a block
#define WIDE_TEAM 4
#define WIDE_TEAMS 8
// the window: 4 bits (5 measured slower, see the header)
#define WIDE_W 4
#define WIDE_ENTRIES (1 << (WIDE_W - 1))  // the table: 1 P .. 8 P

// the scalar's 8 words (big-endian int32, ops/fr.py's layout) as
// little-endian 32-bit words s[0..7]
DEV void wide_words(uint32_t* s, const int* words) {
  for (int j = 0; j < 8; j++) s[j] = (uint32_t)words[7 - j];
}

// lane i's scalar as NW little-endian 32-bit words: K9's [n, 8] int32
// canonical big-endian words (NW = 8), or K11's [n] int64 bit patterns
// read as unsigned 64-bit (NW = 2: a draw with bit 63 set arrives
// negative)
template <int NW>
DEV void wide_load(uint32_t* s, const void* scalars, long long i) {
  if constexpr (NW == 8) {
    wide_words(s, (const int*)scalars + i * 8);
  } else {
    static_assert(NW == 2, "K9's 8 words or K11's 2");
    const unsigned long long k = ((const unsigned long long*)scalars)[i];
    s[0] = (uint32_t)k;
    s[1] = (uint32_t)(k >> 32);
  }
}

// The Booth-recoded digit i of the (32 NW)-bit s: from the W + 1 bits
// i W - 1 .. i W + W - 1 (W = WIDE_W, bit -1 is 0), d_i = (window's low
// W - 1 bits) + (the bit below the window) - 2^(W-1) (the window's top
// bit), so |d_i| <= 2^(W-1) and sum_i d_i 2^(i W) = s over 32 NW / W + 1
// windows (their top bit lies above the scalar's: K9's 256 bits take 65,
// K11's 64 bits 17, the top one bit 63 alone). Each digit is read from the
// words alone: no carry chain runs from digit to digit.
template <int NW>
DEV int wide_digit(const uint32_t* s, int i) {
  const int W = WIDE_W;
  const int lo = i * W - 1;
  uint32_t f;
  if (lo < 0) {
    f = s[0] << 1;
  } else {
    const int q = lo >> 5;
    const unsigned long long two = s[q] | (q < NW - 1 ? (unsigned long long)s[q + 1] << 32 : 0ull);
    f = (uint32_t)(two >> (lo & 31));
  }
  f &= (1u << (W + 1)) - 1;
  return (int)((f >> 1) & ((1u << (W - 1)) - 1)) + (int)(f & 1u) - (int)((f >> W) << (W - 1));
}

// the highest window whose digit is not 0, or -1 for s = 0
template <int NW>
DEV int wide_top(const uint32_t* s) {
  int top = NW * 32 / WIDE_W;
  while (top >= 0 && !wide_digit<NW>(s, top)) top--;
  return top;
}

// sign(d) T[|d| - 1], d != 0: the negation -(X, Y, Z) is (X, -Y, Z)
DEV void wide_entry(jac<fp>& r, const jac<fp>* tab, int d) {
  r = tab[(d < 0 ? -d : d) - 1];
  if (d < 0) fp_neg(r.y, r.y);
}

// pts [n, 3, 12] G1, words [n, 8] int32 (canonical big-endian 256-bit
// scalars) -> out [n, 3, 12]: a thread a lane, the table in local memory
__global__ void __launch_bounds__(WIDE_THREADS)
scalar_mul_wide_kernel(const long long* pts, const int* words, long long* out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[8];
  wide_words(s, words + i * 8);
  jac<fp> tab[WIDE_ENTRIES], acc;
  pt_ld(tab[0], pts + i * 36);
  // m P: 2 (m / 2) P for an even m, (m - 1) P + P for an odd one
  for (int m = 2; m <= WIDE_ENTRIES; m++) {
    if (m & 1) pt_add(tab[m - 1], tab[m - 2], tab[0]); else pt_double(tab[m - 1], tab[m / 2 - 1]);
  }
  const int top = wide_top<8>(s);
  if (top < 0) pt_inf(acc); else wide_entry(acc, tab, wide_digit<8>(s, top));
  for (int w = top - 1; w >= 0; w--) {
    for (int k = 0; k < WIDE_W; k++) pt_double(acc, acc);
    const int d = wide_digit<8>(s, w);
    if (d) {
      jac<fp> q;
      wide_entry(q, tab, d);
      pt_add(acc, acc, q);
    }
  }
  if (fp_is_zero(acc.z)) pt_inf(acc);  // every infinity out is (1, 1, 0)
  pt_st(out + i * 36, acc);
}

// wide_entry on a team
DEV void team_entry(const G1Team& tm, jac<fp>& r, const jac<fp>* tab, int d) {
  const jac<fp>& e = tab[(d < 0 ? -d : d) - 1];
  if (tm.lane == 0) r.x = e.x;
  if (tm.lane == 1) {
    if (d < 0) fp_neg(r.y, e.y); else r.y = e.y;
  }
  if (tm.lane == 2) r.z = e.z;
  tm.sync();
}

// the same on 4-lane teams, a team a lane; a team's table, accumulator
// and addend in shared memory; scalars of NW words (wide_load)
template <int NW>
__global__ void __launch_bounds__(WIDE_TEAM * WIDE_TEAMS)
g1_wide_team_kernel(const long long* pts, const void* scalars, long long* out, long long n) {
  __shared__ jac<fp> tabs[WIDE_TEAMS][WIDE_ENTRIES];
  __shared__ jac<fp> accs[WIDE_TEAMS], adds[WIDE_TEAMS];
  __shared__ fp slots[WIDE_TEAMS][G1_SLOTS];
  const int t = threadIdx.x, team = t / WIDE_TEAM;
  const long long i = blockIdx.x * (long long)WIDE_TEAMS + team;
  if (i >= n) return;  // the whole team: its barriers name its lanes alone
  const G1Team tm{t % WIDE_TEAM, slots[team], 0xfu << (t & 28)};
  jac<fp>* tab = tabs[team];
  jac<fp>&acc = accs[team], &q = adds[team];
  uint32_t s[NW];
  wide_load<NW>(s, scalars, i);
  if (tm.lane < 3) fp_ld(tm.lane == 0 ? tab[0].x : tm.lane == 1 ? tab[0].y : tab[0].z, pts + i * 36 + tm.lane * 12);
  tm.sync();
  for (int m = 2; m <= WIDE_ENTRIES; m++) {
    if (m & 1) team_add(tm, tab[m - 1], tab[m - 2], tab[0]); else team_dbl(tm, tab[m - 1], tab[m / 2 - 1]);
  }
  const int top = wide_top<NW>(s);
  if (top < 0) team_inf(tm, acc); else team_entry(tm, acc, tab, wide_digit<NW>(s, top));
  for (int w = top - 1; w >= 0; w--) {
    for (int k = 0; k < WIDE_W; k++) team_dbl(tm, acc, acc);
    const int d = wide_digit<NW>(s, w);  // the team's own: its lanes agree
    if (d) {
      team_entry(tm, q, tab, d);
      team_add(tm, acc, acc, q);
    }
  }
  const bool at_inf = fp_is_zero(acc.z);
  tm.sync();  // every lane has read Z before team_inf writes it
  if (at_inf) team_inf(tm, acc);
  if (tm.lane < 3) fp_st(out + i * 36 + tm.lane * 12, tm.lane == 0 ? acc.x : tm.lane == 1 ? acc.y : acc.z);
}


// ---------------------------------------------------------------------------
// Segment sums: a block a sub-segment, a worker an addition at every level
// ---------------------------------------------------------------------------

// G1: teams of 8 lanes (a team step uses lanes 0-4), four a warp, 32 a
// block; a block sums up to SEG_G1_SPAN points: 64 additions on threads,
// then 6 team levels
#define SEG_G1_TEAM 8
#define SEG_G1_TEAMS 32
#define SEG_G1_THREADS (SEG_G1_TEAM * SEG_G1_TEAMS)
#define SEG_G1_SPAN 128
// G2: warp teams (g2_team.cuh), four a block over up to 8 points
#define SEG_G2_TEAMS 4
#define SEG_G2_SPAN 8

// P + Q on one thread for the first level, with every case of pt_add and
// Z = 1 (Montgomery's one) tested per operand: both affine 4M + 2S (6
// products), one affine 7M + 4S (11), neither 11M + 5S (16). A product by
// one is exact, so each branch leaves pt_add's limbs. Every product is
// the one out-of-line copy the teams run (fq_mul1): inlined copies, each
// run once a launch, made the level slower (analysis/step_probe.py
// --segment-levels).
DEVNI void seg_add_first(jac<fp>& r, const jac<fp>& p, const jac<fp>& q) {
  if (fp_is_zero(p.z)) { r = q; return; }
  if (fp_is_zero(q.z)) { r = p; return; }
  fp one, u1, u2, s1, s2, t;
  fp_one(one);
  const bool a1 = fp_eq(p.z, one), a2 = fp_eq(q.z, one);
  if (a2) {
    u1 = p.x;
    s1 = p.y;
  } else {  // U1 = X1 Z2^2, S1 = Y1 (Z2^2 Z2)
    fq_mul1(t, q.z, q.z);
    fq_mul1(u1, p.x, t);
    fq_mul1(t, t, q.z);
    fq_mul1(s1, p.y, t);
  }
  if (a1) {
    u2 = q.x;
    s2 = q.y;
  } else {  // U2 = X2 Z1^2, S2 = Y2 (Z1^2 Z1)
    fq_mul1(t, p.z, p.z);
    fq_mul1(u2, q.x, t);
    fq_mul1(t, t, p.z);
    fq_mul1(s2, q.y, t);
  }
  if (fp_eq(u1, u2)) {
    if (fp_eq(s1, s2)) pt_double(r, p); else pt_inf(r);
    return;
  }
  fp h, h2, rr, i, rr2, j, v, x3, y3, sj, z3;
  fp_sub(h, u2, u1);
  fp_add(h2, h, h);
  fp_sub(rr, s2, s1);
  fp_add(rr, rr, rr);
  fq_mul1(i, h2, h2);  // I = (2H)^2
  fq_mul1(rr2, rr, rr);
  fq_mul1(j, h, i);  // J = H I, V = U1 I
  fq_mul1(v, u1, i);
  fp_sub(x3, rr2, j);  // X3 = rr^2 - J - 2V
  fp_add(t, v, v);
  fp_sub(x3, x3, t);
  fp_sub(t, v, x3);
  fq_mul1(y3, rr, t);  // rr (V - X3), S1 J
  fq_mul1(sj, s1, j);
  fp_add(t, sj, sj);
  fp_sub(y3, y3, t);
  // Z3 = 2 (Z1 Z2) H
  if (a1 && a2) z3 = h;
  else if (a1) fq_mul1(z3, q.z, h);
  else if (a2) fq_mul1(z3, p.z, h);
  else {
    fq_mul1(z3, p.z, q.z);
    fq_mul1(z3, z3, h);
  }
  fp_add(r.z, z3, z3);
  r.x = x3;
  r.y = y3;
}

// an addition on a team: G1's team_add; G2's team_madd where Q is affine
// (Z = 1, tested per operand), its team_add (a = 0) otherwise
DEV void seg_team_add(const G1Team& tm, jac<fp>& r, const jac<fp>& p, const jac<fp>& q) { team_add(tm, r, p, q); }
DEV void seg_team_add(const G2Team& tm, jac<fp2>& r, const jac<fp2>& p, const jac<fp2>& q) {
  fp2 one;
  fp2_one(one);
  if (fp2_eq(q.z, one)) team_madd(tm, r, p, q); else team_add(tm, r, p, q, false);
}

// `words` limbs (int64, each a 32-bit value) into shared memory as 32-bit
// words, spread over the block: a point [3, w] is a jac<F> word for word
DEV void seg_load(void* dst, const long long* src, int words) {
  uint32_t* w = (uint32_t*)dst;
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = (uint32_t)src[i];
}

// The tree's levels on teams over sp[0..m) (m a power of two, at most twice
// the block's teams) -> sp[0]: at stride s team j adds sp[i + s] into sp[i],
// i = 2 s j, the plain tree's pairs; no team reads another's output before
// the level's barrier.
template <class Team, class F>
DEV void seg_tree(const Team& tm, int team, jac<F>* sp, int m) {
  for (int s = 1; s < m; s *= 2) {
    const int i = 2 * s * team;
    if (i < m) seg_team_add(tm, sp[i], sp[i], sp[i + s]);
    __syncthreads();
  }
}

// pts [blocks, span, 3, 12] -> out [blocks, 3, 12]: a block sums one
// aligned sub-segment of `span` points (a power of two, at most
// SEG_G1_SPAN) in shared memory. Above 2 * SEG_G1_TEAMS points the first
// level runs a thread an addition (seg_add_first), in place; the rest of
// the tree runs a team an addition. sp and the slots fill the 48 KB of
// static shared memory.
__global__ void __launch_bounds__(SEG_G1_THREADS)
g1_segment_sum_kernel(const long long* pts, long long* out, int span) {
  __shared__ jac<fp> sp[SEG_G1_SPAN];
  __shared__ fp slots[SEG_G1_TEAMS][G1_SLOTS];
  const int t = threadIdx.x, team = t / SEG_G1_TEAM;
  const G1Team tm{t % SEG_G1_TEAM, slots[team], 0xffu << (t & 24)};
  seg_load(sp, pts + blockIdx.x * (long long)span * 36, span * 36);
  __syncthreads();
  int m = span;  // points in sp for the team levels
  if (span > 2 * SEG_G1_TEAMS) {
    m = span / 2;
    jac<fp> p, q, r;
    if (t < m) {
      p = sp[2 * t];
      q = sp[2 * t + 1];
    }
    __syncthreads();  // every pair read before sp[t] is written
    if (t < m) {
      seg_add_first(r, p, q);
      sp[t] = r;
    }
    __syncthreads();
  }
  seg_tree(tm, team, sp, m);
  if (t < 36) out[blockIdx.x * 36ll + t] = ((const uint32_t*)sp)[t];
}

// pts [blocks, span, 3, 2, 12] -> out [blocks, 3, 2, 12], span at most
// SEG_G2_SPAN: every level on warp teams
__global__ void __launch_bounds__(SEG_G2_TEAMS * G2_TEAM)
g2_segment_sum_kernel(const long long* pts, long long* out, int span) {
  __shared__ jac<fp2> sp[SEG_G2_SPAN];
  __shared__ fp opa[SEG_G2_TEAMS][G2_TEAM], opb[SEG_G2_TEAMS][G2_TEAM], prod[SEG_G2_TEAMS][G2_TEAM];
  __shared__ fp2 slots[SEG_G2_TEAMS][G2_SLOTS];
  const int t = threadIdx.x, team = t / G2_TEAM;
  const G2Team tm{t % G2_TEAM, opa[team], opb[team], prod[team], slots[team]};
  seg_load(sp, pts + blockIdx.x * (long long)span * 72, span * 72);
  __syncthreads();
  seg_tree(tm, team, sp, span);
  if (t < 72) out[blockIdx.x * 72ll + t] = ((const uint32_t*)sp)[t];
}

static int seg_span(const fp*) { return SEG_G1_SPAN; }
static int seg_span(const fp2*) { return SEG_G2_SPAN; }
static void seg_launch(const fp*, const long long* in, long long* out, long long blocks, int span, cudaStream_t st) {
  g1_segment_sum_kernel<<<(unsigned)blocks, SEG_G1_THREADS, 0, st>>>(in, out, span);
}
static void seg_launch(const fp2*, const long long* in, long long* out, long long blocks, int span, cudaStream_t st) {
  g2_segment_sum_kernel<<<(unsigned)blocks, SEG_G2_TEAMS * G2_TEAM, 0, st>>>(in, out, span);
}

// The passes of a segment sum over [n, k] in sub-segments of up to `span`
// points: returns their count, a kernel launch each, and sets *scratch to
// the points of buf that segment_sum_passes uses: the first two passes'
// roots when they are not the output (n k / span + n k / span^2 at most;
// a later pass reuses that room).
static int seg_plan(long long n, long long k, long long span, long long* scratch) {
  int passes = 1;
  *scratch = 0;
  for (long long len = k; len > span; len /= span, passes++) {
    if (passes <= 2) *scratch += n * (len / span);
  }
  return passes;
}

// pts [n, k, 3, w] -> out [n, 3, w] in passes: each cuts every segment into
// aligned sub-segments of up to seg_span points, a block each, whose roots
// are the next pass's segments (subtrees of the plain tree, so the limbs
// stay). The roots alternate between buf's start and the points after the
// previous pass's (seg_plan counts them).
template <class F>
static int segment_sum_passes(const long long* pts, long long* buf, long long* out, long long n, int k, cudaStream_t st) {
  const long long p3 = 3 * limbs<F>::n;
  const long long* src = pts;
  long long* dst = buf;
  for (long long len = k;;) {
    const long long span = len < seg_span((F*)0) ? len : seg_span((F*)0);
    const long long blocks = n * (len / span);
    long long* o = span == len ? out : dst;
    seg_launch((F*)0, src, o, blocks, (int)span, st);
    const int err = (int)cudaGetLastError();
    if (err || o == out) return err;
    src = o;
    dst = o == buf ? buf + blocks * p3 : buf;
    len /= span;
  }
}

// d = Z (G1) or N(Z) = Z.c0^2 + Z.c1^2 (G2): the lane's value in the scan
DEV void aff_denom(fp& d, const fp& z) { d = z; }
DEV void aff_denom(fp& d, const fp2& z) {
  fp t;
  fq_mulx(d, z.c0, z.c0);
  fq_mulx(t, z.c1, z.c1);
  fp_add(d, d, t);
}
// z^-1 from d^-1: itself (G1), conj(Z) / N(Z) (G2)
DEV void aff_zinv(fp& zi, const fp&, const fp& dinv) { zi = dinv; }
DEV void aff_zinv(fp2& zi, const fp2& z, const fp& dinv) {
  fp t;
  fq_mulx(zi.c0, z.c0, dinv);
  fq_mulx(t, z.c1, dinv);
  fp_neg(zi.c1, t);
}

// pts [n, 3, w] -> out [n, 2, w]: a lane a thread, one batch inversion a
// block (see the header)
template <class F>
__global__ void __launch_bounds__(LANES_PER_BLOCK)
to_affine_kernel(const long long* pts, long long* out, long long n) {
  __shared__ fp spre[LANES_PER_BLOCK], ssuf[LANES_PER_BLOCK];
  __shared__ fp sinv;
  const int t = threadIdx.x;
  const long long i = blockIdx.x * (long long)LANES_PER_BLOCK + t;
  const int w = limbs<F>::n;
  fp one, d;
  fp_one(one);
  d = one;
  F z;
  bool inf = true;  // no lane, or Z = 0: 1 in the products, (0, 0) out
  if (i < n) {
    f_ld(z, pts + i * 3 * w + 2 * w);
    aff_denom(d, z);
    inf = fp_is_zero(d);
    if (inf) d = one;
  }
  // inclusive prefix and suffix products of the block's d_i; a lane with
  // no partner at a level multiplies by 1, so both products run on every
  // lane without a branch
  fp pre = d, suf = d;
  spre[t] = d;
  ssuf[t] = d;
  __syncthreads();
  for (int h = 1; h < LANES_PER_BLOCK; h <<= 1) {
    const fp a = t >= h ? spre[t - h] : one;
    const fp b = t + h < LANES_PER_BLOCK ? ssuf[t + h] : one;
    __syncthreads();
    fq_mulx(pre, pre, a);
    fq_mulx(suf, suf, b);
    spre[t] = pre;
    ssuf[t] = suf;
    __syncthreads();
  }
  // the other lanes' product: D / d_i
  fp rest;
  {
    const fp a = t > 0 ? spre[t - 1] : one;
    const fp b = t + 1 < LANES_PER_BLOCK ? ssuf[t + 1] : one;
    fq_mulx(rest, a, b);
  }
  if (t == 0) fp_inv_binary(sinv, spre[LANES_PER_BLOCK - 1]);  // D^-1 R
  __syncthreads();
  if (i >= n) return;
  F ax, ay;
  if (inf) {
    f_zero(ax);
    f_zero(ay);
  } else {
    F x, y, zi, zi2, zi3;
    fp dinv;
    fq_mulx(dinv, rest, sinv);  // d_i^-1
    aff_zinv(zi, z, dinv);
    f_ld(x, pts + i * 3 * w);
    f_ld(y, pts + i * 3 * w + w);
    fx_sqr(zi2, zi);
    fx_mul(ax, x, zi2);
    fx_mul(zi3, zi2, zi);
    fx_mul(ay, y, zi3);
  }
  f_st(out + i * 2 * w, ax);
  f_st(out + i * 2 * w + w, ay);
}

static unsigned grid_for(long long n) { return (unsigned)((n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK); }

extern "C" {

// layout 1: a warp team per lane; 0: a thread per lane
int bls_g1_scalar_mul_layout(const long long* pts, const long long* k, long long* out, long long n, int team,
                             void* stream) {
  if (team) g1_ladder_kernel<<<(unsigned)n, G1_TEAM, 0, (cudaStream_t)stream>>>(pts, k, out);
  else scalar_mul_kernel<fp><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, k, out, n);
  return (int)cudaGetLastError();
}

int bls_g1_scalar_mul(const long long* pts, const long long* k, long long* out, long long n, void* stream) {
  return bls_g1_scalar_mul_layout(pts, k, out, n, n <= G1_TEAM_MAX_LANES, stream);
}

int bls_g2_scalar_mul(const long long* pts, const long long* k, long long* out, long long n, void* stream) {
  g2_ladder_kernel<<<(unsigned)n, G2_TEAM, 0, (cudaStream_t)stream>>>(pts, k, out);
  return (int)cudaGetLastError();
}

// team 1: a 4-lane team per lane (bls_g1_scalar_mul_wide's layout), 0: a
// thread per lane (kept for chip_smoke.py's comparison of the layouts)
int bls_g1_scalar_mul_wide_layout(const long long* pts, const int* words, long long* out, long long n, int team,
                                  void* stream) {
  if (team) {
    g1_wide_team_kernel<8><<<(unsigned)((n + WIDE_TEAMS - 1) / WIDE_TEAMS), WIDE_TEAM * WIDE_TEAMS, 0,
                             (cudaStream_t)stream>>>(pts, words, out, n);
  } else {
    scalar_mul_wide_kernel<<<(unsigned)((n + WIDE_THREADS - 1) / WIDE_THREADS), WIDE_THREADS, 0,
                             (cudaStream_t)stream>>>(pts, words, out, n);
  }
  return (int)cudaGetLastError();
}

int bls_g1_scalar_mul_wide(const long long* pts, const int* words, long long* out, long long n, void* stream) {
  return bls_g1_scalar_mul_wide_layout(pts, words, out, n, 1, stream);
}

// K11: [n] 64-bit scalars (int64 bit patterns, read unsigned), the same
// chain over 17 windows on the same 4-lane teams
int bls_g1_scalar_mul_wide64(const long long* pts, const long long* k, long long* out, long long n, void* stream) {
  g1_wide_team_kernel<2><<<(unsigned)((n + WIDE_TEAMS - 1) / WIDE_TEAMS), WIDE_TEAM * WIDE_TEAMS, 0,
                           (cudaStream_t)stream>>>(pts, k, out, n);
  return (int)cudaGetLastError();
}

// *scratch: the points of buf that a segment sum over [n, k] needs (in G2
// if g2); returns its kernel launches
int bls_segment_sum_plan(int g2, long long n, int k, long long* scratch) {
  return seg_plan(n, k, g2 ? SEG_G2_SPAN : SEG_G1_SPAN, scratch);
}

// buf: bls_segment_sum_plan's points
int bls_g1_segment_sum(const long long* pts, long long* buf, long long* out, long long n, int k, void* stream) {
  return segment_sum_passes<fp>(pts, buf, out, n, k, (cudaStream_t)stream);
}

int bls_g2_segment_sum(const long long* pts, long long* buf, long long* out, long long n, int k, void* stream) {
  return segment_sum_passes<fp2>(pts, buf, out, n, k, (cudaStream_t)stream);
}

int bls_g1_to_affine(const long long* pts, long long* out, long long n, void* stream) {
  to_affine_kernel<fp><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, out, n);
  return (int)cudaGetLastError();
}

int bls_g2_to_affine(const long long* pts, long long* out, long long n, void* stream) {
  to_affine_kernel<fp2><<<grid_for(n), LANES_PER_BLOCK, 0, (cudaStream_t)stream>>>(pts, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
