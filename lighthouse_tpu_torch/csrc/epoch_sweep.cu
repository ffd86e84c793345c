// The Altair epoch sweep for Hopper (sm_90a): flag rewards and penalties,
// inactivity-score updates and inactivity penalties in one pass over the
// validator registry's columns.
//
// Replaces lighthouse_tpu/ops/epoch_sweep.py:39 (`epoch_sweep`), the fused
// pass that lighthouse_tpu/state_processing/altair.py runs in place of
// `process_inactivity_updates` + `process_rewards_and_penalties_altair`.
// Bit-exact with it: every quantity is an unsigned 64-bit integer that wraps
// mod 2^64 as JAX's uint64 does, and every division is an unsigned floor
// division. The host guard (altair.py `_device_sweep_applicable`) keeps
// effective_balance * score below 2^64, so the inactivity penalty's product
// never wraps on the states that reach the kernel.
//
// Bound: bytes. A validator reads 50 bytes (six u64 columns, the slashed
// byte, the participation-flag byte) and writes 16 (new balance, new
// score): 66 bytes. The least 32-bit operations it needs are about 160:
//   5 quotients (effective balance by the increment, up to three reward
//     numerators by one sweep-wide denominator, the inactivity numerator
//     by another; the penalty quotient by 64 is a shift), each a 64-bit
//     multiply-high by a reciprocal computed once per sweep plus a
//     correction, ~12 operations                                   =  60
//   ~6 64-bit multiplies, 3 IMAD each                              =  18
//   ~40 64-bit compares, selects and adds on 32-bit halves         = ~80
// Over 33.45 T 32-bit operations per second that is 4.8 ps a validator
// against 19.7 ps for its 66 bytes at 3.35 TB/s, so bytes bind
// (chip_smoke.py: EPOCH_SWEEP_BYTES, EPOCH_SWEEP_MIN_OPS).
//
// Design (`sweep_coop`, launcher `epoch_sweep`): one cooperative launch of
// one wave of blocks (the wrapper sizes the grid to the blocks the card
// holds at once; the runtime refuses a grid that cannot be co-resident).
// Each block owns one contiguous tile of validators.
//   Phase A streams the tile's effective balances, slashed bytes,
//     activation and exit epochs and flag bytes (evict-first loads, a
//     batch of kBatch validators a thread in flight), sums the three
//     unslashed participating balances of the previous epoch, and keeps
//     in dynamic shared memory what phase B needs of them: the effective
//     balance (8 bytes) and one byte of bits (the three flags, active in
//     the previous epoch, slashed) for the first `keep` validators of the
//     tile. The block's three sums go to its own slot of a [grid][3]
//     scratch: no atomics, no memset.
//   A grid barrier (cooperative_groups' grid sync).
//   Phase B: every block sums the [grid][3] partials (integer addition
//     mod 2^64, so any order gives the same sums), applies
//     max(sum, increment) and forms the three weight * upb / increment
//     factors once, then sweeps its tile again: the withdrawable epoch,
//     score and balance from device memory (through the read-only path:
//     evict-first loads here run slower, analysis/sweep_probe.py), the effective
//     balance and bits from shared memory, where the thread that reads a
//     validator is the one that kept it; new balance and score written
//     evict-first. Past `keep` it re-reads the five columns of phase A.
//     A thread's first batch of the three columns is loaded before the
//     barrier, so the memory keeps streaming while the blocks wait.
// Device-memory traffic is the bound's 66 bytes a validator while the
// tile fits in shared memory (~227 KB an SM: ~25,000 validators, ~3.3 M on
// 132 SMs), 92 above it.
// No general division is left in the per-validator work: the three
// runtime divisors (the increment, the reward denominator
// total_active_increments * 64, the inactivity denominator) each get
// Granlund and Montgomery's multiply-high reciprocal for N = 64 ("Division
// by invariant integers using multiplication", 1994, Figure 4.1), exact
// for every u64 numerator and every divisor >= 1; three lanes of a block
// compute them once, while the others stream phase A.
//
// The replaced design stays behind `epoch_sweep_two_pass`, for
// chip_smoke.py's comparison in the same call: a memset of a [3] sum, a
// grid-stride reduction with one atomicAdd a flag a block, and an
// elementwise pass that reads the five columns again and divides with the
// compiler's general 64-bit division: 92 bytes a validator, three stream
// operations a sweep.
//
// Plain C interface, bound with ctypes (lighthouse_tpu_torch/ops/epoch_sweep.py).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

// Altair participation flag weights (TIMELY_SOURCE/TARGET/HEAD) and their
// denominator.
__constant__ u64 kWeights[3] = {14, 26, 14};
constexpr u64 kWeightDenominator = 64;
constexpr int kTargetFlag = 1;
constexpr int kHeadFlag = 2;

// The nine scalars, in the order of the JAX function's `scalars` argument.
struct Scalars {
  u64 prev_epoch, curr_epoch, base_reward_per_increment, total_active_increments,
      in_leak, score_bias, score_recovery, inactivity_denom, eb_increment;
};

__device__ __forceinline__ Scalars load_scalars(const u64* s) {
  return Scalars{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

__device__ __forceinline__ bool prev_active(u64 activation, u64 exit, u64 epoch) {
  return activation <= epoch && epoch < exit;
}

// ---------------------------------------------------------------------------
// The cooperative sweep
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 1024;
// Validators a thread has in flight in each phase's loop.
constexpr int kBatch = 4;
// The bits byte a kept validator carries from phase A to phase B.
constexpr unsigned kFlagBits = 7u, kActiveBit = 8u, kSlashedBit = 16u;

// q = floor(n / d) as t = umulhi(m, n), q = (t + ((n - t) >> sh1)) >> sh2.
struct Recip {
  u64 m;
  unsigned sh1, sh2;
};

// Granlund-Montgomery's reciprocal of d >= 1 for N = 64: l = ceil(log2 d),
// m = floor(2^64 (2^l - d) / d) + 1, sh1 = min(l, 1), sh2 = max(l - 1, 0).
// 2^l - d < d, so the quotient fits in 64 bits; one restoring division
// step a quotient bit (the carry out of the shift is the 65th bit).
__device__ __forceinline__ Recip make_recip(u64 d) {
  const unsigned l = d > 1 ? 64u - static_cast<unsigned>(__clzll(d - 1)) : 0u;
  u64 rem = (l == 64 ? 0ull : 1ull << l) - d, q = 0;
  for (int i = 0; i < 64; ++i) {
    const bool carry = rem >> 63;
    rem <<= 1;
    q <<= 1;
    if (carry || rem >= d) {
      rem -= d;
      q |= 1;
    }
  }
  return Recip{q + 1, l < 1 ? l : 1u, l > 0 ? l - 1 : 0u};
}

__device__ __forceinline__ u64 udiv(u64 n, const Recip& r) {
  const u64 t = __umul64hi(r.m, n);
  return (t + ((n - t) >> r.sh1)) >> r.sh2;
}

struct SweepShared {
  u64 warp_sums[kMaxThreads / 32][3];
  u64 totals[3];
  Recip recip[3];  // the increment, the reward denominator, the inactivity denominator
};

// The block's sums of acc[0..2], returned to every thread in acc. Ends on
// a barrier after the totals are read, so the slots may be written again.
__device__ __forceinline__ void block_sum3(u64 acc[3], SweepShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    u64 v = acc[f];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh.warp_sums[warp][f] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    u64 v = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) v += sh.warp_sums[w][threadIdx.x];
    sh.totals[threadIdx.x] = v;
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 3; ++f) acc[f] = sh.totals[f];
  __syncthreads();
}

// The bits byte of validator i from its phase-A columns.
__device__ __forceinline__ unsigned validator_bits(const uint8_t* slashed,
                                                   const u64* activation_epoch,
                                                   const u64* exit_epoch,
                                                   const uint8_t* prev_flags, long long i,
                                                   u64 prev) {
  const unsigned flags = __ldcs(prev_flags + i) & kFlagBits;
  const bool active = prev_active(__ldcs(activation_epoch + i), __ldcs(exit_epoch + i), prev);
  return flags | (active ? kActiveBit : 0u) | (__ldcs(slashed + i) ? kSlashedBit : 0u);
}

__global__ void __launch_bounds__(kMaxThreads)
    sweep_coop(const u64* __restrict__ effective_balance, const uint8_t* __restrict__ slashed,
               const u64* __restrict__ activation_epoch, const u64* __restrict__ exit_epoch,
               const u64* __restrict__ withdrawable_epoch, const uint8_t* __restrict__ prev_flags,
               const u64* __restrict__ scores, const u64* __restrict__ balances,
               const u64* __restrict__ scalars, u64* __restrict__ partials,
               u64* __restrict__ new_balances, u64* __restrict__ new_scores, long long n,
               long long tile, long long keep) {
  __shared__ SweepShared sh;
  extern __shared__ __align__(16) unsigned char kept[];
  u64* kept_eb = reinterpret_cast<u64*>(kept);
  uint8_t* kept_bits = kept + 8 * keep;

  const Scalars s = load_scalars(scalars);
  const long long start = blockIdx.x * tile;
  const long long end = start + tile < n ? start + tile : n;
  const int threads = blockDim.x;

  // three lanes form the reciprocals while the rest stream phase A; the
  // barriers of block_sum3 publish them
  if (threadIdx.x < 3) {
    const u64 d = threadIdx.x == 0   ? s.eb_increment
                  : threadIdx.x == 1 ? s.total_active_increments * kWeightDenominator
                                     : s.inactivity_denom;
    sh.recip[threadIdx.x] = make_recip(d);
  }

  // Phase A: the sums, keeping the tile's effective balances and bits
  u64 acc[3] = {0, 0, 0};
  for (long long base = start + threadIdx.x; base < end; base += kBatch * threads) {
    u64 eb[kBatch];
    unsigned bits[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long i = base + static_cast<long long>(k) * threads;
      if (i < end) {
        eb[k] = __ldcs(effective_balance + i);
        bits[k] = validator_bits(slashed, activation_epoch, exit_epoch, prev_flags, i, s.prev_epoch);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long i = base + static_cast<long long>(k) * threads;
      if (i >= end) break;
      if (i - start < keep) {
        kept_eb[i - start] = eb[k];
        kept_bits[i - start] = static_cast<uint8_t>(bits[k]);
      }
      if ((bits[k] & kActiveBit) && !(bits[k] & kSlashedBit)) {
#pragma unroll
        for (int f = 0; f < 3; ++f) acc[f] += ((bits[k] >> f) & 1u) ? eb[k] : 0ull;
      }
    }
  }
  block_sum3(acc, sh);
  if (threadIdx.x < 3)
    partials[3 * static_cast<long long>(blockIdx.x) + threadIdx.x] =
        threadIdx.x == 0 ? acc[0] : threadIdx.x == 1 ? acc[1] : acc[2];

  // phase B's first batch of its own columns, in flight across the barrier
  u64 wd[kBatch], score_in[kBatch], balance_in[kBatch];
  long long base = start + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const long long i = base + static_cast<long long>(k) * threads;
    if (i < end) {
      wd[k] = withdrawable_epoch[i];
      score_in[k] = scores[i];
      balance_in[k] = balances[i];
    }
  }

  cooperative_groups::this_grid().sync();

  // Phase B: the sweep-wide sums, then the tile again
  acc[0] = acc[1] = acc[2] = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += threads) {
#pragma unroll
    for (int f = 0; f < 3; ++f) acc[f] += __ldcg(partials + 3 * static_cast<long long>(b) + f);
  }
  block_sum3(acc, sh);
  const Recip r_inc = sh.recip[0], r_reward = sh.recip[1], r_inactivity = sh.recip[2];
  const bool in_leak = s.in_leak != 0;
  u64 weight_upb[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const u64 upb = acc[f] > s.eb_increment ? acc[f] : s.eb_increment;
    weight_upb[f] = kWeights[f] * udiv(upb, r_inc);
  }

  for (; base < end; base += kBatch * threads) {
    if (base != start + threadIdx.x) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long i = base + static_cast<long long>(k) * threads;
        if (i < end) {
          wd[k] = withdrawable_epoch[i];
          score_in[k] = scores[i];
          balance_in[k] = balances[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long i = base + static_cast<long long>(k) * threads;
      if (i >= end) break;
      u64 eb;
      unsigned bits;
      if (i - start < keep) {
        eb = kept_eb[i - start];
        bits = kept_bits[i - start];
      } else {
        eb = __ldcs(effective_balance + i);
        bits = validator_bits(slashed, activation_epoch, exit_epoch, prev_flags, i, s.prev_epoch);
      }
      const bool is_slashed = bits & kSlashedBit;
      const bool active = bits & kActiveBit;
      const bool eligible = active || (is_slashed && s.prev_epoch + 1ull < wd[k]);
      const u64 base_reward = udiv(eb, r_inc) * s.base_reward_per_increment;

      u64 rewards = 0, penalties = 0;
      bool target = false;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const bool participating = ((bits >> f) & 1u) && !is_slashed && active;
        if (f == kTargetFlag) target = participating;
        if (eligible && participating && !in_leak)
          rewards += udiv(base_reward * weight_upb[f], r_reward);
        if (f != kHeadFlag && eligible && !participating)
          penalties += (base_reward * kWeights[f]) >> 6;  // / kWeightDenominator
      }

      // process_inactivity_updates, then the inactivity penalty on the new score
      u64 score = score_in[k];
      if (eligible && target) score -= score < 1ull ? score : 1ull;
      if (eligible && !target) score += s.score_bias;
      if (eligible && !in_leak) score -= score < s.score_recovery ? score : s.score_recovery;
      if (eligible && !target) penalties += udiv(eb * score, r_inactivity);

      u64 balance = balance_in[k] + rewards;
      balance = (balance > penalties ? balance : penalties) - penalties;
      __stcs(new_balances + i, balance);
      __stcs(new_scores + i, score);
    }
  }
}

// ---------------------------------------------------------------------------
// The replaced two-kernel sweep (chip_smoke.py's comparison)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__global__ void sweep_sums(const u64* __restrict__ effective_balance,
                           const uint8_t* __restrict__ slashed,
                           const u64* __restrict__ activation_epoch,
                           const u64* __restrict__ exit_epoch,
                           const uint8_t* __restrict__ prev_flags,
                           const u64* __restrict__ scalars, u64* __restrict__ sums,
                           long long n) {
  const u64 prev = scalars[0];
  u64 acc[3] = {0, 0, 0};
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (slashed[i] || !prev_active(activation_epoch[i], exit_epoch[i], prev)) continue;
    const u64 eb = effective_balance[i];
    const unsigned flags = prev_flags[i];
#pragma unroll
    for (int f = 0; f < 3; ++f) acc[f] += ((flags >> f) & 1u) ? eb : 0ull;
  }
  __shared__ u64 warp_sums[kThreads / 32][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    u64 v = acc[f];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][f] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    u64 v = 0;
    for (int w = 0; w < kThreads / 32; ++w) v += warp_sums[w][threadIdx.x];
    atomicAdd(&sums[threadIdx.x], v);
  }
}

__global__ void sweep_apply(const u64* __restrict__ effective_balance,
                            const uint8_t* __restrict__ slashed,
                            const u64* __restrict__ activation_epoch,
                            const u64* __restrict__ exit_epoch,
                            const u64* __restrict__ withdrawable_epoch,
                            const uint8_t* __restrict__ prev_flags,
                            const u64* __restrict__ scores,
                            const u64* __restrict__ balances,
                            const u64* __restrict__ scalars,
                            const u64* __restrict__ sums, u64* __restrict__ new_balances,
                            u64* __restrict__ new_scores, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Scalars s = load_scalars(scalars);
  const bool in_leak = s.in_leak != 0;
  const u64 eb = effective_balance[i];
  const bool is_slashed = slashed[i] != 0;
  const bool active = prev_active(activation_epoch[i], exit_epoch[i], s.prev_epoch);
  const bool eligible =
      active || (is_slashed && s.prev_epoch + 1ull < withdrawable_epoch[i]);
  const unsigned flags = prev_flags[i];
  const u64 base_reward = (eb / s.eb_increment) * s.base_reward_per_increment;
  const u64 reward_denom = s.total_active_increments * kWeightDenominator;

  u64 rewards = 0, penalties = 0;
  bool target = false;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const bool participating = ((flags >> f) & 1u) && !is_slashed && active;
    if (f == kTargetFlag) target = participating;
    const u64 upb = sums[f] > s.eb_increment ? sums[f] : s.eb_increment;
    if (eligible && participating && !in_leak)
      rewards += base_reward * kWeights[f] * (upb / s.eb_increment) / reward_denom;
    if (f != kHeadFlag && eligible && !participating)
      penalties += base_reward * kWeights[f] / kWeightDenominator;
  }

  // process_inactivity_updates, then the inactivity penalty on the new score
  u64 score = scores[i];
  if (eligible && target) score -= score < 1ull ? score : 1ull;
  if (eligible && !target) score += s.score_bias;
  if (eligible && !in_leak) score -= score < s.score_recovery ? score : s.score_recovery;
  if (eligible && !target) penalties += eb * score / s.inactivity_denom;

  u64 balance = balances[i] + rewards;
  balance = (balance > penalties ? balance : penalties) - penalties;
  new_balances[i] = balance;
  new_scores[i] = score;
}

}  // namespace

// One sweep over n validators on `stream`: one cooperative launch of
// `grid` blocks of `threads` (a multiple of 32, at most 1024), block b
// owning validators [b * tile, (b + 1) * tile) and keeping the first
// `keep` of them in shared memory (9 bytes each). `partials` is a [grid][3]
// u64 scratch on the card. Refuses (cudaErrorInvalidValue) a shape that
// does not cover n, and returns the launch's error: a grid the card cannot
// hold at once is refused by the runtime.
extern "C" int epoch_sweep(const void* effective_balance, const void* slashed,
                           const void* activation_epoch, const void* exit_epoch,
                           const void* withdrawable_epoch, const void* prev_flags,
                           const void* scores, const void* balances, const void* scalars,
                           void* partials, void* new_balances, void* new_scores, long long n,
                           int grid, int threads, long long tile, long long keep, void* stream) {
  if (n < 0 || grid < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      tile < 0 || keep < 0 || keep > tile || static_cast<long long>(grid) * tile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(9 * keep);
  cudaError_t err = cudaFuncSetAttribute(sweep_coop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused shape is this call's error, not the next launch's
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = shared;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, sweep_coop, static_cast<const u64*>(effective_balance),
      static_cast<const uint8_t*>(slashed), static_cast<const u64*>(activation_epoch),
      static_cast<const u64*>(exit_epoch), static_cast<const u64*>(withdrawable_epoch),
      static_cast<const uint8_t*>(prev_flags), static_cast<const u64*>(scores),
      static_cast<const u64*>(balances), static_cast<const u64*>(scalars),
      static_cast<u64*>(partials), static_cast<u64*>(new_balances), static_cast<u64*>(new_scores),
      n, tile, keep);
  if (err != cudaSuccess) {
    cudaGetLastError();  // e.g. a grid the card cannot hold at once
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the wrapper plans the cooperative launch with, on the current
// device: out[0] the blocks of `threads` with `shared` bytes of kept
// validators an SM holds at once, out[1] the kernel's static shared bytes,
// out[2] the shared bytes a block may have (opt-in), out[3] an SM's.
extern "C" int epoch_sweep_limits(int threads, long long shared, void* out) {
  long long* o = static_cast<long long*>(out);
  int device = 0, optin = 0, per_sm = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  cudaFuncAttributes attrs = {};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, sweep_coop);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_coop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attrs.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sweep_coop, threads,
                                                        static_cast<size_t>(shared));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  o[0] = blocks;
  o[1] = static_cast<long long>(attrs.sharedSizeBytes);
  o[2] = optin;
  o[3] = per_sm;
  return 0;
}

// The replaced sweep on `stream`: zeroes `sums` ([3] u64 scratch on the
// card), launches the reduction and the elementwise pass. Returns the
// cudaError_t of the launches.
extern "C" int epoch_sweep_two_pass(const void* effective_balance, const void* slashed,
                                    const void* activation_epoch, const void* exit_epoch,
                                    const void* withdrawable_epoch, const void* prev_flags,
                                    const void* scores, const void* balances,
                                    const void* scalars, void* sums, void* new_balances,
                                    void* new_scores, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(sums, 0, 3 * sizeof(u64), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    const unsigned int sum_blocks =
        static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
    sweep_sums<<<sum_blocks, kThreads, 0, st>>>(
        static_cast<const u64*>(effective_balance), static_cast<const uint8_t*>(slashed),
        static_cast<const u64*>(activation_epoch), static_cast<const u64*>(exit_epoch),
        static_cast<const uint8_t*>(prev_flags), static_cast<const u64*>(scalars),
        static_cast<u64*>(sums), n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_apply<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
        static_cast<const u64*>(effective_balance), static_cast<const uint8_t*>(slashed),
        static_cast<const u64*>(activation_epoch), static_cast<const u64*>(exit_epoch),
        static_cast<const u64*>(withdrawable_epoch), static_cast<const uint8_t*>(prev_flags),
        static_cast<const u64*>(scores), static_cast<const u64*>(balances),
        static_cast<const u64*>(scalars), static_cast<const u64*>(sums),
        static_cast<u64*>(new_balances), static_cast<u64*>(new_scores), n);
  }
  return static_cast<int>(cudaGetLastError());
}
