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
// (chip_smoke.py: EPOCH_SWEEP_BYTES, EPOCH_SWEEP_MIN_OPS). This kernel
// divides with the compiler's general 64-bit division (a software
// sequence of a few dozen instructions) rather than reciprocals, which is
// what may keep it above the bound.
//
// Design, simple and right:
//   1. `sweep_sums`: a grid-stride reduction of the three unslashed
//      participating balances of the previous epoch (one per flag). Each
//      block reduces in registers and shared memory and adds its partial
//      sums with one atomicAdd per flag on unsigned long long: integer
//      addition mod 2^64 is associative and commutative, so the result is
//      exact and independent of the order the blocks finish in.
//   2. `sweep_apply`: one thread per validator. It reads the three sums
//      (applying max(., increment) as the JAX code does between its two
//      halves), computes the per-flag reward numerators, updates the score
//      and then the balance.
// Column loads are coalesced 8-byte reads; nothing is kept resident on the
// card between epochs (the wrapper copies the columns up and the results
// back once each).
//
// Plain C interface, bound with ctypes (lighthouse_tpu_torch/ops/epoch_sweep.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

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

// One sweep over n validators on `stream`: zeroes `sums` ([3] u64 scratch
// on the card), launches the reduction and the elementwise pass. Returns
// the cudaError_t of the launches.
extern "C" int epoch_sweep(const void* effective_balance, const void* slashed,
                           const void* activation_epoch, const void* exit_epoch,
                           const void* withdrawable_epoch, const void* prev_flags,
                           const void* scores, const void* balances, const void* scalars,
                           void* sums, void* new_balances, void* new_scores, long long n,
                           void* stream) {
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
