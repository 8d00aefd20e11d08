// What every round kernel shares (round.cu, round_mxu.cu): the run-time
// product plan with its compile-time maxima, and the tail each kernel ends
// with, the evaluation ladder at t = 0..d and the per-block sums.
//
// Ladder: each slot's start E and step O - E live in dynamic shared memory,
// [slot][cur|step][limb][thread], so run-time slot indices cost no local
// memory and consecutive threads hit consecutive banks. For t = 0..d the
// tail forms total(t) = sum_p [c_p *] prod_{s in p} (E_s + t * (O_s - E_s)),
// fully reduced mod p, with the optional coefficient c_p multiplied onto the
// first factor, in the Pallas kernel's order (`_block_sums`,
// sumcheck_tpu/ops/round_pallas.py:54-82). Each block writes the per-digit
// sums of total(t) over its lanes as 64-bit integers, part[block][t][digit];
// inactive lanes add nothing.

#pragma once

#include "field.cuh"

namespace sc {

constexpr int kThreads = 128;  // threads per block, one lane each
constexpr int kMaxSlots = 16;
constexpr int kMaxProducts = 16;
constexpr int kMaxFactors = 8;
constexpr int kMaxDegree = 8;

struct Plan {
  int slots;
  int products;
  int factors;
  int degree;
  int idx[kMaxProducts * kMaxFactors];  // idx[p * kMaxFactors + l]
};

// plan: slots, products, factors, degree, then products x kMaxFactors
// indices. Returns cudaErrorInvalidValue above the maxima.
inline cudaError_t read_plan(const int* plan, Plan* pl) {
  pl->slots = plan[0];
  pl->products = plan[1];
  pl->factors = plan[2];
  pl->degree = plan[3];
  if (pl->slots < 1 || pl->slots > kMaxSlots || pl->products < 1 ||
      pl->products > kMaxProducts || pl->factors < 1 ||
      pl->factors > kMaxFactors || pl->degree < 1 || pl->degree > kMaxDegree)
    return cudaErrorInvalidValue;
  for (int q = 0; q < kMaxProducts * kMaxFactors; ++q) pl->idx[q] = plan[4 + q];
  return cudaSuccess;
}

// field: p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32
inline Field read_field(const uint32_t* field) {
  Field f;
  for (int j = 0; j < kLimbs; ++j) f.p[j] = field[j];
  f.ninv = field[kLimbs];
  return f;
}

// Dynamic shared memory the ladder of `slots` slots takes.
__host__ __device__ inline size_t ladder_bytes(int slots) {
  return (size_t)slots * 2 * kLimbs * kThreads * sizeof(uint32_t);
}

__device__ __forceinline__ uint32_t& ladder_at(uint32_t* ladder, int u, int which,
                                               int j, int tid) {
  return ladder[((u * 2 + which) * kLimbs + j) * kThreads + tid];
}

// Slot u's start e and step o - e into the ladder.
__device__ __forceinline__ void ladder_put(uint32_t* ladder, int u,
                                           const uint32_t e[kLimbs],
                                           const uint32_t o[kLimbs],
                                           const Field& f, int tid) {
  uint32_t s[kLimbs];
  sub_mod(s, o, e, f);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    ladder_at(ladder, u, 0, j, tid) = e[j];
    ladder_at(ladder, u, 1, j, tid) = s[j];
  }
}

// The tail: ladder, products, per-digit block sums into part[blockIdx.x].
// Every thread of the block calls it (it ends in a block barrier).
template <bool kCoeffs>
__device__ __forceinline__ void ladder_block_sums(
    uint32_t* ladder, uint32_t (*warp_sums)[kMaxDegree + 1][kDigits],
    const uint32_t (*coeff)[kLimbs], bool active, const Field& f,
    const Plan& pl, long long* __restrict__ part) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int t = 0; t <= pl.degree; ++t) {
    uint32_t total[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) total[j] = 0;
    if (active) {
      if (t > 0) {
        for (int u = 0; u < pl.slots; ++u) {
          uint32_t c[kLimbs], s[kLimbs];
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) {
            c[j] = ladder_at(ladder, u, 0, j, tid);
            s[j] = ladder_at(ladder, u, 1, j, tid);
          }
          add_mod(c, c, s, f);
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) ladder_at(ladder, u, 0, j, tid) = c[j];
        }
      }
      for (int p = 0; p < pl.products; ++p) {
        uint32_t term[kLimbs];
        const int s0 = pl.idx[p * kMaxFactors];
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) term[j] = ladder_at(ladder, s0, 0, j, tid);
        if constexpr (kCoeffs) mont_mul(term, coeff[p], term, f);
        for (int l = 1; l < pl.factors; ++l) {
          const int sl = pl.idx[p * kMaxFactors + l];
          uint32_t x[kLimbs];
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) x[j] = ladder_at(ladder, sl, 0, j, tid);
          mont_mul(term, term, x, f);
        }
        add_mod(total, total, term, f);
      }
    }
    // per-digit block sum: a warp's 32 digits < 2^21 fit 32 bits
#pragma unroll
    for (int i = 0; i < kDigits; ++i) {
      uint32_t v = (i & 1) ? (total[i >> 1] >> 16) : (total[i >> 1] & 0xFFFFu);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sums[warp][t][i] = v;
    }
  }
  __syncthreads();
  const int nout = (pl.degree + 1) * kDigits;
  for (int q = tid; q < nout; q += kThreads) {
    const int t = q / kDigits;
    const int i = q % kDigits;
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][t][i];
    part[(long long)blockIdx.x * nout + q] = (long long)s;
  }
}

}  // namespace sc
