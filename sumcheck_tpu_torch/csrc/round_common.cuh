// What every round kernel shares (round.cu, round_mxu.cu, fold_staged.cu):
// the run-time product plan with its compile-time maxima, the ladder, the
// tail the ladder kernels end with, the evaluation at t = 0..d and the
// round's sums, and the evaluation in registers (register_sums) with its
// block sums.
//
// Ladder: each slot's start E and step O - E live in dynamic shared memory,
// [slot][cur|step][limb][thread], so run-time slot indices cost no local
// memory and consecutive threads hit consecutive banks. round.cu's register
// bodies only read it; for the others (above degree 4, and the MXU fold),
// for t = 0..d the tail forms total(t) = sum_p [c_p *] prod_{s in p} (E_s + t * (O_s - E_s)),
// fully reduced mod p, with the optional coefficient c_p multiplied onto the
// first factor, in the Pallas kernel's order (`_block_sums`,
// sumcheck_tpu/ops/round_pallas.py:54-82). Each block adds the per-digit
// sums of total(t) over its lanes into the round's (d+1, 16) int64 row
// `sums` with 64-bit atomic adds: integer addition is exact and order-free,
// so the row holds the same bits whatever order the blocks finish in, and
// no second pass over blocks is needed. Inactive lanes add nothing.

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

// One warp's per-digit sums of total(t) over its 32 lanes into its row of
// the block's scratch: a warp's 32 digits < 2^21 fit 32 bits.
__device__ __forceinline__ void warp_digit_sums(const uint32_t total[kLimbs],
                                                uint32_t row[kDigits]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kDigits; ++i) {
    uint32_t v = (i & 1) ? (total[i >> 1] >> 16) : (total[i >> 1] & 0xFFFFu);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) row[i] = v;
  }
}

// The block's per-digit sums, points 0..degree, added into the row sums with
// 64-bit atomics. Every thread of the block calls it (it starts with a block
// barrier, after every warp's warp_digit_sums).
__device__ __forceinline__ void add_block_sums(
    const uint32_t (*warp_sums)[kMaxDegree + 1][kDigits], int degree,
    long long* __restrict__ sums) {
  __syncthreads();
  const int nout = (degree + 1) * kDigits;
  for (int q = threadIdx.x; q < nout; q += kThreads) {
    const int t = q / kDigits;
    const int i = q % kDigits;
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][t][i];
    atomicAdd(reinterpret_cast<unsigned long long*>(sums) + q, s);
  }
}

// The tail: ladder, products, per-digit block sums added into the row sums.
// Every thread of the block calls it (it ends in a block barrier).
template <bool kCoeffs>
__device__ __forceinline__ void ladder_block_sums(
    uint32_t* ladder, uint32_t (*warp_sums)[kMaxDegree + 1][kDigits],
    const uint32_t (*coeff)[kLimbs], bool active, const Field& f,
    const Plan& pl, long long* __restrict__ sums) {
  const int tid = threadIdx.x;
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
    warp_digit_sums(total, warp_sums[warp][t]);
  }
  add_block_sums(warp_sums, pl.degree, sums);
}

// Degrees up to which a round evaluates in registers (round.cu's
// nofold_kernel and fold_kernel, fold_staged.cu); above it round.cu's
// round_kernel and the ladder's per-t pass.
constexpr int kMaxRegisterDegree = 4;

// acc[0..K] hold a polynomial of degree K at t = 0..K: extend it to
// t = K+1..D by its backward differences. The K-th difference is constant,
// so each new point costs K additions; exact in the field, so the values
// are the ones a multiply at those points would give.
template <int K, int D>
__device__ __forceinline__ void extend(uint32_t (*acc)[kLimbs], const Field& f) {
  uint32_t dt[K + 1][kLimbs];
#pragma unroll
  for (int i = 0; i <= K; ++i)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) dt[i][j] = acc[K - i][j];
  // pass j leaves dt[i] = j-th difference at K - i + j (i >= j), so at the
  // end dt[j] is the j-th backward difference at K
#pragma unroll
  for (int j = 1; j <= K; ++j)
#pragma unroll
    for (int i = K; i >= j; --i) sub_mod(dt[i], dt[i - 1], dt[i], f);
#pragma unroll
  for (int t = K + 1; t <= D; ++t) {
#pragma unroll
    for (int j = K - 1; j >= 0; --j) add_mod(dt[j], dt[j], dt[j + 1], f);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) acc[t][j] = dt[0][j];
  }
}

// extend<K, D> for the run-time degree K, 2 <= K < D
template <int K, int D>
__device__ __forceinline__ void extend_from(int degree, uint32_t (*acc)[kLimbs],
                                            const Field& f) {
  if constexpr (K < D) {
    if (degree == K) {
      extend<K, D>(acc, f);
    } else {
      extend_from<K + 1, D>(degree, acc, f);
    }
  }
}

// total[t] += sum_p [c_p *] prod_l (E + t (O - E)) at t = 0..D, D <= 
// kMaxRegisterDegree, in registers: product by product, factor by factor,
// each factor's values E + t (O - E) formed by additions and multiplied into
// the product's running values. A product of l factors has degree l, so it
// is multiplied at t = 0..l only and extended to the next point by
// differences when the next factor needs it: 7 multiplies for a 3-factor
// product at D = 3, not 8. A coefficient multiplies the first factor's E and
// step (2 multiplies). `factor(p, l, e, step)` gives factor l of product p,
// its E and its step O - E, in this order.
template <int D, bool kCoeffs, class Factor>
__device__ __forceinline__ void register_sums(uint32_t (*total)[kLimbs], const Plan& pl,
                                              const uint32_t (*coeff)[kLimbs], const Field& f,
                                              Factor&& factor) {
  for (int p = 0; p < pl.products; ++p) {
    uint32_t acc[D + 1][kLimbs];
    int known = D;  // acc holds the product so far at t = 0..known
    for (int l = 0; l < pl.factors; ++l) {
      uint32_t v[kLimbs], step[kLimbs];
      factor(p, l, v, step);
      if (l == 0) {
        if constexpr (kCoeffs) {
          mont_mul(v, coeff[p], v, f);
          mont_mul(step, coeff[p], step, f);
        }
#pragma unroll
        for (int t = 0; t <= D; ++t) {
          if (t > 0) add_mod(v, v, step, f);
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) acc[t][j] = v[j];
        }
        continue;
      }
      // the points this factor's product is needed at: all for the last
      // factor, else as many as its degree l + 1 takes
      const int need = l + 1 == pl.factors ? D : min(l + 1, D);
      if (need > known) extend_from<2, D>(known, acc, f);  // known == l here
#pragma unroll
      for (int t = 0; t <= D; ++t) {
        if (t <= need) {
          if (t > 0) add_mod(v, v, step, f);
          mont_mul(acc[t], acc[t], v, f);
        }
      }
      known = need;
    }
#pragma unroll
    for (int t = 0; t <= D; ++t) add_mod(total[t], total[t], acc[t], f);
  }
}

// The block's per-digit sums of total(t), t = 0..D, into the round's row.
template <int D>
__device__ __forceinline__ void register_block_sums(
    const uint32_t (*total)[kLimbs], uint32_t (*warp_sums)[kMaxDegree + 1][kDigits],
    long long* __restrict__ sums) {
#pragma unroll
  for (int t = 0; t <= D; ++t) warp_digit_sums(total[t], warp_sums[threadIdx.x >> 5][t]);
  add_block_sums(warp_sums, D, sums);
}

}  // namespace sc
