// MLSumcheck round kernels for Hopper (sm_90a): fold by the challenge,
// evaluate the round polynomial at t = 0..d, and reduce per block.
//
// Replaces the Pallas kernels of sumcheck_tpu/ops/round_pallas.py:
//   - `_kernel_chain_nofold` / `_kernel_chain_fold` (the generic chain):
//     nofold_kernel<D, false> and fold_kernel<D, false, false, ...>, which
//     fold in place over a run-time extent;
//   - `_kernel_nofold` / `_kernel_fold` (the per-size chain, `_build` and
//     `round_pallas`): nofold_kernel<D, C> and fold_kernel<D, true, C, ...>,
//     which fold out of place into fresh half-width tables, C = with
//     per-product coefficients;
//   - above degree kMaxRegisterDegree, round_kernel<kFold, kOutOfPlace, C>,
//     the same rounds with the evaluation ladder in shared memory;
//   - past the plan's maxima (more than 16 slots or products, 8 factors or
//     degree 8), wide_kernel<kFold, kT>, every mode of the same rounds,
//     single and batched (sc_round_launch_wide).
// Built by ops/cuda_build.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes by ops/round_cuda.py, which holds the plain
// PyTorch versions these kernels are checked against.
//
// Data layout: the table pair lo, hi is (U, 8, H) int32 words, each value
// its 8 x 32-bit Montgomery limbs (least significant first), slot axis
// leading, limb j of slot u, lane k at [(u * 8 + j) * H + k]: consecutive
// threads read consecutive words, 8 coalesced loads an element, 32 B. The
// challenge, the coefficients and the sums rows keep the JAX package's 16 x
// 16-bit digits (load_digits), which the transcript step reads. A thread
// owns one lane k.
//
// Round with active pair count A (the extent):
//   no fold:  E_u = lo[u][k], O_u = hi[u][k]                     (k < A)
//   fold:     E_u = fold(lo[u][k], hi[u][k]),
//             O_u = fold(lo[u][k + A], hi[u][k + A]),            (k < A)
//             where fold(x, y) = x + r * (y - x);
//     in place (generic chain): written back to lo[u][k], hi[u][k]. Lane k
//       is read and written only by its own thread, and the upper stripe
//       [A, 2A) is read-only in the round, so this is race-free;
//     out of place (per-size chain, A = H / 2): written to lane k of the
//       fresh (U, 8, A) tables lo_out, hi_out.
// Then for t = 0..d: total(t) = sum_p [c_p *] prod_{s in p} (E_s + t * (O_s
// - E_s)), fully reduced mod p, with the optional coefficient c_p
// multiplied onto the first factor, in the Pallas kernel's order. Each block
// adds the per-digit sums of total(t) over its lanes into the round's row
// sums[t][digit] (64-bit atomic adds, round_common.cuh). Lanes k >= A add
// nothing. The carry chain runs in the transcript step (transcript.cu) or
// on the host.
//
// What bounds them on the H100: per lane, a fold round of the 2x3 workload
// (6 slots) reads 4 stripes and writes 2 a slot, 1,152 B at 32 B an element
// (302 MB at A = 2^18: 0.090 ms at 3.35 TB/s), and runs 12 Montgomery
// multiplies for the fold and 14 for the evaluation, each 64 32x32->64-bit
// multiply-adds plus carries (1.8e9 32-bit multiplies at A = 2^18: 0.108 ms
// at the IMAD rate, 0.117 ms at the measured multiply rate). So the
// multiplies bound it, and the bytes are a close second: the design keeps
// both pipes busy at once. The fold body, fold_kernel:
//   - the packed layout halves the bytes of the TPU's 16 digits in 32-bit
//     words;
//   - each slot is folded once, its (E, O - E) written to the shared ladder
//     once and only read after that; the evaluation then runs in registers,
//     product by product, with the points past a product's degree extended
//     by backward differences (register_sums, shared with round 0): 14
//     multiplies at 2x3 and d = 3, where the ladder's per-t pass takes 16
//     and reads and writes every slot's ladder entry at every t;
//   - the next slot's four stripes load while this slot's two fold
//     multiplies run (registers, double-buffered). The variant not taken,
//     the stripes staged in shared memory by cp.async, is fold_staged.cu,
//     a library of its own that only its yardstick loads (PERF.md gives
//     both times).
// The ladder still holds (E, O - E) because a product's slot indices are
// known only at run time; each thread reads only its own entries, so no
// barrier separates the fold from the evaluation.
//
// Instance axis (the batched provers, sumcheck_tpu_torch/batch.py): a
// launch over B instances runs grid y = B; block (x, b) offsets its pair,
// output tables, challenge, coefficients and sums row to instance b's
// (sc_round_launch_batched), so every body above serves B instances in one
// launch, each folded by its own challenge. A single launch is B = 1; the
// fold bodies then run an instantiation without the offsets (kBatched =
// false), which saved the in-place fold 3.6% at 2^18 lanes.
//
// Structure: product shape (slots, products, factors, degree) and the
// product index matrix arrive at run time (struct Plan) with compile-time
// maxima. The ladder and the block-sum tail are shared with the MXU fold
// kernel (round_common.cuh). Coefficients, when given, sit in static shared
// memory. A structure past the maxima takes the wide route, chosen by the
// wrapper from its shape (ops/round_cuda.route): the index matrix and each
// product's count of real factors in device memory (WidePlan, uploaded once
// per structure and device), each slot folded and written out, then the
// points in chunks of kT (4, 8, 10 or 12 by the degree, wide_points): in a chunk
// each real factor's E and O read once from this lane of the tables, its
// values at the chunk's points by additions, each product multiplied only at
// its own degree's points and extended by differences, no work on the
// ragged products' constant-one padding, and the chunk's block sums in one
// pass (wide_block_sums). So shared memory, registers and parameter space
// set no maximum: 17 to thousands of slots, any degree. The bodies for
// today's maxima are as they were (their registers and spills unchanged).

#include "round_common.cuh"

namespace {

using namespace sc;

// The rounds above kMaxRegisterDegree: fold (optionally), then the ladder's
// evaluation in shared memory (round_common.cuh).
template <bool kFold, bool kOutOfPlace, bool kCoeffs, bool kBatched>
__global__ void __launch_bounds__(kThreads)
    round_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                 uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
                 const uint32_t* __restrict__ r_digits,
                 const uint32_t* __restrict__ coeff_digits, long long H,
                 long long H_out, long long extent, long long inst_stride,
                 long long out_inst_stride, Field f, Plan pl,
                 long long* __restrict__ sums) {
  static_assert(kFold || !kOutOfPlace, "only a fold writes tables");
  if constexpr (kBatched) {  // instance blockIdx.y of a batched launch
    const long long b = blockIdx.y;
    lo += b * inst_stride;
    hi += b * inst_stride;
    if constexpr (kOutOfPlace) {
      lo_out += b * out_inst_stride;
      hi_out += b * out_inst_stride;
    }
    if constexpr (kFold) r_digits += b * kDigits;
    if constexpr (kCoeffs) coeff_digits += b * pl.products * kDigits;
    sums += b * (pl.degree + 1) * kDigits;
  }
  extern __shared__ uint32_t ladder[];  // [slot][cur|step][limb][thread]
  __shared__ uint32_t warp_sums[kThreads / 32][kMaxDegree + 1][kDigits];
  __shared__ uint32_t coeff[kCoeffs ? kMaxProducts : 1][kLimbs];

  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const bool active = k < extent;
  const long long slot_stride = (long long)kLimbs * H;
  const long long out_stride = (long long)kLimbs * H_out;

  if constexpr (kCoeffs) {
    for (int p = tid; p < pl.products; p += kThreads) load_digits(coeff[p], coeff_digits + p * kDigits);
    __syncthreads();
  }

  if (active) {
    uint32_t rr[kLimbs];
    if constexpr (kFold) load_digits(rr, r_digits);
    for (int u = 0; u < pl.slots; ++u) {
      uint32_t* lo_u = lo + u * slot_stride + k;
      uint32_t* hi_u = hi + u * slot_stride + k;
      uint32_t e[kLimbs], o[kLimbs];
      if constexpr (kFold) {
        uint32_t x[kLimbs], y[kLimbs];
        load_lane(x, lo_u, H);
        load_lane(y, hi_u, H);
        fold(e, x, y, rr, f);
        load_lane(x, lo_u + extent, H);
        load_lane(y, hi_u + extent, H);
        fold(o, x, y, rr, f);
        if constexpr (kOutOfPlace) {
          store_lane(lo_out + u * out_stride + k, H_out, e);
          store_lane(hi_out + u * out_stride + k, H_out, o);
        } else {
          store_lane(lo_u, H, e);
          store_lane(hi_u, H, o);
        }
      } else {
        load_lane(e, lo_u, H);
        load_lane(o, hi_u, H);
      }
      ladder_put(ladder, u, e, o, f, tid);
    }
  }
  ladder_block_sums<kCoeffs>(ladder, warp_sums, coeff, active, f, pl, sums);
}

// The instance axis of a batched launch: `count` instances (grid y), each
// `stride` words of the input pair apart and `out_stride` words of the
// output tables apart; count 1 is a single launch.
struct Batch {
  long long count;
  long long stride;
  long long out_stride;
};

// Round 0 (no fold) at compile-time degree D <= kMaxRegisterDegree, with the
// evaluation in registers (register_sums), each factor's E and O read from
// the tables; the next factor's E and O load while this one multiplies. No
// shared ladder, so registers, not shared memory, set the blocks per SM.
template <int D, bool kCoeffs>
__global__ void __launch_bounds__(kThreads)
    nofold_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
                  const uint32_t* __restrict__ coeff_digits, long long H, long long extent,
                  long long inst_stride, Field f, Plan pl, long long* __restrict__ sums) {
  __shared__ uint32_t warp_sums[kThreads / 32][kMaxDegree + 1][kDigits];
  __shared__ uint32_t coeff[kCoeffs ? kMaxProducts : 1][kLimbs];
  {  // instance blockIdx.y of a batched launch (0 offsets for a single one)
    const long long b = blockIdx.y;
    lo += b * inst_stride;
    hi += b * inst_stride;
    if constexpr (kCoeffs) coeff_digits += b * pl.products * kDigits;
    sums += b * (D + 1) * kDigits;
  }

  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const long long slot_stride = (long long)kLimbs * H;

  if constexpr (kCoeffs) {
    for (int p = tid; p < pl.products; p += kThreads) load_digits(coeff[p], coeff_digits + p * kDigits);
    __syncthreads();
  }

  uint32_t total[D + 1][kLimbs];
#pragma unroll
  for (int t = 0; t <= D; ++t)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) total[t][j] = 0;

  if (k < extent) {
    // the next factor's E and O are loaded while this one multiplies
    uint32_t next_e[kLimbs], next_o[kLimbs];
    load_lane(next_e, lo + pl.idx[0] * slot_stride + k, H);
    load_lane(next_o, hi + pl.idx[0] * slot_stride + k, H);
    register_sums<D, kCoeffs>(
        total, pl, coeff, f,
        [&](int p, int l, uint32_t (&v)[kLimbs], uint32_t (&step)[kLimbs]) {
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) {
            v[j] = next_e[j];
            step[j] = next_o[j];
          }
          const int q = l + 1 < pl.factors ? p * kMaxFactors + l + 1 : (p + 1) * kMaxFactors;
          if (q < pl.products * kMaxFactors) {
            load_lane(next_e, lo + pl.idx[q] * slot_stride + k, H);
            load_lane(next_o, hi + pl.idx[q] * slot_stride + k, H);
          }
          sub_mod(step, step, v, f);
        });
  }
  register_block_sums<D>(total, warp_sums, sums);
}

// Slot u's four stripes of lane k: lo[k], hi[k], lo[k + A], hi[k + A].
__device__ __forceinline__ void load_stripes(uint32_t (*s)[kLimbs], const uint32_t* lo,
                                             const uint32_t* hi, long long at,
                                             long long extent, long long H) {
  load_lane(s[0], lo + at, H);
  load_lane(s[1], hi + at, H);
  load_lane(s[2], lo + at + extent, H);
  load_lane(s[3], hi + at + extent, H);
}

// The fold rounds at compile-time degree D <= kMaxRegisterDegree (header):
// every slot folded once, written out and put in the ladder as (E, O - E),
// the next slot's four stripes loading into registers meanwhile; then
// register_sums over the ladder's entries.
template <int D, bool kOutOfPlace, bool kCoeffs, bool kBatched>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
                const uint32_t* __restrict__ r_digits,
                const uint32_t* __restrict__ coeff_digits, long long H, long long H_out,
                long long extent, long long inst_stride, long long out_inst_stride, Field f,
                Plan pl, long long* __restrict__ sums) {
  if constexpr (kBatched) {  // instance blockIdx.y of a batched launch
    const long long b = blockIdx.y;
    lo += b * inst_stride;
    hi += b * inst_stride;
    if constexpr (kOutOfPlace) {
      lo_out += b * out_inst_stride;
      hi_out += b * out_inst_stride;
    }
    r_digits += b * kDigits;
    if constexpr (kCoeffs) coeff_digits += b * pl.products * kDigits;
    sums += b * (D + 1) * kDigits;
  }
  extern __shared__ uint32_t ladder[];  // [slot][E|step][limb][thread]
  __shared__ uint32_t warp_sums[kThreads / 32][kMaxDegree + 1][kDigits];
  __shared__ uint32_t coeff[kCoeffs ? kMaxProducts : 1][kLimbs];

  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const long long slot_stride = (long long)kLimbs * H;
  const long long out_stride = (long long)kLimbs * H_out;

  if constexpr (kCoeffs) {
    for (int p = tid; p < pl.products; p += kThreads) load_digits(coeff[p], coeff_digits + p * kDigits);
    __syncthreads();
  }

  uint32_t total[D + 1][kLimbs];
#pragma unroll
  for (int t = 0; t <= D; ++t)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) total[t][j] = 0;

  if (k < extent) {
    uint32_t rr[kLimbs];
    load_digits(rr, r_digits);
    uint32_t next[4][kLimbs];
    load_stripes(next, lo, hi, k, extent, H);
    for (int u = 0; u < pl.slots; ++u) {
      uint32_t x[4][kLimbs];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) x[s][j] = next[s][j];
      if (u + 1 < pl.slots) load_stripes(next, lo, hi, (u + 1) * slot_stride + k, extent, H);
      uint32_t e[kLimbs], o[kLimbs];
      fold(e, x[0], x[1], rr, f);
      fold(o, x[2], x[3], rr, f);
      if constexpr (kOutOfPlace) {
        store_lane(lo_out + u * out_stride + k, H_out, e);
        store_lane(hi_out + u * out_stride + k, H_out, o);
      } else {
        store_lane(lo + u * slot_stride + k, H, e);
        store_lane(hi + u * slot_stride + k, H, o);
      }
      ladder_put(ladder, u, e, o, f, tid);
    }
    register_sums<D, kCoeffs>(
        total, pl, coeff, f,
        [&](int p, int l, uint32_t (&v)[kLimbs], uint32_t (&step)[kLimbs]) {
          const int s = pl.idx[p * kMaxFactors + l];
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) {
            v[j] = ladder_at(ladder, s, 0, j, tid);
            step[j] = ladder_at(ladder, s, 1, j, tid);
          }
        });
  }
  register_block_sums<D>(total, warp_sums, sums);
}

// The wide route, for a structure past the maxima of Plan
// (round_common.cuh): fold every slot (optionally) and write it out, in
// place or, with lo_out, out of place; then wide_block_sums over the
// written values in chunks of kT points, with coefficients where
// coeff_digits is given. No ladder and no per-degree arrays, so neither
// shared memory nor registers bound the slots, products, factors or
// degree. Grid y = instance, as for the other bodies (offsets 0 for a
// single launch). Dynamic shared memory: wide_total_bytes(kT).
template <bool kFold, int kT>
__global__ void __launch_bounds__(kThreads)
    wide_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
                const uint32_t* __restrict__ r_digits,
                const uint32_t* __restrict__ coeff_digits, long long H, long long H_out,
                long long extent, long long inst_stride, long long out_inst_stride, Field f,
                const __grid_constant__ WidePlan pl, long long* __restrict__ sums) {
  {  // instance blockIdx.y of a batched launch
    const long long b = blockIdx.y;
    lo += b * inst_stride;
    hi += b * inst_stride;
    if (lo_out != nullptr) {
      lo_out += b * out_inst_stride;
      hi_out += b * out_inst_stride;
    }
    if constexpr (kFold) r_digits += b * kDigits;
    if (coeff_digits != nullptr) coeff_digits += b * pl.products * kDigits;
    sums += b * (pl.degree + 1) * kDigits;
  }
  extern __shared__ uint32_t totals[];  // [point][limb][thread]
  __shared__ uint32_t warp_sums[kThreads / 32][kT][kDigits];
  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const bool active = k < extent;
  // the tables the evaluation reads: the folded ones
  const bool out = kFold && lo_out != nullptr;
  const uint32_t* e_lo = out ? lo_out : lo;
  const uint32_t* e_hi = out ? hi_out : hi;
  const long long e_H = out ? H_out : H;
  if constexpr (kFold) {
    if (active) {
      const long long slot_stride = (long long)kLimbs * H;
      const long long out_stride = (long long)kLimbs * e_H;
      uint32_t* w_lo = out ? lo_out : lo;
      uint32_t* w_hi = out ? hi_out : hi;
      uint32_t rr[kLimbs];
      load_digits(rr, r_digits);
      // the next slot's four stripes load while this one folds, as in
      // fold_kernel (the evaluation's registers are not live yet)
      uint32_t next[4][kLimbs];
      load_stripes(next, lo, hi, k, extent, H);
      for (int u = 0; u < pl.slots; ++u) {
        uint32_t x[4][kLimbs], e[kLimbs], o[kLimbs];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) x[s][j] = next[s][j];
        if (u + 1 < pl.slots) load_stripes(next, lo, hi, (u + 1) * slot_stride + k, extent, H);
        fold(e, x[0], x[1], rr, f);
        fold(o, x[2], x[3], rr, f);
        store_lane(w_lo + u * out_stride + k, e_H, e);
        store_lane(w_hi + u * out_stride + k, e_H, o);
      }
    }
  }
  wide_block_sums<kT>(active, pl, coeff_digits, f, totals, warp_sums, sums,
                      TableFactors(e_lo, e_hi, e_H, k, pl, pl.degree >= kT, active, f));
}

template <int D, bool kCoeffs>
cudaError_t launch_nofold(const void* lo, const void* hi, const void* coeff, long long H,
                          long long extent, const Batch& bt, const Field& f, const Plan& pl,
                          void* sums, long long nblk, cudaStream_t stream) {
  if constexpr (D < kMaxRegisterDegree) {
    if (pl.degree > D)
      return launch_nofold<D + 1, kCoeffs>(lo, hi, coeff, H, extent, bt, f, pl, sums, nblk,
                                           stream);
  }
  nofold_kernel<D, kCoeffs><<<dim3((unsigned)nblk, (unsigned)bt.count), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(coeff), H, extent, bt.stride, f, pl,
      static_cast<long long*>(sums));
  return cudaGetLastError();
}

template <bool kFold, bool kOutOfPlace, bool kCoeffs>
cudaError_t launch(void* lo, void* hi, void* lo_out, void* hi_out,
                   const void* r, const void* coeff, long long H,
                   long long H_out, long long extent, const Batch& bt, const Field& f,
                   const Plan& pl, void* sums, long long nblk,
                   cudaStream_t stream) {
  auto kernel = bt.count > 1 ? round_kernel<kFold, kOutOfPlace, kCoeffs, true>
                              : round_kernel<kFold, kOutOfPlace, kCoeffs, false>;
  const size_t smem = ladder_bytes(pl.slots);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((unsigned)nblk, (unsigned)bt.count), kThreads, smem, stream>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo_out), static_cast<uint32_t*>(hi_out),
      static_cast<const uint32_t*>(r), static_cast<const uint32_t*>(coeff),
      H, H_out, extent, bt.stride, bt.out_stride, f, pl, static_cast<long long*>(sums));
  return cudaGetLastError();
}

// launch modes of sc_round_launch_batched
constexpr int kModeNofold = 0, kModeFoldInPlace = 1, kModeFoldOut = 2;

using FoldKernel = void (*)(uint32_t*, uint32_t*, uint32_t*, uint32_t*, const uint32_t*,
                            const uint32_t*, long long, long long, long long, long long,
                            long long, Field, Plan, long long*);

// fold_kernel<D, ...> for the run-time degree, D <= degree <= kMaxRegisterDegree
template <int D, bool kOutOfPlace, bool kCoeffs, bool kBatched>
FoldKernel fold_for(int degree) {
  if constexpr (D < kMaxRegisterDegree) {
    if (degree > D) return fold_for<D + 1, kOutOfPlace, kCoeffs, kBatched>(degree);
  }
  return fold_kernel<D, kOutOfPlace, kCoeffs, kBatched>;
}

// The fold body of a fold launch (modes 1-2) at degree <= kMaxRegisterDegree,
// or null for a combination no path launches.
FoldKernel pick_fold(int mode, bool coeffs, bool batched, int degree) {
  switch (mode) {
    case kModeFoldInPlace:
      if (coeffs) return nullptr;
      return batched ? fold_for<1, false, false, true>(degree)
                     : fold_for<1, false, false, false>(degree);
    case kModeFoldOut:
      if (coeffs)
        return batched ? fold_for<1, true, true, true>(degree)
                       : fold_for<1, true, true, false>(degree);
      return batched ? fold_for<1, true, false, true>(degree)
                     : fold_for<1, true, false, false>(degree);
    default:
      return nullptr;
  }
}

// The operands of a wide_kernel launch.
struct WideLaunch {
  void *lo, *hi, *lo_out, *hi_out;
  const void *r, *coeff;
  long long H, H_out, extent, inst_stride, out_inst_stride;
  void* sums;
  dim3 grid;
  cudaStream_t stream;
};

// wide_kernel<kFold, kT> at the chunk `points`, one of kT, kRest...
template <bool kFold, int kT, int... kRest>
cudaError_t launch_wide(int points, const WideLaunch& w, const Field& f, const WidePlan& pl) {
  if constexpr (sizeof...(kRest) > 0) {
    if (points != kT) return launch_wide<kFold, kRest...>(points, w, f, pl);
  }
  if (points != kT) return cudaErrorInvalidValue;
  const size_t smem = wide_total_bytes(kT);
  const cudaError_t e = cudaFuncSetAttribute(
      wide_kernel<kFold, kT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  wide_kernel<kFold, kT><<<w.grid, kThreads, smem, w.stream>>>(
      static_cast<uint32_t*>(w.lo), static_cast<uint32_t*>(w.hi),
      static_cast<uint32_t*>(w.lo_out), static_cast<uint32_t*>(w.hi_out),
      static_cast<const uint32_t*>(w.r), static_cast<const uint32_t*>(w.coeff), w.H, w.H_out,
      w.extent, w.inst_stride, w.out_inst_stride, f, pl, static_cast<long long*>(w.sums));
  return cudaGetLastError();
}

// field.cuh's two multiplies: 0 = CIOS (mont_mul_cios), 1 = even/odd (mont_mul)
template <int kImpl>
__device__ __forceinline__ void probe_mul(uint32_t x[kLimbs], const uint32_t y[kLimbs],
                                          const Field& f) {
  if constexpr (kImpl == 0) {
    mont_mul_cios(x, x, y, f);
  } else {
    mont_mul(x, x, y, f);
  }
}

// Test hook of field.cuh's multiplies: per thread i, x = a[i] and then
// `reps` times x <- x * b[i] * 2^-256 mod p; a, b, out are (n, 8) limbs.
template <int kImpl>
__global__ void mont_mul_probe_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      uint32_t* __restrict__ out, long long n, int reps,
                                      Field f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[kLimbs], y[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    x[j] = a[i * kLimbs + j];
    y[j] = b[i * kLimbs + j];
  }
#pragma unroll 1
  for (int k = 0; k < reps; ++k) probe_mul<kImpl>(x, y, f);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) out[i * kLimbs + j] = x[j];
}

// Never launched: the SASS of kCount chained multiplies in straight-line
// code, so that the instruction counts of <impl, 2> minus those of
// <impl, 1> are exactly one multiply's (chip_smoke.py, phase 2).
template <int kImpl, int kCount>
__global__ void mont_mul_count_kernel(const uint32_t* __restrict__ a,
                                      uint32_t* __restrict__ out, Field f) {
  uint32_t x[kLimbs], y[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    x[j] = a[j];
    y[j] = a[kLimbs + j];
  }
#pragma unroll
  for (int k = 0; k < kCount; ++k) probe_mul<kImpl>(x, y, f);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) out[j] = x[j];
}

template __global__ void mont_mul_count_kernel<0, 1>(const uint32_t*, uint32_t*, Field);
template __global__ void mont_mul_count_kernel<0, 2>(const uint32_t*, uint32_t*, Field);
template __global__ void mont_mul_count_kernel<1, 1>(const uint32_t*, uint32_t*, Field);
template __global__ void mont_mul_count_kernel<1, 2>(const uint32_t*, uint32_t*, Field);

}  // namespace

extern "C" {

int sc_round_threads() { return kThreads; }

// mode: 0 = no fold; 1 = fold in place; 2 = fold out of place into lo_out,
// hi_out of width H_out (which must equal extent). coeff: products x 16 Montgomery
// digits, or null for none (modes 0 and 2 only). sums: the round's
// (degree+1, 16) int64 row, which the launch adds into.
// plan: slots, products, factors, degree, then products x kMaxFactors indices.
// field: p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32.
// batch: instances in the launch (grid y; 1 for a single pair): their pairs
// lie `inst_stride` words apart (U x 8 x H), their output tables
// `out_inst_stride` words apart (U x 8 x H_out), and r, coeff and sums hold
// one challenge (16 digits), one coefficient row (products x 16) and one
// sums row ((degree+1) x 16) per instance, back to back.
// Returns the cudaError_t of the launch (0 on success).
int sc_round_launch_batched(int mode, void* lo, void* hi, void* lo_out, void* hi_out,
                            const void* r, const void* coeff, long long H, long long H_out,
                            long long extent, long long batch, long long inst_stride,
                            long long out_inst_stride, const int* plan,
                            const uint32_t* field, void* sums, long long nblk, void* stream) {
  Plan pl;
  const cudaError_t bad = read_plan(plan, &pl);
  if (bad != cudaSuccess) return (int)bad;
  if (mode == kModeFoldOut && H_out != extent) return (int)cudaErrorInvalidValue;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const Batch bt{batch, inst_stride, out_inst_stride};
  const Field f = read_field(field);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = coeff != nullptr;
  if (mode == kModeNofold && pl.degree <= kMaxRegisterDegree) {
    return (int)(c ? launch_nofold<1, true>(lo, hi, coeff, H, extent, bt, f, pl, sums, nblk, s)
                   : launch_nofold<1, false>(lo, hi, coeff, H, extent, bt, f, pl, sums, nblk,
                                             s));
  }
  if (mode != kModeNofold && pl.degree <= kMaxRegisterDegree) {
    const FoldKernel kernel = pick_fold(mode, c, batch > 1, pl.degree);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = ladder_bytes(pl.slots);
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)nblk, (unsigned)batch), kThreads, smem, s>>>(
        static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), static_cast<uint32_t*>(lo_out),
        static_cast<uint32_t*>(hi_out), static_cast<const uint32_t*>(r),
        static_cast<const uint32_t*>(coeff), H, H_out, extent, inst_stride, out_inst_stride, f,
        pl, static_cast<long long*>(sums));
    return (int)cudaGetLastError();
  }
  switch (mode * 2 + (c ? 1 : 0)) {
    case 0:
      return (int)launch<false, false, false>(lo, hi, nullptr, nullptr, r, coeff, H, H,
                                              extent, bt, f, pl, sums, nblk, s);
    case 1:
      return (int)launch<false, false, true>(lo, hi, nullptr, nullptr, r, coeff, H, H,
                                             extent, bt, f, pl, sums, nblk, s);
    case 2:
      return (int)launch<true, false, false>(lo, hi, nullptr, nullptr, r, coeff, H, H,
                                             extent, bt, f, pl, sums, nblk, s);
    case 4:
      return (int)launch<true, true, false>(lo, hi, lo_out, hi_out, r, coeff, H, H_out,
                                            extent, bt, f, pl, sums, nblk, s);
    case 5:
      return (int)launch<true, true, true>(lo, hi, lo_out, hi_out, r, coeff, H, H_out,
                                           extent, bt, f, pl, sums, nblk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wide route (wide_kernel): the launch of sc_round_launch_batched for a
// structure past Plan's maxima. idx: the product index matrix (products x
// factors int32, a ragged product padded with the pair's constant-one slot),
// then each product's count of real factors (products int32), in device
// memory. one: the Montgomery one, 8 limbs.
int sc_round_launch_wide(int mode, void* lo, void* hi, void* lo_out, void* hi_out,
                         const void* r, const void* coeff, long long H, long long H_out,
                         long long extent, long long batch, long long inst_stride,
                         long long out_inst_stride, int slots, int products, int factors,
                         int degree, const int* idx, const uint32_t* field, const uint32_t* one,
                         void* sums, long long nblk, void* stream) {
  WidePlan pl;
  const cudaError_t bad = read_wide_plan(slots, products, factors, degree, idx, one, &pl);
  if (bad != cudaSuccess) return (int)bad;
  if (mode == kModeFoldOut && H_out != extent) return (int)cudaErrorInvalidValue;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (mode == kModeFoldInPlace && coeff != nullptr) return (int)cudaErrorInvalidValue;
  if ((mode == kModeFoldOut) != (lo_out != nullptr)) return (int)cudaErrorInvalidValue;
  const Field f = read_field(field);
  const WideLaunch w{lo, hi, lo_out, hi_out, r, coeff, H, H_out, extent, inst_stride,
                     out_inst_stride, sums, dim3((unsigned)nblk, (unsigned)batch),
                     static_cast<cudaStream_t>(stream)};
  const int points = wide_points(degree);
  switch (mode) {
    case kModeNofold: return (int)launch_wide<false, 4, 8, 10, kMaxWidePoints>(points, w, f, pl);
    case kModeFoldInPlace:
    case kModeFoldOut: return (int)launch_wide<true, 4, 8, 10, kMaxWidePoints>(points, w, f, pl);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks a multiprocessor holds of the in-place fold body of a
// single launch at this degree and slot count
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 for a degree above
// kMaxRegisterDegree or a failed query.
int sc_round_blocks_per_sm(int degree, int slots) {
  if (degree < 1 || degree > kMaxRegisterDegree || slots < 1 || slots > kMaxSlots) return -1;
  const FoldKernel kernel = pick_fold(kModeFoldInPlace, false, false, degree);
  const size_t smem = ladder_bytes(slots);
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// impl: 0 = CIOS, 1 = even/odd accumulators.
int sc_mont_mul_probe(int impl, const void* a, const void* b, void* out, long long n,
                      int reps, const uint32_t* field, void* stream) {
  const int threads = 256;
  auto kernel = impl == 0 ? mont_mul_probe_kernel<0> : mont_mul_probe_kernel<1>;
  if (impl != 0 && impl != 1) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, reps, read_field(field));
  return (int)cudaGetLastError();
}

const char* sc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
