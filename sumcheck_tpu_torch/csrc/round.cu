// MLSumcheck round kernels for Hopper (sm_90a): fold by the challenge,
// evaluate the round polynomial at t = 0..d, and reduce per block.
//
// Replaces the Pallas kernels of sumcheck_tpu/ops/round_pallas.py:
//   - `_kernel_chain_nofold` / `_kernel_chain_fold` (the generic chain):
//     round_kernel<false, false, false> and round_kernel<true, false, false>,
//     which fold in place over a run-time extent;
//   - `_kernel_nofold` / `_kernel_fold` (the per-size chain, `_build` and
//     `round_pallas`): round_kernel<false, false, C> and
//     round_kernel<true, true, C>, which fold out of place into fresh
//     quarter-width tables, C = with per-product coefficients.
// Built by ops/cuda_build.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes by ops/round_cuda.py, which holds the plain
// PyTorch versions these kernels are checked against.
//
// Data layout (the JAX package's, kept at the tensor boundary): the table
// pair lo, hi is (U, 16, H) of 16-bit Montgomery digits in 32-bit words,
// slot axis leading, lane k of digit i of slot u at [(u * 16 + i) * H + k].
// A thread owns one lane k and joins its 16 digits into 8 x 32-bit limbs.
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
//       fresh (U, 16, A) tables lo_out, hi_out.
// Then for t = 0..d: total(t) = sum_p [c_p *] prod_{s in p} (E_s + t * (O_s
// - E_s)), fully reduced mod p, with the optional coefficient c_p
// multiplied onto the first factor, in the Pallas kernel's order. Each block
// adds the per-digit sums of total(t) over its lanes into the round's row
// sums[t][digit] (64-bit atomic adds, round_common.cuh). Lanes k >= A add
// nothing. The carry chain runs in the transcript step (transcript.cu) or
// on the host.
//
// What bounds them on the H100: per lane, a fold round of the 2x3 workload
// (6 slots) moves 2.3 KB and runs 12 Montgomery multiplies for the fold and
// 16 for the evaluation, each 64 32x32->64-bit multiply-adds plus carries:
// several integer instructions per byte moved, above the card's ratio of
// integer throughput to memory bandwidth, so 32-bit integer multiply
// throughput is the bound to expect. The design keeps to that: one lane per
// thread, 8 x 32-bit limbs, the multiply on the multiply-add's own carry
// chain (field.cuh), coalesced digit loads, each lane's values read from
// device memory once per round.
//
// Instance axis (the batched provers, sumcheck_tpu_torch/batch.py): a
// launch over B instances runs grid y = B; block (x, b) offsets its pair,
// output tables, challenge, coefficients and sums row to instance b's
// (sc_round_launch_batched), so every body above serves B instances in one
// launch, each folded by its own challenge. A single launch is B = 1; the
// ladder bodies then run an instantiation without the offsets
// (round_kernel<..., kBatched = false>).
//
// Structure: product shape (slots, products, factors, degree) and the
// product index matrix arrive at run time (struct Plan) with compile-time
// maxima; the wrapper raises above them. The ladder and the block-sum tail
// are shared with the MXU fold kernel (round_common.cuh). Coefficients, when
// given, sit in static shared memory. Round 0 up to degree
// kMaxRegisterDegree runs nofold_kernel, which evaluates in registers and
// needs no ladder; above it, round_kernel<false, false, C>.

#include "round_common.cuh"

namespace {

using namespace sc;

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
  // instance blockIdx.y of a batched launch: its tables, challenge,
  // coefficients and sums row. A single launch compiles without them: the
  // in-place fold lost 3.6% at 2^18 lanes to these few instructions on an
  // H100 (PERF.md).
  if constexpr (kBatched) {
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
  const long long slot_stride = (long long)kDigits * H;
  const long long out_stride = (long long)kDigits * H_out;

  if constexpr (kCoeffs) {
    for (int p = tid; p < pl.products; p += kThreads) {
      uint32_t c[kLimbs];
      load_lane(c, coeff_digits + p * kDigits, 1);
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) coeff[p][j] = c[j];
    }
    __syncthreads();
  }

  if (active) {
    uint32_t rr[kLimbs];
    if constexpr (kFold) load_lane(rr, r_digits, 1);
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

// Degrees up to which round 0 evaluates in registers (nofold_kernel); above
// it round_kernel<false, false, C> and its ladder in shared memory.
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

// Round 0 (no fold) at compile-time degree D <= kMaxRegisterDegree, with the
// evaluation in registers: product by product, factor by factor, each
// factor's E and O read from the tables and its values E + t (O - E) formed
// by additions and multiplied into the product's running values at t =
// 0..D. A product of l factors has degree l, so it is multiplied at t = 0..l
// only and extended to the next point by differences when the next factor
// needs it: 7 multiplies for a 3-factor product at D = 3, not 8. A
// coefficient multiplies the first factor's E and step (2 multiplies). The
// next factor's E and O load while this one multiplies. No shared ladder,
// so registers, not shared memory, set the blocks per SM.
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
  const long long slot_stride = (long long)kDigits * H;

  if constexpr (kCoeffs) {
    for (int p = tid; p < pl.products; p += kThreads) {
      uint32_t c[kLimbs];
      load_lane(c, coeff_digits + p * kDigits, 1);
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) coeff[p][j] = c[j];
    }
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
    for (int p = 0; p < pl.products; ++p) {
      uint32_t acc[D + 1][kLimbs];
      int known = D;  // acc holds the product so far at t = 0..known
      for (int l = 0; l < pl.factors; ++l) {
        uint32_t v[kLimbs], step[kLimbs];
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
#pragma unroll
  for (int t = 0; t <= D; ++t) warp_digit_sums(total[t], warp_sums[tid >> 5][t]);
  add_block_sums(warp_sums, D, sums);
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
// hi_out of width H_out (which must equal extent). coeff: products x 16
// Montgomery digits, or null for none (modes 0 and 2 only). sums: the
// round's (degree+1, 16) int64 row, which the launch adds into.
// plan: slots, products, factors, degree, then products x kMaxFactors indices.
// field: p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32.
// batch: instances in the launch (grid y; 1 for a single pair): their pairs
// lie `inst_stride` words apart (U x 16 x H), their output tables
// `out_inst_stride` words apart (U x 16 x H_out), and r, coeff and sums hold
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
  if (mode == 2 && H_out != extent) return (int)cudaErrorInvalidValue;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const Batch bt{batch, inst_stride, out_inst_stride};
  const Field f = read_field(field);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = coeff != nullptr;
  if (mode == 0 && pl.degree <= kMaxRegisterDegree) {
    return (int)(c ? launch_nofold<1, true>(lo, hi, coeff, H, extent, bt, f, pl, sums, nblk, s)
                   : launch_nofold<1, false>(lo, hi, coeff, H, extent, bt, f, pl, sums, nblk,
                                             s));
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
