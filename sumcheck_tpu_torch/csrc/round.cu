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
// writes the per-digit sums of total(t) over its lanes, as 64-bit integers:
// part[block][t][digit]. Lanes k >= A add nothing. The caller sums the
// blocks; the carry chain runs in the transcript step (transcript.cu) or on
// the host.
//
// What bounds them on the H100: per lane, a fold round of the 2x3 workload
// (6 slots) moves 2.3 KB and runs 12 Montgomery multiplies for the fold and
// 16 for the evaluation, each 64 32x32->64-bit multiply-adds plus carries:
// several integer instructions per byte moved, above the card's ratio of
// integer throughput to memory bandwidth, so 32-bit integer multiply
// throughput is the bound to expect. The design keeps to that: one lane per
// thread, 8 x 32-bit limbs with 64-bit products (CIOS), coalesced digit
// loads, each lane's values read from device memory once per round.
//
// Structure: product shape (slots, products, factors, degree) and the
// product index matrix arrive at run time (struct Plan) with compile-time
// maxima; the wrapper raises above them. The ladder and the block-sum tail
// are shared with the MXU fold kernel (round_common.cuh). Coefficients, when
// given, sit in static shared memory.

#include "round_common.cuh"

namespace {

using namespace sc;

template <bool kFold, bool kOutOfPlace, bool kCoeffs>
__global__ void __launch_bounds__(kThreads)
    round_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                 uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
                 const uint32_t* __restrict__ r_digits,
                 const uint32_t* __restrict__ coeff_digits, long long H,
                 long long H_out, long long extent, Field f, Plan pl,
                 long long* __restrict__ part) {
  static_assert(kFold || !kOutOfPlace, "only a fold writes tables");
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
  ladder_block_sums<kCoeffs>(ladder, warp_sums, coeff, active, f, pl, part);
}

template <bool kFold, bool kOutOfPlace, bool kCoeffs>
cudaError_t launch(void* lo, void* hi, void* lo_out, void* hi_out,
                   const void* r, const void* coeff, long long H,
                   long long H_out, long long extent, const Field& f,
                   const Plan& pl, void* part, long long nblk,
                   cudaStream_t stream) {
  auto kernel = round_kernel<kFold, kOutOfPlace, kCoeffs>;
  const size_t smem = ladder_bytes(pl.slots);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)nblk, kThreads, smem, stream>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo_out), static_cast<uint32_t*>(hi_out),
      static_cast<const uint32_t*>(r), static_cast<const uint32_t*>(coeff),
      H, H_out, extent, f, pl, static_cast<long long*>(part));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sc_round_threads() { return kThreads; }

// mode: 0 = no fold; 1 = fold in place; 2 = fold out of place into lo_out,
// hi_out of width H_out (which must equal extent). coeff: products x 16
// Montgomery digits, or null for none (modes 0 and 2 only).
// plan: slots, products, factors, degree, then products x kMaxFactors indices.
// field: p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32.
// Returns the cudaError_t of the launch (0 on success).
int sc_round_launch(int mode, void* lo, void* hi, void* lo_out, void* hi_out,
                    const void* r, const void* coeff, long long H,
                    long long H_out, long long extent, const int* plan,
                    const uint32_t* field, void* part, long long nblk,
                    void* stream) {
  Plan pl;
  const cudaError_t bad = read_plan(plan, &pl);
  if (bad != cudaSuccess) return (int)bad;
  if (mode == 2 && H_out != extent) return (int)cudaErrorInvalidValue;
  const Field f = read_field(field);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = coeff != nullptr;
  switch (mode * 2 + (c ? 1 : 0)) {
    case 0:
      return (int)launch<false, false, false>(lo, hi, nullptr, nullptr, r, coeff, H, H,
                                              extent, f, pl, part, nblk, s);
    case 1:
      return (int)launch<false, false, true>(lo, hi, nullptr, nullptr, r, coeff, H, H,
                                             extent, f, pl, part, nblk, s);
    case 2:
      return (int)launch<true, false, false>(lo, hi, nullptr, nullptr, r, coeff, H, H,
                                             extent, f, pl, part, nblk, s);
    case 4:
      return (int)launch<true, true, false>(lo, hi, lo_out, hi_out, r, coeff, H, H_out,
                                            extent, f, pl, part, nblk, s);
    case 5:
      return (int)launch<true, true, true>(lo, hi, lo_out, hi_out, r, coeff, H, H_out,
                                           extent, f, pl, part, nblk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
