// MLSumcheck round kernels for Hopper (sm_90a): fold by the challenge,
// evaluate the round polynomial at t = 0..d, and reduce per block.
//
// Replaces the Pallas kernels `_kernel_chain_nofold` and
// `_kernel_chain_fold` of sumcheck_tpu/ops/round_pallas.py (and the jnp
// `first_block` / `fold_block` bodies of protocol/generic_prover.py).
// Built by ops/round_cuda.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes; the Python wrappers there hold the plain
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
//             O_u = fold(lo[u][k + A], hi[u][k + A]),
//             written back to lo[u][k], hi[u][k]                 (k < A)
//             where fold(x, y) = x + r * (y - x).
// Lane k is read and written only by its own thread, and the upper stripe
// [A, 2A) is read-only in the round, so the in-place fold is race-free.
// Then for t = 0..d: total(t) = sum_p prod_{s in p} (E_s + t * (O_s - E_s)),
// fully reduced mod p. Each block writes the per-digit sums of total(t) over
// its lanes, as 64-bit integers: part[block][t][digit]. Lanes k >= A add
// nothing. The caller sums the blocks and carries the digits on the host.
//
// Field arithmetic: Montgomery form with R = 2^256, 8 x 32-bit limbs, CIOS
// multiplication with 64-bit intermediates. p and -p^-1 mod 2^32 arrive as
// launch parameters (struct Field), so another field changes no code here.
// Every result is fully reduced into [0, p), as the JAX limb code does, so
// the integers (and the digit sums) are bit-identical to it.
//
// Structure: product shape (slots, products, factors, degree) and the
// product index matrix arrive at run time (struct Plan) with compile-time
// maxima; the wrapper raises above them. The ladder values of all slots
// live in dynamic shared memory, [slot][cur|step][limb][thread], so runtime
// slot indices cost no local memory and consecutive threads hit
// consecutive banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 8;     // 32-bit limbs per field element
constexpr int kDigits = 16;   // 16-bit digits per field element (storage)
constexpr int kThreads = 128; // threads per block
constexpr int kMaxSlots = 16;
constexpr int kMaxProducts = 16;
constexpr int kMaxFactors = 8;
constexpr int kMaxDegree = 8;

struct Field {
  uint32_t p[kLimbs];
  uint32_t ninv;  // -p^-1 mod 2^32
};

struct Plan {
  int slots;
  int products;
  int factors;
  int degree;
  int idx[kMaxProducts * kMaxFactors];  // idx[p * kMaxFactors + l]
};

__device__ __forceinline__ void load_lane(uint32_t x[kLimbs],
                                          const uint32_t* base,
                                          long long stride) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint32_t d0 = base[(2 * j) * stride];
    const uint32_t d1 = base[(2 * j + 1) * stride];
    x[j] = d0 | (d1 << 16);
  }
}

__device__ __forceinline__ void store_lane(uint32_t* base, long long stride,
                                           const uint32_t x[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    base[(2 * j) * stride] = x[j] & 0xFFFFu;
    base[(2 * j + 1) * stride] = x[j] >> 16;
  }
}

// x in [0, 2p) -> [0, p).
__device__ __forceinline__ void cond_sub_p(uint32_t x[kLimbs], const Field& f) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t t = (uint64_t)x[j] - f.p[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) x[j] = borrow ? x[j] : d[j];
}

// r = a + b mod p. a, b < p < 2^255, so a + b < 2^256 carries out nothing.
__device__ __forceinline__ void add_mod(uint32_t r[kLimbs],
                                        const uint32_t a[kLimbs],
                                        const uint32_t b[kLimbs],
                                        const Field& f) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t t = (uint64_t)a[j] + b[j] + c;
    r[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  cond_sub_p(r, f);
}

// r = a - b mod p.
__device__ __forceinline__ void sub_mod(uint32_t r[kLimbs],
                                        const uint32_t a[kLimbs],
                                        const uint32_t b[kLimbs],
                                        const Field& f) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t t = (uint64_t)a[j] - b[j] - borrow;
    r[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back on a borrow
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t t = (uint64_t)r[j] + (f.p[j] & mask) + c;
    r[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

// r = a * b * 2^-256 mod p (CIOS). r may alias a or b.
__device__ __forceinline__ void mont_mul(uint32_t r[kLimbs],
                                         const uint32_t a[kLimbs],
                                         const uint32_t b[kLimbs],
                                         const Field& f) {
  uint32_t t[kLimbs + 2];
#pragma unroll
  for (int j = 0; j < kLimbs + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      const uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;  // < 2^64
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kLimbs] + c;
    t[kLimbs] = (uint32_t)s;
    t[kLimbs + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * f.ninv;
    s = (uint64_t)m * f.p[0] + t[0];  // low word becomes 0
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kLimbs; ++j) {
      s = (uint64_t)m * f.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kLimbs] + c;
    t[kLimbs - 1] = (uint32_t)s;
    t[kLimbs] = t[kLimbs + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p < 2^256, so t[kLimbs] == 0 here
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = t[j];
  cond_sub_p(r, f);
}

// r = x + c * (y - x) mod p
__device__ __forceinline__ void fold(uint32_t r[kLimbs],
                                     const uint32_t x[kLimbs],
                                     const uint32_t y[kLimbs],
                                     const uint32_t c[kLimbs],
                                     const Field& f) {
  uint32_t d[kLimbs];
  sub_mod(d, y, x, f);
  mont_mul(d, d, c, f);
  add_mod(r, x, d, f);
}

template <bool kFold>
__global__ void __launch_bounds__(kThreads)
    round_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                 const uint32_t* __restrict__ r_digits, long long H,
                 long long extent, Field f, Plan pl,
                 long long* __restrict__ part) {
  extern __shared__ uint32_t ladder[];  // [slot][cur|step][limb][thread]
  __shared__ uint32_t warp_sums[kThreads / 32][kMaxDegree + 1][kDigits];

  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const bool active = k < extent;
  const long long slot_stride = (long long)kDigits * H;
#define LADDER(u, which, j) ladder[(((u) * 2 + (which)) * kLimbs + (j)) * kThreads + tid]

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
        store_lane(lo_u, H, e);
        store_lane(hi_u, H, o);
      } else {
        load_lane(e, lo_u, H);
        load_lane(o, hi_u, H);
      }
      sub_mod(o, o, e, f);  // step
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) {
        LADDER(u, 0, j) = e[j];
        LADDER(u, 1, j) = o[j];
      }
    }
  }

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
            c[j] = LADDER(u, 0, j);
            s[j] = LADDER(u, 1, j);
          }
          add_mod(c, c, s, f);
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) LADDER(u, 0, j) = c[j];
        }
      }
      for (int p = 0; p < pl.products; ++p) {
        uint32_t term[kLimbs];
        const int s0 = pl.idx[p * kMaxFactors];
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) term[j] = LADDER(s0, 0, j);
        for (int l = 1; l < pl.factors; ++l) {
          const int sl = pl.idx[p * kMaxFactors + l];
          uint32_t x[kLimbs];
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) x[j] = LADDER(sl, 0, j);
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
#undef LADDER
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

template <bool kFold>
cudaError_t launch(void* lo, void* hi, const void* r, long long H,
                   long long extent, const Field& f, const Plan& pl,
                   void* part, long long nblk, cudaStream_t stream) {
  const size_t smem = (size_t)pl.slots * 2 * kLimbs * kThreads * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      round_kernel<kFold>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  round_kernel<kFold><<<(unsigned)nblk, kThreads, smem, stream>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi),
      static_cast<const uint32_t*>(r), H, extent, f, pl,
      static_cast<long long*>(part));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sc_round_threads() { return kThreads; }

// plan: slots, products, factors, degree, then products x kMaxFactors indices.
// field: p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32.
// Returns the cudaError_t of the launch (0 on success).
int sc_round_launch(int do_fold, void* lo, void* hi, const void* r,
                    long long H, long long extent, const int* plan,
                    const uint32_t* field, void* part, long long nblk,
                    void* stream) {
  Plan pl;
  pl.slots = plan[0];
  pl.products = plan[1];
  pl.factors = plan[2];
  pl.degree = plan[3];
  if (pl.slots < 1 || pl.slots > kMaxSlots || pl.products < 1 ||
      pl.products > kMaxProducts || pl.factors < 1 ||
      pl.factors > kMaxFactors || pl.degree < 1 || pl.degree > kMaxDegree)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < kMaxProducts * kMaxFactors; ++q) pl.idx[q] = plan[4 + q];
  Field f;
  for (int j = 0; j < kLimbs; ++j) f.p[j] = field[j];
  f.ninv = field[kLimbs];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      do_fold ? launch<true>(lo, hi, r, H, extent, f, pl, part, nblk, s)
              : launch<false>(lo, hi, r, H, extent, f, pl, part, nblk, s);
  return (int)e;
}

const char* sc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
