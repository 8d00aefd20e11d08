// The GKR phase inits for Hopper (sm_90a): four kernels that together build
// each phase's (lo, hi) table pair of the GKR round sumcheck.
//
// Replaces the JAX package's jitted jnp device programs of the phase inits
// (sumcheck_tpu/ops/gkr_init.py): `_phase1_pair_body` and
// `_phase2_pair_body` (:472-523) and the per-size pieces `_compiled_phase1`,
// `_compiled_prep1`, `_compiled_final_fold`, `_compiled_phase2_digits` and
// `_compiled_prep2` (:284-312, :595-654). XLA fused each into one program; a
// port of them as torch ops ran about 13,000 launches a phase, 10,674 of
// them the eq table's doublings. Built by ops/cuda_build.py, loaded by
// ops/gkr_init_cuda.py, which holds each kernel's plain PyTorch version.
//
// The function. Phase 1 sums f1's nonzeros v_j at index (g_j, x_j, y_j) into
// h_g[x] = sum_j v_j eq(g, g_j) f3[y_j]; phase 2 sums the weights w_j =
// v_j eq(g, g_j) into f1(g, u, y) = sum_j w_j eq(u, x_j) at y_j. Each is a
// weight fold, an exact segment sum, and the pair's second slot:
//
//   eq_halves_kernel     eq(r, j) factors as eq_lo[j & m] * eq_hi[j >> kl]
//                        over the low kl = ceil(k/2) and high k - kl bits;
//                        one lane a thread writes both half tables,
//                        2^kl + 2^(k-kl) lanes (1,024 at k = 18, 32 KB);
//   weight_fold_kernel   w_j = v_j * eq_lo[idx_j & m] * eq_hi[idx_j >> kl],
//                        and in phase 1 wv_j = w_j * f3[y_j], the half
//                        tables staged in shared memory;
//   segment_reduce_kernel  the exact sum mod p of each segment of the sorted
//                        entries (read through a permutation in phase 2),
//                        8 limb sums in 64-bit accumulators, a carry pass and
//                        a full reduction; or the raw limb sums (a rank's
//                        partial), or the finish of all-reduced sums;
//   pair_slots_kernel    the pair's other slots: a copy of a table, a table
//                        times a scalar on the device, or times the final
//                        fold l + r (h - l) of a one-lane pair (f2(u)).
//
// Layout: values are 8 x 32-bit limbs (field.cuh), tables limb-major (limb
// j of lane k at [j * stride + k]); f1's entries (8, nnz), sorted on the
// host by the bit-reversed segment of phase 1, with int32 index
// components; the challenges are the chain's rows of 16 x 16-bit digits.
// The field product is exact and every stored value canonical, so any
// association of the products gives the JAX package's bytes.
//
// What bounds it: at the main shape (dim 18, 2^18 entries) the weight fold
// moves 136 B an entry and does 3 Montgomery multiplies (0.0124 ms of
// 32-bit multiplies on an H100, against 0.0107 ms of bytes), the segment
// reduce 68 B an entry and one multiply a segment, a pair slot 64 B a lane;
// the eq halves are latency. Each phase is 4 launches and none waits for the
// host. The f3 gather and phase 2's permuted reads are random 4-byte loads
// of limb-major tables, 8 sectors an entry: the design keeps the half eq
// tables in shared memory (random reads there cost bank conflicts, not
// sectors) and lets each thread sum a segment of up to kLongSegment entries
// alone (the main shape's segments hold about one entry each), the whole
// block longer ones.

#include "field.cuh"

namespace {

using namespace sc;

constexpr int kThreads = 256;
constexpr int kLongSegment = 64;   // entries one thread sums alone
constexpr int kMaxSharedEq = 3072; // half-table lanes staged in shared memory (96 KB)
constexpr int kWarps = kThreads / 32;

// The field and the constants the inits need, by value.
struct Consts {
  Field f;
  uint32_t one[kLimbs];  // the Montgomery one, R mod p
  uint32_t r2[kLimbs];   // R^2 mod p
  int reduce_subs;       // subtractions of p that take any value below 2^256 into [0, p)
};

__device__ __forceinline__ void copy8(uint32_t d[kLimbs], const uint32_t s[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) d[j] = s[j];
}

// Store 8 limbs as a row of 16 consecutive 16-bit digits.
__device__ __forceinline__ void store_digits(int32_t* digits, const uint32_t x[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    digits[2 * j] = (int32_t)(x[j] & 0xFFFF);
    digits[2 * j + 1] = (int32_t)(x[j] >> 16);
  }
}

// ---------------------------------------------------------------------------
// the eq half tables
// ---------------------------------------------------------------------------

// eq[t] = prod_{i < kl} (bit_i(t) ? r_i : 1 - r_i) for t < 2^kl, and
// eq[2^kl + t] = prod_{i < kh} (bit_i(t) ? r_{kl+i} : 1 - r_{kl+i}) for
// t < 2^kh (the empty product is the Montgomery one). eq is (8, 2^kl + 2^kh).
__global__ void __launch_bounds__(kThreads)
    eq_halves_kernel(uint32_t* __restrict__ eq, int kl, int kh,
                     const int32_t* __restrict__ r, long long r_stride,
                     const __grid_constant__ Consts c) {
  const long long nlo = 1LL << kl, lanes = nlo + (1LL << kh);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= lanes) return;
  const bool low = t < nlo;
  const long long j = low ? t : t - nlo;
  const int first = low ? 0 : kl, count = low ? kl : kh;
  uint32_t acc[kLimbs];
  copy8(acc, c.one);
  for (int i = 0; i < count; ++i) {
    uint32_t ri[kLimbs], x[kLimbs];
    load_digits(ri, reinterpret_cast<const uint32_t*>(r + (first + i) * r_stride));
    if ((j >> i) & 1) {
      copy8(x, ri);
    } else {
      sub_mod(x, c.one, ri, c.f);  // 1 - r_i
    }
    if (i == 0) {
      copy8(acc, x);
    } else {
      mont_mul(acc, acc, x, c.f);
    }
  }
  store_lane(eq + t, lanes, acc);
}

// ---------------------------------------------------------------------------
// the weight fold
// ---------------------------------------------------------------------------

// w[:, j] = vals[:, j] * eq_lo[idx_j & (2^kl - 1)] * eq_hi[idx_j >> kl], and
// with kGather wv[:, j] = w[:, j] * f3[:, y_j] (f3 (8, n3)); entries in a
// grid-stride loop. kShared stages the (8, 2^kl + 2^kh) half tables in
// shared memory (dynamic, 32 B a lane), else they are read from the cache.
template <bool kShared, bool kGather>
__global__ void __launch_bounds__(kThreads)
    weight_fold_kernel(uint32_t* __restrict__ w, uint32_t* __restrict__ wv,
                       const uint32_t* __restrict__ vals, const int32_t* __restrict__ idx,
                       long long nnz, const uint32_t* __restrict__ eq, int kl, int kh,
                       const int32_t* __restrict__ y, const uint32_t* __restrict__ f3,
                       long long n3, const __grid_constant__ Consts c) {
  extern __shared__ uint32_t s_eq[];
  const int nlo = 1 << kl, lanes = nlo + (1 << kh);
  const uint32_t* tab = eq;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < kLimbs * lanes; i += kThreads) s_eq[i] = __ldg(eq + i);
    __syncthreads();
    tab = s_eq;
  }
  const uint32_t mask = (uint32_t)nlo - 1;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < nnz;
       j += (long long)gridDim.x * kThreads) {
    const uint32_t ix = (uint32_t)__ldg(idx + j);
    uint32_t v[kLimbs], a[kLimbs];
    load_lane(v, vals + j, nnz);
    load_lane(a, tab + (ix & mask), lanes);
    mont_mul(v, v, a, c.f);
    load_lane(a, tab + nlo + (ix >> kl), lanes);
    mont_mul(v, v, a, c.f);
    store_lane(w + j, nnz, v);
    if constexpr (kGather) {
      load_lane(a, f3 + __ldg(y + j), n3);
      mont_mul(v, v, a, c.f);
      store_lane(wv + j, nnz, v);
    }
  }
}

// ---------------------------------------------------------------------------
// the exact segment reduce
// ---------------------------------------------------------------------------

// Where segment s's strict value goes: limb j at
// (s < split ? lo + s : hi + (s - split)) + j * ld. A (8, n) table is lo with
// split = n; slot 0 of a (lo, hi) pair of half width H is split = ld = H.
struct SegDest {
  uint32_t* lo;
  uint32_t* hi;
  long long ld;
  long long split;
};

// acc += the 8 limbs of sorted entry q (entry perm[q] of vals, or q)
__device__ __forceinline__ void add_entry(uint64_t acc[kLimbs], const uint32_t* __restrict__ vals,
                                          long long nnz, const int32_t* __restrict__ perm,
                                          long long q) {
  const long long e = perm ? (long long)__ldg(perm + q) : q;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) acc[j] += __ldg(vals + j * nnz + e);
}

// 8 limb sums (each below 2^61) -> their value mod p, canonical: one carry
// pass into 8 limbs and a word above 2^256, the low 256 bits reduced by
// reduce_subs conditional subtractions, the high word times 2^256 as
// mont_mul(high, R^2), and one modular add.
__device__ __forceinline__ void finish(uint32_t out[kLimbs], const uint64_t acc[kLimbs],
                                       const Consts& c) {
  uint32_t lo[kLimbs], hi[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t t = acc[j] + carry;
    lo[j] = (uint32_t)t;
    carry = t >> 32;
  }
  for (int i = 0; i < c.reduce_subs; ++i) cond_sub_p(lo, c.f);
  hi[0] = (uint32_t)carry;  // below 2^32 < p
  mont_mul(hi, hi, c.r2, c.f);
  add_mod(out, lo, hi, c.f);
}

__device__ __forceinline__ void emit(long long s, const uint64_t acc[kLimbs], long long nseg,
                                     unsigned long long* sums_out, const SegDest& dst,
                                     const Consts& c) {
  if (sums_out) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) sums_out[j * nseg + s] = acc[j];
    return;
  }
  uint32_t v[kLimbs];
  finish(v, acc, c);
  uint32_t* base = s < dst.split ? dst.lo + s : dst.hi + (s - dst.split);
  store_lane(base, dst.ld, v);
}

// Segment s of nseg: the sorted entries (s == 0 ? 0 : last[s-1] + 1) ..
// last[s] (last = -1 before the first entry; an empty segment repeats the
// previous last), summed limb by limb. kFromSums reads the (8, nseg) limb
// sums instead (all-reduced over the ranks). Writes the raw sums where
// sums_out is given, else the strict value to dst. One thread a segment;
// a segment of more than kLongSegment entries is summed by the whole block
// after the short ones, its threads striding over the entries.
template <bool kFromSums>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const uint32_t* __restrict__ vals, long long nnz,
                          const int32_t* __restrict__ perm, const int32_t* __restrict__ last,
                          const unsigned long long* __restrict__ sums_in,
                          unsigned long long* __restrict__ sums_out, long long nseg, SegDest dst,
                          const __grid_constant__ Consts c) {
  __shared__ int s_long[kThreads];
  __shared__ int s_nlong;
  __shared__ uint64_t s_part[kWarps][kLimbs];
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint64_t acc[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
  if constexpr (kFromSums) {
    if (s < nseg) {
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) acc[j] = sums_in[j * nseg + s];
      emit(s, acc, nseg, nullptr, dst, c);
    }
    return;
  } else {
    if (threadIdx.x == 0) s_nlong = 0;
    __syncthreads();
    if (s < nseg) {
      const long long begin = s == 0 ? 0 : (long long)__ldg(last + s - 1) + 1;
      const long long end = (long long)__ldg(last + s) + 1;
      if (end - begin > kLongSegment) {
        s_long[atomicAdd(&s_nlong, 1)] = threadIdx.x;
      } else {
        for (long long q = begin; q < end; ++q) add_entry(acc, vals, nnz, perm, q);
        emit(s, acc, nseg, sums_out, dst, c);
      }
    }
    __syncthreads();
    const int nlong = s_nlong;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = 0; i < nlong; ++i) {
      const long long ls = (long long)blockIdx.x * kThreads + s_long[i];
      const long long begin = ls == 0 ? 0 : (long long)__ldg(last + ls - 1) + 1;
      const long long end = (long long)__ldg(last + ls) + 1;
      uint64_t part[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (long long q = begin + threadIdx.x; q < end; q += kThreads)
        add_entry(part, vals, nnz, perm, q);
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[j] += __shfl_down_sync(0xFFFFFFFFu, part[j], off);
        if (lane == 0) s_part[warp][j] = part[j];
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        uint64_t total[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int wi = 0; wi < kWarps; ++wi)
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) total[j] += s_part[wi][j];
        emit(ls, total, nseg, sums_out, dst, c);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// the pair's slots
// ---------------------------------------------------------------------------

constexpr int kMaxPairSlots = 2;
enum SlotMode : int { kCopy = 0, kScale = 1, kFoldScale = 2 };

// The slots one launch writes, and the final fold's operands: the scalar
// l + r (h - l) of lane 0 of slot fslot of a one-lane pair (flo, fhi; limb
// j at + fslot * fslot_stride + j * flimb_stride) and a challenge row fr.
struct PairPlan {
  int slot[kMaxPairSlots];
  int mode[kMaxPairSlots];
  const uint32_t* src[kMaxPairSlots];  // the slot's (8, 2H) table
  long long src_ld[kMaxPairSlots];     // its row stride
  long long src_step[kMaxPairSlots];   // its lane stride
  const int32_t* scale[kMaxPairSlots]; // kScale: 16 digits
  const uint32_t* flo;
  const uint32_t* fhi;
  long long fslot_stride, flimb_stride;
  int fslot;
  const int32_t* fr;
};

__device__ __forceinline__ void final_fold(uint32_t out[kLimbs], const PairPlan& p,
                                           const Consts& c) {
  uint32_t l[kLimbs], h[kLimbs], r[kLimbs], d[kLimbs];
  load_lane(l, p.flo + p.fslot * p.fslot_stride, p.flimb_stride);
  load_lane(h, p.fhi + p.fslot * p.fslot_stride, p.flimb_stride);
  load_digits(r, reinterpret_cast<const uint32_t*>(p.fr));
  sub_mod(d, h, l, c.f);
  mont_mul(d, d, r, c.f);
  add_mod(out, l, d, c.f);
}

// Slot p.slot[y] of the (U, 8, H) halves lo, hi at lane k < H, for y =
// blockIdx.y: lo[slot][:, k] = src[:, k] and hi[slot][:, k] = src[:, H + k],
// each times the slot's scalar where it has one (thread 0 of the block
// computes it into shared memory). With fold_out (a launch of one thread)
// only the final fold, as 16 digits.
__global__ void __launch_bounds__(kThreads)
    pair_slots_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, long long half,
                      int32_t* __restrict__ fold_out, const __grid_constant__ PairPlan p,
                      const __grid_constant__ Consts c) {
  __shared__ uint32_t s_scale[kLimbs];
  if (fold_out) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      uint32_t v[kLimbs];
      final_fold(v, p, c);
      store_digits(fold_out, v);
    }
    return;
  }
  const int y = blockIdx.y, mode = p.mode[y];
  if (mode != kCopy) {
    if (threadIdx.x == 0) {
      uint32_t v[kLimbs];
      if (mode == kScale) {
        load_digits(v, reinterpret_cast<const uint32_t*>(p.scale[y]));
      } else {
        final_fold(v, p, c);
      }
      copy8(s_scale, v);
    }
    __syncthreads();
  }
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= half) return;
  const long long ld = p.src_ld[y], step = p.src_step[y];
  const long long at = (long long)p.slot[y] * kLimbs * half + k;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    uint32_t v[kLimbs];
    load_lane(v, p.src[y] + (side * half + k) * step, ld);
    if (mode != kCopy) mont_mul(v, v, s_scale, c.f);
    store_lane((side ? hi : lo) + at, half, v);
  }
}

Consts make_consts(const uint32_t* words) {
  Consts c;
  for (int j = 0; j < kLimbs; ++j) {
    c.f.p[j] = words[j];
    c.one[j] = words[kLimbs + 1 + j];
    c.r2[j] = words[2 * kLimbs + 1 + j];
  }
  c.f.ninv = words[kLimbs];
  c.reduce_subs = (int)words[3 * kLimbs + 1];
  return c;
}

unsigned grid_of(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// The weight fold's blocks that fit on a device at once, by device, f3
// gather and k = kl + kh (which sets the shared memory): 0 until the first
// launch of that shape on the device works them out, so that later launches
// make no runtime call before the launch.
constexpr int kMaxDevices = 64;
constexpr int kMaxK = 48;
int g_fold_blocks[kMaxDevices][2][kMaxK + 1];

// Set the shared-memory limit of the shared variants (once a device, to
// what the largest staged tables need) and work out the resident blocks.
cudaError_t fold_blocks(int device, bool gather, int k, const void* fn, size_t smem, bool shared,
                        int* blocks) {
  int& cached = g_fold_blocks[device][gather][k];
  if (cached > 0) {
    *blocks = cached;
    return cudaSuccess;
  }
  cudaError_t e;
  if (shared && (e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)(kMaxSharedEq * kLimbs * sizeof(uint32_t)))) !=
                    cudaSuccess)
    return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)) !=
      cudaSuccess)
    return e;
  cached = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int sc_gkr_threads() { return kThreads; }
int sc_gkr_long_segment() { return kLongSegment; }
int sc_gkr_max_shared_eq() { return kMaxSharedEq; }

// The constants every launch takes: p (8 limbs), -p^-1 mod 2^32, the
// Montgomery one (8), R^2 mod p (8), the reduction's subtraction count; 26
// words.

// eq: (8, 2^kl + 2^kh) int32 out. r: the challenge rows, 16 int32 digits
// each, row i at r + i * r_stride.
int sc_gkr_eq_halves(void* eq, int kl, int kh, const void* r, long long r_stride,
                     const uint32_t* consts, void* stream) {
  if (kl < 0 || kh < 0 || kl > 24 || kh > 24) return (int)cudaErrorInvalidValue;
  const long long lanes = (1LL << kl) + (1LL << kh);
  eq_halves_kernel<<<grid_of(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(eq), kl, kh, static_cast<const int32_t*>(r), r_stride,
      make_consts(consts));
  return (int)cudaGetLastError();
}

// w, wv (null without y): (8, nnz) int32 out. vals (8, nnz), idx (nnz,),
// eq from sc_gkr_eq_halves; y (nnz,) and f3 (8, n3), or null. device: the
// current device's index.
int sc_gkr_weight_fold(void* w, void* wv, const void* vals, const void* idx, long long nnz,
                       const void* eq, int kl, int kh, const void* y, const void* f3,
                       long long n3, int device, const uint32_t* consts, void* stream) {
  if (nnz < 1 || kl < 0 || kh < 0 || kl > 24 || kh > 24 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const int lanes = (1 << kl) + (1 << kh);
  const bool shared = lanes <= kMaxSharedEq, gather = y != nullptr;
  const size_t smem = shared ? (size_t)lanes * kLimbs * sizeof(uint32_t) : 0;
  const void* fn = shared ? (gather ? (const void*)weight_fold_kernel<true, true>
                                    : (const void*)weight_fold_kernel<true, false>)
                          : (gather ? (const void*)weight_fold_kernel<false, true>
                                    : (const void*)weight_fold_kernel<false, false>);
  // as many blocks as fit at once, each staging the tables once
  int most = 0;
  const cudaError_t e = fold_blocks(device, gather, kl + kh, fn, smem, shared, &most);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(grid_of(nnz) < (unsigned)most ? grid_of(nnz) : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wp = static_cast<uint32_t*>(w);
  uint32_t* wvp = static_cast<uint32_t*>(wv);
  const uint32_t* vp = static_cast<const uint32_t*>(vals);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const uint32_t* ep = static_cast<const uint32_t*>(eq);
  const int32_t* yp = static_cast<const int32_t*>(y);
  const uint32_t* fp = static_cast<const uint32_t*>(f3);
  const Consts c = make_consts(consts);
  if (shared && gather) {
    weight_fold_kernel<true, true><<<grid, kThreads, smem, s>>>(wp, wvp, vp, ip, nnz, ep, kl, kh,
                                                                yp, fp, n3, c);
  } else if (shared) {
    weight_fold_kernel<true, false><<<grid, kThreads, smem, s>>>(wp, wvp, vp, ip, nnz, ep, kl,
                                                                 kh, yp, fp, n3, c);
  } else if (gather) {
    weight_fold_kernel<false, true><<<grid, kThreads, 0, s>>>(wp, wvp, vp, ip, nnz, ep, kl, kh,
                                                              yp, fp, n3, c);
  } else {
    weight_fold_kernel<false, false><<<grid, kThreads, 0, s>>>(wp, wvp, vp, ip, nnz, ep, kl, kh,
                                                               yp, fp, n3, c);
  }
  return (int)cudaGetLastError();
}

// From entries (sums_in null): vals (8, nnz), perm (nnz,) or null, last
// (nseg,); the raw (8, nseg) int64 limb sums to sums_out if given, else the
// strict values to the destination. From sums (sums_in (8, nseg)): the
// strict values to the destination.
int sc_gkr_segment_reduce(const void* vals, long long nnz, const void* perm, const void* last,
                          const void* sums_in, void* sums_out, long long nseg, void* dst_lo,
                          void* dst_hi, long long dst_ld, long long dst_split,
                          const uint32_t* consts, void* stream) {
  if (nseg < 1 || (sums_in && sums_out) || (!sums_out && !dst_lo))
    return (int)cudaErrorInvalidValue;
  const SegDest dst = {static_cast<uint32_t*>(dst_lo), static_cast<uint32_t*>(dst_hi), dst_ld,
                       dst_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts c = make_consts(consts);
  const auto* in = static_cast<const unsigned long long*>(sums_in);
  auto* out = static_cast<unsigned long long*>(sums_out);
  if (sums_in) {
    segment_reduce_kernel<true><<<grid_of(nseg), kThreads, 0, s>>>(
        nullptr, 0, nullptr, nullptr, in, nullptr, nseg, dst, c);
  } else {
    segment_reduce_kernel<false><<<grid_of(nseg), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(vals), nnz, static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(last), nullptr, out, nseg, dst, c);
  }
  return (int)cudaGetLastError();
}

// lo, hi: (U, 8, half) halves. slots (1 or 2) of slot[], mode[] (0 copy, 1
// scale by the digits row scale[], 2 scale by the final fold), src[] with
// row stride src_ld[] and lane stride src_step[]; the final fold's one-lane
// pair flo, fhi (strides fslot_stride, flimb_stride), slot fslot and row fr.
// With fold_out (16 int32 out) and no slots: only the final fold.
int sc_gkr_pair_slots(void* lo, void* hi, long long half, int slots, const int* slot,
                      const int* mode, const void* const* src, const long long* src_ld,
                      const long long* src_step, const void* const* scale, const void* flo,
                      const void* fhi, long long fslot_stride, long long flimb_stride, int fslot,
                      const void* fr, void* fold_out, const uint32_t* consts, void* stream) {
  if (slots < 0 || slots > kMaxPairSlots || (slots == 0) != (fold_out != nullptr))
    return (int)cudaErrorInvalidValue;
  PairPlan p = {};
  for (int y = 0; y < slots; ++y) {
    if (mode[y] < kCopy || mode[y] > kFoldScale || !src[y] || (mode[y] == kScale && !scale[y]))
      return (int)cudaErrorInvalidValue;
    p.slot[y] = slot[y];
    p.mode[y] = mode[y];
    p.src[y] = static_cast<const uint32_t*>(src[y]);
    p.src_ld[y] = src_ld[y];
    p.src_step[y] = src_step[y];
    p.scale[y] = static_cast<const int32_t*>(scale[y]);
  }
  p.flo = static_cast<const uint32_t*>(flo);
  p.fhi = static_cast<const uint32_t*>(fhi);
  p.fslot_stride = fslot_stride;
  p.flimb_stride = flimb_stride;
  p.fslot = fslot;
  p.fr = static_cast<const int32_t*>(fr);
  const dim3 grid(fold_out ? 1u : grid_of(half), fold_out ? 1u : (unsigned)slots);
  pair_slots_kernel<<<grid, fold_out ? 1 : kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), half,
      static_cast<int32_t*>(fold_out), p, make_consts(consts));
  return (int)cudaGetLastError();
}

const char* sc_gkr_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
