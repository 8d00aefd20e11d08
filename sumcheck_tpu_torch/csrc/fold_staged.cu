// The yardstick of round.cu's fold body (fold_kernel): the same in-place
// fold round of the generic chain (round_fold: fold lo + r (hi - lo) over
// the extent, then the sums at t = 0..d), with each slot's four stripes
// staged in shared memory by cp.async where fold_kernel prefetches them into
// registers. A library of its own, built and loaded only by
// ops/fold_staged.py, which chip_smoke.py's phase 6e and the `cuda` tests
// call; no path of the package launches it.
//
// Stage: two buffers of one slot's four stripes (lo[k], hi[k], lo[k + A],
// hi[k + A] for the block's 128 lanes), [buffer][stripe][limb][thread], 32
// KB after the ladder in dynamic shared memory. The block copies slot u + 1
// into one buffer while it folds slot u from the other: 1,024 16-byte
// cp.async.cg copies a slot, 8 a thread, consecutive threads on consecutive
// 16 bytes of one limb row, so each warp copies 512 contiguous bytes. A
// block barrier after each slot's copy makes it visible to every thread and
// frees the other buffer. So the extent, the pair width and the pointers
// must be multiples of 4 lanes and 16 bytes (the wrapper checks). The fold,
// the ladder (E, O - E) and the evaluation in registers are fold_kernel's
// (round_common.cuh), for degree <= kMaxRegisterDegree, one instance, no
// coefficients.

#include "round_common.cuh"

namespace {

using namespace sc;

constexpr int kStripes = 4;
constexpr int kBufferWords = kStripes * kLimbs * kThreads;  // one slot's stripes
constexpr size_t kStageBytes = 2 * kBufferWords * sizeof(uint32_t);
constexpr int kRowChunks = kThreads / 4;  // 16-byte chunks of one limb row
constexpr int kCopiesPerThread = kBufferWords / 4 / kThreads;

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fold_staged_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                       const uint32_t* __restrict__ r_digits, long long H, long long extent,
                       Field f, Plan pl, long long* __restrict__ sums) {
  extern __shared__ uint32_t ladder[];  // [slot][E|step][limb][thread], then the stage
  __shared__ uint32_t warp_sums[kThreads / 32][kMaxDegree + 1][kDigits];

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long k = base + tid;
  const bool active = k < extent;
  const long long slot_stride = (long long)kLimbs * H;
  uint32_t* stage = ladder + ladder_bytes(pl.slots) / sizeof(uint32_t);

  // the block's copy of slot u's four stripes into buffer u % 2
  auto issue = [&](int u) {
    uint32_t* buf = stage + (u & 1) * kBufferWords;
#pragma unroll
    for (int i = 0; i < kCopiesPerThread; ++i) {
      const int c = i * kThreads + tid;
      const int row = c / kRowChunks;  // stripe * kLimbs + limb
      const int lane = 4 * (c % kRowChunks);
      if (base + lane >= extent) continue;
      const int s = row / kLimbs;
      const uint32_t* src = (s & 1 ? hi : lo) + u * slot_stride + (row % kLimbs) * H + base +
                            lane + (s >> 1 ? extent : 0);
      cp_async16(buf + row * kThreads + lane, src);
    }
    cp_async_commit();
  };

  uint32_t total[D + 1][kLimbs];
#pragma unroll
  for (int t = 0; t <= D; ++t)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) total[t][j] = 0;

  uint32_t rr[kLimbs];
  load_digits(rr, r_digits);
  issue(0);
  for (int u = 0; u < pl.slots; ++u) {
    cp_async_wait_all();
    __syncthreads();  // slot u is in; every thread is done with slot u - 1's buffer
    if (u + 1 < pl.slots) issue(u + 1);
    if (active) {
      const uint32_t* buf = stage + (u & 1) * kBufferWords;
      uint32_t x[kStripes][kLimbs];
#pragma unroll
      for (int s = 0; s < kStripes; ++s)
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) x[s][j] = buf[(s * kLimbs + j) * kThreads + tid];
      uint32_t e[kLimbs], o[kLimbs];
      fold(e, x[0], x[1], rr, f);
      fold(o, x[2], x[3], rr, f);
      store_lane(lo + u * slot_stride + k, H, e);
      store_lane(hi + u * slot_stride + k, H, o);
      ladder_put(ladder, u, e, o, f, tid);
    }
  }
  if (active) {
    register_sums<D, false>(
        total, pl, nullptr, f,
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

using StagedKernel = void (*)(uint32_t*, uint32_t*, const uint32_t*, long long, long long,
                              Field, Plan, long long*);

// fold_staged_kernel<D> for the run-time degree, D <= degree <= kMaxRegisterDegree
template <int D>
StagedKernel staged_for(int degree) {
  if constexpr (D < kMaxRegisterDegree) {
    if (degree > D) return staged_for<D + 1>(degree);
  }
  return fold_staged_kernel<D>;
}

size_t staged_smem(int slots) { return ladder_bytes(slots) + kStageBytes; }

}  // namespace

extern "C" {

int sc_fold_staged_threads() { return kThreads; }

// The in-place fold round of round.cu's mode 1 through the staged body:
// lo, hi (U, 8, H) limbs; r: the challenge's 16 Montgomery digits; plan and
// field as sc_round_launch_batched takes them; sums: the round's (degree+1,
// 16) int64 row, which the launch adds into. Degree <= kMaxRegisterDegree;
// H and extent multiples of 4. Returns the cudaError_t of the launch.
int sc_fold_staged_launch(void* lo, void* hi, const void* r, long long H, long long extent,
                          const int* plan, const uint32_t* field, void* sums, long long nblk,
                          void* stream) {
  Plan pl;
  const cudaError_t bad = read_plan(plan, &pl);
  if (bad != cudaSuccess) return (int)bad;
  if (pl.degree > kMaxRegisterDegree || H % 4 || extent % 4 || extent < 4 || 2 * extent > H)
    return (int)cudaErrorInvalidValue;
  const StagedKernel kernel = staged_for<1>(pl.degree);
  const size_t smem = staged_smem(pl.slots);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)nblk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), static_cast<const uint32_t*>(r),
      H, extent, read_field(field), pl, static_cast<long long*>(sums));
  return (int)cudaGetLastError();
}

// Resident blocks a multiprocessor holds of the staged body at this degree
// and slot count, or -1 for a degree above kMaxRegisterDegree or a failed
// query.
int sc_fold_staged_blocks_per_sm(int degree, int slots) {
  if (degree < 1 || degree > kMaxRegisterDegree || slots < 1 || slots > kMaxSlots) return -1;
  const StagedKernel kernel = staged_for<1>(degree);
  const size_t smem = staged_smem(slots);
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

const char* sc_fold_staged_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
