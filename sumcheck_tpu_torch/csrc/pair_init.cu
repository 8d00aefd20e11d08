// The ML table pair's init for Hopper (sm_90a): every slot of one
// instance's (lo, hi) pair in one launch.
//
// Replaces the JAX package's `_stacker` (sumcheck_tpu/protocol/
// device_prover.py), as `init_pair` uses it: the polynomial's unique tables
// (bit-reversed, cached on the device by `DenseMLE.to_device`), a product's
// non-unit coefficient multiplied into one slot (in place where the table
// serves that product only, else as an appended copy), a constant-one slot
// where a product needs ragged padding, all stacked slot-major and split
// into halves. Built by ops/cuda_build.py, loaded by ops/init_cuda.py, which
// holds the plain PyTorch version (the former torch-op body) this kernel is
// checked against.
//
// Layout: the sources are (8, n) tables and the output halves (U, 8, n/2),
// each value 8 x 32-bit limbs (least significant first), limb j of lane k
// at [j * width + k]: 32 B an element, half the bytes of the JAX package's
// 16 digits in 32-bit words.
//
// Slot u of the output takes one of three forms (the plan, by value):
//   copy:  lo[u] = src[:, :n/2],      hi[u] = src[:, n/2:];
//   scale: the same, each lane times the coefficient c_u (mont_mul, fully
//          reduced into [0, p));
//   fill:  every lane = c_u (the Montgomery one for the ones slot).
// The sources are only read: a cached table is never written, so the next
// prove starts from the same input. The output is any contiguous (U, 8,
// n/2) block, such as one instance's slice of a batched (B, U, 8, n/2) pair.
//
// What bounds it: bytes. Each lane reads its 8 limbs of every source slot
// once and writes its 8 limbs of every output slot once (12 x 32 B a lane at
// 2 x 3: 403 MB at nv = 20, 0.120 ms at 3.35 TB/s); the two scaled slots add
// 2 Montgomery multiplies a lane, 0.033 ms at the IMAD rate, hidden under
// the bytes. So the design moves bytes the widest way the card has: a
// thread takes kVec = 4 consecutive lanes, and each limb row of them is one
// 16-byte load and one 16-byte store (a copy slot is 16 such pairs a thread;
// a scaled slot multiplies its 4 lanes between them; a fill slot only
// stores). The plan (pointers and coefficient limbs) rides in the kernel's
// parameters, so a launch uploads nothing and waits for nothing. Where the
// half width is not a multiple of 4 (1 or 2 lanes: nv <= 2) or a pointer is
// not 16-byte aligned, the launch takes kVec = 1, one lane a thread with
// 4-byte accesses (chip_smoke.py times it on an unaligned pair as the wide
// body's yardstick).
//
// Grid: x over the n/2 lanes of a half, 128 x kVec per block; y over the
// slots. Past kMaxSlots the wide route (pair_init_wide_kernel) reads slot
// u's source, mode and value from entry u of a table in device memory,
// which its launch fills by one asynchronous copy ahead of the kernel, so
// any slot count up to grid y's 65,535 takes one launch; the same bodies
// move the lanes.

#include <vector>

#include "field.cuh"

namespace {

using namespace sc;

constexpr int kThreads = 128;
constexpr int kMaxSlots = 16;

enum SlotMode : int { kCopy = 0, kScale = 1, kFill = 2 };

struct InitPlan {
  const uint32_t* src[kMaxSlots];  // (8, n) source table of each slot
  uint32_t c[kMaxSlots][kLimbs];   // the coefficient (scale) or value (fill)
  int mode[kMaxSlots];
};

// kVec consecutive lanes of one limb row: one 16-byte access for kVec = 4
template <int kVec>
struct Row {
  uint32_t w[kVec];
};

template <int kVec>
__device__ __forceinline__ Row<kVec> load_row(const uint32_t* p) {
  Row<kVec> r;
  if constexpr (kVec == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
    r.w[2] = v.z;
    r.w[3] = v.w;
  } else {
    r.w[0] = __ldg(p);
  }
  return r;
}

template <int kVec>
__device__ __forceinline__ void store_row(uint32_t* p, const Row<kVec>& r) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
    *p = r.w[0];
  }
}

// One half of slot u's kVec lanes: dst[j * half + i] from src[j * n + i].
template <int kVec>
__device__ __forceinline__ void init_half(uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src, long long half,
                                          long long n, int mode, const uint32_t c[kLimbs],
                                          const Field& f) {
  if (mode == kCopy) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) store_row<kVec>(dst + j * half, load_row<kVec>(src + j * n));
    return;
  }
  Row<kVec> rows[kLimbs];
  if (mode == kFill) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
#pragma unroll
      for (int i = 0; i < kVec; ++i) rows[j].w[i] = c[j];
  } else {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) rows[j] = load_row<kVec>(src + j * n);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      uint32_t x[kLimbs];
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) x[j] = rows[j].w[i];
      mont_mul(x, x, c, f);
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) rows[j].w[i] = x[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) store_row<kVec>(dst + j * half, rows[j]);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    pair_init_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, long long half,
                     const __grid_constant__ InitPlan plan, const __grid_constant__ Field f) {
  const int u = blockIdx.y;
  const long long k = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (k >= half) return;  // kVec divides half
  const long long at = (long long)u * kLimbs * half + k;
  const int mode = plan.mode[u];
  const uint32_t* src = plan.src[u] + k;  // unused for a fill
  uint32_t c[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) c[j] = plan.c[u][j];
  init_half<kVec>(lo + at, src, half, 2 * half, mode, c, f);
  init_half<kVec>(hi + at, src + half, half, 2 * half, mode, c, f);
}

// The wide route, past kMaxSlots: slot u's plan is entry u of a table in
// device memory, which the launch fills with one asynchronous copy from the
// host (sc_pair_init_launch_wide) ahead of the kernel on its stream.
struct WideSlot {
  const uint32_t* src;
  uint32_t c[kLimbs];
  int mode;
  int pad;
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    pair_init_wide_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, long long half,
                          const WideSlot* __restrict__ plan, const __grid_constant__ Field f) {
  const int u = blockIdx.y;
  const long long k = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (k >= half) return;  // kVec divides half
  const long long at = (long long)u * kLimbs * half + k;
  const int mode = __ldg(&plan[u].mode);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      __ldg(reinterpret_cast<const unsigned long long*>(&plan[u].src))) + k;
  uint32_t c[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) c[j] = __ldg(&plan[u].c[j]);
  init_half<kVec>(lo + at, src, half, 2 * half, mode, c, f);
  init_half<kVec>(hi + at, src + half, half, 2 * half, mode, c, f);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

int sc_pair_init_threads() { return kThreads; }
int sc_pair_init_max_slots() { return kMaxSlots; }

// Resident blocks a multiprocessor holds of the kernel with kVec = vec ? 4
// : 1 (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
int sc_pair_init_blocks_per_sm(int vec) {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, vec ? pair_init_kernel<4> : pair_init_kernel<1>, kThreads, 0);
  return e == cudaSuccess ? blocks : -1;
}

// lo, hi: the (slots, 8, half) output halves. src: slots pointers to (8,
// 2 half) tables (null for a fill). c: slots x 8 limbs. mode: slots modes
// (0 copy, 1 scale, 2 fill). field: p as 8 x 32-bit limbs, then -p^-1 mod
// 2^32. Takes 4 lanes a thread with 16-byte accesses where half is a
// multiple of 4 and every pointer 16-byte aligned, else one lane a thread
// with 4-byte accesses. Returns the cudaError_t of the launch (0 on
// success).
int sc_pair_init_launch(void* lo, void* hi, long long half, int slots,
                        const void* const* src, const uint32_t* c, const int* mode,
                        const uint32_t* field, void* stream) {
  if (slots < 1 || slots > kMaxSlots || half < 1) return (int)cudaErrorInvalidValue;
  InitPlan plan = {};
  bool wide = half % 4 == 0 && aligned16(lo) && aligned16(hi);
  for (int u = 0; u < slots; ++u) {
    if (mode[u] < kCopy || mode[u] > kFill) return (int)cudaErrorInvalidValue;
    if (mode[u] != kFill && src[u] == nullptr) return (int)cudaErrorInvalidValue;
    if (mode[u] != kFill) wide = wide && aligned16(src[u]);
    plan.src[u] = static_cast<const uint32_t*>(src[u]);
    plan.mode[u] = mode[u];
    for (int j = 0; j < kLimbs; ++j) plan.c[u][j] = c[u * kLimbs + j];
  }
  Field f;
  for (int j = 0; j < kLimbs; ++j) f.p[j] = field[j];
  f.ninv = field[kLimbs];
  const long long per_block = kThreads * (wide ? 4 : 1);
  const dim3 grid((unsigned)((half + per_block - 1) / per_block), (unsigned)slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* l = static_cast<uint32_t*>(lo);
  uint32_t* h = static_cast<uint32_t*>(hi);
  if (wide) {
    pair_init_kernel<4><<<grid, kThreads, 0, s>>>(l, h, half, plan, f);
  } else {
    pair_init_kernel<1><<<grid, kThreads, 0, s>>>(l, h, half, plan, f);
  }
  return (int)cudaGetLastError();
}

// Bytes of one slot's entry in the wide route's device table.
int sc_pair_init_wide_slot_bytes() { return (int)sizeof(WideSlot); }

// The wide route: as sc_pair_init_launch for any slot count (grid y, at
// most 65,535), with the plan staged into `table` (slots x
// sc_pair_init_wide_slot_bytes() bytes of device memory, 8-byte aligned) by
// one cudaMemcpyAsync on the stream, which copies the host array before it
// returns and waits for nothing.
int sc_pair_init_launch_wide(void* lo, void* hi, long long half, int slots,
                             const void* const* src, const uint32_t* c, const int* mode,
                             const uint32_t* field, void* table, void* stream) {
  if (slots < 1 || slots > 65535 || half < 1 || table == nullptr)
    return (int)cudaErrorInvalidValue;
  std::vector<WideSlot> plan(slots);
  bool wide = half % 4 == 0 && aligned16(lo) && aligned16(hi);
  for (int u = 0; u < slots; ++u) {
    if (mode[u] < kCopy || mode[u] > kFill) return (int)cudaErrorInvalidValue;
    if (mode[u] != kFill && src[u] == nullptr) return (int)cudaErrorInvalidValue;
    if (mode[u] != kFill) wide = wide && aligned16(src[u]);
    plan[u].src = static_cast<const uint32_t*>(src[u]);
    plan[u].mode = mode[u];
    plan[u].pad = 0;
    for (int j = 0; j < kLimbs; ++j) plan[u].c[j] = c[u * kLimbs + j];
  }
  Field f;
  for (int j = 0; j < kLimbs; ++j) f.p[j] = field[j];
  f.ninv = field[kLimbs];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(table, plan.data(), plan.size() * sizeof(WideSlot),
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = kThreads * (wide ? 4 : 1);
  const dim3 grid((unsigned)((half + per_block - 1) / per_block), (unsigned)slots);
  uint32_t* l = static_cast<uint32_t*>(lo);
  uint32_t* h = static_cast<uint32_t*>(hi);
  const WideSlot* t = static_cast<const WideSlot*>(table);
  if (wide) {
    pair_init_wide_kernel<4><<<grid, kThreads, 0, s>>>(l, h, half, t, f);
  } else {
    pair_init_wide_kernel<1><<<grid, kThreads, 0, s>>>(l, h, half, t, f);
  }
  return (int)cudaGetLastError();
}

const char* sc_pair_init_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
