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
// Slot u of the output takes one of three forms (the plan, by value):
//   copy:  lo[u] = src[:, :n/2],      hi[u] = src[:, n/2:];
//   scale: the same, each lane times the coefficient c_u (mont_mul, fully
//          reduced into [0, p));
//   fill:  every lane = c_u (the Montgomery one for the ones slot).
// The sources are only read: a cached table is never written, so the next
// prove starts from the same input. The output is any contiguous (U, 16,
// n/2) block, such as one instance's slice of a batched (B, U, 16, n/2) pair.
//
// What bounds it: bytes. Each lane reads its 16 digits of every source slot
// once and writes its 16 digits of every output slot once (12 x 64 B a lane
// at 2 x 3: 805 MB at nv = 20, 0.24 ms at 3.35 TB/s); the two scaled slots
// add 2 Montgomery multiplies a lane, under 0.04 ms at the IMAD rate. So one
// thread per lane and slot, coalesced digit loads and stores, and the plan
// (pointers and coefficient limbs) in the kernel's parameters, so a launch
// uploads nothing and waits for nothing.
//
// Grid: x over the n/2 lanes of a half, 128 per block; y over the slots.

#include "field.cuh"

namespace {

using namespace sc;

constexpr int kThreads = 128;
constexpr int kMaxSlots = 16;

enum SlotMode : int { kCopy = 0, kScale = 1, kFill = 2 };

struct InitPlan {
  const uint32_t* src[kMaxSlots];  // (16, n) source table of each slot
  uint32_t c[kMaxSlots][kLimbs];   // the coefficient (scale) or value (fill)
  int mode[kMaxSlots];
};

__global__ void __launch_bounds__(kThreads)
    pair_init_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi, long long half,
                     const __grid_constant__ InitPlan plan, const __grid_constant__ Field f) {
  const int u = blockIdx.y;
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= half) return;
  uint32_t* lo_u = lo + (long long)u * kDigits * half + k;
  uint32_t* hi_u = hi + (long long)u * kDigits * half + k;
  const int mode = plan.mode[u];
  if (mode == kFill) {
    store_lane(lo_u, half, plan.c[u]);
    store_lane(hi_u, half, plan.c[u]);
    return;
  }
  const uint32_t* src = plan.src[u] + k;
  const long long n = 2 * half;
  if (mode == kCopy) {
#pragma unroll
    for (int i = 0; i < kDigits; ++i) {
      lo_u[i * half] = src[i * n];
      hi_u[i * half] = src[i * n + half];
    }
    return;
  }
  uint32_t c[kLimbs], x[kLimbs], y[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) c[j] = plan.c[u][j];
  load_lane(x, src, n);
  load_lane(y, src + half, n);
  mont_mul(x, x, c, f);
  mont_mul(y, y, c, f);
  store_lane(lo_u, half, x);
  store_lane(hi_u, half, y);
}

}  // namespace

extern "C" {

int sc_pair_init_threads() { return kThreads; }
int sc_pair_init_max_slots() { return kMaxSlots; }

// lo, hi: the (slots, 16, half) output halves. src: slots pointers to (16,
// 2 half) tables (null for a fill). c: slots x 8 limbs. mode: slots modes
// (0 copy, 1 scale, 2 fill). field: p as 8 x 32-bit limbs, then -p^-1 mod
// 2^32. Returns the cudaError_t of the launch (0 on success).
int sc_pair_init_launch(void* lo, void* hi, long long half, int slots,
                        const void* const* src, const uint32_t* c, const int* mode,
                        const uint32_t* field, void* stream) {
  if (slots < 1 || slots > kMaxSlots || half < 1) return (int)cudaErrorInvalidValue;
  InitPlan plan = {};
  for (int u = 0; u < slots; ++u) {
    if (mode[u] < kCopy || mode[u] > kFill) return (int)cudaErrorInvalidValue;
    if (mode[u] != kFill && src[u] == nullptr) return (int)cudaErrorInvalidValue;
    plan.src[u] = static_cast<const uint32_t*>(src[u]);
    plan.mode[u] = mode[u];
    for (int j = 0; j < kLimbs; ++j) plan.c[u][j] = c[u * kLimbs + j];
  }
  Field f;
  for (int j = 0; j < kLimbs; ++j) f.p[j] = field[j];
  f.ninv = field[kLimbs];
  const dim3 grid((unsigned)((half + kThreads - 1) / kThreads), (unsigned)slots);
  pair_init_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), half, plan, f);
  return (int)cudaGetLastError();
}

const char* sc_pair_init_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
