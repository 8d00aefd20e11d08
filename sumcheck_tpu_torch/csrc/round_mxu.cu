// The generic chain's fold round with the fold multiply on the tensor cores
// (sm_90a): the port of `_kernel_chain_fold_mxu`
// (sumcheck_tpu/ops/round_pallas.py:215-243), which runs the multiply by the
// round's challenge as three banded 8-bit-digit matrix products on the
// TPU's matrix unit (`mont_mul_band`, sumcheck_tpu/ops/mxu_mul.py:111-149).
// Built by ops/cuda_build.py into a shared library with a plain C interface,
// loaded with ctypes by ops/round_cuda.py (`round_fold_mxu`), whose plain
// version `round_fold_mxu_ref` runs ops/mxu_mul.py.
//
// What it computes is `round_kernel<true, false, false>` of round.cu: fold
// the first `extent` lanes of every slot in place by the challenge r,
//   lo[k] <- x + r (y - x) for (x, y) = (lo[k], hi[k]),
//   hi[k] <- the same for (lo[k + extent], hi[k + extent]),
// then the evaluation ladder and the per-block per-digit sums (the tail of
// round_common.cuh, shared with round.cu). Only the fold multiply differs:
// with a = y - x, a * r * 2^-256 mod p runs as
//   T  = band(r) . a8            (64 x 32) . (32 x lanes), T[m] = sum_j r8[m-j] a8[j]
//   m  = band(mu) . (T mod 2^256) mod 2^256, mu = -p^-1 mod 2^256
//   y  = band(p) . m + T         == 0 mod 2^256, result y >> 256 < 2p
// then cond_sub_p. Every product is exact: operands are bytes, every dot
// product sums at most 32 terms < 2^16, so each cell is < 2^21, and with the
// added accumulator < 2^22; 32-bit integers hold them all. The result is
// bit-identical to the CIOS multiply (both are fully reduced into [0, p)).
//
// Tensor cores: each product is integer
// `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32` (the card's counterpart
// of the MXU's bf16 dots). K = 32 is one lane's 32 8-bit digits, exactly one
// mma step; N = 8 lanes per tile, four tiles per warp; M = the band rows,
// 63 padded to 64 (four m-tiles) for the r and p bands, 32 (two) for mu.
// A lane's 32 digits are the little-endian bytes of its eight 32-bit limbs,
// so each B register is one limb word. The bands are built once per block
// in shared memory from the challenge's 16 digits and the field's p and mu
// (launch parameters), so the chain needs no extra launch or host sync.
//
// Layout of the warp's exchange (every fragment layout as the PTX ISA gives
// it for .m16n8k32 with 8-bit operands; groupID g = lane / 4, t = lane % 4):
//   A (16 x 32, row): a0 = row g, cols 4t..4t+3; a1 = row g+8, same cols;
//     a2 = row g, cols 16+4t..; a3 = row g+8, cols 16+4t..  -> band words
//     band[row][t] and band[row][t+4];
//   B (32 x 8, col): b0 = rows 4t..4t+3 of column g; b1 = rows 16+4t..
//     -> limb t and limb t+4 of lane 8*tile + g;
//   C, D (16 x 8): c0, c1 = row g, cols 2t, 2t+1; c2, c3 = row g+8, same.
// The carry chains run one lane per thread, so each warp stages its
// operands (32 lanes x 8 limb words) and its products (32 lanes x 64 digit
// rows, padded to 65 words: a lane reads its own row conflict-free) in
// dynamic shared memory after the ladder. Lanes >= extent feed zeros into
// the products and discard the results: mma.sync needs the whole warp.
//
// What bounds it on the H100: the same bytes as round_kernel<true,...>, but
// each fold multiply becomes 40 mma per 32 lanes plus about 130 byte-wide
// carry steps and 5 KB of shared-memory traffic per lane; the shared-memory
// staging and the per-lane carry chains, not the tensor cores, are the
// expected bound. This is the simple version: no wgmma, TMA or pipelining.

#include "round_common.cuh"

namespace {

using namespace sc;

constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 2 * kDigits;  // 32 8-bit digits per element
constexpr int kBandRows = 64;        // 63 wide digits, padded to 4 m-tiles
constexpr int kOpStride = kLimbs + 1;  // words per lane of the operand tile
constexpr int kStage = kBandRows + 1;  // words per lane of the product tile
// dynamic shared memory of one warp's exchange, in words
constexpr int kWarpExchange = 32 * kOpStride + 32 * kStage;

struct Mu {
  uint32_t w[kLimbs];  // -p^-1 mod 2^256, 8 x 32-bit limbs
};

// D = A B + C on the tensor cores, 16 x 8 x 32, u8 x u8 -> s32.
__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1,
                                       const uint32_t c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// band[m][w] holds bytes 4w..4w+3 of row m of the banded matrix
// B[m][j] = c8[m - j] (0 outside 0 <= m - j < 32), c8 the bytes of c.
__device__ void build_band(uint32_t (*band)[kLimbs], int rows,
                           const uint32_t c[kLimbs]) {
  for (int q = threadIdx.x; q < rows * kLimbs; q += blockDim.x) {
    const int m = q / kLimbs;
    const int w = q % kLimbs;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = m - (4 * w + b);
      if (i >= 0 && i < kBytes) word |= ((c[i >> 2] >> (8 * (i & 3))) & 0xFFu) << (8 * b);
    }
    band[m][w] = word;
  }
}

// One warp's banded product over its 32 lanes: st[lane][row] = (band . op)
// [row][lane] (+ st[lane][row] when kAccum), rows 0 .. 16 * kMTiles - 1.
// Each thread reads and writes only the cells of its own C fragment.
template <int kMTiles, bool kAccum>
__device__ __forceinline__ void warp_band_product(const uint32_t (*band)[kLimbs],
                                                  const uint32_t* op,
                                                  uint32_t* st, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = nt * 8 + 2 * t;  // lanes col and col + 1 of the C fragment
    const uint32_t b0 = op[(nt * 8 + g) * kOpStride + t];
    const uint32_t b1 = op[(nt * 8 + g) * kOpStride + t + 4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      const int r0 = mt * 16 + g;
      const uint32_t a[4] = {band[r0][t], band[r0 + 8][t], band[r0][t + 4],
                             band[r0 + 8][t + 4]};
      uint32_t c[4] = {0u, 0u, 0u, 0u};
      if constexpr (kAccum) {
        c[0] = st[col * kStage + r0];
        c[1] = st[(col + 1) * kStage + r0];
        c[2] = st[col * kStage + r0 + 8];
        c[3] = st[(col + 1) * kStage + r0 + 8];
      }
      uint32_t d[4];
      mma_u8(d, a, b0, b1, c);
      st[col * kStage + r0] = d[0];
      st[(col + 1) * kStage + r0] = d[1];
      st[col * kStage + r0 + 8] = d[2];
      st[(col + 1) * kStage + r0 + 8] = d[3];
    }
  }
}

// Normalize relaxed 8-bit rows row[0..31] (< 2^22 each) into 32 strict
// bytes, packed as 8 limbs; returns the carry out of the top byte.
__device__ __forceinline__ uint32_t chain8(uint32_t out[kLimbs], const uint32_t* row) {
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) out[j] = 0;
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    const uint32_t v = row[i] + carry;
    out[i >> 2] |= (v & 0xFFu) << (8 * (i & 3));
    carry = v >> 8;
  }
  return carry;
}

// r = a * c * 2^-256 mod p as three banded products on the tensor cores, for
// the warp's 32 lanes at once (every thread of the warp calls it; a < p).
// op, st: the warp's operand and product tiles in shared memory.
__device__ __forceinline__ void mont_mul_mxu(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                             const uint32_t (*band_c)[kLimbs],
                                             const uint32_t (*band_mu)[kLimbs],
                                             const uint32_t (*band_p)[kLimbs],
                                             uint32_t* op, uint32_t* st,
                                             const Field& f) {
  const int lane = threadIdx.x & 31;
  uint32_t* my_op = op + lane * kOpStride;
  uint32_t* my_st = st + lane * kStage;
  // T = band(c) . a8
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) my_op[j] = a[j];
  __syncwarp();
  warp_band_product<4, false>(band_c, op, st, lane);
  __syncwarp();
  // xlo = T mod 2^256, strict; c32 = the carry into digit 32
  uint32_t xlo[kLimbs];
  const uint32_t c32 = chain8(xlo, my_st);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) my_op[j] = xlo[j];
  __syncwarp();
  // m = band(mu) . xlo mod 2^256: rows 0..31 over T's consumed low half
  warp_band_product<2, false>(band_mu, op, st, lane);
  __syncwarp();
  uint32_t m[kLimbs];
  chain8(m, my_st);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) my_op[j] = m[j];
  // accumulator of the last product: xlo's strict bytes below digit 32,
  // T's own rows from digit 32 on
#pragma unroll
  for (int i = 0; i < kBytes; ++i) my_st[i] = (xlo[i >> 2] >> (8 * (i & 3))) & 0xFFu;
  __syncwarp();
  // y = band(p) . m + (xlo | T_hi); its low 256 bits are zero
  warp_band_product<4, true>(band_p, op, st, lane);
  __syncwarp();
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < kBytes; ++i) carry = (my_st[i] + carry) >> 8;
  carry += c32;
  // y >> 256: rows 32..63 plus the carries out of the low half
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = 0;
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    const uint32_t v = my_st[kBytes + i] + carry;
    r[i >> 2] |= (v & 0xFFu) << (8 * (i & 3));
    carry = v >> 8;
  }
  cond_sub_p(r, f);
}

__device__ __forceinline__ void build_bands(uint32_t (*band_c)[kLimbs],
                                            uint32_t (*band_mu)[kLimbs],
                                            uint32_t (*band_p)[kLimbs],
                                            const uint32_t c[kLimbs],
                                            const Mu& mu, const Field& f) {
  build_band(band_c, kBandRows, c);
  build_band(band_mu, kBytes, mu.w);
  build_band(band_p, kBandRows, f.p);
  __syncthreads();
}

// One fold value x + c (y - x) with the multiply on the tensor cores; an
// inactive lane folds zeros and its result is discarded by the caller.
__device__ __forceinline__ void fold_mxu(uint32_t out[kLimbs], const uint32_t* x_ptr,
                                         const uint32_t* y_ptr, long long H, bool active,
                                         const uint32_t (*band_c)[kLimbs],
                                         const uint32_t (*band_mu)[kLimbs],
                                         const uint32_t (*band_p)[kLimbs],
                                         uint32_t* op, uint32_t* st, const Field& f) {
  uint32_t x[kLimbs], y[kLimbs], d[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) x[j] = y[j] = 0;
  if (active) {
    load_lane(x, x_ptr, H);
    load_lane(y, y_ptr, H);
  }
  sub_mod(d, y, x, f);
  mont_mul_mxu(d, d, band_c, band_mu, band_p, op, st, f);
  add_mod(out, x, d, f);
}

__global__ void __launch_bounds__(kThreads)
    fold_mxu_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                    const uint32_t* __restrict__ r_digits, long long H,
                    long long extent, Field f, Mu mu, Plan pl,
                    long long* __restrict__ part) {
  extern __shared__ uint32_t smem[];  // ladder, then the warps' exchange tiles
  __shared__ uint32_t band_c[kBandRows][kLimbs];
  __shared__ uint32_t band_mu[kBytes][kLimbs];
  __shared__ uint32_t band_p[kBandRows][kLimbs];
  __shared__ uint32_t warp_sums[kWarps][kMaxDegree + 1][kDigits];

  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const bool active = k < extent;
  const long long slot_stride = (long long)kDigits * H;
  uint32_t* ladder = smem;
  uint32_t* op = smem + ladder_bytes(pl.slots) / sizeof(uint32_t) +
                 (tid >> 5) * kWarpExchange;
  uint32_t* st = op + 32 * kOpStride;

  uint32_t rr[kLimbs];
  load_lane(rr, r_digits, 1);
  build_bands(band_c, band_mu, band_p, rr, mu, f);

  for (int u = 0; u < pl.slots; ++u) {
    uint32_t* lo_u = lo + u * slot_stride + k;
    uint32_t* hi_u = hi + u * slot_stride + k;
    uint32_t e[kLimbs], o[kLimbs];
    fold_mxu(e, lo_u, hi_u, H, active, band_c, band_mu, band_p, op, st, f);
    fold_mxu(o, lo_u + extent, hi_u + extent, H, active, band_c, band_mu, band_p, op, st, f);
    if (active) {
      store_lane(lo_u, H, e);
      store_lane(hi_u, H, o);
      ladder_put(ladder, u, e, o, f, tid);
    }
  }
  ladder_block_sums<false>(ladder, warp_sums, nullptr, active, f, pl, part);
}

// Test hook: one tile, D = A B + C, A (16 x 32) u8 row-major, B given as its
// 8 columns of 32 bytes, C and D (16 x 8) s32 row-major; one warp.
__global__ void mma_tile_kernel(const uint32_t* __restrict__ A,
                                const uint32_t* __restrict__ B,
                                const uint32_t* __restrict__ C,
                                uint32_t* __restrict__ D) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                         A[(g + 8) * 8 + t + 4]};
  const uint32_t c[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                         C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  uint32_t d[4];
  mma_u8(d, a, B[g * 8 + t], B[g * 8 + t + 4], c);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

Mu read_mu(const uint32_t* field) {
  Mu mu;
  for (int j = 0; j < kLimbs; ++j) mu.w[j] = field[kLimbs + 1 + j];
  return mu;
}

size_t exchange_bytes() { return (size_t)kWarps * kWarpExchange * sizeof(uint32_t); }

}  // namespace

extern "C" {

int sc_mxu_threads() { return kThreads; }

// The fold round in place over lanes [0, extent) of the (U, 16, H) pair.
// plan: as sc_round_launch. field: p as 8 x 32-bit limbs, -p^-1 mod 2^32,
// then -p^-1 mod 2^256 as 8 limbs. Returns the cudaError_t of the launch.
int sc_fold_mxu_launch(void* lo, void* hi, const void* r, long long H,
                       long long extent, const int* plan, const uint32_t* field,
                       void* part, long long nblk, void* stream) {
  Plan pl;
  const cudaError_t bad = read_plan(plan, &pl);
  if (bad != cudaSuccess) return (int)bad;
  const size_t smem = ladder_bytes(pl.slots) + exchange_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      fold_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fold_mxu_kernel<<<(unsigned)nblk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi),
      static_cast<const uint32_t*>(r), H, extent, read_field(field), read_mu(field), pl,
      static_cast<long long*>(part));
  return (int)cudaGetLastError();
}

int sc_mma_tile_launch(const void* A, const void* B, const void* C, void* D, void* stream) {
  mma_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(B),
      static_cast<const uint32_t*>(C), static_cast<uint32_t*>(D));
  return (int)cudaGetLastError();
}

const char* sc_mxu_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
