// The generic chain's fold round with the fold multiply on the tensor cores
// (sm_90a): the port of `_kernel_chain_fold_mxu`
// (sumcheck_tpu/ops/round_pallas.py:215-243), which runs the multiply by the
// round's challenge as 8-bit-digit matrix products on the TPU's matrix unit
// (`mont_mul_band`, sumcheck_tpu/ops/mxu_mul.py:111-149). Built by
// ops/cuda_build.py into a shared library with a plain C interface, loaded
// with ctypes by ops/round_cuda.py (`round_fold_mxu`), whose plain version
// `round_fold_mxu_ref` runs ops/mxu_mul.py.
//
// What it computes is `round_kernel<true, false, false>` of round.cu: fold
// the first `extent` lanes of every slot in place by the challenge r,
//   lo[k] <- x + r (y - x) for (x, y) = (lo[k], hi[k]),
//   hi[k] <- the same for (lo[k + extent], hi[k + extent]),
// then the evaluation ladder and the per-digit sums added into the round's
// row (the tail of round_common.cuh, shared with round.cu). Only the fold
// multiply differs. r is the same for every lane of the round, so the
// multiply by it is a linear map of a = y - x's 32 bytes a8[j]: with
//   M_j = r 2^(8 j + 16) 2^-256 mod p,  j = 0..31 (a Montgomery multiply
//         each, by 32 threads of every block, from r on the device),
//   V   = sum_j a8[j] M_j               == a r 2^16 2^-256 (mod p),
//         an integer below 32 * 255 * p < 2^13 p;
//   m   = (V mod 2^16) (-p^-1) mod 2^16,
//   W   = (V + m p) / 2^16              < 2p,
// and cond_sub_p, so W = a r 2^-256 mod p, bit-identical to mont_mul (both
// are fully reduced into [0, p)). Every matrix product is exact: column n of
// V, sum_j a8[j] M8_j[n] (M8_j[n] byte n of M_j), adds 32 products of bytes,
// so it is below 2^21 and an s32 accumulator holds it.
//
// Tensor cores: integer `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32`,
// lanes in M, the 32 x 32 byte matrix as B in four n-tiles of eight
// columns. A (16 x 32) is 16 lanes' 32 operand bytes. Fragment layouts as
// the PTX ISA gives them (groupID g = lane / 4, t = lane % 4):
//   A: a0 = row g, k 4t..4t+3; a1 = row g+8, same k; a2 = row g, k
//      16+4t..; a3 = row g+8, k 16+4t..
//   B: b0 = k 4t..4t+3 of column g; b1 = k 16+4t.. of column g;
//   C, D: c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row g+8, same.
// The order of k and of the columns is free as long as the matrix follows
// it, so both give each quad (the four threads of one g) its two lanes'
// digits by 64-bit words: operand digit j(k) = 8t + b for k = 4t + b and
// 8t + 4 + b for k = 16 + 4t + b, so a0..a3 are limbs 2t and 2t+1 of the two
// lanes; output column c of n-tile nt is digit 8 (c / 2) + 2 nt + c % 2, so
// thread t holds digits 8t..8t+7 of V for both lanes: its 64-bit word t.
// Carries cross only the quad:
//   - a thread sums its eight columns into one 64-bit word plus a top below
//     2^14 (column_word);
//   - thread 0's word gives V mod 2^16, so m, which the quad shares by a
//     shuffle; each thread adds m times its 64-bit word of p;
//   - the tops move one thread up, and the carries between the words follow
//     from which words overflowed and which are all ones, two ballots
//     (quad_normalize); thread 3 keeps the carry out, below 2^16;
//   - the division by 2^16 takes 16 bits from the thread above (a shuffle).
// The matrix's B fragments, 8 registers per thread, are built once per block
// from the bytes of the M_j in shared memory (r comes from the device, so
// the chain needs no host sync). A warp's 32 lanes are two tiles of 16;
// operands and results cross between a lane per
// thread (sub_mod, cond_sub_p, add_mod, the ladder) and the quad layout
// through a 32 x 9 word exchange tile per warp in shared memory. Lanes >=
// extent feed zeros and discard the results: mma.sync needs the whole warp.
//
// What bounds it on the H100: the same bytes as round.cu's fold (32 B an
// element, 1,152 B a lane at 6 slots: 0.090 ms at 2^18 lanes), and per
// lane the ladder tail's 16 multiplies; each fold multiply becomes 4 mma per 16
// lanes, two column sums, two quad normalizations and two exchanges, fewer
// issue slots than one even/odd multiply and none on its IMAD pipe. While a
// fold multiplies, the next fold's operands load.

#include "round_common.cuh"

namespace {

using namespace sc;

constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 2 * kDigits;    // 32 8-bit digits per element
constexpr int kXStride = kLimbs + 1;   // words per lane of the exchange tile
constexpr unsigned kFull = 0xffffffffu;

struct Pow2 {
  uint32_t w[kBytes][kLimbs];  // 2^(8 j + 16) mod p, j = 0..31, 8 limbs each
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

// This thread's B fragments of the matrix, n-tile nt: column g is output
// digit n = 8 (g / 2) + 2 nt + g % 2; b[nt][h] holds bytes n of M_j for
// j = 8t + 4h .. 8t + 4h + 3 (the k order, header). mat[j][n] = byte n of M_j.
__device__ __forceinline__ void load_matrix(uint32_t b[4][2], const uint8_t (*mat)[kBytes]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = 8 * (g >> 1) + 2 * nt + (g & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) w |= (uint32_t)mat[8 * t + 4 * h + i][n] << (8 * i);
      b[nt][h] = w;
    }
  }
}

// Row `row` (0: g, 1: g+8) of the quad's product, this thread's part: the
// sum of its eight columns as word + top * 2^64 (top < 2^14).
__device__ __forceinline__ void column_word(uint64_t& word, uint32_t& top,
                                            const uint32_t (*acc)[4], int row) {
  uint64_t w0 = 0, w1 = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // columns 2q, 2q + 1 of the thread's eight
    const uint32_t c0 = acc[q][2 * row];
    const uint32_t c1 = acc[q][2 * row + 1];
    if (q < 2) {
      w0 += ((uint64_t)c0 << (16 * q)) + ((uint64_t)c1 << (16 * q + 8));
    } else {
      w1 += ((uint64_t)c0 << (16 * q - 32)) + ((uint64_t)c1 << (16 * q - 24));
    }
  }
  w1 += w0 >> 32;  // value = w0 + w1 2^32
  word = (w1 << 32) | (uint32_t)w0;
  top = (uint32_t)(w1 >> 32);
}

// The quad's four parts of a value (thread t: word + top 2^64 at 2^(64 t),
// tops below 2^31) -> this thread's strict 64-bit word, in place. The tops
// move one thread up; then a word that overflowed generates a carry and an
// all-ones word propagates one, so the carry into each word is the carry
// into its bit of the 4-bit sum (g | p) + g, from two ballots. Returns the
// value >> 256 in thread 3 (elsewhere a partial sum).
__device__ __forceinline__ uint32_t quad_normalize(uint64_t& word, uint32_t top) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  uint32_t in = __shfl_up_sync(kFull, top, 1, 4);
  if (t == 0) in = 0;
  word += in;
  const uint32_t gen = __ballot_sync(kFull, word < in);
  const uint32_t prop = __ballot_sync(kFull, word == ~0ull);
  const uint32_t g4 = (gen >> (lane & ~3)) & 0xFu;
  const uint32_t a4 = g4 | ((prop >> (lane & ~3)) & 0xFu);
  const uint32_t sum = a4 + g4;
  word += ((sum ^ a4 ^ g4) >> t) & 1u;
  return top + (sum >> 4);
}

// (word, top) += m * (p_hi 2^32 + p_lo), one carry chain of multiply-adds.
__device__ __forceinline__ void add_mul_word(uint64_t& word, uint32_t& top, uint32_t m,
                                             uint32_t p_lo, uint32_t p_hi) {
  uint32_t lo = (uint32_t)word, hi = (uint32_t)(word >> 32);
  asm("mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32       %2, %2, 0;\n\t"
      "mad.lo.cc.u32  %1, %3, %5, %1;\n\t"
      "madc.hi.u32    %2, %3, %5, %2;"
      : "+r"(lo), "+r"(hi), "+r"(top)
      : "r"(m), "r"(p_lo), "r"(p_hi));
  word = ((uint64_t)hi << 32) | lo;
}

// One tile of 16 lanes: res[row][q] = limb 2t + q of a * r * 2^-256 (< 2p)
// for the quad's lanes (row 0: g, 1: g + 8), from a's limbs x[row][q];
// p64: this thread's 64-bit word of p.
__device__ __forceinline__ void mxu_tile(uint32_t res[2][2], const uint32_t x[2][2],
                                         const uint32_t (*b)[2], const uint32_t p64[2],
                                         uint32_t ninv) {
  const int t = threadIdx.x & 3;
  const uint32_t zero[4] = {0u, 0u, 0u, 0u};
  const uint32_t a[4] = {x[0][0], x[1][0], x[0][1], x[1][1]};
  uint32_t acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mma_u8(acc[nt], a, b[nt][0], b[nt][1], zero);
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    uint64_t word;
    uint32_t top;
    column_word(word, top, acc, row);
    // m = (V mod 2^16) (-p^-1) mod 2^16, V mod 2^16 from thread 0's word
    const uint32_t m = __shfl_sync(kFull, ((uint32_t)word * ninv) & 0xFFFFu, 0, 4);
    add_mul_word(word, top, m, p64[0], p64[1]);  // below 2^80 more
    const uint32_t over = quad_normalize(word, top);
    // W = (V + m p) / 2^16: the low 16 bits of the word above (thread 3:
    // of the carry out)
    uint32_t above = __shfl_down_sync(kFull, (uint32_t)word, 1, 4);
    if (t == 3) above = over;
    const uint64_t w = (word >> 16) | ((uint64_t)(above & 0xFFFFu) << 48);
    res[row][0] = (uint32_t)w;
    res[row][1] = (uint32_t)(w >> 32);
  }
}

// r = a * c * 2^-256 mod p on the tensor cores for the warp's 32 lanes
// (every thread of the warp calls it; a < p); b: the matrix of c's
// fragments; p64: this thread's word of p (mxu_tile); xch: the warp's
// exchange tile.
__device__ __forceinline__ void mont_mul_mxu(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                             const uint32_t (*b)[2], const uint32_t p64[2],
                                             uint32_t (*xch)[kXStride], const Field& f) {
  const int ln = threadIdx.x & 31;
  const int g = ln >> 2;
  const int t = ln & 3;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) xch[ln][j] = a[j];
  __syncwarp();
  // two tiles: each reads and writes only its own 16 rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t x[2][2], res[2][2];  // [row][q]
#pragma unroll
    for (int row = 0; row < 2; ++row)
#pragma unroll
      for (int q = 0; q < 2; ++q) x[row][q] = xch[16 * h + 8 * row + g][2 * t + q];
    mxu_tile(res, x, b, p64, f.ninv);
#pragma unroll
    for (int row = 0; row < 2; ++row)
#pragma unroll
      for (int q = 0; q < 2; ++q) xch[16 * h + 8 * row + g][2 * t + q] = res[row][q];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = xch[ln][j];
  __syncwarp();
  cond_sub_p(r, f);
}

__global__ void __launch_bounds__(kThreads, 4)
    fold_mxu_kernel(uint32_t* __restrict__ lo, uint32_t* __restrict__ hi,
                    const uint32_t* __restrict__ r_digits, long long H,
                    long long extent, Field f, Pow2 pw, Plan pl,
                    long long* __restrict__ sums) {
  extern __shared__ uint32_t ladder[];  // [slot][cur|step][limb][thread]
  __shared__ uint32_t xch[kWarps][32][kXStride];
  __shared__ uint8_t mat[kBytes][kBytes];  // mat[j][n] = byte n of M_j
  __shared__ uint32_t warp_sums[kWarps][kMaxDegree + 1][kDigits];

  const int tid = threadIdx.x;
  const long long k = (long long)blockIdx.x * kThreads + tid;
  const bool active = k < extent;
  const long long slot_stride = (long long)kLimbs * H;

  // fold value i = 2u + half of slot u; the next one's operands load while
  // this one multiplies (zeros for an inactive lane), the first while the
  // block builds its matrix
  uint32_t nx[kLimbs], ny[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) nx[j] = ny[j] = 0;
  if (active) {
    load_lane(nx, lo + k, H);
    load_lane(ny, hi + k, H);
  }
  if (tid < kBytes) {  // M_j = r 2^(8 j + 16) 2^-256 mod p
    uint32_t rr[kLimbs], m[kLimbs];
    load_digits(rr, r_digits);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) m[j] = pw.w[tid][j];
    mont_mul(m, rr, m, f);
#pragma unroll
    for (int n = 0; n < kBytes; ++n) mat[tid][n] = (uint8_t)(m[n >> 2] >> (8 * (n & 3)));
  }
  __syncthreads();
  uint32_t b[4][2];
  load_matrix(b, mat);
  const uint32_t p64[2] = {f.p[2 * (tid & 3)], f.p[2 * (tid & 3) + 1]};

  for (int u = 0; u < pl.slots; ++u) {
    uint32_t folded[2][kLimbs];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t x[kLimbs], d[kLimbs];
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) {
        x[j] = nx[j];
        d[j] = ny[j];
      }
      const int un = half ? u + 1 : u;
      if (active && un < pl.slots) {
        const long long at = un * slot_stride + k + (half ? 0 : extent);
        load_lane(nx, lo + at, H);
        load_lane(ny, hi + at, H);
      }
      sub_mod(d, d, x, f);
      mont_mul_mxu(d, d, b, p64, xch[tid >> 5], f);
      add_mod(folded[half], x, d, f);
    }
    if (active) {
      store_lane(lo + u * slot_stride + k, H, folded[0]);
      store_lane(hi + u * slot_stride + k, H, folded[1]);
      ladder_put(ladder, u, folded[0], folded[1], f, tid);
    }
  }
  ladder_block_sums<false>(ladder, warp_sums, nullptr, active, f, pl, sums);
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

Pow2 read_pow2(const uint32_t* field) {
  Pow2 pw;
  for (int j = 0; j < kBytes; ++j)
    for (int l = 0; l < kLimbs; ++l) pw.w[j][l] = field[kLimbs + 1 + j * kLimbs + l];
  return pw;
}

}  // namespace

extern "C" {

int sc_mxu_threads() { return kThreads; }

// The fold round in place over lanes [0, extent) of the (U, 8, H) pair.
// plan: as sc_round_launch_batched. field: p as 8 x 32-bit limbs, -p^-1 mod 2^32,
// then 2^(8 j + 16) mod p for j = 0..31, 8 limbs each. sums: the round's
// (degree+1, 16) int64 row, which the launch adds into. Returns the
// cudaError_t of the launch.
int sc_fold_mxu_launch(void* lo, void* hi, const void* r, long long H,
                       long long extent, const int* plan, const uint32_t* field,
                       void* sums, long long nblk, void* stream) {
  Plan pl;
  const cudaError_t bad = read_plan(plan, &pl);
  if (bad != cudaSuccess) return (int)bad;
  const size_t smem = ladder_bytes(pl.slots);
  cudaError_t e = cudaFuncSetAttribute(
      fold_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fold_mxu_kernel<<<(unsigned)nblk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi),
      static_cast<const uint32_t*>(r), H, extent, read_field(field), read_pow2(field), pl,
      static_cast<long long*>(sums));
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
