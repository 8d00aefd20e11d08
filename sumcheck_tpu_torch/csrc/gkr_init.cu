// The GKR phase inits for Hopper (sm_90a): three kernels that together build
// each phase's (lo, hi) table pair of the GKR round sumcheck.
//
// Replaces the JAX package's jitted jnp device programs of the phase inits
// (sumcheck_tpu/ops/gkr_init.py): `_phase1_pair_body` and
// `_phase2_pair_body` (:472-523) and the per-size pieces `_compiled_phase1`,
// `_compiled_prep1`, `_compiled_final_fold`, `_compiled_phase2_digits` and
// `_compiled_prep2` (:284-312, :595-654), their bodies `_weight_fold`
// (:98-135) and `_segment_reduce_sorted` (:237-274) fused into one kernel.
// XLA fused each into one program; a port of them as torch ops ran about
// 13,000 launches a phase, 10,674 of them the eq table's doublings. Built by
// ops/cuda_build.py, loaded by ops/gkr_init_cuda.py, which holds each
// kernel's plain PyTorch version.
//
// The function. Phase 1 sums f1's nonzeros v_j at index (g_j, x_j, y_j) into
// h_g[x] = sum_j v_j eq(g, g_j) f3[y_j]; phase 2 sums the weights w_j =
// v_j eq(g, g_j) into f1(g, u, y) = sum_j w_j eq(u, x_j) at y_j. Each is a
// weight fold, an exact segment sum, and the pair's second slot:
//
//   weight_reduce_kernel one launch a phase: eq's two half tables, eq(r, j) =
//                        eq_lo[j & m] * eq_hi[j >> kl] over the low kl =
//                        ceil(k/2) and high k - kl bits, built by each block
//                        in its shared memory from the challenge rows; the
//                        weight fold w_j = v_j * eq_lo[idx_j & m] *
//                        eq_hi[idx_j >> kl] (phase 1: w_j to the carry in y
//                        order, then times f3[y_j]), summed over each
//                        segment of the sorted entries mod p into slot 0 of
//                        the pair, or the raw limb sums (a rank's partial);
//                        and the pair's slot 1 from the same blocks: a copy
//                        of f2 (phase 1) or f3 times the final fold l + r (h
//                        - l) of a one-lane pair (f2(u), phase 2);
//   weight_reduce_batched_kernel  the same for B instances of one shape in
//                        one launch, grid y = instance, the instances'
//                        operands in the launch's parameters (the batched
//                        GKR prover: one launch a phase for the whole
//                        batch), each block's first tile loaded under its
//                        build of the half tables;
//   finish_sums_kernel   the finish of all-reduced raw sums (a sharded
//                        rank's phase init): only the rank's dealt lanes,
//                        one contiguous run of the rank-major sums that its
//                        weight reduce wrote, straight into its pair's slot
//                        0, and its slot 1 from the same threads, as the
//                        weight reduce's;
//   pair_slots_kernel    a pair's slots for the per-size pieces that no
//                        prover path takes any more (the counterparts of
//                        `_compiled_prep1`, `_compiled_final_fold` and
//                        `_compiled_prep2`): a copy, a table times a scalar
//                        on the device, or times the final fold of a
//                        one-lane pair, or that fold alone.
//
// Layout: values are 8 x 32-bit limbs (field.cuh). Tables are limb-major
// (limb j of lane k at [j * stride + k]); f1's values and the carry w are
// entry-major (nnz, 8), one 32-byte sector an entry: f1's sorted by the
// bit-reversed x segment (phase 1), the carry by the bit-reversed y segment
// (phase 2), so both phases read their entries in sequence; the index
// components are int32, and the challenges the chain's rows of 16 x 16-bit
// digits. The field product is exact and every stored value canonical, so
// any association of the products gives the JAX package's bytes.
//
// What bounds it: at the main shape (dim 18, 2^18 entries) phase 1 does 3
// Montgomery multiplies an entry and 1 a segment (0.0165 ms of 32-bit
// multiplies on an H100, against 0.011 ms of bytes), phase 2 two an entry
// and one a segment; the pair's slot 1 moves 64 B a lane. The weight
// reduce's design: one launch a phase, the weights never in device memory;
// one thread an entry for the multiplies (a thread a segment would leave a
// warp waiting on its longest segment); the products staged in shared
// memory entry-major and summed there one thread a segment in 64-bit limb
// accumulators; persistent blocks that each build the half eq tables in
// shared memory once, by doubling (one multiply a new lane pair, 2^kl +
// 2^kh - 2 a block, depth kl; up to kMaxSharedEq lanes, k <= 21, as far
// as any f1 reaches: its 3 k index bits fit int64); a host-built plan of
// tiles of consecutive segments whose entries fit kTile, so the kernel needs no
// sync and no host round trip; a segment longer than a tile cut into
// tile-sized chunks across blocks, summed with 64-bit atomics into a
// per-device scratch row that the last chunk to arrive finishes and zeroes
// (integer sums are exact in any order; below 2^56 a limb at 2^24
// entries); and slot 1's lanes moved by half of each block's warps while
// the other half build the half tables. None waits for the host. Measured
// on an H100 80GB HBM3 at 700 W (PERF.md, tools/gkr_init_variants.py):
// tiles of 512 entries beat 256; staging the half tables limb-major cost
// nothing more; phase 1's f3 gather, a random 4-byte load of a limb-major
// table, 8 sectors an entry, is what holds phase 1 most. Of the fused
// phase's 0.048 / 0.040 ms the build in every block takes 0.007-0.008 ms
// (its kl dependent levels and its multiplies, repeated in each of the 264
// blocks); it beat a cooperative build, the half tables in a launch of
// their own, the slot's items in the work list, a split of each half as a
// tensor product of two smaller tables and tiles of 1,024.

#include "field.cuh"

namespace {

using namespace sc;

constexpr int kThreads = 256;      // a block of the elementwise kernels
constexpr int kTile = 512;         // entries, and segments, of one tile of the plan: the
                                   // weight reduce's block, one thread an entry
constexpr int kMaxSharedEq = 3072;  // half-table lanes built in shared memory (96 KB)
constexpr int kMaxRows = 24;        // challenge rows a block stages (k <= 21 builds in it)
constexpr int kWarps = kTile / 32;
constexpr size_t kStageBytes = 2 * kTile * sizeof(uint4);  // a tile's products

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

// l + r (h - l) of one lane: limb j of l and h at lo[j * stride] and
// hi[j * stride], r a row of digits.
__device__ __forceinline__ void final_fold(uint32_t out[kLimbs], const uint32_t* lo,
                                           const uint32_t* hi, long long stride,
                                           const int32_t* r, const Consts& c) {
  uint32_t l[kLimbs], h[kLimbs], rr[kLimbs], d[kLimbs];
  load_lane(l, lo, stride);
  load_lane(h, hi, stride);
  load_digits(rr, reinterpret_cast<const uint32_t*>(r));
  sub_mod(d, h, l, c.f);
  mont_mul(d, d, rr, c.f);
  add_mod(out, l, d, c.f);
}

// ---------------------------------------------------------------------------
// the fused weight fold and segment sum
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

// The pair's slot 1 from the weight reduce's launch, `items` items of kTile lanes:
// lane k < half gets lo[:, k] = src[:, k] and hi[:, k] = src[:, half + k] (src a
// contiguous (8, 2 half) table, lo and hi (8, half) with limb stride half), each times
// the final fold of the one-lane pair (flo, fhi; limb stride fstride) by the row fr where
// flo is given.
struct Slot {
  const uint32_t* src;
  uint32_t* lo;
  uint32_t* hi;
  long long half;
  int items;
  const uint32_t* flo;
  const uint32_t* fhi;
  long long fstride;
  const int32_t* fr;
};

// One launch of the fused kernel. The plan (built on the host, ops/gkr_init_cuda.tile_plan)
// is a list of int4 items {s0, count, e0, e1}:
//   count > 0: a tile, segments s0 .. s0 + count - 1 (count <= kTile), whose entries are
//              exactly the sorted entries e0 .. e1 - 1 (e1 - e0 <= kTile);
//   count < 0: a chunk, entries e0 .. e1 - 1 (at most kTile) of the long segment s0 (more
//              than kTile entries), which owns row -1 - count of the scratch.
// With y (phase 1) each entry's weight w_j also goes to row to_y[j] of the carry (the
// entries in y order) before it is multiplied by f3[y_j]. The slot's items are not in the
// plan: they go beside the build (slot_item).
struct WeightReduce {
  const int4* plan;
  int items;
  const uint32_t* vals;          // (nnz, 8) entry-major, sorted by segment
  const int32_t* idx;            // (nnz,) the eq index of each entry
  const int32_t* r;              // the k challenge rows, 16 digits each, row i at
  long long r_stride;            //   r + i * r_stride, from which each block builds eq
  int kl, kh;
  const int32_t* last;           // (nseg,) each segment's last sorted position
  long long nseg;
  const int32_t* y;              // phase 1: (nnz,) f3's lane of each entry, else null
  const uint32_t* f3;            // (8, n3) limb-major
  long long n3;
  const int32_t* to_y;           // phase 1: (nnz,) each entry's row of the carry
  uint32_t* carry;               // phase 1: (nnz, 8) entry-major out
  unsigned long long* scratch;   // (long, 8) limb partials, zero between launches
  unsigned int* arrived;         // (long,) chunks arrived, zero between launches
  unsigned long long* sums_out;  // the raw (8, nseg) limb sums, or null: strict to dst
  int ranks;                     // the raw sums rank-major over this many ranks (emit)
  SegDest dst;
  Slot slot;                     // slot.items = 0: no slot
};

// The 8 limbs of row i of an entry-major (n, 8) table: two 16-byte loads.
__device__ __forceinline__ void load_row(uint32_t x[kLimbs], const uint32_t* rows, long long i) {
  const uint4* p = reinterpret_cast<const uint4*>(rows) + 2 * i;
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void store_row(uint32_t* rows, long long i, const uint32_t x[kLimbs]) {
  uint4* p = reinterpret_cast<uint4*>(rows) + 2 * i;
  p[0] = make_uint4(x[0], x[1], x[2], x[3]);
  p[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// Lane `lane` of the half tables, entry-major in shared memory: two 16-byte
// loads.
__device__ __forceinline__ void eq_lane(uint32_t x[kLimbs], const uint4* s_eq, uint32_t lane) {
  const uint4 a = s_eq[2 * lane], b = s_eq[2 * lane + 1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
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

// `finish` in place, its multiply of the word above 2^256 only where that
// word is not 0 (a sum of at most two strict values never carries out of
// 2^256), so that a warp whose segments all fit skips it.
__device__ __forceinline__ void finish_lazy(uint32_t v[kLimbs], const uint64_t acc[kLimbs],
                                            const Consts& c) {
  uint64_t carry = 0;
#pragma unroll
  for (int l = 0; l < kLimbs; ++l) {
    const uint64_t x = acc[l] + carry;
    v[l] = (uint32_t)x;
    carry = x >> 32;
  }
  for (int i = 0; i < c.reduce_subs; ++i) cond_sub_p(v, c.f);
  if (carry) {
    uint32_t hi[kLimbs] = {(uint32_t)carry, 0, 0, 0, 0, 0, 0, 0};
    mont_mul(hi, hi, c.r2, c.f);
    add_mod(v, v, hi, c.f);
  }
}

// Segment s's sums: raw to sums_out where it is given, else strict to dst.
// The raw sums are rank-major over `ranks` ranks: segment i * ranks + r, rank
// r's dealt lane i (parallel/mesh.deal), at column r * nseg / ranks + i, so
// that each rank's segments are one contiguous run of columns, the run a
// rank finishes (and a reduce-scatter would hand it); ranks = 1, column s.
__device__ __forceinline__ void emit(long long s, const uint64_t acc[kLimbs], long long nseg,
                                     int ranks, unsigned long long* sums_out,
                                     const SegDest& dst, const Consts& c) {
  if (sums_out) {
    const long long col = (s % ranks) * (nseg / ranks) + s / ranks;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) sums_out[j * nseg + col] = acc[j];
    return;
  }
  uint32_t v[kLimbs];
  finish(v, acc, c);
  uint32_t* base = s < dst.split ? dst.lo + s : dst.hi + (s - dst.split);
  store_lane(base, dst.ld, v);
}

// A barrier of the block's first `threads` threads (a multiple of 32):
// barrier 1, so that the other warps may go on with other work.
__device__ __forceinline__ void sync_first(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The k challenge rows (16 digits each, row i at r + i * r_stride) into the
// block's shared memory, one digit a thread of `threads` (thread `tid`):
// one round of global loads in place of one a doubling level. The caller
// syncs before they are read.
__device__ __forceinline__ void stage_rows(uint32_t (*rows)[kDigits], const int32_t* r,
                                           long long r_stride, int k, int tid, int threads) {
  for (int i = tid; i < k * kDigits; i += threads)
    rows[i / kDigits][i % kDigits] = (uint32_t)__ldg(r + (i / kDigits) * r_stride + i % kDigits);
}

// Both half tables of eq(r, .) in the block's shared memory, entry-major (two
// uint4 a lane), from the staged rows: the low one over rows 0 .. kl - 1 at
// lanes [0, 2^kl), the high one over rows kl .. kl + kh - 1 at [2^kl, 2^kl +
// 2^kh), lane 0 of each the Montgomery one. Level i takes each half's table over its first i variables
// (its lanes [0, 2^i)) to the table over i + 1: for x = lane j, lane j + 2^i
// = x r_i and lane j = x - x r_i, so lane j ends as prod_i (bit_i(j) ? r_i : 1
// - r_i), low bit first. One multiply a new lane pair, both halves' levels
// side by side (2^i + 2^i work items over the first `threads` threads of the
// block, thread `tid`), kl levels and a barrier of those threads after each
// (and before the first, for the rows).
__device__ __forceinline__ void build_eq_halves(uint4* s_eq, uint32_t (*rows)[kDigits], int kl,
                                                int kh, const Consts& c, int tid, int threads) {
  const int nlo = 1 << kl;
  if (tid < 2) {
    uint4* lane = s_eq + 2 * (tid ? nlo : 0);
    lane[0] = make_uint4(c.one[0], c.one[1], c.one[2], c.one[3]);
    lane[1] = make_uint4(c.one[4], c.one[5], c.one[6], c.one[7]);
  }
  sync_first(threads);
  for (int i = 0; i < kl; ++i) {  // kl >= kh
    const int n = 1 << i, work = i < kh ? 2 * n : n;
    for (int w = tid; w < work; w += threads) {
      const bool low = w < n;
      uint4* x_at = s_eq + 2 * (low ? w : nlo + w - n);
      const uint4 a = x_at[0], b = x_at[1];
      const uint32_t x[kLimbs] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t ri[kLimbs], hi[kLimbs], lo[kLimbs];
      load_digits(ri, rows[low ? i : kl + i]);
      mont_mul(hi, x, ri, c.f);
      sub_mod(lo, x, hi, c.f);
      x_at[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      x_at[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      x_at[2 * n] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      x_at[2 * n + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    sync_first(threads);
  }
}

// Slot item s, lanes s * kTile .. (s + 1) * kTile - 1 below the half, over
// `threads` threads (thread `tid`): both halves of each lane, times the
// final fold (in shared memory) where the slot has one.
__device__ __forceinline__ void slot_item(const Slot& sl, int s, const uint32_t* scale,
                                          const Consts& c, int tid, int threads) {
  const long long end = min((long long)(s + 1) * kTile, sl.half);
  for (long long k = (long long)s * kTile + tid; k < end; k += threads) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      uint32_t v[kLimbs];
      load_lane(v, sl.src + side * sl.half + k, 2 * sl.half);
      if (sl.flo) mont_mul(v, v, scale, c.f);
      store_lane((side ? sl.hi : sl.lo) + k, sl.half, v);
    }
  }
}

// Each block builds the half tables once and walks the plan's
// items blockIdx.x, + gridDim.x, ...: one thread an entry computes its
// weight v_j * eq_lo[idx_j & m] * eq_hi[idx_j >> kl] (with kGather: stores
// it to the carry and multiplies by f3[y_j]); a tile stages the products in
// shared memory, entry-major, and one thread a segment sums its entries in
// 64-bit limb accumulators and emits them; a chunk sums its products over
// the block (warp shuffles), adds them into its scratch row with 64-bit
// atomics, and the chunk that arrives last (a counter after a fence) reads
// and zeroes the row and the counter and emits the segment. Before the
// tiles, while the first half of the block's warps build the half tables,
// the other half move the block's slot items (blockIdx.x, + gridDim.x,
// ...; after the final fold they scale by, which the block's last thread
// computes once), so that the slot's memory traffic overlaps the build's
// dependent multiplies (tools/gkr_init_variants.py times the slot's items
// in the work list instead, after the plan's items, before them and
// spread between them).
template <bool kGather>
__device__ __forceinline__ void weight_reduce_body(const WeightReduce& a, const Consts& c) {
  extern __shared__ uint4 smem[];
  __shared__ uint64_t s_part[kWarps][kLimbs];
  __shared__ uint32_t s_scale[kLimbs];
  __shared__ uint32_t s_rows[kMaxRows][kDigits];
  uint4* s_stage = smem;               // [2][kTile]: an entry's limbs 0-3, then 4-7
  uint4* s_eq = smem + 2 * kTile;      // the half tables, two a lane
  const int nlo = 1 << a.kl;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (a.slot.flo && t == kTile - 1) {
    uint32_t v[kLimbs];
    final_fold(v, a.slot.flo, a.slot.fhi, a.slot.fstride, a.slot.fr, c);
    copy8(s_scale, v);
  }
  // the table threads: the whole block, or its first half beside the slot's movers
  const int table_threads = a.slot.items ? kTile / 2 : kTile;
  if (t < table_threads) {
    stage_rows(s_rows, a.r, a.r_stride, a.kl + a.kh, t, table_threads);
    build_eq_halves(s_eq, s_rows, a.kl, a.kh, c, t, table_threads);
  } else {
    if (a.slot.flo) asm volatile("bar.sync 2, %0;" ::"r"(kTile - table_threads) : "memory");
    for (int sl = blockIdx.x; sl < a.slot.items; sl += gridDim.x)
      slot_item(a.slot, sl, s_scale, c, t - table_threads, kTile - table_threads);
  }
  __syncthreads();
  const uint32_t mask = (uint32_t)nlo - 1;
  for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
    const int4 item = __ldg(a.plan + it);
    const int e = item.z + t;
    uint32_t v[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (e < item.w) {
      const uint32_t ix = (uint32_t)__ldg(a.idx + e);
      uint32_t q[kLimbs];
      load_row(v, a.vals, e);
      eq_lane(q, s_eq, ix & mask);
      mont_mul(v, v, q, c.f);
      eq_lane(q, s_eq, nlo + (ix >> a.kl));
      mont_mul(v, v, q, c.f);
      if constexpr (kGather) {
        store_row(a.carry, __ldg(a.to_y + e), v);
        const long long yl = __ldg(a.y + e);
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) q[j] = __ldg(a.f3 + j * a.n3 + yl);
        mont_mul(v, v, q, c.f);
      }
    }
    if (item.y > 0) {  // a tile: one thread a segment, out of shared memory
      s_stage[t] = make_uint4(v[0], v[1], v[2], v[3]);
      s_stage[kTile + t] = make_uint4(v[4], v[5], v[6], v[7]);
      __syncthreads();
      if (t < item.y) {
        const long long s = (long long)item.x + t;
        const int begin = (s == 0 ? 0 : __ldg(a.last + s - 1) + 1) - item.z;
        const int end = __ldg(a.last + s) + 1 - item.z;
        uint64_t acc[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int q = begin; q < end; ++q) {
          const uint4 l = s_stage[q], h = s_stage[kTile + q];
          acc[0] += l.x, acc[1] += l.y, acc[2] += l.z, acc[3] += l.w;
          acc[4] += h.x, acc[5] += h.y, acc[6] += h.z, acc[7] += h.w;
        }
        emit(s, acc, a.nseg, a.ranks, a.sums_out, a.dst, c);
      }
      __syncthreads();  // the stage is read before the next item writes it
      continue;
    }
    // a chunk of a long segment: the block's sum, then the scratch row
    uint64_t part[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      part[j] = v[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[j] += __shfl_down_sync(0xFFFFFFFFu, part[j], off);
      if (lane == 0) s_part[warp][j] = part[j];
    }
    __syncthreads();
    if (t == 0) {
      uint64_t total[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int wi = 0; wi < kWarps; ++wi)
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) total[j] += s_part[wi][j];
      const int row = -1 - item.y;
      unsigned long long* sums = a.scratch + (long long)row * kLimbs;
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) atomicAdd(sums + j, (unsigned long long)total[j]);
      __threadfence();  // the sums land before the count that announces them
      const long long s = item.x;
      const int begin = s == 0 ? 0 : __ldg(a.last + s - 1) + 1;
      const unsigned chunks = (unsigned)((__ldg(a.last + s) + 1 - begin + kTile - 1) / kTile);
      if (atomicAdd(a.arrived + row, 1u) == chunks - 1) {  // the last chunk to arrive
        __threadfence();
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) total[j] = atomicExch(sums + j, 0ull);
        atomicExch(a.arrived + row, 0u);
        emit(s, total, a.nseg, a.ranks, a.sums_out, a.dst, c);
      }
    }
    __syncthreads();  // s_part is read before the next chunk writes it
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kTile, 1024 / kTile)  // 64 registers a thread
    weight_reduce_kernel(const __grid_constant__ WeightReduce a,
                         const __grid_constant__ Consts c) {
  weight_reduce_body<kGather>(a, c);
}

// ---------------------------------------------------------------------------
// the weight reduce's instance axis (the batched GKR prover)
// ---------------------------------------------------------------------------

// B instances of one shape (dim, so k, kl, kh and the shared memory) in one
// launch, grid y = instance, each instance's operands passed in the launch's
// parameters (`Batch`, under __grid_constant__, in the constant bank as the
// single launch's are): no copy ahead of the launch and nothing in device
// memory. What bounds it at the bench's batch (8 x dim 14: 256 blocks, one
// tile each, two an SM): the card's memory traffic (8 instances' entries,
// gathers, carries, pairs and slots at once) and each SM's multiplies, not
// the reads of the instance (PERF.md, tools/gkr_batch_variants.py: the
// launch before this design read its instance from a device table filled
// by an async copy; the copy cost 1.3-1.5 us of its 0.030 ms, the reads
// nothing). So:
// kBatchPer = 2 entries a thread (256 threads a block at 128 registers, two
// blocks an SM), so that a block can hold its first tile's entries in
// registers; phase 1's threads issue those loads (the plan item, each
// entry's index, value, y and to_y, then the f3 gather) before they build
// the half tables or move the slot, so that the gather's dependent loads
// overlap that work (phase 2, with no gather, loads after it: measured
// faster); phase 1's f3 gathered from an entry-major copy of f3, one sector
// an entry where the (8, n) table spreads a lane over 8; the finish's
// multiply of the word above 2^256 skipped where that word is 0; the slot's
// lanes cut evenly over the instance's blocks, each mover loading both
// halves of two lanes and the final fold's operands before its own
// entries, then computing the fold itself (no barrier for it). A block with
// no item of its instance only moves the slot. A launch of at most 8
// instances takes parameters for 8, a larger one for kBatchCap, since
// parameter bytes cost launch time. Measured and not taken: a thread an
// entry (512 threads at 64 registers spill, or one block an SM), the half
// tables by direct products (depth 3 multiplies at k = 14 against the
// doubling's 7, no faster), the loads after the work in phase 1, or before
// it in phase 2.

constexpr int kBatchPer = 2;                      // entries a thread of a tile
constexpr int kBatchThreads = kTile / kBatchPer;  // the batched kernel's block
constexpr int kBatchBlocks = 2;                   // blocks an SM: 128 registers a thread
constexpr int kBatchWarps = kBatchThreads / 32;
// challenge digits a thread of the build stages (k <= kMaxRows rows over half the block)
constexpr int kStagePer = (kMaxRows * kDigits + kBatchThreads / 2 - 1) / (kBatchThreads / 2);
constexpr int kParamBytes = 32764;  // a launch's parameters (CUDA 12.1 and later, sm_70 and up)

// What every instance of a batched launch shares.
struct BatchShape {
  long long r_stride;            // the challenge rows' row stride
  long long half;                // the pair's half width: nseg = 2 half, the limb stride
  long long fstride;             // the final fold's limb stride
  unsigned long long* scratch;   // the long segments' (rows, 8) partials, zero between launches
  unsigned int* arrived;         // (rows,) chunks arrived, zero between launches
  int kl, kh;
  int slot;                      // 1: the pair's slot 1 from src
};

// One instance: WeightReduce's operands, its pair (lo, hi) (U, 8, half) each,
// whose slot 0 takes the segment sums (segment s < half at lo + s, else at hi
// + s - half) and slot 1, at + 8 half, the slot (src's halves, times the final
// fold of (flo, fhi, fr) where flo is given).
struct BatchInst {
  const int4* plan;
  const uint32_t* vals;
  const int32_t* idx;
  const int32_t* r;
  const int32_t* last;
  const int32_t* y;              // phase 1: y, f3 (entry-major (n3, 8) rows), to_y and the
  const uint32_t* f3;            //   carry; else null
  const int32_t* to_y;
  uint32_t* carry;
  uint32_t* lo;
  uint32_t* hi;
  const uint32_t* src;
  const uint32_t* flo;
  const uint32_t* fhi;
  const int32_t* fr;
  int items;
  int row;                       // its first scratch row
};

constexpr int kBatchFields = 15;  // BatchInst's pointers
// the most instances a launch's parameters hold; a launch of at most
// kBatchSmall takes a capacity of kBatchSmall, since a launch's parameter
// bytes cost launch time (on an H100, 7.6-8.1 us a launch back to back at 32 KB
// against 2.5-3.0 at 1 KB: tools/gkr_batch_variants.py)
constexpr int kBatchCap =
    (kParamBytes - (int)sizeof(Consts) - (int)sizeof(BatchShape)) / (int)sizeof(BatchInst);
constexpr int kBatchSmall = 8;  // the capacity of a launch of few instances (1,184 bytes)

template <int kCap>
struct Batch {
  BatchShape sh;
  BatchInst inst[kCap];
};
static_assert(sizeof(Batch<kBatchCap>) + sizeof(Consts) <= kParamBytes,
              "a batched launch's parameters");

// A thread's entries of one item (entries t, t + kBatchThreads, ...), loaded
// ahead of their use: the values (the weights, once computed), phase 1's f3
// lanes, the eq indices, the carry's rows and f3's lanes.
struct Held {
  uint32_t v[kBatchPer][kLimbs];
  uint32_t q[kBatchPer][kLimbs];
  uint32_t ix[kBatchPer];
  int32_t to[kBatchPer];
  int32_t yl[kBatchPer];
};

template <bool kGather>
__device__ __forceinline__ void load_entries(Held& h, const BatchInst& in, const int4 item,
                                             int t) {
#pragma unroll
  for (int j = 0; j < kBatchPer; ++j) {
    const int e = item.z + t + j * kBatchThreads;
    if (e < item.w) {
      h.ix[j] = (uint32_t)__ldg(in.idx + e);
      load_row(h.v[j], in.vals, e);
      if constexpr (kGather) {
        h.to[j] = __ldg(in.to_y + e);
        h.yl[j] = __ldg(in.y + e);
      }
    }
  }
}

// Phase 1's f3 lanes of the thread's entries, from f3's entry-major rows:
// one 32-byte sector an entry (a limb-major gather reads 8).
template <bool kGather>
__device__ __forceinline__ void gather_f3(Held& h, const BatchInst& in, const int4 item, int t) {
  if constexpr (kGather) {
#pragma unroll
    for (int j = 0; j < kBatchPer; ++j)
      if (item.z + t + j * kBatchThreads < item.w) load_row(h.q[j], in.f3, h.yl[j]);
  }
}

// Lanes [begin, end) of the pair's slot 1 over `threads` threads (thread
// `tid`): lo[1][:, k] = src[:, k] and hi[1][:, k] = src[:, half + k], times
// the final fold l + r (h - l) of (flo, fhi, fr) where flo is given, which
// each mover computes for itself. Two lanes a thread a pass, all four loads
// before the multiplies and stores; the first pass's loads and the fold's go
// out together, then() runs while they are in flight (the mover's own
// entries' loads), and only then does the fold wait for its operands.
template <class Then>
__device__ __forceinline__ void move_slot(const BatchInst& in, const BatchShape& sh,
                                          long long begin, long long end, const Consts& c,
                                          int tid, int threads, Then then) {
  const long long half = sh.half;
  uint32_t* lo = in.lo + kLimbs * half;
  uint32_t* hi = in.hi + kLimbs * half;
  uint32_t a[kLimbs], b[kLimbs], d[kLimbs], e[kLimbs], scale[kLimbs];
  long long k = begin + tid;
  bool one = k < end, two = k + threads < end;
  if (one) {
    load_lane(a, in.src + k, 2 * half);
    load_lane(b, in.src + half + k, 2 * half);
  }
  if (two) {
    load_lane(d, in.src + k + threads, 2 * half);
    load_lane(e, in.src + half + k + threads, 2 * half);
  }
  uint32_t fl[kLimbs], fh[kLimbs], fr[kLimbs];
  if (one && in.flo) {
    load_lane(fl, in.flo, sh.fstride);
    load_lane(fh, in.fhi, sh.fstride);
    load_digits(fr, reinterpret_cast<const uint32_t*>(in.fr));
  }
  then();
  if (one && in.flo) {
    sub_mod(fh, fh, fl, c.f);
    mont_mul(fh, fh, fr, c.f);
    add_mod(scale, fl, fh, c.f);
  }
  while (one) {
    if (in.flo) {
      mont_mul(a, a, scale, c.f);
      mont_mul(b, b, scale, c.f);
      if (two) {
        mont_mul(d, d, scale, c.f);
        mont_mul(e, e, scale, c.f);
      }
    }
    store_lane(lo + k, half, a);
    store_lane(hi + k, half, b);
    if (two) {
      store_lane(lo + k + threads, half, d);
      store_lane(hi + k + threads, half, e);
    }
    k += 2 * threads;
    one = k < end;
    two = k + threads < end;
    if (one) {
      load_lane(a, in.src + k, 2 * half);
      load_lane(b, in.src + half + k, 2 * half);
    }
    if (two) {
      load_lane(d, in.src + k + threads, 2 * half);
      load_lane(e, in.src + half + k + threads, 2 * half);
    }
  }
}

// Segment s's strict value into the instance's pair (`finish_lazy`).
__device__ __forceinline__ void emit_pair(long long s, const uint64_t acc[kLimbs],
                                          const BatchInst& in, long long half, const Consts& c) {
  uint32_t v[kLimbs];
  finish_lazy(v, acc, c);
  store_lane(s < half ? in.lo + s : in.hi + (s - half), half, v);
}

// One item of the plan over the held entries: the weights (phase 1: to the
// carry, then times f3[y]); a tile's segments one thread each out of the
// products staged in shared memory, entry-major; a chunk's block sum into
// its scratch row, the last chunk to arrive emitting the segment.
template <bool kGather>
__device__ __forceinline__ void reduce_item(Held& h, const int4 item, const BatchInst& in,
                                            const BatchShape& sh, const uint4* s_eq,
                                            uint4* s_stage, uint64_t (*s_part)[kLimbs],
                                            const Consts& c, int t) {
  const int nlo = 1 << sh.kl;
  const uint32_t mask = (uint32_t)nlo - 1;
#pragma unroll
  for (int j = 0; j < kBatchPer; ++j) {
    if (item.z + t + j * kBatchThreads < item.w) {
      uint32_t q[kLimbs];
      eq_lane(q, s_eq, h.ix[j] & mask);
      mont_mul(h.v[j], h.v[j], q, c.f);
      eq_lane(q, s_eq, nlo + (h.ix[j] >> sh.kl));
      mont_mul(h.v[j], h.v[j], q, c.f);
      if constexpr (kGather) {
        store_row(in.carry, h.to[j], h.v[j]);
        mont_mul(h.v[j], h.v[j], h.q[j], c.f);
      }
    } else {
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) h.v[j][l] = 0;
    }
  }
  if (item.y > 0) {  // a tile: one thread a segment, out of shared memory
#pragma unroll
    for (int j = 0; j < kBatchPer; ++j) {
      const uint32_t* v = h.v[j];
      s_stage[t + j * kBatchThreads] = make_uint4(v[0], v[1], v[2], v[3]);
      s_stage[kTile + t + j * kBatchThreads] = make_uint4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    for (int g = t; g < item.y; g += kBatchThreads) {
      const long long s = (long long)item.x + g;
      const int begin = (s == 0 ? 0 : __ldg(in.last + s - 1) + 1) - item.z;
      const int end = __ldg(in.last + s) + 1 - item.z;
      uint64_t acc[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int q = begin; q < end; ++q) {
        const uint4 l = s_stage[q], u = s_stage[kTile + q];
        acc[0] += l.x, acc[1] += l.y, acc[2] += l.z, acc[3] += l.w;
        acc[4] += u.x, acc[5] += u.y, acc[6] += u.z, acc[7] += u.w;
      }
      emit_pair(s, acc, in, sh.half, c);
    }
    __syncthreads();  // the stage is read before the next item writes it
    return;
  }
  // a chunk of a long segment: the block's sum, then the scratch row
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int l = 0; l < kLimbs; ++l) {
    uint64_t part = 0;
#pragma unroll
    for (int j = 0; j < kBatchPer; ++j) part += h.v[j][l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xFFFFFFFFu, part, off);
    if (lane == 0) s_part[warp][l] = part;
  }
  __syncthreads();
  if (t == 0) {
    uint64_t total[kLimbs] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int wi = 0; wi < kBatchWarps; ++wi)
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) total[l] += s_part[wi][l];
    const int row = in.row - 1 - item.y;
    unsigned long long* sums = sh.scratch + (long long)row * kLimbs;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) atomicAdd(sums + l, (unsigned long long)total[l]);
    __threadfence();  // the sums land before the count that announces them
    const long long s = item.x;
    const int begin = s == 0 ? 0 : __ldg(in.last + s - 1) + 1;
    const unsigned chunks = (unsigned)((__ldg(in.last + s) + 1 - begin + kTile - 1) / kTile);
    if (atomicAdd(sh.arrived + row, 1u) == chunks - 1) {  // the last chunk to arrive
      __threadfence();
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) total[l] = atomicExch(sums + l, 0ull);
      atomicExch(sh.arrived + row, 0u);
      emit_pair(s, total, in, sh.half, c);
    }
  }
  __syncthreads();  // s_part is read before the next chunk writes it
}

// Block (x, b) of instance b = blockIdx.y: its first item's loads; then the
// half tables built by the block's first half (the whole block without a
// slot), the build's threads issuing their f3 gather after its first levels,
// while the second half move the block's share of the slot and then issue
// theirs; then items x, x + gridDim.x, ..., the first from the held loads.
template <bool kGather, int kCap>
__global__ void __launch_bounds__(kBatchThreads, kBatchBlocks)
    weight_reduce_batched_kernel(const __grid_constant__ Batch<kCap> p,
                                 const __grid_constant__ Consts c) {
  extern __shared__ uint4 smem[];
  __shared__ uint64_t s_part[kBatchWarps][kLimbs];
  __shared__ uint32_t s_rows[kMaxRows][kDigits];
  uint4* s_stage = smem;           // [2][kTile]: an entry's limbs 0-3, then 4-7
  uint4* s_eq = smem + 2 * kTile;  // the half tables, two a lane
  const BatchShape& sh = p.sh;
  const BatchInst& in = p.inst[blockIdx.y];
  const int t = threadIdx.x;
  const long long chunk = sh.slot ? (sh.half + gridDim.x - 1) / gridDim.x : 0;
  const long long begin = min((long long)blockIdx.x * chunk, sh.half);
  const long long end = min(begin + chunk, sh.half);
  int it = blockIdx.x;
  if (it >= in.items) {  // no item: the whole block moves the slot
    move_slot(in, sh, begin, end, c, t, kBatchThreads, [] {});
    return;
  }
  int4 item = __ldg(in.plan + it);
  Held h;
  const int table_threads = sh.slot ? kBatchThreads / 2 : kBatchThreads;
  // whether the threads load their first entries before their work: phase
  // 1, whose f3 gather waits on y, gains by it, phase 2 loses
  // (tools/gkr_batch_variants.py)
  constexpr bool kEarly = kGather;
  if (t < table_threads) {
    // the challenge digits this thread stages, loaded beside the plan item
    const int digits = (sh.kl + sh.kh) * kDigits;
    uint32_t dig[kStagePer];
#pragma unroll
    for (int u = 0; u < kStagePer; ++u) {
      const int i = t + u * table_threads;
      if (i < digits) dig[u] = (uint32_t)__ldg(in.r + (i / kDigits) * sh.r_stride + i % kDigits);
    }
    if (kEarly) load_entries<kGather>(h, in, item, t);
#pragma unroll
    for (int u = 0; u < kStagePer; ++u) {
      const int i = t + u * table_threads;
      if (i < digits) s_rows[i / kDigits][i % kDigits] = dig[u];
    }
    build_eq_halves(s_eq, s_rows, sh.kl, sh.kh, c, t, table_threads);
    if (kEarly) gather_f3<kGather>(h, in, item, t);
  } else {
    move_slot(in, sh, begin, end, c, t - table_threads, kBatchThreads - table_threads, [&] {
      if (kEarly) load_entries<kGather>(h, in, item, t);
    });
    if (kEarly) gather_f3<kGather>(h, in, item, t);
  }
  __syncthreads();
  if (!kEarly) {
    load_entries<kGather>(h, in, item, t);
    gather_f3<kGather>(h, in, item, t);
  }
  for (;;) {
    reduce_item<kGather>(h, item, in, sh, s_eq, s_stage, s_part, c, t);
    it += gridDim.x;
    if (it >= in.items) break;
    item = __ldg(in.plan + it);
    load_entries<kGather>(h, in, item, t);
    gather_f3<kGather>(h, in, item, t);
  }
}

// A finish's lanes and the pair's slot 1: `lanes` lanes of sums, row j of
// them at sums + j * sums_ld (a rank's run of rank-major raw sums, or all of
// them); with src, slot 1 of the pair (lo, hi, limb stride and split those of
// the destination) takes src's lane i ((8, lanes) limb-major), times the
// final fold l + r (h - l) of the one-lane pair (flo, fhi; limb stride
// fstride) by the row fr where flo is given.
struct Finish {
  const unsigned long long* sums;
  long long sums_ld;
  long long lanes;
  const uint32_t* src;  // or null: no slot
  uint32_t* lo;
  uint32_t* hi;
  const uint32_t* flo;
  const uint32_t* fhi;
  long long fstride;
  const int32_t* fr;
};

// The finish of all-reduced raw sums, one thread a lane: its 8 limb sums ->
// their strict value in dst at the same lane (`finish_lazy`), and the slot's
// lane from the same thread. A sharded rank finishes only its own run of the
// rank-major sums, straight into its dealt pair, every load a contiguous one.
// Each thread loads the final fold's operands beside its lane's and computes
// the fold itself: no shared memory and no barrier, 64 registers, so that
// the 2^17 lanes of a rank at S = 2, dim 18, fit the card in one wave (a
// fold by the block's thread 0 behind a barrier took 74 registers, three
// blocks an SM, and was no faster in phase 2: tools/finish_variants.py).
__global__ void __launch_bounds__(kThreads)
    finish_sums_kernel(SegDest dst, const __grid_constant__ Finish p,
                       const __grid_constant__ Consts c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.lanes) return;
  uint32_t fl[kLimbs], fh[kLimbs], fr[kLimbs];
  if (p.flo) {
    load_lane(fl, p.flo, p.fstride);
    load_lane(fh, p.fhi, p.fstride);
    load_digits(fr, reinterpret_cast<const uint32_t*>(p.fr));
  }
  uint64_t acc[kLimbs];
  uint32_t v[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) acc[j] = p.sums[j * p.sums_ld + i];
  if (p.src) load_lane(v, p.src + i, p.lanes);
  uint32_t x[kLimbs];
  finish_lazy(x, acc, c);
  const bool low = i < dst.split;
  store_lane(low ? dst.lo + i : dst.hi + (i - dst.split), dst.ld, x);
  if (p.src) {
    if (p.flo) {
      sub_mod(fh, fh, fl, c.f);
      mont_mul(fh, fh, fr, c.f);
      add_mod(fl, fl, fh, c.f);
      mont_mul(v, v, fl, c.f);
    }
    store_lane(low ? p.lo + i : p.hi + (i - dst.split), dst.ld, v);
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

__device__ __forceinline__ void plan_fold(uint32_t out[kLimbs], const PairPlan& p,
                                          const Consts& c) {
  final_fold(out, p.flo + p.fslot * p.fslot_stride, p.fhi + p.fslot * p.fslot_stride,
             p.flimb_stride, p.fr, c);
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
      plan_fold(v, p, c);
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
        plan_fold(v, p, c);
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

// The weight reduce's blocks that fit on a device at once, by device, f3
// gather and k = kl + kh (which sets the shared memory): 0 until the first
// launch of that shape on the device works them out, so that later launches
// make no runtime call before the launch.
constexpr int kMaxDevices = 64;
constexpr int kMaxK = 48;
// [device][route: the single launch, or the batched one's capacity][gather][k]
int g_blocks[kMaxDevices][3][2][kMaxK + 1];

// Set the kernel's shared-memory limit (to what the largest half tables
// need) and work out the resident blocks.
cudaError_t resident_blocks(int device, int route, bool gather, int k, const void* fn,
                            int threads, size_t smem, int* blocks) {
  int& cached = g_blocks[device][route][gather][k];
  if (cached > 0) {
    *blocks = cached;
    return cudaSuccess;
  }
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)(kStageBytes + kMaxSharedEq * kLimbs * sizeof(uint32_t)))) !=
      cudaSuccess)
    return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) !=
      cudaSuccess)
    return e;
  cached = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = cached;
  return cudaSuccess;
}

// The scalars every instance of a launch shares.
struct Shape {
  long long r_stride;
  int kl, kh;
  long long nseg, n3, dst_ld, dst_split, half, fstride;
  int ranks;
};

// An instance's pointers, in the order the entries take them.
constexpr int kFields = 20;

size_t reduce_smem(int kl, int kh) {
  return kStageBytes + (size_t)((1 << kl) + (1 << kh)) * kLimbs * sizeof(uint32_t);
}

// One instance's WeightReduce from its pointers f (kFields, the order of
// sc_gkr_weight_reduce's arguments) and the shared scalars, or
// cudaErrorInvalidValue where they do not make a launch.
cudaError_t fill_reduce(WeightReduce* a, const void* const* f, int items, const Shape& sh,
                        int device) {
  const void *plan = f[0], *vals = f[1], *idx = f[2], *r = f[3], *last = f[4], *y = f[5],
             *f3 = f[6], *to_y = f[7], *flo = f[17], *fhi = f[18], *fr = f[19];
  void *carry = const_cast<void*>(f[8]), *scratch = const_cast<void*>(f[9]),
       *arrived = const_cast<void*>(f[10]), *sums_out = const_cast<void*>(f[11]),
       *dst_lo = const_cast<void*>(f[12]), *dst_hi = const_cast<void*>(f[13]),
       *slot_lo = const_cast<void*>(f[15]), *slot_hi = const_cast<void*>(f[16]);
  const void* slot_src = f[14];
  const int kl = sh.kl, kh = sh.kh;
  const bool gather = y != nullptr;
  if (items < 1 || sh.nseg < 1 || kl < 0 || kh < 0 || kl > 24 || kh > 24 || kh > kl ||
      device < 0 || device >= kMaxDevices || (gather && (!f3 || !to_y || !carry)) ||
      (!sums_out && !dst_lo) || !plan)
    return cudaErrorInvalidValue;
  const int lanes = (1 << kl) + (1 << kh);
  if (lanes > kMaxSharedEq || kl + kh > kMaxRows || !r || sh.ranks < 1 || sh.nseg % sh.ranks ||
      (sh.ranks > 1 && !sums_out))
    return cudaErrorInvalidValue;
  const int slot_items = slot_src ? (int)((sh.half + kTile - 1) / kTile) : 0;
  if (slot_src && (sh.half < 1 || !slot_lo || !slot_hi || (flo && (!fhi || !fr))))
    return cudaErrorInvalidValue;
  a->plan = static_cast<const int4*>(plan);
  a->items = items;
  a->vals = static_cast<const uint32_t*>(vals);
  a->idx = static_cast<const int32_t*>(idx);
  a->r = static_cast<const int32_t*>(r);
  a->r_stride = sh.r_stride;
  a->kl = kl;
  a->kh = kh;
  a->last = static_cast<const int32_t*>(last);
  a->nseg = sh.nseg;
  a->y = static_cast<const int32_t*>(y);
  a->f3 = static_cast<const uint32_t*>(f3);
  a->n3 = sh.n3;
  a->to_y = static_cast<const int32_t*>(to_y);
  a->carry = static_cast<uint32_t*>(carry);
  a->scratch = static_cast<unsigned long long*>(scratch);
  a->arrived = static_cast<unsigned int*>(arrived);
  a->sums_out = static_cast<unsigned long long*>(sums_out);
  a->ranks = sh.ranks;
  a->dst = {static_cast<uint32_t*>(dst_lo), static_cast<uint32_t*>(dst_hi), sh.dst_ld,
            sh.dst_split};
  a->slot = {static_cast<const uint32_t*>(slot_src), static_cast<uint32_t*>(slot_lo),
             static_cast<uint32_t*>(slot_hi), sh.half, slot_items,
             static_cast<const uint32_t*>(flo), static_cast<const uint32_t*>(fhi), sh.fstride,
             static_cast<const int32_t*>(fr)};
  return cudaSuccess;
}

bool fill_inst(BatchInst* in, const unsigned long long* f, int items, int row, bool gather,
               bool slot, bool fold) {
  const bool g = f[5] && f[6] && f[7] && f[8];
  if (items < 1 || row < 0 || !f[0] || !f[1] || !f[2] || !f[3] || !f[4] || !f[9] || !f[10] ||
      g != gather || g != (f[5] || f[6] || f[7] || f[8]) || (f[11] != 0) != slot ||
      (f[12] != 0) != fold || (fold && (!slot || !f[13] || !f[14])))
    return false;
  in->plan = reinterpret_cast<const int4*>(f[0]);
  in->vals = reinterpret_cast<const uint32_t*>(f[1]);
  in->idx = reinterpret_cast<const int32_t*>(f[2]);
  in->r = reinterpret_cast<const int32_t*>(f[3]);
  in->last = reinterpret_cast<const int32_t*>(f[4]);
  in->y = reinterpret_cast<const int32_t*>(f[5]);
  in->f3 = reinterpret_cast<const uint32_t*>(f[6]);
  in->to_y = reinterpret_cast<const int32_t*>(f[7]);
  in->carry = reinterpret_cast<uint32_t*>(f[8]);
  in->lo = reinterpret_cast<uint32_t*>(f[9]);
  in->hi = reinterpret_cast<uint32_t*>(f[10]);
  in->src = reinterpret_cast<const uint32_t*>(f[11]);
  in->flo = reinterpret_cast<const uint32_t*>(f[12]);
  in->fhi = reinterpret_cast<const uint32_t*>(f[13]);
  in->fr = reinterpret_cast<const int32_t*>(f[14]);
  in->items = items;
  in->row = row;
  return true;
}

// The batched kernel of capacity kCap, and its grid for `batch` instances
// whose most items is `top`: as many blocks as fit at once, shared evenly,
// at most `top` an instance.
template <int kCap, int kRoute>
cudaError_t batched_grid(bool gather, int kl, int kh, int batch, int top, int device,
                         const void** fn, int* per) {
  *fn = gather ? (const void*)weight_reduce_batched_kernel<true, kCap>
               : (const void*)weight_reduce_batched_kernel<false, kCap>;
  int most = 0;
  const cudaError_t e = resident_blocks(device, kRoute, gather, kl + kh, *fn, kBatchThreads,
                                        reduce_smem(kl, kh), &most);
  *per = (most + batch - 1) / batch < top ? (most + batch - 1) / batch : top;
  return e;
}

template <int kCap, int kRoute>
int launch_batched(const BatchShape& sh, int batch, const unsigned long long* fields,
                   const int* items, const int* rows, int device, const uint32_t* consts,
                   cudaStream_t s) {
  Batch<kCap> p;
  p.sh = sh;
  const bool gather = fields[5] != 0, fold = fields[12] != 0;
  int top = 0;
  for (int b = 0; b < batch; ++b) {
    if (!fill_inst(&p.inst[b], fields + (long long)b * kBatchFields, items[b], rows[b], gather,
                   sh.slot != 0, fold))
      return (int)cudaErrorInvalidValue;
    top = items[b] > top ? items[b] : top;
  }
  const void* fn;
  int per = 0;
  const cudaError_t e =
      batched_grid<kCap, kRoute>(gather, sh.kl, sh.kh, batch, top, device, &fn, &per);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = reduce_smem(sh.kl, sh.kh);
  const dim3 grid((unsigned)per, (unsigned)batch);
  const Consts c = make_consts(consts);
  if (gather) {
    weight_reduce_batched_kernel<true, kCap><<<grid, kBatchThreads, smem, s>>>(p, c);
  } else {
    weight_reduce_batched_kernel<false, kCap><<<grid, kBatchThreads, smem, s>>>(p, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sc_gkr_threads() { return kThreads; }
int sc_gkr_tile() { return kTile; }
int sc_gkr_max_shared_eq() { return kMaxSharedEq; }

// The constants every launch takes: p (8 limbs), -p^-1 mod 2^32, the
// Montgomery one (8), R^2 mod p (8), the reduction's subtraction count; 26
// words.

// The fused weight fold and segment sum over a plan of `items` int4 items
// (the tiles and chunks of `weight_reduce_kernel`): vals (nnz, 8) and idx
// (nnz,) sorted by segment; the k = kl + kh challenge rows r (row stride
// r_stride), from which each block builds the half tables (2^kl + 2^kh <=
// kMaxSharedEq lanes, else the launch is refused); last (nseg,);
// phase 1 also y (nnz,), f3 (8, n3), to_y (nnz,) and the carry (nnz, 8) out,
// else all four null. scratch (long, 8) uint64 and arrived (long,) uint32 for
// a plan with long segments (zero, and left zero), else null. The raw (8,
// nseg) int64 limb sums to sums_out if given (rank-major over `ranks` ranks,
// as emit lays them out; ranks = 1: segment s at column s), else the strict
// values to the destination. With slot_src: the pair's slot 1 too, slot_lo
// and slot_hi (8, half) each, from the (8, 2 half) table slot_src, times the
// final fold of (flo, fhi, fstride, fr) where flo is given. device: the
// current device's index. vals and the carry 16-byte aligned.
int sc_gkr_weight_reduce(const void* plan, int items, const void* vals, const void* idx,
                         const void* r, long long r_stride, int kl, int kh,
                         const void* last, long long nseg, const void* y, const void* f3,
                         long long n3, const void* to_y, void* carry, void* scratch,
                         void* arrived, void* sums_out, int ranks, void* dst_lo, void* dst_hi,
                         long long dst_ld, long long dst_split, const void* slot_src,
                         void* slot_lo, void* slot_hi, long long half, const void* flo,
                         const void* fhi, long long fstride, const void* fr, int device,
                         const uint32_t* consts, void* stream) {
  const void* fields[kFields] = {plan, vals, idx, r, last, y, f3, to_y, carry, scratch,
                                 arrived, sums_out, dst_lo, dst_hi, slot_src, slot_lo, slot_hi,
                                 flo, fhi, fr};
  const Shape sh{r_stride, kl, kh, nseg, n3, dst_ld, dst_split, half, fstride, ranks};
  WeightReduce a;
  cudaError_t e = fill_reduce(&a, fields, items, sh, device);
  if (e != cudaSuccess) return (int)e;
  const bool gather = y != nullptr;
  const size_t smem = reduce_smem(kl, kh);
  const void* fn = gather ? (const void*)weight_reduce_kernel<true>
                          : (const void*)weight_reduce_kernel<false>;
  // as many blocks as fit at once, each building the tables once
  int most = 0;
  if ((e = resident_blocks(device, 0, gather, kl + kh, fn, kTile, smem, &most)) !=
      cudaSuccess)
    return (int)e;
  const unsigned grid = (unsigned)(items < most ? items : most);
  const Consts c = make_consts(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather) {
    weight_reduce_kernel<true><<<grid, kTile, smem, s>>>(a, c);
  } else {
    weight_reduce_kernel<false><<<grid, kTile, smem, s>>>(a, c);
  }
  return (int)cudaGetLastError();
}

int sc_gkr_batch_capacity() { return kBatchCap; }
int sc_gkr_batch_fields() { return kBatchFields; }

// The parameter bytes of a batched launch of `batch` instances (the
// capacity it takes).
int sc_gkr_batch_param_bytes(int batch) {
  return (int)(sizeof(BatchShape) + sizeof(Consts) +
               (batch <= kBatchSmall ? kBatchSmall : kBatchCap) * sizeof(BatchInst));
}

// The blocks an instance that a batched launch of `batch` instances whose
// most items is `top` takes on `device`, or minus a CUDA error.
int sc_gkr_batch_blocks(int batch, int gather, int kl, int kh, int top, int device) {
  if (batch < 1 || batch > kBatchCap || top < 1 || kl < 0 || kh < 0 || kl + kh > kMaxK ||
      device < 0 || device >= kMaxDevices)
    return -(int)cudaErrorInvalidValue;
  const void* fn;
  int per = 0;
  const cudaError_t e =
      batch <= kBatchSmall
          ? batched_grid<kBatchSmall, 1>(gather, kl, kh, batch, top, device, &fn, &per)
          : batched_grid<kBatchCap, 2>(gather, kl, kh, batch, top, device, &fn, &per);
  return e == cudaSuccess ? per : -(int)e;
}

// The weight reduce of `batch` (1 to sc_gkr_batch_capacity()) instances in one
// launch of weight_reduce_batched_kernel, grid y = instance, the instances in
// the launch's parameters (a capacity of kBatchSmall for at most that many):
// fields, batch x kBatchFields pointers, instance b's plan, vals, idx, r,
// last, y, f3, to_y, carry (the last four phase 1's, else null), lo, hi (its
// pair's halves, (U >= 2, 8, half) each where there is a slot, contiguous),
// src, flo, fhi, fr (the slot, null without one; the final fold, null without
// one); f3 as (n3, 8) entry-major rows, 16-byte aligned; items (batch) and
// rows (batch: each instance's first scratch row); the scalars every instance
// shares: the rows' stride, kl, kh, the pair's half width (nseg = 2 half), the
// final fold's limb stride; scratch and
// arrived, the long segments' rows (null where no instance has long
// segments). Every instance gathers (phase 1) or none does, has a slot or
// none does, and a final fold or none does. Each instance takes ceil(resident
// / batch) blocks, at most the most items of any instance.
int sc_gkr_weight_reduce_batched(int batch, const unsigned long long* fields, const int* items,
                                 const int* rows, long long r_stride, int kl, int kh,
                                 long long half, long long fstride, void* scratch, void* arrived,
                                 int device, const uint32_t* consts, void* stream) {
  if (batch < 1 || batch > kBatchCap || half < 1 || kl < 0 || kh < 0 || kh > kl ||
      kl + kh > kMaxRows || (1 << kl) + (1 << kh) > kMaxSharedEq || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const BatchShape sh{r_stride, half, fstride, static_cast<unsigned long long*>(scratch),
                      static_cast<unsigned int*>(arrived), kl, kh, fields[11] != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= kBatchSmall)
    return launch_batched<kBatchSmall, 1>(sh, batch, fields, items, rows, device, consts, s);
  return launch_batched<kBatchCap, 2>(sh, batch, fields, items, rows, device, consts, s);
}

// sums: `lanes` lanes of all-reduced raw int64 limb sums, row j at sums + j
// * sums_ld -> their strict values at the same lanes of the destination
// (dst_ld, dst_split as sc_gkr_weight_reduce's). With src, the pair's slot 1
// too: slot_lo and slot_hi (the destination's strides) from the (8, lanes)
// table src, times the final fold of (flo, fhi, fstride, fr) where flo is
// given.
int sc_gkr_finish_sums(const void* sums, long long sums_ld, long long lanes, void* dst_lo,
                       void* dst_hi, long long dst_ld, long long dst_split, const void* src,
                       void* slot_lo, void* slot_hi, const void* flo, const void* fhi,
                       long long fstride, const void* fr, const uint32_t* consts, void* stream) {
  if (lanes < 1 || sums_ld < lanes || !sums || !dst_lo || (src && (!slot_lo || !slot_hi)) ||
      (flo && (!src || !fhi || !fr)))
    return (int)cudaErrorInvalidValue;
  const SegDest dst = {static_cast<uint32_t*>(dst_lo), static_cast<uint32_t*>(dst_hi), dst_ld,
                       dst_split};
  const Finish p = {static_cast<const unsigned long long*>(sums), sums_ld, lanes,
                    static_cast<const uint32_t*>(src), static_cast<uint32_t*>(slot_lo),
                    static_cast<uint32_t*>(slot_hi), static_cast<const uint32_t*>(flo),
                    static_cast<const uint32_t*>(fhi), fstride, static_cast<const int32_t*>(fr)};
  finish_sums_kernel<<<grid_of(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dst, p, make_consts(consts));
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
