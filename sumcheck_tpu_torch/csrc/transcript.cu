// The per-round Fiat-Shamir step on the device, for Hopper (sm_90a): finish
// the round's exact sums, reduce them mod p to canonical form, feed them to
// the Blake2b-512 transcript as a `Vec<Fr>`, and sample the next challenge
// with arkworks' rejection sampling.
//
// Replaces the transcript step of the JAX package's chained provers:
// `_transcript_step` (sumcheck_tpu/protocol/device_prover.py) and the
// `feed_fr_vec_dyn` / `fr_rand_dyn` tail of the generic round step
// (protocol/generic_prover.py), both over sumcheck_tpu/transcript/device.py,
// where Blake2b ran as uint32-pair jnp ops. Built by ops/cuda_build.py,
// loaded by ops/transcript_cuda.py, which holds the plain PyTorch version
// (over transcript/device.py) this kernel is checked against.
//
// What bounds it: the step is a serial chain, a 64-bit hash whose next
// input depends on its last output, with a data-dependent rejection loop.
// One round of degree 3 is about eight compressions (the feed, then
// 4 x next_u64, each a finalizing compression plus a 64-byte re-absorb, and
// ~10% of the time a second attempt), each 24 dependent G levels of about
// 15 dependent integer instructions: its bound is that chain's latency plus
// one launch, not bytes or issue rate. The design keeps the chain short and
// its code small:
//   - the four G columns on four lanes: one thread running all four issues
//     about 2,100 integer instructions per compression, and a warp issues
//     them at half rate on the integer pipe (16 lanes a clock), about 4,100
//     clocks a compression on the H100; one column per lane issues a
//     quarter of them and is bound by the chain's latency and its 24 row
//     exchanges (`__shfl_sync` between the column and the diagonal step),
//     about 2,550 clocks (`compress_probe_kernel` times it; chip_smoke.py
//     prints it);
//   - registers only on the chain: the round's byte stream (the pending
//     block, the feed, each draw's re-absorbed output) lives in shared
//     memory as 64-bit words, zero past its end, and each compression reads
//     its block straight from it at a run-time offset, which costs no local
//     memory and no copying; the chaining value (two words per hash lane)
//     and the draw are registers;
//   - one copy of the compression: the hash runs as one loop whose body
//     compresses once, either a full block with more words behind it or
//     the finalizing clone of a draw, so the unrolled 12-round body sits in
//     the instruction cache once;
//   - the d+1 elements (carry chain over the round's per-digit sums,
//     `reduce_wide`, canonical form) run one per thread of the block's one
//     warp, while the chaining value's loads are in flight;
//   - the round's sums arrive summed over blocks: the round kernels add them
//     into one (d+1, 16) row with atomics, so a chained round is two
//     launches, the round kernel and this step.
//
// Degree: up to kMaxDegree (8) the stream is a static 128-word array and
// the d+1 elements one turn of the warp. Above it transcript_kernel<true>
// takes any degree in one launch and a fixed window of kWideStreamWords
// words: it forms the elements in turns of 32, one a thread, each turn's
// 128 words behind the at most 17 words carried (the pending words, then
// the length); after every turn but the last the hash lanes compress the
// window's full blocks that more bytes follow, and the rest (1 to 16
// words) moves to the front. So its shared memory does not grow with the
// degree, and the bytes it compresses are the ones the static stream
// would hold.
//
// Transcript state, (26) 64-bit words in device memory, updated in place:
//   [0, 8)   h, the chaining value
//   8        t, bytes compressed so far
//   [9, 25)  buf, the pending block (zero past blen)
//   25       blen, pending bytes, a multiple of 8 in [0, 128]
// the `Blake2b512Rng.state_tuple()` of the host transcript, word for word.
//
// Per launch, for round j, with sums the round's (d+1, 16) int64 per-digit
// sums:
//   msgs[j] (16, d+1) <- canonical digits of the round's evaluations,
//   rs[j] (16)        <- Montgomery digits of the sampled challenge.
// A batched launch (sc_transcript_launch_batched, the batched provers)
// runs one block per transcript, B blocks: block b advances state b from
// sums row b, each reading its own pending-byte count, and writes row
// j * B + b of msgs and rs, so round j of all B is one (B, ...) block.

#include "field.cuh"

namespace {

using namespace sc;

constexpr int kBlockBytes = 128;
constexpr int kStateWords = 26;
constexpr int kMaxDegree = 8;  // the static stream's; above it the wide one
constexpr int kWideDigits = kDigits + 4;  // exact sums of < 2^64 elements

struct Params {
  Field f;
  uint64_t top_mask;  // keeps the top draw word below 2^(MODULUS_BITS - 192)
};

// the round's byte stream in shared memory, 64-bit words: at most 16
// pending, the feed (1 + 4 (d+1) <= 37) and 8 per draw, moved to the front
// when it fills, with 16 zero words of slack past its end
constexpr int kStreamWords = 128;

// Above kMaxDegree: the elements a turn (one a thread of the warp), and
// the window they go into: the 17 carried words and a turn's 128 (145),
// one draw's 8 and the 16 words of slack fit before the first move to the
// front
constexpr int kTurn = 32;
constexpr int kWideStreamWords = 256;
static_assert(16 + 1 + 4 * kTurn + 8 + 16 <= kWideStreamWords, "a turn must fit the window");
constexpr int kSigBytes = 12 * 16;

constexpr unsigned kHashLanes = 0xFu;  // lanes 0..3 run the hash

// Blake2b's message schedule, 12 rounds (the last two repeat the first two)
__constant__ unsigned char kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ void g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d,
                                  uint64_t x, uint64_t y) {
  a = a + b + x;
  d = rotr64(d ^ a, 32);
  c = c + d;
  b = rotr64(b ^ c, 24);
  a = a + b + y;
  d = rotr64(d ^ a, 16);
  c = c + d;
  b = rotr64(b ^ c, 63);
}

// Blake2b F on the four hash lanes: lane i holds column i of the work
// vector (v[i], v[4+i], v[8+i], v[12+i]) and of the chaining value (h0 =
// h[i], h1 = h[4+i]), runs that column's G, then takes rows b, c, d from
// lanes i+1, i+2, i+3 for the diagonal G and hands them back. The message
// block is read from shared memory at the lane's sigma indices (`sig`, the
// table in shared memory); t < 2^64, so its high word is 0.
__device__ __forceinline__ void compress(uint64_t& h0, uint64_t& h1, const uint64_t* blk,
                                         const unsigned char* sig, uint64_t t, bool last,
                                         int i) {
  const uint64_t iv[8] = {
      0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
      0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
      0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
  uint64_t a = h0, b = h1;
  uint64_t c = i == 0 ? iv[0] : i == 1 ? iv[1] : i == 2 ? iv[2] : iv[3];
  uint64_t d = i == 0 ? iv[4] ^ t : i == 1 ? iv[5] : i == 2 ? (last ? ~iv[6] : iv[6]) : iv[7];
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const unsigned char* s = sig + r * 16 + 2 * i;
    const uint64_t x0 = blk[s[0]], y0 = blk[s[1]], x1 = blk[s[8]], y1 = blk[s[9]];
    g(a, b, c, d, x0, y0);
    b = __shfl_sync(kHashLanes, b, (i + 1) & 3, 4);
    c = __shfl_sync(kHashLanes, c, (i + 2) & 3, 4);
    d = __shfl_sync(kHashLanes, d, (i + 3) & 3, 4);
    g(a, b, c, d, x1, y1);
    b = __shfl_sync(kHashLanes, b, (i + 3) & 3, 4);
    c = __shfl_sync(kHashLanes, c, (i + 2) & 3, 4);
    d = __shfl_sync(kHashLanes, d, (i + 1) & 3, 4);
  }
  h0 ^= a ^ c;
  h1 ^= b ^ d;
}

// Element t of the round: the exact integer sum from its 16 per-digit sums,
// reduced mod p, in canonical form; its digits go to msg column t and its
// four little-endian words to `words`.
__device__ __forceinline__ void element(const long long* __restrict__ sums, int t, int d1,
                                        const Params& prm, uint32_t* __restrict__ msg,
                                        uint64_t* words) {
  const Field& f = prm.f;
  // 1. the exact integer sum: carry chain over the per-digit sums
  uint32_t digits[kWideDigits];
  unsigned long long carry = 0;
#pragma unroll
  for (int i = 0; i < kWideDigits; ++i) {
    const unsigned long long x =
        (i < kDigits ? (unsigned long long)sums[t * kDigits + i] : 0ull) + carry;
    digits[i] = (uint32_t)(x & 0xFFFFu);
    carry = x >> 16;
  }
  // 2. the canonical value of the Montgomery-form sum = lo + hi * 2^256
  //    (R = 2^256) is sum * R^-1 = lo * R^-1 + hi mod p: one reduction
  //    (mont_mul by 1, lo < 2^256 < p R) plus hi < 2^64 < p, the same
  //    element `reduce_wide` and `mont_mul(., 1)` give
  uint32_t lo[kLimbs], hi[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    lo[i] = digits[2 * i] | (digits[2 * i + 1] << 16);
    hi[i] = 0;
  }
  hi[0] = digits[16] | (digits[17] << 16);
  hi[1] = digits[18] | (digits[19] << 16);
  uint32_t one[kLimbs] = {1, 0, 0, 0, 0, 0, 0, 0};
  mont_mul(lo, lo, one, f);  // < p after its final subtraction
  add_mod(lo, lo, hi, f);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    msg[(2 * i) * d1 + t] = lo[i] & 0xFFFFu;
    msg[(2 * i + 1) * d1 + t] = lo[i] >> 16;
  }
#pragma unroll
  for (int w = 0; w < 4; ++w)
    words[w] = (uint64_t)lo[2 * w] | ((uint64_t)lo[2 * w + 1] << 32);
}

// One block per transcript: block b of a batched launch advances transcript
// b (state b, sums row b) and writes row j * gridDim.x + b of msgs and rs,
// so round j's outputs of all instances are one contiguous (B, ...) block.
// kWide: above kMaxDegree, the elements in turns of 32 through the
// kWideStreamWords window.
template <bool kWide>
__global__ void __launch_bounds__(32, 1)
    transcript_kernel(unsigned long long* __restrict__ state,
                      const long long* __restrict__ sums, int degree,
                      uint32_t* __restrict__ msgs, uint32_t* __restrict__ rs,
                      long long j, Params prm) {
  // the byte stream in 64-bit words: the pending block's words, then every
  // word absorbed this round; words at and past `len` are zero, so the
  // block at `pos` is always the zero-padded block Blake2b compresses
  constexpr int words = kWide ? kWideStreamWords : kStreamWords;
  __shared__ uint64_t stream[words];
  __shared__ unsigned char sig[kSigBytes];
  const int tid = threadIdx.x;
  const int d1 = degree + 1;
  state += (long long)blockIdx.x * kStateWords;
  sums += (long long)blockIdx.x * d1 * kDigits;
  j = j * gridDim.x + blockIdx.x;

  // the chaining value and counter load first, under the elements' work:
  // hash lane i holds h[i] and h[4 + i]
  uint64_t h0 = 0, h1 = 0;
  if (tid < 4) {
    h0 = state[tid];
    h1 = state[4 + tid];
  }
  uint64_t t = state[8];
  const uint64_t buf = tid < 16 ? state[9 + tid] : 0;
  const int pending = (int)(state[25] >> 3);
  for (int q = tid; q < words; q += 32) stream[q] = q < pending ? buf : 0;
  for (int q = tid; q < 12 * 16; q += 32) sig[q] = (&kSigma[0][0])[q];
  __syncwarp();
  // the feed of a Vec<Fr>: u64 LE length, then 4 LE words per element
  int len;
  if constexpr (kWide) {
    uint32_t* const msg = msgs + j * kDigits * d1;
    if (tid == 0) stream[pending] = (uint64_t)d1;
    len = pending + 1;
    int e0 = 0;
    for (; d1 - e0 > kTurn; e0 += kTurn) {
      // a turn that more elements follow: its words behind the carried
      // ones, then the hash lanes absorb every full block but the last
      // word's (len - 1 >> 4 of them: bytes follow each), all lanes
      // keeping the same count
      element(sums, e0 + tid, d1, prm, msg, stream + len + 4 * tid);
      __syncwarp();
      len += 4 * kTurn;
      const int blocks = (len - 1) >> 4;
      if (tid < 4)
        for (int b = 0; b < blocks; ++b)
          compress(h0, h1, stream + 16 * b, sig, t + (uint64_t)kBlockBytes * (b + 1), false,
                   tid);
      t += (uint64_t)kBlockBytes * blocks;
      // the rest, 1 to 16 words, to the front, and zeros behind it
      const int rest = len - 16 * blocks;
      const uint64_t w = tid < rest ? stream[16 * blocks + tid] : 0;
      __syncwarp();
      for (int q = tid; q < len; q += 32) stream[q] = q < rest ? w : 0;
      __syncwarp();
      len = rest;
    }
    if (tid < d1 - e0) element(sums, e0 + tid, d1, prm, msg, stream + len + 4 * tid);
    len += 4 * (d1 - e0);
  } else {
    if (tid < d1)
      element(sums, tid, d1, prm, msgs + j * kDigits * d1, stream + pending + 1 + 4 * tid);
    if (tid == 0) stream[pending] = (uint64_t)d1;
    len = pending + 1 + 4 * d1;
  }
  __syncwarp();
  if (tid >= 4) return;

  // the four hash lanes; everything below but the compression is uniform
  int pos = 0;
  uint64_t p64[4];
#pragma unroll
  for (int w = 0; w < 4; ++w)
    p64[w] = (uint64_t)prm.f.p[2 * w] | ((uint64_t)prm.f.p[2 * w + 1] << 32);
  // fr_rand: 4 x next_u64, least significant first, shaved, rejected if >= p;
  // the draws shift in at d3, so d0 is the first
  uint64_t d0 = 0, d1w = 0, d2 = 0, d3 = 0;
  int drawn = 0;
  for (;;) {
    // absorb (`Blake2b512.update`): a full pending block is compressed only
    // when more bytes follow it, so the last block can still be finalized
    const bool absorb = len - pos > 16;
    if (!absorb && drawn == 4) {
      const uint64_t w3 = d3 & prm.top_mask;
      const bool below = w3 != p64[3] ? w3 < p64[3]
                       : d2 != p64[2] ? d2 < p64[2]
                       : d1w != p64[1] ? d1w < p64[1]
                       : d0 < p64[0];
      if (below) {
        d3 = w3;
        break;
      }
      drawn = 0;
    }
    // the one compression of this pass: the full block, or one
    // `fill_bytes(8)`, which finalizes a clone, emits its word 0 and
    // re-absorbs its whole 64-byte output (the reference rng's semantics)
    uint64_t o0 = h0, o1 = h1;
    compress(o0, o1, stream + pos, sig,
             absorb ? t + kBlockBytes : t + 8 * (uint64_t)(len - pos), !absorb, tid);
    if (absorb) {
      h0 = o0;
      h1 = o1;
      t += kBlockBytes;
      pos += 16;
    } else {
      d0 = d1w;
      d1w = d2;
      d2 = d3;
      d3 = __shfl_sync(kHashLanes, o0, 0, 4);
      ++drawn;
      if (len + 8 > words - 16) {
        // rare (a run of rejected draws): move the pending words to the
        // front (the two ranges do not overlap); the block read at pos
        // stays inside the zeroed stream
        for (int q = tid; q < len - pos; q += 4) stream[q] = stream[pos + q];
        __syncwarp(kHashLanes);
        for (int q = len - pos + tid; q < len; q += 4) stream[q] = 0;
        __syncwarp(kHashLanes);
        len -= pos;
        pos = 0;
      }
      stream[len + tid] = o0;
      stream[len + 4 + tid] = o1;
      len += 8;
      __syncwarp(kHashLanes);
    }
  }
  state[tid] = h0;
  state[4 + tid] = h1;
  for (int q = tid; q < 16; q += 4) state[9 + q] = stream[pos + q];
  if (tid != 0) return;
  // the accepted draw is the challenge's Montgomery form
  const uint64_t draw[4] = {d0, d1w, d2, d3};
#pragma unroll
  for (int i = 0; i < kDigits; ++i)
    rs[j * kDigits + i] = (uint32_t)((draw[i / 4] >> (16 * (i % 4))) & 0xFFFFu);
  state[8] = t;
  state[25] = 8 * (unsigned long long)(len - pos);
}

// The launch floor: an empty kernel, timed back to back.
__global__ void empty_kernel() {}

// The card's dependent-issue latency: one thread, a chain of dependent
// integer instructions (xor, add), 16 per iteration.
__global__ void latency_kernel(uint32_t* __restrict__ out, int iters, uint32_t k1,
                               uint32_t k2) {
  uint32_t x = threadIdx.x + 1;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      asm volatile("xor.b32 %0, %0, %1;" : "+r"(x) : "r"(k1));
      asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(k2));
    }
  }
  out[0] = x;
}

// Test hook of the design: `iters` chained compressions of one fixed block
// from h = (1, ..., 8), the last flag on every eighth, by the four hash
// lanes; out[0..8) <- h, out[8] <- the clocks the chain took.
__global__ void compress_probe_kernel(unsigned long long* __restrict__ out, int iters) {
  __shared__ uint64_t blk[16];
  __shared__ unsigned char sig[12 * 16];
  const int tid = threadIdx.x;
  if (tid < 16) blk[tid] = 0x0123456789ABCDEFull * (tid + 1);
  for (int q = tid; q < 12 * 16; q += 32) sig[q] = (&kSigma[0][0])[q];
  __syncwarp();
  if (tid >= 4) return;
  const long long start = clock64();
  uint64_t h0 = tid + 1, h1 = tid + 5;
  for (int k = 0; k < iters; ++k)
    compress(h0, h1, blk, sig, (uint64_t)k * kBlockBytes, (k & 7) == 7, tid);
  out[tid] = h0;
  out[4 + tid] = h1;
  if (tid == 0) out[8] = (unsigned long long)(clock64() - start);
}

}  // namespace

extern "C" {

int sc_transcript_state_words() { return kStateWords; }

// field: p as 8 x 32-bit limbs (least significant first), -p^-1 mod 2^32,
// then the number of top bits a draw shaves.
// Returns the cudaError_t of the launch (0 on success).
// batch: transcripts advanced by one launch (one block each; 1 for a single
// one); state, sums, msgs and rs then hold `batch` of each back to back,
// msgs and rs per round.
int sc_transcript_launch_batched(void* state, const void* sums, int degree, void* msgs,
                                 void* rs, long long j, int batch, const uint32_t* field,
                                 void* stream) {
  if (degree < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  Params prm;
  for (int i = 0; i < kLimbs; ++i) prm.f.p[i] = field[i];
  prm.f.ninv = field[kLimbs];
  const uint32_t shave = field[kLimbs + 1];
  if (shave >= 32) return (int)cudaErrorInvalidValue;
  prm.top_mask = (shave == 0) ? ~0ull : ((1ull << (64 - shave)) - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* st = static_cast<unsigned long long*>(state);
  const long long* sm = static_cast<const long long*>(sums);
  uint32_t* m = static_cast<uint32_t*>(msgs);
  uint32_t* r = static_cast<uint32_t*>(rs);
  if (degree <= kMaxDegree)
    transcript_kernel<false><<<batch, 32, 0, s>>>(st, sm, degree, m, r, j, prm);
  else
    transcript_kernel<true><<<batch, 32, 0, s>>>(st, sm, degree, m, r, j, prm);
  return (int)cudaGetLastError();
}

// Test hooks of the bound: the empty kernel, `iters` x 16 dependent
// instructions on one thread, and the compression probe.
int sc_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

int sc_latency_launch(void* out, int iters, void* stream) {
  latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), iters, 0x9E3779B9u, 0x7F4A7C15u);
  return (int)cudaGetLastError();
}

int sc_compress_probe(void* out, int iters, void* stream) {
  compress_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out), iters);
  return (int)cudaGetLastError();
}

const char* sc_transcript_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
