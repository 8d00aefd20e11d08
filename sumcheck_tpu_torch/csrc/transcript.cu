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
// One round is about eight compressions (the feed, then 4 x next_u64, each a
// finalizing compression plus a 64-byte re-absorb, and ~10% of the time a
// second attempt). It runs on one thread of one block, with native 64-bit
// words: its cost is the latency of that chain, a few microseconds per
// compression, and what it saves is the host round trip per round.
//
// Transcript state, (26) 64-bit words in device memory, updated in place:
//   [0, 8)   h, the chaining value
//   8        t, bytes compressed so far
//   [9, 25)  buf, the pending block (zero past blen)
//   25       blen, pending bytes, a multiple of 8 in [0, 128]
// the `Blake2b512Rng.state_tuple()` of the host transcript, word for word.
//
// Per launch, for round j, with sums (d+1, 16) int64 per-digit sums:
//   msgs[j] (16, d+1) <- canonical digits of the round's evaluations,
//   rs[j] (16)        <- Montgomery digits of the sampled challenge.

#include "field.cuh"

namespace {

using namespace sc;

constexpr int kBlockBytes = 128;
constexpr int kStateWords = 26;
constexpr int kMaxDegree = 8;
constexpr int kWideDigits = kDigits + 4;  // exact sums of < 2^64 elements

struct Params {
  Field f;
  uint32_t r2[kLimbs];  // R^2 mod p, Montgomery form of R
  uint64_t top_mask;    // keeps the top draw word below 2^(MODULUS_BITS - 192)
};

struct State {
  uint64_t h[8];
  uint64_t t;
  uint64_t buf[16];
  int blen;
};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ void g(uint64_t v[16], int a, int b, int c, int d,
                                  uint64_t x, uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

// Blake2b F: h <- F(h, m, t, last); t < 2^64, so its high word is 0.
__device__ void compress(uint64_t h[8], const uint64_t m[16], uint64_t t,
                         bool last) {
  const uint64_t iv[8] = {
      0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
      0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
      0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
  const unsigned char sigma[12][16] = {
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
  uint64_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = iv[i];
  }
  v[12] ^= t;
  if (last) v[14] = ~v[14];
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const unsigned char* s = sigma[r];
    g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// Absorb one 8-byte word (`Blake2b512.update`): a full pending block is
// compressed only when more bytes arrive, so the last block can still be
// finalized.
__device__ void absorb_word(State& s, uint64_t w) {
  if (s.blen == kBlockBytes) {
    s.t += kBlockBytes;
    compress(s.h, s.buf, s.t, false);
#pragma unroll
    for (int i = 0; i < 16; ++i) s.buf[i] = 0;
    s.blen = 0;
  }
  s.buf[s.blen / 8] = w;
  s.blen += 8;
}

// One `fill_bytes(8)`: finalize a clone, emit its word 0, re-absorb the
// whole 64-byte block (the reference rng's semantics).
__device__ uint64_t next_u64(State& s) {
  uint64_t block[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) block[i] = s.h[i];
  compress(block, s.buf, s.t + (uint64_t)s.blen, true);
#pragma unroll
  for (int i = 0; i < 8; ++i) absorb_word(s, block[i]);
  return block[0];
}

__global__ void transcript_kernel(unsigned long long* __restrict__ state,
                                  const long long* __restrict__ sums,
                                  int degree, uint32_t* __restrict__ msgs,
                                  uint32_t* __restrict__ rs, long long j,
                                  Params prm) {
  const Field& f = prm.f;
  const int d1 = degree + 1;
  State s;
#pragma unroll
  for (int i = 0; i < 8; ++i) s.h[i] = state[i];
  s.t = state[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) s.buf[i] = state[9 + i];
  s.blen = (int)state[25];

  // feed Vec<Fr>: u64 LE length, then 32 canonical LE bytes per element
  absorb_word(s, (uint64_t)d1);
  uint32_t* msg = msgs + j * kDigits * d1;
  for (int t = 0; t < d1; ++t) {
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
    // 2. reduce mod p (`reduce_wide`): sum = hi * 2^256 + lo with lo < 3p
    //    and hi * 2^256 = mont_mul(hi, R^2)
    uint32_t lo[kLimbs], hi[kLimbs];
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      lo[i] = digits[2 * i] | (digits[2 * i + 1] << 16);
      hi[i] = 0;
    }
    hi[0] = digits[16] | (digits[17] << 16);
    hi[1] = digits[18] | (digits[19] << 16);
    cond_sub_p(lo, f);
    cond_sub_p(lo, f);
    mont_mul(hi, hi, prm.r2, f);
    add_mod(lo, lo, hi, f);
    // 3. canonical form: mont_mul(x, 1) = x * R^-1
    uint32_t one[kLimbs] = {1, 0, 0, 0, 0, 0, 0, 0};
    mont_mul(lo, lo, one, f);
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      msg[(2 * i) * d1 + t] = lo[i] & 0xFFFFu;
      msg[(2 * i + 1) * d1 + t] = lo[i] >> 16;
    }
    // 4. feed the element
#pragma unroll
    for (int w = 0; w < 4; ++w)
      absorb_word(s, (uint64_t)lo[2 * w] | ((uint64_t)lo[2 * w + 1] << 32));
  }

  // 5. fr_rand: 4 x next_u64 (least significant first), shave, reject >= p
  uint64_t p64[4];
#pragma unroll
  for (int w = 0; w < 4; ++w)
    p64[w] = (uint64_t)f.p[2 * w] | ((uint64_t)f.p[2 * w + 1] << 32);
  uint64_t draw[4];
  bool below = false;
  while (!below) {
#pragma unroll
    for (int w = 0; w < 4; ++w) draw[w] = next_u64(s);
    draw[3] &= prm.top_mask;
    bool decided = false;
#pragma unroll
    for (int w = 3; w >= 0; --w) {
      if (!decided && draw[w] != p64[w]) {
        below = draw[w] < p64[w];
        decided = true;
      }
    }
  }
  // 6. the accepted draw is the challenge's Montgomery form
#pragma unroll
  for (int i = 0; i < kDigits; ++i)
    rs[j * kDigits + i] = (uint32_t)((draw[i / 4] >> (16 * (i % 4))) & 0xFFFFu);

#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] = s.h[i];
  state[8] = s.t;
#pragma unroll
  for (int i = 0; i < 16; ++i) state[9 + i] = s.buf[i];
  state[25] = (unsigned long long)s.blen;
}

}  // namespace

extern "C" {

int sc_transcript_state_words() { return kStateWords; }

// field: p as 8 x 32-bit limbs (least significant first), -p^-1 mod 2^32,
// R^2 mod p as 8 limbs, then the number of top bits a draw shaves.
// Returns the cudaError_t of the launch (0 on success).
int sc_transcript_launch(void* state, const void* sums, int degree,
                         void* msgs, void* rs, long long j,
                         const uint32_t* field, void* stream) {
  if (degree < 1 || degree > kMaxDegree) return (int)cudaErrorInvalidValue;
  Params prm;
  for (int i = 0; i < kLimbs; ++i) prm.f.p[i] = field[i];
  prm.f.ninv = field[kLimbs];
  for (int i = 0; i < kLimbs; ++i) prm.r2[i] = field[kLimbs + 1 + i];
  const uint32_t shave = field[2 * kLimbs + 1];
  if (shave >= 32) return (int)cudaErrorInvalidValue;
  prm.top_mask = (shave == 0) ? ~0ull : ((1ull << (64 - shave)) - 1);
  transcript_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(state), static_cast<const long long*>(sums),
      degree, static_cast<uint32_t*>(msgs), static_cast<uint32_t*>(rs), j, prm);
  return (int)cudaGetLastError();
}

const char* sc_transcript_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
