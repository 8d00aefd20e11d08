// Field arithmetic shared by the port's kernels (round.cu, transcript.cu).
//
// Montgomery form with R = 2^256, 8 x 32-bit limbs (least significant
// first), CIOS multiplication with 64-bit intermediates. p and -p^-1 mod
// 2^32 arrive as launch parameters (struct Field), so another field changes
// no code here. Every result is fully reduced into [0, p), as the JAX limb
// code does, so the integers are bit-identical to it.
//
// Storage layout at the tensor boundary is the JAX package's: 16 x 16-bit
// digits per element in 32-bit words; load_lane / store_lane join and split
// them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sc {

constexpr int kLimbs = 8;    // 32-bit limbs per field element
constexpr int kDigits = 16;  // 16-bit digits per field element (storage)

struct Field {
  uint32_t p[kLimbs];
  uint32_t ninv;  // -p^-1 mod 2^32
};

// Join 16 digits spaced `stride` words apart into 8 limbs.
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

// r = a * b * 2^-256 mod p (CIOS), for a * b < p * 2^256. r may alias a or b.
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

}  // namespace sc
