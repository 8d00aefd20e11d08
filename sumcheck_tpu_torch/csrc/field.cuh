// Field arithmetic shared by the port's kernels (round.cu, transcript.cu).
//
// Montgomery form with R = 2^256, 8 x 32-bit limbs (least significant
// first), multiplication by even/odd accumulators on the multiply-add's
// carry chain (mont_mul; CIOS, mont_mul_cios, beside it as the probe's
// yardstick), additions and subtractions as PTX carry chains. p and -p^-1
// mod 2^32 arrive as launch parameters (struct Field), so another field
// changes no code here: BLS12-381 Fr (p < 2^255, -p^-1 = 0xFFFFFFFF mod
// 2^32) and BN254 Fr (p < 2^254, 0xEFFFFFFF) run the same code, and every
// bound below that cites p < 2^255 holds for both. Every result is fully
// reduced into [0, p), as the JAX limb code does, so the integers are
// bit-identical to it.
//
// Storage layout at the tensor boundary: a table holds each value as its 8
// limbs, limb j of lane k at [j * stride + k] (load_lane / store_lane), 32 B
// an element. The challenges, coefficients and sums rows the transcript
// reads keep the JAX package's 16 x 16-bit digits, one value a row
// (load_digits).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sc {

constexpr int kLimbs = 8;    // 32-bit limbs per field element
constexpr int kDigits = 16;  // 16-bit digits per field element (rows, sums)

struct Field {
  uint32_t p[kLimbs];
  uint32_t ninv;  // -p^-1 mod 2^32
};

// The 8 limbs of one lane, spaced `stride` words apart.
__device__ __forceinline__ void load_lane(uint32_t x[kLimbs], const uint32_t* base,
                                          long long stride) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) x[j] = base[j * stride];
}

__device__ __forceinline__ void store_lane(uint32_t* base, long long stride,
                                           const uint32_t x[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) base[j * stride] = x[j];
}

// Join a row of 16 consecutive 16-bit digits (a challenge, a coefficient)
// into 8 limbs.
__device__ __forceinline__ void load_digits(uint32_t x[kLimbs], const uint32_t* digits) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) x[j] = digits[2 * j] | (digits[2 * j + 1] << 16);
}

// x in [0, 2p) -> [0, p): x - p on one borrow chain, kept unless it
// borrowed out.
__device__ __forceinline__ void cond_sub_p(uint32_t x[kLimbs], const Field& f) {
  uint32_t d[kLimbs], borrow;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]),
        "r"(x[7]), "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]), "r"(f.p[3]), "r"(f.p[4]),
        "r"(f.p[5]), "r"(f.p[6]), "r"(f.p[7]));
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) x[j] = borrow ? x[j] : d[j];
}

// r = a + b mod p. a, b < p < 2^255, so a + b < 2^256 carries out nothing.
__device__ __forceinline__ void add_mod(uint32_t r[kLimbs],
                                        const uint32_t a[kLimbs],
                                        const uint32_t b[kLimbs],
                                        const Field& f) {
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  cond_sub_p(r, f);
}

// r = a - b mod p: a - b on one borrow chain, then p added back on one
// carry chain where it borrowed out.
__device__ __forceinline__ void sub_mod(uint32_t r[kLimbs],
                                        const uint32_t a[kLimbs],
                                        const uint32_t b[kLimbs],
                                        const Field& f) {
  uint32_t mask;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(mask)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
        "+r"(r[6]), "+r"(r[7])
      : "r"(f.p[0] & mask), "r"(f.p[1] & mask), "r"(f.p[2] & mask), "r"(f.p[3] & mask),
        "r"(f.p[4] & mask), "r"(f.p[5] & mask), "r"(f.p[6] & mask), "r"(f.p[7] & mask));
}

// r = a * b * 2^-256 mod p (CIOS), for a * b < p * 2^256. r may alias a or
// b. The yardstick of mont_mul's probe: 35.6e9 a second against mont_mul's
// 58.6e9 on an H100 80GB HBM3 at 700 W (chip_smoke.py, phase 5c).
__device__ __forceinline__ void mont_mul_cios(uint32_t r[kLimbs],
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

// The round kernels' multiply, by even/odd accumulators (the schedule of sppark's
// mont_t): the running value is T = E + O * 2^32, where E collects the
// partial products a[j] * b[i] of even j (low word at limb j, high at j+1:
// they never overlap, so a chain over E is one multiply-add with carry per
// word) and O those of odd j, one limb up. Every carry rides the carry-in of
// the next `madc`, so the 264 32-bit multiply-adds carry no separate add.
// After each reduction E[0] is 0 and T >> 32 is (O + E[1]) + (E >> 64) *
// 2^32: the arrays swap roles, E[1] is added into the new E's first word,
// and the shift by two words rides the new O's accumulate chain. T < 2p
// between steps and < 2^288 inside one (p < 2^255), so O's last carry out
// is always 0 and is dropped. Each chain is one asm statement, so nothing
// can come between its carries.
namespace eo {

// e[0..7] += sum_{j even} x[j] * b * 2^(32 j); the carry out goes into top
__device__ __forceinline__ void mac_even(uint32_t e[kLimbs], uint32_t& top,
                                         const uint32_t x[kLimbs], uint32_t b) {
  asm("mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
        "+r"(e[6]), "+r"(e[7]), "+r"(top)
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(b));
}

// o[0..7] += sum_{j odd} x[j] * b * 2^(32 (j - 1)); the carry out is 0
__device__ __forceinline__ void mac_odd(uint32_t o[kLimbs], const uint32_t x[kLimbs],
                                        uint32_t b) {
  asm("mad.lo.cc.u32  %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32    %7, %11, %12, %7;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(x[1]), "r"(x[3]), "r"(x[5]), "r"(x[7]), "r"(b));
}

// e[0] += o[1], and o <- (o >> 64) + sum_{j odd} x[j] * b * 2^(32 (j - 1))
// with that add's carry entering o[0]; the carry out is 0
__device__ __forceinline__ void shift_mac_odd(uint32_t& e0, uint32_t o[kLimbs],
                                              const uint32_t x[kLimbs], uint32_t b) {
  asm("add.cc.u32     %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32    %8, %12, %13, 0;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(x[1]), "r"(x[3]), "r"(x[5]), "r"(x[7]), "r"(b));
}

// One step of the product: (er, orr) += a * b_i, then the reduction by
// m = er[0] * ninv, which zeroes er[0].
__device__ __forceinline__ void step(uint32_t er[kLimbs], uint32_t orr[kLimbs],
                                     const uint32_t a[kLimbs], uint32_t bi, bool first,
                                     const Field& f) {
  if (first) {
#pragma unroll
    for (int j = 0; j < kLimbs; j += 2) {
      er[j] = a[j] * bi;
      er[j + 1] = __umulhi(a[j], bi);
      orr[j] = a[j + 1] * bi;
      orr[j + 1] = __umulhi(a[j + 1], bi);
    }
  } else {
    shift_mac_odd(er[0], orr, a, bi);
    mac_even(er, orr[kLimbs - 1], a, bi);
  }
  const uint32_t m = er[0] * f.ninv;
  mac_odd(orr, f.p, m);
  mac_even(er, orr[kLimbs - 1], f.p, m);
}

}  // namespace eo

// r = a * b * 2^-256 mod p by even/odd accumulators (above), for a, b < p,
// or for b = 1 and any a < 2^256 (transcript.cu's reduction): either way T
// stays below 2^288 inside a step and the result below 2p. Bit-identical
// to mont_mul_cios. r may alias a or b. ptxas fuses each lo/hi pair of a
// chain into one IMAD.WIDE.U32.X with predicate carries: 184 SASS
// instructions a multiply for sm_90a, 136 of them multiplies, against
// CIOS's 422 (chip_smoke.py, phase 5c).
__device__ __forceinline__ void mont_mul(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                                         const uint32_t b[kLimbs], const Field& f) {
  uint32_t e[kLimbs], o[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; i += 2) {
    eo::step(e, o, a, b[i], i == 0, f);  // swap: the next step's E is o
    eo::step(o, e, a, b[i + 1], false, f);
  }
  // T = e + (o >> 32) < 2p
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
        "+r"(e[6]), "+r"(e[7])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = e[j];
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
