/* Native Fiat-Shamir transcript core: unkeyed Blake2b-512 (RFC 7693) plus
 * the reference transcript's squeeze chain and ark-ff rejection sampling.
 *
 * Semantics served (bit-exact):
 * - running-digest transcript of the reference's `src/rng.rs` (Blake2b512Rng):
 *   `feed` absorbs serialized bytes; `fill_bytes` finalizes a clone per
 *   64-byte block and re-absorbs every emitted block (rng.rs:61-80);
 * - ark-ff 0.4 `UniformRand`: four LE u64 draws, top limb masked to
 *   MODULUS_BITS, reject if >= p (see transcript/blake2b_rng.py docstring).
 *
 * State convention matches `transcript/blake2b_core.py` exactly so the
 * (h, t, buf) triple round-trips with the pure-Python core and the on-device
 * transcript: `t` counts bytes already compressed, `buf` holds 0..128
 * pending bytes (a full block is held back until more data arrives, so the
 * final block can carry the `last` flag).
 *
 * The hot path this exists for: the host verifier samples one field element
 * per round (4 clone-finalize-absorb steps each); in Python that is ~16 us
 * per draw of interpreter overhead — here it is ~0.3 us.
 *
 * The port's own copy of `sumcheck_tpu/native/fastrng.c`, unchanged in
 * function. Built on demand by `sumcheck_tpu_torch/native/__init__.py`
 * (cc -O2 -shared); every entry point is plain C for ctypes. The field
 * arrives as arguments (p, the draw's shave mask, -p^-1 mod 2^64), so one
 * library serves every prime of the 4x64-limb shape.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define B2_BLOCK 128
#define B2_OUT 64

typedef struct {
    uint64_t h[8];
    uint64_t t;          /* bytes compressed so far (excl. pending buf) */
    uint64_t buflen;     /* 0..128 pending bytes */
    uint8_t buf[B2_BLOCK];
} b2_ctx;

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t SIGMA[12][16] = {
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
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

static inline uint64_t rotr64(uint64_t x, unsigned n) {
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64le(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8); /* little-endian host (x86-64/aarch64-le) */
    return v;
}

static inline void store64le(uint8_t *p, uint64_t v) { memcpy(p, &v, 8); }

#define G(a, b, c, d, x, y)                \
    do {                                   \
        va = v[a]; vb = v[b]; vc = v[c]; vd = v[d]; \
        va += vb + (x);                    \
        vd = rotr64(vd ^ va, 32);          \
        vc += vd;                          \
        vb = rotr64(vb ^ vc, 24);          \
        va += vb + (y);                    \
        vd = rotr64(vd ^ va, 16);          \
        vc += vd;                          \
        vb = rotr64(vb ^ vc, 63);          \
        v[a] = va; v[b] = vb; v[c] = vc; v[d] = vd; \
    } while (0)

/* One compression: t = total bytes including this block. */
static void b2_compress(uint64_t h[8], const uint8_t block[B2_BLOCK],
                        uint64_t t, int last) {
    uint64_t m[16], v[16], va, vb, vc, vd;
    int i, r;
    for (i = 0; i < 16; i++) m[i] = load64le(block + 8 * i);
    for (i = 0; i < 8; i++) v[i] = h[i];
    for (i = 0; i < 8; i++) v[8 + i] = IV[i];
    v[12] ^= t; /* t never exceeds 2^64 bytes here; high word stays 0 */
    if (last) v[14] = ~v[14];
    for (r = 0; r < 12; r++) {
        const uint8_t *s = SIGMA[r];
        G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

void b2_init(b2_ctx *S) {
    memcpy(S->h, IV, sizeof(IV));
    S->h[0] ^= 0x01010000ULL | B2_OUT; /* digest 64, no key, fanout/depth 1 */
    S->t = 0;
    S->buflen = 0;
}

void b2_update(b2_ctx *S, const uint8_t *in, uint64_t n) {
    /* a full block is held pending until MORE data arrives (matches the
     * pure-Python core's `while len(buf) > BLOCK` loop) */
    while (S->buflen + n > B2_BLOCK) {
        uint64_t take = B2_BLOCK - S->buflen;
        memcpy(S->buf + S->buflen, in, take);
        in += take;
        n -= take;
        S->t += B2_BLOCK;
        b2_compress(S->h, S->buf, S->t, 0);
        S->buflen = 0;
    }
    memcpy(S->buf + S->buflen, in, n);
    S->buflen += n;
}

/* Finalize a CLONE of the running state (the ctx itself is untouched). */
void b2_digest(const b2_ctx *S, uint8_t out[B2_OUT]) {
    uint64_t h[8];
    uint8_t block[B2_BLOCK];
    int i;
    memcpy(h, S->h, sizeof(h));
    memcpy(block, S->buf, S->buflen);
    memset(block + S->buflen, 0, B2_BLOCK - S->buflen);
    b2_compress(h, block, S->t + S->buflen, 1);
    for (i = 0; i < 8; i++) store64le(out + 8 * i, h[i]);
}

/* The transcript squeeze (`rng.rs:61-80`), block-sliced exactly like
 * `Blake2b512Rng.fill_bytes`: emit from a finalized clone; every
 * fully-consumed 64-byte block is re-absorbed; the block held at exit
 * (even unconsumed — the 64-aligned corner case) is absorbed too. */
void b2_fill(b2_ctx *S, uint8_t *out, uint64_t n) {
    uint8_t block[B2_OUT];
    b2_digest(S, block);
    while (n >= B2_OUT) {
        memcpy(out, block, B2_OUT);
        out += B2_OUT;
        n -= B2_OUT;
        b2_update(S, block, B2_OUT);
        b2_digest(S, block);
    }
    memcpy(out, block, n);
    b2_update(S, block, B2_OUT);
}

/* Four consecutive `next_u64` draws (each a separate fill_bytes(8)):
 * the byte pattern `Fr::rand` consumes. */
void b2_draw4(b2_ctx *S, uint8_t out[32]) {
    uint8_t block[B2_OUT];
    int k;
    for (k = 0; k < 4; k++) {
        b2_digest(S, block);
        memcpy(out + 8 * k, block, 8);
        b2_update(S, block, B2_OUT);
    }
}

/* ark-ff rejection sampling: draw 4 u64 limbs, mask the top limb with
 * `shave_mask`, accept when the 256-bit value is < p (LE limbs). Writes the
 * accepted MONTGOMERY-form limbs (LE bytes) to `out`; returns the attempt
 * count (callers only need >= 1). */
int b2_fr_draw(b2_ctx *S, const uint64_t p[4], uint64_t shave_mask,
               uint8_t out[32]) {
    uint64_t L[4];
    int attempts = 0, i, lt;
    for (;;) {
        attempts++;
        b2_draw4(S, out);
        for (i = 0; i < 4; i++) L[i] = load64le(out + 8 * i);
        L[3] &= shave_mask;
        lt = 0;
        for (i = 3; i >= 0; i--) {
            if (L[i] < p[i]) { lt = 1; break; }
            if (L[i] > p[i]) { lt = 0; break; }
        }
        if (lt) {
            for (i = 0; i < 4; i++) store64le(out + 8 * i, L[i]);
            return attempts;
        }
    }
}

/* Montgomery REDC with R = 2^256 (arkworks' 4x64 shape): canonical =
 * mont * R^-1 mod p. Word-serial: 4 rounds of m = T[0] * (-p^-1 mod 2^64);
 * T = (T + m*p) >> 64. Requires gcc/clang __int128. */
static void redc256(uint64_t T[4], const uint64_t p[4], uint64_t ninv0) {
    uint64_t acc[5] = {T[0], T[1], T[2], T[3], 0};
    int i, j;
    for (i = 0; i < 4; i++) {
        uint64_t m = acc[0] * ninv0;
        unsigned __int128 carry = 0;
        /* acc += m * p; acc[0] becomes 0 by construction */
        for (j = 0; j < 4; j++) {
            unsigned __int128 cur =
                (unsigned __int128)m * p[j] + acc[j] + (uint64_t)carry;
            acc[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        /* propagate the final carry into limb 4 (cannot overflow: acc < 2p*R) */
        {
            unsigned __int128 cur = (unsigned __int128)acc[4] + (uint64_t)carry;
            acc[4] = (uint64_t)cur;
            carry = cur >> 64;
        }
        /* shift right one limb; the dropped acc[0] is zero */
        acc[0] = acc[1];
        acc[1] = acc[2];
        acc[2] = acc[3];
        acc[3] = acc[4];
        acc[4] = (uint64_t)carry; /* at most 1 */
    }
    /* conditional subtract: result < 2p for p < 2^255 */
    {
        uint64_t ge = acc[4] ? 1 : 0; /* acc has a 257th-bit overflow? */
        int k;
        if (!ge) {
            ge = 1;
            for (k = 3; k >= 0; k--) {
                if (acc[k] < p[k]) { ge = 0; break; }
                if (acc[k] > p[k]) { ge = 1; break; }
            }
        }
        if (ge) {
            unsigned __int128 borrow = 0;
            for (k = 0; k < 4; k++) {
                unsigned __int128 cur = (unsigned __int128)acc[k] - p[k]
                                        - (uint64_t)borrow;
                acc[k] = (uint64_t)cur;
                borrow = (cur >> 64) ? 1 : 0;
            }
        }
    }
    T[0] = acc[0];
    T[1] = acc[1];
    T[2] = acc[2];
    T[3] = acc[3];
}

/* Rejection-sample AND convert to the canonical residue in one call:
 * the accepted masked draw IS the Montgomery representation (ark-ff
 * UniformRand), so canonical = REDC(draw). `ninv0` = -p^-1 mod 2^64. */
int b2_fr_draw_canonical(b2_ctx *S, const uint64_t p[4], uint64_t shave_mask,
                         uint64_t ninv0, uint8_t out[32]) {
    uint64_t L[4];
    int attempts = b2_fr_draw(S, p, shave_mask, out);
    int i;
    for (i = 0; i < 4; i++) L[i] = load64le(out + 8 * i);
    redc256(L, p, ninv0);
    for (i = 0; i < 4; i++) store64le(out + 8 * i, L[i]);
    return attempts;
}

/* --- 4x64 Montgomery field helpers (verifier interpolation) ------------- */

/* CIOS Montgomery multiply: out = a*b*R^-1 mod p, R = 2^256. Inputs < p,
 * output < p (final conditional subtract; valid for any p < 2^255). */
static void mont_mul4(uint64_t out[4], const uint64_t a[4], const uint64_t b[4],
                      const uint64_t p[4], uint64_t ninv0) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    int i, j;
    for (i = 0; i < 4; i++) {
        unsigned __int128 c = 0, cur;
        uint64_t m;
        for (j = 0; j < 4; j++) {
            cur = (unsigned __int128)a[i] * b[j] + t[j] + (uint64_t)c;
            t[j] = (uint64_t)cur;
            c = cur >> 64;
        }
        cur = (unsigned __int128)t[4] + (uint64_t)c;
        t[4] = (uint64_t)cur;
        t[5] = (uint64_t)(cur >> 64);
        m = t[0] * ninv0;
        c = 0;
        for (j = 0; j < 4; j++) {
            cur = (unsigned __int128)m * p[j] + t[j] + (uint64_t)c;
            t[j] = (uint64_t)cur;
            c = cur >> 64;
        }
        cur = (unsigned __int128)t[4] + (uint64_t)c;
        t[4] = (uint64_t)cur;
        t[5] += (uint64_t)(cur >> 64);
        t[0] = t[1];
        t[1] = t[2];
        t[2] = t[3];
        t[3] = t[4];
        t[4] = t[5];
        t[5] = 0;
    }
    /* result < 2p < 2^256 (p < 2^255): one conditional subtract */
    {
        int ge = 1;
        if (t[4]) {
            ge = 1;
        } else {
            for (i = 3; i >= 0; i--) {
                if (t[i] < p[i]) { ge = 0; break; }
                if (t[i] > p[i]) { ge = 1; break; }
            }
        }
        if (ge) {
            unsigned __int128 borrow = 0, cur;
            for (i = 0; i < 4; i++) {
                cur = (unsigned __int128)t[i] - p[i] - (uint64_t)borrow;
                t[i] = (uint64_t)cur;
                borrow = (cur >> 64) ? 1 : 0;
            }
        }
    }
    out[0] = t[0];
    out[1] = t[1];
    out[2] = t[2];
    out[3] = t[3];
}

static void add_mod4(uint64_t out[4], const uint64_t a[4], const uint64_t b[4],
                     const uint64_t p[4]) {
    unsigned __int128 c = 0, cur;
    uint64_t s[4];
    int i, ge = 1;
    for (i = 0; i < 4; i++) {
        cur = (unsigned __int128)a[i] + b[i] + (uint64_t)c;
        s[i] = (uint64_t)cur;
        c = cur >> 64;
    }
    if (!c) {
        for (i = 3; i >= 0; i--) {
            if (s[i] < p[i]) { ge = 0; break; }
            if (s[i] > p[i]) { ge = 1; break; }
        }
    }
    if (ge) {
        unsigned __int128 borrow = 0;
        for (i = 0; i < 4; i++) {
            cur = (unsigned __int128)s[i] - p[i] - (uint64_t)borrow;
            s[i] = (uint64_t)cur;
            borrow = (cur >> 64) ? 1 : 0;
        }
    }
    for (i = 0; i < 4; i++) out[i] = s[i];
}

static void sub_mod4(uint64_t out[4], const uint64_t a[4], const uint64_t b[4],
                     const uint64_t p[4]) {
    unsigned __int128 borrow = 0, cur;
    uint64_t s[4];
    int i;
    for (i = 0; i < 4; i++) {
        cur = (unsigned __int128)a[i] - b[i] - (uint64_t)borrow;
        s[i] = (uint64_t)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned __int128 c = 0;
        for (i = 0; i < 4; i++) {
            cur = (unsigned __int128)s[i] + p[i] + (uint64_t)c;
            s[i] = (uint64_t)cur;
            c = cur >> 64;
        }
    }
    for (i = 0; i < 4; i++) out[i] = s[i];
}

#define INTERP_MAX 36

/* Evaluate the unique degree-<n interpolant through (j, vals[j]) at
 * eval_at, Lagrange form with prefix/suffix numerators — the C twin of
 * `protocol/verifier._interp_eval_int` (identical results; the caller
 * handles the integer-node early return).
 *
 * vals/eval_at/out: canonical LE limbs. consts_mont: the cached per-degree
 * Lagrange denominators C_i ALREADY in Montgomery form. r2: R^2 mod p
 * (canonical -> Montgomery conversion multiplier). */
int fr_interp_eval(const uint64_t *vals, uint64_t n, const uint64_t eval_at[4],
                   const uint64_t *consts_mont, const uint64_t p[4],
                   uint64_t ninv0, const uint64_t r2[4], uint64_t out[4]) {
    uint64_t rM[4], facs[INTERP_MAX][4], suf[INTERP_MAX][4];
    uint64_t pre[4], acc[4], term[4], nodeM[4], one_m[4];
    uint64_t i;
    if (n > INTERP_MAX || n == 0) return -1;
    /* node i in Montgomery form, built incrementally: nodeM += oneM */
    mont_mul4(rM, eval_at, r2, p, ninv0); /* r -> Montgomery */
    /* oneM = R mod p = REDC(R2) = mont(1) */
    {
        uint64_t one[4] = {1, 0, 0, 0};
        mont_mul4(one_m, one, r2, p, ninv0);
    }
    nodeM[0] = nodeM[1] = nodeM[2] = nodeM[3] = 0;
    for (i = 0; i < n; i++) {
        sub_mod4(facs[i], rM, nodeM, p);
        add_mod4(nodeM, nodeM, one_m, p);
    }
    /* suffix products */
    suf[n - 1][0] = one_m[0];
    suf[n - 1][1] = one_m[1];
    suf[n - 1][2] = one_m[2];
    suf[n - 1][3] = one_m[3];
    for (i = n - 1; i > 0; i--)
        mont_mul4(suf[i - 1], suf[i], facs[i], p, ninv0);
    pre[0] = one_m[0];
    pre[1] = one_m[1];
    pre[2] = one_m[2];
    pre[3] = one_m[3];
    acc[0] = acc[1] = acc[2] = acc[3] = 0;
    for (i = 0; i < n; i++) {
        mont_mul4(term, vals + 4 * i, r2, p, ninv0); /* -> Montgomery */
        mont_mul4(term, term, consts_mont + 4 * i, p, ninv0);
        mont_mul4(term, term, pre, p, ninv0);
        mont_mul4(term, term, suf[i], p, ninv0);
        add_mod4(acc, acc, term, p);
        if (i + 1 < n) mont_mul4(pre, pre, facs[i], p, ninv0);
    }
    /* Montgomery -> canonical: multiply by 1 */
    {
        uint64_t one[4] = {1, 0, 0, 0};
        mont_mul4(out, acc, one, p, ninv0);
    }
    return 0;
}

/* One whole verification pass (feed + sample + deferred checks) in a single
 * call — the Python per-round loop costs ~15 us/round of interpreter and
 * serialization overhead, which dominated sub-ms verifies. Per round i:
 *   - absorb the round's serialized ProverMsg bytes (u64 LE count + d1
 *     32-byte canonical Fr) — byte-identical to `feed(prover_msg)`;
 *   - rejection-sample the round challenge (4 next_u64 draws, ark-ff
 *     masking) and store its canonical residue to rands_out + 32*i;
 *   - run the deferred consistency check `P_i(0) + P_i(1) == expected` and
 *     the interpolation `expected = P_i(r_i)` (reference `verifier.rs:90-121`
 *     order; checks don't touch the transcript, so fusing them into the feed
 *     loop changes no bytes).
 * The transcript ALWAYS advances through every round (matching the lazy
 * verifier, which feeds everything before checking); the first failed check
 * is reported as rc = -(i+1) with later checks skipped. Returns 0 and the
 * final expected value in `out` on success. */
int fr_verify_rounds(b2_ctx *S, const uint8_t *msgs, uint64_t nv, uint64_t d1,
                     const uint64_t asserted[4], const uint64_t *consts_mont,
                     const uint64_t p[4], uint64_t shave_mask, uint64_t ninv0,
                     const uint64_t r2[4], uint8_t *rands_out,
                     uint64_t out[4]) {
    uint64_t expected[4], s[4], ev[INTERP_MAX * 4], r[4];
    uint64_t stride = 8 + 32 * d1;
    uint64_t i, j;
    int k, rc = 0;
    if (d1 > INTERP_MAX || d1 < 2) return -1000;
    for (k = 0; k < 4; k++) expected[k] = asserted[k];
    for (i = 0; i < nv; i++) {
        const uint8_t *mb = msgs + i * stride;
        b2_update(S, mb, stride);
        b2_fr_draw_canonical(S, p, shave_mask, ninv0, rands_out + 32 * i);
        if (rc != 0) continue; /* keep feeding; first failure already held */
        for (j = 0; j < d1 * 4; j++) ev[j] = load64le(mb + 8 + 8 * j);
        for (k = 0; k < 4; k++) r[k] = load64le(rands_out + 32 * i + 8 * k);
        add_mod4(s, ev, ev + 4, p);
        for (k = 0; k < 4; k++)
            if (s[k] != expected[k]) { rc = -(int)(i + 1); break; }
        if (rc != 0) continue;
        if (r[1] == 0 && r[2] == 0 && r[3] == 0 && r[0] < d1) {
            for (k = 0; k < 4; k++) expected[k] = ev[4 * r[0] + k];
        } else {
            fr_interp_eval(ev, d1, r, consts_mont, p, ninv0, r2, expected);
        }
    }
    for (k = 0; k < 4; k++) out[k] = expected[k];
    return rc;
}

void b2_get_state(const b2_ctx *S, uint64_t h[8], uint64_t *t,
                  uint8_t buf[B2_BLOCK], uint64_t *buflen) {
    memcpy(h, S->h, sizeof(S->h));
    *t = S->t;
    memcpy(buf, S->buf, S->buflen);
    *buflen = S->buflen;
}

void b2_set_state(b2_ctx *S, const uint64_t h[8], uint64_t t,
                  const uint8_t *buf, uint64_t buflen) {
    memcpy(S->h, h, sizeof(S->h));
    S->t = t;
    S->buflen = buflen;
    memcpy(S->buf, buf, buflen);
}

void b2_copy(const b2_ctx *src, b2_ctx *dst) { *dst = *src; }

uint64_t b2_ctx_size(void) { return sizeof(b2_ctx); }
