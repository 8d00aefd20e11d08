"""Vectorized host (NumPy) limb arithmetic for Fr — the reference model for
the device kernels, plus fast host<->device packing.

Layout convention (shared with `limbs_torch` and the CUDA round kernels): a
vector of N field elements is a `(NUM_DIGITS, N) uint32` array in
**Montgomery form**, digit axis leading. Digits are 16-bit values stored in
uint32 ("strict" form: every digit < 2^16).

NumPy may use uint64/int64 intermediates freely (host only). Copied from
`sumcheck_tpu/fields/limbs_np.py`; only `WIDE_DIGITS` now comes from `fr`.

The port's device tables hold the same values as 8 x 32-bit limbs (least
significant first) in int32 words (`pack_limbs` / `unpack_limbs`, and
`limbs_torch`'s pair of the same names): `DenseMLE.to_device` packs here,
on the host, before its one upload.
"""

from __future__ import annotations

import numpy as np

from .fr import (
    DIGIT_BITS,
    DIGIT_MASK,
    NINV16,
    NUM_DIGITS,
    P,
    P_DIGITS,
    R2,
    R_INV,
    REDUCE_SUBS,
    SHAVE_BITS,
    WIDE_DIGITS,
)

_P64 = np.array(P_DIGITS, dtype=np.uint64)
_P_I64 = np.array(P_DIGITS, dtype=np.int64)


def _pcol(ndim_lanes: int, dtype=np.uint64) -> np.ndarray:
    """p digits shaped (NUM_DIGITS, 1, 1, ...) for broadcasting over lanes."""
    return np.asarray(P_DIGITS, dtype=dtype).reshape((NUM_DIGITS,) + (1,) * ndim_lanes)


def zeros(n: int) -> np.ndarray:
    return np.zeros((NUM_DIGITS, n), dtype=np.uint32)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def from_ints(vals, mont: bool = True) -> np.ndarray:
    """Pack canonical Python ints -> (NUM_DIGITS, N) uint32 digit array.

    If `mont`, converts to Montgomery form (vectorized montmul by R^2).
    """
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    arr = (
        np.frombuffer(buf, dtype="<u2")
        .reshape(len(vals), NUM_DIGITS)
        .T.astype(np.uint32)
        .copy()
    )
    if mont:
        r2 = from_int_scalar(R2)
        arr = mont_mul(arr, np.broadcast_to(r2, arr.shape))
    return arr


def from_int_scalar(v: int) -> np.ndarray:
    """Single value -> (NUM_DIGITS, 1) digit column (no Montgomery conversion)."""
    out = np.zeros((NUM_DIGITS, 1), dtype=np.uint32)
    for i in range(NUM_DIGITS):
        out[i, 0] = (v >> (DIGIT_BITS * i)) & DIGIT_MASK
    return out


def random_tables(rng: np.random.Generator, nv: int, count: int) -> list[np.ndarray]:
    """`count` random strict (NUM_DIGITS, 2^nv) tables below p, as the
    benchmarks draw them: uniform digits, the top one shifted right by
    1 + SHAVE_BITS (by 2 under BLS12-381 Fr, so below 2^254; by 3 under
    BN254 Fr), read as Montgomery values."""
    out = []
    for _ in range(count):
        d = rng.integers(0, 1 << DIGIT_BITS, size=(NUM_DIGITS, 1 << nv), dtype=np.uint32)
        d[NUM_DIGITS - 1] >>= 1 + SHAVE_BITS
        out.append(d)
    return out


def pack_limbs(digits: np.ndarray, axis: int = 0) -> np.ndarray:
    """Strict digits, 16 along `axis` -> the same values as 8 x 32-bit limbs
    along `axis` (limb j = digit 2j + digit 2j+1 * 2^16), int32 words
    holding the bit pattern; exact."""
    d = np.moveaxis(np.asarray(digits).astype(np.uint32), axis, 0)
    limbs = (d[0::2] | (d[1::2] << 16)).view(np.int32)
    return np.ascontiguousarray(np.moveaxis(limbs, 0, axis))


def unpack_limbs(limbs: np.ndarray, axis: int = 0) -> np.ndarray:
    """8 x 32-bit limbs along `axis` (int32 words) -> strict uint32 digits,
    16 along `axis`; exact, the inverse of `pack_limbs`."""
    x = np.moveaxis(np.asarray(limbs).astype(np.int64) & 0xFFFFFFFF, axis, 0)
    d = np.stack([x & DIGIT_MASK, x >> DIGIT_BITS], axis=1).reshape((NUM_DIGITS,) + x.shape[1:])
    return np.ascontiguousarray(np.moveaxis(d.astype(np.uint32), 0, axis))


def mont_scalar(v: int) -> np.ndarray:
    """Canonical int -> Montgomery digit column (NUM_DIGITS, 1)."""
    from .fr import to_mont

    return from_int_scalar(to_mont(v))


def to_ints(arr: np.ndarray, mont: bool = True) -> list[int]:
    """(NUM_DIGITS, N) strict digit array -> list of canonical Python ints."""
    n = arr.shape[1]
    b = arr.T.astype("<u2").tobytes()
    out = []
    for j in range(n):
        v = int.from_bytes(b[32 * j : 32 * (j + 1)], "little")
        out.append((v * R_INV) % P if mont else v % P)
    return out


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def _carry_normalize(acc: np.ndarray) -> np.ndarray:
    """Relaxed uint64 digits -> strict 16-bit digits (uint32).

    Assumes the represented value < 2^(16*len) so the final carry vanishes.
    """
    out = np.zeros(acc.shape, dtype=np.uint32)
    carry = np.zeros(acc.shape[1:], dtype=np.uint64)
    for i in range(acc.shape[0]):
        t = acc[i] + carry
        out[i] = (t & DIGIT_MASK).astype(np.uint32)
        carry = t >> DIGIT_BITS
    return out


def _geq_p(a: np.ndarray) -> np.ndarray:
    """a >= p, elementwise over lanes. `a` strict digits, shape (16, ...)."""
    ge = np.ones(a.shape[1:], dtype=bool)
    for i in range(NUM_DIGITS):
        d = a[i].astype(np.uint64)
        ge = np.where(d > _P64[i], True, np.where(d < _P64[i], False, ge))
    return ge


def _sub_p(a: np.ndarray) -> np.ndarray:
    """a - p mod 2^256, strict digits."""
    t = a.astype(np.int64) - _pcol(a.ndim - 1, np.int64)
    out = np.zeros(a.shape, dtype=np.uint32)
    carry = np.zeros(a.shape[1:], dtype=np.int64)
    for i in range(NUM_DIGITS):
        v = t[i] + carry
        out[i] = (v & DIGIT_MASK).astype(np.uint32)
        carry = v >> DIGIT_BITS  # arithmetic shift: -1 on borrow
    return out


def cond_sub_p(a: np.ndarray) -> np.ndarray:
    """a - p where a >= p, else a (any a < 2^256): [0, 2p) -> [0, p)."""
    ge = _geq_p(a)
    return np.where(ge[None], _sub_p(a), a)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Modular add; strict reduced digits in and out."""
    s = _carry_normalize(a.astype(np.uint64) + b.astype(np.uint64))
    return cond_sub_p(s)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Modular subtract; strict reduced digits in and out."""
    t = a.astype(np.int64) + _pcol(a.ndim - 1, np.int64) - b.astype(np.int64)
    out = np.zeros(t.shape, dtype=np.uint32)
    carry = np.zeros(t.shape[1:], dtype=np.int64)
    for i in range(NUM_DIGITS):
        v = t[i] + carry
        out[i] = (v & DIGIT_MASK).astype(np.uint32)
        carry = v >> DIGIT_BITS
    # a + p - b in [0, 2p)
    return cond_sub_p(out)


def neg(a: np.ndarray) -> np.ndarray:
    return sub(np.zeros_like(a), a)


def mont_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Montgomery multiply: a*b*R^-1 mod p. Strict digits in, fully reduced out.

    Digit-serial CIOS over 16-bit digits — the same schedule the uint32-only
    device kernels use; here with uint64 headroom for clarity.
    """
    a64 = a.astype(np.uint64)
    b64 = b.astype(np.uint64)
    lanes = np.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = np.zeros((2 * NUM_DIGITS,) + lanes, dtype=np.uint64)
    # schoolbook product: acc[k] < 16 * (2^16-1)^2 < 2^36
    for i in range(NUM_DIGITS):
        acc[i : i + NUM_DIGITS] += a64[i] * b64
    pcol = _pcol(len(lanes))
    # digit-serial Montgomery reduction
    for i in range(NUM_DIGITS):
        carry_in = acc[i] >> DIGIT_BITS
        di = acc[i] & DIGIT_MASK
        acc[i + 1] += carry_in
        m = (di * NINV16) & DIGIT_MASK
        prod = m * pcol  # (16, lanes), each < 2^32
        acc[i + 1 : i + NUM_DIGITS] += prod[1:]
        acc[i + 1] += (di + prod[0]) >> DIGIT_BITS  # low digit becomes 0
    res = _carry_normalize(acc[NUM_DIGITS : 2 * NUM_DIGITS])
    return cond_sub_p(res)


def mont_mul_scalar(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Montgomery multiply a table (16, N) by one element (16, 1)."""
    return mont_mul(a, np.broadcast_to(s, a.shape))


def reduce_wide(wide: np.ndarray) -> np.ndarray:
    """Strict wide digits (W, N), W in (16, 32] -> (16, N) reduced mod p.

    Splits value = hi*2^256 + lo and folds the high part back with
    hi*2^256 == hi*R == montmul(hi, R^2) (mod p); lo < 2^256 needs
    `REDUCE_SUBS` conditional subtractions (two for BLS12-381 Fr, five for
    BN254 Fr).
    """
    w = wide.shape[0]
    assert NUM_DIGITS < w <= 2 * NUM_DIGITS
    lo = wide[:NUM_DIGITS].astype(np.uint32)
    hi = np.zeros((NUM_DIGITS,) + wide.shape[1:], dtype=np.uint32)
    hi[: w - NUM_DIGITS] = wide[NUM_DIGITS:]
    for _ in range(REDUCE_SUBS):
        lo = cond_sub_p(lo)
    r2 = np.broadcast_to(from_int_scalar(R2), hi.shape)
    return add(lo, mont_mul(hi, r2))


def sum_lanes_wide(a: np.ndarray, axis: int = 1) -> np.ndarray:
    """Exact integer sum over one axis of a strict digit array.

    (16, ..., N, ...) -> (WIDE_DIGITS, ...): strict wide digits equal to the
    integer sum (NOT reduced mod p). Host analog of
    `limbs_torch.sum_lanes_wide`; uint64 accumulation (exact for N < 2^48).
    """
    s = np.sum(a.astype(np.uint64), axis=axis)
    out_shape = (WIDE_DIGITS,) + s.shape[1:]
    out = np.zeros(out_shape, dtype=np.uint32)
    carry = np.zeros(s.shape[1:], dtype=np.uint64)
    for i in range(WIDE_DIGITS):
        t = (s[i] if i < NUM_DIGITS else 0) + carry
        out[i] = (t & DIGIT_MASK).astype(np.uint32)
        carry = t >> DIGIT_BITS
    return out
