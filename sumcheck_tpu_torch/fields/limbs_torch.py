"""Limb arithmetic for Fr in plain PyTorch — the port of
`sumcheck_tpu/fields/limbs_jnp.py`.

A vector of N field elements is a `(NUM_DIGITS, ...)` tensor in Montgomery
form, digit axis leading, every digit < 2^16 ("strict" form) — the JAX
package's layout, so tests compare like with like. Digits are held in
`int64`: PyTorch's CPU build implements neither `+` nor `>>` for `uint32`,
and 64-bit headroom lets the multiply accumulate digit products without the
uint32-only carry juggling the TPU needed. Every operation returns fully
reduced values in [0, p), exactly as `limbs_jnp` does, so results are
bit-identical to it and to `limbs_np`.

These are the plain versions the CUDA round kernels are checked against
(`ops/round_cuda.py`, `ops/init_cuda.py`) and the CPU path of the prover.
They run on any torch device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fr import (
    DIGIT_BITS,
    DIGIT_MASK,
    NINV16,
    NUM_DIGITS,
    P_DIGITS,
    R2,
    REDUCE_SUBS,
    WIDE_DIGITS,
)

_D = NUM_DIGITS
R2_DIGITS = tuple((R2 >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(_D))


@functools.cache
def const(digits: tuple, device: torch.device) -> torch.Tensor:
    """A constant digit tuple as an int64 tensor on `device`, made once per
    device. Later uses upload nothing: a copy from pageable host memory
    would wait for the device, so a chain of these ops stays free of host
    syncs once its constants exist."""
    return torch.tensor(digits, dtype=torch.int64, device=device)


def _pcol(ndim_lanes: int, device) -> torch.Tensor:
    """p digits shaped (16, 1, ..., 1) for broadcasting over lanes."""
    return const(P_DIGITS, device).reshape((_D,) + (1,) * ndim_lanes)


def _chain(rows, carry_in=None):
    """Sequential carry propagation over a list of relaxed rows -> (strict
    rows, carry_out). Arithmetic shifts, so a negative row borrows."""
    out = []
    carry = carry_in if carry_in is not None else torch.zeros_like(rows[0])
    for r in rows:
        t = r + carry
        out.append(t & DIGIT_MASK)
        carry = t >> DIGIT_BITS
    return out, carry


def cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """Strict (16, ...) a - p where a >= p, else a (any a < 2^256), so
    [0, 2p) -> [0, p): borrow chain, then select."""
    a = a.long()
    rows, borrow = _chain(list(a - _pcol(a.ndim - 1, a.device)))
    return torch.where(borrow == 0, torch.stack(rows), a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular add; strict reduced digits in and out."""
    rows, _ = _chain(list(a.long() + b.long()))  # < 2p < 2^256: no carry out
    return cond_sub_p(torch.stack(rows))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular subtract; strict reduced digits in and out."""
    a = a.long()
    t = a + _pcol(a.ndim - 1, a.device) - b.long()
    rows, _ = _chain(list(t))  # a + p - b in [0, 2p)
    return cond_sub_p(torch.stack(rows))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery multiply: a*b*R^-1 mod p, strict reduced digits in and out.

    Schoolbook 16x16-digit product, then digit-serial Montgomery reduction,
    all in int64 (the `limbs_np.mont_mul` schedule): digit products are
    < 2^32, and no accumulator digit exceeds 2^40, far inside int64."""
    a = a.long()
    b = b.long()
    lanes = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = torch.zeros((2 * _D,) + tuple(lanes), dtype=torch.int64, device=a.device)
    for i in range(_D):
        acc[i : i + _D] += a[i] * b
    pcol = _pcol(len(lanes), a.device)
    for i in range(_D):
        di = acc[i] & DIGIT_MASK
        acc[i + 1] += acc[i] >> DIGIT_BITS
        m = (di * NINV16) & DIGIT_MASK
        prod = m * pcol  # (16, lanes), each < 2^32
        acc[i + 1 : i + _D] += prod[1:]
        acc[i + 1] += (di + prod[0]) >> DIGIT_BITS  # low digit becomes 0
    rows, _ = _chain(list(acc[_D:]))  # value < 2p fits 16 digits
    return cond_sub_p(torch.stack(rows))


def mont_mul_const(a: torch.Tensor, digits: tuple) -> torch.Tensor:
    """Montgomery multiply by a constant digit tuple."""
    col = const(tuple(digits), a.device)
    return mont_mul(a, col.reshape((_D,) + (1,) * (a.ndim - 1)))


def reduce_wide(wide: torch.Tensor) -> torch.Tensor:
    """Strict wide digits (W, ...), 16 < W <= 32 -> (16, ...) reduced mod p.

    value = hi*2^256 + lo with hi*2^256 == montmul(hi, R^2) (mod p);
    lo < 2^256 needs `REDUCE_SUBS` conditional subtractions: two for
    BLS12-381 Fr, five for BN254 Fr (the round kernels take only values
    below p)."""
    wide = wide.long()
    w = wide.shape[0]
    assert _D < w <= 2 * _D
    lo = wide[:_D]
    for _ in range(REDUCE_SUBS):
        lo = cond_sub_p(lo)
    hi = torch.zeros((_D,) + tuple(wide.shape[1:]), dtype=torch.int64, device=wide.device)
    hi[: w - _D] = wide[_D:]
    return add(lo, mont_mul_const(hi, R2_DIGITS))


def sum_lanes_wide(a: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Exact integer sum over one axis of a strict digit array.

    (16, ..., N, ...) -> (WIDE_DIGITS, ...): strict wide digits, equal to the
    integer sum (NOT reduced mod p). int64 digit sums are exact for
    N < 2^47 lanes."""
    s = a.long().sum(dim=axis)
    zero = torch.zeros_like(s[0])
    rows, _ = _chain(list(s) + [zero] * (WIDE_DIGITS - _D))
    return torch.stack(rows)


def wide_to_int(w) -> int:
    """Host: wide digit column -> Python int (not mod-reduced).

    Uses addition, not OR: digits may be relaxed (> 16 bits)."""
    v = 0
    for i in range(len(w)):
        v += int(w[i]) << (DIGIT_BITS * i)
    return v


def from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """Strict uint32 digit array -> int64 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64)).to(device)
