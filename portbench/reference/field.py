"""Prime-field arithmetic in plain torch operations, for the benchmark's
reference prover.

A value is a column of 16 digits of 16 bits, least significant first,
held in int64 so that sums of digit products never overflow; a tensor of
values is (16, ...), the digits on the first axis. Values are kept in
Montgomery form, x·R mod p with R = 2^256, as the benchmark's random
tables are read: a product of two Montgomery values is Montgomery's
x·y·R^-1 mod p. Every result is strict: each digit below 2^16 and the
value below p.

This file is written from the definitions, not from the port: the port's
kernels hold 8 limbs of 32 bits and multiply in CIOS order on the card;
here the digits are multiplied row by row in torch and carried by passes.

`lazy=True` gives the control of the benchmark's correctness check: the
same arithmetic with the reduction a later change might be tempted to
drop. Sums and products skip their final subtraction of p and keep 256
bits, so a carry out of the top digit is lost.
"""

from __future__ import annotations

import torch

DIGITS = 16
DIGIT_BITS = 16
MASK = (1 << DIGIT_BITS) - 1
R_BITS = DIGITS * DIGIT_BITS


def int_digits(v: int) -> list[int]:
    return [(v >> (DIGIT_BITS * i)) & MASK for i in range(DIGITS)]


def digits_int(col) -> int:
    """A column of digit sums (any size each) -> the Python int they stand
    for."""
    return sum(int(d) << (DIGIT_BITS * i) for i, d in enumerate(col))


class Field:
    """Arithmetic mod `p` (odd, below 2^255) on `device`."""

    def __init__(self, p: int, device, lazy: bool = False):
        if p % 2 == 0 or p.bit_length() > 255:
            raise ValueError("the modulus must be odd and below 2^255")
        self.p = p
        self.device = torch.device(device)
        self.lazy = lazy
        self.r_mod = (1 << R_BITS) % p
        self.r_inv = pow(self.r_mod, -1, p)
        self.ninv = (-pow(p, -1, 1 << DIGIT_BITS)) % (1 << DIGIT_BITS)
        self._p = torch.tensor(int_digits(p), dtype=torch.int64, device=self.device)
        # conditional subtractions that take any value below 2^256 into [0, p)
        self.reduce_subs = -(-(1 << R_BITS) // p) - 1

    # -- conversions -------------------------------------------------------
    def const(self, v: int, ndim: int) -> torch.Tensor:
        """The value `v` (already in the form wanted) as digits shaped to
        broadcast against a (16, ...) tensor of `ndim` dimensions."""
        t = torch.tensor(int_digits(v % self.p), dtype=torch.int64, device=self.device)
        return t.reshape((DIGITS,) + (1,) * (ndim - 1))

    def mont(self, v: int) -> int:
        """Canonical -> Montgomery form."""
        return v * self.r_mod % self.p

    def canonical(self, m: int) -> int:
        """Montgomery form (any representative) -> canonical residue."""
        return m * self.r_inv % self.p

    def one(self, ndim: int) -> torch.Tensor:
        return self.const(self.r_mod, ndim)

    def _pcol(self, ndim: int) -> torch.Tensor:
        return self._p.reshape((DIGITS,) + (1,) * (ndim - 1))

    # -- carries -----------------------------------------------------------
    @staticmethod
    def carry(x: torch.Tensor) -> torch.Tensor:
        """Carry (or borrow) `x` in place until every row but the last is a
        digit in [0, 2^16); the last row takes what is left, its sign the
        sign of the value."""
        while True:
            hi = x[:-1] >> DIGIT_BITS  # floor: a borrow for a negative row
            if not bool(hi.any()):
                return x
            x[:-1] -= hi << DIGIT_BITS
            x[1:] += hi

    def _extend(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        pad = torch.zeros((rows - x.shape[0],) + tuple(x.shape[1:]), dtype=torch.int64,
                          device=x.device)
        return torch.cat([x, pad])

    def _sub_p_if_over(self, x: torch.Tensor) -> torch.Tensor:
        """x (17 rows, strict, non-negative) -> x - p where that is not
        negative, else x."""
        d = x.clone()
        d[:DIGITS] -= self._pcol(x.dim())
        self.carry(d)
        return torch.where((d[DIGITS] < 0).unsqueeze(0), x, d)

    def _finish(self, x: torch.Tensor, subs: int) -> torch.Tensor:
        """A non-negative value of 17 rows below (subs + 1)·p, carried ->
        its strict 16 digits below p (lazy: its low 256 bits, unreduced)."""
        self.carry(x)
        if self.lazy:
            return x[:DIGITS].contiguous()
        for _ in range(subs):
            x = self._sub_p_if_over(x)
        return x[:DIGITS].contiguous()

    # -- arithmetic --------------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._finish(self._extend(a + b, DIGITS + 1), 1)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = self.carry(self._extend(a - b, DIGITS + 1))
        neg = (d[DIGITS] < 0).unsqueeze(0)
        back = self.carry(d + self._extend(self._pcol(d.dim()).expand_as(d[:DIGITS]),
                                           DIGITS + 1))
        return torch.where(neg, back, d)[:DIGITS].contiguous()

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery's a·b·R^-1 mod p, digit-serial: at step i add a_i·b,
        then the multiple m·p that clears digit i, and carry digit i up."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        acc = torch.zeros((2 * DIGITS + 1,) + tuple(shape[1:]), dtype=torch.int64,
                          device=self.device)
        pcol = self._pcol(len(shape))
        for i in range(DIGITS):
            acc[i:i + DIGITS] += a[i] * b
            m = ((acc[i] & MASK) * self.ninv) & MASK
            acc[i:i + DIGITS] += m * pcol
            acc[i + 1] += acc[i] >> DIGIT_BITS
        return self._finish(acc[DIGITS:], 1)

    def reduce_wide(self, x: torch.Tensor) -> torch.Tensor:
        """Non-negative digit sums (16 or more rows, any size each, their
        value below 2^272) -> the strict value mod p: the low 256 bits
        reduced by subtraction, the high digit h as h·2^256 = h·R, the
        Montgomery product of h and R^2."""
        x = self.carry(self._extend(x, max(x.shape[0], DIGITS + 2)))
        if bool(x[DIGITS + 1:].any()):
            raise ValueError("reduce_wide takes values below 2^272")
        high = torch.zeros_like(x[:DIGITS])
        high[0] = x[DIGITS]
        low = self._finish(self._extend(x[:DIGITS], DIGITS + 1), self.reduce_subs)
        r2 = self.const(self.r_mod * self.r_mod % self.p, x.dim())
        return self.add(low, self.mul(high, r2))
