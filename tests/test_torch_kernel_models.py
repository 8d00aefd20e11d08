"""Plain models of the data flow inside the port's CUDA kernels, on the CPU.

A CUDA kernel cannot run here, so each schedule that the kernels use is
written out below step by step, in the kernel's own order and layout, and
checked against the port's plain versions and Python integers:

- the even/odd Montgomery multiply of `csrc/field.cuh` (`mont_mul`): each
  carry chain word by word, as the PTX `mad.lo.cc` / `madc.hi.cc` chains run
  it;
- the MXU fold multiply of `csrc/round_mxu.cu` (`mxu_tile`): the rows M_j
  of the challenge's byte matrix, the `mma.m16n8k32` fragments of every
  thread of a warp, the permuted k and column orders, and the quad carry
  passes (`column_word`, m and m p, `quad_normalize` with its shuffle and
  ballots, the division by 2^16); against `ops/mxu_mul.py` and
  `limbs_torch.mont_mul`;
- the register evaluation of `csrc/round.cu` (`nofold_kernel`, and
  `fold_kernel` after its fold, reading the ladder's (E, O - E)): product by
  product, a product of l factors multiplied at t = 0..l and extended by
  backward differences; against the ladder (`round_cuda.round_nofold_ref`)
  at degrees 1-8;
- the wide route's chunked evaluation (`csrc/round_common.cuh`
  `wide_block_sums`, `extend_to`): the points in chunks of T, each factor's
  first point of a chunk by one multiply and the rest by additions, each
  product at its own degree's points and extended by differences in place,
  the padding slot skipped; against the plain versions and Python integers
  at T = 1, 2, 4, 8, 10, 12 and the kernels' choice, degrees 1-24, ragged
  products with and without coefficients, F4's five structures (round 0 and
  the fold), and its multiplies against `chip_smoke.eval_multiplies`.

Tolerance 0 everywhere: exact integer arithmetic.
"""

from __future__ import annotations

import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.fields import limbs_torch as LT
from sumcheck_tpu_torch.fields.fr import NINV32, NINV_FULL, P
from sumcheck_tpu_torch.ops import gkr_init_cuda as GK
from sumcheck_tpu_torch.ops import mxu_mul as TM
from sumcheck_tpu_torch.ops import round_cuda as RC

M32 = (1 << 32) - 1
R_INV = pow(1 << 256, -1, P)
P_LIMBS = [(P >> (32 * j)) & M32 for j in range(8)]
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 255) % P, (1 << 256) % P, (1 << 128) % P]


def _limbs(v: int) -> list[int]:
    return [(v >> (32 * j)) & M32 for j in range(8)]


def _int(limbs) -> int:
    return sum(int(x) << (32 * j) for j, x in enumerate(limbs))


# ---------------------------------------------------------------------------
# field.cuh: mont_mul by even/odd accumulators
# ---------------------------------------------------------------------------


class _Chain:
    """One PTX carry chain: `op` adds the carry flag in (cin) and sets it
    from the 33rd bit (cout), as `madc` / `addc` with and without `.cc`."""

    def __init__(self):
        self.cf = 0

    def op(self, v: int, cin: bool, cout: bool) -> int:
        v += self.cf if cin else 0
        if cout:
            self.cf = v >> 32
        return v & M32


def _lo(a, b):
    return (a * b) & M32


def _hi(a, b):
    return (a * b) >> 32


def _mac_even(e, o, x, b):
    """`eo::mac_even`: e += x_even * b, the carry out into o[7]."""
    c = _Chain()
    for j in range(0, 8, 2):
        e[j] = c.op(e[j] + _lo(x[j], b), j > 0, True)
        e[j + 1] = c.op(e[j + 1] + _hi(x[j], b), True, True)
    o[7] = c.op(o[7], True, False)


def _mac_odd(o, x, b):
    """`eo::mac_odd`: o += x_odd * b one limb down; the last carry dropped."""
    c = _Chain()
    for j in range(1, 8, 2):
        o[j - 1] = c.op(o[j - 1] + _lo(x[j], b), j > 1, True)
        o[j] = c.op(o[j] + _hi(x[j], b), True, j < 7)


def _shift_mac_odd(e, o, x, b):
    """`eo::shift_mac_odd`: e[0] += o[1]; o <- (o >> 64) + x_odd * b."""
    c = _Chain()
    e[0] = c.op(e[0] + o[1], False, True)
    for j in range(0, 8, 2):
        n0 = o[j + 2] if j + 2 < 8 else 0
        n1 = o[j + 3] if j + 3 < 8 else 0
        o[j] = c.op(_lo(x[j + 1], b) + n0, True, True)
        o[j + 1] = c.op(_hi(x[j + 1], b) + n1, True, j < 6)


def mont_mul_eo(a: list[int], b: list[int]) -> list[int]:
    """`mont_mul` of csrc/field.cuh, word by word."""
    e, o = [0] * 8, [0] * 8
    er, orr = e, o
    for i in range(8):
        if i == 0:
            for j in range(0, 8, 2):
                er[j], er[j + 1] = _lo(a[j], b[0]), _hi(a[j], b[0])
                orr[j], orr[j + 1] = _lo(a[j + 1], b[0]), _hi(a[j + 1], b[0])
        else:
            er, orr = orr, er  # the roles swap every step
            _shift_mac_odd(er, orr, a, b[i])
            _mac_even(er, orr, a, b[i])
        m = (er[0] * NINV32) & M32
        _mac_odd(orr, P_LIMBS, m)
        _mac_even(er, orr, P_LIMBS, m)
        assert er[0] == 0
    c = _Chain()  # e + (o >> 32); after eight steps er is o, orr is e
    r = [c.op(orr[k] + er[k + 1], k > 0, True) for k in range(7)]
    r.append(c.op(orr[7], True, False))
    v = _int(r)
    assert v < 2 * P
    return _limbs(v - P if v >= P else v)


@pytest.mark.parametrize("x", EDGES, ids=[f"a{i}" for i in range(len(EDGES))])
def test_eo_multiply_model_edges(x):
    rnd = random.Random(x % 1000)
    for y in EDGES + [rnd.randrange(P) for _ in range(8)]:
        assert _int(mont_mul_eo(_limbs(x), _limbs(y))) == x * y * R_INV % P


def test_eo_multiply_model_random_and_by_one():
    """Random operands; and b = 1 with any a < 2^256, the transcript's
    reduction of a wide sum (`csrc/transcript.cu`)."""
    rnd = random.Random(5)
    for _ in range(200):
        x, y = rnd.randrange(P), rnd.randrange(P)
        assert _int(mont_mul_eo(_limbs(x), _limbs(y))) == x * y * R_INV % P
    for x in [(1 << 256) - 1, (1 << 256) - 2, P, 2 * P - 1, 1 << 255] + [
            rnd.randrange(1 << 256) for _ in range(50)]:
        assert _int(mont_mul_eo(_limbs(x), _limbs(1))) == x * R_INV % P


def test_eo_multiply_model_matches_limbs_torch():
    gen = np.random.default_rng(9)
    a = gen.integers(0, 1 << 16, size=(16, 24), dtype=np.int64)
    b = gen.integers(0, 1 << 16, size=(16, 24), dtype=np.int64)
    a[15] >>= 2
    b[15] >>= 2
    want = LT.mont_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for k in range(24):
        x = sum(int(a[i, k]) << (16 * i) for i in range(16))
        y = sum(int(b[i, k]) << (16 * i) for i in range(16))
        got = _int(mont_mul_eo(_limbs(x), _limbs(y)))
        assert got == sum(int(want[i, k]) << (16 * i) for i in range(16))


# ---------------------------------------------------------------------------
# round_mxu.cu: the fold multiply in the quad layout
# ---------------------------------------------------------------------------

THREADS = [(ln >> 2, ln & 3) for ln in range(32)]  # (g, t) of each thread
M64 = (1 << 64) - 1


def out_digit(nt: int, c: int) -> int:
    """The product digit of output column c of n-tile nt."""
    return 8 * (c >> 1) + 2 * nt + (c & 1)


def k_digit(k: int) -> int:
    """The operand digit of k index k (the kernel's A order)."""
    return 8 * ((k % 16) // 4) + (k % 4) + (4 if k >= 16 else 0)


def _bytes(v: int) -> list[int]:
    return [(v >> (8 * i)) & 0xFF for i in range(32)]


def matrix_rows(r: int) -> list[int]:
    """M_j = r 2^(8 j + 16) 2^-256 mod p: `mont_mul` of r by the launch
    parameter 2^(8 j + 16) mod p (`fold_mxu_kernel`'s prologue)."""
    return [_int(mont_mul_eo(_limbs(r), _limbs((1 << (8 * j + 16)) % P))) for j in range(32)]


def load_matrix(r: int) -> list:
    """`load_matrix`: each thread's B fragments, b[nt][h] = bytes n of M_j
    for j = 8t + 4h + i, i = 0..3, n the digit of column g."""
    mat = [_bytes(m) for m in matrix_rows(r)]
    return [[tuple(sum(mat[8 * t + 4 * h + i][out_digit(nt, g)] << (8 * i) for i in range(4))
                   for h in range(2)) for nt in range(4)] for g, t in THREADS]


def mma(a_regs, b_regs, c_regs):
    """`mma.sync.m16n8k32.row.col.s32.u8.u8.s32` over the warp's fragments
    (each a list of 32 per-thread register tuples), by the PTX ISA's
    layouts; returns the D fragments."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    C = np.zeros((16, 8), np.int64)
    for ln, (g, t) in enumerate(THREADS):
        a0, a1, a2, a3 = a_regs[ln]
        b0, b1 = b_regs[ln]
        for b in range(4):
            A[g, 4 * t + b] = (a0 >> (8 * b)) & 0xFF
            A[g + 8, 4 * t + b] = (a1 >> (8 * b)) & 0xFF
            A[g, 16 + 4 * t + b] = (a2 >> (8 * b)) & 0xFF
            A[g + 8, 16 + 4 * t + b] = (a3 >> (8 * b)) & 0xFF
            B[4 * t + b, g] = (b0 >> (8 * b)) & 0xFF
            B[16 + 4 * t + b, g] = (b1 >> (8 * b)) & 0xFF
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = c_regs[ln]
    D = A @ B + C
    assert D.max() < 1 << 21  # a column of 32 byte products: the s32 accumulator holds it
    return [(int(D[g, 2 * t]), int(D[g, 2 * t + 1]), int(D[g + 8, 2 * t]),
             int(D[g + 8, 2 * t + 1])) for g, t in THREADS]


def column_word(acc_ln, row: int):
    """`column_word` of one thread: acc_ln[nt] its D fragments; returns
    (word, top), top < 2^14."""
    w0 = w1 = 0
    for q in range(4):
        c0, c1 = acc_ln[q][2 * row], acc_ln[q][2 * row + 1]
        if q < 2:
            w0 += (c0 << (16 * q)) + (c1 << (16 * q + 8))
        else:
            w1 += (c0 << (16 * q - 32)) + (c1 << (16 * q - 24))
    w1 += w0 >> 32
    assert w1 >> 32 < 1 << 14
    return ((w1 << 32) | (w0 & M32)) & M64, w1 >> 32


def _up(vals):
    """`__shfl_up_sync(.., 1, 4)`: thread t gets t - 1's value (t = 0 its own)."""
    return [vals[ln - 1] if ln & 3 else vals[ln] for ln in range(32)]


def _down(vals):
    """`__shfl_down_sync(.., 1, 4)`: thread t gets t + 1's value (t = 3 its own)."""
    return [vals[ln + 1] if ln & 3 != 3 else vals[ln] for ln in range(32)]


def _ballot(flags) -> int:
    return sum(1 << ln for ln, f in enumerate(flags) if f)


def quad_normalize(parts):
    """`quad_normalize` for every thread: parts[ln] = (word, top); returns
    (strict words, carries) with the value >> 256 in thread 3's carry."""
    tin = [0 if ln & 3 == 0 else v for ln, v in enumerate(_up([tp for _, tp in parts]))]
    word = [w + i for (w, _), i in zip(parts, tin)]
    gen = _ballot([w > M64 for w in word])
    word = [w & M64 for w in word]
    prop = _ballot([w == M64 for w in word])
    out, over = [], []
    for ln in range(32):
        g4 = (gen >> (ln & ~3)) & 0xF
        a4 = g4 | ((prop >> (ln & ~3)) & 0xF)
        out.append((word[ln] + ((((a4 + g4) ^ a4 ^ g4) >> (ln & 3)) & 1)) & M64)
        over.append(parts[ln][1] + ((a4 + g4) >> 4))
    return out, over


def mxu_tile(x, b):
    """`mxu_tile` for one warp: x[ln] = ((limb 2t, 2t+1) of row g, (limb 2t,
    2t+1) of row g+8); returns the result limbs in the same layout (< 2p).
    Checks on the way that V + m p is a multiple of 2^16 and W < 2p."""
    zero = [(0, 0, 0, 0)] * 32
    a = [(x[ln][0][0], x[ln][1][0], x[ln][0][1], x[ln][1][1]) for ln in range(32)]
    frags = [mma(a, [b[ln][nt] for ln in range(32)], zero) for nt in range(4)]
    acc = [[frags[nt][ln] for nt in range(4)] for ln in range(32)]
    res = []
    for row in (0, 1):
        parts = [column_word(acc[ln], row) for ln in range(32)]
        m_own = [((w & M32) * NINV32) & 0xFFFF for w, _ in parts]
        m = [m_own[ln & ~3] for ln in range(32)]  # __shfl_sync(.., 0, 4)
        summed = []
        for ln, ((w, tp), mm) in enumerate(zip(parts, m)):
            t = ln & 3
            p_lo, p_hi = P_LIMBS[2 * t], P_LIMBS[2 * t + 1]
            lo_part, hi_part = mm * p_lo, mm * p_hi
            mp = (lo_part + (hi_part << 32)) & M64
            w2 = (w + mp) & M64
            tp += (hi_part >> 32) + (1 if mp < lo_part else 0) + (1 if w2 < mp else 0)
            summed.append((w2, tp))
        words, over = quad_normalize(summed)
        above = _down([w & M32 for w in words])
        above = [over[ln] if ln & 3 == 3 else above[ln] for ln in range(32)]
        out = []
        for ln in range(32):
            if ln & 3 == 0:
                assert words[ln] & 0xFFFF == 0  # V + m p == 0 mod 2^16
            if ln & 3 == 3:
                assert over[ln] < 1 << 16
            w = (words[ln] >> 16) | ((above[ln] & 0xFFFF) << 48)
            out.append((w & M32, w >> 32))
        res.append(out)
    return [(res[0][ln], res[1][ln]) for ln in range(32)]


def mont_mul_mxu(a_vals: list[int], r: int) -> list[int]:
    """`mont_mul_mxu` over a warp's 32 lanes: the exchange into two tiles of
    16, `mxu_tile` on each, back to a lane per thread, `cond_sub_p`."""
    b = load_matrix(r)
    limbs = [_limbs(v) for v in a_vals]
    out = [[0] * 8 for _ in range(32)]
    for h in range(2):
        x = [((limbs[16 * h + g][2 * t], limbs[16 * h + g][2 * t + 1]),
              (limbs[16 * h + 8 + g][2 * t], limbs[16 * h + 8 + g][2 * t + 1]))
             for g, t in THREADS]
        res = mxu_tile(x, b)
        for ln, (g, t) in enumerate(THREADS):
            for row in (0, 1):
                lane = 16 * h + 8 * row + g
                out[lane][2 * t], out[lane][2 * t + 1] = res[ln][row]
    vals = []
    for lane in range(32):
        v = _int(out[lane])
        assert v < 2 * P
        vals.append(v - P if v >= P else v)
    return vals


def test_mxu_layout_covers_each_digit_once():
    """The permuted orders are bijections: the four n-tiles' columns are the
    32 digits once each, thread t holds digits 8t..8t+7, and the k order
    takes limbs 2t, 2t+1 to thread t."""
    cols = sorted(out_digit(nt, c) for nt in range(4) for c in range(8))
    assert cols == list(range(32))
    for t in range(4):
        mine = sorted(out_digit(nt, c) for nt in range(4) for c in (2 * t, 2 * t + 1))
        assert mine == list(range(8 * t, 8 * t + 8))
        assert [k_digit(4 * t + b) for b in range(4)] == list(range(8 * t, 8 * t + 4))
        assert [k_digit(16 + 4 * t + b) for b in range(4)] == list(range(8 * t + 4, 8 * t + 8))
    assert sorted(k_digit(k) for k in range(32)) == list(range(32))


def test_matrix_rows_make_the_product():
    """sum_j a8[j] M_j is a r 2^16 2^-256 mod p, and below 2^13 p."""
    rnd = random.Random(3)
    for r in (0, 1, P - 1, rnd.randrange(P)):
        rows = matrix_rows(r)
        assert rows == [r * (1 << (8 * j + 16)) * R_INV % P for j in range(32)]
        for a in (0, 1, P - 1, (1 << 255) % P, rnd.randrange(P)):
            v = sum(b * m for b, m in zip(_bytes(a), rows))
            assert v % P == a * r * (1 << 16) * R_INV % P and v < (1 << 13) * P


@pytest.mark.parametrize("r", [None, 0, 1, P - 1], ids=["random", "0", "1", "p-1"])
def test_mxu_quad_model_matches_banded_and_cios(r):
    """The quad-layout model against `mxu_mul.mont_mul_scalar_mxu` (the
    kernel's plain version) and `limbs_torch.mont_mul`, 32 lanes holding
    the edge operands and random ones, for edge challenges."""
    rnd = random.Random(17)
    r = rnd.randrange(P) if r is None else r
    a = (EDGES + [rnd.randrange(P) for _ in range(32)])[:32]
    got = mont_mul_mxu(a, r)
    assert got == [x * r * R_INV % P for x in a]
    a_d = torch.from_numpy(L.from_ints(a, mont=False).astype(np.int64))
    r_d = torch.from_numpy(L.from_ints([r], mont=False)[:, 0].astype(np.int64))
    want = TM.mont_mul_scalar_mxu(a_d, r_d)
    assert torch.equal(want, LT.mont_mul(a_d, r_d[:, None]))
    assert L.to_ints(want.numpy().astype(np.uint32), mont=False) == got


def test_mxu_quad_model_at_the_largest_columns():
    """Operands whose bytes are all large (p - 1 and its neighbours) by
    challenges whose matrix rows are near p: the largest columns, tops and
    carries the kernel can meet."""
    rnd = random.Random(23)
    a = [P - 1 - i for i in range(16)] + [(1 << 254) - 1 - i for i in range(16)]
    for r in (P - 1, P - 2, (1 << 254) % P):
        assert mont_mul_mxu(a, r) == [x * r * R_INV % P for x in a]
    a = [rnd.randrange(P) for _ in range(32)]
    assert mont_mul_mxu(a, 1) == [x * R_INV % P for x in a]


def _parts_of(words, tops):
    """Each thread's (word, top) for a quad value given per thread t."""
    return [(words[ln & 3], tops[ln & 3]) for ln in range(32)]


@pytest.mark.parametrize("words,tops", [
    ((0, M64, M64, 7), (5, 0, 0, 0)),
    ((M32 << 32 | (M32 - 4), M64, 9, 0), (1, 0, 0, 3)),
    ((M64,) * 4, (0, 0, 0, 0)),
    ((M64 - 1, M64, M64, M64), (2, 0, 0, 0)),
    ((M64, M64, M64, M64), (1, 0, 0, 9)),
    ((0, 0, 0, 0), (0, 0, 0, 0)),
], ids=["carry-through-two", "overflow-then-ones", "all-ones", "ripple-to-the-top",
        "ripple-out", "zero"])
def test_quad_normalize_carries_through_all_ones_words(words, tops):
    """A carry into words that are all ones moves on through every one of
    them, by the ballots' 4-bit sum: each thread's word equals the exact
    integer's mod 2^256, and thread 3's carry is the value >> 256."""
    value = sum((w + (tp << 64)) << (64 * t) for t, (w, tp) in enumerate(zip(words, tops)))
    got, over = quad_normalize(_parts_of(words, tops))
    for ln in range(32):
        assert got[ln] == (value >> (64 * (ln & 3))) & M64
        if ln & 3 == 3:
            assert over[ln] == value >> 256


# ---------------------------------------------------------------------------
# round.cu: the register evaluation of round 0
# ---------------------------------------------------------------------------


def _extend(acc: list[int], k: int, d: int) -> None:
    """`extend<K, D>`: acc[0..k] of a degree-k polynomial -> acc[k+1..d] by
    backward differences, mod p."""
    dt = [acc[k - i] for i in range(k + 1)]
    for j in range(1, k + 1):
        for i in range(k, j - 1, -1):
            dt[i] = (dt[i - 1] - dt[i]) % P
    for t in range(k + 1, d + 1):
        for j in range(k - 1, -1, -1):
            dt[j] = (dt[j] + dt[j + 1]) % P
        acc[t] = dt[0]


def register_eval(e, o, products, degree: int, coeffs=None, count=None) -> list[int]:
    """`nofold_kernel`'s evaluation of one lane: e[s], o[s] the slots'
    values (Montgomery form, as ints); returns total(t), t = 0..degree.
    `count`, a list, gets one entry per multiply."""
    def mul(x, y):
        if count is not None:
            count.append(1)
        return x * y * R_INV % P

    total = [0] * (degree + 1)
    factors = len(products[0])
    for p, idx in enumerate(products):
        acc = [0] * (degree + 1)
        known = degree
        for l, s in enumerate(idx):
            v, step = e[s], (o[s] - e[s]) % P
            if l == 0:
                if coeffs is not None:
                    v, step = mul(coeffs[p], v), mul(coeffs[p], step)
                for t in range(degree + 1):
                    acc[t] = (v + t * step) % P
                continue
            need = degree if l + 1 == factors else min(l + 1, degree)
            if need > known:
                assert known == l
                _extend(acc, known, degree)
            for t in range(need + 1):
                acc[t] = mul(acc[t], (v + t * step) % P)
            known = need
        total = [(a + b) % P for a, b in zip(total, acc)]
    return total


def _limb_pair(vals, half: int, width: int):
    """Slot values (Montgomery form, as ints), 2 x half lanes each -> the
    (U, 8, width) limb pair whose first `half` lanes hold them."""
    def block(part):
        d = np.stack([L.from_ints(v[part] + [0] * (width - half), mont=False) for v in vals])
        return torch.from_numpy(L.pack_limbs(d, axis=1))

    return block(slice(0, half)), block(slice(half, 2 * half))


def _digit_sums(totals: list[list[int]], degree: int) -> torch.Tensor:
    out = torch.zeros((degree + 1, 16), dtype=torch.int64)
    for tot in totals:
        for t, v in enumerate(tot):
            for i in range(16):
                out[t, i] += (v >> (16 * i)) & 0xFFFF
    return out


@pytest.mark.parametrize("degree", range(1, 9))
@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
def test_register_eval_model_matches_ladder(degree, coeffs):
    """The register evaluation with differences against the ladder's plain
    version, at every degree 1-8, with products of 1 to 8 factors (padded to
    one length, as the plans are), with and without coefficients."""
    rnd = random.Random(100 * degree + coeffs)
    slots, lanes = 9, 6
    factors = min(8, max(1, degree + rnd.choice([-1, 0, 0, 1])))
    products = [tuple(rnd.randrange(slots) for _ in range(factors)) for _ in range(3)]
    vals = [[rnd.randrange(P) for _ in range(2 * lanes)] for _ in range(slots)]
    vals[0][:4] = [0, 1, P - 1, (1 << 255) % P]
    lo, hi = _limb_pair(vals, lanes, lanes)
    cs = [rnd.randrange(P) for _ in products] if coeffs else None
    totals = [register_eval([v[k] for v in vals], [v[lanes + k] for v in vals],
                            products, degree, cs) for k in range(lanes)]
    if coeffs:
        c = torch.from_numpy(L.from_ints(cs, mont=False).T.astype(np.int32).copy())
        want = RC.round_step_nofold_ref(lo, hi, products, degree, c)
    else:
        want = RC.round_nofold_ref(lo, hi, products, degree, lanes)
    assert torch.equal(_digit_sums(totals, degree), want)


@pytest.mark.parametrize("degree", range(1, 5))
def test_fold_body_model_matches_plain_fold(degree):
    """`fold_kernel`'s data flow for one round, lane by lane: each slot
    folded once by r (E from lanes k, O from k + A), the ladder's (E, O - E)
    then read by the register evaluation, at every degree up to
    kMaxRegisterDegree; against the in-place fold's plain version
    (`round_cuda.round_fold_ref`): the folded lanes and the sums."""
    rnd = random.Random(700 + degree)
    slots, extent = 7, 5
    factors = max(1, degree - rnd.choice([0, 1]))
    products = [tuple(rnd.randrange(slots) for _ in range(factors)) for _ in range(3)]
    vals = [[rnd.randrange(P) for _ in range(4 * extent)] for _ in range(slots)]
    vals[1][:3] = [0, P - 1, 1]
    r = rnd.randrange(P)

    def fold(x, y):
        return (x + (y - x) * r * R_INV) % P

    es, os_ = [], []
    for k in range(extent):
        es.append([fold(v[k], v[2 * extent + k]) for v in vals])
        os_.append([fold(v[extent + k], v[3 * extent + k]) for v in vals])
    totals = [register_eval(es[k], os_[k], products, degree) for k in range(extent)]
    lo, hi = _limb_pair(vals, 2 * extent, 2 * extent)
    r_digits = torch.from_numpy(L.from_ints([r], mont=False)[:, 0].astype(np.int32))
    want = RC.round_fold_ref(lo, hi, r_digits, products, degree, extent)
    assert torch.equal(_digit_sums(totals, degree), want)
    got_lo = [L.to_ints(L.unpack_limbs(lo[u].numpy())[:, :extent], mont=False)
              for u in range(slots)]
    assert got_lo == [[es[k][u] for k in range(extent)] for u in range(slots)]


@pytest.mark.parametrize("factors", range(2, 9))
def test_register_eval_multiplies_fewer(factors):
    """At degree = factors the schedule multiplies sum_{l=2..F} (l + 1)
    times a product, against the ladder's (F - 1)(F + 1): 7 against 8 at 3
    factors, the 2x3 prove's plan; the same values."""
    rnd = random.Random(factors)
    e = [rnd.randrange(P) for _ in range(factors)]
    o = [rnd.randrange(P) for _ in range(factors)]
    count = []
    got = register_eval(e, o, [tuple(range(factors))], factors, count=count)
    assert len(count) == sum(l + 1 for l in range(2, factors + 1))
    assert len(count) < (factors - 1) * (factors + 1) or factors == 2
    want = []
    for t in range(factors + 1):
        v = (e[0] + t * (o[0] - e[0])) % P
        for s in range(1, factors):
            v = v * ((e[s] + t * (o[s] - e[s])) % P) * R_INV % P
        want.append(v)
    assert got == want


# ---------------------------------------------------------------------------
# round_common.cuh: the wide route's chunked evaluation
# ---------------------------------------------------------------------------

ONE = (1 << 256) % P  # the Montgomery one: every lane of the pair's ones slot


def extend_to(acc: list[int], k: int, m: int) -> None:
    """`extend_to<kT>`: acc[0..k] of a degree-k polynomial -> acc[k+1..m],
    in place: the forward differences at 0, zeros past the k-th, then back
    to values, mod p."""
    for j in range(1, k + 1):
        for i in range(k, j - 1, -1):
            acc[i] = (acc[i] - acc[i - 1]) % P
    for i in range(k + 1, m + 1):
        acc[i] = 0
    for j in range(k + 1, 0, -1):
        for i in range(j, m + 1):
            acc[i] = (acc[i] + acc[i - 1]) % P


def chunk_eval(e, o, products, degree: int, T: int, coeffs=None, count=None) -> list[int]:
    """`wide_block_sums<T>` for one lane, in the kernel's order: e[s], o[s]
    the slots' values (Montgomery form, as ints), `products` the plan's
    rows (a `round_cuda.Products` names its padding slot, which is never
    read: each row's real factors as `round_cuda._wide_idx` orders them);
    returns total(t), t = 0..degree. `count`, a list, gets one entry per
    multiply."""
    def mul(x, y):
        if count is not None:
            count.append(1)
        return x * y * R_INV % P

    ones = getattr(products, "ones", None)
    rows = [[s for s in ix if s != ones] for ix in products]
    lengths = RC.product_lengths(products)
    total, tm = [], 0  # tm: t0 * one, the chunk's first point
    for t0 in range(0, degree + 1, T):
        n = min(T, degree + 1 - t0)
        tot = [0] * n
        for p, (row, length) in enumerate(zip(rows, lengths)):
            acc, known, l = [0] * T, 0, 0
            while True:
                need = min(l + 1, n - 1) if l < length else n - 1
                if l > 0 and need > known:
                    extend_to(acc, known, need)
                if l == length:
                    break
                s = row[l] if row else ones
                v, step = e[s], (o[s] - e[s]) % P
                if t0 > 0:
                    v = (v + mul(step, tm)) % P
                if l == 0:
                    if coeffs is not None:
                        v, step = mul(coeffs[p], v), mul(coeffs[p], step)
                    for i in range(n):
                        v = (v + step) % P if i else v
                        acc[i] = v
                    known = n - 1
                else:
                    for i in range(need + 1):
                        v = (v + step) % P if i else v
                        acc[i] = mul(acc[i], v)
                    known = need
                l += 1
            tot = [(a + b) % P for a, b in zip(tot, acc)]
        total += tot
        if t0 + T <= degree:
            for _ in range(T):
                tm = (tm + ONE) % P
    return total


def direct_eval(e, o, products, degree: int, coeffs=None) -> list[int]:
    """total(t) in Python integers, every factor of every product (the
    padding slot too) at every point."""
    out = []
    for t in range(degree + 1):
        tot = 0
        for p, ix in enumerate(products):
            v = coeffs[p] if coeffs is not None else ONE
            for s in ix:
                v = v * ((e[s] + t * (o[s] - e[s])) % P) * R_INV % P
            tot += v
        out.append(tot % P)
    return out


def ragged_case(rnd, degree: int, products: int = 4, tables: int = 6):
    """A ragged structure of `degree`: products of 1..degree real factors
    (one of `degree`), padded with a ones slot after the tables
    (`Products`); the slots' values for `lanes` lanes, the ones slot's the
    Montgomery one."""
    lengths = [degree] + [rnd.randint(1, degree) for _ in range(products - 1)]
    rnd.shuffle(lengths)
    ones = tables
    rows = [[rnd.randrange(tables) for _ in range(n)] + [ones] * (degree - n) for n in lengths]
    return RC.Products(rows, ones if min(lengths) < degree else None), tables + 1


def _ones_pair(rnd, slots: int, ones, lanes: int, width: int):
    """Random slot values, 2 x lanes each, slot `ones` the Montgomery one;
    and the limb pair holding them."""
    vals = [[rnd.randrange(P) for _ in range(2 * lanes)] for _ in range(slots)]
    vals[0][:3] = [0, 1, P - 1]
    if ones is not None:
        vals[ones] = [ONE] * (2 * lanes)
    return vals, _limb_pair(vals, lanes, width)


def _coeff_digits(cs) -> torch.Tensor:
    return torch.from_numpy(L.from_ints(cs, mont=False).T.astype(np.int32).copy())


CHUNKS = (1, 2, 4, 8, 10, 12)


@pytest.mark.parametrize("T", CHUNKS)
@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
def test_chunk_model_matches_plain_at_chunk_boundaries(T, coeffs):
    """The chunked evaluation at d + 1 = T - 1, T, T + 1 and 2T + 1 (d >=
    1), ragged products padded with the ones slot, with and without
    coefficients: against the plain version (`round_nofold_ref`, or
    `round_step_nofold_ref` with coefficients) and Python integers."""
    rnd = random.Random(31 * T + coeffs)
    lanes = 3
    for degree in sorted({d for d in (T - 2, T - 1, T, 2 * T) if d >= 1}):
        products, slots = ragged_case(rnd, degree)
        vals, (lo, hi) = _ones_pair(rnd, slots, products.ones, lanes, lanes)
        cs = [rnd.randrange(P) for _ in products] if coeffs else None
        totals = []
        for k in range(lanes):
            e, o = [v[k] for v in vals], [v[lanes + k] for v in vals]
            totals.append(chunk_eval(e, o, products, degree, T, cs))
            assert totals[-1] == direct_eval(e, o, products, degree, cs), (degree, k)
        if coeffs:
            want = RC.round_step_nofold_ref(lo, hi, products, degree, _coeff_digits(cs))
        else:
            want = RC.round_nofold_ref(lo, hi, products, degree, lanes)
        assert torch.equal(_digit_sums(totals, degree), want), degree


@pytest.mark.parametrize("degree", range(1, 22))
def test_chunk_model_matches_plain_at_every_degree(degree):
    """At the kernels' chunk for each degree 1-21 (`round_cuda.wide_points`:
    4, 8, 10, then 12, two chunks past degree 11), ragged products with
    random coefficients: against the plain version."""
    rnd = random.Random(500 + degree)
    lanes, T = 2, RC.wide_points(degree)
    products, slots = ragged_case(rnd, degree, products=3)
    vals, (lo, hi) = _ones_pair(rnd, slots, products.ones, lanes, lanes)
    cs = [rnd.randrange(P) for _ in products]
    totals = [chunk_eval([v[k] for v in vals], [v[lanes + k] for v in vals], products, degree,
                         T, cs) for k in range(lanes)]
    want = RC.round_step_nofold_ref(lo, hi, products, degree, _coeff_digits(cs))
    assert torch.equal(_digit_sums(totals, degree), want)


@pytest.mark.parametrize("name", ["a", "b", "c", "tables18", "wide"])
def test_chunk_model_matches_plain_on_f4_structures(name):
    """F4's five structures (`tests/f4_cases.py`) through the pair the
    provers build (`init_pair`: scaled copies, the ones slot), at the
    kernels' chunk: round 0 over the pair, and one in-place fold by r
    (`wide_kernel<true>`: each slot folded, then the chunked evaluation
    over the folded values); sums and folded tables against the plain
    versions."""
    from f4_cases import f4_structure
    from sumcheck_tpu_torch.convert import polynomial_from_numpy
    from sumcheck_tpu_torch.protocol.device_prover import init_pair

    nv, prods, count = f4_structure(name)
    tabs = L.random_tables(np.random.default_rng(len(name)), nv, count)
    lo, hi, products, degree = init_pair(polynomial_from_numpy(nv, tabs, prods), "cpu")
    assert isinstance(products, RC.Products) and RC.route(lo.shape[0], products, degree) == "wide"
    slots, half = lo.shape[0], lo.shape[2]
    vals = [L.to_ints(np.concatenate([L.unpack_limbs(lo[u].numpy()),
                                      L.unpack_limbs(hi[u].numpy())], axis=1), mont=False)
            for u in range(slots)]
    T = RC.wide_points(degree)
    totals = [chunk_eval([v[k] for v in vals], [v[half + k] for v in vals], products, degree, T)
              for k in range(half)]
    assert torch.equal(_digit_sums(totals, degree),
                       RC.round_nofold_ref(lo, hi, products, degree, half))
    r = random.Random(name).randrange(P)
    extent = half // 2

    def fold(x, y):
        return (x + (y - x) * r * R_INV) % P

    es = [[fold(v[k], v[half + k]) for v in vals] for k in range(extent)]
    os_ = [[fold(v[extent + k], v[half + extent + k]) for v in vals] for k in range(extent)]
    totals = [chunk_eval(es[k], os_[k], products, degree, T) for k in range(extent)]
    r_digits = torch.from_numpy(L.from_ints([r], mont=False)[:, 0].astype(np.int32))
    want = RC.round_fold_ref(lo, hi, r_digits, products, degree, extent)
    assert torch.equal(_digit_sums(totals, degree), want)
    got_lo = [L.to_ints(L.unpack_limbs(lo[u].numpy())[:, :extent], mont=False)
              for u in range(slots)]
    assert got_lo == [[es[k][u] for k in range(extent)] for u in range(slots)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
def test_chunk_model_multiplies_equal_the_bound(coeffs):
    """Where one chunk holds the d + 1 points (every degree below 12 at the
    kernels' chunk), a lane's multiplies are `chip_smoke.eval_multiplies`,
    the register schedule on the real factors: none for the padding slot.
    Past one chunk, each later chunk adds the schedule over its own points
    and one multiply a factor for x(t0):
    sum over chunks c of sum_p [sum_{l=1}^{L_p-1} (min(l+1, n_c-1) + 1)
    + (2 with coefficients) + (L_p for c > 0)]."""
    smoke = _chip_smoke()
    rnd = random.Random(77 + coeffs)
    for degree in range(1, 25):
        products, slots = ragged_case(rnd, degree, products=5)
        e = [rnd.randrange(P) for _ in range(slots)]
        o = [rnd.randrange(P) for _ in range(slots)]
        cs = [rnd.randrange(P) for _ in products] if coeffs else None
        T = RC.wide_points(degree)
        count = []
        chunk_eval(e, o, products, degree, T, cs, count)
        lengths = RC.product_lengths(products)
        want = 0
        for t0 in range(0, degree + 1, T):
            n = min(T, degree + 1 - t0)
            want += sum(sum(min(l + 1, n - 1) + 1 for l in range(1, f)) + 2 * coeffs
                        + (f if t0 else 0) for f in lengths)
        assert len(count) == want, degree
        bound = smoke.eval_multiplies(products, degree, coeffs)
        if degree + 1 <= T:
            assert len(count) == bound, degree
        else:
            assert len(count) > bound, degree
        padded = smoke.eval_multiplies(tuple(products), degree, coeffs)
        assert bound < padded or products.ones is None, degree


# ---------------------------------------------------------------------------
# gkr_init.cu: the eq half tables and the fused weight reduce
# ---------------------------------------------------------------------------

GKR_TILE = GK.TILE  # the weight reduce's block: one thread an entry of a tile
ONE_M = (1 << 256) % P  # the Montgomery one
R2_M = pow(1 << 256, 2, P)


def _cond_sub_p(x: list[int]) -> list[int]:
    """field.cuh's cond_sub_p: x - p on one borrow chain, kept unless it
    borrowed out (any x < 2^256)."""
    d, borrow = [], 0
    for j in range(8):
        t = x[j] - P_LIMBS[j] - borrow
        borrow = 1 if t < 0 else 0
        d.append(t & M32)
    return x if borrow else d


def _add_mod(a: list[int], b: list[int]) -> list[int]:
    v = _int(a) + _int(b)
    assert v < 1 << 256  # a, b < p < 2^255: no carry out
    return _cond_sub_p(_limbs(v))


def _sub_mod(a: list[int], b: list[int]) -> list[int]:
    v = _int(a) - _int(b)
    return _limbs(v + P if v < 0 else v)


def eq_half_lane(points: list[int], t: int) -> list[int]:
    """One lane of a half table as a product over its variables, the
    factors by the kernels' word operations: the first factor copied, each
    next one multiplied in (1 - r by sub_mod from the one)."""
    acc = _limbs(ONE_M)
    for i, r in enumerate(points):
        ri = _limbs(r * (1 << 256) % P)
        x = ri if (t >> i) & 1 else _sub_mod(_limbs(ONE_M), ri)
        acc = x if i == 0 else mont_mul_eo(acc, x)
    return acc


def segment_finish(acc: list[int], subs: int) -> list[int]:
    """weight_reduce_kernel's `finish`, word by word: the carry pass of
    the 8 64-bit limb sums, `subs` conditional subtractions of the low 256
    bits, the word above them times 2^256 as mont_mul(high, R^2), and one
    add_mod."""
    lo, carry = [], 0
    for j in range(8):
        t = acc[j] + carry
        assert t < 1 << 64  # a 64-bit add
        lo.append(t & M32)
        carry = t >> 32
    assert carry < 1 << 32  # one 32-bit word above 2^256
    for _ in range(subs):
        lo = _cond_sub_p(lo)
    assert _int(lo) < P
    hi = mont_mul_eo(_limbs(carry), _limbs(R2_M))
    return _add_mod(lo, hi)


def block_sum(entries: list[list[int]], e0: int, e1: int) -> list[int]:
    """A chunk's 8 64-bit limb sums as the block forms them: thread t holds
    entry e0 + t (zeros past e1), each warp's partials folded by
    shuffle-down offsets 16..1, and thread 0 adding the warps'."""
    part = [list(entries[e0 + t]) if e0 + t < e1 else [0] * 8 for t in range(GKR_TILE)]
    warps = []
    for w0 in range(0, GKR_TILE, 32):
        lanes = [list(part[w0 + ln]) for ln in range(32)]
        off = 16
        while off:  # __shfl_down_sync: lane l adds lane l + off (a lane past 31 reads itself)
            lanes = [[a + (b if ln + off < 32 else 0) for a, b in
                      zip(lanes[ln], lanes[ln + off] if ln + off < 32 else lanes[ln])]
                     for ln in range(32)]
            off >>= 1
        warps.append(lanes[0])
    total = [0] * 8
    for wp in warps:
        total = [a + b for a, b in zip(total, wp)]
    return total


class Scratch:
    """The long segments' device scratch: 64-bit rows of 8 limb sums and
    32-bit arrival counters, zero between launches."""

    def __init__(self, rows: int):
        self.sums = [[0] * 8 for _ in range(rows)]
        self.arrived = [0] * rows

    def arrive(self, row: int, part: list[int], chunks: int):
        """One chunk's atomicAdds, the fence, its atomicAdd on the counter;
        the last to arrive (old count chunks - 1) reads and zeroes the row
        (atomicExch) and the counter: returns the row's sums then, else
        None."""
        for j in range(8):
            self.sums[row][j] += part[j]
            assert self.sums[row][j] < 1 << 64  # a 64-bit atomicAdd, no wrap
        old = self.arrived[row]
        self.arrived[row] += 1
        if old != chunks - 1:
            return None
        total, self.sums[row], self.arrived[row] = self.sums[row], [0] * 8, 0
        return total


def kernel_schedule(entries: list[list[int]], last: list[int], order_seed: int) -> list:
    """The 8 64-bit limb accumulators of every segment as weight_reduce_kernel
    forms them over `tile_plan`'s items, the items taken in a shuffled
    order (blocks run in no order): a tile's segments one thread each in
    series over the staged entries, a chunk's by `block_sum` and the
    scratch's last arrival. Every segment is emitted once; the scratch
    ends zero."""
    items, long = GK.tile_plan(np.array(last), len(entries))
    scratch = Scratch(long)
    out = [None] * len(last)
    order = list(range(len(items)))
    random.Random(order_seed).shuffle(order)
    for i in order:
        s0, count, e0, e1 = (int(v) for v in items[i])
        if count > 0:
            for s in range(s0, s0 + count):
                acc = [0] * 8
                for q in range(0 if s == 0 else last[s - 1] + 1, last[s] + 1):
                    assert e0 <= q < e1  # staged by this tile
                    acc = [a + x for a, x in zip(acc, entries[q])]
                assert out[s] is None
                out[s] = acc
            continue
        begin = 0 if s0 == 0 else last[s0 - 1] + 1
        chunks = -(-(last[s0] + 1 - begin) // GKR_TILE)
        done = scratch.arrive(-1 - count, block_sum(entries, e0, e1), chunks)
        if done is not None:
            assert out[s0] is None
            out[s0] = done
    assert all(o is not None for o in out)
    assert all(a == 0 for row in scratch.sums for a in row) and not any(scratch.arrived)
    return out


def test_segment_finish_model_worst_case():
    """2^24 entries of p - 1 in one segment (the asserted maximum; the
    64-bit accumulators below 2^56), and edge sums, reduce to their value
    mod p under the field's subtraction count."""
    from sumcheck_tpu_torch.fields.fr import REDUCE_SUBS

    worst = [(1 << 24) * x for x in _limbs(P - 1)]
    assert max(worst) < 1 << 56
    cases = [worst, [0] * 8, [M32] * 8, [(1 << 24) * M32] * 8,
             _limbs(P), _limbs(2 * P - 1) if 2 * P - 1 < 1 << 256 else _limbs(P + 1)]
    rnd = random.Random(24)
    cases += [[rnd.randrange(1 << 56) for _ in range(8)] for _ in range(40)]
    for acc in cases:
        value = sum(a << (32 * j) for j, a in enumerate(acc))
        assert _int(segment_finish(acc, REDUCE_SUBS)) == value % P


def test_long_segment_model_worst_case():
    """The chunked long-segment sum at the asserted maximum: one segment of
    2^24 entries of p - 1 (32,768 chunks of a tile), each chunk's block sum
    added into the 64-bit scratch row in a shuffled order of arrival, never
    past 2^64 (each limb below 2^56); the last arrival reads the whole sum
    and leaves the row and the counter zero, and the finish gives its value
    mod p."""
    from sumcheck_tpu_torch.fields.fr import REDUCE_SUBS

    n = 1 << 24
    chunks = n // GKR_TILE
    limbs = _limbs(P - 1)
    part = block_sum([limbs] * GKR_TILE, 0, GKR_TILE)
    assert part == [GKR_TILE * x for x in limbs]
    scratch = Scratch(2)
    done = None
    for i in range(chunks):
        got = scratch.arrive(1, part, chunks)
        assert (got is None) == (i < chunks - 1)
        done = got if got is not None else done
    assert done == [n * x for x in limbs] and max(done) < 1 << 56
    assert scratch.sums[1] == [0] * 8 and scratch.arrived == [0, 0]
    assert _int(segment_finish(done, REDUCE_SUBS)) == n * (P - 1) % P


@pytest.mark.parametrize("lengths", [[0, 1, 3, 0, 64], [513, 0, 2], [600, 1, 1100, 0, 512]],
                         ids=["short", "one_long", "two_long"])
def test_segment_schedule_model_matches_limb_sums(lengths):
    """The kernel's schedule over the tile plan (tiles one thread a
    segment, chunks of the long segments by block sums and the scratch's
    last arrival, items in a shuffled order) covers each sorted entry once
    and gives the plain version's limb sums (`gkr_init_cuda.limb_sums_ref`),
    and the finish gives its strict values."""
    from sumcheck_tpu_torch.fields.fr import REDUCE_SUBS

    rnd = random.Random(sum(lengths))
    nnz = sum(lengths)
    vals = [rnd.randrange(P) for _ in range(nnz)]
    last, pos = [], -1
    for n in lengths:
        pos += n
        last.append(pos)
    limbs = torch.from_numpy(np.ascontiguousarray(
        np.array([_limbs(v) for v in vals], dtype=np.uint32).reshape(nnz, 8).T).view(np.int32))
    sums = GK.limb_sums_ref(limbs, None, torch.tensor(last, dtype=torch.int32))
    strict = GK.finish_ref(sums)
    accs = kernel_schedule([_limbs(v) for v in vals], last, sum(lengths))
    for s, acc in enumerate(accs):
        assert acc == [int(x) for x in sums[:, s]]
        assert _int(segment_finish(acc, REDUCE_SUBS)) == \
            _int([int(x) & M32 for x in strict[:, s]])


def batched_schedule(plans: list, lasts: list, entries: list, half: int, resident: int,
                     order_seed: int) -> tuple[list, list, list]:
    """weight_reduce_batched_kernel's walk over B instances as
    `gkr_init_cuda.weight_reduce_batched` cuts them into launches
    (`batch_launches`, their instances' rows of the scratch in order) and
    each launch into blocks (`batch_blocks`, `slot_span`): block (x, b)
    with no item of instance b moves only its slot lanes, else its slot
    lanes and items x, x + blocks, ...; a tile's segments summed over the
    staged entries, a chunk's sum added into scratch row `row_b - 1 -
    item.y` with the last arrival emitting the segment. The launches run in
    order, the blocks of one in a shuffled order. `entries` are one integer
    each (limb 0 of a sum). Returns, per instance, how often each item was
    walked, how often each slot lane was moved, and each segment's sum as
    emitted (None if never)."""
    rows, long = [], 0
    for _items, n_long in plans:
        rows.append(long)
        long += n_long
    scratch = Scratch(long)
    walked = [[0] * len(items) for items, _n in plans]
    moved = [[0] * half for _ in plans]
    sums = [[None] * len(last) for last in lasts]
    rnd = random.Random(order_seed)
    for run in GK.batch_launches(len(plans)):
        top = max(len(plans[b][0]) for b in run)
        blocks = GK.batch_blocks(resident, len(run), top)
        order = [(x, b) for b in run for x in range(blocks)]
        rnd.shuffle(order)
        for x, b in order:
            begin, end = GK.slot_span(half, blocks, x)
            for k in range(begin, end):
                moved[b][k] += 1
            items, last = plans[b][0], lasts[b]
            for it in range(x, len(items), blocks):
                walked[b][it] += 1
                s0, count, e0, e1 = (int(v) for v in items[it])
                if count > 0:
                    for s in range(s0, s0 + count):
                        first = 0 if s == 0 else last[s - 1] + 1
                        assert e0 <= first and last[s] < e1 and sums[b][s] is None
                        sums[b][s] = sum(entries[b][first:last[s] + 1])
                    continue
                first = 0 if s0 == 0 else last[s0 - 1] + 1
                chunks = -(-(last[s0] + 1 - first) // GKR_TILE)
                part = [sum(entries[b][e0:e1])] + [0] * 7
                done = scratch.arrive(rows[b] - 1 - count, part, chunks)
                if done is not None:
                    assert sums[b][s0] is None
                    sums[b][s0] = done[0]
    assert all(a == 0 for row in scratch.sums for a in row) and not any(scratch.arrived)
    return walked, moved, sums


@pytest.mark.parametrize("resident", [264, 7], ids=["h100", "few_blocks"])
@pytest.mark.parametrize("batch", [1, 3, 8, GK.BATCH_CAP, GK.BATCH_CAP + 1, 300])
def test_batched_schedule_model_walks_everything_once(batch, resident):
    """The batched weight reduce's launches and blocks over B instances of
    different tile plans, every fifth with long segments (cut across
    blocks, on its own scratch rows): the instances go into the fewest
    launches that hold them (one up to BATCH_CAP, the instances a launch's
    parameters hold: 32,764 bytes less the constants and the shared shape,
    128 bytes an instance), in order, of sizes within one of each other;
    every item and every slot lane of every instance is walked exactly
    once, every segment is emitted once with its entries' sum, and the
    scratch ends zero. `resident` 264 is an H100's 132 SMs at 2 blocks
    each; 7 gives blocks several items each."""
    assert GK.BATCH_CAP == (32764 - 104 - 64) // 128
    runs = GK.batch_launches(batch)
    assert [b for run in runs for b in run] == list(range(batch))
    assert len(runs) == -(-batch // GK.BATCH_CAP) and (len(runs) == 1) == (batch <= GK.BATCH_CAP)
    assert max(map(len, runs)) <= GK.BATCH_CAP and max(map(len, runs)) - min(map(len, runs)) <= 1
    rnd = random.Random(batch * 1000 + resident)
    plans, lasts, entries = [], [], []
    for b in range(batch):
        lengths = [rnd.randrange(0, 40) for _ in range(rnd.randrange(1, 40))]
        if b % 5 == 1:
            lengths[rnd.randrange(len(lengths))] = rnd.randrange(GKR_TILE + 1, 3 * GKR_TILE)
            lengths.append(GKR_TILE + 1)
        last = (np.cumsum(lengths) - 1).tolist()
        nnz = sum(lengths)
        plans.append(GK.tile_plan(np.array(last), nnz))
        lasts.append(last)
        entries.append([rnd.randrange(1 << 32) for _ in range(nnz)])
    half = 1000
    walked, moved, sums = batched_schedule(plans, lasts, entries, half, resident, batch)
    assert all(w == [1] * len(p[0]) for w, p in zip(walked, plans))
    assert all(m == [1] * half for m in moved)
    for b in range(batch):
        last = lasts[b]
        want = [sum(entries[b][(0 if s == 0 else last[s - 1] + 1):last[s] + 1])
                for s in range(len(last))]
        assert sums[b] == want, b
    assert sum(p[1] for p in plans) == sum(1 for b in range(batch) if b % 5 == 1) * 2


def test_eq_half_tables_model_matches_eq_table():
    """The half tables' lanes as products (`eq_half_lane`), then
    weight_reduce_kernel's product
    eq_lo[idx & m] * eq_hi[idx >> kl] by the even/odd multiply, equal the
    plain eq table by doublings (`ops/gkr_init._eq_table`) at every index,
    for k = 1 to 6; and a weight's two multiplies and the f3 gather's third
    equal `gkr_init_cuda.weight_fold_ref`."""
    from sumcheck_tpu_torch.fields.fr import Fr
    from sumcheck_tpu_torch.ops import gkr_init as GI

    for k in range(1, 7):
        rnd = random.Random(k)
        pts = [rnd.randrange(P) for _ in range(k)]
        kl, kh = GK.halves(k)
        lo = [eq_half_lane(pts[:kl], t) for t in range(1 << kl)]
        hi = [eq_half_lane(pts[kl:], t) for t in range(1 << kh)]
        r_np, omr_np = GI._points_arrays([Fr(v) for v in pts])
        full = GI._eq_table(torch.from_numpy(r_np.astype(np.int64)),
                            torch.from_numpy(omr_np.astype(np.int64)), k).numpy()
        for j in range(1 << k):
            got = mont_mul_eo(lo[j & ((1 << kl) - 1)], hi[j >> kl])
            assert _int(got) == sum(int(full[i, j]) << (16 * i) for i in range(16))
    k, nnz = 5, 40
    rnd = random.Random(55)
    pts = [rnd.randrange(P) for _ in range(k)]
    kl, kh = GK.halves(k)
    halves = [eq_half_lane(pts[:kl], t) for t in range(1 << kl)] + \
        [eq_half_lane(pts[kl:], t) for t in range(1 << kh)]
    idx = [rnd.randrange(1 << k) for _ in range(nnz)]
    y = [rnd.randrange(1 << k) for _ in range(nnz)]
    vals = [_limbs(rnd.randrange(P)) for _ in range(nnz)]
    f3 = [_limbs(rnd.randrange(P)) for _ in range(1 << k)]

    def table(rows):
        return torch.from_numpy(np.ascontiguousarray(np.array(rows, dtype=np.uint32).T)
                                .view(np.int32))

    w, wv = GK.weight_fold_ref(torch.tensor(idx, dtype=torch.int32), table(vals), table(halves),
                               k, torch.tensor(y, dtype=torch.int32), table(f3))
    for j in range(nnz):
        a = mont_mul_eo(vals[j], halves[idx[j] & ((1 << kl) - 1)])
        a = mont_mul_eo(a, halves[(1 << kl) + (idx[j] >> kl)])
        assert a == [int(x) & M32 for x in w[:, j]]
        assert mont_mul_eo(a, f3[y[j]]) == [int(x) & M32 for x in wv[:, j]]


def build_eq_halves_model(points: list[int], kl: int, kh: int, threads: int = GKR_TILE):
    """weight_reduce_kernel's `build_eq_halves` as a block of `threads` runs
    it: threads 0 and 1 put the Montgomery one into lane 0 of each half;
    then level i < kl hands work item w < 2^i + (2^i if i < kh) to thread w
    mod threads (w < 2^i: the low half's lane w; else the high half's lane
    w - 2^i), which reads its lane x, writes x * r_i to the lane 2^i up and
    x - x * r_i back (r_i the low half's challenge i or the high half's kl +
    i); a __syncthreads ends each level. Asserts that within a level no
    lane is written twice and no thread reads a lane another writes.
    Returns the 2^kl + 2^kh lanes and, per level, the lanes each thread
    wrote."""
    nlo = 1 << kl
    lanes = [None] * (nlo + (1 << kh))
    lanes[0] = lanes[nlo] = _limbs(ONE_M)
    wrote = []
    for i in range(kl):
        n = 1 << i
        work = 2 * n if i < kh else n
        by_thread, new, read = {}, {}, {}
        for w in range(work):
            t = w % threads
            low = w < n
            at = w if low else nlo + w - n
            x = lanes[at]
            assert x is not None
            ri = _limbs(points[i if low else kl + i] * (1 << 256) % P)
            hi = mont_mul_eo(x, ri)
            for lane, v in ((at, _sub_mod(x, hi)), (at + n, hi)):
                assert lane not in new  # one writer a lane
                new[lane] = v
                by_thread.setdefault(t, []).append(lane)
            read[at] = t
        assert all(read.get(lane, t) == t for t, ls in by_thread.items() for lane in ls)
        for lane, v in new.items():
            lanes[lane] = v
        wrote.append(by_thread)
    assert all(v is not None for v in lanes)
    return lanes, wrote


@pytest.mark.parametrize("k", range(9))
def test_eq_halves_in_block_model_matches_eq_table(k):
    """The blocks' doubling build of both half tables (`build_eq_halves_model`:
    the level order, the lanes each thread writes, both halves side by side)
    equals the lanes as products (`eq_half_lane`) and, through eq_lo[j &
    m] * eq_hi[j >> kl], the plain eq table by doublings (`_eq_table`), for
    k = 0 to 8 (k = 0 and 1: an empty high half, the Montgomery one), also
    with 3 threads and with half a block (the table threads beside the slot's
    movers), each thread then several items a level; the
    multiplies are 2^kl + 2^kh - 2, one a new lane pair; and the wrapper's
    threshold: the blocks build for k <= 21, and `weight_reduce` refuses k
    >= 22."""
    from sumcheck_tpu_torch.fields.fr import Fr
    from sumcheck_tpu_torch.ops import gkr_init as GI

    rnd = random.Random(300 + k)
    pts = [rnd.randrange(P) for _ in range(k)]
    kl, kh = GK.halves(k)
    lanes, wrote = build_eq_halves_model(pts, kl, kh)
    assert len(wrote) == kl
    assert sum(len(ls) for by in wrote for ls in by.values()) == 2 * ((1 << kl) + (1 << kh) - 2)
    assert lanes == [eq_half_lane(pts[:kl], t) for t in range(1 << kl)] + \
        [eq_half_lane(pts[kl:], t) for t in range(1 << kh)]
    assert build_eq_halves_model(pts, kl, kh, threads=3)[0] == lanes
    assert build_eq_halves_model(pts, kl, kh, threads=GKR_TILE // 2)[0] == lanes
    if k:
        r_np, omr_np = GI._points_arrays([Fr(v) for v in pts])
        full = GI._eq_table(torch.from_numpy(r_np.astype(np.int64)),
                            torch.from_numpy(omr_np.astype(np.int64)), k).numpy()
        table = [sum(int(full[i, j]) << (16 * i) for i in range(16)) for j in range(1 << k)]
    else:  # the empty product
        table = [ONE_M]
    for j in range(1 << k):
        got = mont_mul_eo(lanes[j & ((1 << kl) - 1)], lanes[(1 << kl) + (j >> kl)])
        assert _int(got) == table[j]
    assert [GK.in_block(m) for m in range(48)] == [m <= 21 for m in range(48)]


SLOT_ORDERS = ("beside", "after", "before", "spread")


def plan_item(it: int, items: int, slots: int, order: str) -> tuple[bool, int]:
    """Work item `it` of a weight_reduce_kernel launch: (True, its plan
    item) or (False, its slot item). Beside the build (the committed
    kernel) the work list holds the plan's items alone; the work-list
    variants of `tools/gkr_init_variants.py` (its `plan_item`) put the slot
    items after the plan's, before them, or spread (slot item s at
    floor((2 s + 1) T / (2 S)), T = items + S), in C's integer
    arithmetic."""
    if order == "beside":
        return True, it
    if order == "after":
        return (True, it) if it < items else (False, it - items)
    if order == "before":
        return (False, it) if it < slots else (True, it - slots)
    total, q = items + slots, 2 * slots * it
    before = (int((q - 1) / total) + 1) // 2 if slots else 0  # C's / truncates
    slot = before < slots and (2 * before + 1) * total // (2 * slots) == it
    return (False, before) if slot else (True, it - before)


def launch_walk(last: list[int], entries: list[int], half: int, grid: int, order: str):
    """One launch's work over `tile_plan`'s items and the slot's
    ceil(half / kTile) items on at most `grid` persistent blocks (no more
    than the work list's items, as the launch sizes it), block b taking
    it = b, b + grid, ... and the blocks advancing a step each in turn:
    each tile's segments summed, each long segment's chunks into the
    scratch (`Scratch`, the last arrival emits), and thread t of slot item
    s moving lane s * kTile + t below `half`; beside the build, block b's
    last kTile / 2 threads move its slot items b, b + grid, ... first,
    thread t lanes s * kTile + t, + kTile / 2. Returns the segments' sums
    (each emitted once) and each lane's move count."""
    items, long = GK.tile_plan(np.array(last), len(entries))
    slots = -(-half // GKR_TILE)
    work = len(items) + (0 if order == "beside" else slots)
    grid = min(grid, work)
    walks = [list(range(b, work, grid)) for b in range(grid)]
    scratch, sums, moved = Scratch(long), [None] * len(last), [0] * half
    if order == "beside":
        movers = GKR_TILE // 2
        for b in range(grid):
            for s in range(b, slots, grid):
                for t in range(movers):
                    for k in range(s * GKR_TILE + t, min((s + 1) * GKR_TILE, half), movers):
                        moved[k] += 1
    for step in range(max(len(w) for w in walks)):
        for walk in walks:
            if step >= len(walk):
                continue
            is_plan, which = plan_item(walk[step], len(items), slots, order)
            if not is_plan:
                assert 0 <= which < slots
                for t in range(GKR_TILE):
                    if which * GKR_TILE + t < half:
                        moved[which * GKR_TILE + t] += 1
                continue
            s0, count, e0, e1 = (int(v) for v in items[which])
            if count > 0:
                for s in range(s0, s0 + count):
                    assert sums[s] is None
                    sums[s] = sum(entries[(last[s - 1] + 1 if s else 0):last[s] + 1])
                continue
            begin = last[s0 - 1] + 1 if s0 else 0
            chunks = -(-(last[s0] + 1 - begin) // GKR_TILE)
            done = scratch.arrive(-1 - count, [sum(entries[e0:e1])] + [0] * 7, chunks)
            if done is not None:
                assert sums[s0] is None
                sums[s0] = done[0]
    assert not any(scratch.arrived)
    return sums, moved


@pytest.mark.parametrize("order", SLOT_ORDERS)
@pytest.mark.parametrize("shape", ["dim5", "dim11", "skewed"])
def test_work_list_model_covers_segments_and_slot_lanes(shape, order):
    """The fused launch's work (the slot beside the build, the committed
    kernel's, or the slot's items in the work list, `plan_item`, as the
    variants tool builds it) over grids of 1, 3 and 264 blocks: every
    segment
    summed once, to its naive sum, and every lane of slot 1 moved once,
    where the half H is below a tile (dim 5: 16 lanes, 32 segments), a
    multiple of it (dim 11: 1,024 lanes) and with a skewed plan whose long
    segments are cut into chunks (2,048 segments, two of them longer than a
    tile); each order is a bijection of the work items."""
    rnd = random.Random(shape)
    dim = {"dim5": 5, "dim11": 11, "skewed": 11}[shape]
    nseg = 1 << dim
    lengths = [rnd.choice([0, 1, 2, 3, 5]) for _ in range(nseg)]
    if shape == "skewed":
        lengths[7], lengths[900] = 3 * GKR_TILE + 17, GKR_TILE + 1
    last = list(np.cumsum(lengths) - 1)
    entries = [rnd.randrange(1 << 30) for _ in range(sum(lengths))]
    items, _long = GK.tile_plan(np.array(last), len(entries))
    slots = 0 if order == "beside" else -(-(nseg // 2) // GKR_TILE)
    assert sorted(plan_item(it, len(items), slots, order) for it in range(len(items) + slots)) \
        == sorted([(True, i) for i in range(len(items))] + [(False, s) for s in range(slots)])
    want = [sum(entries[(last[s - 1] + 1 if s else 0):last[s] + 1]) for s in range(nseg)]
    for grid in (1, 3, 264):
        sums, moved = launch_walk(last, entries, nseg // 2, grid, order)
        assert sums == want and moved == [1] * (nseg // 2)


# ---------------------------------------------------------------------------
# every model above under the second prime
# ---------------------------------------------------------------------------

# BLS12-381's -p^-1 mod 2^32 is 0xFFFFFFFF, p's low limb 1 and the next
# 0xFFFFFFFF, so under it every Montgomery step has m = -t[0]; BN254's are
# 0xEFFFFFFF, 0xF0000001 and 0x43E1F593, so the even/odd carry chains and
# the MXU quad carries follow a multiply by ninv there. Both primes share
# -p^-1 mod 2^16 = 0xFFFF (the MXU fold's 16-bit step). The module reads
# its constants from `fields/fr.py` at import, so the models run under
# BN254 in one child pytest of this file with SUMCHECK_TPU_FIELD=bn254_fr.
MODEL_TESTS = sorted(n for n in list(globals()) if n.startswith("test_"))


@pytest.fixture(scope="module")
def bn254_outcomes(tmp_path_factory):
    from test_torch_field import child_outcomes

    return child_outcomes(__file__, tmp_path_factory.mktemp("bn254"), "not under_bn254")


@pytest.mark.parametrize("name", MODEL_TESTS)
def test_model_under_bn254(bn254_outcomes, name):
    """Every case of test `name` passed in the child under BN254 Fr."""
    from test_torch_field import outcomes_of

    cases = outcomes_of(bn254_outcomes, name)
    assert cases and set(cases.values()) == {"passed"}, cases
