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
  at degrees 1-8.

Tolerance 0 everywhere: exact integer arithmetic.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from sumcheck_tpu_torch.fields import limbs_np as L
from sumcheck_tpu_torch.fields import limbs_torch as LT
from sumcheck_tpu_torch.fields.fr import NINV32, NINV_FULL, P
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
