"""The port's limb arithmetic (`sumcheck_tpu_torch.fields.limbs_torch`)
against the JAX package's `limbs_jnp` (eager, CPU) and `limbs_np`.

Tolerance 0: exact field arithmetic, every comparison is array-equal.
Inputs: random values below p from `numpy.random.default_rng`, plus the
edge values 0, 1 and p-1 (and [p, 2p) for `cond_sub_p`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sumcheck_tpu.fields import limbs_jnp as LJ
from sumcheck_tpu.fields import limbs_np as LN
from sumcheck_tpu.fields.fr import P, R2
from sumcheck_tpu_torch.fields import limbs_np as PN
from sumcheck_tpu_torch.fields import limbs_torch as LT
from sumcheck_tpu_torch.fields.fr import P as P_PORT
from sumcheck_tpu_torch.fields.fr import WIDE_DIGITS

N = 96  # random lanes per operand
EDGES = [0, 1, 2, P - 1, P - 2]


def _digits(vals) -> np.ndarray:
    """Python ints -> (16, N) uint32 strict digits (no Montgomery step)."""
    return LN.from_ints(list(vals), mont=False)


def _operand(seed: int) -> np.ndarray:
    """Random values below p, then the edge values."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(16, N), dtype=np.uint32)
    d[15] >>= 2  # < 2^254 < p
    return np.concatenate([d, _digits(EDGES)], axis=1)


def _t(a: np.ndarray) -> torch.Tensor:
    return LT.from_numpy(a)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.uint32)
    return np.asarray(x)


def test_field_constants_match():
    assert P_PORT == P
    assert WIDE_DIGITS == LJ.WIDE_DIGITS


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops(op):
    a = _operand(1)
    b = np.roll(_operand(2), 3, axis=1)  # edge values meet random ones
    want = getattr(LN, op)(a, b)
    got = _np(getattr(LT, op)(_t(a), _t(b)))
    jax_got = np.asarray(getattr(LJ, op)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)


def test_mont_mul_broadcasts_a_scalar():
    a = _operand(3)
    s = _digits([P - 1])  # (16, 1)
    want = LN.mont_mul_scalar(a, s)
    np.testing.assert_array_equal(_np(LT.mont_mul(_t(a), _t(s))), want)
    np.testing.assert_array_equal(
        np.asarray(LJ.mont_mul(jnp.asarray(a), jnp.asarray(s))), want
    )


def test_mont_mul_const():
    a = _operand(4)
    r2 = tuple((R2 >> (16 * i)) & 0xFFFF for i in range(16))
    want = LN.mont_mul(a, np.broadcast_to(LN.from_int_scalar(R2), a.shape))
    np.testing.assert_array_equal(_np(LT.mont_mul_const(_t(a), r2)), want)
    np.testing.assert_array_equal(np.asarray(LJ.mont_mul_const(jnp.asarray(a), r2)), want)


def test_cond_sub_p():
    rng = np.random.default_rng(6)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=40)]
    ins = [0, 1, P - 1, P, P + 1, 2 * P - 1] + [P + v for v in vals] + vals
    a = _digits(ins)
    want = _digits([v % P for v in ins])
    np.testing.assert_array_equal(_np(LT.cond_sub_p(_t(a))), want)
    np.testing.assert_array_equal(np.asarray(LJ.cond_sub_p(jnp.asarray(a))), want)
    np.testing.assert_array_equal(PN.cond_sub_p(a), want)


@pytest.mark.parametrize("width", [17, WIDE_DIGITS, 32])
def test_reduce_wide(width):
    rng = np.random.default_rng(width)
    w = rng.integers(0, 1 << 16, size=(width, N), dtype=np.uint32)
    w[:, :3] = 0xFFFF  # all-ones wide values
    want = LN.reduce_wide(w)
    np.testing.assert_array_equal(_np(LT.reduce_wide(_t(w))), want)
    np.testing.assert_array_equal(np.asarray(LJ.reduce_wide(jnp.asarray(w))), want)


def test_sum_lanes_wide():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 1 << 16, size=(16, 5, 300), dtype=np.uint32)
    a[..., :7] = 0xFFFF
    want = LN.sum_lanes_wide(a, axis=2)
    np.testing.assert_array_equal(_np(LT.sum_lanes_wide(_t(a), axis=2)), want)
    np.testing.assert_array_equal(
        np.asarray(LJ.sum_lanes_wide(jnp.asarray(a), axis=2)), want
    )
    np.testing.assert_array_equal(PN.sum_lanes_wide(a, axis=2), want)


def test_chain():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 1 << 20, size=(WIDE_DIGITS, 64), dtype=np.uint32)
    j_rows, j_carry = LJ._chain([jnp.asarray(r) for r in rows])
    t_rows, t_carry = LT._chain(list(_t(rows)))
    np.testing.assert_array_equal(
        _np(torch.stack(t_rows)), np.stack([np.asarray(r) for r in j_rows])
    )
    np.testing.assert_array_equal(_np(t_carry), np.asarray(j_carry))


def test_wide_to_int():
    rng = np.random.default_rng(10)
    for _ in range(8):
        w = rng.integers(0, 1 << 24, size=WIDE_DIGITS, dtype=np.uint32)  # relaxed
        assert LT.wide_to_int(w) == LJ.wide_to_int(w)
        assert LT.wide_to_int(torch.from_numpy(w.astype(np.int64))) == LJ.wide_to_int(w)


def test_montgomery_roundtrip_matches_host_model():
    vals = EDGES + [12345, 1 << 200]
    m = LN.from_ints(vals)  # Montgomery form
    np.testing.assert_array_equal(PN.from_ints(vals), m)
    one = LN.from_int_scalar(1)
    canon = _np(LT.mont_mul(_t(m), _t(one)))  # * R^-1: canonical digits
    assert LN.to_ints(canon, mont=False) == [v % P for v in vals]


# ---------------------------------------------------------------------------
# the kernels' layout: 8 x 32-bit limbs in int32 words
# ---------------------------------------------------------------------------

PACK_CASES = ["random", "zero", "p-1", "ffff"]


def _pack_case(case: str) -> np.ndarray:
    """A (16, N) uint32 digit array as the JAX package holds it: random
    Montgomery values below p with the edges, zeros, p - 1 (canonical and
    in Montgomery form), and every digit 0xFFFF (all 256 bits set)."""
    if case == "random":
        return LN.from_ints([int(v) for v in np.random.default_rng(12).integers(0, 1 << 62, N)]
                            + EDGES)
    if case == "zero":
        return np.zeros((16, N), np.uint32)
    if case == "p-1":
        return np.concatenate([_digits([P - 1] * 4), LN.from_ints([P - 1] * 4)], axis=1)
    return np.full((16, N), 0xFFFF, np.uint32)


def _want_limbs(d: np.ndarray) -> np.ndarray:
    """The 8 limbs of each lane's integer, least significant first, as
    int32 bit patterns."""
    vals = [sum(int(d[i, k]) << (16 * i) for i in range(16)) for k in range(d.shape[1])]
    words = [[(v >> (32 * j)) & 0xFFFFFFFF for v in vals] for j in range(8)]
    return np.array(words, dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_limbs_matches_jax_digits(case):
    """`pack_limbs` (torch and NumPy) of the JAX package's digits: limb j
    holds bits 32j..32j+31 of the lane's integer."""
    d = _pack_case(case)
    want = _want_limbs(d)
    np.testing.assert_array_equal(PN.pack_limbs(d), want)
    got = LT.pack_limbs(_t(d))
    assert got.dtype == torch.int32 and got.shape == (8, d.shape[1]) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", PACK_CASES)
def test_unpack_limbs_gives_jax_digits(case):
    """`unpack_limbs` (torch and NumPy) of those limbs gives the JAX
    package's digit array back exactly, along any axis of a pair."""
    d = _pack_case(case)
    limbs = _want_limbs(d)
    np.testing.assert_array_equal(PN.unpack_limbs(limbs), d)
    np.testing.assert_array_equal(_np(LT.unpack_limbs(torch.from_numpy(limbs))), d)
    pair = np.stack([d, d[:, ::-1]])  # (U, 16, N), the pair's digit axis 1
    packed = LT.pack_limbs(_t(pair), dim=1)
    assert packed.shape == (2, 8, d.shape[1])
    np.testing.assert_array_equal(_np(LT.unpack_limbs(packed, dim=1)), pair)
    np.testing.assert_array_equal(PN.unpack_limbs(PN.pack_limbs(pair, axis=1), axis=1), pair)


def test_limb_round_trip():
    """Any int32 words round-trip through digits and back (torch and
    NumPy), negative bit patterns included."""
    words = np.random.default_rng(13).integers(-(1 << 31), 1 << 31, size=(3, 8, 40),
                                                dtype=np.int64).astype(np.int32)
    words[0, :, 0] = [-1, 0, -(1 << 31), (1 << 31) - 1, 1, -2, 65535, -65536]
    for axis in (1, -2):
        digits = PN.unpack_limbs(words, axis=axis)
        assert digits.shape == (3, 16, 40) and digits.max() <= 0xFFFF
        np.testing.assert_array_equal(PN.pack_limbs(digits, axis=axis), words)
        t = LT.unpack_limbs(torch.from_numpy(words), dim=axis)
        np.testing.assert_array_equal(_np(t), digits)
        np.testing.assert_array_equal(LT.pack_limbs(t, dim=axis).numpy(), words)


LIMB_TESTS = ["test_pack_limbs_matches_jax_digits", "test_unpack_limbs_gives_jax_digits",
              "test_limb_round_trip"]


@pytest.fixture(scope="module")
def bn254_limb_outcomes(tmp_path_factory):
    """The limb layout's tests in one child pytest under
    SUMCHECK_TPU_FIELD=bn254_fr (its p - 1 and Montgomery form)."""
    from test_torch_field import child_outcomes

    return child_outcomes(__file__, tmp_path_factory.mktemp("bn254"),
                          f"({' or '.join(LIMB_TESTS)}) and not under_bn254")


@pytest.mark.parametrize("name", LIMB_TESTS, ids=["pack", "unpack", "round_trip"])
def test_limb_layout_under_bn254(bn254_limb_outcomes, name):
    from test_torch_field import outcomes_of

    got = outcomes_of(bn254_limb_outcomes, name)
    assert got and all(v == "passed" for v in got.values()), got
