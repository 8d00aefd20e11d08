"""The per-size round step's plain versions (`ops/round_cuda.round_step_nofold_ref`,
`round_step_fold_ref`, and the wrappers on CPU tensors, which must take
them) against the JAX package: its per-size round step
`device_prover._kernel_step(..., use_pallas=False)` under jit, the host
engine `engine.round_sums` / `fold_tables` with and without per-product
coefficients, and (slow) the Pallas kernels `_kernel_nofold` /
`_kernel_fold` through `round_pallas(..., interpret=True)`.

Compared: the fresh folded tables, unpacked from the port's limbs to
digits, and the exact `(WIDE, d+1)` sums.
Tolerance 0. Inputs from `numpy.random.default_rng` / `random.Random`:

- "u3": U=3 (two tables and a ones slot), n=256, products (0,1), (1,0),
  degree 2 (the `tests/test_pallas_round.py` shape);
- "ragged": U=6 from `init_pair`: products of lengths 3 and 2 sharing a
  table, so a scaled copy and a ones slot, degree 3, n=64;
- "half1" / "half2": the last rounds, a pair of width 1 (no fold) and 2
  (fold into width 1), U=4, products (0,1), (2,1), degree 2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sumcheck_tpu.fields import limbs_np as LN
from sumcheck_tpu.protocol import device_prover as JD
from sumcheck_tpu.protocol import engine as JE
from sumcheck_tpu_torch.convert import polynomial_from_numpy
from sumcheck_tpu_torch.fields.fr import P
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.fields import limbs_torch as LT
from sumcheck_tpu_torch.protocol.device_prover import init_pair

R_VALUE = 0x1234_5678_9ABC_DEF0_1357_9BDF


def _tables(seed: int, count: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(count, 16, n), dtype=np.uint32)
    d[:, 15] >>= 2  # < 2^254 < p
    return d


def case(name: str):
    """(slots (U, 16, n) uint32, products, degree)."""
    if name == "u3":
        slots = _tables(1, 3, 256)
        slots[2] = LN.mont_scalar(1)  # ones slot
        return slots, ((0, 1), (1, 0)), 2
    if name == "ragged":
        tabs = list(_tables(2, 4, 64))
        poly = polynomial_from_numpy(6, tabs, [(11, [0, 1, 2]), (13, [0, 3])])
        lo, hi, products, degree = init_pair(poly, "cpu")
        assert lo.shape[0] == 6  # 4 tables, a scaled copy, a ones slot
        slots = _unpacked(torch.cat([lo, hi], dim=2))
        return slots, products, degree
    n = {"half1": 2, "half2": 4}[name]
    return _tables(3, 4, n), ((0, 1), (2, 1)), 2


def _pair(slots):
    """(U, 16, n) digit tables -> the port's (U, 8, n/2) limb pair."""
    half = slots.shape[2] // 2
    packed = LT.pack_limbs(torch.from_numpy(slots.astype(np.int64)), dim=1)
    return packed[:, :, :half].contiguous(), packed[:, :, half:].contiguous()


def _unpacked(t: torch.Tensor) -> np.ndarray:
    """A (U, 8, n) limb block -> its (U, 16, n) uint32 digits."""
    return LT.unpack_limbs(t, dim=1).numpy().astype(np.uint32)


def _r_digits():
    return LN.mont_scalar(R_VALUE % P)[:, 0]


def _coeffs(num: int) -> np.ndarray:
    """(P, 16) Montgomery digits of the coefficients 5, 9, 13, ..."""
    return np.stack([LN.mont_scalar(5 + 4 * p)[:, 0] for p in range(num)])


def port_step(slots, products, degree, fold, coeffs=None, fns=None):
    """Through the port: (pair | None, (WIDE, d+1) sums)."""
    nofold, fold_fn = fns or (RC.round_step_nofold_ref, RC.round_step_fold_ref)
    lo, hi = _pair(slots)
    lo0, hi0 = lo.clone(), hi.clone()
    c = None if coeffs is None else torch.from_numpy(coeffs.astype(np.int32))
    if fold:
        r = torch.from_numpy(_r_digits().astype(np.int32))
        (nlo, nhi), sums = fold_fn(lo, hi, r, products, degree, c)
        assert nlo.shape == (lo.shape[0], 8, lo.shape[2] // 2) and nlo.is_contiguous()
        pair = (_unpacked(nlo), _unpacked(nhi))
    else:
        sums = nofold(lo, hi, products, degree, c)
        pair = None
    assert torch.equal(lo, lo0) and torch.equal(hi, hi0)  # inputs untouched
    assert sums.shape == (degree + 1, 16) and sums.dtype == torch.int64
    return pair, RC.finish_sums(sums)


def host_step(slots, products, degree, fold, coeffs=None):
    """The JAX package's host engine on the same pair."""
    stacked = slots.transpose(1, 0, 2)  # (16, U, n)
    if fold:
        stacked = JE.fold_tables(JE.HOST, stacked, _r_digits()[:, None, None])
    coeff_cols = None if coeffs is None else coeffs.T[:, :, None, None]
    sums = JE.round_sums(JE.HOST, stacked, coeff_cols,
                         np.array(products, np.int32), degree)
    pair = None
    if fold:
        q = stacked.shape[2] // 2
        folded = stacked.transpose(1, 0, 2)
        pair = (folded[:, :, :q], folded[:, :, q:])
    return pair, np.asarray(sums)


def _assert_same(got, want):
    (gpair, gsums), (wpair, wsums) = got, want
    np.testing.assert_array_equal(gsums, wsums)
    if wpair is None:
        assert gpair is None
    else:
        np.testing.assert_array_equal(gpair[0], wpair[0])
        np.testing.assert_array_equal(gpair[1], wpair[1])


STEPS = [("u3", False), ("u3", True), ("ragged", False), ("ragged", True),
         ("half1", False), ("half2", True)]


@pytest.mark.parametrize("name,fold", [s for s in STEPS if s != ("ragged", False)])
def test_step_matches_jax_kernel_step(name, fold):
    """Against the JAX per-size round step (jnp path, jit). The ragged
    no-fold round is left to the host-engine test: each jit of the U=6
    structure costs half a minute of CPU compile."""
    slots, products, degree = case(name)
    half = slots.shape[2] // 2
    fn = JD._kernel_step(half, slots.shape[0], products, degree, fold,
                         use_pallas=False, block=256, interpret=False, donate=False)
    lo = jnp.asarray(slots[:, :, :half])
    hi = jnp.asarray(slots[:, :, half:])
    jpair, jsums = fn(lo, hi, jnp.asarray(_r_digits()))
    want = (None if jpair is None else (np.asarray(jpair[0]), np.asarray(jpair[1])),
            np.asarray(jsums))
    _assert_same(port_step(slots, products, degree, fold), want)


@pytest.mark.parametrize("entry", ["ref", "wrapper"])
@pytest.mark.parametrize("coeffs", [False, True], ids=["plain", "coeffs"])
@pytest.mark.parametrize("name,fold", STEPS)
def test_step_matches_host_engine(name, fold, coeffs, entry):
    """Against `engine.round_sums(HOST)` / `fold_tables(HOST)`, with and
    without coefficients, through the plain versions and through the
    wrappers on CPU tensors (which launch nothing)."""
    slots, products, degree = case(name)
    c = _coeffs(len(products)) if coeffs else None
    fns = ((RC.round_step_nofold_ref, RC.round_step_fold_ref) if entry == "ref"
           else (RC.round_step_nofold, RC.round_step_fold))
    before = (RC.round_step_nofold.launches, RC.round_step_fold.launches)
    _assert_same(port_step(slots, products, degree, fold, c, fns),
                 host_step(slots, products, degree, fold, c))
    assert (RC.round_step_nofold.launches, RC.round_step_fold.launches) == before


def test_step_fold_equals_generic_fold():
    """The per-size fold's fresh tables and sums equal the generic chain's
    in-place fold over the extent H/2."""
    slots, products, degree = case("ragged")
    lo, hi = _pair(slots)
    r = torch.from_numpy(_r_digits().astype(np.int32))
    (nlo, nhi), sums = RC.round_step_fold_ref(lo, hi, r, products, degree)
    q = lo.shape[2] // 2
    gsums = RC.round_fold_ref(lo, hi, r, products, degree, q)
    assert torch.equal(sums, gsums)
    assert torch.equal(nlo, lo[:, :, :q]) and torch.equal(nhi, hi[:, :, :q])


@pytest.mark.parametrize("bad", ["odd_width", "coeff_shape", "coeff_dtype", "challenge"])
def test_step_rejects_bad_input(bad):
    slots, products, degree = case("u3")
    lo, hi = _pair(slots)
    r = torch.from_numpy(_r_digits().astype(np.int32))
    c = None
    if bad == "odd_width":
        lo, hi = lo[:, :, :5].contiguous(), hi[:, :, :5].contiguous()
    elif bad == "coeff_shape":
        c = torch.zeros((3, 16), dtype=torch.int32)
    elif bad == "coeff_dtype":
        c = torch.zeros((2, 16), dtype=torch.int64)
    else:
        r = r[:8]
    with pytest.raises((TypeError, ValueError)):
        RC.round_step_fold(lo, hi, r, products, degree, c)


@pytest.mark.slow
@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
def test_step_matches_pallas_kernels(fold):
    """Against `_kernel_nofold` / `_kernel_fold` in interpret mode, with
    coefficients (`has_coeffs`), at the `tests/test_pallas_round.py` shape."""
    from sumcheck_tpu.ops.round_pallas import round_pallas

    slots, products, degree = case("u3")
    half = slots.shape[2] // 2
    c = _coeffs(len(products))
    jpair, jsums = round_pallas(
        jnp.asarray(slots[:, :, :half]), jnp.asarray(slots[:, :, half:]),
        jnp.asarray(_r_digits()), jnp.asarray(c.astype(np.uint32)), products, degree,
        fold, block=64, interpret=True,
    )
    want = (None if jpair is None else (np.asarray(jpair[0]), np.asarray(jpair[1])),
            np.asarray(jsums))
    _assert_same(port_step(slots, products, degree, fold, c), want)
