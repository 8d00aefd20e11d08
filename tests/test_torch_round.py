"""The round kernels' plain versions (`ops/round_cuda.round_nofold_ref`,
`round_fold_ref`, and the wrappers on CPU tensors) against the JAX package:
the host engine `engine.HOST`, the jnp engine `engine.DEVICE` (eager), and
the Pallas chain kernels themselves in interpret mode (slow).

Compared: the folded active lanes, unpacked from the port's (U, 8, H)
limb pair (`limbs_torch.unpack_limbs`) to the JAX package's digits, and the
exact `(WIDE, d+1)` sums. Tolerance 0. Inputs from `numpy.random.default_rng`, shaped as
`__graft_entry__._example(nv=8)`: three tables, products (0,1,2) and
(2,0,1) with coefficients 123 and 456 pre-folded into scaled copies of
their first tables (what `_fold_plan` does for shared tables).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sumcheck_tpu.fields import limbs_np as LN
from sumcheck_tpu.protocol import engine as JE
from sumcheck_tpu_torch.fields import limbs_torch as LT
from sumcheck_tpu_torch.ops import round_cuda as RC

DEGREE = 3
# slots: t0, t1, t2, 123*t0, 456*t2 — coefficients folded into copies
EXAMPLE_PRODUCTS = ((3, 1, 2), (4, 0, 1))
# ragged: (t0, t1, t2) and (t0, t3) padded with the ones slot 4
RAGGED_PRODUCTS = ((0, 1, 2), (0, 3, 4))


def _tables(seed: int, nv: int, count: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(count, 16, 1 << nv), dtype=np.uint32)
    d[:, 15] >>= 2  # < 2^254 < p
    return d


def example_slots(nv: int) -> np.ndarray:
    """(U=5, 16, 2^nv) slot-leading tables with the coefficients folded."""
    t = _tables(0, nv, 3)
    c0 = LN.mont_mul(t[0], np.broadcast_to(LN.mont_scalar(123), t[0].shape))
    c2 = LN.mont_mul(t[2], np.broadcast_to(LN.mont_scalar(456), t[2].shape))
    return np.stack([t[0], t[1], t[2], c0, c2])


def ragged_slots(nv: int) -> np.ndarray:
    t = _tables(1, nv, 4)
    ones = np.broadcast_to(LN.mont_scalar(1), (16, 1 << nv))
    return np.concatenate([t, ones[None]])


def _pair(slots: np.ndarray):
    """Slot-leading digit tables (U, 16, n) -> the port's (U, 8, n/2) int32
    limb (lo, hi) pair."""
    half = slots.shape[2] // 2
    packed = LT.pack_limbs(torch.from_numpy(slots.astype(np.int64)), dim=1)
    return packed[:, :, :half].contiguous(), packed[:, :, half:].contiguous()


def _unpacked(t: torch.Tensor) -> np.ndarray:
    """A (U, 8, n) limb block -> its (U, 16, n) uint32 digits."""
    return LT.unpack_limbs(t, dim=1).numpy().astype(np.uint32)


def _challenge(v: int = 789):
    return torch.from_numpy(LN.mont_scalar(v)[:, 0].astype(np.int32))


def _host_stripes(slots, extent, width):
    """digit-leading (16, U, 2*width) table for the JAX engines: the first
    `width` lanes of lo, then of hi."""
    half = slots.shape[2] // 2
    d = slots.transpose(1, 0, 2)
    return np.concatenate([d[:, :, :width], d[:, :, half : half + width]], axis=2)


def host_round(slots, products, extent, fold, ops=JE.HOST, xp=np):
    """The JAX package's round on the active lanes: (new lo, new hi) or
    None, and the (WIDE, d+1) sums."""
    idx = np.array(products, np.int32)
    if not fold:
        st = xp.asarray(_host_stripes(slots, extent, extent))
        return None, np.asarray(JE.round_sums(ops, st, None, xp.asarray(idx), DEGREE))
    st = xp.asarray(_host_stripes(slots, extent, 2 * extent))
    r_col = xp.asarray(LN.mont_scalar(789))[:, None, :]
    folded = JE.fold_tables(ops, st, r_col)  # (16, U, 2*extent)
    sums = JE.round_sums(ops, folded, None, xp.asarray(idx), DEGREE)
    folded = np.asarray(folded).transpose(1, 0, 2)
    return (folded[:, :, :extent], folded[:, :, extent:]), np.asarray(sums)


def port_round(slots, products, extent, fold, fn_nofold, fn_fold):
    lo, hi = _pair(slots)
    lo0, hi0 = lo.clone(), hi.clone()
    if fold:
        sums = fn_fold(lo, hi, _challenge(), products, DEGREE, extent)
        # lanes past the extent stay as they were
        assert torch.equal(lo[:, :, extent:], lo0[:, :, extent:])
        assert torch.equal(hi[:, :, extent:], hi0[:, :, extent:])
        pair = (_unpacked(lo[:, :, :extent]), _unpacked(hi[:, :, :extent]))
    else:
        sums = fn_nofold(lo, hi, products, DEGREE, extent)
        assert torch.equal(lo, lo0) and torch.equal(hi, hi0)
        pair = None
    assert sums.shape == (DEGREE + 1, 16) and sums.dtype == torch.int64
    return pair, RC.finish_sums(sums)


def _assert_same(got, want):
    (gpair, gsums), (wpair, wsums) = got, want
    np.testing.assert_array_equal(gsums, wsums)
    if wpair is None:
        assert gpair is None
    else:
        np.testing.assert_array_equal(gpair[0].astype(np.uint32), wpair[0])
        np.testing.assert_array_equal(gpair[1].astype(np.uint32), wpair[1])


@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
@pytest.mark.parametrize("entry", ["ref", "wrapper"])
def test_example_full_extent_matches_host(fold, entry):
    """nv=8 pair, every lane active, through the plain version and through
    the wrapper on CPU tensors (which must take the plain version)."""
    slots = example_slots(8)
    half = slots.shape[2] // 2
    extent = half // 2 if fold else half
    fns = ((RC.round_nofold_ref, RC.round_fold_ref) if entry == "ref"
           else (RC.round_nofold, RC.round_fold))
    _assert_same(port_round(slots, EXAMPLE_PRODUCTS, extent, fold, *fns),
                 host_round(slots, EXAMPLE_PRODUCTS, extent, fold))


@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
def test_example_matches_jnp_engine(fold):
    """The same round against the jnp `engine.DEVICE` (eager)."""
    slots = example_slots(6)
    half = slots.shape[2] // 2
    extent = half // 2 if fold else half
    _assert_same(
        port_round(slots, EXAMPLE_PRODUCTS, extent, fold,
                   RC.round_nofold_ref, RC.round_fold_ref),
        host_round(slots, EXAMPLE_PRODUCTS, extent, fold, ops=JE.DEVICE, xp=jnp),
    )


@pytest.mark.parametrize("extent", [1, 3, 5])
@pytest.mark.parametrize("fold", [False, True], ids=["nofold", "fold"])
@pytest.mark.parametrize("shape", ["example", "ragged"])
def test_sub_extent_rounds(shape, fold, extent):
    """Extents that fill no block: lanes past the extent add nothing and
    keep their values; the ragged case carries a ones slot."""
    slots, products = ((example_slots(5), EXAMPLE_PRODUCTS) if shape == "example"
                       else (ragged_slots(5), RAGGED_PRODUCTS))
    _assert_same(
        port_round(slots, products, extent, fold, RC.round_nofold_ref, RC.round_fold_ref),
        host_round(slots, products, extent, fold),
    )


def test_prefolded_coefficients_match_unfolded_round():
    """Pre-folding the coefficients changes no sum: the port's round over
    the scaled copies equals the host engine's round with the coefficients
    applied per product over the original tables."""
    nv = 6
    slots = example_slots(nv)
    half = 1 << (nv - 1)
    _, got = port_round(slots, EXAMPLE_PRODUCTS, half, False,
                        RC.round_nofold_ref, RC.round_fold_ref)
    plain = slots[:3].transpose(1, 0, 2)  # (16, 3, n): t0, t1, t2
    coeffs = np.stack([LN.mont_scalar(123), LN.mont_scalar(456)], axis=1)[:, :, :, None]
    idx = np.array([[0, 1, 2], [2, 0, 1]], np.int32)
    want = JE.round_sums(JE.HOST, plain, coeffs, idx, DEGREE)
    np.testing.assert_array_equal(got, want)


def test_finish_sums_is_the_exact_carry_chain():
    rng = np.random.default_rng(11)
    s = rng.integers(0, 1 << 40, size=(DEGREE + 1, 16), dtype=np.int64)
    wide = RC.finish_sums(torch.from_numpy(s))
    for t in range(DEGREE + 1):
        want = sum(int(s[t, i]) << (16 * i) for i in range(16))
        got = sum(int(wide[i, t]) << (16 * i) for i in range(wide.shape[0]))
        assert got == want
        assert (wide[:, t] < (1 << 16)).all()


@pytest.mark.parametrize(
    "bad",
    ["dtype", "extent", "product", "challenge"],
)
def test_plain_versions_reject_bad_input(bad):
    lo, hi = _pair(example_slots(4))
    r = _challenge()
    products, extent = EXAMPLE_PRODUCTS, 4
    if bad == "dtype":
        lo = lo.long()
    elif bad == "extent":
        extent = 5  # 2 * 5 lanes do not fit a width of 8
    elif bad == "product":
        products = ((0, 1, 9), (1, 2, 3))
    else:
        r = r[:8]
    with pytest.raises((TypeError, ValueError)):
        RC.round_fold_ref(lo, hi, r, products, DEGREE, extent)


@pytest.mark.slow
@pytest.mark.parametrize("do_fold", [False, True], ids=["nofold", "fold"])
def test_matches_pallas_chain_kernel(do_fold):
    """Against `_kernel_chain_nofold` / `_kernel_chain_fold` in interpret
    mode: one B=16 block of two bt=8 tiles, U=3, extent 5 (masked lanes)."""
    from sumcheck_tpu.ops.round_pallas import _build_chain

    B, bt, extent = 16, 8, 5
    products = ((0, 1, 2), (2, 0, 1))
    slots = _tables(2, 6, 3)  # (3, 16, 64): a pair of width 32
    lo, hi = _pair(slots)
    lo_j, hi_j = jnp.asarray(_unpacked(lo)), jnp.asarray(_unpacked(hi))
    mask = jnp.asarray((np.arange(B)[None, :] < extent).repeat(16, 0).astype(np.uint32))
    call = _build_chain(B, 3, products, DEGREE, do_fold, bt, True)
    if do_fold:
        r_blk = jnp.broadcast_to(jnp.asarray(LN.mont_scalar(789)), (16, bt))
        flo, fhi, part = call(r_blk, mask, lo_j[:, :, :B], lo_j[:, :, extent:extent + B],
                              hi_j[:, :, :B], hi_j[:, :, extent:extent + B])
        sums = RC.round_fold_ref(lo, hi, _challenge(), products, DEGREE, extent)
        np.testing.assert_array_equal(np.asarray(flo)[:, :, :extent], _unpacked(lo[:, :, :extent]))
        np.testing.assert_array_equal(np.asarray(fhi)[:, :, :extent], _unpacked(hi[:, :, :extent]))
    else:
        (part,) = call(mask, lo_j[:, :, :B], hi_j[:, :, :B])
        sums = RC.round_nofold_ref(lo, hi, products, DEGREE, extent)
    # the tiles' relaxed per-digit sums add up to the port's digit sums
    np.testing.assert_array_equal(np.asarray(part).astype(np.int64).sum(axis=0), sums.numpy())
