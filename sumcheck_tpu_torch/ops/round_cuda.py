"""The MLSumcheck round kernels: CUDA launch wrappers and their plain
PyTorch versions.

Replaces the Pallas kernels of `sumcheck_tpu/ops/round_pallas.py`:

- `_kernel_chain_nofold` (round 0) and `_kernel_chain_fold` (every later
  round) of the generic chain, and with them the jnp `first_block` /
  `fold_block` bodies of `sumcheck_tpu/protocol/generic_prover.py`:
  `round_nofold` and `round_fold`;
- `_kernel_nofold` (round 0) and `_kernel_fold` (every later round) of the
  per-size chain (`_build`, `round_pallas`): `round_step_nofold` and
  `round_step_fold`;
- `_kernel_chain_fold_mxu`, the generic chain's fold under the MXU fold
  mode (`utils/config.py`): `round_fold_mxu`, whose fold multiply runs as
  8-bit-digit matrix products on the tensor cores (`csrc/round_mxu.cu`;
  plain version over `ops/mxu_mul.py`'s banded products).

The kernels are in `csrc/round.cu` and `csrc/round_mxu.cu` (CUDA C++ for
sm_90a). Each wrapper
launches its kernel for a CUDA tensor and runs the plain version (the
`_ref` function of the same name) only for a CPU tensor; it raises for
anything else. The library is built with `nvcc` at first launch, never at
import (`ops/cuda_build.py`); a failed build or launch raises.

Contract, for the table pair `lo`, `hi` of shape (U, 8, H) int32 (each
value its 8 x 32-bit Montgomery limbs, least significant first, in int32
words holding the bit pattern, `limbs_torch.pack_limbs`; slot axis
leading); each function returns the round polynomial's per-digit lane
sums, `(degree+1, 16)` int64, in the 16-bit digits the transcript step
reads. Each also takes
`out`, a contiguous `(degree+1, 16)` int64 row on the pair's device: the
round's sums are added into it and it is returned. The chains pass row j of
one zeroed `(nv, degree+1, 16)` buffer, which the transcript step then
reads, so a chained round is two launches; without `out` the wrapper
allocates a zeroed row. The kernels add their blocks' sums into the row
with 64-bit atomics, exact and independent of order.

- `round_nofold(lo, hi, products, degree, extent)`: over lanes [0, extent);
- `round_fold(lo, hi, r, products, degree, extent)`: first folds every
  slot by the challenge `r` ((16,) int32 Montgomery digits) in place,
  lo[k] <- fold(lo[k], hi[k]) and hi[k] <- fold(lo[k+extent], hi[k+extent])
  for k < extent; then the same sums over the folded pair;
- `round_fold_mxu(lo, hi, r, products, degree, extent)`: the same, with
  the same results bit for bit;
- `round_step_nofold(lo, hi, products, degree, coeffs=None)`: over all H
  lanes;
- `round_step_fold(lo, hi, r, products, degree, coeffs=None)`: folds out of
  place into fresh (U, 8, H/2) tables, new_lo[k] = fold(lo[k], hi[k]) and
  new_hi[k] = fold(lo[k+H/2], hi[k+H/2]), then the sums over them; returns
  ((new_lo, new_hi), sums).

The batched provers (`batch.py`) run B instances of one shape through one
launch each round, instance b at grid y = b: a (B, U, 8, H) pair, one
challenge per instance as a (B, 16) tensor, (B, P, 16) coefficients and a
(B, d+1, 16) sums buffer, instance b adding into row b. Counterparts of the
JAX package's vmapped bodies (`sumcheck_tpu/batch.py:32-84, 260-300`):

- `round_nofold_batched(lo, hi, products, degree, extent, out=None,
  coeffs=None)`: round 0 of each instance over lanes [0, extent);
- `round_fold_batched(lo, hi, r, products, degree, extent, out=None)`: the
  in-place fold of `round_fold`, instance b by r[b];
- `round_step_fold_batched(lo, hi, r, products, degree, coeffs=None,
  out=None)`: the out-of-place fold of `round_step_fold` into fresh (B, U,
  8, H/2) tables.

Each `_ref` applies the single plain version per instance. Every plain
version unpacks the pair to 16-bit digits (`limbs_torch.unpack_limbs`),
computes on them as `limbs_torch` does, and packs what it writes.
`blocks_per_sm` gives the resident blocks of `round_fold`'s body; its
yardstick, the body with the stripes staged by cp.async, is
`ops/fold_staged.py`.

`coeffs`, where taken, is a (products, 16) int32 tensor of Montgomery digits:
product p's value is multiplied by coeffs[p] (the Pallas kernels'
`has_coeffs`). The per-size prover folds the coefficients into the tables
instead and passes none.

`finish_sums` turns the digit sums into the exact `(WIDE, degree+1)` strict
digits on the host; on the chained provers' path the transcript step does
that on the device (`ops/transcript_cuda.py`).

What bounds the kernels on the H100: per lane, a fold round of the 2x3
workload (6 slots) reads 4 stripes x 32 B and writes 2 x 32 B per slot
(1,152 B), and runs 12 Montgomery multiplies for the fold (2 per slot) and
14 for the evaluation in registers, each 64 32x32->64-bit multiply-adds
plus their carries. At 2^18 lanes its 302 MB take 0.090 ms at 3.35 TB/s and
its multiplies 0.11-0.12 ms, so the multiplies bound it and the loads must
hide under them. The design keeps to one lane per thread, 8 x 32-bit limbs
in memory as in registers, the multiply on the multiply-add's carry chain
(`csrc/field.cuh`), coalesced limb loads, each lane's values read from
device memory once per round, the next slot's stripes loading while a slot
folds, and the evaluation in registers up to degree 4 (above it, the ladder
in shared memory; `csrc/round.cu`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields import limbs_torch as LT
from ..fields.fr import DIGIT_BITS, DIGIT_MASK, NINV32, NUM_DIGITS, NUM_LIMBS, P, WIDE_DIGITS
from ..protocol import engine
from . import cuda_build, mxu_mul

SOURCE = cuda_build.source("round")
SOURCE_MXU = cuda_build.source("round_mxu")

# Compile-time maxima of the kernels' run-time product structure
# (`csrc/round.cu`: kMaxSlots, kMaxProducts, kMaxFactors, kMaxDegree).
MAX_SLOTS = 16
MAX_PRODUCTS = 16
MAX_FACTORS = 8
MAX_DEGREE = 8

# p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32
_FIELD = (ctypes.c_uint32 * 9)(*[(P >> (32 * j)) & 0xFFFFFFFF for j in range(8)], NINV32)
# the same, then 2^(8 j + 16) mod p for j = 0..31 as 8 limbs each (the MXU
# fold kernel's matrix rows, times the challenge)
_FIELD_MXU = (ctypes.c_uint32 * (9 + 32 * 8))(
    *_FIELD, *[((1 << (8 * j + 16)) % P >> (32 * i)) & 0xFFFFFFFF
               for j in range(32) for i in range(8)])

# launch modes of `sc_round_launch_batched`
_NOFOLD, _FOLD_IN_PLACE, _FOLD_OUT = 0, 1, 2


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def build():
    """Compile `csrc/round.cu` unless built already; returns the library's
    path."""
    return cuda_build.build("round")["round"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.sc_round_threads.argtypes = []
    lib.sc_round_threads.restype = ctypes.c_int
    lib.sc_round_launch_batched.argtypes = [
        ctypes.c_int,  # mode
        ctypes.c_void_p, ctypes.c_void_p,  # lo, hi
        ctypes.c_void_p, ctypes.c_void_p,  # lo_out, hi_out
        ctypes.c_void_p, ctypes.c_void_p,  # r, coeff
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # H, H_out, extent
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch, strides
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),  # plan, field
        ctypes.c_void_p, ctypes.c_longlong,  # sums, nblk
        ctypes.c_void_p,  # stream
    ]
    lib.sc_round_launch_batched.restype = ctypes.c_int
    lib.sc_round_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.sc_round_blocks_per_sm.restype = ctypes.c_int
    lib.sc_mont_mul_probe.argtypes = [
        ctypes.c_int,  # impl
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, b, out
        ctypes.c_longlong, ctypes.c_int,  # n, reps
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p,  # field, stream
    ]
    lib.sc_mont_mul_probe.restype = ctypes.c_int
    lib.sc_error_string.argtypes = [ctypes.c_int]
    lib.sc_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _mxu_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build("round_mxu")["round_mxu"]))
    lib.sc_mxu_threads.argtypes = []
    lib.sc_mxu_threads.restype = ctypes.c_int
    lib.sc_fold_mxu_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lo, hi, r
        ctypes.c_longlong, ctypes.c_longlong,  # H, extent
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),  # plan, field
        ctypes.c_void_p, ctypes.c_longlong,  # sums, nblk
        ctypes.c_void_p,  # stream
    ]
    lib.sc_mma_tile_launch.argtypes = [ctypes.c_void_p] * 5
    for fn in (lib.sc_fold_mxu_launch, lib.sc_mma_tile_launch):
        fn.restype = ctypes.c_int
    lib.sc_mxu_error_string.argtypes = [ctypes.c_int]
    lib.sc_mxu_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# checks shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


def _check(lo, hi, products, degree: int, extent: int, fold: bool, r=None) -> None:
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise TypeError("table pair must be int32 limb tensors")
    if lo.shape != hi.shape or lo.dim() != 3 or lo.shape[1] != NUM_LIMBS:
        raise ValueError(f"table pair must be (U, 8, H), got {lo.shape} and {hi.shape}")
    if lo.device != hi.device:
        raise ValueError("lo and hi lie on different devices")
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("table pair must be contiguous")
    slots, _, width = lo.shape
    need = 2 * extent if fold else extent
    if extent < 1 or need > width:
        raise ValueError(f"extent {extent} does not fit a pair of width {width}")
    if not products or len({len(ix) for ix in products}) != 1:
        raise ValueError("products must be index tuples of one length")
    if any(not 0 <= s < slots for ix in products for s in ix):
        raise ValueError("product index out of the slot range")
    if degree < 1:
        raise ValueError("degree must be at least 1")
    if fold:
        if r is None or r.shape != (NUM_DIGITS,) or r.dtype != torch.int32:
            raise ValueError("challenge must be a (16,) int32 digit tensor")
        if r.device != lo.device:
            raise ValueError("challenge and tables lie on different devices")
        if not r.is_contiguous():
            raise ValueError("challenge must be contiguous")


def _check_step(lo, hi, products, degree: int, fold: bool, r=None, coeffs=None) -> int:
    """Checks of the per-size round step; returns its extent (H, or H/2 for
    a fold)."""
    width = lo.shape[2] if lo.dim() == 3 else 0
    if fold and width % 2:
        raise ValueError(f"a per-size fold needs an even pair width, got {width}")
    extent = width // 2 if fold else width
    _check(lo, hi, products, degree, max(extent, 1), fold, r)
    if coeffs is not None:
        if coeffs.dtype != torch.int32 or coeffs.shape != (len(products), NUM_DIGITS):
            raise ValueError(
                f"coefficients must be a ({len(products)}, 16) int32 digit tensor")
        if coeffs.device != lo.device or not coeffs.is_contiguous():
            raise ValueError("coefficients must be contiguous, on the tables' device")
    return extent


def _digit_sums(total: torch.Tensor, out=None) -> torch.Tensor:
    """(16, d+1, lanes) per-lane values -> (d+1, 16) int64 per-digit sums,
    added into `out` if given."""
    sums = total.sum(dim=-1).T.contiguous()
    return sums if out is None else out.add_(sums)


def _check_out(out, lo, degree: int) -> None:
    if out is None:
        return
    if out.shape != (degree + 1, NUM_DIGITS) or out.dtype != torch.int64:
        raise ValueError(f"out must be a ({degree + 1}, 16) int64 row, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if out.device != lo.device or not out.is_contiguous():
        raise ValueError("out must be contiguous, on the tables' device")


def _coeff_cols(coeffs):
    """(P, 16) coefficient digits -> (16, P, 1, 1) for `engine.round_totals`."""
    return None if coeffs is None else coeffs.long().T.reshape(NUM_DIGITS, -1, 1, 1)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _digits(pair) -> torch.Tensor:
    """A (U, 8, n) limb pair block -> (16, U, n) int64 digits, the layout of
    `engine`."""
    return LT.unpack_limbs(pair, dim=1).permute(1, 0, 2)


def _limbs(digits) -> torch.Tensor:
    """(16, U, n) digits -> a (U, 8, n) int32 limb block."""
    return LT.pack_limbs(digits, dim=0).permute(1, 0, 2)


def _nofold_sums(lo, hi, products, degree: int, extent: int, coeffs, out) -> torch.Tensor:
    """Round 0's sums over lanes [0, extent), [times each product's
    coefficient], added into `out` if given."""
    stacked = _digits(torch.cat([lo[:, :, :extent], hi[:, :, :extent]], dim=2))
    total = engine.round_totals(engine.TORCH, stacked, _coeff_cols(coeffs), products, degree)
    return _digit_sums(total, out)


def round_nofold_ref(lo, hi, products, degree: int, extent: int, out=None) -> torch.Tensor:
    """Plain version of the no-fold kernel (any device)."""
    _check(lo, hi, products, degree, extent, fold=False)
    _check_out(out, lo, degree)
    return _nofold_sums(lo, hi, products, degree, extent, None, out)


def _fold_in_place_ref(lo, hi, products, degree: int, extent: int, fold_fn,
                      out=None) -> torch.Tensor:
    """The in-place fold round over `fold_fn`, which takes the (16, U, 4A)
    stacked stripes [lo[:2A] | hi[:2A]] to the (16, U, 2A) folded values."""
    a2 = 2 * extent
    folded = fold_fn(_digits(torch.cat([lo[:, :, :a2], hi[:, :, :a2]], dim=2)))
    packed = _limbs(folded)
    lo[:, :, :extent] = packed[:, :, :extent]
    hi[:, :, :extent] = packed[:, :, extent:]
    total = engine.round_totals(engine.TORCH, folded, None, products, degree)
    return _digit_sums(total, out)


def round_fold_ref(lo, hi, r, products, degree: int, extent: int, out=None) -> torch.Tensor:
    """Plain version of the fold kernel (any device); folds in place."""
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    _check_out(out, lo, degree)
    r_col = r.long().reshape(NUM_DIGITS, 1, 1)
    return _fold_in_place_ref(lo, hi, products, degree, extent,
                              lambda s: engine.fold_tables(engine.TORCH, s, r_col), out)


def round_fold_mxu_ref(lo, hi, r, products, degree: int, extent: int,
                       out=None) -> torch.Tensor:
    """Plain version of the MXU fold kernel (any device); folds in place,
    each fold multiply as banded products (`mxu_mul.mont_mul_scalar_mxu`)."""
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    _check_out(out, lo, degree)

    def fold(stacked):
        half = stacked.shape[-1] // 2
        even, odd = stacked[..., :half], stacked[..., half:]
        return LT.add(even, mxu_mul.mont_mul_scalar_mxu(LT.sub(odd, even), r))

    return _fold_in_place_ref(lo, hi, products, degree, extent, fold, out)


def round_step_nofold_ref(lo, hi, products, degree: int, coeffs=None,
                          out=None) -> torch.Tensor:
    """Plain version of the per-size no-fold kernel (any device)."""
    extent = _check_step(lo, hi, products, degree, False, coeffs=coeffs)
    _check_out(out, lo, degree)
    return _nofold_sums(lo, hi, products, degree, extent, coeffs, out)


def round_step_fold_ref(lo, hi, r, products, degree: int, coeffs=None, out=None):
    """Plain version of the per-size fold kernel (any device): fresh
    (U, 8, H/2) tables and the sums over them."""
    quarter = _check_step(lo, hi, products, degree, True, r=r, coeffs=coeffs)
    _check_out(out, lo, degree)
    stacked = _digits(torch.cat([lo, hi], dim=2))  # (16, U, 2H)
    folded = engine.fold_tables(engine.TORCH, stacked, r.long().reshape(NUM_DIGITS, 1, 1))
    packed = _limbs(folded)
    new_lo = packed[:, :, :quarter].contiguous()
    new_hi = packed[:, :, quarter:].contiguous()
    total = engine.round_totals(engine.TORCH, folded, _coeff_cols(coeffs), products, degree)
    return (new_lo, new_hi), _digit_sums(total, out)


def _check_batched(lo, hi, products, degree: int, extent: int, fold: bool, r=None,
                   coeffs=None, out=None) -> int:
    """Checks of a batched round: (B, U, 8, H) pair, one (16,) challenge
    per instance as a (B, 16) tensor, (B, P, 16) coefficients, a (B, d+1,
    16) sums buffer. Returns B."""
    if lo.dim() != 4 or lo.shape[0] < 1 or lo.shape[0] > 65535:
        raise ValueError(f"a batched pair must be (B, U, 8, H) with 1 <= B <= 65535, "
                         f"got {tuple(lo.shape)}")
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("table pair must be contiguous")
    batch = lo.shape[0]
    _check(lo[0], hi[0], products, degree, extent, fold, r[0] if fold and r is not None
           and r.dim() == 2 else r)
    if lo.shape != hi.shape:
        raise ValueError(f"lo and hi differ in shape: {lo.shape} and {hi.shape}")
    if fold and (r.shape != (batch, NUM_DIGITS) or not r.is_contiguous()):
        raise ValueError(f"challenges must be one contiguous (B, 16) int32 row per instance, "
                         f"got {tuple(r.shape)}")
    if coeffs is not None:
        if coeffs.dtype != torch.int32 or coeffs.shape != (batch, len(products), NUM_DIGITS):
            raise ValueError(f"coefficients must be a (B, {len(products)}, 16) int32 tensor")
        if coeffs.device != lo.device or not coeffs.is_contiguous():
            raise ValueError("coefficients must be contiguous, on the tables' device")
    if out is not None:
        if out.shape != (batch, degree + 1, NUM_DIGITS) or out.dtype != torch.int64:
            raise ValueError(f"out must be a (B, {degree + 1}, 16) int64 buffer, got "
                             f"{tuple(out.shape)} {out.dtype}")
        if out.device != lo.device or not out.is_contiguous():
            raise ValueError("out must be contiguous, on the tables' device")
    return batch


def _batched_rows(out, lo, degree: int) -> torch.Tensor:
    """The (B, d+1, 16) rows a batched round adds into: `out`, or fresh
    zeroed ones."""
    if out is not None:
        return out
    return torch.zeros((lo.shape[0], degree + 1, NUM_DIGITS), dtype=torch.int64,
                       device=lo.device)


def round_nofold_batched_ref(lo, hi, products, degree: int, extent: int, out=None,
                             coeffs=None) -> torch.Tensor:
    """Plain version of the batched no-fold kernel (any device): the single
    plain version per instance, instance b into row b."""
    batch = _check_batched(lo, hi, products, degree, extent, False, coeffs=coeffs, out=out)
    rows = _batched_rows(out, lo, degree)
    for b in range(batch):
        _nofold_sums(lo[b], hi[b], products, degree, extent,
                     None if coeffs is None else coeffs[b], rows[b])
    return rows


def round_fold_batched_ref(lo, hi, r, products, degree: int, extent: int,
                           out=None) -> torch.Tensor:
    """Plain version of the batched in-place fold kernel (any device):
    `round_fold_ref` per instance, by its own challenge r[b]."""
    batch = _check_batched(lo, hi, products, degree, extent, True, r=r, out=out)
    rows = _batched_rows(out, lo, degree)
    for b in range(batch):
        round_fold_ref(lo[b], hi[b], r[b], products, degree, extent, rows[b])
    return rows


def round_step_fold_batched_ref(lo, hi, r, products, degree: int, coeffs=None, out=None):
    """Plain version of the batched out-of-place fold kernel (any device):
    `round_step_fold_ref` per instance; returns ((new_lo, new_hi), sums)
    with fresh (B, U, 8, H/2) tables."""
    width = lo.shape[-1]
    if width % 2:
        raise ValueError(f"a per-size fold needs an even pair width, got {width}")
    batch = _check_batched(lo, hi, products, degree, max(width // 2, 1), True, r=r,
                           coeffs=coeffs, out=out)
    rows = _batched_rows(out, lo, degree)
    halves = [round_step_fold_ref(lo[b], hi[b], r[b], products, degree,
                                  None if coeffs is None else coeffs[b], rows[b])[0]
              for b in range(batch)]
    return (torch.stack([h[0] for h in halves]), torch.stack([h[1] for h in halves])), rows


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _plan(slots: int, products, degree: int):
    """The kernels' run-time product plan (`Plan` in `csrc/round_common.cuh`);
    raises above its compile-time maxima, before any build."""
    factors = len(products[0])
    if (slots > MAX_SLOTS or len(products) > MAX_PRODUCTS
            or factors > MAX_FACTORS or degree > MAX_DEGREE):
        raise ValueError(
            f"product structure (slots={slots}, products={len(products)}, "
            f"factors={factors}, degree={degree}) exceeds the kernel's maxima"
        )
    idx = [0] * (MAX_PRODUCTS * MAX_FACTORS)
    for p, ix in enumerate(products):
        idx[p * MAX_FACTORS : p * MAX_FACTORS + factors] = ix
    return (ctypes.c_int * (4 + len(idx)))(slots, len(products), factors, degree, *idx)


def _sums_row(out, lo, degree: int) -> torch.Tensor:
    """The row a kernel adds the round's sums into: `out`, or a fresh zeroed
    one."""
    if out is None:
        return torch.zeros((degree + 1, NUM_DIGITS), dtype=torch.int64, device=lo.device)
    _check_out(out, lo, degree)
    return out


def _launch(mode: int, lo, hi, r, products, degree: int, extent: int,
            out=None, tables=None, coeffs=None) -> torch.Tensor:
    """One launch of `sc_round_launch_batched` for a (U, 8, H) pair (one
    instance) or a (B, U, 8, H) pair (B instances, grid y)."""
    batched = lo.dim() == 4
    plan = _plan(lo.shape[-3], products, degree)
    lib = _library()
    sums = _batched_rows(out, lo, degree) if batched else _sums_row(out, lo, degree)
    nblk = -(-extent // lib.sc_round_threads())
    lo_out, hi_out = tables if tables is not None else (None, None)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_round_launch_batched(
            int(mode), lo.data_ptr(), hi.data_ptr(),
            lo_out.data_ptr() if lo_out is not None else None,
            hi_out.data_ptr() if hi_out is not None else None,
            r.data_ptr() if r is not None else None,
            coeffs.data_ptr() if coeffs is not None else None,
            lo.shape[-1], lo_out.shape[-1] if lo_out is not None else lo.shape[-1], extent,
            lo.shape[0] if batched else 1, lo[0].numel() if batched else 0,
            lo_out[0].numel() if batched and lo_out is not None else 0,
            plan, _FIELD, sums.data_ptr(), nblk, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"round kernel launch failed: {lib.sc_error_string(rc).decode()} ({rc})"
        )
    return sums


def _kernel_device(lo) -> None:
    if lo.device.type != "cuda":
        raise ValueError(f"no round kernel for device {lo.device}")


def round_nofold(lo, hi, products, degree: int, extent: int, out=None) -> torch.Tensor:
    """Round 0 of the generic chain: evaluate without a fold. Launches the
    CUDA kernel for a CUDA pair, runs `round_nofold_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_nofold_ref(lo, hi, products, degree, extent, out)
    _kernel_device(lo)
    _check(lo, hi, products, degree, extent, fold=False)
    sums = _launch(_NOFOLD, lo, hi, None, products, degree, extent, out)
    round_nofold.launches += 1
    return sums


def round_fold(lo, hi, r, products, degree: int, extent: int, out=None) -> torch.Tensor:
    """Rounds 1..nv-1 of the generic chain: fold in place by `r`, then
    evaluate. Launches the CUDA kernel for a CUDA pair, runs
    `round_fold_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_fold_ref(lo, hi, r, products, degree, extent, out)
    _kernel_device(lo)
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    sums = _launch(_FOLD_IN_PLACE, lo, hi, r, products, degree, extent, out)
    round_fold.launches += 1
    return sums


def round_step_nofold(lo, hi, products, degree: int, coeffs=None, out=None) -> torch.Tensor:
    """Round 0 of the per-size chain: evaluate over the whole pair. Launches
    the CUDA kernel for a CUDA pair, runs `round_step_nofold_ref` for a CPU
    pair."""
    if lo.device.type == "cpu":
        return round_step_nofold_ref(lo, hi, products, degree, coeffs, out)
    _kernel_device(lo)
    extent = _check_step(lo, hi, products, degree, False, coeffs=coeffs)
    sums = _launch(_NOFOLD, lo, hi, None, products, degree, extent, out, coeffs=coeffs)
    round_step_nofold.launches += 1
    return sums


def round_step_fold(lo, hi, r, products, degree: int, coeffs=None, out=None):
    """Rounds 1..nv-1 of the per-size chain: fold by `r` into fresh
    half-width tables, then evaluate; returns ((new_lo, new_hi), sums).
    Launches the CUDA kernel for a CUDA pair, runs `round_step_fold_ref`
    for a CPU pair."""
    if lo.device.type == "cpu":
        return round_step_fold_ref(lo, hi, r, products, degree, coeffs, out)
    _kernel_device(lo)
    quarter = _check_step(lo, hi, products, degree, True, r=r, coeffs=coeffs)
    new_lo = torch.empty((lo.shape[0], NUM_LIMBS, quarter), dtype=torch.int32, device=lo.device)
    new_hi = torch.empty_like(new_lo)
    sums = _launch(_FOLD_OUT, lo, hi, r, products, degree, quarter, out,
                   tables=(new_lo, new_hi), coeffs=coeffs)
    round_step_fold.launches += 1
    return (new_lo, new_hi), sums


def round_nofold_batched(lo, hi, products, degree: int, extent: int, out=None,
                         coeffs=None) -> torch.Tensor:
    """Round 0 of B instances in one launch: each evaluated over lanes [0,
    extent) without a fold, [times its own coefficients], into its row of
    the (B, d+1, 16) sums. Launches the CUDA kernel for a CUDA pair, runs
    `round_nofold_batched_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_nofold_batched_ref(lo, hi, products, degree, extent, out, coeffs)
    _kernel_device(lo)
    _check_batched(lo, hi, products, degree, extent, False, coeffs=coeffs, out=out)
    sums = _launch(_NOFOLD, lo, hi, None, products, degree, extent, out, coeffs=coeffs)
    round_nofold_batched.launches += 1
    return sums


def round_fold_batched(lo, hi, r, products, degree: int, extent: int,
                       out=None) -> torch.Tensor:
    """A generic-chain fold round of B instances in one launch: instance b
    folded in place by its challenge r[b], then evaluated. Launches the CUDA
    kernel for a CUDA pair, runs `round_fold_batched_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_fold_batched_ref(lo, hi, r, products, degree, extent, out)
    _kernel_device(lo)
    _check_batched(lo, hi, products, degree, extent, True, r=r, out=out)
    sums = _launch(_FOLD_IN_PLACE, lo, hi, r, products, degree, extent, out)
    round_fold_batched.launches += 1
    return sums


def round_step_fold_batched(lo, hi, r, products, degree: int, coeffs=None, out=None):
    """A per-size fold round of B instances in one launch: instance b folded
    by r[b] into fresh (B, U, 8, H/2) tables, [times its own coefficients],
    then evaluated; returns ((new_lo, new_hi), sums). Launches the CUDA
    kernel for a CUDA pair, runs `round_step_fold_batched_ref` for a CPU
    pair."""
    if lo.device.type == "cpu":
        return round_step_fold_batched_ref(lo, hi, r, products, degree, coeffs, out)
    _kernel_device(lo)
    width = lo.shape[-1]
    if width % 2:
        raise ValueError(f"a per-size fold needs an even pair width, got {width}")
    quarter = width // 2
    _check_batched(lo, hi, products, degree, max(quarter, 1), True, r=r, coeffs=coeffs, out=out)
    new_lo = torch.empty(lo.shape[:3] + (quarter,), dtype=torch.int32, device=lo.device)
    new_hi = torch.empty_like(new_lo)
    sums = _launch(_FOLD_OUT, lo, hi, r, products, degree, quarter, out,
                           tables=(new_lo, new_hi), coeffs=coeffs)
    round_step_fold_batched.launches += 1
    return (new_lo, new_hi), sums


def round_fold_mxu(lo, hi, r, products, degree: int, extent: int, out=None) -> torch.Tensor:
    """Rounds 1..nv-1 of the generic chain in the MXU fold mode: what
    `round_fold` computes, with each fold multiply as a byte-matrix product
    on the tensor cores. Launches the CUDA kernel for a CUDA pair, runs
    `round_fold_mxu_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_fold_mxu_ref(lo, hi, r, products, degree, extent, out)
    _kernel_device(lo)
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    plan = _plan(lo.shape[0], products, degree)
    lib = _mxu_library()
    sums = _sums_row(out, lo, degree)
    nblk = -(-extent // lib.sc_mxu_threads())
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_fold_mxu_launch(lo.data_ptr(), hi.data_ptr(), r.data_ptr(), lo.shape[2],
                                    extent, plan, _FIELD_MXU, sums.data_ptr(), nblk, stream)
    _raise_mxu(rc, "MXU fold kernel")
    round_fold_mxu.launches += 1
    return sums


def blocks_per_sm(degree: int, slots: int) -> int:
    """Resident blocks a multiprocessor holds of `round_fold`'s body (degree
    <= 4) at `slots` slots (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    blocks = _library().sc_round_blocks_per_sm(degree, slots)
    if blocks < 0:
        raise ValueError(f"no register fold body for degree {degree} at {slots} slots")
    return blocks


round_nofold.launches = 0
round_fold.launches = 0
round_step_nofold.launches = 0
round_step_fold.launches = 0
round_fold_mxu.launches = 0
round_nofold_batched.launches = 0
round_fold_batched.launches = 0
round_step_fold_batched.launches = 0


def _raise_mxu(rc: int, what: str) -> None:
    if rc != 0:
        msg = _mxu_library().sc_mxu_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _mma_tile(a, b, c) -> torch.Tensor:
    """Test hook of `csrc/round_mxu.cu`'s fragment layouts: one tensor-core
    tile D = A B + C on the card. a (16, 32) uint8, b (8, 32) uint8 (the
    columns of B), c (16, 8) int32; returns D (16, 8) int32."""
    _kernel_device(a)
    if (a.shape, b.shape, c.shape) != ((16, 32), (8, 32), (16, 8)) or (
            a.dtype, b.dtype, c.dtype) != (torch.uint8, torch.uint8, torch.int32):
        raise ValueError("a (16, 32) uint8, b (8, 32) uint8, c (16, 8) int32")
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    d = torch.empty_like(c)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _mxu_library().sc_mma_tile_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                               d.data_ptr(), stream)
    _raise_mxu(rc, "mma tile")
    return d


# the multiplies of `csrc/field.cuh`, by the probe's `impl` argument
MULTIPLIES = {"cios": 0, "eo": 1}


def _mont_mul_probe(a, b, reps: int = 1, impl: str = "cios") -> torch.Tensor:
    """Test hook of `csrc/field.cuh`'s multiplies on the card (`impl`: "cios"
    or "eo", the even/odd accumulators): (n, 8) int32 limbs a, b (Montgomery
    form, below p) -> a * b^reps * 2^(-256 reps) mod p."""
    _kernel_device(a)
    if a.shape != b.shape or a.dim() != 2 or a.shape[1] != 8 or a.dtype != torch.int32 \
            or b.dtype != torch.int32:
        raise ValueError("a and b must be (n, 8) int32 limb tensors")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.sc_mont_mul_probe(MULTIPLIES[impl], a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   a.shape[0],
                                   reps, _FIELD, stream)
    if rc != 0:
        raise RuntimeError(f"multiply probe launch failed: "
                           f"{lib.sc_error_string(rc).decode()} ({rc})")
    return out


def finish_sums(digit_sums: torch.Tensor) -> np.ndarray:
    """(d+1, 16) int64 per-digit sums -> (WIDE, d+1) uint32 strict digits of
    the exact integer sums: the host carry chain (one device-to-host copy)."""
    s = digit_sums.cpu().numpy().astype(np.int64)
    out = np.zeros((WIDE_DIGITS, s.shape[0]), dtype=np.uint32)
    carry = np.zeros(s.shape[0], dtype=np.int64)
    for i in range(WIDE_DIGITS):
        t = (s[:, i] if i < NUM_DIGITS else 0) + carry
        out[i] = t & DIGIT_MASK
        carry = t >> DIGIT_BITS
    return out
