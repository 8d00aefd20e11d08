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
  banded 8-bit-digit products on the tensor cores (`csrc/round_mxu.cu`;
  plain version over `ops/mxu_mul.py`).

The kernels are in `csrc/round.cu` and `csrc/round_mxu.cu` (CUDA C++ for
sm_90a). Each wrapper
launches its kernel for a CUDA tensor and runs the plain version (the
`_ref` function of the same name) only for a CPU tensor; it raises for
anything else. The library is built with `nvcc` at first launch, never at
import (`ops/cuda_build.py`); a failed build or launch raises.

Contract, for the table pair `lo`, `hi` of shape (U, 16, H) int32 (16-bit
Montgomery digits, slot axis leading); each function returns the round
polynomial's per-digit lane sums, `(degree+1, 16)` int64:

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
  place into fresh (U, 16, H/2) tables, new_lo[k] = fold(lo[k], hi[k]) and
  new_hi[k] = fold(lo[k+H/2], hi[k+H/2]), then the sums over them; returns
  ((new_lo, new_hi), sums).

`coeffs`, where taken, is a (products, 16) int32 tensor of Montgomery digits:
product p's value is multiplied by coeffs[p] (the Pallas kernels'
`has_coeffs`). The per-size prover folds the coefficients into the tables
instead and passes none.

`finish_sums` turns the digit sums into the exact `(WIDE, degree+1)` strict
digits on the host; on the chained provers' path the transcript step does
that on the device (`ops/transcript_cuda.py`).

What bounds the kernels on the H100: per lane, a fold round of the 2x3
workload (6 slots) reads 4 stripes x 64 B and writes 2 x 64 B per slot
(2.3 KB), and runs 12 Montgomery multiplies for the fold (2 per slot) and 16
for the evaluation ((factors-1) x products x (degree+1)), each 64
32x32->64-bit multiply-adds plus their carries. That is several integer
instructions per byte moved, above the card's ratio of 32-bit integer
throughput to memory bandwidth, so 32-bit integer multiply throughput is
the bound to expect. The simple design keeps to that: one lane per thread,
8 x 32-bit limbs with 64-bit products (CIOS, a quarter of the digit
products of the 16 x 16-bit schedule), coalesced digit loads, each lane's
values read from device memory once per round, and the evaluation ladder
kept in shared memory. Faster kernels (integer tiling, TMA loads) are later
work.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields import limbs_torch as LT
from ..fields.fr import DIGIT_BITS, DIGIT_MASK, NINV32, NINV_FULL, NUM_DIGITS, P, WIDE_DIGITS
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
# the same, then -p^-1 mod 2^256 as 8 limbs (the MXU fold kernel's mu band)
_FIELD_MXU = (ctypes.c_uint32 * 17)(
    *_FIELD, *[(NINV_FULL >> (32 * j)) & 0xFFFFFFFF for j in range(8)])

# launch modes of `sc_round_launch`
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
    lib.sc_round_launch.argtypes = [
        ctypes.c_int,  # mode
        ctypes.c_void_p, ctypes.c_void_p,  # lo, hi
        ctypes.c_void_p, ctypes.c_void_p,  # lo_out, hi_out
        ctypes.c_void_p, ctypes.c_void_p,  # r, coeff
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # H, H_out, extent
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),  # plan, field
        ctypes.c_void_p, ctypes.c_longlong,  # part, nblk
        ctypes.c_void_p,  # stream
    ]
    lib.sc_round_launch.restype = ctypes.c_int
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
        ctypes.c_void_p, ctypes.c_longlong,  # part, nblk
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
        raise TypeError("table pair must be int32 digit tensors")
    if lo.shape != hi.shape or lo.dim() != 3 or lo.shape[1] != NUM_DIGITS:
        raise ValueError(f"table pair must be (U, 16, H), got {lo.shape} and {hi.shape}")
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


def _digit_sums(total: torch.Tensor) -> torch.Tensor:
    """(16, d+1, lanes) per-lane values -> (d+1, 16) int64 per-digit sums."""
    return total.sum(dim=-1).T.contiguous()


def _coeff_cols(coeffs):
    """(P, 16) coefficient digits -> (16, P, 1, 1) for `engine.round_totals`."""
    return None if coeffs is None else coeffs.long().T.reshape(NUM_DIGITS, -1, 1, 1)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def round_nofold_ref(lo, hi, products, degree: int, extent: int) -> torch.Tensor:
    """Plain version of the no-fold kernel (any device)."""
    _check(lo, hi, products, degree, extent, fold=False)
    pair = torch.cat([lo[:, :, :extent], hi[:, :, :extent]], dim=2)
    stacked = pair.long().permute(1, 0, 2)  # (16, U, 2*extent)
    total = engine.round_totals(engine.TORCH, stacked, None, products, degree)
    return _digit_sums(total)


def _fold_in_place_ref(lo, hi, products, degree: int, extent: int, fold_fn) -> torch.Tensor:
    """The in-place fold round over `fold_fn`, which takes the (16, U, 4A)
    stacked stripes [lo[:2A] | hi[:2A]] to the (16, U, 2A) folded values."""
    a2 = 2 * extent
    pair = torch.cat([lo[:, :, :a2], hi[:, :, :a2]], dim=2)
    folded = fold_fn(pair.long().permute(1, 0, 2))
    lo[:, :, :extent] = folded[:, :, :extent].permute(1, 0, 2).to(torch.int32)
    hi[:, :, :extent] = folded[:, :, extent:].permute(1, 0, 2).to(torch.int32)
    total = engine.round_totals(engine.TORCH, folded, None, products, degree)
    return _digit_sums(total)


def round_fold_ref(lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    """Plain version of the fold kernel (any device); folds in place."""
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    r_col = r.long().reshape(NUM_DIGITS, 1, 1)
    return _fold_in_place_ref(lo, hi, products, degree, extent,
                              lambda s: engine.fold_tables(engine.TORCH, s, r_col))


def round_fold_mxu_ref(lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    """Plain version of the MXU fold kernel (any device); folds in place,
    each fold multiply as banded products (`mxu_mul.mont_mul_scalar_mxu`)."""
    _check(lo, hi, products, degree, extent, fold=True, r=r)

    def fold(stacked):
        half = stacked.shape[-1] // 2
        even, odd = stacked[..., :half], stacked[..., half:]
        return LT.add(even, mxu_mul.mont_mul_scalar_mxu(LT.sub(odd, even), r))

    return _fold_in_place_ref(lo, hi, products, degree, extent, fold)


def round_step_nofold_ref(lo, hi, products, degree: int, coeffs=None) -> torch.Tensor:
    """Plain version of the per-size no-fold kernel (any device)."""
    _check_step(lo, hi, products, degree, False, coeffs=coeffs)
    stacked = torch.cat([lo, hi], dim=2).long().permute(1, 0, 2)  # (16, U, 2H)
    total = engine.round_totals(engine.TORCH, stacked, _coeff_cols(coeffs), products, degree)
    return _digit_sums(total)


def round_step_fold_ref(lo, hi, r, products, degree: int, coeffs=None):
    """Plain version of the per-size fold kernel (any device): fresh
    (U, 16, H/2) tables and the sums over them."""
    quarter = _check_step(lo, hi, products, degree, True, r=r, coeffs=coeffs)
    stacked = torch.cat([lo, hi], dim=2).long().permute(1, 0, 2)  # (16, U, 2H)
    folded = engine.fold_tables(engine.TORCH, stacked, r.long().reshape(NUM_DIGITS, 1, 1))
    new_lo = folded[:, :, :quarter].permute(1, 0, 2).to(torch.int32).contiguous()
    new_hi = folded[:, :, quarter:].permute(1, 0, 2).to(torch.int32).contiguous()
    total = engine.round_totals(engine.TORCH, folded, _coeff_cols(coeffs), products, degree)
    return (new_lo, new_hi), _digit_sums(total)


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


def _launch(mode: int, lo, hi, r, products, degree: int, extent: int,
            out=None, coeffs=None) -> torch.Tensor:
    plan = _plan(lo.shape[0], products, degree)
    lib = _library()
    threads = lib.sc_round_threads()
    nblk = -(-extent // threads)
    part = torch.empty((nblk, degree + 1, NUM_DIGITS), dtype=torch.int64, device=lo.device)
    lo_out, hi_out = out if out is not None else (None, None)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_round_launch(
            int(mode), lo.data_ptr(), hi.data_ptr(),
            lo_out.data_ptr() if lo_out is not None else None,
            hi_out.data_ptr() if hi_out is not None else None,
            r.data_ptr() if r is not None else None,
            coeffs.data_ptr() if coeffs is not None else None,
            lo.shape[2], lo_out.shape[2] if lo_out is not None else lo.shape[2],
            extent, plan, _FIELD, part.data_ptr(), nblk, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"round kernel launch failed: {lib.sc_error_string(rc).decode()} ({rc})"
        )
    return part.sum(dim=0)  # (d+1, 16): the second, plain pass over blocks


def _kernel_device(lo) -> None:
    if lo.device.type != "cuda":
        raise ValueError(f"no round kernel for device {lo.device}")


def round_nofold(lo, hi, products, degree: int, extent: int) -> torch.Tensor:
    """Round 0 of the generic chain: evaluate without a fold. Launches the
    CUDA kernel for a CUDA pair, runs `round_nofold_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_nofold_ref(lo, hi, products, degree, extent)
    _kernel_device(lo)
    _check(lo, hi, products, degree, extent, fold=False)
    out = _launch(_NOFOLD, lo, hi, None, products, degree, extent)
    round_nofold.launches += 1
    return out


def round_fold(lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    """Rounds 1..nv-1 of the generic chain: fold in place by `r`, then
    evaluate. Launches the CUDA kernel for a CUDA pair, runs
    `round_fold_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_fold_ref(lo, hi, r, products, degree, extent)
    _kernel_device(lo)
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    out = _launch(_FOLD_IN_PLACE, lo, hi, r, products, degree, extent)
    round_fold.launches += 1
    return out


def round_step_nofold(lo, hi, products, degree: int, coeffs=None) -> torch.Tensor:
    """Round 0 of the per-size chain: evaluate over the whole pair. Launches
    the CUDA kernel for a CUDA pair, runs `round_step_nofold_ref` for a CPU
    pair."""
    if lo.device.type == "cpu":
        return round_step_nofold_ref(lo, hi, products, degree, coeffs)
    _kernel_device(lo)
    extent = _check_step(lo, hi, products, degree, False, coeffs=coeffs)
    out = _launch(_NOFOLD, lo, hi, None, products, degree, extent, coeffs=coeffs)
    round_step_nofold.launches += 1
    return out


def round_step_fold(lo, hi, r, products, degree: int, coeffs=None):
    """Rounds 1..nv-1 of the per-size chain: fold by `r` into fresh
    half-width tables, then evaluate; returns ((new_lo, new_hi), sums).
    Launches the CUDA kernel for a CUDA pair, runs `round_step_fold_ref`
    for a CPU pair."""
    if lo.device.type == "cpu":
        return round_step_fold_ref(lo, hi, r, products, degree, coeffs)
    _kernel_device(lo)
    quarter = _check_step(lo, hi, products, degree, True, r=r, coeffs=coeffs)
    new_lo = torch.empty((lo.shape[0], NUM_DIGITS, quarter), dtype=torch.int32, device=lo.device)
    new_hi = torch.empty_like(new_lo)
    out = _launch(_FOLD_OUT, lo, hi, r, products, degree, quarter,
                  out=(new_lo, new_hi), coeffs=coeffs)
    round_step_fold.launches += 1
    return (new_lo, new_hi), out


def round_fold_mxu(lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    """Rounds 1..nv-1 of the generic chain in the MXU fold mode: what
    `round_fold` computes, with each fold multiply as banded products on the
    tensor cores. Launches the CUDA kernel for a CUDA pair, runs
    `round_fold_mxu_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_fold_mxu_ref(lo, hi, r, products, degree, extent)
    _kernel_device(lo)
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    plan = _plan(lo.shape[0], products, degree)
    lib = _mxu_library()
    nblk = -(-extent // lib.sc_mxu_threads())
    part = torch.empty((nblk, degree + 1, NUM_DIGITS), dtype=torch.int64, device=lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_fold_mxu_launch(lo.data_ptr(), hi.data_ptr(), r.data_ptr(), lo.shape[2],
                                    extent, plan, _FIELD_MXU, part.data_ptr(), nblk, stream)
    _raise_mxu(rc, "MXU fold kernel")
    round_fold_mxu.launches += 1
    return part.sum(dim=0)


round_nofold.launches = 0
round_fold.launches = 0
round_step_nofold.launches = 0
round_step_fold.launches = 0
round_fold_mxu.launches = 0


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
