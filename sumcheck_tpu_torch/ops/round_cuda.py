"""The MLSumcheck round kernels: CUDA launch wrappers and their plain
PyTorch versions.

Replaces `sumcheck_tpu/ops/round_pallas.py`'s `_kernel_chain_nofold`
(round 0) and `_kernel_chain_fold` (every later round), and with them the
jnp `first_block` / `fold_block` bodies of
`sumcheck_tpu/protocol/generic_prover.py` that the TPU ran for wide rounds.
The kernels are in `csrc/round.cu` (CUDA C++ for sm_90a). Each wrapper
launches its kernel for a CUDA tensor and runs the plain version
(`round_nofold_ref`, `round_fold_ref`) only for a CPU tensor; it raises for
anything else. The library is built with `nvcc` at first launch, never at
import, into `sumcheck_tpu_torch/build/` keyed by a hash of the source; a
failed build or launch raises.

Contract, for the table pair `lo`, `hi` of shape (U, 16, H) int32 (16-bit
Montgomery digits, slot axis leading) and the active pair count `extent`:

- `round_nofold(lo, hi, products, degree, extent)`: the round polynomial's
  per-digit lane sums over lanes [0, extent), `(degree+1, 16)` int64;
- `round_fold(lo, hi, r, products, degree, extent)`: first folds every
  slot by the challenge `r` ((16,) int32 Montgomery digits) in place,
  lo[k] <- fold(lo[k], hi[k]) and hi[k] <- fold(lo[k+extent], hi[k+extent])
  for k < extent; then the same sums over the folded pair.

`finish_sums` turns the digit sums into the exact `(WIDE, degree+1)` strict
digits that the JAX package's rounds produce (one device-to-host copy).

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
kept in shared memory. Faster kernels (integer tiling, TMA loads, the
transcript on the device) are later work.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..fields.fr import DIGIT_BITS, DIGIT_MASK, NINV32, NUM_DIGITS, P, WIDE_DIGITS
from ..protocol import engine

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "round.cu"
BUILD_DIR = _PKG / "build"

# Compile-time maxima of the kernels' run-time product structure
# (`csrc/round.cu`: kMaxSlots, kMaxProducts, kMaxFactors, kMaxDegree).
MAX_SLOTS = 16
MAX_PRODUCTS = 16
MAX_FACTORS = 8
MAX_DEGREE = 8

# p as 8 x 32-bit limbs (least significant first), then -p^-1 mod 2^32
_FIELD = (ctypes.c_uint32 * 9)(*[(P >> (32 * j)) & 0xFFFFFFFF for j in range(8)], NINV32)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA round kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile `csrc/round.cu` for sm_90a unless this source is built
    already; returns the shared library's path. The compiler's resource
    report (`-Xptxas -v`) is kept beside it as `<library>.log`."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"round_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.sc_round_threads.argtypes = []
    lib.sc_round_threads.restype = ctypes.c_int
    lib.sc_round_launch.argtypes = [
        ctypes.c_int,  # do_fold
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lo, hi, r
        ctypes.c_longlong, ctypes.c_longlong,  # H, extent
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),  # plan, field
        ctypes.c_void_p, ctypes.c_longlong,  # part, nblk
        ctypes.c_void_p,  # stream
    ]
    lib.sc_round_launch.restype = ctypes.c_int
    lib.sc_error_string.argtypes = [ctypes.c_int]
    lib.sc_error_string.restype = ctypes.c_char_p
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


def _digit_sums(total: torch.Tensor) -> torch.Tensor:
    """(16, d+1, lanes) per-lane values -> (d+1, 16) int64 per-digit sums."""
    return total.sum(dim=-1).T.contiguous()


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


def round_fold_ref(lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    """Plain version of the fold kernel (any device); folds in place."""
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    a2 = 2 * extent
    pair = torch.cat([lo[:, :, :a2], hi[:, :, :a2]], dim=2)
    stacked = pair.long().permute(1, 0, 2)  # (16, U, 4*extent)
    folded = engine.fold_tables(engine.TORCH, stacked, r.long().reshape(NUM_DIGITS, 1, 1))
    lo[:, :, :extent] = folded[:, :, :extent].permute(1, 0, 2).to(torch.int32)
    hi[:, :, :extent] = folded[:, :, extent:].permute(1, 0, 2).to(torch.int32)
    total = engine.round_totals(engine.TORCH, folded, None, products, degree)
    return _digit_sums(total)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(do_fold: bool, lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    slots = lo.shape[0]
    factors = len(products[0])
    if (slots > MAX_SLOTS or len(products) > MAX_PRODUCTS
            or factors > MAX_FACTORS or degree > MAX_DEGREE):
        raise ValueError(
            f"product structure (slots={slots}, products={len(products)}, "
            f"factors={factors}, degree={degree}) exceeds the kernel's maxima"
        )
    lib = _library()
    threads = lib.sc_round_threads()
    nblk = -(-extent // threads)
    part = torch.empty((nblk, degree + 1, NUM_DIGITS), dtype=torch.int64, device=lo.device)
    idx = [0] * (MAX_PRODUCTS * MAX_FACTORS)
    for p, ix in enumerate(products):
        idx[p * MAX_FACTORS : p * MAX_FACTORS + factors] = ix
    plan = (ctypes.c_int * (4 + len(idx)))(slots, len(products), factors, degree, *idx)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_round_launch(
            int(do_fold), lo.data_ptr(), hi.data_ptr(),
            r.data_ptr() if do_fold else None,
            lo.shape[2], extent, plan, _FIELD, part.data_ptr(), nblk, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"round kernel launch failed: {lib.sc_error_string(rc).decode()} ({rc})"
        )
    return part.sum(dim=0)  # (d+1, 16): the second, plain pass over blocks


def round_nofold(lo, hi, products, degree: int, extent: int) -> torch.Tensor:
    """Round 0: evaluate without a fold. Launches the CUDA kernel for a CUDA
    pair, runs `round_nofold_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_nofold_ref(lo, hi, products, degree, extent)
    if lo.device.type != "cuda":
        raise ValueError(f"no round kernel for device {lo.device}")
    _check(lo, hi, products, degree, extent, fold=False)
    out = _launch(False, lo, hi, None, products, degree, extent)
    round_nofold.launches += 1
    return out


def round_fold(lo, hi, r, products, degree: int, extent: int) -> torch.Tensor:
    """Rounds 1..nv-1: fold in place by `r`, then evaluate. Launches the CUDA
    kernel for a CUDA pair, runs `round_fold_ref` for a CPU pair."""
    if lo.device.type == "cpu":
        return round_fold_ref(lo, hi, r, products, degree, extent)
    if lo.device.type != "cuda":
        raise ValueError(f"no round kernel for device {lo.device}")
    _check(lo, hi, products, degree, extent, fold=True, r=r)
    out = _launch(True, lo, hi, r, products, degree, extent)
    round_fold.launches += 1
    return out


round_nofold.launches = 0
round_fold.launches = 0


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
