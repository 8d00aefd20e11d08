"""The yardstick of `round_fold`'s body: the same in-place fold round with
each slot's four stripes staged in shared memory by 16-byte cp.async
copies (`csrc/fold_staged.cu`, a library of its own), where the main
path's body prefetches them into registers. `chip_smoke.py` times the two
in turns; no path of the package calls this module.

`round_fold_staged(lo, hi, r, products, degree, extent, out=None)`
computes what `round_fold` does, for degree <= 4, with the extent and the
pair width multiples of 4 and the pair 16-byte aligned; CUDA tensors only,
and not counted in `round_fold.launches`. `blocks_per_sm(degree, slots)`
gives the staged body's resident blocks a multiprocessor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from . import round_cuda as RC

SOURCE = cuda_build.source("fold_staged")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build("fold_staged")["fold_staged"]))
    lib.sc_fold_staged_threads.restype = ctypes.c_int
    lib.sc_fold_staged_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lo, hi, r
        ctypes.c_longlong, ctypes.c_longlong,  # H, extent
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),  # plan, field
        ctypes.c_void_p, ctypes.c_longlong,  # sums, nblk
        ctypes.c_void_p,  # stream
    ]
    lib.sc_fold_staged_launch.restype = ctypes.c_int
    lib.sc_fold_staged_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.sc_fold_staged_blocks_per_sm.restype = ctypes.c_int
    lib.sc_fold_staged_error_string.argtypes = [ctypes.c_int]
    lib.sc_fold_staged_error_string.restype = ctypes.c_char_p
    return lib


def round_fold_staged(lo, hi, r, products, degree: int, extent: int, out=None):
    """`round_fold` through the staged body; returns the (d+1, 16) sums."""
    RC._kernel_device(lo)
    RC._check(lo, hi, products, degree, extent, fold=True, r=r)
    if extent % 4 or lo.shape[2] % 4 or lo.data_ptr() % 16 or hi.data_ptr() % 16:
        raise ValueError("the staged body copies 4 lanes at a time: extent and width "
                         "multiples of 4, the pair 16-byte aligned")
    plan = RC._plan(lo.shape[0], products, degree)
    lib = _library()
    sums = RC._sums_row(out, lo, degree)
    nblk = -(-extent // lib.sc_fold_staged_threads())
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_fold_staged_launch(lo.data_ptr(), hi.data_ptr(), r.data_ptr(), lo.shape[2],
                                       extent, plan, RC._FIELD, sums.data_ptr(), nblk, stream)
    if rc != 0:
        raise RuntimeError(f"staged fold launch failed: "
                           f"{lib.sc_fold_staged_error_string(rc).decode()} ({rc})")
    return sums


def blocks_per_sm(degree: int, slots: int) -> int:
    """Resident blocks a multiprocessor holds of the staged body (degree <= 4)
    at `slots` slots (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    blocks = _library().sc_fold_staged_blocks_per_sm(degree, slots)
    if blocks < 0:
        raise ValueError(f"no staged fold body for degree {degree} at {slots} slots")
    return blocks
