"""The ML table pair's init: the CUDA launch wrapper and its plain PyTorch
version.

Replaces the JAX package's `_stacker`
(`sumcheck_tpu/protocol/device_prover.py:181-203`) as `init_pair` uses it
(`:298-334`). The kernel is `csrc/pair_init.cu`: one launch writes every
slot of one instance's pair, each lane read once and written once, four
lanes a thread in 16-byte accesses, with the slot plan (table pointers,
coefficient limbs) passed by value, so a launch uploads nothing and does
not sync.

`pair_init(lo, hi, tables, slots)` fills slot u of the (U, 8, n/2) int32
halves `lo`, `hi` (8 x 32-bit limbs a value, `limbs_torch.pack_limbs`) by
`slots[u] = (src, coeff)`:

- `(s, None)`: a copy of `tables[s]`;
- `(s, c)`: `tables[s]` times the field element whose Montgomery form is
  `c * R mod p` (`c` a canonical int), fully reduced;
- `(None, c)`: every lane holds `c` (the Montgomery one for the ones slot).

`tables` are (8, n) int32 Montgomery limb tables (`DenseMLE.to_device`),
only read: a cached table is never written. `lo` and `hi` may be one
instance's slice of a batched (B, U, 8, n/2) pair. It launches the kernel
for CUDA tensors and runs `pair_init_ref` for CPU tensors; it raises for
anything else. The launch takes the four-lane body where the half width
is a multiple of 4 and every pointer 16-byte aligned, else the one-lane
body; `blocks_per_sm` gives either's occupancy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import limbs_np as L
from ..fields import limbs_torch as LT
from ..fields.fr import NINV32, NUM_LIMBS, P, R
from . import cuda_build

SOURCE = cuda_build.source("pair_init")
MAX_SLOTS = 16  # `csrc/pair_init.cu`: kMaxSlots

_FIELD = (ctypes.c_uint32 * 9)(*[(P >> (32 * j)) & 0xFFFFFFFF for j in range(8)], NINV32)
_COPY, _SCALE, _FILL = 0, 1, 2


def build():
    """Compile `csrc/pair_init.cu` unless built already; returns the
    library's path."""
    return cuda_build.build("pair_init")["pair_init"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.sc_pair_init_max_slots.restype = ctypes.c_int
    if lib.sc_pair_init_max_slots() != MAX_SLOTS:
        raise RuntimeError("pair init kernel and wrapper disagree on the slot maximum")
    lib.sc_pair_init_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # lo, hi, half, slots
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint32),  # src, c
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),  # mode, field
        ctypes.c_void_p,  # stream
    ]
    lib.sc_pair_init_launch.restype = ctypes.c_int
    lib.sc_pair_init_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.sc_pair_init_blocks_per_sm.restype = ctypes.c_int
    lib.sc_pair_init_error_string.argtypes = [ctypes.c_int]
    lib.sc_pair_init_error_string.restype = ctypes.c_char_p
    return lib


def slot_specs(num_tables: int, scale_plan, need_ones: bool) -> tuple:
    """The `slots` of `pair_init` for a `device_prover._fold_plan`: table u
    in slot u (scaled in place where the plan says so), each appended scaled
    copy after them, then the ones slot if needed."""
    inplace = {src: c for dst, src, c in scale_plan if dst == src}
    specs = [(u, inplace.get(u)) for u in range(num_tables)]
    specs += [(src, c) for dst, src, c in scale_plan if dst != src]
    if need_ones:
        specs.append((None, 1))
    return tuple(specs)


def _check(lo, hi, tables, slots) -> int:
    """Checks shared by the kernel and its plain version; returns n/2."""
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise TypeError("pair halves must be int32 limb tensors")
    if lo.shape != hi.shape or lo.dim() != 3 or lo.shape[1] != NUM_LIMBS:
        raise ValueError(f"pair halves must be (U, 8, n/2), got {lo.shape} and {hi.shape}")
    if not (lo.is_contiguous() and hi.is_contiguous()) or lo.device != hi.device:
        raise ValueError("pair halves must be contiguous, on one device")
    half = lo.shape[2]
    if len(slots) != lo.shape[0] or not 1 <= len(slots) <= MAX_SLOTS:
        raise ValueError(f"{len(slots)} slot specs for {lo.shape[0]} slots (at most {MAX_SLOTS})")
    for src, c in slots:
        if src is None:
            if c is None:
                raise ValueError("a fill slot needs its value")
            continue
        t = tables[src]
        if t.shape != (NUM_LIMBS, 2 * half) or t.dtype != torch.int32:
            raise ValueError(f"table {src} must be (8, {2 * half}) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != lo.device or not t.is_contiguous():
            raise ValueError(f"table {src} must be contiguous, on the pair's device")
    return half


def pair_init_ref(lo, hi, tables, slots) -> None:
    """Plain version of the pair-init kernel (any device): the coefficient
    scaling as `limbs_torch` ops on the unpacked digits."""
    half = _check(lo, hi, tables, slots)
    for u, (src, c) in enumerate(slots):
        if src is None:
            col = torch.from_numpy(L.pack_limbs(L.mont_scalar(c))).to(lo.device)
            lo[u] = col.expand(NUM_LIMBS, half)
            hi[u] = col.expand(NUM_LIMBS, half)
            continue
        t = tables[src]
        if c is not None:
            t = LT.pack_limbs(LT.mont_mul(LT.unpack_limbs(t),
                                          LT.from_numpy(L.mont_scalar(c), lo.device)))
        lo[u] = t[:, :half]
        hi[u] = t[:, half:]


def _launch(lo, hi, tables, slots) -> None:
    half = _check(lo, hi, tables, slots)
    u_count = len(slots)
    src = (ctypes.c_void_p * u_count)(
        *[None if s is None else tables[s].data_ptr() for s, _ in slots])
    limbs = []
    modes = []
    for s, c in slots:
        mont = 0 if c is None else c * R % P
        limbs += [(mont >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
        modes.append(_FILL if s is None else _COPY if c is None else _SCALE)
    lib = _library()
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        rc = lib.sc_pair_init_launch(
            lo.data_ptr(), hi.data_ptr(), half, u_count, src,
            (ctypes.c_uint32 * (8 * u_count))(*limbs), (ctypes.c_int * u_count)(*modes),
            _FIELD, stream)
    if rc != 0:
        raise RuntimeError(f"pair init kernel launch failed: "
                           f"{lib.sc_pair_init_error_string(rc).decode()} ({rc})")


def _kernel_device(lo) -> None:
    if lo.device.type != "cuda":
        raise ValueError(f"no pair-init kernel for device {lo.device}")


def pair_init(lo, hi, tables, slots) -> None:
    """Fill every slot of `lo`, `hi` in one launch. Launches the CUDA
    kernel for CUDA tensors, runs `pair_init_ref` for CPU tensors."""
    if lo.device.type == "cpu":
        return pair_init_ref(lo, hi, tables, slots)
    _kernel_device(lo)
    _launch(lo, hi, tables, slots)
    pair_init.launches += 1


def blocks_per_sm(vec: bool = True) -> int:
    """Resident blocks a multiprocessor holds of the four-lane (`vec`) or
    the one-lane body (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    blocks = _library().sc_pair_init_blocks_per_sm(int(vec))
    if blocks < 0:
        raise RuntimeError("occupancy query of the pair init kernel failed")
    return blocks


pair_init.launches = 0
