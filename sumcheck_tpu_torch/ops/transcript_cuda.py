"""The per-round Fiat-Shamir step of the chained provers: the CUDA launch
wrapper and its plain PyTorch version.

Replaces the JAX package's on-device transcript step, `_transcript_step`
(`sumcheck_tpu/protocol/device_prover.py:118-138`) and the
`feed_fr_vec_dyn` / `fr_rand_dyn` tail of the generic round step
(`protocol/generic_prover.py:276-296`). The kernel is `csrc/transcript.cu`
(one thread of one block, native 64-bit words); see its header for what
bounds it. The plain version runs `transcript/device.py` over
`fields/limbs_torch.py`.

`transcript_step(state, sums, msgs, rs, j)`, for round `j`:

1. finishes the exact wide sums from `sums`, the round kernel's (d+1, 16)
   int64 per-digit sums (the carry chain of `round_cuda.finish_sums`);
2. reduces them mod p (`reduce_wide`) and converts to canonical form
   (`mont_mul_const(., 1)`);
3. feeds them to the transcript as a `Vec<Fr>`;
4. samples the next challenge (`fr_rand`);
5. writes the canonical digits into `msgs[j]` ((nv, 16, d+1) int32), the
   challenge's Montgomery digits into `rs[j]` ((nv, 16) int32), where the
   next fold reads it, and the advanced transcript into `state` ((26, 2)
   int32, the packed state of `transcript/device.py`), all in place.

It launches the kernel for CUDA tensors and runs `transcript_step_ref` for
CPU tensors; it raises for anything else. Nothing waits for the device, so
a whole chain of rounds enqueues without a host sync.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import limbs_torch as LT
from ..fields.fr import NINV32, NUM_DIGITS, P, R2, SHAVE_BITS, WIDE_DIGITS
from ..transcript.device import STATE_WORDS, DevTranscript, feed_fr_vec, fr_rand
from . import cuda_build

SOURCE = cuda_build.source("transcript")
MAX_DEGREE = 8  # `csrc/transcript.cu`: kMaxDegree

_ONE_DIGITS = (1,) + (0,) * (NUM_DIGITS - 1)
# p and R^2 as 8 x 32-bit limbs each (least significant first), with
# -p^-1 mod 2^32 between them, then the bits a draw shaves
_FIELD = (ctypes.c_uint32 * 18)(
    *[(P >> (32 * j)) & 0xFFFFFFFF for j in range(8)], NINV32,
    *[(R2 >> (32 * j)) & 0xFFFFFFFF for j in range(8)], SHAVE_BITS,
)


def build():
    """Compile `csrc/transcript.cu` unless built already; returns the
    library's path."""
    return cuda_build.build("transcript")["transcript"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.sc_transcript_state_words.argtypes = []
    lib.sc_transcript_state_words.restype = ctypes.c_int
    if lib.sc_transcript_state_words() != STATE_WORDS:
        raise RuntimeError("transcript kernel and plain version disagree on the state layout")
    lib.sc_transcript_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # state, sums, degree
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # msgs, rs, j
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p,  # field, stream
    ]
    lib.sc_transcript_launch.restype = ctypes.c_int
    lib.sc_transcript_error_string.argtypes = [ctypes.c_int]
    lib.sc_transcript_error_string.restype = ctypes.c_char_p
    return lib


def _check(state, sums, msgs, rs, j: int) -> None:
    if state.shape != (STATE_WORDS, 2) or state.dtype != torch.int32:
        raise ValueError(f"state must be a ({STATE_WORDS}, 2) int32 tensor")
    if sums.dim() != 2 or sums.shape[1] != NUM_DIGITS or sums.dtype != torch.int64:
        raise ValueError(f"sums must be a (d+1, 16) int64 tensor, got {tuple(sums.shape)}")
    d1 = sums.shape[0]
    if not 2 <= d1 <= MAX_DEGREE + 1:
        raise ValueError(f"degree {d1 - 1} is outside [1, {MAX_DEGREE}]")
    if msgs.dim() != 3 or msgs.shape[1:] != (NUM_DIGITS, d1) or msgs.dtype != torch.int32:
        raise ValueError(f"msgs must be an (nv, 16, {d1}) int32 tensor")
    if rs.dim() != 2 or rs.shape[1] != NUM_DIGITS or rs.dtype != torch.int32:
        raise ValueError("rs must be an (nv, 16) int32 tensor")
    if not (0 <= j < msgs.shape[0] and j < rs.shape[0]):
        raise ValueError(f"round {j} is outside the output buffers")
    for x in (sums, msgs, rs):
        if x.device != state.device:
            raise ValueError("transcript step operands lie on different devices")
    if not all(x.is_contiguous() for x in (state, sums, msgs, rs)):
        raise ValueError("transcript step operands must be contiguous")


def transcript_step_ref(state, sums, msgs, rs, j: int) -> None:
    """Plain version of the transcript kernel (any device)."""
    _check(state, sums, msgs, rs, j)
    rows = list(sums.T)  # 16 rows of (d+1,) per-digit sums
    zero = torch.zeros_like(rows[0])
    strict, _ = LT._chain(rows + [zero] * (WIDE_DIGITS - NUM_DIGITS))
    mont = LT.reduce_wide(torch.stack(strict))  # (16, d+1) Montgomery form
    canon = LT.mont_mul_const(mont, _ONE_DIGITS)  # * R^-1: canonical
    ts = feed_fr_vec(DevTranscript.from_state(state), canon)
    r, ts = fr_rand(ts)
    state.copy_(ts.to_state())
    msgs[j] = canon.to(torch.int32)
    rs[j] = r.to(torch.int32)


def transcript_step(state, sums, msgs, rs, j: int) -> None:
    """One round's transcript step in place. Launches the CUDA kernel for
    CUDA tensors, runs `transcript_step_ref` for CPU tensors."""
    if state.device.type == "cpu":
        return transcript_step_ref(state, sums, msgs, rs, j)
    if state.device.type != "cuda":
        raise ValueError(f"no transcript kernel for device {state.device}")
    _check(state, sums, msgs, rs, j)
    if state.data_ptr() % 8:
        raise ValueError("the kernel reads the state as 64-bit words: it must be 8-byte aligned")
    lib = _library()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.sc_transcript_launch(
            state.data_ptr(), sums.data_ptr(), sums.shape[0] - 1,
            msgs.data_ptr(), rs.data_ptr(), j, _FIELD, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"transcript kernel launch failed: "
            f"{lib.sc_transcript_error_string(rc).decode()} ({rc})"
        )
    transcript_step.launches += 1


transcript_step.launches = 0
