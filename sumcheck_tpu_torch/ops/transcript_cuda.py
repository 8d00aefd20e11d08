"""The per-round Fiat-Shamir step of the chained provers: the CUDA launch
wrapper and its plain PyTorch version.

Replaces the JAX package's on-device transcript step, `_transcript_step`
(`sumcheck_tpu/protocol/device_prover.py:118-138`) and the
`feed_fr_vec_dyn` / `fr_rand_dyn` tail of the generic round step
(`protocol/generic_prover.py:276-296`). The kernel is `csrc/transcript.cu`
(one warp: the round's elements one per thread, then the hash chain on
four lanes, one Blake2b column each, with native 64-bit words and one copy
of the compression); see its header for what bounds it. The plain version runs `transcript/device.py`
over `fields/limbs_torch.py`.

`transcript_step(state, sums, msgs, rs, j)`, for round `j`:

1. finishes the exact wide sums from `sums`, the round's (d+1, 16) int64
   per-digit sums, summed over the round kernel's blocks (the row the
   kernel added into; the carry chain of `round_cuda.finish_sums`);
2. reduces them mod p (`reduce_wide`) and converts to canonical form
   (`mont_mul_const(., 1)`);
3. feeds them to the transcript as a `Vec<Fr>`;
4. samples the next challenge (`fr_rand`);
5. writes the canonical digits into `msgs[j]` ((nv, 16, d+1) int32), the
   challenge's Montgomery digits into `rs[j]` ((nv, 16) int32), where the
   next fold reads it, and the advanced transcript into `state` ((26, 2)
   int32, the packed state of `transcript/device.py`), all in place.

`transcript_step_batched(state, sums, msgs, rs, j)` does the same for B
transcripts in one launch, one warp each (`_btranscript`,
`sumcheck_tpu/batch.py:303-323`): (B, 26, 2) states, the round's (B, d+1,
16) sums, (nv, B, 16, d+1) msgs and (nv, B, 16) rs. Each transcript keeps
its own pending-byte count.

Each launches the kernel for CUDA tensors and runs its `_ref` for CPU
tensors; it raises for anything else. Nothing waits for the device, so
a whole chain of rounds enqueues without a host sync.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import limbs_torch as LT
from ..fields.fr import NINV32, NUM_DIGITS, P, SHAVE_BITS, WIDE_DIGITS
from ..transcript.device import STATE_WORDS, DevTranscript, feed_fr_vec, fr_rand
from . import cuda_build

SOURCE = cuda_build.source("transcript")
MAX_DEGREE = 8  # `csrc/transcript.cu`: kMaxDegree, the static stream's; past it the window's

_ONE_DIGITS = (1,) + (0,) * (NUM_DIGITS - 1)
# p as 8 x 32-bit limbs (least significant first), -p^-1 mod 2^32, then
# the bits a draw shaves
_FIELD = (ctypes.c_uint32 * 10)(
    *[(P >> (32 * j)) & 0xFFFFFFFF for j in range(8)], NINV32, SHAVE_BITS,
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
    lib.sc_transcript_launch_batched.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # state, sums, degree
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # msgs, rs, j
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p,  # batch, field, stream
    ]
    lib.sc_transcript_launch_batched.restype = ctypes.c_int
    lib.sc_empty_launch.argtypes = [ctypes.c_void_p]
    lib.sc_latency_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.sc_compress_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.sc_empty_launch, lib.sc_latency_launch, lib.sc_compress_probe):
        fn.restype = ctypes.c_int
    lib.sc_transcript_error_string.argtypes = [ctypes.c_int]
    lib.sc_transcript_error_string.restype = ctypes.c_char_p
    return lib


def _check(state, sums, msgs, rs, j: int) -> None:
    """Checks of the single step: (26, 2) state, (d+1, 16) sums, (nv, 16,
    d+1) msgs, (nv, 16) rs."""
    _check_shapes(state, sums, msgs, rs, j, ())


def _check_shapes(state, sums, msgs, rs, j: int, batch: tuple) -> None:
    """`_check` with `batch` = () or (B,): the states and sums lead with it,
    msgs and rs carry it after the round axis."""
    if state.shape != batch + (STATE_WORDS, 2) or state.dtype != torch.int32:
        raise ValueError(f"state must be a {batch + (STATE_WORDS, 2)} int32 tensor")
    if (sums.dim() != len(batch) + 2 or sums.shape[:len(batch)] != batch
            or sums.shape[-1] != NUM_DIGITS or sums.dtype != torch.int64):
        raise ValueError(f"sums must be a {batch + ('d+1', 16)} int64 tensor, got "
                         f"{tuple(sums.shape)}")
    d1 = sums.shape[-2]
    if d1 < 2:
        raise ValueError(f"degree {d1 - 1} is below 1")
    if (msgs.dim() != len(batch) + 3 or msgs.shape[1:] != batch + (NUM_DIGITS, d1)
            or msgs.dtype != torch.int32):
        raise ValueError(f"msgs must be an {('nv',) + batch + (NUM_DIGITS, d1)} int32 tensor")
    if rs.dim() != len(batch) + 2 or rs.shape[1:] != batch + (NUM_DIGITS,) \
            or rs.dtype != torch.int32:
        raise ValueError(f"rs must be an {('nv',) + batch + (NUM_DIGITS,)} int32 tensor")
    if not (0 <= j < msgs.shape[0] and j < rs.shape[0]):
        raise ValueError(f"round {j} is outside the output buffers")
    for x in (sums, msgs, rs):
        if x.device != state.device:
            raise ValueError("transcript step operands lie on different devices")
    if not all(x.is_contiguous() for x in (state, sums, msgs, rs)):
        raise ValueError("transcript step operands must be contiguous")


def _step(state, sums):
    """One transcript's round on plain ops: `state` ((26, 2) int32) advanced
    in place; returns the canonical (16, d+1) digits and the challenge's
    (16,) Montgomery digits, int32."""
    rows = list(sums.T)  # 16 rows of (d+1,) per-digit sums
    zero = torch.zeros_like(rows[0])
    strict, _ = LT._chain(rows + [zero] * (WIDE_DIGITS - NUM_DIGITS))
    mont = LT.reduce_wide(torch.stack(strict))  # (16, d+1) Montgomery form
    canon = LT.mont_mul_const(mont, _ONE_DIGITS)  # * R^-1: canonical
    ts = feed_fr_vec(DevTranscript.from_state(state), canon)
    r, ts = fr_rand(ts)
    state.copy_(ts.to_state())
    return canon.to(torch.int32), r.to(torch.int32)


def transcript_step_ref(state, sums, msgs, rs, j: int) -> None:
    """Plain version of the transcript kernel (any device)."""
    _check(state, sums, msgs, rs, j)
    msgs[j], rs[j] = _step(state, sums)


def _check_batched(state, sums, msgs, rs, j: int) -> int:
    """Checks of the batched step: (B, 26, 2) states, (B, d+1, 16) sums,
    (nv, B, 16, d+1) msgs, (nv, B, 16) rs. Returns B."""
    if state.dim() != 3 or not 1 <= state.shape[0] <= 65535:
        raise ValueError(f"states must be (B, {STATE_WORDS}, 2) with 1 <= B <= 65535, got "
                         f"{tuple(state.shape)}")
    _check_shapes(state, sums, msgs, rs, j, (state.shape[0],))
    return state.shape[0]


def transcript_step_batched_ref(state, sums, msgs, rs, j: int) -> None:
    """Plain version of the batched transcript kernel (any device): the
    single plain step per transcript."""
    batch = _check_batched(state, sums, msgs, rs, j)
    for b in range(batch):
        msgs[j, b], rs[j, b] = _step(state[b], sums[b])


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
        rc = lib.sc_transcript_launch_batched(
            state.data_ptr(), sums.data_ptr(), sums.shape[0] - 1,
            msgs.data_ptr(), rs.data_ptr(), j, 1, _FIELD, stream,
        )
    _raise(rc, "transcript kernel")
    transcript_step.launches += 1


transcript_step.launches = 0


def transcript_step_batched(state, sums, msgs, rs, j: int) -> None:
    """Round j's transcript step of B transcripts in one launch, one warp
    each: `state` (B, 26, 2), `sums` the round's (B, d+1, 16) rows, `msgs`
    (nv, B, 16, d+1), `rs` (nv, B, 16); instance b's outputs go to
    msgs[j, b] and rs[j, b], so the next batched fold reads rs[j] as one
    (B, 16) block. Each transcript keeps its own pending-byte count.
    Launches the CUDA kernel for CUDA tensors, runs
    `transcript_step_batched_ref` for CPU tensors."""
    if state.device.type == "cpu":
        return transcript_step_batched_ref(state, sums, msgs, rs, j)
    if state.device.type != "cuda":
        raise ValueError(f"no transcript kernel for device {state.device}")
    batch = _check_batched(state, sums, msgs, rs, j)
    if state.data_ptr() % 8:
        raise ValueError("the kernel reads the states as 64-bit words: they must be 8-byte "
                         "aligned")
    lib = _library()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.sc_transcript_launch_batched(
            state.data_ptr(), sums.data_ptr(), sums.shape[1] - 1,
            msgs.data_ptr(), rs.data_ptr(), j, batch, _FIELD, stream,
        )
    _raise(rc, "batched transcript kernel")
    transcript_step_batched.launches += 1


transcript_step_batched.launches = 0


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().sc_transcript_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _empty_launch(device) -> None:
    """Test hook of the step's bound: one empty kernel on `device`, whose
    back-to-back time is the launch floor."""
    with torch.cuda.device(device):
        _raise(_library().sc_empty_launch(torch.cuda.current_stream(device).cuda_stream),
               "empty kernel")


def _latency_chain(out, iters: int) -> None:
    """Test hook of the step's bound: `iters` x 16 dependent integer
    instructions (xor, add) on one thread; `out` is a (1,) int32 CUDA
    tensor that receives the chain's end."""
    with torch.cuda.device(out.device):
        _raise(_library().sc_latency_launch(
            out.data_ptr(), iters, torch.cuda.current_stream(out.device).cuda_stream),
            "latency chain")


def _compress_probe(out, iters: int) -> None:
    """Test hook of the kernel's compression: `iters` chained compressions
    of the block of words 0x0123456789ABCDEF * (i + 1), i < 16, from h =
    (1, ..., 8), every eighth with the last flag, at t = 128 k for the k-th,
    by the kernel's four hash lanes. `out` is a (9,) int64 CUDA tensor: the
    final h, then the clocks the chain took."""
    with torch.cuda.device(out.device):
        _raise(_library().sc_compress_probe(
            out.data_ptr(), iters, torch.cuda.current_stream(out.device).cuda_stream),
            "compression probe")
