"""Fiat-Shamir transcript: bit-exact replica of the reference `Blake2b512Rng`.

Reference behavior (the reference's `src/rng.rs`):

- State is a *running* Blake2b-512 digest (unkeyed, 64-byte output).
- `feed(msg)` absorbs `msg.serialize_uncompressed()` bytes (`rng.rs:36-41`).
- `fill_bytes(dest)` (`rng.rs:61-80`): clone the running digest, finalize to a
  64-byte block, emit bytes from it; whenever a block is fully consumed,
  absorb it into the running digest and finalize a fresh clone for the next
  block; after the destination is filled, absorb the currently-held block
  (even if partially — or not at all — consumed).  Note the corner case: a
  64-byte-aligned request absorbs the exhausted block inside the loop AND the
  freshly generated (unconsumed) block at exit.
- `next_u32`/`next_u64`: separate `fill_bytes(4)`/`fill_bytes(8)` calls, LE.

`fr_rand` replicates ark-ff 0.4's `Distribution<Fp> for Standard`: draw 4
u64 limbs (least-significant first, one `next_u64` each), mask the top limb to
MODULUS_BITS (`num_bits_to_shave()` bits shaved), reject if >= modulus — and
the accepted bigint IS the Montgomery representation, so the canonical value
is `draw * R^-1 mod p`.

Copied from `sumcheck_tpu/transcript/blake2b_rng.py`. Hashing runs in the
C core (`_NativeCore` over `native/fastrng.c`) unless
``SUMCHECK_TPU_NATIVE=off``, and then in `hashlib` (`_FastCore`) or, after
`set_state`, in the explicit-state core (`blake2b_core.Blake2b512`). Every
core gives the same bytes and the same `(h, t, buf)` state tuples.
"""

from __future__ import annotations

import ctypes
import hashlib

from ..fields.fr import NINV_FULL, P, R_INV, SHAVE_BITS
from ..native import lib as _native_lib
from .blake2b_core import Blake2b512

_BLOCK = 64  # Blake2b512 output size

_M64 = (1 << 64) - 1
_P_LIMBS_C = (ctypes.c_uint64 * 4)(
    P & _M64, (P >> 64) & _M64, (P >> 128) & _M64, (P >> 192) & _M64
)
_SHAVE_MASK64 = (1 << (64 - SHAVE_BITS)) - 1
_NINV64 = NINV_FULL & _M64  # -p^-1 mod 2^64 (low limb of the 2^256 inverse)


class _NativeCore:
    """ctypes front for the C transcript core (`native/fastrng.c`) — the
    surface of `_FastCore` plus direct draw entry points. One C call per
    transcript operation instead of 8-12 hashlib calls per field draw."""

    __slots__ = ("_lib", "_ctx", "_o32", "_o64")

    def __init__(self, lib, state=None):
        self._lib = lib
        self._ctx = ctypes.create_string_buffer(512)
        self._o32 = ctypes.create_string_buffer(32)  # reused draw output
        self._o64 = ctypes.create_string_buffer(64)
        if state is None:
            lib.b2_init(self._ctx)
        else:
            h, t, buf = state
            harr = (ctypes.c_uint64 * 8)(*(w & _M64 for w in h))
            lib.b2_set_state(self._ctx, harr, ctypes.c_uint64(t),
                             bytes(buf), ctypes.c_uint64(len(buf)))

    def update(self, data: bytes) -> None:
        self._lib.b2_update(self._ctx, data, ctypes.c_uint64(len(data)))

    def digest_clone(self) -> bytes:
        out = self._o64
        self._lib.b2_digest(self._ctx, out)
        return out.raw

    def copy(self):
        # only ever used as `.copy().digest()` (finalize-a-clone)
        return _Finalizer(self)

    def fill(self, n: int) -> bytes:
        out = ctypes.create_string_buffer(max(n, 1))
        self._lib.b2_fill(self._ctx, out, ctypes.c_uint64(n))
        return out.raw[:n]

    def draw4(self) -> bytes:
        out = self._o32
        self._lib.b2_draw4(self._ctx, out)
        return out.raw

    def fr_draw_canonical(self) -> int:
        """Rejection-sample one field element (the whole ark-ff loop and the
        Montgomery -> canonical REDC in C); returns the canonical residue."""
        out = self._o32
        self._lib.b2_fr_draw_canonical(
            self._ctx, _P_LIMBS_C, _SHAVE_MASK64, _NINV64, out
        )
        return int.from_bytes(out.raw, "little")

    def state_tuple(self):
        h = (ctypes.c_uint64 * 8)()
        t = ctypes.c_uint64()
        buf = ctypes.create_string_buffer(128)
        blen = ctypes.c_uint64()
        self._lib.b2_get_state(self._ctx, h, ctypes.byref(t), buf,
                               ctypes.byref(blen))
        return (list(h), int(t.value), buf.raw[: int(blen.value)])


class _Finalizer:
    __slots__ = ("_core",)

    def __init__(self, core):
        self._core = core

    def digest(self) -> bytes:
        return self._core.digest_clone()


class _FastCore:
    """hashlib-backed Blake2b-512 with a byte log.

    The C implementation is ~500x faster per compression than the explicit
    pure-Python core, but hides its internal state. The explicit `(h, t,
    buf)` state is needed only when a transcript is handed to another core —
    so we hash with hashlib and keep the absorbed byte stream;
    `state_tuple()` replays that stream through the explicit core. After
    `set_state`, the rng switches to the pure-Python core
    (`Blake2b512.from_state`), since hashlib cannot be re-seeded."""

    __slots__ = ("_h", "_log")

    def __init__(self):
        self._h = hashlib.blake2b(digest_size=64)
        self._log = bytearray()

    def update(self, data: bytes) -> None:
        self._h.update(data)
        self._log += data

    def copy(self):
        return self._h.copy()  # callers only .digest() the copy

    def state_tuple(self):
        core = Blake2b512()
        core.update(bytes(self._log))
        return core.state_tuple()


class Blake2b512Rng:
    """Deterministic feed/sample transcript (`FeedableRNG` equivalent).

    Transcripts hash through the C core (`_NativeCore`), fresh or from an
    explicit `(h, t, buf)` state (`set_state`). With
    ``SUMCHECK_TPU_NATIVE=off``, fresh transcripts hash through `hashlib`
    (`_FastCore`) and the explicit-state core (`blake2b_core.Blake2b512`)
    takes over after `set_state`."""

    __slots__ = ("_h",)

    def __init__(self):
        nat = _native_lib()
        self._h = _NativeCore(nat) if nat is not None else _FastCore()

    @classmethod
    def setup(cls) -> "Blake2b512Rng":
        return cls()

    def feed_bytes(self, data: bytes) -> None:
        """Absorb raw serialized bytes (caller already encoded the message)."""
        self._h.update(data)

    def feed(self, msg) -> None:
        """Absorb a message. Accepts raw `bytes` (pre-serialized) or any
        object exposing `serialize_uncompressed()`."""
        if isinstance(msg, (bytes, bytearray)):
            self._h.update(bytes(msg))
        else:
            self._h.update(msg.serialize_uncompressed())

    def fill_bytes(self, n: int) -> bytes:
        # Block-sliced form of `rng.rs:61-80`: emit from a finalized clone;
        # every fully-consumed 64-byte block is re-absorbed and re-finalized;
        # the block held at exit (even unconsumed — the 64-aligned corner
        # case) is absorbed too. Byte-identical to the per-byte loop.
        fast = getattr(self._h, "fill", None)
        if fast is not None:
            return fast(n)
        out = bytearray()
        rem = n
        block = self._h.copy().digest()
        while rem >= _BLOCK:
            out += block
            self._h.update(block)
            block = self._h.copy().digest()
            rem -= _BLOCK
        out += block[:rem]
        self._h.update(block)
        return bytes(out)

    def next_u32(self) -> int:
        return int.from_bytes(self.fill_bytes(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(self.fill_bytes(8), "little")

    def next_u64s(self, k: int) -> list[int]:
        """`k` consecutive `next_u64` draws (`sumcheck_tpu/transcript/
        blake2b_rng.py:203-217`)."""
        raw = self.next_u64s_bytes(k)
        return [int.from_bytes(raw[8 * i:8 * i + 8], "little") for i in range(k)]

    def next_u64s_bytes(self, k: int) -> bytes:
        """`k` consecutive `next_u64` draws' little-endian bytes, concatenated
        (each is a separate sub-block `fill_bytes(8)` — they cannot be merged
        into one 64-byte squeeze without changing the byte stream)."""
        if k == 4:
            draw4 = getattr(self._h, "draw4", None)
            if draw4 is not None:
                return draw4()
        h = self._h
        copy, update = h.copy, h.update
        chunks = []
        for _ in range(k):
            block = copy().digest()
            chunks.append(block[:8])
            update(block)
        return b"".join(chunks)

    def state_tuple(self):
        """(h, t, buf) of the running hasher."""
        return self._h.state_tuple()

    def set_state(self, h, t: int, buf: bytes) -> None:
        """Continue from an explicit hasher state."""
        nat = _native_lib()
        if nat is not None:
            self._h = _NativeCore(nat, state=(h, t, buf))
        else:
            self._h = Blake2b512.from_state(h, t, buf)


# 256-bit draw -> masked to MODULUS_BITS (`num_bits_to_shave()` top bits)
_DRAW_MASK = (1 << (256 - SHAVE_BITS)) - 1


def fr_rand(rng) -> int:
    """Sample a uniform Fr exactly as `ark_ff::UniformRand` does; returns the
    canonical residue as a Python int. Draws through the first the rng has,
    in the JAX package's order: the native core's whole loop,
    `next_u64s_bytes`, `next_u64s`, four `next_u64` calls."""
    native = getattr(getattr(rng, "_h", None), "fr_draw_canonical", None)
    if native is not None:  # the whole rejection loop and REDC in C, one call
        return native()
    fast = getattr(rng, "next_u64s_bytes", None)
    if fast is not None:
        while True:
            mont = int.from_bytes(fast(4), "little") & _DRAW_MASK
            if mont < P:
                return (mont * R_INV) % P
    draw = getattr(rng, "next_u64s", None)
    if draw is None:  # duck-typed external FeedableRNG without the fast path
        def draw(k, _r=rng):
            return [_r.next_u64() for _ in range(k)]
    while True:
        limbs = draw(4)
        limbs[3] &= (1 << (64 - SHAVE_BITS)) - 1  # num_bits_to_shave()
        mont = limbs[0] | (limbs[1] << 64) | (limbs[2] << 128) | (limbs[3] << 192)
        if mont < P:
            return (mont * R_INV) % P
