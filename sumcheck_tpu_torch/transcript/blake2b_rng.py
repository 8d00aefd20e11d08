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

Copied from `sumcheck_tpu/transcript/blake2b_rng.py` without the C transcript
core: hashing runs in `hashlib` (`_FastCore`) or, after `set_state`, in the
explicit-state core (`blake2b_core.Blake2b512`).
"""

from __future__ import annotations

import hashlib

from ..fields.fr import P, R_INV, SHAVE_BITS
from .blake2b_core import Blake2b512

_BLOCK = 64  # Blake2b512 output size


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

    Fresh transcripts hash through `hashlib` (`_FastCore`). The
    explicit-state core (`blake2b_core.Blake2b512`) takes over only after
    `set_state`, where continuing from an arbitrary `(h, t, buf)` is
    required."""

    __slots__ = ("_h",)

    def __init__(self):
        self._h = _FastCore()

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

    def next_u64s_bytes(self, k: int) -> bytes:
        """`k` consecutive `next_u64` draws' little-endian bytes, concatenated
        (each is a separate sub-block `fill_bytes(8)` — they cannot be merged
        into one 64-byte squeeze without changing the byte stream)."""
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
        self._h = Blake2b512.from_state(h, t, buf)


# 256-bit draw -> masked to MODULUS_BITS (`num_bits_to_shave()` top bits)
_DRAW_MASK = (1 << (256 - SHAVE_BITS)) - 1


def fr_rand(rng) -> int:
    """Sample a uniform Fr exactly as `ark_ff::UniformRand` does; returns the
    canonical residue as a Python int."""
    fast = getattr(rng, "next_u64s_bytes", None)
    if fast is not None:
        while True:
            mont = int.from_bytes(fast(4), "little") & _DRAW_MASK
            if mont < P:
                return (mont * R_INV) % P
    while True:  # duck-typed external FeedableRNG without the fast path
        limbs = [rng.next_u64() for _ in range(4)]
        limbs[3] &= (1 << (64 - SHAVE_BITS)) - 1  # num_bits_to_shave()
        mont = limbs[0] | (limbs[1] << 64) | (limbs[2] << 128) | (limbs[3] << 192)
        if mont < P:
            return (mont * R_INV) % P
