"""Explicit-state Blake2b-512 (unkeyed, RFC 7693) — the host-side hash core
behind the Fiat-Shamir transcript.

`hashlib.blake2b` is bit-identical but hides its internal state; a
transcript that continues from an explicit `(h, t, buf)` state (as a device
transcript hands one back) needs the state first-class. Copied unchanged
from `sumcheck_tpu/transcript/blake2b_core.py`; tested byte-for-byte against
`hashlib` in `tests/test_torch_transcript.py`.

Reference transcript semantics being served: the reference's `src/rng.rs`
(`Blake2b512Rng`), which is a running unkeyed Blake2b-512 digest.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1
BLOCK_BYTES = 128
DIGEST_BYTES = 64

IV = (
    0x6A09E667F3BCC908,
    0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1,
    0x510E527FADE682D1,
    0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B,
    0x5BE0CD19137E2179,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

# h[0] ^= param block word 0: digest_length=64, key_length=0, fanout=1, depth=1
H0 = tuple(
    (IV[i] ^ (0x01010000 | DIGEST_BYTES if i == 0 else 0)) for i in range(8)
)


def _ror(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def compress(h: list[int], block: bytes, t: int, last: bool) -> list[int]:
    """One Blake2b F round: h (8 u64), block (128 bytes), t = total bytes
    compressed *including* this block. Returns new h."""
    m = [int.from_bytes(block[8 * i : 8 * i + 8], "little") for i in range(16)]
    v = list(h) + list(IV)
    v[12] ^= t & MASK64
    v[13] ^= t >> 64
    if last:
        v[14] ^= MASK64

    for s in SIGMA:
        for i, (a, b, c, d) in enumerate(
            ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
             (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))
        ):
            x, y = m[s[2 * i]], m[s[2 * i + 1]]
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va = (va + vb + x) & MASK64
            vd = _ror(vd ^ va, 32)
            vc = (vc + vd) & MASK64
            vb = _ror(vb ^ vc, 24)
            va = (va + vb + y) & MASK64
            vd = _ror(vd ^ va, 16)
            vc = (vc + vd) & MASK64
            vb = _ror(vb ^ vc, 63)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


class Blake2b512:
    """Streaming unkeyed Blake2b-512 with exposed state.

    State triple: `h` (8 u64 words), `t` (bytes compressed so far), `buf`
    (0..128 pending bytes — the final block is always held back so it can be
    compressed with the `last` flag)."""

    __slots__ = ("h", "t", "buf")

    def __init__(self, h=None, t: int = 0, buf: bytes = b""):
        self.h = list(h) if h is not None else list(H0)
        self.t = t
        self.buf = buf

    def copy(self) -> "Blake2b512":
        return Blake2b512(self.h, self.t, self.buf)

    def update(self, data: bytes) -> None:
        buf = self.buf + data
        # keep at least one byte (and at most a full block) pending
        while len(buf) > BLOCK_BYTES:
            self.t += BLOCK_BYTES
            self.h = compress(self.h, buf[:BLOCK_BYTES], self.t, last=False)
            buf = buf[BLOCK_BYTES:]
        self.buf = buf

    def digest(self) -> bytes:
        block = self.buf + b"\x00" * (BLOCK_BYTES - len(self.buf))
        h = compress(self.h, block, self.t + len(self.buf), last=True)
        return b"".join(w.to_bytes(8, "little") for w in h)

    # --- device interop -------------------------------------------------
    def state_tuple(self) -> tuple[list[int], int, bytes]:
        """(h, t, buf) snapshot for lifting onto the device transcript."""
        return (list(self.h), self.t, self.buf)

    @classmethod
    def from_state(cls, h, t: int, buf: bytes) -> "Blake2b512":
        return cls(h, t, buf)
