"""The Fiat-Shamir transcript as tensor ops: Blake2b-512 and arkworks
rejection sampling over 64-bit words kept as 32-bit halves in `int64`
tensors, on any torch device.

Port of `sumcheck_tpu/transcript/device.py` (`compress`, `DevTranscript`,
`blen_after_feed`, `_lt_p`, `_words_to_digits`, `fr_rand`, `feed_fr_vec`).
This is the plain version of the transcript kernel (`csrc/transcript.cu`,
`ops/transcript_cuda.py`): the CPU path runs it, and the tests and
`chip_smoke.py` hold the kernel against it. PyTorch's CPU build has no
`uint32` `+` or `>>`, so a 64-bit word is a (..., 2) int64 pair of 32-bit
halves (low, high), as the JAX version keeps uint32 pairs.

The JAX version splits into ops with a static pending length (one program
per byte offset) and `_dyn` ops with a traced one; that split is an XLA
compile artifact. Here one implementation keeps the pending length `blen`
as a Python int and serves both chains. The rejection loop reads its
verdict with `.item()`.

Bit-exactness: the byte schedule mirrors `transcript/blake2b_rng.py`
(itself tested against `hashlib`): `feed` absorbs serialized bytes; each
`next_u64` finalizes a clone, takes its first 8 bytes and re-absorbs the
whole 64-byte block; `fr_rand` draws 4 u64 (least significant first),
shaves the top bits and rejects a draw >= p; the accepted draw is the
Montgomery representation. Every absorbed length is a multiple of 8 bytes.

Packed state: the kernel keeps the transcript in one (26, 2) int32 tensor,
26 little-endian 64-bit words: h[0..8), t, buf[0..16) (zero past blen),
blen. `DevTranscript.from_state` / `to_state` convert.
"""

from __future__ import annotations

import functools

import torch

from ..fields.fr import NUM_DIGITS, P_DIGITS, SHAVE_BITS
from .blake2b_core import BLOCK_BYTES, IV, SIGMA

STATE_WORDS = 26
_M32 = (1 << 32) - 1
_SHAVE_MASK = (1 << (32 - SHAVE_BITS)) - 1  # on the top 32-bit half of a draw


def _halves(vals, device) -> torch.Tensor:
    """Python u64 iterable -> (n, 2) int64 (low, high) halves."""
    return torch.tensor([(v & _M32, (v >> 32) & _M32) for v in vals],
                        dtype=torch.int64, device=device).reshape(-1, 2)


@functools.cache
def _consts(device: torch.device):
    sigma = torch.tensor(SIGMA, dtype=torch.int64, device=device)
    return _halves(IV, device), sigma


def _add64(a, b):
    s = a + b
    lo = s[..., 0]
    hi = s[..., 1] + (lo >> 32)
    return torch.stack([lo & _M32, hi & _M32], dim=-1)


def _ror64(x, n: int):
    lo, hi = x[..., 0], x[..., 1]
    if n == 32:
        return torch.stack([hi, lo], dim=-1)
    if n > 32:  # ror n == swap, then ror (n - 32)
        lo, hi, n = hi, lo, n - 32
    nlo = (lo >> n) | ((hi << (32 - n)) & _M32)
    nhi = (hi >> n) | ((lo << (32 - n)) & _M32)
    return torch.stack([nlo, nhi], dim=-1)


def _g(a, b, c, d, x, y):
    """Blake2b G over 4 lanes; operands (4, 2) halves."""
    a = _add64(_add64(a, b), x)
    d = _ror64(d ^ a, 32)
    c = _add64(c, d)
    b = _ror64(b ^ c, 24)
    a = _add64(_add64(a, b), y)
    d = _ror64(d ^ a, 16)
    c = _add64(c, d)
    b = _ror64(b ^ c, 63)
    return a, b, c, d


def compress(h, m, t, last: bool):
    """Blake2b F. h: (8, 2) halves; m: (16, 2) halves; t: total bytes
    including this block (a () int64 tensor or an int, < 2^63)."""
    iv, sigma = _consts(h.device)
    va, vb = h[0:4], h[4:8]
    vc = iv[0:4]
    vd = iv[4:8].clone()
    vd[0, 0] ^= t & _M32
    vd[0, 1] ^= (t >> 32) & _M32
    if last:
        vd[2] ^= _M32
    for r in range(12):
        s = sigma[r]
        # column step: G(v0,v4,v8,v12) .. G(v3,v7,v11,v15)
        va, vb, vc, vd = _g(va, vb, vc, vd, m[s[0:8:2]], m[s[1:8:2]])
        # diagonal step: rotate rows
        vb = torch.roll(vb, -1, dims=0)
        vc = torch.roll(vc, -2, dims=0)
        vd = torch.roll(vd, -3, dims=0)
        va, vb, vc, vd = _g(va, vb, vc, vd, m[s[8:16:2]], m[s[9:16:2]])
        vb = torch.roll(vb, 1, dims=0)
        vc = torch.roll(vc, 2, dims=0)
        vd = torch.roll(vd, 3, dims=0)
    return h ^ torch.cat([va, vb]) ^ torch.cat([vc, vd])


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


class DevTranscript:
    """A transcript on a torch device: `h` (8, 2) and `buf` (16, 2) halves
    (the pending block, zero past `blen`), `t` a () int64 tensor (bytes
    compressed), `blen` an int (pending bytes, a multiple of 8)."""

    __slots__ = ("h", "t", "buf", "blen")

    def __init__(self, h, t, buf, blen: int):
        if blen % 8 or not 0 <= blen <= BLOCK_BYTES:
            raise ValueError(f"pending byte count {blen} is not a multiple of 8 in [0, 128]")
        self.h, self.t, self.buf, self.blen = h, t, buf, blen

    # --- host <-> device ------------------------------------------------
    @classmethod
    def lift(cls, state_tuple) -> "DevTranscript":
        """From `Blake2b512Rng.state_tuple()` (host snapshot), on the CPU."""
        h, t, buf = state_tuple
        if len(buf) % 8:
            raise ValueError("transcript byte alignment must be 8 to run on the device")
        words = [int.from_bytes(buf[8 * i : 8 * i + 8], "little") for i in range(len(buf) // 8)]
        words += [0] * (16 - len(words))
        return cls(_halves(h, None), torch.tensor(t, dtype=torch.int64),
                   _halves(words, None), len(buf))

    def lower(self) -> tuple[list[int], int, bytes]:
        """To host `(h, t, buf)`, the form of `Blake2b512Rng.state_tuple()`."""
        h = self.h.cpu().tolist()
        buf = self.buf.cpu().tolist()
        hw = [lo | (hi << 32) for lo, hi in h]
        bb = b"".join((lo | (hi << 32)).to_bytes(8, "little") for lo, hi in buf[: self.blen // 8])
        return hw, int(self.t), bb

    @classmethod
    def from_state(cls, state: torch.Tensor) -> "DevTranscript":
        """From the kernel's packed (26, 2) int32 state."""
        if state.shape != (STATE_WORDS, 2) or state.dtype != torch.int32:
            raise ValueError(f"packed state must be ({STATE_WORDS}, 2) int32")
        x = state.long() & _M32
        return cls(x[0:8], x[8, 0] | (x[8, 1] << 32), x[9:25], int(x[25, 0]))

    def to_state(self) -> torch.Tensor:
        """To the kernel's packed (26, 2) int32 state."""
        t = torch.stack([self.t & _M32, self.t >> 32]).reshape(1, 2)
        blen = torch.tensor([[self.blen, 0]], dtype=torch.int64, device=self.h.device)
        return _to_int32(torch.cat([self.h, t, self.buf, blen]))

    # --- hashing ----------------------------------------------------------
    def absorb(self, words, nbytes: int) -> "DevTranscript":
        """Absorb `nbytes` (a multiple of 8) from `words` ((nbytes/8, 2)
        halves). Mirrors `Blake2b512.update`: a full pending block is
        compressed only when more bytes arrive."""
        if nbytes % 8 or words.shape[0] != nbytes // 8:
            raise ValueError("absorb takes whole 8-byte words")
        total = self.blen + nbytes
        pend = torch.cat([self.buf[: self.blen // 8], words])
        h, t = self.h, self.t
        while total > BLOCK_BYTES:
            t = t + BLOCK_BYTES
            h = compress(h, pend[:16], t, last=False)
            pend = pend[16:]
            total -= BLOCK_BYTES
        pad = torch.zeros((16 - pend.shape[0], 2), dtype=torch.int64, device=pend.device)
        return DevTranscript(h, t, torch.cat([pend, pad]), total)

    def finalize_clone(self):
        """Digest of a clone of the running state: (8, 2) halves = 64 bytes."""
        return compress(self.h, self.buf, self.t + self.blen, last=True)

    def next_u64(self):
        """One `fill_bytes(8)`: emit word 0 of a finalized clone, re-absorb
        the full 64-byte block (the reference rng's semantics)."""
        block = self.finalize_clone()
        return block[0], self.absorb(block, 64)


def blen_after_feed(blen: int, nbytes: int) -> int:
    """Pending byte count after absorbing `nbytes`. (`fr_rand` leaves the
    count unchanged: each attempt absorbs 256 bytes = 2 whole blocks.)"""
    total = blen + nbytes
    while total > BLOCK_BYTES:
        total -= BLOCK_BYTES
    return total


def _lt_p(digits) -> torch.Tensor:
    """(16,) strict digits -> () bool: value < p (borrow-chain compare)."""
    borrow = 0
    for i in range(NUM_DIGITS):
        t = digits[i] + ((1 << 16) - P_DIGITS[i]) - borrow
        borrow = 1 - (t >> 16)
    return borrow == 1


def _words_to_digits(words):
    """(4, 2) halves (least significant word first) -> (16,) strict
    16-bit digits."""
    flat = words.reshape(8)
    return torch.stack([flat & 0xFFFF, flat >> 16], dim=1).reshape(NUM_DIGITS)


def fr_rand(ts: DevTranscript):
    """Sample one Fr challenge exactly as `ark_ff::UniformRand` over this
    transcript. Returns ((16,) int64 strict digits of the accepted draw,
    which is the Montgomery representation, and the advanced transcript)."""
    while True:
        ws = []
        for _ in range(4):
            w, ts = ts.next_u64()
            ws.append(w)
        words = torch.stack(ws)  # (4, 2)
        words[3, 1] &= _SHAVE_MASK  # num_bits_to_shave()
        digits = _words_to_digits(words)
        if bool(_lt_p(digits).item()):
            return digits, ts


def feed_fr_vec(ts: DevTranscript, digits_canonical) -> DevTranscript:
    """Absorb a `Vec<Fr>`: u64 LE length prefix, then 32 canonical LE bytes
    per element (arkworks `serialize_uncompressed`). digits_canonical:
    (16, k) strict digits of canonical residues, not Montgomery."""
    d = digits_canonical.long()
    k = d.shape[1]
    halves = d[0::2] | (d[1::2] << 16)  # (8, k): 32-bit halves, word-major
    words = halves.T.reshape(4 * k, 2)  # element-major (4k, 2)
    prefix = _halves([k], d.device)
    return ts.absorb(torch.cat([prefix, words]), 8 + 32 * k)
