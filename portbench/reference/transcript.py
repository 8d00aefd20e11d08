"""arkworks' `Blake2b512Rng` (ark-sumcheck `src/rng.rs`) over `hashlib`,
for the benchmark's reference prover.

The state is a running Blake2b-512 digest. `feed` absorbs bytes. A draw of
n bytes finalises a clone of the digest into a 64-byte block and hands out
its bytes; each block used up whole is absorbed and a fresh clone
finalised; at the end the block in hand is absorbed too, used up or not.
A field element is ark-ff's rejection sample: four u64 draws, least
significant first, the top bits above the modulus's width cleared, drawn
again while the value is not below p; the value drawn is the Montgomery
form, so the element is value·R^-1 mod p.
"""

from __future__ import annotations

import hashlib

BLOCK = 64


class Transcript:
    def __init__(self):
        self._h = hashlib.blake2b(digest_size=BLOCK)

    def feed(self, data: bytes) -> None:
        self._h.update(data)

    def draw(self, n: int) -> bytes:
        out = bytearray()
        block = self._h.copy().digest()
        while n >= BLOCK:
            out += block
            self._h.update(block)
            block = self._h.copy().digest()
            n -= BLOCK
        out += block[:n]
        self._h.update(block)
        return bytes(out)

    def u64(self) -> int:
        return int.from_bytes(self.draw(8), "little")

    def field_element(self, p: int) -> int:
        """ark-ff's `UniformRand` for the field of `p`: the canonical
        residue."""
        width = p.bit_length()
        r_inv = pow((1 << 256) % p, -1, p)
        while True:
            limbs = [self.u64() for _ in range(4)]
            limbs[3] &= (1 << (width - 192)) - 1
            value = sum(w << (64 * i) for i, w in enumerate(limbs))
            if value < p:
                return value * r_inv % p


def u64_bytes(v: int) -> bytes:
    return int(v).to_bytes(8, "little")


def element_bytes(v: int) -> bytes:
    """ark-serialize's uncompressed field element: 32 little-endian bytes
    of the canonical residue."""
    return int(v).to_bytes(32, "little")


def message_bytes(evaluations) -> bytes:
    """A prover message, `Vec<F>`: its length as a u64, then each element."""
    return u64_bytes(len(evaluations)) + b"".join(element_bytes(v) for v in evaluations)


def proof_bytes(messages) -> bytes:
    """A proof, `Vec<ProverMsg>`."""
    return u64_bytes(len(messages)) + b"".join(message_bytes(m) for m in messages)
