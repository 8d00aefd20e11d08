"""arkworks `CanonicalSerialize` (uncompressed mode) byte encodings.

These byte streams drive the Fiat-Shamir transcript, so they must match the
reference bit-exactly (SURVEY.md Stage 1; reference `src/rng.rs:36-41` feeds
`serialize_uncompressed` output into the digest):

- `Fr`            -> 32 LE bytes of the canonical residue
                     (ark-ff `Fp::serialize_with_mode` writes `into_bigint()`
                     limbs little-endian).
- `usize`         -> 8 LE bytes (ark-serialize encodes usize as u64).
- `Vec<T>`        -> u64 LE length prefix, then each element
                     (ark-serialize `impl CanonicalSerialize for Vec<T>`).
- derived structs -> fields in declaration order.
"""

from __future__ import annotations

from ..fields.fr import fr_to_bytes


def serialize_u64(v: int) -> bytes:
    return int(v).to_bytes(8, "little")


def serialize_usize(v: int) -> bytes:
    return serialize_u64(v)


def serialize_fr(x) -> bytes:
    """x: Fr or canonical int."""
    v = x.v if hasattr(x, "v") else int(x)
    return fr_to_bytes(v)


def serialize_fr_vec(xs) -> bytes:
    """Vec<Fr>: u64 LE length + 32 LE bytes per element."""
    return serialize_u64(len(xs)) + b"".join(serialize_fr(x) for x in xs)


def serialize_u8_vec(b: bytes) -> bytes:
    """Vec<u8>: u64 LE length + raw bytes (used by reference rng tests)."""
    return serialize_u64(len(b)) + bytes(b)
