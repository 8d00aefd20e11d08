"""The scalar field: constants and host-side (Python int) arithmetic.

Default field is BLS12-381 Fr, the scalar field used by the reference
library's tests and benches (reference: `Cargo.toml:28`,
`src/ml_sumcheck/test.rs:13`) and the one pinned by the golden fixtures.
``SUMCHECK_TPU_FIELD`` selects another registered prime per process (see
`_FIELDS`: any prime of at most 255 bits with arkworks' 4x64-limb /
R = 2^256 shape drops in); copied from `sumcheck_tpu/fields/fr.py`.

Host-side representation: Python ints holding the *canonical* residue in
[0, P). The device representation (Montgomery form, 16x16-bit digits) lives
in `limbs_np.py` / `limbs_torch.py`; the CUDA kernels take `P`, `NINV32`
and `SHAVE_BITS` from here as launch parameters, so one built library
serves every prime.

Montgomery parameters match arkworks' (R = 2^256 mod p), so a device-resident
Montgomery value is numerically identical to arkworks' internal `Fp` backing
store — which is what `Fr::rand` samples directly (ark-ff 0.4
`Distribution<Fp> for Standard`): the accepted masked draw IS the Montgomery
representation.
"""

from __future__ import annotations

import os

# Field registry: any prime that fits the 16x16-bit / R=2^256 limb shape
# arkworks uses for 4x64-limb fields. The process-wide field is chosen at
# import time via SUMCHECK_TPU_FIELD (a config knob, not a runtime switch:
# the constants below are read into every kernel wrapper at import).
_FIELDS = {
    # BLS12-381 scalar field (255 bits) — the reference's test/bench field
    # (`Cargo.toml:28`), and the one pinned by the golden fixtures.
    "bls12_381_fr": 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    # BN254 scalar field (254 bits)
    "bn254_fr": 0x30644E72E131A029B85045B68181585D2833E84879B97091_43E1F593F0000001,
}
FIELD_NAME = os.environ.get("SUMCHECK_TPU_FIELD", "bls12_381_fr")
if FIELD_NAME not in _FIELDS:
    raise ImportError(
        f"SUMCHECK_TPU_FIELD={FIELD_NAME!r} names no registered field; "
        f"unset it or set it to one of {', '.join(sorted(_FIELDS))}"
    )
P = _FIELDS[FIELD_NAME]
assert P % 2 == 1 and P.bit_length() <= 255
if FIELD_NAME == "bls12_381_fr":
    assert P == 52435875175126190479447740508185965837690552500527637822603658699938581184513
MODULUS_BITS = P.bit_length()
MODULUS_BYTES = 32  # serialized size: arkworks uses limb bytes (4 x u64)
# ark-ff UniformRand masks the top draw limb down to MODULUS_BITS
SHAVE_BITS = 256 - MODULUS_BITS
assert SHAVE_BITS < 32, "top-u32 shave mask assumes <= 31 shaved bits"

# Montgomery constants, R = 2^256 (matches arkworks' 4x64-bit-limb R)
R_BITS = 256
R = (1 << R_BITS) % P
R2 = (R * R) % P
R_INV = pow(R, -1, P)
# conditional subtractions of p that take any value below 2^256 into
# [0, p): 2^256 < (REDUCE_SUBS + 1) p. 2 for BLS12-381 Fr (2^256 < 2.3 p),
# 5 for BN254 Fr (2^256 < 5.3 p).
REDUCE_SUBS = -(-(1 << R_BITS) // P) - 1

# -p^{-1} mod 2^w for digit-serial Montgomery reduction (16-bit digits on the
# host model, 32-bit limbs in the CUDA kernels). They depend on the field:
# BLS12-381's are all-ones (0xFFFF, 0xFFFFFFFF), BN254's 0xFFFF and 0xEFFFFFFF.
NINV16 = (-pow(P, -1, 1 << 16)) % (1 << 16)
NINV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)
# full-width inverse for single-shot Montgomery reduction (the banded
# 8-bit-digit multiply of `ops/mxu_mul.py` and `csrc/round_mxu.cu`)
NINV_FULL = (-pow(P, -1, 1 << R_BITS)) % (1 << R_BITS)

# Device digit layout: 16 digits x 16 bits = 256 bits.
DIGIT_BITS = 16
NUM_DIGITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1
# The kernels' tables (the round pair, `DenseMLE.to_device`): the same 256
# bits as 8 x 32-bit limbs, least significant first (`limbs_torch.pack_limbs`).
NUM_LIMBS = 8
# An exact lane sum of up to 2^64 strict values fits NUM_DIGITS + 4 digits.
WIDE_DIGITS = NUM_DIGITS + 4

# p in 16-bit digits, least significant first
P_DIGITS = tuple((P >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(NUM_DIGITS))


def to_mont(x: int) -> int:
    """Canonical residue -> Montgomery representation (x*R mod p)."""
    return (x * R) % P


def from_mont(m: int) -> int:
    """Montgomery representation -> canonical residue (m*R^-1 mod p)."""
    return (m * R_INV) % P


def fr_to_bytes(x: int) -> bytes:
    """arkworks CanonicalSerialize (uncompressed) of Fr: 32 LE bytes of the
    canonical residue (ark-ff `Fp::serialize_with_mode` writes
    `into_bigint()` limbs little-endian)."""
    return int(x).to_bytes(MODULUS_BYTES, "little")


def fr_from_bytes(b: bytes) -> int:
    from ..utils.errors import SerializationError

    v = int.from_bytes(b, "little")
    if v >= P:
        raise SerializationError("non-canonical Fr encoding")
    return v


class Fr:
    """A scalar field element of the configured field (canonical residue,
    host-side; BLS12-381 Fr by default).

    Mirrors the `ark_ff::Field` surface the reference consumes
    (SURVEY.md L0): + - * / neg, zero/one, `Fr.rand(rng)`, `Fr(int)`.
    """

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % P

    # -- constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "Fr":
        return Fr(0)

    @staticmethod
    def one() -> "Fr":
        return Fr(1)

    @staticmethod
    def from_mont(m: int) -> "Fr":
        return Fr(from_mont(m))

    @staticmethod
    def rand(rng) -> "Fr":
        """Uniform field element from a FeedableRNG, replicating arkworks'
        rejection sampling (see transcript/blake2b_rng.fr_rand)."""
        from ..transcript.blake2b_rng import fr_rand

        return Fr(fr_rand(rng))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fr") -> "Fr":
        return Fr(self.v + o.v)

    def __sub__(self, o: "Fr") -> "Fr":
        return Fr(self.v - o.v)

    def __mul__(self, o: "Fr") -> "Fr":
        return Fr(self.v * o.v)

    def __neg__(self) -> "Fr":
        return Fr(-self.v)

    def __truediv__(self, o: "Fr") -> "Fr":
        return Fr(self.v * pow(o.v, -1, P))

    def inverse(self) -> "Fr":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero field element")
        return Fr(pow(self.v, -1, P))

    def square(self) -> "Fr":
        return Fr(self.v * self.v)

    def __pow__(self, e: int) -> "Fr":
        return Fr(pow(self.v, e, P))

    # -- comparisons / misc ------------------------------------------------
    def __eq__(self, o) -> bool:
        return isinstance(o, Fr) and self.v == o.v

    def __hash__(self) -> int:
        return hash(("Fr", self.v))

    def __repr__(self) -> str:
        return f"Fr({hex(self.v)})"

    def __bool__(self) -> bool:
        return self.v != 0

    def is_zero(self) -> bool:
        return self.v == 0

    # -- encodings ---------------------------------------------------------
    def to_mont(self) -> int:
        return to_mont(self.v)

    def serialize_uncompressed(self) -> bytes:
        return fr_to_bytes(self.v)

    @staticmethod
    def deserialize_uncompressed(b: bytes) -> "Fr":
        return Fr(fr_from_bytes(b))
