"""Per-instance prime fields — the constructor-level field choice the
reference gets from its `F: Field` generic (`src/ml_sumcheck/mod.rs:19`).

The kernel wrappers read the process-default field's constants at import
(`fields/fr.py`, selected by ``SUMCHECK_TPU_FIELD``), so the CUDA kernels,
the chains and the device transcript serve exactly one prime per process.
This module removes the *API* restriction: any registered (or ad-hoc)
prime of the arkworks 4x64-limb / R=2^256 shape can be used per instance —
`ListOfProductsOfPolynomials(nv, field=...)` — with proofs produced by the
portable host engine (`sumcheck_tpu_torch/portable.py`), byte-compatible
with an arkworks instantiation over the same field. Two fields therefore
coexist in one process: the default one on the kernels, any others on the
host. Copied from `sumcheck_tpu/fields/generic.py`.
"""

from __future__ import annotations

from .fr import _FIELDS, FIELD_NAME
from .fr import Fr as _DefaultFr


class FieldEl:
    """Element of a `Field` (canonical residue). Same operator surface as
    the default-field `Fr` (SURVEY.md L0)."""

    __slots__ = ("f", "v")

    def __init__(self, f: "Field", v: int):
        self.f = f
        self.v = v % f.P

    def _coerce(self, o) -> int:
        if isinstance(o, FieldEl):
            assert o.f is self.f, "mixed-field arithmetic"
            return o.v
        if isinstance(o, _DefaultFr):
            raise TypeError("mixing default-field Fr with a generic FieldEl")
        return int(o)

    def __add__(self, o):
        return FieldEl(self.f, self.v + self._coerce(o))

    def __sub__(self, o):
        return FieldEl(self.f, self.v - self._coerce(o))

    def __mul__(self, o):
        return FieldEl(self.f, self.v * self._coerce(o))

    def __neg__(self):
        return FieldEl(self.f, -self.v)

    def __truediv__(self, o):
        return FieldEl(self.f, self.v * pow(self._coerce(o), -1, self.f.P))

    def inverse(self) -> "FieldEl":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero field element")
        return FieldEl(self.f, pow(self.v, -1, self.f.P))

    def __eq__(self, o) -> bool:
        return isinstance(o, FieldEl) and o.f is self.f and o.v == self.v

    def __hash__(self) -> int:
        return hash((self.f.P, self.v))

    def __repr__(self) -> str:
        return f"FieldEl<{self.f.name}>({hex(self.v)})"

    def __bool__(self) -> bool:
        return self.v != 0

    def is_zero(self) -> bool:
        return self.v == 0

    def serialize_uncompressed(self) -> bytes:
        """arkworks uncompressed Fp: 32 LE bytes of the canonical residue."""
        return self.v.to_bytes(32, "little")


class Field:
    """A prime field of the arkworks 4x64-limb shape (p odd, <= 255 bits).

    Carries every derived constant the protocol needs (Montgomery R = 2^256,
    `num_bits_to_shave` mask for `UniformRand`). `is_default` fields are
    served by the kernels through the existing `Fr` class; all others run
    the portable engine."""

    __slots__ = ("name", "P", "MODULUS_BITS", "SHAVE_BITS", "R", "R_INV",
                 "R2", "_draw_mask", "is_default")

    def __init__(self, prime: int, name: str = ""):
        if not (prime % 2 == 1 and 3 <= prime.bit_length() <= 255):
            raise ValueError(
                f"unsupported field modulus ({prime.bit_length()}-bit, "
                f"{'even' if prime % 2 == 0 else 'odd'}): sumcheck_tpu_torch "
                "serves odd primes of 3..255 bits in the arkworks "
                "4x64-limb / R=2^256 Montgomery shape — see README.md "
                "'Field support envelope' for the exact contract "
                "(extension fields and wider primes are out of scope)"
            )
        self.P = prime
        self.name = name or f"prime_{prime.bit_length()}b_{prime % 100000}"
        self.MODULUS_BITS = prime.bit_length()
        self.SHAVE_BITS = 256 - self.MODULUS_BITS
        self.R = (1 << 256) % prime
        self.R_INV = pow(self.R, -1, prime)
        self.R2 = (self.R * self.R) % prime
        self._draw_mask = (1 << self.MODULUS_BITS) - 1
        self.is_default = prime == _FIELDS.get(FIELD_NAME)

    # -- element constructors -----------------------------------------------
    def el(self, v: int):
        """An element of this field. Default field -> the fast `Fr` class
        (so fast-path structures and kernels accept it unchanged)."""
        if self.is_default:
            return _DefaultFr(int(v))
        return FieldEl(self, int(v))

    def __call__(self, v: int):
        return self.el(v)

    def zero(self):
        return self.el(0)

    def one(self):
        return self.el(1)

    def rand(self, rng):
        """Uniform element via ark-ff 0.4 `UniformRand` rejection sampling
        over a FeedableRNG (same byte schedule as `Fr.rand` — 4 `next_u64`
        draws per attempt, top limb masked to MODULUS_BITS, accepted draw is
        the Montgomery representation)."""
        if self.is_default:
            return _DefaultFr.rand(rng)
        draw = getattr(rng, "next_u64s_bytes", None)
        if draw is None:
            def draw(k, _r=rng):
                return b"".join(
                    _r.next_u64().to_bytes(8, "little") for _ in range(k)
                )
        while True:
            mont = int.from_bytes(draw(4), "little") & self._draw_mask
            if mont < self.P:
                return self.el(mont * self.R_INV % self.P)

    def deserialize_uncompressed(self, b: bytes):
        from ..utils.errors import SerializationError

        v = int.from_bytes(b, "little")
        if v >= self.P:
            raise SerializationError("non-canonical field encoding")
        return self.el(v)

    def __repr__(self) -> str:
        return f"Field({self.name}, {self.MODULUS_BITS} bits)"


_cache: dict = {}


def get_field(name_or_prime) -> Field:
    """Field by registry name (`fields/fr._FIELDS`) or by literal prime."""
    key = name_or_prime
    f = _cache.get(key)
    if f is None:
        if isinstance(name_or_prime, str):
            f = Field(_FIELDS[name_or_prime], name_or_prime)
        else:
            f = Field(int(name_or_prime))
        _cache[key] = f
    return f


def default_field() -> Field:
    return get_field(FIELD_NAME)
