"""Prover/verifier keys for MLSumcheck.

Equivalents of `ListOfProductsOfPolynomials` (prover key) and
`PolynomialInfo` (verifier key) from the reference
(`src/ml_sumcheck/data_structures.rs:24-109`), including the reference's
object-identity dedup of shared multiplicand tables
(`data_structures.rs:83-96`): the same `DenseMLE` *object* appearing in many
multiplicand slots is stored once in `flattened_ml_extensions` and folded once
per round by the prover. Copied from `sumcheck_tpu/data_structures.py`
without the `field=` promotion (one field in this port so far).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .fields.fr import Fr
from .mle import DenseMLE
from .transcript.serialize import serialize_usize


class PolynomialInfo:
    """Verifier key: shape of the summed polynomial
    (`data_structures.rs:47-55`). Serialization = two u64 LE (usize fields in
    declaration order), fed to the Fiat-Shamir transcript."""

    __slots__ = ("max_multiplicands", "num_variables")

    def __init__(self, max_multiplicands: int, num_variables: int):
        self.max_multiplicands = max_multiplicands
        self.num_variables = num_variables

    def serialize_uncompressed(self) -> bytes:
        return serialize_usize(self.max_multiplicands) + serialize_usize(
            self.num_variables
        )

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, PolynomialInfo)
            and self.max_multiplicands == o.max_multiplicands
            and self.num_variables == o.num_variables
        )

    def __repr__(self) -> str:
        return f"PolynomialInfo(max_multiplicands={self.max_multiplicands}, num_variables={self.num_variables})"


class ListOfProductsOfPolynomials:
    """Prover key: sum_i c_i * prod_j f_ij over shared MLE tables.

    `products` holds `(coefficient: Fr, [indices into
    flattened_ml_extensions])`; identical `DenseMLE` objects (by `id()`, the
    analog of the reference's `Rc` pointer identity) are deduplicated.
    """

    def __init__(self, num_variables: int):
        self.max_multiplicands = 0
        self.num_variables = num_variables
        self.products: list[tuple[Fr, list[int]]] = []
        self.flattened_ml_extensions: list[DenseMLE] = []
        self._id_lookup: dict[int, int] = {}

    def add_product(self, product: Iterable[DenseMLE], coefficient) -> None:
        coefficient = coefficient if isinstance(coefficient, Fr) else Fr(int(coefficient))
        product = list(product)
        assert product, "product must not be empty"
        self.max_multiplicands = max(self.max_multiplicands, len(product))
        indexed = []
        for m in product:
            assert m.num_vars == self.num_variables, (
                "product has a multiplicand with wrong number of variables"
            )
            key = id(m)
            if key in self._id_lookup:
                indexed.append(self._id_lookup[key])
            else:
                idx = len(self.flattened_ml_extensions)
                self.flattened_ml_extensions.append(m)
                self._id_lookup[key] = idx
                indexed.append(idx)
        self.products.append((coefficient, indexed))

    def info(self) -> PolynomialInfo:
        return PolynomialInfo(self.max_multiplicands, self.num_variables)

    def evaluate(self, point: Sequence) -> Fr:
        """Direct evaluation at a point (host-side; used to check subclaims)."""
        evals = [mle.evaluate(point) for mle in self.flattened_ml_extensions]
        total = Fr.zero()
        for coeff, indices in self.products:
            term = coeff
            for i in indices:
                term = term * evals[i]
            total = total + term
        return total
