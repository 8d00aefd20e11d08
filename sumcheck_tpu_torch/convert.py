"""Carry a polynomial across from NumPy arrays.

The JAX package's `DenseMLE.evals` are `(16, 2^nv) uint32` Montgomery digit
arrays in natural index order; the port's `DenseMLE` holds the same arrays.
`polynomial_from_numpy` builds the port's prover key from such arrays, so
both packages prove the same polynomial.
"""

from __future__ import annotations

import numpy as np

from .data_structures import ListOfProductsOfPolynomials
from .fields.fr import NUM_DIGITS, Fr
from .mle import DenseMLE


def polynomial_from_numpy(nv: int, tables, products) -> ListOfProductsOfPolynomials:
    """`tables`: list of `(16, 2^nv) uint32` Montgomery digit arrays;
    `products`: list of `(coeff_int, [table_idx, ...])`. A table index used
    in several products (or twice in one) stays one shared `DenseMLE`, so the
    table identity of the source polynomial is preserved."""
    mles = []
    for t in tables:
        arr = np.ascontiguousarray(t, dtype=np.uint32)
        if arr.shape != (NUM_DIGITS, 1 << nv):
            raise ValueError(f"table shape {arr.shape}, expected {(NUM_DIGITS, 1 << nv)}")
        mles.append(DenseMLE(nv, arr))
    poly = ListOfProductsOfPolynomials(nv)
    for coeff, idx in products:
        poly.add_product([mles[i] for i in idx], Fr(int(coeff)))
    return poly
