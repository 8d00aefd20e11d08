"""Carry a polynomial or a GKR instance across from NumPy arrays.

The JAX package's `DenseMLE.evals` are `(16, 2^nv) uint32` Montgomery digit
arrays in natural index order, and its `SparseMLE` holds `indices` (int64)
and `values` (`(16, nnz) uint32` Montgomery digits); the port's MLEs hold
the same arrays. `polynomial_from_numpy` and `gkr_instance_from_numpy` build
the port's inputs from such arrays, so both packages prove the same thing.
"""

from __future__ import annotations

import numpy as np

from .data_structures import ListOfProductsOfPolynomials
from .fields.fr import NUM_DIGITS, Fr
from .mle import DenseMLE, SparseMLE


def _dense(nv: int, table) -> DenseMLE:
    arr = np.ascontiguousarray(table, dtype=np.uint32)
    if arr.shape != (NUM_DIGITS, 1 << nv):
        raise ValueError(f"table shape {arr.shape}, expected {(NUM_DIGITS, 1 << nv)}")
    return DenseMLE(nv, arr)


def gkr_instance_from_numpy(dim: int, f1_indices, f1_values, f2, f3, g):
    """A GKR instance `(f1, f2, f3, g)` for `GKRRoundSumcheck.prove`:
    `f1_indices` (nnz,) and `f1_values` (16, nnz) uint32 are the sparse
    f1 over 3*dim variables, `f2`, `f3` (16, 2^dim) uint32 tables, `g` the
    dim canonical point coordinates as ints."""
    idx = np.asarray(f1_indices, dtype=np.int64)
    vals = np.ascontiguousarray(f1_values, dtype=np.uint32)
    if idx.ndim != 1 or vals.shape != (NUM_DIGITS, len(idx)):
        raise ValueError(f"f1 indices {idx.shape} and values {vals.shape} do not match")
    if len(g) != dim:
        raise ValueError(f"g has {len(g)} coordinates, expected {dim}")
    return (SparseMLE(3 * dim, idx, vals), _dense(dim, f2), _dense(dim, f3),
            [Fr(int(v)) for v in g])


def polynomial_from_numpy(nv: int, tables, products) -> ListOfProductsOfPolynomials:
    """`tables`: list of `(16, 2^nv) uint32` Montgomery digit arrays;
    `products`: list of `(coeff_int, [table_idx, ...])`. A table index used
    in several products (or twice in one) stays one shared `DenseMLE`, so the
    table identity of the source polynomial is preserved."""
    mles = [_dense(nv, t) for t in tables]
    poly = ListOfProductsOfPolynomials(nv)
    for coeff, idx in products:
        poly.add_product([mles[i] for i in idx], Fr(int(coeff)))
    return poly
