"""Fault F4's product structures, shared by the port's tests (no JAX, no
torch: plain ints and lists).

The kernels carry a by-value plan up to 16 slots, 16 products, 8 factors
and degree 8; each structure here is past one of them, so it takes the
kernels' wide route:

- "a": 17 products of one table each (17 slots), nv=4;
- "b": one product of 9 tables (degree 9), nv=3;
- "c": 17 pairs of 7 tables, coefficients 2..18 (17 products), nv=3;
- "tables18": 9 pairs of 18 tables, the first coefficient 0 (19 slots with
  its copy), nv=3;
- "wide": a product of 20 tables (degree 20) beside 40 single-table
  products, random coefficients (61 slots, 41 products), nv=3.

`chunk_structure` is one more, past the wide route's first chunk of 12
points: a product of 17 tables (degree 17, two chunks) and one of 9 beside
single-table products, random coefficients, so the products straddle the
chunk boundary at t = 12.
"""

from __future__ import annotations

import itertools
import random

NAMES = ("a", "b", "c", "tables18", "wide")


def f4_structure(name: str):
    """(nv, products [(coeff, [table indices])], table count)."""
    if name == "a":
        return 4, [(1, [i]) for i in range(17)], 17
    if name == "b":
        return 3, [(1, list(range(9)))], 9
    if name == "c":
        pairs = list(itertools.combinations(range(7), 2))[:17]
        return 3, [(2 + i, list(ix)) for i, ix in enumerate(pairs)], 7
    rnd = random.Random(name)
    if name == "tables18":
        return 3, [(0 if i == 0 else rnd.randrange(2, 1 << 62), [2 * i, 2 * i + 1])
                   for i in range(9)], 18
    if name == "wide":
        return 3, [(rnd.randrange(2, 1 << 62), list(range(20)))] + [
            (rnd.randrange(2, 1 << 62), [20 + i]) for i in range(40)], 60
    raise ValueError(name)


def chunk_structure():
    """(nv, products [(coeff, [table indices])], table count): a product of
    17 tables and one of 9 beside four single-table products (two of them
    on tables the long products use), random coefficients; nv=4."""
    rnd = random.Random("chunk")
    rows = [list(range(17)), list(range(17, 26)), [26], [27], [0], [20]]
    return 4, [(rnd.randrange(2, 1 << 62), ix) for ix in rows], 28
