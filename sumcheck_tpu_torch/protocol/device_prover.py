"""The round kernels' table pair: coefficient plan and initialisation.

Port of the parts of `sumcheck_tpu/protocol/device_prover.py` that the
Fiat-Shamir prover (`generic_prover.py`) runs: `_fold_plan` (`:141-177`),
`init_pair` (`:298-334`, with the scaling of `_stacker` as torch ops on the
pair's device). `col_int` and `msgs_from_host` convert canonical digits
fetched from a device transcript; with the transcript on the host they have
no caller yet and come with the device transcript.
"""

from __future__ import annotations

import torch

from ..fields import limbs_np as L
from ..fields import limbs_torch as LT
from ..fields.fr import NUM_DIGITS


def _fold_plan(polynomial):
    """Decide how to fold each product's coefficient into a table slot.

    Returns (products, scale_plan, num_slots, need_ones):
    - products: padded index tuples with coefficients absorbed;
    - scale_plan: list of (dst_slot, src_slot, coeff_int) — dst == src means
      scale in place (slot referenced nowhere else); dst >= num_tables
      appends a scaled copy (slot shared between products);
    - coefficient 1 folds for free (no scale op).
    """
    num_tables = len(polynomial.flattened_ml_extensions)
    usage = [0] * num_tables
    prods = [list(ix) for _, ix in polynomial.products]
    for ix in prods:
        for s in ix:
            usage[s] += 1
    scale_plan = []
    next_slot = num_tables
    for (coeff, _), ix in zip(polynomial.products, prods):
        if coeff.v == 1:
            continue
        t0 = ix[0]
        if usage[t0] == 1:
            scale_plan.append((t0, t0, coeff.v))
        else:
            scale_plan.append((next_slot, t0, coeff.v))
            usage[t0] -= 1
            ix[0] = next_slot
            next_slot += 1
    max_len = max(len(ix) for ix in prods)
    need_ones = any(len(ix) < max_len for ix in prods)
    ones_slot = next_slot
    products = tuple(
        tuple(ix + [ones_slot] * (max_len - len(ix))) for ix in prods
    )
    num_slots = next_slot + (1 if need_ones else 0)
    return products, tuple(scale_plan), num_slots, need_ones


def init_pair(polynomial, device):
    """Build the (lo, hi) table pair the round kernels consume on `device`:
    unique tables (device-cached, bit-reversed — `DenseMLE.to_device`),
    product coefficients pre-multiplied into one exclusive slot each, a
    constant-one slot only if some product needs ragged padding.

    Returns (lo, hi, products, degree): lo and hi are fresh (U, 16, 2^nv/2)
    int32 tensors that the rounds fold in place."""
    n = 1 << polynomial.num_variables
    products, scale_plan, num_slots, need_ones = _fold_plan(polynomial)
    tabs = [m.to_device(device) for m in polynomial.flattened_ml_extensions]
    for dst, src, coeff in scale_plan:
        col = LT.from_numpy(L.mont_scalar(coeff), tabs[src].device)
        scaled = LT.mont_mul(tabs[src], col).to(torch.int32)
        if dst == src:
            tabs[src] = scaled
        else:
            tabs.append(scaled)
    if need_ones:
        one = torch.from_numpy(L.mont_scalar(1).astype("int32"))
        tabs.append(one.to(tabs[0].device).expand(NUM_DIGITS, n))
    # slot axis leading: (U, 16, n/2) halves, filled slot by slot
    lo = torch.empty((num_slots, NUM_DIGITS, n // 2), dtype=torch.int32, device=tabs[0].device)
    hi = torch.empty_like(lo)
    for u, t in enumerate(tabs):
        lo[u] = t[:, : n // 2]
        hi[u] = t[:, n // 2 :]
    return lo, hi, products, polynomial.max_multiplicands
