"""The round engine algorithm, written once over a pluggable limb backend.

Port of `sumcheck_tpu/protocol/engine.py`: `TORCH` runs its algorithm over
`fields.limbs_torch` on any torch device (`add`, `sub`, `mont_mul`,
`sum_lanes_wide`, `stack` and `take` on `(16, ...)` digit arrays); the
round kernels' plain versions (`ops/round_cuda.py`) are built on it. The
JAX package's NumPy `HOST` backend and `round_sums` served its host round
engine, which the port's interactive tier replaces with the round kernels.

Round semantics mirror the reference hot loop (`prover.rs:110-132`): with the
bit-reversed device layout, `start = first_half`, `step = second_half -
first_half`; the round polynomial evaluation at t is
`sum_lanes( sum_products( coeff * prod_j (start_j + t*step_j) ) )`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limbs_torch


class _TorchBackend:
    add = staticmethod(limbs_torch.add)
    sub = staticmethod(limbs_torch.sub)
    mont_mul = staticmethod(limbs_torch.mont_mul)
    sum_lanes_wide = staticmethod(limbs_torch.sum_lanes_wide)

    @staticmethod
    def stack(rows, axis):
        return torch.stack(rows, dim=axis)

    @staticmethod
    def take(arr, idx, axis):
        """`np.take` with an index array of any rank."""
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=arr.device)
        axis = axis % arr.ndim
        out = arr.index_select(axis, idx.reshape(-1))
        return out.reshape(arr.shape[:axis] + idx.shape + arr.shape[axis + 1 :])


TORCH = _TorchBackend


def fold_tables(ops, stacked, r_col):
    """One variable fold in bit-reversed layout (all tables at once):
    new = first_half + r * (second_half - first_half).

    stacked: (16, [B,] U+1, n); r_col broadcastable (16, [B,] 1, 1).
    Returns (16, [B,] U+1, n//2).
    """
    m = stacked.shape[-1] // 2
    even = stacked[..., :m]
    odd = stacked[..., m:]
    return ops.add(even, ops.mont_mul(ops.sub(odd, even), r_col))


def round_totals(ops, stacked, coeffs, idx_mat, degree: int):
    """Per-lane round-polynomial values at t = 0..degree, before the lane
    reduction: (16, [B,] degree+1, m) strict Montgomery digits.

    stacked: (16, [B,] U+1, 2m) bitrev tables (slot U = constant ones).
    coeffs:  (16, [B,] P, 1, 1) Montgomery digit columns, or None when the
    coefficients are already folded into the tables (`device_prover.init_pair`).
    idx_mat: (P, L) integer table indices (ragged products padded with U).
    """
    m2 = stacked.shape[-1] // 2
    even = stacked[..., :m2]
    step = ops.sub(stacked[..., m2:], even)
    ladder = [even]
    for _ in range(degree):
        ladder.append(ops.add(ladder[-1], step))
    evals = ops.stack(ladder, axis=-2)  # (16, [B,] U+1, d+1, m2)
    gathered = ops.take(evals, idx_mat, axis=-3)  # (16, [B,] P, L, d+1, m2)
    acc = gathered[..., 0, :, :]
    for l in range(1, gathered.shape[-3]):
        acc = ops.mont_mul(acc, gathered[..., l, :, :])
    if coeffs is not None:
        acc = ops.mont_mul(coeffs, acc)  # (16, [B,] P, d+1, m2)
    total = acc[..., 0, :, :]
    for pi in range(1, acc.shape[-3]):
        total = ops.add(total, acc[..., pi, :, :])
    return total
