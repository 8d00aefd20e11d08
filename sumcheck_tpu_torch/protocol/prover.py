"""MLSumcheck round prover, interactive tier (reference C8,
`src/ml_sumcheck/protocol/prover.rs`).

Algorithm (Libra [XZZPS19] §3.2, linear time): at round i the prover sends the
round polynomial's evaluations at t = 0..d, computed as
`sum_b prod_j (start_j + t*step_j)` where `start_j = T_j[2b]`,
`step_j = T_j[2b+1] - T_j[2b]` (reference `prover.rs:110-132`), after folding
every unique table by the previous challenge (`prover.rs:87-89`).

Tables are one stacked `(NUM_DIGITS, U+1, n)` Montgomery digit array in
**bit-reversed index order**: the reference's low-bit pair `(T[2b], T[2b+1])`
becomes `(first_half[k], second_half[k])`, and the layout is closed under
folding. Slot U is a constant-one table used to pad ragged products to a
rectangular `(num_products, max_len)` index matrix.

Port of `sumcheck_tpu/protocol/prover.py`: the interactive rounds run on the
NumPy host engine (`engine.HOST`). The Fiat-Shamir fast path, with the round
kernels on a torch device, is `protocol/generic_prover.py`.
"""

from __future__ import annotations

import functools

import numpy as np

from ..data_structures import ListOfProductsOfPolynomials
from ..fields import limbs_np as L
from ..fields.fr import Fr, NUM_DIGITS, P, R_INV
from ..fields.limbs_torch import wide_to_int
from ..transcript.serialize import serialize_fr_vec
from ..utils.errors import SumcheckError
from . import engine


class ProverMsg:
    """Evaluations of the round polynomial at t = 0, 1, ..., d
    (reference `ProverMsg`, `prover.rs:13-17`). Serializes as `Vec<Fr>`."""

    __slots__ = ("evaluations",)

    def __init__(self, evaluations: list[Fr]):
        self.evaluations = evaluations

    def serialize_uncompressed(self) -> bytes:
        return serialize_fr_vec(self.evaluations)

    def __eq__(self, o) -> bool:
        return isinstance(o, ProverMsg) and self.evaluations == o.evaluations

    def __repr__(self) -> str:
        return f"ProverMsg({self.evaluations})"


class ProverState:
    """Mutable prover state across rounds (reference `ProverState`,
    `prover.rs:19-33`). `stacked` holds the unique tables (plus the constant
    ones-table in the last slot), bit-reversed."""

    def __init__(self, randomness, list_of_products, stacked, num_vars, max_multiplicands):
        self.randomness: list[Fr] = randomness
        self.list_of_products: list[tuple[Fr, list[int]]] = list_of_products
        # host engine: (16, U+1, n) digit-leading NumPy array;
        # Fiat-Shamir fast path: (lo, hi) torch pair, slot axis leading (U, 16, half)
        self.stacked = stacked
        self.num_vars = num_vars
        self.max_multiplicands = max_multiplicands
        self.round = 0

    @property
    def num_tables(self) -> int:
        if isinstance(self.stacked, tuple):
            return self.stacked[0].shape[0]
        return self.stacked.shape[1] - 1

    @property
    def flattened_ml_extensions(self) -> list:
        """Per-table views (excluding any internal ones slot); mirrors the
        reference field of the same name."""
        if isinstance(self.stacked, tuple):
            return [self.stacked[0][i] for i in range(self.num_tables)]
        return [self.stacked[:, i] for i in range(self.num_tables)]


@functools.lru_cache(maxsize=None)
def bitrev_perm(nv: int) -> np.ndarray:
    """Permutation q with q[i] = bit-reverse of i in nv bits (an involution)."""
    idx = np.arange(1 << nv, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(nv):
        rev |= ((idx >> b) & 1) << (nv - 1 - b)
    return rev


def to_bitrev(evals_mont: np.ndarray, nv: int) -> np.ndarray:
    """Natural-order host digit table (..., 2^nv) -> bit-reversed layout
    (an involution)."""
    return evals_mont[..., bitrev_perm(nv)]


def prover_init(polynomial: ListOfProductsOfPolynomials) -> ProverState:
    """Deep-copy unique tables (reference `prover_init`, `prover.rs:49-69`)
    into the stacked bit-reversed layout, appending the ones-table."""
    if polynomial.num_variables == 0:
        raise SumcheckError("Attempt to prove a constant.")
    nv = polynomial.num_variables
    n = 1 << nv
    tables = [to_bitrev(m.evals, nv) for m in polynomial.flattened_ml_extensions]
    tables.append(np.broadcast_to(L.mont_scalar(1), (NUM_DIGITS, n)))
    return ProverState(
        randomness=[],
        list_of_products=[(c, list(ix)) for c, ix in polynomial.products],
        stacked=np.stack(tables, axis=1),  # (16, U+1, n)
        num_vars=nv,
        max_multiplicands=polynomial.max_multiplicands,
    )


def _run_round(state: ProverState, r_col, do_fold: bool):
    """One round on the host engine; returns wide sums (WIDE, d+1)."""
    degree = state.max_multiplicands
    ones_slot = state.num_tables
    max_len = max(len(ix) for _, ix in state.list_of_products)
    idx_mat = np.array(
        [ix + [ones_slot] * (max_len - len(ix)) for _, ix in state.list_of_products],
        dtype=np.int32,
    )
    coeffs = np.stack(
        [L.mont_scalar(c.v) for c, _ in state.list_of_products], axis=1
    )[:, :, :, None]  # (16, P, 1, 1)
    if do_fold:
        state.stacked = engine.fold_tables(engine.HOST, state.stacked, r_col[:, None, :])
    return engine.round_sums(engine.HOST, state.stacked, coeffs, idx_mat, degree)


def prove_round(prover_state: ProverState, v_msg) -> ProverMsg:
    """Receive the verifier message, emit this round's polynomial evaluations,
    and advance (reference `prove_round`, `prover.rs:74-153`)."""
    state = prover_state
    if v_msg is not None:
        if state.round == 0:
            raise SumcheckError("first round should be prover first.")
        state.randomness.append(v_msg.randomness)
        r_col = L.mont_scalar(v_msg.randomness.v)
    elif state.round > 0:
        raise SumcheckError("verifier message is empty")
    else:
        r_col = np.zeros((NUM_DIGITS, 1), np.uint32)  # unused placeholder

    do_fold = state.round > 0
    state.round += 1
    if state.round > state.num_vars:
        raise SumcheckError("Prover is not active")

    sums = _run_round(state, r_col, do_fold)  # (WIDE, degree+1)
    evaluations = [
        Fr((wide_to_int(sums[:, t]) % P) * R_INV % P)
        for t in range(state.max_multiplicands + 1)
    ]
    return ProverMsg(evaluations)
