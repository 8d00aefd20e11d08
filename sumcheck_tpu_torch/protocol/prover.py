"""MLSumcheck round prover, interactive tier (reference C8,
`src/ml_sumcheck/protocol/prover.rs`).

Algorithm (Libra [XZZPS19] §3.2, linear time): at round i the prover sends the
round polynomial's evaluations at t = 0..d, computed as
`sum_b prod_j (start_j + t*step_j)` where `start_j = T_j[2b]`,
`step_j = T_j[2b+1] - T_j[2b]` (reference `prover.rs:110-132`), after folding
every unique table by the previous challenge (`prover.rs:87-89`).

Port of `sumcheck_tpu/protocol/prover.py`, on the round kernels. The state
holds the table pair the chains fold (`device_prover.init_pair`: the
unique tables in **bit-reversed index order**, so the reference's low-bit
pair `(T[2b], T[2b+1])` is `(lo[k], hi[k])`, each product's coefficient
folded into one slot, a constant-one slot for ragged products) on the
prover's device. `prove_round` runs round 0 through `round_cuda.round_nofold`
and every later round through `round_cuda.round_fold` (in place, by the
verifier's challenge uploaded as Montgomery digits) over the extent
`2^(nv-1) >> round`, and copies the round's exact sums to the host in
`round_cuda.finish_sums`, its one sync. `device="cpu"` runs the kernels'
plain versions. A sharded state (`parallel/prover.ShardedProverState`)
takes `parallel.prover.run_sharded_round` instead, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data_structures import ListOfProductsOfPolynomials
from ..fields import limbs_np as L
from ..fields.fr import Fr, P, R_INV
from ..fields.limbs_torch import wide_to_int
from ..ops import round_cuda
from ..transcript.serialize import serialize_fr_vec
from ..utils.errors import SumcheckError


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
    `prover.rs:19-33`). `stacked` is the round kernels' (lo, hi) pair of
    (U, 8, 2^nv / 2) int32 limb tensors, folded in place; `products` its padded
    slot tuples; slots 0..num_tables-1 hold the polynomial's tables, slot u
    times `scales[u]` where `init_pair` folded a coefficient into it.
    `round_fns` replaces (round_nofold, round_fold), a test hook."""

    def __init__(self, randomness, list_of_products, stacked, num_vars, max_multiplicands,
                 products, num_tables: int, scales=None):
        self.randomness: list[Fr] = randomness
        self.list_of_products: list[tuple[Fr, list[int]]] = list_of_products
        self.stacked = stacked
        self.num_vars = num_vars
        self.max_multiplicands = max_multiplicands
        self.round = 0
        self.products = products
        self.num_tables = num_tables
        self.scales = scales or {}
        self.round_fns = None

    @property
    def extent(self) -> int:
        """The active pair lanes: 2^(nv-1) >> (folds so far)."""
        return (1 << (self.num_vars - 1)) >> max(self.round - 1, 0)

    @property
    def flattened_ml_extensions(self) -> list[np.ndarray]:
        """The polynomial's tables as the rounds so far left them, each a
        (16, 2 * extent) NumPy digit array in bit-reversed order (the JAX
        package's host-engine state), with the coefficients folded into
        them divided back out; one copy from the device, unpacked from the
        pair's limbs (`limbs_np.unpack_limbs`). Raises for a table
        that took the coefficient 0 in place, which the fold plan does only
        where a copy slot would pass the kernels' slot limit."""
        lo, hi = self.stacked
        k, a = self.num_tables, self.extent
        both = L.unpack_limbs(torch.cat([lo[:k, :, :a], hi[:k, :, :a]], dim=2).cpu().numpy(),
                              axis=1)
        out = []
        for i in range(k):
            c = self.scales.get(i)
            if c is None:
                out.append(both[i])
            elif c % P == 0:
                raise SumcheckError(f"table {i} took the coefficient 0 in place (a copy slot "
                                    f"would pass the kernels' slot limit): its values are gone")
            else:
                out.append(L.mont_mul_scalar(both[i], L.mont_scalar(pow(c, -1, P))))
        return out


def pair_state(polynomial, lo, hi, cls=ProverState, **kwargs) -> ProverState:
    """A `cls` state over the pair `init_pair(polynomial, ...)` built (the
    fold plan read again), before round 0."""
    from .device_prover import _fold_plan

    products, scale_plan, _slots, _ones = _fold_plan(polynomial)
    return cls([], [(c, list(ix)) for c, ix in polynomial.products], (lo, hi),
               polynomial.num_variables, polynomial.max_multiplicands, products,
               len(polynomial.flattened_ml_extensions),
               {dst: c for dst, src, c in scale_plan if dst == src}, **kwargs)


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


def prover_init(polynomial: ListOfProductsOfPolynomials, *, device="cuda") -> ProverState:
    """Deep-copy the unique tables (reference `prover_init`,
    `prover.rs:49-69`) into the round kernels' table pair on `device` (a
    `torch.device` or its name; the card unless the caller asks for the
    CPU): one pair-init launch on a card."""
    from .device_prover import init_pair

    if polynomial.num_variables == 0:
        raise SumcheckError("Attempt to prove a constant.")
    lo, hi, _products, _degree = init_pair(polynomial, device)
    return pair_state(polynomial, lo, hi)


def _round_sums(state: ProverState, r_col, do_fold: bool) -> torch.Tensor:
    """One round's (d+1, 16) int64 per-digit sums on the state's device,
    with no host sync: the challenge uploaded, then one round kernel over
    the round's extent. A sharded state takes `run_sharded_round`."""
    if getattr(state, "group", None) is not None:
        from ..parallel.prover import run_sharded_round

        return run_sharded_round(state, r_col, do_fold)
    from .device_prover import upload

    nofold, fold = state.round_fns or (round_cuda.round_nofold, round_cuda.round_fold)
    lo, hi = state.stacked
    if do_fold:
        r = upload(torch.from_numpy(r_col[:, 0].astype(np.int32)), lo.device)
        return fold(lo, hi, r, state.products, state.max_multiplicands, state.extent)
    return nofold(lo, hi, state.products, state.max_multiplicands, state.extent)


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
        r_col = None  # round 0 folds nothing

    do_fold = state.round > 0
    state.round += 1
    if state.round > state.num_vars:
        raise SumcheckError("Prover is not active")

    sums = round_cuda.finish_sums(_round_sums(state, r_col, do_fold))  # the round's one sync
    evaluations = [
        Fr((wide_to_int(sums[:, t]) % P) * R_INV % P)
        for t in range(state.max_multiplicands + 1)
    ]
    return ProverMsg(evaluations)
