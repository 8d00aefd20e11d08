"""Dense multilinear extensions in evaluation form over the boolean hypercube.

Port of `sumcheck_tpu/mle.py` (`DenseMLE` only; the sparse form comes with
GKR): the equivalent of `ark-poly`'s `DenseMultilinearExtension` as consumed
by the reference (SURVEY.md L0), with `fix_variables` (fold the *first*
variables — the low index bits — to challenge points), `evaluate`, scaled
addition, and random sampling.

Host representation: NumPy `(NUM_DIGITS, 2^nv) uint32` digit arrays in
Montgomery form, natural (reference) index order — index bit i corresponds to
variable i. Host ops are vectorized NumPy limb arithmetic (`fields.limbs_np`);
the prover takes a bit-reversed torch copy on its device (`to_device`).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .fields import limbs_np as L
from .fields.fr import Fr, NUM_DIGITS, P


def _as_fr(x) -> Fr:
    return x if isinstance(x, Fr) else Fr(int(x))


def _point_cols(point: Sequence) -> list[np.ndarray]:
    """Challenge points -> list of Montgomery digit columns (16, 1)."""
    return [L.mont_scalar(_as_fr(r).v) for r in point]


class DenseMLE:
    """Dense multilinear extension: full evaluation table over {0,1}^nv.

    Equivalent of `ark_poly::DenseMultilinearExtension`
    (reference usage: `src/ml_sumcheck/protocol/prover.rs:88,119-120`).
    """

    __slots__ = ("num_vars", "evals", "_dev")

    def __init__(self, num_vars: int, evals_mont: np.ndarray):
        assert evals_mont.shape == (NUM_DIGITS, 1 << num_vars)
        assert evals_mont.dtype == np.uint32
        self.num_vars = num_vars
        self.evals = evals_mont  # Montgomery digits, natural index order
        self._dev: dict = {}  # torch.device -> bit-reversed copy

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_evaluations(num_vars: int, values: Iterable) -> "DenseMLE":
        """values: iterable of Fr or canonical ints, length 2^num_vars."""
        ints = [_as_fr(v).v for v in values]
        assert len(ints) == 1 << num_vars
        return DenseMLE(num_vars, L.from_ints(ints))

    @staticmethod
    def zero(num_vars: int = 0) -> "DenseMLE":
        return DenseMLE(num_vars, L.zeros(1 << num_vars))

    @staticmethod
    def rand(num_vars: int, rng) -> "DenseMLE":
        """rng: `random.Random`-like (has randrange)."""
        return DenseMLE.from_evaluations(
            num_vars, [rng.randrange(P) for _ in range(1 << num_vars)]
        )

    # -- accessors ---------------------------------------------------------
    def __len__(self) -> int:
        return 1 << self.num_vars

    def __getitem__(self, i: int) -> Fr:
        return Fr(L.to_ints(self.evals[:, i : i + 1])[0])

    def to_fr_list(self) -> list[Fr]:
        return [Fr(v) for v in L.to_ints(self.evals)]

    def to_device(self, device) -> torch.Tensor:
        """`(NUM_DIGITS, 2^nv) int32` copy on `device` in bit-reversed index
        order (the prover's table layout — `protocol/prover.py`).

        Uploaded once per MLE and device (cached: DenseMLE is immutable).
        The upload is part of table construction, matching the reference
        where tables already sit in prover memory before `prove`
        (`prover.rs:49-69`). Replaces `sumcheck_tpu`'s `device_bitrev`."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        t = self._dev.get(device)
        if t is None:
            from .protocol.prover import to_bitrev

            host = to_bitrev(self.evals, self.num_vars).astype(np.int32)
            t = torch.from_numpy(host).to(device)
            self._dev[device] = t
        return t

    # -- algebra -----------------------------------------------------------
    def fix_variables(self, partial_point: Sequence) -> "DenseMLE":
        """Fold the first len(partial_point) variables to the given values:
        new[b] = old[2b] + r*(old[2b+1] - old[2b]) per variable, low bit first
        (matches `DenseMultilinearExtension::fix_variables`)."""
        assert len(partial_point) <= self.num_vars
        arr = self.evals
        for r_col in _point_cols(partial_point):
            even = np.ascontiguousarray(arr[:, 0::2])
            odd = np.ascontiguousarray(arr[:, 1::2])
            arr = L.add(even, L.mont_mul_scalar(L.sub(odd, even), r_col))
        return DenseMLE(self.num_vars - len(partial_point), arr)

    def evaluate(self, point: Sequence) -> Fr:
        assert len(point) == self.num_vars
        fixed = self.fix_variables(point)
        return fixed[0]

    def scaled_add(self, coeff, other: "DenseMLE") -> "DenseMLE":
        """self + coeff * other (the reference's `zero += (f2_u, f3)` pattern,
        `src/gkr_round_sumcheck/mod.rs:72-74`)."""
        if self.num_vars == 0 and len(self.evals[0]) == 1 and not self.evals.any():
            # adding to the zero polynomial adopts other's num_vars
            base = L.zeros(1 << other.num_vars)
            nv = other.num_vars
        else:
            assert self.num_vars == other.num_vars
            base = self.evals
            nv = self.num_vars
        c = L.mont_scalar(_as_fr(coeff).v)
        return DenseMLE(nv, L.add(base, L.mont_mul_scalar(other.evals, c)))
