"""Multilinear extensions in evaluation form over the boolean hypercube.

Port of `sumcheck_tpu/mle.py`: the equivalents of `ark-poly`'s
`DenseMultilinearExtension` / `SparseMultilinearExtension` as consumed by
the reference (SURVEY.md L0), with `fix_variables` (fold the *first*
variables — the low index bits — to challenge points), `evaluate`, scaled
addition, and random sampling.

Host representation: NumPy `(NUM_DIGITS, 2^nv) uint32` digit arrays in
Montgomery form, natural (reference) index order — index bit i corresponds to
variable i. Host ops are vectorized NumPy limb arithmetic (`fields.limbs_np`);
the prover takes a bit-reversed torch copy on its device in 8 x 32-bit limbs
(`to_device`).
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
        self._dev: dict = {}  # torch.device [, s, S] -> bit-reversed copy

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

    def to_device(self, device, shard=None) -> torch.Tensor:
        """`(8, 2^nv) int32` copy on `device` in bit-reversed index order
        (the prover's table layout — `protocol/prover.py`), each value as
        8 x 32-bit limbs (`limbs_np.pack_limbs`), the layout of the round
        kernels' pair, half the bytes of the 16 digits; with `shard` = (s,
        S), only rank s's `(8, 2^nv / S)` lanes of it (`parallel/mesh.deal`),
        the only part a sharded prove reads there.

        Uploaded once per MLE, device and shard (cached: DenseMLE is
        immutable). The upload is part of table construction, matching the
        reference where tables already sit in prover memory before `prove`
        (`prover.rs:49-69`). Replaces `sumcheck_tpu`'s `device_bitrev`."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = device if shard is None else (device, *shard)
        t = self._dev.get(key)
        if t is None:
            from .protocol.prover import to_bitrev

            host = to_bitrev(self.evals, self.num_vars)
            if shard is not None:
                from .parallel.mesh import deal

                host = deal(host, *shard)
            # row-major, as the pair-init kernel reads it
            t = torch.from_numpy(L.pack_limbs(host)).to(device)
            self._dev[key] = t
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


class SparseMLE:
    """Sparse multilinear extension: (index, value) pairs, zero elsewhere.

    Equivalent of `ark_poly::SparseMultilinearExtension` as used by the GKR
    round sumcheck (`src/gkr_round_sumcheck/mod.rs:22-42`). Indices are unique.
    """

    __slots__ = ("num_vars", "indices", "values", "_dev_split")

    def __init__(self, num_vars: int, indices: np.ndarray, values_mont: np.ndarray):
        assert indices.ndim == 1 and values_mont.shape == (NUM_DIGITS, len(indices))
        order = np.argsort(indices, kind="stable")
        self.num_vars = num_vars
        self.indices = indices[order].astype(np.int64)
        self.values = np.ascontiguousarray(values_mont[:, order])
        self._dev_split: dict = {}  # (dim, device) -> split (ops/gkr_init.py)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_pairs(num_vars: int, pairs) -> "SparseMLE":
        pairs = [(int(i), _as_fr(v).v) for i, v in pairs]
        idx = np.array([i for i, _ in pairs], dtype=np.int64)
        assert len(np.unique(idx)) == len(idx), "duplicate indices"
        vals = L.from_ints([v for _, v in pairs]) if pairs else L.zeros(0)
        return SparseMLE(num_vars, idx, vals)

    @staticmethod
    def rand_with_config(num_vars: int, num_nonzero: int, rng) -> "SparseMLE":
        """Random sparse MLE with `num_nonzero` distinct nonzero entries
        (mirrors `SparseMultilinearExtension::rand_with_config`); draws the
        same entries as the JAX package from the same `random.Random`."""
        seen = {}
        while len(seen) < num_nonzero:
            seen[rng.randrange(1 << num_vars)] = rng.randrange(P)
        return SparseMLE.from_pairs(num_vars, seen.items())

    # -- accessors ---------------------------------------------------------
    @property
    def num_nonzero(self) -> int:
        return len(self.indices)

    def iter_pairs(self):
        vals = L.to_ints(self.values)
        for i, v in zip(self.indices, vals):
            yield int(i), Fr(v)

    def to_dense(self) -> DenseMLE:
        arr = L.zeros(1 << self.num_vars)
        arr[:, self.indices] = self.values
        return DenseMLE(self.num_vars, arr)

    # -- algebra -----------------------------------------------------------
    def fix_variables(self, partial_point: Sequence) -> "SparseMLE":
        """Fix the first k variables (low index bits). Each entry (idx, v)
        contributes v * prod_i(bit_i ? r_i : 1-r_i) to new index idx >> k."""
        k = len(partial_point)
        assert k <= self.num_vars
        if self.num_nonzero == 0:
            return SparseMLE(self.num_vars - k, self.indices, self.values)
        vals = self.values
        for i, r in enumerate(_as_fr(r) for r in partial_point):
            r_col = L.mont_scalar(r.v)
            omr_col = L.mont_scalar((Fr.one() - r).v)
            bit = ((self.indices >> i) & 1).astype(bool)
            factor = np.where(bit[None, :], r_col, omr_col).astype(np.uint32)
            vals = L.mont_mul(vals, factor)
        new_idx = self.indices >> k
        # merge duplicate indices: sorted order -> segment sums
        uniq, inverse = np.unique(new_idx, return_inverse=True)
        if len(uniq) == len(new_idx):
            return SparseMLE(self.num_vars - k, new_idx, vals)
        merged = _segment_sum_mod_p(vals, inverse, len(uniq))
        return SparseMLE(self.num_vars - k, uniq, merged)

    def evaluate(self, point: Sequence) -> Fr:
        assert len(point) == self.num_vars
        fixed = self.fix_variables(point)
        if fixed.num_nonzero == 0:
            return Fr.zero()
        return Fr(L.to_ints(fixed.values[:, :1])[0])


def _segment_sum_mod_p(vals: np.ndarray, seg_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """Sum digit columns by segment id, then reduce mod p.

    uint64 accumulation: safe for < 2^42 entries per segment."""
    acc = np.zeros((2 * NUM_DIGITS, num_segments), dtype=np.uint64)
    for d in range(NUM_DIGITS):
        np.add.at(acc[d], seg_ids, vals[d].astype(np.uint64))
    # carry-normalize uint64 digits into strict wide digits
    out = np.zeros((2 * NUM_DIGITS, num_segments), dtype=np.uint32)
    carry = np.zeros(num_segments, dtype=np.uint64)
    for d in range(2 * NUM_DIGITS):
        t = acc[d] + carry
        out[d] = (t & 0xFFFF).astype(np.uint32)
        carry = t >> 16
    return L.reduce_wide(out[: NUM_DIGITS + 4])
