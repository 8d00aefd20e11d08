"""The sharded MLSumcheck prover with the transcript on the host: the port
of `sumcheck_tpu/parallel/prover.py` (`ShardedProver`) over
`torch.distributed`.

SPMD, as `chained.py`: each of the S ranks (a power of two) calls the
prover with the same polynomial and the same transcript, which may be any
rng with `feed` and the draws `Fr.rand` uses, and each returns the proof
of `MLSumcheck.prove`, byte for byte, leaving its transcript in the same
state. It is the sharded prover for a transcript the device chain cannot
lift; `ChainedShardedProver` is the faster one for a `Blake2b512Rng`.

- **Deal**: `chained.py`'s (`device_prover.init_pair(..., shard=)`): rank
  s holds global pair lanes l·S + s as its local lanes l.
- **Rounds**: the interactive tier's (`protocol/prover.prove_round`, which
  dispatches a `ShardedProverState` to `run_sharded_round`, as
  `sumcheck_tpu/protocol/prover.py:160-163` does). While the shard lasts,
  the round kernel runs over the rank's lanes and one exact
  `comm.all_reduce_sum_` sums the round's (d+1, 16) int64 row over the
  ranks; every rank then finishes the same sums, feeds its own replica of
  the transcript and draws the same challenge.
- **Tail**: once each rank holds one active pair lane, `chained.gather_tail`
  gives the replicated (U, 16, S) pair, and the last log2 S rounds run on
  every rank's card alone.

The JAX package moves the tail to its NumPy host engine; here it stays on
the rank's device, as the chained prover's tail does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import round_cuda
from ..protocol import device_prover
from ..protocol.generic_prover import host_rounds
from ..protocol.prover import ProverState, pair_state
from ..transcript.blake2b_rng import Blake2b512Rng
from ..utils.errors import SumcheckError
from . import comm
from .chained import gather_tail
from .mesh import auto_group, default_group, group_shape, shard_device


class ShardedProverState(ProverState):
    """A `ProverState` whose pair is the rank's dealt lanes until the shard
    is exhausted, then the gathered (U, 16, S) pair of the tail, the same
    on every rank. `flattened_ml_extensions` reads the rank's lanes before
    the gather and the whole tables after it."""

    def __init__(self, *args, group=None, num_shards: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group
        self.num_shards = num_shards
        self._sharded_rounds_left = 0  # rounds with >= 1 pair lane a rank
        self._tail = False

    @property
    def extent(self) -> int:
        """The active lanes of the pair the state holds: the whole table's
        in the tail, the rank's 1/S of them before it."""
        return super().extent // (1 if self._tail else self.num_shards)


class ShardedProver:
    """Sharded MLSumcheck prove over a process group with the transcript
    on the host. `group` None is `mesh.default_group()`; `device` is each
    rank's (`mesh.shard_device`): "cuda" puts rank r on card r %
    device_count, "cpu" runs the kernels' plain versions."""

    def __init__(self, group=None, *, device="cuda"):
        self.group = default_group() if group is None else group
        self.rank, self.num_shards = group_shape(self.group)
        self.device = shard_device(self.group, device)

    @staticmethod
    def auto(num_ranks: int | None = None, *, device="cuda") -> "ShardedProver":
        """Over the default group (`mesh.auto_group`)."""
        return ShardedProver(auto_group(num_ranks), device=device)

    def prover_init(self, polynomial) -> ShardedProverState:
        """The rank's dealt pair (one pair-init launch on a card) in a state
        for `IPForMLSumcheck.prove_round`. Raises `SumcheckError` for a
        constant or a table with fewer pair lanes than ranks."""
        nv = polynomial.num_variables
        if nv == 0:
            raise SumcheckError("Attempt to prove a constant.")
        if (1 << (nv - 1)) < self.num_shards:
            raise SumcheckError(
                f"table of 2^{nv} entries cannot be sharded over {self.num_shards} ranks")
        lo, hi, _products, _degree = device_prover.init_pair(
            polynomial, self.device, (self.rank, self.num_shards))
        state = pair_state(polynomial, lo, hi, ShardedProverState, group=self.group,
                           num_shards=self.num_shards)
        state._sharded_rounds_left = nv - (self.num_shards.bit_length() - 1)
        return state

    def prove(self, polynomial):
        """Mirror of `MLSumcheck.prove` over this group (the same proof)."""
        return self.prove_as_subprotocol(Blake2b512Rng.setup(), polynomial)[0]

    def prove_as_subprotocol(self, fs_rng, polynomial):
        """Prove over the caller's transcript; returns (proof, ProverState)
        as `MLSumcheck.prove_as_subprotocol` does, on every rank. A
        rejected polynomial leaves the transcript unfed."""
        state = self.prover_init(polynomial)
        fs_rng.feed(polynomial.info())
        msgs, point = host_rounds(fs_rng, state, polynomial.num_variables)
        state.randomness.append(point[-1])
        return msgs, state


def run_sharded_round(state: ShardedProverState, r_col, do_fold: bool) -> torch.Tensor:
    """One round of a sharded state: the (d+1, 16) int64 sums of the whole
    table, the same on every rank. While the shard lasts, the round kernel
    over the rank's lanes and one all-reduce; then the gather (once) and the
    tail's rounds on the rank alone. `r_col` is the challenge's (16, 1)
    Montgomery digits, uploaded for a fold. Called from
    `protocol.prover.prove_round` by the state's type."""
    nofold, fold = state.round_fns or (round_cuda.round_nofold, round_cuda.round_fold)
    lo, hi = state.stacked
    if state._sharded_rounds_left == 0 and not state._tail:
        state.stacked = lo, hi = gather_tail(lo, hi, state.group)
        state._tail = True
    args = (state.products, state.max_multiplicands, state.extent)
    if do_fold:
        r = device_prover.upload(torch.from_numpy(r_col[:, 0].astype(np.int32)), lo.device)
        sums = fold(lo, hi, r, *args)
    else:
        sums = nofold(lo, hi, *args)
    if not state._tail:
        comm.all_reduce_sum_(sums, state.group)
        state._sharded_rounds_left -= 1
    return sums
