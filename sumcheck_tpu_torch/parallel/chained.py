"""The chained sharded MLSumcheck prover: the port of
`sumcheck_tpu/parallel/chained.py` (`ChainedShardedProver`, `:132-274`)
over `torch.distributed`.

SPMD: each of the S ranks (a power of two) calls `prove_as_subprotocol`
with the same polynomial and the same transcript, and each returns the
same proof, leaving its transcript in the same state, byte-identical to a
single-device prove.

- **Deal** (`:153-205`): rank s uploads only its lanes of each table
  (`DenseMLE.to_device(device, (s, S))`, `mesh.deal`) and runs the
  unchanged pair-init kernel over them (`device_prover.init_pair(...,
  shard=)`): global pair lane l·S + s is its local lane l.
- **Sharded rounds** (`:233-248`): nv - log2 S rounds of the generic chain
  (`generic_prover.chain_rounds_generic`) on the local extent, round 0
  through `round_nofold` and every later round through `round_fold`; between
  each round kernel and its transcript step the round's int64 sums row is
  summed over the ranks (`comm.all_reduce_sum_`). The sums are exact, so
  every rank feeds the single device's message and draws its challenge.
- **Tail** (`:250-259`): once each rank holds one active pair lane, one
  `comm.gather_lanes` of every rank's lane 0 gives the replicated (U, 16,
  S) pair, and the last log2 S rounds run on every rank through the same
  chain, folding first by the last sharded challenge.
- **Finish**: one fetch a rank (`device_prover.finish_chain`), which also
  restores the caller's transcript.

Like the JAX package (whose sharded step forces the non-Pallas, non-MXU
body), this path runs the generic chain with `round_fold` whatever
`SUMCHECK_TPU_CHAIN_IMPL` or the MXU fold mode say. It lifts only
`Blake2b512Rng` transcripts, as the JAX package's does; a `Blake2b512Rng`
holding a pending byte count that is not a multiple of 8 is proved by every
rank alone on the host-transcript loop, with no collective, so all ranks
still agree. The sharded path for any other transcript is
`parallel/prover.ShardedProver`, which keeps the transcript on the host
between the rounds and shares this module's deal and tail.

With a gloo group on CUDA tensors each all-reduce goes through the host;
with NCCL (one rank per card) nothing inside the chain syncs the host.
"""

from __future__ import annotations

import functools

import torch

from ..ops import round_cuda
from ..protocol import device_prover, generic_prover
from ..transcript.blake2b_rng import Blake2b512Rng
from ..utils.errors import SumcheckError
from . import comm
from .mesh import auto_group, default_group, group_shape, shard_device


def check_transcript(fs_rng) -> None:
    """The sharded provers lift `Blake2b512Rng` transcripts only."""
    if not isinstance(fs_rng, Blake2b512Rng):
        raise SumcheckError(f"the sharded provers need a Blake2b512Rng transcript, got "
                            f"{type(fs_rng).__name__}")


def sharded_rounds(lo, hi, state, products, degree: int, num_rounds: int, group):
    """`num_rounds` rounds over the rank's dealt pair `lo`, `hi` (folded in
    place): the sharded rounds with one all-reduce each, then the gather
    and the replicated tail. Returns (msgs (k, 16, d+1), rs (k, 16), state,
    (lo, hi)), the last the final pair, the same on every rank."""
    _s, size = group_shape(group)
    sigma = size.bit_length() - 1
    fns = (round_cuda.round_nofold, round_cuda.round_fold)
    reduce = functools.partial(comm.all_reduce_sum_, group=group)
    msgs, rs, state = generic_prover.chain_rounds_generic(
        lo, hi, state, products, degree, num_rounds - sigma, fns, reduce_fn=reduce)
    if not sigma:
        return msgs, rs, state, (lo, hi)
    lo, hi = gather_tail(lo, hi, group)
    tmsgs, trs, state = generic_prover.chain_rounds_generic(
        lo, hi, state, products, degree, sigma, fns, r0=rs[-1])
    return torch.cat([msgs, tmsgs]), torch.cat([rs, trs]), state, (lo, hi)


def gather_tail(lo, hi, group):
    """Once each rank holds one active pair lane (lane 0): every rank's,
    gathered in rank order by one `comm.gather_lanes`, as the replicated
    (U, 16, S) pair of the remaining rounds on the rank's device."""
    pair = comm.gather_lanes(torch.stack([lo[:, :, :1], hi[:, :, :1]]), group)  # (2, U, 16, S)
    return pair[0].contiguous(), pair[1].contiguous()


class ChainedShardedProver:
    """Sharded MLSumcheck prove over a process group, with the transcript on
    each rank's device and one fetch. `group` None is `mesh.default_group()`;
    `device` is each rank's (`mesh.shard_device`): "cuda" puts rank r on
    card r % device_count, "cpu" runs the kernels' plain versions."""

    def __init__(self, group=None, *, device="cuda"):
        self.group = default_group() if group is None else group
        self.rank, self.num_shards = group_shape(self.group)
        self.device = shard_device(self.group, device)

    @staticmethod
    def auto(num_ranks: int | None = None, *, device="cuda") -> "ChainedShardedProver":
        """Over the default group (`mesh.auto_group`; `sumcheck_tpu/
        parallel/chained.py:143-145`)."""
        return ChainedShardedProver(auto_group(num_ranks), device=device)

    def prove(self, polynomial):
        """One-shot prove with a fresh transcript; returns the proof."""
        return self.prove_as_subprotocol(Blake2b512Rng.setup(), polynomial)[0]

    def prove_as_subprotocol(self, fs_rng, polynomial):
        """Prove over the caller's transcript; returns (proof, ProverState)
        as `MLSumcheck.prove_as_subprotocol` does, on every rank. Raises
        `SumcheckError` before the transcript is fed for a constant, a
        table with fewer pair lanes than ranks, or a transcript other than
        `Blake2b512Rng`."""
        nv = polynomial.num_variables
        if nv == 0:
            raise SumcheckError("Attempt to prove a constant.")
        if (1 << (nv - 1)) < self.num_shards:
            raise SumcheckError(
                f"table of 2^{nv} entries cannot be sharded over {self.num_shards} ranks")
        check_transcript(fs_rng)

        fs_rng.feed(polynomial.info())
        if not device_prover.liftable(fs_rng):
            return generic_prover.prove_host_transcript(fs_rng, polynomial, self.device)
        lo, hi, products, degree = device_prover.init_pair(
            polynomial, self.device, (self.rank, self.num_shards))
        state = device_prover.lift_transcript(fs_rng, self.device)
        msgs, rs, state, (lo, hi) = sharded_rounds(lo, hi, state, products, degree, nv,
                                                   self.group)
        prover_msgs, randomness = device_prover.finish_chain(fs_rng, msgs, rs, state, degree)
        return prover_msgs, device_prover.prover_state(polynomial, lo, hi, randomness)
