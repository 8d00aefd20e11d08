"""The chained sharded GKR round sumcheck: the port of
`sumcheck_tpu/parallel/gkr.py` (`ShardedGKRProver`, `:277-389`) over
`torch.distributed`, byte-identical to `GKRRoundSumcheck.prove`.

- **Split** (`:206-274`): f1's nonzeros, sorted by their bit-reversed x as
  the single-device split sorts them, fall into S contiguous chunks, the
  last padded with zero entries; rank s uploads only chunk s, with its own
  segment metadata for x (phase 1) and y (phase 2), cached on the
  `SparseMLE` (`ops/gkr_init._split_f1_device(..., shard=)`).
- **Phase inits** (`:77-143`): each rank runs the single-device weight
  reduce (`ops/gkr_init.phase1_pair`, `phase2_pair` with `reduce_fn` and
  `shard`) over its chunk up to the raw segment sums of the 32-bit limbs,
  written rank-major, (S, 8, 2^dim / S) int64 (16 MiB at dim 18, in every
  fold mode and in the plain versions alike), so that block [s] holds rank
  s's dealt segments; one `comm.reduce_scatter_sum_` a phase adds them
  over the ranks, exactly, and hands each rank only its own block, the
  JAX package's `psum_scatter` (`_psum_reduce_mod_p`, `:50-74`). The rank
  then finishes its 2^dim / S dealt lanes (carries, reduction mod p)
  straight into its pair, whose bytes equal the deal of the single
  device's (`ops/gkr_init_cuda.finish_sums`). The JAX package's
  all-gather after the finish is left out: the rounds need only the
  rank's lanes. The weights `w` of phase 1 (the carry) stay on the rank
  for phase 2.
- **Deal and rounds** (`:146-203`, `:351-389`): each rank holds its lanes
  of the bit-reversed pairs ([h_g, f2] for phase 1, [f1(g,u,.), f2(u)·f3]
  for phase 2; `mesh.deal`: local lane l is global pair lane l·S + s),
  written by the finish's launch, slot 1 beside slot 0, and runs each
  phase through `chained.sharded_rounds`; f2(u) is the final fold of phase
  1's replicated one-lane final pair, computed in the finish's blocks. A
  rank's inits are 4 launches a prove. One fetch at the end.

A `Blake2b512Rng` holding a pending byte count that is not a multiple of 8
is proved by every rank alone on the single-device host loop.
"""

from __future__ import annotations

import functools

import torch

from ..ops import gkr_init as GI
from ..protocol import device_prover
from ..utils.errors import SumcheckError
from . import comm
from .chained import check_transcript, sharded_rounds
from .mesh import auto_group, default_group, group_shape, shard_device

_PRODUCTS = ((0, 1),)  # h_g * f2 and f1_gu * (f2(u) * f3): one 2-slot unit product
_DEGREE = 2


class ShardedGKRProver:
    """Sharded GKR round sumcheck prove over a process group, the
    transcript on each rank's device and one fetch. `group` and `device` as
    `ChainedShardedProver`'s."""

    def __init__(self, group=None, *, device="cuda"):
        self.group = default_group() if group is None else group
        self.rank, self.num_shards = group_shape(self.group)
        self.device = shard_device(self.group, device)

    @staticmethod
    def auto(num_ranks: int | None = None, *, device="cuda") -> "ShardedGKRProver":
        """Over the default group (`mesh.auto_group`; `sumcheck_tpu/
        parallel/gkr.py:290-292`)."""
        return ShardedGKRProver(auto_group(num_ranks), device=device)

    def prove(self, rng, f1, f2, f3, g):
        """Caller supplies the transcript (reference `mod.rs:93-139`); every
        rank returns the same `GKRProof` and leaves `rng` in the same state.
        Raises `SumcheckError` before `rng` is touched for a dim whose pair
        has fewer lanes than ranks, or a transcript other than
        `Blake2b512Rng`."""
        from ..gkr_round_sumcheck import GKRProof, GKRRoundSumcheck, _upload

        assert f1.num_vars == 3 * f2.num_vars
        assert f1.num_vars == 3 * f3.num_vars
        dim = f2.num_vars
        if dim < 1 or (1 << (dim - 1)) < self.num_shards:
            raise SumcheckError(f"GKR dim {dim} cannot be sharded over {self.num_shards} ranks")
        check_transcript(rng)
        if not device_prover.liftable(rng):
            return GKRRoundSumcheck.prove(rng, f1, f2, f3, g, device=self.device)

        shard = (self.rank, self.num_shards)
        inputs = _upload(f1, f2, f3, list(g), dim, self.device, shard)
        inputs += (f2.to_device(self.device, shard), f3.to_device(self.device, shard))
        state = device_prover.lift_transcript(rng, self.device)
        msgs, rs, state = self._enqueue(inputs, state, dim)
        msgs_h, _rs_h, state_h = device_prover.fetch_chain_outputs(msgs, rs, state)
        device_prover.restore_transcript(rng, state_h)
        return GKRProof(device_prover.msgs_from_host(msgs_h[:dim], _DEGREE),
                        device_prover.msgs_from_host(msgs_h[dim:], _DEGREE))

    def _enqueue(self, inputs: tuple, state, dim: int):
        """Both phases on the rank (the single device's `_enqueue`,
        sharded) from `gkr_round_sumcheck._upload(..., shard=)`: returns
        (msgs (2 dim, 16, 3), rs (2 dim, 16), state). `inputs` ends with
        the rank's dealt f2 and f3, the sources of its pairs' slot 1."""
        split, _f2_d, f3_d, g_r, f2_mine, f3_mine = inputs
        reduce = functools.partial(comm.reduce_scatter_sum_, group=self.group)
        shard = (self.rank, self.num_shards)
        lo, hi, w = GI.phase1_pair(split, g_r, f3_d, f2_mine, dim, reduce_fn=reduce, shard=shard)
        msgs1, rs1, state, (flo, fhi) = sharded_rounds(lo, hi, state, _PRODUCTS, _DEGREE, dim,
                                                       self.group)
        # the replicated final pair, folded in place: lane 0; a fresh dealt pair
        lo, hi = GI.phase2_pair(flo[:, :, :1], fhi[:, :, :1], rs1[dim - 1], split, w, rs1,
                                f3_mine, dim, reduce_fn=reduce, shard=shard)
        msgs2, rs2, state, _pair = sharded_rounds(lo, hi, state, _PRODUCTS, _DEGREE, dim,
                                                  self.group)
        return torch.cat([msgs1, msgs2]), torch.cat([rs1, rs2]), state
