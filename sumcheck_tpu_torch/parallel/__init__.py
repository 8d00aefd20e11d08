"""The multi-device provers over `torch.distributed`, the port of
`sumcheck_tpu/parallel/`: SPMD, every rank one process that calls the
prover with the same inputs, a process group in place of the JAX mesh.

- `mesh.py`: the sharded layouts, the deal of a table's pair lanes over the
  ranks, the default group and each rank's device;
- `comm.py`: the one module that calls `torch.distributed`; every exchange
  is an exact int64 sum, an all-reduce or (the GKR inits' raw sums) a
  reduce-scatter;
- `chained.py`: `ChainedShardedProver`, the sharded MLSumcheck prove;
- `prover.py`: `ShardedProver`, the sharded MLSumcheck prove with the
  transcript on the host, for any transcript;
- `gkr.py`: `ShardedGKRProver`, the sharded GKR round sumcheck prove.

The sharded batch is `batch.BatchedMLSumcheck.prove(..., group=)`.
Not exported from the package, as in the JAX package.
"""

from .chained import ChainedShardedProver
from .gkr import ShardedGKRProver
from .mesh import default_group, shard_device
from .prover import ShardedProver, ShardedProverState

__all__ = ["ChainedShardedProver", "ShardedGKRProver", "ShardedProver", "ShardedProverState",
           "default_group", "shard_device"]
