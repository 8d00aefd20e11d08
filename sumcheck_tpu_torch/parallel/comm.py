"""The only module of the port that calls `torch.distributed`.

Every exchange of the multi-device provers is an exact sum of integer
digits, so the collectives are two int64 sums; the order of a sum is
irrelevant, since the values are integers far below 2^63:

- `all_reduce_sum_`, in place: a round's per-digit sums
  (`parallel/chained.py`, `parallel/prover.py`, the sharded batch) and
  gathers built as sums in which one rank writes each slot
  (`gather_lanes`);
- `reduce_scatter_sum_`: the GKR inits' raw segment sums (`parallel/
  gkr.py`), of which each rank keeps only its own block, as the JAX
  package's `psum_scatter` hands each shard its chunk.

Both are one `torch.distributed` call on the tensor itself
(`all_reduce`, `reduce_scatter_tensor`), on NCCL, on
gloo over CPU tensors and on gloo over CUDA tensors (which gloo takes
through the host, for the reduce-scatter as for the all-reduce); a failed
collective raises.

Each counts its calls (`.calls`) and the bytes this rank contributes to
them (`.bytes`); `reduce_scatter_sum_.received` also the bytes the rank
gets back. Set them to 0 to count one prove.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world():
    """The default group, or None when no group is initialised."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank_and_size(group) -> tuple[int, int]:
    """This process's rank in `group`, and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def backend(group) -> str:
    """The group's backend name, as `torch.distributed` gives it."""
    return str(dist.get_backend(group))


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the int64 tensor `t` over the ranks of `group`, in place;
    returns `t`."""
    if t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"the all-reduce sums contiguous int64 tensors, got {t.dtype}")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum_.calls += 1
    all_reduce_sum_.bytes += t.numel() * t.element_size()
    return t


all_reduce_sum_.calls = 0
all_reduce_sum_.bytes = 0


def reduce_scatter_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """The exact sum over the ranks of `group` of `t[rank]`: `t` is a
    contiguous int64 tensor (S, ...) with one block a rank, and the result
    is this rank's summed block, shaped `t.shape[1:]`, a fresh tensor on
    `t`'s device. `t` is left as it was."""
    size = rank_and_size(group)[1]
    if t.dtype != torch.int64 or not t.is_contiguous() or t.dim() < 1 or t.shape[0] != size:
        raise ValueError(f"the reduce-scatter sums a contiguous int64 tensor of {size} blocks "
                         f"(one a rank), got {tuple(t.shape)} {t.dtype}")
    out = torch.empty(t.shape[1:], dtype=torch.int64, device=t.device)
    # flat views: gloo wants the output's first axis times S to be the input's
    dist.reduce_scatter_tensor(out.reshape(-1), t.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    reduce_scatter_sum_.calls += 1
    reduce_scatter_sum_.bytes += t.numel() * t.element_size()
    reduce_scatter_sum_.received += out.numel() * out.element_size()
    return out


reduce_scatter_sum_.calls = 0
reduce_scatter_sum_.bytes = 0
reduce_scatter_sum_.received = 0


def gather_lanes(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` (..., w), integer, concatenated along the last axis
    in rank order: (..., S·w) of `x`'s dtype on `x`'s device, the same on
    every rank. One `all_reduce_sum_` of a zeroed int64 buffer in which
    each rank writes its own slot."""
    s, size = rank_and_size(group)
    w = x.shape[-1]
    buf = torch.zeros(x.shape[:-1] + (size * w,), dtype=torch.int64, device=x.device)
    buf[..., s * w:(s + 1) * w] = x
    return all_reduce_sum_(buf, group).to(x.dtype)
