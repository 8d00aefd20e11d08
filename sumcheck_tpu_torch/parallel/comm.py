"""The only module of the port that calls `torch.distributed`.

Every exchange of the multi-device provers is an exact sum of integer
digits: a round's per-digit sums (`parallel/chained.py`), the GKR inits'
raw segment sums (`parallel/gkr.py`), and gathers built as sums in which
one rank writes each slot. So one collective serves them all: an int64
all-reduce, in place. It runs the same on gloo over CPU tensors, gloo over
CUDA tensors (which goes through the host) and NCCL, and needs no
collective that gloo lacks for CUDA tensors. The order of the sum is
irrelevant: the values are integers far below 2^63.

`all_reduce_sum_.calls` and `.bytes` count the all-reduces and the bytes
each rank contributes to them (set them to 0 to count one prove).
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
