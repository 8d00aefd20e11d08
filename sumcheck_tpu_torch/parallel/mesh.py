"""Hypercube sharding over a process group: the port of
`sumcheck_tpu/parallel/mesh.py` (`:35-77`).

The JAX package shards the 2^nv hypercube on the high-order reference index
bits (the variables folded last), so the per-round fold never crosses a
shard. `sharded_perm`, `inverse_sharded_perm`, `to_sharded_layout` and
`from_sharded_layout` are its host layouts, copied as NumPy.

The chained provers (`chained.py`, `gkr.py`) use the equivalent cyclic
deal of the bit-reversed pair (`deal`): rank s holds global pair lanes
l·S + s as its local lanes l. While a round's extent is a multiple of S,
both the fold's partner and the evaluation's pairing stay on the rank, and
the local lanes are themselves a valid pair table, so the round kernels
run on them unchanged.

`default_group` takes the place of `default_mesh`; `shard_device` picks a
rank's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..protocol.device_prover import resolve_device
from ..protocol.prover import bitrev_perm
from ..utils.errors import SumcheckError
from . import comm


@functools.lru_cache(maxsize=None)
def sharded_perm(nv: int, k: int) -> np.ndarray:
    """Permutation q with q[b] = global position of reference index b under
    k-bit sharding: shard b >> (nv-k), then the low bits bit-reversed."""
    assert 0 <= k <= nv
    b = np.arange(1 << nv, dtype=np.int64)
    lo_bits = nv - k
    s = b >> lo_bits
    lo = b & ((1 << lo_bits) - 1)
    w = bitrev_perm(lo_bits)[lo]
    return (s << lo_bits) | w


@functools.lru_cache(maxsize=None)
def inverse_sharded_perm(nv: int, k: int) -> np.ndarray:
    perm = sharded_perm(nv, k)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return inv


def to_sharded_layout(evals_mont: np.ndarray, nv: int, k: int) -> np.ndarray:
    """Natural-order host digit table (..., 2^nv) -> shard-blocked bitrev."""
    out = np.empty_like(evals_mont)
    out[..., sharded_perm(nv, k)] = evals_mont
    return out


def from_sharded_layout(arr: np.ndarray, nv: int, k: int) -> np.ndarray:
    """Shard-blocked bitrev layout (..., 2^nv) -> natural-order table."""
    return arr[..., sharded_perm(nv, k)]


def deal(table, s: int, size: int):
    """Rank s's lanes of a bit-reversed (16, n) table (NumPy or torch): the
    lanes s::size of its first half, then those of its second half,
    (16, n / size). As a pair table, its local lane l is global pair lane
    l·size + s."""
    rows, n = table.shape
    return table.reshape(rows, 2, n // (2 * size), size)[..., s].reshape(rows, n // size)


def _check_size(size: int) -> int:
    if size < 1 or size & (size - 1):
        raise SumcheckError(f"a group of {size} ranks is not a power of two")
    return size


def default_group():
    """The default process group (`dist.group.WORLD`); raises
    `SumcheckError` when none is initialised or its size is not a power of
    two."""
    group = comm.world()
    if group is None:
        raise SumcheckError("no torch.distributed process group is initialised")
    _check_size(comm.rank_and_size(group)[1])
    return group


def auto_group(num_ranks: int | None = None):
    """The default group for the provers' `auto` constructors (the JAX
    package's `default_mesh(num_devices)`); `num_ranks`, if given, must be
    its size: a process group is made by every rank, not chosen by one."""
    group = default_group()
    size = comm.rank_and_size(group)[1]
    if num_ranks is not None and num_ranks != size:
        raise SumcheckError(f"the default group has {size} ranks, not {num_ranks}")
    return group


def group_shape(group) -> tuple[int, int]:
    """(rank, size) of `group`, the size checked to be a power of two."""
    rank, size = comm.rank_and_size(group)
    return rank, _check_size(size)


def shard_device(group, device) -> torch.device:
    """The device of this rank: "cuda" without an index is card
    rank % device_count; a device with an index, or the CPU, is taken as
    given. "cuda" without a card raises, as `resolve_device` does; a group
    whose backend cannot carry the device's tensors (NCCL and the CPU)
    raises `SumcheckError` here, not at the first collective."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        cards = max(torch.cuda.device_count(), 1)  # none: `resolve_device` raises below
        device = torch.device("cuda", comm.rank_and_size(group)[0] % cards)
    device = resolve_device(device)
    if device.type == "cpu" and comm.backend(group) == "nccl":
        raise SumcheckError("an NCCL group cannot carry CPU tensors: use a gloo group")
    return device
