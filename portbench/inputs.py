"""The benchmark's inputs, made from the seed: the pool of instances a cell
proves (its configuration's shapes) and each call's fresh inputs (its
traffic mix's batch). One general generator serves every configuration
and mix; the program and the reference are handed the same arrays.

Table values and f1's positions are drawn on the device by a
`torch.Generator` seeded from `--seed`, in few large calls, then copied
to the host once: the program's multilinear extensions take host arrays.
Everything else (coefficients, labels, points) comes from NumPy
generators keyed by the seed, so the same seed gives the same inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

DIGITS = 16
LABEL_WORDS = 4  # u64 words of each transcript's label: whole words, so the batched chain takes it


def modulus(config: dict) -> int:
    return int(config["modulus"], 16)


def _host_rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *key])


def _field_elements(rng: np.random.Generator, p: int, count: int) -> list[int]:
    """`count` uniform elements below p (four u64 words each, mod p)."""
    words = rng.integers(0, 2**64, size=(count, 4), dtype=np.uint64)
    return [sum(int(w) << (64 * i) for i, w in enumerate(row)) % p for row in words]


def random_digits(gen: torch.Generator, shape, p: int, device) -> np.ndarray:
    """Uniform strict digit tables (..., 16, n) below 2^(bits(p) - 1) < p,
    read as Montgomery values, as host uint32 arrays."""
    d = torch.randint(0, 1 << 16, tuple(shape), generator=gen, device=device, dtype=torch.int32)
    d[..., DIGITS - 1, :] >>= 257 - p.bit_length()
    return d.cpu().numpy().view(np.uint32)


@dataclass
class Pool:
    """A cell's instances: for `ml`, each instance's tables (T host (16,
    2^nv) arrays) and coefficients; for `gkr`, the one wiring f1
    (indices, values) that every instance shares, and each instance's f2
    and f3."""
    protocol: str
    tables: list = field(default_factory=list)
    coeffs: list = field(default_factory=list)
    f1: tuple = ()
    f2: list = field(default_factory=list)
    f3: list = field(default_factory=list)


def make_pool(config: dict, batch: int, seed: int, device) -> Pool:
    p = modulus(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**64 - 1))
    rng = _host_rng(seed, 0)
    pool = Pool(config["protocol"])
    if pool.protocol == "ml":
        n = 1 << config["num_variables"]
        for _ in range(batch):
            arr = random_digits(gen, (config["tables"], DIGITS, n), p, device)
            pool.tables.append(list(arr))
            # a coefficient of 0 or 1 would change the program's slot plan
            pool.coeffs.append([c if c > 1 else 2 for c in
                                _field_elements(rng, p, len(config["products"]))])
    elif pool.protocol == "gkr":
        # one f1 for the batch: the copies of a data-parallel circuit share
        # their wiring and differ in their layer values f2, f3 and point g
        dim, nnz = config["dim"], config["f1_nonzeros"]
        vals = random_digits(gen, (DIGITS, nnz), p, device)
        tabs = random_digits(gen, (batch, 2, DIGITS, 1 << dim), p, device)
        # distinct positions, drawn and sorted on the device: a host sort
        # of 2^20 keys can take most of a second, every run
        idx = torch.zeros(0, dtype=torch.int64, device=device)
        while idx.numel() < nnz:
            more = torch.randint(0, 1 << (3 * dim), (nnz - idx.numel(),), generator=gen,
                                 device=device, dtype=torch.int64)
            idx = torch.unique(torch.cat([idx, more]))
        pool.f1 = (idx.cpu().numpy(), vals)
        pool.f2 = list(tabs[:, 0])
        pool.f3 = list(tabs[:, 1])
    else:
        raise ValueError(f"unknown protocol {pool.protocol!r}")
    return pool


def call_inputs(config: dict, batch: int, seed: int, call: int, warm: bool = False) -> dict:
    """Call `call`'s fresh inputs: a label of `LABEL_WORDS` u64 words for
    each of the `batch` instances' new transcripts and, for `gkr`, a new
    point g for each instance. The same (seed, call) gives the same
    inputs; the set-up's warm calls draw theirs from a stream of their own."""
    rng = _host_rng(seed, 2 if warm else 1, call)
    words = rng.integers(0, 2**64, size=(batch, LABEL_WORDS), dtype=np.uint64)
    out = {"labels": [row.astype("<u8").tobytes() for row in words]}
    if config["protocol"] == "gkr":
        p, dim = modulus(config), config["dim"]
        out["g"] = [_field_elements(rng, p, dim) for _ in range(batch)]
    return out
