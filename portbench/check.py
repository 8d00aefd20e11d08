"""How `correct` is decided: each sampled proof of the window against the
plain reference's proof of the same inputs, exactly.

A sample of (call, instance) pairs is drawn from the seed over every
instance proof the window returned (`Sample`): one from the lower half of
the batch's slots, one from the upper half, one from any slot, so every
check covers both halves of a call. After the window, the
reference proves each sampled instance again from the benchmark's own
inputs (the pool's tables or f1, f2, f3; the call's label and point),
side by side on the card, and the check counts the instances whose proof
bytes, challenges (where the entry point returns them) or next
transcript element differ. Every count has the limit 0: the proof is
exact, so one differing byte is a wrong proof. A proof asked for in the
window and never returned (`proofs_missing`) is as wrong.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .inputs import call_inputs, modulus
from .reference import prover as RP
from .reference.field import Field
from .reference.transcript import proof_bytes

LIMITS = {"proofs_differing": 0, "challenges_differing": 0, "transcripts_differing": 0}


class Reservoir:
    """A uniform sample of `size` of the items offered, drawn from the seed
    (Vitter's algorithm R): the same seed and the same count of items give
    the same sample."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, key, value) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((key, value))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = (key, value)


class Sample:
    """The proofs a run checks, drawn from the seed over the window's
    (call, slot) keys of a batch of `batch` slots: one proof from the
    lower half of the slots, one from the upper half, one from any slot
    (a key drawn twice is checked once)."""

    def __init__(self, batch: int, seed: int):
        self.half = batch // 2
        self.strata = [Reservoir(1, seed ^ 0x5EED ^ (i << 40)) for i in range(3)]

    def offer(self, key, value) -> None:
        _call, slot = key
        self.strata[slot >= self.half].offer(key, value)
        self.strata[2].offer(key, value)

    @property
    def items(self) -> list:
        return list({k: v for r in self.strata for k, v in r.items}.items())


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def reference_outputs(config: dict, batch: int, seed: int, pool, keys, device,
                      lazy: bool = False) -> list[dict]:
    """The reference's {"bytes", "challenges", "next"} for each (call,
    instance) key, proved side by side on `device`."""
    F = Field(modulus(config), device, lazy=lazy)
    calls = {c: call_inputs(config, batch, seed, c) for c in {c for c, _b in keys}}
    labels = [calls[c]["labels"][b] for c, b in keys]
    if config["protocol"] == "ml":
        tabs = torch.stack([torch.stack([_i64(t) for t in pool.tables[b]], 1)
                            for _c, b in keys], 2).to(device)
        out = RP.ml_prove(F, tabs, [tuple(ix) for ix in config["products"]],
                          [pool.coeffs[b] for _c, b in keys], labels)
        return [{"bytes": proof_bytes(m), "challenges": r, "next": n}
                for m, r, n in zip(out["messages"], out["challenges"], out["next"])]
    idx = torch.from_numpy(pool.f1[0]).to(device).expand(len(keys), -1)
    val = _i64(pool.f1[1]).to(device)[:, None, :].expand(-1, len(keys), -1)
    f2 = torch.stack([_i64(pool.f2[b]) for _c, b in keys], 1).to(device)
    f3 = torch.stack([_i64(pool.f3[b]) for _c, b in keys], 1).to(device)
    gs = [calls[c]["g"][b] for c, b in keys]
    out = RP.gkr_prove(F, idx, val, f2, f3, gs, labels)
    return [{"bytes": proof_bytes(a) + proof_bytes(b), "challenges": None, "next": n}
            for a, b, n in zip(out["phase1"], out["phase2"], out["next"])]


def compare(got: list[dict], want: list[dict]) -> dict:
    """{number: count of instances that differ}, over the keys checked;
    challenges only where the entry point returns them."""
    counts = {"proofs_differing": 0, "transcripts_differing": 0}
    for g, w in zip(got, want):
        counts["proofs_differing"] += g["bytes"] != w["bytes"]
        counts["transcripts_differing"] += g["next"] != w["next"]
        if w["challenges"] is not None:
            counts["challenges_differing"] = (counts.get("challenges_differing", 0)
                                              + (g["challenges"] != w["challenges"]))
    return counts


def verdict(counts: dict, checked: int, missing: int = 0) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when some proof was
    checked, no count passes its limit, and every proof asked for in the
    window came back (`missing` = 0)."""
    numbers = {k: {"value": v, "limit": LIMITS[k]} for k, v in counts.items()}
    numbers["proofs_missing"] = {"value": missing, "limit": 0}
    numbers["proofs_checked"] = {"value": checked, "limit": 1}
    ok = checked >= 1 and missing == 0 and all(v <= LIMITS[k] for k, v in counts.items())
    return ok, numbers
