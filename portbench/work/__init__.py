"""What each layer's kernels must do in one call, from the cell's shapes
alone, and the card's peaks: the yardstick of the roofline shares.

Frozen here from `chip_smoke.py` (`bound_of`, `round_work`,
`eval_multiplies`, `reduce_work`), so that no change to the port moves
it. A bound counts each input read once and each output written once, 32
bytes an element (255 bits in eight 32-bit words), and the fewest
Montgomery multiplies the layer's arithmetic needs, each 264 32-bit
multiplies (64 + 64 products of 32 x 32 -> 64 bits for a·b and m·p, two
multiplies each, and 8 for m). The bound time is the larger of the bytes
at the memory rate and the multiplies at the IMAD rate. Nothing here
reads the port.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
ELEMENT_BYTES = PEAKS["element_bytes"]
IMADS_PER_MONT_MUL = PEAKS["imads_per_montgomery_multiply"]


def bound_ms(work: dict) -> float:
    """The least time the card could take for `work` ({"bytes",
    "multiplies"}), in ms."""
    mem = work["bytes"] / PEAKS["hbm_bytes_per_s"]
    ops = work["multiplies"] * IMADS_PER_MONT_MUL / PEAKS["imad_per_s"]
    return max(mem, ops) * 1e3


def _add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def eval_multiplies(lengths, degree: int) -> int:
    """Multiplies of one lane's round evaluation at t = 0..degree: a
    product of L factors multiplies factor l at the points t = 0..min(l +
    1, degree), l = 1..L-1; the other points follow by differences."""
    return sum(sum(min(l + 1, degree) + 1 for l in range(1, n)) for n in lengths)


def round_work(lanes: int, slots: int, lengths, degree: int, fold: bool) -> dict:
    """One round kernel over `lanes` lanes of a (slots, lanes) table pair:
    round 0 reads both halves; a fold reads the last round's pair of 2 x
    lanes and writes the folded pair, one multiply a folded value, then
    evaluates."""
    stripe = ELEMENT_BYTES * lanes * slots
    folds = 2 * slots if fold else 0
    return {"bytes": stripe * (6 if fold else 2),
            "multiplies": (eval_multiplies(lengths, degree) + folds) * lanes}


def chain_work(nv: int, slots: int, lengths, degree: int) -> dict:
    """Every round kernel of one instance's nv rounds."""
    half = 1 << (nv - 1)
    total = round_work(half, slots, lengths, degree, False)
    for j in range(1, nv):
        total = _add(total, round_work(half >> j, slots, lengths, degree, True))
    return total


def pair_init_work(nv: int, tables: int, slots: int, scaled: int) -> dict:
    """One instance's pair init: each table read, each slot written, one
    multiply a lane of a slot that takes a coefficient."""
    n = 1 << nv
    return {"bytes": ELEMENT_BYTES * n * (tables + slots), "multiplies": scaled * n}


def gkr_init_work(dim: int, nnz: int, batch: int = 1) -> dict:
    """The two GKR phase inits (the fused weight reduce) of `batch`
    instances that share one f1. f1's arrays are read once a call: per
    entry its index, value, y and row (phase 1) and its x (phase 2), and
    each segment's end. Once an instance: per entry its f3 lane read and
    its carry written (phase 1), its carry read (phase 2); each segment's
    sum written; the challenge rows; the pair's slot 1 read and written
    (phase 2 also its final fold's one-lane pair). Multiplies, an
    instance: 3 an entry in phase 1 (eq's halves, the value, f3) and 2 in
    phase 2, 1 a segment's finish, eq's half tables, and in phase 2
    f3·f2(u) a lane and the fold."""
    n = 1 << dim
    halves = (1 << (dim - dim // 2)) + (1 << (dim // 2))
    total = {"bytes": 0, "multiplies": 0}
    for phase in (1, 2):
        shared = (4 + 32 + 4 + 4 if phase == 1 else 4) * nnz + 4 * n
        own = (32 + 32 if phase == 1 else 32) * nnz + 32 * n + 64 * dim + 2 * ELEMENT_BYTES * n
        mults = (3 if phase == 1 else 2) * nnz + n + halves - 2
        if phase == 2:
            own += 2 * ELEMENT_BYTES + 64
            mults += n + 1
        total = _add(total, {"bytes": shared + batch * own, "multiplies": batch * mults})
    return total


def call_work(config: dict, batch: int) -> dict:
    """{layer: work} for one call of `batch` instances of `config` (a `gkr`
    batch shares one f1)."""
    if config["protocol"] == "ml":
        nv = config["num_variables"]
        lengths = [len(ix) for ix in config["products"]]
        tables = config["tables"]
        scaled = len(config["products"])  # each product's coefficient in one slot
        layers = {"pair_init": pair_init_work(nv, tables, tables, scaled),
                  "round": chain_work(nv, tables, lengths, max(lengths))}
    else:
        dim = config["dim"]
        round_ = _add(chain_work(dim, 2, [2], 2), chain_work(dim, 2, [2], 2))
        return {"gkr_init": gkr_init_work(dim, config["f1_nonzeros"], batch),
                "round": {m: v * batch for m, v in round_.items()}}
    return {k: {m: v * batch for m, v in w.items()} for k, w in layers.items()}
