"""The benchmark's plain reference provers: the multilinear sumcheck of
ark-sumcheck (`src/ml_sumcheck`) and its GKR round sumcheck
(`src/gkr_round_sumcheck`), over `field.Field` and `transcript.Transcript`.

K items are proved side by side: tables are (16, T, K, n) digit tensors,
item k with its own transcript, coefficients and challenges. Tables are
in natural index order, variable i the index's bit i, and each round
fixes the lowest remaining variable: the pair (2b, 2b + 1) folds to
entry b. The round message is the sum over b of each product's value at
t = 0..d, each table taken as lo + t·(hi - lo). Nothing here reads the
port.
"""

from __future__ import annotations

import torch

from .field import Field, digits_int
from .transcript import Transcript, message_bytes, u64_bytes


def _column(F: Field, values, ndim: int, axis: int) -> torch.Tensor:
    """K Montgomery values as digits along `axis` of an `ndim` tensor."""
    shape = [1] * ndim
    shape[0], shape[axis] = 16, len(values)
    cols = torch.stack([F.const(v, 1) for v in values], dim=1)  # (16, K)
    return cols.reshape(shape)


def sumcheck_rounds(F: Field, tabs: torch.Tensor, products, coeffs, degree: int,
                    transcripts) -> tuple[list, list]:
    """Every round of K sumchecks: `tabs` (16, T, K, 2^nv) Montgomery
    tables, `products` index tuples into T (one structure for all K),
    `coeffs[k]` item k's canonical coefficient of each product. Each
    message is fed to its item's transcript and the challenge drawn.
    Returns (messages [k][round] -> d + 1 canonical ints, challenges
    [k][round])."""
    num_items = tabs.shape[2]
    rounds = tabs.shape[3].bit_length() - 1
    longest = max(len(ix) for ix in products)
    msgs = [[] for _ in range(num_items)]
    rs = [[] for _ in range(num_items)]
    for j in range(rounds):
        lo, hi = tabs[..., 0::2], tabs[..., 1::2]
        diff = F.sub(hi, lo)
        points = [lo.contiguous(), hi.contiguous()]
        while len(points) <= degree:
            points.append(F.add(points[-1], diff))
        ones = F.one(4).expand(16, 1, lo.shape[2], lo.shape[3])
        sums = []
        for ix in products:
            factors = [p.unsqueeze(1) for p in points]  # (16, 1, T, K, h) each
            value = None
            for f in list(ix) + [None] * (longest - len(ix)):
                col = torch.cat([x[:, :, f] if f is not None else ones
                                 for x in factors], dim=1)  # (16, d+1, K, h)
                value = col if value is None else F.mul(value, col)
            sums.append(value.sum(-1))  # (16, d+1, K) digit sums
            del value
        del points
        host = torch.stack(sums, dim=1).cpu().tolist()  # [16][P][d+1][K]
        challenge = []
        for k in range(num_items):
            evals = []
            for t in range(degree + 1):
                total = 0
                for q, c in enumerate(coeffs[k]):
                    s = digits_int([host[i][q][t][k] for i in range(16)])
                    total += c * F.canonical(s)
                evals.append(total % F.p)
            msgs[k].append(evals)
            transcripts[k].feed(message_bytes(evals))
            r = transcripts[k].field_element(F.p)
            rs[k].append(r)
            challenge.append(F.mont(r))
        if j + 1 < rounds:
            r_col = _column(F, challenge, tabs.dim(), 2)
            tabs = F.add(lo, F.mul(diff, r_col))
        del lo, hi, diff
    return msgs, rs


def ml_prove(F: Field, tabs: torch.Tensor, products, coeffs, labels) -> dict:
    """K multilinear sumcheck proofs (`MLSumcheck::prove_as_subprotocol`):
    item k's transcript fed its label, then the polynomial's info (the
    largest product's length and nv, two u64), then the rounds. Returns
    {"messages", "challenges", "next"}: `next` is each transcript's next
    field element after the proof, which stands for its final state."""
    degree = max(len(ix) for ix in products)
    nv = tabs.shape[3].bit_length() - 1
    transcripts = []
    for label in labels:
        t = Transcript()
        t.feed(label)
        t.feed(u64_bytes(degree) + u64_bytes(nv))
        transcripts.append(t)
    msgs, rs = sumcheck_rounds(F, tabs, products, coeffs, degree, transcripts)
    return {"messages": msgs, "challenges": rs,
            "next": [t.field_element(F.p) for t in transcripts]}


def eq_table(F: Field, points) -> torch.Tensor:
    """(16, K, 2^dim): eq(r, z) = prod_i (z_i ? r_i : 1 - r_i) for each
    item's point r (canonical ints), z's bit i against r_i."""
    table = F.one(3).expand(16, len(points), 1).contiguous()
    for i in range(len(points[0])):
        r = _column(F, [F.mont(pt[i]) for pt in points], 3, 1)
        omr = _column(F, [F.mont(1 - pt[i]) for pt in points], 3, 1)
        table = torch.cat([F.mul(table, omr), F.mul(table, r)], dim=2)
    return table


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (16, K, n), idx (K, m) -> (16, K, m)."""
    return table.gather(2, idx.unsqueeze(0).expand(16, -1, -1))


def _segment_sum(F: Field, values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """values (16, K, m) summed by segment id seg (K, m) into (16, K, n),
    reduced mod p."""
    out = torch.zeros(values.shape[:2] + (n,), dtype=torch.int64, device=values.device)
    out.scatter_add_(2, seg.unsqueeze(0).expand(16, -1, -1), values)
    return F.reduce_wide(out)


def gkr_prove(F: Field, f1_idx: torch.Tensor, f1_val: torch.Tensor, f2: torch.Tensor,
              f3: torch.Tensor, gs, labels) -> dict:
    """K GKR round sumcheck proofs (`GKRRoundSumcheck::prove`): f1 sparse
    over 3·dim variables, entry index z + 2^dim x + 2^2dim y, values
    (16, K, nnz); f2, f3 (16, K, 2^dim); gs[k] item k's dim coordinates.

    Phase 1 sums h_g(x) = sum_y f1(g, x, y) f3(y) against f2 (drawing u);
    phase 2 sums f1(g, u, y) against f2(u)·f3(y). The transcripts are fed
    only the labels and the messages. Returns {"phase1", "phase2",
    "next"}."""
    dim = f2.shape[2].bit_length() - 1
    n = 1 << dim
    mask = n - 1
    z, x, y = f1_idx & mask, (f1_idx >> dim) & mask, f1_idx >> (2 * dim)
    transcripts = []
    for label in labels:
        t = Transcript()
        t.feed(label)
        transcripts.append(t)
    ones = [[1] for _ in labels]
    # f1 fixed at g: each entry times eq(g, z)
    at_g = F.mul(f1_val, _gather(eq_table(F, gs), z))
    h_g = _segment_sum(F, F.mul(at_g, _gather(f3, y)), x, n)
    msgs1, u = sumcheck_rounds(F, torch.stack([h_g, f2], dim=1), [(0, 1)], ones, 2,
                               transcripts)
    del h_g
    eq_u = eq_table(F, u)
    f1_gu = _segment_sum(F, F.mul(at_g, _gather(eq_u, x)), y, n)
    del at_g
    f2_u = F.mul(f2, eq_u).sum(-1).cpu().tolist()  # [16][K] digit sums of f2(u)
    f2_u = [digits_int([f2_u[i][k] for i in range(16)]) % F.p for k in range(len(labels))]
    scaled = F.mul(f3, _column(F, f2_u, 3, 1))
    msgs2, _v = sumcheck_rounds(F, torch.stack([f1_gu, scaled], dim=1), [(0, 1)], ones, 2,
                                transcripts)
    return {"phase1": msgs1, "phase2": msgs2,
            "next": [t.field_element(F.p) for t in transcripts]}
