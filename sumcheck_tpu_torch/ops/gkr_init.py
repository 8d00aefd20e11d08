"""GKR phase initialization on the prover's device — the port of
`sumcheck_tpu/ops/gkr_init.py`. On a card each phase init of the generic
chain is one launch of a hand-written kernel (`ops/gkr_init_cuda.py`,
`csrc/gkr_init.cu`); on the CPU its plain version. The JAX package jits
each phase init into one XLA program.

The reference's phase-1 init is a scalar scatter loop over `f1`'s nonzeros
(`gkr_round_sumcheck/mod.rs:22-42`): fix `f1` at `g` (sparse), then
`a_hg[x] += v * f3[y]`. Here, as in the JAX package:

1. **weight fold**: each entry's fixing weight `prod_i (bit_i ? r_i : 1-r_i)`
   from the eq table and one multiply: the kernel's blocks build eq's two
   half tables in their shared memory and multiply each entry by one lane
   of each (up to 21 variables, as far as f1's int64 indices reach);
2. **gather** f3 at the y-part of each index and multiply;
3. **segment sum** over the x-part without a scatter: entries pre-sorted by
   segment on the host (`_split_f1_device`), each segment's limbs summed
   exactly in 64-bit accumulators and reduced mod p, written straight into
   slot 0 of the phase's pair;
4. **the pair's other slot**: f2 (phase 1), or f3 times f2(u), the final
   fold of phase 1's one-lane pair (phase 2).

Steps 1-4 are one launch, `weight_reduce`, over a tile plan built with the
sort; the weights of step 1 go to phase 2 as the carry `w`, in y order.

Phase 2 (`mod.rs:57-63`) reuses the weight fold and the segment sum with
the remaining index bits and the phase-1 challenges, which stay on the
device: `phase2_pair` reads them from the chain's challenge rows, and
nothing between the prove's uploads and its one fetch waits for the host
(no `.item()`, no boolean masks, no upload). A phase is 1 launch on both
chains (`phase1_pair`, `phase2_pair`); a sharded rank's takes 2, the
weight reduce into rank-major raw sums and, after their reduce-scatter, the
finish of only the rank's dealt lanes straight into its pair, slot 1 from
the same launch (`reduce_fn`, `shard`). The per-size pieces of the JAX
package keep their counterparts (`phase1`, `phase2_digits`: 1 launch each; `prep1`,
`final_fold`, `prep2` on `pair_slots`), which no prover path takes. The
batched prover's `phase1_pairs` and `phase2_pairs` build a phase of all B
instances in one launch (`weight_reduce_batched`, grid y = instance).

Layout: f1's split (`F1Split`, `_split_f1_device`, cached per f1 and
device): int32 index components, the values an (nnz, 8) entry-major limb
table sorted by x, the tile plans, and phase 2's view in y order (x and
the carry's row of each entry); the carry `w` (nnz, 8) entry-major limbs
in y order; f2 and f3 the cached (8, 2^dim) limb tables
(`DenseMLE.to_device`); h_g and f1(g, u, .) (8, 2^dim) limb tables in
bit-reversed lane order; the challenges (k, 16) int32 rows of Montgomery
digits (g's from `_point_rows`, u the chain's); f2(u) a (16,) int32 digit
row; the pairs (2, 8, 2^dim / 2) int32, the round kernels' layout.

The torch-op bodies that came before the kernels stay as the plain
versions of the whole phases (`phase1_ref`, `prep1_ref`, `phase1_pair_ref`,
`final_fold_ref`, `phase2_digits_ref`, `prep2_ref`, `phase2_pair_ref`):
the eq table by doublings (`_eq_table`) and the segment sums by
`gkr_init_cuda.segment_reduce_ref`, on any device. No path runs them on a
card: every fold mode runs the kernels, and the tests and `chip_smoke.py`
hold the kernels against them. In the MXU fold mode `_eq_table` and
`prep2_ref` take the banded products (`ops/mxu_mul.py`), the A/B of a
banded-product init that has no kernel yet.

Left out: `_take_small_mxu` and the kron-split modes (they work around XLA's
small-table gather lowering), `bitrev_cols` (the entries are sorted so the
tables come out in bit-reversed order), `warm_pair_programs_async` (compile
warm-up) and `_eq_table_sharded` (the multi-device inits build the whole eq
table on every rank: `parallel/gkr.py`).

The host-facing wrappers `phase1_init_device` / `phase2_init_device`
(`:416-449`) take NumPy arrays and return NumPy tables in natural lane
order, for callers outside a prove; `phase1_init_device_arrays`
(`:315-342`) is their variant that leaves everything on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields import limbs_np as L
from ..fields import limbs_torch as LT
from ..fields.fr import NUM_DIGITS, NUM_LIMBS, P_DIGITS, Fr
from ..protocol import device_prover
from ..utils.config import get_config
from . import gkr_init_cuda as K
from . import mxu_mul

# shared-scalar multiplies at or above this lane count take the banded
# product when the MXU fold mode is on (`sumcheck_tpu/ops/gkr_init.py:37`)
MXU_MIN_LANES = 1 << 11

_ONE = tuple(int(d) for d in L.mont_scalar(1)[:, 0])  # Montgomery one


def prepare(device: torch.device) -> None:
    """Put every constant the plain inits use on `device` (once per
    device), so that the inits themselves upload nothing. `device` carries
    its index (`device_prover.resolve_device`), as a tensor's `.device`
    does."""
    for digits in (P_DIGITS, LT.R2_DIGITS, _ONE):
        LT.const(digits, device)
    mxu_mul._bands(device)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array of digit rows as an int32 tensor on `device`
    (`device_prover.upload`: no host wait on a card)."""
    return device_prover.upload(torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)),
                                device)


def _points_arrays(points: list[Fr]):
    """Challenges -> stacked (k, 16, 1) Montgomery columns for r and 1-r."""
    r = np.stack([L.mont_scalar(p.v) for p in points])
    omr = np.stack([L.mont_scalar((Fr.one() - p).v) for p in points])
    return r, omr


def _point_rows(points: list[Fr]) -> np.ndarray:
    """Challenges -> (k, 16) int32 rows of Montgomery digits, the layout of
    the chain's challenge rows."""
    return np.stack([L.mont_scalar(p.v)[:, 0] for p in points]).astype(np.int32)


def _eq_table(r_pts, omr_pts, k: int) -> torch.Tensor:
    """(16, 2^k) eq table: eq[j] = prod_i (bit_i(j) ? r_i : 1-r_i), built by
    k doublings (bit i of j = variable i, low bits first). r_pts, omr_pts:
    (k, 16, 1) Montgomery digit columns, tensors on one device.

    Each doubling multiplies the whole table by two shared scalars; in the
    MXU fold mode the wide ones (>= MXU_MIN_LANES) run as banded products."""
    use_mxu = get_config().use_mxu_fold()
    eq = LT.const(_ONE, r_pts.device).reshape(NUM_DIGITS, 1)
    for i in range(k):
        if use_mxu and eq.shape[1] >= MXU_MIN_LANES:
            lo = mxu_mul.mont_mul_scalar_mxu(eq, omr_pts[i][:, 0])
            hi = mxu_mul.mont_mul_scalar_mxu(eq, r_pts[i][:, 0])
        else:
            lo = LT.mont_mul(eq, omr_pts[i])
            hi = LT.mont_mul(eq, r_pts[i])
        eq = torch.cat([lo, hi], dim=1)  # (16, 2^(i+1))
    return eq


def _weight_fold(indices, values, r_pts, omr_pts, k: int) -> torch.Tensor:
    """values * prod_{i<k} (bit_i(indices) ? r_i : 1-r_i), through the eq
    table: one gather and one multiply (the JAX package's plain branch)."""
    eq = _eq_table(r_pts, omr_pts, k)
    return LT.mont_mul(values, eq.index_select(1, indices))


def _segment_reduce_sorted(vals, perm, last_pos) -> torch.Tensor:
    """`_segment_reduce_sorted` (`:237-274`) on (16, nnz) digits: the exact
    sum mod p of each segment of the sorted entries, strict (16, segments)
    digits, by `gkr_init_cuda.segment_reduce_ref` (the JAX package's byte
    split of wide segments gives the same sums)."""
    out = torch.empty((NUM_LIMBS, last_pos.shape[0]), dtype=torch.int32, device=vals.device)
    K.segment_reduce_ref(LT.pack_limbs(vals), None if perm is None else perm.int(),
                         last_pos.int(), out)
    return LT.unpack_limbs(out)


class F1Split(NamedTuple):
    """f1's entries on a device in the kernels' layout (`_split_f1_device`).
    Phase 1 reads them sorted by the bit-reversed x segment, phase 2 sorted
    by the bit-reversed y segment (both stable)."""

    gbits: torch.Tensor  # (nnz,) the g part of each index, x order
    y_rev: torch.Tensor  # (nnz,) the y part, bit-reversed (f3's lane), x order
    vals: torch.Tensor  # (nnz, 8) entry-major limbs of the values, x order
    last_x: torch.Tensor  # (2^dim,) each x segment's last position
    plan_x: K.Plan  # the fused kernel's tiles over the x segments
    to_y: torch.Tensor  # (nnz,) each entry's position in y order: its row of the carry
    x_y: torch.Tensor  # (nnz,) the x part, y order
    last_y: torch.Tensor  # (2^dim,) each y segment's last position
    plan_y: K.Plan  # the tiles over the y segments


def _split_f1_device(f1, dim: int, device: torch.device, shard=None) -> F1Split:
    """f1's index components and values on `device`, with the segment
    metadata and the tile plans, cached on the (immutable) SparseMLE per
    (dim, device).

    The entries are sorted by the bit-reversed x, so the phase-1 segment
    sum needs no gather and h_g comes out in the bit-reversed lane order of
    the round chain; gbits, x, y the low, middle and top dim bits of each
    index (y bit-reversed, to gather from the bit-reversed f3); `last_*` each
    bit-reversed segment's last sorted position. Phase 1 writes the weights
    `w` (the carry) in y order, each entry at its row `to_y`, so phase 2
    reads them, and x in y order (`x_y`), in sequence. Every component is
    int32, the values an (nnz, 8) int32 entry-major limb table
    (`limbs_np.pack_limbs`), and the plans `gkr_init_cuda.tile_plan`'s. (The
    JAX package also keeps perm_x, the identity, for its batch prover, and
    the segment-sum widths; the port drops them, and keeps `perm_y` as its
    inverse `to_y`.)

    With `shard` = (s, S), only rank s's chunk of the multi-device inits
    (`parallel/gkr.py`, cached per (dim, device, s, S)): the sorted
    entries cut into S contiguous chunks, the last padded with zero
    entries at x = all ones (the last bit-reversed x segment, so every
    chunk stays sorted and the padding adds nothing), each chunk with its
    own metadata."""
    from ..protocol.prover import bitrev_perm

    key = (dim, device) if shard is None else (dim, device, *shard)
    cached = f1._dev_split.get(key)
    if cached is not None:
        return cached
    idx = np.asarray(f1.indices).astype(np.int64)
    mask = (1 << dim) - 1
    revp = bitrev_perm(dim)
    x_rev = revp[(idx >> dim) & mask]
    order = np.argsort(x_rev, kind="stable")
    idx, vals = idx[order], np.asarray(f1.values)[:, order]
    if shard is not None:
        s, size = shard
        chunk = max(1, -(-len(idx) // size))
        pad = size * chunk - len(idx)
        mine = slice(s * chunk, (s + 1) * chunk)
        idx = np.concatenate([idx, np.full(pad, mask << dim, np.int64)])[mine]
        vals = np.concatenate([vals, np.zeros((NUM_DIGITS, pad), vals.dtype)], axis=1)[:, mine]
    nnz = len(idx)
    assert nnz <= 1 << 24, "segment sums are exact up to 2^24 entries"
    x = (idx >> dim) & mask  # natural values, sorted by their bit reversal
    y_rev = revp[idx >> (2 * dim)]
    segments = np.arange(1 << dim)
    last_x = np.searchsorted(revp[x], segments, side="right") - 1
    perm_y = np.argsort(y_rev, kind="stable")
    last_y = np.searchsorted(y_rev[perm_y], segments, side="right") - 1
    to_y = np.empty(nnz, np.int64)
    to_y[perm_y] = np.arange(nnz)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)

    out = F1Split(ints(idx & mask), ints(y_rev), torch.from_numpy(L.pack_limbs(vals.T, axis=1))
                  .to(device), ints(last_x), K.upload_plan(last_x, nnz, device), ints(to_y),
                  ints(x[perm_y]), ints(last_y), K.upload_plan(last_y, nnz, device))
    f1._dev_split[key] = out
    return out


def _halves(a: torch.Tensor, b: torch.Tensor, out=None):
    """Two (8, n) int32 limb tables -> the round kernels' (2, 8, n/2)
    pair, fresh or written into `out` = (lo, hi) (one instance's slice of
    a batched pair)."""
    s = torch.stack([a, b])
    n = s.shape[2]
    if out is None:
        return s[:, :, : n // 2].contiguous(), s[:, :, n // 2 :].contiguous()
    out[0].copy_(s[:, :, : n // 2])
    out[1].copy_(s[:, :, n // 2 :])
    return out


def _new_pair(n: int, device, out=None):
    """`out` = (lo, hi), or a fresh (2, 8, n/2) int32 pair."""
    if out is not None:
        return out
    lo = torch.empty((2, NUM_LIMBS, n // 2), dtype=torch.int32, device=device)
    return lo, torch.empty_like(lo)


# ---------------------------------------------------------------------------
# the plain versions of the whole phases: the torch-op bodies
# ---------------------------------------------------------------------------


def _columns(rows: torch.Tensor, k: int):
    """(>= k, 16) digit rows -> (k, 16, 1) int64 columns r and 1 - r."""
    one = LT.const(_ONE, rows.device).reshape(NUM_DIGITS, 1)
    r_pts = rows[:k].long()[:, :, None]
    return r_pts, torch.stack([LT.sub(one, r) for r in r_pts])


def _carry(w: torch.Tensor, to_y: torch.Tensor) -> torch.Tensor:
    """(8, nnz) weights in x order -> the carry, (nnz, 8) entry-major with
    entry j at row to_y[j] (y order)."""
    carry = torch.empty((w.shape[1], NUM_LIMBS), dtype=torch.int32, device=w.device)
    carry[to_y.long()] = w.T
    return carry


def phase1_ref(split: F1Split, g_r, f3_bitrev, dim: int):
    """Plain version of `phase1`, `_compiled_phase1` (`:284-301`) as torch
    ops: the eq table by doublings, one gather and multiply, the f3 gather
    and multiply, and the plain segment reduce; the weights as the carry."""
    r_pts, omr_pts = _columns(g_r, dim)
    w = _weight_fold(split.gbits, LT.unpack_limbs(split.vals, dim=1).T, r_pts, omr_pts, dim)
    f3y = LT.unpack_limbs(f3_bitrev.index_select(1, split.y_rev))  # f3[y]
    hg = torch.empty((NUM_LIMBS, 1 << dim), dtype=torch.int32, device=f3_bitrev.device)
    K.segment_reduce_ref(LT.pack_limbs(LT.mont_mul(w, f3y)), None, split.last_x, hg)
    return hg, _carry(LT.pack_limbs(w), split.to_y)


def prep1_ref(hg_brev, f2_bitrev, out=None):
    """Plain version of `prep1`."""
    return _halves(hg_brev, f2_bitrev, out)


def phase1_pair_ref(split: F1Split, g_r, f3_bitrev, f2_bitrev, dim: int, out=None):
    """Plain version of `phase1_pair`, `_phase1_pair_body` (`:472-491`)."""
    hg, w = phase1_ref(split, g_r, f3_bitrev, dim)
    lo, hi = prep1_ref(hg, f2_bitrev, out)
    return lo, hi, w


def final_fold_ref(lo, hi, r, slot: int) -> torch.Tensor:
    """Plain version of `final_fold`."""
    return K.final_fold_ref(lo, hi, r, slot).to(torch.int32)


def phase2_digits_ref(split: F1Split, w, u_digits, dim: int):
    """Plain version of `phase2_digits`, `_compiled_phase2_digits`
    (`:621-634`) as torch ops, over the carry in y order."""
    r_pts, omr_pts = _columns(u_digits, dim)
    w2 = _weight_fold(split.x_y, LT.unpack_limbs(w, dim=1).T, r_pts, omr_pts, dim)
    f1gu = torch.empty((NUM_LIMBS, 1 << dim), dtype=torch.int32, device=w.device)
    K.segment_reduce_ref(LT.pack_limbs(w2), None, split.last_y, f1gu)
    return f1gu


def prep2_ref(f1gu_brev, f3_bitrev, f2u, out=None):
    """Plain version of `prep2`, `_compiled_prep2` (`:637-654`); the
    scaling is a banded product in the MXU fold mode."""
    f3 = LT.unpack_limbs(f3_bitrev)
    if get_config().use_mxu_fold() and f3.shape[1] >= MXU_MIN_LANES:
        f3f2u = mxu_mul.mont_mul_scalar_mxu(f3, f2u.long())
    else:
        f3f2u = LT.mont_mul(f3, f2u.long()[:, None])
    return _halves(f1gu_brev, LT.pack_limbs(f3f2u), out)


def phase2_pair_ref(pair_lo, pair_hi, r_last, split: F1Split, w, u_digits, f3_bitrev, dim: int,
                    out=None):
    """Plain version of `phase2_pair`, `_phase2_pair_body` (`:494-522`)."""
    f2u = final_fold_ref(pair_lo, pair_hi, r_last, 1)
    f1gu = phase2_digits_ref(split, w, u_digits, dim)
    return prep2_ref(f1gu, f3_bitrev, f2u, out)


# ---------------------------------------------------------------------------
# the phases on the kernels
# ---------------------------------------------------------------------------


def _reduce(idx, vals, r, dim: int, last, plan, dst, reduce_fn=None, shard=None, slot=None,
            **kw):
    """The fused weight fold and segment sum by eq(r, .) into `dst`, and
    the pair's other slot (`slot`): 1 launch (`weight_reduce`; `kw` takes
    phase 1's f3, y and to_y, which gather f3 and return the carry). With
    `reduce_fn` (rank s of S, `shard`) the raw segment sums, rank-major
    (S, 8, nseg/S), go to it; it returns the rank's block summed over the
    ranks, (8, nseg/S), and a second launch finishes that block into `dst`
    and writes the slot (`finish_sums`)."""
    if reduce_fn is None:
        return K.weight_reduce(idx, vals, r, dim, last, plan, dst, slot=slot, **kw)
    size = (shard or (0, 1))[1]
    nseg = last.shape[0]
    sums = torch.empty((size, NUM_LIMBS, nseg // size), dtype=torch.int64, device=vals.device)
    carry = K.weight_reduce(idx, vals, r, dim, last, plan, sums, ranks=size, **kw)
    K.finish_sums(reduce_fn(sums), dst, slot)
    return carry


def _reduce1(split: F1Split, g_r, f3_bitrev, dim: int, dst, reduce_fn=None, shard=None,
             slot=None):
    """Phase 1's `_reduce`: h_g into `dst`; returns the carry."""
    return _reduce(split.gbits, split.vals, g_r, dim, split.last_x, split.plan_x, dst, reduce_fn,
                   shard, slot, f3=f3_bitrev, y=split.y_rev, to_y=split.to_y)


def phase1(split: F1Split, g_r, f3_bitrev, dim: int):
    """h_g as an (8, 2^dim) limb table in bit-reversed lane order, and the
    entries' weights `w` as the carry, (nnz, 8) in y order, kept for phase 2
    (`_compiled_phase1`, `:284-301`): 1 launch. `g_r` is g's (dim, 16)
    digit rows, `f3_bitrev` the cached (8, 2^dim) limb table."""
    hg = torch.empty((NUM_LIMBS, 1 << dim), dtype=torch.int32, device=f3_bitrev.device)
    return hg, _reduce1(split, g_r, f3_bitrev, dim, hg)


def prep1(hg_brev, f2_bitrev, out=None):
    """[h_g, f2] (8, 2^dim) limb tables -> the phase-1 (lo, hi) pair, (2, 8,
    2^dim / 2) int32, fresh or written into `out`: 1 launch."""
    lo, hi = _new_pair(hg_brev.shape[1], hg_brev.device, out)
    K.pair_slots(lo, hi, ((0, hg_brev, None), (1, f2_bitrev, None)))
    return lo, hi


def phase1_pair(split: F1Split, g_r, f3_bitrev, f2_bitrev, dim: int, out=None,
                reduce_fn=None, shard=None):
    """`_phase1_pair_body` (`:472-491`): the phase-1 pair (written into
    `out` = (lo, hi) if given) and the carry `w`: 1 launch, h_g summed
    straight into slot 0 and f2 copied into slot 1. A sharded rank passes
    `reduce_fn`, `shard` = (s, S) and, as `f2_bitrev`, its dealt f2
    (`DenseMLE.to_device(device, shard)`). `reduce_fn` takes the raw
    segment sums of the rank's chunk `split`, a (S, 8, 2^dim / S) int64
    tensor whose block [s] holds rank s's dealt segments, and returns rank
    s's block summed over the ranks, (8, 2^dim / S) int64 (the sharded
    prover passes `comm.reduce_scatter_sum_`). The pair is rank s's deal,
    (2, 8, 2^dim / 2S), local lane l of each half the global pair lane
    l·S + s (`parallel/mesh.deal`), h_g's dealt lanes finished straight
    into slot 0 and f2's copied into slot 1 by `finish_sums`: 2 launches,
    the finish over 2^dim / S lanes (the JAX package's `psum_scatter` and
    shard-local finish, `sumcheck_tpu/parallel/gkr.py:50-74`, with no
    all-gather)."""
    size = 1 if shard is None else shard[1]
    lo, hi = _new_pair((1 << dim) // size, f3_bitrev.device, out)
    w = _reduce1(split, g_r, f3_bitrev, dim, (lo, hi), reduce_fn, shard, (f2_bitrev, None))
    return lo, hi, w


def final_fold(lo, hi, r, slot: int) -> torch.Tensor:
    """Fold slot `slot` of the 1-lane final pair by the last challenge (16
    digits): the table at the phase's point, (16,) int32 digits; 1 launch."""
    out = torch.empty(NUM_DIGITS, dtype=torch.int32, device=lo.device)
    K.pair_slots(None, None, (), fold=(lo, hi, r, slot), fold_out=out)
    return out


def phase2_digits(split: F1Split, w, u_digits, dim: int):
    """f1(g, u, .) densified, an (8, 2^dim) limb table in bit-reversed lane
    order, from phase 1's carry `w` and the challenges u as (dim, 16)
    Montgomery digit rows on the device: 1 launch."""
    f1gu = torch.empty((NUM_LIMBS, 1 << dim), dtype=torch.int32, device=w.device)
    _reduce(split.x_y, w, u_digits, dim, split.last_y, split.plan_y, f1gu)
    return f1gu


def prep2(f1gu_brev, f3_bitrev, f2u, out=None):
    """[f1_gu, f3] (8, 2^dim) limb tables and f2(u), (16,) int32 digits ->
    the phase-2 pair for `f1_gu * (f2(u) * f3)` (reference `mod.rs:66-82`),
    (2, 8, 2^dim / 2) int32: 1 launch."""
    lo, hi = _new_pair(f1gu_brev.shape[1], f1gu_brev.device, out)
    K.pair_slots(lo, hi, ((0, f1gu_brev, None), (1, f3_bitrev, f2u)))
    return lo, hi


def phase2_pair(pair_lo, pair_hi, r_last, split: F1Split, w, u_digits, f3_bitrev, dim: int,
                out=None, reduce_fn=None, shard=None):
    """`_phase2_pair_body` (`:494-522`): f2(u) from the phase-1 final pair
    (lane 0 of `pair_lo`, `pair_hi`), the phase-2 init, and the phase-2
    pair (written into `out` = (lo, hi) if given, which must not overlap
    the final pair): 1 launch, f1(g, u, .) summed straight into slot 0, and
    f3 times the final fold, computed in each block, into slot 1. A sharded
    rank passes `reduce_fn` (which returns the rank's summed block of the
    raw sums) and `shard`, as in `phase1_pair`, and as `f3_bitrev` its
    dealt f3: its dealt pair, f1(g, u, .)'s dealt lanes
    finished into slot 0 and f3's times the final fold (of the replicated
    one-lane pair of `sharded_rounds`' tail) into slot 1 by `finish_sums`:
    2 launches."""
    size = 1 if shard is None else shard[1]
    lo, hi = _new_pair((1 << dim) // size, w.device, out)
    _reduce(split.x_y, w, u_digits, dim, split.last_y, split.plan_y, (lo, hi), reduce_fn, shard,
            (f3_bitrev, (pair_lo, pair_hi, r_last, 1)))
    return lo, hi


def phase1_pairs(splits, g_rs, f3s, f2s, dim: int, lo, hi) -> list:
    """`phase1_pair` of B instances in one launch (the batched prover's
    phase 1, the JAX package's vmapped `_bgkr_phase1`,
    `sumcheck_tpu/batch.py:565-572`): instance b's pair written into
    lo[b], hi[b] of the (B, 2, 8, 2^dim/2) batched pair, from its own f1
    split, g rows, f3 and f2. Returns the B carries."""
    return K.weight_reduce_batched([
        K.Instance(s.gbits, s.vals, g_r, s.last_x, s.plan_x, (lo[b], hi[b]), f3=f3, y=s.y_rev,
                   to_y=s.to_y, slot=(f2, None))
        for b, (s, g_r, f3, f2) in enumerate(zip(splits, g_rs, f3s, f2s))], dim)


def phase2_pairs(pair_lo, pair_hi, r_last, splits, ws, u_rows, f3s, dim: int, lo, hi) -> None:
    """`phase2_pair` of B instances in one launch (`_bgkr_phase2`,
    `sumcheck_tpu/batch.py:574-580`): instance b's phase-2 pair into lo[b],
    hi[b] from its carry ws[b], its column u_rows[:, b] of the (dim, B, 16)
    challenge rows, its f3, and f2(u) folded from its lane-0 final pair
    (pair_lo[b], pair_hi[b], (B, 2, 8, >= 1)) by r_last[b]."""
    K.weight_reduce_batched([
        K.Instance(s.x_y, w, u_rows[:, b], s.last_y, s.plan_y, (lo[b], hi[b]),
                   slot=(f3, (pair_lo[b], pair_hi[b], r_last[b], 1)))
        for b, (s, w, f3) in enumerate(zip(splits, ws, f3s))], dim)


# ---------------------------------------------------------------------------
# host-facing wrappers (`sumcheck_tpu/ops/gkr_init.py:315-342, 416-449`)
# ---------------------------------------------------------------------------


class _HostF1:
    """f1's nonzeros as `_split_f1_device` reads them, with its caches."""

    def __init__(self, indices, values):
        self.indices, self.values = np.asarray(indices), np.asarray(values)
        self._dev_split: dict = {}


def phase1_init_device_arrays(f1, f3, g: list[Fr], dim: int, device="cuda"):
    """h_g and phase 2's carry on `device`, with no host sync: h_g as an
    (8, 2^dim) int32 limb table in bit-reversed lane order, and the carry
    (f1's split, w) that `phase2_init_device` takes. `f1` has `indices` and
    `values` (a `SparseMLE`: its split is cached on it), `f3` a `to_device`
    (a `DenseMLE`)."""
    device = device_prover.resolve_device(device)
    split = _split_f1_device(f1, dim, device)
    prepare(device)
    hg, w = phase1(split, upload(_point_rows(list(g)), device), f3.to_device(device), dim)
    return hg, (split, w)


def _natural(table: torch.Tensor, dim: int) -> np.ndarray:
    """An (8, 2^dim) limb table in bit-reversed lane order -> (16, 2^dim)
    uint32 NumPy digits in natural lane order."""
    from ..protocol.prover import bitrev_perm

    return L.unpack_limbs(table.cpu().numpy())[:, bitrev_perm(dim)]


def phase1_init_device(f1_indices, f1_values, f3_evals, g: list[Fr], dim: int,
                       device="cuda"):
    """h_g(x) = sum_y f1(g, x, y) f3(y) by the device init on `device` from
    f1's nonzeros (indices, (16, nnz) Montgomery digits) and f3's (16,
    2^dim) natural-order digits: returns (h_g as a (16, 2^dim) uint32 NumPy
    array in natural lane order, the carry for `phase2_init_device`)."""
    from ..mle import DenseMLE

    hg, carry = phase1_init_device_arrays(_HostF1(f1_indices, f1_values),
                                          DenseMLE(dim, np.asarray(f3_evals, np.uint32)), g, dim,
                                          device)
    return _natural(hg, dim), carry


def phase2_init_device(carry, u: list[Fr], dim: int) -> np.ndarray:
    """f1(g, u, .) densified on the carry's device: a (16, 2^dim) uint32
    NumPy array in natural lane order."""
    split, w = carry
    f1gu = phase2_digits(split, w, upload(_point_rows(list(u)), w.device), dim)
    return _natural(f1gu, dim)
