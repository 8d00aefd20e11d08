"""GKR phase initialization on the prover's device — the port of
`sumcheck_tpu/ops/gkr_init.py`, as plain torch ops (the JAX package has no
Pallas kernel here either; it leaves these to XLA).

The reference's phase-1 init is a scalar scatter loop over `f1`'s nonzeros
(`gkr_round_sumcheck/mod.rs:22-42`): fix `f1` at `g` (sparse), then
`a_hg[x] += v * f3[y]`. Here, as in the JAX package:

1. **weight fold**: each entry's fixing weight `prod_i (bit_i ? r_i : 1-r_i)`
   as one gather from the eq table (`_eq_table`, built by doublings) and one
   batched Montgomery multiply;
2. **gather** f3 at the y-part of each index and multiply;
3. **segment sum** over the x-part without a scatter: entries pre-sorted by
   segment on the host (`_split_f1_device`), a cumulative sum, and the
   difference at each segment's last position (`_segment_reduce_sorted`),
   then an exact mod-p reduction of the wide per-segment sums.

Phase 2 (`mod.rs:57-63`) reuses the weight fold and the segment sum with
the remaining index bits and the phase-1 challenges, which stay on the
device: `phase2_pair` (the generic chain) and `final_fold`,
`phase2_digits`, `prep2` (the per-size chain) read them from the chain's
challenge buffer, and nothing between the prove's uploads and its one fetch
waits for the device (no `.item()`, no boolean masks, no `nonzero`, no
upload: `prepare` puts every constant on the device first).

The inits compute on `int64` digits (`fields/limbs_torch.py`). They read
the cached f2 and f3 (`DenseMLE.to_device`, 8 x 32-bit limbs) through
`limbs_torch.unpack_limbs` and write the phase pairs packed (`_halves`,
`limbs_torch.pack_limbs`), the round kernels' layout.

Digits are `int64`, so the segment sums' cumulative
sums are exact for any entry count up to 2^24 (asserted), and both digit
split widths of the JAX package give exact sums; the port keeps the JAX
package's choice of width (`_seg_narrow`) all the same.

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

import numpy as np
import torch

from ..fields import limbs_np as L
from ..fields import limbs_torch as LT
from ..fields.fr import NUM_DIGITS, P_DIGITS, Fr
from ..protocol import device_prover
from ..utils.config import get_config
from . import mxu_mul

# shared-scalar multiplies at or above this lane count take the banded
# product when the MXU fold mode is on (`sumcheck_tpu/ops/gkr_init.py:37`)
MXU_MIN_LANES = 1 << 11

_ONE = tuple(int(d) for d in L.mont_scalar(1)[:, 0])  # Montgomery one


def prepare(device: torch.device) -> None:
    """Put every constant the inits use on `device` (once per device), so
    that the inits themselves upload nothing. `device` carries its index
    (`device_prover.resolve_device`), as a tensor's `.device` does."""
    for digits in (P_DIGITS, LT.R2_DIGITS, _ONE):
        LT.const(digits, device)
    mxu_mul._bands(device)


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as an int64 tensor on `device` (`device_prover.upload`:
    no host wait on a card)."""
    return device_prover.upload(torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64)),
                                device)


def _points_arrays(points: list[Fr]):
    """Challenges -> stacked (k, 16, 1) Montgomery columns for r and 1-r."""
    r = np.stack([L.mont_scalar(p.v) for p in points])
    omr = np.stack([L.mont_scalar((Fr.one() - p).v) for p in points])
    return r, omr


def _eq_table(r_pts, omr_pts, k: int) -> torch.Tensor:
    """(16, 2^k) eq table: eq[j] = prod_i (bit_i(j) ? r_i : 1-r_i), built by
    k doublings (bit i of j = variable i, low bits first). r_pts, omr_pts:
    indexable (k, 16, 1) Montgomery digit columns on one device.

    Each doubling multiplies the whole table by two shared scalars; in the
    MXU fold mode the wide ones (>= MXU_MIN_LANES) run as banded products."""
    use_mxu = get_config().use_mxu_fold()
    eq = LT.const(_ONE, r_pts[0].device).reshape(NUM_DIGITS, 1)
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


def _finish_segment_sums(slo, shi) -> torch.Tensor:
    """(16, S) 8-bit-split sums -> strict, reduced mod p."""
    zero = torch.zeros_like(slo[0])
    relaxed = []
    for d in range(NUM_DIGITS + 2):
        r = zero
        if d < NUM_DIGITS:
            r = r + slo[d] + ((shi[d] & 0xFF) << 8)
        if 1 <= d <= NUM_DIGITS:
            r = r + (shi[d - 1] >> 8)
        relaxed.append(r)
    strict, _ = LT._chain(relaxed + [zero] * (LT.WIDE_DIGITS - len(relaxed)))
    return LT.reduce_wide(torch.stack(strict))


def _finish_segment_sums16(s) -> torch.Tensor:
    """(16, S) unsplit digit sums -> strict, reduced mod p. Splits after
    the reduction: the carries ride into the next digit."""
    zero = torch.zeros_like(s[0])
    relaxed = []
    for d in range(NUM_DIGITS + 1):
        r = zero
        if d < NUM_DIGITS:
            r = r + (s[d] & 0xFFFF)
        if d >= 1:
            r = r + (s[d - 1] >> 16)
        relaxed.append(r)
    strict, _ = LT._chain(relaxed + [zero] * (LT.WIDE_DIGITS - len(relaxed)))
    return LT.reduce_wide(torch.stack(strict))


def segment_sums(vals, perm, last_pos, split8: bool = True) -> torch.Tensor:
    """The raw int64 segment sums, (32 | 16, segments), without a scatter:
    gather the entries into segment order (`perm`; None when `vals` is
    already in it), take the cumulative sum along the entries, and
    difference it at each segment's last position (`last_pos`, -1 for an
    empty segment). `split8` splits the 16-bit digits into bytes first (32
    rows), as the JAX package does for segments that may hold more than
    2^16 entries; either way the int64 cumulative sum is exact (no
    wraparound to cancel), so both widths give the same result. Sums over
    disjoint sets of entries add exactly: the multi-device inits sum them
    over the ranks before `finish_segment_sums`."""
    v = vals if perm is None else vals.index_select(1, perm)
    rows = torch.cat([v & 0xFF, v >> 8], dim=0) if split8 else v  # (32 | 16, nnz)
    csum = torch.cumsum(rows, dim=1)
    at_last = csum.index_select(1, last_pos.clamp(min=0))
    at_last = torch.where(last_pos[None, :] >= 0, at_last, 0)
    prev = torch.cat([torch.zeros_like(at_last[:, :1]), at_last[:, :-1]], dim=1)
    return at_last - prev


def finish_segment_sums(sums, split8: bool = True) -> torch.Tensor:
    """`segment_sums` -> strict (16, segments) digits, reduced mod p."""
    if split8:
        return _finish_segment_sums(sums[:NUM_DIGITS], sums[NUM_DIGITS:])
    return _finish_segment_sums16(sums)


def _segment_reduce_sorted(vals, perm, last_pos, split8: bool = True,
                           reduce_fn=None) -> torch.Tensor:
    """Exact segment sums, strict and reduced mod p: `segment_sums`, then
    `reduce_fn` on them in place if given (the sum over the ranks of the
    multi-device inits), then `finish_segment_sums`."""
    sums = segment_sums(vals, perm, last_pos, split8)
    if reduce_fn is not None:
        reduce_fn(sums)
    return finish_segment_sums(sums, split8)


def _split_f1_device(f1, dim: int, device: torch.device, shard=None):
    """f1's index components and values on `device`, with the segment
    metadata, cached on the (immutable) SparseMLE per (dim, device).

    Returns (gbits, x, y_rev, vals, last_x, perm_y, last_y): the entries
    sorted by the bit-reversed x, so the phase-1 segment reduce needs no
    gather and h_g comes out in the bit-reversed lane order of the round
    chain; gbits, x, y the low, middle and top dim bits of each index (y
    bit-reversed, to gather from the bit-reversed f3); `last_*` each
    bit-reversed segment's last sorted position; `perm_y` the sort by the
    bit-reversed y. Also records in `f1._seg_narrow` whether the no-split
    segment reduce is the JAX package's choice per axis (at most 2^16
    entries per segment). (The JAX package also keeps perm_x, the
    identity, for its batch prover; the port drops it.)

    With `shard` = (s, S), only rank s's chunk of the multi-device inits
    (`parallel/gkr.py`, cached per (dim, device, s, S)): the sorted
    entries cut into S contiguous chunks, the last padded with zero
    entries at x = all ones (the last bit-reversed x segment, so every
    chunk stays sorted and the padding adds nothing), each chunk with its
    own metadata. The widths are the whole f1's either way, so every rank
    chooses alike."""
    from ..protocol.prover import bitrev_perm

    key = (dim, device) if shard is None else (dim, device, *shard)
    cached = f1._dev_split.get(key)
    if cached is not None:
        return cached
    idx = np.asarray(f1.indices).astype(np.int64)
    mask = (1 << dim) - 1
    revp = bitrev_perm(dim)
    x_rev = revp[(idx >> dim) & mask]
    f1._seg_narrow = tuple(bool(np.bincount(seg, minlength=1).max() <= (1 << 16))
                           for seg in (x_rev, revp[idx >> (2 * dim)]))
    order = np.argsort(x_rev, kind="stable")
    idx, vals = idx[order], np.asarray(f1.values)[:, order]
    if shard is not None:
        s, size = shard
        chunk = max(1, -(-len(idx) // size))
        pad = size * chunk - len(idx)
        mine = slice(s * chunk, (s + 1) * chunk)
        idx = np.concatenate([idx, np.full(pad, mask << dim, np.int64)])[mine]
        vals = np.concatenate([vals, np.zeros((NUM_DIGITS, pad), vals.dtype)], axis=1)[:, mine]
    assert len(idx) <= 1 << 24, "cumsum exactness bound"
    x = (idx >> dim) & mask  # natural values, sorted by their bit reversal
    y_rev = revp[idx >> (2 * dim)]
    segments = np.arange(1 << dim)
    last_x = np.searchsorted(revp[x], segments, side="right") - 1
    perm_y = np.argsort(y_rev, kind="stable")
    last_y = np.searchsorted(y_rev[perm_y], segments, side="right") - 1
    out = tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)
                for a in (idx & mask, x, y_rev, vals, last_x, perm_y, last_y))
    f1._dev_split[key] = out
    return out


def _seg_narrow(f1) -> tuple[bool, bool]:
    """(x-axis, y-axis) no-split segment-reduce choice recorded at split
    time; (False, False), the always-exact byte split, before it."""
    return f1._seg_narrow


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


def phase1(gbits, last_x, y_rev, values, g_r, g_omr, f3_bitrev, dim: int,
           split8x: bool = True, reduce_fn=None):
    """h_g (16, 2^dim) digits in bit-reversed lane order, and the entries'
    weights `w` (kept for phase 2): `_compiled_phase1` (`:284-301`).
    `f3_bitrev` is the cached (8, 2^dim) limb table. `reduce_fn` sums the
    raw segment sums over the ranks (`_segment_reduce_sorted`)."""
    w = _weight_fold(gbits, values, g_r, g_omr, dim)
    f3y = LT.unpack_limbs(f3_bitrev.index_select(1, y_rev))  # f3[y]
    wv = LT.mont_mul(w, f3y)
    return _segment_reduce_sorted(wv, None, last_x, split8x, reduce_fn), w


def prep1(hg_brev, f2_bitrev, out=None):
    """[h_g (16, 2^dim) digits, f2 (8, 2^dim) limbs] -> the phase-1 (lo, hi)
    pair, (2, 8, 2^dim / 2) int32."""
    return _halves(LT.pack_limbs(hg_brev), f2_bitrev, out)


def phase1_pair(gbits, last_x, y_rev, values, g_r, g_omr, f3_bitrev, f2_bitrev,
                dim: int, split8x: bool = True, out=None):
    """`_phase1_pair_body` (`:472-491`): the phase-1 pair (written into
    `out` = (lo, hi) if given) and `w`."""
    hg, w = phase1(gbits, last_x, y_rev, values, g_r, g_omr, f3_bitrev, dim, split8x)
    lo, hi = prep1(hg, f2_bitrev, out)
    return lo, hi, w


def final_fold(lo, hi, r, slot: int) -> torch.Tensor:
    """Fold slot `slot` of the 1-lane final pair by the last challenge (16
    digits): the table at the phase's point, (16,) digits."""
    l, h = LT.unpack_limbs(lo[slot, :, 0]), LT.unpack_limbs(hi[slot, :, 0])
    return LT.add(l, LT.mont_mul(LT.sub(h, l), r.long()))


def phase2_digits(x, perm_y, last_y, w, u_digits, dim: int, split8y: bool = True,
                  reduce_fn=None):
    """f1(g, u, .) densified, (16, 2^dim) in bit-reversed lane order, from
    the challenges u as (dim, 16) Montgomery digits on the device.
    `reduce_fn` as in `phase1`."""
    one = LT.const(_ONE, w.device).reshape(NUM_DIGITS, 1)
    r_pts = [u_digits[i].long()[:, None] for i in range(dim)]
    omr_pts = [LT.sub(one, r) for r in r_pts]
    w2 = _weight_fold(x, w, r_pts, omr_pts, dim)
    return _segment_reduce_sorted(w2, perm_y, last_y, split8y, reduce_fn)


def prep2(f1gu_brev, f3_bitrev, f2u, out=None):
    """[f1_gu (16, 2^dim) digits, f3 (8, 2^dim) limbs, f2(u) (16,) digits]
    -> the phase-2 pair for `f1_gu * (f2(u) * f3)` (reference
    `mod.rs:66-82`), (2, 8, 2^dim / 2) int32; the scaling is a banded
    product in the MXU fold mode."""
    f3 = LT.unpack_limbs(f3_bitrev)
    if get_config().use_mxu_fold() and f3.shape[1] >= MXU_MIN_LANES:
        f3f2u = mxu_mul.mont_mul_scalar_mxu(f3, f2u)
    else:
        f3f2u = LT.mont_mul(f3, f2u[:, None])
    return _halves(LT.pack_limbs(f1gu_brev), LT.pack_limbs(f3f2u), out)


def phase2_pair(pair_lo, pair_hi, r_last, x, perm_y, last_y, w, u_digits, f3_bitrev,
                dim: int, split8y: bool = True, out=None):
    """`_phase2_pair_body` (`:494-522`): f2(u) from the phase-1 final pair,
    the phase-2 init, and the phase-2 pair (written into `out` = (lo, hi)
    if given)."""
    f2u = final_fold(pair_lo, pair_hi, r_last, 1)
    f1gu = phase2_digits(x, perm_y, last_y, w, u_digits, dim, split8y)
    return prep2(f1gu, f3_bitrev, f2u, out)


# ---------------------------------------------------------------------------
# host-facing wrappers (`sumcheck_tpu/ops/gkr_init.py:315-342, 416-449`)
# ---------------------------------------------------------------------------


class _HostF1:
    """f1's nonzeros as `_split_f1_device` reads them, with its caches."""

    def __init__(self, indices, values):
        self.indices, self.values = np.asarray(indices), np.asarray(values)
        self._dev_split: dict = {}
        self._seg_narrow = (False, False)


def phase1_init_device_arrays(f1, f3, g: list[Fr], dim: int, device="cuda"):
    """h_g and phase 2's carry on `device`, with no host sync: h_g as a
    (16, 2^dim) int64 tensor in bit-reversed lane order, and the carry
    (x, perm_y, last_y, w, narrow_y) that `phase2_init_device` takes. `f1`
    has `indices` and `values` (a `SparseMLE`: its split is cached on it),
    `f3` a `to_device` (a `DenseMLE`)."""
    device = device_prover.resolve_device(device)
    gbits, x, y_rev, vals, last_x, perm_y, last_y = _split_f1_device(f1, dim, device)
    narrow_x, narrow_y = _seg_narrow(f1)
    prepare(device)
    g_r, g_omr = (upload(a, device) for a in _points_arrays(list(g)))
    hg, w = phase1(gbits, last_x, y_rev, vals, g_r, g_omr, f3.to_device(device), dim,
                   not narrow_x)
    return hg, (x, perm_y, last_y, w, narrow_y)


def phase1_init_device(f1_indices, f1_values, f3_evals, g: list[Fr], dim: int,
                       device="cuda"):
    """h_g(x) = sum_y f1(g, x, y) f3(y) by the device init on `device` from
    f1's nonzeros (indices, (16, nnz) Montgomery digits) and f3's (16,
    2^dim) natural-order digits: returns (h_g as a (16, 2^dim) uint32 NumPy
    array in natural lane order, the carry for `phase2_init_device`)."""
    from ..mle import DenseMLE
    from ..protocol.prover import bitrev_perm

    hg, carry = phase1_init_device_arrays(_HostF1(f1_indices, f1_values),
                                          DenseMLE(dim, np.asarray(f3_evals, np.uint32)), g, dim,
                                          device)
    return hg.cpu().numpy().astype(np.uint32)[:, bitrev_perm(dim)], carry


def phase2_init_device(carry, u: list[Fr], dim: int) -> np.ndarray:
    """f1(g, u, .) densified on the carry's device: a (16, 2^dim) uint32
    NumPy array in natural lane order."""
    from ..protocol.prover import bitrev_perm

    x, perm_y, last_y, w, narrow_y = carry
    u_digits = upload(np.stack([L.mont_scalar(p.v)[:, 0] for p in u]), w.device)
    f1gu = phase2_digits(x, perm_y, last_y, w, u_digits, dim, not narrow_y)
    return f1gu.cpu().numpy().astype(np.uint32)[:, bitrev_perm(dim)]
