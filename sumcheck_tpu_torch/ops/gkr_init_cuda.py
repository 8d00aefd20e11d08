"""The GKR phase inits' kernels: the CUDA launch wrappers and their plain
PyTorch versions.

Replaces the JAX package's jitted jnp phase-init programs
(`sumcheck_tpu/ops/gkr_init.py`: `_phase1_pair_body`, `_phase2_pair_body`,
`:472-523`, and the per-size `_compiled_phase1`, `_compiled_prep1`,
`_compiled_final_fold`, `_compiled_phase2_digits`, `_compiled_prep2`,
`:284-312, 595-654`), as `ops/gkr_init.py` composes them. The kernels are in
`csrc/gkr_init.cu`; a phase is one launch on the generic chain:

- `weight_reduce(idx, vals, r, k, last, plan, out, f3=None, y=None,
  to_y=None, slot=None, ranks=1)`: eq's half tables by the challenge rows `r`, the
  weight fold (`_weight_fold`, `:98-135`), the exact segment sum
  (`_segment_reduce_sorted`, `:237-274`) and the pair's other slot in one
  launch. Each entry's weight w = vals * eq_lo[idx & (2^kl - 1)] *
  eq_hi[idx >> kl] ((nnz, 8) entry-major limbs, (nnz,) int32 indices), in
  phase 1 (`f3`, `y`, `to_y`) written to row to_y[j] of the returned carry
  (the weights in y order, (nnz, 8)) and multiplied by f3[:, y]; then
  summed mod p over each segment of the sorted entries, positions
  (last[s-1] + 1) .. last[s] (`last` int32, -1 before the first entry),
  strict into `out`, a (8, nseg) int32 table or a pair `(lo, hi)` of (U,
  8, nseg/2) halves (slot 0), or as the raw int64 limb sums (a rank's
  partial) where `out` is int64: (8, nseg), or (S, 8, nseg/S) rank-major
  over `ranks` = S ranks (`rank_major`). `plan` is `tile_plan`'s schedule
  of the segments (built once per f1 on the host, `upload_plan`): tiles of
  consecutive segments, and chunks of the long ones, which the kernel sums
  into a per-device scratch that the last chunk to arrive finishes and
  zeroes. `slot` = (table, fold) writes slot 1 of the pair `out` from the
  same launch: lo[1] = table[:, :H], hi[1] = table[:, H:], times the final
  fold of `fold` = (flo, fhi, r, fslot) where it is given (as
  `pair_slots`). `r` is (>= k, 16) int32 Montgomery digit rows (the
  chain's challenge rows; row stride free, digits contiguous); the half
  tables are those of `eq_halves_ref`, and k is at most 21 (`in_block`).
- `weight_reduce_batched(insts, k)`: the same for B instances of one shape
  in one launch, grid y = instance (the batched GKR prover's phase init,
  the JAX package's vmapped `_bgkr_phase1` / `_bgkr_phase2`,
  `sumcheck_tpu/batch.py:565-580`): each `Instance` with its own plan,
  entries, challenge rows (any row stride, one for all), f3, carry, pair
  slice and slot, its long segments on scratch rows of its own; the
  instances' operands go in the launch's parameters (`BATCH_CAP` a launch,
  more in `batch_launches`' few launches), with no copy ahead of the
  launch. Plain version `weight_reduce_batched_ref`, the single plain
  version per instance.
- `finish_sums(sums, dst, slot=None)`: summed raw limb sums -> their
  strict values in `dst`, and with `slot` the pair's slot 1 from the same
  launch, as `weight_reduce`'s (a sharded rank's phase init: `reduce_fn`
  in `ops/gkr_init.py`). A rank's weight reduce writes its raw sums
  rank-major, (S, 8, nseg/S) (`ranks` = S), so that rank s's dealt
  segments (`parallel/mesh.deal`: local lane l of each half is global
  pair lane l·S + s) are the contiguous block [s], the block a
  reduce-scatter over the ranks hands rank s, summed: the rank finishes
  that block alone, straight into its dealt pair, its slot 1 from its
  dealt table (the JAX package's `psum_scatter` and shard-local finish in
  `_psum_reduce_mod_p`, `sumcheck_tpu/parallel/gkr.py:50-74`, without its
  all-gather).
- `pair_slots(lo, hi, slots, fold=None, fold_out=None)`: slot u of the
  (U, 8, H) halves for each `(u, table, scale)` of `slots` (at most 2):
  lo[u] = table[:, :H], hi[u] = table[:, H:], times `scale` where it is a
  (16,) int32 digit row or "fold", the final fold l + r (h - l) of
  `fold` = (flo, fhi, r, fslot): lane 0 of slot fslot of a one-lane pair
  ((U, 8, >= 1) views) and a challenge row. A table may be a strided view
  (`parallel/mesh.deal`). With `fold_out`, a (16,) int32 tensor, and no
  slots: only the final fold, as digits. It serves `ops/gkr_init.py`'s
  `prep1`, `final_fold` and `prep2`, the counterparts of the JAX
  package's per-size pieces; no prover path launches it (the per-size
  chain takes the fused phase inits, a sharded rank the dealt finish).

Each wrapper launches its kernel for CUDA tensors, on the current stream,
uploading nothing and waiting for nothing, and adds one to its `.launches`
a launch; it runs its plain version (`*_ref`, the same name) for CPU
tensors and raises for any other device. The plain versions unpack to
16-bit digits (`limbs_torch.unpack_limbs`), compute as `limbs_torch` does,
and pack; `weight_reduce_ref` composes `eq_halves_ref` (eq's two half
tables, which no kernel writes to device memory), `weight_fold_ref`,
the segment sum's plain versions (`limb_sums_ref`, `finish_ref`;
`segment_reduce_ref` is the plain segment sum of the whole-phase plain
versions) and `pair_slots_ref`. The weight reduce, its batched form and
the plain segment sums refuse a table of no entries (`ValueError`, before
any build or launch): f1's split never has none (`ops/gkr_init.
_split_f1_device` splits an f1 with no entries as one zero entry). A
failed build or launch raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..fields import limbs_torch as LT
from ..fields.fr import NINV32, NUM_DIGITS, NUM_LIMBS, P, R, R2, REDUCE_SUBS, WIDE_DIGITS
from . import cuda_build

SOURCE = cuda_build.source("gkr_init")
THREADS = 256  # `csrc/gkr_init.cu`: kThreads, a block of the elementwise kernels
TILE = 512  # kTile: entries and segments of a tile, the weight reduce's block; longer
            # segments are cut into chunks
MAX_SHARED_EQ = 3072  # kMaxSharedEq: half-table lanes staged in shared memory
MAX_PAIR_SLOTS = 2  # kMaxPairSlots

_M32 = 0xFFFFFFFF
_COPY, _SCALE, _FOLD = 0, 1, 2


def _words(v: int) -> list[int]:
    return [(v >> (32 * j)) & _M32 for j in range(NUM_LIMBS)]


# p, -p^-1 mod 2^32, the Montgomery one, R^2 mod p, the reduction's subtractions
_CONSTS = (ctypes.c_uint32 * 26)(*_words(P), NINV32, *_words(R), *_words(R2), REDUCE_SUBS)


def halves(k: int) -> tuple[int, int]:
    """(kl, kh): the variables of eq's low and high half table."""
    return k - k // 2, k // 2


def in_block(k: int) -> bool:
    """Whether `weight_reduce`'s blocks can build eq's half tables over k
    variables in their shared memory (2^kl + 2^kh <= MAX_SHARED_EQ lanes:
    k <= 21). Every f1 meets it (its 3 k index bits are int64), and
    `weight_reduce` refuses a k past it."""
    kl, kh = halves(k)
    return (1 << kl) + (1 << kh) <= MAX_SHARED_EQ


def build():
    """Compile `csrc/gkr_init.cu` unless built already; returns the
    library's path."""
    return cuda_build.build("gkr_init")["gkr_init"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, value in (("sc_gkr_threads", THREADS), ("sc_gkr_tile", TILE),
                        ("sc_gkr_max_shared_eq", MAX_SHARED_EQ)):
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != value:
            raise RuntimeError(f"GKR init kernels and wrapper disagree on {name}")
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.sc_gkr_weight_reduce.argtypes = [
        ptr, i32, ptr, ptr, ptr, ll, i32, i32,  # plan, items, vals, idx, r, kl, kh
        ptr, ll, ptr, ptr, ll, ptr, ptr,  # last, nseg, y, f3, n3, to_y, carry
        ptr, ptr, ptr, i32, ptr, ptr, ll, ll,  # scratch, arrived, sums, ranks, the destination
        ptr, ptr, ptr, ll, ptr, ptr, ll, ptr,  # the slot: src, lo, hi, half, its final fold
        i32, words, ptr,  # device, consts, stream
    ]
    lib.sc_gkr_finish_sums.argtypes = [
        ptr, ll, ll, ptr, ptr, ll, ll,  # sums, their row stride, lanes, the destination
        ptr, ptr, ptr, ptr, ptr, ll, ptr, words, ptr,  # the slot, its final fold, consts, stream
    ]
    lib.sc_gkr_pair_slots.argtypes = [
        ptr, ptr, ll, i32, ctypes.POINTER(i32), ctypes.POINTER(i32),  # lo, hi, half, slots
        ctypes.POINTER(ptr), ctypes.POINTER(ll), ctypes.POINTER(ll), ctypes.POINTER(ptr),
        ptr, ptr, ll, ll, i32, ptr, ptr, words, ptr,  # the fold, fold_out, consts, stream
    ]
    lib.sc_gkr_weight_reduce_batched.argtypes = [
        i32, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(i32), ctypes.POINTER(i32),
        ll, i32, i32, ll, ll,  # r_stride, kl, kh, half, fstride
        ptr, ptr, i32, words, ptr,  # scratch, arrived, device, consts, stream
    ]
    lib.sc_gkr_batch_blocks.argtypes = [i32, i32, i32, i32, i32, i32]
    for name in ("sc_gkr_batch_blocks", "sc_gkr_batch_param_bytes"):
        getattr(lib, name).restype = ctypes.c_int
    for name, value in (("sc_gkr_batch_capacity", BATCH_CAP), ("sc_gkr_batch_fields", _FIELDS)):
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != value:
            raise RuntimeError(f"GKR init kernels and wrapper disagree on {name}")
    for fn in (lib.sc_gkr_weight_reduce, lib.sc_gkr_weight_reduce_batched,
               lib.sc_gkr_finish_sums, lib.sc_gkr_pair_slots):
        fn.restype = ctypes.c_int
    lib.sc_gkr_error_string.argtypes = [ctypes.c_int]
    lib.sc_gkr_error_string.restype = ctypes.c_char_p
    return lib


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no GKR init kernel for device {t.device}")
    return True


def _run(what: str, launch, device) -> None:
    """Call `launch(stream)` on `device`'s current stream; raise on an error."""
    lib = _library()
    with torch.cuda.device(device):
        rc = launch(lib, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"GKR init kernel {what} failed to launch: "
                           f"{lib.sc_gkr_error_string(rc).decode()} ({rc})")


def _limbs(t: torch.Tensor, name: str, width: int | None = None) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != NUM_LIMBS \
            or (width is not None and t.shape[1] != width) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (8, {width or 'n'}) int32 limb table, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _ints(t: torch.Tensor, name: str, n: int) -> None:
    if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _rows(r: torch.Tensor, k: int) -> None:
    if r.dtype != torch.int32 or r.dim() != 2 or r.shape[0] < k or r.shape[1] != NUM_DIGITS \
            or r.stride(1) != 1:
        raise ValueError(f"the challenges must be (>= {k}, 16) int32 digit rows, got "
                         f"{tuple(r.shape)} {r.dtype}")


def _entries(nnz: int) -> None:
    """Refuse a segment sum over no entries, before any build or launch:
    the kernels take at least one (`ops/gkr_init._split_f1_device` splits
    an f1 with no entries as one zero entry)."""
    if nnz == 0:
        raise ValueError("the segment sum takes at least one entry, got none: an f1 with no "
                         "entries splits as one zero entry")


def _same_device(*ts) -> None:
    if len({t.device for t in ts if t is not None}) != 1:
        raise ValueError("the GKR init operands must be on one device")


# ---------------------------------------------------------------------------
# the eq half tables
# ---------------------------------------------------------------------------


def eq_halves_ref(r: torch.Tensor, k: int) -> torch.Tensor:
    """The two half tables of eq(r, .) over k variables that the weight
    reduce's blocks build, (8, 2^kl + 2^kh) int32 limbs with kl = k - k // 2
    and kh = k // 2: lane t < 2^kl holds prod_{i<kl} (bit_i(t) ? r_i : 1 -
    r_i), lane 2^kl + t the product over variables kl..k-1; each half by
    the plain inits' doublings (`gkr_init._eq_table`)."""
    from .gkr_init import _columns, _eq_table

    _rows(r, k)
    kl, kh = halves(k)
    r_pts, omr_pts = _columns(r, k)
    return LT.pack_limbs(torch.cat([_eq_table(r_pts[:kl], omr_pts[:kl], kl),
                                    _eq_table(r_pts[kl:], omr_pts[kl:], kh)], dim=1))



# ---------------------------------------------------------------------------
# the plan of the fused kernel's tiles
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """`tile_plan`'s items on a device, (n, 4) int32, and the count of its
    long segments (the scratch rows a launch uses)."""

    items: torch.Tensor
    long: int


def tile_plan(last: np.ndarray, nnz: int, tile: int = TILE) -> tuple[np.ndarray, int]:
    """The fused kernel's work over segments of sorted entries (`last`, each
    segment's last position, -1 before the first entry): (items, long), items
    an (n, 4) int32 array of {s0, count, e0, e1}. A tile (count > 0) is the
    most consecutive segments from s0 whose entries, exactly e0 .. e1 - 1,
    fit `tile`, and at most `tile` segments; a segment of more than `tile`
    entries is long, cut into chunks of `tile` entries (the last shorter),
    each an item {s0, -1 - row, e0, e1} with the segment's scratch row.
    Built on the host from the sort alone, once for each f1 (one step a
    tile)."""
    last = np.asarray(last, dtype=np.int64)
    nseg = len(last)
    bounds = np.empty(nseg + 1, np.int64)  # bounds[s]: segment s's first position
    bounds[0], bounds[1:] = 0, last + 1
    if bounds[-1] != nnz:
        raise ValueError(f"the segments end at {bounds[-1]}, not at the {nnz} entries")
    items, long, s = [], 0, 0
    while s < nseg:
        e0 = int(bounds[s])
        if bounds[s + 1] - e0 > tile:
            end = int(bounds[s + 1])
            items += [(s, -1 - long, c, min(c + tile, end)) for c in range(e0, end, tile)]
            long, s = long + 1, s + 1
            continue
        s1 = min(int(np.searchsorted(bounds, e0 + tile, side="right")) - 1, s + tile, nseg)
        items.append((s, s1 - s, e0, int(bounds[s1])))
        s = s1
    return np.array(items, dtype=np.int32).reshape(-1, 4), long


def upload_plan(last: np.ndarray, nnz: int, device) -> Plan:
    """`tile_plan` on `device`."""
    items, long = tile_plan(last, nnz)
    return Plan(torch.from_numpy(items).to(device), long)


# ---------------------------------------------------------------------------
# the weight fold and the segment sum: plain versions
# ---------------------------------------------------------------------------


def _check_fold(idx, vals, eq, k, y, f3) -> int:
    nnz = vals.shape[1] if vals.dim() == 2 else -1
    _limbs(vals, "vals")
    _ints(idx, "idx", nnz)
    kl, kh = halves(k)
    _limbs(eq, "eq", (1 << kl) + (1 << kh))
    if (y is None) != (f3 is None):
        raise ValueError("the f3 gather needs both y and f3")
    if y is not None:
        _ints(y, "y", nnz)
        _limbs(f3, "f3")
    _same_device(idx, vals, eq, y, f3)
    return nnz


def weight_fold_ref(idx, vals, eq, k: int, y=None, f3=None):
    """The weight fold (`_weight_fold`, `sumcheck_tpu/ops/gkr_init.py:98`)
    over (8, nnz) limbs: two gathers of the unpacked half tables and two
    multiplies, and with `y` the f3 gather and a third. Returns (w, wv or
    None), (8, nnz) int32 tables."""
    _check_fold(idx, vals, eq, k, y, f3)
    kl, _kh = halves(k)
    nlo = 1 << kl
    e = LT.unpack_limbs(eq)
    w = LT.mont_mul(LT.unpack_limbs(vals), e[:, :nlo].index_select(1, idx & (nlo - 1)))
    w = LT.mont_mul(w, e[:, nlo:].index_select(1, idx >> kl))
    if y is None:
        return LT.pack_limbs(w), None
    wv = LT.mont_mul(w, LT.unpack_limbs(f3.index_select(1, y)))
    return LT.pack_limbs(w), LT.pack_limbs(wv)


def _dest(dst, nseg: int):
    """(lo, hi, ld, split) of a (8, nseg) table or of slot 0 of a pair."""
    if isinstance(dst, torch.Tensor):
        _limbs(dst, "dst", nseg)
        return dst, dst, nseg, nseg
    lo, hi = dst
    half = nseg // 2
    for t in (lo, hi):
        if t.dtype != torch.int32 or t.dim() != 3 or tuple(t.shape[1:]) != (NUM_LIMBS, half) \
                or 2 * half != nseg or not t.is_contiguous():
            raise ValueError(f"pair halves for {nseg} segments must be contiguous (U, 8, "
                             f"{half}) int32, got {tuple(t.shape)} {t.dtype}")
    return lo[0], hi[0], half, half


def limb_sums_ref(vals, perm, last) -> torch.Tensor:
    """The raw (8, nseg) int64 limb sums of each segment of (8, nnz) limbs
    (plain): a cumulative sum along the sorted entries, differenced at each
    segment's last position. Exact: each limb is below 2^32 and a segment
    holds at most 2^24 entries. Refuses nnz = 0 (`_entries`)."""
    _entries(vals.shape[1])
    v = vals.long() & _M32
    if perm is not None:
        v = v.index_select(1, perm)
    csum = torch.cumsum(v, dim=1)
    at_last = csum.index_select(1, last.clamp(min=0))
    at_last = torch.where(last[None, :] >= 0, at_last, 0)
    prev = torch.cat([torch.zeros_like(at_last[:, :1]), at_last[:, :-1]], dim=1)
    return at_last - prev


def finish_ref(sums: torch.Tensor) -> torch.Tensor:
    """(8, nseg) limb sums -> (8, nseg) strict limbs mod p (plain): a carry
    pass into 8 limbs and a word above them, then `limbs_torch.reduce_wide`
    over their digits."""
    limbs, carry = [], torch.zeros_like(sums[0])
    for j in range(NUM_LIMBS):
        t = sums[j] + carry
        limbs.append(t & _M32)
        carry = t >> 32
    digits = [d for x in limbs + [carry] for d in (x & 0xFFFF, x >> 16)]
    digits += [torch.zeros_like(carry)] * (WIDE_DIGITS - len(digits))
    return LT.pack_limbs(LT.reduce_wide(torch.stack(digits)))


def _write(dst, table: torch.Tensor) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(table)
        return
    half = table.shape[1] // 2
    dst[0][0].copy_(table[:, :half])
    dst[1][0].copy_(table[:, half:])


def segment_reduce_ref(vals, perm, last, dst) -> None:
    """The exact segment sum (`_segment_reduce_sorted`,
    `sumcheck_tpu/ops/gkr_init.py:237`) of (8, nnz) limbs, entry `perm[q]`
    at sorted position q (`perm` None: q), written strict into `dst`."""
    _limbs(vals, "vals")
    nseg = last.shape[0]
    _ints(last, "last", nseg)
    if perm is not None:
        _ints(perm, "perm", vals.shape[1])
    _write(dst, finish_ref(limb_sums_ref(vals, perm, last)))


# ---------------------------------------------------------------------------
# the fused weight fold and segment sum
# ---------------------------------------------------------------------------


def _rows_table(t: torch.Tensor, name: str, n: int) -> None:
    if t.dtype != torch.int32 or t.shape != (n, NUM_LIMBS) or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned ({n}, 8) int32 "
                         f"entry-major table, got {tuple(t.shape)} {t.dtype}")


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The bytes [start, end) that a view of `t` can touch."""
    start = t.data_ptr()
    reach = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return start, start + (reach + 1) * t.element_size()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def _check_slot(slot, out, nseg: int):
    """`slot` = (table, fold) checked against the destination `out`: a
    pair of at least two slots, a contiguous (8, nseg) table for slot 1,
    and a final fold whose one-lane pair lies outside the pair (the
    launch's blocks read it while others write the pair)."""
    if isinstance(out, torch.Tensor):
        raise ValueError("the pair's other slot needs a pair (lo, hi) as the destination")
    lo, hi = out
    if lo.shape[0] < 2:
        raise ValueError(f"slot 1 of a {lo.shape[0]}-slot pair")
    table, fold = slot
    _limbs(table, "the slot's table", nseg)
    if fold is not None:
        _check_fold_pair(fold)
        if any(_overlaps(d, f) for d in (lo, hi) for f in fold[:2]):
            raise ValueError("the destination pair overlaps the pair the final fold reads")
    return table, fold


def _check_reduce(idx, vals, r, k, last, plan, out, f3, y, to_y, slot, ranks=1):
    """(nnz, nseg, destination or None, raw sums or None)."""
    if not in_block(k):
        raise ValueError(f"the weight reduce builds eq's half tables in shared memory up to "
                         f"k = 21 variables, not {k}")
    nnz = vals.shape[0] if vals.dim() == 2 else -1
    _rows_table(vals, "vals", nnz)
    _entries(nnz)
    _ints(idx, "idx", nnz)
    _rows(r, k)
    nseg = last.shape[0] if last.dim() == 1 else -1
    _ints(last, "last", nseg)
    items = plan.items
    if items.dtype != torch.int32 or items.dim() != 2 or items.shape[1] != 4 \
            or not items.is_contiguous() or len(items) < 1:
        raise ValueError("the plan's items must be a contiguous (n >= 1, 4) int32 tensor")
    if (y is None) != (f3 is None) or (y is None) != (to_y is None):
        raise ValueError("phase 1's f3 gather and carry need y, f3 and to_y")
    if y is not None:
        _ints(y, "y", nnz)
        _ints(to_y, "to_y", nnz)
        _limbs(f3, "f3")
    raw = out if isinstance(out, torch.Tensor) and out.dtype == torch.int64 else None
    if ranks != 1 and (raw is None or ranks < 1 or nseg % ranks):
        raise ValueError(f"rank-major raw sums over {ranks} ranks need raw sums of a "
                         f"multiple of {ranks} segments")
    if raw is not None:
        shapes = {(ranks, NUM_LIMBS, nseg // ranks)} | ({(NUM_LIMBS, nseg)} if ranks == 1
                                                          else set())
        if tuple(raw.shape) not in shapes or not raw.is_contiguous():
            raise ValueError(f"the raw sums must be a contiguous int64 tensor of shape "
                             f"{' or '.join(map(str, sorted(shapes)))}, got {tuple(raw.shape)}")
        dst = None
    else:
        dst = _dest(out, nseg)
    slot_ts = []
    if slot is not None:
        table, fold = _check_slot(slot, out, nseg)
        slot_ts = [table] + ([] if fold is None else list(fold[:3]))
    _same_device(idx, vals, r, last, items, f3, y, to_y, raw,
                 *(() if dst is None else dst[:2]), *slot_ts)
    return nnz, nseg, dst, raw


def rank_major(sums: torch.Tensor, ranks: int) -> torch.Tensor:
    """(8, nseg) sums by segment -> (S, 8, nseg/S) rank-major over `ranks`
    = S ranks: segment i·S + s (rank s's dealt lane i, `parallel/mesh.deal`)
    at [s, :, i], so that rank s's segments are the contiguous block [s],
    in its lanes' order."""
    rows, nseg = sums.shape
    return sums.reshape(rows, nseg // ranks, ranks).permute(2, 0, 1).contiguous()


def weight_reduce_ref(idx, vals, r, k: int, last, plan: Plan, out, f3=None, y=None,
                      to_y=None, slot=None, ranks=1):
    """Plain version of `weight_reduce`: the half tables, the weight fold,
    the segment sum and the pair slot's plain versions composed on the
    entry-major layout (the plan unused: it only schedules the kernel)."""
    nnz, _nseg, _dst, raw = _check_reduce(idx, vals, r, k, last, plan, out, f3, y, to_y, slot,
                                          ranks)
    w, wv = weight_fold_ref(idx, vals.T.contiguous(), eq_halves_ref(r, k), k, y, f3)
    sums = limb_sums_ref(w if wv is None else wv, None, last)
    if raw is not None:
        raw.copy_(rank_major(sums, ranks).reshape(raw.shape))
    else:
        _write(out, finish_ref(sums))
    if slot is not None:
        table, fold = slot
        pair_slots_ref(*out, ((1, table, None if fold is None else "fold"),), fold=fold)
    if to_y is None:
        return None
    carry = torch.empty((nnz, NUM_LIMBS), dtype=torch.int32, device=vals.device)
    carry[to_y.long()] = w.T
    return carry


_SCRATCH: dict = {}  # device -> the long segments' (rows, 8) sums and (rows,) counters


def _scratch(device: torch.device, rows: int):
    """The long segments' scratch on `device`, zero and kept zero by the
    kernel: at least `rows` rows, grown (fresh zeros) when a plan needs more.
    Launches on one device's streams run in order (the port launches on the
    current stream), so they share it."""
    have = _SCRATCH.get(device)
    if have is None or have[0].shape[0] < rows:
        have = (torch.zeros((max(rows, 1), NUM_LIMBS), dtype=torch.int64, device=device),
                torch.zeros(max(rows, 1), dtype=torch.int32, device=device))
        _SCRATCH[device] = have
    return have


def weight_reduce(idx, vals, r, k: int, last, plan: Plan, out, f3=None, y=None, to_y=None,
                  slot=None, ranks=1):
    """eq's half tables by the challenge rows `r`, the weight fold by them
    and the exact segment sum of the sorted entries, one launch: (nnz, 8)
    `vals` times eq_lo[idx & m] * eq_hi[idx >> kl], summed over each
    segment (`last`) mod p into `out`, a (8, nseg) int32 table or a pair
    (slot 0), or as the raw int64 limb sums where `out` is int64 (a rank's
    partial; `finish_sums` finishes them): (8, nseg), or (S, 8, nseg/S)
    rank-major over `ranks` = S ranks (`rank_major`: each rank's dealt
    segments one contiguous block, the block a reduce-scatter hands it and
    the run it finishes). Phase 1 passes `f3`,
    `y` and `to_y`: each weight is multiplied by f3[:, y] before the sum,
    and the weights are returned as the carry, (nnz, 8) int32 with entry j
    at row to_y[j]; else returns None. `slot` = (table, fold) also writes
    slot 1 of the pair `out` from the same launch: table's two halves,
    times the final fold of `fold` = (flo, fhi, r, fslot) unless it is
    None (`pair_slots`' "fold" scale; the fold's pair must not overlap
    `out`). `plan` is `tile_plan`'s over the same `last` (its bounds are not
    checked on the card: that would cost a sync). Every block builds the
    half tables in its shared memory, so k is at most 21 (`in_block`); a
    larger k raises."""
    if not _on_card(vals):
        return weight_reduce_ref(idx, vals, r, k, last, plan, out, f3, y, to_y, slot, ranks)
    _nnz, _nseg, dst, raw = _check_reduce(idx, vals, r, k, last, plan, out, f3, y, to_y, slot,
                                          ranks)
    carry = _launch_reduce(idx, vals, r, k, last, plan, out, dst, raw, f3, y, to_y, slot, ranks)
    weight_reduce.launches += 1
    return carry


def _launch_reduce(idx, vals, r, k, last, plan, out, dst, raw, f3, y, to_y, slot, ranks):
    """The weight reduce's launch over checked operands; returns the carry
    or None."""
    kl, kh = halves(k)
    carry = None if to_y is None else torch.empty_like(vals)
    scratch, arrived = _scratch(vals.device, plan.long) if plan.long else (None, None)
    lo, hi, ld, split = dst if dst is not None else (None, None, 0, 0)
    table, fold = slot if slot is not None else (None, None)
    flo, fhi, fr, fslot = fold if fold is not None else (None, None, None, 0)
    _run("weight_reduce", lambda lib, s: lib.sc_gkr_weight_reduce(
        plan.items.data_ptr(), len(plan.items), vals.data_ptr(), idx.data_ptr(), r.data_ptr(),
        r.stride(0), kl, kh, last.data_ptr(), last.shape[0], _ptr(y), _ptr(f3),
        0 if f3 is None else f3.shape[1], _ptr(to_y), _ptr(carry), _ptr(scratch), _ptr(arrived),
        _ptr(raw), ranks, _ptr(lo), _ptr(hi), ld, split, _ptr(table),
        None if slot is None else out[0][1].data_ptr(),
        None if slot is None else out[1][1].data_ptr(), 0 if slot is None else ld,
        None if flo is None else flo[fslot].data_ptr(),
        None if fhi is None else fhi[fslot].data_ptr(), 0 if flo is None else flo.stride(1),
        _ptr(fr), vals.device.index, _CONSTS, s), vals.device)
    return carry


class Instance(NamedTuple):
    """One instance's operands of `weight_reduce_batched`: the arguments of
    `weight_reduce` but k, which the instances share."""

    idx: torch.Tensor
    vals: torch.Tensor
    r: torch.Tensor
    last: torch.Tensor
    plan: Plan
    out: tuple
    f3: torch.Tensor | None = None
    y: torch.Tensor | None = None
    to_y: torch.Tensor | None = None
    slot: tuple | None = None


_FIELDS = 15  # `csrc/gkr_init.cu`: kBatchFields, an instance's pointers in a batched launch
BATCH_CAP = 254  # kBatchCap: the instances one batched launch's parameters hold


def batch_launches(n: int, cap: int = BATCH_CAP) -> list[range]:
    """The batched weight reduce's launches over n instances: the fewest
    that hold them, ceil(n / cap), each a run of consecutive instances,
    their sizes differing by at most one."""
    count = -(-n // cap)
    return [range(i * n // count, (i + 1) * n // count) for i in range(count)]


def batch_blocks(resident: int, batch: int, top: int) -> int:
    """Blocks an instance of a batched launch of `batch` instances whose
    most items is `top` (`sc_gkr_weight_reduce_batched`): the `resident`
    blocks that fit on the card at once, shared evenly, and no more than
    the most items. Block x of an instance walks its items x, x + blocks,
    ... and `slot_span(half, blocks, x)` of its slot's lanes."""
    return min(-(-resident // batch), top)


def slot_span(half: int, blocks: int, x: int) -> tuple[int, int]:
    """The slot lanes [begin, end) that block x of an instance's `blocks`
    moves (`weight_reduce_batched_kernel`): ceil(half / blocks) a block."""
    chunk = -(-half // blocks)
    begin = min(x * chunk, half)
    return begin, min(begin + chunk, half)


def f3_rows(f3: torch.Tensor) -> torch.Tensor:
    """f3's (n3, 8) entry-major copy, the batched kernel's gather layout
    (one 32-byte row an entry where the (8, n3) table spreads a lane over
    8 sectors): made once a table, by a transpose on its device, and kept
    on the table's tensor; made again if the table was written since."""
    have = getattr(f3, "_entry_rows", None)
    if have is None or have[0] != f3._version:
        have = (f3._version, f3.T.contiguous())
        f3._entry_rows = have
    return have[1]


def batch_launch_shape(insts, k: int) -> list[tuple[int, int]]:
    """(parameter bytes, blocks an instance) of each launch that
    `weight_reduce_batched` makes for `insts` on their card."""
    lib, device = _library(), insts[0].vals.device
    kl, kh = halves(k)
    out = []
    for run in batch_launches(len(insts)):
        top = max(len(insts[b].plan.items) for b in run)
        with torch.cuda.device(device):
            blocks = lib.sc_gkr_batch_blocks(len(run), insts[0].y is not None, kl, kh, top,
                                             device.index)
        if blocks < 0:
            raise RuntimeError(f"GKR init kernel weight_reduce_batched: "
                               f"{lib.sc_gkr_error_string(-blocks).decode()}")
        out.append((lib.sc_gkr_batch_param_bytes(len(run)), blocks))
    return out


def weight_reduce_batched_ref(insts, k: int) -> list:
    """Plain version of `weight_reduce_batched`: `weight_reduce_ref` per
    instance."""
    return [weight_reduce_ref(i.idx, i.vals, i.r, k, i.last, i.plan, i.out, i.f3, i.y, i.to_y,
                              i.slot) for i in insts]


def weight_reduce_batched(insts, k: int) -> list:
    """`weight_reduce` of B instances, grid y = instance (the batched GKR
    prover's phase init): each `Instance` with its own tile plan, entries,
    challenge rows, f3, carry, destination pair `out` and slot, its long
    segments on its own scratch rows. The instances share k and the shapes
    a launch takes once: the segment count, f3's width, the challenge
    rows' stride, the destination pair's half width and the final fold's
    stride; all gather (phase 1) or none, all have a slot or none, and a
    final fold or none; every `out` is a pair (slot 0; no raw sums). The
    instances go in the launch's parameters, BATCH_CAP a launch: one launch
    for up to BATCH_CAP instances, else `batch_launches`' (each counted).
    Returns each instance's carry (phase 1) or None."""
    if not _on_card(insts[0].vals):
        return weight_reduce_batched_ref(insts, k)
    shared, carries, long = None, [], 0
    for i in insts:
        _nnz, nseg, dst, raw = _check_reduce(i.idx, i.vals, i.r, k, i.last, i.plan, i.out,
                                             i.f3, i.y, i.to_y, i.slot)
        if raw is not None or isinstance(i.out, torch.Tensor):
            raise ValueError("a batched weight reduce writes each instance's pair")
        fold = i.slot[1] if i.slot is not None else None
        key = (nseg, i.r.stride(0), None if i.f3 is None else i.f3.shape[1], dst[2],
               i.slot is None, None if fold is None else fold[0].stride(1), i.vals.device)
        if shared not in (None, key):
            raise ValueError("the instances of a batched weight reduce differ in shape, "
                             "phase, slot or device")
        shared = key
        carries.append(None if i.to_y is None else torch.empty_like(i.vals))
    _nseg, r_stride, _n3, half, _no_slot, fstride, device = shared
    ptrs, items, rows = [], [], []
    for i, carry in zip(insts, carries):
        src, fold = i.slot if i.slot is not None else (None, None)
        flo, fhi, fr, fslot = fold if fold is not None else (None, None, None, 0)
        rows3 = None if i.f3 is None else f3_rows(i.f3)
        ptrs += [_ptr(t) for t in (i.plan.items, i.vals, i.idx, i.r, i.last, i.y, rows3, i.to_y,
                                   carry, i.out[0], i.out[1], src)]
        ptrs += [_ptr(flo[fslot]) if flo is not None else 0,
                 _ptr(fhi[fslot]) if fhi is not None else 0, _ptr(fr)]
        items.append(len(i.plan.items))
        rows.append(long)
        long += i.plan.long
    scratch, arrived = _scratch(device, long) if long else (None, None)
    kl, kh = halves(k)
    for run in batch_launches(len(insts)):
        b0, n = run.start, len(run)
        fields = (ctypes.c_ulonglong * (n * _FIELDS))(*ptrs[b0 * _FIELDS:run.stop * _FIELDS])
        _run("weight_reduce_batched", lambda lib, s: lib.sc_gkr_weight_reduce_batched(
            n, fields, (ctypes.c_int * n)(*items[b0:run.stop]),
            (ctypes.c_int * n)(*rows[b0:run.stop]), r_stride, kl, kh, half, fstride or 0,
            _ptr(scratch), _ptr(arrived), device.index, _CONSTS, s), device)
        weight_reduce_batched.launches += 1
    return carries


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_finish(sums, dst, slot):
    """The destination's (lo, hi, ld, split) of checked operands."""
    if sums.dtype != torch.int64 or sums.dim() != 2 or sums.shape[0] != NUM_LIMBS \
            or sums.stride(1) != 1:
        raise ValueError(f"the sums must be (8, n) int64 with contiguous rows, got "
                         f"{tuple(sums.shape)} {sums.dtype}")
    n = sums.shape[1]
    dest = _dest(dst, n)
    slot_ts = []
    if slot is not None:
        table, fold = _check_slot(slot, dst, n)
        slot_ts = [table] + ([] if fold is None else list(fold[:3]))
    _same_device(sums, *dest[:2], *slot_ts)
    return dest


def finish_sums_ref(sums, dst, slot=None) -> None:
    """Plain version of `finish_sums`."""
    _check_finish(sums, dst, slot)
    _write(dst, finish_ref(sums))
    if slot is not None:
        table, fold = slot
        pair_slots_ref(*dst, ((1, table, None if fold is None else "fold"),), fold=fold)


def finish_sums(sums, dst, slot=None) -> None:
    """Summed raw (8, n) int64 limb sums (rows contiguous, any row
    stride) -> their strict values in `dst` (a table or slot 0 of a pair),
    one launch. `slot` = (table, fold) also writes slot 1 of the pair `dst`
    from the same launch: the contiguous (8, n) table's two halves, times
    the final fold of `fold` = (flo, fhi, r, fslot) unless it is None (as
    `weight_reduce`'s slot; the fold's pair must not overlap `dst`). A
    sharded rank passes its reduce-scattered block of the rank-major sums
    (`weight_reduce(..., ranks=)`) and its dealt table
    (`DenseMLE.to_device(device, shard)`), so that it finishes only its
    own lanes straight into its dealt pair."""
    lo, hi, ld, split = _check_finish(sums, dst, slot)
    if not _on_card(sums):
        return finish_sums_ref(sums, dst, slot)
    table, fold = slot if slot is not None else (None, None)
    flo, fhi, fr, fslot = fold if fold is not None else (None, None, None, 0)
    _run("finish_sums", lambda lib, st: lib.sc_gkr_finish_sums(
        sums.data_ptr(), sums.stride(0), sums.shape[1], lo.data_ptr(), hi.data_ptr(), ld, split,
        _ptr(table), None if slot is None else dst[0][1].data_ptr(),
        None if slot is None else dst[1][1].data_ptr(),
        None if flo is None else flo[fslot].data_ptr(),
        None if fhi is None else fhi[fslot].data_ptr(), 0 if flo is None else flo.stride(1),
        _ptr(fr), _CONSTS, st), sums.device)
    finish_sums.launches += 1


# ---------------------------------------------------------------------------
# the pair's slots
# ---------------------------------------------------------------------------


def _check_fold_pair(fold) -> None:
    flo, fhi, r, fslot = fold
    if flo.dtype != torch.int32 or flo.dim() != 3 or flo.shape[1] != NUM_LIMBS \
            or flo.shape[2] < 1 or flo.shape != fhi.shape or flo.stride() != fhi.stride() \
            or not 0 <= fslot < flo.shape[0]:
        raise ValueError("the final fold takes a (U, 8, >= 1) int32 pair and a slot of it")
    if r.dtype != torch.int32 or r.shape != (NUM_DIGITS,) or r.stride(0) != 1:
        raise ValueError("the final fold's challenge must be a (16,) int32 digit row")


def _check_pair(lo, hi, slots, fold, fold_out) -> int:
    if fold_out is not None:
        if slots or fold is None:
            raise ValueError("fold_out takes the fold and no slots")
        if fold_out.dtype != torch.int32 or fold_out.shape != (NUM_DIGITS,) \
                or not fold_out.is_contiguous():
            raise ValueError("fold_out must be a contiguous (16,) int32 tensor")
    elif not 1 <= len(slots) <= MAX_PAIR_SLOTS:
        raise ValueError(f"{len(slots)} slots (1 to {MAX_PAIR_SLOTS} a launch)")
    half = 0
    if slots:
        if lo.dtype != torch.int32 or lo.shape != hi.shape or lo.dim() != 3 \
                or lo.shape[1] != NUM_LIMBS or not (lo.is_contiguous() and hi.is_contiguous()):
            raise ValueError(f"pair halves must be contiguous (U, 8, H) int32, got "
                             f"{tuple(lo.shape)} and {tuple(hi.shape)}")
        half = lo.shape[2]
    for u, table, scale in slots:
        if not 0 <= u < lo.shape[0]:
            raise ValueError(f"slot {u} of a {lo.shape[0]}-slot pair")
        if table.dtype != torch.int32 or tuple(table.shape) != (NUM_LIMBS, 2 * half):
            raise ValueError(f"slot {u}'s table must be (8, {2 * half}) int32, got "
                             f"{tuple(table.shape)} {table.dtype}")
        if isinstance(scale, str):
            if scale != "fold" or fold is None:
                raise ValueError("a slot scaled by the final fold needs `fold`")
        elif scale is not None and (scale.dtype != torch.int32 or scale.shape != (NUM_DIGITS,)
                                    or not scale.is_contiguous()):
            raise ValueError("a slot's scale must be a contiguous (16,) int32 digit row")
    if fold is not None:
        _check_fold_pair(fold)
    ts = [lo, hi, fold_out] + [t for _u, t, _s in slots] \
        + [s for _u, _t, s in slots if isinstance(s, torch.Tensor)] \
        + (list(fold[:3]) if fold is not None else [])
    _same_device(*ts)
    return half


def final_fold_ref(flo, fhi, r, fslot: int) -> torch.Tensor:
    """l + r (h - l) of lane 0 of slot `fslot` of a one-lane pair, as (16,)
    int64 digits (plain)."""
    l, h = LT.unpack_limbs(flo[fslot, :, 0]), LT.unpack_limbs(fhi[fslot, :, 0])
    return LT.add(l, LT.mont_mul(LT.sub(h, l), r.long()))


def pair_slots_ref(lo, hi, slots, fold=None, fold_out=None) -> None:
    """Plain version of `pair_slots`."""
    half = _check_pair(lo, hi, slots, fold, fold_out)
    c = None if fold is None else final_fold_ref(*fold)
    if fold_out is not None:
        fold_out.copy_(c)
        return
    for u, table, scale in slots:
        if scale is not None:
            s = c if isinstance(scale, str) else scale.long()
            table = LT.pack_limbs(LT.mont_mul(LT.unpack_limbs(table), s[:, None]))
        lo[u] = table[:, :half]
        hi[u] = table[:, half:]


def pair_slots(lo, hi, slots, fold=None, fold_out=None) -> None:
    """Write the pair's `slots`, or the final fold into `fold_out`, in one
    launch."""
    if not _on_card(fold_out if fold_out is not None else lo):
        return pair_slots_ref(lo, hi, slots, fold, fold_out)
    half = _check_pair(lo, hi, slots, fold, fold_out)
    n = len(slots)
    ptrs = ctypes.c_void_p * MAX_PAIR_SLOTS
    lls = ctypes.c_longlong * MAX_PAIR_SLOTS
    ints = ctypes.c_int * MAX_PAIR_SLOTS
    slot = ints(*[u for u, _t, _s in slots])
    mode = ints(*[_COPY if s is None else _FOLD if isinstance(s, str) else _SCALE
                  for _u, _t, s in slots])
    src = ptrs(*[t.data_ptr() for _u, t, _s in slots])
    ld = lls(*[t.stride(0) for _u, t, _s in slots])
    step = lls(*[t.stride(1) for _u, t, _s in slots])
    scale = ptrs(*[s.data_ptr() if isinstance(s, torch.Tensor) else None for _u, _t, s in slots])
    flo, fhi, r, fslot = fold if fold is not None else (None, None, None, 0)
    device = (fold_out if fold_out is not None else lo).device
    _run("pair_slots", lambda lib, s: lib.sc_gkr_pair_slots(
        None if lo is None else lo.data_ptr(), None if hi is None else hi.data_ptr(), half, n,
        slot, mode, src, ld, step, scale, None if flo is None else flo.data_ptr(),
        None if fhi is None else fhi.data_ptr(), 0 if flo is None else flo.stride(0),
        0 if flo is None else flo.stride(1), fslot, None if r is None else r.data_ptr(),
        None if fold_out is None else fold_out.data_ptr(), _CONSTS, s), device)
    pair_slots.launches += 1


weight_reduce.launches = 0
weight_reduce_batched.launches = 0
finish_sums.launches = 0
pair_slots.launches = 0
