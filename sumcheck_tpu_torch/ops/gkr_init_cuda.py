"""The GKR phase inits' kernels: the CUDA launch wrappers and their plain
PyTorch versions.

Replaces the JAX package's jitted jnp phase-init programs
(`sumcheck_tpu/ops/gkr_init.py`: `_phase1_pair_body`, `_phase2_pair_body`,
`:472-523`, and the per-size `_compiled_phase1`, `_compiled_prep1`,
`_compiled_final_fold`, `_compiled_phase2_digits`, `_compiled_prep2`,
`:284-312, 595-654`), as `ops/gkr_init.py` composes them. The kernels are in
`csrc/gkr_init.cu`; a phase is four launches:

- `eq_halves(r, k)`: the two half tables of eq(r, .) over k variables,
  (8, 2^kl + 2^kh) int32 limbs with kl = k - k // 2 and kh = k // 2:
  lane t < 2^kl holds prod_{i<kl} (bit_i(t) ? r_i : 1 - r_i), lane 2^kl + t
  the product over variables kl..k-1. `r` is (>= k, 16) int32 Montgomery
  digit rows (the chain's challenge rows; row stride free, digits
  contiguous).
- `weight_fold(idx, vals, eq, k, y=None, f3=None)`: w = vals *
  eq_lo[idx & (2^kl - 1)] * eq_hi[idx >> kl] over f1's entries ((8, nnz)
  limbs, (nnz,) int32 indices), and with `y`, `f3` also wv = w * f3[:, y];
  returns (w, wv or None), fresh (8, nnz) int32 tables.
- `segment_reduce(vals, perm, last, dst, reduce_fn=None)`: the exact sum mod
  p of each segment of the sorted entries, written as strict limbs into
  `dst`, a (8, nseg) int32 table or a pair `(lo, hi)` of (U, 8, nseg/2)
  halves (slot 0). Segment s covers sorted positions (last[s-1] + 1) ..
  last[s] (`last` int32, -1 before the first entry), entry `perm[q]` of
  `vals` at sorted position q (`perm` None: q). With `reduce_fn`, the raw
  (8, nseg) int64 limb sums (a rank's partial) go to `reduce_fn`, which
  sums them over the ranks in place, and a second launch finishes them
  into `dst`.
- `pair_slots(lo, hi, slots, fold=None, fold_out=None)`: slot u of the
  (U, 8, H) halves for each `(u, table, scale)` of `slots` (at most 2):
  lo[u] = table[:, :H], hi[u] = table[:, H:], times `scale` where it is a
  (16,) int32 digit row or "fold", the final fold l + r (h - l) of
  `fold` = (flo, fhi, r, fslot): lane 0 of slot fslot of a one-lane pair
  ((U, 8, >= 1) views) and a challenge row. A table may be a strided view
  (`parallel/mesh.deal`). With `fold_out`, a (16,) int32 tensor, and no
  slots: only the final fold, as digits.

Each wrapper launches its kernel for CUDA tensors, on the current stream,
uploading nothing and waiting for nothing, and adds one to its `.launches`
a launch; it runs its plain version (`*_ref`, the same name) for CPU
tensors and raises for any other device. The plain versions unpack to
16-bit digits (`limbs_torch.unpack_limbs`), compute as `limbs_torch` does,
and pack. A failed build or launch raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import limbs_torch as LT
from ..fields.fr import NINV32, NUM_DIGITS, NUM_LIMBS, P, R, R2, REDUCE_SUBS, WIDE_DIGITS
from . import cuda_build

SOURCE = cuda_build.source("gkr_init")
THREADS = 256  # `csrc/gkr_init.cu`: kThreads
LONG_SEGMENT = 64  # kLongSegment: longer segments are summed by a whole block
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


def build():
    """Compile `csrc/gkr_init.cu` unless built already; returns the
    library's path."""
    return cuda_build.build("gkr_init")["gkr_init"]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, value in (("sc_gkr_threads", THREADS), ("sc_gkr_long_segment", LONG_SEGMENT),
                        ("sc_gkr_max_shared_eq", MAX_SHARED_EQ)):
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != value:
            raise RuntimeError(f"GKR init kernels and wrapper disagree on {name}")
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.sc_gkr_eq_halves.argtypes = [ptr, i32, i32, ptr, ll, words, ptr]
    lib.sc_gkr_weight_fold.argtypes = [ptr, ptr, ptr, ptr, ll, ptr, i32, i32, ptr, ptr, ll, i32,
                                       words, ptr]
    lib.sc_gkr_segment_reduce.argtypes = [ptr, ll, ptr, ptr, ptr, ptr, ll, ptr, ptr, ll, ll,
                                          words, ptr]
    lib.sc_gkr_pair_slots.argtypes = [
        ptr, ptr, ll, i32, ctypes.POINTER(i32), ctypes.POINTER(i32),  # lo, hi, half, slots
        ctypes.POINTER(ptr), ctypes.POINTER(ll), ctypes.POINTER(ll), ctypes.POINTER(ptr),
        ptr, ptr, ll, ll, i32, ptr, ptr, words, ptr,  # the fold, fold_out, consts, stream
    ]
    for fn in (lib.sc_gkr_eq_halves, lib.sc_gkr_weight_fold, lib.sc_gkr_segment_reduce,
               lib.sc_gkr_pair_slots):
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


def _same_device(*ts) -> None:
    if len({t.device for t in ts if t is not None}) != 1:
        raise ValueError("the GKR init operands must be on one device")


# ---------------------------------------------------------------------------
# the eq half tables
# ---------------------------------------------------------------------------


def eq_halves_ref(r: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of `eq_halves`: each half by the plain inits'
    doublings (`gkr_init._eq_table`)."""
    from .gkr_init import _columns, _eq_table

    _rows(r, k)
    kl, kh = halves(k)
    r_pts, omr_pts = _columns(r, k)
    return LT.pack_limbs(torch.cat([_eq_table(r_pts[:kl], omr_pts[:kl], kl),
                                    _eq_table(r_pts[kl:], omr_pts[kl:], kh)], dim=1))


def eq_halves(r: torch.Tensor, k: int) -> torch.Tensor:
    """The (8, 2^kl + 2^kh) half tables of eq(r, .) in one launch."""
    if not _on_card(r):
        return eq_halves_ref(r, k)
    _rows(r, k)
    kl, kh = halves(k)
    eq = torch.empty((NUM_LIMBS, (1 << kl) + (1 << kh)), dtype=torch.int32, device=r.device)
    _run("eq_halves", lambda lib, s: lib.sc_gkr_eq_halves(
        eq.data_ptr(), kl, kh, r.data_ptr(), r.stride(0), _CONSTS, s), r.device)
    eq_halves.launches += 1
    return eq


# ---------------------------------------------------------------------------
# the weight fold
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
    """Plain version of `weight_fold`: two gathers of the unpacked half
    tables and two multiplies, and with `y` the f3 gather and a third."""
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


def weight_fold(idx, vals, eq, k: int, y=None, f3=None):
    """(w, wv) over f1's entries in one launch (wv None without `y`)."""
    if not _on_card(vals):
        return weight_fold_ref(idx, vals, eq, k, y, f3)
    nnz = _check_fold(idx, vals, eq, k, y, f3)
    kl, kh = halves(k)
    w = torch.empty_like(vals)
    wv = None if y is None else torch.empty_like(vals)
    _run("weight_fold", lambda lib, s: lib.sc_gkr_weight_fold(
        w.data_ptr(), None if wv is None else wv.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        nnz, eq.data_ptr(), kl, kh, None if y is None else y.data_ptr(),
        None if f3 is None else f3.data_ptr(), 0 if f3 is None else f3.shape[1],
        vals.device.index, _CONSTS, s), vals.device)
    weight_fold.launches += 1
    return w, wv


# ---------------------------------------------------------------------------
# the exact segment reduce
# ---------------------------------------------------------------------------


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


def _check_reduce(vals, perm, last, dst) -> tuple:
    _limbs(vals, "vals")
    nnz, nseg = vals.shape[1], last.shape[0] if last.dim() == 1 else -1
    _ints(last, "last", nseg)
    if perm is not None:
        _ints(perm, "perm", nnz)
    out = _dest(dst, nseg)
    _same_device(vals, perm, last, out[0], out[1])
    return nnz, nseg, out


def limb_sums_ref(vals, perm, last) -> torch.Tensor:
    """The raw (8, nseg) int64 limb sums of each segment (plain): a
    cumulative sum along the sorted entries, differenced at each segment's
    last position. Exact: each limb is below 2^32 and a segment holds at
    most 2^24 entries."""
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


def segment_reduce_ref(vals, perm, last, dst, reduce_fn=None) -> None:
    """Plain version of `segment_reduce`."""
    _check_reduce(vals, perm, last, dst)
    sums = limb_sums_ref(vals, perm, last)
    if reduce_fn is not None:
        reduce_fn(sums)
    _write(dst, finish_ref(sums))


def segment_reduce(vals, perm, last, dst, reduce_fn=None) -> None:
    """The strict segment sums into `dst`: one launch, or with `reduce_fn`
    two (the raw limb sums, then the finish of the summed partials)."""
    if not _on_card(vals):
        return segment_reduce_ref(vals, perm, last, dst, reduce_fn)
    nnz, nseg, (lo, hi, ld, split) = _check_reduce(vals, perm, last, dst)
    perm_p = None if perm is None else perm.data_ptr()
    if reduce_fn is None:
        _run("segment_reduce", lambda lib, s: lib.sc_gkr_segment_reduce(
            vals.data_ptr(), nnz, perm_p, last.data_ptr(), None, None, nseg, lo.data_ptr(),
            hi.data_ptr(), ld, split, _CONSTS, s), vals.device)
        segment_reduce.launches += 1
        return
    sums = torch.empty((NUM_LIMBS, nseg), dtype=torch.int64, device=vals.device)
    _run("segment_reduce (sums)", lambda lib, s: lib.sc_gkr_segment_reduce(
        vals.data_ptr(), nnz, perm_p, last.data_ptr(), None, sums.data_ptr(), nseg, None, None,
        0, 0, _CONSTS, s), vals.device)
    reduce_fn(sums)
    _run("segment_reduce (finish)", lambda lib, s: lib.sc_gkr_segment_reduce(
        None, 0, None, None, sums.data_ptr(), None, nseg, lo.data_ptr(), hi.data_ptr(), ld,
        split, _CONSTS, s), vals.device)
    segment_reduce.launches += 2


# ---------------------------------------------------------------------------
# the pair's slots
# ---------------------------------------------------------------------------


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
        flo, fhi, r, fslot = fold
        if flo.dtype != torch.int32 or flo.dim() != 3 or flo.shape[1] != NUM_LIMBS \
                or flo.shape != fhi.shape or flo.stride() != fhi.stride() \
                or not 0 <= fslot < flo.shape[0]:
            raise ValueError("the final fold takes a (U, 8, >= 1) int32 pair and a slot of it")
        if r.dtype != torch.int32 or r.shape != (NUM_DIGITS,) or r.stride(0) != 1:
            raise ValueError("the final fold's challenge must be a (16,) int32 digit row")
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


eq_halves.launches = 0
weight_fold.launches = 0
segment_reduce.launches = 0
pair_slots.launches = 0
