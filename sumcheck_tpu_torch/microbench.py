"""Per-op costs of the GKR inits' building blocks, and the stage profile of
the chained GKR prove: the port of `tools/microbench.py` and
`tools/gkr_profile.py`.

    python -m sumcheck_tpu_torch.microbench [nv] [--device cuda] [--reps N] [--out PATH]

Probes, each over the port's own op at the GKR dim-nv shape (nnz = 2^nv,
as `bench.py:187-194` draws it; nv 18 by default):

  rtt          one empty kernel and a sync: the floor of a round trip
  compress     one Blake2b compression (`transcript_cuda._compress_probe`,
               64 chained in one launch; the numbers are per compression,
               and on a card `clocks` is the probe's own count)
  challenge    one transcript step at d=2 (`transcript_cuda.transcript_step`:
               feed 3 Fr, draw with rejection)
  gather16     `index_select` of a (16, 2^nv) int64 table at 2^nv random
               indices, as `gkr_init._weight_fold` and `phase1` run it
  cumsum32     the `torch.cumsum` of `gkr_init.segment_sums` over its 32
               split rows
  mont_nnz     one (16, 2^nv) Montgomery multiply as the inits run it
               (`limbs_torch.mont_mul`)
  mont_nnz_eo  the same multiplies by `csrc/field.cuh`'s even/odd multiply
               (`round_cuda._mont_mul_probe(impl="eo")`) on the same lanes
  eq_build     `gkr_init._eq_table` at k = nv
  segreduce    `gkr_init._segment_reduce_sorted` at nnz = 2^nv

Stages: the chained GKR prove (generic chain) of the bench's dim-nv
instance cut at cumulative prefixes, through `gkr_round_sumcheck._upload`
and the pieces of `_enqueue`: `upto_phase1` (the transcript lift and the
phase-1 pair), `upto_rounds_p1` (+ phase 1's dim rounds), `upto_phase2`
(+ the phase-2 pair), `upto_rounds_p2` (+ phase 2's rounds), and
`full_prove` (`GKRRoundSumcheck.prove`, with its one fetch).

Every probe and stage reports `host_ms`, the median warm wall of one call
between two syncs, and on a card also `device_ms` (CUDA events, the stream
held by `torch.cuda._sleep` until every call is enqueued, so the events
time the kernels back to back; `held` says whether the sleep outlasted the
enqueue, and where it did not, as for calls of more launches than CUDA's
launch queue holds, `device_ms` is null; null too for `full_prove`, which
syncs), `launches` and `copies` of
one call and `busy_ms`, the union of their device intervals (one
`torch.profiler` run), and `bound_ms`: bytes at 3.35 TB/s or 32-bit
multiplies at the card's IMAD rate (SMs x 64 x its maximum SM clock),
whichever is larger; for `compress` and `challenge` the dependent-issue
latency of the compressions (`bound_by` "latency"). The gap between
`host_ms` and `device_ms` is what the probes are for. Each probe's output
is checked against the op's plain or NumPy value, and a mismatch raises.

On the CPU (`--device cpu`, what the tests run) the ops run their plain
versions and only `host_ms` is measured; every device number is null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .fields import limbs_np as L
from .fields.fr import NUM_DIGITS, P

PROBES = ("rtt", "compress", "challenge", "gather16", "cumsum32", "mont_nnz", "mont_nnz_eo",
          "eq_build", "segreduce")
STAGES = ("upto_phase1", "upto_rounds_p1", "upto_phase2", "upto_rounds_p2", "full_prove")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
IMAD_PER_SM_CLOCK = 64  # 32-bit IMAD results per SM per clock, compute capability 9.0
COMPRESS_CHAIN = 64  # compressions in one `compress` launch
# the dependent depth of one Blake2b compression (`chip_smoke.py`): 24 G
# levels of 15 dependent 32-bit instructions
COMPRESS_DEPTH = 24 * 15


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_rates(device) -> dict:
    """The card's name and power limit (`nvidia-smi`), its SM count, its
    maximum SM clock and from them its 32-bit IMAD rate."""
    from .utils.sol import card_line

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
         "-i", str(device.index or 0)], capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    return {"card": card_line(device), "sms": sms, "clock_hz": mhz * 1e6,
            "imad_per_s": sms * IMAD_PER_SM_CLOCK * mhz * 1e6}


def dependent_op_ns(device, iters: int = 1 << 15) -> float:
    """The card's dependent-issue latency: a chain of `iters` x 16 dependent
    xor/add instructions on one thread (`transcript_cuda._latency_chain`),
    timed by CUDA events after a warm run."""
    from .ops import transcript_cuda as tc

    out = torch.zeros(1, dtype=torch.int32, device=device)
    tc._latency_chain(out, iters)
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    tc._latency_chain(out, iters)
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) * 1e6 / (16 * iters)


def held_ms(fn, reps: int, hold_s: float, clock_hz: float = 2e9) -> tuple[float, bool]:
    """Mean device time of `fn()` over `reps` calls by CUDA events, the
    stream held by `torch.cuda._sleep` for about `hold_s` seconds (at
    `clock_hz`) so that every call is enqueued before the first runs: the
    events then time the kernels back to back, not the host's enqueue.
    Returns (ms, whether the hold outlasted the enqueue)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(clock_hz * hold_s))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, enqueue_s < hold_s


PROFILE_SETTLE_S = (0.05, 0.2, 0.5)  # the waits of the profiles `profile_events` may take
# empty launches that open each profile: the profiler drops the device
# records of a profile's first few launches
PROFILE_PAD = 64
# the host-side CUDA runtime calls that each put one record on the device
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_events(fn, warm=None) -> dict:
    """One call of `fn` under `torch.profiler`: {"wall_s": its host seconds
    between syncs, "events": one device record (start us, end us, name) for
    each kernel launch, copy and fill it made, in start order}. `warm()`,
    if given, runs first, outside the profile. The profiler drops the
    device records of a profile's first launches (kineto's "Out-of-range"
    count with `KINETO_LOG_LEVEL=0`) in a process that has profiled tens of
    thousands of launches, more of them in one that has spawned ranks on
    the card (`tools/torch_profiler_check.py`). So
    each profile opens with `PROFILE_PAD` empty launches, the call's
    launches, copies and fills are its host-side runtime calls after
    those (`RUNTIME_CALLS`, which the profiler keeps), each device record
    is matched to its call by correlation id, and a profile that lost any
    of the call's records is taken again after a longer wait
    (`PROFILE_SETTLE_S`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for settle in PROFILE_SETTLE_S:
        if warm is not None:
            warm()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = list(prof.events())
        calls = sorted((e.time_range.start, e.id) for e in events
                       if e.device_type != DeviceType.CUDA and e.name in RUNTIME_CALLS)
        ids = {i for _t, i in calls[PROFILE_PAD:]}
        records = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                         if e.device_type == DeviceType.CUDA and e.id in ids)
        if len(records) == len(ids):
            return {"wall_s": wall_s, "events": records}
    raise RuntimeError(f"the profiler kept {len(records)} device records of {len(ids)} launches "
                       f"and copies, in each of {len(PROFILE_SETTLE_S)} profiles")


def is_copy(name: str) -> bool:
    """Whether a device record is a copy or a fill, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def busy_ms(events) -> float:
    """The union of the records' device intervals, in ms."""
    busy_us, reach = 0.0, None
    for start, end, _name in sorted(events):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    return busy_us / 1e3


def measure(fn, device, reps: int, rates: dict | None, syncs: bool = False,
            per_call: int = 1) -> dict:
    """`host_ms` (median of `reps` warm calls between syncs) and, on a card,
    `device_ms` / `held` (not for a function that `syncs`; null where the
    sleep ended before the enqueue: CUDA's launch queue holds about a
    thousand launches, and a call of more blocks the host until the card
    drains it), `launches`, `copies` and `busy_ms`; every number divided by
    `per_call`."""
    fn()
    walls = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        walls.append(time.perf_counter() - t0)
    host_ms = statistics.median(walls) * 1e3
    out = {"host_ms": host_ms / per_call, "device_ms": None, "held": None, "launches": None,
           "copies": None, "busy_ms": None}
    if device.type != "cuda":
        return out
    if not syncs:
        ms, held = held_ms(fn, reps, 0.005 + 2 * reps * host_ms / 1e3, rates["clock_hz"])
        out.update(device_ms=ms / per_call if held else None, held=held)
    events = profile_events(fn)["events"]
    copies = sum(is_copy(name) for _s, _e, name in events)
    out.update(launches=len(events) - copies, copies=copies, busy_ms=busy_ms(events) / per_call)
    return out


def bound(work: dict, rates: dict | None) -> tuple[float | None, str | None]:
    """(bound ms, what sets it) of `work` on the card; (None, None) on the
    CPU. `work` holds `bytes` and `imads`, or a dependent-instruction
    `depth`, with `floored` adding the launch floor (`rates["floor_ms"]`,
    the `rtt` probe's device time)."""
    if rates is None:
        return None, None
    if "depth" in work:
        floor = rates["floor_ms"] if work.get("floored") else 0.0
        return work["depth"] * rates["ns_per_dependent_op"] / 1e6 + floor, "latency"
    mem = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ops = work["imads"] / rates["imad_per_s"] * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def probe_inputs(nv: int, seed: int = 0) -> dict:
    """The probes' inputs as NumPy arrays (the tests hand the same ones to
    the JAX package's ops): two (16, 2^nv) tables `a`, `b`, 2^nv gather
    indices `idx`, the (32, 2^nv) byte rows `rows32`, the eq table's points
    (from `random.Random(3)`, as `tools/microbench.py`), and a sorted
    segment layout (`seg`, `perm`, `last`) of 2^nv entries over 2^nv
    segments, as there."""
    from .fields.fr import Fr
    from .ops.gkr_init import _points_arrays

    n = 1 << nv
    gen = np.random.default_rng(seed)
    a, b = L.random_tables(gen, nv, 2)
    idx = gen.integers(0, n, size=(n,), dtype=np.int64)
    rows32 = gen.integers(0, 256, size=(32, n), dtype=np.int64)
    prnd = random.Random(3)
    points = [prnd.randrange(P) for _ in range(nv)]
    r_pts, omr_pts = _points_arrays([Fr(v) for v in points])
    seg = np.sort(gen.integers(0, n, size=(n,), dtype=np.int64))
    perm = np.argsort(seg, kind="stable")
    last = np.searchsorted(seg[perm], np.arange(n), side="right") - 1
    return {"nv": nv, "a": a, "b": b, "idx": idx, "rows32": rows32, "points": points,
            "r_pts": r_pts, "omr_pts": omr_pts, "seg": seg, "perm": perm, "last": last}


def _limbs(digits: np.ndarray) -> np.ndarray:
    """(16, n) 16-bit digits -> (n, 8) 32-bit limbs, as int32."""
    return np.ascontiguousarray(L.pack_limbs(digits).T)


def _digits(limbs: np.ndarray) -> np.ndarray:
    """(n, 8) int32 limbs -> (16, n) uint32 16-bit digits."""
    return L.unpack_limbs(limbs, axis=1).T


def mont_mul_eo(a_limbs: torch.Tensor, b_limbs: torch.Tensor) -> torch.Tensor:
    """(n, 8) int32 limbs a * b * R^-1 mod p: the even/odd multiply of
    `csrc/field.cuh` for CUDA tensors, `limbs_torch.mont_mul` over the
    digits for CPU tensors."""
    from .fields import limbs_torch as LT
    from .ops import round_cuda

    if a_limbs.device.type != "cpu":
        return round_cuda._mont_mul_probe(a_limbs, b_limbs, 1, "eo")
    a, b = (torch.from_numpy(_digits(x.numpy()).astype(np.int64)) for x in (a_limbs, b_limbs))
    return torch.from_numpy(_limbs(LT.mont_mul(a, b).numpy()))


def _compress_chain(device):
    """`COMPRESS_CHAIN` chained compressions: the probe kernel on a card
    (the final h, then its clocks, in a (9,) int64 tensor), the host's
    Blake2b core (`transcript/blake2b_core.compress`) on the CPU."""
    from .ops import transcript_cuda as tc

    if device.type == "cuda":
        buf = torch.zeros(9, dtype=torch.int64, device=device)

        def kernel():
            tc._compress_probe(buf, COMPRESS_CHAIN)
            return buf
        return kernel
    return lambda: host_compress_chain(COMPRESS_CHAIN)


def host_compress_chain(iters: int) -> list[int]:
    """`transcript_cuda._compress_probe`'s chain by the host's Blake2b core:
    `iters` chained compressions of the block of words 0x0123456789ABCDEF *
    (i + 1) from h = (1, ..., 8), every eighth with the last flag, at t =
    128 k for the k-th; returns the final h."""
    from .transcript.blake2b_core import compress

    blk = b"".join((0x0123456789ABCDEF * (i + 1) % (1 << 64)).to_bytes(8, "little")
                   for i in range(16))
    h = list(range(1, 9))
    for k in range(iters):
        h = compress(h, blk, 128 * k, k % 8 == 7)
    return h


def _challenge_step(device):
    """One d=2 transcript step over a fresh transcript's state: returns (the
    step, the state, sums, msgs and rs it works in place on)."""
    from .ops import transcript_cuda as tc
    from .protocol.device_prover import lift_transcript
    from .transcript.blake2b_rng import Blake2b512Rng

    gen = np.random.default_rng(2)
    sums = torch.from_numpy(gen.integers(0, 1 << 40, size=(3, NUM_DIGITS),
                                         dtype=np.int64)).to(device)
    state = lift_transcript(Blake2b512Rng.setup(), device)
    msgs = torch.zeros((1, NUM_DIGITS, 3), dtype=torch.int32, device=device)
    rs = torch.zeros((1, NUM_DIGITS), dtype=torch.int32, device=device)
    return (lambda: tc.transcript_step(state, sums, msgs, rs, 0)), (state, sums, msgs, rs)


def compressions(blen: int, d1: int, attempts: int) -> tuple[int, int]:
    """(compressions, pending bytes after) of one transcript step from
    `blen` pending bytes, for d+1 = `d1` elements and `attempts` draws of
    4 x next_u64: absorbing compresses a full pending block only when more
    bytes arrive; each next_u64 finalizes a clone (one compression) and
    re-absorbs its 64 bytes."""
    count = 0

    def absorb(words):
        nonlocal blen, count
        for _ in range(words):
            if blen == 128:
                count += 1
                blen = 0
            blen += 8

    absorb(1 + 4 * d1)
    for _ in range(4 * attempts):
        count += 1
        absorb(8)
    return count, blen


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"microbench: {what}")


def probes(nv: int, device, seed: int = 0) -> dict:
    """{name: (fn, check, work)}: `fn()` runs the op once, `check()` runs it
    on fresh inputs and raises unless its output equals the op's plain or
    NumPy value, `work` what it must do (for `bound`)."""
    from .fields import limbs_torch as LT
    from .mle import _segment_sum_mod_p
    from .ops import gkr_init as GI
    from .ops import transcript_cuda as tc
    from .transcript.blake2b_rng import Blake2b512Rng
    from .utils.sol import MULS_PER_MONT

    x = probe_inputs(nv, seed)
    n = 1 << nv

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64)).to(device)

    a, b, idx, rows32 = up(x["a"]), up(x["b"]), up(x["idx"]), up(x["rows32"])
    r_pts, omr_pts = up(x["r_pts"]), up(x["omr_pts"])
    perm, last = up(x["perm"]), up(x["last"])
    a_l, b_l = (torch.from_numpy(_limbs(t)).to(device) for t in (x["a"], x["b"]))
    mont_want = L.mont_mul(x["a"], x["b"])
    out: dict = {}

    def rtt():
        if device.type == "cuda":
            tc._empty_launch(device)

    out["rtt"] = (rtt, lambda: None, {"bytes": 0, "imads": 0})

    chain = _compress_chain(device)

    def check_compress():
        got = chain()
        if device.type == "cuda":
            got = [int(v) % (1 << 64) for v in got.cpu().tolist()[:8]]
        _check(got == _compress_chain(torch.device("cpu"))(),
               "compression chain differs from the host's Blake2b core")

    out["compress"] = (chain, check_compress, {"depth": COMPRESS_DEPTH})  # a compression

    step, _bufs = _challenge_step(device)

    def check_challenge():
        fresh, bufs = _challenge_step(device)
        fresh()
        _plain, ref = _challenge_step(torch.device("cpu"))
        tc.transcript_step_ref(*ref, 0)
        _check(all(torch.equal(got.cpu(), want) for got, want in zip(bufs, ref)),
               "transcript step differs from its plain version")

    # the compressions of one step from the fresh transcript's pending
    # bytes, with one attempt at the draw
    count, _blen = compressions(len(Blake2b512Rng.setup().state_tuple()[2]), 3, 1)
    out["challenge"] = (step, check_challenge, {"depth": count * COMPRESS_DEPTH,
                                                "floored": True})

    def gather():
        return a.index_select(1, idx)

    out["gather16"] = (gather, lambda: _check(np.array_equal(gather().cpu().numpy(),
                                                             x["a"][:, x["idx"]]),
                                              "gather differs from NumPy's"),
                       {"bytes": 8 * n + 2 * 128 * n, "imads": 0})

    def cumsum():
        return torch.cumsum(rows32, dim=1)

    out["cumsum32"] = (cumsum, lambda: _check(np.array_equal(cumsum().cpu().numpy(),
                                                             np.cumsum(x["rows32"], axis=1)),
                                              "cumsum differs from NumPy's"),
                       {"bytes": 2 * 256 * n, "imads": 0})

    def mont():
        return LT.mont_mul(a, b)

    mont_work = {"bytes": 3 * 128 * n, "imads": n * MULS_PER_MONT}
    out["mont_nnz"] = (mont, lambda: _check(np.array_equal(mont().cpu().numpy(), mont_want),
                                            "limbs_torch.mont_mul differs from limbs_np's"),
                       mont_work)

    def mont_eo():
        return mont_mul_eo(a_l, b_l)

    out["mont_nnz_eo"] = (mont_eo, lambda: _check(np.array_equal(
        _digits(mont_eo().cpu().numpy()), mont_want), "even/odd multiply differs from limbs_np's"),
        {"bytes": 3 * 32 * n, "imads": n * MULS_PER_MONT})

    def eq():
        return GI._eq_table(r_pts, omr_pts, nv)

    def check_eq():
        got = eq().cpu().numpy().astype(np.uint32)
        lanes = np.random.default_rng(seed + 1).choice(n, size=min(n, 256), replace=False)
        want = []
        for j in lanes:
            v = 1
            for i, r in enumerate(x["points"]):
                v = v * (r if (j >> i) & 1 else 1 - r) % P
            want.append(v)
        _check(L.to_ints(got[:, lanes]) == want, "eq table differs from Python integers")

    out["eq_build"] = (eq, check_eq, {"bytes": 128 * n, "imads": (2 * n - 2) * MULS_PER_MONT})

    def segreduce():
        return GI._segment_reduce_sorted(a, perm, last)

    out["segreduce"] = (segreduce, lambda: _check(np.array_equal(
        segreduce().cpu().numpy(), _segment_sum_mod_p(x["a"][:, x["perm"]], x["seg"][x["perm"]],
                                                      n)),
        "segment reduce differs from NumPy's"), {"bytes": 2 * 128 * n + 16 * n, "imads": 0})
    return out


# ---------------------------------------------------------------------------
# the stage profile
# ---------------------------------------------------------------------------


def gkr_instance(nv: int, seed: int = 0):
    """The bench's GKR instance (`bench.py:187-194`): f1 with 2^nv nonzeros
    over 3 nv variables and g from `random.Random(7)`, f2 and f3 by the
    `bench.py:89-93` rule from `numpy.random.default_rng(seed)`."""
    from . import DenseMLE, Fr, SparseMLE

    prnd = random.Random(7)
    f1 = SparseMLE.rand_with_config(3 * nv, 1 << nv, prnd)
    f2, f3 = (DenseMLE(nv, t) for t in L.random_tables(np.random.default_rng(seed), nv, 2))
    g = [Fr(prnd.randrange(P)) for _ in range(nv)]
    return f1, f2, f3, g


@contextlib.contextmanager
def _generic_chain():
    """The default path: the generic chain, the MXU fold mode off."""
    from .utils.config import get_config

    cfg = get_config()
    saved = (cfg.chain_impl, cfg.mxu_fold)
    cfg.chain_impl, cfg.mxu_fold = "generic", "off"
    try:
        yield
    finally:
        cfg.chain_impl, cfg.mxu_fold = saved


def stage_fns(inst, device) -> dict:
    """{stage: fn} over the instance's uploaded inputs (the uploads are
    cached on the MLEs; made here, outside every stage). Each prefix stage
    returns what it enqueued last."""
    from . import Blake2b512Rng, GKRRoundSumcheck
    from . import gkr_round_sumcheck as G
    from .ops import gkr_init as GI
    from .protocol import device_prover, generic_prover

    device = device_prover.resolve_device(device)
    f1, f2, f3, g = inst
    dim = f2.num_vars
    (gbits, x, y_rev, vals, last_x, perm_y, last_y), (nx, ny), f2_d, f3_d, g_r, g_omr = \
        G._upload(f1, f2, f3, g, dim, device)
    products = ((0, 1),)

    def run(depth: int):
        state = device_prover.lift_transcript(Blake2b512Rng.setup(), device)
        lo1, hi1, w = GI.phase1_pair(gbits, last_x, y_rev, vals, g_r, g_omr, f3_d, f2_d, dim,
                                     not nx)
        if depth == 1:
            return lo1, hi1
        msgs1, rs1, state = generic_prover.chain_rounds_generic(lo1, hi1, state, products, 2,
                                                                dim)
        if depth == 2:
            return lo1, hi1, msgs1, rs1
        lo2, hi2 = GI.phase2_pair(lo1[:, :, :1], hi1[:, :, :1], rs1[dim - 1], x, perm_y, last_y,
                                  w, rs1, f3_d, dim, not ny)
        if depth == 3:
            return lo2, hi2, rs1
        msgs2, rs2, state = generic_prover.chain_rounds_generic(lo2, hi2, state, products, 2,
                                                                dim)
        return torch.cat([msgs1, msgs2]), state

    fns = {name: (lambda d=d: run(d)) for d, name in enumerate(STAGES[:4], start=1)}
    fns["full_prove"] = lambda: GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g,
                                                       device=device)
    return fns


def stage_tables(inst, device) -> dict:
    """What the prefix stages compute, on the host: h_g and f1(g, u, .) as
    (16, 2^dim) uint32 tables in natural lane order, and phase 1's
    challenges u as canonical ints (the tests hold these against the JAX
    package's phase inits)."""
    from .fields.fr import R_INV
    from .protocol.device_prover import col_int
    from .protocol.prover import bitrev_perm

    dim = inst[1].num_vars
    fns = stage_fns(inst, device)
    lo1, hi1 = fns["upto_phase1"]()
    lo2, hi2, rs1 = fns["upto_phase2"]()
    natural = bitrev_perm(dim)

    def table(lo, hi):
        limbs = torch.cat([lo[0], hi[0]], dim=1).cpu().numpy()
        return L.unpack_limbs(limbs)[:, natural]

    return {"h_g": table(lo1, hi1), "f1_gu": table(lo2, hi2),
            "u": [col_int(r) * R_INV % P for r in rs1.cpu().numpy()]}


def stage_work(dim: int, nnz: int) -> dict:
    """{stage: work} of each cumulative prefix: the bytes each input is read
    and each output written once (int64 entry arrays and digits, the
    cached f2, f3 and the table pairs in 32 B limbs an element), and the
    32-bit multiplies of its Montgomery multiplies
    (the inits' eq tables 2 x 2^dim, weight folds and gathered products one
    an entry, f2(u)'s scaling one a lane; the rounds `sol.count_prove_ops`
    for U=2 slots, one product of two, degree 2). The transcript steps'
    latency is not in it."""
    from .utils.sol import MULS_PER_MONT, count_prove_ops

    n = 1 << dim
    rounds = count_prove_ops(dim, 2, 1, 2, 2)
    # phase 1: gbits, y_rev, values, last_x, f3, f2 in; the pair and w out
    p1 = {"bytes": 8 * nnz + 8 * nnz + 128 * nnz + 8 * n + 32 * n + 32 * n + 64 * n + 128 * nnz,
          "mont": 2 * n + 2 * nnz}
    # phase 2: x, perm_y, last_y, w, f3 in; the pair out
    p2 = {"bytes": 8 * nnz + 8 * nnz + 8 * n + 128 * nnz + 32 * n + 64 * n,
          "mont": 2 * n + nnz + n}
    r = {"bytes": rounds["hbm_bytes"], "mont": rounds["mont_muls"]}
    out, total = {}, {"bytes": 0, "mont": 0}
    for name, part in zip(STAGES, (p1, r, p2, r, None)):
        if part is not None:
            total = {k: total[k] + part[k] for k in total}
        out[name] = {"bytes": total["bytes"], "imads": total["mont"] * MULS_PER_MONT}
    return out


def stages(inst, device, reps: int, rates: dict | None) -> dict:
    """The stage profile: `measure` of each prefix and of the full prove,
    and the check that the last prefix's messages are the full prove's."""
    from .protocol.device_prover import msgs_from_host

    dim = inst[1].num_vars
    with _generic_chain():
        fns = stage_fns(inst, device)
        work = stage_work(dim, inst[0].num_nonzero)
        out = {}
        for name in STAGES:
            res = measure(fns[name], device, reps, rates, syncs=name == "full_prove")
            res["bound_ms"], res["bound_by"] = bound(work[name], rates)
            out[name] = dict(res, work=work[name])
        msgs, _state = fns["upto_rounds_p2"]()
        proof = fns["full_prove"]()
    _check(msgs_from_host(msgs.cpu().numpy(), 2)
           == proof.phase1_sumcheck_msgs + proof.phase2_sumcheck_msgs,
           "the stages' messages differ from the full prove's")
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(nv: int = 18, device="cuda", reps: int = 3, seed: int = 0) -> dict:
    """Every probe and the stage profile (over `gkr_instance(nv, seed)`) at
    dim `nv` on `device` (the card unless the caller asks for the CPU).
    Raises if a check fails. Returns {"card", "nv", "device", "probes",
    "stages"}."""
    from .protocol.device_prover import resolve_device

    device = resolve_device(device)
    rates = None
    if device.type == "cuda":
        rates = dict(card_rates(device), ns_per_dependent_op=dependent_op_ns(device))
    res: dict = {"card": rates["card"] if rates else None, "nv": nv, "device": str(device),
                 "probes": {}}
    probe_set = probes(nv, device, seed)
    for name, (fn, check, work) in probe_set.items():
        check()
        per_call = COMPRESS_CHAIN if name == "compress" else 1
        m = measure(fn, device, reps, rates, per_call=per_call)
        if name == "rtt" and rates is not None:
            _check(m["held"], "the rtt probe's one launch outlasted the stream's hold")
            rates["floor_ms"] = m["device_ms"]
        m["bound_ms"], m["bound_by"] = bound(work, rates)
        res["probes"][name] = dict(m, ok=True)
    if rates is not None:  # and the compression probe's own clock count
        res["ns_per_dependent_op"] = rates["ns_per_dependent_op"]
        res["probes"]["compress"]["clocks"] = int(probe_set["compress"][0]()[8]) / COMPRESS_CHAIN
    res["stages"] = stages(gkr_instance(nv, seed), device, reps, rates)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nv", type=int, nargs="?", default=18)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    res = run(args.nv, args.device, args.reps, args.seed)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
