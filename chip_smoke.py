#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`sumcheck_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--reps N]

Run from the root of a checkout. Phases, each printed on its own lines; any
failure raises and exits non-zero without the final line:

1. the card's name and power limit (`nvidia-smi`); no CUDA device -> exit 1;
2. build the three kernel sources, `sumcheck_tpu_torch/csrc/round.cu`,
   `csrc/transcript.cu` and `csrc/round_mxu.cu`, one `nvcc` each, started
   together;
3. the generic chain's round kernels against their plain PyTorch versions
   on the card, array-equal, at the round shapes of the nv=20 2x3 prove and
   at ragged extents, with kernel and plain times;
4. the per-size chain's round kernels against their plain versions at the
   nv=20 shapes (round 0 over 2^19 lanes; folds into 2^18, 2^10, 3 and 1
   lanes; one case with coefficients), with kernel and plain times;
5. the MXU fold kernel `round_fold_mxu` (tensor-core banded multiply)
   against its plain version and against the CIOS fold kernel `round_fold`,
   array-equal, at the nv=20 fold shapes (extents 2^18, 2^10, 37, 3, 1 and
   a ragged 2^9 + 5) and the GKR dim-18 shape (U=2, d=2, extent 2^16), with
   kernel, plain and CIOS-kernel times; then `ops/mxu_mul.py`'s banded
   multiply (float32 matmuls) against the CIOS multiply at 2^17 lanes;
6. the transcript kernel against the plain transcript and the host rng
   over 60 rounds that reject draws, with kernel and plain times;
7. the golden fixtures `tests/fixtures/ml_nv6_rich.json` and
   `ml_nv14_config1.json` through `device="cuda"` on both chains, and
   `gkr_dim5.json` on both chains and in the MXU fold mode;
8. the ML headlines: `MLSumcheck.prove` on 2 products x 3 multiplicands at
   nv=20 (tables from `numpy.random.default_rng(seed)`) on the generic
   chain, the per-size chain (`SUMCHECK_TPU_CHAIN_IMPL=persize`) and the
   generic chain in the MXU fold mode (`SUMCHECK_TPU_MXU_FOLD=kernel`,
   `SUMCHECK_TPU_AB=1`): one first prove and the median of `--reps` warm
   proves each, launch counts per prove (1 + 19 round kernels and 20
   transcript steps), the chain enqueued under
   `torch.cuda.set_sync_debug_mode("error")` so that a host sync inside it
   fails the run, verify, the subclaim against the polynomial, and proof
   bytes equal across the three, the plain path on the card and the
   host-transcript loop (timed beside them);
9. the GKR headlines: `GKRRoundSumcheck.prove` at dim 18 on the bench's
   instance (`bench.py:187-194`) on the same three paths: first prove and
   warm median, launch counts per prove (2 + 34 round kernels and 36
   transcript steps), everything between the uploads and the one fetch
   under the sync debug mode "error", the phase inits and the round kernels
   timed alone, verify and `verify_subclaim`, and proof bytes equal across
   the three and the plain path on the card;
10. one JSON line of the kernels, then the last line
   `{"ok": true, "device": {...}}`.

Tolerance everywhere is 0: the field arithmetic is exact, so every check is
array- or byte-equality.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
NV = 20
SLOTS = 6  # 2 products x 3 multiplicands, coefficients folded in place
GKR_DIM = 18  # the bench's GKR size (`bench.py:560`)
KERNEL_REPS = 20
PLAIN_REPS = 3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def random_tables(rng, nv: int, count: int) -> list[np.ndarray]:
    """Strict Montgomery digit tables below p (the `bench.py` rule)."""
    out = []
    for _ in range(count):
        d = rng.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 2  # < 2^254 < p
        out.append(d)
    return out


def random_pair(rng, slots: int, half: int, device):
    """A random (lo, hi) pair of `slots` tables of 2 * half lanes."""
    stacked = np.stack(random_tables(rng, half.bit_length(), slots)).astype(np.int32)
    lo = torch.from_numpy(np.ascontiguousarray(stacked[:, :, :half])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(stacked[:, :, half:])).to(device)
    return lo, hi


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device) -> float:
    """Mean device time of `fn()` over `reps` runs, after one warm-up."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_round(rc, name, lo, hi, r, products, degree, extent, device, timed):
    """One kernel-vs-plain case; returns (max_abs_err, kernel ms, plain ms)."""
    fold = r is not None
    lo_k, hi_k, lo_p, hi_p = lo.clone(), hi.clone(), lo.clone(), hi.clone()
    if fold:
        got = rc.round_fold(lo_k, hi_k, r, products, degree, extent)
        want = rc.round_fold_ref(lo_p, hi_p, r, products, degree, extent)
    else:
        got = rc.round_nofold(lo_k, hi_k, products, degree, extent)
        want = rc.round_nofold_ref(lo_p, hi_p, products, degree, extent)
    sync(device)
    err = int((got - want).abs().max())
    err = max(err, int((lo_k - lo_p).abs().max()), int((hi_k - hi_p).abs().max()))
    check(err == 0, f"{name}: kernel differs from plain by {err}")
    check((rc.finish_sums(got) == rc.finish_sums(want)).all(), f"{name}: wide sums differ")
    if fold:  # lanes past the extent stay as they were
        check(torch.equal(lo_k[:, :, extent:], lo[:, :, extent:])
              and torch.equal(hi_k[:, :, extent:], hi[:, :, extent:]),
              f"{name}: kernel wrote past the extent")
    ms = plain_ms = None
    if timed:
        if fold:
            ms = time_ms(lambda: rc.round_fold(lo_k, hi_k, r, products, degree, extent),
                         KERNEL_REPS, device)
            plain_ms = time_ms(lambda: rc.round_fold_ref(lo_p, hi_p, r, products, degree, extent),
                               PLAIN_REPS, device)
        else:
            ms = time_ms(lambda: rc.round_nofold(lo_k, hi_k, products, degree, extent),
                         KERNEL_REPS, device)
            plain_ms = time_ms(lambda: rc.round_nofold_ref(lo_p, hi_p, products, degree, extent),
                               PLAIN_REPS, device)
    print(f"kernel-vs-plain {name}: equal"
          + (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if timed else ""))
    return err, ms, plain_ms


def kernel_phase(device, seed: int, nv: int = NV) -> dict:
    """Phase 3: every round shape of the generic chain, kernel against plain."""
    from sumcheck_tpu_torch.convert import polynomial_from_numpy
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.protocol.device_prover import init_pair

    rng = np.random.default_rng(seed)
    half = 1 << (nv - 1)
    lo, hi = random_pair(rng, SLOTS, half, device)
    products = ((0, 1, 2), (3, 4, 5))
    r = torch.from_numpy(
        L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0].astype(np.int32)
    ).to(device)
    stats = {"round_nofold": [0, []], "round_fold": [0, []]}

    def record(kernel, name, res):
        err, ms, plain_ms = res
        stats[kernel][0] = max(stats[kernel][0], err)
        if ms is not None:
            stats[kernel][1].append({"shape": name, "ms": ms, "plain_ms": plain_ms})

    record("round_nofold", f"round 0 nv={nv} U=6 H=2^{nv - 1} d=3",
           compare_round(rc, f"round 0 (H=2^{nv - 1})", lo, hi, None, products, 3,
                         half, device, True))
    record("round_fold", f"fold A2=2^{nv - 2}",
           compare_round(rc, f"fold A2=2^{nv - 2}", lo, hi, r, products, 3,
                         half // 2, device, True))
    for a2 in (1, 3, 37, (1 << 9) + 5):
        record("round_fold", f"fold A2={a2}",
               compare_round(rc, f"fold A2={a2}", lo, hi, r, products, 3, a2,
                             device, True))

    # ragged: products of lengths 3 and 2 sharing a table -> a ones slot and
    # a scaled copy of the shared table, built by init_pair on the device
    nv_r = 10
    tabs = random_tables(rng, nv_r, 4)
    poly = polynomial_from_numpy(nv_r, tabs, [(11, [0, 1, 2]), (13, [0, 3])])
    lo_r, hi_r, prods_r, deg_r = init_pair(poly, device)
    check(lo_r.shape[0] == 6, f"ragged instance has {lo_r.shape[0]} slots, expected 6")
    record("round_nofold", "ragged round 0",
           compare_round(rc, "ragged round 0 (U=6, ones slot)", lo_r, hi_r, None,
                         prods_r, deg_r, 1 << (nv_r - 1), device, False))
    for a2 in (1 << (nv_r - 2), 5):
        record("round_fold", f"ragged fold A2={a2}",
               compare_round(rc, f"ragged fold A2={a2}", lo_r, hi_r, r, prods_r,
                             deg_r, a2, device, False))
    return stats


def compare_step(rc, name, lo, hi, r, products, degree, coeffs, device):
    """One per-size kernel-vs-plain case, timed; returns (err, ms, plain_ms)."""
    fold = r is not None
    if fold:
        (glo, ghi), got = rc.round_step_fold(lo, hi, r, products, degree, coeffs)
        (wlo, whi), want = rc.round_step_fold_ref(lo, hi, r, products, degree, coeffs)
    else:
        got = rc.round_step_nofold(lo, hi, products, degree, coeffs)
        want = rc.round_step_nofold_ref(lo, hi, products, degree, coeffs)
    sync(device)
    err = int((got - want).abs().max())
    if fold:
        check(glo.shape == (lo.shape[0], 16, lo.shape[2] // 2), f"{name}: folded shape {glo.shape}")
        err = max(err, int((glo - wlo).abs().max()), int((ghi - whi).abs().max()))
    check(err == 0, f"{name}: kernel differs from plain by {err}")
    if fold:
        ms = time_ms(lambda: rc.round_step_fold(lo, hi, r, products, degree, coeffs),
                     KERNEL_REPS, device)
        plain_ms = time_ms(lambda: rc.round_step_fold_ref(lo, hi, r, products, degree, coeffs),
                           PLAIN_REPS, device)
    else:
        ms = time_ms(lambda: rc.round_step_nofold(lo, hi, products, degree, coeffs),
                     KERNEL_REPS, device)
        plain_ms = time_ms(lambda: rc.round_step_nofold_ref(lo, hi, products, degree, coeffs),
                           PLAIN_REPS, device)
    print(f"kernel-vs-plain {name}: equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def step_kernel_phase(device, seed: int, nv: int = NV) -> dict:
    """Phase 4: the per-size kernels at the nv=20 round shapes."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import round_cuda as rc

    rng = np.random.default_rng(seed + 1)
    half = 1 << (nv - 1)
    lo, hi = random_pair(rng, SLOTS, half, device)
    products = ((0, 1, 2), (3, 4, 5))
    r = torch.from_numpy(
        L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0].astype(np.int32)
    ).to(device)
    coeffs = torch.from_numpy(np.stack(
        [L.mont_scalar(int(rng.integers(1, 1 << 62)))[:, 0] for _ in products]
    ).astype(np.int32)).to(device)
    stats = {"round_step_nofold": [0, []], "round_step_fold": [0, []]}

    def record(kernel, name, res):
        err, ms, plain_ms = res
        stats[kernel][0] = max(stats[kernel][0], err)
        stats[kernel][1].append({"shape": name, "ms": ms, "plain_ms": plain_ms})

    name = f"round 0 nv={nv} U=6 H=2^{nv - 1} d=3"
    record("round_step_nofold", name,
           compare_step(rc, f"per-size {name}", lo, hi, None, products, 3, None, device))
    for quarter in (half // 2, 1 << 10, 3, 1):
        qname = f"2^{quarter.bit_length() - 1}" if quarter > 3 else str(quarter)
        name = f"fold H={2 * quarter} -> {qname}"
        w = 2 * quarter
        slo, shi = lo[:, :, :w].contiguous(), hi[:, :, :w].contiguous()
        record("round_step_fold", name,
               compare_step(rc, f"per-size {name}", slo, shi, r, products, 3, None, device))
    record("round_step_fold", f"fold H=2^{nv - 1} with coefficients",
           compare_step(rc, f"per-size fold H=2^{nv - 1} with coefficients", lo, hi, r,
                        products, 3, coeffs, device))
    record("round_step_nofold", "round 0 with coefficients",
           compare_step(rc, "per-size round 0 with coefficients", lo[:, :, :1 << 10].contiguous(),
                        hi[:, :, :1 << 10].contiguous(), None, products, 3, coeffs, device))
    return stats


def compare_mxu(rc, name, lo, hi, r, products, degree, extent, device):
    """`round_fold_mxu` against its plain version and against `round_fold`,
    each from the same pair: sums and folded pair array-equal, lanes past
    the extent untouched. Returns (max_abs_err, kernel ms, plain ms, CIOS
    kernel ms); the timed runs fold the kernel's output again in place."""
    runs = []
    for fn in (rc.round_fold_mxu, rc.round_fold_mxu_ref, rc.round_fold):
        lo_c, hi_c = lo.clone(), hi.clone()
        runs.append((fn(lo_c, hi_c, r, products, degree, extent), lo_c, hi_c))
    sync(device)
    (got, lo_k, hi_k) = runs[0]
    err = 0
    for sums, lo_c, hi_c in runs[1:]:
        err = max(err, int((got - sums).abs().max()), int((lo_k - lo_c).abs().max()),
                  int((hi_k - hi_c).abs().max()))
    check(err == 0, f"{name}: MXU fold kernel differs from its plain version or round_fold "
                    f"by {err}")
    check(torch.equal(lo_k[:, :, extent:], lo[:, :, extent:])
          and torch.equal(hi_k[:, :, extent:], hi[:, :, extent:]),
          f"{name}: MXU fold kernel wrote past the extent")
    ms = time_ms(lambda: rc.round_fold_mxu(lo_k, hi_k, r, products, degree, extent),
                 KERNEL_REPS, device)
    plain_ms = time_ms(lambda: rc.round_fold_mxu_ref(lo_k, hi_k, r, products, degree, extent),
                       PLAIN_REPS, device)
    cios_ms = time_ms(lambda: rc.round_fold(lo_k, hi_k, r, products, degree, extent),
                      KERNEL_REPS, device)
    print(f"kernel-vs-plain-vs-CIOS {name}: equal, MXU kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, CIOS kernel {cios_ms:.4f} ms")
    return err, ms, plain_ms, cios_ms


def mxu_kernel_phase(device, seed: int, nv: int = NV, gkr_dim: int = GKR_DIM) -> dict:
    """Phase 5: the MXU fold kernel at the GKR dim-18 fold shape and the
    nv=20 fold shapes, against its plain version and the CIOS kernel."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import round_cuda as rc

    rng = np.random.default_rng(seed + 3)
    r = torch.from_numpy(
        L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0].astype(np.int32)
    ).to(device)
    timings, err = [], 0

    def record(shape, lo, hi, products, degree, extent):
        nonlocal err
        e, ms, plain_ms, cios_ms = compare_mxu(rc, shape, lo, hi, r, products, degree, extent,
                                               device)
        err = max(err, e)
        timings.append({"shape": shape, "ms": ms, "plain_ms": plain_ms, "cios_ms": cios_ms})

    half = 1 << (gkr_dim - 1)
    lo, hi = random_pair(rng, 2, half, device)
    record(f"GKR dim={gkr_dim} fold U=2 d=2 A2=2^{gkr_dim - 2}", lo, hi, ((0, 1),), 2, half // 2)
    half = 1 << (nv - 1)
    lo, hi = random_pair(rng, SLOTS, half, device)
    products = ((0, 1, 2), (3, 4, 5))
    for a2 in (half // 2, 1 << 10, 37, 3, 1, (1 << 9) + 5):
        name = f"2^{a2.bit_length() - 1}" if a2 in (half // 2, 1 << 10) else str(a2)
        record(f"ML nv={nv} fold U=6 d=3 A2={name}", lo, hi, products, 3, a2)
    return {"round_fold_mxu": [err, timings]}


def mxu_mul_phase(device, seed: int, lanes: int = 1 << 17) -> dict:
    """Phase 5b: `ops/mxu_mul.py`'s banded multiply (the GKR inits' shared-
    scalar multiply in the MXU fold mode, float32 matmuls on the card)
    against the CIOS multiply of `limbs_torch`, edge values included."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields import limbs_torch as LT
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import mxu_mul

    rng = np.random.default_rng(seed + 4)
    a = torch.from_numpy(random_tables(rng, lanes.bit_length() - 1, 1)[0].astype(np.int64))
    edges = [0, 1, 2, P - 1, P - 2, (1 << 255) % P]
    a[:, :len(edges)] = torch.from_numpy(L.from_ints(edges, mont=False).astype(np.int64))
    a = a.to(device)
    scalars = [int(rng.integers(1, 1 << 62)) ** 4 % P, 0, 1, P - 1]
    for v in scalars:
        c = torch.from_numpy(L.from_ints([v], mont=False)[:, 0].astype(np.int64)).to(device)
        got, want = mxu_mul.mont_mul_scalar_mxu(a, c), LT.mont_mul(a, c[:, None])
        sync(device)
        check(torch.equal(got, want), f"banded multiply differs from CIOS for scalar {v:#x}")
    ms = time_ms(lambda: mxu_mul.mont_mul_scalar_mxu(a, c), PLAIN_REPS, device)
    cios_ms = time_ms(lambda: LT.mont_mul(a, c[:, None]), PLAIN_REPS, device)
    print(f"mxu_mul.mont_mul_scalar_mxu at {lanes} lanes: equal to limbs_torch.mont_mul for "
          f"{len(scalars)} scalars and edge operands; banded {ms:.4f} ms, CIOS {cios_ms:.4f} ms "
          f"(torch ops)")
    return {"lanes": lanes, "ms": ms, "cios_ms": cios_ms}


def transcript_phase(device, seed: int, rounds: int = 60, degree: int = 3) -> dict:
    """Phase 5: the transcript kernel against the plain transcript on the
    card and against the host rng, over `rounds` rounds."""
    from sumcheck_tpu_torch import Blake2b512Rng, Fr
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcript
    from sumcheck_tpu_torch.protocol.prover import ProverMsg
    from sumcheck_tpu_torch.transcript.blake2b_rng import _DRAW_MASK

    gen = np.random.default_rng(seed + 2)
    sums = torch.from_numpy(
        gen.integers(0, 1 << 40, size=(rounds, degree + 1, 16), dtype=np.int64)).to(device)
    prefix = gen.bytes(48)
    host = Blake2b512Rng.setup()
    host.feed_bytes(prefix)
    state_k = lift_transcript(host, device)
    state_p = state_k.clone()

    def buffers():
        return (torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=device),
                torch.empty((rounds, 16), dtype=torch.int32, device=device))

    (msgs_k, rs_k), (msgs_p, rs_p) = buffers(), buffers()
    for j in range(rounds):
        tc.transcript_step(state_k, sums[j], msgs_k, rs_k, j)
        tc.transcript_step_ref(state_p, sums[j], msgs_p, rs_p, j)
    sync(device)
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in ((state_k, state_p), (msgs_k, msgs_p), (rs_k, rs_p)))
    check(err == 0, f"transcript kernel differs from plain by {err}")

    # the host rng over the same messages: same challenges, same final state
    msgs_h = msgs_k.cpu().numpy().astype(np.int64)
    rs_h = rs_k.cpu().numpy().astype(np.int64)
    rejected = 0
    for j in range(rounds):
        host.feed(ProverMsg([Fr(sum(int(msgs_h[j, i, t]) << (16 * i) for i in range(16)))
                             for t in range(degree + 1)]))
        while True:
            draw = int.from_bytes(host.next_u64s_bytes(4), "little") & _DRAW_MASK
            if draw < P:
                break
            rejected += 1
        check(sum(int(rs_h[j, i]) << (16 * i) for i in range(16)) == draw,
              f"transcript round {j}: challenge differs from the host rng's")
    from sumcheck_tpu_torch.protocol.device_prover import restore_transcript

    probe = Blake2b512Rng.setup()
    restore_transcript(probe, state_k.cpu())
    check(probe.state_tuple() == host.state_tuple(), "transcript state differs from the host rng's")
    check(rejected >= 1, "the transcript schedule rejected no draw")

    state_t = state_k.clone()
    j_next = [0]

    def kernel_step():
        tc.transcript_step(state_t, sums[j_next[0]], msgs_k, rs_k, j_next[0])
        j_next[0] = (j_next[0] + 1) % rounds

    def plain_step():
        tc.transcript_step_ref(state_t, sums[j_next[0]], msgs_p, rs_p, j_next[0])
        j_next[0] = (j_next[0] + 1) % rounds

    ms = time_ms(kernel_step, rounds, device)
    plain_ms = time_ms(plain_step, PLAIN_REPS, device)
    print(f"transcript kernel-vs-plain, {rounds} rounds d={degree}: equal, equal to the host "
          f"rng ({rejected} draws rejected); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per round")
    return {"transcript_step": [err, [{"shape": f"one round, d={degree}", "ms": ms,
                                       "plain_ms": plain_ms}]]}


def golden_table(prefix: str, tag: str, nv: int, P: int) -> list[int]:
    """The fixtures' documented table rule (`tests/test_golden.py:54-61`)."""
    out = []
    for i in range(1 << nv):
        h = hashlib.blake2b(f"sumcheck-golden/{prefix}/{tag}/{i}".encode(), digest_size=32)
        out.append(int.from_bytes(h.digest(), "little") % P)
    return out


def golden_phase(device) -> None:
    """Phase 6: the ML golden fixtures through `device`, on both chains."""
    from sumcheck_tpu_torch import (
        Blake2b512Rng, DenseMLE, Fr, ListOfProductsOfPolynomials, MLSumcheck,
    )
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    for name in ("ml_nv6_rich.json", "ml_nv14_config1.json"):
        fx = json.loads((FIXTURES / name).read_text())
        nv = fx["nv"]
        prefix = "nv14" if nv == 14 else "nv6"
        shared = {}
        poly = ListOfProductsOfPolynomials(nv)
        for prod in fx["products"]:
            mles = []
            for tag in prod["tables"]:
                if tag not in shared:
                    shared[tag] = DenseMLE.from_evaluations(nv, golden_table(prefix, tag, nv, P))
                mles.append(shared[tag])
            poly.add_product(mles, Fr(int(prod["coeff"], 16)))
        check(poly.info().serialize_uncompressed().hex() == fx["info_bytes"], f"{name}: info")
        for chain in ("generic", "persize"):
            fs_rng = Blake2b512Rng.setup()
            with fold_mode(chain), syncs_forbidden_in_chains():
                proof, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
            check(serialize_proof(proof).hex() == fx["proof_bytes"], f"{name} {chain}: proof bytes")
            check([format(r.v, "064x") for r in state.randomness] == fx["challenges"],
                  f"{name} {chain}: challenges")
            sub = MLSumcheck.verify(poly.info(), Fr(int(fx["asserted_sum"], 16)), proof)
            check(sub.expected_evaluation.v == int(fx["final_evaluation"], 16),
                  f"{name} {chain}: final evaluation")
            print(f"golden {name}, {chain} chain: proof bytes, challenges and final "
                  f"evaluation equal")


# the paths each headline drives: (chain, MXU fold mode)
PATHS = {"generic": ("generic", False), "per-size": ("persize", False),
         "generic mxu": ("generic", True)}


@contextlib.contextmanager
def fold_mode(chain: str, mxu: bool = False, mxu_min_lanes: int | None = None):
    """Run under one chain (`SUMCHECK_TPU_CHAIN_IMPL`) and, with `mxu`, the
    MXU fold mode (`SUMCHECK_TPU_MXU_FOLD=kernel`, `SUMCHECK_TPU_AB=1`);
    `mxu_min_lanes` lowers the GKR inits' banded-product threshold."""
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.utils.config import get_config

    cfg = get_config()
    saved = (cfg.chain_impl, cfg.mxu_fold, cfg.ab, GI.MXU_MIN_LANES)
    cfg.chain_impl = chain
    if mxu:
        cfg.mxu_fold, cfg.ab = "kernel", True
    if mxu_min_lanes is not None:
        GI.MXU_MIN_LANES = mxu_min_lanes
    try:
        yield
    finally:
        cfg.chain_impl, cfg.mxu_fold, cfg.ab, GI.MXU_MIN_LANES = saved


def gkr_golden_phase(device) -> None:
    """Phase 7b: `tests/fixtures/gkr_dim5.json` through `device` on both
    chains and in the MXU fold mode (banded-product threshold at 1 lane, so
    the inits' banded multiplies run too): messages, claimed sum, the
    verifier's challenges and expected evaluation, the subclaim."""
    from sumcheck_tpu_torch import Blake2b512Rng, DenseMLE, Fr, GKRRoundSumcheck, SparseMLE
    from sumcheck_tpu_torch.fields.fr import P

    fx = json.loads((FIXTURES / "gkr_dim5.json").read_text())
    dim = fx["dim"]
    f1 = SparseMLE.from_pairs(3 * dim, [(int(k), Fr(int(v, 16)))
                                        for k, v in fx["f1_nonzeros"].items()])
    f2, f3 = (DenseMLE.from_evaluations(dim, golden_table(f"gkr{dim}", tag, dim, P))
              for tag in ("f2", "f3"))
    g = [Fr(int(x, 16)) for x in fx["g"]]

    def hexes(msgs):
        return [[format(e.v, "064x") for e in m.evaluations] for m in msgs]

    for path, (chain, mxu) in PATHS.items():
        with fold_mode(chain, mxu, 1 if mxu else None), syncs_forbidden_in_chains():
            proof = GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g, device=device)
        check(hexes(proof.phase1_sumcheck_msgs) == fx["phase1_msgs"]
              and hexes(proof.phase2_sumcheck_msgs) == fx["phase2_msgs"],
              f"gkr_dim5.json {path}: proof messages")
        sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, proof,
                                      Fr(int(fx["claimed_sum"], 16)))
        check([format(x.v, "064x") for x in sub.u + sub.v] == fx["u"] + fx["v"]
              and sub.expected_evaluation.v == int(fx["expected_evaluation"], 16)
              and sub.verify_subclaim(f1, f2, f3, g), f"gkr_dim5.json {path}: verifier")
        print(f"golden gkr_dim5.json, {path}: proof bytes, challenges, expected evaluation "
              f"and subclaim equal")


def headline_poly(seed: int, nv: int = NV):
    """2 products x 3 multiplicands at `nv`, tables and coefficients from
    `numpy.random.default_rng(seed)` in the order of `bench.py:179-184`."""
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    rng = np.random.default_rng(seed)
    tables, products = [], []
    for _ in range(2):
        idx = []
        for t in random_tables(rng, nv, 3):
            tables.append(t)
            idx.append(len(tables) - 1)
        products.append((int(rng.integers(1, 1 << 62)), idx))
    return polynomial_from_numpy(nv, tables, products)


def counters() -> dict:
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.ops import transcript_cuda as tc

    return {"round_nofold": rc.round_nofold, "round_fold": rc.round_fold,
            "round_step_nofold": rc.round_step_nofold, "round_step_fold": rc.round_step_fold,
            "round_fold_mxu": rc.round_fold_mxu, "transcript_step": tc.transcript_step}


@contextlib.contextmanager
def syncs_forbidden_in_chains():
    """Run both chains' enqueue loops, and a GKR prove's whole enqueue
    (both phase inits and both chains, `gkr_round_sumcheck._enqueue`),
    under the sync debug mode "error": a host sync inside raises, so the
    prove's one fetch after them is its only sync. (The plain versions sync
    by design, so the plain path runs outside this.)"""
    from sumcheck_tpu_torch import gkr_round_sumcheck
    from sumcheck_tpu_torch.protocol import device_prover, generic_prover

    def guarded(fn):
        def run(*args, **kwargs):
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        return run

    owners = ((device_prover, "chain_rounds"), (generic_prover, "chain_rounds_generic"),
              (gkr_round_sumcheck, "_enqueue"))
    saved = [getattr(mod, name) for mod, name in owners]
    for (mod, name), fn in zip(owners, saved):
        setattr(mod, name, guarded(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(owners, saved):
            setattr(mod, name, fn)


def wall(fn, device, reps: int = 3) -> float:
    """Median host-clock seconds of `fn()` between two syncs."""
    out = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def device_busy(fn, top: int = 5) -> dict:
    """One run of `fn` under `torch.profiler`: host-clock seconds between
    two syncs, the seconds in which the card ran a kernel or a copy (the
    union of their intervals), the idle share, and the `top` device
    operations by summed device time. The profiler adds host time to every
    torch op, so the idle share it reads is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.end - e.time_range.start
    busy_us, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    busy_s = busy_us / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall_s, "busy_s": busy_s, "idle_share": 1 - busy_s / wall_s,
            "top": [(name[:70], us / 1e3) for name, us in ranked]}


def print_busy(label: str, busy: dict) -> None:
    print(f"{label}: one warm prove under torch.profiler {busy['wall_s']:.4f} s, the card busy "
          f"{busy['busy_s']:.4f} s, idle share {busy['idle_share']:.4f}; most device time: "
          + "; ".join(f"{name} {ms:.3f} ms" for name, ms in busy["top"]))


def path_kernels(chain: str, mxu: bool) -> tuple[str, str]:
    """The (round 0, fold) kernels a path launches."""
    if chain != "generic":
        return "round_step_nofold", "round_step_fold"
    return "round_nofold", "round_fold_mxu" if mxu else "round_fold"


def headline_phase(device, seed: int, reps: int, path: str, nv: int = NV) -> dict:
    """Phase 8: the nv=20 2x3 prove through the public entry points on one
    path (`PATHS`); returns its numbers and proof bytes."""
    chain, mxu = PATHS[path]
    with fold_mode(chain, mxu):
        return _headline(device, seed, reps, path, chain, mxu, nv)


def _headline(device, seed: int, reps: int, path: str, chain: str, mxu: bool, nv: int) -> dict:
    from sumcheck_tpu_torch import Blake2b512Rng, MLSumcheck
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import init_pair, prove_chained
    from sumcheck_tpu_torch.protocol.generic_prover import prove_generic

    poly = headline_poly(seed, nv)
    info = poly.info()
    kernels = path_kernels(chain, mxu)
    fold_fn = getattr(rc, kernels[1])

    with syncs_forbidden_in_chains():
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        proof = MLSumcheck.prove(poly, device=device)
        first_s = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = MLSumcheck.prove(poly, device=device)
            walls.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters().items()}
    proves = reps + 1
    want = {k: 0 for k in launches}
    want.update({kernels[0]: proves, kernels[1]: proves * (nv - 1), "transcript_step": proves * nv})
    check(launches == want, f"ML {path}: launch counts {launches} over {proves} proves, "
                           f"expected {want}")
    check(serialize_proof(again) == serialize_proof(proof), f"ML {path}: warm proves differ")
    prove_s = statistics.median(walls)
    print(f"headline ML {path}, prove nv={nv} 2x3: first {first_s:.4f} s (with table "
          f"upload), median of {reps} warm {prove_s:.4f} s, walls {[round(w, 4) for w in walls]}")
    print(f"ML {path} launches over {proves} proves: "
          f"{ {k: v for k, v in launches.items() if v} }, no sync inside the chain")

    # where the prove's time goes: the pair init alone, and init plus every
    # round kernel enqueued back to back with no transcript
    r = torch.from_numpy(L.mont_scalar(12345)[:, 0].astype(np.int32)).to(device)

    def rounds_only():
        lo, hi, products, degree = init_pair(poly, device)
        half = lo.shape[2]
        if chain == "generic":
            rc.round_nofold(lo, hi, products, degree, half)
            for j in range(1, nv):
                fold_fn(lo, hi, r, products, degree, half >> j)
        else:
            rc.round_step_nofold(lo, hi, products, degree)
            for _ in range(1, nv):
                (lo, hi), _s = rc.round_step_fold(lo, hi, r, products, degree)

    init_s = wall(lambda: init_pair(poly, device), device)
    kernels_s = wall(rounds_only, device)
    for f in counters().values():
        f.launches = 0
    print(f"ML {path}: pair init {init_s:.4f} s; init + {nv} round kernels without transcript "
          f"{kernels_s:.4f} s; so transcript steps and the fetch {prove_s - kernels_s:.4f} s "
          f"of the {prove_s:.4f} s prove")
    busy = device_busy(lambda: MLSumcheck.prove(poly, device=device))
    print_busy(f"ML {path}", busy)

    s = MLSumcheck.extract_sum(proof)
    sub = MLSumcheck.verify(info, s, proof)
    vwalls = []
    for _ in range(21):
        t0 = time.perf_counter()
        MLSumcheck.verify(info, s, proof)
        vwalls.append(time.perf_counter() - t0)
    verify_s = statistics.median(vwalls)
    check(poly.evaluate(sub.point) == sub.expected_evaluation,
          f"ML {path}: subclaim does not match the polynomial")
    fs_rng = Blake2b512Rng.setup()
    _, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
    check(state.randomness == sub.point, f"ML {path}: prover randomness is not the subclaim point")
    print(f"ML {path}: verify accepts; subclaim equals poly.evaluate(point) and the prover's "
          f"randomness; verify median {verify_s:.6f} s")

    # the plain path on the same card: plain round versions and plain transcript
    fs_rng = Blake2b512Rng.setup()
    fs_rng.feed(info)
    t0 = time.perf_counter()
    if chain == "generic":
        plain, _ = prove_generic(fs_rng, poly, device,
                                 round_fns=(rc.round_nofold_ref, rc.round_fold_mxu_ref if mxu
                                            else rc.round_fold_ref),
                                 transcript_fn=tc.transcript_step_ref)
    else:
        plain, _ = prove_chained(fs_rng, poly, device,
                                 step_fns=(rc.round_step_nofold_ref, rc.round_step_fold_ref),
                                 transcript_fn=tc.transcript_step_ref)
    plain_s = time.perf_counter() - t0
    check(serialize_proof(plain) == serialize_proof(proof),
          f"ML {path}: kernel proof differs from the plain path's")
    print(f"ML {path}: plain-path proof on the same device: bytes equal ({plain_s:.4f} s)")
    return {"launches": launches, "prove_s": prove_s, "first_s": first_s, "init_s": init_s,
            "kernels_s": kernels_s, "verify_s": verify_s, "plain_s": plain_s, "busy": busy,
            "proof": serialize_proof(proof)}


class HostTranscriptRng:
    """The same transcript bytes as `Blake2b512Rng`, but not one: the prover
    runs its host-transcript loop for it (one sync per round)."""

    def __init__(self):
        from sumcheck_tpu_torch import Blake2b512Rng

        self._rng = Blake2b512Rng.setup()

    def feed(self, msg):
        self._rng.feed(msg)

    def next_u64s_bytes(self, k: int) -> bytes:
        return self._rng.next_u64s_bytes(k)


def host_transcript_phase(device, seed: int, reps: int, nv: int = NV) -> dict:
    """The generic chain's kernels with the transcript on the host, one sync
    per round, timed beside the headlines."""
    from sumcheck_tpu_torch import MLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    poly = headline_poly(seed, nv)
    MLSumcheck.prove_as_subprotocol(HostTranscriptRng(), poly, device=device)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        proof, _ = MLSumcheck.prove_as_subprotocol(HostTranscriptRng(), poly, device=device)
        walls.append(time.perf_counter() - t0)
    prove_s = statistics.median(walls)
    print(f"host-transcript loop (generic kernels, one sync per round): median of {reps} "
          f"warm {prove_s:.4f} s, walls {[round(w, 4) for w in walls]}")
    return {"prove_s": prove_s, "proof": serialize_proof(proof)}


def gkr_instance(seed: int, dim: int = GKR_DIM):
    """The bench's GKR instance (`bench.py:187-194`): f1 with 2^dim nonzeros
    over 3 dim variables and g from `random.Random(7)`, f2 and f3 by the
    `bench.py:89-93` rule from `numpy.random.default_rng(seed)`."""
    from sumcheck_tpu_torch import DenseMLE, Fr, SparseMLE
    from sumcheck_tpu_torch.fields.fr import P

    prnd = random.Random(7)
    f1 = SparseMLE.rand_with_config(3 * dim, 1 << dim, prnd)
    f2, f3 = (DenseMLE(dim, t) for t in random_tables(np.random.default_rng(seed), dim, 2))
    g = [Fr(prnd.randrange(P)) for _ in range(dim)]
    return f1, f2, f3, g


def gkr_headline_phase(device, inst, reps: int, path: str) -> dict:
    """Phase 9: `GKRRoundSumcheck.prove` at the instance's dim on one path
    (`PATHS`); returns its numbers and proof bytes."""
    chain, mxu = PATHS[path]
    with fold_mode(chain, mxu):
        return _gkr_headline(device, inst, reps, path, chain, mxu)


def _gkr_headline(device, inst, reps: int, path: str, chain: str, mxu: bool) -> dict:
    from sumcheck_tpu_torch import Blake2b512Rng, GKRRoundSumcheck
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.ops import transcript_cuda as tc

    f1, f2, f3, g = inst
    dim = f2.num_vars
    kernels = path_kernels(chain, mxu)

    def prove():
        return GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g, device=device)

    with syncs_forbidden_in_chains():
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        proof = prove()
        first_s = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = prove()
            walls.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters().items()}
    proves = reps + 1
    want = {k: 0 for k in launches}
    want.update({kernels[0]: 2 * proves, kernels[1]: 2 * (dim - 1) * proves,
                 "transcript_step": 2 * dim * proves})
    check(launches == want, f"GKR {path}: launch counts {launches} over {proves} proves, "
                           f"expected {want}")
    blob = proof.serialize_uncompressed()
    check(again.serialize_uncompressed() == blob, f"GKR {path}: warm proves differ")
    prove_s = statistics.median(walls)
    print(f"headline GKR {path}, prove dim={dim} (nnz 2^{dim}): first {first_s:.4f} s (with "
          f"f1 split and table upload), median of {reps} warm {prove_s:.4f} s, walls "
          f"{[round(w, 4) for w in walls]}")
    print(f"GKR {path} launches over {proves} proves: "
          f"{ {k: v for k, v in launches.items() if v} }, no sync between the uploads and the "
          f"fetch")

    # where the prove's time goes: both phase inits alone (fixed challenges),
    # and the 2 dim round kernels alone on a pair of the phases' shape
    (gbits, x, y_rev, vals, last_x, perm_y, last_y), (nx, ny), f2_d, f3_d, g_r, g_omr = \
        G._upload(f1, f2, f3, g, dim, device)
    gen = np.random.default_rng(dim)
    us = torch.from_numpy(np.stack([L.mont_scalar(int(gen.integers(1, 1 << 62)) % P)[:, 0]
                                    for _ in range(dim)]).astype(np.int32)).to(device)

    def inits():
        lo, hi, w = GI.phase1_pair(gbits, last_x, y_rev, vals, g_r, g_omr, f3_d, f2_d, dim,
                                   not nx)
        return GI.phase2_pair(lo[:, :, :1], hi[:, :, :1], us[dim - 1], x, perm_y, last_y, w,
                              us, f3_d, dim, not ny)

    lo0, hi0 = inits()
    products, half = ((0, 1),), lo0.shape[2]

    def rounds_only():
        for _ in range(2):
            lo, hi = lo0.clone(), hi0.clone()
            if chain == "generic":
                rc.round_nofold(lo, hi, products, 2, half)
                for j in range(1, dim):
                    getattr(rc, kernels[1])(lo, hi, us[j], products, 2, half >> j)
            else:
                rc.round_step_nofold(lo, hi, products, 2)
                for j in range(1, dim):
                    (lo, hi), _s = rc.round_step_fold(lo, hi, us[j], products, 2)

    inits_s = wall(inits, device, reps=5)
    rounds_s = wall(rounds_only, device, reps=5)
    for f in counters().values():
        f.launches = 0
    print(f"GKR {path}: both phase inits {inits_s:.4f} s; {2 * dim} round kernels without "
          f"transcript {rounds_s:.4f} s; so transcript steps and the fetch "
          f"{prove_s - inits_s - rounds_s:.4f} s of the {prove_s:.4f} s prove")
    busy = device_busy(prove)
    print_busy(f"GKR {path}", busy)

    s = proof.extract_sum()
    vwalls = []
    for _ in range(21):
        t0 = time.perf_counter()
        sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, proof, s)
        vwalls.append(time.perf_counter() - t0)
    verify_s = statistics.median(vwalls)
    out = {"launches": launches, "prove_s": prove_s, "first_s": first_s, "inits_s": inits_s,
           "rounds_s": rounds_s, "verify_s": verify_s, "busy": busy, "proof": blob}
    print(f"GKR {path}: verify accepts, median {verify_s:.6f} s")
    if path != "generic":
        return out

    # once, on the default path: the subclaim against f1, f2, f3 on the host,
    # and the plain path on the card (plain round versions and transcript)
    t0 = time.perf_counter()
    check(sub.verify_subclaim(f1, f2, f3, g), f"GKR {path}: subclaim does not hold")
    subclaim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = G._prove_chained(Blake2b512Rng.setup(), f1, f2, f3, g, dim, device,
                             round_fns=(rc.round_nofold_ref, rc.round_fold_ref),
                             transcript_fn=tc.transcript_step_ref)
    plain_s = time.perf_counter() - t0
    check(plain.serialize_uncompressed() == blob, f"GKR {path}: kernel proof differs from "
                                                  f"the plain path's")
    print(f"GKR {path}: verify_subclaim holds ({subclaim_s:.4f} s on the host); plain-path "
          f"proof on the same device: bytes equal ({plain_s:.4f} s)")
    out.update(subclaim_s=subclaim_s, plain_s=plain_s)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sumcheck_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = cuda_build.build("round", "transcript", "round_mxu")
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(lib.name for lib in libs.values())} in {build_s:.2f} s (in parallel)")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    stats = kernel_phase(device, args.seed)
    stats.update(step_kernel_phase(device, args.seed))
    stats.update(mxu_kernel_phase(device, args.seed))
    mxu_mul = mxu_mul_phase(device, args.seed)
    stats.update(transcript_phase(device, args.seed))
    golden_phase(device)
    gkr_golden_phase(device)

    # the main paths: each driven with every launch count set to 0 just
    # before it and read just after
    heads = {f"ml {path}": headline_phase(device, args.seed, args.reps, path) for path in PATHS}
    host = host_transcript_phase(device, args.seed, args.reps)
    check(len({h["proof"] for h in heads.values()} | {host["proof"]}) == 1,
          "the ML paths and the host-transcript loop prove different bytes")
    print("ML proof bytes equal: generic chain, per-size chain, generic chain in the MXU fold "
          "mode, their plain paths, host-transcript loop; prove medians "
          + ", ".join(f"{k} {h['prove_s']:.4f} s" for k, h in heads.items())
          + f", host transcript {host['prove_s']:.4f} s")
    inst = gkr_instance(args.seed)
    gkr = {f"gkr {path}": gkr_headline_phase(device, inst, args.reps, path) for path in PATHS}
    check(len({h["proof"] for h in gkr.values()}) == 1, "the GKR paths prove different bytes")
    print("GKR proof bytes equal: generic chain, per-size chain, generic chain in the MXU fold "
          "mode, the plain path; prove medians "
          + ", ".join(f"{k} {h['prove_s']:.4f} s" for k, h in gkr.items()))
    heads.update(gkr)

    kernels = []
    for name, replaces, path in (
        ("round_nofold", "sumcheck_tpu/ops/round_pallas.py:246", "ml generic"),
        ("round_fold", "sumcheck_tpu/ops/round_pallas.py:192", "ml generic"),
        ("round_step_nofold", "sumcheck_tpu/ops/round_pallas.py:103", "ml per-size"),
        ("round_step_fold", "sumcheck_tpu/ops/round_pallas.py:85", "ml per-size"),
        ("round_fold_mxu", "sumcheck_tpu/ops/round_pallas.py:215", "gkr generic mxu"),
        ("transcript_step", "sumcheck_tpu/protocol/device_prover.py:118", "ml per-size"),
    ):
        err, timings = stats[name]
        main_shape = timings[0]
        source = {"transcript_step": "transcript.cu", "round_fold_mxu": "round_mxu.cu"}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"sumcheck_tpu_torch/csrc/{source.get(name, 'round.cu')}",
            "replaces": replaces,
            "launches": heads[path]["launches"][name],
            "launches_by_path": {p: h["launches"][name] for p, h in heads.items()},
            "max_abs_err": err,
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "shape": main_shape["shape"],
            "timings": timings,
        })
    print(f"card: {card}; prove medians "
          + ", ".join(f"{k} {h['prove_s']:.4f} s" for k, h in heads.items())
          + f"; banded multiply at {mxu_mul['lanes']} lanes {mxu_mul['ms']:.4f} ms, CIOS "
          f"{mxu_mul['cios_ms']:.4f} ms; build {build_s:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
