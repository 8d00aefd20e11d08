#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`sumcheck_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--reps N]

Run from the root of a checkout. Phases, each printed on its own lines; any
failure raises and exits non-zero without the final line:

1. the card's name and power limit (`nvidia-smi`); no CUDA device -> exit 1;
2. build both kernel sources, `sumcheck_tpu_torch/csrc/round.cu` and
   `csrc/transcript.cu`, one `nvcc` each, started together;
3. the generic chain's round kernels against their plain PyTorch versions
   on the card, array-equal, at the round shapes of the nv=20 2x3 prove and
   at ragged extents, with kernel and plain times;
4. the per-size chain's round kernels against their plain versions at the
   nv=20 shapes (round 0 over 2^19 lanes; folds into 2^18, 2^10, 3 and 1
   lanes; one case with coefficients), with kernel and plain times;
5. the transcript kernel against the plain transcript and the host rng
   over 60 rounds that reject draws, with kernel and plain times;
6. the golden fixtures `tests/fixtures/ml_nv6_rich.json` and
   `ml_nv14_config1.json` through `device="cuda"` on both chains;
7. the headlines: `MLSumcheck.prove` on 2 products x 3 multiplicands at
   nv=20 (tables from `numpy.random.default_rng(seed)`), first on the
   generic chain, then with `SUMCHECK_TPU_CHAIN_IMPL=persize` semantics on
   the per-size chain: one first prove and the median of `--reps` warm
   proves each, launch counts per prove (1 + 19 round kernels and 20
   transcript steps), the chain enqueued under
   `torch.cuda.set_sync_debug_mode("error")` so that a host sync inside it
   fails the run, verify, the subclaim against the polynomial, and proof
   bytes equal across both chains, the plain path on the card and the
   host-transcript loop (timed beside them);
8. one JSON line of the kernels, then the last line
   `{"ok": true, "device": {...}}`.

Tolerance everywhere is 0: the field arithmetic is exact, so every check is
array- or byte-equality.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
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
    from sumcheck_tpu_torch.utils.config import get_config

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
            get_config().chain_impl = chain
            fs_rng = Blake2b512Rng.setup()
            with syncs_forbidden_in_chains():
                proof, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
            check(serialize_proof(proof).hex() == fx["proof_bytes"], f"{name} {chain}: proof bytes")
            check([format(r.v, "064x") for r in state.randomness] == fx["challenges"],
                  f"{name} {chain}: challenges")
            sub = MLSumcheck.verify(poly.info(), Fr(int(fx["asserted_sum"], 16)), proof)
            check(sub.expected_evaluation.v == int(fx["final_evaluation"], 16),
                  f"{name} {chain}: final evaluation")
            print(f"golden {name}, {chain} chain: proof bytes, challenges and final "
                  f"evaluation equal")
    get_config().chain_impl = "generic"


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
            "transcript_step": tc.transcript_step}


@contextlib.contextmanager
def syncs_forbidden_in_chains():
    """Run both chains' enqueue loops under the sync debug mode "error": a
    host sync inside a chain raises, so the prove's one fetch after the
    chain is its only sync. (The plain versions sync by design, so the
    plain path runs outside this.)"""
    from sumcheck_tpu_torch.protocol import device_prover, generic_prover

    def guarded(fn):
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    saved = device_prover.chain_rounds, generic_prover.chain_rounds_generic
    device_prover.chain_rounds = guarded(saved[0])
    generic_prover.chain_rounds_generic = guarded(saved[1])
    try:
        yield
    finally:
        device_prover.chain_rounds, generic_prover.chain_rounds_generic = saved


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


def headline_phase(device, seed: int, reps: int, chain: str, nv: int = NV) -> dict:
    """Phase 7: the nv=20 2x3 prove through the public entry points on one
    chain; returns its numbers and proof bytes."""
    from sumcheck_tpu_torch import Blake2b512Rng, MLSumcheck
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import init_pair, prove_chained
    from sumcheck_tpu_torch.protocol.generic_prover import prove_generic
    from sumcheck_tpu_torch.utils.config import get_config

    get_config().chain_impl = chain
    poly = headline_poly(seed, nv)
    info = poly.info()
    kernels = (("round_nofold", "round_fold") if chain == "generic"
               else ("round_step_nofold", "round_step_fold"))

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
    check(launches == want, f"{chain}: launch counts {launches} over {proves} proves, "
                            f"expected {want}")
    check(serialize_proof(again) == serialize_proof(proof), f"{chain}: warm proves differ")
    prove_s = statistics.median(walls)
    print(f"headline {chain} chain, prove nv={nv} 2x3: first {first_s:.4f} s (with table "
          f"upload), median of {reps} warm {prove_s:.4f} s, walls {[round(w, 4) for w in walls]}")
    print(f"{chain} launches over {proves} proves: "
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
                rc.round_fold(lo, hi, r, products, degree, half >> j)
        else:
            rc.round_step_nofold(lo, hi, products, degree)
            for _ in range(1, nv):
                (lo, hi), _s = rc.round_step_fold(lo, hi, r, products, degree)

    init_s = wall(lambda: init_pair(poly, device), device)
    kernels_s = wall(rounds_only, device)
    for f in counters().values():
        f.launches = 0
    print(f"{chain}: pair init {init_s:.4f} s; init + {nv} round kernels without transcript "
          f"{kernels_s:.4f} s; so transcript steps and the fetch {prove_s - kernels_s:.4f} s "
          f"of the {prove_s:.4f} s prove")

    s = MLSumcheck.extract_sum(proof)
    sub = MLSumcheck.verify(info, s, proof)
    vwalls = []
    for _ in range(21):
        t0 = time.perf_counter()
        MLSumcheck.verify(info, s, proof)
        vwalls.append(time.perf_counter() - t0)
    verify_s = statistics.median(vwalls)
    check(poly.evaluate(sub.point) == sub.expected_evaluation,
          f"{chain}: subclaim does not match the polynomial")
    fs_rng = Blake2b512Rng.setup()
    _, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
    check(state.randomness == sub.point, f"{chain}: prover randomness is not the subclaim point")
    print(f"{chain}: verify accepts; subclaim equals poly.evaluate(point) and the prover's "
          f"randomness; verify median {verify_s:.6f} s")

    # the plain path on the same card: plain round versions and plain transcript
    fs_rng = Blake2b512Rng.setup()
    fs_rng.feed(info)
    t0 = time.perf_counter()
    if chain == "generic":
        plain, _ = prove_generic(fs_rng, poly, device,
                                 round_fns=(rc.round_nofold_ref, rc.round_fold_ref),
                                 transcript_fn=tc.transcript_step_ref)
    else:
        plain, _ = prove_chained(fs_rng, poly, device,
                                 step_fns=(rc.round_step_nofold_ref, rc.round_step_fold_ref),
                                 transcript_fn=tc.transcript_step_ref)
    plain_s = time.perf_counter() - t0
    check(serialize_proof(plain) == serialize_proof(proof),
          f"{chain}: kernel proof differs from the plain path's")
    print(f"{chain}: plain-path proof on the same device: bytes equal ({plain_s:.4f} s)")
    return {"launches": launches, "prove_s": prove_s, "first_s": first_s, "init_s": init_s,
            "kernels_s": kernels_s, "verify_s": verify_s, "plain_s": plain_s,
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
    libs = cuda_build.build("round", "transcript")
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(lib.name for lib in libs.values())} in {build_s:.2f} s (in parallel)")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    stats = kernel_phase(device, args.seed)
    stats.update(step_kernel_phase(device, args.seed))
    stats.update(transcript_phase(device, args.seed))
    golden_phase(device)
    heads = {chain: headline_phase(device, args.seed, args.reps, chain)
             for chain in ("generic", "persize")}
    host = host_transcript_phase(device, args.seed, args.reps)
    check(heads["generic"]["proof"] == heads["persize"]["proof"] == host["proof"],
          "the two chains and the host-transcript loop prove different bytes")
    print(f"proof bytes equal: generic chain, per-size chain, plain paths, host-transcript loop; "
          f"prove medians generic {heads['generic']['prove_s']:.4f} s, per-size "
          f"{heads['persize']['prove_s']:.4f} s, host transcript {host['prove_s']:.4f} s")

    kernels = []
    for name, replaces, chain in (
        ("round_nofold", "sumcheck_tpu/ops/round_pallas.py:246", "generic"),
        ("round_fold", "sumcheck_tpu/ops/round_pallas.py:192", "generic"),
        ("round_step_nofold", "sumcheck_tpu/ops/round_pallas.py:103", "persize"),
        ("round_step_fold", "sumcheck_tpu/ops/round_pallas.py:85", "persize"),
        ("transcript_step", "sumcheck_tpu/protocol/device_prover.py:118", "persize"),
    ):
        err, timings = stats[name]
        main_shape = timings[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": ("sumcheck_tpu_torch/csrc/transcript.cu" if name == "transcript_step"
                       else "sumcheck_tpu_torch/csrc/round.cu"),
            "replaces": replaces,
            "launches": heads[chain]["launches"][name],
            "launches_by_path": {c: heads[c]["launches"][name] for c in heads},
            "max_abs_err": err,
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "shape": main_shape["shape"],
            "timings": timings,
        })
    print(f"card: {card}; prove median generic {heads['generic']['prove_s']:.4f} s, "
          f"per-size {heads['persize']['prove_s']:.4f} s; build {build_s:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
