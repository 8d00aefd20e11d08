#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`sumcheck_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--reps N]

Run from the root of a checkout. Phases, each printed on its own lines; any
failure raises and exits non-zero without the final line:

1. the card's name and power limit (`nvidia-smi`); no CUDA device -> exit 1;
2. build the round kernels from `sumcheck_tpu_torch/csrc/round.cu`;
3. each kernel against its plain PyTorch version on the card, array-equal,
   at the round shapes of the nv=20 2x3 prove and at ragged extents, with
   kernel and plain times;
4. the golden fixtures `tests/fixtures/ml_nv6_rich.json` and
   `ml_nv14_config1.json` through `device="cuda"`;
5. the headline: `MLSumcheck.prove` on 2 products x 3 multiplicands at
   nv=20 (tables from `numpy.random.default_rng(seed)`), one warm-up and the
   median of `--reps` warm proves, launch counts, verify, the subclaim
   against the polynomial, and proof bytes equal to the plain path on the
   card;
6. one JSON line of the kernels, then the last line
   `{"ok": true, "device": {...}}`.

Tolerance everywhere is 0: the field arithmetic is exact, so every check is
array- or byte-equality.
"""

from __future__ import annotations

import argparse
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
    """Phase 3: every round shape of the path, kernel against plain."""
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


def golden_table(prefix: str, tag: str, nv: int, P: int) -> list[int]:
    """The fixtures' documented table rule (`tests/test_golden.py:54-61`)."""
    out = []
    for i in range(1 << nv):
        h = hashlib.blake2b(f"sumcheck-golden/{prefix}/{tag}/{i}".encode(), digest_size=32)
        out.append(int.from_bytes(h.digest(), "little") % P)
    return out


def golden_phase(device) -> None:
    """Phase 4: the ML golden fixtures through `device`."""
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
        fs_rng = Blake2b512Rng.setup()
        proof, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
        check(serialize_proof(proof).hex() == fx["proof_bytes"], f"{name}: proof bytes")
        check([format(r.v, "064x") for r in state.randomness] == fx["challenges"],
              f"{name}: challenges")
        sub = MLSumcheck.verify(poly.info(), Fr(int(fx["asserted_sum"], 16)), proof)
        check(sub.expected_evaluation.v == int(fx["final_evaluation"], 16),
              f"{name}: final evaluation")
        print(f"golden {name}: proof bytes, challenges and final evaluation equal")


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


def headline_phase(device, seed: int, reps: int, nv: int = NV) -> dict:
    """Phase 5: the nv=20 2x3 prove through the public entry points."""
    from sumcheck_tpu_torch import Blake2b512Rng, MLSumcheck
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.protocol.device_prover import init_pair
    from sumcheck_tpu_torch.protocol.generic_prover import prove_generic

    poly = headline_poly(seed, nv)
    info = poly.info()

    rc.round_nofold.launches = 0
    rc.round_fold.launches = 0
    t0 = time.perf_counter()
    proof = MLSumcheck.prove(poly, device=device)
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        again = MLSumcheck.prove(poly, device=device)
        walls.append(time.perf_counter() - t0)
    launches = {"round_nofold": rc.round_nofold.launches, "round_fold": rc.round_fold.launches}
    proves = reps + 1
    check(launches == {"round_nofold": proves, "round_fold": proves * (nv - 1)},
          f"launch counts {launches} over {proves} proves, expected 1 + {nv - 1} each")
    check(serialize_proof(again) == serialize_proof(proof), "warm proves differ")
    prove_s = statistics.median(walls)
    print(f"headline prove nv={nv} 2x3: first {first_s:.4f} s (with table upload), "
          f"median of {reps} warm {prove_s:.4f} s, walls {[round(w, 4) for w in walls]}")
    print(f"launches over {proves} proves: {launches}")

    # where the prove's time goes: the pair init alone, and init plus every
    # round enqueued back to back with no transcript and no per-round sync
    def init_only():
        init_pair(poly, device)

    def rounds_nosync():
        lo, hi, products, degree = init_pair(poly, device)
        r = torch.from_numpy(L.mont_scalar(12345)[:, 0].astype(np.int32)).to(device)
        half = lo.shape[2]
        rc.round_nofold(lo, hi, products, degree, half)
        for j in range(1, nv):
            rc.round_fold(lo, hi, r, products, degree, half >> j)

    def wall(fn) -> float:
        out = []
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    init_s = wall(init_only)
    nosync_s = wall(rounds_nosync)
    print(f"pair init {init_s:.4f} s; init + {nv} rounds without transcript "
          f"{nosync_s:.4f} s; host transcript and per-round syncs "
          f"{prove_s - nosync_s:.4f} s of the {prove_s:.4f} s prove")

    s = MLSumcheck.extract_sum(proof)
    sub = MLSumcheck.verify(info, s, proof)
    vwalls = []
    for _ in range(21):
        t0 = time.perf_counter()
        MLSumcheck.verify(info, s, proof)
        vwalls.append(time.perf_counter() - t0)
    verify_s = statistics.median(vwalls)
    check(poly.evaluate(sub.point) == sub.expected_evaluation,
          "subclaim does not match the polynomial")
    print(f"verify accepts; subclaim equals poly.evaluate(point); verify median {verify_s:.6f} s")

    fs_rng = Blake2b512Rng.setup()
    fs_rng.feed(info)
    t0 = time.perf_counter()
    plain, _ = prove_generic(fs_rng, poly, device,
                             round_fns=(rc.round_nofold_ref, rc.round_fold_ref))
    plain_s = time.perf_counter() - t0
    check(serialize_proof(plain) == serialize_proof(proof),
          "kernel proof differs from the plain path's")
    print(f"plain-path proof on the same device: bytes equal ({plain_s:.4f} s)")
    return {"launches": launches, "prove_s": prove_s, "verify_s": verify_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sumcheck_tpu_torch.ops import round_cuda as rc

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = rc.build()
    build_s = time.perf_counter() - t0
    print(f"build: {lib.name} in {build_s:.2f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "round_kernel" in line:
                print(f"  ptxas: {line.strip()}")

    stats = kernel_phase(device, args.seed)
    golden_phase(device)
    head = headline_phase(device, args.seed, args.reps)

    kernels = []
    for name, line in (("round_nofold", 246), ("round_fold", 192)):
        err, timings = stats[name]
        main_shape = timings[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "sumcheck_tpu_torch/csrc/round.cu",
            "replaces": f"sumcheck_tpu/ops/round_pallas.py:{line}",
            "launches": head["launches"][name],
            "max_abs_err": err,
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "shape": main_shape["shape"],
            "timings": timings,
        })
    print(f"card: {card}; prove median {head['prove_s']:.4f} s; build {build_s:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
