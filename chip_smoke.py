#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`sumcheck_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--reps N]

Run from the root of a checkout. Phases, each printed on its own lines; any
failure raises and exits non-zero without the final line:

1. the card's name and power limit (`nvidia-smi`); no CUDA device -> exit 1;
2. build the six kernel sources, `sumcheck_tpu_torch/csrc/round.cu`,
   `csrc/transcript.cu`, `csrc/round_mxu.cu`, `csrc/pair_init.cu`,
   `csrc/fold_staged.cu` (the fold body's yardstick, phase 6e) and
   `csrc/gkr_init.cu` (the GKR phase inits' kernels), one
   `nvcc` each, started together; print each kernel's registers, shared memory, stack frame and
   spills from the ptxas logs, and the SASS instruction mix of the
   transcript and round kernels (`cuobjdump`, where the toolkit has it);
   the main path's instantiations held to their ptxas numbers before the
   wide route (`MAIN_PATH_PTXAS`);
3. the generic chain's round kernels against their plain PyTorch versions
   on the card, array-equal, at the round shapes of the nv=20 2x3 prove and
   at ragged extents, with kernel and plain times; the fold at A2=2^18
   beside its bytes per second, its bound and the previous version's time;
4. the per-size chain's round kernels against their plain versions at the
   nv=20 shapes (round 0 over 2^19 lanes; folds into 2^18, 2^10, 3 and 1
   lanes; one case with coefficients), with kernel and plain times;
5. the MXU fold kernel `round_fold_mxu` (tensor-core banded multiply)
   against its plain version and against the CIOS fold kernel `round_fold`,
   array-equal, at the nv=20 fold shapes (extents 2^18, 2^10, 37, 3, 1 and
   a ragged 2^9 + 5) and the GKR dim-18 shape (U=2, d=2, extent 2^16), with
   kernel, plain and CIOS-kernel times and the bound at each shape beside
   both kernels' shares of it; then `ops/mxu_mul.py`'s banded multiply
   (float32 matmuls) against the CIOS multiply at 2^17 lanes, and (5c) the
   field's two multiplies, even/odd and CIOS, against Python integers, their
   rates and the SASS instructions of one multiply each;
6. the transcript kernel against the plain transcript and the host rng
   over 60 rounds that reject draws (the attempts a draw took and the
   kernel's stream compactions counted), with kernel and plain times, and the
   step's latency bound: the compressions this run's rounds needed, times
   the depth of one compression, times the card's dependent-issue latency
   (measured by a chain of dependent instructions), plus the launch floor
   (an empty kernel back to back); and one compression's clocks on the
   kernel's four hash lanes, checked against the host's Blake2b core;
6b. the pair-init kernel against its plain version at the ML nv=20 2x3
   shape, the cached tables untouched, with its bound;
6c. the batched round kernels (instance axis) against their plain versions
   at the 8 x nv=16 2x3 shapes, each beside 8 single launches of the same
   work; 6d. the batched transcript step over 8 transcripts of unequal
   pending bytes against its plain version and the host rngs, beside 8
   single steps, with its latency bound; 6e. the two kernels redesigned
   for Hopper, `round_fold` and `pair_init`, each against the variant it
   did not take (the stripes staged by cp.async; one lane a thread), in
   turns, with ptxas registers, stack and blocks per multiprocessor;
6f. fault F4, each kernel's wide route (past the by-value plan's 16
   slots, 16 products, 8 factors or degree 8) against its plain version:
   round 0, the in-place fold, the per-size round 0 and fold, the MXU fold
   and the pair init at F4 (a) nv=20 (17 slots), (b), (c) at nv=18
   (degree 9; 17 products) and `wide` at nv=14 (degree 20 in two chunks of
   the evaluation's 12 points, 40 products padded with the ones slot), the
   transcript step at degrees 9 and 20, with device ms and bounds (the
   register schedule's multiplies on each product's real factors); and
   fault F6, the transcript step past degree 8 in its fixed window of
   the stream: single and batched (two transcripts of 40 and 128 pending
   bytes) at degree 8,000, one launch each, array-equal to the plain
   versions (run on the host's CPU by a process of this script,
   `--plain-f6`, started with the build) and to the host rngs, with device
   ms and latency bound;
6g. the batched wide route: round 0, both folds and the transcript step at
   4 x F4 (b) nv=16 against their plain versions, beside 4 single launches;
7. the golden fixtures `tests/fixtures/ml_nv6_rich.json`,
   `ml_nv14_config1.json` and `gkr_dim5.json` through `device="cuda"` on
   both chains and in the MXU fold mode;
8. the ML headlines: `MLSumcheck.prove` on 2 products x 3 multiplicands at
   nv=20 (tables from `numpy.random.default_rng(seed)`) on the generic
   chain, the per-size chain (`SUMCHECK_TPU_CHAIN_IMPL=persize`) and the
   generic chain in the MXU fold mode (`SUMCHECK_TPU_MXU_FOLD=kernel`,
   `SUMCHECK_TPU_AB=1`): one first prove and the median of `--reps` warm
   proves each, launch counts per prove (one pair init, 1 + 19 round
   kernels and 20 transcript steps), the kernels of one chain counted by `torch.profiler`
   (two per round, plus the zero fill of its sums buffer), the chain
   enqueued under
   `torch.cuda.set_sync_debug_mode("error")` so that a host sync inside it
   fails the run, verify, the subclaim against the polynomial, and proof
   bytes equal across the three, the plain path on the card and the
   host-transcript loop (timed beside them);
9a. the GKR phase-init kernels (`ops/gkr_init_cuda.py`: `weight_reduce`,
   one launch a phase: eq's half tables built in its blocks, the weight
   fold, the segment sums into slot 0 and the pair's slot 1;
   `finish_sums`, the whole table and a sharded rank's block of the
   (S, 8, n / S) rank-major raw sums into its dealt pair with its slot 1,
   in both phases' forms at S = 2 and 4; `pair_slots` in the forms
   of `prep1`, `final_fold` and `prep2`, which no prover path launches)
   against their plain versions on the card,
   array-equal, at the dim-18 shapes of phase 9's instance (phase 1's and
   phase 2's inits, strict and as a rank's raw sums) and on the same
   instance with one x segment of 2^16 + 1 entries (cut into chunks across
   blocks), with device ms (each launch after an L2 flush), bound, share
   and plain ms; both phase inits on the kernels against the torch-op
   plain versions of the phases (`gkr_init.phase1_pair_ref`,
   `phase2_pair_ref`) on the card, strict and, as a sharded rank's pair at
   S = 2, against their deal, on both
   instances and at dim 21 (the largest build in the blocks, and the
   largest dim whose f1 indices fit int64), with their walls;
9b. the batched weight reduce (one launch a phase for the 8 x dim 14 GKR
   batch, grid y = instance) against 8 single launches and the plain
   version, flushed, also with a skewed instance whose tile plan differs;
9. the GKR headlines: `GKRRoundSumcheck.prove` at dim 18 on the bench's
   instance (`bench.py:187-194`) on the same three paths: first prove and
   warm median, launch counts per prove (2 + 34 round kernels, 36
   transcript steps and the phase inits' kernels: 2 on every path, one
   fused launch a phase; the profiler's count
   of round, transcript and init kernels in one prove and its idle share),
   everything between the uploads and the one fetch under the sync debug
   mode "error", the phase inits and the round kernels timed alone, one verify and the subclaim in Python integers
   (`subclaim_in_integers`; `verify_subclaim` runs at dim 14, in the GKR
   batch), and proof bytes equal across the three and the plain path on the
   card;
10. the batch headlines: `batch.BatchedMLSumcheck.prove` on 8 x nv=16 2x3
   (`bench.py:302-310`) on both chains and `BatchedGKRRoundSumcheck.prove`
   on 8 x dim 14 (`bench.py:313-338`): first prove, warm median per batch
   and per proof, launches per batch (the pair inits, then two a round for
   all 8), the batched chains under the sync debug mode "error", proofs
   byte-equal to per-instance card proves (timed beside them), all
   verified, two subclaims, the ML batches' idle share; the GKR batch's 2
   init launches a batch and its wall in turns against the parent's
   per-instance loop (`parent_enqueue_gkr`, 16 init launches); fault F5,
   `GKRRoundSumcheck.prove` with an f1 of no entries at dim 1 and 14 on
   the three paths (launches counted from 0, the enqueue under the sync
   debug mode "error"), bytes equal to the same prove's plain path on the
   card and to the CPU's, sum 0, verified, the subclaim holding, and a
   batch of two such instances at dim 14 against their single proves;
10f. fault F4's structures (a), (b), (c) proved at nv=20 and `wide` at
   nv=18 on the generic, per-size and MXU chains, each run's launches
   counted from 0 (no host fallback) under the sync debug mode "error",
   bytes equal across the chains, each verified, and at nv=12 (`wide`: 8)
   equal to the CPU's plain prove;
   10g. 4 x F4 (b) at nv=16 on both batched chains, equal to per-instance
   card proves; fault F6, one product of 7,300 repeats of one table at
   nv=2 (degree 7,300) on the generic chain, launches counted from 0,
   bytes equal to the host-transcript loop's on the card, verified;
10b. the interactive tier on the phase-8 instance: `IPForMLSumcheck.
   prover_init(device="cuda")` and 20 `prove_round` / `sample_round` over a
   live `Blake2b512Rng`: launches, syncs per prove (its `finish_sums`
   calls, one a round; each round's enqueue under the sync debug mode
   "error"), first and warm walls, proof, final transcript and final tables
   equal to the generic chain's;
10c. the GKR host-transcript branch: the phase-9 prove over a transcript
   pre-fed `b"abc"` (3 pending bytes, which the device chain cannot lift):
   launches (no transcript step), one sync a round, walls beside the
   aligned transcript's chained prove, verify and the subclaim in Python
   integers, and at dim 14 bytes equal to the plain round versions' on the
   card;
10d. the engine variables (`sumcheck_tpu_torch/utils/config.py`): a child
   process that imports the port under ``SUMCHECK_TPU_CHAINED=off`` stops
   with `SumcheckError` naming the variable, and `check_engine_variables`
   refuses the other values the port does not honour and takes the rest;
10e. fault F3: 0 x [t0, t1, t2] + c x [t3, t4, t5] at nv=20 through
   `IPForMLSumcheck` on the card (the zero product's copy slot): launches,
   20 syncs, proof and final transcript equal to the chained prove's; the
   same state on the CPU (the plain versions) in step for rounds 0-5: the
   pair-init kernel's pair (copy slot zero, tables kept), every message,
   and `flattened_ml_extensions` after rounds 0, 1 and 5 equal;
11. the multi-device provers (`sumcheck_tpu_torch/parallel/`): for S = 2
   and 4, one `torch.multiprocessing.spawn` of S ranks in a gloo group, all
   on the one card (`shard_device`), each running the sharded ML nv=20 2x3
   prove (`ChainedShardedProver.auto(S)`, the phase-8 instance; proof and
   final transcript), the sharded GKR dim-18 prove
   (`ShardedGKRProver.auto(S)`, phase 9's; `.auto(2 S)` of both raises),
   the sharded batch 8 x nv=16 (`BatchedMLSumcheck.prove(..., group=)`,
   phase 10's) and `ShardedProver` (the transcript on the host)
   on the ML instance over a fresh and over the `b"abc"` transcript, through
   the public entry points, each byte-equal to the single-card proofs of
   phases 8-10b on every rank, with the median of
   warm walls, launches a rank, all-reduces and bytes per prove, the GKR
   inits' reduce-scatters with the bytes each rank sends and receives, the
   inits split into compute and reduce-scatter seconds, beside the
   all-reduce of the same sums (off the prover path) (gloo takes the
   card's tensors itself, through the host); where the machine has S
   cards, again in an NCCL group, one rank a card, the chains under the
   sync debug mode "error" (otherwise one line says why not). The kernels
   are built before the spawn, so no rank compiles; a rank's failure exits
   non-zero. S ranks on one card say nothing about speed across cards;
11b. the entry points (`sumcheck_tpu_torch/entry.py`): `entry()` on the
   card against `entry(device="cpu")` on the same inputs, folded tables and
   sums equal, one `round_fold` launch; 11c. `dryrun_multichip(2)` on the
   card (gloo, both ranks on card 0; NCCL where the machine has two cards):
   on every rank `ShardedProver` = `ChainedShardedProver` = the single
   card's host-transcript prove, the sharded GKR prove at an odd nonzero
   count = the single card's, the sharded batch = each instance's prove,
   and the proofs equal to the same dry run's on the CPU; 11d. the
   microbench (`python -m sumcheck_tpu_torch.microbench 18`, in a process
   of its own) at the GKR dim-18 shape,
   each probe checked against its plain or NumPy value (the GKR init
   kernels' probes against their plain versions), and the stage profile
   of phase 9's chained GKR prove: device ms, host wall, launches, the
   kernels by wrapper and bound of each probe and stage, one line each
   (the full prove's init kernels checked: 2), and the report as a JSON
   line before the kernels line;
12. the verify walls of the ML and GKR headline proofs with the C core
   (`sumcheck_tpu_torch/native/`) and with the Python loop
   (`SUMCHECK_TPU_NATIVE=off`), same subclaims; then `utils/sol.
   measure_roofline` on this card (even/odd Montgomery multiplies a second,
   HBM bytes a second from a 1 GiB copy) and the speed-of-light share
   `pct_sol` of the ML nv=20 and GKR dim-18 generic proves, as `bench.py`
   reports it;
13. the second field: a child process, `SUMCHECK_TPU_FIELD=bn254_fr
   python3 chip_smoke.py --field-phase` (its lines marked `[bn254_fr]`; a
   failure there fails the run), which reruns under BN254 Fr, at the same
   sizes and with the libraries already built: phases 3-5c, 6b-6d and 9a,
   the fixture `tests/fixtures/bn254_torch.json` on every path, the ML, GKR
   (with the init kernels' launches) and batch proves (byte-equal across
   paths and to per-instance proves;
   the GKR subclaim at dim 14, in the batch, not 18), phases 10b and 10c
   (without the dim-14 plain check), the sharded ML prove and `ShardedProver`
   with 2 gloo ranks against their single-card proofs, the roofline and
   `pct_sol`, and phase 6 over 320
   rounds with the attempts a draw took and the stream compactions counted
   (it fails if none fired), the plain transcript running meanwhile on the
   host's CPU (`--plain-transcript`); then each kernel's time and each
   wall beside BLS12-381's;
14. the microbench's JSON line, then one JSON line of the kernels (each
   with its time at the main path's shape, its bound there and what sets
   it, its launches on the main path and on every path in
   `launches_by_path`, phase 11b and each sharded prove of phase 11c among
   them (the microbench reports its launches a call itself), `library_ms`
   null: no PyTorch call computes these functions, and its BN254 time,
   bound and error), then the last line `{"ok": true, "device": {...}}`.

Kernel times are device times: `torch.cuda._sleep` holds the stream while
the launches are enqueued, so the events time the kernels back to back and
not the host's enqueue. Tolerance everywhere is 0: the field arithmetic is
exact, so every check is array- or byte-equality.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
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
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core peak
ELEMENT_BYTES = 32  # an element: 255 or 254 bits in 8 32-bit limbs, as the kernels hold it
# 32-bit multiplies in one 8-limb CIOS Montgomery multiply: 64 + 64
# 32x32->64-bit products (a*b and m*p), two 32-bit multiplies each (low
# and high word), and 8 for m = t0 * ninv
IMADS_PER_MONT_MUL = 2 * 2 * 64 + 8
# the dependent depth of one Blake2b compression: 12 rounds of two G levels
# (four G in parallel each), one G a chain of 15 dependent 32-bit
# instructions (four 64-bit adds of two each, carry then high word; the
# xor of the rotate by 32, one; three xor-and-rotates of two each)
G_LEVELS = 24
G_DEPTH = 15
# each kernel's time at its main shape before its current version (PERF.md,
# section 6, in parentheses; an H100 80GB HBM3 at 700 W), quoted in the
# printed lines beside this run's; not part of the kernels line
PREVIOUS_MS = {"round_nofold": 0.3551, "round_fold": 0.3630, "round_step_nofold": 0.3547,
               "round_step_fold": 0.3496, "round_fold_mxu": 0.0954, "transcript_step": 0.0151,
               # phase 1's init as three launches (eq_halves, weight_reduce, pair_slots)
               "weight_reduce": 0.0640}


RATES: dict = {}  # the card's SM count, clock and IMAD rate (`microbench.card_rates`)
# the main path's instantiations, by a piece of their mangled names, and
# their ptxas (registers, stack frame, spill stores, static shared memory)
# on the tree before the wide route (`python tools/ptxas_compare.py
# <parent> <change>` on an H100, sm_90a, CUDA 12.8; equal for every kernel
# both trees have): the wide route leaves them as they were (the by-value
# MXU fold is `fold_mxu_kernel` since its wide body became a kernel of its
# own, `fold_mxu_wide_kernel`)
MAIN_PATH_PTXAS = {"round_nofold: nofold_kernel<3, no coefficients>": "13nofold_kernelILi3ELb0E",
                   "round_fold: fold_kernel<3, in place, single>": "11fold_kernelILi3ELb0ELb0ELb0E",
                   "round_step_fold: fold_kernel<3, out of place, single>":
                       "11fold_kernelILi3ELb1ELb0ELb0E",
                   "round_fold_batched: fold_kernel<3, in place, batched>":
                       "11fold_kernelILi3ELb0ELb0ELb1E",
                   "transcript_step: transcript_kernel<static stream>": "17transcript_kernelILb0E",
                   "round_fold_mxu: fold_mxu_kernel<plan>": "15fold_mxu_kernelEP",
                   "pair_init: pair_init_kernel<4 lanes>": "16pair_init_kernelILi4E",
                   "weight_reduce: weight_reduce_kernel<phase 1>": "20weight_reduce_kernelILb1E",
                   "weight_reduce: weight_reduce_kernel<phase 2>": "20weight_reduce_kernelILb0E"}
PREVIOUS_PTXAS = {"round_nofold: nofold_kernel<3, no coefficients>": (128, 0, 0, 2304),
                  "round_fold: fold_kernel<3, in place, single>": (126, 0, 0, 2304),
                  "round_step_fold: fold_kernel<3, out of place, single>": (126, 0, 0, 2304),
                  "round_fold_batched: fold_kernel<3, in place, batched>": (126, 0, 0, 2304),
                  "transcript_step: transcript_kernel<static stream>": (56, 0, 0, 1216),
                  "round_fold_mxu: fold_mxu_kernel<plan>": (92, 0, 0, 7936),
                  "pair_init: pair_init_kernel<4 lanes>": (84, 0, 0, 0),
                  "weight_reduce: weight_reduce_kernel<phase 1>": (64, 0, 0, 2592),
                  "weight_reduce: weight_reduce_kernel<phase 2>": (64, 0, 0, 2592)}


def eval_multiplies(products, degree: int, coeffs: bool) -> int:
    """Montgomery multiplies of one lane's evaluation at t = 0..d, the least
    any of the port's bodies needs for the same sums, at every degree: the
    register schedule (`register_sums`, and the wide route's
    `wide_block_sums` where one chunk holds the d + 1 points) on each
    product's real factors (`round_cuda.product_lengths`: a `Products`'
    padding slot, the constant one, takes no multiply). A product of L
    factors multiplies factor l at t = 0..min(l+1, d), l = 1..L-1, the rest
    by differences, and a coefficient 2."""
    from sumcheck_tpu_torch.ops.round_cuda import product_lengths

    return sum(sum(min(l + 1, degree) + 1 for l in range(1, f)) + (2 if coeffs else 0)
               for f in product_lengths(products))


def round_work(lanes, slots, products, degree, fold, coeffs=False, mma=False) -> dict:
    """What a round kernel must do at one shape: bytes (each input stripe
    read once, each output stripe written once: 8 limbs x 4 bytes per lane
    and slot), 32-bit multiplies of its Montgomery multiplies (2 per
    slot for a fold, and the evaluation's `eval_multiplies`: the least any
    body of the function needs, for every kernel of the function, the MXU
    fold too), and, for the MXU fold, the
    int8 tensor-core operations of its fold multiplies (4 mma.m16n8k32 per
    16 lanes each) in place of their IMADs, plus the 32 Montgomery
    multiplies of each 128-lane block's byte matrix."""
    stripe = ELEMENT_BYTES * lanes * slots
    evals = eval_multiplies(products, degree, coeffs)
    folds = 2 * slots if fold else 0
    matrix = 32 * -(-lanes // 128) if mma else 0
    return {"bytes": stripe * (6 if fold else 2),
            "imads": ((evals + (0 if mma else folds)) * lanes + matrix) * IMADS_PER_MONT_MUL,
            "int8_ops": folds * 4 * 16 * 8 * 32 * 2 // 16 * lanes if mma else 0}


def bound_of(work: dict) -> tuple[float, str, str]:
    """(bound ms, bound_by, what sets it): the larger of the bytes the
    function must move at the card's memory rate and the operations at its
    peak rate for their type. `work["bytes"]` counts 32 B an element
    (`ELEMENT_BYTES`), what the kernels move and the function needs."""
    from sumcheck_tpu_torch.microbench import HBM_BYTES_PER_S

    mem_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
    op_ms = (work["imads"] / RATES["imad_per_s"] + work["int8_ops"] / INT8_OPS_PER_S) * 1e3
    return (mem_ms, "bytes", "memory") if mem_ms >= op_ms else (op_ms, "operations", "int")


def max_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest absolute difference of two integer tensors, in int64 (a
    difference of two int32 limb words can pass 2^31)."""
    return int((a.long() - b.long()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def random_pair(rng, slots: int, half: int, device):
    """A random (lo, hi) pair of `slots` tables of 2 * half lanes, (slots,
    8, half) int32 limbs."""
    from sumcheck_tpu_torch.fields.limbs_np import pack_limbs, random_tables

    stacked = pack_limbs(np.stack(random_tables(rng, half.bit_length(), slots)), axis=1)
    lo = torch.from_numpy(np.ascontiguousarray(stacked[:, :, :half])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(stacked[:, :, half:])).to(device)
    return lo, hi


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device, device_only: bool = False, warm: bool = True,
            cold_l2: bool = False) -> float:
    """Mean time of `fn()` over `reps` runs, after one warm-up. On the card
    CUDA events time it; with `device_only` the stream first sleeps long
    enough for all `reps` launches to be enqueued, so the events see the
    kernels back to back and not the host's enqueue (for functions that do
    not sync; `microbench.held_ms`), and with `cold_l2` as well each run
    alone after the L2 is flushed (`microbench.flushed_ms`)."""
    from sumcheck_tpu_torch.microbench import flushed_ms, held_ms

    if warm:
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    if device_only and cold_l2:
        return flushed_ms(fn, reps, 0.005 + 0.0005 * reps)[0]
    if device_only:
        return held_ms(fn, reps, 0.005 + 0.0002 * reps)[0]  # about 5 ms + 0.2 ms a launch
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_round(rc, name, lo, hi, r, products, degree, extent, device, timed):
    """One kernel-vs-plain case; returns (max_abs_err, kernel ms, plain ms).
    The kernel's time is device time, into a preallocated sums row."""
    fold = r is not None
    row = torch.zeros((degree + 1, 16), dtype=torch.int64, device=device)
    lo_k, hi_k, lo_p, hi_p = lo.clone(), hi.clone(), lo.clone(), hi.clone()
    if fold:
        got = rc.round_fold(lo_k, hi_k, r, products, degree, extent)
        want = rc.round_fold_ref(lo_p, hi_p, r, products, degree, extent)
    else:
        got = rc.round_nofold(lo_k, hi_k, products, degree, extent)
        want = rc.round_nofold_ref(lo_p, hi_p, products, degree, extent)
    sync(device)
    err = max_diff(got, want)
    err = max(err, max_diff(lo_k, lo_p), max_diff(hi_k, hi_p))
    check(err == 0, f"{name}: kernel differs from plain by {err}")
    check((rc.finish_sums(got) == rc.finish_sums(want)).all(), f"{name}: wide sums differ")
    if fold:  # lanes past the extent stay as they were
        check(torch.equal(lo_k[:, :, extent:], lo[:, :, extent:])
              and torch.equal(hi_k[:, :, extent:], hi[:, :, extent:]),
              f"{name}: kernel wrote past the extent")
    ms = plain_ms = None
    if timed:
        if fold:
            ms = time_ms(lambda: rc.round_fold(lo_k, hi_k, r, products, degree, extent, row),
                         KERNEL_REPS, device, device_only=True)
            plain_ms = time_ms(lambda: rc.round_fold_ref(lo_p, hi_p, r, products, degree, extent),
                               PLAIN_REPS, device)
        else:
            ms = time_ms(lambda: rc.round_nofold(lo_k, hi_k, products, degree, extent, row),
                         KERNEL_REPS, device, device_only=True)
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
    from sumcheck_tpu_torch.microbench import HBM_BYTES_PER_S
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

    def record(kernel, name, res, work=None):
        err, ms, plain_ms = res
        stats[kernel][0] = max(stats[kernel][0], err)
        if ms is not None:
            stats[kernel][1].append({"shape": name, "ms": ms, "plain_ms": plain_ms,
                                     "work": work})

    record("round_nofold", f"round 0 nv={nv} U=6 H=2^{nv - 1} d=3",
           compare_round(rc, f"round 0 (H=2^{nv - 1})", lo, hi, None, products, 3,
                         half, device, True),
           round_work(half, SLOTS, products, 3, False))
    work = round_work(half // 2, SLOTS, products, 3, True)
    record("round_fold", f"fold A2=2^{nv - 2}",
           compare_round(rc, f"fold A2=2^{nv - 2}", lo, hi, r, products, 3,
                         half // 2, device, True), work)
    if RATES:
        ms = stats["round_fold"][1][-1]["ms"]
        bound_ms, bound_by, _ = bound_of(work)
        print(f"round_fold A2=2^{nv - 2} (U=6, d=3): {ms:.4f} ms, {work['bytes'] / ms / 1e9:.3f} "
              f"TB/s of {HBM_BYTES_PER_S / 1e12} TB/s; bound {bound_ms:.4f} ms by {bound_by} "
              f"({work['bytes'] / 1e6:.1f} MB at 32 B an element; "
              f"{work['imads'] / 1e9:.3f}e9 32-bit multiplies at "
              f"{RATES['imad_per_s'] / 1e12:.2f}e12/s), {bound_ms / ms:.1%} of it; "
              f"previous version (PERF.md): {PREVIOUS_MS['round_fold']} ms")
    for a2 in (1, 3, 37, (1 << 9) + 5):
        record("round_fold", f"fold A2={a2}",
               compare_round(rc, f"fold A2={a2}", lo, hi, r, products, 3, a2,
                             device, True), round_work(a2, SLOTS, products, 3, True))

    # ragged: products of lengths 3 and 2 sharing a table -> a ones slot and
    # a scaled copy of the shared table, built by init_pair on the device
    nv_r = 10
    tabs = L.random_tables(rng, nv_r, 4)
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
    """One per-size kernel-vs-plain case, timed (the kernel's device time,
    into a preallocated row); returns (err, ms, plain_ms)."""
    fold = r is not None
    row = torch.zeros((degree + 1, 16), dtype=torch.int64, device=device)
    if fold:
        (glo, ghi), got = rc.round_step_fold(lo, hi, r, products, degree, coeffs)
        (wlo, whi), want = rc.round_step_fold_ref(lo, hi, r, products, degree, coeffs)
    else:
        got = rc.round_step_nofold(lo, hi, products, degree, coeffs)
        want = rc.round_step_nofold_ref(lo, hi, products, degree, coeffs)
    sync(device)
    err = max_diff(got, want)
    if fold:
        check(glo.shape == (lo.shape[0], 8, lo.shape[2] // 2), f"{name}: folded shape {glo.shape}")
        err = max(err, max_diff(glo, wlo), max_diff(ghi, whi))
    check(err == 0, f"{name}: kernel differs from plain by {err}")
    if fold:
        ms = time_ms(lambda: rc.round_step_fold(lo, hi, r, products, degree, coeffs, row),
                     KERNEL_REPS, device, device_only=True)
        plain_ms = time_ms(lambda: rc.round_step_fold_ref(lo, hi, r, products, degree, coeffs),
                           PLAIN_REPS, device)
    else:
        ms = time_ms(lambda: rc.round_step_nofold(lo, hi, products, degree, coeffs, row),
                     KERNEL_REPS, device, device_only=True)
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

    def record(kernel, name, res, work):
        err, ms, plain_ms = res
        stats[kernel][0] = max(stats[kernel][0], err)
        stats[kernel][1].append({"shape": name, "ms": ms, "plain_ms": plain_ms, "work": work})

    name = f"round 0 nv={nv} U=6 H=2^{nv - 1} d=3"
    record("round_step_nofold", name,
           compare_step(rc, f"per-size {name}", lo, hi, None, products, 3, None, device),
           round_work(half, SLOTS, products, 3, False))
    for quarter in (half // 2, 1 << 10, 3, 1):
        qname = f"2^{quarter.bit_length() - 1}" if quarter > 3 else str(quarter)
        name = f"fold H={2 * quarter} -> {qname}"
        w = 2 * quarter
        slo, shi = lo[:, :, :w].contiguous(), hi[:, :, :w].contiguous()
        record("round_step_fold", name,
               compare_step(rc, f"per-size {name}", slo, shi, r, products, 3, None, device),
               round_work(quarter, SLOTS, products, 3, True))
    record("round_step_fold", f"fold H=2^{nv - 1} with coefficients",
           compare_step(rc, f"per-size fold H=2^{nv - 1} with coefficients", lo, hi, r,
                        products, 3, coeffs, device),
           round_work(half // 2, SLOTS, products, 3, True, coeffs=True))
    record("round_step_nofold", "round 0 with coefficients",
           compare_step(rc, "per-size round 0 with coefficients", lo[:, :, :1 << 10].contiguous(),
                        hi[:, :, :1 << 10].contiguous(), None, products, 3, coeffs, device),
           round_work(1 << 10, SLOTS, products, 3, False, coeffs=True))
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
        err = max(err, max_diff(got, sums), max_diff(lo_k, lo_c),
                  max_diff(hi_k, hi_c))
    check(err == 0, f"{name}: MXU fold kernel differs from its plain version or round_fold "
                    f"by {err}")
    check(torch.equal(lo_k[:, :, extent:], lo[:, :, extent:])
          and torch.equal(hi_k[:, :, extent:], hi[:, :, extent:]),
          f"{name}: MXU fold kernel wrote past the extent")
    row = torch.zeros((degree + 1, 16), dtype=torch.int64, device=device)
    ms = time_ms(lambda: rc.round_fold_mxu(lo_k, hi_k, r, products, degree, extent, row),
                 KERNEL_REPS, device, device_only=True)
    plain_ms = time_ms(lambda: rc.round_fold_mxu_ref(lo_k, hi_k, r, products, degree, extent),
                       PLAIN_REPS, device)
    cios_ms = time_ms(lambda: rc.round_fold(lo_k, hi_k, r, products, degree, extent, row),
                      KERNEL_REPS, device, device_only=True)
    bound = ""
    if RATES:
        bound_ms, bound_by, _ = bound_of(round_work(extent, lo.shape[0], products, degree, True,
                                                    mma=True))
        bound = (f"; bound {bound_ms:.4f} ms by {bound_by}, MXU kernel at {bound_ms / ms:.1%} "
                 f"of it, round_fold at {bound_ms / cios_ms:.1%}")
    print(f"kernel-vs-plain-vs-CIOS {name}: equal, MXU kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, CIOS kernel round_fold {cios_ms:.4f} ms{bound}")
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
        timings.append({"shape": shape, "ms": ms, "plain_ms": plain_ms, "cios_ms": cios_ms,
                        "work": round_work(extent, lo.shape[0], products, degree, True,
                                           mma=True)})

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
    """Phase 5b: `ops/mxu_mul.py`'s banded multiply (the shared-scalar
    multiply of the GKR inits' plain versions in the MXU fold mode, float32
    matmuls on the card)
    against the CIOS multiply of `limbs_torch`, edge values included."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields import limbs_torch as LT
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import mxu_mul

    rng = np.random.default_rng(seed + 4)
    a = torch.from_numpy(L.random_tables(rng, lanes.bit_length() - 1, 1)[0].astype(np.int64))
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


def mont_mul_phase(device, seed: int, lib: Path | None = None, lanes: int = 1 << 20,
                   reps: int = 64) -> dict:
    """Phase 5c: `csrc/field.cuh`'s two Montgomery multiplies, `mont_mul`
    (even/odd accumulators, the kernels' multiply) and `mont_mul_cios`
    (CIOS, its yardstick), against Python integers at edge operands and at
    random ones, then timed on `lanes` threads that each chain `reps`
    multiplies, as multiplies per second; beside them the SASS instruction
    counts of one multiply of each in `lib` (`multiply_sass`)."""
    from sumcheck_tpu_torch.fields.fr import P, R2
    from sumcheck_tpu_torch.ops import round_cuda as rc

    def limbs(values):
        rows = [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in values]
        return torch.from_numpy(np.array(rows, dtype=np.uint32).view(np.int32)).to(device)

    edges = [0, 1, 2, P - 1, P - 2, (1 << 256) % P, R2 % P, (1 << 255) % P]
    pairs = [(x, y) for x in edges for y in edges]
    r_inv = pow(1 << 256, -1, P)
    ea, eb = limbs([x for x, _ in pairs]), limbs([y for _, y in pairs])
    want = limbs([x * y * r_inv % P for x, y in pairs])
    gen = np.random.default_rng(seed + 5)
    d = gen.integers(0, 1 << 32, size=(2, lanes, 8), dtype=np.uint64).astype(np.uint32)
    d[:, :, 7] >>= 3  # < 2^253 < p
    a, b = (torch.from_numpy(x.view(np.int32)).to(device) for x in d)
    xs, ys = ([int.from_bytes(row.tobytes(), "little") for row in x[:256]] for x in d)
    want_rand = limbs([x * y * r_inv % P for x, y in zip(xs, ys)])
    rates = {}
    for impl in rc.MULTIPLIES:
        check(torch.equal(rc._mont_mul_probe(ea, eb, 1, impl), want),
              f"{impl} multiply differs from Python at edge operands")
        check(torch.equal(rc._mont_mul_probe(a[:256], b[:256], 1, impl), want_rand),
              f"{impl} multiply differs from Python at random operands")
        ms = time_ms(lambda: rc._mont_mul_probe(a, b, reps, impl), 3, device)
        rates[impl] = lanes * reps / (ms / 1e3)
    print(f"Montgomery multiplies, equal to Python at {len(pairs)} edge pairs and 256 random "
          f"ones; per second ({lanes} threads x {reps} chained): "
          + ", ".join(f"{k} {v / 1e9:.2f}e9" for k, v in rates.items())
          + f"; {RATES['imad_per_s'] / IMADS_PER_MONT_MUL / 1e9:.2f}e9 at the IMAD rate (264 "
          f"32-bit multiplies each)")
    for impl, c in (multiply_sass(lib) if lib is not None else {}).items():
        print(f"  SASS of one {impl} multiply: {c['total']} instructions; "
              + ", ".join(f"{k} {v}" for k, v in c.items() if k != "total"))
    return rates


def transcript_bound(device, compressions_per_round: float) -> dict:
    """The transcript step's latency bound on this card: compressions x
    (G_LEVELS x G_DEPTH) dependent instructions x the dependent-issue
    latency, measured as a chain of 2^19 dependent xor/add instructions on
    one thread, plus the launch floor, an empty kernel's back-to-back
    device time."""
    from sumcheck_tpu_torch.ops import transcript_cuda as tc

    out = torch.zeros(1, dtype=torch.int32, device=device)
    iters = 1 << 15
    chain_ms = time_ms(lambda: tc._latency_chain(out, iters), 3, device)
    ns_per_op = chain_ms * 1e6 / (16 * iters)
    floor_ms = time_ms(lambda: tc._empty_launch(device), 200, device, device_only=True)
    compress_us = G_LEVELS * G_DEPTH * ns_per_op / 1e3
    bound_ms = compressions_per_round * compress_us / 1e3 + floor_ms
    return {"ns_per_op": ns_per_op, "floor_ms": floor_ms, "compress_us": compress_us,
            "compressions": compressions_per_round, "bound_ms": bound_ms,
            "compress_clocks": compress_clocks(device)}


def compress_clocks(device, iters: int = 1024) -> float:
    """Clocks per Blake2b compression on the transcript kernel's four hash
    lanes, the chain checked against the host's Blake2b core."""
    from sumcheck_tpu_torch.microbench import host_compress_chain
    from sumcheck_tpu_torch.ops import transcript_cuda as tc

    buf = torch.zeros(9, dtype=torch.int64, device=device)
    tc._compress_probe(buf, iters)
    got = [int(x) % (1 << 64) for x in buf.cpu().tolist()]
    check(got[:8] == host_compress_chain(iters), "compression probe differs from blake2b_core")
    return got[8] / iters


def host_replay(host, msgs, rs, blen: int, degree: int, what: str):
    """Feed the host rng each round's message from a kernel's (rounds, 16,
    d+1) `msgs` and draw its challenge, checked against the kernel's (rounds,
    16) `rs`; returns (draws rejected, compressions per round, pending bytes
    after, attempts per round), the compressions from the rejections and the
    pending bytes."""
    from sumcheck_tpu_torch import Fr
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.microbench import compressions
    from sumcheck_tpu_torch.protocol.prover import ProverMsg
    from sumcheck_tpu_torch.transcript.blake2b_rng import _DRAW_MASK

    msgs_h = msgs.numpy().astype(np.int64)
    rs_h = rs.numpy().astype(np.int64)
    rejected, per_round, tries = 0, [], []
    for j in range(msgs_h.shape[0]):
        host.feed(ProverMsg([Fr(sum(int(msgs_h[j, i, t]) << (16 * i) for i in range(16)))
                             for t in range(degree + 1)]))
        attempts = 1
        while True:
            draw = int.from_bytes(host.next_u64s_bytes(4), "little") & _DRAW_MASK
            if draw < P:
                break
            rejected += 1
            attempts += 1
        n, blen = compressions(blen, degree + 1, attempts)
        per_round.append(n)
        tries.append(attempts)
        check(sum(int(rs_h[j, i]) << (16 * i) for i in range(16)) == draw,
              f"{what} round {j}: challenge differs from the host rng's")
    return rejected, per_round, blen, tries


STREAM_WORDS = 128  # `csrc/transcript.cu` kStreamWords, up to kMaxDegree = 8
WIDE_STREAM_WORDS, TURN = 256, 32  # kWideStreamWords and kTurn, past it


def stream_compactions(blen: int, d1: int, attempts: int) -> tuple[int, int]:
    """(compactions, pending bytes after) of one transcript step, by the
    transcript kernel's own bookkeeping (`csrc/transcript.cu`, the loop of
    `transcript_kernel`): the round's stream of 64-bit words (`STREAM_WORDS`
    up to degree 8, else a window of `WIDE_STREAM_WORDS`) starts with the
    pending block and the length; past degree 8 the elements go in turns of
    `TURN`, each turn but the last followed by the compression of its full
    blocks that more bytes follow and the move of the rest to the front.
    Then a compression of a full block moves `pos` 16 words on, each
    next_u64 appends its 8 re-absorbed words, and when they would pass
    `words - 16` the words from `pos` move to the front (a compaction: the
    branch that runs of rejected draws reach)."""
    words = STREAM_WORDS if d1 <= 9 else WIDE_STREAM_WORDS
    pos, length, e0 = 0, blen // 8 + 1, 0
    while d1 > 9 and d1 - e0 > TURN:
        length += 4 * TURN
        length -= 16 * ((length - 1) >> 4)
        e0 += TURN
    length += 4 * (d1 - e0)
    drawn, tried, count = 0, 0, 0
    while True:
        absorb = length - pos > 16
        if not absorb and drawn == 4:
            tried += 1
            if tried == attempts:
                return count, 8 * (length - pos)
            drawn = 0
        if absorb:
            pos += 16
        else:
            drawn += 1
            if length + 8 > words - 16:
                count += 1
                length -= pos
                pos = 0
            length += 8


def transcript_inputs(seed: int, rounds: int, degree: int):
    """Phase 6's inputs: (rounds, d+1, 16) per-digit sums and a 48-byte
    prefix the transcript is fed first, from `default_rng(seed + 2)`."""
    gen = np.random.default_rng(seed + 2)
    sums = gen.integers(0, 1 << 40, size=(rounds, degree + 1, 16), dtype=np.int64)
    return sums, gen.bytes(48)


def plain_transcript(seed: int, rounds: int, degree: int, device):
    """The plain transcript step over `transcript_inputs`, round by round
    on `device`: (final state, msgs, rs) on the CPU."""
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcript

    sums, prefix = transcript_inputs(seed, rounds, degree)
    host = Blake2b512Rng.setup()
    host.feed_bytes(prefix)
    state = lift_transcript(host, device)
    sums = torch.from_numpy(sums).to(device)
    msgs = torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=device)
    rs = torch.empty((rounds, 16), dtype=torch.int32, device=device)
    for j in range(rounds):
        tc.transcript_step_ref(state, sums[j], msgs, rs, j)
    return state.cpu(), msgs.cpu(), rs.cpu()


def transcript_phase(device, seed: int, rounds: int = 60, degree: int = 3,
                     plain=None) -> dict:
    """Phase 6: the transcript kernel against the plain transcript and
    against the host rng, over `rounds` rounds; its device time per round
    beside its latency bound, and how many rounds drew 1, 2, 3 and 4 or
    more attempts and how many stream compactions the kernel ran
    (`stream_compactions`). `plain` returns the plain version's (state,
    msgs, rs) over the same inputs; by default it runs here on the card."""
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcript, restore_transcript

    sums_h, prefix = transcript_inputs(seed, rounds, degree)
    sums = torch.from_numpy(sums_h).to(device)
    host = Blake2b512Rng.setup()
    host.feed_bytes(prefix)
    state0 = lift_transcript(host, device)
    state_k = state0.clone()
    msgs_k = torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=device)
    rs_k = torch.empty((rounds, 16), dtype=torch.int32, device=device)
    for j in range(rounds):
        tc.transcript_step(state_k, sums[j], msgs_k, rs_k, j)
    state_p, msgs_p, rs_p = (plain or (lambda: plain_transcript(seed, rounds, degree, device)))()
    sync(device)
    err = max(max_diff(a.cpu().long(), b.long())
              for a, b in ((state_k, state_p), (msgs_k, msgs_p), (rs_k, rs_p)))
    check(err == 0, f"transcript kernel differs from plain by {err}")

    # the host rng over the same messages: same challenges, same final
    # state; its rejections and pending bytes give each round's compressions
    blen0 = int(state0[25, 0])
    rejected, per_round, blen, tries = host_replay(host, msgs_k.cpu(), rs_k.cpu(), blen0,
                                                   degree, "transcript")
    total = sum(per_round)
    probe = Blake2b512Rng.setup()
    restore_transcript(probe, state_k.cpu())
    check(probe.state_tuple() == host.state_tuple(), "transcript state differs from the host rng's")
    check(blen == int(state_k[25, 0]), "the compression count's pending bytes differ from the card's")
    check(rejected >= 1, "the transcript schedule rejected no draw")
    compactions, pending = 0, blen0
    for attempts in tries:
        n, pending = stream_compactions(pending, degree + 1, attempts)
        compactions += n
    check(pending == blen, "the stream model's pending bytes differ from the card's")
    hist = {str(k): sum(1 for a in tries if min(a, 4) == k) for k in (1, 2, 3)}
    hist["4+"] = sum(1 for a in tries if a >= 4)
    print(f"transcript attempts a round over {rounds} rounds: {hist}; stream compactions in "
          f"the kernel: {compactions}")

    # device time: the same rounds from the same state, back to back
    def rounds_from(st):
        it = iter(range(rounds))

        def step():
            j = next(it)
            tc.transcript_step(st, sums[j], msgs_k, rs_k, j)
        return step

    per_pass = [time_ms(rounds_from(st), rounds, device, device_only=True, warm=False)
                for st in [state0.clone() for _ in range(3)]]
    ms = statistics.median(per_pass)
    state_t, msgs_t, rs_t = state0.clone(), msgs_k.clone(), rs_k.clone()
    plain_ms = time_ms(lambda: tc.transcript_step_ref(state_t, sums[0], msgs_t, rs_t, 0),
                       PLAIN_REPS, device)
    print(f"transcript kernel-vs-plain, {rounds} rounds d={degree}: equal, equal to the host "
          f"rng ({rejected} draws rejected); kernel {ms:.4f} ms per round (device time, passes "
          f"{[round(x, 5) for x in per_pass]}), plain {plain_ms:.4f} ms per round")
    out = {"shape": f"one round, d={degree}", "ms": ms, "plain_ms": plain_ms,
           "attempts": hist, "compactions": compactions}
    if device.type != "cuda":
        return {"transcript_step": [err, [out]]}
    bound = transcript_bound(device, total / rounds)
    print(f"transcript bound: {bound['compressions']:.2f} compressions a round x "
          f"{G_LEVELS} x {G_DEPTH} dependent instructions x {bound['ns_per_op']:.4f} ns = "
          f"{bound['compress_us']:.4f} us each, + launch floor {bound['floor_ms']:.4f} ms = "
          f"{bound['bound_ms']:.4f} ms a round; kernel at {bound['bound_ms'] / ms:.1%} of it; "
          f"previous version (PERF.md): {PREVIOUS_MS['transcript_step']} ms")
    clocks = bound["compress_clocks"]
    print(f"one compression, 1024 chained, equal to blake2b_core: {clocks:.1f} clocks on the "
          f"kernel's four hash lanes ({clocks / RATES['clock_hz'] * 1e6:.4f} us at the max SM "
          f"clock)")
    out["bound"] = bound
    return {"transcript_step": [err, [out]]}


def golden_table(prefix: str, tag: str, nv: int, P: int) -> list[int]:
    """The fixtures' documented table rule (`tests/test_golden.py:54-61`)."""
    out = []
    for i in range(1 << nv):
        h = hashlib.blake2b(f"sumcheck-golden/{prefix}/{tag}/{i}".encode(), digest_size=32)
        out.append(int.from_bytes(h.digest(), "little") % P)
    return out


def golden_phase(device, fixtures=None) -> None:
    """Phase 7: ML golden fixtures through `device`, on both chains and in
    the MXU fold mode: `fixtures` is a list of (label, fixture), by default
    `ml_nv6_rich.json` and `ml_nv14_config1.json`."""
    from sumcheck_tpu_torch import (
        Blake2b512Rng, DenseMLE, Fr, ListOfProductsOfPolynomials, MLSumcheck,
    )
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    if fixtures is None:
        fixtures = [(name, json.loads((FIXTURES / name).read_text()))
                    for name in ("ml_nv6_rich.json", "ml_nv14_config1.json")]
    for name, fx in fixtures:
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
        for path, (chain, mxu) in PATHS.items():
            fs_rng = Blake2b512Rng.setup()
            with fold_mode(chain, mxu), syncs_forbidden_in_chains():
                proof, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
            check(serialize_proof(proof).hex() == fx["proof_bytes"], f"{name} {path}: proof bytes")
            check([format(r.v, "064x") for r in state.randomness] == fx["challenges"],
                  f"{name} {path}: challenges")
            sub = MLSumcheck.verify(poly.info(), Fr(int(fx["asserted_sum"], 16)), proof)
            check(sub.expected_evaluation.v == int(fx["final_evaluation"], 16),
                  f"{name} {path}: final evaluation")
            print(f"golden {name}, {path}: proof bytes, challenges and final evaluation equal")


# the paths each headline drives: (chain, MXU fold mode)
PATHS = {"generic": ("generic", False), "per-size": ("persize", False),
         "generic mxu": ("generic", True)}


@contextlib.contextmanager
def fold_mode(chain: str, mxu: bool = False):
    """Run under one chain (`SUMCHECK_TPU_CHAIN_IMPL`) and, with `mxu`, the
    MXU fold mode (`SUMCHECK_TPU_MXU_FOLD=kernel`, `SUMCHECK_TPU_AB=1`)."""
    from sumcheck_tpu_torch.utils.config import get_config

    cfg = get_config()
    saved = (cfg.chain_impl, cfg.mxu_fold, cfg.ab)
    cfg.chain_impl = chain
    if mxu:
        cfg.mxu_fold, cfg.ab = "kernel", True
    try:
        yield
    finally:
        cfg.chain_impl, cfg.mxu_fold, cfg.ab = saved


def gkr_golden_phase(device, fx=None, name: str = "gkr_dim5.json") -> None:
    """Phase 7b: a GKR golden fixture (by default `tests/fixtures/gkr_dim5.json`)
    through `device` on both chains and in the MXU fold mode: messages,
    claimed sum, the verifier's challenges and expected evaluation, the
    subclaim."""
    from sumcheck_tpu_torch import Blake2b512Rng, DenseMLE, Fr, GKRRoundSumcheck, SparseMLE
    from sumcheck_tpu_torch.fields.fr import P

    if fx is None:
        fx = json.loads((FIXTURES / name).read_text())
    dim = fx["dim"]
    f1 = SparseMLE.from_pairs(3 * dim, [(int(k), Fr(int(v, 16)))
                                        for k, v in fx["f1_nonzeros"].items()])
    f2, f3 = (DenseMLE.from_evaluations(dim, golden_table(f"gkr{dim}", tag, dim, P))
              for tag in ("f2", "f3"))
    g = [Fr(int(x, 16)) for x in fx["g"]]

    def hexes(msgs):
        return [[format(e.v, "064x") for e in m.evaluations] for m in msgs]

    for path, (chain, mxu) in PATHS.items():
        with fold_mode(chain, mxu), syncs_forbidden_in_chains():
            proof = GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g, device=device)
        check(hexes(proof.phase1_sumcheck_msgs) == fx["phase1_msgs"]
              and hexes(proof.phase2_sumcheck_msgs) == fx["phase2_msgs"],
              f"{name} {path}: proof messages")
        sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, proof,
                                      Fr(int(fx["claimed_sum"], 16)))
        check([format(x.v, "064x") for x in sub.u + sub.v] == fx["u"] + fx["v"]
              and sub.expected_evaluation.v == int(fx["expected_evaluation"], 16)
              and sub.verify_subclaim(f1, f2, f3, g), f"{name} {path}: verifier")
        print(f"golden {name}, {path}: proof bytes, challenges, expected evaluation "
              f"and subclaim equal")


def evaluate_on_card(poly, point, device):
    """`poly.evaluate(point)` with each table's folds on the card by plain
    torch ops (`limbs_torch`, what `DenseMLE.fix_variables` does on the
    host with NumPy: new[b] = old[2b] + r (old[2b+1] - old[2b]), low bit
    first, from the natural-order digits) and the products in Python
    integers: the same field element, independent of the kernels, a
    second a polynomial at nv=20 where the host's NumPy takes about 6 s a
    table."""
    from sumcheck_tpu_torch import Fr
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields import limbs_torch as LT
    from sumcheck_tpu_torch.fields.fr import P, R_INV
    from sumcheck_tpu_torch.protocol.device_prover import col_int

    values = []
    for m in poly.flattened_ml_extensions:
        arr = torch.from_numpy(m.evals.astype(np.int64)).to(device)
        for x in point:
            r = LT.from_numpy(L.mont_scalar(x.v), device)
            even, odd = arr[:, 0::2], arr[:, 1::2]
            arr = LT.add(even, LT.mont_mul(LT.sub(odd, even), r))
        values.append(col_int(arr[:, 0].cpu().numpy()) * R_INV % P)
    total = 0
    for coeff, ix in poly.products:
        term = coeff.v
        for i in ix:
            term = term * values[i] % P
        total = (total + term) % P
    return Fr(total)


def headline_poly(seed: int, nv: int = NV):
    """2 products x 3 multiplicands at `nv`, tables and coefficients from
    `numpy.random.default_rng(seed)` in the order of `bench.py:179-184`."""
    return ml_poly(np.random.default_rng(seed), nv)


def headline_polys(seed: int, nv: int, count: int) -> list:
    """`count` such instances from one `numpy.random.default_rng(seed)`,
    one after the other, as `bench.py:302-305` builds its batch."""
    rng = np.random.default_rng(seed)
    return [ml_poly(rng, nv) for _ in range(count)]


def ml_poly(rng, nv: int):
    """One 2 x 3 instance from `rng` by the `bench.py:179-184` rule."""
    from sumcheck_tpu_torch.convert import polynomial_from_numpy
    from sumcheck_tpu_torch.fields.limbs_np import random_tables

    tables, products = [], []
    for _ in range(2):
        idx = []
        for t in random_tables(rng, nv, 3):
            tables.append(t)
            idx.append(len(tables) - 1)
        products.append((int(rng.integers(1, 1 << 62)), idx))
    return polynomial_from_numpy(nv, tables, products)


def counters() -> dict:
    from sumcheck_tpu_torch.ops import launch_counters

    return launch_counters()


@contextlib.contextmanager
def syncs_forbidden_in_chains():
    """Run both chains' enqueue loops, single and batched, and a GKR
    prove's whole enqueue (both phase inits and both chains,
    `gkr_round_sumcheck._enqueue`, and `batch._enqueue_gkr` for B
    instances), under the sync debug mode "error": a host sync inside
    raises, so the prove's one fetch after them is its only sync. (The
    plain versions sync by design, so the plain path runs outside this.)"""
    from sumcheck_tpu_torch import batch, gkr_round_sumcheck
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
              (gkr_round_sumcheck, "_enqueue"), (device_prover, "chain_rounds_batched"),
              (generic_prover, "chain_rounds_generic_batched"), (batch, "_enqueue_gkr"))
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
    """One run of `fn` under `torch.profiler` (`microbench.profile_events`):
    host-clock seconds between two syncs, the seconds in which the card ran
    a kernel or a copy (the union of their intervals), the idle share, and
    the `top` device operations by summed device time. The profiler adds
    host time to every torch op, so the idle share it reads is an upper
    bound."""
    from sumcheck_tpu_torch import microbench as MB

    prof = MB.profile_events(fn)
    by_name, launches = {}, {}
    for start, end, name in prof["events"]:
        by_name[name] = by_name.get(name, 0) + end - start
        if not MB.is_copy(name):
            launches[name] = launches.get(name, 0) + 1
    wall_s, busy_s = prof["wall_s"], MB.busy_ms(prof["events"]) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall_s, "busy_s": busy_s, "idle_share": 1 - busy_s / wall_s,
            "top": [(name[:70], us / 1e3) for name, us in ranked],
            "kernels": classify(launches), "device_ms": classify(by_name, scale=1e-3)}


# substrings of the port's kernels' names as the profiler shows them
ROUND_KERNELS = ("round_kernel", "fold_kernel", "fold_mxu_kernel")  # "fold_kernel": nofold_kernel too
INIT_KERNELS = ("weight_reduce_kernel", "finish_sums_kernel", "pair_slots_kernel")


def classify(by_name: dict, scale: float | None = None) -> dict:
    """Profiler counts (or, scaled, device times) by kernel name -> the
    round kernels', the transcript steps', the GKR phase-init kernels', and
    everything else's."""
    out = {"round": 0, "transcript": 0, "init": 0, "other": 0}
    for name, v in by_name.items():
        key = ("transcript" if "transcript_kernel" in name
               else "init" if any(k in name for k in INIT_KERNELS)
               else "round" if any(k in name for k in ROUND_KERNELS) else "other")
        out[key] += v if scale is None else v * scale
    return out


def profiled_kernels(warm, fn) -> dict:
    """Kernel launches (no copies) of one run of `fn`, by `classify`:
    `microbench.profile_events`, after `warm()`."""
    from sumcheck_tpu_torch import microbench as MB

    counts = {}
    for _s, _e, name in MB.profile_events(fn, warm)["events"]:
        if not MB.is_copy(name):
            counts[name] = counts.get(name, 0) + 1
    return classify(counts)


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
    from sumcheck_tpu_torch.protocol.device_prover import (
        chain_rounds, init_pair, lift_transcript, prove_chained, sum_rows)
    from sumcheck_tpu_torch.protocol.generic_prover import chain_rounds_generic, prove_generic

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
    want.update({kernels[0]: proves, kernels[1]: proves * (nv - 1), "transcript_step": proves * nv,
                 "pair_init": proves})
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
        rows = sum_rows(nv, degree, device)
        if chain == "generic":
            rc.round_nofold(lo, hi, products, degree, half, rows[0])
            for j in range(1, nv):
                fold_fn(lo, hi, r, products, degree, half >> j, rows[j])
        else:
            rc.round_step_nofold(lo, hi, products, degree, None, rows[0])
            for j in range(1, nv):
                (lo, hi), _s = rc.round_step_fold(lo, hi, r, products, degree, None, rows[j])

    init_s = wall(lambda: init_pair(poly, device), device)
    kernels_s = wall(rounds_only, device)
    # the kernels of one chain alone, as the profiler counts them, after a
    # chain at nv=6 (the same kernels) in the same profile
    def chain_on(p, n):
        lo, hi, products, degree = init_pair(p, device)
        state = lift_transcript(Blake2b512Rng.setup(), device)
        sync(device)
        if chain == "generic":
            return lambda: chain_rounds_generic(lo, hi, state, products, degree, n)
        return lambda: chain_rounds([lo, hi], state, products, degree, n)

    k = profiled_kernels(chain_on(headline_poly(seed, 6), 6), chain_on(poly, nv))
    for f in counters().values():
        f.launches = 0
    check(k["round"] == nv and k["transcript"] == nv and k["other"] <= 1,
          f"ML {path}: one chain launched {k}, expected {nv} round kernels, {nv} transcript "
          f"steps and at most the zero fill of its sums buffer")
    print(f"ML {path}: one chain of {nv} rounds launched {sum(k.values())} kernels (profiler): "
          f"{k['round']} round kernels, {k['transcript']} transcript steps, {k['other']} other "
          f"(the zero fill of its sums buffer): two per round")
    print(f"ML {path}: pair init {init_s:.4f} s; init + {nv} round kernels without transcript "
          f"{kernels_s:.4f} s; so transcript steps and the fetch {prove_s - kernels_s:.4f} s "
          f"of the {prove_s:.4f} s prove")
    busy = device_busy(lambda: MLSumcheck.prove(poly, device=device))
    print_busy(f"ML {path}", busy)
    k, dms = busy["kernels"], busy["device_ms"]
    if not (k["round"] == nv and k["transcript"] == nv):
        print(f"ML {path}: the profiler saw {k} in one prove, not {nv} of each")
    print(f"ML {path}: the profiled prove launched {sum(k.values())} kernels: {k['round']} round "
          f"kernels ({dms['round']:.4f} ms of device time), {k['transcript']} transcript steps "
          f"({dms['transcript']:.4f} ms, {dms['transcript'] / nv:.4f} ms each), {k['other']} "
          f"other (pair init, sums buffer fill)")

    s = MLSumcheck.extract_sum(proof)
    sub = MLSumcheck.verify(info, s, proof)
    vwalls = []
    for _ in range(21):
        t0 = time.perf_counter()
        MLSumcheck.verify(info, s, proof)
        vwalls.append(time.perf_counter() - t0)
    verify_s = statistics.median(vwalls)
    check(evaluate_on_card(poly, sub.point, device) == sub.expected_evaluation,
          f"ML {path}: subclaim does not match the polynomial")
    fs_rng = Blake2b512Rng.setup()
    _, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
    transcript = repr(fs_rng.state_tuple())
    check(state.randomness == sub.point, f"ML {path}: prover randomness is not the subclaim point")
    print(f"ML {path}: verify accepts; subclaim equals the polynomial at the point "
          f"(`evaluate_on_card`) and the prover's "
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
            "proof": serialize_proof(proof), "transcript": transcript}


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


# the GKR phase-init kernels (`ops/gkr_init_cuda.py`, `csrc/gkr_init.cu`)
GKR_INIT_KERNELS = ("weight_reduce", "finish_sums", "pair_slots")
GKR_INIT_MAX = 2  # launches of both phase inits a dim-18 prove may take, on any chain
SKEW = (1 << 16) + 1  # entries of phase 9a's skewed segment


# the phase-init kernels' launches a single-card GKR prove takes, on every
# chain and in either fold mode: the fused weight reduce, 1 a phase; no finish
# of raw sums (only a sharded rank's inits take it) and no pair slots
INIT_LAUNCHES = dict(zip(GKR_INIT_KERNELS, (2, 0, 0)))


def skewed_instance(inst, seed: int):
    """Phase 9's f1 with SKEW more entries in x segment 5 (distinct (g, y)
    parts): one segment past 2^16 entries, which the weight reduce cuts
    into chunks across blocks. (f1, f2, f3, g)."""
    from sumcheck_tpu_torch import SparseMLE
    from sumcheck_tpu_torch.fields.limbs_np import random_tables

    f1, f2, f3, g = inst
    dim = f2.num_vars
    gen = np.random.default_rng(seed + 1)
    mask = (1 << dim) - 1
    gy = gen.choice(1 << (2 * dim), SKEW, replace=False)
    idx = np.unique(np.concatenate([f1.indices.astype(np.int64),
                                    (gy & mask) | (5 << dim) | ((gy >> dim) << (2 * dim))]))
    vals = random_tables(gen, (len(idx) - 1).bit_length(), 1)[0][:, :len(idx)]
    return SparseMLE(3 * dim, idx, np.ascontiguousarray(vals)), f2, f3, g


def reduce_work(nnz: int, nseg: int, k: int, phase: int, raw: bool = False,
                slot: bool = False) -> dict:
    """What the fused weight reduce must do: each input read once and each
    output written once, 32 B an element and 4 B an index (phase 1: the g
    index, the value, y, to_y, the gathered f3 lane and the carry out an
    entry; phase 2: x and the carry an entry), `last` and the sum a segment
    (raw: 8 int64 limbs), the k challenge rows (16 int32 digits each), and
    with the slot its table read and written (32 B a lane each way) and,
    in phase 2, the final fold's one-lane pair and row; the Montgomery
    multiplies, 3 (phase 1) or 2 (phase 2) an entry, 1 a segment's finish
    (none for raw sums), the half tables' 2^kl + 2^kh - 2 once (the work of
    the function, not each block's copy of it), and phase 2's slot 1 a lane
    and 1 for the final fold."""
    from sumcheck_tpu_torch.ops.gkr_init_cuda import halves

    lanes = sum(1 << h for h in halves(k))
    per_entry = 4 + 32 + 4 + 4 + 32 + 32 if phase == 1 else 4 + 32
    nbytes = per_entry * nnz + (4 + (64 if raw else 32)) * nseg + 64 * k
    mults = (3 if phase == 1 else 2) * nnz + (0 if raw else nseg) + lanes - 2
    if slot:
        nbytes += 2 * ELEMENT_BYTES * nseg + (2 * ELEMENT_BYTES + 64 if phase == 2 else 0)
        mults += nseg + 1 if phase == 2 else 0
    return {"bytes": nbytes, "imads": mults * IMADS_PER_MONT_MUL, "int8_ops": 0}


def finish_work(lanes: int, phase: int) -> dict:
    """What a sharded rank's finish must do over its `lanes` dealt lanes:
    each lane's 8 int64 limb sums read and its strict value written, the
    slot's table lane read and written (32 B each way), and in phase 2 the
    final fold's one-lane pair and row; 1 Montgomery multiply a lane (the
    word above 2^256) and, in phase 2, 1 more a lane and 1 for the fold."""
    nbytes = (64 + 3 * ELEMENT_BYTES) * lanes + (2 * ELEMENT_BYTES + 64 if phase == 2 else 0)
    mults = lanes + (lanes + 1 if phase == 2 else 0)
    return {"bytes": nbytes, "imads": mults * IMADS_PER_MONT_MUL, "int8_ops": 0}


def gkr_k21_instance(seed: int, dim: int = 21, nnz: int = 1 << 16):
    """A GKR instance at dim 21, the largest whose eq half tables (2^11 +
    2^10 lanes) the weight reduce builds in its blocks' shared memory (and
    the largest whose 3 dim index bits fit f1's int64 indices): f1 with
    `nnz` random entries, f2 and f3 from `numpy.random.default_rng`, and g.
    (f1, f2, f3, g)."""
    from sumcheck_tpu_torch import DenseMLE, Fr, SparseMLE
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.fields.limbs_np import random_tables

    gen = np.random.default_rng(seed + dim)
    idx = np.unique(gen.integers(0, 1 << (3 * dim), nnz, dtype=np.int64))
    vals = random_tables(gen, (len(idx) - 1).bit_length(), 1)[0][:, :len(idx)]
    f2, f3 = (DenseMLE(dim, t) for t in random_tables(gen, dim, 2))
    rnd = random.Random(seed + dim)
    g = [Fr(rnd.randrange(P)) for _ in range(dim)]
    return SparseMLE(3 * dim, idx, np.ascontiguousarray(vals)), f2, f3, g


def gkr_init_phase(device, inst, seed: int) -> dict:
    """Phase 9a: the GKR phase-init kernels against their plain versions on
    the card, array-equal. The fused weight reduce, one launch a phase (the
    eq half tables built in its blocks, the weight fold, the segment sums
    into slot 0 of the pair and its slot 1: f2 copied in phase 1, f3 times
    the final fold of phase 1's one-lane pair in phase 2), at the dim-18
    shapes of phase 9's instance and on the skewed instance
    (`skewed_instance`: one segment of SKEW entries, cut into chunks across
    blocks), strict and as a rank's raw sums (no slot); the finish of raw
    sums, into a table and, as a sharded rank's, into its dealt pair at S =
    2 and 4 with slot 1 in both phases' forms (`finish_work`); the pair
    slots in the forms of the per-size pieces, which no prover path takes
    (`prep2`: a copy and a scale by a digit row; `prep1`: two copies;
    `final_fold`: the fold alone, one thread; and the final fold's
    scale); the whole phase inits (`gkr_init.phase1_pair`,
    `phase2_pair`) against the torch-op plain versions of the phases
    (`phase1_pair_ref`, `phase2_pair_ref`) on both instances and at dim 21
    (`gkr_k21_instance`: the largest build in the blocks), and as a sharded
    rank's (rank 1 of 2: its raw sums, and its dealt pairs against the deal
    of the plain versions') there too. Device ms (CUDA events behind
    `torch.cuda._sleep`, each launch alone after an L2 flush, since every
    working set here fits in the H100's 50 MB L2), the bound (each input
    read once and each output written once, 32 B an element and 4 B an
    index, against the Montgomery multiplies the function needs,
    `reduce_work`) and the share of it, and the plain version's ms (host
    clock between syncs). Returns the stats of the kernels line, {name:
    [max_abs_err, [timing of each shape, the main one first]]} (the weight
    reduce's main shape the fused phase 1 at dim 18, the finish's a rank's
    dealt phase-2 pair at S = 2, pair_slots' prep2)."""
    from sumcheck_tpu_torch import Fr
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK
    from sumcheck_tpu_torch.parallel.mesh import deal

    dim = inst[1].num_vars
    n, half = 1 << dim, 1 << (dim - 1)
    rnd = random.Random(seed + dim)
    u_r = GI.upload(GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)]), device)
    stats = {name: [0, []] for name in GKR_INIT_KERNELS}

    def pair(size=1):
        lo = torch.empty((2, 8, half // size), dtype=torch.int32, device=device)
        return lo, torch.empty_like(lo)

    def dealt(lo, hi, s, size):
        """Rank s's deal (`mesh.deal`) of each slot of a (2, 8, H) pair."""
        tables = [deal(torch.cat([lo[u], hi[u]], dim=1), s, size) for u in range(2)]
        h = lo.shape[2] // size
        return tuple(torch.stack([t[:, side * h:(side + 1) * h] for t in tables])
                     for side in range(2))

    def case(name, shape, kernel, plain, work, timed=True, main=False):
        got, want = kernel(), plain()
        sync(device)
        err = max(max_diff(a, b) for a, b in zip(got, want))
        check(err == 0, f"9a {name} ({shape}): kernel differs from its plain version by {err}")
        stats[name][0] = max(stats[name][0], err)
        line = f"kernel-vs-plain {name} ({shape}): equal"
        if timed:
            ms = time_ms(kernel, KERNEL_REPS, device, device_only=True, cold_l2=True)
            plain_ms = time_ms(plain, PLAIN_REPS, device)
            stats[name][1].insert(0 if main else len(stats[name][1]),
                                  {"shape": shape, "ms": ms, "plain_ms": plain_ms, "work": work})
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if RATES:
                bound_ms, bound_by, _ = bound_of(work)
                line += (f"; bound {bound_ms:.4f} ms by {bound_by} ({work['bytes'] / 1e6:.1f} "
                         f"MB, {work['imads'] / IMADS_PER_MONT_MUL:.0f} Montgomery multiplies), "
                         f"{bound_ms / ms:.1%} of it")
        print(line)

    def phases_equal(label, split, g_r, f3_d, f2_d, d, u):
        """phase1_pair and phase2_pair on the kernels against the torch-op
        plain versions of the phases, and a rank's raw sums of both."""
        k1 = GI.phase1_pair(split, g_r, f3_d, f2_d, d)
        r1 = GI.phase1_pair_ref(split, g_r, f3_d, f2_d, d)
        args2 = (k1[0][:, :, :1], k1[1][:, :, :1], u[d - 1], split, k1[2], u, f3_d, d)
        k2, r2 = GI.phase2_pair(*args2), GI.phase2_pair_ref(*args2)
        # rank 1 of 2's: the raw sums, (2, 8, 2^d / 2) rank-major, kept
        # (the whole f1 is its own reduce-scatter: block [1] is its sum), and
        # the finish of that block into its dealt pair
        sums = [torch.empty((2, 8, 1 << (d - 1)), dtype=torch.int64, device=device)
                for _ in range(2)]
        mine = [deal(t, 1, 2).contiguous() for t in (f2_d, f3_d)]

        def kept(i):
            return lambda t: sums[i].copy_(t)[1].clone()

        d1 = GI.phase1_pair(split, g_r, f3_d, mine[0], d, reduce_fn=kept(0), shard=(1, 2))
        d2 = GI.phase2_pair(*args2[:6], mine[1], d, reduce_fn=kept(1), shard=(1, 2))
        want = [torch.empty_like(t) for t in sums]
        GK.weight_reduce_ref(split.gbits, split.vals, g_r, d, split.last_x, split.plan_x,
                             want[0], f3_d, split.y_rev, split.to_y, ranks=2)
        GK.weight_reduce_ref(split.x_y, k1[2], u, d, split.last_y, split.plan_y, want[1], ranks=2)
        sync(device)
        err = max(max_diff(a, b) for a, b in zip(
            k1 + k2 + tuple(sums) + d1 + d2,
            r1 + r2 + tuple(want) + dealt(*r1[:2], 1, 2) + (r1[2],) + dealt(*r2, 1, 2)))
        check(err == 0, f"9a {label}: the phase inits differ from their plain versions by {err}")
        return args2

    for label, (f1, f2, f3, g) in ((f"dim {dim}", inst),
                                   ("skewed", skewed_instance(inst, seed))):
        split, f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, dim, device)
        nnz = split.vals.shape[0]
        main = label != "skewed"
        tag = f"{label}, 2^{dim} lanes, {nnz} entries"
        print(f"9a {tag}: tile plans of {len(split.plan_x.items)} (x) and "
              f"{len(split.plan_y.items)} (y) items, {split.plan_x.long} and "
              f"{split.plan_y.long} long segments, {-(-half // GK.TILE)} slot items")
        p1 = (split.gbits, split.vals, g_r, dim, split.last_x, split.plan_x)
        kw1 = {"f3": f3_d, "y": split.y_rev, "to_y": split.to_y}
        k_pair, p_pair = pair(), pair()
        case("weight_reduce", f"{tag}: phase 1 init, one launch (eq halves in the blocks, f3 "
             f"gather, carry, slot 0 sums, slot 1 = f2)",
             lambda: (GK.weight_reduce(*p1, k_pair, slot=(f2_d, None), **kw1), *k_pair),
             lambda: (GK.weight_reduce_ref(*p1, p_pair, slot=(f2_d, None), **kw1), *p_pair),
             reduce_work(nnz, n, dim, 1, slot=True), True, main)
        carry = GK.weight_reduce(*p1, k_pair, slot=(f2_d, None), **kw1)
        p2 = (split.x_y, carry, u_r, dim, split.last_y, split.plan_y)
        fold = (k_pair[0][:, :, :1], k_pair[1][:, :, :1], u_r[dim - 1], 1)
        o_k, o_p = pair(), pair()
        case("weight_reduce", f"{tag}: phase 2 init, one launch (slot 0 sums over the carry, "
             f"slot 1 = f3 times the final fold)",
             lambda: (GK.weight_reduce(*p2, o_k, slot=(f3_d, fold)), *o_k)[1:],
             lambda: (GK.weight_reduce_ref(*p2, o_p, slot=(f3_d, fold)), *o_p)[1:],
             reduce_work(nnz, n, dim, 2, slot=True), True)
        table, want = (torch.empty((8, n), dtype=torch.int32, device=device) for _ in range(2))
        for phase, args, kw in ((1, p1, kw1), (2, p2, {})):
            case("weight_reduce", f"{tag}: phase {phase}, no slot, into a table",
                 lambda: (GK.weight_reduce(*args, table, **kw), table)[1:],
                 lambda: (GK.weight_reduce_ref(*args, want, **kw), want)[1:],
                 reduce_work(nnz, n, dim, phase), False)
        k_sums, p_sums = (torch.empty((8, n), dtype=torch.int64, device=device) for _ in range(2))
        for phase, args, kw in ((1, p1, kw1), (2, p2, {})):
            case("weight_reduce", f"{tag}: phase {phase}, a rank's raw sums",
                 lambda: (GK.weight_reduce(*args, k_sums, **kw), k_sums)[1:],
                 lambda: (GK.weight_reduce_ref(*args, p_sums, **kw), p_sums)[1:],
                 reduce_work(nnz, n, dim, phase, raw=True), False)
        case("finish_sums", f"{tag}: phase 2's raw sums, into a table",
             lambda: (GK.finish_sums(k_sums, table), table)[1:],
             lambda: (GK.finish_sums_ref(k_sums, want), want)[1:],
             {"bytes": (64 + 32) * n, "imads": n * IMADS_PER_MONT_MUL, "int8_ops": 0}, main)
        # a sharded rank's finish: the raw sums rank-major, (S, 8, n / S),
        # then rank 1's block of them (what its reduce-scatter hands it)
        # straight into its dealt pair, slot 1 from the same launch
        # (phase 1: its dealt f2; phase 2: its dealt f3 times the final fold)
        for size in (2, 4):
            rm = [torch.empty((size, 8, n // size), dtype=torch.int64, device=device)
                  for _ in range(2)]
            for phase, args, kw, sums in ((1, p1, kw1, rm[0]), (2, p2, {}, rm[1])):
                want_rm = torch.empty_like(sums)
                case("weight_reduce", f"{tag}: phase {phase}, a rank's raw sums rank-major over "
                     f"S = {size}",
                     lambda: (GK.weight_reduce(*args, sums, ranks=size, **kw), sums)[1:],
                     lambda: (GK.weight_reduce_ref(*args, want_rm, ranks=size, **kw),
                              want_rm)[1:],
                     reduce_work(nnz, n, dim, phase, raw=True), False)
            mine = [deal(t, 1, size).contiguous() for t in (f2_d, f3_d)]
            for phase, sums, slot in ((1, rm[0], (mine[0], None)), (2, rm[1], (mine[1], fold))):
                d_k, d_p = pair(size), pair(size)
                case("finish_sums", f"{tag}: a rank's dealt pair at S = {size}, phase {phase}'s "
                     f"form (its block of rank-major sums; slot 1 = "
                     f"{'f2' if phase == 1 else 'f3 times the final fold'})",
                     lambda: (GK.finish_sums(sums[1], d_k, slot=slot), *d_k)[1:],
                     lambda: (GK.finish_sums_ref(sums[1], d_p, slot=slot), *d_p)[1:],
                     finish_work(n // size, phase), main, main and size == 2 and phase == 2)
        scratch, arrived = GK._scratch(device, 1)
        check(not scratch.any() and not arrived.any(), f"9a {label}: the scratch is not zero")
        f2u = GI.final_fold(*fold)
        s_k, s_p = pair(), pair()
        case("pair_slots", f"{tag}: prep2's form, slot 0 = a table, slot 1 = f3 times f2(u)",
             lambda: (GK.pair_slots(*s_k, ((0, table, None), (1, f3_d, f2u))), *s_k)[1:],
             lambda: (GK.pair_slots_ref(*s_p, ((0, table, None), (1, f3_d, f2u))), *s_p)[1:],
             {"bytes": 2 * 64 * n + 64, "imads": n * IMADS_PER_MONT_MUL, "int8_ops": 0}, main,
             main=True)
        case("pair_slots", f"{tag}: prep1's form, two copies",
             lambda: (GK.pair_slots(*s_k, ((0, table, None), (1, f2_d, None))), *s_k)[1:],
             lambda: (GK.pair_slots_ref(*s_p, ((0, table, None), (1, f2_d, None))), *s_p)[1:],
             {"bytes": 2 * 64 * n, "imads": 0, "int8_ops": 0}, main)
        o_k, o_p = (torch.empty(16, dtype=torch.int32, device=device) for _ in range(2))
        case("pair_slots", f"{tag}: final_fold's form, the fold alone (one thread)",
             lambda: (GK.pair_slots(None, None, (), fold=fold, fold_out=o_k), o_k)[1:],
             lambda: (GK.pair_slots_ref(None, None, (), fold=fold, fold_out=o_p), o_p)[1:],
             {"bytes": 2 * ELEMENT_BYTES + 2 * 64, "imads": IMADS_PER_MONT_MUL, "int8_ops": 0},
             main)
        case("pair_slots", f"{tag}: slot 1 = f3 times the final fold",
             lambda: (GK.pair_slots(*s_k, ((1, f3_d, "fold"),), fold=fold), *s_k)[1:],
             lambda: (GK.pair_slots_ref(*s_p, ((1, f3_d, "fold"),), fold=fold), *s_p)[1:],
             {"bytes": 64 * n + 2 * 32 + 64, "imads": (n + 1) * IMADS_PER_MONT_MUL,
              "int8_ops": 0}, main)
        args2 = phases_equal(label, split, g_r, f3_d, f2_d, dim, u_r)
        kern_s = wall(lambda: (GI.phase1_pair(split, g_r, f3_d, f2_d, dim),
                               GI.phase2_pair(*args2)), device, reps=5)
        plain_s = wall(lambda: (GI.phase1_pair_ref(split, g_r, f3_d, f2_d, dim),
                                GI.phase2_pair_ref(*args2)), device)
        print(f"9a {label}: phase1_pair and phase2_pair on the kernels (a launch each) equal "
              f"the torch-op plain versions on the card, strict, as raw sums and as a sharded "
              f"rank's dealt pairs (2 launches each); both inits "
              f"{kern_s * 1e3:.4f} ms against {plain_s * 1e3:.4f} ms (host clock between syncs)")

    # the largest build in the blocks: dim 21, 2^11 + 2^10 half-table lanes
    f1, f2, f3, g = gkr_k21_instance(seed)
    k21 = f2.num_vars
    check(GK.in_block(k21) and not GK.in_block(k21 + 1), f"9a: dim {k21} is not the largest "
                                                         f"build in the blocks")
    split, f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, k21, device)
    u21 = GI.upload(GI._point_rows([Fr(rnd.randrange(P)) for _ in range(k21)]), device)
    phases_equal(f"dim {k21}", split, g_r, f3_d, f2_d, k21, u21)
    print(f"9a dim {k21}, {split.vals.shape[0]} entries: phase1_pair and phase2_pair equal the "
          f"torch-op plain versions on the card, strict, as raw sums and as a sharded rank's "
          f"dealt pairs (the half tables built in the blocks)")
    return stats


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
    from sumcheck_tpu_torch.protocol.device_prover import sum_rows

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
    init_counts = INIT_LAUNCHES
    want.update({k: v * proves for k, v in init_counts.items()})
    check(launches == want, f"GKR {path}: launch counts {launches} over {proves} proves, "
                           f"expected {want}")
    check(sum(init_counts.values()) <= GKR_INIT_MAX, f"GKR {path}: {init_counts} init launches")
    print(f"GKR {path}: the phase inits launch {sum(init_counts.values())} kernels a prove "
          f"({init_counts})")
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
    split, f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, dim, device)
    gen = np.random.default_rng(dim)
    us = torch.from_numpy(np.stack([L.mont_scalar(int(gen.integers(1, 1 << 62)) % P)[:, 0]
                                    for _ in range(dim)]).astype(np.int32)).to(device)

    def inits():
        lo, hi, w = GI.phase1_pair(split, g_r, f3_d, f2_d, dim)
        return GI.phase2_pair(lo[:, :, :1], hi[:, :, :1], us[dim - 1], split, w,
                              us, f3_d, dim)

    lo0, hi0 = inits()
    products, half = ((0, 1),), lo0.shape[2]

    def rounds_only():
        for _ in range(2):
            lo, hi = lo0.clone(), hi0.clone()
            rows = sum_rows(dim, 2, device)
            if chain == "generic":
                rc.round_nofold(lo, hi, products, 2, half, rows[0])
                for j in range(1, dim):
                    getattr(rc, kernels[1])(lo, hi, us[j], products, 2, half >> j, rows[j])
            else:
                rc.round_step_nofold(lo, hi, products, 2, None, rows[0])
                for j in range(1, dim):
                    (lo, hi), _s = rc.round_step_fold(lo, hi, us[j], products, 2, None, rows[j])

    inits_s = wall(inits, device, reps=5)
    rounds_s = wall(rounds_only, device, reps=5)
    for f in counters().values():
        f.launches = 0
    print(f"GKR {path}: both phase inits {inits_s:.4f} s; {2 * dim} round kernels without "
          f"transcript {rounds_s:.4f} s; so transcript steps and the fetch "
          f"{prove_s - inits_s - rounds_s:.4f} s of the {prove_s:.4f} s prove")
    busy = device_busy(prove)
    print_busy(f"GKR {path}", busy)
    k, dms = busy["kernels"], busy["device_ms"]
    if not (k["round"] == 2 * dim and k["transcript"] == 2 * dim
            and k["init"] == sum(init_counts.values())):
        print(f"GKR {path}: the profiler saw {k} in one prove, not {2 * dim} round kernels and "
              f"transcript steps and {sum(init_counts.values())} init kernels")
    print(f"GKR {path}: the profiled prove launched {sum(k.values())} kernels: {k['round']} round "
          f"kernels ({dms['round']:.4f} ms of device time), {k['transcript']} transcript steps "
          f"({dms['transcript']:.4f} ms, {dms['transcript'] / (2 * dim):.4f} ms each), two per "
          f"chained round; {k['init']} phase-init kernels ({dms['init']:.4f} ms); {k['other']} "
          f"other ({dms['other']:.4f} ms: the sums buffer fills); "
          f"idle share {busy['idle_share']:.4f}")

    t0 = time.perf_counter()  # one host verify a path, to keep the script's time down
    sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, proof, proof.extract_sum())
    verify_s = time.perf_counter() - t0
    out = {"launches": launches, "prove_s": prove_s, "first_s": first_s, "inits_s": inits_s,
           "rounds_s": rounds_s, "verify_s": verify_s, "busy": busy, "proof": blob,
           "init_launches": sum(init_counts.values())}
    print(f"GKR {path}: verify accepts, {verify_s:.6f} s")
    if path != "generic":
        return out

    # once, on the default path: the subclaim against f1, f2, f3 in Python
    # integers (`verify_subclaim` takes about a minute of host limb
    # arithmetic at dim 18: it runs at dim 14, in the GKR batch), and the
    # plain path on the card (plain round versions and transcript)
    t0 = time.perf_counter()
    check(subclaim_in_integers(inst, sub), f"GKR {path}: subclaim does not hold")
    subclaim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = G._prove_chained(Blake2b512Rng.setup(), f1, f2, f3, g, dim, device,
                             round_fns=(rc.round_nofold_ref, rc.round_fold_ref),
                             transcript_fn=tc.transcript_step_ref)
    plain_s = time.perf_counter() - t0
    check(plain.serialize_uncompressed() == blob, f"GKR {path}: kernel proof differs from "
                                                  f"the plain path's")
    print(f"GKR {path}: the subclaim holds in Python integers ({subclaim_s:.4f} s on the host); "
          f"plain-path "
          f"proof on the same device: bytes equal ({plain_s:.4f} s)")
    out.update(subclaim_s=subclaim_s, plain_s=plain_s)
    return out


# --- the batched provers (BASELINE config 4; bench.py's batch and gkr_batch)

BATCH = 8  # instances per batch (`bench.py:565`, `:570`)
BATCH_NV = 16  # `bench.py:564`
GKR_BATCH_DIM = 14  # `bench.py:569`


def pair_init_phase(device, seed: int, nv: int = NV, poly=None, label: str = "ML") -> dict:
    """Phase 6b: the pair-init kernel at the ML nv=20 2x3 shape (6 slots,
    the two coefficients scaled in place; or `poly`'s) against its plain
    version on the card, array-equal, the cached tables untouched; kernel
    and plain times and the bound (each source lane read once, each slot
    lane written once)."""
    from sumcheck_tpu_torch.ops import init_cuda as ic
    from sumcheck_tpu_torch.protocol.device_prover import _fold_plan

    if poly is None:
        poly = headline_poly(seed, nv)
    _products, scale_plan, num_slots, need_ones = _fold_plan(poly)
    tabs = [m.to_device(device) for m in poly.flattened_ml_extensions]
    before = [t.clone() for t in tabs]
    specs = ic.slot_specs(len(tabs), scale_plan, need_ones)
    lo = torch.empty((num_slots, 8, 1 << (nv - 1)), dtype=torch.int32, device=device)
    hi, lo_p, hi_p = (torch.empty_like(lo) for _ in range(3))
    ic.pair_init(lo, hi, tabs, specs)
    ic.pair_init_ref(lo_p, hi_p, tabs, specs)
    sync(device)
    err = max(max_diff(lo, lo_p), max_diff(hi, hi_p))
    check(err == 0, f"pair_init differs from its plain version by {err}")
    check(all(torch.equal(a, b) for a, b in zip(tabs, before)),
          "pair_init wrote into a cached table")
    ms = time_ms(lambda: ic.pair_init(lo, hi, tabs, specs), KERNEL_REPS, device, device_only=True)
    plain_ms = time_ms(lambda: ic.pair_init_ref(lo_p, hi_p, tabs, specs), PLAIN_REPS, device)
    scaled = sum(1 for src, c in specs if src is not None and c is not None)
    reads = sum(1 for src, _c in specs if src is not None)
    work = {"bytes": (reads + num_slots) * ELEMENT_BYTES * (1 << nv),
            "imads": scaled * (1 << nv) * IMADS_PER_MONT_MUL, "int8_ops": 0}
    shape = f"{label} nv={nv}{' 2x3' if label == 'ML' else ''}: {num_slots} slots, {scaled} scaled"
    bound = ""
    if RATES:
        bound_ms, bound_by, _ = bound_of(work)
        bound = (f"; bound {bound_ms:.4f} ms by {bound_by} "
                 f"({work['bytes'] / 1e6:.1f} MB at 32 B an "
                 f"element), "
                 f"{bound_ms / ms:.1%} of it")
    print(f"kernel-vs-plain pair_init {shape}: equal, cached tables untouched; kernel "
          f"{ms:.4f} ms, plain (torch ops) {plain_ms:.4f} ms{bound}")
    return {"pair_init": [err, [{"shape": shape, "ms": ms, "plain_ms": plain_ms, "work": work}]]}


def alternating_ms(fns: dict, device) -> dict:
    """{name: device ms} of each function, timed in turns a, b, b, a (the
    mean of its two runs), so that two versions meet the card alike."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(time_ms(fns[n], KERNEL_REPS, device, device_only=True))
    return {n: sum(v) / len(v) for n, v in runs.items()}


def redesign_phase(device, seed: int, ptxas: dict, nv: int = NV) -> dict:
    """Phase 6e: the two kernels redesigned for Hopper beside the variant
    each did not take, at the main path's shapes, both checked against the
    plain version first: `round_fold` (the next slot's stripes prefetched
    in registers) against `fold_staged.round_fold_staged` (the stripes
    staged in shared memory by 16-byte cp.async copies of the whole block,
    `csrc/fold_staged.cu`) at A2=2^(nv-2), and `pair_init` (4 lanes a
    thread, 16-byte accesses) against its one-lane body (4-byte accesses),
    which the launch takes for a pair not 16-byte aligned, at the nv=20 2x3
    pair; timed in turns. Prints each body's ptxas registers and stack frame
    and its resident blocks a multiprocessor. Returns {kernel: {"registers",
    "stack", "blocks_per_sm", "ms", "variant": {the same}}}."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import fold_staged as fs
    from sumcheck_tpu_torch.ops import init_cuda as ic
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.protocol.device_prover import _fold_plan

    def resources(symbol: str, args: str) -> dict:
        res = next(v for k, v in ptxas.items() if short_name(k) == symbol + args)
        return {"registers": res.get("registers"), "stack": res.get("stack")}

    rng = np.random.default_rng(seed + 5)
    half = 1 << (nv - 1)
    lo, hi = random_pair(rng, SLOTS, half, device)
    products = ((0, 1, 2), (3, 4, 5))
    r = torch.from_numpy(
        L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0].astype(np.int32)).to(device)
    extent = half // 2
    runs = []
    for fn in (rc.round_fold, fs.round_fold_staged, rc.round_fold_ref):
        lo_c, hi_c = lo.clone(), hi.clone()
        runs.append((fn(lo_c, hi_c, r, products, 3, extent), lo_c, hi_c))
    sync(device)
    err = max(max(max_diff(a, b) for a, b in zip(runs[0], run)) for run in runs[1:])
    check(err == 0, f"round_fold_staged or round_fold differs from the plain version by {err}")
    row = torch.zeros((4, 16), dtype=torch.int64, device=device)
    ms = alternating_ms({"registers": lambda: rc.round_fold(lo, hi, r, products, 3, extent, row),
                         "staged": lambda: fs.round_fold_staged(lo, hi, r, products, 3, extent,
                                                                row)}, device)
    staged = dict(resources("fold_staged_kernel", "ILi3E"),
                  name="stripes staged in shared memory by the block's 16-byte cp.async",
                  blocks_per_sm=fs.blocks_per_sm(3, SLOTS), ms=ms["staged"])
    # fold_kernel<D = 3, in place, no coefficients, one instance>
    out = {"round_fold": dict(resources("fold_kernel", "ILi3ELb0ELb0ELb0E"),
                              blocks_per_sm=rc.blocks_per_sm(3, SLOTS), ms=ms["registers"],
                              shape=f"fold A2=2^{nv - 2} U=6 d=3", variant=staged)}
    del lo, hi, runs

    poly = headline_poly(seed, nv)
    _products, scale_plan, num_slots, need_ones = _fold_plan(poly)
    tabs = [m.to_device(device) for m in poly.flattened_ml_extensions]
    specs = ic.slot_specs(len(tabs), scale_plan, need_ones)
    words = num_slots * 8 * half
    wide = torch.empty((2, words), dtype=torch.int32, device=device)
    # one word past a 16-byte boundary: the launch takes the one-lane body
    unaligned = torch.empty((2, words + 1), dtype=torch.int32, device=device)
    pairs = [[w.view(num_slots, 8, half) for w in wide],
             [w[1:].view(num_slots, 8, half) for w in unaligned]]
    check(pairs[1][0].data_ptr() % 16 != 0, "the one-lane pair is 16-byte aligned")
    for lo_p, hi_p in pairs:
        ic.pair_init(lo_p, hi_p, tabs, specs)
    sync(device)
    err = max(max_diff(a, b) for a, b in zip(pairs[0], pairs[1]))
    check(err == 0, f"pair_init's one-lane body differs from its four-lane body by {err}")
    ms = alternating_ms({"wide": lambda: ic.pair_init(pairs[0][0], pairs[0][1], tabs, specs),
                         "narrow": lambda: ic.pair_init(pairs[1][0], pairs[1][1], tabs, specs)},
                        device)
    out["pair_init"] = dict(resources("pair_init_kernel", "ILi4E"),
                            blocks_per_sm=ic.blocks_per_sm(True), ms=ms["wide"],
                            shape=f"ML nv={nv} 2x3: {num_slots} slots",
                            variant=dict(resources("pair_init_kernel", "ILi1E"),
                                         name="one lane a thread, 4-byte accesses",
                                         blocks_per_sm=ic.blocks_per_sm(False), ms=ms["narrow"]))
    for name, o in out.items():
        v = o["variant"]
        print(f"redesign {name} at {o['shape']}: {o['registers']} registers, {o['stack']} B "
              f"stack, {o['blocks_per_sm']} blocks/SM, {o['ms']:.4f} ms; variant not taken "
              f"({v['name']}): {v['registers']} registers, {v['stack']} B stack, "
              f"{v['blocks_per_sm']} blocks/SM, {v['ms']:.4f} ms (in turns, this call)")
    return out


def _batch_case(name, compare, batched, singles, plain, batch, device, work):
    """One batched-vs-plain case: `compare()` returns pairs (kernel, plain)
    of tensors computed from the same inputs, which must be array-equal;
    then the device time of `batched()` beside that of `singles()`, the
    same work as `batch` single launches, and the plain version's time.
    Returns (err, timing entry)."""
    pairs = compare()
    sync(device)
    err = max(max_diff(a.long(), b.long()) for a, b in pairs)
    check(err == 0, f"{name}: batched kernel differs from its plain version by {err}")
    ms = time_ms(batched, KERNEL_REPS, device, device_only=True)
    singles_ms = time_ms(singles, KERNEL_REPS, device, device_only=True)
    plain_ms = time_ms(plain, 1, device, warm=False)
    bound = ""
    if RATES:
        bound_ms, bound_by, _ = bound_of(work)
        bound = f"; bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of it"
    print(f"kernel-vs-plain {name}: equal; batched kernel {ms:.4f} ms, {batch} single launches "
          f"{singles_ms:.4f} ms, plain {plain_ms:.4f} ms{bound}")
    return err, {"shape": name, "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms,
                 "work": work}


def batch_kernel_phase(device, seed: int, batch: int = BATCH, nv: int = BATCH_NV) -> dict:
    """Phase 6c: the batched round kernels at the 8 x nv=16 2x3 shapes (round
    0 over 2^15 lanes an instance, with and without coefficients; the
    in-place fold at A2=2^14 and tail extents; the out-of-place fold 2^15 ->
    2^14, with coefficients, and a tail), each instance with its own
    challenge, against their plain versions, array-equal, each beside the
    time of 8 single launches of the same work."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import round_cuda as rc

    rng = np.random.default_rng(seed + 6)
    half = 1 << (nv - 1)
    pairs = [random_pair(rng, SLOTS, half, device) for _ in range(batch)]
    lo, hi = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    del pairs
    products = ((0, 1, 2), (3, 4, 5))
    r = torch.from_numpy(np.stack([L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0]
                                   for _ in range(batch)]).astype(np.int32)).to(device)
    coeffs = torch.from_numpy(np.stack([
        np.stack([L.mont_scalar(int(rng.integers(1, 1 << 62)))[:, 0] for _ in products])
        for _ in range(batch)]).astype(np.int32)).to(device)
    rows = torch.zeros((batch, 4, 16), dtype=torch.int64, device=device)
    stats = {k: [0, []] for k in ("round_nofold_batched", "round_fold_batched",
                                  "round_step_fold_batched")}

    def record(kernel, res):
        stats[kernel][0] = max(stats[kernel][0], res[0])
        stats[kernel][1].append(res[1])

    for c in (None, coeffs):
        tag = " with coefficients" if c is not None else ""

        def nofold(c=c):
            return rc.round_nofold_batched(lo, hi, products, 3, half, rows.zero_(), c)

        def nofold_ref(c=c):
            return rc.round_nofold_batched_ref(lo, hi, products, 3, half, None, c)

        record("round_nofold_batched", _batch_case(
            f"round_nofold_batched {batch} x round 0 nv={nv} U=6 H=2^{nv - 1} d=3{tag}",
            lambda nofold=nofold, nofold_ref=nofold_ref: [(nofold(), nofold_ref())], nofold,
            lambda c=c: [rc.round_step_nofold(lo[b], hi[b], products, 3,
                                              None if c is None else c[b], rows[b])
                         for b in range(batch)],
            nofold_ref, batch, device,
            round_work(batch * half, SLOTS, products, 3, False, c is not None)))
    for a2 in (half // 2, 64, 3, 1):
        lo_k, hi_k = lo.clone(), hi.clone()

        def compare(a2=a2):
            pair_k, pair_p = (lo.clone(), hi.clone()), (lo.clone(), hi.clone())
            got = rc.round_fold_batched(*pair_k, r, products, 3, a2)
            want = rc.round_fold_batched_ref(*pair_p, r, products, 3, a2)
            return [(got, want), (pair_k[0], pair_p[0]), (pair_k[1], pair_p[1])]

        # the timed runs fold lo_k, hi_k again in place, round after round
        name = f"2^{a2.bit_length() - 1}" if a2 > 3 else str(a2)
        record("round_fold_batched", _batch_case(
            f"round_fold_batched {batch} x fold A2={name}", compare,
            lambda a2=a2, lo_k=lo_k, hi_k=hi_k: rc.round_fold_batched(
                lo_k, hi_k, r, products, 3, a2, rows.zero_()),
            lambda a2=a2, lo_k=lo_k, hi_k=hi_k: [
                rc.round_fold(lo_k[b], hi_k[b], r[b], products, 3, a2, rows[b])
                for b in range(batch)],
            lambda a2=a2, lo_k=lo_k, hi_k=hi_k: rc.round_fold_batched_ref(
                lo_k, hi_k, r, products, 3, a2),
            batch, device, round_work(batch * a2, SLOTS, products, 3, True)))
    for quarter, c in ((half // 2, None), (half // 2, coeffs), (64, None), (1, None)):
        w = 2 * quarter
        lo_w, hi_w = lo[..., :w].contiguous(), hi[..., :w].contiguous()
        name = f"2^{w.bit_length() - 1} -> " + (f"2^{quarter.bit_length() - 1}" if quarter > 1
                                                else "1")
        tag = " with coefficients" if c is not None else ""

        def step(c=c, lo_w=lo_w, hi_w=hi_w):
            return _flat(rc.round_step_fold_batched(lo_w, hi_w, r, products, 3, c, rows.zero_()))

        def step_ref(c=c, lo_w=lo_w, hi_w=hi_w):
            return _flat(rc.round_step_fold_batched_ref(lo_w, hi_w, r, products, 3, c))

        record("round_step_fold_batched", _batch_case(
            f"round_step_fold_batched {batch} x fold {name}{tag}",
            lambda step=step, step_ref=step_ref: list(zip(step(), step_ref())), step,
            lambda c=c, lo_w=lo_w, hi_w=hi_w: [
                rc.round_step_fold(lo_w[b], hi_w[b], r[b], products, 3,
                                   None if c is None else c[b], rows[b])
                for b in range(batch)],
            step_ref, batch, device,
            round_work(batch * quarter, SLOTS, products, 3, True, c is not None)))
    return stats


def _flat(res):
    """((new_lo, new_hi), sums) -> (sums, new_lo, new_hi)."""
    (new_lo, new_hi), sums = res
    return sums, new_lo, new_hi


def batch_transcript_phase(device, seed: int, batch: int = BATCH, rounds: int = 16,
                           degree: int = 3) -> dict:
    """Phase 6d: the batched transcript step over `rounds` rounds of 8
    transcripts that hold unequal pending byte counts, against its plain
    version (the first round: a plain step takes a fifth of a second) and
    against the host rng (every round, every instance: challenges and final
    states); its device time per round beside 8 single steps' and its
    latency bound: the most compressions any instance needed in a round,
    averaged over the rounds, at the single step's rate, plus one launch."""
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcripts, restore_transcript

    gen = np.random.default_rng(seed + 7)
    hosts = []
    for b in range(batch):
        host = Blake2b512Rng.setup()
        host.feed_bytes(gen.bytes(8 * ((5 * b + 3) % 17)))
        hosts.append(host)
    state0 = lift_transcripts(hosts, device)
    blens = [int(state0[b, 25, 0]) for b in range(batch)]
    check(len(set(blens)) > 1, "the batch's transcripts hold equal pending byte counts")
    sums = torch.from_numpy(gen.integers(0, 1 << 40, size=(rounds, batch, degree + 1, 16),
                                         dtype=np.int64)).to(device)

    def buffers(n):
        return (torch.empty((n, batch, 16, degree + 1), dtype=torch.int32, device=device),
                torch.empty((n, batch, 16), dtype=torch.int32, device=device))

    state_k, state_p = state0.clone(), state0.clone()
    (msgs, rs), (msgs_p, rs_p) = buffers(rounds), buffers(1)
    for j in range(rounds):
        tc.transcript_step_batched(state_k, sums[j], msgs, rs, j)
    plain_ms = time_ms(lambda: tc.transcript_step_batched_ref(state_p, sums[0], msgs_p, rs_p, 0),
                       1, device, warm=False)
    err = max(max_diff(a.long(), b.long())
              for a, b in ((msgs[:1], msgs_p), (rs[:1], rs_p)))
    check(err == 0, f"batched transcript kernel differs from plain by {err}")
    worst = [0] * rounds
    rejected = 0
    for b, host in enumerate(hosts):
        rej, per_round, blen, _tries = host_replay(host, msgs[:, b].cpu(), rs[:, b].cpu(),
                                                   blens[b], degree,
                                                   f"batched transcript instance {b}")
        rejected += rej
        worst = [max(w, n) for w, n in zip(worst, per_round)]
        probe = Blake2b512Rng.setup()
        restore_transcript(probe, state_k[b].cpu())
        check(probe.state_tuple() == host.state_tuple(),
              f"batched transcript instance {b}: state differs from the host rng's")
        check(blen == int(state_k[b, 25, 0]), f"instance {b}: pending bytes differ")

    def rounds_from(step):
        it = iter(range(rounds))
        return lambda: step(next(it))

    def batched_pass():
        st = state0.clone()
        return rounds_from(lambda j: tc.transcript_step_batched(st, sums[j], msgs, rs, j))

    def singles_pass():
        sts = [state0[b].clone() for b in range(batch)]
        outs = [(torch.empty((rounds, 16, degree + 1), dtype=torch.int32, device=device),
                 torch.empty((rounds, 16), dtype=torch.int32, device=device))
                for _ in range(batch)]
        sums_b = [[sums[j, b].contiguous() for b in range(batch)] for j in range(rounds)]

        def step(j):
            for b in range(batch):
                tc.transcript_step(sts[b], sums_b[j][b], *outs[b], j)
        return rounds_from(step)

    ms = statistics.median(time_ms(batched_pass(), rounds, device, device_only=True, warm=False)
                           for _ in range(3))
    singles_ms = statistics.median(time_ms(singles_pass(), rounds, device, device_only=True,
                                           warm=False) for _ in range(3))
    bound = transcript_bound(device, sum(worst) / rounds)
    print(f"batched transcript kernel-vs-plain, {batch} transcripts (pending bytes {blens}), "
          f"{rounds} rounds d={degree}: equal, equal to the host rngs ({rejected} draws "
          f"rejected); kernel {ms:.4f} ms per round for all {batch}, {batch} single steps "
          f"{singles_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
          f"({bound['compressions']:.2f} compressions a round at most), "
          f"{bound['bound_ms'] / ms:.1%} of it")
    return {"transcript_step_batched": [err, [{
        "shape": f"one round of {batch} transcripts, d={degree}", "ms": ms,
        "singles_ms": singles_ms, "plain_ms": plain_ms, "bound": bound}]]}


BATCH_PATHS = {"batch ml generic": "generic", "batch ml per-size": "persize"}


def batch_ml_phase(device, seed: int, reps: int, path: str, batch: int = BATCH,
                   nv: int = BATCH_NV) -> dict:
    """Phase 10: `BatchedMLSumcheck.prove` on 8 instances of 2 x 3 at nv=16
    (`bench.py:302-310`) on one chain (`BATCH_PATHS`): the first prove and
    the warm median per batch and per proof, launches per batch (one pair
    init an instance, then two a round), the batched chain under the sync
    debug mode "error", the kernels of one profiled batch, proofs
    byte-equal to per-instance card proves (timed beside it), all verified,
    two subclaims against their polynomials, the idle share."""
    chain = BATCH_PATHS[path]
    with fold_mode(chain):
        return _batch_ml(device, seed, reps, path, chain, batch, nv)


def _batch_ml(device, seed, reps, path, chain, batch, nv) -> dict:
    from sumcheck_tpu_torch import MLSumcheck
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    polys = headline_polys(seed, nv, batch)
    with syncs_forbidden_in_chains():
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        proofs = BatchedMLSumcheck.prove(polys, device=device)
        first_s = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = BatchedMLSumcheck.prove(polys, device=device)
            walls.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters().items()}
    proves = reps + 1
    fold = "round_fold_batched" if chain == "generic" else "round_step_fold_batched"
    want = {k: 0 for k in launches}
    want.update({"pair_init": batch * proves, "round_nofold_batched": proves,
                 fold: (nv - 1) * proves, "transcript_step_batched": nv * proves})
    check(launches == want, f"{path}: launch counts {launches} over {proves} batches, "
                           f"expected {want}")
    blobs = [serialize_proof(p) for p in proofs]
    check([serialize_proof(p) for p in again] == blobs, f"{path}: warm batches differ")
    prove_s = statistics.median(walls)

    t0 = time.perf_counter()
    alone = [serialize_proof(MLSumcheck.prove(p, device=device)) for p in polys]
    alone_s = time.perf_counter() - t0
    check(blobs == alone, f"{path}: batched proofs differ from per-instance card proves")
    subs = BatchedMLSumcheck.verify([p.info() for p in polys],
                                    [MLSumcheck.extract_sum(pf) for pf in proofs], proofs)
    for b in (0, batch - 1):
        check(polys[b].evaluate(subs[b].point) == subs[b].expected_evaluation,
              f"{path}: instance {b}'s subclaim does not match its polynomial")

    busy = device_busy(lambda: BatchedMLSumcheck.prove(polys, device=device))
    k = busy["kernels"]
    for f in counters().values():
        f.launches = 0
    print(f"headline {path}, {batch} x nv={nv} 2x3: first {first_s:.4f} s, median of {reps} warm "
          f"{prove_s:.4f} s a batch = {prove_s / batch:.5f} s a proof, walls "
          f"{[round(w, 4) for w in walls]}; {batch} per-instance card proves {alone_s:.4f} s")
    print(f"{path} launches over {proves} batches: { {k: v for k, v in launches.items() if v} }, "
          f"no sync inside the batched chain; the profiled batch launched {sum(k.values())} "
          f"kernels: {k['round']} round kernels ({busy['device_ms']['round']:.4f} ms of device "
          f"time), {k['transcript']} transcript steps ({busy['device_ms']['transcript']:.4f} ms), "
          f"{k['other']} other (the {batch} pair inits, the sums buffer fill)")
    print(f"{path}: proofs byte-equal to per-instance card proves, all {batch} verified, "
          f"subclaims of instances 0 and {batch - 1} equal poly.evaluate(point)")
    print_busy(path, busy)
    return {"launches": launches, "prove_s": prove_s, "per_proof_s": prove_s / batch,
            "first_s": first_s, "alone_s": alone_s, "busy": busy, "proofs": blobs}


def gkr_batch_instances(seed: int, dim: int = GKR_BATCH_DIM, batch: int = BATCH) -> list:
    """`bench.py:313-328`'s batch: f1 with 2^dim nonzeros over 3 dim
    variables and g from one `random.Random(11)`, f2 and f3 by the table rule
    from `numpy.random.default_rng(seed)`, instance after instance."""
    from sumcheck_tpu_torch import DenseMLE, Fr, SparseMLE
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.fields.limbs_np import random_tables

    prnd = random.Random(11)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        f1 = SparseMLE.rand_with_config(3 * dim, 1 << dim, prnd)
        f2, f3 = (DenseMLE(dim, t) for t in random_tables(rng, dim, 2))
        out.append((f1, f2, f3, [Fr(prnd.randrange(P)) for _ in range(dim)]))
    return out


def gkr_batch_phase(device, seed: int, reps: int, batch: int = BATCH,
                    dim: int = GKR_BATCH_DIM) -> dict:
    """Phase 11: `BatchedGKRRoundSumcheck.prove` on 8 instances at dim 14
    with 2^14 nonzeros each (`bench.py:313-338`) on the generic chain: the
    first prove and the warm median per batch and per proof, launches per
    batch (two batched chains of dim rounds, two launches a round), the
    whole enqueue under the sync debug mode "error", proofs byte-equal to
    per-instance card proves (timed beside it), all verified, two subclaims.
    (No profile: the GKR headline's profile covers the same kernels.)"""
    with fold_mode("generic"):
        return _gkr_batch(device, seed, reps, batch, dim)


def _gkr_batch(device, seed, reps, batch, dim) -> dict:
    from sumcheck_tpu_torch import Blake2b512Rng, GKRRoundSumcheck
    from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck

    path = "batch gkr generic"
    insts = gkr_batch_instances(seed, dim, batch)
    args = [list(t) for t in zip(*insts)]

    def prove():
        return BatchedGKRRoundSumcheck.prove([Blake2b512Rng.setup() for _ in range(batch)], *args,
                                             device=device)

    with syncs_forbidden_in_chains():
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        proofs = prove()
        first_s = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = prove()
            walls.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters().items()}
    proves = reps + 1
    want = {k: 0 for k in launches}
    want.update({"round_nofold_batched": 2 * proves, "round_fold_batched": 2 * (dim - 1) * proves,
                 "transcript_step_batched": 2 * dim * proves})
    # each phase's inits of all B instances in one launch (the weight reduce's instance axis)
    want.update({"weight_reduce_batched": 2 * proves})
    check(launches == want, f"{path}: launch counts {launches} over {proves} batches, "
                           f"expected {want}")
    blobs = [p.serialize_uncompressed() for p in proofs]
    check([p.serialize_uncompressed() for p in again] == blobs, f"{path}: warm batches differ")
    prove_s = statistics.median(walls)
    # the batch wall against the parent's enqueue (one init launch per
    # instance and phase), in turns parent, change, change, parent
    from sumcheck_tpu_torch import batch as batch_mod

    turns = {"parent": [], "change": []}
    for kind in ("parent", "change", "change", "parent") * reps:
        saved = batch_mod._enqueue_gkr
        if kind == "parent":
            batch_mod._enqueue_gkr = parent_enqueue_gkr
        try:
            for f in counters().values():
                f.launches = 0
            t0 = time.perf_counter()
            got = prove()
            turns[kind].append(time.perf_counter() - t0)
            inits = counters()["weight_reduce"].launches + \
                counters()["weight_reduce_batched"].launches
        finally:
            batch_mod._enqueue_gkr = saved
        check([p.serialize_uncompressed() for p in got] == blobs,
              f"{path}: the {kind} enqueue proves other bytes")
        check(inits == (2 * batch if kind == "parent" else 2),
              f"{path}: the {kind} enqueue made {inits} init launches")
    parent_s, change_s = (statistics.median(turns[k]) for k in ("parent", "change"))
    print(f"{path}: batch wall, median of {2 * reps} each in turns: {change_s:.4f} s with 2 init "
          f"launches a batch, {parent_s:.4f} s with the parent's {2 * batch} "
          f"({change_s / parent_s:.1%} of it); walls change "
          f"{[round(w, 4) for w in turns['change']]}, parent "
          f"{[round(w, 4) for w in turns['parent']]}")
    t0 = time.perf_counter()
    alone = [GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device=device)
             .serialize_uncompressed() for inst in insts]
    alone_s = time.perf_counter() - t0
    check(blobs == alone, f"{path}: batched proofs differ from per-instance card proves")
    subs = [GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, p, p.extract_sum())
            for p in proofs]
    t0 = time.perf_counter()
    for b in (0, batch - 1):
        check(subs[b].verify_subclaim(*insts[b]), f"{path}: instance {b}'s subclaim fails")
    subclaim_s = time.perf_counter() - t0
    for f in counters().values():
        f.launches = 0
    print(f"headline {path}, {batch} x dim={dim} (nnz 2^{dim}): first {first_s:.4f} s, median of "
          f"{reps} warm {prove_s:.4f} s a batch = {prove_s / batch:.4f} s a proof, walls "
          f"{[round(w, 4) for w in walls]}; {batch} per-instance card proves {alone_s:.4f} s")
    print(f"{path} launches over {proves} batches: { {k: v for k, v in launches.items() if v} }, "
          f"no sync between the uploads and the fetch; proofs byte-equal to per-instance card "
          f"proves, all {batch} verified, subclaims of instances 0 and {batch - 1} hold "
          f"({subclaim_s:.2f} s on the host)")
    return {"launches": launches, "prove_s": prove_s, "per_proof_s": prove_s / batch,
            "first_s": first_s, "alone_s": alone_s, "proofs": blobs,
            "parent_loop_s": parent_s, "turns_s": change_s}


# --- fault F5: a GKR f1 with no entries (a layer with no gate of one kind)

F5_DIMS = (1, 14)


def f5_empty_f1_phase(device, seed: int) -> dict:
    """Phase 10's fault F5: `GKRRoundSumcheck.prove` with an f1 of no
    entries (split as one zero entry, so no kernel reads an empty table) at
    dim 1 and 14 on the three paths (`PATHS`), each run with every launch
    count set to 0 just before it and read just after (2 round 0s, 2 (dim -
    1) folds, 2 dim transcript steps and the 2 fused init launches), the
    enqueue under the sync debug mode "error": bytes equal across the
    paths, to the same prove's plain path on the card (plain round versions
    and transcript) and to the CPU's prove (every plain version); the sum 0,
    verified, the subclaim holding. Then `BatchedGKRRoundSumcheck` of two
    empty f1s at dim 14 (one batched weight reduce a phase) against their
    single card proves. Returns {"f5 gkr <path> dim <dim>" and "f5 gkr
    batch": {"launches", "prove_s"}}."""
    from sumcheck_tpu_torch import (Blake2b512Rng, DenseMLE, Fr, GKRRoundSumcheck,
                                    SparseMLE)
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.ops import transcript_cuda as tc

    gen = np.random.default_rng(seed + 5)

    def instance(dim):
        f2, f3 = (DenseMLE(dim, t) for t in L.random_tables(gen, dim, 2))
        return (SparseMLE.from_pairs(3 * dim, []), f2, f3,
                [Fr(int(gen.integers(1, 1 << 62))) for _ in range(dim)])

    out = {}
    for dim in F5_DIMS:
        inst = instance(dim)
        blobs = {}
        for path, (chain, mxu) in PATHS.items():
            kernels = path_kernels(chain, mxu)
            with fold_mode(chain, mxu), syncs_forbidden_in_chains():
                for f in counters().values():
                    f.launches = 0
                t0 = time.perf_counter()
                proof = GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device=device)
                prove_s = time.perf_counter() - t0
                launches = {k: f.launches for k, f in counters().items()}
            want = {k: 0 for k in launches}
            want.update({kernels[0]: 2, kernels[1]: 2 * (dim - 1), "transcript_step": 2 * dim,
                         **INIT_LAUNCHES})
            check(launches == want, f"F5 dim {dim} {path}: launches {launches}, expected {want}")
            blobs[path] = proof.serialize_uncompressed()
            out[f"f5 gkr {path} dim {dim}"] = {"launches": launches, "prove_s": prove_s}
        t0 = time.perf_counter()
        plain = G._prove_chained(Blake2b512Rng.setup(), *inst, dim, device,
                                 round_fns=(rc.round_nofold_ref, rc.round_fold_ref),
                                 transcript_fn=tc.transcript_step_ref)
        plain_s = time.perf_counter() - t0
        cpu = GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device="cpu")
        check(len(set(blobs.values()) | {plain.serialize_uncompressed(),
                                         cpu.serialize_uncompressed()}) == 1,
              f"F5 dim {dim}: the paths, the plain path and the CPU prove different bytes")
        check(proof.extract_sum().v == 0, f"F5 dim {dim}: the sum is not 0")
        sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, proof, proof.extract_sum())
        check(sub.verify_subclaim(*inst), f"F5 dim {dim}: the subclaim does not hold")
        print(f"F5 empty f1 dim {dim}: proof bytes equal on the generic, per-size and MXU paths "
              f"(" + ", ".join(f"{p} {out[f'f5 gkr {p} dim {dim}']['prove_s']:.4f} s"
                               for p in PATHS)
              + f"), the plain path on the card ({plain_s:.4f} s) and the CPU; sum 0, verified, "
              f"subclaim holds; launches { {k: v for k, v in want.items() if v} }")
    dim = F5_DIMS[-1]
    insts = [instance(dim) for _ in range(2)]
    alone = [GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *i, device=device)
             .serialize_uncompressed() for i in insts]
    with syncs_forbidden_in_chains():
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        proofs = BatchedGKRRoundSumcheck.prove([Blake2b512Rng.setup() for _ in insts],
                                               *(list(t) for t in zip(*insts)), device=device)
        prove_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters().items()}
    want = {k: 0 for k in launches}
    want.update({"round_nofold_batched": 2, "round_fold_batched": 2 * (dim - 1),
                 "transcript_step_batched": 2 * dim, "weight_reduce_batched": 2})
    check(launches == want, f"F5 batch: launches {launches}, expected {want}")
    check([p.serialize_uncompressed() for p in proofs] == alone,
          "F5 batch: proofs differ from per-instance card proves")
    out["f5 gkr batch"] = {"launches": launches, "prove_s": prove_s}
    print(f"F5 batch of 2 empty f1s at dim {dim}: {prove_s:.4f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }; proofs equal per-instance card proves")
    return out


# --- fault F4: product structures past the kernels' by-value plan, on their
# wide route (`round_cuda.route`; the pair init's and the transcript step's
# wide bodies)

F4_NV = 20
F4_CHECK_NV = 12  # the size at which the card's proofs meet the CPU's plain prove
# F4's `wide` structure (61 slots, 41 products, degree 20: two chunks of the
# wide route's 12 points), this many variables below the others: its
# kernels at nv=14, where their plain versions take seconds; its proves at
# nv=18, their bytes against the CPU's plain prove at nv=8
F4_WIDE_KERNEL_CUT, F4_WIDE_CUT, F4_WIDE_CHECK_CUT = 6, 2, 4
F4_BATCH, F4_BATCH_NV = 4, 16
F4_TRANSCRIPT_DEGREES = (9, 20)
F4_CHAINS = {"generic": ("generic", False), "per-size": ("persize", False),
             "mxu": ("generic", True)}
# the wide rows of the kernels line: (row, wrapper, F4 run whose launches it reports)
F4_ROWS = (("round_nofold[wide]", "round_nofold", "f4 generic a"),
           ("round_fold[wide]", "round_fold", "f4 generic a"),
           ("round_step_nofold[wide]", "round_step_nofold", "f4 per-size a"),
           ("round_step_fold[wide]", "round_step_fold", "f4 per-size a"),
           ("round_fold_mxu[wide]", "round_fold_mxu", "f4 mxu a"),
           ("transcript_step[wide]", "transcript_step", "f4 generic b"),
           ("pair_init[wide]", "pair_init", "f4 generic a"),
           ("round_nofold_batched[wide]", "round_nofold_batched", "f4 batch generic"),
           ("round_fold_batched[wide]", "round_fold_batched", "f4 batch generic"),
           ("round_step_fold_batched[wide]", "round_step_fold_batched", "f4 batch per-size"),
           ("transcript_step_batched[wide]", "transcript_step_batched", "f4 batch generic"))


def f4_structure(name: str):
    """Fault F4's structures (`tests/f4_cases.py`): (a) 17 products of one
    table (17 slots), (b) one product of 9 tables (degree 9), (c) 17 pairs
    of 7 tables with coefficients 2..18 (17 products), `wide`: a product of
    20 tables beside 40 single-table products, random coefficients (61
    slots with the ones slot, 41 products, degree 20). (products, table
    count)."""
    if name == "a":
        return [(1, [i]) for i in range(17)], 17
    if name == "b":
        return [(1, list(range(9)))], 9
    if name == "wide":
        rnd = random.Random(name)
        return [(rnd.randrange(2, 1 << 62), list(range(20)))] + [
            (rnd.randrange(2, 1 << 62), [20 + i]) for i in range(40)], 60
    import itertools

    pairs = list(itertools.combinations(range(7), 2))[:17]
    return [(2 + i, list(ix)) for i, ix in enumerate(pairs)], 7


def f4_poly(name: str, seed: int, nv: int):
    from sumcheck_tpu_torch.convert import polynomial_from_numpy
    from sumcheck_tpu_torch.fields.limbs_np import random_tables

    products, count = f4_structure(name)
    rng = np.random.default_rng(seed + 1000 * count + nv)
    return polynomial_from_numpy(nv, random_tables(rng, nv, count), products)


def f4_kernel_phase(device, seed: int, nv: int = F4_NV) -> dict:
    """Phase 6f: each kernel's wide route against its plain version on the
    card, array-equal, at F4's shapes ((a) at nv=20: 17 slots at degree 1;
    (b) and (c) at nv=18: 9 slots at degree 9, and 23 slots, 17 products at
    degree 2; the pair built by `init_pair`, one pair-init launch): round 0 and the in-place
    fold of the generic chain, the per-size round 0 and fold, the MXU fold,
    the pair init; the transcript step at degrees 9 and 20 against the
    plain step and the host rng. Device ms, plain ms and each bound
    (`round_work`: the function's bytes and the Montgomery multiplies of
    its evaluation schedule, not the wide body's re-reads). Returns the
    stats of the kernels line's wide rows, (a)'s shapes first."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.protocol.device_prover import init_pair

    rng = np.random.default_rng(seed + 16)
    r = torch.from_numpy(
        L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0].astype(np.int32)).to(device)
    stats = {row: [0, []] for row, _w, _p in F4_ROWS if "batched" not in row}

    def record(row, res, shape, work):
        err, ms, plain_ms = res[:3]
        stats[row][0] = max(stats[row][0], err)
        entry = {"shape": shape, "ms": ms, "plain_ms": plain_ms, "work": work}
        stats[row][1].append(entry)
        if RATES:
            bound_ms, bound_by, _ = bound_of(work)
            print(f"F4 {row} at {shape}: bound {bound_ms:.4f} ms by {bound_by}, "
                  f"{bound_ms / ms:.1%} of it")

    for name in ("a", "b", "c", "wide"):
        # (a) at nv=20, the rows' main shape; (b) and (c) at nv=18 (their
        # plain versions take seconds at nv=20), `wide` at nv=14
        n = {"a": nv, "wide": nv - F4_WIDE_KERNEL_CUT}.get(name, nv - 2)
        poly = f4_poly(name, seed, n)
        lo, hi, products, degree = init_pair(poly, device)
        slots, half = lo.shape[0], lo.shape[2]
        check(rc.route(slots, products, degree) == "wide",
              f"F4 ({name}) does not take the wide route")
        tag = (f"F4 ({name}) nv={n} U={slots} P={len(products)} d={degree} "
               f"T={rc.wide_points(degree)}")
        record("round_nofold[wide]",
               compare_round(rc, f"{tag} round 0", lo, hi, None, products, degree, half,
                             device, True),
               f"{tag} round 0 H=2^{n - 1}", round_work(half, slots, products, degree, False))
        record("round_fold[wide]",
               compare_round(rc, f"{tag} fold", lo, hi, r, products, degree, half // 2,
                             device, True),
               f"{tag} fold A2=2^{n - 2}", round_work(half // 2, slots, products, degree, True))
        record("round_step_nofold[wide]",
               compare_step(rc, f"{tag} per-size round 0", lo, hi, None, products, degree, None,
                            device),
               f"{tag} per-size round 0", round_work(half, slots, products, degree, False))
        record("round_step_fold[wide]",
               compare_step(rc, f"{tag} per-size fold", lo, hi, r, products, degree, None,
                            device),
               f"{tag} per-size fold 2^{n - 1} -> 2^{n - 2}",
               round_work(half // 2, slots, products, degree, True))
        record("round_fold_mxu[wide]",
               compare_mxu(rc, f"{tag} MXU fold", lo, hi, r, products, degree, half // 2, device),
               f"{tag} MXU fold A2=2^{n - 2}",
               round_work(half // 2, slots, products, degree, True, mma=True))
        del lo, hi
        err, (entry,) = pair_init_phase(device, seed, n, poly, f"F4 ({name})")["pair_init"]
        record("pair_init[wide]", (err, entry["ms"], entry["plain_ms"]), entry["shape"],
               entry["work"])
        torch.cuda.empty_cache()
    for degree in F4_TRANSCRIPT_DEGREES:
        err, (entry,) = transcript_phase(device, seed + degree, rounds=24,
                                         degree=degree)["transcript_step"]
        stats["transcript_step[wide]"][0] = max(stats["transcript_step[wide]"][0], err)
        stats["transcript_step[wide]"][1].append(entry)
    return stats


def f4_batch_kernel_phase(device, seed: int, batch: int = F4_BATCH,
                          nv: int = F4_BATCH_NV) -> dict:
    """Phase 6g: the batched round kernels and the batched transcript step
    on the wide route, at F4 (b)'s shape (9 slots, degree 9), 4 x nv=16,
    each instance with its own challenge, against their plain versions,
    array-equal, each beside the time of 4 single launches."""
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.protocol.device_prover import init_pairs

    polys = [f4_poly("b", seed + b, nv) for b in range(batch)]
    lo, hi, products, degree = init_pairs(polys, device)
    slots, half = lo.shape[1], lo.shape[3]
    check(rc.route(slots, products, degree) == "wide", "F4 (b) does not take the wide route")
    rng = np.random.default_rng(seed + 17)
    r = torch.from_numpy(np.stack([L.mont_scalar(int(rng.integers(1, 1 << 62)) % P)[:, 0]
                                   for _ in range(batch)]).astype(np.int32)).to(device)
    rows = torch.zeros((batch, degree + 1, 16), dtype=torch.int64, device=device)
    tag = f"{batch} x F4 (b) nv={nv} U={slots} d={degree}"
    stats = {}

    def record(row, res):
        stats.setdefault(row, [0, []])
        stats[row][0] = max(stats[row][0], res[0])
        stats[row][1].append(res[1])

    record("round_nofold_batched[wide]", _batch_case(
        f"round_nofold_batched {tag} round 0",
        lambda: [(rc.round_nofold_batched(lo, hi, products, degree, half, rows.zero_()),
                  rc.round_nofold_batched_ref(lo, hi, products, degree, half))],
        lambda: rc.round_nofold_batched(lo, hi, products, degree, half, rows.zero_()),
        lambda: [rc.round_nofold(lo[b], hi[b], products, degree, half, rows[b])
                 for b in range(batch)],
        lambda: rc.round_nofold_batched_ref(lo, hi, products, degree, half), batch, device,
        round_work(batch * half, slots, products, degree, False)))
    lo_k, hi_k = lo.clone(), hi.clone()

    def fold_compare():
        pair_k, pair_p = (lo.clone(), hi.clone()), (lo.clone(), hi.clone())
        got = rc.round_fold_batched(*pair_k, r, products, degree, half // 2)
        want = rc.round_fold_batched_ref(*pair_p, r, products, degree, half // 2)
        return [(got, want), (pair_k[0], pair_p[0]), (pair_k[1], pair_p[1])]

    record("round_fold_batched[wide]", _batch_case(
        f"round_fold_batched {tag} fold", fold_compare,
        lambda: rc.round_fold_batched(lo_k, hi_k, r, products, degree, half // 2, rows.zero_()),
        lambda: [rc.round_fold(lo_k[b], hi_k[b], r[b], products, degree, half // 2, rows[b])
                 for b in range(batch)],
        lambda: rc.round_fold_batched_ref(lo_k, hi_k, r, products, degree, half // 2),
        batch, device, round_work(batch * half // 2, slots, products, degree, True)))
    record("round_step_fold_batched[wide]", _batch_case(
        f"round_step_fold_batched {tag} fold",
        lambda: list(zip(_flat(rc.round_step_fold_batched(lo, hi, r, products, degree, None,
                                                          rows.zero_())),
                         _flat(rc.round_step_fold_batched_ref(lo, hi, r, products, degree)))),
        lambda: rc.round_step_fold_batched(lo, hi, r, products, degree, None, rows.zero_()),
        lambda: [rc.round_step_fold(lo[b], hi[b], r[b], products, degree, None, rows[b])
                 for b in range(batch)],
        lambda: rc.round_step_fold_batched_ref(lo, hi, r, products, degree), batch, device,
        round_work(batch * half // 2, slots, products, degree, True)))
    err, (entry,) = batch_transcript_phase(device, seed, batch, rounds=8,
                                           degree=degree)["transcript_step_batched"]
    stats["transcript_step_batched[wide]"] = [err, [entry]]
    return stats


# --- fault F6: the transcript step past the degree that a block's shared
# memory once set (7,241 on the H100), in its fixed window

F6_TRANSCRIPT_DEGREE = 8000
F6_DEGREE, F6_NV = 7300, 2  # the ML prove: one product of 7,300 repeats of one table
F6_PREFIXES = (40, 128)  # pending bytes of the two transcripts (the single step's first)


def f6_operands(seed: int, batched: bool, device):
    """Phase 6f's F6 step: (state, sums, msgs, rs, host rngs) of one round at
    degree 8,000, a single transcript fed 40 bytes or, `batched`, two fed
    40 and 128 bytes, each with its own sums, from `default_rng(seed + 8000)`."""
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.protocol.device_prover import lift_transcript, lift_transcripts

    gen = np.random.default_rng(seed + 8000)
    d1 = F6_TRANSCRIPT_DEGREE + 1
    sums = gen.integers(0, 1 << 40, size=(len(F6_PREFIXES), d1, 16), dtype=np.int64)
    hosts = []
    for blen in F6_PREFIXES:
        hosts.append(Blake2b512Rng.setup())
        hosts[-1].feed_bytes(gen.bytes(blen))
    n = len(F6_PREFIXES) if batched else 1
    state = lift_transcripts(hosts, device) if batched else lift_transcript(hosts[0], device)
    lead = (1, n) if batched else (1,)
    msgs = torch.zeros(lead + (16, d1), dtype=torch.int32, device=device)
    rs = torch.zeros(lead + (16,), dtype=torch.int32, device=device)
    sums = torch.from_numpy(sums if batched else sums[0]).to(device)
    return state, sums, msgs, rs, hosts[:n]


def f6_plain(seed: int) -> dict:
    """The plain step (single) and the plain batched step over `f6_operands`
    on the CPU: {False: (state, msgs, rs), True: (...), "seconds": ...}
    (`--plain-f6`, a process of its own started with the build: a plain
    step at degree 8,000 takes about 15 s on the host)."""
    from sumcheck_tpu_torch.ops import transcript_cuda as tc

    out, t0 = {}, time.perf_counter()
    for batched in (False, True):
        state, sums, msgs, rs, _hosts = f6_operands(seed, batched, torch.device("cpu"))
        (tc.transcript_step_batched_ref if batched else tc.transcript_step_ref)(
            state, sums, msgs, rs, 0)
        out[batched] = (state, msgs, rs)
    out["seconds"] = time.perf_counter() - t0
    return out


def f6_transcript_phase(device, seed: int, plain) -> dict:
    """Phase 6f's fault F6: the transcript step at degree 8,000, single and
    batched (two transcripts of 40 and 128 pending bytes), one launch each,
    array-equal to the plain versions' (`plain()` waits for the `--plain-f6`
    process) and to the host rngs (message, challenge, state), the pending
    bytes equal to `stream_compactions`' model of the window; its device ms
    and latency bound. Returns {row: timing entry} for the wide rows."""
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.ops import transcript_cuda as tc
    from sumcheck_tpu_torch.protocol.device_prover import restore_transcript

    degree, want, out = F6_TRANSCRIPT_DEGREE, plain(), {}
    for batched in (False, True):
        step = tc.transcript_step_batched if batched else tc.transcript_step
        row = "transcript_step_batched[wide]" if batched else "transcript_step[wide]"
        state, sums, msgs, rs, hosts = f6_operands(seed, batched, device)
        state0 = state.clone()
        before = step.launches
        step(state, sums, msgs, rs, 0)
        sync(device)
        check(step.launches - before == 1, f"F6 {row}: not one launch")
        err = max(max_diff(a.cpu(), b) for a, b in zip((state, msgs, rs), want[batched]))
        check(err == 0, f"F6 {row} at d={degree}: kernel differs from plain by {err}")
        states = state.cpu() if batched else state.cpu()[None]
        blens = (state0.cpu() if batched else state0.cpu()[None])[:, 25, 0].tolist()
        worst = 0
        for b, (host, blen0) in enumerate(zip(hosts, blens)):
            m = msgs[:, b] if batched else msgs
            r = rs[:, b] if batched else rs
            _rej, per_round, blen, tries = host_replay(host, m.cpu(), r.cpu(), blen0, degree,
                                                       f"F6 {row} instance {b}")
            worst = max(worst, per_round[0])
            probe = Blake2b512Rng.setup()
            restore_transcript(probe, states[b])
            check(probe.state_tuple() == host.state_tuple(),
                  f"F6 {row} instance {b}: state differs from the host rng's")
            _n, pending = stream_compactions(blen0, degree + 1, tries[0])
            check(pending == blen == int(states[b, 25, 0]),
                  f"F6 {row} instance {b}: the window model's pending bytes differ from the card's")
        ms = time_ms(lambda: step(state0, sums, msgs, rs, 0), 5, device, device_only=True)
        bound = transcript_bound(device, worst)
        print(f"F6 {row}, one round d={degree} ({len(hosts)} transcript(s), pending bytes "
              f"{list(F6_PREFIXES[:len(hosts)])}): one launch, equal to the plain version (on the "
              f"host's CPU, {want['seconds']:.1f} s for both) and to the host rng; kernel "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({worst} compressions), {bound['bound_ms'] / ms:.1%} of it")
        out[row] = {"shape": f"one round{' of 2 transcripts' if batched else ''}, d={degree}",
                    "ms": ms, "plain_ms": None, "bound_ms": bound["bound_ms"],
                    "compressions": worst, "max_abs_err": err}
    return out


def f6_prove_phase(device, seed: int) -> dict:
    """Phase 10f's fault F6: `MLSumcheck.prove` of one product of 7,300
    repeats of one table at nv=2 (degree 7,300) on the generic chain (the
    wide route's round 0 and fold, the pair init and the transcript step
    in its window), with every launch count set to 0 just before it and
    read just after, the enqueue under the sync debug mode "error"; its
    bytes equal to the host-transcript loop's on the card
    (`HostTranscriptRng`: the same kernels, the transcript on the host);
    verified, the subclaim the polynomial at the point. A prove takes
    about a minute on the card (its one or two lanes evaluate 7,301 points
    on one warp), so the per-size and MXU chains at this degree are
    `tests/test_torch_cuda.py`'s (`-k degree_7300`). Returns {"f6
    generic": {"launches", "prove_s"}}."""
    from sumcheck_tpu_torch import MLSumcheck
    from sumcheck_tpu_torch.convert import polynomial_from_numpy
    from sumcheck_tpu_torch.fields.limbs_np import random_tables
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    nv = F6_NV
    poly = polynomial_from_numpy(nv, random_tables(np.random.default_rng(seed + F6_DEGREE), nv, 1),
                                 [(1, [0] * F6_DEGREE)])
    with fold_mode("generic"), syncs_forbidden_in_chains():
        for f in counters().values():
            f.launches = 0
        t0 = time.perf_counter()
        proof = MLSumcheck.prove(poly, device=device)
        prove_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters().items()}
    want = {k: 0 for k in launches}
    want.update({"round_nofold": 1, "round_fold": nv - 1, "transcript_step": nv,
                 "pair_init": 1})
    check(launches == want, f"F6: launches {launches}, expected {want}")
    print(f"F6 degree {F6_DEGREE} nv={nv} generic: prove {prove_s:.4f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }, no sync inside the chain")
    t0 = time.perf_counter()
    host, _ = MLSumcheck.prove_as_subprotocol(HostTranscriptRng(), poly, device=device)
    host_s = time.perf_counter() - t0
    check(serialize_proof(host) == serialize_proof(proof),
          "F6: the chain and the host-transcript loop prove different bytes")
    sub = MLSumcheck.verify(poly.info(), MLSumcheck.extract_sum(proof), proof)
    check(poly.evaluate(sub.point) == sub.expected_evaluation,
          "F6: the subclaim does not match the polynomial")
    print(f"F6 degree {F6_DEGREE}: proof bytes equal on the generic chain and the "
          f"host-transcript loop on the card ({host_s:.4f} s), verified (subclaim = the "
          f"polynomial at the point)")
    return {"f6 generic": {"launches": launches, "prove_s": prove_s}}


def f4_prove_phase(device, seed: int, nv: int = F4_NV, check_nv: int = F4_CHECK_NV) -> dict:
    """Phase 10f: F4's structures (a), (b) and (c) proved at nv=20 and
    `wide` at nv=18 on the generic, the per-size and the MXU chain, each run
    with every launch count set to 0 just before it and read just after
    (one pair init, one round 0, nv - 1 folds and nv transcript steps of the
    chain: no host fallback), the enqueue under the sync debug mode "error":
    proof bytes equal across the chains, each proof verified (the subclaim
    against `evaluate_on_card`); and at nv=12 (`wide`: 8) every chain's
    proof equal to the CPU's plain prove. Returns {"f4 <chain> <name>":
    {"launches", "prove_s"}}."""
    from sumcheck_tpu_torch import Blake2b512Rng, MLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    out = {}
    for name, nv, check_nv in (("a", nv, check_nv), ("b", nv, check_nv), ("c", nv, check_nv),
                               ("wide", nv - F4_WIDE_CUT, check_nv - F4_WIDE_CHECK_CUT)):
        blobs, small = {}, {}
        poly = f4_poly(name, seed, nv)
        check_poly = f4_poly(name, seed, check_nv)
        for path, (chain, mxu) in F4_CHAINS.items():
            kernels = path_kernels(chain, mxu)
            with fold_mode(chain, mxu), syncs_forbidden_in_chains():
                MLSumcheck.prove(poly, device=device)  # warm: the wide index matrix uploaded
                sync(device)
                for f in counters().values():
                    f.launches = 0
                t0 = time.perf_counter()
                proof = MLSumcheck.prove(poly, device=device)
                prove_s = time.perf_counter() - t0
                launches = {k: f.launches for k, f in counters().items()}
                small[path] = serialize_proof(MLSumcheck.prove(check_poly, device=device))
            want = {k: 0 for k in launches}
            want.update({kernels[0]: 1, kernels[1]: nv - 1, "transcript_step": nv,
                         "pair_init": 1})
            check(launches == want, f"F4 ({name}) {path}: launches {launches}, expected {want}")
            blobs[path] = serialize_proof(proof)
            out[f"f4 {path} {name}"] = {"launches": launches, "prove_s": prove_s}
            print(f"F4 ({name}) nv={nv} {path}: prove {prove_s:.4f} s, launches "
                  f"{ {k: v for k, v in launches.items() if v} }, no sync inside the chain")
        check(len(set(blobs.values())) == 1, f"F4 ({name}): the chains prove different bytes")
        s = MLSumcheck.extract_sum(proof)
        sub = MLSumcheck.verify(poly.info(), s, proof)
        check(evaluate_on_card(poly, sub.point, device) == sub.expected_evaluation,
              f"F4 ({name}): the subclaim does not match the polynomial")
        rng = Blake2b512Rng.setup()
        plain, _ = MLSumcheck.prove_as_subprotocol(rng, check_poly, device="cpu")
        check(len(set(small.values()) | {serialize_proof(plain)}) == 1,
              f"F4 ({name}) nv={check_nv}: the card's proofs differ from the CPU's plain prove")
        print(f"F4 ({name}): nv={nv} proof bytes equal on the generic, per-size and MXU chains, "
              f"verified (subclaim = the polynomial at the point); nv={check_nv} proofs on the three "
              f"chains equal the CPU's plain prove")
        torch.cuda.empty_cache()
    return out


def f4_batch_prove_phase(device, seed: int, batch: int = F4_BATCH,
                         nv: int = F4_BATCH_NV) -> dict:
    """Phase 10g: `BatchedMLSumcheck.prove` of 4 x F4 (b) at nv=16 on both
    batched chains, each run with every launch count set to 0 just before
    it and read just after (a pair init each, then two launches a round for
    all four), proofs equal to per-instance card proves. Returns {"f4 batch
    <chain>": {"launches", "prove_s"}}."""
    from sumcheck_tpu_torch import MLSumcheck
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    polys = [f4_poly("b", seed + b, nv) for b in range(batch)]
    alone = [serialize_proof(MLSumcheck.prove(p, device=device)) for p in polys]
    out = {}
    for path, chain in (("generic", "generic"), ("per-size", "persize")):
        fold = "round_fold_batched" if chain == "generic" else "round_step_fold_batched"
        with fold_mode(chain), syncs_forbidden_in_chains():
            BatchedMLSumcheck.prove(polys, device=device)
            sync(device)
            for f in counters().values():
                f.launches = 0
            t0 = time.perf_counter()
            proofs = BatchedMLSumcheck.prove(polys, device=device)
            prove_s = time.perf_counter() - t0
            launches = {k: f.launches for k, f in counters().items()}
        want = {k: 0 for k in launches}
        want.update({"round_nofold_batched": 1, fold: nv - 1, "transcript_step_batched": nv,
                     "pair_init": batch})
        check(launches == want, f"F4 batch {path}: launches {launches}, expected {want}")
        check([serialize_proof(p) for p in proofs] == alone,
              f"F4 batch {path}: proofs differ from per-instance card proves")
        out[f"f4 batch {path}"] = {"launches": launches, "prove_s": prove_s}
        print(f"F4 batch {path}, {batch} x (b) nv={nv}: {prove_s:.4f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }; proofs equal per-instance card "
              f"proves")
    return out


# --- the batched GKR inits: one weight-reduce launch a phase for B instances


def parent_enqueue_gkr(inputs: list, state, dim: int, round_fns=None, transcript_fn=None):
    """The batched GKR enqueue as it was before the weight reduce's
    instance axis (one `phase1_pair` and one `phase2_pair` launch per
    instance), kept here as the yardstick of the batch wall."""
    from sumcheck_tpu_torch.fields.fr import NUM_LIMBS
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.protocol import generic_prover

    products = ((0, 1),)
    shape = (len(inputs), 2, NUM_LIMBS, 1 << (dim - 1))
    lo = torch.empty(shape, dtype=torch.int32, device=state.device)
    hi = torch.empty_like(lo)
    ws = [GI.phase1_pair(split, g_r, f3_d, f2_d, dim, out=(lo[b], hi[b]))[2]
          for b, (split, f2_d, f3_d, g_r) in enumerate(inputs)]
    msgs1, rs1, state = generic_prover.chain_rounds_generic_batched(
        lo, hi, state, products, 2, dim, round_fns, transcript_fn)
    lo2, hi2 = torch.empty_like(lo), torch.empty_like(hi)
    for b, (split, _f2, f3_d, _gr) in enumerate(inputs):
        GI.phase2_pair(lo[b, :, :, :1], hi[b, :, :, :1], rs1[dim - 1, b], split, ws[b],
                       rs1[:, b], f3_d, dim, out=(lo2[b], hi2[b]))
    msgs2, rs2, state = generic_prover.chain_rounds_generic_batched(
        lo2, hi2, state, products, 2, dim, round_fns, transcript_fn)
    return torch.cat([msgs1, msgs2]), torch.cat([rs1, rs2]), state


def held_flushed_ms(fn, device, reps: int = KERNEL_REPS) -> float:
    """`microbench.flushed_ms` of `fn` with a hold long enough for the
    enqueue of a call that checks 8 instances on the host (about a
    millisecond; `time_ms`'s hold assumes a single launch's): the hold is
    doubled until it outlasts the enqueue, so the events time the device
    and not the host's gaps."""
    from sumcheck_tpu_torch.microbench import flushed_ms

    if device.type != "cuda":
        return time_ms(fn, reps, device)
    fn()
    hold = 0.005 + 0.002 * reps
    for _ in range(4):
        ms, held = flushed_ms(fn, reps, hold)
        if held:
            return ms
        hold *= 2
    raise RuntimeError("the stream hold never outlasted the enqueue")


def gkr_batch_init_phase(device, seed: int, batch: int = BATCH,
                         dim: int = GKR_BATCH_DIM) -> dict:
    """Phase 9b: the batched weight reduce (`gkr_init_cuda.
    weight_reduce_batched`, grid y = instance) of the 8 x dim 14 GKR batch,
    each phase in one launch, against 8 single launches (`weight_reduce`)
    and the plain version, array-equal: phase 1 (pairs and carries) and
    phase 2 (over the carries, each instance's column of (dim, 8, 16)
    challenge rows, f3 times the final fold of its phase-1 pair's lane 0);
    then a batch of the skewed instance (one segment of SKEW entries cut
    across blocks, its own scratch rows) beside the others, whose tile plans
    differ. Device ms after an L2 flush for the batched launch and for the 8
    single launches, the plain version's ms and the bound (8 x
    `reduce_work`). Returns the kernels line's stats."""
    from sumcheck_tpu_torch import Fr
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    insts = gkr_batch_instances(seed, dim, batch)
    rnd = random.Random(seed + 14)
    stats = {"weight_reduce_batched": [0, []]}
    for label, chosen in ((f"{batch} x dim {dim}", insts),
                          ("with a skewed instance", [skewed_instance(insts[0], seed)]
                           + insts[1:])):
        inputs = [G._upload(f1, f2, f3, g, dim, device) for f1, f2, f3, g in chosen]
        splits, f2s, f3s, g_rs = zip(*inputs)
        u = torch.from_numpy(np.stack([GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)])
                                       for _ in range(batch)], axis=1)).to(device)
        nnz = [s.vals.shape[0] for s in splits]
        print(f"9b {label}: tile plans of {[len(s.plan_x.items) for s in splits]} (x) items, "
              f"long segments {[s.plan_x.long for s in splits]}, entries {nnz}")
        shape = (batch, 2, 8, 1 << (dim - 1))
        pairs = {k: (torch.empty(shape, dtype=torch.int32, device=device),
                     torch.empty(shape, dtype=torch.int32, device=device))
                 for k in ("batched", "singles", "plain", "batched2", "singles2", "plain2")}

        def phase1(kind):
            lo, hi = pairs[kind]
            if kind == "batched":
                return GI.phase1_pairs(splits, g_rs, f3s, f2s, dim, lo, hi)
            if kind == "singles":
                return [GI.phase1_pair(s, g, f3, f2, dim, out=(lo[b], hi[b]))[2]
                        for b, (s, f2, f3, g) in enumerate(inputs)]
            return GK.weight_reduce_batched_ref([
                GK.Instance(s.gbits, s.vals, g, s.last_x, s.plan_x, (lo[b], hi[b]), f3=f3,
                            y=s.y_rev, to_y=s.to_y, slot=(f2, None))
                for b, (s, f2, f3, g) in enumerate(inputs)], dim)

        carries = {k: phase1(k) for k in ("batched", "singles", "plain")}
        lo1, hi1 = pairs["batched"]

        def phase2(kind):
            lo, hi = pairs[kind + "2"]
            if kind == "batched":
                return GI.phase2_pairs(lo1[:, :, :, :1], hi1[:, :, :, :1], u[dim - 1], splits,
                                       carries["batched"], u, f3s, dim, lo, hi)
            if kind == "singles":
                return [GI.phase2_pair(lo1[b, :, :, :1], hi1[b, :, :, :1], u[dim - 1, b], s,
                                       carries["batched"][b], u[:, b], f3, dim,
                                       out=(lo[b], hi[b])) for b, (s, f3) in
                        enumerate(zip(splits, f3s))]
            return GK.weight_reduce_batched_ref([
                GK.Instance(s.x_y, carries["batched"][b], u[:, b], s.last_y, s.plan_y,
                            (lo[b], hi[b]), slot=(f3, (lo1[b, :, :, :1], hi1[b, :, :, :1],
                                                       u[dim - 1, b], 1)))
                for b, (s, f3) in enumerate(zip(splits, f3s))], dim)

        for kind in ("batched", "singles", "plain"):
            phase2(kind)
        sync(device)
        (blo, bhi), (blo2, bhi2) = pairs["batched"], pairs["batched2"]
        routes = [GK.batch_launch_shape([
            GK.Instance(s.gbits, s.vals, g, s.last_x, s.plan_x, (blo[b], bhi[b]), f3=f3,
                        y=s.y_rev,
                        to_y=s.to_y, slot=(f2, None))
            for b, (s, f2, f3, g) in enumerate(inputs)], dim),
            GK.batch_launch_shape([
                GK.Instance(s.x_y, carries["batched"][b], u[:, b], s.last_y, s.plan_y,
                            (blo2[b], bhi2[b]), slot=(f3, (lo1[b, :, :, :1], hi1[b, :, :, :1],
                                                           u[dim - 1, b], 1)))
                for b, (s, f3) in enumerate(zip(splits, f3s))], dim)]
        print(f"9b {label}: the batched launch takes the {batch} instances in its parameters, "
              f"no copy ahead of it: (parameter bytes, blocks an instance) of each launch, "
              f"phase 1 {routes[0]}, phase 2 {routes[1]}")
        err = 0
        for other in ("singles", "plain"):
            for a, b in zip(pairs["batched"] + pairs["batched2"],
                            pairs[other] + pairs[other + "2"]):
                err = max(err, max_diff(a, b))
            for a, b in zip(carries["batched"], carries[other]):
                err = max(err, max_diff(a, b))
        check(err == 0, f"9b {label}: the batched weight reduce differs from the single "
                        f"launches or the plain version by {err}")
        scratch, arrived = GK._scratch(device, 1)
        check(not scratch.any() and not arrived.any(), f"9b {label}: the scratch is not zero")
        stats["weight_reduce_batched"][0] = max(stats["weight_reduce_batched"][0], err)
        n = 1 << dim
        for phase, fn in ((1, phase1), (2, phase2)):
            work = {k: sum(reduce_work(z, n, dim, phase, slot=True)[k] for z in nnz)
                    for k in ("bytes", "imads", "int8_ops")}
            ms = held_flushed_ms(lambda fn=fn: fn("batched"), device)
            singles_ms = held_flushed_ms(lambda fn=fn: fn("singles"), device)
            plain_ms = time_ms(lambda fn=fn: fn("plain"), PLAIN_REPS, device)
            entry = {"shape": f"{label}: phase {phase} init", "ms": ms, "singles_ms": singles_ms,
                     "plain_ms": plain_ms, "work": work, "launches": routes[phase - 1]}
            stats["weight_reduce_batched"][1].append(entry)
            line = (f"kernel-vs-plain weight_reduce_batched ({label}, phase {phase}): equal to "
                    f"{batch} single launches and the plain version; batched {ms:.4f} ms, "
                    f"{batch} single launches {singles_ms:.4f} ms (device time, each after an "
                    f"L2 flush), plain {plain_ms:.4f} ms")
            if RATES:
                bound_ms, bound_by, _ = bound_of(work)
                line += f"; bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of it"
            print(line)
    return stats


# --- the round-by-round prover: the interactive tier, the GKR host-transcript
# branch and `ShardedProver` (in phase 11's spawns), and the speed-of-light model

ABC = b"abc"  # a pre-fed transcript whose pending bytes the device chain cannot lift
GKR_PLAIN_DIM = 14  # the host-transcript GKR prove against its plain versions


@contextlib.contextmanager
def counted_syncs(guard: bool = True):
    """Count the calls of `round_cuda.finish_sums`, a host-transcript
    round's one sync (the list yielded grows by one a call); with `guard`,
    run each round's enqueue (`protocol.prover._round_sums`: the challenge
    upload and the round kernel) under the sync debug mode "error", so
    that any other sync in a round fails the run. (A gloo all-reduce syncs
    by design: the sharded rounds run unguarded.)"""
    from sumcheck_tpu_torch.ops import round_cuda as rc
    from sumcheck_tpu_torch.protocol import prover

    calls = []
    real_finish, real_round = rc.finish_sums, prover._round_sums

    def finish(sums):
        calls.append(1)
        return real_finish(sums)

    def round_sums(*args):
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_round(*args)
        finally:
            torch.cuda.set_sync_debug_mode(before)

    rc.finish_sums = finish
    if guard:
        prover._round_sums = round_sums
    try:
        yield calls
    finally:
        rc.finish_sums, prover._round_sums = real_finish, real_round


def abc_rng():
    """A `Blake2b512Rng` pre-fed `ABC`: 3 pending bytes."""
    from sumcheck_tpu_torch import Blake2b512Rng

    rng = Blake2b512Rng.setup()
    rng.feed_bytes(ABC)
    return rng


def interactive_phase(device, seed: int, reps: int, ref: dict, nv: int = NV) -> dict:
    """Phase 10b: the interactive tier on the nv=20 2x3 instance (phase
    8's): `IPForMLSumcheck.prover_init(device=)`, then nv `prove_round` /
    `sample_round` over a live `Blake2b512Rng`, as a caller composing
    sumcheck into a larger protocol drives it. Launches and syncs (one
    `finish_sums` a round, each round's enqueue under the sync debug mode
    "error") counted from 0, first and warm walls; proof bytes and the
    final transcript equal to `MLSumcheck.prove`'s on the generic chain
    (`ref`), the final tables to that prove's state's. Also proves the
    instance over the `ABC` transcript (`MLSumcheck.prove_as_subprotocol`,
    which takes this tier for it), the single-card proof the sharded
    `ShardedProver` case is held to."""
    from sumcheck_tpu_torch import Blake2b512Rng, IPForMLSumcheck, MLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    poly = headline_poly(seed, nv)

    def prove():
        state = IPForMLSumcheck.prover_init(poly, device=device)
        rng = Blake2b512Rng.setup()
        rng.feed(poly.info())
        msgs, v_msg = [], None
        for _ in range(nv):
            msg = IPForMLSumcheck.prove_round(state, v_msg)
            rng.feed(msg)
            msgs.append(msg)
            v_msg = IPForMLSumcheck.sample_round(rng)
        state.randomness.append(v_msg.randomness)
        return serialize_proof(msgs), repr(rng.state_tuple()), state

    proves = reps + 2  # the first, `reps` warm and timed, one under the sync guard
    results, walls, launches, syncs = _loop_proves(prove, proves)
    want = {k: 0 for k in launches}
    want.update({"pair_init": proves, "round_nofold": proves, "round_fold": (nv - 1) * proves})
    check(launches == want, f"interactive ML: launches {launches}, expected {want}")
    check(syncs == nv * proves, f"interactive ML: {syncs} syncs in {proves} proves, "
                                f"expected {nv} a prove")
    check(all(r[:2] == (ref["proof"], ref["transcript"]) for r in results),
          "interactive ML: proof or final transcript differs from MLSumcheck.prove's")
    _, chain_state = MLSumcheck.prove_as_subprotocol(Blake2b512Rng.setup(), poly, device=device)
    check(all(np.array_equal(a, b) for a, b in zip(results[-1][2].flattened_ml_extensions,
                                                   chain_state.flattened_ml_extensions)),
          "interactive ML: final tables differ from the chained prove's")
    rng = abc_rng()
    abc, _ = MLSumcheck.prove_as_subprotocol(rng, poly, device=device)
    prove_s = statistics.median(walls[1:])
    print(f"interactive ML nv={nv} 2x3 (prover_init + {nv} prove_round / sample_round, live "
          f"Blake2b512Rng): first {walls[0]:.4f} s, median of {reps} warm {prove_s:.4f} s, walls "
          f"{[round(w, 4) for w in walls[1:]]}; syncs per prove {syncs // proves} (finish_sums), "
          f"none other in a round (one more prove under the sync guard), launches a prove "
          f"{ {k: v // proves for k, v in launches.items() if v} }; proof, final transcript and "
          f"final tables equal to MLSumcheck.prove's (generic chain)")
    return {"launches": launches, "prove_s": prove_s, "first_s": walls[0],
            "syncs_per_prove": syncs // proves, "abc_proof": serialize_proof(abc),
            "abc_transcript": repr(rng.state_tuple())}


def gkr_host_phase(device, seed: int, inst, reps: int, check_plain: bool = True) -> dict:
    """Phase 10c: `GKRRoundSumcheck.prove` over the `ABC` transcript, which
    the device chain cannot lift, at the instance's dim (phase 9's): the
    chained prove's inits and round kernels with the transcript on the host
    between the rounds. Launches (no transcript step) and syncs (one
    `finish_sums` a round) counted from 0, warm walls beside the aligned
    transcript's chained prove in this call; verify over the same transcript
    and the subclaim in Python integers (`subclaim_in_integers`); with
    `check_plain`, at dim `GKR_PLAIN_DIM` byte-equal to the same prove with
    the round kernels' plain versions on the card."""
    from sumcheck_tpu_torch import Blake2b512Rng, GKRRoundSumcheck
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch import microbench as MB
    from sumcheck_tpu_torch.ops import round_cuda as rc

    f1, f2, f3, g = inst
    dim = f2.num_vars
    proves = reps + 2  # the first, `reps` warm and timed, one under the sync guard
    results, walls, launches, syncs = _loop_proves(
        lambda: GKRRoundSumcheck.prove(abc_rng(), *inst, device=device), proves)
    proof = results[0]
    check(len({r.serialize_uncompressed() for r in results}) == 1,
          "GKR host transcript: proves differ")
    want = {k: 0 for k in launches}
    want.update({"round_nofold": 2 * proves, "round_fold": 2 * (dim - 1) * proves})
    want.update({k: v * proves for k, v in INIT_LAUNCHES.items()})
    check(launches == want, f"GKR host transcript: launches {launches}, expected {want}")
    check(syncs == 2 * dim * proves, f"GKR host transcript: {syncs} syncs in "
                                     f"{proves} proves, expected {2 * dim} a prove")
    chained = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device=device)
        chained.append(time.perf_counter() - t0)
    sub = GKRRoundSumcheck.verify(abc_rng(), dim, proof, proof.extract_sum())
    t0 = time.perf_counter()
    check(subclaim_in_integers(inst, sub), f"GKR host transcript dim={dim}: the subclaim fails")
    subclaim_s = time.perf_counter() - t0
    prove_s, chained_s = statistics.median(walls[1:]), statistics.median(chained[1:])
    print(f"GKR dim={dim} over a transcript pre-fed {ABC!r} (host transcript, round kernels on "
          f"the card): first {walls[0]:.4f} s, median of {reps} warm {prove_s:.4f} s, walls "
          f"{[round(w, 4) for w in walls[1:]]}; the aligned transcript's chained prove "
          f"{chained_s:.4f} s in this call; syncs per prove {syncs // proves} (none other "
          f"in a round, one more prove under the sync guard), launches a prove "
          f"{ {k: v // proves for k, v in launches.items() if v} }; verify accepts, the "
          f"subclaim holds in Python integers ({subclaim_s:.2f} s)")
    out = {"launches": launches, "prove_s": prove_s, "first_s": walls[0], "chained_s": chained_s,
           "syncs_per_prove": syncs // proves}
    if check_plain:
        small = MB.gkr_instance(GKR_PLAIN_DIM, seed)
        kernel = GKRRoundSumcheck.prove(abc_rng(), *small, device=device)
        t0 = time.perf_counter()
        plain = G._prove_host_transcript(abc_rng(), *small, GKR_PLAIN_DIM, device,
                                         round_fns=(rc.round_nofold_ref, rc.round_fold_ref))
        check(plain.serialize_uncompressed() == kernel.serialize_uncompressed(),
              f"GKR host transcript dim={GKR_PLAIN_DIM}: kernel proof differs from the plain "
              f"versions'")
        print(f"GKR dim={GKR_PLAIN_DIM} over the {ABC!r} transcript: bytes equal to the plain "
              f"round versions' on the card ({time.perf_counter() - t0:.4f} s)")
    return out


def _loop_proves(prove, proves: int):
    """`prove()` `proves` times with every launch count at 0 before and the
    `finish_sums` calls counted, the last prove with each round's enqueue
    under the sync debug mode "error" (`counted_syncs`); returns (results,
    the walls of all but the guarded prove, launches, syncs)."""
    with counted_syncs(guard=False) as syncs:
        for f in counters().values():
            f.launches = 0
        results, walls = [], []
        for i in range(proves):
            with counted_syncs() if i == proves - 1 else contextlib.nullcontext():
                t0 = time.perf_counter()
                results.append(prove())
                walls.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters().items()}
    return results, walls[:-1], launches, len(syncs)


def engine_variables_phase() -> None:
    """Phase 10d: the JAX package's engine variables. A child process that
    imports the port under ``SUMCHECK_TPU_CHAINED=off`` exits non-zero with
    `SumcheckError` naming the variable and prints nothing;
    `check_engine_variables` refuses ``off``, a threshold and
    ``ENGINE=host``, each naming its variable, and takes the values that
    mean the chain on the prover's device."""
    from sumcheck_tpu_torch import SumcheckError
    from sumcheck_tpu_torch.utils.config import check_engine_variables

    env = dict(os.environ, SUMCHECK_TPU_CHAINED="off")
    child = subprocess.run([sys.executable, "-c", "import sumcheck_tpu_torch; print('imported')"],
                           capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    check(child.returncode != 0 and child.stdout == ""
          and "SumcheckError: SUMCHECK_TPU_CHAINED='off'" in child.stderr,
          f"the port imported under SUMCHECK_TPU_CHAINED=off: rc {child.returncode}, "
          f"{child.stderr[-500:]!r}")
    for variable, value in (("SUMCHECK_TPU_CHAINED", "off"),
                            ("SUMCHECK_TPU_DEVICE_THRESHOLD", "4096"),
                            ("SUMCHECK_TPU_ENGINE", "host")):
        try:
            check_engine_variables({variable: value})
            raised = ""
        except SumcheckError as e:
            raised = str(e)
        check(raised.startswith(f"{variable}={value!r}"),
              f"{variable}={value} was not refused by name: {raised!r}")
    check_engine_variables({"SUMCHECK_TPU_CHAINED": "on", "SUMCHECK_TPU_DEVICE_THRESHOLD": "0",
                            "SUMCHECK_TPU_ENGINE": "device"})
    print("engine variables: the port's import stops under SUMCHECK_TPU_CHAINED=off, naming "
          "it; SUMCHECK_TPU_DEVICE_THRESHOLD=4096 and SUMCHECK_TPU_ENGINE=host are refused by "
          "name; CHAINED=on, THRESHOLD=0 and ENGINE=device are taken")


def zero_coefficient_phase(device, seed: int, nv: int = NV, compared=(0, 1, 5)) -> dict:
    """Phase 10e: fault F3 on the card. The polynomial 0 x [t0, t1, t2] +
    c x [t3, t4, t5] at nv=20 (tables and c from
    `numpy.random.default_rng(seed + 3)`): its fold plan gives the zero
    product a copy slot (slot 6, table 0 scaled by 0). `IPForMLSumcheck`
    on the card, driven by a live `Blake2b512Rng` fed the polynomial's
    info, launches counted from 0 and syncs counted: the proof and final
    transcript equal to `MLSumcheck.prove_as_subprotocol`'s chained proof.
    Then the same drive in step with a state on the CPU (the plain
    versions): after the init the whole pair equal (the pair-init kernel at
    the copy slot, which is all zero, and tables 0-2, 4, 5 equal to the
    inputs, bit-reversed), every message equal, and after rounds
    `compared` `flattened_ml_extensions` equal, after round 0 equal to the
    input tables."""
    from sumcheck_tpu_torch import Blake2b512Rng, IPForMLSumcheck, MLSumcheck
    from sumcheck_tpu_torch.convert import polynomial_from_numpy
    from sumcheck_tpu_torch.fields.limbs_np import random_tables, unpack_limbs
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.protocol.device_prover import _fold_plan
    from sumcheck_tpu_torch.protocol.prover import to_bitrev

    gen = np.random.default_rng(seed + 3)
    tables = random_tables(gen, nv, 6)
    poly = polynomial_from_numpy(nv, tables, [(0, [0, 1, 2]),
                                              (int(gen.integers(1, 1 << 62)), [3, 4, 5])])
    products, scale_plan, slots, _ones = _fold_plan(poly)
    check(slots == 7 and scale_plan[0] == (6, 0, 0) and products[0] == (6, 1, 2),
          f"F3: fold plan {products}, {scale_plan}, {slots} slots")

    def drive(state, rounds, rng, v_msg=None):
        msgs = []
        for _ in range(rounds):
            msg = IPForMLSumcheck.prove_round(state, v_msg)
            rng.feed(msg)
            msgs.append(msg)
            v_msg = IPForMLSumcheck.sample_round(rng)
        return msgs, v_msg

    def prove():
        rng = Blake2b512Rng.setup()
        rng.feed(poly.info())
        msgs, _v = drive(IPForMLSumcheck.prover_init(poly, device=device), nv, rng)
        return serialize_proof(msgs), repr(rng.state_tuple())

    chained_rng = Blake2b512Rng.setup()
    chained, _state = MLSumcheck.prove_as_subprotocol(chained_rng, poly, device=device)
    results, walls, launches, syncs = _loop_proves(prove, 3)
    walls = walls[1:]
    check(all(r == (serialize_proof(chained), repr(chained_rng.state_tuple())) for r in results),
          "F3: the interactive proof or final transcript differs from the chained prove's")
    want = {k: 0 for k in launches}
    want.update({"pair_init": 3, "round_nofold": 3, "round_fold": 3 * (nv - 1)})
    check(launches == want and syncs == 3 * nv, f"F3: launches {launches}, {syncs} syncs")

    t0 = time.perf_counter()
    card = IPForMLSumcheck.prover_init(poly, device=device)
    plain = IPForMLSumcheck.prover_init(poly, device="cpu")
    pair = [t.cpu() for t in card.stacked]
    check(all(torch.equal(a, b) for a, b in zip(pair, plain.stacked)),
          "F3: the pair-init kernel's pair differs from its plain version's")
    check(not pair[0][6].any() and not pair[1][6].any(), "F3: the copy slot is not zero")
    for i in (0, 1, 2, 4, 5):
        both = unpack_limbs(torch.cat([pair[0][i], pair[1][i]], dim=1).numpy())
        check(np.array_equal(both, to_bitrev(tables[i], nv)), f"F3: table {i} was not kept")
    rng_card, rng_plain = Blake2b512Rng.setup(), Blake2b512Rng.setup()
    v_card = v_plain = None
    for j in range(max(compared) + 1):
        (m_card,), v_card = drive(card, 1, rng_card, v_card)
        (m_plain,), v_plain = drive(plain, 1, rng_plain, v_plain)
        check(m_card == m_plain, f"F3 round {j}: the card's message differs from the plain one")
        if j in compared:
            got, ref = card.flattened_ml_extensions, plain.flattened_ml_extensions
            check(len(got) == len(ref) == 6 and all(np.array_equal(a, b)
                                                    for a, b in zip(got, ref)),
                  f"F3 round {j}: flattened_ml_extensions differ between the card and the CPU")
            if j == 0:
                check(all(np.array_equal(a, to_bitrev(t, nv)) for a, t in zip(got, tables)),
                      "F3 round 0: flattened_ml_extensions are not the input tables")
    plain_s = time.perf_counter() - t0
    prove_s = statistics.median(walls) if walls else float("nan")
    print(f"F3 (zero coefficient) nv={nv}, 0 x [t0, t1, t2] + c x [t3, t4, t5]: fold plan "
          f"{slots} slots (the zero product's copy of t0 in slot 6); interactive prove on the "
          f"card {prove_s:.4f} s, {syncs // 3} syncs, launches a prove "
          f"{ {k: v // 3 for k, v in launches.items() if v} }, proof and final transcript equal "
          f"to the chained prove's; the pair-init kernel's pair equal to its plain version's "
          f"(copy slot zero, tables kept), messages of rounds 0-{max(compared)} equal to the CPU "
          f"state's and flattened_ml_extensions after rounds {list(compared)} equal "
          f"({plain_s:.1f} s with the CPU state)")
    return {"launches": launches, "prove_s": prove_s, "syncs": syncs, "plain_s": plain_s}


def sharded_sp(device: str, group, seed: int, reps: int, refs: dict) -> dict:
    """One rank's `ShardedProver` cases (phase 11): the nv=20 2x3 instance
    over a fresh `Blake2b512Rng` and over the `ABC` transcript, each held
    to the single card's proof and final transcript (`refs`), with launches,
    all-reduces, bytes and syncs (`finish_sums`) a prove."""
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
    from sumcheck_tpu_torch.parallel import ShardedProver

    prover = ShardedProver(group, device=device)
    poly = headline_poly(seed, NV)
    out = {}
    for case, make, ref, which in (
            ("sp", Blake2b512Rng.setup, (refs["ml"], refs["ml_state"]), "a fresh"),
            ("sp abc", abc_rng, (refs["ml_abc"], refs["ml_abc_state"]), f"a {ABC!r}")):
        def prove():
            rng = make()
            proof, _state = prover.prove_as_subprotocol(rng, poly)
            return serialize_proof(proof), repr(rng.state_tuple())

        proves = reps + 1
        with counted_syncs(guard=False) as syncs:
            results, walls, launches, calls, nbytes, _rs = _counted(prove, proves,
                                                                    contextlib.nullcontext)
        check(all(r == ref for r in results),
              f"ShardedProver {case}: proof or final transcript differs from the single card's")
        want = {k: 0 for k in launches}
        want.update({"pair_init": proves, "round_nofold": proves,
                     "round_fold": (NV - 1) * proves})
        check(launches == want, f"ShardedProver {case}: launches {launches}, expected {want}")
        check(len(syncs) == NV * proves, f"ShardedProver {case}: {len(syncs)} syncs")
        out[case] = {"what": f"ShardedProver ML nv={NV} 2x3 over {which} transcript on the "
                             f"host, proof and final transcript, {NV} syncs a prove",
                     "walls": walls,
                     "prove_s": statistics.median(walls), "launches": launches,
                     "collectives": calls, "bytes": nbytes}
    return out


def roofline_phase(device, ml_prove_s: float, gkr_prove_s: float, dim: int = GKR_DIM) -> dict:
    """Phase 12b: `utils/sol.measure_roofline` on this card (measured
    afresh), and the speed-of-light share of the ML nv=20 generic prove
    (`sol_seconds(count_prove_ops(20, 6, 2, 3, 3))`, the arguments of
    `bench.py:341-346`) and of the GKR dim-18 generic prove over their
    medians, as `bench.py` reports `pct_sol`."""
    from sumcheck_tpu_torch.utils import sol

    t0 = time.perf_counter()
    roof = sol.measure_roofline(device, force=True)
    measure_s = time.perf_counter() - t0
    ml = sol.sol_seconds(sol.count_prove_ops(NV, 6, 2, 3, 3), roof)
    gkr = sol.sol_seconds(sol.count_gkr_prove_ops(dim, 1 << dim), roof)
    out = {"mont_muls_per_s": roof["mont_muls_per_s"], "hbm_bytes_per_s": roof["hbm_bytes_per_s"],
           "card": roof["card"], "ml_sol_s": ml["sol_s"], "ml_bound": ml["bound"],
           "ml_pct_sol": round(100 * ml["sol_s"] / ml_prove_s, 2), "gkr_sol_s": gkr["sol_s"],
           "gkr_bound": gkr["bound"], "gkr_pct_sol": round(100 * gkr["sol_s"] / gkr_prove_s, 2)}
    print(f"roofline ({roof['card']}, measured in {measure_s:.2f} s): "
          f"{roof['mont_muls_per_s']:.4e} Montgomery multiplies/s (even/odd mont_mul, "
          f"{roof['mont_lanes']} lanes x {roof['mont_chain']} chained), "
          f"{roof['hbm_bytes_per_s'] / 1e12:.4f} TB/s HBM (a {roof['copy_bytes']} B "
          f"device-to-device copy); ML nv={NV} generic: sol_s {ml['sol_s']:.6f} ({ml['bound']}), "
          f"pct_sol {out['ml_pct_sol']} of the {ml_prove_s:.4f} s prove; GKR dim={dim} generic: "
          f"sol_s {gkr['sol_s']:.6f} ({gkr['bound']}), pct_sol {out['gkr_pct_sol']} of the "
          f"{gkr_prove_s:.4f} s prove")
    return out


# --- the multi-device provers (`sumcheck_tpu_torch/parallel/`, the sharded batch)

SHARD_SIZES = (2, 4)
GKR_SHARD_SIZES = (2, 4)  # the inits' reduce-scatter against the all-reduce at both sizes
INIT_PASSES = 5  # timed passes of a rank's two phase inits (medians)
EXCHANGE_PAIRS = 7  # reduce-scatter / all-reduce pairs of the same raw sums (medians)
ONE_CARD_NOTE = ("S ranks on one card share its SMs and pass every collective through the "
                 "host (gloo): these walls say nothing about speed across cards")


def sharded_phase(device, seed: int, reps: int, refs: dict) -> dict:
    """Phase 11: the sharded provers, S ranks of one `mp.spawn` for each S
    in `SHARD_SIZES`, in a gloo group on the card(s) (`sharded_rank`), and,
    where the machine has S cards, again in an NCCL group with one rank a
    card and the chains under the sync debug mode "error". `refs` are the
    single-card proofs of phases 8-10. A rank's failure makes the spawn
    raise, and the script exits non-zero. Returns {path: numbers}."""
    heads = {}
    torch.cuda.empty_cache()  # the ranks allocate on the same card
    for size in SHARD_SIZES:
        heads.update(run_ranks(size, "gloo", seed, reps, refs))
    for size in SHARD_SIZES:
        if torch.cuda.device_count() >= size:
            heads.update(run_ranks(size, "nccl", seed, reps, refs))
        else:
            print(f"sharded S={size} NCCL: not run, {torch.cuda.device_count()} card(s) here and "
                  f"NCCL takes one card a rank")
    print(f"sharded: {ONE_CARD_NOTE}")
    return heads


def run_ranks(size: int, backend: str, seed: int, reps: int, refs: dict,
              cases: tuple = ("ml", "gkr", "batch", "sp")) -> dict:
    """One spawn of `size` ranks in a `backend` group running `cases` (the
    GKR case only at `GKR_SHARD_SIZES`); prints each case's numbers and
    returns them by path, with rank 0's launch counts."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(size, backend, "cuda", f"{tmp}/init", tmp, seed, reps, refs,
                                     cases), nprocs=size)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(size):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    tag = f"S={size} {backend}"
    print(f"sharded {tag}: {size} ranks on {', '.join(r['device'] for r in ranks)}, "
          f"{spawn_s:.1f} s of host time for the spawn")
    out = {}
    for case, res in ranks[0]["cases"].items():
        path = f"sharded {case} {tag}"
        walls = [r["cases"][case]["walls"] for r in ranks]
        print(f"{path}: {res['what']}; warm walls by rank {walls}, median (rank 0) "
              f"{res['prove_s']:.4f} s; per prove {res['collectives']} all-reduces of "
              f"{res['bytes']} bytes a rank; launches a rank "
              f"{ {k: v for k, v in res['launches'].items() if v} }; bytes equal to the single "
              f"card's on every rank")
        if "inits" in res:
            i = res["inits"]
            calls, sent, received = res["reduce_scatters"]
            print(f"{path}: per prove {calls} reduce-scatters, {sent} bytes sent and {received} "
                  f"received a rank; both phase inits {i['total_s']:.4f} s, of it compute "
                  f"{i['compute_s']:.4f} s and the two reduce-scatters of the raw segment sums "
                  f"{i['reduce_scatter_s']:.4f} s (medians of {INIT_PASSES} passes; route "
                  f"direct: one {i['backend']} reduce-scatter of the card's tensor itself, torch "
                  f"{torch.__version__}; {i['sent']} bytes sent and {i['received']} received "
                  f"each rank: the (S, 8, 2^{GKR_DIM} / S) int64 limb sums and the rank's block); "
                  f"card {card_line()}")
            print(f"{path}: the same raw sums again, off the prover path, in {len(i['pairs'])} "
                  f"pairs, the first of each alternating, each exchange behind a barrier: two "
                  f"reduce-scatters {i['pair_reduce_scatter_s']:.4f} s against two all-reduces "
                  f"{i['pair_all_reduce_s']:.4f} s (medians), the pairs' ratio median "
                  f"{i['pair_ratio']:.3f}; pairs (reduce-scatters, all-reduces) "
                  f"{[[round(r, 4), round(a, 4)] for r, a in i['pairs']]}; card {card_line()}")
        out[path] = dict(res, walls=walls)
    return out


def sharded_rank(rank: int, size: int, backend: str, device: str, init_file: str, out_dir: str,
                 seed: int, reps: int, refs: dict,
                 cases: tuple = ("ml", "gkr", "batch", "sp")) -> None:
    """One rank of `run_ranks`, the `cases` of: the sharded ML nv=20 2x3 prove (the phase-8
    instance, `ChainedShardedProver.auto(size)`), the sharded GKR dim-18 prove (phase
    9's, `ShardedGKRProver.auto(size)`, at the sizes of `GKR_SHARD_SIZES`), the
    sharded batch 8 x nv=16 (phase 10's) and
    `ShardedProver` on the ML instance (`sharded_sp`), each
    through its public entry point on the rank's card, checked byte for
    byte against `refs`, launches counted from 0 around it; writes the
    numbers to `out_dir`/rank<r>.json. Raises on any mismatch. `device` is
    "cuda" (each rank on `shard_device`'s card); "cpu" rehearses the phase
    on the plain versions."""
    import torch.distributed as dist

    from sumcheck_tpu_torch import SumcheckError
    from sumcheck_tpu_torch.parallel import ChainedShardedProver, ShardedGKRProver

    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    try:
        ml = ChainedShardedProver.auto(size, device=device)
        for cls in (ChainedShardedProver, ShardedGKRProver):
            try:
                cls.auto(2 * size, device=device)
                raised = False
            except SumcheckError:
                raised = True
            check(raised, f"{cls.__name__}.auto({2 * size}) in a group of {size} did not raise")
        if backend == "nccl":
            torch.cuda.set_device(ml.device)
        # NCCL syncs nothing inside a chain; gloo passes each collective
        # through the host by design, so its chains are not held to that
        guard = syncs_forbidden_in_chains if backend == "nccl" else contextlib.nullcontext
        out = {}
        if "ml" in cases:
            out["ml"] = sharded_ml(ml, seed, reps, refs, guard)
        if "gkr" in cases and size in GKR_SHARD_SIZES:
            out["gkr"] = sharded_gkr(ShardedGKRProver.auto(size, device=device), seed, refs,
                                     guard)
        if "batch" in cases:
            out["batch"] = sharded_batch(ml, seed, reps, refs, guard)
        if "sp" in cases:
            out.update(sharded_sp(device, ml.group, seed, reps, refs))
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump({"device": str(ml.device), "cases": out}, f)
    finally:
        dist.destroy_process_group()


def _counted(fn, proves: int, guard):
    """Run `fn` `proves` times under `guard` with every launch count and the
    collectives' counts at 0 before; returns (results, warm walls,
    launches, all-reduces per prove, their bytes a rank per prove,
    [reduce-scatters, their bytes sent, their bytes received] a rank per
    prove)."""
    from sumcheck_tpu_torch.parallel import comm

    rs = comm.reduce_scatter_sum_
    with guard():
        for f in counters().values():
            f.launches = 0
        comm.all_reduce_sum_.calls = comm.all_reduce_sum_.bytes = 0
        rs.calls = rs.bytes = rs.received = 0
        results, walls = [], []
        for _ in range(proves):
            t0 = time.perf_counter()
            results.append(fn())
            walls.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters().items()}
    return (results, walls[1:], launches, comm.all_reduce_sum_.calls // proves,
            comm.all_reduce_sum_.bytes // proves,
            [rs.calls // proves, rs.bytes // proves, rs.received // proves])


def sharded_ml(prover, seed: int, reps: int, refs: dict, guard) -> dict:
    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    poly = headline_poly(seed, NV)

    def prove():
        rng = Blake2b512Rng.setup()
        proof, _state = prover.prove_as_subprotocol(rng, poly)
        return serialize_proof(proof), repr(rng.state_tuple())

    proves = reps + 1
    results, walls, launches, calls, nbytes, _rs = _counted(prove, proves, guard)
    check(all(r == (refs["ml"], refs["ml_state"]) for r in results),
          "sharded ML: proof or final transcript differs from the single card's")
    want = {k: 0 for k in launches}
    want.update({"round_nofold": proves, "round_fold": (NV - 1) * proves,
                 "transcript_step": NV * proves, "pair_init": proves})
    check(launches == want, f"sharded ML: launches {launches}, expected {want}")
    return {"what": f"ML nv={NV} 2x3, proof and final transcript", "walls": walls,
            "prove_s": statistics.median(walls), "launches": launches, "collectives": calls,
            "bytes": nbytes}


def sharded_gkr(prover, seed: int, refs: dict, guard) -> dict:
    import torch.distributed as dist

    from sumcheck_tpu_torch import Blake2b512Rng
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch import microbench as MB
    from sumcheck_tpu_torch.fields import limbs_np as L
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.parallel import comm

    f1, f2, f3, g = inst = MB.gkr_instance(GKR_DIM, seed)
    dim = f2.num_vars

    def prove():
        return prover.prove(Blake2b512Rng.setup(), *inst).serialize_uncompressed()

    results, walls, launches, calls, nbytes, rs = _counted(prove, 2, guard)
    rs_calls, rs_sent, rs_received = rs
    check(all(r == refs["gkr"] for r in results),
          "sharded GKR: proof differs from the single card's")
    # the inits' exchange: one reduce-scatter a phase of the whole (8, 2^dim)
    # raw sums, each rank receiving its block; no init all-reduce
    size = prover.num_shards
    sums_bytes = 64 << dim
    check([rs_calls, rs_sent, rs_received] == [2, 2 * sums_bytes, 2 * sums_bytes // size],
          f"sharded GKR: reduce-scatters a prove {[rs_calls, rs_sent, rs_received]}, expected "
          f"2 of {sums_bytes} bytes each, receiving {sums_bytes // size}")
    check(calls == 2 * (dim - (size.bit_length() - 1) + 1),
          f"sharded GKR: {calls} all-reduces a prove, expected one a sharded round and a "
          f"gather a phase, none for the inits")
    want = {k: 0 for k in launches}
    want.update({"round_nofold": 4, "round_fold": 4 * (dim - 1), "transcript_step": 4 * dim})
    # a rank's inits (2 proves): the weight reduce into the raw limb sums
    # (its blocks building the half tables) and the finish of the rank's
    # dealt lanes of the all-reduced sums straight into its pair, slot 1
    # from the same launch, once a phase; no pair slots
    want.update({"weight_reduce": 4, "finish_sums": 4, "pair_slots": 0})
    check(launches == want, f"sharded GKR: launches {launches}, expected {want}")

    # the inits alone at fixed challenges, a warm pass and INIT_PASSES timed,
    # each of the pass's two reduce-scatters timed between syncs; then, off
    # the prover path, the raw sums of one pass exchanged again in
    # EXCHANGE_PAIRS pairs, the reduce-scatter and the all-reduce of the same
    # sums (the exchange the inits made before; its result is dropped), the
    # first of each pair alternating, each behind a barrier
    shard = (prover.rank, prover.num_shards)
    split, _f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, dim, prover.device, shard)
    f2_mine, f3_mine = (t.to_device(prover.device, shard) for t in (f2, f3))
    gen = np.random.default_rng(dim)
    us = torch.from_numpy(np.stack([L.mont_scalar(int(gen.integers(1, 1 << 62)) % P)[:, 0]
                                    for _ in range(dim)]).astype(np.int32)).to(prover.device)
    reduced, raws = [], []

    def timed(t):
        sync(prover.device)
        t0 = time.perf_counter()
        mine = comm.reduce_scatter_sum_(t, prover.group)
        sync(prover.device)
        reduced.append((time.perf_counter() - t0, t.numel() * 8, mine.numel() * 8))
        return mine

    def kept(t):
        raws.append(t.clone())
        return comm.reduce_scatter_sum_(t, prover.group)

    def inits(reduce_fn):
        lo, hi, w = GI.phase1_pair(split, g_r, f3_d, f2_mine, dim, reduce_fn=reduce_fn,
                                   shard=shard)
        GI.phase2_pair(lo[:, :, :1], hi[:, :, :1], us[dim - 1], split, w, us, f3_mine, dim,
                       reduce_fn=reduce_fn, shard=shard)

    passes = []
    for _ in range(INIT_PASSES + 1):  # the first warms
        reduced.clear()
        sync(prover.device)
        t0 = time.perf_counter()
        inits(timed)
        sync(prover.device)
        passes.append((time.perf_counter() - t0, sum(t for t, _, _ in reduced)))
    passes = passes[1:]
    inits(kept)

    def exchange(fn, t) -> float:
        dist.barrier(group=prover.group)
        sync(prover.device)
        t0 = time.perf_counter()
        fn(t)
        sync(prover.device)
        return time.perf_counter() - t0

    def scatter(t):
        comm.reduce_scatter_sum_(t, prover.group)

    def whole(t):
        comm.all_reduce_sum_(t, prover.group)

    pairs = []
    for k in range(EXCHANGE_PAIRS + 1):  # the first warms
        rs_s = ar_s = 0.0
        for t in raws:
            copy = t.clone()
            if k % 2 == 0:
                rs_s += exchange(scatter, t)
                ar_s += exchange(whole, copy)
            else:
                ar_s += exchange(whole, copy)
                rs_s += exchange(scatter, t)
        pairs.append((rs_s, ar_s))
    pairs = pairs[1:]
    return {"what": f"GKR dim {dim} (nnz 2^{dim}), proof", "walls": walls,
            "prove_s": statistics.median(walls), "launches": launches, "collectives": calls,
            "bytes": nbytes, "reduce_scatters": [rs_calls, rs_sent, rs_received],
            "inits": {"total_s": statistics.median(t for t, _ in passes),
                      "compute_s": statistics.median(t - r for t, r in passes),
                      "reduce_scatter_s": statistics.median(r for _, r in passes),
                      "sent": [b for _, b, _ in reduced],
                      "received": [b for _, _, b in reduced],
                      "backend": comm.backend(prover.group),
                      "pairs": pairs,
                      "pair_reduce_scatter_s": statistics.median(r for r, _ in pairs),
                      "pair_all_reduce_s": statistics.median(a for _, a in pairs),
                      "pair_ratio": statistics.median(r / a for r, a in pairs)}}


def sharded_batch(ml, seed: int, reps: int, refs: dict, guard) -> dict:
    from sumcheck_tpu_torch.batch import BatchedMLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    polys = headline_polys(seed, BATCH_NV, BATCH)

    def prove():
        return [serialize_proof(p) for p in BatchedMLSumcheck.prove(polys, device=ml.device,
                                                                     group=ml.group)]

    proves = reps + 1
    results, walls, launches, calls, nbytes, _rs = _counted(prove, proves, guard)
    check(all(r == refs["batch"] for r in results),
          "sharded batch: proofs differ from the single card's")
    want = {k: 0 for k in launches}
    want.update({"pair_init": BATCH // ml.num_shards * proves, "round_nofold_batched": proves,
                 "round_fold_batched": (BATCH_NV - 1) * proves,
                 "transcript_step_batched": BATCH_NV * proves})
    check(launches == want, f"sharded batch: launches {launches}, expected {want}")
    return {"what": f"batch {BATCH} x nv={BATCH_NV} 2x3, {BATCH // ml.num_shards} instances a "
                    f"rank, every proof", "walls": walls, "prove_s": statistics.median(walls),
            "launches": launches, "collectives": calls, "bytes": nbytes}


# --- the entry point, the multi-rank dry run and the microbench
# (`sumcheck_tpu_torch/entry.py`, `sumcheck_tpu_torch/microbench.py`)


def entry_phase(device) -> dict:
    """Phase 11b: `entry()` on the card against `entry(device="cpu")` on the
    same inputs: the folded tables and the round's sums equal, one
    `round_fold` launch a call."""
    from sumcheck_tpu_torch import entry as E

    fn, args = E.entry(device)
    cpu_fn, cpu_args = E.entry("cpu")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(args, cpu_args)),
          "entry: the card's inputs differ from the CPU's")
    for f in counters().values():
        f.launches = 0
    folded, sums = fn(*args)
    launches = {k: f.launches for k, f in counters().items()}
    want_folded, want_sums = cpu_fn(*cpu_args)
    check(torch.equal(folded.cpu(), want_folded) and np.array_equal(sums, want_sums),
          "entry: the card's folded tables or sums differ from the CPU's")
    want = {k: 0 for k in launches}
    want["round_fold"] = 1
    check(launches == want, f"entry: launches {launches}, expected {want}")
    call_s = wall(lambda: fn(*args), device, reps=5)
    print(f"entry: folded tables {tuple(folded.shape)} and sums {sums.shape} equal to the CPU's; "
          f"one round_fold launch; {call_s * 1e3:.4f} ms a call (median of 5, with the host "
          f"finish of the sums)")
    return {"launches": launches, "call_s": call_s}


def dryrun_phase(device) -> dict:
    """Phase 11c: `dryrun_multichip(2)` on the card (gloo, both ranks on
    card 0; NCCL where the machine has two cards), whose ranks check every
    case against their single-card proves, then the proofs against
    `dryrun_multichip(2, device="cpu")`'s. Returns rank 0's launches in each
    sharded prove by path (each counted from zero just before that prove,
    without the reference proves')."""
    from sumcheck_tpu_torch import entry as E

    torch.cuda.empty_cache()  # the ranks allocate on the same card
    t0 = time.perf_counter()
    res = E.dryrun_multichip(2)
    card_s = time.perf_counter() - t0
    cpu = E.dryrun_multichip(2, device="cpu")
    check(all(res[k] == cpu[k] for k in ("ml", "gkr", "batch")),
          "dry run: the card's proofs differ from the CPU's")
    # the kernels each sharded prove must launch on every rank
    want = {"sp": ("round_fold",), "chained": ("round_fold", "transcript_step"),
            "gkr": ("round_fold", "transcript_step", "weight_reduce", "finish_sums"),
            "batch": ("round_fold_batched", "transcript_step_batched")}
    for r in res["ranks"]:
        check(all(r["launches"][case][name] > 0 for case, names in want.items()
                  for name in names) and r["launches"]["gkr"]["pair_slots"] == 0,
              f"dry run: rank on {r['device']} launched {r['launches']}")
    rank0 = res["ranks"][0]
    print(f"dry run S=2 {res['backend']}: ranks on {', '.join(r['device'] for r in res['ranks'])}; "
          f"ShardedProver = ChainedShardedProver = the single card's host-transcript prove, the "
          f"sharded GKR (odd nnz) = the single card's, the sharded batch = each instance's, on "
          f"every rank, and all equal to the CPU's; {card_s:.1f} s for the spawn; "
          f"{rank0['collectives']} all-reduces and {rank0['reduce_scatters']} reduce-scatters; "
          f"launches of each sharded prove, rank 0: "
          + "; ".join(f"{case} { {k: v for k, v in n.items() if v} }"
                      for case, n in rank0["launches"].items()))
    return {f"dryrun {case} S=2": {"launches": n} for case, n in rank0["launches"].items()}


MICROBENCH_REPS = 5  # the host walls of the GKR stages spread by tens of percent


def microbench_phase(seed: int) -> dict:
    """Phase 11d: `python -m sumcheck_tpu_torch.microbench 18` in a process
    of its own, as a user runs it, its stages over phase 9's instance (the
    same seed): every probe checked against its plain or NumPy value, every
    stage's messages against the full prove's. A fresh process, because
    this one has by now profiled tens of thousands of launches and spawned
    ranks on the card, after which the profiler drops the device records of
    most profiles (`microbench.profile_events`). Prints one line a probe
    and a stage; returns the report."""
    import tempfile

    from sumcheck_tpu_torch import microbench as MB

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "microbench.json"
        proc = subprocess.run(
            [sys.executable, "-m", "sumcheck_tpu_torch.microbench", str(GKR_DIM), "--reps",
             str(MICROBENCH_REPS), "--seed", str(seed), "--out", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"the microbench exited with code {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}")
        res = json.loads(out.read_text())
    check(tuple(res["probes"]) == MB.PROBES and tuple(res["stages"]) == MB.STAGES
          and all(p["ok"] for p in res["probes"].values()),
          f"microbench: probes {list(res['probes'])}, stages {list(res['stages'])}")
    check(all(res[part][k]["host_ms"] > 0 and res[part][k]["launches"] is not None
              for part in ("probes", "stages") for k in res[part]),
          "microbench: a probe or stage has no host wall or launch count")

    def num(v, fmt=".4f"):
        return "null" if v is None else format(v, fmt)

    for part in ("probes", "stages"):
        for name, m in res[part].items():
            print(f"microbench {name}: device {num(m['device_ms'])} ms, host {num(m['host_ms'])} "
                  f"ms, {m['launches']} launches and {m['copies']} copies, busy "
                  f"{num(m['busy_ms'])} ms, bound {num(m['bound_ms'])} ms ({m['bound_by']})"
                  + (f", {m['clocks']:.0f} clocks" if "clocks" in m else "")
                  + (f"; kernels {m['kernels']}" if m.get("kernels") is not None else "")
                  + ("" if m["held"] is not False else "; no device ms: the call's launches "
                     "overflow the launch queue, so the sleep cannot hold them"))
    inits = {k: res["stages"]["full_prove"]["kernels"].get(k, 0) for k in GKR_INIT_KERNELS}
    check(inits == INIT_LAUNCHES and sum(inits.values()) <= GKR_INIT_MAX,
          f"microbench: the full prove's init kernels {inits}")
    print(f"microbench: the full prove's phase inits launch {sum(inits.values())} kernels "
          f"({inits})")
    return res


# --- the verifier's cores: the C core against the Python loop


def verify_core_phase(ml_proof: bytes, gkr_proof: bytes) -> dict:
    """The ML nv=20 2x3 and GKR dim-18 verify walls on the card's host with
    the C core (`native/`, the default) and with ``SUMCHECK_TPU_NATIVE=off``
    (hashlib and the per-round Python loop: the verifier before the C core),
    from the headline proofs; the same subclaims both ways. Medians of 21
    (GKR: 5) verifies."""
    import os

    from sumcheck_tpu_torch import (
        Blake2b512Rng, GKRProof, GKRRoundSumcheck, MLSumcheck, PolynomialInfo,
    )
    from sumcheck_tpu_torch.ml_sumcheck import deserialize_proof

    info = PolynomialInfo(3, NV)
    proof = deserialize_proof(ml_proof)
    gproof = GKRProof.deserialize_uncompressed(gkr_proof)
    s, gs = MLSumcheck.extract_sum(proof), gproof.extract_sum()

    def ml():
        sub = MLSumcheck.verify(info, s, proof)
        return [x.v for x in sub.point] + [sub.expected_evaluation.v]

    def gkr():
        sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), GKR_DIM, gproof, gs)
        return [x.v for x in sub.u + sub.v] + [sub.expected_evaluation.v]

    out, subs = {}, {}
    saved = os.environ.get("SUMCHECK_TPU_NATIVE")
    try:
        for core in ("c", "python"):
            os.environ["SUMCHECK_TPU_NATIVE"] = "off" if core == "python" else "on"
            for what, reps, fn in (("ml", 21, ml), ("gkr", 5, gkr)):
                walls = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    subs[what, core] = fn()
                    walls.append(time.perf_counter() - t0)
                out[f"{what} {core}"] = statistics.median(walls)
    finally:
        if saved is None:
            os.environ.pop("SUMCHECK_TPU_NATIVE", None)
        else:
            os.environ["SUMCHECK_TPU_NATIVE"] = saved
    check(subs["ml", "c"] == subs["ml", "python"] and subs["gkr", "c"] == subs["gkr", "python"],
          "the C core and the Python loop verify to different subclaims")
    print(f"verify walls on the host, C core / Python loop (SUMCHECK_TPU_NATIVE=off), same "
          f"subclaims: ML nv={NV} {out['ml c']:.6f} / {out['ml python']:.6f} s (median of 21), "
          f"GKR dim {GKR_DIM} {out['gkr c']:.6f} / {out['gkr python']:.6f} s (median of 5)")
    return out


# --- the second field: BN254 Fr, in a child process (`--field-phase`)

FIELD = "bn254_fr"
FIELD_TRANSCRIPT_ROUNDS = 320
# the kernels of the kernels line, each with its phase-3..6d main shape
KERNEL_NAMES = ("round_nofold", "round_fold", "round_step_nofold", "round_step_fold",
                "round_fold_mxu", "transcript_step", "pair_init", "round_nofold_batched",
                "round_fold_batched", "round_step_fold_batched",
                "transcript_step_batched") + GKR_INIT_KERNELS


def main_shape_bound(name: str, main_shape: dict) -> tuple[float, str, str]:
    """(bound ms, "bytes" or "operations", what sets it) at a kernel's main
    shape: the transcript steps' latency bound, else `bound_of`."""
    if name.startswith("transcript_step"):
        return main_shape["bound"]["bound_ms"], "operations", "latency"
    return bound_of(main_shape["work"])


def field_child(seed: int, reps: int) -> dict:
    """Run `chip_smoke.py --field-phase` under ``SUMCHECK_TPU_FIELD=bn254_fr``
    (the libraries are built already, so it builds nothing): its lines pass
    through, marked with the field; a failure there raises here. Returns the
    JSON object of its last line."""
    import os

    env = dict(os.environ, SUMCHECK_TPU_FIELD=FIELD)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--field-phase", "--seed", str(seed),
           "--reps", str(reps)]
    lines = []
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env) as proc:
        for line in proc.stdout:
            print(f"[{FIELD}] {line}", end="", flush=True)
            lines.append(line)
    check(proc.returncode == 0, f"the {FIELD} phase exited with code {proc.returncode}")
    return json.loads(lines[-1])["field_phase"]


def field_golden_phase(device) -> None:
    """The BN254 golden fixture `tests/fixtures/bn254_torch.json` (made by
    the JAX package under BN254, `tests/test_torch_field.py`): the ML nv=6
    instance and the GKR dim-5 instance on both chains and in the MXU fold
    mode, and the `Fr.rand` draws."""
    from sumcheck_tpu_torch import Blake2b512Rng, Fr
    from sumcheck_tpu_torch.fields.fr import P

    fx = json.loads((FIXTURES / "bn254_torch.json").read_text())
    check(fx["field"] == FIELD and int(fx["p"], 16) == P, "bn254_torch.json is not over this p")
    golden_phase(device, [("bn254_torch.json ml", fx["ml"])])
    gkr_golden_phase(device, fx["gkr"], "bn254_torch.json gkr")
    rng = Blake2b512Rng.setup()
    rng.feed_bytes(bytes.fromhex(fx["fr_rand"]["seed_feed"]))
    draws = [format(Fr.rand(rng).v, "064x") for _ in fx["fr_rand"]["draws_canonical"]]
    check(draws == fx["fr_rand"]["draws_canonical"], "bn254_torch.json: Fr.rand draws")
    print(f"golden bn254_torch.json fr_rand: {len(draws)} draws equal")


def field_ml_proves(device, seed: int, reps: int, nv: int = NV) -> dict:
    """`MLSumcheck.prove` on the nv=20 2x3 instance on the three paths and
    the host-transcript loop: launch counts, first and warm walls, proof
    bytes equal across all four, one verify (C core) and the subclaim."""
    from sumcheck_tpu_torch import Blake2b512Rng, MLSumcheck
    from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

    poly = headline_poly(seed, nv)
    out = {}
    for path, (chain, mxu) in PATHS.items():
        kernels = path_kernels(chain, mxu)
        with fold_mode(chain, mxu), syncs_forbidden_in_chains():
            for f in counters().values():
                f.launches = 0
            t0 = time.perf_counter()
            proof = MLSumcheck.prove(poly, device=device)
            first_s = time.perf_counter() - t0
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                MLSumcheck.prove(poly, device=device)
                walls.append(time.perf_counter() - t0)
            launches = {k: f.launches for k, f in counters().items()}
        proves = reps + 1
        want = {k: 0 for k in launches}
        want.update({kernels[0]: proves, kernels[1]: proves * (nv - 1),
                     "transcript_step": proves * nv, "pair_init": proves})
        check(launches == want, f"{FIELD} ML {path}: launches {launches}, expected {want}")
        out[f"ml {path}"] = {"prove_s": statistics.median(walls), "first_s": first_s,
                             "launches": launches, "proof": serialize_proof(proof)}
        print(f"{FIELD} ML nv={nv} 2x3 {path}: first {first_s:.4f} s, median of {reps} warm "
              f"{out[f'ml {path}']['prove_s']:.4f} s; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    t0 = time.perf_counter()
    host, _ = MLSumcheck.prove_as_subprotocol(HostTranscriptRng(), poly, device=device)
    host_s = time.perf_counter() - t0
    proofs = {p: h["proof"] for p, h in out.items()}
    proofs["host-transcript loop"] = serialize_proof(host)
    check(len(set(proofs.values())) == 1, f"{FIELD} ML: the paths prove different bytes")
    fs_rng = Blake2b512Rng.setup()
    proof, state = MLSumcheck.prove_as_subprotocol(fs_rng, poly, device=device)
    sub = MLSumcheck.verify(poly.info(), MLSumcheck.extract_sum(proof), proof)
    check(state.randomness == sub.point
          and evaluate_on_card(poly, sub.point, device) == sub.expected_evaluation,
          f"{FIELD} ML: subclaim")
    out["ml generic"]["transcript"] = repr(fs_rng.state_tuple())
    print(f"{FIELD} ML: proof bytes equal on {', '.join(proofs)} ({host_s:.4f} s); verify "
          f"accepts, subclaim equals the polynomial at the point and the prover's randomness")
    return out


def subclaim_in_integers(inst, sub) -> bool:
    """`verify_subclaim` in Python integers: f1(g, u, v) f2(u) f3(v) from the
    eq tables of g, u and v (low variable first) and the tables' canonical
    values, with none of the limb arithmetic that the prover's inits and
    `verify_subclaim` share; seconds at dim 18, where `verify_subclaim`
    takes 40-75 s."""
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.fields.limbs_np import to_ints

    f1, f2, f3, g = inst
    dim = f2.num_vars

    def eq_table(point):
        tab = [1]
        for r in point:
            tab = [t * (1 - r.v) % P for t in tab] + [t * r.v % P for t in tab]
        return tab

    eg, eu, ev = (eq_table(pt) for pt in (g, sub.u, sub.v))
    mask = (1 << dim) - 1
    f1_guv = sum(w * eg[i & mask] % P * eu[(i >> dim) & mask] % P * ev[i >> 2 * dim]
                 for i, w in zip(f1.indices.tolist(), to_ints(f1.values)))
    f2_u = sum(a * b for a, b in zip(to_ints(f2.evals), eu))
    f3_v = sum(a * b for a, b in zip(to_ints(f3.evals), ev))
    return f1_guv % P * (f2_u % P) % P * (f3_v % P) % P == sub.expected_evaluation.v


def field_gkr_proves(device, seed: int, reps: int) -> dict:
    """`GKRRoundSumcheck.prove` at dim 18 on the three paths: launch counts
    (the phase inits' among them), walls, one profiled prove's init kernels
    and idle share, bytes equal, `verify` (C core) on each, and the subclaim checked
    in Python integers (`subclaim_in_integers`), which holds the inits at
    dim 18; `verify_subclaim` itself (40-75 s of limb arithmetic on the
    host) runs in the GKR batch, on two instances at dim 14."""
    from sumcheck_tpu_torch import Blake2b512Rng, GKRRoundSumcheck
    from sumcheck_tpu_torch import microbench as MB

    f1, f2, f3, g = inst = MB.gkr_instance(GKR_DIM, seed)
    dim = f2.num_vars
    out = {}
    for path, (chain, mxu) in PATHS.items():
        kernels = path_kernels(chain, mxu)
        with fold_mode(chain, mxu), syncs_forbidden_in_chains():
            for f in counters().values():
                f.launches = 0
            walls = []
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                proof = GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device=device)
                walls.append(time.perf_counter() - t0)
            launches = {k: f.launches for k, f in counters().items()}
        proves = reps + 1
        want = {k: 0 for k in launches}
        want.update({kernels[0]: 2 * proves, kernels[1]: 2 * (dim - 1) * proves,
                     "transcript_step": 2 * dim * proves})
        inits = INIT_LAUNCHES
        want.update({k: v * proves for k, v in inits.items()})
        check(launches == want, f"{FIELD} GKR {path}: launches {launches}, expected {want}")
        with fold_mode(chain, mxu):
            busy = device_busy(lambda: GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst,
                                                              device=device))
        print(f"{FIELD} GKR {path}: the phase inits launch {sum(inits.values())} kernels a "
              f"prove; the profiled prove's {busy['kernels']['init']} init kernels take "
              f"{busy['device_ms']['init']:.4f} ms, idle share {busy['idle_share']:.4f}")
        t0 = time.perf_counter()
        sub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, proof, proof.extract_sum())
        verify_s = time.perf_counter() - t0
        out[f"gkr {path}"] = {"prove_s": statistics.median(walls[1:]), "first_s": walls[0],
                              "verify_s": verify_s, "launches": launches,
                              "idle_share": busy["idle_share"],
                              "proof": proof.serialize_uncompressed()}
        print(f"{FIELD} GKR dim={dim} {path}: first {walls[0]:.4f} s, median of {reps} warm "
              f"{out[f'gkr {path}']['prove_s']:.4f} s; verify accepts ({verify_s:.6f} s)")
    check(len({h["proof"] for h in out.values()}) == 1, f"{FIELD} GKR: paths differ")
    t0 = time.perf_counter()
    check(subclaim_in_integers(inst, sub), f"{FIELD} GKR dim={dim}: the subclaim fails")
    print(f"{FIELD} GKR: proof bytes equal on {', '.join(PATHS)}; the subclaim holds in Python "
          f"integers ({time.perf_counter() - t0:.2f} s; verify_subclaim runs at dim "
          f"{GKR_BATCH_DIM}, in the GKR batch)")
    return out


def field_phase_main(args) -> int:
    """`--field-phase`: every kernel of the main paths against its plain
    version, the golden fixture and the proves, under BN254 Fr (the parent
    sets ``SUMCHECK_TPU_FIELD``), at the sizes of the BLS12-381 phases; the
    last line is one JSON object of the numbers."""
    import os
    import tempfile

    from sumcheck_tpu_torch import microbench as MB
    from sumcheck_tpu_torch.fields.fr import FIELD_NAME, NINV16, NINV32, P, SHAVE_BITS
    from sumcheck_tpu_torch.ops import cuda_build

    check(FIELD_NAME == FIELD, f"--field-phase runs under SUMCHECK_TPU_FIELD={FIELD}")
    device = torch.device("cuda", 0)
    print(f"field {FIELD_NAME}: p = {P:#x}, -p^-1 mod 2^32 = {NINV32:#010x}, -p^-1 mod 2^16 = "
          f"{NINV16:#06x}, {SHAVE_BITS} shaved bits")
    RATES.update(MB.card_rates(device))
    t0 = time.perf_counter()
    libs = cuda_build.build("round", "transcript", "round_mxu", "pair_init", "gkr_init")
    print(f"libraries: {', '.join(lib.name for lib in libs.values())} ({time.perf_counter() - t0:.2f}"
          f" s: built by the parent, the field is a launch parameter)")
    # the plain transcript over the transcript phase's rounds, on the host's
    # CPU in a process of its own while the card runs the phases below
    with tempfile.TemporaryDirectory() as tmp:
        plain_file = os.path.join(tmp, "plain.pt")
        plain_proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--plain-transcript", plain_file,
             "--seed", str(args.seed)])
        try:
            return _field_phases(args, device, libs, plain_proc, plain_file)
        finally:
            if plain_proc.poll() is None:  # a phase failed before it was waited for
                plain_proc.kill()
            plain_proc.wait()


def _field_phases(args, device, libs, plain_proc, plain_file: str) -> int:
    """The phases of `field_phase_main`; `plain_proc` is writing the plain
    transcript to `plain_file`."""
    from sumcheck_tpu_torch import microbench as MB

    marks = [("", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))

    stats = kernel_phase(device, args.seed)
    stats.update(step_kernel_phase(device, args.seed))
    stats.update(mxu_kernel_phase(device, args.seed))
    mark("round kernels")
    mxu_mul_phase(device, args.seed)
    mont_mul_phase(device, args.seed, libs["round"])
    stats.update(pair_init_phase(device, args.seed))
    stats.update(batch_kernel_phase(device, args.seed))
    stats.update(batch_transcript_phase(device, args.seed))
    mark("multiplies, pair init and batched kernels")
    field_golden_phase(device)
    mark("golden fixture")
    heads = field_ml_proves(device, args.seed, args.reps)
    stats.update(gkr_init_phase(device, MB.gkr_instance(GKR_DIM, args.seed), args.seed))
    mark("ML proves and the GKR init kernels")
    heads.update(field_gkr_proves(device, args.seed, args.reps))
    mark("GKR proves")
    for path in BATCH_PATHS:
        heads[path] = batch_ml_phase(device, args.seed, args.reps, path)
    check(heads["batch ml generic"]["proofs"] == heads["batch ml per-size"]["proofs"],
          "the two batched chains prove different bytes")
    heads["batch gkr generic"] = gkr_batch_phase(device, args.seed, 1)
    mark("batches")
    heads["interactive ml"] = interactive_phase(device, args.seed, args.reps, heads["ml generic"])
    heads["gkr host-transcript"] = gkr_host_phase(
        device, args.seed, MB.gkr_instance(GKR_DIM, args.seed), args.reps, check_plain=False)
    mark("round-by-round prover")
    refs = {"ml": heads["ml generic"]["proof"], "ml_state": heads["ml generic"]["transcript"],
            "ml_abc": heads["interactive ml"]["abc_proof"],
            "ml_abc_state": heads["interactive ml"]["abc_transcript"]}
    torch.cuda.empty_cache()
    heads.update(run_ranks(2, "gloo", args.seed, args.reps, refs, cases=("ml", "sp")))
    mark("sharded ML")
    roofline = roofline_phase(device, heads["ml generic"]["prove_s"],
                              heads["gkr generic"]["prove_s"])

    def wait_plain():
        check(plain_proc.wait() == 0, "the plain transcript process failed")
        return torch.load(plain_file)

    stats.update(transcript_phase(device, args.seed, FIELD_TRANSCRIPT_ROUNDS, plain=wait_plain))
    tr = stats["transcript_step"][1][0]
    check(tr["compactions"] >= 1, f"{FIELD}: no stream compaction in "
                                  f"{FIELD_TRANSCRIPT_ROUNDS} transcript rounds")
    mark("transcript")
    print(f"{FIELD} host seconds by phase: " + ", ".join(
        f"{label} {t - prev:.1f}" for (_, prev), (label, t) in zip(marks, marks[1:])))
    kernels = {}
    for name in KERNEL_NAMES:
        err, timings = stats[name]
        bound_ms, bound_by, _ = main_shape_bound(name, timings[0])
        kernels[name] = {"max_abs_err": err, "ms": timings[0]["ms"],
                         "plain_ms": timings[0]["plain_ms"], "bound_ms": bound_ms,
                         "bound_by": bound_by, "shape": timings[0]["shape"]}
    walls = {path: {k: h[k] for k in ("prove_s", "per_proof_s", "launches") if k in h}
             for path, h in heads.items()}
    print(json.dumps({"field_phase": {
        "field": FIELD, "kernels": kernels, "walls": walls,
        "transcript": {"rounds": FIELD_TRANSCRIPT_ROUNDS, "attempts": tr["attempts"],
                       "compactions": tr["compactions"],
                       "compressions": tr["bound"]["compressions"]},
        "roofline": roofline,
        "seconds": marks[-1][1] - marks[0][1]}}))
    return 0


def short_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    import re

    m = re.search(r"\d+([a-z][a-z_]*_kernel)(I\w*?E)?E", mangled)
    return (m.group(1) + (m.group(2) or "")) if m else mangled[:60]


def sass_ops(lib: Path, kernel: str) -> dict:
    """{function: Counter of opcodes with their modifiers} of each function
    of `lib` whose name holds `kernel`, from `cuobjdump -sass`; empty where
    the toolkit has no cuobjdump."""
    import collections
    import os
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True).stdout
    res, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                res[cur] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T\d]\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur and m:
            res[cur][m.group(1)] += 1
    return res


# opcode classes of a Montgomery multiply's SASS: (label, test on the opcode)
SASS_CLASSES = (
    ("IMAD.WIDE", lambda op: op.startswith("IMAD.WIDE")),
    ("IMAD.HI", lambda op: op.startswith("IMAD.HI")),
    ("IMAD.X", lambda op: op.startswith("IMAD") and ".X" in op and "HI" not in op
     and "WIDE" not in op),
    ("IMAD", lambda op: op in ("IMAD", "IMAD.U32")),
    ("IMAD.MOV/SHL/IADD", lambda op: op.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD"))),
    ("IADD3", lambda op: op.startswith("IADD3") and ".X" not in op),
    ("IADD3.X", lambda op: op.startswith("IADD3") and ".X" in op),
    ("SEL", lambda op: op.startswith("SEL")),
    ("ISETP", lambda op: op.startswith("ISETP")),
    ("LOP3", lambda op: op.startswith("LOP3")),
)


def sass_classes(ops) -> dict:
    """A Counter of opcodes -> counts per `SASS_CLASSES` label, the rest as
    "other", and "total"."""
    out = {label: 0 for label, _ in SASS_CLASSES}
    out["other"] = 0
    for op, n in ops.items():
        label = next((lb for lb, test in SASS_CLASSES if test(op)), "other")
        out[label] += n
    out["total"] = sum(ops.values())
    return out


def multiply_sass(lib: Path) -> dict:
    """{impl: SASS instruction counts of one multiply} for `csrc/round.cu`'s
    two multiplies, as the counts of `mont_mul_count_kernel<impl, 2>` less
    those of `<impl, 1>`; empty without cuobjdump."""
    funcs = sass_ops(lib, "mont_mul_count_kernel")
    out = {}
    for impl, code in (("cios", 0), ("eo", 1)):
        one = [c for f, c in funcs.items() if f"ILi{code}ELi1E" in f]
        two = [c for f, c in funcs.items() if f"ILi{code}ELi2E" in f]
        if one and two:
            out[impl] = sass_classes(two[0] - one[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--field-phase", action="store_true",
                    help=f"run the {FIELD} phase (the parent starts it under "
                         f"SUMCHECK_TPU_FIELD={FIELD})")
    ap.add_argument("--plain-transcript", metavar="PATH",
                    help="save the plain transcript over the transcript phase's inputs, on "
                         "the CPU, to PATH (the field phase starts it)")
    ap.add_argument("--plain-f6", metavar="PATH",
                    help="save the plain transcript step at degree 8,000 over phase 6f's "
                         "inputs, on the CPU, to PATH (the main run starts it)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.plain_transcript:
        torch.save(plain_transcript(args.seed, FIELD_TRANSCRIPT_ROUNDS, 3, torch.device("cpu")),
                   args.plain_transcript)
        return 0
    if args.plain_f6:
        torch.save(f6_plain(args.seed), args.plain_f6)
        return 0
    if args.field_phase:
        return field_phase_main(args)
    import tempfile

    # the plain transcript step at degree 8,000 (phase 6f), on the host's CPU
    # in a process of its own while the kernels build and the card runs
    with tempfile.TemporaryDirectory() as tmp:
        plain_file = os.path.join(tmp, "plain_f6.pt")
        plain_proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--plain-f6", plain_file,
             "--seed", str(args.seed)])

        def plain_f6():
            check(plain_proc.wait() == 0, "the plain F6 transcript process failed")
            return torch.load(plain_file)

        try:
            return main_phases(args, plain_f6)
        finally:
            if plain_proc.poll() is None:  # a phase failed before it was waited for
                plain_proc.kill()
            plain_proc.wait()


def main_phases(args, plain_f6) -> int:
    """Every phase of the main run; `plain_f6()` waits for the plain F6
    transcript step's process and returns its results."""
    from sumcheck_tpu_torch import microbench as MB
    from sumcheck_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    RATES.update(MB.card_rates(device))
    print(f"card rates: {RATES['sms']} SMs at {RATES['clock_hz'] / 1e6:.0f} MHz (max SM clock), "
          f"{RATES['imad_per_s'] / 1e12:.3f}e12 32-bit IMAD/s, {MB.HBM_BYTES_PER_S / 1e12} TB/s")

    t0 = time.perf_counter()
    libs = cuda_build.build("round", "transcript", "round_mxu", "pair_init", "fold_staged",
                            "gkr_init")
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(lib.name for lib in libs.values())} in {build_s:.2f} s (in parallel)")
    ptxas = {}
    for name, lib in libs.items():
        for fn, res in cuda_build.resources(name).items():
            ptxas[fn] = res
            print(f"  ptxas {name}.cu {short_name(fn)}: {res.get('registers')} registers, "
                  f"{res.get('smem')} B static smem, {res.get('stack')} B stack frame, "
                  f"spills {res.get('spill_stores')}/{res.get('spill_loads')} B")
    for name, kernel in (("transcript", "transcript_kernel"), ("round", "round_kernel"),
                         ("round", "11fold_kernel"), ("round", "nofold_kernel"),
                         ("round_mxu", "fold_mxu_kernel"), ("pair_init", "pair_init_kernel")):
        for fn, ops in sass_ops(libs[name], kernel).items():
            c = sass_classes(ops)
            print(f"  SASS {short_name(fn)}: {c['total']} instructions ({c['total'] * 16} B); "
                  + ", ".join(f"{k} {v}" for k, v in c.items() if k != "total" and v))
    for label, key in MAIN_PATH_PTXAS.items():
        res = next(v for k, v in ptxas.items() if key in k)
        got = (res.get("registers"), res.get("stack"), res.get("spill_stores"), res.get("smem"))
        print(f"ptxas main path {label}: {got[0]} registers, {got[1]} B stack, {got[2]} B "
              f"spills, {got[3]} B static smem; before the wide route "
              f"(tools/ptxas_compare.py) {PREVIOUS_PTXAS[label]}")
        check(got == PREVIOUS_PTXAS[label], f"ptxas of {label} changed")
    tk = next(v for k, v in ptxas.items() if "transcript_kernel" in k)
    print(f"transcript_kernel: {tk.get('stack')} B stack frame, spills "
          f"{tk.get('spill_stores')}/{tk.get('spill_loads')} B (208 B before the redesign)")

    marks = [("", t0)]

    def mark(label):  # the host seconds each group of phases took
        marks.append((label, time.perf_counter()))

    mark("build")
    stats = kernel_phase(device, args.seed)
    stats.update(step_kernel_phase(device, args.seed))
    stats.update(mxu_kernel_phase(device, args.seed))
    mark("round kernels")
    mxu_mul = mxu_mul_phase(device, args.seed)
    mul_rates = mont_mul_phase(device, args.seed, libs["round"])
    stats.update(transcript_phase(device, args.seed))
    mark("multiplies and transcript")
    stats.update(pair_init_phase(device, args.seed))
    stats.update(batch_kernel_phase(device, args.seed))
    stats.update(batch_transcript_phase(device, args.seed))
    redesign = redesign_phase(device, args.seed, ptxas)
    mark("pair init, batched kernels and redesigns")
    stats.update(f4_kernel_phase(device, args.seed))
    stats.update(f4_batch_kernel_phase(device, args.seed))
    for row, entry in f6_transcript_phase(device, args.seed, plain_f6).items():
        stats[row][0] = max(stats[row][0], entry["max_abs_err"])
        stats[row][1].append(entry)
    mark("F4 wide-route kernels and F6 transcript steps")
    golden_phase(device)
    gkr_golden_phase(device)
    mark("golden fixtures")

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
    mark("ML headlines")
    inst = MB.gkr_instance(GKR_DIM, args.seed)
    stats.update(gkr_init_phase(device, inst, args.seed))
    stats.update(gkr_batch_init_phase(device, args.seed))
    mark("GKR init kernels")
    gkr = {f"gkr {path}": gkr_headline_phase(device, inst, args.reps, path) for path in PATHS}
    check(len({h["proof"] for h in gkr.values()}) == 1, "the GKR paths prove different bytes")
    print("GKR proof bytes equal: generic chain, per-size chain, generic chain in the MXU fold "
          "mode, the plain path; prove medians "
          + ", ".join(f"{k} {h['prove_s']:.4f} s" for k, h in gkr.items()))
    heads.update(gkr)
    mark("GKR headlines")
    batches = {path: batch_ml_phase(device, args.seed, args.reps, path) for path in BATCH_PATHS}
    check(len({tuple(h["proofs"]) for h in batches.values()}) == 1,
          "the two batched chains prove different bytes")
    mark("ML batch")
    batches["batch gkr generic"] = gkr_batch_phase(device, args.seed, args.reps)
    mark("GKR batch")
    heads.update(f5_empty_f1_phase(device, args.seed))
    mark("F5 empty f1")
    print("batch proof bytes equal: generic and per-size batched chains, per-instance card "
          "proves; per batch / per proof "
          + ", ".join(f"{k} {h['prove_s']:.4f} / {h['per_proof_s']:.5f} s"
                      for k, h in batches.items()))
    heads.update(batches)
    heads.update(f4_prove_phase(device, args.seed))
    heads.update(f4_batch_prove_phase(device, args.seed))
    mark("F4 proves")
    heads.update(f6_prove_phase(device, args.seed))
    mark("F6 prove")
    heads["interactive ml"] = interactive_phase(device, args.seed, args.reps,
                                                heads["ml generic"])
    heads["gkr host-transcript"] = gkr_host_phase(device, args.seed, inst, args.reps)
    mark("round-by-round prover")
    engine_variables_phase()
    heads["f3 interactive"] = zero_coefficient_phase(device, args.seed)
    mark("engine variables and F3")
    refs = {"ml": heads["ml generic"]["proof"], "ml_state": heads["ml generic"]["transcript"],
            "gkr": heads["gkr generic"]["proof"], "batch": heads["batch ml generic"]["proofs"],
            "ml_abc": heads["interactive ml"]["abc_proof"],
            "ml_abc_state": heads["interactive ml"]["abc_transcript"]}
    heads.update(sharded_phase(device, args.seed, args.reps, refs))
    mark("sharded")
    tools = {"entry": entry_phase(device), **dryrun_phase(device)}
    microbench = microbench_phase(args.seed)
    mark("entry, dry run and microbench")
    verify_core_phase(heads["ml generic"]["proof"], heads["gkr generic"]["proof"])
    roofline = roofline_phase(device, heads["ml generic"]["prove_s"],
                              heads["gkr generic"]["prove_s"])
    mark("verify cores and roofline")
    torch.cuda.empty_cache()  # the child allocates on the same card
    field = field_child(args.seed, args.reps)
    mark(f"{FIELD} child")
    print("host seconds by phase: " + ", ".join(
        f"{label} {t - prev:.1f}" for (_, prev), (label, t) in zip(marks, marks[1:])))
    tr = stats["transcript_step"][1][0]
    print(f"transcript attempts a round, BLS12-381 over 60 rounds {tr['attempts']}, "
          f"{tr['compactions']} compactions; {FIELD} over "
          f"{field['transcript']['rounds']} rounds {field['transcript']['attempts']}, "
          f"{field['transcript']['compactions']} compactions")
    for path, w in field["walls"].items():
        if path in heads:
            print(f"wall {path}: BLS12-381 {heads[path]['prove_s']:.4f} s, {FIELD} "
                  f"{w['prove_s']:.4f} s (medians of {args.reps} warm, this call)")

    kernels = []
    sources = {"transcript_step": "transcript.cu", "round_fold_mxu": "round_mxu.cu",
               "transcript_step_batched": "transcript.cu", "pair_init": "pair_init.cu",
               **{name: "gkr_init.cu" for name in GKR_INIT_KERNELS}}
    symbols = {**{name: f"{name}_kernel" for name in GKR_INIT_KERNELS},
               "transcript_step": "transcript_kernel", "round_fold_mxu": "fold_mxu_kernel",
               "transcript_step_batched": "transcript_kernel", "pair_init": "pair_init_kernel",
               "round_nofold": "nofold_kernel", "round_step_nofold": "nofold_kernel",
               "round_nofold_batched": "nofold_kernel", "round_fold": "fold_kernel",
               "round_step_fold": "fold_kernel", "round_fold_batched": "fold_kernel",
               "round_step_fold_batched": "fold_kernel"}
    for name, replaces, path in (
        ("round_nofold", "sumcheck_tpu/ops/round_pallas.py:246", "ml generic"),
        ("round_fold", "sumcheck_tpu/ops/round_pallas.py:192", "ml generic"),
        ("round_step_nofold", "sumcheck_tpu/ops/round_pallas.py:103", "ml per-size"),
        ("round_step_fold", "sumcheck_tpu/ops/round_pallas.py:85", "ml per-size"),
        ("round_fold_mxu", "sumcheck_tpu/ops/round_pallas.py:215", "gkr generic mxu"),
        ("transcript_step", "sumcheck_tpu/protocol/device_prover.py:118", "ml generic"),
        ("pair_init", "sumcheck_tpu/protocol/device_prover.py:181", "ml generic"),
        ("round_nofold_batched", "sumcheck_tpu/batch.py:61", "batch ml generic"),
        ("round_fold_batched", "sumcheck_tpu/batch.py:75", "batch ml generic"),
        ("round_step_fold_batched", "sumcheck_tpu/batch.py:261", "batch ml per-size"),
        ("transcript_step_batched", "sumcheck_tpu/batch.py:304", "batch ml generic"),
        ("weight_reduce", "sumcheck_tpu/ops/gkr_init.py:98, :138, :237 and :472-523",
         "gkr generic"),
        ("finish_sums", "sumcheck_tpu/parallel/gkr.py:50", "sharded gkr S=2 gloo"),
        ("pair_slots", "sumcheck_tpu/ops/gkr_init.py:595-654", "gkr per-size"),
    ):
        err, timings = stats[name]
        main_shape = timings[0]
        bound_ms, bound_by, detail = main_shape_bound(name, main_shape)
        symbol = symbols.get(name, "round_kernel")
        bn = field["kernels"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"sumcheck_tpu_torch/csrc/{sources.get(name, 'round.cu')}",
            "replaces": replaces,
            "launches": {**heads, **tools}[path]["launches"][name],
            "launches_by_path": {p: h["launches"][name] for p, h in {**heads, **tools}.items()},
            "max_abs_err": err,
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_detail": detail,
            "library_ms": None,
            "shape": main_shape["shape"],
            f"{FIELD}_ms": bn["ms"],
            f"{FIELD}_bound_ms": bn["bound_ms"],
            f"{FIELD}_max_abs_err": bn["max_abs_err"],
            "ptxas": {short_name(k): v for k, v in ptxas.items()
                      if short_name(k).split("I")[0] == symbol},
            **({"redesign": redesign[name]} if name in redesign else {}),
            "timings": [{k: v for k, v in t.items() if k not in ("work", "bound")}
                        for t in timings],
        })
        prev = PREVIOUS_MS.get(name)
        print(f"kernel {name}: {main_shape['ms']:.4f} ms at {main_shape['shape']}, bound "
              f"{bound_ms:.4f} ms ({detail}), {bound_ms / main_shape['ms']:.1%} of it; "
              f"{FIELD} {bn['ms']:.4f} ms, bound {bn['bound_ms']:.4f} ms, "
              f"{bn['bound_ms'] / bn['ms']:.1%} of it; "
              + (f"previous version (PERF.md): {prev} ms" if prev else "new in this version"))
    wide_sources = {"round_fold_mxu[wide]": "round_mxu.cu", "transcript_step[wide]": "transcript.cu",
                    "transcript_step_batched[wide]": "transcript.cu",
                    "pair_init[wide]": "pair_init.cu", "weight_reduce_batched": "gkr_init.cu"}
    wide_replaces = {
        "round_nofold[wide]": "sumcheck_tpu/ops/round_pallas.py:315",
        "round_fold[wide]": "sumcheck_tpu/ops/round_pallas.py:306",
        "round_step_nofold[wide]": "sumcheck_tpu/ops/round_pallas.py:163",
        "round_step_fold[wide]": "sumcheck_tpu/ops/round_pallas.py:131",
        "round_fold_mxu[wide]": "sumcheck_tpu/ops/round_pallas.py:289",
        "transcript_step[wide]": "sumcheck_tpu/protocol/device_prover.py:118",
        "pair_init[wide]": "sumcheck_tpu/protocol/device_prover.py:181",
        "round_nofold_batched[wide]": "sumcheck_tpu/batch.py:61",
        "round_fold_batched[wide]": "sumcheck_tpu/batch.py:75",
        "round_step_fold_batched[wide]": "sumcheck_tpu/batch.py:261",
        "transcript_step_batched[wide]": "sumcheck_tpu/batch.py:304",
        "weight_reduce_batched": "sumcheck_tpu/batch.py:565-580"}
    for row, wrapper, path in F4_ROWS + (("weight_reduce_batched", "weight_reduce_batched",
                                          "batch gkr generic"),):
        err, timings = stats[row]
        main_shape = timings[0]
        bound_ms, bound_by, detail = main_shape_bound(row, main_shape)
        kernels.append({
            "name": row,
            "route": "cuda",
            "source": f"sumcheck_tpu_torch/csrc/{wide_sources.get(row, 'round.cu')}",
            "replaces": wide_replaces[row],
            "launches": heads[path]["launches"][wrapper],
            "launches_by_path": {p: h["launches"][wrapper] for p, h in heads.items()
                                 if p.startswith(("f4", "f6")) or p == path},
            "max_abs_err": err,
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_detail": detail,
            "library_ms": None,
            "shape": main_shape["shape"],
            "timings": [{k: v for k, v in t.items() if k not in ("work", "bound")}
                        for t in timings],
        })
        print(f"kernel {row}: {main_shape['ms']:.4f} ms at {main_shape['shape']}, bound "
              f"{bound_ms:.4f} ms ({detail}), {bound_ms / main_shape['ms']:.1%} of it; "
              f"{heads[path]['launches'][wrapper]} launches in {path}")
    print("Montgomery multiplies per second: "
          + ", ".join(f"{k} {v:.4e}" for k, v in mul_rates.items()))
    print(f"card: {card}; prove medians "
          + ", ".join(f"{k} {h['prove_s']:.4f} s" for k, h in heads.items())
          + f"; banded multiply at {mxu_mul['lanes']} lanes {mxu_mul['ms']:.4f} ms, CIOS "
          f"{mxu_mul['cios_ms']:.4f} ms; build {build_s:.2f} s")
    print(f"round-by-round prover: interactive ML {heads['interactive ml']['prove_s']:.4f} s "
          f"({heads['interactive ml']['syncs_per_prove']} syncs) against the generic chain's "
          f"{heads['ml generic']['prove_s']:.4f} s; GKR over {ABC!r} "
          f"{heads['gkr host-transcript']['prove_s']:.4f} s against the chained "
          f"{heads['gkr host-transcript']['chained_s']:.4f} s; ShardedProver "
          + ", ".join(f"{k[len('sharded '):]} {h['prove_s']:.4f} s ({h['collectives']} all-reduces"
                      f", {h['bytes']} B a rank)" for k, h in heads.items()
                      if k.startswith("sharded sp"))
          + f"; pct_sol ML {roofline['ml_pct_sol']}, GKR {roofline['gkr_pct_sol']}; {FIELD}: "
          + ", ".join(f"{k} {field['walls'][k]['prove_s']:.4f} s" for k in
                      ("interactive ml", "gkr host-transcript") if k in field["walls"])
          + f", pct_sol ML {field['roofline']['ml_pct_sol']}")
    print(json.dumps({"microbench": microbench}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
