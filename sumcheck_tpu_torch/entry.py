"""The entry points of the port: the counterpart of the JAX package's
`__graft_entry__.py`.

- `entry(device="cuda")` returns `(fn, args)`: one round of the flagship
  MLSumcheck workload, fold by the challenge, evaluate the round polynomial
  at t = 0..3 and reduce exactly over the lanes, on the 2 products x 3
  multiplicands instance of `__graft_entry__._example(nv=8)` (the reference
  benchmark's product structure). `fn(*args)` is one `round_cuda.round_fold`
  launch (`csrc/round.cu`) and one `round_cuda.finish_sums`; on the CPU it
  runs the kernel's plain version.
- `dryrun_multichip(n_devices, device="cuda")` spawns `n_devices` ranks
  over `torch.distributed` and runs the JAX dry run's three cases on every
  rank: `ShardedProver` and `ChainedShardedProver` (ML), `ShardedGKRProver`
  (an odd nonzero count: the padding path) and the sharded batch, each
  checked byte for byte against the single-device prove on the rank.

    python -m sumcheck_tpu_torch.entry            # entry() on the card
    DRYRUN_DEVICES=2 python -m sumcheck_tpu_torch.entry

This module imports torch and numpy, never JAX and never `sumcheck_tpu`;
the spawned ranks import it.
"""

from __future__ import annotations

import json
import os
import random
import sys
import tempfile

import numpy as np
import torch

from .fields import limbs_np as L
from .fields import limbs_torch as LT

ENTRY_NV = 8
ENTRY_DEGREE = 3
ENTRY_TABLES = 3
ENTRY_CHALLENGE = 789
# the pair's slots: the 3 tables, the ones slot of the JAX layout, then each
# product's coefficient times its first factor (`device_prover._fold_plan`:
# tables 0 and 2 are shared, so each product gets a scaled copy)
ENTRY_PRODUCTS = ((4, 1, 2), (5, 0, 1))
ENTRY_SCALED = ((0, 123), (2, 456))  # (source table, coefficient) of slots 4 and 5


def entry(device="cuda"):
    """(fn, args): one fused fold + evaluate + exact-reduce round.

    `args` = (lo, hi, r): the table pair of `_example(nv=8)` as the round
    kernels take it, (6, 8, 128) int32 limb halves of the natural lane order
    (slots: the 3 tables, the ones table, 123 x table 0, 456 x table 2), and
    the challenge 789 as (16,) Montgomery digits, on `device`. `fn(lo, hi,
    r)` folds a copy of the pair in place and evaluates it (one
    `round_fold` launch over 64 lanes on a card), then finishes the sums on
    the host; it returns the folded (16, 4, 128) int32 digit tables of the
    JAX layout's slots (unpacked from the pair's limbs), on `device`, and
    the (WIDE, 4) uint32 exact sums."""
    from .ops import round_cuda
    from .protocol.device_prover import resolve_device

    device = resolve_device(device)
    # `_example`'s tables (`numpy.random.default_rng(0)`), then the ones table
    tables = L.random_tables(np.random.default_rng(0), ENTRY_NV, ENTRY_TABLES)
    tables = np.stack(tables + [np.broadcast_to(L.mont_scalar(1), tables[0].shape)])
    scaled = [L.mont_mul(tables[src], L.mont_scalar(c)) for src, c in ENTRY_SCALED]
    pair = L.pack_limbs(np.concatenate([tables, np.stack(scaled)]), axis=1)  # (6, 8, n)
    half = pair.shape[2] // 2
    lo = torch.from_numpy(np.ascontiguousarray(pair[:, :, :half])).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(pair[:, :, half:])).to(device)
    r = torch.from_numpy(L.mont_scalar(ENTRY_CHALLENGE)[:, 0].astype(np.int32)).to(device)
    slots = ENTRY_TABLES + 1

    def round_step(lo, hi, r):
        lo, hi = lo.clone(), hi.clone()
        extent = lo.shape[2] // 2
        sums = round_cuda.round_fold(lo, hi, r, ENTRY_PRODUCTS, ENTRY_DEGREE, extent)
        folded = torch.cat([lo[:slots, :, :extent], hi[:slots, :, :extent]], dim=2)
        digits = LT.unpack_limbs(folded, dim=1).to(torch.int32)
        return digits.permute(1, 0, 2), round_cuda.finish_sums(sums)

    return round_step, (lo, hi, r)


# ---------------------------------------------------------------------------
# the multi-rank dry run
# ---------------------------------------------------------------------------


def dryrun_backend(n_devices: int, device) -> str:
    """NCCL with one rank a card where the machine has `n_devices` cards,
    else gloo (on the CPU, or every rank on a card they share)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n_devices:
        return "nccl"
    return "gloo"


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """Spawn `n_devices` ranks (`torch.multiprocessing`, a file store: no
    TCP port) and run on every rank, on the same instances as
    `__graft_entry__.dryrun_multichip`:

    - ML, nv = k+3 (k = max(1, ceil(log2 n))), three tables from
      `random.Random(0)`, products 123 x (0, 1, 2) and 456 x (2, 0):
      `ShardedProver` and `ChainedShardedProver.auto(n)`, equal to each
      other and to the single-device host-transcript prove; verify and the
      subclaim;
    - GKR, dim k+1, 2^dim - 1 nonzeros (odd: the padding path) from
      `random.Random(1)`: `ShardedGKRProver.auto(n)` equal to
      `GKRRoundSumcheck.prove` on the rank's device; verify and
      `verify_subclaim`;
    - the sharded batch, n instances of nv=5 from `random.Random(2)`: each
      proof equal to its own `MLSumcheck.prove`.

    A mismatch raises on the rank, and the spawn raises here. `device` is
    each rank's ("cuda": rank r on card r % device_count), the group's
    backend `dryrun_backend`'s choice. Returns {"backend", "ml", "gkr", "batch"
    (proof bytes, equal on every rank), "ranks" (each rank's device, its
    kernel launches in each sharded prove, counted from zero just before it:
    "sp", "chained", "gkr" and "batch", without the reference proves', and
    its all-reduces)}."""
    import torch.multiprocessing as mp

    from .protocol.device_prover import resolve_device

    resolve_device(device)  # "cuda" without a card raises before any spawn
    backend = dryrun_backend(n_devices, device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, args=(n_devices, backend, str(device), tmp),
                           nprocs=n_devices, join=True, start_method="spawn")
        ranks = []
        for rank in range(n_devices):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    proofs = {k: ranks[0][k] for k in ("ml", "gkr", "batch")}
    for rank, got in enumerate(ranks):
        if {k: got[k] for k in proofs} != proofs:
            raise RuntimeError(f"dry run: rank {rank}'s proofs differ from rank 0's")
    return {"backend": backend, "ml": bytes.fromhex(proofs["ml"]),
            "gkr": bytes.fromhex(proofs["gkr"]),
            "batch": [bytes.fromhex(p) for p in proofs["batch"]],
            "ranks": [{k: got[k] for k in ("device", "launches", "collectives")}
                      for got in ranks]}


def _dryrun_rank(rank: int, size: int, backend: str, device: str, out_dir: str) -> None:
    """One rank of `dryrun_multichip`: joins the group, runs the three
    cases and writes its results to `out_dir`/rank<r>.json."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{out_dir}/init", rank=rank,
                            world_size=size)
    try:
        out = _dryrun_cases(device, backend)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _poly(nv: int, mles, products):
    from .data_structures import ListOfProductsOfPolynomials
    from .fields.fr import Fr

    poly = ListOfProductsOfPolynomials(nv)
    for coeff, idx in products:
        poly.add_product([mles[i] for i in idx], Fr(coeff))
    return poly


def _dryrun_cases(device: str, backend: str) -> dict:
    """The three cases on this rank over the default group."""
    from . import Blake2b512Rng, DenseMLE, Fr, GKRRoundSumcheck, MLSumcheck, SparseMLE
    from .batch import BatchedMLSumcheck
    from .fields.fr import P
    from .ml_sumcheck import serialize_proof
    from .ops import launch_counters
    from .parallel import ChainedShardedProver, ShardedGKRProver, ShardedProver, comm
    from .protocol.generic_prover import prove_host_transcript

    sp = ShardedProver(device=device)
    if backend == "nccl":
        torch.cuda.set_device(sp.device)
    group, dev, size = sp.group, sp.device, sp.num_shards
    k = max(1, (size - 1).bit_length())
    counters, launches = launch_counters(), {}

    def sharded(case, prove):
        """`prove()`, its launches counted from zero into `launches[case]`."""
        for f in counters.values():
            f.launches = 0
        out = prove()
        launches[case] = {name: f.launches for name, f in counters.items()}
        return out

    # ML: both sharded provers against the single device's host-transcript prove
    nv = k + 3
    rnd = random.Random(0)
    poly = _poly(nv, [DenseMLE.rand(nv, rnd) for _ in range(3)],
                 ((123, (0, 1, 2)), (456, (2, 0))))
    proof = sharded("sp", lambda: sp.prove(poly))
    chained = sharded("chained", lambda: ChainedShardedProver.auto(size, device=dev).prove(poly))
    rng = Blake2b512Rng.setup()
    rng.feed(poly.info())
    single, _state = prove_host_transcript(rng, poly, dev)
    ml = serialize_proof(proof)
    _check(serialize_proof(chained) == ml, "ChainedShardedProver differs from ShardedProver")
    _check(serialize_proof(single) == ml, "sharded ML proof differs from the single device's")
    sub = MLSumcheck.verify(poly.info(), MLSumcheck.extract_sum(proof), proof)
    _check(poly.evaluate(sub.point) == sub.expected_evaluation, "ML subclaim does not hold")

    # GKR: one nonzero short of 2^dim, so the last rank's chunk is padded
    dim = k + 1
    rnd = random.Random(1)
    f1 = SparseMLE.rand_with_config(3 * dim, (1 << dim) - 1, rnd)
    f2, f3 = DenseMLE.rand(dim, rnd), DenseMLE.rand(dim, rnd)
    g = [Fr(rnd.randrange(P)) for _ in range(dim)]
    gproof = sharded("gkr", lambda: ShardedGKRProver.auto(size, device=dev).prove(
        Blake2b512Rng.setup(), f1, f2, f3, g))
    gkr = gproof.serialize_uncompressed()
    want = GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g, device=dev)
    _check(want.serialize_uncompressed() == gkr, "sharded GKR proof differs from the single "
                                                 "device's")
    gsub = GKRRoundSumcheck.verify(Blake2b512Rng.setup(), dim, gproof, gproof.extract_sum())
    _check(gsub.verify_subclaim(f1, f2, f3, g), "GKR subclaim does not hold")

    # the sharded batch: one instance a rank
    rnd = random.Random(2)

    def instance():
        mles = [DenseMLE.rand(5, rnd) for _ in range(3)]
        return _poly(5, mles, ((rnd.randrange(P), (0, 1)), (rnd.randrange(P), (2, 0))))

    polys = [instance() for _ in range(size)]
    batch = [serialize_proof(p) for p in
             sharded("batch", lambda: BatchedMLSumcheck.prove(polys, device=dev, group=group))]
    _check(batch == [serialize_proof(MLSumcheck.prove(p, device=dev)) for p in polys],
           "sharded batch differs from the instances' own proves")
    return {"device": str(dev), "ml": ml.hex(), "gkr": gkr.hex(), "batch": [b.hex() for b in batch],
            "launches": launches, "collectives": comm.all_reduce_sum_.calls}


def main() -> int:
    """`dryrun_multichip(DRYRUN_DEVICES)` when the variable is set, then
    `entry()` on the card; prints what each gave."""
    n = int(os.environ.get("DRYRUN_DEVICES", "0"))
    if n:
        res = dryrun_multichip(n)
        print(f"dryrun_multichip({n}) OK: backend {res['backend']}, ranks on "
              f"{', '.join(r['device'] for r in res['ranks'])}")
    fn, args = entry()
    folded, sums = fn(*args)
    torch.cuda.synchronize()
    print(f"entry OK: folded tables {tuple(folded.shape)}, sums {sums.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
