"""The GKR inits' collective on the card, taken apart: S gloo ranks on one
card (and NCCL, one rank a card, where the machine has S cards) exchange
the raw segment sums of a dim-`dim` phase, (S, 8, 2^dim / S) int64 a rank.

    python tools/collective_probe.py [--dim 18] [--sizes 2,4] [--reps 5] [--out FILE]

For each S, one line a rank, median seconds of `reps` calls after one
warm-up, each between a barrier and a sync:

- `reduce_scatter_sum`: `comm.reduce_scatter_sum_` on the card, the inits'
  exchange (one reduce-scatter of the card's tensor itself);
- `all_reduce_cuda`: `comm.all_reduce_sum_` of the whole (8, 2^dim) sums
  on the card, the exchange the inits made before;
- `all_reduce_cpu`, `reduce_scatter_cpu`: the same sums on CPU tensors,
  all-reduced and reduce-scattered through `comm` (what gloo itself costs
  there).

Every exchange's result is checked equal to the all-reduced sums' block
for the rank. Needs a card; the last line is the JSON summary (also
written to FILE), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, reps: int, device, group) -> float:
    fn()
    walls = []
    for _ in range(reps):
        dist.barrier(group)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _rank(rank: int, size: int, backend: str, init_file: str, out_dir: str, dim: int,
          reps: int) -> None:
    from sumcheck_tpu_torch.parallel import comm

    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=size)
    group = dist.group.WORLD
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    try:
        n = 1 << dim
        gen = torch.Generator().manual_seed(1000 + rank)
        t_cpu = torch.randint(0, 1 << 40, (size, 8, n // size), dtype=torch.int64,
                              generator=gen)
        t_dev = t_cpu.to(device)
        whole = t_cpu.clone()
        dist.all_reduce(whole, group=group)
        want = whole[rank]
        res = {"bytes_a_rank": t_cpu.numel() * 8, "received_a_rank": want.numel() * 8}
        got = {}

        def reduce_scatter_sum():
            got["reduce_scatter_sum"] = comm.reduce_scatter_sum_(t_dev, group)

        def all_reduce_cuda():
            comm.all_reduce_sum_(t_dev.reshape(8, n).clone(), group)

        res["reduce_scatter_sum"] = _timed(reduce_scatter_sum, reps, device, group)
        res["all_reduce_cuda"] = _timed(all_reduce_cuda, reps, device, group)
        if backend == "gloo":
            def reduce_scatter_cpu():
                got["reduce_scatter_cpu"] = comm.reduce_scatter_sum_(t_cpu, group)

            res["all_reduce_cpu"] = _timed(lambda: comm.all_reduce_sum_(
                t_cpu.reshape(8, n).clone(), group), reps, device, group)
            res["reduce_scatter_cpu"] = _timed(reduce_scatter_cpu, reps, device, group)
        res["equal"] = {k: torch.equal(v.cpu(), want) for k, v in got.items()}
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=18)
    ap.add_argument("--sizes", default="2,4")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the JSON summary here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("collective_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    summary = {"card": card, "torch": torch.__version__, "dim": args.dim, "runs": {}}
    for size in (int(s) for s in args.sizes.split(",")):
        for backend in ("gloo", "nccl"):
            if backend == "nccl" and torch.cuda.device_count() < size:
                print(f"S={size} nccl: not run, {torch.cuda.device_count()} card(s) here and "
                      f"NCCL takes one card a rank")
                continue
            with tempfile.TemporaryDirectory() as tmp:
                mp.spawn(_rank, args=(size, backend, f"{tmp}/init", tmp, args.dim, args.reps),
                         nprocs=size)
                ranks = []
                for r in range(size):
                    with open(f"{tmp}/rank{r}.json") as f:
                        ranks.append(json.load(f))
            key = f"S={size} {backend}"
            summary["runs"][key] = ranks
            for r, res in enumerate(ranks):
                print(f"{key} rank {r}: {json.dumps(res)}")
            if not all(all(r["equal"].values()) for r in ranks):
                print(f"{key}: an exchange's sums differ from the all-reduced ones")
                return 1
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
