"""The correctness check's control: the plain reference put in the
program's place, with the reduction a later change might drop (its
`lazy` field: no final subtraction of p, 256 bits kept), judged by the
same check against the exact reference.

    python3 portbench/control.py --workload <cell> --seeds 5 6 7 [--calls 300]

For each seed it makes the cell's pool at the cell's own size, draws the
sample a run of `--calls` calls would check (`check.Sample`), proves
each sampled instance with the lazy reference and with the exact one, and
prints the check's numbers, one JSON line a seed. A sound control reads
every count above its limit of 0. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_counts(spec: dict, seed: int, calls: int, device) -> dict:
    """The check's counts for the lazy reference in the program's place."""
    from portbench.check import Sample, compare, reference_outputs, verdict
    from portbench.inputs import make_pool

    config, batch = spec["config"], spec["mix"]["batch"]
    pool = make_pool(config, batch, seed, device)
    sample = Sample(batch, seed)
    for c in range(calls):
        for b in range(batch):
            sample.offer((c, b), None)
    keys = [k for k, _v in sample.items]
    lazy = reference_outputs(config, batch, seed, pool, keys, device, lazy=True)
    exact = reference_outputs(config, batch, seed, pool, keys, device)
    correct, numbers = verdict(compare(lazy, exact), len(keys))
    return {"seed": seed, "correct": correct, "checks": numbers}


def main(argv=None) -> int:
    from portbench.run import apply_environment, load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    apply_environment(spec["config"])
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_counts(spec, seed, args.calls, torch.device("cuda", 0))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
