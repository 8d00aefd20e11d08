"""One checkout's GKR phase inits inside the generic GKR prove on the card,
for comparing two commits of the PyTorch/CUDA port (`sumcheck_tpu_torch`)
on one H100.

    python tools/gkr_init_ab.py <checkout root> <label> [--reps N] [--profiles N]

Imports the port from <checkout root>, builds its kernels there, and prints
one JSON line: on the bench's GKR dim-18 instance
(`microbench.gkr_instance(18)`, in both checkouts), the median of `--reps`
warm `GKRRoundSumcheck.prove` walls on the generic chain, and from
`--profiles` profiled warm proves (`microbench.profile_events`, in the
measured checkout) the median device time of the phase-init kernels, in
all and by launch in prove order (phase 1's, then phase 2's; each name cut
to its kernel), the prove's kernel launches and its idle share, beside the
card's name and power limit. The init kernels are matched by name, so
commits with different inits compare alike: the four-kernel inits
(`weight_fold_kernel`, `segment_reduce_kernel`), the three launches a
phase (`eq_halves_kernel`, `weight_reduce_kernel`, `pair_slots_kernel`)
and the one fused launch a phase (`weight_reduce_kernel`). Times inside
a prove, as the prove leaves the L2. Compare two commits in one call,
alternating them: parent, change, change, parent."""

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

INIT = ("eq_halves_kernel", "weight_fold_kernel", "segment_reduce_kernel",
        "weight_reduce_kernel", "finish_sums_kernel", "pair_slots_kernel")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("label")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--profiles", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from sumcheck_tpu_torch import Blake2b512Rng, GKRRoundSumcheck
    from sumcheck_tpu_torch import microbench as MB
    from sumcheck_tpu_torch.ops import cuda_build

    assert Path(MB.__file__).resolve().is_relative_to(root), MB.__file__
    dev = torch.device("cuda", 0)
    cuda_build.build("round", "transcript", "gkr_init")
    inst = MB.gkr_instance(18, 0)

    def prove():
        return GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device=dev)

    blob = prove().serialize_uncompressed()
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove()
        walls.append(time.perf_counter() - t0)
    inits, launches, idle = [], [], []
    for _ in range(args.profiles):
        prof = MB.profile_events(prove, prove)
        kernels = [(e - s, name) for s, e, name in prof["events"] if not MB.is_copy(name)]
        inits.append([(re.search(r"(\w+_kernel)", name).group(1), us) for us, name in kernels
                      if any(k in name for k in INIT)])
        launches.append(len(kernels))
        idle.append(1 - MB.busy_ms(prof["events"]) / 1e3 / prof["wall_s"])
    names = [n for n, _us in inits[0]]
    assert all([n for n, _us in run] == names for run in inits), inits
    by_launch = [statistics.median(run[i][1] for run in inits) for i in range(len(names))]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "label": args.label, "card": card, "prove_s": statistics.median(walls),
        "walls": [round(w, 5) for w in walls],
        "init_ms": statistics.median(sum(us for _n, us in run) for run in inits) / 1e3,
        "init_launches": [[n, round(us / 1e3, 5)] for n, us in zip(names, by_launch)],
        "kernels": statistics.median(launches), "idle_share": statistics.median(idle),
        "proof_sha": hashlib.sha256(blob).hexdigest()[:16]}))


if __name__ == "__main__":
    main()
