"""One checkout's GKR phase inits inside the generic GKR prove on the card,
for comparing two commits of the PyTorch/CUDA port (`sumcheck_tpu_torch`)
on one H100.

    python tools/gkr_init_ab.py <checkout root> <label> [--reps N] [--profiles N]
    python tools/gkr_init_ab.py <checkout root> <label> --batch [--reps N]

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
alternating them: parent, change, change, parent.

With `--batch`, on `chip_smoke.py`'s GKR batch (8 x dim 14,
`bench.py:313-338`, both checkouts' `gkr_batch_instances`): the device time
of the batched phase 1 and phase 2 inits (`gkr_init.phase1_pairs`,
`phase2_pairs`: one launch a phase), each call after an L2 flush
(`chip_smoke.held_flushed_ms`, `--reps` calls), on the batch and on the
batch with its first instance skewed (`chip_smoke.skewed_instance`: one
segment of 2^16 + 1 entries cut across blocks), both checked equal to the
plain version; then the median of `--reps` warm
`BatchedGKRRoundSumcheck.prove` walls and the proofs' hash. One JSON
line."""

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
    ap.add_argument("--batch", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if args.batch:
        batch_mode(root, args.label, args.reps)
        return
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


def batch_mode(root: Path, label: str, reps: int) -> None:
    import random

    import numpy as np

    import chip_smoke as C
    from sumcheck_tpu_torch import Blake2b512Rng, Fr
    from sumcheck_tpu_torch import gkr_round_sumcheck as G
    from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck
    from sumcheck_tpu_torch.fields.fr import P
    from sumcheck_tpu_torch.ops import cuda_build
    from sumcheck_tpu_torch.ops import gkr_init as GI
    from sumcheck_tpu_torch.ops import gkr_init_cuda as GK

    assert Path(C.__file__).resolve().is_relative_to(root), C.__file__
    dev = torch.device("cuda", 0)
    cuda_build.build("round", "transcript", "gkr_init")
    seed, batch, dim = 0, C.BATCH, C.GKR_BATCH_DIM
    insts = C.gkr_batch_instances(seed, dim, batch)
    out = {"label": label, "card": C.card_line(), "batch": batch, "dim": dim}
    for name, chosen in (("", insts), ("skewed_", [C.skewed_instance(insts[0], seed)]
                                        + insts[1:])):
        inputs = [G._upload(f1, f2, f3, g, dim, dev) for f1, f2, f3, g in chosen]
        splits, f2s, f3s, g_rs = zip(*inputs)
        rnd = random.Random(seed + dim)
        u = torch.from_numpy(np.stack([GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)])
                                       for _ in range(batch)], axis=1)).to(dev)
        shape = (batch, 2, 8, 1 << (dim - 1))
        lo, hi, lo2, hi2 = (torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(4))

        def phase1():
            return GI.phase1_pairs(splits, g_rs, f3s, f2s, dim, lo, hi)

        ws = phase1()

        def phase2():
            GI.phase2_pairs(lo[:, :, :, :1], hi[:, :, :, :1], u[dim - 1], splits, ws, u, f3s,
                            dim, lo2, hi2)

        phase2()
        plo, phi, plo2, phi2 = (torch.empty_like(lo) for _ in range(4))
        pws = GK.weight_reduce_batched_ref([
            GK.Instance(s.gbits, s.vals, g, s.last_x, s.plan_x, (plo[b], phi[b]), f3=f3,
                        y=s.y_rev, to_y=s.to_y, slot=(f2, None))
            for b, (s, f2, f3, g) in enumerate(inputs)], dim)
        GK.weight_reduce_batched_ref([
            GK.Instance(s.x_y, pws[b], u[:, b], s.last_y, s.plan_y, (plo2[b], phi2[b]),
                        slot=(f3, (plo[b, :, :, :1], phi[b, :, :, :1], u[dim - 1, b], 1)))
            for b, (s, f3) in enumerate(zip(splits, f3s))], dim)
        torch.cuda.synchronize()
        C.check(all(torch.equal(a, b) for a, b in zip((lo, hi, lo2, hi2, *ws),
                                                      (plo, phi, plo2, phi2, *pws))),
                f"{label} {name}batch: the phase inits differ from the plain version")
        out[f"{name}phase1_ms"] = C.held_flushed_ms(phase1, dev, reps)
        out[f"{name}phase2_ms"] = C.held_flushed_ms(phase2, dev, reps)
    args = [list(t) for t in zip(*insts)]

    def prove():
        return BatchedGKRRoundSumcheck.prove([Blake2b512Rng.setup() for _ in range(batch)],
                                             *args, device=dev)

    blob = b"".join(p.serialize_uncompressed() for p in prove())
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove()
        walls.append(time.perf_counter() - t0)
    out.update(prove_s=statistics.median(walls), walls=[round(w, 5) for w in walls],
               proof_sha=hashlib.sha256(blob).hexdigest()[:16])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
