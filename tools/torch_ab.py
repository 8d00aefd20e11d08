"""One checkout's CUDA kernels and ML prove on the card, for comparing two
commits of the PyTorch/CUDA port (`sumcheck_tpu_torch`) on one H100.

    python tools/torch_ab.py <checkout root> <label>

Imports the port from <checkout root>, builds its kernels there, and prints
one line: the generic chain's fold kernel (`round_cuda.round_fold`) at
every extent of the nv=20 2x3 prove (2^18 down to 1 lane) and their sum,
the round-0 kernel at 2^19 lanes, the MXU fold kernel
(`round_cuda.round_fold_mxu`) at the ML shape (U=6 d=3, extent 2^18) and
the GKR dim-18 shape (U=2 d=2, extent 2^16) beside `round_fold` at the GKR
shape (device times: the stream sleeps while the launches are enqueued),
the median of 15 warm `MLSumcheck.prove` walls on the bench's 2 products x
3 multiplicands at nv=20 on the generic chain and in the MXU fold mode,
and, from one profiled prove, the launches and device time of its round
kernels, its transcript steps and its other kernels (copies and fills).
Timing and the profiler's classes are this repo's `chip_smoke.py`
(`time_ms`, `device_busy`), whichever checkout is measured; they time and
profile through the measured checkout's `sumcheck_tpu_torch.microbench`
(`held_ms`, `profile_events`) and draw its tables with `limbs_np.
random_tables`, so that checkout must have both. Compare two commits in
one call, alternating them: parent, change, change, parent."""

import importlib.util
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[1]).resolve()
LABEL = sys.argv[2]
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
sys.path.insert(0, str(ROOT))

from sumcheck_tpu_torch import MLSumcheck  # noqa: E402  (from ROOT)
from sumcheck_tpu_torch.convert import polynomial_from_numpy  # noqa: E402
from sumcheck_tpu_torch.fields import limbs_np as L  # noqa: E402
from sumcheck_tpu_torch.ops import round_cuda as rc  # noqa: E402
from sumcheck_tpu_torch.utils.config import get_config  # noqa: E402


def main() -> None:
    assert Path(rc.__file__).resolve().is_relative_to(ROOT), rc.__file__
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    half = 1 << 19
    stacked = np.stack(L.random_tables(rng, 20, 6)).astype(np.int32)
    lo = torch.from_numpy(np.ascontiguousarray(stacked[:, :, :half])).to(dev)
    hi = torch.from_numpy(np.ascontiguousarray(stacked[:, :, half:])).to(dev)
    products = ((0, 1, 2), (3, 4, 5))
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32)).to(dev)

    def device_ms(fn):
        return smoke.time_ms(fn, smoke.KERNEL_REPS, dev, device_only=True)

    fold = [device_ms(lambda a2=1 << k: rc.round_fold(lo, hi, r, products, 3, a2))
            for k in range(18, -1, -1)]
    nofold = device_ms(lambda: rc.round_nofold(lo, hi, products, 3, half))
    mxu_ml = device_ms(lambda: rc.round_fold_mxu(lo, hi, r, products, 3, 1 << 18))
    glo, ghi = lo[:2, :, :1 << 17].contiguous(), hi[:2, :, :1 << 17].contiguous()
    mxu_gkr = device_ms(lambda: rc.round_fold_mxu(glo, ghi, r, ((0, 1),), 2, 1 << 16))
    cios_gkr = device_ms(lambda: rc.round_fold(glo, ghi, r, ((0, 1),), 2, 1 << 16))

    prng = np.random.default_rng(0)  # the bench's 2 x 3 instance at nv=20
    tabs, prods = [], []
    for _ in range(2):
        idx = []
        for t in L.random_tables(prng, 20, 3):
            tabs.append(t)
            idx.append(len(tabs) - 1)
        prods.append((int(prng.integers(1, 1 << 62)), idx))
    poly = polynomial_from_numpy(20, tabs, prods)

    def median_wall():
        MLSumcheck.prove(poly, device=dev)
        walls = []
        for _ in range(15):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            MLSumcheck.prove(poly, device=dev)
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    prove_s = median_wall()
    busy = smoke.device_busy(lambda: MLSumcheck.prove(poly, device=dev))
    cfg = get_config()
    saved = cfg.mxu_fold, cfg.ab
    cfg.mxu_fold, cfg.ab = "kernel", True
    mxu_prove_s = median_wall()
    cfg.mxu_fold, cfg.ab = saved
    count, ms = busy["kernels"], busy["device_ms"]
    print(f"AB {LABEL}: fold 2^18 {fold[0]:.4f} ms, 2^17 {fold[1]:.4f}, 2^16 {fold[2]:.4f}, "
          f"2^15 {fold[3]:.4f}, 2^10 {fold[8]:.4f}, 2^0 {fold[18]:.4f}; sum of 19 folds "
          f"{sum(fold):.4f} ms; nofold 2^19 {nofold:.4f} ms; MXU fold ML 2^18 {mxu_ml:.4f} ms, "
          f"GKR 2^16 {mxu_gkr:.4f} ms (round_fold {cios_gkr:.4f}); ML prove median of 15 "
          f"{prove_s:.4f} s, MXU mode {mxu_prove_s:.4f} s; profiled prove: "
          f"{count['round']} round kernels {ms['round']:.4f} ms, {count['transcript']} transcript "
          f"steps {ms['transcript']:.4f} ms, {count['other']} other kernels {ms['other']:.4f} ms "
          f"with the copies")


if __name__ == "__main__":
    main()
