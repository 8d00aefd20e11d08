"""A sharded rank's dealt finish (`csrc/gkr_init.cu`, `finish_sums_kernel`
over the rank's run of rank-major raw sums) beside the designs it did not
take, on one H100.

    python tools/finish_variants.py [--reps N]

Each variant is the committed source with the finish kernel replaced by
text substitution, built with `nvcc` into
`sumcheck_tpu_torch/build/variants/` and loaded in place of the committed
library:

  committed   one thread a lane, each loading the final fold's operands
              beside its lane's and computing the fold itself (no shared
              memory, no barrier: 64 registers, four blocks an SM); the
              word above 2^256 multiplied only where it is not 0
              (`finish_lazy`)
  block_fold  the fold computed once a block: thread 0 issues its loads
              first and writes it to shared memory, the block waits at a
              barrier
  eager       the first run-based kernel: the block's fold by thread 0
              after its lane's loads, the high word always multiplied
              (`finish`)
  strided     the first dealt design: rank s reads segments i·S + s of the
              natural (not rank-major) sums and lanes i·S + s of the whole
              f2 / f3, every sector of both touched (one library for S = 2
              and one for S = 4)
  empty       the committed grid with an empty body: the launch and its
              flushed floor

On the bench's GKR dim-18 instance (`microbench.gkr_instance(18)`): the
raw sums of both phases (natural and rank-major, from the committed weight
reduce), then for S = 2 and 4 and both slot forms (phase 1: f2; phase 2:
f3 times the final fold of phase 1's one-lane pair), rank 1's finish on
every variant, checked array-equal to `finish_sums_ref` (but `empty`),
timed with the L2 flushed before each call (`chip_smoke.time_ms`, `--reps`
calls), the variants in turns, forward then backward, and the mean of the
two turns. One JSON line, with the card's name and power limit and each
variant's registers and spills."""

import argparse
import json
import random
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from sumcheck_tpu_torch import Fr  # noqa: E402
from sumcheck_tpu_torch import gkr_round_sumcheck as G  # noqa: E402
from sumcheck_tpu_torch import microbench as MB  # noqa: E402
from sumcheck_tpu_torch.fields.fr import P  # noqa: E402
from sumcheck_tpu_torch.ops import cuda_build  # noqa: E402
from sumcheck_tpu_torch.ops import gkr_init as GI  # noqa: E402
from sumcheck_tpu_torch.ops import gkr_init_cuda as GK  # noqa: E402
from sumcheck_tpu_torch.parallel.mesh import deal  # noqa: E402

HEAD = "__global__ void __launch_bounds__(kThreads)\n    finish_sums_kernel("
BODY_START = "  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;\n"
TAIL = "\n// ---------------------------------------------------------------------------\n// the pair's slots"

EAGER = """  __shared__ uint32_t s_scale[kLimbs];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.lanes;
  uint64_t acc[kLimbs];
  uint32_t v[kLimbs];
  if (live) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) acc[j] = p.sums[j * p.sums_ld + i];
    if (p.src) load_lane(v, p.src + i, p.lanes);
  }
  if (p.flo) {
    if (threadIdx.x == 0) {
      uint32_t f[kLimbs];
      final_fold(f, p.flo, p.fhi, p.fstride, p.fr, c);
      copy8(s_scale, f);
    }
    __syncthreads();
  }
  if (!live) return;
  uint32_t x[kLimbs];
  finish(x, acc, c);
  const bool low = i < dst.split;
  store_lane(low ? dst.lo + i : dst.hi + (i - dst.split), dst.ld, x);
  if (p.src) {
    if (p.flo) mont_mul(v, v, s_scale, c.f);
    store_lane(low ? p.lo + i : p.hi + (i - dst.split), dst.ld, v);
  }
}
"""

BLOCK_FOLD = """  __shared__ uint32_t s_scale[kLimbs];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < p.lanes, folds = p.flo && threadIdx.x == 0;
  uint32_t fl[kLimbs], fh[kLimbs], fr[kLimbs];
  if (folds) {
    load_lane(fl, p.flo, p.fstride);
    load_lane(fh, p.fhi, p.fstride);
    load_digits(fr, reinterpret_cast<const uint32_t*>(p.fr));
  }
  uint64_t acc[kLimbs];
  uint32_t v[kLimbs];
  if (live) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) acc[j] = p.sums[j * p.sums_ld + i];
    if (p.src) load_lane(v, p.src + i, p.lanes);
  }
  if (p.flo) {
    if (folds) {
      sub_mod(fh, fh, fl, c.f);
      mont_mul(fh, fh, fr, c.f);
      add_mod(fl, fl, fh, c.f);
      copy8(s_scale, fl);
    }
    __syncthreads();
  }
  if (!live) return;
  uint32_t x[kLimbs];
  finish_lazy(x, acc, c);
  const bool low = i < dst.split;
  store_lane(low ? dst.lo + i : dst.hi + (i - dst.split), dst.ld, x);
  if (p.src) {
    if (p.flo) mont_mul(v, v, s_scale, c.f);
    store_lane(low ? p.lo + i : p.hi + (i - dst.split), dst.ld, v);
  }
}
"""

EMPTY = "}\n"


def committed_kernel(src: str) -> str:
    start = src.index(HEAD)
    return src[start:src.index(TAIL, start)]


def variant_source(src: str, name: str) -> str:
    """The committed source with the finish kernel of variant `name`."""
    kernel = committed_kernel(src)
    body = kernel[kernel.index(BODY_START):]
    stride = 1
    if name.startswith("strided"):
        stride = int(name[len("strided"):])
        new = kernel.replace("p.sums[j * p.sums_ld + i]", "p.sums[j * p.sums_ld + i * kStride]")
        new = new.replace("load_lane(v, p.src + i, p.lanes)",
                          "load_lane(v, p.src + i * kStride, p.lanes * kStride)")
        if new.count("kStride") != 3:
            raise RuntimeError("the committed finish kernel no longer reads as the tool expects")
    elif name in ("block_fold", "eager", "empty"):
        new = kernel.replace(body, {"block_fold": BLOCK_FOLD, "eager": EAGER, "empty": EMPTY}[name]
                             + "\n")
    else:
        new = kernel
    prefix = f"constexpr long long kStride = {stride};\n"
    return src.replace(kernel, prefix + new)


def build_variants(names) -> tuple:
    """({name: library path}, {name: the finish kernel's registers}), one
    nvcc each, all at once."""
    src = GK.SOURCE.read_text()
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for name in names:
        cu = out_dir / f"gkr_init_finish_{name}.cu"
        cu.write_text(variant_source(src, name))
        libs[name] = out_dir / f"gkr_init_finish_{name}.so"
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(cuda_build.CSRC), "-o",
             str(libs[name]), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    regs = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        regs[name] = finish_resources(err)
    return libs, regs


def finish_resources(log: str) -> dict:
    """The finish kernel's registers and spill bytes from a ptxas log."""
    out, cur = {}, ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = m.group(1)
        elif "finish_sums_kernel" in cur:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m.group(1))
    return out


def use(lib: Path) -> None:
    """Point the wrappers at `lib`."""
    GK.build = lambda: lib
    GK._library.cache_clear()


def strided_finish(sums, dst, slot, s: int, size: int) -> None:
    """The first dealt design on a `strided` library: rank s's lanes read
    from the natural sums and the whole table, lane i at i·S + s."""
    lo, hi = dst
    table, fold = slot
    flo, fhi, fr, fslot = fold if fold is not None else (None, None, None, 0)
    nseg = sums.shape[1]
    half = lo.shape[2]
    GK._run("finish_sums", lambda lib, st: lib.sc_gkr_finish_sums(
        sums.data_ptr() + 8 * s, nseg, nseg // size, lo.data_ptr(), hi.data_ptr(), half, half,
        table.data_ptr() + 4 * s, lo[1].data_ptr(), hi[1].data_ptr(),
        None if flo is None else flo[fslot].data_ptr(),
        None if fhi is None else fhi[fslot].data_ptr(), 0 if flo is None else flo.stride(1),
        GK._ptr(fr), GK._CONSTS, st), sums.device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cuda_build.build("gkr_init")
    committed = GK.build()
    names = ["committed", "block_fold", "eager", "strided2", "strided4", "empty"]
    libs, regs = build_variants(names)
    dim = 18
    f1, f2, f3, g = MB.gkr_instance(dim, 0)
    split, f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, dim, dev)
    rnd = random.Random(dim)
    u_r = GI.upload(GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)]), dev)
    n, half = 1 << dim, 1 << (dim - 1)
    lo1, hi1, w = GI.phase1_pair(split, g_r, f3_d, f2_d, dim)
    fold = (lo1[:, :, :1], hi1[:, :, :1], u_r[dim - 1], 1)
    p1 = (split.gbits, split.vals, g_r, dim, split.last_x, split.plan_x)
    kw1 = {"f3": f3_d, "y": split.y_rev, "to_y": split.to_y}
    p2 = (split.x_y, w, u_r, dim, split.last_y, split.plan_y)
    sums = {}
    for ranks in (1, 2, 4):
        raw = [torch.empty((ranks, 8, n // ranks), dtype=torch.int64, device=dev)
               for _ in range(2)]
        GK.weight_reduce(*p1, raw[0], ranks=ranks, **kw1)
        GK.weight_reduce(*p2, raw[1], ranks=ranks)
        sums[ranks] = raw
    cases = {}
    for size in (2, 4):
        mine = [deal(t, 1, size).contiguous() for t in (f2_d, f3_d)]
        for phase in (1, 2):
            slot = (mine[phase - 1], None if phase == 1 else fold)
            want = tuple(torch.empty((2, 8, half // size), dtype=torch.int32, device=dev)
                         for _ in range(2))
            GK.finish_sums_ref(sums[size][phase - 1][1], want, slot=slot)
            whole = (f2_d, f3_d)[phase - 1], None if phase == 1 else fold
            cases[f"S{size} phase {phase}"] = (size, sums[size][phase - 1][1],
                                               sums[1][phase - 1][0], slot, whole, want)
    results = {name: {case: [] for case in cases} for name in names}
    errors = {}
    for turn in (names, names[::-1]):
        for name in turn:
            use(libs[name])
            for case, (size, run_sums, natural, slot, whole, want) in cases.items():
                out = tuple(torch.zeros_like(t) for t in want)
                if name.startswith("strided"):
                    if int(name[len("strided"):]) != size:
                        continue

                    def fn(out=out, natural=natural, whole=whole, size=size):
                        strided_finish(natural, out, whole, 1, size)
                else:
                    def fn(out=out, run_sums=run_sums, slot=slot):
                        GK.finish_sums(run_sums, out, slot=slot)
                fn()
                torch.cuda.synchronize()
                if name != "empty":
                    errors[(name, case)] = max(C.max_diff(a, b) for a, b in zip(out, want))
                results[name][case].append(C.time_ms(fn, args.reps, dev, device_only=True,
                                                     cold_l2=True))
    use(committed)
    bad = {f"{k[0]} {k[1]}": v for k, v in errors.items() if v}
    if bad:
        raise SystemExit(f"variants differ from the plain version: {bad}")
    means = {name: {case: sum(ts) / len(ts) for case, ts in by.items() if ts}
             for name, by in results.items()}
    print(json.dumps({"card": C.card_line(), "dim": dim, "reps": args.reps, "registers": regs,
                      "ms": means, "turns": results}))


if __name__ == "__main__":
    main()
