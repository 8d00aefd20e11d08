"""The round kernels' wide route (`csrc/round.cu` `wide_kernel`, the
evaluation `wide_block_sums` of `csrc/round_common.cuh`) beside the design
choices it did not take, on one H100.

    python tools/wide_variants.py [--reps N] [--set chunks|build]

Each variant is the committed source with its choices changed by text
substitution, built with `nvcc` into `sumcheck_tpu_torch/build/variants/`
and loaded in place of the committed library (`round_cuda._library`).
A variant's name joins its choices:

  the chunks of points T a degree takes (the evaluation holds a product's
  values at T points in registers)
    t4_8_10_12 the smallest of 4, 8, 10 and 12 that holds the d + 1
               points, 12 past it (committed)
    t4_8_12    the same without 10
    t8, t12    8, or 12, at every degree
  the registers a thread may take
    free       as many as the kernel needs (`__launch_bounds__(128)`,
               committed)
    lb         at most 128 for T <= 8 and 168 above (four and three blocks
               an SM: `__launch_bounds__(128, 4 or 3)`)
  the next factor's loads
    pf         loading while this factor multiplies (`TableFactors`,
               committed)
    nopf       loaded when the factor is taken
  the extension of a product by one point before its next factor
    gen        `extend_to`, one body for any K, its unrolled passes
               guarded by K (committed: the guards compile to uniform
               branches)
    exact      a body for each K (`extend_one<K>`), K from the factor index
  where a fold's folded values come from for the evaluation
    (no suffix) re-read from the written tables, once a chunk (committed)
    ladder     each lane's folded (E, O - E) also kept in a dynamic shared
               memory ladder, [slot][E|step][limb][thread], which the
               evaluation reads
    ladder64   the same with 64-thread blocks (`kThreads`)
  the fold's loads
    (no suffix) the next slot's four stripes loading while this one folds
               (committed)
    foldnopf   each slot's stripes loaded when it is folded

At fault F4's shapes (`chip_smoke.f4_poly`, the pair by `init_pair`): round
0 and the in-place fold of (a) at nv=20 and of (b) and (c) at nv=18, and
(b)'s round 0 at nv=20. Each variant's sums and folded tables are checked
array-equal to the committed library's (which `chip_smoke.py` holds to the
plain versions), then the shapes are timed (`chip_smoke.time_ms`, device
time, `--reps` launches), the variants in turns, forward then backward,
and the mean of the two turns printed. One JSON line, with the card's name
and power limit, each variant's ptxas registers and spills, and the SASS
of its round-0 kernel at the chunk of degree 9: instructions, predicated
ones and branches (`cuobjdump`)."""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from sumcheck_tpu_torch.fields import limbs_np as L  # noqa: E402
from sumcheck_tpu_torch.ops import cuda_build  # noqa: E402
from sumcheck_tpu_torch.ops import round_cuda as RC  # noqa: E402
from sumcheck_tpu_torch.protocol.device_prover import init_pair  # noqa: E402

COMMON = cuda_build.CSRC / "round_common.cuh"
WIDE_POINTS = """  return degree < 4 ? 4 : degree < 8 ? 8 : degree < 10 ? 10 : kMaxWidePoints;"""
LAUNCH_NOFOLD = "launch_wide<false, 4, 8, 10, kMaxWidePoints>"
LAUNCH_FOLD = "launch_wide<true, 4, 8, 10, kMaxWidePoints>"
T_SUBS = {  # (round_common.cuh, round.cu)
    "t4_8_10_12": ([], []),
    "t4_8_12": ([(WIDE_POINTS, "  return degree < 4 ? 4 : degree < 8 ? 8 : kMaxWidePoints;")],
                [(LAUNCH_NOFOLD, "launch_wide<false, 4, 8, kMaxWidePoints>"),
                 (LAUNCH_FOLD, "launch_wide<true, 4, 8, kMaxWidePoints>")]),
    "t8": ([(WIDE_POINTS, "  return 8;")], []),
    "t12": ([(WIDE_POINTS, "  return 12;")], []),
}
LB_SUBS = {
    "free": ([], []),
    "lb": ([], [("template <bool kFold, int kT>\n__global__ void __launch_bounds__(kThreads)\n",
                 "template <bool kFold, int kT>\n"
                 "__global__ void __launch_bounds__(kThreads, kT <= 8 ? 4 : 3)\n")]),
}
PF_SUBS = {
    "pf": ([], []),
    "nopf": ([("""    if (active) fetch(0, 0);
  }""", """  }"""), ("""#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      v[j] = ne[j];
      step[j] = no[j];
    }
    if (l + 1 < __ldg(len + p)) {
      fetch(p, l + 1);
    } else if (p + 1 < products) {
      fetch(p + 1, 0);
    } else if (again) {
      fetch(0, 0);
    }
    sub_mod(step, step, v, f);""", """    fetch(p, l);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      v[j] = ne[j];
      step[j] = no[j];
    }
    sub_mod(step, step, v, f);""")], []),
}
EXTEND_ONE = """// acc[0..K] of a degree-K polynomial -> acc[K + 1], in place, for a K
// known at compile time.
template <int K>
__device__ __forceinline__ void extend_one_k(uint32_t (*acc)[kLimbs], const Field& f) {
#pragma unroll
  for (int j = 1; j <= K; ++j)
#pragma unroll
    for (int i = K; i >= j; --i) sub_mod(acc[i], acc[i], acc[i - 1], f);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) acc[K + 1][j] = 0;
#pragma unroll
  for (int j = K + 1; j >= 1; --j)
#pragma unroll
    for (int i = j; i <= K + 1; ++i) add_mod(acc[i], acc[i], acc[i - 1], f);
}

// extend_one_k<K> for the run-time k, K <= k < kT - 1
template <int K, int kT>
__device__ __forceinline__ void extend_one(int k, uint32_t (*acc)[kLimbs], const Field& f) {
  if constexpr (K + 1 < kT) {
    if (k == K) {
      extend_one_k<K>(acc, f);
    } else {
      extend_one<K + 1, kT>(k, acc, f);
    }
  }
}

"""
EXT_SUBS = {
    "gen": ([], []),
    "exact": ([("// The wide route's evaluation (round.cu's wide_kernel",
                EXTEND_ONE + "// The wide route's evaluation (round.cu's wide_kernel"),
               ("          if (l > 0 && need > known) extend_to<kT>(acc, known, need, f);",
                "          if (l > 0 && need > known) {\n"
                "            if (l < L) {\n"
                "              extend_one<1, kT>(known, acc, f);\n"
                "            } else {\n"
                "              extend_to<kT>(acc, known, need, f);\n"
                "            }\n"
                "          }")], []),
}
LADDER_FACTORS = """// This variant's factors from the folded values' ladder in shared memory.
struct LadderFactors {
  uint32_t* ladder;
  const int* idx;
  int factors, tid;
  __device__ __forceinline__ void operator()(int p, int l, uint32_t (&v)[kLimbs],
                                             uint32_t (&step)[kLimbs]) {
    const int s = __ldg(idx + p * factors + l);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      v[j] = ladder_at(ladder, s, 0, j, tid);
      step[j] = ladder_at(ladder, s, 1, j, tid);
    }
  }
};

"""
LADDER = [
    # round.cu: the ladder behind the totals, filled by the fold, read by
    # the evaluation of a fold round
    ("template <bool kFold, int kT>\n__global__", LADDER_FACTORS
     + "template <bool kFold, int kT>\n__global__"),
    ("""        store_lane(w_hi + u * out_stride + k, e_H, o);
""", """        store_lane(w_hi + u * out_stride + k, e_H, o);
        ladder_put(totals + kT * kLimbs * kThreads, u, e, o, f, tid);
"""),
    ("""  wide_block_sums<kT>(active, pl, coeff_digits, f, totals, warp_sums, sums,
                      TableFactors(e_lo, e_hi, e_H, k, pl, pl.degree >= kT, active, f));""",
     """  if constexpr (kFold) {
    wide_block_sums<kT>(active, pl, coeff_digits, f, totals, warp_sums, sums,
                        LadderFactors{totals + kT * kLimbs * kThreads, pl.idx, pl.factors, tid});
  } else {
    wide_block_sums<kT>(active, pl, coeff_digits, f, totals, warp_sums, sums,
                        TableFactors(e_lo, e_hi, e_H, k, pl, pl.degree >= kT, active, f));
  }"""),
    ("  const size_t smem = wide_total_bytes(kT);\n",
     "  const size_t smem = wide_total_bytes(kT) + (kFold ? ladder_bytes(pl.slots) : 0);\n"),
]
FOLD_SUBS = {
    "": ([], []),
    "ladder": ([], LADDER),
    "ladder64": ([("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")], LADDER),
}
FOLD_LOAD_SUBS = {
    "": ([], []),
    "foldnopf": ([], [("""      uint32_t next[4][kLimbs];
      load_stripes(next, lo, hi, k, extent, H);
""", ""), ("""#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) x[s][j] = next[s][j];
        if (u + 1 < pl.slots) load_stripes(next, lo, hi, (u + 1) * slot_stride + k, extent, H);
""", """        load_stripes(x, lo, hi, u * slot_stride + k, extent, H);
""")]),
}
CHOICES = (T_SUBS, LB_SUBS, PF_SUBS, EXT_SUBS, FOLD_SUBS, FOLD_LOAD_SUBS)
SETS = {
    # the committed build first
    "build": ["t4_8_10_12_free_pf_gen", "t4_8_12_free_pf_gen", "t4_8_10_12_lb_pf_gen",
              "t4_8_10_12_free_nopf_gen", "t4_8_10_12_lb_nopf_gen", "t4_8_10_12_free_pf_exact",
              "t4_8_10_12_lb_pf_exact", "t4_8_10_12_lb_nopf_exact"],
    "chunks": ["t4_8_10_12_free_pf_gen", "t8_free_pf_gen", "t12_free_pf_gen",
               "t4_8_12_free_pf_gen", "t4_8_10_12_free_pf_gen_ladder",
               "t4_8_10_12_free_pf_gen_ladder64", "t4_8_10_12_free_pf_gen_foldnopf"],
}
SHAPES = (("a", 20, True), ("b", 20, False), ("b", 18, True), ("c", 18, True))


def parse(name: str) -> list:
    """A variant's substitutions, (round_common.cuh, round.cu), one choice
    of each of `CHOICES` in turn."""
    rest, subs = name, []
    for choice in CHOICES:
        key = max((k for k in choice if k and (rest == k or rest.startswith(k + "_"))),
                  key=len, default="")
        if key == "" and "" not in choice:
            raise ValueError(f"variant {name}: no choice at {rest!r}")
        subs.append(choice[key])
        rest = rest[len(key) + 1:] if key else rest
    if rest:
        raise ValueError(f"variant {name}: {rest!r} left over")
    return [sum((c[0] for c in subs), []), sum((c[1] for c in subs), [])]


def _sub(text: str, subs: list, name: str) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(names: list) -> tuple[dict, dict]:
    """({variant: library path}, {variant: ptxas of its wide kernels}), one
    nvcc each, all at once, each in a directory of its own with its copy of
    the headers."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    procs, libs = {}, {}
    for name in names:
        common_subs, round_subs = parse(name)
        d = out_dir / f"wide_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for h in cuda_build.CSRC.glob("*.cuh"):
            text = h.read_text()
            if h == COMMON:
                text = _sub(text, common_subs, name)
            (d / h.name).write_text(text)
        cu = d / "round.cu"
        cu.write_text(_sub(RC.SOURCE.read_text(), round_subs, name))
        libs[name] = d / "round.so"
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(d),
             "-o", str(libs[name]), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ptxas = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        ptxas[name] = {}
        for m in re.finditer(r"Compiling entry function '(\w*wide_kernel\w*)'.*?"
                             r"(\d+) bytes stack frame, (\d+) bytes spill stores.*?"
                             r"Used (\d+) registers", err, re.S):
            ptxas[name][C.short_name(m.group(1))] = {
                "registers": int(m.group(4)), "stack": int(m.group(2)),
                "spill_stores": int(m.group(3))}
    return libs, ptxas


def sass_stats(lib: Path, kernel: str) -> dict:
    """Instructions, predicated instructions and branches of the functions
    of `lib` whose names hold `kernel` (`cuobjdump -sass`), or {}."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return {}
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True).stdout
    stats, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = C.short_name(m.group(1)) if kernel in m.group(1) else None
            if cur:
                stats[cur] = {"instructions": 0, "predicated": 0, "branches": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T\d]\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur and m:
            stats[cur]["instructions"] += 1
            stats[cur]["predicated"] += bool(m.group(1))
            stats[cur]["branches"] += m.group(2).startswith("BRA")
    return stats


def use(lib: Path) -> None:
    """Point the round wrappers at `lib`."""
    ctypes.CDLL(str(lib))
    RC.build = lambda: lib
    RC._library.cache_clear()


def run_shapes(dev, r) -> dict:
    """{shape: (sums, folded pair or None)} of the loaded library at every
    shape, for the equality check."""
    out = {}
    for name, nv, fold in SHAPES:
        lo, hi, products, degree = init_pair(C.f4_poly(name, 0, nv), dev)
        h = lo.shape[2]
        out[f"({name}) nv={nv} round 0"] = (RC.round_nofold(lo, hi, products, degree, h), None)
        if fold:
            s = RC.round_fold(lo, hi, r, products, degree, h // 2)
            out[f"({name}) nv={nv} fold"] = (s, (lo[:, :, :h // 2].clone(),
                                                 hi[:, :, :h // 2].clone()))
        del lo, hi
    torch.cuda.synchronize()
    return out


def time_shapes(dev, r, reps: int) -> dict:
    out = {}
    for name, nv, fold in SHAPES:
        lo, hi, products, degree = init_pair(C.f4_poly(name, 0, nv), dev)
        h = lo.shape[2]
        out[f"({name}) nv={nv} round 0"] = C.time_ms(
            lambda: RC.round_nofold(lo, hi, products, degree, h), reps, dev, device_only=True)
        if fold:
            out[f"({name}) nv={nv} fold"] = C.time_ms(
                lambda: RC.round_fold(lo, hi, r, products, degree, h // 2), reps, dev,
                device_only=True)
        del lo, hi
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--set", choices=sorted(SETS), default="chunks")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    committed = cuda_build.build("round")["round"]
    variants = SETS[args.set]
    libs, ptxas = build_variants(variants)
    sass = {name: sass_stats(libs[name], "wide_kernelILb0E") for name in variants}
    r = torch.from_numpy(L.mont_scalar(987654321)[:, 0].astype(np.int32)).to(dev)
    use(committed)
    want = run_shapes(dev, r)
    for name in variants:
        use(libs[name])
        got = run_shapes(dev, r)
        for shape, (sums, pair) in got.items():
            ok = torch.equal(sums, want[shape][0]) and (
                pair is None or all(torch.equal(a, b) for a, b in zip(pair, want[shape][1])))
            C.check(ok, f"variant {name} at {shape} differs from the committed kernels")
    print("every variant equal to the committed kernels at every shape")
    times = {name: [] for name in variants}
    for order in (variants, variants[::-1]):
        for name in order:
            use(libs[name])
            times[name].append(time_shapes(dev, r, args.reps))
    mean = {name: {shape: sum(t[shape] for t in ts) / len(ts) for shape in ts[0]}
            for name, ts in times.items()}
    for name in variants:
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in mean[name].items())
              + f"; ptxas {ptxas[name]}; SASS {sass[name]}")
    print(json.dumps({"card": C.card_line(), "ms": mean, "turns": times, "ptxas": ptxas,
                      "sass": sass}))


if __name__ == "__main__":
    main()
