"""The fused GKR phase init (`csrc/gkr_init.cu`, `weight_reduce_kernel`: one
launch a phase) beside the design choices it did not take, on one H100.

    python tools/gkr_init_variants.py [--reps N] [--profiles N]

Each variant is the committed source with its choices changed by text
substitution, built with `nvcc` into `sumcheck_tpu_torch/build/variants/`
and loaded in place of the committed library. Two choices, each variant
one of each:

  where eq's half tables come from
    blocks       each block builds both halves in its shared memory by
                 doubling (the committed build)
    cooperative  a cooperative launch (`cudaLaunchCooperativeKernel`): the
                 blocks write disjoint lanes of the halves to global memory,
                 one lane a thread as a product over its variables, then
                 `grid.sync()`, then each stages them
    separate     `eq_halves_kernel` (this tool's copy of the half tables'
                 kernel before they were built in the blocks: one lane a
                 thread as a product) in a launch of its own before the
                 reduce, whose blocks stage its tables
  (both read the half tables through a pointer that this tool's entry
  `sc_variant_set_eq` hands the next launch, `GLOBAL_EQ`)
  where the slot's items go
    beside       beside the build: half the block's warps build the half
                 tables while the other half move the block's slot items
                 (committed)
    after        in the work list (`plan_item`), after the plan's tiles
                 and chunks, the whole block building
    before       before them
    spread       evenly between them
  and two more of the committed build: `split_beside`, each half built
  as the tensor product of two smaller tables (over its first ceil(n/2)
  variables and the rest, each by doubling, then one multiply a lane), a
  depth of ceil(kl/2) + 1 in place of kl; and `tile1024_beside`, tiles of
  1,024 entries (a block of 1,024 threads, one an SM, so one build an SM).
  `separate` and `cooperative` take the work-list orders only: their
  blocks sync as a whole while they stage.

and `three_launches`: `eq_halves_kernel`, the reduce without the slot
and `pair_slots`, the three launches a phase before the fusion, on the
`separate` build. The parts, alone: the committed build's reduce without the slot
(`build_reduce`: the half tables built, slot 0 summed), the `separate`
build's reduce without the slot over tables made beforehand
(`staged_reduce`, the weight reduce before the fusion), `eq_halves` and
the slot by `pair_slots` (`slot`).

On the bench's GKR dim-18 instance (`microbench.gkr_instance(18)`): each
variant's phase-1 init (slot 1 = f2) and phase-2 init (slot 1 = f3 times
the final fold of phase 1's pair) checked array-equal to the plain
version, then timed with the L2 flushed before each call
(`chip_smoke.time_ms`, `--reps` calls), the variants in turns, forward
then backward, and the mean of the two turns; then, for each variant,
the device time of the two init calls inside `--profiles` profiled
generic GKR dim-18 proves (`microbench.profile_events`, median; the proof
bytes checked equal to the committed build's). One JSON line, with the
card's name and power limit."""

import argparse
import ctypes
import json
import random
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from sumcheck_tpu_torch import Blake2b512Rng, Fr, GKRRoundSumcheck  # noqa: E402
from sumcheck_tpu_torch import gkr_round_sumcheck as G  # noqa: E402
from sumcheck_tpu_torch import microbench as MB  # noqa: E402
from sumcheck_tpu_torch.fields.fr import P  # noqa: E402
from sumcheck_tpu_torch.ops import cuda_build  # noqa: E402
from sumcheck_tpu_torch.ops import gkr_init as GI  # noqa: E402
from sumcheck_tpu_torch.ops import gkr_init_cuda as GK  # noqa: E402

# the slot's items in the work list (`plan_item`): the whole block builds, and
# work item it is a plan item or a slot item
PLAN_ITEM = {
    "after": """  *which = it < items ? it : it - items;
  return it < items;""",
    "before": """  *which = it < slots ? it : it - slots;
  return it >= slots;""",
    # slot item s at floor((2 s + 1) T / (2 S)) of the T = items + S
    "spread": """  const long long total = (long long)items + slots, q = 2LL * slots * it;
  const int before = slots ? (int)(((q - 1) / total + 1) / 2) : 0;
  const bool slot = before < slots && (2LL * before + 1) * total / (2LL * slots) == it;
  *which = slot ? before : it - before;
  return !slot;""",
}
KERNEL_DOC = "// Each block builds the half tables once and walks the plan's\n"


def in_list(order: str) -> list:
    """The substitutions that put the slot's items into the work list."""
    return [
        (KERNEL_DOC, "__device__ __forceinline__ bool plan_item(int it, int items, int slots, "
                     "int* which) {\n" + PLAN_ITEM[order] + "\n}\n\n" + KERNEL_DOC),
        ("  const int table_threads = a.slot.items ? kTile / 2 : kTile;\n",
         "  const int table_threads = kTile;\n"),
        ("""  for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
    const int4 item = __ldg(a.plan + it);
""", """  for (int it = blockIdx.x; it < a.items + a.slot.items; it += gridDim.x) {
    int which;
    if (!plan_item(it, a.items, a.slot.items, &which)) {
      slot_item(a.slot, which, s_scale, c, t, kTile);
      continue;
    }
    const int4 item = __ldg(a.plan + which);
"""),
        ("  const unsigned grid = (unsigned)(items < most ? items : most);\n",
         "  const int work = items + a.slot.items;\n"
         "  const unsigned grid = (unsigned)(work < most ? work : most);\n"),
    ]


ORDERS = ("beside", "after", "before", "spread")
BUILD_CALL = ("    stage_rows(s_rows, a.r, a.r_stride, a.kl + a.kh, t, table_threads);\n"
              "    build_eq_halves(s_eq, s_rows, a.kl, a.kh, c, t, table_threads);\n")

# the half tables in global memory (separate, cooperative): a pointer that
# `sc_variant_set_eq` sets on the host before a launch, passed in the
# launch's arguments, and the kernel that writes the tables one lane a
# thread (`eq_halves_kernel`, launched by `sc_variant_eq_halves`)
EQ_HALVES_KERNEL = '''// eq[t] = prod_{i < kl} (bit_i(t) ? r_i : 1 - r_i) for t < 2^kl, and
// eq[2^kl + t] = prod_{i < kh} (bit_i(t) ? r_{kl+i} : 1 - r_{kl+i}) for
// t < 2^kh (the empty product is the Montgomery one). eq is (8, 2^kl + 2^kh).
__global__ void __launch_bounds__(kThreads)
    eq_halves_kernel(uint32_t* __restrict__ eq, int kl, int kh,
                     const int32_t* __restrict__ r, long long r_stride,
                     const __grid_constant__ Consts c) {
  const long long nlo = 1LL << kl, lanes = nlo + (1LL << kh);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= lanes) return;
  const bool low = t < nlo;
  const long long j = low ? t : t - nlo;
  const int first = low ? 0 : kl, count = low ? kl : kh;
  uint32_t acc[kLimbs];
  copy8(acc, c.one);
  for (int i = 0; i < count; ++i) {
    uint32_t ri[kLimbs], x[kLimbs];
    load_digits(ri, reinterpret_cast<const uint32_t*>(r + (first + i) * r_stride));
    if ((j >> i) & 1) {
      copy8(x, ri);
    } else {
      sub_mod(x, c.one, ri, c.f);  // 1 - r_i
    }
    if (i == 0) {
      copy8(acc, x);
    } else {
      mont_mul(acc, acc, x, c.f);
    }
  }
  store_lane(eq + t, lanes, acc);
}

'''
EQ_ENTRIES = '''
extern "C" {

int sc_variant_set_eq(const void* eq) {
  g_variant_eq = eq;
  return 0;
}

int sc_variant_eq_halves(void* eq, int kl, int kh, const void* r, long long r_stride,
                         const uint32_t* consts, void* stream) {
  const long long lanes = (1LL << kl) + (1LL << kh);
  eq_halves_kernel<<<grid_of(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(eq), kl, kh, static_cast<const int32_t*>(r), r_stride,
      make_consts(consts));
  return (int)cudaGetLastError();
}

}  // extern "C"
'''
R_FIELD = "  long long r_stride;            //   r + i * r_stride, from which each block builds eq\n"
GLOBAL_EQ = [
    ('#include "field.cuh"\n',
     '#include "field.cuh"\n\nstatic const void* g_variant_eq = nullptr;  // the next launch\'s\n'),
    (R_FIELD, R_FIELD + "  const uint32_t* eq;            // the half tables in global memory\n"),
    ("  a->r_stride = sh.r_stride;\n",
     "  a->r_stride = sh.r_stride;\n  a->eq = static_cast<const uint32_t*>(g_variant_eq);\n"),
    ("// ---------------------------------------------------------------------------\n"
     "// the fused weight fold and segment sum\n",
     EQ_HALVES_KERNEL + "// ---------------------------------------------------------------------------\n"
     "// the fused weight fold and segment sum\n"),
    ('}  // extern "C"\n', '}  // extern "C"\n' + EQ_ENTRIES),
]

# the blocks stage the half tables written before them (separate, cooperative)
STAGE = '''    const uint32_t* eq_in = a.eq;
    for (int i = threadIdx.x; i < lanes; i += kTile) {
      uint32_t v[kLimbs];
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) v[j] = __ldcg(eq_in + (long long)j * lanes + i);
      s_eq[2 * i] = make_uint4(v[0], v[1], v[2], v[3]);
      s_eq[2 * i + 1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
'''
EQ_LANES = "    const int lanes = nlo + (1 << a.kh);\n"
# the cooperative build: disjoint lanes, one a thread, then the grid's barrier
COOPERATIVE = EQ_LANES + '''    uint32_t* eq_out = const_cast<uint32_t*>(a.eq);
    for (long long g = (long long)blockIdx.x * kTile + threadIdx.x; g < lanes;
         g += (long long)gridDim.x * kTile) {
      const bool low = g < nlo;
      const long long j = low ? g : g - nlo;
      const int first = low ? 0 : a.kl, count = low ? a.kl : a.kh;
      uint32_t acc[kLimbs];
      copy8(acc, c.one);
      for (int i = 0; i < count; ++i) {
        uint32_t ri[kLimbs], x[kLimbs];
        load_digits(ri, reinterpret_cast<const uint32_t*>(a.r + (first + i) * a.r_stride));
        if ((j >> i) & 1) {
          copy8(x, ri);
        } else {
          sub_mod(x, c.one, ri, c.f);
        }
        if (i == 0) {
          copy8(acc, x);
        } else {
          mont_mul(acc, acc, x, c.f);
        }
      }
      store_lane(eq_out + g, lanes, acc);
    }
    __threadfence();
    cooperative_groups::this_grid().sync();
''' + STAGE
LAUNCHES = '''  if (gather) {
    weight_reduce_kernel<true><<<grid, kTile, smem, s>>>(a, c);
  } else {
    weight_reduce_kernel<false><<<grid, kTile, smem, s>>>(a, c);
  }
'''
COOPERATIVE_LAUNCH = '''  void* params[] = {&a, const_cast<Consts*>(&c)};
  const cudaError_t le = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kTile), params, smem, s);
  if (le != cudaSuccess) return (int)le;
'''

# each half as A (its first ceil(n/2) variables) x B (the rest): the four
# small tables by doubling in the stage area, then one product a lane
SPLIT = (
    "    build_eq_halves(s_eq, s_rows, a.kl, a.kh, c, t, table_threads);\n",
    EQ_LANES + """      {
        uint4* tabs = s_stage;  // free until the first tile
        const int al = a.kl - a.kl / 2, ah = a.kh - a.kh / 2;
        const int bits[4] = {al, a.kl - al, ah, a.kh - ah};
        const int row0[4] = {0, al, a.kl, a.kl + ah};
        const int off[4] = {0, 1 << bits[0], (1 << bits[0]) + (1 << bits[1]),
                            (1 << bits[0]) + (1 << bits[1]) + (1 << bits[2])};
        if (t < 4) {
          tabs[2 * off[t]] = make_uint4(c.one[0], c.one[1], c.one[2], c.one[3]);
          tabs[2 * off[t] + 1] = make_uint4(c.one[4], c.one[5], c.one[6], c.one[7]);
        }
        sync_first(table_threads);
        for (int i = 0; i < bits[0]; ++i) {
          const int n = 1 << i;
          for (int w = t; w < 4 * n; w += table_threads) {
            const int q = w / n, j = w % n;
            if (i >= bits[q]) continue;
            uint4* x_at = tabs + 2 * (off[q] + j);
            const uint4 u0 = x_at[0], u1 = x_at[1];
            const uint32_t x[kLimbs] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
            uint32_t ri[kLimbs], hi[kLimbs], lo[kLimbs];
            load_digits(ri, s_rows[row0[q] + i]);
            mont_mul(hi, x, ri, c.f);
            sub_mod(lo, x, hi, c.f);
            x_at[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
            x_at[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
            x_at[2 * n] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            x_at[2 * n + 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
          }
          sync_first(table_threads);
        }
        for (int w = t; w < lanes; w += table_threads) {
          const bool low = w < nlo;
          const int j = low ? w : w - nlo, q = low ? 0 : 2;
          const uint4* pa = tabs + 2 * (off[q] + (j & ((1 << bits[q]) - 1)));
          const uint4* pb = tabs + 2 * (off[q + 1] + (j >> bits[q]));
          const uint32_t x[kLimbs] = {pa[0].x, pa[0].y, pa[0].z, pa[0].w,
                                      pa[1].x, pa[1].y, pa[1].z, pa[1].w};
          const uint32_t y[kLimbs] = {pb[0].x, pb[0].y, pb[0].z, pb[0].w,
                                      pb[1].x, pb[1].y, pb[1].z, pb[1].w};
          uint32_t v[kLimbs];
          mont_mul(v, x, y, c.f);
          s_eq[2 * w] = make_uint4(v[0], v[1], v[2], v[3]);
          s_eq[2 * w + 1] = make_uint4(v[4], v[5], v[6], v[7]);
        }
      }
""")
TILE_1024 = ("constexpr int kTile = 512;", "constexpr int kTile = 1024;")

EQ_SUBS = {
    "blocks": [],
    "split": [SPLIT],
    "tile1024": [TILE_1024],
    "separate": GLOBAL_EQ + [(BUILD_CALL, EQ_LANES + STAGE)],
    "cooperative": GLOBAL_EQ + [(BUILD_CALL, COOPERATIVE), (LAUNCHES, COOPERATIVE_LAUNCH),
                    ('#include "field.cuh"\n', '#include "field.cuh"\n\n#include <cooperative_groups.h>\n')],
}
VARIANTS = [f"{eq}_{order}" for eq in EQ_SUBS for order in ORDERS
            if (eq in ("separate", "cooperative")) != (order == "beside")
            or eq == "blocks"] + ["three_launches"]


def build_variants() -> dict:
    """{library name: path}, one nvcc each, all at once: each eq source
    with each slot order."""
    src = GK.SOURCE.read_text()
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for eq, subs in EQ_SUBS.items():
        for order in ORDERS:
            name = f"{eq}_{order}"
            if name not in VARIANTS:
                continue
            text = src
            for old, new in subs + ([] if order == "beside" else in_list(order)):
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            cu = out_dir / f"gkr_init_{name}.cu"
            cu.write_text(text)
            libs[name] = out_dir / f"gkr_init_{name}.so"
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
                 str(cuda_build.CSRC), "-o", str(libs[name]), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    regs = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        regs[name] = sorted({int(r) for r in re.findall(r"Used (\d+) registers", err)})
    return libs, regs


def use(lib: Path) -> int:
    """Point the wrappers at `lib`; returns its tile."""
    tile = ctypes.CDLL(str(lib)).sc_gkr_tile()
    GK.TILE = tile
    GK.build = lambda: lib
    GK._library.cache_clear()
    return tile


def _variant_lib() -> ctypes.CDLL:
    """The loaded variant library, with the entries of `GLOBAL_EQ` typed."""
    lib = GK._library()
    ptr, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sc_variant_set_eq.argtypes = [ptr]
    lib.sc_variant_eq_halves.argtypes = [ptr, i32, i32, ptr, ll,
                                         ctypes.POINTER(ctypes.c_uint32), ptr]
    return lib


def set_eq(eq: torch.Tensor) -> None:
    """Hand the next launch of a `GLOBAL_EQ` variant its half tables."""
    _variant_lib().sc_variant_set_eq(eq.data_ptr())


def eq_halves(r: torch.Tensor, k: int) -> torch.Tensor:
    """The (8, 2^kl + 2^kh) half tables of eq(r, .) by `eq_halves_kernel`
    on a `GLOBAL_EQ` variant's library, one launch."""
    kl, kh = GK.halves(k)
    eq = torch.empty((8, (1 << kl) + (1 << kh)), dtype=torch.int32, device=r.device)
    GK._run("eq_halves", lambda lib, s: _variant_lib().sc_variant_eq_halves(
        eq.data_ptr(), kl, kh, r.data_ptr(), r.stride(0), GK._CONSTS, s), r.device)
    return eq


def reducer(variant: str):
    """A stand-in for `gkr_init_cuda.weight_reduce` on a variant's library:
    the same checks, the half tables from where the variant takes them."""
    kind = variant.split("_")[0]

    def fn(idx, vals, r, k, last, plan, out, f3=None, y=None, to_y=None, slot=None):
        _n, _s, dst, raw = GK._check_reduce(idx, vals, r, k, last, plan, out, f3, y, to_y, slot)
        if kind in ("separate", "three"):
            set_eq(eq_halves(r, k))
        elif kind == "cooperative":
            set_eq(torch.empty((8, sum(1 << h for h in GK.halves(k))), dtype=torch.int32,
                               device=vals.device))
        if kind == "three" and slot is not None:  # pair_slots in a launch of its own
            carry = GK._launch_reduce(idx, vals, r, k, last, plan, out, dst, raw, f3, y, to_y,
                                      None)
            table, fold = slot
            GK.pair_slots(*out, ((1, table, None if fold is None else "fold"),), fold=fold)
            return carry
        return GK._launch_reduce(idx, vals, r, k, last, plan, out, dst, raw, f3, y, to_y, slot)

    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profiles", type=int, default=5)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cuda_build.build("round", "transcript", "gkr_init")
    libs, regs = build_variants()
    lib_of = {v: libs["separate_after" if v == "three_launches" else v] for v in VARIANTS}
    dim = 18
    inst = MB.gkr_instance(dim, 0)
    f1, f2, f3, g = inst
    split, f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, dim, dev)
    rnd = random.Random(dim)
    u_r = GI.upload(GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)]), dev)
    half = 1 << (dim - 1)

    def pair():
        return tuple(torch.empty((2, 8, half), dtype=torch.int32, device=dev) for _ in range(2))

    nnz = split.vals.shape[0]
    plans = {}

    def phase_args(tile):
        """Both phases' leading arguments with `tile`'s plans."""
        if tile not in plans:
            plans[tile] = tuple(GK.Plan(torch.from_numpy(items).to(dev), long) for items, long in
                                (GK.tile_plan(last.cpu().numpy(), nnz, tile)
                                 for last in (split.last_x, split.last_y)))
        px, py = plans[tile]
        return ((split.gbits, split.vals, g_r, dim, split.last_x, px),
                (split.x_y, carry_want, u_r, dim, split.last_y, py))

    kw1 = {"f3": f3_d, "y": split.y_rev, "to_y": split.to_y}
    want1 = pair()
    carry_want = GK.weight_reduce_ref(split.gbits, split.vals, g_r, dim, split.last_x,
                                      split.plan_x, want1, slot=(f2_d, None), **kw1)
    fold = (want1[0][:, :, :1], want1[1][:, :, :1], u_r[dim - 1], 1)
    p1, p2 = phase_args(GK.TILE)
    want2 = pair()
    GK.weight_reduce_ref(*p2, want2, slot=(f3_d, fold))
    out1, out2 = pair(), pair()
    times = {v: [] for v in VARIANTS}
    real = GK.weight_reduce
    try:
        # a turn of the committed build first, not kept: the first timings
        # of a process read slow
        for v in ["blocks_beside"] + VARIANTS + VARIANTS[::-1]:
            reduce, (a1, a2) = reducer(v), phase_args(use(lib_of[v]))

            def phase1():
                return reduce(*a1, out1, slot=(f2_d, None), **kw1)

            def phase2():
                reduce(*a2, out2, slot=(f3_d, fold))

            carry = phase1()
            phase2()
            torch.cuda.synchronize()
            C.check(torch.equal(carry, carry_want) and all(
                torch.equal(a, b) for a, b in zip(out1 + out2, want1 + want2)), f"{v}: differs")
            times[v].append([C.time_ms(fn, args.reps, dev, device_only=True, cold_l2=True)
                             for fn in (phase1, phase2)])
        times["blocks_beside"].pop(0)

        # the parts alone
        def bare(args, out, kw, eq):
            f3, y, to_y = (kw.get(key) for key in ("f3", "y", "to_y"))
            _n, _s, dst, raw = GK._check_reduce(*args, out, f3, y, to_y, None)
            if eq is not None:
                set_eq(eq)
            return GK._launch_reduce(*args, out, dst, raw, f3, y, to_y, None)

        use(libs["separate_after"])
        eq_g, eq_u = eq_halves(g_r, dim), eq_halves(u_r, dim)
        parts = {
            "build_reduce": (libs["blocks_beside"], lambda: bare(p1, out1, kw1, None),
                             lambda: bare(p2, out2, {}, None)),
            "staged_reduce": (libs["separate_after"], lambda: bare(p1, out1, kw1, eq_g),
                              lambda: bare(p2, out2, {}, eq_u)),
            "eq_halves": (libs["separate_after"], lambda: eq_halves(g_r, dim),
                          lambda: eq_halves(u_r, dim)),
            "slot": (libs["blocks_beside"], lambda: GK.pair_slots(*out1, ((1, f2_d, None),)),
                     lambda: GK.pair_slots(*out2, ((1, f3_d, "fold"),), fold=fold)),
        }
        part_ms = {name: [] for name in parts}
        for name in list(parts) + list(parts)[::-1]:
            lib, one, two = parts[name]
            check_tile = use(lib)
            C.check(check_tile == 512, f"{name}: tile {check_tile}")
            one(), two()
            torch.cuda.synchronize()
            if name.endswith("reduce"):
                C.check(all(torch.equal(a[0], b[0]) for a, b in zip(out1 + out2, want1 + want2)),
                        f"{name}: slot 0 differs")
            part_ms[name].append([C.time_ms(fn, args.reps, dev, device_only=True, cold_l2=True)
                                  for fn in (one, two)])

        # inside a prove: each variant's init calls in profiled proves
        def prove():
            return GKRRoundSumcheck.prove(Blake2b512Rng.setup(), *inst, device=dev)

        inside, blob = {}, None
        names = ("eq_halves_kernel", "weight_reduce_kernel", "pair_slots_kernel")
        for v in VARIANTS:
            if use(lib_of[v]) != 512:  # the prove's plans are cut for 512
                inside[v] = None
                continue
            GK.weight_reduce = reducer(v)
            proof = prove().serialize_uncompressed()
            blob = blob or proof
            C.check(proof == blob, f"{v}: the prove's bytes differ")
            runs = []
            for _ in range(args.profiles):
                prof = MB.profile_events(prove, prove)
                runs.append(sum(e - s for s, e, name in prof["events"]
                                if any(k in name for k in names)) / 1e3)
            inside[v] = statistics.median(runs)
    finally:
        GK.weight_reduce = real
        use(cuda_build.build("gkr_init")["gkr_init"])
    print(json.dumps({"card": C.card_line(), "dim": dim, "entries": split.vals.shape[0],
                      "registers": regs, "flushed_ms": {
                          v: {"phase1": statistics.mean(t[0] for t in ts),
                              "phase2": statistics.mean(t[1] for t in ts),
                              "turns": [[round(x, 5) for x in t] for t in ts]}
                          for v, ts in times.items()},
                      "parts_flushed_ms": {
                          name: {"phase1": statistics.mean(t[0] for t in ts),
                                 "phase2": statistics.mean(t[1] for t in ts)}
                          for name, ts in part_ms.items()},
                      "inside_prove_ms": inside}))


if __name__ == "__main__":
    main()
