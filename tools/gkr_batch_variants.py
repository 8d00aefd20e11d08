"""The batched GKR weight reduce (`csrc/gkr_init.cu`,
`weight_reduce_batched_kernel`: one launch a phase for B instances) taken
apart, and beside the design it replaced, on one H100.

    python tools/gkr_batch_variants.py [--reps N] [--sass DIR]

On `chip_smoke.py`'s GKR batch (8 x dim 14, `bench.py:313-338`), phase 1
(the f3 gather, the carry, slot 0's sums, f2 into slot 1) and phase 2
(over the carries, f3 times the final fold into slot 1), each checked
array-equal to the plain version, then timed with the L2 flushed before
each call (`chip_smoke.held_flushed_ms`, `--reps` calls), the variants in
turns, forward then backward, and the mean of the two turns:

  committed   the committed launch (`gkr_init_cuda.weight_reduce_batched`)
  table       the launch before it, as it was: the instances' `WeightReduce`
              entries in a device table that one `cudaMemcpyAsync` from
              pageable host memory fills ahead of the launch, each block
              running the single launch's body on `insts[blockIdx.y]`, a
              reference into device memory (this tool's copy of it,
              `variant_table_kernel`, appended to the committed source)
  resident    the same with the table already on the card: no copy in the
              window
  once        the same, each block reading its instance once, into shared
              memory, in place of the reference
  build       the half tables alone: the resident table's launch with no
              items and no slot items in any instance
  empty       an empty kernel with the same grid, block and shared memory
  single      one single `weight_reduce` launch of one instance (not 8)

and the committed kernel's own choices, each built by text substitution of
the committed source (`CHOICES`). Each library goes into
`sumcheck_tpu_torch/build/variants/`, one `nvcc` each, all at once. With
`--sass DIR`, each library's SASS (`cuobjdump -sass`) is written there, and
the loads of every weight-reduce kernel are counted (global loads `LDG`,
constant loads `LDC`; for a kernel that loads each plan item inside its
item loop, also inside that loop: between the plan item's load and the
loop's backward branch). One JSON line, with the card's name and
power limit."""

import argparse
import ctypes
import json
import random
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from sumcheck_tpu_torch import Fr  # noqa: E402
from sumcheck_tpu_torch import gkr_round_sumcheck as G  # noqa: E402
from sumcheck_tpu_torch.fields.fr import P  # noqa: E402
from sumcheck_tpu_torch.ops import cuda_build  # noqa: E402
from sumcheck_tpu_torch.ops import gkr_init as GI  # noqa: E402
from sumcheck_tpu_torch.ops import gkr_init_cuda as GK  # noqa: E402

# The launch before the committed one, appended to the committed source: its
# kernel over a device table of WeightReduce entries (read by reference, or
# copied into shared memory once a block), an empty kernel of the same shape,
# and one entry that fills the table (optionally copying it from pageable
# host memory on the stream, as that launch did) and launches.
TABLE_LAUNCH = r"""
#include <vector>

namespace {

template <bool kGather, bool kOnce>
__global__ void __launch_bounds__(kTile, 1024 / kTile)
    variant_table_kernel(const WeightReduce* __restrict__ insts,
                         const __grid_constant__ Consts c) {
  if constexpr (kOnce) {
    __shared__ WeightReduce s_inst;
    const uint64_t* from = reinterpret_cast<const uint64_t*>(insts + blockIdx.y);
    uint64_t* to = reinterpret_cast<uint64_t*>(&s_inst);
    for (int i = threadIdx.x; i < (int)(sizeof(WeightReduce) / 8); i += blockDim.x)
      to[i] = from[i];
    __syncthreads();
    weight_reduce_body<kGather>(s_inst, c);
  } else {
    weight_reduce_body<kGather>(insts[blockIdx.y], c);
  }
}

__global__ void __launch_bounds__(kTile, 1024 / kTile) variant_empty_kernel() {}

template <bool kGather, bool kOnce>
void variant_launch(dim3 grid, size_t smem, cudaStream_t s, const WeightReduce* t,
                    const Consts& c) {
  variant_table_kernel<kGather, kOnce><<<grid, kTile, smem, s>>>(t, c);
}

}  // namespace

// a launch's cost by its parameter bytes: an empty kernel taking N words
template <int N>
struct ParamBlob {
  unsigned long long v[N];
};

template <int N>
__global__ void variant_param_kernel(const __grid_constant__ ParamBlob<N> p,
                                     unsigned long long* out) {
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = p.v[N - 1];
}

template <int N>
float param_us(int reps, unsigned long long* out, cudaStream_t s) {
  ParamBlob<N> p;
  for (int i = 0; i < N; ++i) p.v[i] = i;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  variant_param_kernel<N><<<132, 32, 0, s>>>(p, out);
  cudaEventRecord(a, s);
  for (int i = 0; i < reps; ++i) variant_param_kernel<N><<<132, 32, 0, s>>>(p, out);
  cudaEventRecord(b, s);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms * 1000 / reps;
}

// Microseconds a launch of `reps` back to back, 132 blocks of 32 threads,
// with 8 B (which 0), 1 KB, 4 KB, 16 KB or 32,752 B (which 4) of parameters
// besides the output pointer.
extern "C" float sc_variant_param_us(int which, int reps, void* out, void* stream) {
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: return param_us<1>(reps, o, s);
    case 1: return param_us<128>(reps, o, s);
    case 2: return param_us<512>(reps, o, s);
    case 3: return param_us<2048>(reps, o, s);
    default: return param_us<4094>(reps, o, s);
  }
}

extern "C" int sc_variant_table(int batch, void* table, const unsigned long long* fields,
                                const int* items, long long r_stride, int kl, int kh,
                                long long nseg, long long n3, long long dst_ld,
                                long long dst_split, long long half, long long fstride,
                                int device, const uint32_t* consts, void* stream, int mode) {
  // mode: 0 copy and launch (the launch before), 1 fill only (synchronous
  // copy), 2 launch over the table as it is, 3 the same reading the
  // instance once, 4 the empty kernel, 5 fill with no items (the build alone)
  const Shape sh{r_stride, kl, kh, nseg, n3, dst_ld, dst_split, half, fstride};
  const bool gather = fields[5] != 0;
  std::vector<WeightReduce> insts(batch);
  int top = 0;
  for (int b = 0; b < batch; ++b) {
    const void* f[kFields];
    for (int q = 0; q < kFields; ++q) f[q] = reinterpret_cast<const void*>(fields[b * kFields + q]);
    const cudaError_t e = fill_reduce(&insts[b], f, items[b], sh, device);
    if (e != cudaSuccess) return (int)e;
    if (mode == 5) insts[b].items = 0, insts[b].slot.items = 0;
    top = items[b] > top ? items[b] : top;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == 1 || mode == 5)
    return (int)cudaMemcpy(table, insts.data(), insts.size() * sizeof(WeightReduce),
                           cudaMemcpyHostToDevice);
  const size_t smem = reduce_smem(kl, kh);
  const void* fn = gather ? (const void*)variant_table_kernel<true, false>
                          : (const void*)variant_table_kernel<false, false>;
  const void* fns[] = {fn, (const void*)variant_table_kernel<true, true>,
                       (const void*)variant_table_kernel<false, true>,
                       (const void*)variant_empty_kernel};
  for (const void* f : fns)
    if ((e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(kStageBytes + kMaxSharedEq * kLimbs * sizeof(uint32_t)))) !=
        cudaSuccess)
      return (int)e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kTile, smem)) != cudaSuccess)
    return (int)e;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  int per = (most + batch - 1) / batch;
  per = per < top ? per : top;
  if (mode == 0 && (e = cudaMemcpyAsync(table, insts.data(), insts.size() * sizeof(WeightReduce),
                                        cudaMemcpyHostToDevice, s)) != cudaSuccess)
    return (int)e;
  const dim3 grid((unsigned)per, (unsigned)batch);
  const Consts c = make_consts(consts);
  const WeightReduce* t = static_cast<const WeightReduce*>(table);
  if (mode == 4) {
    variant_empty_kernel<<<grid, kTile, smem, s>>>();
  } else if (mode == 3) {
    (gather ? variant_launch<true, true> : variant_launch<false, true>)(grid, smem, s, t, c);
  } else {
    (gather ? variant_launch<true, false> : variant_launch<false, false>)(grid, smem, s, t, c);
  }
  return (int)cudaGetLastError();
}
"""

# The committed kernel's choices, by text substitution: {name: [(old, new)]}.
BUILD_CALL = """    build_eq_halves(s_eq, s_rows, sh.kl, sh.kh, c, t, table_threads);
    if (kEarly) gather_f3<kGather>(h, in, item, t);
"""
# the half tables by direct products (the batched kernel's build before it
# took build_eq_halves): three barrier-separated steps, a depth of
# ceil(ceil(kl/2)/2) + 1 multiplies where the doubling takes kl levels
DIRECT_BUILD = r"""// Both half tables of eq(r, .) as build_eq_halves leaves them, for the
// batched kernel, by direct products in three barrier-separated steps where
// the doubling takes kl levels: each half over n variables is the product of
// a sub-table A over its low a = ceil(n/2) variables and B over the other n -
// a, lane t = A[t mod 2^a] * B[t >> a]; each sub-table lane is the product of
// its factors (r_i where bit i of the lane is set, else 1 - r_i), one thread
// a lane over two interleaved accumulators (ceil(a/2) dependent multiplies).
// So the depth is ceil(ceil(kl/2)/2) + 1 multiplies (3 at k = 14, 4 at k =
// 18 and 21) for 2^a + 2^(n-a) - 2 more multiplies a half. The four
// sub-tables go to `s_sub` (two uint4 a lane; the tile's stage, unused until
// the items). The rows are staged in `rows` by the caller; over `threads`
// threads (thread `tid`), the first barrier making the rows visible; then()
// runs after the sub-tables, before their barrier.
template <class Then>
__device__ __forceinline__ void build_halves_direct(uint4* s_eq, uint4* s_sub,
                                                    uint32_t (*rows)[kDigits], int kl, int kh,
                                                    const Consts& c, int tid, int threads,
                                                    Then then) {
  // the sub-tables A0, B0 (the low half), A1, B1 (the high half): their
  // variables, first rows and first lanes in s_sub
  const int a0 = (kl + 1) / 2, b0 = kl - a0, a1 = (kh + 1) / 2, b1 = kh - a1;
  const int at1 = 1 << a0, at2 = at1 + (1 << b0), at3 = at2 + (1 << a1), subs = at3 + (1 << b1);
  sync_first(threads);  // the staged rows
  for (int w = tid; w < subs; w += threads) {
    const int lane = w - (w < at1 ? 0 : w < at2 ? at1 : w < at3 ? at2 : at3);
    const int n = w < at1 ? a0 : w < at2 ? b0 : w < at3 ? a1 : b1;
    const int row = w < at1 ? 0 : w < at2 ? a0 : w < at3 ? kl : kl + a1;
    uint32_t even[kLimbs], odd[kLimbs];  // the products of the even and the odd factors
    copy8(even, c.one);
    for (int i = 0; i < n; ++i) {
      uint32_t f[kLimbs];
      load_digits(f, rows[row + i]);
      if (!((lane >> i) & 1)) sub_mod(f, c.one, f, c.f);
      if (i == 0) {
        copy8(even, f);
      } else if (i == 1) {
        copy8(odd, f);
      } else if (i & 1) {
        mont_mul(odd, odd, f, c.f);
      } else {
        mont_mul(even, even, f, c.f);
      }
    }
    if (n > 1) mont_mul(even, even, odd, c.f);
    s_sub[2 * w] = make_uint4(even[0], even[1], even[2], even[3]);
    s_sub[2 * w + 1] = make_uint4(even[4], even[5], even[6], even[7]);
  }
  then();
  sync_first(threads);
  const int nlo = 1 << kl, lanes = nlo + (1 << kh);
  for (int w = tid; w < lanes; w += threads) {
    const bool low = w < nlo;
    const int t = low ? w : w - nlo, a = low ? a0 : a1;
    uint32_t x[kLimbs], y[kLimbs];
    eq_lane(x, s_sub, (low ? 0 : at2) + (t & ((1 << a) - 1)));
    eq_lane(y, s_sub, (low ? at1 : at3) + (t >> a));
    mont_mul(x, x, y, c.f);
    s_eq[2 * w] = make_uint4(x[0], x[1], x[2], x[3]);
    s_eq[2 * w + 1] = make_uint4(x[4], x[5], x[6], x[7]);
  }
  sync_first(threads);
}

"""
MOVER_CALL = """    move_slot(in, sh, begin, end, c, t - table_threads, kBatchThreads - table_threads, [&] {
      if (kEarly) load_entries<kGather>(h, in, item, t);
    });
"""
EARLY = "  constexpr bool kEarly = kGather;\n"
CHOICES: dict = {
    # a thread an entry: 512 threads at 64 registers, 2 blocks an SM
    "per1": [("constexpr int kBatchPer = 2;", "constexpr int kBatchPer = 1;")],
    # a thread an entry at 128 registers, one block an SM
    "per1_wide": [("constexpr int kBatchPer = 2;", "constexpr int kBatchPer = 1;"),
                  ("constexpr int kBatchBlocks = 2;", "constexpr int kBatchBlocks = 1;")],
    # the half tables by direct products, the f3 gather between its steps
    "direct": [("// Lanes [begin, end) of the pair's slot 1 over", DIRECT_BUILD
                + "// Lanes [begin, end) of the pair's slot 1 over"),
               (BUILD_CALL, """    build_halves_direct(s_eq, s_stage, s_rows, sh.kl, sh.kh, c, t, table_threads, [&] {
      if (kEarly) gather_f3<kGather>(h, in, item, t);
    });
""")],
    # the first item's loads before the build and the slot in both phases,
    # and in neither
    "early_all": [(EARLY, EARLY.replace("= kGather", "= true"))],
    "late_all": [(EARLY, EARLY.replace("= kGather", "= false"))],
    # every launch's parameters at the most instances they hold (32 KB)
    "cap_max": [("  if (batch <= kBatchSmall)\n", "  if (false)\n")],
    # f3 gathered as from an (8, 2^14) limb-major table, 8 sectors an entry
    # (the rows read as such: the gather's bytes, not f3's values)
    "x_f3_limbs": [("if (item.z + t + j * kBatchThreads < item.w) load_row(h.q[j], in.f3, h.yl[j]);",
                  "if (item.z + t + j * kBatchThreads < item.w)\n"
                  "        for (int l = 0; l < kLimbs; ++l) h.q[j][l] = __ldg(in.f3 + l * (1 << 14)"
                  " + h.yl[j]);")],
    # the parts of the committed kernel, each taken out (their outputs are
    # not the function's, so not checked): the half tables' build, the
    # weights' multiplies (each an exclusive or, keeping the loads), the
    # segments' finish (the low words stored), the slot's lanes
    "x_no_build": [(BUILD_CALL, "    if (kEarly) gather_f3<kGather>(h, in, item, t);\n")],
    "x_no_mul": [("""      eq_lane(q, s_eq, h.ix[j] & mask);
      mont_mul(h.v[j], h.v[j], q, c.f);
      eq_lane(q, s_eq, nlo + (h.ix[j] >> sh.kl));
      mont_mul(h.v[j], h.v[j], q, c.f);
      if constexpr (kGather) {
        store_row(in.carry, h.to[j], h.v[j]);
        mont_mul(h.v[j], h.v[j], h.q[j], c.f);
      }""", """      eq_lane(q, s_eq, h.ix[j] & mask);
      for (int l = 0; l < kLimbs; ++l) h.v[j][l] ^= q[l];
      eq_lane(q, s_eq, nlo + (h.ix[j] >> sh.kl));
      for (int l = 0; l < kLimbs; ++l) h.v[j][l] ^= q[l];
      if constexpr (kGather) {
        store_row(in.carry, h.to[j], h.v[j]);
        for (int l = 0; l < kLimbs; ++l) h.v[j][l] ^= h.q[j][l];
      }""")],
    "x_no_finish": [("""  for (int i = 0; i < c.reduce_subs; ++i) cond_sub_p(v, c.f);
  if (carry) {""", """  if (false) {""")],
    "x_no_slot": [(MOVER_CALL, "    if (kEarly) load_entries<kGather>(h, in, item, t);\n")],
}

# The table launch's modes (TABLE_LAUNCH's `mode`), timed as variants.
MODES = {"table": 0, "resident": 2, "once": 3, "build": 2, "empty": 4}


def build_variants() -> tuple[dict, dict]:
    """({name: library path}, {name: ptxas registers}): the committed
    source with TABLE_LAUNCH appended, and each choice of CHOICES on it."""
    src = GK.SOURCE.read_text() + TABLE_LAUNCH
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for name, subs in {"committed": [], **CHOICES}.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        cu = out_dir / f"gkr_batch_{name}.cu"
        cu.write_text(text)
        libs[name] = out_dir / f"gkr_batch_{name}.so"
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
        regs[name], cur, spills = {}, None, 0
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            cur = m.group(1) if m else cur
            m = re.search(r"(\d+) bytes spill stores", line)
            spills = int(m.group(1)) if m else spills if cur else 0
            m = re.search(r"Used (\d+) registers", line)
            if m and cur and ("weight_reduce" in cur or "variant" in cur):
                regs[name][re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "", cur)] = \
                    [int(m.group(1)), spills]
    return libs, regs


def use(lib: Path) -> ctypes.CDLL:
    """Point the wrappers at `lib`; returns it with TABLE_LAUNCH's entry typed."""
    GK.build = lambda: lib
    GK._library.cache_clear()
    out = GK._library()
    if not hasattr(out, "sc_variant_table"):  # the committed library alone
        return out
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    out.sc_variant_table.argtypes = [
        i32, ptr, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(i32),
        ll, i32, i32, ll, ll, ll, ll, ll, ll, i32, ctypes.POINTER(ctypes.c_uint32), ptr, i32]
    out.sc_variant_table.restype = ctypes.c_int
    return out


def table_fields(insts, carries) -> tuple[list, list]:
    """(pointers, items): each instance's 20 pointers in the order of the
    table launch's entries (`fill_reduce`), its long segments on scratch
    rows of its own."""
    long = sum(i.plan.long for i in insts)
    scratch, arrived = GK._scratch(insts[0].vals.device, long) if long else (None, None)
    ptrs, row = [], 0
    for i, carry in zip(insts, carries):
        lo, hi = i.out
        src, fold = i.slot if i.slot is not None else (None, None)
        flo, fhi, fr, fslot = fold if fold is not None else (None, None, None, 0)
        rows = (scratch[row], arrived[row]) if i.plan.long else (None, None)
        row += i.plan.long
        ptrs += [GK._ptr(t) for t in (i.plan.items, i.vals, i.idx, i.r, i.last, i.y, i.f3,
                                      i.to_y, carry, *rows, None, lo[0], hi[0], src)]
        ptrs += [GK._ptr(lo[1]) if src is not None else 0,
                 GK._ptr(hi[1]) if src is not None else 0,
                 GK._ptr(flo[fslot]) if flo is not None else 0,
                 GK._ptr(fhi[fslot]) if fhi is not None else 0, GK._ptr(fr)]
    return ptrs, [len(i.plan.items) for i in insts]


def table_launch(insts, k: int, mode: int, table: torch.Tensor, carries) -> None:
    """TABLE_LAUNCH's entry over `insts` (GK.Instance) in `mode`."""
    ptrs, items = table_fields(insts, carries)
    i0 = insts[0]
    half = i0.out[0].shape[2]
    fold = i0.slot[1] if i0.slot is not None else None
    kl, kh = GK.halves(k)
    GK._run("variant_table", lambda lib, s: lib.sc_variant_table(
        len(insts), table.data_ptr(), (ctypes.c_ulonglong * len(ptrs))(*ptrs),
        (ctypes.c_int * len(items))(*items), i0.r.stride(0), kl, kh, i0.last.shape[0],
        0 if i0.f3 is None else i0.f3.shape[1], half, half, 0 if i0.slot is None else half,
        0 if fold is None else fold[0].stride(1), i0.vals.device.index, GK._CONSTS, s, mode),
        i0.vals.device)


def sass_loads(lib: Path, out_dir: Path) -> dict:
    """{kernel: {"LDG", "LDC", "loop_LDG", "loop_LDC"}} of the weight-reduce
    kernels in `lib`'s SASS, written to out_dir/<lib>.sass: the item loop
    runs from the plan item's 16-byte load (`LDG.E.128.CONSTANT`, the first
    after the half tables' last barrier) to the last backward branch."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    (out_dir / f"{lib.stem}.sass").write_text(sass)
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "weight_reduce" not in name and "variant_table" not in name:
            continue
        lines = [(int(m.group(1), 16), m.group(2)) for m in
                 re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        ops = [text for _addr, text in lines]
        start = next((i for i, t in enumerate(ops) if "LDG.E.128.CONSTANT" in t
                      and any("BAR" in u for u in ops[:i])), None)
        end = start
        for i, (addr, text) in enumerate(lines):
            m = re.search(r"BRA(?:\.\w+)*\s+[^;]*?0x([0-9a-f]+)", text)
            if m and start is not None and int(m.group(1), 16) <= lines[start][0] < addr:
                end = i
        loop = ops[start:end + 1] if start is not None and end > start else None
        name = re.sub(r"_ZN\w*?_GLOBAL__N__\w+?_cu_\w{8}\d+", "", name)
        out[name] = {"LDG": sum("LDG" in t for t in ops), "LDC": sum("LDC" in t for t in ops)}
        if loop is not None:  # a kernel that loads each item inside its loop
            out[name].update(loop_LDG=sum("LDG" in t for t in loop),
                             loop_LDC=sum("LDC" in t for t in loop), loop_instructions=len(loop))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--only", help="comma-separated variants to build and time (default all)")
    args = ap.parse_args()
    if args.only:
        keep = set(args.only.split(","))
        for name in list(CHOICES):
            if name not in keep:
                del CHOICES[name]
    dev = torch.device("cuda", 0)
    cuda_build.build("gkr_init")
    libs, regs = build_variants()
    seed, batch, dim = 0, C.BATCH, C.GKR_BATCH_DIM
    insts = C.gkr_batch_instances(seed, dim, batch)
    inputs = [G._upload(f1, f2, f3, g, dim, dev) for f1, f2, f3, g in insts]
    splits, f2s, f3s, g_rs = zip(*inputs)
    rnd = random.Random(seed + 14)
    u = torch.from_numpy(np.stack([GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)])
                                   for _ in range(batch)], axis=1)).to(dev)
    shape = (batch, 2, 8, 1 << (dim - 1))

    def pair():
        return tuple(torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(2))

    def insts1(lo, hi):
        return [GK.Instance(s.gbits, s.vals, g, s.last_x, s.plan_x, (lo[b], hi[b]), f3=f3,
                            y=s.y_rev, to_y=s.to_y, slot=(f2, None))
                for b, (s, f2, f3, g) in enumerate(inputs)]

    want1 = pair()
    carries_want = GK.weight_reduce_batched_ref(insts1(*want1), dim)
    lo1, hi1 = want1

    def insts2(lo, hi):
        return [GK.Instance(s.x_y, carries_want[b], u[:, b], s.last_y, s.plan_y, (lo[b], hi[b]),
                            slot=(f3, (lo1[b, :, :, :1], hi1[b, :, :, :1], u[dim - 1, b], 1)))
                for b, (s, f3) in enumerate(zip(splits, f3s))]

    want2 = pair()
    GK.weight_reduce_batched_ref(insts2(*want2), dim)
    out1, out2 = pair(), pair()
    carries = [torch.empty_like(c) for c in carries_want]
    table = torch.empty(batch * 256, dtype=torch.uint8, device=dev)
    nbytes = {}

    def calls(v):
        """(phase 1, phase 2, checked): variant v's two calls, and whether
        its outputs are the function's."""
        if v in CHOICES or v == "committed":
            return (lambda: GI.phase1_pairs(splits, g_rs, f3s, f2s, dim, *out1),
                    lambda: GI.phase2_pairs(lo1[:, :, :, :1], hi1[:, :, :, :1], u[dim - 1],
                                            splits, carries_want, u, f3s, dim, *out2),
                    not v.startswith("x_"))
        if v == "single":
            i1, i2 = insts1(*out1)[0], insts2(*out2)[0]
            return (lambda: GK.weight_reduce(i1.idx, i1.vals, i1.r, dim, i1.last, i1.plan,
                                             i1.out, i1.f3, i1.y, i1.to_y, i1.slot),
                    lambda: GK.weight_reduce(i2.idx, i2.vals, i2.r, dim, i2.last, i2.plan,
                                             i2.out, slot=i2.slot), False)
        mode = MODES[v]
        a1, a2 = insts1(*out1), insts2(*out2)
        if mode in (2, 3):  # the table filled once, outside the window
            fill = 5 if v == "build" else 1
            return (lambda: (table_launch(a1, dim, fill, table, carries),
                             table_launch(a1, dim, mode, table, carries)),
                    lambda: (table_launch(a2, dim, fill, table, carries),
                             table_launch(a2, dim, mode, table, carries)),
                    v != "build")
        return (lambda: table_launch(a1, dim, mode, table, carries),
                lambda: table_launch(a2, dim, mode, table, carries), mode == 0)

    def timed(v):
        """Variant v's two calls as timed: the table's fill outside the window."""
        one, two, _ok = calls(v)
        if MODES.get(v) in (2, 3):
            one(), two()  # fills, then each timed call launches only
            mode = MODES[v]
            fill = 5 if v == "build" else 1
            a1, a2 = insts1(*out1), insts2(*out2)
            table_launch(a1, dim, fill, table, carries)
            t1 = lambda: table_launch(a1, dim, mode, table, carries)  # noqa: E731
            ms1 = C.held_flushed_ms(t1, dev, args.reps)
            table_launch(a2, dim, fill, table, carries)
            t2 = lambda: table_launch(a2, dim, mode, table, carries)  # noqa: E731
            return [ms1, C.held_flushed_ms(t2, dev, args.reps)]
        return [C.held_flushed_ms(fn, dev, args.reps) for fn in (one, two)]

    variants = ["committed", *CHOICES, "table", "resident", "once", "build", "empty", "single"]
    times = {v: [] for v in variants}
    try:
        for v in ["committed"] + variants + variants[::-1]:  # a first turn, not kept
            use(libs[v] if v in libs else libs["committed"])
            one, two, checked = calls(v)
            for o in out1 + out2:
                o.fill_(0)
            got = one()
            two()
            torch.cuda.synchronize()
            if checked:
                if v in CHOICES or v == "committed":
                    carries_got = got
                else:
                    carries_got = carries
                C.check(all(torch.equal(a, b) for a, b in zip(carries_got, carries_want))
                        and all(torch.equal(a, b) for a, b in zip(out1 + out2, want1 + want2)),
                        f"{v}: differs from the plain version")
                scratch, arrived = GK._scratch(dev, 1)
                C.check(not scratch.any() and not arrived.any(), f"{v}: the scratch is not zero")
            times[v].append(timed(v))
        times["committed"].pop(0)
        lib = use(libs["committed"])
        nbytes["param_bytes"] = lib.sc_gkr_batch_param_bytes(batch)
        lib.sc_variant_param_us.restype = ctypes.c_float
        lib.sc_variant_param_us.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p]
        sink = torch.empty(1, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        nbytes["launch_us_by_param_bytes"] = {
            size: [round(lib.sc_variant_param_us(which, 2000, sink.data_ptr(), stream), 3)
                   for _turn in range(2)]
            for which, size in enumerate((8, 1024, 4096, 16384, 32752))}
        sass = {}
        if args.sass:  # the committed library's (it holds the table launch's kernels too)
            args.sass.mkdir(parents=True, exist_ok=True)
            sass = sass_loads(libs["committed"], args.sass)
    finally:
        use(cuda_build.build("gkr_init")["gkr_init"])
    print(json.dumps({"card": C.card_line(), **nbytes, "flushed_ms": {
        v: [round(statistics.mean(t[0] for t in ts), 5), round(statistics.mean(t[1] for t in ts), 5)]
        for v, ts in times.items()}}))
    print(json.dumps({
        "card": C.card_line(), "batch": batch, "dim": dim,
        "entries": [s.vals.shape[0] for s in splits], "registers": regs, **nbytes,
        "flushed_ms": {v: {"phase1": statistics.mean(t[0] for t in ts),
                           "phase2": statistics.mean(t[1] for t in ts),
                           "turns": [[round(x, 5) for x in t] for t in ts]}
                       for v, ts in times.items()},
        "sass_loads": sass}))


if __name__ == "__main__":
    main()
