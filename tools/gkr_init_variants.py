"""The fused GKR weight reduce (`csrc/gkr_init.cu`, `weight_reduce_kernel`)
beside the design choices it did not take, on one H100.

    python tools/gkr_init_variants.py [--reps N]

Each variant is the committed source with one choice changed by text
substitution, built with `nvcc` into `sumcheck_tpu_torch/build/variants/`
and loaded in place of the committed library:

  committed       tiles of 512 entries (a block of 512 threads), the half
                  eq tables staged in shared memory entry-major (two
                  16-byte loads a lane), f3 gathered from its limb-major
                  (8, n) table (8 sectors an entry)
  tile_256        tiles of 256 entries, a block of 256 threads
  eq_global       the half tables read from global memory (the cache),
                  as past `kMaxSharedEq` lanes
  eq_limb_major   the half tables staged limb-major (limb j of lane i at
                  word j * lanes + i: eight 4-byte loads a lane, the
                  earlier kernel's layout, whose bank conflicts were the
                  question)
  f3_rows         f3 gathered from an entry-major (n, 8) copy, one 32-byte
                  sector an entry (the copy made here, outside the timing)

On the bench's GKR dim-18 instance (`microbench.gkr_instance(18)`): each
variant's phase 1 (the f3 gather and the carry into slot 0 of a pair) and
phase 2 (over the carry) checked array-equal to the plain version, then
timed with the L2 flushed before each launch (`chip_smoke.time_ms`, 20
launches), the variants in turns, forward then backward, and the mean of
the two turns printed, one JSON line, with the card's name and power
limit."""

import argparse
import ctypes
import json
import random
import statistics
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

# (old, new) text substitutions of each variant, each of which must match once
VARIANTS = {
    "committed": [],
    "tile_256": [("constexpr int kTile = 512;", "constexpr int kTile = 256;")],
    "eq_global": [("const bool shared = lanes <= kMaxSharedEq;", "const bool shared = false;")],
    "eq_limb_major": [
        ("""      eq_rows[2 * i] = make_uint4(v[0], v[1], v[2], v[3]);
      eq_rows[2 * i + 1] = make_uint4(v[4], v[5], v[6], v[7]);""",
         """      for (int j = 0; j < kLimbs; ++j) reinterpret_cast<uint32_t*>(eq_rows)[j * lanes + i] = v[j];"""),
        ("""    const uint4 a = s_eq[2 * lane], b = s_eq[2 * lane + 1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z,
    x[7] = b.w;""",
         """    for (int j = 0; j < kLimbs; ++j) x[j] = reinterpret_cast<const uint32_t*>(s_eq)[j * lanes + lane];"""),
    ],
    "f3_rows": [("""#pragma unroll
        for (int j = 0; j < kLimbs; ++j) q[j] = __ldg(a.f3 + j * a.n3 + yl);""",
                 """        load_row(q, a.f3, yl);""")],
}


def build_variants() -> dict:
    """{variant: library path}, one nvcc each, all at once."""
    src = GK.SOURCE.read_text()
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"gkr_init_{name}.cu"
        cu.write_text(text)
        libs[name] = out_dir / f"gkr_init_{name}.so"
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(cuda_build.CSRC), "-o", str(libs[name]),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
    return libs


def use(lib: Path) -> int:
    """Point the wrappers at `lib`; returns its tile."""
    tile = ctypes.CDLL(str(lib)).sc_gkr_tile()
    GK.TILE = tile
    GK.build = lambda: lib
    GK._library.cache_clear()
    return tile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    libs = build_variants()
    dim = 18
    f1, f2, f3, g = MB.gkr_instance(dim, 0)
    split, _f2_d, f3_d, g_r = G._upload(f1, f2, f3, g, dim, dev)
    rnd = random.Random(dim)
    u_r = GI.upload(GI._point_rows([Fr(rnd.randrange(P)) for _ in range(dim)]), dev)
    eq_g, eq_u = GK.eq_halves_ref(g_r, dim), GK.eq_halves_ref(u_r, dim)
    f3_rows = f3_d.T.contiguous().view(8, -1)  # the entry-major copy, shaped as the table
    nnz = split.vals.shape[0]
    plans = {}
    lo, hi = (torch.empty((2, 8, 1 << (dim - 1)), dtype=torch.int32, device=dev)
              for _ in range(2))
    want = [torch.empty_like(lo), torch.empty_like(hi)]
    carry_want = GK.weight_reduce_ref(split.gbits, split.vals, eq_g, dim, split.last_x,
                                      split.plan_x, want, f3_d, split.y_rev, split.to_y)
    want1 = torch.cat([want[0][0], want[1][0]], dim=1)
    GK.weight_reduce_ref(split.x_y, carry_want, eq_u, dim, split.last_y, split.plan_y, want)
    want2 = torch.cat([want[0][0], want[1][0]], dim=1)
    times = {name: [] for name in VARIANTS}
    # a turn of the committed variant first, not kept: the first timings of
    # a process read slow
    for name in ["committed"] + list(VARIANTS) + list(reversed(VARIANTS)):
        tile = use(libs[name])
        if tile not in plans:
            plans[tile] = tuple(GK.Plan(torch.from_numpy(items).to(dev), long) for items, long in
                                (GK.tile_plan(last.cpu().numpy(), nnz, tile)
                                 for last in (split.last_x, split.last_y)))
        px, py = plans[tile]
        f3_arg = f3_rows if name == "f3_rows" else f3_d

        def phase1():
            return GK.weight_reduce(split.gbits, split.vals, eq_g, dim, split.last_x, px,
                                    (lo, hi), f3_arg, split.y_rev, split.to_y)

        def phase2():
            GK.weight_reduce(split.x_y, carry_want, eq_u, dim, split.last_y, py, (lo, hi))

        carry = phase1()
        torch.cuda.synchronize()
        C.check(torch.equal(carry, carry_want) and torch.equal(torch.cat([lo[0], hi[0]], 1),
                                                                want1), f"{name}: phase 1")
        phase2()
        torch.cuda.synchronize()
        C.check(torch.equal(torch.cat([lo[0], hi[0]], 1), want2), f"{name}: phase 2")
        times[name].append([C.time_ms(fn, args.reps, dev, device_only=True, cold_l2=True)
                            for fn in (phase1, phase2)])
    times["committed"].pop(0)
    print(json.dumps({"card": C.card_line(), "dim": dim, "entries": nnz, "flushed_ms": {
        name: {"phase1": statistics.mean(t[0] for t in ts),
               "phase2": statistics.mean(t[1] for t in ts),
               "turns": [[round(x, 5) for x in t] for t in ts]} for name, ts in times.items()}}))


if __name__ == "__main__":
    main()
