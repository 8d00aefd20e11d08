"""Speed-of-light model of a prove on the card: the port of
`sumcheck_tpu/utils/sol.py`.

Two rooflines bound a prove, both measured on the card by
`measure_roofline`, never quoted from a data sheet or carried over from
another device:

- **Montgomery multiplies per second** (primary): `csrc/field.cuh`'s
  even/odd `mont_mul`, the multiply every round kernel runs, through the
  probe `round_cuda._mont_mul_probe` on 2^20 lanes, each lane a chain of
  dependent multiplies;
- **HBM bytes per second**: a 1 GiB device-to-device copy, each byte read
  once and written once.

SOL seconds = max(mont_muls / mont rate, bytes / HBM rate); %SOL = SOL /
achieved. The op and byte counts are the algorithm's, as the JAX package
counts them (`prover.rs:110-132` semantics): round i has A2 = 2^(nv-1-i)
active pairs; the fold costs U*2*A2 multiplies (U = table slots), the
evaluation P*(L-1)*(d+1)*A2 (P products padded to L multiplicands,
coefficients pre-folded, `device_prover._fold_plan`). The per-multiply
constants are the port's: 32-bit multiplies, not the TPU's 16-bit digits.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

# 32-bit multiplies in one `csrc/field.cuh` even/odd mont_mul over 8 limbs:
# 64 + 64 32x32->64-bit products (a*b and m*p), two multiplies each (the
# low and the high word), and 8 for m = t0 * ninv
MULS_PER_MONT = 2 * 2 * 64 + 8
LANE_BYTES = 64  # one field element: 16 digits x uint32

MONT_LANES = 1 << 20
MONT_CHAIN = 256  # dependent multiplies a lane
COPY_BYTES = 1 << 30
TRIES = 5  # each rate is the fastest of this many timed runs


def count_prove_ops(nv: int, num_slots: int, num_products: int,
                    max_len: int, degree: int) -> dict:
    """Analytic mont_mul / byte totals for one chained prove."""
    mont = 0
    bytes_moved = 0
    H = 1 << (nv - 1)
    for i in range(nv):
        a2 = H >> i
        if i > 0:
            mont += num_slots * 2 * a2          # fold both half-stripes
            bytes_moved += 6 * a2 * num_slots * LANE_BYTES  # r 4 stripes, w 2
        else:
            bytes_moved += 2 * a2 * num_slots * LANE_BYTES  # sums read only
        mont += num_products * (max_len - 1) * (degree + 1) * a2
    return {"mont_muls": mont, "u32_muls": mont * MULS_PER_MONT, "hbm_bytes": bytes_moved}


def count_gkr_prove_ops(nv: int, nnz: int) -> dict:
    """Analytic totals for one chained GKR prove (dim = nv).

    Multiplies of the device path (`gkr_round_sumcheck._prove_chained`):
    - phase-1 init (`ops/gkr_init.phase1`): eq table by doublings ~2*2^nv,
      weight fold 1*nnz, f3-gather multiply 1*nnz;
    - phase-2 init (`phase2_digits`): eq table ~2*2^nv + 1*nnz;
    - prep2's f2(u) scaling: 1*2^nv;
    - two dim-round chains, U=2 slots, 1 product x 2 multiplicands, degree 2:
      per round `fold 2*2*A2 + eval 3*A2` with `sum A2 ~ 2^nv` per chain
      (round 0 folds nothing) => ~2 * (7 - 2) * 2^nv.
    HBM: the chains stream the pair ~6x extent a round (as in
    `count_prove_ops`) plus the two inits' dominant streams (sorted gather,
    32-row 8-bit cumsum, boundary gathers: ~6 passes of 128 B an entry).
    """
    n = 1 << nv
    mont = 3 * nnz + (2 + 2 + 1 + 10) * n
    chain_bytes = 2 * (6 * 2 * n * 2 * LANE_BYTES)  # 2 chains, U=2 slots
    init_bytes = 2 * (6 * 128 * nnz)
    return {"mont_muls": mont, "u32_muls": mont * MULS_PER_MONT,
            "hbm_bytes": chain_bytes + init_bytes}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index)], capture_output=True, text=True, check=True,
    ).stdout.strip()


def _fastest_ms(fn) -> float:
    """The fastest of `TRIES` CUDA-event timings of `fn()`, after one
    warm-up."""
    fn()
    best = float("inf")
    for _ in range(TRIES):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def _cache_path():
    from ..ops import cuda_build

    return cuda_build.BUILD_DIR / "sol_roofline.json"


def measure_roofline(device="cuda", force: bool = False) -> dict:
    """The card's two rooflines, measured (see the module docstring), with
    its name and power limit: {"mont_muls_per_s", "hbm_bytes_per_s",
    "card", ...}. Cached per card and power limit in the package's build
    directory; `force` measures again."""
    from ..fields.fr import FIELD_NAME, SHAVE_BITS
    from ..ops import round_cuda
    from ..protocol.device_prover import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the rooflines are a card's, not {device}'s")
    card = card_line(device)
    key = f"{card} / {FIELD_NAME}"
    path = _cache_path()
    cache = json.loads(path.read_text()) if path.exists() else {}
    if not force and key in cache:
        return cache[key]

    gen = np.random.default_rng(0)
    limbs = gen.integers(0, 1 << 32, size=(2, MONT_LANES, 8), dtype=np.uint64).astype(np.uint32)
    limbs[:, :, 7] >>= 1 + SHAVE_BITS  # below p
    a, b = (torch.from_numpy(x.view(np.int32)).to(device) for x in limbs)
    ms = _fastest_ms(lambda: round_cuda._mont_mul_probe(a, b, MONT_CHAIN, "eo"))
    mont_per_s = MONT_LANES * MONT_CHAIN / (ms / 1e3)

    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = _fastest_ms(lambda: dst.copy_(src))
    hbm_per_s = 2 * COPY_BYTES / (ms / 1e3)
    del src, dst

    result = {"mont_muls_per_s": mont_per_s, "hbm_bytes_per_s": hbm_per_s, "card": card,
              "field": FIELD_NAME, "mont_lanes": MONT_LANES, "mont_chain": MONT_CHAIN,
              "copy_bytes": COPY_BYTES}
    cache[key] = result
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cache, indent=1))
    return result


def sol_seconds(counts: dict, roofline: dict) -> dict:
    """SOL = the time of back-to-back Montgomery multiplies at the measured
    rate or of the HBM stream at the measured rate, whichever binds."""
    mont_s = counts["mont_muls"] / roofline["mont_muls_per_s"]
    hbm_s = counts["hbm_bytes"] / roofline["hbm_bytes_per_s"]
    return {
        "mont_bound_s": mont_s,
        "hbm_bound_s": hbm_s,
        "sol_s": max(mont_s, hbm_s),
        "bound": "mont" if mont_s >= hbm_s else "hbm",
    }
