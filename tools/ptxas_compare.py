"""Build the port's CUDA libraries of two checkouts and compare the ptxas
resources of every kernel they share: registers, stack frame and spills.

    python tools/ptxas_compare.py <checkout A> <checkout B> [--out FILE]

Each checkout builds its own libraries (`ops/cuda_build.build`, in its own
`sumcheck_tpu_torch/build/`) in a child process, both at once. Prints one
line a kernel present in both, marked `=` where the resources are equal and
`!` where they differ, then the kernels only one checkout has, and a JSON
summary as the last line (also written to FILE). Needs `nvcc`; the card is
not used.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

NAMES = ("round", "transcript", "round_mxu", "pair_init", "gkr_init")

_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from sumcheck_tpu_torch.ops import cuda_build
cuda_build.build(*{names!r})
print(json.dumps({{n: cuda_build.resources(n) for n in {names!r}}}))
"""


def _key(name: str) -> str:
    """A kernel's name without the per-build hash of its anonymous
    namespace."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__", name)


def _short(name: str) -> str | None:
    """A kernel's identifier and template arguments without its parameter
    types, a leading `false` argument dropped: the key that matches a
    kernel to the one it became when it gained a compile-time switch whose
    false side is the old code (its mangled parameters may differ)."""
    m = re.search(r"\d+([A-Za-z_]\w*?_kernel)(I(.*?)EE)?", name)
    if m is None:
        return None
    args = m.group(3) + "E" if m.group(3) else ""
    return m.group(1) + "<" + (args[4:] if args.startswith("Lb0E") else args) + ">"


def _match(ka: dict, kb: dict) -> list[tuple[str, str]]:
    """Pairs (name in A, name in B) of the same kernel: by name, else by
    `_short` where that is unique on both sides."""
    pairs = [(n, n) for n in ka if n in kb]
    rest_a = [n for n in ka if n not in kb]
    rest_b = [n for n in kb if n not in ka]
    for n in rest_a:
        hits = [m for m in rest_b if _short(m) == _short(n) and _short(n)]
        if len(hits) == 1 and [x for x in rest_a if _short(x) == _short(n)] == [n]:
            pairs.append((n, hits[0]))
    return pairs


def _start(root: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", _CHILD.format(root=root, names=NAMES)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out")
    args = ap.parse_args()
    procs = [_start(args.a), _start(args.b)]
    res = []
    for root, proc in zip((args.a, args.b), procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"build of {root} failed:\n{err}")
        libs = json.loads(out.strip().splitlines()[-1])
        res.append({lib: {_key(k): v for k, v in ks.items()} for lib, ks in libs.items()})
    keys = ("registers", "stack", "spill_stores", "spill_loads")
    same, differ, only = 0, [], []
    for lib in NAMES:
        ka, kb = res[0][lib], res[1][lib]
        pairs = _match(ka, kb)
        for na, nb in sorted(pairs):
            a = tuple(ka[na].get(k) for k in keys)
            b = tuple(kb[nb].get(k) for k in keys)
            mark = "=" if a == b else "!"
            print(f"{mark} {lib} {nb} registers/stack/spills A {a} B {b}")
            if a == b:
                same += 1
            else:
                differ.append(nb)
        paired_a, paired_b = {a for a, _ in pairs}, {b for _, b in pairs}
        only += [f"{lib} {n} (A only)" for n in sorted(set(ka) - paired_a)]
        only += [f"{lib} {n} (B only)" for n in sorted(set(kb) - paired_b)]
    for line in only:
        print(line)
    summary = {"same": same, "differ": differ, "only_one": len(only)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "a": res[0], "b": res[1]}, f)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
