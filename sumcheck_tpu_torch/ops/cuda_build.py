"""Build the port's CUDA sources into shared libraries with a plain C
interface, for `ctypes`.

Each source `csrc/<name>.cu` becomes `build/<name>_<hash>.so`, keyed by a
hash of the source and the headers the sources share (`csrc/field.cuh`,
`csrc/round_common.cuh`), built with
`nvcc` for sm_90a at first launch, never at import. `build(*names)` starts
one `nvcc` per source not built yet, all at once, and waits for all of them.
A failed build raises. The compiler's resource report (`-Xptxas -v`) is
kept beside each library as `<library>.log`; `resources(name)` reads each
kernel's registers, shared memory, stack frame and spills from it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
HEADERS = (CSRC / "field.cuh", CSRC / "round_common.cuh")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in (source(name),) + HEADERS:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(*names: str) -> dict[str, Path]:
    """Compile `csrc/<name>.cu` for each name unless it is built already;
    returns {name: library path}."""
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", str(CSRC), "-o", str(tmp), str(source(name)),
        ]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source(name).name}: nvcc exit code {proc.returncode}\n{err}")
            continue
        todo[name].with_suffix(".log").write_text(out + err)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def resources(name: str) -> dict[str, dict]:
    """Per kernel of the built `csrc/<name>.cu`, from its ptxas log: {mangled
    kernel name: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}} (bytes, except registers). Device functions that ptxas
    reports on their own are included under their names."""
    import re

    out, cur = {}, None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out
