"""The C transcript and verifier core, built on demand with the system C
compiler.

`fastrng.c` (the port's own copy of the JAX package's source) holds the
Fiat-Shamir transcript (Blake2b-512, the reference rng's squeeze chain,
arkworks' rejection sampling) and the verifier's whole pass (feed, sample,
checks and interpolations in one call): the host verifier hashes and
rejection-samples once per round, and CPython's overhead made that the
verify's cost. The field arrives as arguments of each call, so one
library serves every prime.

Build model: `$CC -O2 -shared -fPIC` (`cc` unless ``CC`` says otherwise)
into `sumcheck_tpu_torch/build/fastrng_<hash>.so`, keyed by a hash of the
source, at the first transcript or verify, never at import. Concurrent
builds each write a temporary file and `os.replace` it, so they race
benignly. A failed build or load raises `NativeBuildError` with the
compiler's messages: there is no silent fallback. ``SUMCHECK_TPU_NATIVE=off``
is the one way to run the Python cores (`hashlib` and
`transcript/blake2b_core.py`, the per-round verify loop); `lib()` then
returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "fastrng.c"
BUILD_DIR = _DIR.parent / "build"
_CTX_BYTES = 512  # the callers' context buffer; b2_ctx must fit in it

_lib = None


class NativeBuildError(RuntimeError):
    """The C core did not build or load."""


def enabled() -> bool:
    """False when ``SUMCHECK_TPU_NATIVE=off`` selects the Python cores."""
    return os.environ.get("SUMCHECK_TPU_NATIVE", "on") != "off"


def library_path(build_dir=None) -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"fastrng_{tag}.so"


def build(build_dir=None) -> Path:
    """Compile `fastrng.c` into `build_dir` (`BUILD_DIR` by default) unless
    it is built already; returns the library's path. Raises
    `NativeBuildError` on failure."""
    so = library_path(build_dir)
    if so.exists():
        return so
    cc = os.environ.get("CC", "cc")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=so.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise NativeBuildError(f"C core: could not run {cc!r}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(
            f"C core: {cc} exit code {proc.returncode} building {SOURCE.name}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(so: Path) -> ctypes.CDLL:
    """The library at `so` with every entry point's signature declared."""
    try:
        L = ctypes.CDLL(str(so))
    except OSError as e:
        raise NativeBuildError(f"C core: could not load {so}: {e}") from e
    u64, cp, vp = ctypes.c_uint64, ctypes.c_char_p, ctypes.c_void_p
    L.b2_ctx_size.restype = u64
    L.b2_init.argtypes = [vp]
    L.b2_update.argtypes = [vp, cp, u64]
    L.b2_digest.argtypes = [vp, vp]
    L.b2_fill.argtypes = [vp, vp, u64]
    L.b2_draw4.argtypes = [vp, vp]
    L.b2_fr_draw_canonical.restype = ctypes.c_int
    L.b2_fr_draw_canonical.argtypes = [vp, vp, u64, u64, vp]
    L.b2_get_state.argtypes = [vp, vp, vp, vp, vp]
    L.b2_set_state.argtypes = [vp, vp, u64, cp, u64]
    L.fr_verify_rounds.restype = ctypes.c_int
    L.fr_verify_rounds.argtypes = [vp, cp, u64, u64, vp, vp, vp, u64, u64, vp, vp, vp]
    if int(L.b2_ctx_size()) > _CTX_BYTES:
        raise NativeBuildError(
            f"C core: b2_ctx is {int(L.b2_ctx_size())} bytes, over the {_CTX_BYTES} the "
            "callers allocate")
    return L


def lib():
    """The loaded C core, built at the first call; None when
    ``SUMCHECK_TPU_NATIVE=off``. A failed build or load raises."""
    global _lib
    if not enabled():
        return None
    if _lib is None:
        _lib = load(build())
    return _lib
