"""Package rules of the port (`sumcheck_tpu_torch`): no JAX and no
`sumcheck_tpu` at import, no kernel build at import, and no silent fallback
from the CUDA path to the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import sumcheck_tpu_torch as T
from sumcheck_tpu_torch.ops import round_cuda as RC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )


def test_import_leaves_jax_out():
    proc = _run("""
        import sys
        import sumcheck_tpu_torch
        import sumcheck_tpu_torch.convert, sumcheck_tpu_torch.ops.round_cuda
        import sumcheck_tpu_torch.protocol.generic_prover
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "sumcheck_tpu" or m.startswith("sumcheck_tpu.")]
        assert not bad, bad
    """)
    assert proc.returncode == 0, proc.stderr


def test_import_and_cpu_rounds_run_no_nvcc(tmp_path):
    """An `nvcc` first on PATH that would leave a mark: importing the kernel
    module and running the CPU plain path must not call it."""
    mark = tmp_path / "nvcc-ran"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{tmp_path}{os.pathsep}{os.environ.get('PATH', '')}")
    proc = _run("""
        import numpy as np
        import sumcheck_tpu_torch as T
        from sumcheck_tpu_torch.convert import polynomial_from_numpy
        t = np.random.default_rng(0).integers(0, 1 << 14, size=(2, 16, 8), dtype=np.uint32)
        poly = polynomial_from_numpy(3, list(t), [(1, [0, 1])])
        T.MLSumcheck.prove(poly, device="cpu")
    """, env=env)
    assert proc.returncode == 0, proc.stderr
    assert not mark.exists()


def _small_poly():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 1 << 14, size=(2, 16, 16), dtype=np.uint32)
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    return polynomial_from_numpy(4, list(t), [(3, [0, 1])])


def test_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    calls = []
    monkeypatch.setattr(RC, "round_nofold_ref", lambda *a: calls.append(a))
    monkeypatch.setattr(RC, "round_fold_ref", lambda *a: calls.append(a))
    with pytest.raises(RuntimeError):
        T.MLSumcheck.prove(_small_poly(), device="cuda")
    assert not calls  # nothing ran on the CPU instead


def test_wrappers_refuse_other_devices():
    lo = torch.zeros((2, 16, 8), dtype=torch.int32, device="meta")
    hi = torch.zeros((2, 16, 8), dtype=torch.int32, device="meta")
    r = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        RC.round_nofold(lo, hi, ((0, 1),), 2, 4)
    with pytest.raises(ValueError):
        RC.round_fold(lo, hi, r, ((0, 1),), 2, 4)
    assert RC.round_nofold.launches == 0 and RC.round_fold.launches == 0


def test_kernel_maxima_are_checked_before_a_build():
    """A structure beyond the kernel's compile-time maxima raises before
    any build is attempted (the maxima mirror `csrc/round.cu`)."""
    src = RC.SOURCE.read_text()
    for name, value in (("kMaxSlots", RC.MAX_SLOTS), ("kMaxProducts", RC.MAX_PRODUCTS),
                        ("kMaxFactors", RC.MAX_FACTORS), ("kMaxDegree", RC.MAX_DEGREE)):
        assert f"constexpr int {name} = {value};" in src
    lo = torch.zeros((RC.MAX_SLOTS + 1, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        RC._launch(False, lo, lo, None, ((0, 1),), 2, 4)


def test_cpu_prove_launches_no_kernel():
    before = (RC.round_nofold.launches, RC.round_fold.launches)
    T.MLSumcheck.prove(_small_poly(), device="cpu")
    assert (RC.round_nofold.launches, RC.round_fold.launches) == before
