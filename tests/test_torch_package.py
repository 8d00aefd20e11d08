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
from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck, BatchedMLSumcheck
from sumcheck_tpu_torch.ops import fold_staged as FS
from sumcheck_tpu_torch.ops import gkr_init_cuda as GK
from sumcheck_tpu_torch.ops import init_cuda as IC
from sumcheck_tpu_torch.ops import round_cuda as RC
from sumcheck_tpu_torch.ops import transcript_cuda as TC
from sumcheck_tpu_torch.utils.config import get_config

COUNTERS = (RC.round_nofold, RC.round_fold, RC.round_step_nofold, RC.round_step_fold,
            RC.round_fold_mxu, TC.transcript_step, IC.pair_init, RC.round_nofold_batched,
            RC.round_fold_batched, RC.round_step_fold_batched, TC.transcript_step_batched,
            GK.weight_reduce, GK.weight_reduce_batched, GK.finish_sums, GK.pair_slots)

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
        import sumcheck_tpu_torch.ops.transcript_cuda, sumcheck_tpu_torch.transcript.device
        import sumcheck_tpu_torch.protocol.generic_prover, sumcheck_tpu_torch.protocol.device_prover
        import sumcheck_tpu_torch.gkr_round_sumcheck, sumcheck_tpu_torch.ops.gkr_init
        import sumcheck_tpu_torch.ops.mxu_mul, sumcheck_tpu_torch.ops.init_cuda
        import sumcheck_tpu_torch.batch, sumcheck_tpu_torch.parallel
        import sumcheck_tpu_torch.parallel.comm, sumcheck_tpu_torch.parallel.mesh
        import sumcheck_tpu_torch.parallel.prover, sumcheck_tpu_torch.utils.sol
        import sumcheck_tpu_torch.entry, sumcheck_tpu_torch.microbench
        from sumcheck_tpu_torch.protocol import IPForMLSumcheck
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
        from sumcheck_tpu_torch.utils.config import get_config
        get_config().chain_impl = "persize"
        T.MLSumcheck.prove(poly, device="cpu")
        import random
        rnd = random.Random(0)
        f1 = T.SparseMLE.rand_with_config(9, 8, rnd)
        f2, f3 = T.DenseMLE.rand(3, rnd), T.DenseMLE.rand(3, rnd)
        T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), f1, f2, f3, [T.Fr(5)] * 3, device="cpu")
        get_config().chain_impl, get_config().mxu_fold, get_config().ab = "generic", "kernel", True
        T.MLSumcheck.prove(poly, device="cpu")
        T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), f1, f2, f3, [T.Fr(5)] * 3, device="cpu")
    """, env=env)
    assert proc.returncode == 0, proc.stderr
    assert not mark.exists()


def _small_poly():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 1 << 14, size=(2, 16, 16), dtype=np.uint32)
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    return polynomial_from_numpy(4, list(t), [(3, [0, 1])])


def test_cuda_without_a_card_raises(monkeypatch):
    _cuda_without_a_card_raises(monkeypatch, "generic")


def test_cuda_without_a_card_raises_persize(monkeypatch):
    _cuda_without_a_card_raises(monkeypatch, "persize")


def _cuda_without_a_card_raises(monkeypatch, chain):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    monkeypatch.setattr(get_config(), "chain_impl", chain)
    calls = []
    for name in ("round_nofold_ref", "round_fold_ref", "round_step_nofold_ref",
                 "round_step_fold_ref"):
        monkeypatch.setattr(RC, name, lambda *a: calls.append(a))
    monkeypatch.setattr(TC, "transcript_step_ref", lambda *a: calls.append(a))
    with pytest.raises(RuntimeError):
        T.MLSumcheck.prove(_small_poly(), device="cuda")
    assert not calls  # nothing ran on the CPU instead


def test_wrappers_refuse_other_devices():
    lo = torch.zeros((2, 8, 8), dtype=torch.int32, device="meta")
    hi = torch.zeros((2, 8, 8), dtype=torch.int32, device="meta")
    r = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        RC.round_nofold(lo, hi, ((0, 1),), 2, 4)
    with pytest.raises(ValueError):
        RC.round_fold(lo, hi, r, ((0, 1),), 2, 4)
    with pytest.raises(ValueError):
        RC.round_step_nofold(lo, hi, ((0, 1),), 2)
    with pytest.raises(ValueError):
        RC.round_step_fold(lo, hi, r, ((0, 1),), 2)
    with pytest.raises(ValueError):
        RC.round_fold_mxu(lo, hi, r, ((0, 1),), 2, 4)
    with pytest.raises(ValueError):
        FS.round_fold_staged(lo, hi, r, ((0, 1),), 2, 4)
    state = torch.zeros((26, 2), dtype=torch.int32, device="meta")
    sums = torch.zeros((3, 16), dtype=torch.int64, device="meta")
    msgs = torch.zeros((2, 16, 3), dtype=torch.int32, device="meta")
    rs = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TC.transcript_step(state, sums, msgs, rs, 0)
    blo, bhi = lo[None], hi[None]
    br = r[None]
    with pytest.raises(ValueError):
        RC.round_nofold_batched(blo, bhi, ((0, 1),), 2, 4)
    with pytest.raises(ValueError):
        RC.round_fold_batched(blo, bhi, br, ((0, 1),), 2, 4)
    with pytest.raises(ValueError):
        RC.round_step_fold_batched(blo, bhi, br, ((0, 1),), 2)
    with pytest.raises(ValueError):
        TC.transcript_step_batched(state[None], sums[None], msgs[:, None], rs[:, None], 0)
    tab = torch.zeros((8, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        IC.pair_init(lo, hi, [tab], ((0, None), (None, 1)))
    idx = torch.zeros(16, dtype=torch.int32, device="meta")
    rows = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    vals = torch.zeros((16, 8), dtype=torch.int32, device="meta")
    plan = GK.Plan(torch.zeros((1, 4), dtype=torch.int32, device="meta"), 0)
    with pytest.raises(ValueError):
        GK.weight_reduce(idx, vals, rows, 4, idx, plan, tab)
    with pytest.raises(ValueError):
        GK.finish_sums(tab.long(), tab)
    with pytest.raises(ValueError):
        GK.pair_slots(lo, hi, ((1, tab, None),))
    with pytest.raises(ValueError):
        GK.pair_slots(None, None, (), fold=(lo, hi, r, 1), fold_out=r)
    assert all(f.launches == 0 for f in COUNTERS)


def test_launch_counters_name_every_wrapper():
    """`ops.launch_counters()` (the counts `chip_smoke.py` reads around each
    path) holds every kernel wrapper under its own name."""
    from sumcheck_tpu_torch.ops import launch_counters

    counters = launch_counters()
    assert tuple(counters.values()) == COUNTERS
    assert all(f.__name__ == name for name, f in counters.items())


def test_kernel_maxima_are_checked_before_a_build(monkeypatch):
    """The by-value plan's maxima mirror `csrc/round_common.cuh` (which
    both round kernel sources include) and `csrc/transcript.cu`, and the
    route is chosen by shape from them before any build: within them the
    by-value plan, past any of them the wide route, whose entries the
    sources hold. The transcript step's one ceiling, measured on the card
    (`max_degree`), raises `SumcheckError` naming it before any launch or
    build (the measurement stubbed here)."""
    from sumcheck_tpu_torch.ops import cuda_build
    from sumcheck_tpu_torch.ops import init_cuda as IC

    src = (cuda_build.CSRC / "round_common.cuh").read_text()
    for source in (RC.SOURCE, RC.SOURCE_MXU):
        assert '#include "round_common.cuh"' in source.read_text()
    for name, value in (("kMaxSlots", RC.MAX_SLOTS), ("kMaxProducts", RC.MAX_PRODUCTS),
                        ("kMaxFactors", RC.MAX_FACTORS), ("kMaxDegree", RC.MAX_DEGREE)):
        assert f"constexpr int {name} = {value};" in src
    assert "struct WidePlan" in src and "wide_block_sums" in src
    assert "int sc_round_launch_wide(" in RC.SOURCE.read_text()
    assert "int sc_fold_mxu_launch_wide(" in RC.SOURCE_MXU.read_text()
    assert "int sc_pair_init_launch_wide(" in IC.SOURCE.read_text()
    assert f"constexpr int kMaxSlots = {IC.MAX_SLOTS};" in IC.SOURCE.read_text()
    tsrc = TC.SOURCE.read_text()
    assert "constexpr int kMaxDegree = 8;" in tsrc and TC.MAX_DEGREE == 8
    assert "int sc_transcript_max_degree(" in tsrc
    assert f"constexpr int kStateWords = {TC.STATE_WORDS};" in tsrc
    assert RC.route(RC.MAX_SLOTS, ((0, 1),) * RC.MAX_PRODUCTS, RC.MAX_DEGREE) == "plan"
    for slots, products, degree in ((RC.MAX_SLOTS + 1, ((0, 1),), 2),
                                    (2, ((0, 1),) * (RC.MAX_PRODUCTS + 1), 2),
                                    (9, (tuple(range(9)),), RC.MAX_DEGREE + 1)):
        assert RC.route(slots, products, degree) == "wide"
    monkeypatch.setattr(TC, "max_degree", lambda index: 40)
    monkeypatch.setattr(TC, "_library", lambda: pytest.fail("built"))
    TC._check_ceiling(40, torch.device("cuda", 0))
    with pytest.raises(T.SumcheckError, match="ceiling on this card, 40"):
        TC._check_ceiling(41, torch.device("cuda", 0))


def test_cpu_prove_launches_no_kernel(monkeypatch):
    _cpu_prove_launches_no_kernel(monkeypatch, "generic")


def test_cpu_prove_launches_no_kernel_persize(monkeypatch):
    _cpu_prove_launches_no_kernel(monkeypatch, "persize")


def _cpu_prove_launches_no_kernel(monkeypatch, chain):
    monkeypatch.setattr(get_config(), "chain_impl", chain)
    before = [f.launches for f in COUNTERS]
    T.MLSumcheck.prove(_small_poly(), device="cpu")
    assert [f.launches for f in COUNTERS] == before


def test_build_names_each_source_and_shared_header(tmp_path, monkeypatch):
    """Each library is keyed by its own source and the shared header, and a
    missing `nvcc` raises before anything is built."""
    from sumcheck_tpu_torch.ops import cuda_build

    names = ("round", "transcript", "round_mxu", "pair_init", "gkr_init")
    assert len({cuda_build.library_path(n) for n in names}) == 5
    assert cuda_build.library_path("round").name.startswith("round_")
    assert cuda_build.CSRC / "round_common.cuh" in cuda_build.HEADERS
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError):
        cuda_build.build("round", "transcript")
    assert not any(tmp_path.iterdir())


def _small_gkr():
    import random

    rnd = random.Random(2)
    f1 = T.SparseMLE.rand_with_config(12, 20, rnd)
    return f1, T.DenseMLE.rand(4, rnd), T.DenseMLE.rand(4, rnd), [T.Fr(rnd.randrange(97)) for _ in range(4)]


@pytest.mark.parametrize("mode", ["generic", "persize", "mxu"])
def test_gkr_cuda_without_a_card_raises(monkeypatch, mode):
    """A GKR prove on `device="cuda"` without a card raises, on every path,
    and runs nothing on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-card path")
    monkeypatch.setattr(get_config(), "chain_impl", "persize" if mode == "persize" else "generic")
    if mode == "mxu":
        monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
        monkeypatch.setattr(get_config(), "ab", True)
    calls = []
    for name in ("round_nofold_ref", "round_fold_ref", "round_step_nofold_ref",
                 "round_step_fold_ref", "round_fold_mxu_ref"):
        monkeypatch.setattr(RC, name, lambda *a: calls.append(a))
    monkeypatch.setattr(TC, "transcript_step_ref", lambda *a: calls.append(a))
    with pytest.raises(RuntimeError):
        T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *_small_gkr(), device="cuda")
    assert not calls


@pytest.mark.parametrize("entry", ["prove", "prove_as_subprotocol", "gkr_prove", "batch_prove",
                                   "batch_prove_as_subprotocol", "batch_gkr_prove",
                                   "prover_init", "sharded_prove"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """The public prove entry points run on the card unless the caller asks
    for the CPU: `device` defaults to "cuda", so a call that names no device
    raises the no-card error where there is no card, and runs nothing on
    the CPU instead. (`ShardedProver` takes its device when it is made.)"""
    import inspect

    from sumcheck_tpu_torch.parallel import ShardedProver, comm

    fn = {"prove": T.MLSumcheck.prove, "prove_as_subprotocol": T.MLSumcheck.prove_as_subprotocol,
          "gkr_prove": T.GKRRoundSumcheck.prove, "batch_prove": BatchedMLSumcheck.prove,
          "batch_prove_as_subprotocol": BatchedMLSumcheck.prove_as_subprotocol,
          "batch_gkr_prove": BatchedGKRRoundSumcheck.prove,
          "prover_init": T.IPForMLSumcheck.prover_init,
          "sharded_prove": ShardedProver.__init__}[entry]
    param = inspect.signature(fn).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY and param.default == "cuda"
    if torch.cuda.is_available():
        return
    calls = []
    for name in ("round_nofold_ref", "round_fold_ref", "round_step_nofold_ref",
                 "round_step_fold_ref", "round_fold_mxu_ref", "round_nofold_batched_ref",
                 "round_fold_batched_ref", "round_step_fold_batched_ref"):
        monkeypatch.setattr(RC, name, lambda *a: calls.append(a))
    for name in ("transcript_step_ref", "transcript_step_batched_ref"):
        monkeypatch.setattr(TC, name, lambda *a: calls.append(a))
    monkeypatch.setattr(IC, "pair_init_ref", lambda *a: calls.append(a))
    rng = T.Blake2b512Rng.setup()
    state = rng.state_tuple()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "prove":
            T.MLSumcheck.prove(_small_poly())
        elif entry == "prove_as_subprotocol":
            T.MLSumcheck.prove_as_subprotocol(rng, _small_poly())
        elif entry == "gkr_prove":
            T.GKRRoundSumcheck.prove(rng, *_small_gkr())
        elif entry == "batch_prove":
            BatchedMLSumcheck.prove([_small_poly()] * 2)
        elif entry == "batch_prove_as_subprotocol":
            BatchedMLSumcheck.prove_as_subprotocol([rng], [_small_poly()])
        elif entry == "prover_init":
            T.IPForMLSumcheck.prover_init(_small_poly())
        elif entry == "sharded_prove":  # a one-rank gloo group stands in for a real one
            monkeypatch.setattr(comm, "rank_and_size", lambda group: (0, 1))
            monkeypatch.setattr(comm, "backend", lambda group: "gloo")
            ShardedProver(object()).prove(_small_poly())
        else:
            BatchedGKRRoundSumcheck.prove([rng], *([x] for x in _small_gkr()))
    assert not calls
    if entry.startswith("batch"):  # the device is resolved before any feed
        assert rng.state_tuple() == state


@pytest.mark.parametrize("mode", ["generic", "persize", "mxu"])
def test_cpu_gkr_prove_launches_no_kernel(monkeypatch, mode):
    monkeypatch.setattr(get_config(), "chain_impl", "persize" if mode == "persize" else "generic")
    if mode == "mxu":
        monkeypatch.setattr(get_config(), "mxu_fold", "kernel")
        monkeypatch.setattr(get_config(), "ab", True)
    before = [f.launches for f in COUNTERS]
    T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), *_small_gkr(), device="cpu")
    assert [f.launches for f in COUNTERS] == before


_FIELD_PRIMES = {
    None: 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    "bls12_381_fr": 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    "bn254_fr": 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
}


@pytest.mark.parametrize("value", ["bn254_fr", "", None, "bls12_381_fr", "goldilocks"])
def test_field_variable_other_than_bls12_381_raises(value):
    """`SUMCHECK_TPU_FIELD` selects the prime at import, as in the JAX
    package: unset or `bls12_381_fr` gives BLS12-381 Fr and `bn254_fr`
    BN254 Fr; a name that is not registered (`""`, `"goldilocks"`) raises
    on import, naming the variable, instead of proving over a field the
    caller did not ask for."""
    env = dict(os.environ)
    env.pop("SUMCHECK_TPU_FIELD", None)
    if value is not None:
        env["SUMCHECK_TPU_FIELD"] = value
    proc = _run("""
        import sumcheck_tpu_torch
        from sumcheck_tpu_torch.fields.fr import P
        print(hex(P))
    """, env=env)
    if value in _FIELD_PRIMES:
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == hex(_FIELD_PRIMES[value])
    else:
        assert proc.returncode != 0
        assert "SUMCHECK_TPU_FIELD" in proc.stderr and "ImportError" in proc.stderr
