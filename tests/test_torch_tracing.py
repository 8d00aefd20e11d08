"""The port's stage spans and counters (`sumcheck_tpu_torch/utils/tracing.py`)
on the CPU (`device="cpu"`: the kernels' plain versions).

Under `torch.profiler`, a batched ML and a batched GKR prove open their
stages in order, flat, over at least 90% of the call; with no profiler no
`record_function` is entered; a profiled prove gives the same bytes and
transcripts as one not profiled. The fallback counters rise by the batch
on their paths, and `counters()` holds the kernel wrappers' `.launches` and
the collectives' counters by name.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import sumcheck_tpu_torch as T
from sumcheck_tpu_torch import batch as B
from sumcheck_tpu_torch.convert import polynomial_from_numpy
from sumcheck_tpu_torch.ml_sumcheck import serialize_proof
from sumcheck_tpu_torch.ops import launch_counters
from sumcheck_tpu_torch.parallel import comm
from sumcheck_tpu_torch.utils import tracing

STAGES = {"ml": ["feed", "lift", "init", "chain", "fetch", "assemble"],
          "gkr": ["feed", "lift", "inputs", "init", "chain", "init", "chain", "fetch",
                  "assemble"]}
CALL = "test.call"


def _ml(batch: int = 2, nv: int = 4, seed: int = 3):
    gen = np.random.default_rng(seed)
    polys = []
    for _ in range(batch):
        tables = []
        for _ in range(3):
            t = gen.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
            t[15] >>= 2  # < 2^254 < p
            tables.append(t)
        polys.append(polynomial_from_numpy(nv, tables, [(3, [0, 1, 2]), (5, [1])]))
    return polys


def _gkr(batch: int = 2, dim: int = 4, nnzs=None, seed: int = 5):
    rnd = random.Random(seed)
    nnzs = nnzs or [16] * batch
    shared = T.SparseMLE.rand_with_config(3 * dim, nnzs[0], rnd)
    out = []
    for nnz in nnzs:
        f1 = shared if nnz == nnzs[0] else T.SparseMLE.rand_with_config(3 * dim, nnz, rnd)
        g = [T.Fr(rnd.randrange(1 << 60)) for _ in range(dim)]
        out.append((f1, T.DenseMLE.rand(dim, rnd), T.DenseMLE.rand(dim, rnd), g))
    return out


def _rngs(count: int, prefix: bytes = b""):
    rngs = []
    for _ in range(count):
        rng = T.Blake2b512Rng.setup()
        if prefix:
            rng.feed(prefix)
        rngs.append(rng)
    return rngs


def _prove(protocol: str, rngs, instances):
    """One batched prove; returns each instance's proof bytes."""
    if protocol == "ml":
        proofs, _chal = B.BatchedMLSumcheck.prove_as_subprotocol(rngs, instances, device="cpu")
        return [serialize_proof(p) for p in proofs]
    proofs = B.BatchedGKRRoundSumcheck.prove(rngs, *(list(t) for t in zip(*instances)),
                                             device="cpu")
    return [p.serialize_uncompressed() for p in proofs]


def _instances(protocol: str):
    return _ml() if protocol == "ml" else _gkr()


def _profiled(protocol: str, rngs, instances):
    """The prove under a CPU profiler inside one range of the test's own;
    returns (proof bytes, the call's (start, end) ns, its stage spans
    (start, end, stage) in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            out = _prove(protocol, rngs, instances)
    # the raw records: parsing the plain kernels' million torch ops into
    # `prof.events()` would take most of a minute
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    (call,) = [(s, e) for s, e, n, _u in events if n == CALL]
    spans = sorted((s, e, n[len("sumcheck."):]) for s, e, n, user in events
                   if n.startswith("sumcheck.") and not user)
    assert len(spans) == sum(n.startswith("sumcheck.") for _s, _e, n, _u in events)
    return out, call, spans


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
def test_stages_in_order_flat_over_the_call(protocol):
    instances = _instances(protocol)
    _out, (start, end), spans = _profiled(protocol, _rngs(2), instances)
    assert [stage for _s, _e, stage in spans] == STAGES[protocol]
    for (_s0, e0, _a), (s1, _e1, _b) in zip(spans, spans[1:]):
        assert e0 <= s1  # no stage overlaps another
    assert start <= spans[0][0] and spans[-1][1] <= end
    assert sum(e - s for s, e, _n in spans) >= 0.9 * (end - start)


def _counting(monkeypatch, owner, attr: str, entered: list, kind: str):
    real = getattr(owner, attr)

    def counted(name, *args):
        entered.append((kind, name))
        return real(name, *args)

    monkeypatch.setattr(owner, attr, counted)


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
def test_no_profiler_enters_no_range(monkeypatch, protocol):
    """No range of either kind is entered with no profiler; under one, the
    spans are the profiler's ordinary host ranges, never the user
    annotations of `record_function`, whose copies on the device's
    timeline would carry ids that collide with the launches'."""
    entered = []
    _counting(monkeypatch, torch.profiler, "record_function", entered, "annotation")
    _counting(monkeypatch, torch._C._profiler, "_RecordFunctionFast", entered, "range")
    assert tracing.span("feed") is tracing.span("chain")  # one shared null context
    _prove(protocol, _rngs(2), _instances(protocol))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _prove(protocol, _rngs(2), _instances(protocol))
    assert entered == [("range", f"sumcheck.{s}") for s in STAGES[protocol]]


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
def test_profiled_prove_gives_the_same_bytes(protocol):
    instances = _instances(protocol)
    plain_rngs, traced_rngs = _rngs(2, b"\x05" * 8), _rngs(2, b"\x05" * 8)
    plain = _prove(protocol, plain_rngs, instances)
    traced, _call, _spans = _profiled(protocol, traced_rngs, instances)
    assert traced == plain
    assert [r.state_tuple() for r in traced_rngs] == [r.state_tuple() for r in plain_rngs]


def _delta(prove) -> dict:
    before = tracing.counters()
    prove()
    after = tracing.counters()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("prefix", [b"", b"abc"], ids=["chained", "pending_3_bytes"])
def test_ml_host_loop_counts_its_instances(prefix):
    polys = _ml(batch=3)
    got = _delta(lambda: _prove("ml", _rngs(3, prefix), polys))
    assert got.get("_prove_local.instances") == 3
    assert got.get("_prove_batched_host.instances", 0) == (3 if prefix else 0)


@pytest.mark.parametrize("nnzs", [[16, 16, 16], [16, 12, 16]], ids=["equal", "unequal_nnz"])
def test_gkr_alone_counts_its_instances(nnzs):
    instances = _gkr(batch=3, nnzs=nnzs)
    got = _delta(lambda: _prove("gkr", _rngs(3), instances))
    assert got.get("BatchedGKRRoundSumcheck.prove.instances") == 3
    assert got.get("BatchedGKRRoundSumcheck.prove.alone", 0) == (3 if nnzs[1] != 16 else 0)


def test_counters_hold_the_launch_and_collective_counters(monkeypatch):
    wrappers = launch_counters()
    for i, f in enumerate(wrappers.values()):
        monkeypatch.setattr(f, "launches", 100 + i)
    for i, (f, attr) in enumerate([(comm.all_reduce_sum_, "calls"),
                                   (comm.all_reduce_sum_, "bytes"),
                                   (comm.reduce_scatter_sum_, "calls"),
                                   (comm.reduce_scatter_sum_, "bytes"),
                                   (comm.reduce_scatter_sum_, "received")]):
        monkeypatch.setattr(f, attr, 7 + i)
    got = tracing.counters()
    assert {k: got[f"{k}.launches"] for k in wrappers} == {
        k: 100 + i for i, k in enumerate(wrappers)}
    assert [got["all_reduce_sum_.calls"], got["all_reduce_sum_.bytes"],
            got["reduce_scatter_sum_.calls"], got["reduce_scatter_sum_.bytes"],
            got["reduce_scatter_sum_.received"]] == [7, 8, 9, 10, 11]
    assert all(type(v) is int for v in got.values())
    assert len(got) == len(wrappers) + 5 + 4
