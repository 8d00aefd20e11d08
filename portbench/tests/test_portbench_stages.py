"""The stage metrics (`portbench/stages.py` and their readers) on hand-built
traces of two calls, whose spans and device records give every reading by
hand, and on a trace of the port's own spans profiled on the CPU."""

import sys

import pytest

from portbench import run as R
from portbench import stages as S
from portbench.trace import Call, Trace

# us. Call 1 [0, 100]: the card copies in 10-20, computes 30-60, copies
# out 85-88. Call 2 [200, 300]: 215-260, out 270-275. Its `assemble`
# starts in its range and ends past it; a span between the calls belongs
# to none.
CALLS = [(0, 100, [(10, 20, "Memcpy HtoD"), (30, 60, "fold_kernel"), (85, 88, "Memcpy DtoH")]),
         (200, 300, [(215, 260, "fold_kernel"), (270, 275, "Memcpy DtoH")])]
SPANS = [(1, 5, "feed"), (5, 12, "lift"), (12, 40, "init"), (40, 70, "chain"), (70, 88, "fetch"),
         (88, 99, "assemble"),
         (150, 160, "feed"),
         (201, 203, "feed"), (203, 210, "lift"), (210, 214, "inputs"), (214, 230, "init"),
         (230, 266, "chain"), (266, 275, "fetch"), (275, 310, "assemble")]
OPS = [(41, 45, "aten::empty"), (72, 87, "aten::to"), (231, 233, "cudaLaunchKernel")]


def _trace(spans=SPANS):
    calls = [Call(s, e, list(recs)) for s, e, recs in CALLS]
    host = sorted([(s, e, f"sumcheck.{n}") for s, e, n in spans] + OPS)
    return Trace(calls, host, 2, {})


def _read(metric, trace):
    return R.load_reader(metric).read(trace)


def test_spans_belong_to_the_call_that_holds_their_start():
    per_call = S.call_spans(_trace())
    assert [len(spans) for spans in per_call] == [6, 7]
    assert per_call[1][-1] == (275, 310, "assemble")


def test_stage_readings_by_hand():
    trace = _trace()
    # enqueue: 4 + 7 + 28 + 30 in call 1, 2 + 7 + 4 + 16 + 36 in call 2
    assert _read("enqueue_ms", trace) == pytest.approx((69 + 65) / 2 / 1e3)
    # idle inside them: feed 4, lift 5 (busy 10-12), init 10 (12-20, 30-40 busy),
    # chain 10 (40-60 busy); call 2: 2, 7, 4, init 1 (215-230 busy), chain 6
    assert _read("enqueue_idle_ms", trace) == pytest.approx((29 + 20) / 2 / 1e3)
    assert _read("fetch_wait_ms", trace) == pytest.approx((18 + 9) / 2 / 1e3)
    assert _read("assemble_ms", trace) == pytest.approx((11 + 35) / 2 / 1e3)


def test_a_gap_split_by_a_stage_boundary_takes_the_larger_side():
    """The 60-85 gap of call 1 lies 10 us in `chain` and 15 in `fetch`
    (13 of them in a torch op): the breakdown names it after `fetch`, and
    `enqueue_idle_ms` counts only its 10 us in `chain`. With the boundary
    moved to 80 the gap is named after `chain`, whose idle time grows by
    10 us. Every gap carries a stage."""
    gaps = _trace().breakdown()["idle_gaps"]
    # longest first: 60-85, 275-300, 200-215, 88-100, 0-10, 20-30, 260-270
    assert [name[len(S.PREFIX):] for name, _l in gaps] == [
        "fetch", "assemble", "lift", "assemble", "lift", "init", "chain"]
    assert [round(length * 1e6) for _n, length in gaps] == [25, 25, 15, 12, 10, 10, 10]
    moved = [(s, e, n) for s, e, n in SPANS if n not in ("chain", "fetch")] + [
        (40, 80, "chain"), (80, 88, "fetch"), (230, 266, "chain"), (266, 275, "fetch")]
    gaps = _trace(moved).breakdown()["idle_gaps"]
    assert ["sumcheck.chain", 25e-6] in [[n, pytest.approx(x)] for n, x in gaps]
    assert _read("enqueue_idle_ms", _trace(moved)) == pytest.approx((29 + 10 + 20) / 2 / 1e3)


def test_a_program_without_spans_or_counters_reads_nothing(monkeypatch):
    trace = _trace(spans=[])
    for metric in ("enqueue_ms", "enqueue_idle_ms", "fetch_wait_ms", "assemble_ms"):
        assert _read(metric, trace) is None
    monkeypatch.setitem(sys.modules, "sumcheck_tpu_torch.utils.tracing", None)
    assert _read("chained_pct", trace) is None


def _counts(ml=16, host=0, gkr=8, alone=0):
    return {"_prove_local.instances": ml, "_prove_batched_host.instances": host,
            "BatchedGKRRoundSumcheck.prove.instances": gkr,
            "BatchedGKRRoundSumcheck.prove.alone": alone, "pair_init.launches": 3}


@pytest.mark.parametrize("counts, want", [
    (_counts(), 100.0),
    (_counts(host=4), 100.0 * (1 - 4 / 24)),
    (_counts(ml=0, gkr=8, alone=8), 0.0),
    (_counts(ml=32, host=16, gkr=0), 50.0),
    (_counts(ml=0, gkr=0), None),
    ({"pair_init.launches": 3}, None),
    (None, None),
])
def test_chained_pct(counts, want):
    got = S.chained_pct(counts)
    assert got == (None if want is None else pytest.approx(want))


def test_chained_pct_reads_the_port():
    got = _read("chained_pct", _trace())
    counts = S.port_counters()
    assert got == S.chained_pct(counts)
    assert set(S.ASKED + S.FALLEN) <= set(counts)


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
def test_the_ports_spans_partition_its_calls(protocol):
    """Two batched proves of the port at a tiny size on the CPU, profiled as
    the traced window is (`portbench.call` around each): the three parts
    of a call add up to 90-100% of it, and a call without device records
    is idle through its whole enqueue."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.inputs import call_inputs, make_pool
    from portbench.program import Program
    from portbench.tests.test_portbench_run import tiny
    from portbench.trace import SPAN

    spec = tiny(protocol)
    config, batch = spec["config"], spec["mix"]["batch"]
    program = Program(config, make_pool(config, batch, 5, "cpu"), "cpu")
    args = [program.prepare(call_inputs(config, batch, 5, i)) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for a in args:
            with record_function(SPAN):
                program.call(a)
    events = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
              for e in prof.profiler.kineto_results.events()]
    calls = sorted((s, e) for s, e, n in events if n == SPAN)
    trace = Trace([Call(s, e, []) for s, e in calls],
                  [x for x in events if x[2].startswith(S.PREFIX)], batch, {})
    mean_call_ms = sum(e - s for s, e in calls) / len(calls) / 1e3
    parts = sum(_read(m, trace) for m in ("enqueue_ms", "fetch_wait_ms", "assemble_ms"))
    assert 0.9 * mean_call_ms <= parts <= mean_call_ms
    assert _read("enqueue_idle_ms", trace) == pytest.approx(_read("enqueue_ms", trace))
    assert [len(spans) for spans in S.call_spans(trace)] == [6 if protocol == "ml" else 9] * 2
