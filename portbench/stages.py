"""The port's stage spans and fallback counters, as the stage metrics read
them.

The port marks each stage of a prove with a `record_function` range named
`sumcheck.<stage>` while a profiler runs (`sumcheck_tpu_torch/utils/
tracing.py`): the profiler's own host events, on the clock of its device
records, so they come into `Trace.host_events` beside the host's ops. The
stages are flat (none opens inside another): `feed`, `lift`, `inputs`,
`init` and `chain` enqueue a call's work, `fetch` is the host blocked in
the one device-to-host copy, `assemble` builds the proofs after it. A span
belongs to the traced call whose range holds its start.

The fallback counters come from `tracing.counters()`, over the whole run:
every call proves the same shape, so warm calls count alike.

A program without the spans or the counters gives nothing to read: each
reading is then None.
"""

from __future__ import annotations

PREFIX = "sumcheck."
ENQUEUE = ("feed", "lift", "inputs", "init", "chain")
ASKED = ("_prove_local.instances", "BatchedGKRRoundSumcheck.prove.instances")
FALLEN = ("_prove_batched_host.instances", "BatchedGKRRoundSumcheck.prove.alone")


def call_spans(trace) -> list:
    """Per traced call, its stage spans (start us, end us, stage) in start
    order."""
    per_call = [[] for _ in trace.calls]
    for start, end, name in trace.host_events:
        if not name.startswith(PREFIX):
            continue
        for spans, call in zip(per_call, trace.calls):
            if call.start <= start <= call.end:
                spans.append((start, end, name[len(PREFIX):]))
                break
    return [sorted(spans) for spans in per_call]


def stage_ms(trace, stages) -> float | None:
    """The summed durations of the spans of `stages` in a call, ms, the mean
    over the traced calls; None where no call holds a stage span."""
    per_call = call_spans(trace)
    if not any(per_call):
        return None
    total = sum(e - s for spans in per_call for s, e, stage in spans if stage in stages)
    return total / len(per_call) / 1e3


def _merged(intervals) -> list:
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def idle_ms(trace, stages) -> float | None:
    """The time inside the spans of `stages` in a call when no kernel, copy
    or fill ran on the card (the union of the device records, as
    `device_idle_pct` takes it), ms, the mean over the traced calls; None
    where no call holds a stage span."""
    per_call = call_spans(trace)
    if not any(per_call):
        return None
    busy = _merged((s, e) for s, e, _n in trace.records())
    idle = 0.0
    for spans in per_call:
        for start, end, stage in spans:
            if stage in stages:
                covered = sum(max(0.0, min(end, b) - max(start, a)) for a, b in busy)
                idle += end - start - covered
    return idle / len(per_call) / 1e3


def port_counters() -> dict | None:
    """The port's counters (`tracing.counters()`), None where the port has
    no such read-out."""
    try:
        from sumcheck_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    return counters()


def chained_pct(counts: dict | None) -> float | None:
    """The share of the instances asked for that the batched chains proved,
    percent: those neither on the ML host-transcript loop nor proved one
    by one by the GKR batch. None without the counters or with no
    instance asked for."""
    if counts is None or any(k not in counts for k in ASKED + FALLEN):
        return None
    asked = sum(counts[k] for k in ASKED)
    if not asked:
        return None
    return 100.0 * (1.0 - sum(counts[k] for k in FALLEN) / asked)
