"""The traced window: consecutive calls under `torch.profiler`, each call's
device records, and the readings every per-layer metric takes from them.

The profiler drops the device records of a profile's first launches in a
process that has profiled many launches. So, as the port's microbench
does (copied here, not imported), each profile opens with `PAD` empty
launches, the calls' records are those of the host-side runtime calls
after them (which the profiler keeps), each device record is matched to
its runtime call by correlation id, and a profile that lost any record is
taken again, after a longer wait, over the next calls. A traced run whose
every profile lost records fails; it reports no partial number.

Each call is one `record_function` span of the benchmark's own
(`SPAN`); a device record belongs to the call whose span holds its
runtime call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

SPAN = "portbench.call"
PAD = 64
SETTLE_S = (0.05, 0.2, 0.5)
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaLaunchCooperativeKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def is_copy(name: str) -> bool:
    """Whether a device record is a copy or a fill, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def union_us(intervals) -> float:
    busy, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


@dataclass
class Call:
    start: float  # us, the profiler's clock
    end: float
    records: list  # (start us, end us, name), in start order


class Trace:
    """The traced calls of one cell: what the metric readers read."""

    def __init__(self, calls: list, host_events: list, proofs_per_call: int, work: dict):
        self.calls = calls
        self.host_events = host_events  # (start us, end us, name) of the host's ops
        self.proofs = proofs_per_call * len(calls)
        self.work = work  # {layer: {"bytes", "multiplies"}} of one call
        self.start = calls[0].start
        self.end = calls[-1].end

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def records(self):
        return [r for c in self.calls for r in c.records]

    def busy_us(self) -> float:
        return union_us((s, e) for s, e, _n in self.records())

    def kernels(self, patterns=None):
        """Kernel records (no copies or fills), those whose name holds one
        of `patterns` if given."""
        return [r for r in self.records() if not is_copy(r[2])
                and (patterns is None or any(p in r[2] for p in patterns))]

    def layer_ms(self, patterns) -> float | None:
        """Device ms of the layer's kernels over the traced calls; None if
        no kernel of the layer ran."""
        recs = self.kernels(patterns)
        if not recs:
            return None
        return sum(e - s for s, e, _n in recs) / 1e3

    def ms_per_proof(self, patterns) -> float | None:
        ms = self.layer_ms(patterns)
        return None if ms is None else ms / self.proofs

    def roofline_pct(self, patterns, layer: str) -> float | None:
        """The layer's bound time (`work`) over its kernels' device time,
        in percent; None where the layer did no work or ran no kernel."""
        from .work import bound_ms

        ms = self.layer_ms(patterns)
        if ms is None or layer not in self.work:
            return None
        return 100.0 * bound_ms(self.work[layer]) * len(self.calls) / ms

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by kernel name, and
        the longest idle gaps inside the calls, each named by the host op
        that overlaps most of it ("host Python" where ops cover less than
        a tenth of it: the port's Python between its launches)."""
        by_name: dict = {}
        for s, e, n in self.records():
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for c in self.calls:
            reach = c.start
            for s, e, _n in sorted(c.records):
                if s > reach:
                    gaps.append((reach, s))
                reach = max(reach, e)
            if c.end > reach:
                gaps.append((reach, c.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            cover = {}
            for hs, he, n in self.host_events:
                part = min(he, b) - max(hs, a)
                if part > 0:
                    cover[n] = cover.get(n, 0.0) + part
            name, part = max(cover.items(), key=lambda kv: kv[1], default=("", 0.0))
            named.append([name if part >= 0.1 * (b - a) else "host Python", (b - a) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def short_name(name: str) -> str:
    """A device record's name without its argument list or return type."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i].strip()
    return name.strip()


def profile_calls(step, count: int, proofs_per_call: int, work: dict) -> Trace:
    """Profile `count` consecutive window steps (`step()`, which opens one
    `SPAN` around its call of the program), retrying on lost records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for settle in SETTLE_S:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            for _ in range(PAD):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            for _ in range(count):
                step()
        events = list(prof.events())
        host = [e for e in events if e.device_type != DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == SPAN)
        runtime = sorted((e.time_range.start, e.id) for e in host if e.name in RUNTIME_CALLS)
        at = {i: t for t, i in runtime[PAD:]}
        recs = sorted((e.time_range.start, e.time_range.end, e.name, e.id) for e in events
                      if e.device_type == DeviceType.CUDA and e.id in at)
        if len(recs) != len(at) or len(spans) != count:
            continue
        calls = [Call(s, e, []) for s, e in spans]
        for s, e, name, i in recs:
            for c in calls:
                if c.start <= at[i] <= c.end:
                    c.records.append((s, e, name))
                    break
        host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in host
                    if e.name != SPAN and spans[0][0] <= e.time_range.start <= spans[-1][1]]
        return Trace(calls, host_ops, proofs_per_call, work)
    raise RuntimeError(f"every one of {len(SETTLE_S)} profiles lost device records of the "
                       "traced calls")
