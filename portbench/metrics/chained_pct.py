"""Chain loop: the share of the run's instances that the batched chains
proved, percent, from the port's counters (`tracing.counters()`): those
neither on the ML host-transcript loop nor proved one by one by the GKR
batch (`portbench/stages.py`). Read over the whole run, warm calls
included: every call proves the same shape."""

from portbench import stages

UNIT = "%"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    return stages.chained_pct(stages.port_counters())
