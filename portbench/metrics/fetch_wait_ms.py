"""API and dispatch: the host blocked in the call's one device-to-host
copy while the card finishes, ms, the mean over the traced calls of the
port's `fetch` spans (`portbench/stages.py`)."""

from portbench import stages

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    return stages.stage_ms(trace, ("fetch",))
