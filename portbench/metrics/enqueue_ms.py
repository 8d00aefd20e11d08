"""API and dispatch: the host enqueueing a call's work, ms, the mean over
the traced calls of the summed durations of the port's `feed`, `lift`,
`inputs`, `init` and `chain` spans (`portbench/stages.py`)."""

from portbench import stages

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    return stages.stage_ms(trace, stages.ENQUEUE)
